#!/usr/bin/env python
"""Cross-rank phase-profile viewer: straggler attribution + leaderboard

The counterpart of tools/profile_view.py over gloo_tpu_torch.utils, with
its flags, output and exit codes: it reads the profile snapshots that
the port writes in the reference's format, and runs where gloo_tpu's
library does not load.
(docs/profiling.md).

Point it at per-rank profile snapshots — JSON files written from
``Context.profile()``, a directory of ``profile-rank*.json``, or live
ranks' telemetry endpoints (``http://host:port`` fetches
``/profile.json``) — and it merges them by collective sequence number,
attributes each op's latency to self-time vs straggler-wait, and prints
the per-rank leaderboard of who the job waits for.

    python tools/torch_profile_view.py prof-rank0.json prof-rank1.json
    python tools/torch_profile_view.py profile-dump/
    python tools/torch_profile_view.py http://127.0.0.1:9401 http://127.0.0.1:9402
    python tools/torch_profile_view.py profile-dump/ --perfetto phases.json
    python tools/torch_profile_view.py profile-dump/ --ops 10
    python tools/torch_profile_view.py http://10.0.0.1:9401 --fleet

With ``--fleet`` the sources are rank 0 endpoints (or saved fleet
documents) and the merged in-band ``/fleet`` view is rendered instead —
coverage, health, straggler leaderboard, slow links, anomalies
(docs/fleet.md). Endpoint handling (timeout, auth token) is shared with
torch_flightrec_view via tools/_torch_telemetry_client.py.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_telemetry_client as _telemetry_client  # noqa: E402
from gloo_tpu_torch.utils import profile  # noqa: E402


def load_source(src: str, timeout: float = 10.0, token=None) -> list:
    """One source -> list of profile snapshot dicts. Never raises for a
    single bad source; reports and returns []."""
    try:
        if _telemetry_client.is_url(src):
            snap = _telemetry_client.fetch(src, "/profile.json",
                                           timeout=timeout, token=token)
            return [snap] if snap is not None else []
        if os.path.isdir(src):
            out = []
            for path in sorted(glob.glob(
                    os.path.join(src, "profile-rank*.json"))):
                out.extend(load_source(path))
            return out
        with open(src) as f:
            return [json.load(f)]
    except Exception as exc:  # noqa: BLE001 - CLI degrades per source
        print(f"warning: cannot load {src}: {exc}", file=sys.stderr)
        return []


def fmt_us(us: int) -> str:
    if us >= 1_000_000:
        return f"{us / 1e6:.2f}s"
    if us >= 1000:
        return f"{us / 1e3:.1f}ms"
    return f"{us}us"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+",
                    help="profile JSON files, a dump directory, or "
                         "http://host:port telemetry endpoints")
    ap.add_argument("--ops", type=int, default=15,
                    help="worst ops to print (by straggler excess; "
                         "default 15)")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write per-rank phase tracks (Chrome trace "
                         "JSON) here")
    ap.add_argument("--json", action="store_true",
                    help="print the full attribution as JSON instead of "
                         "the table")
    _telemetry_client.add_endpoint_args(ap)
    args = ap.parse_args()

    if args.fleet:
        return _telemetry_client.run_fleet_mode(
            args.sources, timeout=args.timeout, token=args.token)

    snaps = []
    for src in args.sources:
        snaps.extend(load_source(src, timeout=args.timeout,
                                 token=args.token))
    if not snaps:
        print("no usable profile snapshots", file=sys.stderr)
        return 1

    # Partition by communicator group FIRST (split sub-groups / epochs
    # renumber ranks and run independent schedules — their cseq axes
    # must never be compared; same rule as flightrec_view).
    groups = profile.merge_by_group(snaps)
    if args.json:
        print(json.dumps({g: profile.attribute(m)
                          for g, m in groups.items()}, indent=2))
    for tag, merged in groups.items() if not args.json else ():
        attributed = profile.attribute(merged)
        label = f" [group {tag}]" if tag else ""
        print(f"ranks{label}: {merged['ranks']} of {merged['size']}  "
              f"collectives merged: {len(merged['ops'])}")
        if merged.get("duplicates"):
            print(f"warning: several snapshots for rank(s) "
                  f"{merged['duplicates']} — kept the last given "
                  f"source per rank", file=sys.stderr)
        print(f"\nstraggler leaderboard{label} (time the OTHER ranks "
              "spent waiting for this one):")
        for row in profile.leaderboard(attributed):
            print(f"  rank {row['rank']}: blamed for "
                  f"{fmt_us(row['blamed_us'])} across "
                  f"{row['blamed_ops']} ops  "
                  f"(self {fmt_us(row['self_us'])}, "
                  f"waited-on-others {fmt_us(row['excess_us'])})")
        worst = sorted(attributed["ops"], key=lambda o: -o["excess_us"])
        print(f"\nworst ops{label} (top {args.ops} by straggler "
              "excess):")
        for op in worst[:args.ops]:
            if op["excess_us"] <= 0:
                continue
            print(f"  cseq {op['cseq']:>5}  {op['op']}"
                  f"{'[' + op['algo'] + ']' if op['algo'] else ''}  "
                  f"{op['bytes']}B  straggler=rank {op['straggler']}  "
                  f"excess {fmt_us(op['excess_us'])}")
            for r, st in sorted(op["ranks"].items()):
                phases = " ".join(
                    f"{k}={fmt_us(v)}"
                    for k, v in sorted(st["phases"].items()))
                print(f"      rank {r}: total {fmt_us(st['total_us'])} "
                      f"(self {fmt_us(st['self_us'])}, excess "
                      f"{fmt_us(st['excess_us'])})  {phases}")
        print()

    if args.perfetto:
        # Same rails as the attribution path: one trace per group (pid
        # = rank is only unique within a communicator) and one snapshot
        # per rank (last wins), so unrelated spans never share a track.
        by_group = {}
        for snap in snaps:
            if not isinstance(snap, dict) or "ops" not in snap:
                continue
            tag = str(snap.get("group", "") or "")
            by_group.setdefault(tag, {})[int(snap.get("rank", -1))] = snap
        for tag, rank_snaps in sorted(by_group.items()):
            out = args.perfetto if not tag else \
                f"{args.perfetto}.{tag.replace('/', '.')}"
            with open(out, "w") as f:
                f.write(profile.to_perfetto(rank_snaps.values()))
            print(f"wrote {out} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
