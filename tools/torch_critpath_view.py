#!/usr/bin/env python
"""Cross-rank causal critical-path viewer (docs/critpath.md).

The counterpart of tools/critpath_view.py over gloo_tpu_torch.utils,
with its flags, output and exit codes: it reads the span snapshots that
the port writes in the reference's format, and runs where gloo_tpu's
library does not load.

Point it at per-rank span snapshots — JSON files written from
``Context.spans()``, a directory of ``spans-rank*.json``, or live ranks'
telemetry endpoints (``http://host:port`` fetches ``/spans``) — and it
merges them by collective sequence number, matches send->recv wire
edges by FIFO ordinal, extracts each op's longest weighted path, and
prints the critical path as a rank->step chain with each span's share
of the op's latency, plus the slack leaderboard (spans whose finish
could slip furthest before the op notices).

    python tools/torch_critpath_view.py spans-rank0.json spans-rank1.json
    python tools/torch_critpath_view.py spans-dump/
    python tools/torch_critpath_view.py http://127.0.0.1:9401 http://127.0.0.1:9402
    python tools/torch_critpath_view.py spans-dump/ --perfetto crit.json
    python tools/torch_critpath_view.py spans-dump/ --check 1=send:0.8

``--check RANK=KIND:FRAC`` turns the viewer into an assertion: on the
slowest merged op, does rank RANK's spans of kind KIND own at least
FRAC of the critical-path time? Exit 0 when the check passes, 3 when it
fails, 1 when there is no usable data — so chaos tests and CI gates can
pin blame without parsing the table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_telemetry_client as _telemetry_client  # noqa: E402
from gloo_tpu_torch.utils import critpath  # noqa: E402


def load_source(src: str, timeout: float = 10.0, token=None) -> list:
    """One source -> list of span snapshot dicts. Never raises for a
    single bad source; reports and returns []."""
    try:
        if _telemetry_client.is_url(src):
            snap = _telemetry_client.fetch(src, "/spans",
                                           timeout=timeout, token=token)
            return [snap] if snap is not None else []
        if os.path.isdir(src):
            out = []
            for path in sorted(glob.glob(
                    os.path.join(src, "spans-rank*.json"))):
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


def parse_check(spec: str):
    """``RANK=KIND:FRAC`` -> (rank, kind, frac). Raises ValueError."""
    rank_s, _, rest = spec.partition("=")
    kind, _, frac_s = rest.partition(":")
    rank, frac = int(rank_s), float(frac_s)
    if kind not in ("send", "recv", "wait", "local"):
        raise ValueError(f"unknown span kind {kind!r}")
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {frac}")
    return rank, kind, frac


def run_check(analysis: dict, spec: str) -> int:
    """Evaluate --check against the slowest analyzed op."""
    rank, kind, frac = parse_check(spec)
    ops = [op for op in analysis.get("ops", []) if op["total_us"] > 0]
    if not ops:
        print("check: no analyzable ops", file=sys.stderr)
        return 1
    op = max(ops, key=lambda o: o["total_us"])
    owned = op["attribution"].get(rank, {}).get(kind, 0)
    share = owned / op["total_us"]
    verdict = "PASS" if share >= frac else "FAIL"
    print(f"check {verdict}: cseq {op['cseq']} ({op['op']}, "
          f"{fmt_us(op['total_us'])}) — rank {rank} {kind} spans own "
          f"{fmt_us(owned)} = {share:.0%} of the critical "
          f"path (need >= {frac:.0%})")
    return 0 if share >= frac else 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+",
                    help="span JSON files, a dump directory, or "
                         "http://host:port telemetry endpoints")
    ap.add_argument("--ops", type=int, default=5,
                    help="slowest ops to print the path for (default 5)")
    ap.add_argument("--slack", type=int, default=8,
                    help="slack leaderboard rows per op (default 8)")
    ap.add_argument("--clock", choices=("auto", "raw", "align"),
                    default="auto",
                    help="cross-rank clock handling (default auto: raw "
                         "when per-rank origins agree, else align)")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write per-rank span tracks with the critical "
                         "path flagged (Chrome trace JSON) here")
    ap.add_argument("--json", action="store_true",
                    help="print the full analysis as JSON instead of "
                         "the table")
    ap.add_argument("--check", metavar="RANK=KIND:FRAC",
                    help="assert rank RANK's KIND spans own >= FRAC of "
                         "the slowest op's critical path; exit 0 pass, "
                         "3 fail, 1 no data")
    _telemetry_client.add_endpoint_args(ap)
    args = ap.parse_args()

    if args.check:
        try:
            parse_check(args.check)
        except ValueError as exc:
            ap.error(f"--check: {exc}")

    snaps = []
    for src in args.sources:
        snaps.extend(load_source(src, timeout=args.timeout,
                                 token=args.token))
    snaps = [s for s in snaps
             if isinstance(s, dict) and "spans" in s]
    if not snaps:
        print("no usable span snapshots", file=sys.stderr)
        return 1

    # One communicator group per analysis (split sub-groups renumber
    # ranks and run independent cseq axes; same rail as profile_view).
    groups = critpath.merge_by_group(snaps)
    analyses = {tag: critpath.analyze(m, clock=args.clock)
                for tag, m in groups.items()}

    if args.check:
        if len(analyses) != 1:
            print(f"check: need exactly one group, got "
                  f"{sorted(analyses)}", file=sys.stderr)
            return 1
        return run_check(next(iter(analyses.values())), args.check)

    if args.json:
        print(json.dumps(analyses, indent=2))
    for tag, merged in groups.items() if not args.json else ():
        analysis = analyses[tag]
        label = f" [group {tag}]" if tag else ""
        print(f"ranks{label}: {merged['ranks']} of {merged['size']}  "
              f"collectives merged: {len(merged['ops'])}  "
              f"clock: {analysis['clock']}")
        if merged.get("duplicates"):
            print(f"warning: several snapshots for rank(s) "
                  f"{merged['duplicates']} — kept the last given "
                  f"source per rank", file=sys.stderr)
        slowest = sorted(analysis["ops"], key=lambda o: -o["total_us"])
        for op in slowest[:args.ops]:
            un = op["unmatched"]
            un_note = ""
            if un["sends"] or un["recvs"] or un["mismatched"]:
                un_note = (f"  [unmatched: {un['sends']} sends, "
                           f"{un['recvs']} recvs, "
                           f"{un['mismatched']} slot/bytes mismatches]")
            print(f"\ncseq {op['cseq']}  {op['op']}  {op['bytes']}B  "
                  f"total {fmt_us(op['total_us'])}{un_note}")
            print("  critical path (origin -> finish):")
            for row in op["path"]:
                if row["contrib_us"] <= 0:
                    continue
                peer = (f" peer={row['peer']}"
                        if row.get("peer") is not None else "")
                pct = 100.0 * row["contrib_us"] / max(op["total_us"], 1)
                print(f"    rank {row['rank']} step {row['id']:>3} "
                      f"{row['kind']:<5}{peer:<9} "
                      f"{fmt_us(row['contrib_us']):>9}  {pct:5.1f}%")
            by_rank = []
            for r, kinds in sorted(op["attribution"].items()):
                total = sum(kinds.values())
                detail = " ".join(f"{k}={fmt_us(v)}"
                                  for k, v in sorted(kinds.items()))
                by_rank.append(f"rank {r} {fmt_us(total)} ({detail})")
            print("  attribution: " + "; ".join(by_rank))
            loose = [r for r in op["slack"] if r["slack_us"] > 0]
            loose.sort(key=lambda r: -r["slack_us"])
            if loose:
                print(f"  most slack (top {args.slack} — could slip "
                      "without extending the op):")
                for row in loose[:args.slack]:
                    print(f"    rank {row['rank']} step {row['id']:>3} "
                          f"{row['kind']:<5} slack "
                          f"{fmt_us(row['slack_us'])}")
        print()

    if args.perfetto:
        for tag, merged in sorted(groups.items()):
            out = args.perfetto if not tag else \
                f"{args.perfetto}.{tag.replace('/', '.')}"
            with open(out, "w") as f:
                f.write(critpath.to_perfetto(merged, analyses[tag],
                                             clock=args.clock))
            print(f"wrote {out} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
