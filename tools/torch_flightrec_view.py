#!/usr/bin/env python
"""Post-mortem viewer for flight-recorder dumps (docs/flightrec.md).

The counterpart of tools/flightrec_view.py over gloo_tpu_torch.utils,
with its flags, output and exit codes: it reads the flight-recorder
dumps that the port writes in the reference's format, and runs where
gloo_tpu's library does not load.

Point it at a dump directory, individual dump files, or LIVE ranks'
telemetry endpoints (``http://host:port`` sources fetch ``/flightrec``
from gloo_tpu_torch.utils.telemetry.serve_telemetry — post-mortem and live
tooling share this one CLI); it merges the per-rank rings, prints the
cross-rank timeline tail and the verdict — desync (who ran what at the
diverging seq), stall (who everyone blames), or clean — and can emit a
Perfetto/chrome://tracing file of the merged timeline.

    python tools/torch_flightrec_view.py flightrec-dump/
    python tools/torch_flightrec_view.py dump/flightrec-rank*.json --tail 30
    python tools/torch_flightrec_view.py http://10.0.0.1:9401 http://10.0.0.2:9401
    python tools/torch_flightrec_view.py flightrec-dump/ --perfetto out.json
    python tools/torch_flightrec_view.py flightrec-dump/ --check   # exit 2 on desync

Exit status: 0 clean, 1 stall, 2 desync (with --check; otherwise 0
unless the input is unusable).

With ``--fleet`` the sources are rank 0 endpoints (or saved fleet
documents) and the merged in-band ``/fleet`` view is rendered instead
(docs/fleet.md). Endpoint handling (timeout, auth token) is shared with
torch_profile_view via tools/_torch_telemetry_client.py.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import _torch_telemetry_client as _telemetry_client  # noqa: E402
from gloo_tpu_torch.utils import flightrec  # noqa: E402


def _resolve_source(src: str, timeout: float = 10.0, token=None):
    """A CLI source -> something flightrec.merge understands: http(s)
    URLs fetch the live /flightrec ring (loaded dict; unreachable ranks
    degrade to None, exactly like a missing dump file), everything else
    passes through as a path."""
    if not _telemetry_client.is_url(src):
        return src
    return _telemetry_client.fetch(src, "/flightrec",
                                   timeout=timeout, token=token)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dumps", nargs="+",
                    help="dump directory, flightrec-rank*.json files, "
                         "or live http://host:port telemetry endpoints")
    ap.add_argument("--tail", type=int, default=20,
                    help="timeline rows to print (default 20)")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write merged Chrome trace-event JSON here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on stall, 2 on desync")
    _telemetry_client.add_endpoint_args(ap)
    args = ap.parse_args()

    if args.fleet:
        return _telemetry_client.run_fleet_mode(
            args.dumps, timeout=args.timeout, token=args.token)

    # A directory may hold dumps from several communicators — the root
    # context plus split sub-groups (tagged -g<group>) and async lanes
    # (-lane<k>). Each tag is an independent schedule: merge + analyze
    # PER TAG, never across (disjoint groups legitimately run different
    # collectives; comparing their fingerprints would invent a desync).
    if len(args.dumps) == 1 and os.path.isdir(args.dumps[0]):
        groups = flightrec.merge_by_tag(args.dumps[0])
    else:
        sources = [_resolve_source(s, timeout=args.timeout,
                                   token=args.token)
                   for s in args.dumps]
        groups = {"": flightrec.merge(sources)}
    groups = {tag: m for tag, m in groups.items() if m["ranks"]}
    if not groups:
        print("no usable dumps found", file=sys.stderr)
        return 1

    worst = 0
    for tag, merged in groups.items():
        label = f" [group {tag}]" if tag else ""
        print(f"ranks{label}: {sorted(merged['ranks'])} of "
              f"{merged['size']}"
              + (f"  MISSING: {merged['missing']}"
                 if merged["missing"] else ""))
        for rank, doc in sorted(merged["ranks"].items()):
            print(f"  rank {rank}: reason={doc.get('reason')} "
                  f"next_seq={doc.get('next_seq')} "
                  f"blamed_peer={doc.get('blamed_peer')} "
                  f"dropped={doc.get('dropped')}")

        print(f"\ntimeline{label} (last {args.tail} of "
              f"{len(merged['timeline'])}):")
        for e in merged["timeline"][-args.tail:]:
            print(f"  seq {e.get('seq'):>5}  rank {e.get('rank')}  "
                  f"{e.get('state', '?'):>9}  "
                  f"{flightrec.describe_event(e)}  "
                  f"slot={e.get('slot')} fp={e.get('fp')}")

        verdict = flightrec.analyze(merged)
        print(f"\nverdict{label}: {verdict['kind'].upper()}")
        print(f"  {verdict['message']}")
        if verdict["blamed_ranks"]:
            print(f"  blamed rank(s): {verdict['blamed_ranks']}")
        for rank, f in sorted(verdict.get("frontier", {}).items()):
            print(f"  rank {rank} frontier: seq {f['seq']} ({f['desc']}, "
                  f"{f['state']})")
        print()
        worst = max(worst,
                    {"ok": 0, "stall": 1, "desync": 2}.get(
                        verdict["kind"], 1))

        if args.perfetto:
            out = args.perfetto if not tag else \
                f"{args.perfetto}.{tag.replace('/', '.')}"
            with open(out, "w") as f:
                f.write(flightrec.to_perfetto(merged))
            print(f"wrote {out} (open in ui.perfetto.dev)")

    if args.check:
        return worst
    return 0


if __name__ == "__main__":
    sys.exit(main())
