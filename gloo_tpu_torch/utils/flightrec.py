"""The flight-recorder analysis that failure recovery reads.

Counterpart of the part of gloo_tpu/utils/flightrec.py that
gloo_tpu_torch.resilience needs: pure functions over the records of
``Context.flightrec()`` (dicts), copied so that the port imports nothing
of the JAX package. The dump, merge and Perfetto tools are not copied.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["DesyncError", "TAIL_K", "describe_event", "detect_desync"]

# How many trailing ops a rank publishes through the rendezvous store
# when recovery exchanges evidence (resilience._stall_evidence): enough to
# find the divergence point across ranks whose frontiers drifted apart by
# a few ops, small enough for a store value.
TAIL_K = 16


class DesyncError(RuntimeError):
    """Ranks issued DIFFERENT collectives at the same sequence number: the
    schedule divergence no rebuild can fix. `.report` carries the verdict
    dict of :func:`detect_desync`."""

    def __init__(self, message: str, report: Optional[dict] = None):
        super().__init__(message)
        self.report = report or {}


def describe_event(e: dict) -> str:
    """Human description of one record: "allreduce float32 1.0MB"."""
    parts = [str(e.get("op", "?"))]
    if e.get("algo"):
        parts.append(f"[{e['algo']}]")
    if e.get("dtype"):
        parts.append(str(e["dtype"]))
    nbytes = e.get("bytes", 0)
    if nbytes:
        for unit in ("B", "KB", "MB", "GB"):
            if nbytes < 1024 or unit == "GB":
                parts.append(f"{nbytes:.1f}{unit}"
                             if isinstance(nbytes, float)
                             else f"{nbytes}{unit}")
                break
            nbytes /= 1024
    return " ".join(parts)


def detect_desync(tails: Dict[int, List[dict]]) -> Optional[dict]:
    """Compare per-rank op fingerprints at matching COLLECTIVE sequence
    numbers.

    `tails` maps rank -> list of records (full flight-recorder events and
    the compact store-exchanged tails both qualify). Only entries with a
    `cseq` take part: point-to-point ops (`cseq` None) are rank-asymmetric
    by nature. Returns None when every shared cseq agrees; otherwise
    {"mismatches": [{"seq", "groups": [{"fp", "ranks", "desc"}]}],
    "blamed_ranks": the minority group at the first mismatch, "message"}.
    """
    by_seq: Dict[int, Dict[int, dict]] = {}
    for rank, tail in tails.items():
        for e in tail or []:
            if e.get("cseq") is not None and "fp" in e:
                by_seq.setdefault(int(e["cseq"]), {})[rank] = e
    mismatches = []
    for seq in sorted(by_seq):
        groups: Dict[str, List[int]] = {}
        for rank, e in by_seq[seq].items():
            groups.setdefault(str(e["fp"]), []).append(rank)
        if len(groups) < 2:
            continue
        mismatches.append({
            "seq": seq,
            "groups": [{"fp": fp, "ranks": sorted(rs),
                        "desc": by_seq[seq][rs[0]].get("desc")
                        or describe_event(by_seq[seq][rs[0]])}
                       for fp, rs in sorted(groups.items(),
                                            key=lambda kv: kv[1])],
        })
    if not mismatches:
        return None
    first = mismatches[0]
    # The smallest group is the blamed one; the message sets it against
    # the largest other group (a 1 v 1 tie still names two sides).
    by_size = sorted(first["groups"],
                     key=lambda g: (len(g["ranks"]), g["ranks"]))
    minority = by_size[0]
    majority = by_size[-1]
    message = (
        f"collective desync: rank {minority['ranks'][0]} is at seq "
        f"{first['seq']} ({minority['desc']}) while rank "
        f"{majority['ranks'][0]} is at seq {first['seq']} "
        f"({majority['desc']})")
    return {"mismatches": mismatches, "blamed_ranks": minority["ranks"],
            "message": message}
