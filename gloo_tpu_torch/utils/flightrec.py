"""Flight-recorder post-mortem tooling: dump, cross-rank merge, desync
analysis, Perfetto conversion.

The native side (csrc/tpucoll/common/flightrec.h, docs/flightrec.md)
keeps an always-on bounded ring of every collective/p2p op per context
and dumps it to JSON on stall, transport failure, fatal signal (opt-in),
or request. This module is the other half of the black box: collect the
per-rank dumps after an incident and turn them into one answer —

- :func:`dump` writes this rank's ring to a dump directory;
- :func:`merge` combines per-rank dumps into a single cross-rank
  timeline, degrading gracefully over empty/corrupt files and noting
  ranks whose dump never appeared (a SIGKILL'd rank writes nothing);
- :func:`analyze` renders the verdict: a **desync** (ranks issued
  different collectives at the same sequence number — fingerprints
  diverge), a **stall** (same schedule, one rank behind or blamed by its
  peers' watchdogs), or a clean record;
- :func:`raise_on_desync` turns a desync verdict into the typed
  :class:`DesyncError`;
- :func:`to_perfetto` emits Chrome trace-event JSON of the merged
  timeline (per-rank rows, in-flight ops rendered to the dump instant).

Timestamps are per-host CLOCK_MONOTONIC: comparable across the
processes of one host (the multiprocess test topology) but NOT across
machines — the analysis therefore reasons in sequence numbers and
states, and only uses timestamps for ordering within a rank and for the
Perfetto rendering.

The port's copy of gloo_tpu/utils/flightrec.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Union

__all__ = [
    "DesyncError",
    "analyze",
    "describe_event",
    "detect_desync",
    "dump",
    "install_signal_handler",
    "load",
    "merge",
    "merge_by_tag",
    "raise_on_desync",
    "to_perfetto",
]

# How many trailing ops a rank publishes through the rendezvous store
# when recovery exchanges evidence (resilience._stall_evidence): enough
# to find the divergence point across ranks whose frontiers drifted
# apart by a few ops, small enough for a store value.
TAIL_K = 16

_RANK_RE = re.compile(r"flightrec-rank(\d+)\.json$")
# Tagged dump names: flightrec-rank<r>[-g<group>][-lane<k>].json — group
# tags come from split sub-communicators (Context.group_tag, '/' mapped
# to '.'), lane tags from async engines. merge() keeps its historical
# contract (untagged = root-context dumps only); merge_by_tag() is the
# partitioned form.
_TAGGED_RE = re.compile(
    r"flightrec-rank(\d+)(?:-g([\w.]+))?(?:-lane(\d+))?\.json$")


class DesyncError(RuntimeError):
    """Ranks issued DIFFERENT collectives at the same sequence number —
    the unrecoverable schedule divergence. `.report` carries the full
    verdict dict from :func:`analyze` / :func:`detect_desync`."""

    def __init__(self, message: str, report: Optional[dict] = None):
        super().__init__(message)
        self.report = report or {}


def install_signal_handler() -> None:
    """Opt in to fatal-signal dumping: SIGSEGV/SIGABRT/SIGBUS/SIGFPE/
    SIGILL/SIGTERM dump every live context's ring to
    TPUCOLL_FLIGHTREC_DIR before the process dies. Also reachable with
    TPUCOLL_FLIGHTREC_SIGNALS=1 (checked at context connect)."""
    from gloo_tpu_torch import _lib

    _lib.lib().tc_flightrec_install_signal_handler()


def dump(ctx, directory: Optional[str] = None) -> str:
    """Write `ctx`'s flight-recorder ring to
    `directory/flightrec-rank<r>.json` (the same naming automatic dumps
    use, so one merge() reads both). Default directory:
    TPUCOLL_FLIGHTREC_DIR, else ./flightrec-dump. Returns the path."""
    if directory is None:
        directory = os.environ.get("TPUCOLL_FLIGHTREC_DIR",
                                   "flightrec-dump")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"flightrec-rank{ctx.rank}.json")
    return ctx.flightrec_dump(path)


def load(path: str) -> Optional[dict]:
    """Read one dump file; returns None (never raises) for a missing,
    empty, or corrupt file — a crashing rank may truncate its dump, and
    the merge must survive that."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "events" not in doc:
        return None
    return doc


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


def _iter_docs(dumps) -> List[Optional[dict]]:
    """Normalize merge() input — a dump directory, an iterable of file
    paths, or an iterable of already-loaded dicts — into docs."""
    if isinstance(dumps, str):
        paths = [p for p in
                 glob.glob(os.path.join(dumps, "flightrec-rank*.json"))
                 if _RANK_RE.search(p)]
        paths.sort(key=lambda p: int(_RANK_RE.search(p).group(1)))
        return [load(p) for p in paths]
    docs: List[Optional[dict]] = []
    for item in dumps:
        if isinstance(item, str):
            docs.append(load(item))
        else:
            docs.append(item if isinstance(item, dict) else None)
    return docs


def merge(dumps: Union[str, Iterable]) -> dict:
    """Merge per-rank dumps into one cross-rank record.

    `dumps` is a dump directory, an iterable of file paths, or an
    iterable of loaded docs (None entries allowed). Returns::

        {"ranks": {rank: doc},        # successfully loaded dumps
         "size": <group size>,        # max size claimed by any dump
         "missing": [rank, ...],      # ranks with no usable dump
         "timeline": [event + {"rank": r}, ...]}  # ts-sorted

    A missing or unreadable rank is NOTED, never fatal — with a killed
    rank the absence itself is the evidence. Events with absent or
    unsorted timestamps are tolerated (sort key falls back to seq)."""
    ranks: Dict[int, dict] = {}
    size = 0
    for doc in _iter_docs(dumps):
        if doc is None:
            continue
        rank = int(doc.get("rank", -1))
        if rank < 0:
            continue
        ranks[rank] = doc
        size = max(size, int(doc.get("size", 0)), rank + 1)
    timeline = []
    for rank, doc in sorted(ranks.items()):
        for e in doc.get("events", []):
            if not isinstance(e, dict):
                continue
            timeline.append(dict(e, rank=rank))
    timeline.sort(key=lambda e: (e.get("ts_enqueued_us") or 0,
                                 e.get("seq", 0), e.get("rank", 0)))
    missing = [r for r in range(size) if r not in ranks]
    return {"ranks": ranks, "size": size, "missing": missing,
            "timeline": timeline}


def merge_by_tag(directory: str) -> Dict[str, dict]:
    """Partition a dump directory by tag, then merge each partition.

    Returns {tag: merge_result}. The tag is "<group>" for split
    sub-communicator dumps (flightrec-rank<r>-g<group>.json, with the
    "group" field inside the doc as fallback), "<group>/lane<k>" or
    "lane<k>" for async-lane dumps, and "" for plain root-context dumps.

    Partitioning is REQUIRED before analysis when sub-groups share a
    dump directory: disjoint split groups legitimately run different
    schedules, so fingerprint-comparing rank 0 of group A against rank 0
    of group B would report a desync that is not one. Analyze each
    partition independently (see tools/flightrec_view.py)."""
    partitions: Dict[str, list] = {}
    for path in sorted(glob.glob(
            os.path.join(directory, "flightrec-rank*.json"))):
        m = _TAGGED_RE.search(os.path.basename(path))
        if m is None:
            continue
        doc = load(path)
        if doc is None:
            continue
        group = m.group(2) or str(doc.get("group", "") or "")
        lane = m.group(3)
        tag = group
        if lane is not None:
            tag = f"{group}/lane{lane}" if group else f"lane{lane}"
        partitions.setdefault(tag, []).append(doc)
    return {tag: merge(docs) for tag, docs in sorted(partitions.items())}


def detect_desync(tails: Dict[int, List[dict]]) -> Optional[dict]:
    """Compare per-rank op fingerprints at matching COLLECTIVE sequence
    numbers.

    `tails` maps rank -> list of records (full dump events and the
    compact store-exchanged tails both qualify). Only entries with a
    `cseq` participate: the collective sequence advances identically on
    every rank for a matching schedule, whereas p2p ops (send/recv/
    put/get, `cseq` null) are legitimately rank-asymmetric and must not
    shift or poison the comparison. Returns None when every shared cseq
    agrees; otherwise a desync report::

        {"mismatches": [{"seq", "groups": [{"fp", "ranks", "desc"}]}],
         "blamed_ranks": [...],   # minority group at the first mismatch
         "message": "rank 2 is at seq 41 (broadcast ...) while ..."}
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
    # Smallest group is the blamed divergent; the message quotes it
    # against the LARGEST OTHER group (size ties — e.g. a 1v1 split when
    # only two ranks' tails overlap — must still name two different
    # sides, not the same group twice).
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


def _frontier(doc: dict) -> Optional[dict]:
    """The record that tells where a rank got to: its first
    non-completed op when one exists (the op it died/hung inside), else
    its last op."""
    events = [e for e in doc.get("events", []) if isinstance(e, dict)]
    if not events:
        return None
    for e in events:
        if e.get("state") != "completed":
            return e
    return events[-1]


def analyze(merged: dict) -> dict:
    """Render the verdict over a :func:`merge` result.

    Returns {"kind": "desync" | "stall" | "ok", "blamed_ranks": [...],
    "message": str, "frontier": {rank: {"seq", "desc", "state"}},
    "desync": <detect_desync report or None>, "missing": [...],
    "suspects": {rank: votes}}.

    Blame order: fingerprint divergence wins (a desync explains every
    downstream stall); then ranks that never dumped (killed before the
    recorder could write) together with the peers their survivors'
    dumps blame; then the watchdog blame votes carried in each dump's
    `blamed_peer`; then the rank whose frontier trails the group."""
    ranks = merged.get("ranks", {})
    frontier = {}
    for rank, doc in ranks.items():
        e = _frontier(doc)
        if e is None:
            continue
        # The displayed frontier is whatever op the rank is stuck in
        # (possibly p2p); the cross-rank COMPARISON axis is the rank's
        # last collective seq — ring seqs count rank-asymmetric p2p
        # traffic and are not comparable between ranks.
        colls = [ev for ev in doc.get("events", [])
                 if isinstance(ev, dict) and ev.get("cseq") is not None]
        frontier[rank] = {"seq": e.get("seq"),
                          "cseq": colls[-1]["cseq"] if colls else None,
                          "desc": describe_event(e),
                          "state": e.get("state")}
    desync = detect_desync(
        {r: doc.get("events", []) for r, doc in ranks.items()})
    suspects: Dict[int, int] = {}
    for doc in ranks.values():
        blamed = doc.get("blamed_peer", -1)
        if isinstance(blamed, int) and blamed >= 0:
            suspects[blamed] = suspects.get(blamed, 0) + 1
    missing = list(merged.get("missing", []))

    if desync is not None:
        return {"kind": "desync", "blamed_ranks": desync["blamed_ranks"],
                "message": desync["message"], "frontier": frontier,
                "desync": desync, "missing": missing,
                "suspects": suspects}

    blamed: List[int] = []
    message = "no desync detected"
    kind = "ok"
    if missing:
        kind = "stall"
        blamed = missing
        message = (f"rank(s) {missing} produced no dump (died before the "
                   f"recorder could write)")
    elif suspects:
        kind = "stall"
        top = max(suspects.items(), key=lambda kv: kv[1])[0]
        blamed = [top]
        message = f"peers blame rank {top}"
    elif frontier:
        # Laggard comparison in COLLECTIVE seq: a rank that never
        # reached a collective sorts as furthest behind.
        def key(f):
            return f["cseq"] if f.get("cseq") is not None else -1

        behind = min(frontier.items(), key=lambda kv: key(kv[1]))
        ahead = max(frontier.items(), key=lambda kv: key(kv[1]))
        if (key(behind[1]) != key(ahead[1])
                or any(f["state"] != "completed"
                       for f in frontier.values())):
            kind = "stall"
            inflight = [r for r, f in frontier.items()
                        if f["state"] != "completed"]
            blamed = [behind[0]] if not inflight else sorted(inflight)
            message = (f"rank {behind[0]} is at seq {key(behind[1])} "
                       f"({behind[1]['desc']}, {behind[1]['state']}); "
                       f"rank {ahead[0]} reached seq {key(ahead[1])}")
    if blamed and frontier:
        extras = [f"rank {r} in-flight: {frontier[r]['desc']} "
                  f"(seq {frontier[r]['seq']}, {frontier[r]['state']})"
                  for r in sorted(frontier)
                  if frontier[r]["state"] != "completed"]
        if extras:
            message += "; " + "; ".join(extras)
    return {"kind": kind, "blamed_ranks": blamed, "message": message,
            "frontier": frontier, "desync": None, "missing": missing,
            "suspects": suspects}


def raise_on_desync(merged_or_verdict: dict) -> dict:
    """Run (or reuse) the analysis; raise :class:`DesyncError` on a
    fingerprint divergence, return the verdict otherwise."""
    verdict = merged_or_verdict
    if "kind" not in verdict:
        verdict = analyze(verdict)
    if verdict.get("kind") == "desync":
        raise DesyncError(verdict["message"], verdict)
    return verdict


def to_perfetto(merged: dict) -> str:
    """Chrome trace-event JSON of the merged timeline: one row per rank
    (pid = rank, labeled like utils.merge_traces), one complete-event
    span per op. In-flight ops extend to the dumping rank's `now_us` so
    the hang is visible as a bar running off the end."""
    events = []
    pids = set()
    for rank, doc in sorted(merged.get("ranks", {}).items()):
        now = doc.get("now_us", 0)
        for e in doc.get("events", []):
            start = e.get("ts_enqueued_us") or 0
            end = e.get("ts_completed_us") or 0
            if end <= 0:
                end = max(now, start)
            args = {"seq": e.get("seq"), "state": e.get("state"),
                    "bytes": e.get("bytes"), "fp": e.get("fp")}
            if e.get("algo"):
                args["algo"] = e["algo"]
            if e.get("peer", -1) is not None and e.get("peer", -1) >= 0:
                args["peer"] = e["peer"]
            events.append({"name": e.get("op", "?"), "ph": "X",
                           "ts": start, "dur": max(end - start, 1),
                           "pid": rank, "tid": 0, "args": args})
            pids.add(rank)
    meta = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"rank {pid}"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
    return json.dumps(meta + events)
