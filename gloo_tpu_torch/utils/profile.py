"""Cross-rank phase-profile merging and straggler attribution.

The native phase profiler (csrc/tpucoll/common/profile.h,
docs/profiling.md) decomposes every collective on every rank into
canonical phases (pack / post / wire_wait / reduce / unpack, plus the
hierarchical intra / inter / fanout) and keys each per-op breakdown by
the flight recorder's cross-rank collective sequence number ``cseq``.
This module is the cross-rank half:

- :func:`merge` joins per-rank ``Context.profile()`` snapshots by
  ``cseq`` into one record per collective;
- :func:`attribute` splits each collective's latency into **self time**
  and **straggler wait**: a rank's ``wire_wait`` in excess of the
  cross-rank minimum is time spent waiting for a slower peer, and is
  attributed to the straggler — the rank with the *minimum* wire wait
  (it made everyone else wait while itself never waiting);
- :func:`leaderboard` ranks ranks by total blamed time — "who is
  slowing this job down";
- :func:`to_perfetto` renders per-rank phase tracks (Chrome trace-event
  JSON) with each op's span subdivided into its phases.

Timestamps are per-host CLOCK_MONOTONIC and never compared across
machines; the cross-rank join happens purely on ``cseq``, and
attribution uses per-op durations only.

The port's copy of gloo_tpu/utils/profile.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

__all__ = [
    "attribute",
    "leaderboard",
    "merge",
    "merge_by_group",
    "to_perfetto",
]

# Phases that count as "waiting on the wire" for attribution. post is
# deliberately excluded: a send delayed at posting time (e.g. the fault
# plane's injected delay) is the STRAGGLER's own time, and folding it
# into the wait would blame the victim.
WAIT_PHASES = ("wire_wait",)


def merge(snapshots: Iterable[dict], group: Optional[str] = None,
          ) -> dict:
    """Join per-rank ``Context.profile()`` snapshots by ``cseq``.

    Returns ``{"group": g, "ranks": [r, ...], "size": n,
    "duplicates": [r, ...], "skipped_groups": [g, ...],
    "ops": {cseq: {rank: op_record}}}``. Ops whose cseq is null (never
    the case for collectives) and ranks without a usable snapshot are
    skipped; an op present on only a subset of ranks (bounded ring
    overwrote it elsewhere) still merges — attribution just sees fewer
    ranks.

    Two safety rails mirror the flight recorder's merge semantics:

    - **one communicator per merge**: the cseq axis only lines up
      within one group tag (split sub-groups renumber ranks AND run
      independent schedules, docs/topology.md), so only snapshots whose
      ``group`` matches — ``group=`` when given, else the first usable
      snapshot's — participate; others are noted under
      ``skipped_groups``. Use :func:`merge_by_group` to handle a mixed
      set.
    - **one snapshot per rank**: several snapshots for one rank (a
      stale dump file beside a live fetch) never mix — the LAST wins
      wholesale and the rank is noted under ``duplicates``."""
    by_rank: Dict[int, dict] = {}
    duplicates: List[int] = []
    skipped_groups: List[str] = []
    size = 0
    for snap in snapshots:
        if not isinstance(snap, dict) or "ops" not in snap:
            continue
        rank = int(snap.get("rank", -1))
        if rank < 0:
            continue
        snap_group = str(snap.get("group", "") or "")
        if group is None:
            group = snap_group
        if snap_group != group:
            if snap_group not in skipped_groups:
                skipped_groups.append(snap_group)
            continue
        if rank in by_rank and rank not in duplicates:
            duplicates.append(rank)
        by_rank[rank] = snap
        size = max(size, int(snap.get("size", 0)), rank + 1)
    ops: Dict[int, Dict[int, dict]] = {}
    for rank, snap in by_rank.items():
        for op in snap.get("ops", []):
            cseq = op.get("cseq")
            if cseq is None:
                continue
            ops.setdefault(int(cseq), {})[rank] = op
    return {"group": group or "", "ranks": sorted(by_rank),
            "size": size, "duplicates": sorted(duplicates),
            "skipped_groups": sorted(skipped_groups), "ops": ops}


def merge_by_group(snapshots: Iterable[dict]) -> Dict[str, dict]:
    """Partition snapshots by their ``group`` tag, then :func:`merge`
    each partition — the safe entry point for a source set spanning
    split sub-groups / epochs (disjoint communicators must never be
    cseq-compared against each other). Returns ``{group: merged}``."""
    partitions: Dict[str, List[dict]] = {}
    for snap in snapshots:
        if not isinstance(snap, dict) or "ops" not in snap:
            continue
        partitions.setdefault(str(snap.get("group", "") or ""),
                              []).append(snap)
    return {g: merge(snaps, group=g)
            for g, snaps in sorted(partitions.items())}


def _wait_us(op: dict) -> int:
    phases = op.get("phases", {})
    return sum(int(phases.get(p, 0)) for p in WAIT_PHASES)


def attribute(merged: dict) -> dict:
    """Attribute each merged collective's latency to self time vs
    straggler wait.

    For collective c with per-rank wire waits w_r, the baseline
    ``min_r w_r`` is the wait everyone pays even in lockstep (wire
    transfer time); rank r's **excess** ``w_r - min w`` is time it
    spent waiting for a slower peer, attributed to the **straggler**
    ``argmin_r w_r``. Self time is ``total - excess``.

    Returns ``{"ops": [{"cseq", "op", "algo", "bytes", "straggler",
    "excess_us", "ranks": {r: {"total_us", "wait_us", "excess_us",
    "self_us", "phases"}}}, ...], "by_rank": {r: {"blamed_us",
    "blamed_ops", "self_us", "excess_us"}}}`` with ops sorted by cseq.
    Single-rank records (ring overwrote the peers) get no straggler."""
    out_ops = []
    by_rank: Dict[int, dict] = {}

    def rank_acc(r: int) -> dict:
        return by_rank.setdefault(r, {"blamed_us": 0, "blamed_ops": 0,
                                      "self_us": 0, "excess_us": 0})

    for cseq in sorted(merged.get("ops", {})):
        per_rank = merged["ops"][cseq]
        waits = {r: _wait_us(op) for r, op in per_rank.items()}
        base = min(waits.values()) if waits else 0
        straggler: Optional[int] = None
        if len(per_rank) > 1:
            straggler = min(waits, key=lambda r: (waits[r], r))
        ranks_out = {}
        total_excess = 0
        first = next(iter(per_rank.values()))
        for r, op in sorted(per_rank.items()):
            total = int(op.get("total_us", 0))
            wait = waits[r]
            excess = max(wait - base, 0)
            total_excess += excess
            ranks_out[r] = {
                "total_us": total,
                "wait_us": wait,
                "excess_us": excess,
                "self_us": max(total - excess, 0),
                "phases": op.get("phases", {}),
            }
            acc = rank_acc(r)
            acc["self_us"] += ranks_out[r]["self_us"]
            acc["excess_us"] += excess
        if straggler is not None and total_excess > 0:
            acc = rank_acc(straggler)
            acc["blamed_us"] += total_excess
            acc["blamed_ops"] += 1
        out_ops.append({
            "cseq": cseq,
            "op": first.get("op"),
            "algo": first.get("algo"),
            "bytes": first.get("bytes", 0),
            "straggler": straggler if total_excess > 0 else None,
            "excess_us": total_excess,
            "ranks": ranks_out,
        })
    return {"ops": out_ops, "by_rank": by_rank}


def leaderboard(attributed: dict) -> List[dict]:
    """Straggler leaderboard from an :func:`attribute` result: one row
    per rank, sorted by total blamed time descending — the rank at the
    top is the one the rest of the job spends the most time waiting
    for."""
    rows = []
    for rank, acc in attributed.get("by_rank", {}).items():
        rows.append({"rank": rank, **acc})
    rows.sort(key=lambda row: (-row["blamed_us"], row["rank"]))
    return rows


_PHASE_ORDER = ("pack", "post", "wire_wait", "reduce", "unpack",
                "intra", "inter", "fanout")


def to_perfetto(snapshots: Iterable[dict]) -> str:
    """Chrome trace-event JSON with per-rank phase tracks.

    One row per rank (pid = rank); each op renders as a span on tid 0
    with its phases as consecutive child spans on tid 1. Phase
    sub-spans are laid out sequentially from the op's start in
    canonical order — an approximation (pipelined schedules interleave
    phases), but the AREA of each phase bar is exact, which is what the
    breakdown reads. Timestamps are per-host CLOCK_MONOTONIC and never
    comparable across machines, so each rank's track is normalized to
    ITS OWN first op (ts 0 = that rank's earliest start) — rows line up
    by relative position, not by a cross-host clock that would offset
    tracks by boot-time differences. Load in ui.perfetto.dev."""
    events = []
    pids = set()
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        rank = int(snap.get("rank", -1))
        if rank < 0:
            continue
        pids.add(rank)
        origin = min((int(op.get("start_us", 0))
                      for op in snap.get("ops", [])), default=0)
        for op in snap.get("ops", []):
            start = int(op.get("start_us", 0)) - origin
            total = max(int(op.get("total_us", 0)), 1)
            name = str(op.get("op", "?"))
            if op.get("algo"):
                name += f"[{op['algo']}]"
            args = {"cseq": op.get("cseq"), "bytes": op.get("bytes")}
            events.append({"name": name, "ph": "X", "ts": start,
                           "dur": total, "pid": rank, "tid": 0,
                           "args": args})
            cursor = start
            for phase in _PHASE_ORDER:
                us = int(op.get("phases", {}).get(phase, 0))
                if us <= 0:
                    continue
                events.append({"name": phase, "ph": "X", "ts": cursor,
                               "dur": us, "pid": rank, "tid": 1,
                               "args": {"cseq": op.get("cseq")}})
                cursor += us
    meta = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"rank {pid}"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "ops"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"name": "phases"}})
    return json.dumps(meta + events)
