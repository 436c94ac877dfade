"""Cross-rank causal critical-path extraction over span streams.

The native span recorder (csrc/tpucoll/common/span.h,
docs/critpath.md) emits one causal span per phase instance of every
collective — annotated wire sends ("send"), FIFO-attributed arrivals
("recv"), drain waits ("wait"), local work ("local") — keyed by the
flight recorder's cross-rank collective sequence number ``cseq`` and a
per-op emission ordinal ``id``. This module is the cross-rank half:

- :func:`merge` joins per-rank ``Context.spans()`` snapshots by
  ``cseq`` into one span set per collective;
- :func:`analyze` builds each collective's causal graph — intra-rank
  program-order edges plus send->recv wire edges matched by
  ``(sender, receiver)`` FIFO ordinal — extracts the **longest weighted
  path** ending at the op's last-finishing span, attributes every
  segment of the op's latency to the span that gated it, and computes
  per-span **slack** (how far a span's finish could slip before it
  extends the op);
- :func:`to_perfetto` renders per-rank span tracks (Chrome trace-event
  JSON) with the critical path flagged on its own track.

Wire matching needs no timestamps: the k-th "send" span rank a emits
toward b pairs with the k-th "recv" span rank b emits from a (both
streams are in deterministic program order; the slot and byte count
ride along as sanity checks, mismatches are surfaced not guessed
around). Timestamps are per-host CLOCK_MONOTONIC; ``clock="auto"``
compares them raw when the per-rank origins sit within
:data:`CLOCK_SKEW_LIMIT_US` of each other (threads / processes on one
host share the clock) and falls back to aligning each rank's origin —
its earliest span in the first common collective — when they do not
(distinct hosts, distinct boot times). Force ``"raw"`` or ``"align"``
to override.

The port's copy of gloo_tpu/utils/critpath.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "CLOCK_SKEW_LIMIT_US",
    "analyze",
    "dump",
    "merge",
    "merge_by_group",
    "to_perfetto",
]

# Per-rank origins further apart than this (10 s) cannot be one host's
# monotonic clock observed through thread scheduling; auto mode aligns.
CLOCK_SKEW_LIMIT_US = 10_000_000


def dump(ctx, directory: str) -> str:
    """Write ``ctx.spans()`` to ``directory/spans-rank<r>.json`` (the
    file layout ``tools/critpath_view.py`` globs) and return the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spans-rank{ctx.rank}.json")
    with open(path, "w") as f:
        json.dump(ctx.spans(), f)
    return path


def merge(snapshots: Iterable[dict], group: Optional[str] = None,
          ) -> dict:
    """Join per-rank ``Context.spans()`` snapshots by ``cseq``.

    Returns ``{"group": g, "ranks": [r, ...], "size": n,
    "duplicates": [r, ...], "skipped_groups": [g, ...],
    "ops": {cseq: {rank: [span, ...]}}}`` with each rank's span list in
    emission (``id``) order. Spans whose cseq is null (p2p ops) are
    skipped. The same two rails as ``utils.profile.merge``: one
    communicator per merge (mismatched ``group`` tags are skipped, use
    :func:`merge_by_group` for mixed sets) and one snapshot per rank
    (the last wins, the rank lands in ``duplicates``)."""
    by_rank: Dict[int, dict] = {}
    duplicates: List[int] = []
    skipped_groups: List[str] = []
    size = 0
    for snap in snapshots:
        if not isinstance(snap, dict) or "spans" not in snap:
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
    ops: Dict[int, Dict[int, List[dict]]] = {}
    for rank, snap in by_rank.items():
        for span in snap.get("spans", []):
            cseq = span.get("cseq")
            if cseq is None:
                continue
            ops.setdefault(int(cseq), {}).setdefault(rank,
                                                     []).append(span)
    for per_rank in ops.values():
        for spans in per_rank.values():
            spans.sort(key=lambda s: int(s.get("id", 0)))
    return {"group": group or "", "ranks": sorted(by_rank),
            "size": size, "duplicates": sorted(duplicates),
            "skipped_groups": sorted(skipped_groups), "ops": ops}


def merge_by_group(snapshots: Iterable[dict]) -> Dict[str, dict]:
    """Partition snapshots by ``group`` tag, then :func:`merge` each
    partition (disjoint communicators must never be cseq-compared)."""
    partitions: Dict[str, List[dict]] = {}
    for snap in snapshots:
        if not isinstance(snap, dict) or "spans" not in snap:
            continue
        partitions.setdefault(str(snap.get("group", "") or ""),
                              []).append(snap)
    return {g: merge(snaps, group=g)
            for g, snaps in sorted(partitions.items())}


def _origins(merged: dict) -> Dict[int, int]:
    """Per-rank clock origin: the rank's earliest span start in the
    first cseq every merged rank participates in (all ranks enter a
    collective within one schedule of each other, so the origins bound
    the clock offsets), falling back to the rank's earliest span."""
    ranks = set(merged.get("ranks", []))
    common = None
    for cseq in sorted(merged.get("ops", {})):
        if set(merged["ops"][cseq]) == ranks:
            common = cseq
            break
    origins: Dict[int, int] = {}
    for rank in ranks:
        t0s: List[int] = []
        if common is not None and rank in merged["ops"][common]:
            t0s = [int(s.get("t0_us", 0))
                   for s in merged["ops"][common][rank]]
        if not t0s:
            t0s = [int(s.get("t0_us", 0))
                   for per in merged.get("ops", {}).values()
                   for r, spans in per.items() if r == rank
                   for s in spans]
        origins[rank] = min(t0s) if t0s else 0
    return origins


def _resolve_clock(merged: dict, clock: str) -> Tuple[str, Dict[int, int]]:
    origins = _origins(merged)
    if clock == "raw":
        return "raw", {r: 0 for r in origins}
    if clock == "align":
        return "align", origins
    if clock != "auto":
        raise ValueError(f"clock must be auto/raw/align, got {clock!r}")
    if origins and (max(origins.values()) - min(origins.values())
                    > CLOCK_SKEW_LIMIT_US):
        return "align", origins
    return "raw", {r: 0 for r in origins}


class _Node:
    __slots__ = ("rank", "span", "t0", "t1", "preds", "deps", "wire")

    def __init__(self, rank: int, span: dict, shift: int):
        self.rank = rank
        self.span = span
        self.t0 = int(span.get("t0_us", 0)) - shift
        self.t1 = int(span.get("t1_us", 0)) - shift
        self.preds: List["_Node"] = []
        self.deps: List["_Node"] = []
        self.wire: Optional["_Node"] = None

    def row(self) -> dict:
        s = self.span
        return {"rank": self.rank, "id": s.get("id"),
                "kind": s.get("kind"), "phase": s.get("phase"),
                "peer": s.get("peer"), "slot": s.get("slot"),
                "bytes": s.get("bytes", 0), "t0_us": self.t0,
                "t1_us": self.t1}


def _build_graph(per_rank: Dict[int, List[dict]],
                 shifts: Dict[int, int],
                 ) -> Tuple[List[_Node], Dict[str, int]]:
    """One collective's causal DAG: program-order chains per rank plus
    send->recv edges matched by directed-pair FIFO ordinal."""
    nodes: List[_Node] = []
    sends: Dict[Tuple[int, int], List[_Node]] = {}
    recvs: Dict[Tuple[int, int], List[_Node]] = {}
    for rank in sorted(per_rank):
        prev: Optional[_Node] = None
        for span in per_rank[rank]:
            node = _Node(rank, span, shifts.get(rank, 0))
            if prev is not None:
                node.preds.append(prev)
                prev.deps.append(node)
            prev = node
            nodes.append(node)
            peer = span.get("peer")
            if peer is None:
                continue
            if span.get("kind") == "send":
                sends.setdefault((rank, int(peer)), []).append(node)
            elif span.get("kind") == "recv":
                recvs.setdefault((int(peer), rank), []).append(node)
    unmatched = {"sends": 0, "recvs": 0, "mismatched": 0}
    for pair, recv_q in recvs.items():
        send_q = sends.get(pair, [])
        for k, recv in enumerate(recv_q):
            if k >= len(send_q):
                unmatched["recvs"] += 1
                continue
            send = send_q[k]
            if (send.span.get("slot") != recv.span.get("slot") or
                    send.span.get("bytes") != recv.span.get("bytes")):
                unmatched["mismatched"] += 1
            recv.preds.append(send)
            recv.wire = send
            send.deps.append(recv)
        if len(send_q) > len(recv_q):
            unmatched["sends"] += len(send_q) - len(recv_q)
    for pair, send_q in sends.items():
        if pair not in recvs:
            unmatched["sends"] += len(send_q)
    return nodes, unmatched


# A drain wait that merely OBSERVES an arrival finishes this much later
# than the arrival it observed (scheduling latency of the waiting
# thread). Within this window the wire edge is the cause, not the wait.
_OBSERVATION_EPS_US = 1000


def _walk_critical_path(nodes: List[_Node]) -> List[dict]:
    """Backward walk from the last-finishing span: at each span the
    binding predecessor is the latest-finishing one, and the segment
    ``[max(pred.t1, t0), t1]`` of the op's latency is attributed to the
    span that spent it, clipped below the previously attributed
    segment — segments stay disjoint, so the rows' contribs never sum
    past the op's total. Returned origin-first, each row carrying
    ``contrib_us``.

    One asymmetry: at a matched recv that sat blocked on the wire
    beyond scheduling noise while its rank's local chain was already
    done by the arrival, a program-order predecessor finishing within
    observation latency of the arrival is a drain wait that merely
    *noticed* the message — the walk hops the wire to the sender that
    caused the stall instead of stranding the blocked time on the
    waiting rank."""
    if not nodes:
        return []
    # Ties on t1 go to the later-emitted span of the lower rank: at
    # equal finish times the later program-order span is the one that
    # actually closed the op (a drain wait and the recv it observed
    # round to the same microsecond).
    cur = max(nodes, key=lambda n: (n.t1, -n.rank,
                                    int(n.span.get("id", 0))))
    rows: List[dict] = []
    seen = set()
    # Everything at or above `horizon` is already attributed. A span on
    # the chain is credited only below it — a predecessor can outlive
    # the point where it gated (a send's post call returning after the
    # message was consumed), and its overlap with downstream segments
    # was not gating anything.
    horizon = cur.t1
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        pred = None
        if cur.preds:
            pred = max(cur.preds, key=lambda p: p.t1)
        gate = max(pred.t1, cur.t0) if pred is not None else cur.t0
        if pred is not None:
            wire = cur.wire
            # cur.t1 is the arrival. The wire was the binding gate iff
            # this rank sat blocked on it beyond scheduling noise
            # (arrival far after the recv post), its local chain was
            # done by the arrival (a program pred finishing within
            # observation latency of cur.t1 is the drain wait that
            # merely noticed this message), AND the matched send was
            # still in flight at the recv post — arrival stamps are
            # observation-derived, so a message that landed long ago
            # still shows a late arrival on a busy receiver. Only with
            # all three follow the sender; otherwise the local chain
            # is the cause.
            if (wire is not None and pred is not wire
                    and wire.t1 >= cur.t0
                    and cur.t1 - cur.t0 > _OBSERVATION_EPS_US
                    and pred.t1 - cur.t1 <= _OBSERVATION_EPS_US):
                pred = wire
        hi = min(cur.t1, horizon)
        lo = max(gate, cur.t0)
        row = cur.row()
        row["contrib_us"] = max(hi - lo, 0)
        horizon = min(hi, lo)
        rows.append(row)
        cur = pred
    rows.reverse()
    return rows


def _slacks(nodes: List[_Node], end_us: int) -> None:
    """Backward propagation of each span's latest allowable finish:
    sinks may finish at the op's end; elsewhere a span may finish no
    later than every dependent's latest finish minus the dependent's
    own gated busy time. Stored on the node's span row by the caller.
    An approximation (a dependent's busy time is treated as fixed), but
    exact on the critical path, which pins slack 0 where it matters."""
    order: List[_Node] = []
    indeg = {id(n): len(n.deps) for n in nodes}
    stack = [n for n in nodes if not n.deps]
    while stack:
        n = stack.pop()
        order.append(n)
        for p in n.preds:
            indeg[id(p)] -= 1
            if indeg[id(p)] == 0:
                stack.append(p)
    latest = {id(n): end_us for n in nodes}
    for n in order:
        if not n.deps:
            latest[id(n)] = end_us
            continue
        allowed = []
        for d in n.deps:
            gate = max([p.t1 for p in d.preds] + [d.t0])
            busy = max(d.t1 - gate, 0)
            allowed.append(latest[id(d)] - busy)
        latest[id(n)] = min(allowed)
    for n in nodes:
        n.span["_slack_us"] = max(latest[id(n)] - n.t1, 0)


def analyze(merged: dict, clock: str = "auto") -> dict:
    """Causal analysis of every merged collective.

    Returns ``{"clock": "raw"|"align", "ranks", "ops": [{"cseq", "op",
    "bytes", "start_us", "end_us", "total_us", "path": [row, ...],
    "attribution": {rank: {kind: us}}, "slack": [row, ...],
    "unmatched": {...}}, ...]}`` with ops sorted by cseq. ``path`` runs
    origin-first; each row's ``contrib_us`` is the stretch of the op's
    latency that span gated (the rows' contribs sum to ~``total_us``).
    ``attribution`` folds the path's contribs by (rank, kind) — the
    table ``critpath_view --check`` thresholds against. ``slack`` lists
    every span's headroom ascending (the leaderboard's tail is where
    optimization effort is wasted)."""
    mode, shifts = _resolve_clock(merged, clock)
    out_ops = []
    for cseq in sorted(merged.get("ops", {})):
        per_rank = merged["ops"][cseq]
        nodes, unmatched = _build_graph(per_rank, shifts)
        if not nodes:
            continue
        start = min(n.t0 for n in nodes)
        end = max(n.t1 for n in nodes)
        path = _walk_critical_path(nodes)
        _slacks(nodes, end)
        attribution: Dict[int, Dict[str, int]] = {}
        for row in path:
            kinds = attribution.setdefault(int(row["rank"]), {})
            kind = str(row["kind"])
            kinds[kind] = kinds.get(kind, 0) + int(row["contrib_us"])
        slack_rows = []
        for n in nodes:
            row = n.row()
            row["slack_us"] = n.span.pop("_slack_us", 0)
            slack_rows.append(row)
        slack_rows.sort(key=lambda r: (r["slack_us"], r["rank"],
                                       r["id"]))
        first = per_rank[min(per_rank)][0] if per_rank else {}
        out_ops.append({
            "cseq": cseq,
            "op": first.get("op"),
            "bytes": max((int(s.get("bytes", 0))
                          for spans in per_rank.values()
                          for s in spans), default=0),
            "start_us": start,
            "end_us": end,
            "total_us": end - start,
            "path": path,
            "attribution": attribution,
            "slack": slack_rows,
            "unmatched": unmatched,
        })
    return {"clock": mode, "ranks": merged.get("ranks", []),
            "ops": out_ops}


def to_perfetto(merged: dict, analysis: Optional[dict] = None,
                clock: str = "auto") -> str:
    """Chrome trace-event JSON with per-rank step tracks.

    One row per rank (pid = rank): tid 0 carries every span (named by
    kind, with id/peer/slot in args), tid 1 re-renders the spans on the
    critical path (``analysis`` defaults to :func:`analyze` of the same
    merge) so the cross-rank chain reads as a highlighted staircase.
    Timestamps follow the analysis' clock resolution, re-zeroed to the
    earliest span. Load in ui.perfetto.dev."""
    if analysis is None:
        analysis = analyze(merged, clock=clock)
    mode, shifts = _resolve_clock(merged, clock if clock != "auto"
                                  else analysis.get("clock", "auto"))
    events = []
    pids = set()
    origin = None
    for per_rank in merged.get("ops", {}).values():
        for rank, spans in per_rank.items():
            for s in spans:
                t0 = int(s.get("t0_us", 0)) - shifts.get(rank, 0)
                origin = t0 if origin is None else min(origin, t0)
    origin = origin or 0
    for cseq in sorted(merged.get("ops", {})):
        for rank, spans in merged["ops"][cseq].items():
            pids.add(rank)
            for s in spans:
                t0 = int(s.get("t0_us", 0)) - shifts.get(rank, 0)
                t1 = int(s.get("t1_us", 0)) - shifts.get(rank, 0)
                events.append({
                    "name": f"{s.get('kind')}:{s.get('op', '?')}",
                    "ph": "X", "ts": t0 - origin,
                    "dur": max(t1 - t0, 1), "pid": rank, "tid": 0,
                    "args": {"cseq": cseq, "id": s.get("id"),
                             "phase": s.get("phase"),
                             "peer": s.get("peer"),
                             "slot": s.get("slot"),
                             "bytes": s.get("bytes")}})
    for op in analysis.get("ops", []):
        for row in op.get("path", []):
            pids.add(row["rank"])
            events.append({
                "name": f"CRIT {row['kind']}"
                        + (f"->r{row['peer']}"
                           if row.get("peer") is not None else ""),
                "ph": "X", "ts": int(row["t0_us"]) - origin,
                "dur": max(int(row["t1_us"]) - int(row["t0_us"]), 1),
                "pid": row["rank"], "tid": 1,
                "args": {"cseq": op["cseq"],
                         "contrib_us": row["contrib_us"]}})
    meta = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"rank {pid}"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "spans"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 1, "args": {"name": "critical path"}})
    return json.dumps(meta + events)
