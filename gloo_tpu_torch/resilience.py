"""Failure recovery: rebuild the process group after a rank dies.

Counterpart of gloo_tpu/resilience.py over the port's host plane
(gloo_tpu_torch.core). A transport failure poisons the context, and the
application re-rendezvouses: `rebuild_after_failure` coordinates the
survivors of a failed collective into a fresh, contiguous, smaller group
over the same store.

Protocol (store-side, no working mesh required):
 1. every survivor announces itself under a new generation namespace
    (``rebuild/<generation>``) and bumps a membership counter;
 2. survivors wait a settle window for stragglers, then read the final
    count and the announced ranks;
 3. old ranks map to new contiguous ranks by sort order, and a normal
    full-mesh bootstrap runs in the generation's namespace.

Generations make retries safe: a survivor that crashes during a rebuild
just triggers another round with generation + 1.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional, Tuple

from gloo_tpu_torch import core
from gloo_tpu_torch.utils.flightrec import (TAIL_K, DesyncError,
                                            describe_event, detect_desync)

def _flightrec_tail(failed_context) -> Optional[dict]:
    """Compact flight-recorder tail for the store exchange: the last
    TAIL_K COLLECTIVE ops' (cseq, fingerprint, description, state) plus
    the frontier seq — everything the cross-rank desync comparison
    needs, at store-value size. Collectives only: p2p entries carry no
    comparable cseq/fingerprint, and a p2p-heavy workload must not flush
    the collective evidence out of the exchanged window
    (docs/flightrec.md "Desync detection")."""
    try:
        fr = failed_context.flightrec()
    except Exception:  # noqa: BLE001 - a dead context must not block rebuild
        return None
    events = [e for e in fr.get("events", [])
              if e.get("cseq") is not None][-TAIL_K:]
    if not events:
        return None
    return {"next_seq": fr.get("next_seq", 0),
            "tail": [{"seq": e["seq"], "cseq": e["cseq"],
                      "fp": e["fp"], "state": e.get("state"),
                      "desc": describe_event(e)} for e in events]}


def _stall_evidence(failed_context) -> Optional[dict]:
    """Extract the failure verdict from a poisoned context: which peer
    this rank was blocked on (watchdog stall), or — when the watchdog
    never fired because detection was EOF-fast, e.g. a SIGKILL'd peer —
    which peer's link died first (the transport-failure record
    Context.onPairError feeds). Either way the evidence also carries the
    flight recorder's fingerprint tail, so the collected reports can
    distinguish a stalled-but-matching schedule from a desync
    (analyze_stall_reports). Returns None when no source has anything
    to say (or the context is unreadable)."""
    evidence = None
    try:
        snap = failed_context.metrics()
    except Exception:  # noqa: BLE001 - a dead context must not block rebuild
        snap = None
    if snap is not None:
        last = snap.get("watchdog", {}).get("last")
        failure = snap.get("transport_failure")
        if last:
            evidence = {"suspect": last.get("peer", -1),
                        "op": last.get("op"), "slot": last.get("slot"),
                        "waited_ms": last.get("waited_us", 0) // 1000}
            peer = last.get("peer", -1)
            transport = snap.get("transport", {})
            if peer in transport:
                evidence["peer_progress_age_ms"] = (
                    transport[peer].get("last_progress_age_us", -1) // 1000)
        elif failure and failure.get("peer", -1) >= 0:
            evidence = {"suspect": failure["peer"], "op": "transport",
                        "error": str(failure.get("message", ""))[:160],
                        "failures": failure.get("count", 1)}
    tail = _flightrec_tail(failed_context)
    if evidence is None and tail is None:
        return None
    if evidence is None:
        # No single peer to blame (e.g. a timeout caused by a schedule
        # desync) — the fingerprint tail IS the evidence.
        evidence = {"suspect": -1, "op": None}
    if tail is not None:
        evidence["flightrec"] = tail
    return evidence


def stall_reports(store: core.Store, generation: int,
                  old_size: int) -> Dict[int, dict]:
    """Read every survivor's published stall evidence for `generation`
    (written by rebuild_after_failure when failed_context is passed).
    The modal NON-NEGATIVE `suspect` across reports is the rank to
    blame — since the flight recorder, ranks with nothing to blame also
    publish (suspect -1, fingerprint tail only), so filter those out or
    use `analyze_stall_reports`, which applies the full blame order
    (desync > modal suspect) and names the culprit for you."""
    gen = core.PrefixStore(store, f"rebuild/{generation}")
    reports = {}
    for r in range(old_size):
        try:
            raw = gen.get(f"stall/{r}", timeout=0.001)
        except core.Error:
            continue
        try:
            reports[r] = json.loads(raw.decode())
        except ValueError:
            continue
    return reports


def analyze_stall_reports(reports: Dict[int, dict]) -> dict:
    """Cross-rank verdict over `stall_reports` output.

    Returns {"kind": "desync" | "stall" | "unknown", "blamed_ranks",
    "message", "desync": <detect_desync report or None>,
    "suspects": {rank: votes}}. A fingerprint mismatch at a shared seq
    (two ranks issued DIFFERENT collectives) wins over everything else:
    a desync explains every downstream stall, and no rebuild can fix
    it — the application's schedule itself diverged. Raise it as a
    typed error with `raise_on_desync_reports`."""
    tails = {r: rep.get("flightrec", {}).get("tail", [])
             for r, rep in reports.items()}
    desync = detect_desync(tails)
    suspects: Dict[int, int] = {}
    for rep in reports.values():
        s = rep.get("suspect", -1)
        if isinstance(s, int) and s >= 0:
            suspects[s] = suspects.get(s, 0) + 1
    if desync is not None:
        return {"kind": "desync", "blamed_ranks": desync["blamed_ranks"],
                "message": desync["message"], "desync": desync,
                "suspects": suspects}
    if suspects:
        top = max(suspects.items(), key=lambda kv: kv[1])[0]
        return {"kind": "stall", "blamed_ranks": [top],
                "message": f"survivors blame rank {top}", "desync": None,
                "suspects": suspects}
    return {"kind": "unknown", "blamed_ranks": [],
            "message": "no evidence published", "desync": None,
            "suspects": {}}


def raise_on_desync_reports(reports: Dict[int, dict]) -> dict:
    """`analyze_stall_reports`, raising the typed ``DesyncError`` when
    the reports show a schedule divergence; returns the verdict
    otherwise."""
    verdict = analyze_stall_reports(reports)
    if verdict["kind"] == "desync":
        raise DesyncError(verdict["message"], verdict)
    return verdict


def rebuild_after_failure(store: core.Store, device: core.Device,
                          old_rank: int, old_size: int, generation: int,
                          settle: float = 1.0, timeout: float = 30.0,
                          min_size: int = 2, failed_context=None
                          ) -> Tuple[Optional[core.Context], int, int]:
    """Form a new group from whoever shows up.

    Returns (context, new_rank, new_size); context is None when fewer than
    `min_size` survivors remain (caller decides whether to continue solo).
    `generation` must increase on every rebuild attempt (start at 1).

    Pass the poisoned context as `failed_context` to feed the straggler
    watchdog's evidence into recovery: this rank's last-stall record
    (which peer/slot it was blocked on, per docs/observability.md) is
    published under the generation namespace so survivors — and the
    operator — can cite WHICH rank stalled instead of guessing. Read the
    collected evidence with `stall_reports(store, generation, old_size)`.
    """
    gen = core.PrefixStore(store, f"rebuild/{generation}")
    if failed_context is not None:
        evidence = _stall_evidence(failed_context)
        if evidence is not None:
            gen.set(f"stall/{old_rank}", json.dumps(evidence).encode())
    gen.set(f"alive/{old_rank}", str(time.time()).encode())
    gen.add("count", 1)
    deadline = time.time() + timeout

    # Membership settles when no new survivor has announced for `settle`
    # seconds. Survivors detect the failure at different times — a rank
    # blocked on the dead peer only notices at its operation timeout — so
    # `settle` must exceed the slowest survivor's detection lag (bound it
    # by the per-op timeout your collectives use).
    def roll_call():
        found = []
        for r in range(old_size):
            try:
                gen.get(f"alive/{r}", timeout=0.001)
                found.append(r)
            except core.Error:
                continue
        return found

    last = -1
    last_change = time.time()
    survivors = []
    while True:
        count = gen.add("count", 0)
        now = time.time()
        if count != last:
            last, last_change = count, now
        elif now - last_change >= settle:
            survivors = roll_call()
            # Re-verify: anyone arriving during the roll call restarts the
            # settle window instead of being split-brained out.
            if gen.add("count", 0) == last and len(survivors) == last:
                break
        if now > deadline:
            survivors = roll_call()
            break
        time.sleep(0.05)

    if len(survivors) < min_size or old_rank not in survivors:
        return None, -1, len(survivors)

    new_rank = survivors.index(old_rank)
    new_size = len(survivors)
    ctx = core.Context(new_rank, new_size, timeout=timeout)
    ctx.connect_full_mesh(core.PrefixStore(gen, "mesh"), device)
    if new_rank == 0:
        _reap_generation(gen)
    return ctx, new_rank, new_size


def _reap_generation(gen: core.Store) -> None:
    """Reap this generation's bootstrap keys once the mesh is up, so
    repeated rebuilds against one long-lived store don't leak a full
    O(n^2) mesh-blob namespace per generation. Safe from new rank 0
    after its connect returns: every survivor batch-reads ALL mesh
    blobs before dialing rank 0, so a fully-accepted rank 0 proves the
    store phase is globally over. Scope discipline: only the bootstrap
    families go — `mesh/tc/` (address blobs + topology fingerprints)
    plus the roll-call keys — because POST-rebuild traffic (splits,
    tuner elections) rides the same store under `mesh/tpucoll/` and a
    wholesale reap would race it. The `stall/<rank>` evidence keys are
    deliberately KEPT — they are the post-mortem record stall_reports /
    analyze_stall_reports read after the fact (docs/faults.md)."""
    try:
        for key in gen.list("mesh/tc/"):
            gen.delete(key)
        for key in gen.list("alive/"):
            gen.delete(key)
        gen.delete("count")
    except core.Error:
        # Hygiene must never turn a successful rebuild into a failure.
        pass
