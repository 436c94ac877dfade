"""Deterministic fault injection for the transport stack (docs/faults.md).

The native fault plane (csrc/tpucoll/fault/) interposes on every outbound
wire message and connection attempt and fires scripted faults — delay,
stall, dup, truncate, corrupt, kill, connect_refuse — matched on
(rank, peer, opcode, slot, payload size, nth). This module is the Python
face of that plane: install a schedule, run the workload, read back the
deterministic firing report.

The table is **process-global** (one schedule per process, like the
connect debug logger): rules pin the injecting ``rank`` so in-process
multi-rank tests share it safely, and multiprocess jobs install the same
schedule in every worker (or set ``TPUCOLL_FAULT_FILE``, loaded at
context connect). With nothing installed, the transport hot path pays a
single predictable pointer check per message — production binaries carry
the plane for free.

The table belongs to the library that holds it: the port's own build of
the native core has its own, apart from that of any other build a
process loads, and ``TPUCOLL_FAULT_FILE`` is read by every build at
connect.

Determinism contract: same seed + same schedule + same per-rank workload
=> each rank's firing subsequence in :func:`report` is byte-identical
across runs (entries carry no timestamps; probabilistic rules draw from
a per-(rule, rank) PRNG seeded from the schedule seed).

Example::

    from gloo_tpu_torch import fault
    fault.install({"seed": 42, "faults": [
        {"when": {"rank": 1, "peer": 0, "opcode": "data", "nth": 3},
         "action": "delay", "ms": 200},
        {"when": {"rank": 2}, "action": "kill", "count": 1},
    ]})
    ...   # run collectives; rank 2's first matched send kills its pair
    fired = fault.report()
    fault.clear()

Every fired fault is also counted in the owning context's metrics
registry (``ctx.metrics()["faults"]``) and stamped into the span tracer
(``fault.delay`` etc.), so tests can assert exactly which fault fired
from either side.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

from gloo_tpu_torch import _lib
from gloo_tpu_torch._lib import check

__all__ = ["install", "clear", "report", "fired_count"]


def install(schedule: Union[dict, str]) -> None:
    """Install a fault schedule for this process, replacing any previous
    one and resetting the firing report.

    ``schedule`` is a dict (serialized here) or a pre-serialized JSON
    string::

        {"seed": <int, optional>,
         "faults": [{"when": {"rank", "peer", "opcode", "slot",
                              "min_bytes", "max_bytes", "nth"},
                     "action": "delay|stall|dup|truncate|corrupt|kill|"
                               "connect_refuse",
                     "ms": ..., "bytes": ..., "count": ...,
                     "prob": ..., "seed": ...}, ...]}

    All ``when`` fields are optional (match-any); see docs/faults.md for
    the full semantics. Malformed schedules raise ``gloo_tpu_torch.Error``.
    """
    if not isinstance(schedule, str):
        schedule = json.dumps(schedule)
    check(_lib.lib().tc_fault_install(schedule.encode()))


def clear() -> None:
    """Remove the installed schedule and firing report; the transport
    returns to its zero-cost (single pointer check) hot path."""
    _lib.lib().tc_fault_clear()


def report(rank: Optional[int] = None) -> List[Dict]:
    """The deterministic firing log, in firing order.

    Each entry is ``{"rank", "n", "rule", "action", "peer", "opcode",
    "slot", "nbytes", "channel", "domain"}`` where ``n`` indexes fires
    per (injecting rank, fault domain) — domain 0 is the root context,
    async-engine lanes carry lane + 1. With several in-process ranks
    (or async lanes) the global interleaving is scheduling-dependent,
    but each (rank, domain) subsequence is deterministic — pass ``rank``
    for that rank's slice, and sort by ``(domain, n)`` to canonicalize a
    run with concurrent lanes (docs/faults.md, "Determinism").
    """
    entries = json.loads(_lib.copy_out(_lib.lib().tc_fault_report))
    if rank is not None:
        entries = [e for e in entries if e["rank"] == rank]
    return entries


def fired_count(action: Optional[str] = None,
                rank: Optional[int] = None) -> int:
    """Convenience: how many faults have fired (optionally filtered by
    action name and/or injecting rank)."""
    return sum(1 for e in report(rank)
               if action is None or e["action"] == action)
