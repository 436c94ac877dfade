"""Collective schedule plane: algorithms as data.

The native core's collectives historically lived only as hand-written
C++ (ring / halving-doubling / bcube / ...). The schedule plane makes
the communication pattern itself a first-class, inspectable value: a
schedule is a rank-parameterized program of ``send`` / ``recv`` /
``recv_reduce`` / ``reduce_local`` / ``copy`` / ``encode`` / ``decode``
steps over chunk ids with explicit dependency edges
(csrc/tpucoll/schedule/ir.h). A static verifier proves a schedule
computes its declared collective (every chunk reduced exactly once,
delivered everywhere, deadlock-free); an interpreter lowers verified
schedules onto the existing transport through the plan cache, so warm
replays stay zero-allocation exactly like the native algorithms.

Generators (``generate()``) emit the known families — including shapes
the native core has no hardcoded implementation for, like the
chunked-pipelined ring (``ring`` with ``depth`` > 1) and the two-level
hierarchy (``hier`` with ``ranks_per_host``) — and ``sweep()`` measures
a parameter grid on the live fabric, electing the best schedule per
(collective, world, size-bucket) cell wherever one beats the native
algorithms.

Determinism contract
--------------------
Identical to the tuning table (tuning.py): every rank must
install byte-identical schedule JSON or groups disagree on the dispatch
and deadlock mid-collective. ``sweep()`` owns that contract (rank 0's
elections are broadcast and installed everywhere); ``install()`` is the
manual path and the caller owns it. Installation verifies and resolves
every schedule for the context's world size BEFORE swapping the plane —
a malformed or invalid table raises and leaves the previous plane (and
the plan cache) untouched.

Workflow
--------
>>> table = schedule.sweep(ctx)                 # all ranks, collectively
>>> if ctx.rank == 0:
...     schedule.save(table, "sched.json")
then in later jobs either ``TPUCOLL_SCHEDULE_FILE=sched.json`` (loaded
and installed at context connect) or::
>>> schedule.install(ctx, schedule.load("sched.json"))

``bench.py --schedule-sweep`` drives the sweep standalone; see
docs/schedules.md for the IR, the JSON format, and the election rules.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence, Union

import torch

from gloo_tpu_torch import _lib
from gloo_tpu_torch._lib import check
from gloo_tpu_torch.core import Context

__all__ = [
    "install",
    "installed",
    "clear",
    "list_schedules",
    "describe",
    "generate",
    "families",
    "verify",
    "merge",
    "sweep",
    "save",
    "load",
]

TableLike = Union[dict, str]


def _copy_out(fn, *args) -> str:
    return _lib.copy_out(fn, *args).decode()


def _to_json_str(table: TableLike) -> str:
    if isinstance(table, str):
        return table
    return json.dumps(table)


def install(context: Context, table: TableLike) -> None:
    """Install a schedule table (dict or JSON string) on THIS rank.

    Every schedule matching the context's world size is statically
    verified and resolved before the swap; failures raise Error and
    leave the previously installed plane untouched. Installing clears
    the plan cache (schedules change what a cached plan would replay),
    exactly like tuning.install_table. The caller owns the every-rank-
    same-bytes contract.
    """
    check(_lib.lib().tc_schedule_install(
        context._handle, _to_json_str(table).encode()))


def installed(context: Context) -> Optional[dict]:
    """The installed schedule table as a dict, or None."""
    raw = _copy_out(_lib.lib().tc_schedule_json, context._handle)
    return json.loads(raw) if raw else None


def clear(context: Context) -> None:
    """Remove the installed plane; dispatch reverts to the native
    algorithms (and clears the plan cache)."""
    check(_lib.lib().tc_schedule_install(context._handle, None))


def list_schedules(context: Context) -> list:
    """Summaries of installed schedules:
    ``[{"name", "collective", "world_size", "steps", "resolved"}]``.
    ``resolved`` is 1 when the schedule matches this context's world
    (its elections can fire)."""
    return json.loads(_copy_out(_lib.lib().tc_schedule_list, context._handle))


def describe(context: Context, name: str) -> dict:
    """One installed schedule in full, as a single-schedule table dict
    (the same shape ``install`` accepts). Raises for unknown names."""
    return json.loads(_copy_out(
        _lib.lib().tc_schedule_describe, context._handle, name.encode()))


def generate(family: str, world_size: int,
             params: Optional[dict] = None) -> dict:
    """Generate + verify one schedule; returns a single-schedule table
    dict. Context-free. ``params`` is a dict of integer generator
    parameters (e.g. ``{"depth": 2}`` for the pipelined ring,
    ``{"ranks_per_host": 2}`` for the two-level hierarchy)."""
    raw = _copy_out(
        _lib.lib().tc_schedule_generate, family.encode(), world_size,
        json.dumps(params).encode() if params else None)
    return json.loads(raw)


def families() -> list:
    """Names of the built-in schedule generator families."""
    return json.loads(_copy_out(_lib.lib().tc_schedule_families))


def verify(table: TableLike) -> None:
    """Statically verify every schedule in a table (all ranks of each
    schedule's declared world). Context-free; raises Error with the
    verifier's typed, step-naming message on the first failure."""
    check(_lib.lib().tc_schedule_verify(_to_json_str(table).encode()))


def merge(*tables: TableLike) -> dict:
    """Union several tables into one (schedule names must not collide;
    later elections win their cells)."""
    out = {"version": 1, "schedules": [], "elections": []}
    seen = set()
    for t in tables:
        d = json.loads(_to_json_str(t))
        for s in d.get("schedules", []):
            if s["name"] in seen:
                raise ValueError(f"duplicate schedule name {s['name']!r}")
            seen.add(s["name"])
            out["schedules"].append(s)
        for e in d.get("elections", []):
            out["elections"] = [
                x for x in out["elections"]
                if (x["collective"], x["world_size"], x.get("dtype", ""),
                    x["bucket"]) != (e["collective"], e["world_size"],
                                     e.get("dtype", ""), e["bucket"])
            ]
            out["elections"].append(e)
    return out


def _default_candidates(world: int) -> list:
    """The default sweep grid: (family, params) pairs that generate for
    ``world``. Pipelined-ring depths scale the chunk pipeline; hier
    shapes try the divisors of the world size."""
    cands = [("ring", {"depth": 1}), ("ring", {"depth": 2}),
             ("ring", {"depth": 4}), ("hd", {}), ("bcube", {})]
    for rph in (2, 4):
        if world % rph == 0 and world // rph >= 2:
            cands.append(("hier", {"ranks_per_host": rph}))
    return cands


def _cand_name(family: str, params: dict, world: int) -> str:
    suffix = "".join(f"_{k[0]}{v}" for k, v in sorted(params.items()))
    return f"{family}{suffix}_p{world}"


def _time_allreduce(context: Context, nbytes: int, iters: int,
                    warmup: int, tag: int) -> float:
    """Median-of-iters wall time for one float32 sum allreduce of a host
    tensor (the table governs the native transport, which sees host
    memory whatever a CUDA tensor is staged through)."""
    arr = torch.ones(nbytes // 4, dtype=torch.float32)
    for _ in range(warmup):
        context.allreduce(arr, tag=tag)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        context.allreduce(arr, tag=tag)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def sweep(context: Context, min_bytes: int = 1 << 10,
          max_bytes: int = 1 << 20, iters: int = 8, warmup: int = 2,
          tag: int = 0,
          candidates: Optional[Sequence] = None) -> dict:
    """Measure the generator grid and elect winning schedules per cell.

    COLLECTIVE: every rank must call concurrently with identical
    arguments. For each log2 size bucket in [min_bytes, max_bytes] the
    sweep times the native kAuto dispatch (schedule plane cleared),
    then each candidate schedule (installed with a single election for
    that exact cell), all on float32 sum allreduce. Rank 0 elects the
    fastest candidate for every cell where it beats native, broadcasts
    the resulting table, and every rank installs those same bytes.

    Returns the installed table as a dict — empty elections mean native
    won everywhere. ``candidates`` overrides the default grid with
    (family, params) pairs.
    """
    world = context.size
    prior = installed(context)
    cands = list(candidates) if candidates is not None \
        else _default_candidates(world)
    # Generate + verify every candidate up front (identical on all
    # ranks: generators are deterministic).
    named = []  # (name, single-schedule table dict)
    for family, params in cands:
        t = generate(family, world, params)
        named.append((_cand_name(family, params, world), t))

    sizes = []
    nbytes = 1 << (min_bytes - 1).bit_length()  # round up to a pow2
    while nbytes <= max_bytes:
        sizes.append(nbytes)
        nbytes *= 2
    results = {}  # (name, nbytes) -> seconds; name None = native
    for size in sizes:
        clear(context)
        context.barrier(tag=tag)
        results[(None, size)] = _time_allreduce(
            context, size, iters, warmup, tag)
        bucket = size.bit_length() - 1
        for name, table in named:
            one = json.loads(json.dumps(table))
            one["schedules"][0]["name"] = name
            one["elections"] = [{
                "collective": "allreduce", "world_size": world,
                "dtype": "", "bucket": bucket, "schedule": name,
            }]
            install(context, one)
            context.barrier(tag=tag)
            results[(name, size)] = _time_allreduce(
                context, size, iters, warmup, tag)
    clear(context)

    # Rank 0 elects; everyone installs rank 0's bytes.
    if context.rank == 0:
        elected = {"version": 1, "schedules": [], "elections": []}
        used = set()
        for size in sizes:
            native = results[(None, size)]
            best, best_t = None, native
            for name, _ in named:
                if results[(name, size)] < best_t:
                    best, best_t = name, results[(name, size)]
            if best is not None:
                used.add(best)
                elected["elections"].append({
                    "collective": "allreduce", "world_size": world,
                    "dtype": "", "bucket": size.bit_length() - 1,
                    "schedule": best,
                })
        for name, table in named:
            if name in used:
                s = json.loads(json.dumps(table))["schedules"][0]
                s["name"] = name
                elected["schedules"].append(s)
        payload = json.dumps(elected).encode()
    else:
        payload = b""
    n = torch.tensor([len(payload)], dtype=torch.int64)
    context.broadcast(n, root=0, tag=tag)
    buf = torch.zeros(int(n[0]), dtype=torch.uint8)
    if context.rank == 0:
        buf[:] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    context.broadcast(buf, root=0, tag=tag)
    table = json.loads(buf.numpy().tobytes().decode())
    install(context, table)
    # The sweep intentionally discards any previously installed plane:
    # its elections were measured under different conditions. Callers
    # wanting to keep them can merge() with the prior table themselves.
    del prior
    return table


def save(table: TableLike, path: str) -> None:
    """Write a table to a JSON file (the TPUCOLL_SCHEDULE_FILE format)."""
    with open(path, "w") as f:
        f.write(_to_json_str(table))
        f.write("\n")


def load(path: str) -> dict:
    """Read a table written by save() / sweep()."""
    with open(path) as f:
        return json.load(f)
