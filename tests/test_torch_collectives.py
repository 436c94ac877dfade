"""The rest of gloo_tpu_torch.core's collectives (reduce, gather, gatherv,
scatter, allgatherv, alltoall, alltoallv, allreduce_multi,
reduce_scatter_inplace, output=, timeout= and callable reductions) against
gloo_tpu.core's, bitwise.

Both sides run their ranks as threads of this process (tests/harness.spawn
for the reference, tests/test_torch_host.spawn for the port), on the same
numpy inputs made from a seed per rank; every result is compared as raw
bytes. The staged (CUDA) forms are in tests/test_torch_p2p_plans.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gloo_tpu_torch import _lib, core
from tests.test_torch_host import (DTYPES, OPS, _reference, rank_input, raw,
                                   spawn, to_torch)

# Elements per rank: 1 takes the small-payload branches, 1000 is not a
# multiple of any group size here and runs the schedules' chunking.
COUNTS = (1, 1000)
REDUCE_ALGORITHMS = ("auto", "binomial", "ring")
# torch has no add for the unsigned types wider than a byte; their
# wrapping sum has the bits of the signed sum of the same width.
_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def add(acc, inp):
    """A callable sum for either side: numpy arrays or torch tensors."""
    if isinstance(acc, torch.Tensor) and acc.dtype in _SIGNED:
        acc, inp = acc.view(_SIGNED[acc.dtype]), inp.view(_SIGNED[acc.dtype])
    acc += inp


def uneven(size: int, count: int, shift: int = 0):
    """Per-rank counts that differ and hold a 0 (a rank that sends or
    gets nothing), summing to size * count."""
    counts = [(count * (1 + (r + shift) % 3)) // 2 for r in range(size)]
    counts[(size - 1 + shift) % size] = 0
    counts[shift % size] += size * count - sum(counts)
    return counts


def _surface(lib, ctx, rank, name):
    """Every call of the case on one rank: {label: result bytes, or None
    where the call returns None}. `lib` is gloo_tpu (numpy in) or None for
    the port (torch in)."""
    port = lib is None
    size = ctx.size
    out = {}

    def data(x):
        return to_torch(x) if port else x.copy()

    def put(label, result):
        if isinstance(result, list):
            out[label] = [raw(r) for r in result]
        else:
            out[label] = None if result is None else raw(result)

    def empty(count, like):
        return torch.empty(count, dtype=like.dtype) if port \
            else np.empty(count, like.dtype)

    for count in COUNTS:
        x = rank_input(name, rank, count)
        for op in OPS:
            src = rank_input(name, rank, count, op)
            for root in range(size):
                algo = REDUCE_ALGORITHMS[root % 3]
                put(f"reduce {count} {op} root {root} {algo}",
                    ctx.reduce(data(src), root=root, op=op, algorithm=algo,
                               tag=20))
            put(f"allreduce_multi {count} {op}", ctx.allreduce_multi(
                [data(rank_input(name, rank + 10 * k, count, op))
                 for k in range(3)], op=op, tag=21))
            put(f"reduce_scatter_inplace {count} {op}",
                ctx.reduce_scatter_inplace(
                    data(rank_input(name, rank, count * size, op)),
                    recv_counts=uneven(size, count, 1), op=op, tag=22))
        d = data(x)
        target = empty(count, d) if rank == size - 1 else None
        put(f"reduce {count} output=", ctx.reduce(
            d, root=size - 1, output=target, tag=23, timeout=30.0))
        counts = uneven(size, count)
        mine = data(rank_input(name, rank, counts[rank]))
        for root in range(size):
            put(f"gather {count} root {root}",
                ctx.gather(data(x), root=root, tag=24))
            put(f"gatherv {count} root {root}",
                ctx.gatherv(mine, counts, root=root, tag=25))
            rows = data(rank_input(name, rank, size * count).reshape(
                size, count)) if rank == root else None
            put(f"scatter {count} root {root}", ctx.scatter(
                rows, root=root, output=empty(count, data(x)), tag=26))
        put(f"scatter {count} new output", ctx.scatter(
            data(x.reshape(1, -1).repeat(size, 0)) if rank == 0 else None,
            root=0, output=None if rank == 0 else empty(count, data(x)),
            tag=27))
        put(f"allgatherv {count}",
            ctx.allgatherv(mine, counts, tag=28, timeout=30.0))
        put(f"alltoall {count}", ctx.alltoall(
            data(rank_input(name, rank, size * count).reshape(size, count)),
            tag=29))
        in_counts = uneven(size, count, rank)
        # out_counts[r] is what rank r sends here: its in_counts[rank].
        out_counts = [uneven(size, count, r)[rank] for r in range(size)]
        put(f"alltoallv {count}", ctx.alltoallv(
            data(rank_input(name, rank, size * count)), in_counts,
            out_counts, tag=30))
        put(f"allgather {count} output=", ctx.allgather(
            data(x), output=empty(size * count, data(x)), tag=31,
            timeout=30.0))
        put(f"reduce_scatter {count} output=", ctx.reduce_scatter(
            data(rank_input(name, rank, count * size)),
            output=empty(count, data(x)), tag=32, timeout=30.0))
        put(f"allreduce {count} callable", ctx.allreduce(
            data(x), op=add, tag=33, timeout=30.0))
        put(f"reduce {count} callable",
            ctx.reduce(data(x), root=size - 1, op=add, tag=34))
        put(f"reduce_scatter {count} callable", ctx.reduce_scatter(
            data(rank_input(name, rank, count * size)), op=add, tag=35))
        put(f"allreduce_multi {count} callable", ctx.allreduce_multi(
            [data(x), data(x)], op=add, tag=36))
        put(f"broadcast {count} timeout=",
            ctx.broadcast(data(x), root=size - 1, tag=37, timeout=30.0))
    ctx.barrier(tag=38, timeout=30.0)
    return out


@pytest.mark.parametrize("size", (2, 3, 4))
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_collectives_match_the_reference_bitwise(name, size):
    """reduce (4 ops x every root, auto/binomial/ring), allreduce_multi,
    reduce_scatter_inplace (uneven counts with a 0), gather, gatherv and
    scatter at every root, allgatherv and alltoallv with uneven counts
    holding a 0, alltoall, output= on reduce/scatter/allgather/
    reduce_scatter, timeout= on every kind, and a callable sum through
    allreduce, reduce, reduce_scatter and allreduce_multi."""
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(size, lambda ctx, r: _surface(gloo_tpu, ctx, r, name),
                    timeout=120)
    got = spawn(size, lambda ctx, r: _surface(None, ctx, r, name),
                timeout=120)
    for r in range(size):
        assert got[r].keys() == ref[r].keys()
        wrong = [k for k in ref[r] if got[r][k] != ref[r][k]]
        assert not wrong, (r, wrong[:5])


def test_result_shapes_and_roots():
    """Shapes and placement the bytes do not show: gather's (size, *shape)
    on root and None elsewhere, reduce's input shape, scatter's row shape,
    reduce_scatter_inplace's view of the input's front, output= returned
    as given."""
    def fn(ctx, rank):
        x = torch.full((2, 3), float(rank))
        g = ctx.gather(x, root=1)
        r = ctx.reduce(x, root=0)
        s = ctx.scatter(torch.arange(12.).view(3, 2, 2) if rank == 2
                        else None, root=2, output=None if rank == 2
                        else torch.empty(2, 2))
        buf = torch.arange(6, dtype=torch.float64) * (rank + 1)
        front = ctx.reduce_scatter_inplace(buf, recv_counts=[1, 2, 3])
        out = torch.empty(3 * 6)
        a = ctx.allgather(x, output=out)
        return (None if g is None else g.shape, None if r is None
                else r.shape, s.shape, front.data_ptr() == buf.data_ptr(),
                front.tolist(), a is out)

    res = spawn(3, fn)
    assert [g for g, *_ in res] == [None, (3, 2, 3), None]
    assert [r for _, r, *_ in res] == [(2, 3), None, None]
    assert all(s == (2, 2) for _, _, s, *_ in res)
    assert [f for *_, ptr, f, _ in res] == [[0.], [6., 12.], [18., 24., 30.]]
    assert all(ptr and same for *_, ptr, _, same in res)


def _raising(lib, ctx, rank):
    """A callable that raises, on every rank, through the ring schedule
    (where every rank reduces a chunk): the error each rank sees."""
    def bad(acc, inp):
        raise ValueError("bad reduction")

    x = np.arange(64, dtype=np.float32) + rank
    try:
        ctx.allreduce(x.copy() if lib else to_torch(x), op=bad,
                      algorithm="ring", tag=40)
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, str(exc), type(exc.__cause__).__name__
    return None


@pytest.mark.parametrize("size", (2, 3))
def test_a_raising_callable_raises_the_same_error(size):
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(size, lambda ctx, r: _raising(gloo_tpu, ctx, r))
    got = spawn(size, lambda ctx, r: _raising(None, ctx, r))
    assert got == ref
    assert got == [("Error", "custom reduction callable raised; the "
                    "collective result is invalid on all ranks",
                    "ValueError")] * size


def _stays_out(lib, ctx, rank, gate):
    """Rank 0 allreduces with timeout=0.5 while rank 1 stays out; returns
    rank 0's (error type, seconds)."""
    if rank == 1:
        gate.wait(30)
        return None
    x = np.ones(1024, np.float32)
    t0 = time.monotonic()
    try:
        ctx.allreduce(x if lib else to_torch(x), tag=41, timeout=0.5)
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__, time.monotonic() - t0
    finally:
        gate.set()
    return None, time.monotonic() - t0


def test_a_per_call_timeout_raises_timeout_error_on_both_sides():
    gloo_tpu, jax_spawn, _ = _reference()
    ref_gate, gate = threading.Event(), threading.Event()
    ref = jax_spawn(2, lambda ctx, r: _stays_out(gloo_tpu, ctx, r, ref_gate))
    got = spawn(2, lambda ctx, r: _stays_out(None, ctx, r, gate))
    for kind, seconds in (ref[0], got[0]):
        assert kind == "TimeoutError"
        # The context's own timeout is 30 s (the port) and 15 s (the
        # reference): the call took the per-call 0.5 s, with slack for a
        # loaded machine.
        assert 0.4 < seconds < 5.0, seconds


def _errors(lib, ctx, rank):
    """Rank 0's error message (or None) for each malformed call; no call
    reaches the network."""
    if rank:
        return None

    def t(a):
        return a if lib else to_torch(a)

    f32 = np.float32
    seen = []
    for call in (
            lambda: ctx.gatherv(t(np.zeros(3, f32)), [2, 2]),
            lambda: ctx.alltoall(t(np.zeros((3, 2), f32))),
            lambda: ctx.alltoallv(t(np.zeros(4, f32)), [1, 1], [2, 2]),
            lambda: ctx.scatter(t(np.zeros((3, 2), f32))),
            lambda: ctx.allgather(t(np.zeros(2, f32)),
                                  output=t(np.zeros(3, f32))),
            lambda: ctx.reduce_scatter(t(np.zeros(4, f32)),
                                       output=t(np.zeros(2, np.int32))),
            lambda: ctx.allreduce_multi([]),
            lambda: ctx.allreduce_multi([t(np.zeros(2, f32)),
                                         t(np.zeros(3, f32))]),
            lambda: ctx.reduce_scatter_inplace(t(np.zeros(4, f32)), op=add),
            lambda: ctx.allreduce_plan(t(np.zeros(4, f32)), op=add)):
        try:
            call()
            seen.append(None)
        except (AssertionError, core.Error) as exc:
            seen.append(str(exc))
        except Exception as exc:  # noqa: BLE001 - the reference's Error
            seen.append(str(exc))
    return seen


def test_errors_match_the_reference():
    """The reference's messages; where the reference asserts, the port
    raises a typed Error that names the call."""
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(2, lambda ctx, r: _errors(gloo_tpu, ctx, r))[0]
    got = spawn(2, lambda ctx, r: _errors(None, ctx, r))[0]
    assert None not in got
    asserted = {0: "gatherv: ", 2: "alltoallv: "}
    assert got == [asserted.get(i, "") + msg for i, msg in enumerate(ref)]


def test_prototypes_are_the_references():
    """Every prototype the port declares has the reference's restype and
    argtypes: a wrong width on a count or a pointer corrupts silently."""
    from gloo_tpu import _lib as ref_lib

    for name, (restype, argtypes) in _lib._PROTOTYPES.items():
        fn = getattr(ref_lib.lib, name)
        assert fn.restype == restype and list(fn.argtypes) == argtypes, name


def test_exports_follow_the_reference():
    """core exports what the reference core exports, no name left out;
    the package and its utils export every name of the reference's; and
    Context, AsyncEngine and Device have every public method of the
    reference's classes."""
    import gloo_tpu
    import gloo_tpu.utils
    from gloo_tpu import core as ref_core

    import gloo_tpu_torch
    import gloo_tpu_torch.utils

    assert set(core.__all__) == set(ref_core.__all__)
    assert set(core.__all__) <= set(gloo_tpu_torch.__all__)
    assert set(gloo_tpu.__all__) <= set(gloo_tpu_torch.__all__)
    assert set(gloo_tpu.utils.__all__) <= set(gloo_tpu_torch.utils.__all__)
    for name in gloo_tpu_torch.__all__:
        assert hasattr(gloo_tpu_torch, name), name
    for cls in ("Context", "AsyncEngine", "Device"):
        ref_cls, port_cls = getattr(ref_core, cls), getattr(core, cls)
        for name in dir(ref_cls):
            if not name.startswith("_"):
                assert callable(getattr(port_cls, name, None)), \
                    f"{cls}.{name}"
