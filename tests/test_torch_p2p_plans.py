"""gloo_tpu_torch.core's point-to-point surface (Context.send/recv,
UnboundBuffer), persistent plans, the async reduce-scatter and allgather
with Work.error and Work.wait(timeout=), and the q8/q4 codec helpers,
against gloo_tpu.core's, bitwise; and the staging of CUDA tensors through
every new call.

The reference and the port run their ranks as threads of this process on
the same numpy inputs from a seed. Here, with no card, the staging order
of the new calls is held on meta tensors with the staging steps stood in
(tests/test_torch_host._StagingLog); the `cuda` tests hold every staged
call against the same call on a CPU copy and skip without a card.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gloo_tpu_torch import core
# By the module's own name (pytest puts tests/ on sys.path): the card
# machine, where the `cuda` tests run with --noconftest, has another
# package named `tests`.
from test_torch_host import (_reference, _StagingLog, rank_input, raw, spawn,
                             to_torch)
from test_torch_host import cuda_device  # noqa: F401 - a fixture


def _outcome(fn):
    """fn()'s result, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return type(exc).__name__


def _p2p(lib, ctx, rank):
    """Context.send/recv once around the ring and from a list, and
    UnboundBuffer offsets, slots, put (with and without notify), wait_put,
    get and the aborts, on 3 ranks: {label: result}."""
    port = lib is None
    size = ctx.size
    out = {}

    def t(a):
        return to_torch(a) if port else a.copy()

    # Around the ring: rank 0 sends first, every other rank receives
    # from its left neighbour, then sends to its right.
    x = t(rank_input("float32", rank, 300))
    got = t(np.zeros(300, np.float32))
    right, left = (rank + 1) % size, (rank - 1) % size
    if rank == 0:
        ctx.send(x, right, slot=100)
        src = ctx.recv(got, left, slot=100)
    else:
        src = ctx.recv(got, left, slot=100)
        ctx.send(x, right, slot=100, timeout=30.0)
    out["ring"] = (src, raw(got))
    # From a list: rank 0 takes one message from each of the others.
    if rank == 0:
        seen = []
        for _ in range(size - 1):
            buf = t(np.zeros(8, np.int64))
            src = ctx.recv(buf, list(range(1, size)), slot=101)
            seen.append((src, raw(buf)))
        out["any"] = sorted(seen)
    else:
        ctx.send(t(np.full(8, 10 * rank, np.int64)), 0, slot=101)
    # Offsets and slots: elements [4, 6) of rank 0 land at [1, 3) of
    # rank 1, on a slot drawn from next_slot().
    slot = ctx.next_slot()
    out["slot"] = slot
    if rank == 0:
        buf = ctx.register(t(np.arange(10, dtype=np.float32)))
        buf.send(1, slot, offset=16, nbytes=8)
        out["wait_send"] = buf.wait_send()
    elif rank == 1:
        dst = t(np.zeros(4, np.float32))
        buf = ctx.register(dst)
        buf.recv(0, slot, offset=4, nbytes=8)
        out["offsets"] = (buf.wait_recv(), raw(dst))
    # One-sided: every rank exports `size` bytes; rank r puts byte r into
    # its right neighbour's region at r with notify, and into its left
    # neighbour's at size + r without; then gets its right neighbour's
    # first `size` bytes.
    region = t(np.zeros(2 * size, np.uint8))
    exported = ctx.register(region)
    key = np.frombuffer(exported.get_remote_key(), np.uint8).copy()
    keys = ctx.allgather(t(key))
    keys = [raw(keys[r]) for r in range(size)]
    local = t(np.full(2 * size, rank, np.uint8))
    lbuf = ctx.register(local)
    lbuf.put(keys[right], offset=rank, roffset=rank, nbytes=1, notify=True)
    lbuf.wait_send()
    lbuf.put(keys[left], offset=rank, roffset=size + rank, nbytes=1)
    lbuf.wait_send()
    out["wait_put"] = exported.wait_put(timeout=30.0)
    ctx.barrier(tag=102)
    deadline = time.monotonic() + 10.0
    want = {rank: 0, left: left, size + right: right}
    while time.monotonic() < deadline and any(
            int(region[i]) != v for i, v in want.items()):
        time.sleep(0.01)
    out["region"] = raw(region)
    ctx.barrier(tag=103)
    sink = t(np.zeros(size, np.uint8))
    gbuf = ctx.register(sink)
    gbuf.get(keys[right], ctx.next_slot(), nbytes=size)
    out["get"] = (gbuf.wait_recv(timeout=30.0), raw(sink))
    ctx.barrier(tag=104)
    # Aborts: a wait with nothing to come, cut from another thread.
    if rank == 0:
        pending = ctx.register(t(np.zeros(1, np.float32)))
        pending.recv(1, slot=105)
        threading.Timer(0.2, pending.abort_wait_recv).start()
        out["abort_recv"] = pending.wait_recv(timeout=10.0)
        idle = ctx.register(t(np.zeros(1, np.float32)))
        threading.Timer(0.2, idle.abort_wait_send).start()
        out["abort_send"] = _outcome(lambda: idle.wait_send(timeout=10.0))
        del pending
    ctx.barrier(tag=106)
    return out


def test_point_to_point_matches_the_reference():
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(3, lambda ctx, r: _p2p(gloo_tpu, ctx, r), timeout=60)
    got = spawn(3, lambda ctx, r: _p2p(None, ctx, r), timeout=60)
    assert got == ref
    assert [g["ring"][0] for g in got] == [2, 0, 1]
    assert [s for s, _ in got[0]["any"]] == [1, 2]
    assert got[0]["abort_recv"] is None and got[0]["wait_send"] is True
    assert [g["wait_put"] for g in got] == [2, 0, 1]


def test_register_refuses_a_tensor_off_the_cpu(single):
    with pytest.raises(core.Error, match="A.7"):
        single.register(torch.empty(4, device="meta"))
    buf = single.register(torch.zeros(4, pin_memory=False))
    assert len(buf.get_remote_key()) > 0


@pytest.fixture
def single():
    """A connected context of one rank."""
    ctx = core.Context(0, 1, timeout=10)
    ctx.connect_full_mesh(core.HashStore(), core.Device())
    yield ctx
    ctx.close()


def _plans(lib, ctx, rank):
    """Each plan replayed 3 times on new data against the per-call form,
    and the plan-cache size after the first replays: {label: result}. (A
    per-call form allocates its output anew, so whether its native plan
    is reused depends on where the allocator puts it: only the plans'
    entries are counted.)"""
    port = lib is None
    size = ctx.size
    out = {}

    def t(a):
        return to_torch(a) if port else a.copy()

    def fill(dst, a):
        dst[:] = to_torch(a).view(dst.shape) if port else a.reshape(
            dst.shape)

    ctx.plan_cache_clear()
    cases = {"allreduce": ("float32", 1000, (1000,),
                           lambda d: ctx.allreduce(d, op="max", tag=53)),
             "reduce_scatter": ("bfloat16", 6 * size, (6 * size,),
                                lambda d: ctx.reduce_scatter(d, tag=54)),
             "allgather": ("int32", 7, (7, 1),
                           lambda d: ctx.allgather(d, tag=55))}
    data = {name: t(rank_input(dt, rank, n).reshape(shape))
            for name, (dt, n, shape, _) in cases.items()}
    plans = {"allreduce": ctx.allreduce_plan(data["allreduce"], op="max",
                                             tag=50),
             "reduce_scatter": ctx.reduce_scatter_plan(
                 data["reduce_scatter"], tag=51, timeout=30.0),
             "allgather": ctx.allgather_plan(data["allgather"], tag=52)}
    out["built"] = ctx.plan_cache_size()
    for step in range(3):
        inputs = {}
        for name, (dt, n, shape, _) in cases.items():
            inputs[name] = rank_input(dt, 100 * step + rank, n).reshape(
                shape)
            fill(data[name], inputs[name])
            replay = plans[name]()
            assert replay is plans[name].result
            out[f"{name} {step}"] = raw(replay)
        if step == 0:
            out["after replays"] = ctx.plan_cache_size()
        for name, (_, _, _, call) in cases.items():
            out[f"{name} {step} per call"] = raw(call(t(inputs[name])))
    ctx.barrier(tag=56)
    return out


def test_plans_replay_the_per_call_form():
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(3, lambda ctx, r: _plans(gloo_tpu, ctx, r))
    got = spawn(3, lambda ctx, r: _plans(None, ctx, r))
    assert got == ref
    for res in got:
        assert res["built"] == 0 and res["after replays"] == 3
        for key in res:
            if key.endswith("per call"):
                assert res[key] == res[key.removesuffix(" per call")], key


def _async(lib, ctx, rank):
    """The async reduce-scatter and allgather, Work.error, and a wait with
    a timeout that runs out before a late peer issues."""
    port = lib is None
    size = ctx.size
    out = {}

    def t(a):
        return to_torch(a) if port else a.copy()

    engine = ctx.async_engine(lanes=2, tag_base=0x300)
    rs = engine.reduce_scatter_async(
        t(rank_input("float32", rank, 4 * size)), recv_counts=None,
        op="max", timeout=30.0)
    ag = engine.allgather_async(t(rank_input("uint8", rank, 5)))
    q8 = engine.reduce_scatter_async(
        t(rank_input("float32", rank, 512 * size)), wire="q8")
    given = t(np.zeros(size * 3, np.float64))
    ag_out = engine.allgather_async(t(rank_input("float64", rank, 3)),
                                    output=given)
    for label, work in (("rs", rs), ("ag", ag), ("q8", q8),
                        ("ag output", ag_out)):
        result = work.wait(timeout=30.0)
        out[label] = (work.op, raw(result), tuple(result.shape),
                      work.error(), work.test())
    out["output kept"] = ag_out.result is given
    # A wait that times out does not cancel the op.
    late = t(np.ones(64, np.float32))
    if rank == 1:
        time.sleep(0.6)
    work = engine.allreduce_async(late)
    if rank == 0:
        out["early wait"] = _outcome(lambda: work.wait(timeout=0.1))
    out["late wait"] = raw(work.wait())
    # An op whose peer never issues fails at its own timeout, and its
    # Work carries the error.
    if rank == 0:
        failed = engine.allreduce_async(t(np.ones(8, np.float32)),
                                        timeout=0.3)
        out["failed"] = _outcome(failed.wait)
        out["error"] = failed.error() is not None
    engine.shutdown()
    return out


def test_async_reduce_scatter_and_allgather_match_the_reference():
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(2, lambda ctx, r: _async(gloo_tpu, ctx, r))
    got = spawn(2, lambda ctx, r: _async(None, ctx, r))
    assert got == ref
    assert got[0]["early wait"] == "TimeoutError"
    assert got[0]["failed"] in ("TimeoutError", "IoError")
    assert got[0]["error"]
    assert got[0]["rs"][3] is None and got[0]["output kept"]


def test_async_refuses_callables(single):
    engine = single.async_engine(lanes=1)
    with pytest.raises(core.Error, match="callable"):
        engine.reduce_scatter_async(torch.zeros(4), op=lambda a, b: None)
    engine.shutdown()


@pytest.mark.parametrize("count", (0, 1, 255, 256, 1000, 4097))
def test_codecs_match_the_reference(count):
    gloo_tpu, _, _ = _reference()
    a = np.random.RandomState(count).randn(count).astype(np.float32) * 3
    for codec in ("q8", "q4"):
        encode = getattr(core, f"{codec}_encode")
        decode = getattr(core, f"{codec}_decode")
        wire = encode(torch.from_numpy(a))
        ref_wire = getattr(gloo_tpu, f"{codec}_encode")(a)
        assert wire.dtype == torch.uint8 and raw(wire) == raw(ref_wire)
        assert raw(decode(wire, count)) == raw(
            getattr(gloo_tpu, f"{codec}_decode")(ref_wire, count))
        assert getattr(core, f"{codec}_wire_bytes")(count) == \
            getattr(gloo_tpu, f"{codec}_wire_bytes")(count)
        assert getattr(core, f"{codec}_block")() == \
            getattr(gloo_tpu, f"{codec}_block")()
    assert core.codec_threads() == gloo_tpu.codec_threads()
    assert core.codec_pipeline() == gloo_tpu.codec_pipeline()
    with pytest.raises(core.Error, match="float32"):
        core.q8_encode(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(core.Error, match="uint8"):
        core.q4_decode(torch.zeros(4, dtype=torch.int8), 4)


def test_metrics_drain_watchdog_and_flightrec_dump(single, tmp_path):
    single.allreduce(torch.ones(4))
    assert single.metrics(drain=True)["ops"]["allreduce"]["calls"] == 1
    assert "allreduce" not in single.metrics()["ops"] or \
        single.metrics()["ops"]["allreduce"]["calls"] == 0
    single.metrics_enable(False)
    assert not single.metrics_enabled()
    single.metrics_enable(True)
    single.set_watchdog(0.5)
    assert single.metrics()["watchdog_ms"] == 500
    single.set_watchdog(None)
    path = single.flightrec_dump(str(tmp_path / "fr.json"))
    assert (tmp_path / "fr.json").read_text().startswith("{")
    assert path == str(tmp_path / "fr.json")


# ---- staging of CUDA tensors, on meta tensors ----

_NEW_NATIVES = ("tc_reduce", "tc_gather", "tc_scatter", "tc_allgatherv",
                "tc_alltoall", "tc_allreduce", "tc_async",
                "tc_buffer_wait", "tc_q8_encode", "tc_allgather")
_CALL = ["to host", "sync", "native", "to device", "record event"]


def _steps(log):
    """The staging steps, without the waits on a reused buffer's event
    (tests/test_torch_host.py holds those)."""
    return [step for step in log.order if step != "wait event"]


def test_staging_of_the_new_collectives(single, monkeypatch):
    """Each call copies in, synchronizes, calls, copies out and records an
    event, in that order; results land on the input's device."""
    log = _StagingLog(monkeypatch, _NEW_NATIVES)
    x = torch.empty(2, 3, device="meta")
    for call, shape in (
            (lambda: single.reduce(x), (2, 3)),
            (lambda: single.gather(x), (1, 2, 3)),
            (lambda: single.gatherv(x.view(-1), [6]), (6,)),
            (lambda: single.scatter(x.view(1, 6)), (6,)),
            (lambda: single.allgatherv(x.view(-1), [6]), (6,)),
            (lambda: single.alltoall(x.view(1, 6)), (1, 6)),
            (lambda: single.alltoallv(x.view(-1), [6], [6]), (6,)),
            (lambda: single.reduce_scatter_inplace(x.view(-1)), (6,)),
            (lambda: single.allreduce(x, op=lambda a, b: None), (2, 3))):
        log.order.clear()
        result = call()
        assert result.device.type == "meta" and result.shape == shape
        assert _steps(log) == _CALL
    log.order.clear()
    outs = single.allreduce_multi([x, x.clone()])
    assert [o.device.type for o in outs] == ["meta", "meta"]
    assert _steps(log) == ["to host", "to host", "sync", "native",
                           "to device", "to device", "record event"]
    # The codecs stage through new pinned buffers, which PyTorch's pinned
    # allocator keeps until the copies have read them: no event.
    log.order.clear()
    wire = core.q8_encode(x.view(-1))
    assert wire.device.type == "meta" and wire.shape == (
        core.q8_wire_bytes(6),)
    assert log.order == ["to host", "sync", "native", "to device"]


def test_staging_of_send_recv_plans_and_async(single, monkeypatch):
    log = _StagingLog(monkeypatch, _NEW_NATIVES)
    x = torch.empty(16, device="meta")
    single.send(x, 0, slot=7)
    assert log.order == ["to host", "sync", "native"]
    log.order.clear()
    assert single.recv(x, 0, slot=7) == 0
    assert log.order == ["sync", "native", "to device", "record event"]
    # A plan owns its pinned mirrors: two replays take no buffer from the
    # pool and record no event.
    allocated = log.allocated
    plan = single.reduce_scatter_plan(x)
    assert log.allocated == allocated + 2
    log.order.clear()
    for _ in range(2):
        assert plan() is plan.result and plan.result.device.type == "meta"
    assert log.order == ["to host", "sync", "native", "to device"] * 2
    assert log.allocated == allocated + 2
    # Async: staged at issue, copied back in wait().
    engine = single.async_engine(lanes=1)
    log.order.clear()
    work = engine.allgather_async(x)
    assert _steps(log) == ["to host", "sync", "native"]
    assert work.wait().device.type == "meta"
    assert _steps(log) == _CALL
    engine.shutdown()


def test_outputs_must_be_on_the_input_device(single):
    with pytest.raises(core.Error, match="device"):
        single.allgather(torch.empty(4, device="meta"),
                         output=torch.empty(4))


# ---- on the card ----

STAGED_CALLS = {
    "reduce sum": lambda ctx, t: ctx.reduce(t, root=ctx.size - 1, tag=1),
    "reduce max": lambda ctx, t: ctx.reduce(t, root=0, op="max", tag=2),
    "gather": lambda ctx, t: ctx.gather(t, root=ctx.size - 1, tag=3),
    "scatter": lambda ctx, t: ctx.scatter(
        t.repeat(ctx.size, 1) if ctx.rank == 0 else None, root=0,
        output=None if ctx.rank == 0 else torch.empty_like(t), tag=4),
    "allgatherv": lambda ctx, t: ctx.allgatherv(
        t[:ctx.rank], list(range(ctx.size)), tag=5),
    "alltoall": lambda ctx, t: ctx.alltoall(t.view(ctx.size, -1), tag=6),
    "allreduce_multi": lambda ctx, t: ctx.allreduce_multi(
        [t, t.clone()], tag=7)[1],
    "reduce_scatter_inplace": lambda ctx, t: ctx.reduce_scatter_inplace(
        t, tag=8),
    "callable": lambda ctx, t: ctx.allreduce(t, op=lambda a, b: a.add_(b),
                                             tag=9),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STAGED_CALLS))
def test_staged_calls_equal_the_cpu_calls(cuda_device, name):
    """Each new call on a CUDA tensor against the same call on a CPU copy,
    bitwise, over 3 thread ranks, three rounds."""
    call = STAGED_CALLS[name]

    def fn(ctx, rank):
        wrong = []
        for round_ in range(3):
            x = to_torch(rank_input("float32", rank, 3 * 4096))
            got = call(ctx, x.to(cuda_device))
            want = call(ctx, x.clone())
            if got is None or want is None:
                if (got is None) != (want is None):
                    wrong.append((round_, "root"))
            elif got.device != cuda_device or \
                    not torch.equal(got.cpu(), want):
                wrong.append(round_)
        return wrong

    assert spawn(3, fn, timeout=300) == [[], [], []]


@pytest.mark.cuda
def test_staged_plans_send_recv_and_codecs(cuda_device):
    def fn(ctx, rank):
        x = to_torch(rank_input("float32", rank, 3 * 4096))
        d = x.to(cuda_device)
        plan = ctx.allreduce_plan(d, tag=20)
        wrong = []
        for step in range(5):
            d.copy_(x * (step + 1))
            want = ctx.allreduce(x * (step + 1), tag=21)
            if not torch.equal(plan().cpu(), want):
                wrong.append(f"plan {step}")
        got = torch.empty_like(d)
        if rank == 0:
            ctx.send(d, 1, slot=22)
            ctx.recv(got, ctx.size - 1, slot=22)
        else:
            ctx.recv(got, rank - 1, slot=22)
            ctx.send(d, (rank + 1) % ctx.size, slot=22)
        wire = core.q8_encode(d)
        if wire.device != cuda_device or \
                not torch.equal(wire.cpu(), core.q8_encode(d.cpu())):
            wrong.append("q8")
        return wrong, got.cpu()

    res = spawn(3, fn, timeout=300)
    assert [w for w, _ in res] == [[], [], []]
