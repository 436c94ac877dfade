"""gloo_tpu_torch.core (the host plane over torch tensors) against
gloo_tpu.core (over numpy arrays), bitwise.

Both sides run their ranks as threads of this process, each rank with its
own Device and Context over an in-process HashStore (tests/harness.py's
mode); the port's ranks connect only to the port's ranks. The same inputs,
made with numpy from a seed per rank, go through both, and every result is
compared as raw bytes: both sides run the same C++ schedules on the same
bytes (the port from its own build of csrc/, loaded beside the reference's
library), so nothing may differ by a bit.

CUDA tensors are staged through pinned host memory. Here, with no card,
the order of the staging steps is held on meta tensors with the steps
stood in (test_staging_*): the device-to-host copy, then the stream
synchronization, then the native call, then the host-to-device copy and
the event; a pinned buffer is reused only after its event has completed.
The `cuda` tests of the whole host plane (staged collectives,
HostGradSync and the hierarchical group on the card) are in this file and
need neither JAX nor gloo_tpu, which are imported only by the tests that
compare with them.
"""

import threading

import numpy as np
import pytest
import torch

ml_dtypes = pytest.importorskip("ml_dtypes")

from gloo_tpu_torch import _lib, core  # noqa: E402
from gloo_tpu_torch.parallel import HostGradSync  # noqa: E402
from gloo_tpu_torch.tpu import HierarchicalGroup  # noqa: E402


def _reference():
    """(gloo_tpu, its thread harness, its topology harness)."""
    import gloo_tpu
    from tests.harness import spawn as jax_spawn
    from tests.test_group import spawn_topo as jax_spawn_topo

    return gloo_tpu, jax_spawn, jax_spawn_topo

DTYPES = {
    "int8": (np.int8, torch.int8),
    "uint8": (np.uint8, torch.uint8),
    "int32": (np.int32, torch.int32),
    "uint32": (np.uint32, torch.uint32),
    "int64": (np.int64, torch.int64),
    "uint64": (np.uint64, torch.uint64),
    "float16": (np.float16, torch.float16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "float32": (np.float32, torch.float32),
    "float64": (np.float64, torch.float64),
}
OPS = ("sum", "prod", "max", "min")
ALGORITHMS = ("auto", "ring", "hd", "rd", "bcube")
RS_ALGORITHMS = ("auto", "ring", "hd", "direct")
# Elements per rank: 1 and 5 take the small-payload branches, 1000 is not
# a multiple of any group size here, 4096 runs every schedule's chunking.
COUNTS = (1, 5, 1000, 4096)


def spawn(size, fn, timeout=60.0, context_timeout=30.0, host_of=None,
          device_kwargs=None):
    """tests/harness.spawn for the port: fn(ctx, rank) on `size` threads,
    each with its own gloo_tpu_torch Device(**device_kwargs) and Context
    over one HashStore (host fingerprint grp-host<host_of(rank)> when
    host_of is given). Returns the per-rank results; re-raises the first
    rank's error."""
    store = core.HashStore()
    results = [None] * size
    errors = []

    def worker(rank):
        ctx = None
        try:
            device = core.Device(**(device_kwargs or {}))
            ctx = core.Context(rank, size, timeout=context_timeout)
            if host_of is not None:
                ctx.set_host_id(f"grp-host{host_of(rank)}")
            ctx.connect_full_mesh(store, device)
            results[rank] = fn(ctx, rank)
        except BaseException as exc:  # noqa: BLE001 - surfaced to caller
            errors.append((rank, exc))
        finally:
            if ctx is not None:
                try:
                    ctx.close()
                except Exception:
                    pass

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"rank thread did not finish in {timeout}s")
    if errors:
        rank, exc = errors[0]
        raise AssertionError(f"rank {rank} failed: {exc!r}") from exc
    return results


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A torch copy of a numpy array (bf16 through its bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def raw(x) -> bytes:
    """The bytes of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def rank_input(name: str, rank: int, count: int, op: str = "sum"):
    """Rank `rank`'s input: small integers for every op and dtype (a
    product of 4 ranks stays finite), negative ones where the type has
    them, and fractions for the float types."""
    rng = np.random.RandomState(1000 * rank + count)
    np_dtype = DTYPES[name][0]
    if op == "prod":
        base = rng.randint(1, 4, count)
    else:
        base = rng.randint(0, 100, count)
    if name.startswith("int") or name.startswith("float") \
            or name == "bfloat16":
        base = base - (0 if op == "prod" else 50)
    if name.startswith("float") or name == "bfloat16":
        base = base + rng.rand(count) * (0.25 if op == "prod" else 1.0)
    return np.asarray(base).astype(np_dtype)


def _collectives(lib, ctx, rank, name):
    """Every collective of the case on one rank: {label: result bytes}.
    `lib` is gloo_tpu (numpy in) or None for the port (torch in)."""
    port = lib is None
    out = {}

    def run(label, fn, x):
        data = to_torch(x) if port else x.copy()
        out[label] = raw(fn(data))

    floats = name.startswith("float") or name == "bfloat16"
    algorithms = ALGORITHMS
    if floats and ctx.size & (ctx.size - 1):
        # bcube at a size that is not a power of 2 folds float partials in
        # the order they arrive: two runs of the reference differ there.
        algorithms = tuple(a for a in ALGORITHMS if a != "bcube")
    for count in COUNTS:
        for op in OPS:
            for algo in algorithms:
                run(f"allreduce {count} {op} {algo}",
                    lambda t: ctx.allreduce(t, op=op, algorithm=algo,
                                            tag=7),
                    rank_input(name, rank, count, op))
        run(f"broadcast {count}", lambda t: ctx.broadcast(
            t, root=ctx.size - 1, tag=8), rank_input(name, rank, count))
        run(f"allgather {count}", lambda t: ctx.allgather(t, tag=9),
            rank_input(name, rank, count))
        for algo in RS_ALGORITHMS:
            for op in ("sum", "max"):
                run(f"reduce_scatter {count} {op} {algo}",
                    lambda t: ctx.reduce_scatter(
                        t, op=op, algorithm=algo, tag=10),
                    rank_input(name, rank, count * ctx.size))
        if name == "float32":
            for wire in ("q8", "bf16"):
                run(f"allreduce {count} wire {wire}",
                    lambda t: ctx.allreduce(t, wire=wire, tag=11),
                    rank_input(name, rank, count))
            run(f"reduce_scatter {count} wire q8",
                lambda t: ctx.reduce_scatter(t, wire="q8", tag=12),
                rank_input(name, rank, count * ctx.size))
    ctx.barrier(tag=13)
    return out


@pytest.mark.parametrize("size", (2, 3, 4))
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_collectives_match_the_reference_bitwise(name, size):
    """allreduce (sum, prod, max, min x auto, ring, hd, rd, bcube; bcube
    on float types only at sizes 2 and 4), broadcast, allgather,
    reduce_scatter (auto, ring, hd, direct), and on f32 the q8 and bf16
    wires, at 1 to 4096 elements per rank."""
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(size, lambda ctx, r: _collectives(gloo_tpu, ctx, r,
                                                      name), timeout=120)
    got = spawn(size, lambda ctx, r: _collectives(None, ctx, r, name),
                timeout=120)
    for r in range(size):
        assert got[r].keys() == ref[r].keys()
        wrong = [k for k in ref[r] if got[r][k] != ref[r][k]]
        assert not wrong, (r, wrong[:5])


def test_allgather_and_reduce_scatter_shapes():
    def fn(ctx, rank):
        x = torch.full((2, 3), float(rank), dtype=torch.float32)
        g = ctx.allgather(x)
        s = ctx.reduce_scatter(torch.arange(6, dtype=torch.float64),
                               recv_counts=[4, 2])
        return g, s

    (g0, s0), (g1, s1) = spawn(2, fn)
    assert g0.shape == (2, 2, 3) and torch.equal(g0, g1)
    assert torch.equal(g0[1], torch.ones(2, 3))
    assert torch.equal(s0, torch.tensor([0., 2., 4., 6.], dtype=torch.float64))
    assert torch.equal(s1, torch.tensor([8., 10.], dtype=torch.float64))


def test_cpu_tensor_is_reduced_in_place():
    def fn(ctx, rank):
        x = torch.full((16,), float(rank + 1))
        ptr = x.data_ptr()
        y = ctx.allreduce(x)
        b = ctx.broadcast(x, root=1)
        return y is x and b is x and x.data_ptr() == ptr, float(x[0])

    assert spawn(3, fn) == [(True, 6.0)] * 3


def _topology_run(lib, ctx, rank):
    """Topology, fork, split and split_by_host on 4 ranks presenting as 2
    hosts x 2; each sub-communicator's allreduce and allgather."""
    port = lib is None

    def arr(values, dtype=np.float32):
        a = np.asarray(values, dtype=dtype)
        return to_torch(a) if port else a

    topo = ctx.topology()
    out = {"topology": {k: topo[k] for k in (
        "rank", "host_index", "local_rank", "local_size", "leader",
        "is_leader", "n_hosts", "non_flat")}}
    child = ctx.fork(tag=0x77)
    out["fork"] = (child.rank, child.size,
                   raw(child.allreduce(arr([rank + 1.0] * 3))))
    child.close()
    local = ctx.split_by_host(tag=0x60)
    out["by_host"] = (local.rank, local.size, local.group_tag() != "",
                      raw(local.allreduce(arr([rank + 1.0] * 5))),
                      raw(local.allgather(arr([rank], np.int32))))
    odd = ctx.split(rank % 2, key=-rank, tag=0x64)
    out["split"] = (odd.rank, odd.size,
                    raw(odd.allgather(arr([rank], np.int64))))
    none = ctx.split(0 if rank == 0 else -1, tag=0x68)
    out["opt_out"] = none is None if rank else (none.rank, none.size)
    ctx.allreduce(arr([1.0]), algorithm="hier", tag=0x6C)
    out["hier"] = (raw(ctx.allreduce(arr([rank + 0.5] * 7),
                                     algorithm="hier", tag=0x6D)),
                   raw(ctx.allgather(arr([rank] * 3, np.int32),
                                     algorithm="hier", tag=0x6E)))
    ctx.barrier(algorithm="hier", tag=0x6F)
    return out


def test_topology_fork_and_splits_match_the_reference():
    gloo_tpu, _, jax_spawn_topo = _reference()
    ref = jax_spawn_topo(4, 2, lambda ctx, r: _topology_run(gloo_tpu, ctx,
                                                            r))
    got = spawn(4, lambda ctx, r: _topology_run(None, ctx, r),
                host_of=lambda r: r // 2)
    assert got == ref
    assert [g["topology"]["n_hosts"] for g in got] == [2] * 4
    assert got[0]["topology"]["non_flat"]


def test_stores():
    server = core.TcpStoreServer("127.0.0.1", 0)
    tcp = core.TcpStore("127.0.0.1", server.port)
    tcp.set("a", b"xyz")
    assert tcp.get("a") == b"xyz"
    assert tcp.add("n", 2) == 2 and tcp.add("n", 3) == 5
    prefixed = core.PrefixStore(tcp, "p")
    prefixed.set("a", b"in p")
    assert prefixed.get("a") == b"in p" and tcp.get("a") == b"xyz"
    hashed = core.HashStore()
    hashed.set("k", b"")
    assert hashed.get("k") == b""


def test_file_store_rendezvous(tmp_path):
    def worker(rank, out):
        ctx = core.Context(rank, 2, timeout=30)
        ctx.connect_full_mesh(core.FileStore(str(tmp_path)), core.Device())
        out[rank] = float(ctx.allreduce(torch.full((4,), rank + 1.0))[0])
        ctx.close()

    out = [None, None]
    threads = [threading.Thread(target=worker, args=(r, out))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert out == [3.0, 3.0]


@pytest.fixture
def single():
    """A connected context of one rank."""
    ctx = core.Context(0, 1, timeout=10)
    ctx.connect_full_mesh(core.HashStore(), core.Device())
    yield ctx
    ctx.close()


def test_errors_match_the_reference(single):
    gloo_tpu, _, _ = _reference()
    ref = gloo_tpu.Context(0, 1, timeout=10)
    ref.connect_full_mesh(gloo_tpu.HashStore(), gloo_tpu.Device())
    try:
        for name, np_dtype, dtype in (("int16", np.int16, torch.int16),
                                      ("bool", np.bool_, torch.bool)):
            with pytest.raises(gloo_tpu.Error) as want:
                ref.allreduce(np.zeros(4, np_dtype))
            with pytest.raises(core.Error) as got:
                single.allreduce(torch.zeros(4, dtype=dtype))
            assert str(got.value) == str(want.value) == \
                f"unsupported dtype: {name}"
        for dtype in (torch.uint16, torch.complex64):
            with pytest.raises(core.Error, match="unsupported dtype"):
                single.allreduce(torch.zeros(4, dtype=dtype))
        with pytest.raises(gloo_tpu.Error) as want:
            ref.allreduce(np.zeros((4, 4), np.float32).T)
        with pytest.raises(core.Error) as got:
            single.allreduce(torch.zeros(4, 4).T)
        assert str(got.value) == str(want.value).replace("array", "tensor")
        for fn in (single.allreduce, single.allgather, single.broadcast,
                   single.reduce_scatter):
            with pytest.raises(TypeError):
                fn(np.zeros(4, np.float32))
        with pytest.raises(core.Error, match="wire"):
            single.allreduce(torch.zeros(4), wire="q7")
        with pytest.raises(core.Error, match="recv_counts"):
            single.reduce_scatter(torch.zeros(4), recv_counts=[3])
    finally:
        ref.close()
    assert issubclass(core.TimeoutError, core.IoError)
    assert issubclass(core.IoError, core.Error)


def test_async_engine_and_work(single):
    engine = single.async_engine(lanes=2)
    x = torch.arange(10, dtype=torch.float32)
    work = engine.allreduce_async(x)
    assert work.wait() is x and work.test()
    assert torch.equal(x, torch.arange(10, dtype=torch.float32))
    engine.shutdown()
    with pytest.raises(core.Error, match="callable"):
        engine.allreduce_async(x, op=lambda a, b: None)


class _StagingLog:
    """Stands in for the four staging steps and the native library, and
    logs their order. Meta tensors take the card's path (their device is
    not the CPU); the pinned buffers are plain CPU tensors."""

    NATIVES = ("tc_allreduce", "tc_async_allreduce", "tc_allgather",
               "tc_reduce_scatter", "tc_broadcast")

    def __init__(self, monkeypatch, natives=NATIVES):
        self.order = []
        self.allocated = 0
        real = _lib.lib()
        log = self

        class Event:
            def synchronize(self):
                log.order.append("wait event")

        class Lib:
            def __getattr__(self, name):
                fn = getattr(real, name)
                if not name.startswith(natives):
                    return fn

                def native(*args):
                    log.order.append("native")
                    return fn(*args)
                return native

        def pinned(numel, dtype):
            self.allocated += 1
            return torch.empty(numel, dtype=dtype)

        def to_host(host, t):
            assert t.device.type == "meta"
            host.fill_(1)
            self.order.append("to host")

        def to_device(t, host):
            assert t.device.type == "meta"
            self.order.append("to device")

        def record(device):
            self.order.append("record event")
            return Event()

        monkeypatch.setattr(core, "_pinned_empty", pinned)
        monkeypatch.setattr(core, "_to_host", to_host)
        monkeypatch.setattr(core, "_sync",
                            lambda device: self.order.append("sync"))
        monkeypatch.setattr(core, "_to_device", to_device)
        monkeypatch.setattr(core, "_record", record)
        monkeypatch.setattr(core._lib, "lib", lambda: Lib())


def test_staging_synchronizes_before_the_native_call(single, monkeypatch):
    log = _StagingLog(monkeypatch)
    x = torch.empty(64, device="meta")
    assert single.allreduce(x) is x
    assert log.order == ["to host", "sync", "native", "to device",
                         "record event"]
    # The same (dtype, numel) takes the same pinned buffer, once the event
    # after its last host-to-device copy has completed.
    log.order.clear()
    single.broadcast(x)
    assert log.order == ["wait event", "to host", "sync", "native",
                         "to device", "record event"]
    assert log.allocated == 1


def test_staging_of_allgather_and_reduce_scatter(single, monkeypatch):
    log = _StagingLog(monkeypatch)
    x = torch.empty(2, 3, device="meta", dtype=torch.bfloat16)
    g = single.allgather(x)
    assert g.device.type == "meta" and g.shape == (1, 2, 3)
    assert g.dtype == torch.bfloat16
    assert log.order == ["to host", "sync", "native", "to device",
                         "record event"]
    log.order.clear()
    s = single.reduce_scatter(torch.empty(6, device="meta"))
    assert s.device.type == "meta" and s.shape == (6,)
    assert log.order == ["to host", "sync", "native", "to device",
                         "record event"]


def test_staging_of_an_async_allreduce(single, monkeypatch):
    log = _StagingLog(monkeypatch)
    engine = single.async_engine(lanes=1)
    x = torch.empty(32, device="meta")
    work = engine.allreduce_async(x)
    assert log.order == ["to host", "sync", "native"]
    assert work.wait() is x
    assert log.order == ["to host", "sync", "native", "to device",
                         "record event"]
    engine.shutdown()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: staging copies to and from a card")
    # With its index: a tensor's device is cuda:0, never the bare "cuda".
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("float32", "bfloat16", "int32"))
def test_staged_collectives_equal_the_cpu_calls(cuda_device, name):
    """CUDA tensors through pinned memory against CPU copies, bitwise,
    three rounds (a stale copy shows only some of the time)."""
    def fn(ctx, rank):
        wrong = []
        for round_ in range(3):
            for count in (256, 1 << 20):
                x = to_torch(rank_input(name, rank, count))
                for label, call in (
                        ("sum", lambda t: ctx.allreduce(t, tag=1)),
                        ("max", lambda t: ctx.allreduce(t, op="max", tag=2)),
                        ("bcast", lambda t: ctx.broadcast(t, tag=3)),
                        ("gather", lambda t: ctx.allgather(t, tag=4)),
                        ("rs", lambda t: ctx.reduce_scatter(t, tag=5))):
                    got = call(x.to(cuda_device))
                    want = call(x.clone())
                    if got.device != cuda_device or \
                            not torch.equal(got.cpu(), want):
                        wrong.append((round_, count, label))
        return wrong

    assert spawn(2, fn, timeout=300) == [[], []]


def _q8_reuse(lib, ctx, rank):
    """A q8 allreduce of the same data on a fresh plan, then on the plan
    that a call of other data at the same pointer and tag left cached."""
    data = np.random.RandomState(rank).randn(5).astype(np.float32)
    other = np.random.RandomState(rank + 7).randn(5).astype(np.float32)
    buf = data.copy() if lib else to_torch(data)
    ctx.allreduce(buf, wire="q8", tag=5)
    fresh = raw(buf)
    buf[:] = other if lib else to_torch(other)
    ctx.allreduce(buf, wire="q8", tag=5)
    buf[:] = data if lib else to_torch(data)
    ctx.allreduce(buf, wire="q8", tag=5)
    return fresh, raw(buf)


@pytest.mark.parametrize("size", (2, 3))
def test_q8_on_a_reused_plan_matches_the_reference(size):
    """The C++ core's q8 wire gives other bits on a reused plan than on a
    fresh one (ROADMAP.md C.7; the reference shows it on numpy arrays).
    The port equals the reference on both."""
    gloo_tpu, jax_spawn, _ = _reference()
    ref = jax_spawn(size, lambda ctx, r: _q8_reuse(gloo_tpu, ctx, r))
    got = spawn(size, lambda ctx, r: _q8_reuse(None, ctx, r))
    assert got == ref
    assert all(fresh != reused for fresh, reused in ref)


GRAD_ARMS = {"sequential": dict(bucketed=False),
             "bucketed": dict(bucketed=True, bucket_bytes=256),
             "sequential_q8": dict(bucketed=False, wire="q8")}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(GRAD_ARMS))
def test_host_grad_sync_on_the_card_equals_the_cpu_call(cuda_device, arm):
    """HostGradSync on CUDA gradients (f32, bf16, int32 leaves; staged
    through pinned memory) against the same arm on CPU copies, bitwise,
    over 2 ranks, three rounds."""
    def fn(ctx, rank):
        sync = HostGradSync(ctx, **GRAD_ARMS[arm])
        wrong = []
        for round_ in range(3):
            grads = {"w": to_torch(rank_input("float32", rank + round_, 300)),
                     "e": to_torch(rank_input("bfloat16", rank + round_, 64)),
                     "n": to_torch(rank_input("int32", rank + round_, 6))}
            results = []
            for leaves in ({k: v.to(cuda_device) for k, v in grads.items()},
                           grads):
                if "wire" in GRAD_ARMS[arm]:
                    ctx.plan_cache_clear()  # ROADMAP.md C.7
                    ctx.barrier()
                results.append(sync.average(leaves))
            got, want = results
            wrong += [(round_, k) for k in grads
                      if got[k].device != cuda_device
                      or raw(got[k].cpu()) != raw(want[k])]
        return wrong

    assert spawn(2, fn, timeout=300) == [[], []]


@pytest.mark.cuda
def test_hierarchical_partials_on_the_card(cuda_device):
    """Partials on a world of 2 local ranks of the card: a list of CUDA
    tensors equal to the closed form, and a tensor in gives a CUDA tensor
    out."""
    def fn(ctx, rank):
        group = HierarchicalGroup(ctx, devices=[cuda_device] * 2)
        out = group.allreduce([torch.full((1000,), rank + d + 1.0,
                                          device=cuda_device)
                               for d in range(2)])
        one = group.mean(torch.full((8,), rank + 1.0, device=cuda_device))
        return ([(o.device.type, float(o[0])) for o in out],
                one.device.type, float(one[0]))

    assert spawn(2, fn) == [([("cuda", 8.0)] * 2, "cuda", 1.5)] * 2
