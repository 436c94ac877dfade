"""gloo_tpu_torch.tpu.init_multihost, the process mesh and the collectives
across processes, against gloo_tpu.tpu.init_multihost and the one-process
world.

Processes are simulated with threads: each calls init_multihost over a
TcpStoreServer that rank 0 serves on a free port (as
tests/test_torch_host.py's spawn runs thread ranks), with devices=["cpu"],
so the ring collectives gather the world through the host plane and run
the kernels' twins. The reference's init_multihost starts
jax.distributed for more than one process, which one test process cannot
host, so it is compared at size 1 only.

Tolerance: none where the port is held against itself. B3, B4a and B4b on
a process mesh run the same twins on the same world as a one-process
mesh, and the DDP step adds the same rank gradients in the same ring
order, so results, losses and parameters are bitwise equal. Against
gloo_tpu's DDP step (flash attention off on both sides, ROADMAP C.6), the
loss to rtol 1e-5 and the parameters after one SGD(0.1) step to atol 1e-5,
as tests/test_torch_ddp.py holds the one-process step: XLA's psum adds
the rank gradients in another order than the ring.

Tests marked `cuda` drive the peer workspace and the cross-process
kernels in real processes on the card and skip without one; they import
no JAX.
"""

import contextlib
import socket
import subprocess
import sys
import textwrap
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gloo_tpu_torch import _lib
from gloo_tpu_torch import entry as entry_mod
from gloo_tpu_torch.models import Transformer, TransformerConfig
from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.parallel import make_ddp_train_step
from gloo_tpu_torch.tpu import init_multihost, make_mesh, spmd

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = Path(__file__).resolve().parent.parent
# The narrow flagship of tests/test_torch_ddp.py at one layer.
NARROW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=1, d_ff=128,
              max_seq_len=32)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _processes(devices, fn, axes=None, timeout=60.0):
    """fn(ctx, mesh, rank) in one thread per "process", each with its own
    init_multihost (mesh_axes `axes`) over a TcpStoreServer on a free
    port (rank 0 serves it); devices[q] are process q's devices. Returns
    the per-process results; re-raises the first error."""
    size = len(devices)
    address = f"127.0.0.1:{_free_port()}"
    results, errors = [None] * size, []

    def worker(rank):
        ctx = None
        try:
            ctx, mesh = init_multihost(rank, size, address, mesh_axes=axes,
                                       timeout=30.0,
                                       device_hostname="127.0.0.1",
                                       devices=devices[rank])
            results[rank] = fn(ctx, mesh, rank)
        except BaseException as exc:  # noqa: BLE001 - surfaced to caller
            errors.append((rank, exc))
        finally:
            if ctx is not None:
                ctx.close()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), f"a process did not finish in {timeout} s"
    if errors:
        rank, exc = errors[0]
        raise AssertionError(f"process {rank} failed: {exc!r}") from exc
    return results


def _cpus(counts):
    return [["cpu"] * c for c in counts]


# ---- the size-1 bootstrap against the reference ----

@pytest.mark.parametrize("axes", [None, {"data": -1}, {"a": 2, "b": 4}])
def test_size_one_matches_the_reference(axes):
    """At size 1 both wire a connected Context of one rank and a mesh over
    the process's devices (the reference's 8 CPU devices, the port given
    as many): the same shape and, along every axis, the ring tables of
    pallas_ring.py's _ring_neighbors evaluated in shard_map."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import gloo_tpu.tpu
    from gloo_tpu.ops.pallas_ring import _ring_neighbors

    jctx, jmesh = gloo_tpu.tpu.init_multihost(0, 1, f"127.0.0.1:{_free_port()}",
                                              mesh_axes=axes)
    ctx, mesh = init_multihost(0, 1, f"127.0.0.1:{_free_port()}",
                               mesh_axes=axes, device_hostname="127.0.0.1",
                               devices=["cpu"] * len(jax.devices()))
    try:
        assert (ctx.rank, ctx.size) == (jctx.rank, jctx.size) == (0, 1)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.local_ranks == list(range(mesh.size))
        assert mesh.process_of == [0] * mesh.size
        names = tuple(mesh.axis_names)
        for axis in names:
            def tables(_):
                _, right, left = _ring_neighbors(axis, names)
                return jnp.stack([lax.axis_index(axis), right, left])[None]

            f = jax.jit(jax.shard_map(tables, mesh=jmesh, in_specs=P(names),
                                      out_specs=P(names), check_vma=False))
            ref = np.asarray(f(jnp.zeros((mesh.size,))))
            assert [list(t) for t in ref.T] == \
                [list(t) for t in mesh.ring_neighbors(axis)]
        assert float(ctx.allreduce(torch.ones(3))[0]) == 1.0
    finally:
        ctx.close()
        jctx.close()


# ---- the process mesh ----

@pytest.mark.parametrize("counts", [(1, 1), (1, 1, 1), (1, 1, 1, 1),
                                    (1, 3), (2, 2)],
                         ids=["2x1", "3x1", "4x1", "1+3", "2x2"])
def test_process_mesh_and_host_plane(counts):
    """Each process: a host allreduce of rank + 1 (its closed form), the
    flat ranks it owns (process-major), and ring tables equal to
    make_mesh's over the same flat list, along every axis."""
    size = sum(counts)
    axes = {"data": 2, "model": 2} if size == 4 else None

    def fn(ctx, mesh, rank):
        total = ctx.allreduce(torch.full((4,), float(rank + 1)))
        tables = {a: (mesh.ring_members(a), mesh.ring_neighbors(a))
                  for a in mesh.axis_names}
        return (float(total[0]), mesh.process_of, mesh.local_ranks,
                mesh.shape, tables, str(mesh.device))

    res = _processes(_cpus(counts), fn, axes)
    flat = make_mesh(axes, devices=["cpu"] * size)
    owners = [q for q, c in enumerate(counts) for _ in range(c)]
    for rank, (total, process_of, local, shape, tables, dev) in \
            enumerate(res):
        assert total == len(counts) * (len(counts) + 1) / 2
        assert process_of == owners
        assert local == [r for r, q in enumerate(owners) if q == rank]
        assert shape == flat.shape and dev == "cpu"
        for a, (members, neighbors) in tables.items():
            assert members == flat.ring_members(a)
            assert neighbors == flat.ring_neighbors(a)


def _world(dtype, ranks, rows, cols, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.randint(-1000, 1000, (ranks, rows, cols))
                                .astype(np.int32))
    return torch.from_numpy(rng.randn(ranks, rows, cols).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("counts,axes", [
    ((1, 1, 1, 1), None), ((1, 1, 1), None), ((1, 1, 1, 1),
                                              {"data": 2, "model": 2}),
    ((2, 2), {"data": 2, "model": 2}), ((1, 3), {"data": 2, "model": 2})],
    ids=["4x1", "3x1", "4x1-2x2", "2x2-2x2", "1+3-2x2"])
def test_ring_collectives_across_processes(dtype, counts, axes):
    """B3, B4a and B4b on each process's local rows, along every axis (and
    the tuple of both), bitwise the one-process world's rows."""
    size = sum(counts)
    rows = 6 * size
    world = _world(dtype, size, rows, 8)
    flat = make_mesh(axes, devices=["cpu"] * size)
    axis_list = list(flat.axis_names) + (
        [tuple(flat.axis_names)] if len(flat.axis_names) > 1 else [])

    def fn(ctx, mesh, rank):
        mine = world[mesh.local_ranks]
        return mesh.local_ranks, {
            str(a): (ring.ring_allreduce(mine, a, mesh),
                     ring.ring_reduce_scatter(mine, a, mesh),
                     ring.ring_allgather(mine, a, mesh))
            for a in axis_list}

    res = _processes(_cpus(counts), fn, axes)
    for local, outs in res:
        for a in axis_list:
            want = (ring.ring_allreduce(world, a, flat),
                    ring.ring_reduce_scatter(world, a, flat),
                    ring.ring_allgather(world, a, flat))
            for got, ref in zip(outs[str(a)], want):
                assert got.dtype == ref.dtype
                assert torch.equal(got, ref[local])


def test_ring_allreduce_is_differentiable_across_processes():
    """The VJP of a sum-allreduce is the same allreduce of the cotangent,
    made by every process in its backward."""
    world = _world(torch.float32, 4, 8, 4)
    cot = _world(torch.float32, 4, 8, 4, seed=1)
    flat = make_mesh({"data": 4}, devices=["cpu"] * 4)

    def fn(ctx, mesh, rank):
        x = world[mesh.local_ranks].clone().requires_grad_()
        ring.ring_allreduce(x, "data", mesh).backward(cot[mesh.local_ranks])
        return x.grad

    grads = _processes(_cpus((1, 1, 1, 1)), fn)
    want = ring.ring_allreduce(cot, "data", flat)
    for r, g in enumerate(grads):
        assert torch.equal(g, want[r:r + 1])


# ---- the DDP step across processes ----

def _narrow(dtype=torch.float32, flash=True):
    cfg = TransformerConfig(dtype=dtype, use_flash_attention=flash, **NARROW)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    return cfg, model


def _copies(cfg, model, count):
    out = []
    for _ in range(count):
        m = Transformer(cfg, device="cpu")
        m.load_state_dict(model.state_dict())
        out.append(m)
    return out


def _lm(m, b):
    return m.loss(*b)


def test_ddp_step_across_processes_is_the_world_step():
    """Three Adam steps of make_ddp_train_step over 4 "processes" (one
    replica each, its 2 of 8 sequences) against the same steps over a
    one-process world of 4 ranks: losses and parameters bitwise."""
    cfg, model = _narrow()
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 16)), dtype=torch.int32)
    targets = torch.roll(tokens, -1, 1)
    world = _copies(cfg, model, 4)
    world_opts = [torch.optim.Adam(m.parameters(), **entry_mod.ADAM_SETTINGS)
                  for m in world]
    world_step = make_ddp_train_step(_lm, make_mesh(
        {"data": 4}, devices=["cpu"] * 4))
    want = [float(world_step(world, world_opts, (tokens, targets)))
            for _ in range(3)]

    def fn(ctx, mesh, rank):
        (replica,) = _copies(cfg, model, 1)
        opt = torch.optim.Adam(replica.parameters(),
                               **entry_mod.ADAM_SETTINGS)
        step = make_ddp_train_step(_lm, mesh)
        batch = (tokens[2 * rank:2 * rank + 2],
                 targets[2 * rank:2 * rank + 2])
        losses = [float(step([replica], [opt], batch)) for _ in range(3)]
        return losses, [p.detach().clone() for p in replica.parameters()]

    for losses, params in _processes(_cpus((1, 1, 1, 1)), fn):
        assert losses == want
        for p, q in zip(params, world[0].parameters()):
            assert torch.equal(p, q.detach())


def test_ddp_step_across_processes_matches_the_reference():
    """One SGD(0.1) step over 4 "processes" against gloo_tpu's DDP step
    over a 4-device mesh, flash attention off on both sides (ROADMAP
    C.6): the loss to rtol 1e-5, parameters to atol 1e-5."""
    jax = pytest.importorskip("jax")
    optax = pytest.importorskip("optax")
    import jax.numpy as jnp

    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from gloo_tpu.parallel import make_ddp_train_step as jax_ddp
    from gloo_tpu.tpu import make_mesh as jax_make_mesh
    from gloo_tpu_torch import weights

    jm = JaxTransformer(JaxConfig(dtype=jnp.float32,
                                  use_flash_attention=False, **NARROW))
    jparams = jm.init(jax.random.PRNGKey(0))
    tx = optax.sgd(0.1)
    jstep = jax_ddp(jm.loss, tx, jax_make_mesh({"data": 4},
                                               devices=jax.devices()[:4]))
    cfg = TransformerConfig(dtype=torch.float32, use_flash_attention=False,
                            **NARROW)
    state = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 32))
    targets = np.roll(tokens, -1, axis=1)
    jparams, _, jloss = jstep(jparams, tx.init(jparams),
                              (jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(targets, jnp.int32)))
    ref = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tok = torch.as_tensor(tokens, dtype=torch.int32)
    tgt = torch.as_tensor(targets, dtype=torch.int32)

    def fn(ctx, mesh, rank):
        m = Transformer(cfg, device="cpu")
        m.load_state_dict(state)
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        loss = make_ddp_train_step(_lm, mesh)(
            [m], [opt], (tok[2 * rank:2 * rank + 2],
                         tgt[2 * rank:2 * rank + 2]))
        return float(loss), {n: p.detach().clone()
                             for n, p in m.named_parameters()}

    for loss, params in _processes(_cpus((1, 1, 1, 1)), fn):
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_multihost_ddp_entry_is_ddp_train_entry_on_the_cpu():
    """multihost_ddp_entry over 4 "processes" at full width: its first
    step's loss is ddp_train_entry()'s, bitwise, on each process."""
    step, (replicas, optimizers, batch) = entry_mod.ddp_train_entry("cpu")
    want = float(step(replicas, optimizers, batch))
    address = f"127.0.0.1:{_free_port()}"
    losses, errors = [None] * 4, []

    def worker(rank):
        try:
            mstep, (reps, opts, part) = entry_mod.multihost_ddp_entry(
                rank, 4, address, "cpu", device_hostname="127.0.0.1")
            assert len(reps) == 1 and part[0].shape == (2, 128)
            assert mstep.mesh.local_ranks == [rank]
            losses[rank] = float(mstep(reps, opts, part))
            mstep.context.close()
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert losses == [want] * 4


# ---- the peer workspace's layout, on host memory ----

def test_peer_workspace_tables_views_and_growth(monkeypatch):
    """PeerWorkspace over stand-ins for the CUDA calls: each "process"'s
    allocation is a host tensor, and opening a peer's handle gives that
    tensor's address (the threads share an address space). Every
    process's pointer tables then reach each rank's part of every named
    region where its owner's views put them; a larger call grows every
    workspace at once, and every family's count restarts there; agree
    takes the least value over the processes, once per key."""
    import ctypes

    from gloo_tpu_torch.tpu import peer

    owners = {}

    class HostAllocation:
        def __init__(self, nbytes, device):
            self.bytes = torch.zeros(nbytes, dtype=torch.uint8)
            self.ptr = self.bytes.data_ptr()
            owners[self.handle()] = self

        def handle(self):
            return self.ptr.to_bytes(8, "little") * 8

        def free(self):
            self.ptr, self.bytes = 0, None

    monkeypatch.setattr(peer, "_Allocation", HostAllocation)
    monkeypatch.setattr(peer._Mappings, "open",
                        lambda self, h: owners[h].ptr)
    monkeypatch.setattr(peer._Mappings, "close_all", lambda self: None)
    monkeypatch.setattr(peer, "card_id", lambda device: "one card")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def fn(ctx, mesh, rank):
        ws = peer.PeerWorkspace(mesh, ctx, mesh.store, "cpu")
        seen = []
        slices = ws.agree("ring", 6 + rank)
        assert ws.agree("ring", 100) == slices
        for rows in (4, 64):
            ws.reserve({"in": rows * 8 * 4, "out": 2 * rows * 8 * 4,
                        "ring_flags": slices * 8})
            x = ws.view("in", torch.float32, (rows, 8))
            x.copy_(torch.arange(x.numel(), dtype=torch.float32)
                    .view_as(x) + 1000 * rank)
            ws.view("out", torch.float32, (2 * rows, 8)).fill_(-rank)
            assert ws.holds("in", x)
            assert not ws.holds("in", x.clone())
            assert not ws.holds("out", x)
            ctx.barrier()
            # Every rank's rows as the pointer tables reach them.
            ins = [torch.frombuffer(bytearray(ctypes.string_at(
                ws.table("in")[r], rows * 8 * 4)), dtype=torch.float32)
                for r in range(mesh.size)]
            outs = [torch.frombuffer(bytearray(ctypes.string_at(
                ws.table("out")[r], 2 * rows * 8 * 4)), dtype=torch.float32)
                for r in range(mesh.size)]
            seen.append((slices, ws.shared_card, ws.advance("ring", 3),
                         ws.advance("ring", 3), ws.advance("alltoall", 5),
                         ins, outs))
            ctx.barrier()
        with pytest.raises(ValueError, match="unknown workspace regions"):
            ws.reserve({"bogus": 8})
        ws.close()
        return seen

    res = _processes(_cpus((1, 1, 1, 1)), fn)
    for seen in res:
        for rows, (slices, shared, before0, before1, other, ins, outs) in \
                zip((4, 64), seen):
            assert slices == 6 and shared
            assert (before0, before1, other) == (0, 3, 0)
            for r in range(4):
                assert torch.equal(ins[r], torch.arange(
                    rows * 8, dtype=torch.float32) + 1000 * r)
                assert torch.equal(outs[r], torch.full((2 * rows * 8,),
                                                       -float(r)))


# ---- refusals ----

def _pmesh(ranks=2, device="cpu", processes=2, axes=None):
    per = ranks // processes
    return make_mesh(axes or {"data": ranks}, devices=[device] * ranks,
                     process_of=[r // per for r in range(ranks)], process=0)


def test_what_has_no_cross_process_form_refuses_a_process_mesh():
    """The allreduce variants and spmd's collectives without a kernel
    raised on a process mesh until they had a cross-process form (the test
    keeps that name): each now gives, on each process's local rows of 2
    processes of 2 ranks, the one-process world's rows bitwise. What still
    has no cross-process form (the two-level DDP, unshard_state) raises:
    tests/test_torch_multihost_sp.py."""
    world = _world(torch.float32, 4, 128, 256, seed=5)

    def calls(x, mesh):
        return [spmd.allreduce(x, "data", "max", mesh=mesh),
                spmd.broadcast(x, "data", mesh=mesh),
                spmd.ppermute(x, "data", [(0, 1)], mesh=mesh),
                ring.ring_allreduce_hbm(x, "data", mesh),
                ring.ring_allreduce_q8(x, "data", mesh),
                ring.ring_allreduce_bidir(x, "data", mesh),
                spmd.shift(x, "data", mesh=mesh)]

    want = calls(world, make_mesh({"data": 4}, devices=["cpu"] * 4))
    res = _processes(_cpus((2, 2)), lambda ctx, mesh, rank: (
        mesh.local_ranks, calls(world[mesh.local_ranks], mesh)))
    for local, got in res:
        for g, w in zip(got, want):
            assert torch.equal(g, w[local])


def test_process_mesh_checks():
    with pytest.raises(ValueError, match="process-major"):
        make_mesh({"data": 3}, devices=["cpu"] * 3, process_of=[0, 2, 1])
    with pytest.raises(ValueError, match="not one of"):
        make_mesh({"data": 2}, devices=["cpu"] * 2, process_of=[0, 1],
                  process=2)
    mesh = make_mesh({"data": 4}, devices=["cpu", "meta", "cpu", "cpu"],
                     process_of=[0, 0, 1, 1], process=0)
    with pytest.raises(NotImplementedError, match="in one process"):
        mesh.device
    other = make_mesh({"data": 4}, devices=["cpu", "meta", "cpu", "cpu"],
                      process_of=[0, 0, 1, 1], process=1)
    assert other.device == torch.device("cpu")
    assert other.local_ranks == [2, 3] and other.processes == 2
    with pytest.raises(ValueError, match="local tensor"):
        ring.ring_allreduce(torch.zeros(4, 4, 2), "data", other)


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, ["cuda"]):
        with pytest.raises(RuntimeError, match="device"):
            init_multihost(0, 1, f"127.0.0.1:{_free_port()}",
                           device_hostname="127.0.0.1", devices=devices)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_mod.multihost_ddp_entry(0, 1, f"127.0.0.1:{_free_port()}")


def test_more_ranks_than_the_kernels_peer_table_raise(monkeypatch):
    """The kernels' rank tables live in device memory, so the card's path
    (a meta tensor takes it) refuses a world of 34 ranks in 2 processes
    only where a card cannot hold the 17 local ranks' blocks at once (a
    fake library that reports 16), and then names the kernel, before it
    reserves or launches anything; the CPU's twins take any size."""
    ranks = 34

    class FakeLib:
        def gtt_ring_peer_max_blocks(self, ref):
            ref._obj.value = 16
            return 0

    monkeypatch.setattr(ring, "_ring_lib", lambda: FakeLib())
    monkeypatch.setattr(ring, "_peer_max_blocks", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = _pmesh(ranks, device="meta")
    agreed = []
    mesh.workspace = types.SimpleNamespace(
        agree=lambda key, value: agreed.append((key, value)) or value,
        reserve=lambda regions: pytest.fail("reserved past residency"))
    x = torch.empty(ranks // 2, ranks, 4, device="meta")
    for fn in (ring.ring_allreduce, ring.ring_reduce_scatter,
               ring.ring_allgather):
        with pytest.raises(RuntimeError, match=f"{fn.__name__}: 17 blocks "
                           "must be resident at once"):
            fn(x, "data", mesh)
    # The processes agree on the slices before any of them raises.
    assert agreed == [("ring", 0)] * 3
    world = _world(torch.float32, ranks, ranks, 2)
    res = _processes(_cpus((ranks // 2, ranks // 2)),
                     lambda ctx, m, r: ring.ring_allreduce(
                         world[m.local_ranks], "data", m))
    flat = make_mesh({"data": ranks}, devices=["cpu"] * ranks)
    assert torch.equal(torch.cat(res), ring.ring_allreduce(world, "data",
                                                           flat))


# ---- on the card ----

_CARD_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from gloo_tpu_torch.ops import ring
    from gloo_tpu_torch.tpu import init_multihost
    from gloo_tpu_torch.tpu.peer import pingpong

    rank, size, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ctx, mesh = init_multihost(rank, size, address, timeout=60.0,
                               device_hostname="127.0.0.1")
    gen = torch.Generator().manual_seed(0)
    world = torch.randn(size, 4 * size, 40, generator=gen)
    out = {"probe": pingpong(ctx, mesh.store, 10, mesh.device)
           .get("round_trips_per_s", -1.0)}
    ok = []
    for k in range(3):
        x = (world + k).to(mesh.device)
        mine = x[mesh.local_ranks]
        for name in ("ring_allreduce", "ring_reduce_scatter",
                     "ring_allgather"):
            got = getattr(ring, name)(mine, "data", mesh)
            ref = getattr(ring, name + "_plain")(x, "data", mesh)
            ok.append(torch.equal(got, ref[mesh.local_ranks]))
    out["ok"] = ok
    out["launches"] = ring.ring_allreduce.launches
    ctx.close()
    print(json.dumps(out))
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peer workspace maps device "
                    "memory between processes with CUDA IPC")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 3])
def test_peer_workspace_across_processes_on_card(cuda_device, size):
    """`size` processes on the card: the probe bounces a counter between
    ranks 0 and 1, and B3, B4a and B4b over the peer workspace are bitwise
    their twins on the world, three calls each."""
    import json

    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARD_WORKER, str(r), str(size), address],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**__import__("os").environ, "PYTHONPATH": str(REPO)})
        for r in range(size)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert all(res["ok"]) and len(res["ok"]) == 9
        assert res["launches"] == 3
    assert json.loads(outs[0][0].strip().splitlines()[-1])["probe"] > 0
