"""Tensor and expert parallelism across processes: spmd's kernel
collectives, the collective matmuls (B5a, B5b), the all-to-all (B8), the
TP dispatch, the dp x tp step and the MoE routing on a process mesh,
against the port's one-process world and against gloo_tpu.

Processes are simulated with threads, each with its own
init_multihost(devices=["cpu"]) (tests/test_torch_multihost.py's
_processes): on CPU tensors every cross-process collective gathers the
world through the host plane and runs the kernel's twin, then keeps the
local rows.

Tolerance: none where the port is held against itself. A process mesh
runs the same twins on the same world as a one-process mesh, so results,
gradients, losses and parameters are bitwise equal. Against gloo_tpu:
tests/test_torch_overlap.py's bounds for B5a/B5b against the interpreted
Pallas kernels (f32 rtol/atol 1e-5; bf16 two ulps of the largest |JAX|
value), tests/test_torch_ep.py's for dispatch_combine (bitwise with a
scaling expert), and tests/test_torch_dp_tp.py's for the dp x tp step
against the GSPMD step (loss rtol 1e-5, parameters atol 1e-5 after the
steps).

Tests marked `cuda` drive the cross-process kernels in real processes on
the card and skip without one; they import no JAX.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gloo_tpu_torch import _lib
from gloo_tpu_torch import entry as entry_mod
from gloo_tpu_torch.models import Transformer, TransformerConfig
from gloo_tpu_torch.ops import overlap, ring
from gloo_tpu_torch.parallel import dispatch_combine, dp_tp, tp
from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd
from gloo_tpu_torch.tpu.mesh import MULTI_PROCESS_ITEM
from test_torch_multihost import _cpus, _free_port, _processes

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = Path(__file__).resolve().parent.parent
TP22 = {"data": 2, "model": 2}
# (processes' rank counts, mesh axes): 2, 3 and 4 processes of one rank,
# the uneven 1 + 3, and {"data": 2, "model": 2} over 4 and over 2 x 2.
LAYOUTS = [((1, 1), None), ((1, 1, 1), None), ((1, 1, 1, 1), None),
           ((1, 3), None), ((1, 1, 1, 1), TP22), ((2, 2), TP22)]
LAYOUT_IDS = ["2x1", "3x1", "4x1", "1+3", "4x1-2x2", "2x2-2x2"]


def _world(dtype, shape, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.randint(-1000, 1000, shape)
                                .astype(np.int32))
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _axes(mesh):
    names = list(mesh.axis_names)
    return names + ([tuple(names)] if len(names) > 1 else [])


def _mesh_of(counts, axes):
    return make_mesh(axes, devices=["cpu"] * sum(counts))


# ---- spmd's kernel collectives ----

def _spmd_calls(x, axis, mesh, floating):
    """Every kernel collective of spmd on x along `axis`, by name."""
    out = {
        "rank": spmd.rank(axis, mesh=mesh),
        "size": torch.tensor(spmd.size(axis, mesh=mesh)),
        "allreduce": spmd.allreduce(x, axis, mesh=mesh),
        "reduce": spmd.reduce(x, axis, root=1, mesh=mesh),
        "reduce_scatter": spmd.reduce_scatter(x, axis, scatter_axis=1,
                                              mesh=mesh),
        "allgather": spmd.allgather(x, axis, gather_axis=1, mesh=mesh),
        "allgather_stacked": spmd.allgather(x, axis, tiled=False, mesh=mesh),
        "alltoall": spmd.alltoall(x, axis, mesh=mesh),
        "alltoall_strided": spmd.alltoall(x, axis, split_axis=1,
                                          concat_axis=2, mesh=mesh),
    }
    if floating:
        out["mean"] = spmd.mean(x, axis, mesh=mesh)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("counts,axes", LAYOUTS, ids=LAYOUT_IDS)
def test_spmd_kernel_collectives_across_processes(counts, axes, dtype):
    """spmd's sum collectives, allgather and alltoall on each process's
    local rows, along every axis (and the tuple of both): bitwise the
    one-process world's rows."""
    size = sum(counts)
    world = _world(dtype, (size, 2 * size, 12 * size, 3))
    flat = _mesh_of(counts, axes)
    floating = dtype.is_floating_point

    def fn(ctx, mesh, rank):
        mine = world[mesh.local_ranks]
        return mesh.local_ranks, {str(a): _spmd_calls(mine, a, mesh,
                                                      floating)
                                  for a in _axes(mesh)}

    for local, outs in _processes(_cpus(counts), fn, axes):
        for a in _axes(flat):
            want = _spmd_calls(world, a, flat, floating)
            for name, got in outs[str(a)].items():
                ref = want[name] if name == "size" else want[name][local]
                assert got.dtype == ref.dtype, (a, name)
                assert torch.equal(got, ref), (a, name)


def _xla_collectives(mesh, x):
    """What was an XLA collective in the reference, by case id."""
    return {
        "broadcast": lambda: spmd.broadcast(x, "data", mesh=mesh),
        "scatter": lambda: spmd.scatter(x, "data", mesh=mesh),
        "ppermute": lambda: spmd.ppermute(x, "data", [(0, 1)], mesh=mesh),
        "shift": lambda: spmd.shift(x, "data", mesh=mesh),
        "barrier": lambda: spmd.barrier("data", mesh=mesh),
        "allreduce_max": lambda: spmd.allreduce(x, "data", "max", mesh=mesh),
        "allreduce_min": lambda: spmd.allreduce(x, "data", "min", mesh=mesh),
        "allreduce_product": lambda: spmd.allreduce(x, "data", "product",
                                                    mesh=mesh),
        "reduce_max": lambda: spmd.reduce(x, "data", op="max", mesh=mesh),
        "reduce_scatter_max": lambda: spmd.reduce_scatter(x, "data", "max",
                                                          mesh=mesh),
        "group_broadcast": lambda: CudaProcessGroup(mesh).broadcast(x),
        "group_send_recv": lambda: CudaProcessGroup(mesh).send_recv(
            x, [(0, 1)]),
        "group_barrier": lambda: CudaProcessGroup(mesh).barrier(),
    }


@pytest.mark.parametrize("call", sorted(_xla_collectives(None, None)))
def test_collectives_without_a_cross_process_form_raise(call):
    """What was an XLA collective in the reference raised on a process
    mesh until it had a device transport across processes (the test keeps
    that name); each now has one (the transport of ops/permute.py, the
    cross-process B4b or B3) and gives, on each process's local rows of 2
    processes of 2 ranks, the one-process world's rows bitwise (the group
    barrier returns nothing). What still has no cross-process form raises:
    tests/test_torch_multihost_sp.py."""
    world = _world(torch.float32, (4, 8, 6), seed=9)
    want = _xla_collectives(make_mesh({"data": 4}, devices=["cpu"] * 4),
                            world)[call]()

    def fn(ctx, mesh, rank):
        return mesh.local_ranks, _xla_collectives(
            mesh, world[mesh.local_ranks])[call]()

    for local, got in _processes(_cpus((2, 2)), fn):
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            assert torch.equal(got, want[local])


def test_process_group_runs_its_kernel_methods_on_local_rows():
    """CudaProcessGroup on a process mesh: each kernel-backed method takes
    and returns the local rows (one per local rank), bitwise the
    one-process group's rows."""
    world = _world(torch.float32, (4, 8, 3), seed=3)
    flat = CudaProcessGroup(make_mesh({"data": 4}, devices=["cpu"] * 4))
    want = {"allreduce": flat.allreduce(world), "reduce": flat.reduce(world,
                                                                      2),
            "allgather": flat.allgather(world),
            "reduce_scatter": flat.reduce_scatter(world),
            "alltoall": flat.alltoall(world)}

    def fn(ctx, mesh, rank):
        group = CudaProcessGroup(mesh)
        x = group.shard(world[mesh.local_ranks].numpy())
        with pytest.raises(ValueError, match="local ranks"):
            group.shard(world.numpy())
        return mesh.local_ranks, {
            "allreduce": group.allreduce(x), "reduce": group.reduce(x, 2),
            "allgather": group.allgather(x),
            "reduce_scatter": group.reduce_scatter(x),
            "alltoall": group.alltoall(x)}

    for local, got in _processes(_cpus((1, 3)), fn):
        for name, out in got.items():
            assert torch.equal(out, want[name][local]), name


# ---- B5a and B5b ----

def _mm_world(dtype, n, ranks, rows, k, cols, seed):
    x = _world(dtype, (ranks, n * rows, k), seed)
    w = (_world(torch.float32, (ranks, k, cols), seed + 1)
         / k ** 0.5).to(dtype)
    g_rs = _world(dtype, (ranks, rows, cols), seed + 2)
    g_ag = _world(dtype, (ranks, n * rows, cols), seed + 3)
    return x, w, g_rs, g_ag


def _mm_calls(x, w, g_rs, g_ag, axis, mesh, rows):
    """B5a and B5b forward, and both VJPs (dx, dw), on x, w."""
    out = {"rs": overlap.matmul_reduce_scatter(x, w, axis, mesh)}
    out["y"], out["gx"] = overlap.allgather_matmul_fwd(
        x[:, :rows].contiguous(), w, axis, mesh)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    overlap.matmul_reduce_scatter(xa, wa, axis, mesh).backward(g_rs)
    out["rs_dx"], out["rs_dw"] = xa.grad, wa.grad
    xb = x[:, :rows].clone().requires_grad_()
    wb = w.clone().requires_grad_()
    overlap.allgather_matmul(xb, wb, axis, mesh).backward(g_ag)
    out["ag_dx"], out["ag_dw"] = xb.grad, wb.grad
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts,axes,axis", [
    ((1, 1), None, "data"), ((1, 1, 1, 1), None, "data"),
    ((1, 3), None, "data"), ((2, 2), TP22, "model"),
    ((1, 1, 1, 1), TP22, "data")],
    ids=["2x1", "4x1", "1+3", "2x2-model", "4x1-data"])
def test_collective_matmuls_across_processes(counts, axes, axis, dtype):
    """B5a and B5b on each process's local x and w, forward and VJP (B5a's
    through the cross-process B4b, B5b's through the cross-process B5a):
    bitwise the one-process world's rows."""
    size = sum(counts)
    flat = _mesh_of(counts, axes)
    n, rows = flat.axis_size(axis), 16
    args = _mm_world(dtype, n, size, rows, 24, 40, seed=7)
    want = _mm_calls(*args, axis, flat, rows)

    def fn(ctx, mesh, rank):
        mine = mesh.local_ranks
        return mine, _mm_calls(*(t[mine] for t in args), axis, mesh, rows)

    for local, got in _processes(_cpus(counts), fn, axes):
        for name, out in got.items():
            assert torch.equal(out, want[name][local]), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_collective_matmuls_across_four_processes_match_jax(dtype):
    """At n = 4 over 4 "processes": B5a with the K-sharded operands and B5b
    with a replicated w against gloo_tpu's kernels in interpret mode, with
    tests/test_torch_overlap.py's tolerances."""
    pytest.importorskip("jax")
    from test_torch_overlap import (DTYPES, P, _assert_close, _cols,
                                    _jax_mesh, _rand, _rows, _run, _torch,
                                    jax_ag, jax_rs)
    n = 4
    npt, _ = DTYPES[dtype]
    m, k_total, cols = 8 * n, 16 * n, 128
    x, w = _rand((m, k_total), 0, npt), _rand((k_total, cols), 1, npt)
    ref_rs = _run(lambda xs, ws: jax_rs(xs, ws, "x", interpret=True),
                  _jax_mesh((n,), ("x",)), (P(None, "x"), P("x", None)),
                  P("x", None), x, w)
    xg, wg = _rand((m, k_total), 2, npt), _rand((k_total, cols), 3, npt)
    ref_ag = _run(lambda xs, ws: jax_ag(xs, ws, "x", interpret=True),
                  _jax_mesh((n,), ("x",)), (P("x", None), P(None, None)),
                  P(None, None), xg, wg)
    x_rs, w_rs = _torch(_cols(x, n)), _torch(_rows(w, n))
    x_ag, w_ag = _torch(_rows(xg, n)), _torch(wg).expand(n, -1, -1)

    def fn(ctx, mesh, rank):
        return (overlap.matmul_reduce_scatter(x_rs[[rank]], w_rs[[rank]],
                                              "x", mesh),
                overlap.allgather_matmul(x_ag[[rank]], w_ag[[rank]], "x",
                                         mesh))

    res = _processes(_cpus((1,) * n), fn, {"x": n})
    _assert_close(torch.cat([r[0] for r in res]).reshape(m, cols), ref_rs,
                  dtype)
    for _, y in res:
        _assert_close(y[0], ref_ag, dtype)


def test_the_fused_pair_across_processes_is_the_world_pair():
    """fused_mlp_step (B5b up, GELU, B5a down, forward and backward) on a
    narrow MLP over 4 "processes": y and the three gradients bitwise the
    world's rows."""
    n, rows, d, f = 4, 8, 16, 32
    x = _world(torch.bfloat16, (n, rows, d), 1)
    up = (_world(torch.float32, (n, d, f // n), 2) / 4).bfloat16()
    down = (_world(torch.float32, (n, f // n, d), 3) / 4).bfloat16()
    dy = _world(torch.bfloat16, (n, rows, d), 4)
    y_want, g_want = entry_mod.fused_mlp_step(
        x, up, down, dy, make_mesh({"model": n}, devices=["cpu"] * n))

    def fn(ctx, mesh, rank):
        return entry_mod.fused_mlp_step(x[[rank]], up[[rank]], down[[rank]],
                                        dy[[rank]], mesh)

    for rank, (y, grads) in enumerate(_processes(_cpus((1,) * n), fn,
                                                 {"model": n})):
        assert torch.equal(y, y_want[[rank]])
        for g, want in zip(grads, g_want):
            assert torch.equal(g, want[[rank]])


# ---- the all-to-all and the MoE routing ----

def _ep_inputs(seed, capacity_overflow=False):
    n, t, d = 4, 16, 8
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randn(n, t, d).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, n, (n, t)))
    if capacity_overflow:
        idx[:, ::5] = n + 1
    w = torch.from_numpy((rng.randn(n, d, d) / np.sqrt(d)).astype(
        np.float32))
    return tokens, idx, w


def _ep_step(tokens, idx, w, capacity, mesh):
    leaves = [tokens.clone().requires_grad_(), w.clone().requires_grad_()]
    out = dispatch_combine(lambda x: torch.tanh(torch.bmm(x, leaves[1])),
                           leaves[0], idx, capacity, "expert", mesh=mesh)
    torch.sin(out).sum().backward()
    return out.detach(), leaves[0].grad, leaves[1].grad


@pytest.mark.parametrize("capacity,overflow", [(16, False), (3, True)],
                         ids=["ample", "overflow"])
def test_dispatch_combine_across_processes_is_the_world(capacity, overflow):
    """dispatch_combine over 4 "processes" (its two exchanges and their
    VJPs the cross-process B8): out and the gradients in the tokens and
    the experts' weights bitwise the world's rows, with dropped and
    out-of-range tokens."""
    tokens, idx, w = _ep_inputs(5, overflow)
    want = _ep_step(tokens, idx, w, capacity,
                    make_mesh({"expert": 4}, devices=["cpu"] * 4))

    def fn(ctx, mesh, rank):
        mine = mesh.local_ranks
        return mine, _ep_step(tokens[mine], idx[mine], w[mine], capacity,
                              mesh)

    for layout in ((1, 1, 1, 1), (1, 3)):
        for local, got in _processes(_cpus(layout), fn, {"expert": 4}):
            for g, ref in zip(got, want):
                assert torch.equal(g, ref[local])


def test_dispatch_combine_across_processes_matches_jax():
    """tests/test_torch_ep.py's scaling expert (each expert multiplies its
    slots by 1 + its rank) with overflow, over 4 "processes", against
    gloo_tpu.parallel.ep.dispatch_combine in shard_map: bitwise."""
    pytest.importorskip("jax")
    from test_torch_ep import N, D, T, _jax, jax_dispatch
    capacity = 2
    tokens = np.random.RandomState(3).randn(N * T, D).astype(np.float32)
    idx = np.random.RandomState(3).randint(0, N, (N, T))
    scales = (1.0 + np.arange(N)).astype(np.float32)

    def shard_fn(tok, i, scale):
        return jax_dispatch(lambda x: x * scale[0], tok, i, capacity,
                            "expert")

    want = _jax(shard_fn, tokens, idx.reshape(-1).astype(np.int32), scales)
    tw = torch.from_numpy(tokens).view(N, T, D)
    iw = torch.from_numpy(idx)

    def fn(ctx, mesh, rank):
        scale = float(scales[rank])
        return dispatch_combine(lambda x: x * scale, tw[[rank]], iw[[rank]],
                                capacity, "expert", mesh=mesh)

    got = torch.cat(_processes(_cpus((1,) * N), fn, {"expert": N}))
    np.testing.assert_array_equal(got.reshape(N * T, D).numpy(), want)


def test_mismatches_raise_in_every_process_before_any_launch():
    """Every process of a ring makes the same calls in the same order, so
    a call with a bad shape or dtype must raise the same error in every
    process before it touches the workspace or launches: the later calls
    then still meet. On the CPU each process raises alike and a good call
    after the bad ones is still the world's; on the card's path (a meta
    tensor takes it, and a mesh without a workspace would fail on any use
    of one) the checks come first."""
    x = _world(torch.float32, (4, 8, 6), 1)
    w = _world(torch.float32, (4, 6, 5), 2)
    flat = make_mesh({"data": 4}, devices=["cpu"] * 4)
    want = overlap.matmul_reduce_scatter(x, w, "data", flat)

    def bad_calls(mesh, xs, ws):
        return [lambda: overlap.matmul_reduce_scatter(xs[:, :6], ws, "data",
                                                      mesh),
                lambda: overlap.matmul_reduce_scatter(xs, ws[:, :4], "data",
                                                      mesh),
                lambda: overlap.allgather_matmul(xs, ws.double(), "data",
                                                 mesh),
                lambda: ring.alltoall(xs[:, :6], "data", mesh),
                lambda: spmd.reduce_scatter(xs[:, :6], "data", mesh=mesh),
                lambda: overlap.matmul_reduce_scatter(xs, ws, "data", flat)]

    def fn(ctx, mesh, rank):
        errors = []
        for call in bad_calls(mesh, x[[rank]], w[[rank]]):
            with pytest.raises((ValueError, TypeError)) as info:
                call()
            errors.append(f"{info.type.__name__}: {info.value}")
        return errors, overlap.matmul_reduce_scatter(x[[rank]], w[[rank]],
                                                     "data", mesh)

    res = _processes(_cpus((1,) * 4), fn)
    for rank, (errors, good) in enumerate(res):
        assert errors == res[0][0]
        assert torch.equal(good, want[[rank]])
    meta = make_mesh({"data": 4}, devices=["meta"] * 4,
                     process_of=[0, 1, 2, 3], process=2)
    xm = torch.empty(1, 8, 6, device="meta")
    wm = torch.empty(1, 6, 5, device="meta")
    for call in bad_calls(meta, xm, wm)[:-1] + [
            lambda: overlap.matmul_reduce_scatter(xm.int(), wm.int(),
                                                  "data", meta),
            lambda: overlap.allgather_matmul(xm.int(), wm.int(), "data",
                                             meta)]:
        with pytest.raises((ValueError, TypeError)):
            call()


# ---- the TP dispatch ----

def test_dispatch_agrees_across_processes(monkeypatch):
    """agreed_dispatch decides on the least share and the least ratio over
    the processes, so every process of a ring takes the same arm even
    where its own inputs would pick the other; a process without a ratio
    makes every process take the unfused arm."""
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    cases = {
        # ratio by process: process 0 alone would fuse (0.5 > 1 - 0.9).
        "least_ratio": ([0.9, 0.2, 0.3, 0.4], [0.5] * 4, False),
        "all_fuse": ([0.9, 0.8, 0.95, 0.85], [0.5] * 4, True),
        "a_missing_ratio": ([0.9, 0.9, None, 0.9], [0.5] * 4, False),
        "least_share": ([0.9] * 4, [0.5, 0.05, 0.5, 0.5], False),
    }

    def fn(ctx, mesh, rank):
        return {name: tp.agreed_dispatch(mesh, 64, 64, 64, 4, shares[rank],
                                         ratios[rank])
                for name, (ratios, shares, _) in cases.items()}

    for got in _processes(_cpus((1,) * 4), fn):
        assert got == {name: want for name, (_, _, want) in cases.items()}


def test_dispatch_raises_in_every_process_on_differing_modes(monkeypatch):
    """TPUCOLL_TP_OVERLAP that differs across the processes (here read per
    thread "process") raises ValueError in every process before any
    launch, and the *_auto wrappers raise it too."""
    modes = {}
    monkeypatch.setattr(tp, "_overlap_mode",
                        lambda: modes[threading.current_thread().name])
    x = _world(torch.float32, (4, 8, 6), 1)
    w = _world(torch.float32, (4, 6, 4), 2)

    def fn(ctx, mesh, rank):
        modes[threading.current_thread().name] = \
            "fused" if rank == 0 else "unfused"
        errors = []
        for call in (lambda: tp.agreed_dispatch(mesh, 8, 6, 4, 4, 1.0, 1.0),
                     lambda: tp.row_parallel_dense_scattered_auto(
                         x[[rank]], w[[rank]], "data", mesh=mesh)):
            with pytest.raises(ValueError, match="TPUCOLL_TP_OVERLAP "
                               "differs") as info:
                call()
            errors.append(str(info.value))
        return errors

    res = _processes(_cpus((1,) * 4), fn)
    assert all(r == res[0] for r in res)


@pytest.mark.parametrize("arm", ["fused", "unfused"])
def test_auto_arms_across_processes_are_the_world_arms(monkeypatch, arm):
    """Both *_auto wrappers, one arm forced in every process, over 4
    "processes": bitwise the world's rows of the same arm."""
    monkeypatch.setenv("TPUCOLL_TP_OVERLAP", arm)
    n, rows, k, cols = 4, 8, 12, 16
    x = _world(torch.float32, (n, n * rows, k), 5)
    w = _world(torch.float32, (n, k, cols), 6)
    flat = make_mesh({"x": n}, devices=["cpu"] * n)
    want = (tp.row_parallel_dense_scattered_auto(x, w, "x", mesh=flat),
            tp.allgather_matmul_dense_auto(x[:, :rows], w, "x", mesh=flat))

    def fn(ctx, mesh, rank):
        return (tp.row_parallel_dense_scattered_auto(x[[rank]], w[[rank]],
                                                     "x", mesh=mesh),
                tp.allgather_matmul_dense_auto(x[[rank], :rows], w[[rank]],
                                               "x", mesh=mesh))

    for rank, got in enumerate(_processes(_cpus((1,) * n), fn, {"x": n})):
        for g, ref in zip(got, want):
            assert torch.equal(g, ref[[rank]])


# ---- the dp x tp step ----

NARROW = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=1, d_ff=128,
              max_seq_len=32, use_flash_attention=True)


def _narrow_batches(cfg, steps=3, batch=4):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        tokens = rng.randint(0, cfg.vocab_size, (batch, 32)).astype(np.int32)
        out.append((tokens, np.roll(tokens, -1, axis=1)))
    return out


@pytest.mark.parametrize("counts", [(1, 1, 1, 1), (2, 2), (1, 3)],
                         ids=["4x1", "2x2", "1+3"])
def test_dp_tp_step_across_processes_is_the_world_step(counts):
    """Three Adam steps of make_dp_tp_train_step on a narrow one-layer
    flagship over {"data": 2, "model": 2} split over processes (each its
    data ranks' share of the batch) against the one-process world step:
    losses and every local row of the parameters bitwise."""
    cfg = TransformerConfig(dtype=torch.float32, **NARROW)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batches = _narrow_batches(cfg)
    flat = make_mesh(TP22, devices=["cpu"] * 4)
    world = dp_tp.shard_transformer(model, flat)
    opt = torch.optim.Adam(world.parameters(), **entry_mod.ADAM_SETTINGS)
    step = dp_tp.make_dp_tp_train_step(flat)
    want = [float(step(world, opt, torch.from_numpy(t), torch.from_numpy(g)))
            for t, g in batches]

    def fn(ctx, mesh, rank):
        local = dp_tp.shard_transformer(model, mesh)
        lopt = torch.optim.Adam(local.parameters(),
                                **entry_mod.ADAM_SETTINGS)
        lstep = dp_tp.make_dp_tp_train_step(mesh)
        losses = [float(lstep(local, lopt,
                              dp_tp.data_share(torch.from_numpy(t), mesh),
                              dp_tp.data_share(torch.from_numpy(g), mesh)))
                  for t, g in batches]
        return mesh.local_ranks, losses, {
            n: p.detach().clone() for n, p in local.named_parameters()}

    for local, losses, params in _processes(_cpus(counts), fn, TP22):
        assert losses == want
        for name, p in world.named_parameters():
            assert torch.equal(params[name], p.detach()[local]), name


def test_dp_tp_step_across_processes_matches_the_gspmd_step():
    """The same steps over 4 "processes" against dryrun_multichip's GSPMD
    dp x tp step (tests/test_torch_dp_tp.py's builder, flash on both
    sides): losses rtol 1e-5, every process's shards atol 1e-5 of the
    JAX parameters after three Adam steps."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from gloo_tpu_torch import weights
    from test_torch_dp_tp import _jax_step

    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **NARROW))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=torch.float32, **NARROW)
    state = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batches = _narrow_batches(cfg)
    jparams, jstate, jstep = _jax_step(jm, jparams)
    jlosses = []
    for tokens, targets in batches:
        jparams, jstate, jloss = jstep(jparams, jstate, tokens, targets)
        jlosses.append(float(jloss))
    ref = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")

    def fn(ctx, mesh, rank):
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(state)
        local = dp_tp.shard_transformer(model, mesh)
        opt = torch.optim.Adam(local.parameters(), **entry_mod.ADAM_SETTINGS)
        step = dp_tp.make_dp_tp_train_step(mesh)
        losses = [float(step(local, opt,
                             dp_tp.data_share(torch.from_numpy(t), mesh),
                             dp_tp.data_share(torch.from_numpy(g), mesh)))
                  for t, g in batches]
        return losses, {n: p.detach().clone()
                        for n, p in local.named_parameters()}, mesh

    res = _processes(_cpus((1,) * 4), fn, TP22)
    flat = make_mesh(TP22, devices=["cpu"] * 4)
    want = dp_tp.shard_state(ref, cfg, flat)
    for rank, (losses, params, _) in enumerate(res):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[name][[rank]].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_dp_tp_data_share_and_unshard_on_a_process_mesh():
    """data_share gives each process its data ranks' parts of the batch,
    world_batch then each local rank its part; unshard_state, whose ring
    lies in other processes, raises."""
    batch = torch.arange(8 * 3).view(8, 3)
    flat = make_mesh(TP22, devices=["cpu"] * 4)
    whole = dp_tp.world_batch(batch, flat)
    for counts in ((1, 1, 1, 1), (2, 2), (1, 3)):
        owners = [q for q, c in enumerate(counts) for _ in range(c)]
        for q in range(len(counts)):
            mesh = make_mesh(TP22, devices=["cpu"] * 4, process_of=owners,
                             process=q)
            share = dp_tp.data_share(batch, mesh)
            assert torch.equal(dp_tp.world_batch(share, mesh),
                               whole[mesh.local_ranks])
    with pytest.raises(NotImplementedError, match=MULTI_PROCESS_ITEM[:20]):
        dp_tp.unshard_state({}, TransformerConfig(**NARROW), mesh)


# ---- the three entries ----

def _entries(name, fn, size=4, counts=None):
    """fn(rank) -> result in `size` thread "processes" of the multihost
    entry `name` over a fresh address ("cpu"); returns the results."""
    address = f"127.0.0.1:{_free_port()}"
    results, errors = [None] * size, []

    def worker(rank):
        try:
            step, args = getattr(entry_mod, name)(
                rank, size, address, "cpu", device_hostname="127.0.0.1")
            try:
                results[rank] = fn(rank, step, args)
            finally:
                step.context.close()
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append((rank, exc))

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors, errors
    return results


def test_multihost_dp_tp_entry_is_dp_tp_train_entry():
    """multihost_dp_tp_entry over 4 "processes" at full width: each holds
    dp_tp_train_entry()'s parameters at its rank's rows and its data
    rank's share of the batch; its first step's loss is the world step's,
    bitwise."""
    step, (model, opt, tokens, targets) = entry_mod.dp_tp_train_entry("cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    want = float(step(model, opt, tokens, targets))
    data = make_mesh(TP22, devices=["cpu"] * 4).ring_index("data")

    def fn(rank, lstep, args):
        local, lopt, ltok, ltgt = args
        assert lstep.mesh.local_ranks == [rank]
        for name, p in local.named_parameters():
            assert torch.equal(p.detach(), params[name][[rank]]), name
        per = tokens.shape[0] // 2
        assert torch.equal(ltok, tokens[data[rank] * per:
                                        (data[rank] + 1) * per])
        return float(lstep(local, lopt, ltok, ltgt))

    assert _entries("multihost_dp_tp_entry", fn) == [want] * 4


def test_multihost_fused_mlp_entry_is_fused_mlp_entry():
    """multihost_fused_mlp_entry over 4 "processes": fused_mlp_entry()'s
    inputs at each process's rows (1024 token rows, d_model 256, d_ff 1024
    over 4, bf16), and one forward and backward bitwise the world's."""
    fn0, (x, up, down, dy, mesh) = entry_mod.fused_mlp_entry("cpu")
    assert x.shape == (4, 256, 256) and up.shape == (4, 256, 256)
    assert x.dtype == torch.bfloat16
    y_want, g_want = fn0(x, up, down, dy, mesh)

    def fn(rank, step, args):
        for got, want in zip(args[:4], (x, up, down, dy)):
            assert torch.equal(got, want[[rank]])
        y, grads = step(*args)
        return torch.equal(y, y_want[[rank]]) and all(
            torch.equal(g, w[[rank]]) for g, w in zip(grads, g_want))

    assert _entries("multihost_fused_mlp_entry", fn) == [True] * 4


def test_multihost_ep_entry_is_ep_entry():
    """multihost_ep_entry over 4 "processes" and over 2 of 2 ranks each:
    ep_entry()'s draws at each process's rows, and one step (out and the
    three gradients) bitwise the world's."""
    fn0, (tokens, idx, up, down, mesh) = entry_mod.ep_entry("cpu")
    out_want, g_want = fn0(tokens, idx, up, down, mesh)

    def fn(rank, step, args):
        local = args[-1].local_ranks
        for got, want in zip(args[:4], (tokens, idx, up, down)):
            assert torch.equal(got, want[local])
        out, grads = step(*args)
        return torch.equal(out, out_want[local]) and all(
            torch.equal(g, w[local]) for g, w in zip(grads, g_want))

    assert _entries("multihost_ep_entry", fn) == [True] * 4
    assert _entries("multihost_ep_entry", fn, size=2) == [True] * 2


def test_multihost_entries_refuse_a_size_that_does_not_split_the_mesh():
    for name in ("multihost_dp_tp_entry", "multihost_fused_mlp_entry",
                 "multihost_ep_entry"):
        with pytest.raises(ValueError, match="splits its 4 ranks"):
            getattr(entry_mod, name)(0, 3, f"127.0.0.1:{_free_port()}",
                                     "cpu")


# ---- on the card ----

_CARD_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from gloo_tpu_torch.ops import overlap, ring
    from gloo_tpu_torch.tpu import init_multihost, make_mesh

    rank, size, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ctx, mesh = init_multihost(rank, size, address, timeout=60.0,
                               device_hostname="127.0.0.1")
    dev = mesh.device
    world = make_mesh({"data": size}, devices=[dev] * size)
    mine = mesh.local_ranks
    gen = torch.Generator(dev).manual_seed(0)
    ok = []
    for k in range(3):
        for dtype in (torch.bfloat16, torch.float16):
            x = torch.randn((size, 64 * size, 72), generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn((size, 72, 40), generator=gen, device=dev)
                 / 9).to(dtype)
            ok.append(torch.equal(
                overlap.matmul_reduce_scatter(x[mine], w[mine], "data",
                                              mesh),
                overlap.matmul_reduce_scatter(x, w, "data", world)[mine]))
            xs = x[:, :64].contiguous()
            y, gx = overlap.allgather_matmul_fwd(xs[mine], w[mine], "data",
                                                 mesh)
            y_ref, gx_ref = overlap.allgather_matmul_fwd(xs, w, "data",
                                                         world)
            ok.append(torch.equal(y, y_ref[mine])
                      and torch.equal(gx, gx_ref[mine]))
        a = torch.randn((size, 3, 2 * size, 8), generator=gen, device=dev)
        ok.append(torch.equal(ring.alltoall(a[mine], "data", mesh, 1, 2),
                              ring.alltoall_plain(a, "data", world, 1,
                                                  2)[mine]))
    launches = [overlap.matmul_reduce_scatter.launches,
                overlap.allgather_matmul.launches, ring.alltoall.launches]
    ctx.close()
    print(json.dumps({"ok": ok, "launches": launches}))
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cross-process kernels map "
                    "device memory between processes with CUDA IPC")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 3])
def test_cross_process_kernels_on_card(cuda_device, size):
    """`size` processes on the card: B5a and B5b (bf16, f16) bitwise the
    one-card kernels on the world, and the strided B8 bitwise its twin,
    three calls each; world launches count too."""
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARD_WORKER, str(r), str(size), address],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)})
        for r in range(size)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert all(res["ok"]) and len(res["ok"]) == 15
        # Each process launches the world kernels too: 6 + 6 of B5, 3 B8.
        assert res["launches"] == [12, 12, 3]
