"""The ring allreduce variants, spmd's point-to-point collectives, and
sequence and pipeline parallelism across processes: B9, B10 and B11, the
transport of ops/permute.py (ppermute, shift, broadcast, scatter), the
max/min/product reductions, barrier, ring-flash, Ulysses and ring
attention, GPipe and 1F1B on a process mesh, against the port's
one-process world and against gloo_tpu.

Processes are simulated with threads, each with its own
init_multihost(devices=["cpu"]) (tests/test_torch_multihost.py's
_processes): on CPU tensors every cross-process collective gathers the
world through the host plane and runs the kernel's (or the transport's)
twin, then keeps the local rows.

Tolerance: none where the port is held against itself. A process mesh
runs the same twins on the same world as a one-process mesh, and the
paths' kernels and products run per row, so results, gradients and
losses are bitwise equal. Against gloo_tpu: tests/test_torch_ring_
variants.py's (bitwise) for B9, B10 and B11 against the interpreted
Pallas kernels; tests/test_torch_sp.py's for ring-flash, Ulysses and
ring attention (f32 rtol 1e-4 / atol 1e-5); tests/test_torch_pp.py's for
GPipe and 1F1B (rtol 1e-5 / atol 1e-6); the JAX side in shard_map with
check_vma=False where its interpreted kernels or a replicated input need
it (ROADMAP C.6).

Tests marked `cuda` drive the cross-process kernels and the transport in
real processes on the card and skip without one; they import no JAX.
"""

import functools
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

from gloo_tpu_torch import _lib
from gloo_tpu_torch import entry as entry_mod
from gloo_tpu_torch import weights
from gloo_tpu_torch.models import Transformer, TransformerConfig
from gloo_tpu_torch.models.transformer import world_block
from gloo_tpu_torch.ops import permute, ring
from gloo_tpu_torch.parallel import dp_tp, pp, sp
from gloo_tpu_torch.tpu import (CudaProcessGroup, HierarchicalGroup,
                                make_hierarchical_ddp, make_mesh, spmd)
from gloo_tpu_torch.tpu.mesh import MULTI_PROCESS_ITEM
from test_torch_multihost import _cpus, _free_port, _processes
from test_torch_multihost_tp import LAYOUT_IDS, LAYOUTS, _axes, _world

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = Path(__file__).resolve().parent.parent
VARIANTS = {"hbm": ring.ring_allreduce_hbm, "q8": ring.ring_allreduce_q8,
            "bidir": ring.ring_allreduce_bidir}
# Rows per rank that every ring of 2, 3 and 4 splits for all three
# variants (B10: rows / n % 32), and B11's columns (cols % 256).
ROWS, COLS = 384, 256


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while the thread "processes" run: they share
    torch's pool, and a CPU reduction splits its sum by the threads a
    call gets, which concurrent callers change; with one each, every sum
    keeps the world's order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh_of(counts, axes):
    return make_mesh(axes, devices=["cpu"] * sum(counts))


def _across(counts, axes, fn):
    """fn(mesh) on each "process" of `counts` over `axes`: [(local ranks,
    result)]."""
    return _processes(_cpus(counts),
                      lambda ctx, mesh, rank: (mesh.local_ranks, fn(mesh)),
                      axes)


def _assert_rows(got, want, local, what=""):
    assert got.dtype == want.dtype, what
    assert torch.equal(got, want[local]), what


# ---- B9, B10, B11 ----

def _variant_calls(x, axis, mesh):
    """Each variant that takes x's dtype on x along `axis`, and the VJPs
    of sum(y ** 2) where x is floating (straight-through for B10)."""
    out = {}
    for name, fn in VARIANTS.items():
        if name == "q8" and x.dtype != torch.float32:
            continue
        out[name] = fn(x, axis, mesh)
        if x.dtype.is_floating_point:
            leaf = x.clone().requires_grad_()
            (fn(leaf, axis, mesh) ** 2).sum().backward()
            out[f"{name} vjp"] = leaf.grad
    # B9 on columns that are no whole number of 16-byte units (padded).
    out["hbm ragged"] = ring.ring_allreduce_hbm(x[..., :99].contiguous(),
                                                axis, mesh)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("counts,axes", LAYOUTS, ids=LAYOUT_IDS)
def test_variants_across_processes(counts, axes, dtype):
    """B9, B10 (f32) and B11 on each process's local rows along every axis
    (and the tuple of both), forward and VJP: bitwise the one-process
    world's rows."""
    size = sum(counts)
    world = _world(dtype, (size, ROWS, COLS))
    flat = _mesh_of(counts, axes)
    want = {str(a): _variant_calls(world, a, flat) for a in _axes(flat)}
    for local, outs in _across(counts, axes, lambda mesh: {
            str(a): _variant_calls(world[mesh.local_ranks], a, mesh)
            for a in _axes(mesh)}):
        for a, calls in outs.items():
            assert set(calls) == set(want[a])
            for name, got in calls.items():
                _assert_rows(got, want[a][name], local, (a, name))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variants_across_four_processes_match_jax(name):
    """At n = 4 over 4 "processes": each variant against gloo_tpu's
    interpreted Pallas kernel, bitwise, as tests/test_torch_ring_variants.py
    holds the world."""
    pytest.importorskip("jax")
    from test_torch_ring_variants import _jax_kernel, _jax_ring

    n, cols = 4, 256 if name == "bidir" else 128
    x = np.random.RandomState(23).randn(n, n * 32, cols).astype(np.float32)
    ref = _jax_ring(_jax_kernel(name), x)
    xt = torch.from_numpy(x)
    res = _across((1,) * n, {"x": n},
                  lambda mesh: VARIANTS[name](xt[mesh.local_ranks], "x",
                                              mesh))
    got = torch.cat([out for _, out in res])
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- the transport and the reductions without a kernel ----

def _transport_calls(x, axis, mesh):
    """spmd's point-to-point collectives, the max/min/product reductions
    and barrier on x along `axis`, and CudaProcessGroup's along one name."""
    n = mesh.axis_size(axis)
    last = n - 1
    out = {
        # A permutation that leaves ring index 0 (and at n > 3 the ones
        # between 1 and n - 1) without a source.
        "ppermute": spmd.ppermute(x, axis, [(0, 1), (1, last)] if n > 2
                                  else [(0, 1)], mesh=mesh),
        "ppermute_swap": spmd.ppermute(x, axis, [(0, 1), (1, 0)], mesh=mesh),
        "shift": spmd.shift(x, axis, 1, mesh=mesh),
        "shift_back": spmd.shift(x, axis, -1, mesh=mesh),
        "shift_no_wrap": spmd.shift(x, axis, 1, wrap=False, mesh=mesh),
        "shift_back_no_wrap": spmd.shift(x, axis, -1, wrap=False, mesh=mesh),
        "broadcast": spmd.broadcast(x, axis, last, mesh=mesh),
        "scatter": spmd.scatter(x, axis, 1, mesh=mesh),
        "scatter_axis1": spmd.scatter(x, axis, last, scatter_axis=1,
                                      mesh=mesh),
        "max": spmd.allreduce(x, axis, "max", mesh=mesh),
        "min": spmd.allreduce(x, axis, "min", mesh=mesh),
        "product": spmd.allreduce(x, axis, "product", mesh=mesh),
        "reduce_max": spmd.reduce(x, axis, root=1, op="max", mesh=mesh),
        "reduce_scatter_min": spmd.reduce_scatter(x, axis, "min",
                                                  scatter_axis=1, mesh=mesh),
        "barrier": spmd.barrier(axis, mesh=mesh),
    }
    if isinstance(axis, str) and len(mesh.axis_names) == 1:
        group = CudaProcessGroup(mesh)
        out["group_broadcast"] = group.broadcast(x, root=1)
        out["group_scatter"] = group.scatter(x, root=last)
        out["group_send_recv"] = group.send_recv(x, [(0, 1), (1, 0)])
        out["group_shift"] = group.shift(x, -1)
        out["group_max"] = group.allreduce(x, op="max")
        group.barrier()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("counts,axes", LAYOUTS, ids=LAYOUT_IDS)
def test_transport_across_processes(counts, axes, dtype):
    """The transport's collectives, the reductions on B4b and barrier on
    B3 on each process's local rows, along every axis and both orders of
    a tuple of two: bitwise the one-process world's rows."""
    size = sum(counts)
    world = _world(dtype, (size, 12, 4 * size, 3), seed=4)
    flat = _mesh_of(counts, axes)
    axis_list = _axes(flat) + ([tuple(reversed(flat.axis_names))]
                               if len(flat.axis_names) > 1 else [])
    want = {str(a): _transport_calls(world, a, flat) for a in axis_list}
    for local, outs in _across(counts, axes, lambda mesh: {
            str(a): _transport_calls(world[mesh.local_ranks], a, mesh)
            for a in axis_list}):
        for a, calls in outs.items():
            assert set(calls) == set(want[a])
            for name, got in calls.items():
                _assert_rows(got, want[a][name], local, (a, name))


def test_pull_is_the_twin_and_counts_no_launch_on_the_cpu():
    """ops.permute.pull on a process mesh: each rank's slice of its
    source's value by the tables, zeros without a source, the plain twin
    on the world bitwise; every process raises the same ValueError for a
    bad table before any work, and the CPU counts no launch."""
    world = _world(torch.float32, (4, 5, 6), seed=2)
    flat = make_mesh({"x": 4}, devices=["cpu"] * 4)
    sources, offsets = [2, -1, 0, 0], [3, 0, 12, 0]
    want = permute.pull_plain(world, "x", flat, sources, offsets, 10)
    assert not want[1].any()
    assert torch.equal(want[0], world[2].reshape(-1)[3:13])

    def fn(mesh):
        errors = []
        for bad in (([4, 0, 0, 0], offsets, 10), ([0, 0, 0], [0] * 3, 10),
                    (sources, [25, 0, 0, 0], 10)):
            with pytest.raises(ValueError) as info:
                permute.pull(world[mesh.local_ranks], "x", mesh, *bad)
            errors.append(str(info.value))
        return errors, permute.pull(world[mesh.local_ranks], "x", mesh,
                                    sources, offsets, 10)

    before = permute.pull.launches
    res = _across((1, 3), {"x": 4}, fn)
    assert permute.pull.launches == before
    for local, (errors, got) in res:
        assert errors == res[0][1][0]
        _assert_rows(got, want, local)


@pytest.mark.parametrize("counts", [(1, 1, 1, 1), (1, 3), (2, 2)],
                         ids=["1x4", "1+3", "2x2"])
def test_pull_plan_is_the_same_in_every_process(counts):
    """The card's launch plan of a pull whose offsets the count's widest
    access does not divide: every process of the mesh takes the same
    access, accesses and slices (the flags advance by (n - 1) x slices in
    each), the access divides every pulled offset, and each local rank
    pulls its own source at its own offset."""
    sources, offsets = [1, 0, 3, -1], [0, 1, 2, 7]
    count, elt, most = 8, 4, 132
    flat = make_mesh({"x": 4}, devices=["cpu"] * 4)
    res = _across(counts, {"x": 4},
                  lambda mesh: permute.pull_plan(mesh, "x", sources, offsets,
                                                 count, elt, most))
    plans = {(plan.unit, plan.units, plan.slices) for _, plan in res}
    assert plans == {(4, 8, 1)}
    members, my = flat.ring_members("x"), flat.ring_index("x")
    for local, plan in res:
        for r, src, off in zip(local, plan.src, plan.offset):
            k = my[r]
            if sources[k] < 0:
                assert (src, off) == (-1, 0)
            else:
                assert src == members[r][sources[k]]
                assert off * plan.unit == offsets[k] * elt


def test_ppermute_is_differentiable_across_processes():
    """ppermute on a process mesh takes the inverse permutation of the
    cotangent in its backward: the gradients are the world's, bitwise."""
    world = _world(torch.float32, (4, 6, 3), seed=6)
    cot = _world(torch.float32, (4, 6, 3), seed=7)
    perm = [(0, 2), (2, 3), (3, 0)]

    def grad(x, mesh):
        leaf = x.clone().requires_grad_()
        spmd.ppermute(leaf, "x", perm, mesh=mesh).backward(
            cot[mesh.local_ranks])
        return leaf.grad

    want = grad(world, make_mesh({"x": 4}, devices=["cpu"] * 4))
    for local, got in _across((1, 1, 1, 1), {"x": 4},
                              lambda mesh: grad(world[mesh.local_ranks],
                                                mesh)):
        _assert_rows(got, want, local)


# ---- sequence parallelism ----

SP_SHAPE = (1, 4, 32, 16)  # batch, heads, t_local, head_dim


def _qkv(dtype, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n, *SP_SHAPE).astype(
        np.float32)).to(dtype) for _ in range(3)]


def _sp_run(name, q, k, v, mesh):
    """(out, dq, dk, dv) of sum(sin(out)) for attention `name`."""
    fn = {"ring_flash": sp.ring_flash_attention,
          "ulysses": sp.ulysses_attention,
          "ring_attention": sp.ring_attention}[name]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, "seq", mesh=mesh)
    return [out.detach(), *torch.autograd.grad(torch.sin(out).sum(),
                                               leaves)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [(1, 1, 1, 1), (1, 3), (2, 2)],
                         ids=["4x1", "1+3", "2x2"])
@pytest.mark.parametrize("name", ["ring_flash", "ulysses", "ring_attention"])
def test_sequence_parallel_across_processes_is_the_world(name, counts,
                                                         dtype):
    """Ring-flash, Ulysses and ring attention on each process's local
    rows, forward and backward: bitwise the one-process world's rows."""
    q, k, v = _qkv(dtype, seed=3)
    want = _sp_run(name, q, k, v, make_mesh({"seq": 4},
                                            devices=["cpu"] * 4))
    for local, got in _across(counts, {"seq": 4}, lambda mesh: _sp_run(
            name, *(t[mesh.local_ranks] for t in (q, k, v)), mesh)):
        for g, w in zip(got, want):
            _assert_rows(g, w, local, name)


@pytest.mark.parametrize("name", ["ring_flash", "ulysses", "ring_attention"])
def test_sequence_parallel_across_processes_matches_jax(name):
    """The three paths over 4 "processes" against gloo_tpu.parallel.sp in
    shard_map (ring-flash with block_q = block_k = t_local in interpret
    mode), f32: out and the grads of sum(sin(out)) within
    tests/test_torch_sp.py's tolerance."""
    pytest.importorskip("jax")
    from gloo_tpu.parallel import sp as jsp
    from test_torch_sp import (_close, _global, _inputs,
                               _jax_out_and_grads, _world as sp_world)

    js = _inputs(1, 4, 4, 16 * 4, 16, "float32", 9)
    t_local = js[0].shape[2] // 4
    jfn = {"ring_flash": lambda q, k, v: jsp.ring_flash_attention(
               q, k, v, "seq", block_q=t_local, block_k=t_local,
               interpret=True),
           "ulysses": lambda q, k, v: jsp.ulysses_attention(q, k, v, "seq"),
           "ring_attention": lambda q, k, v: jsp.ring_attention(q, k, v,
                                                                "seq")}[name]
    ref_out, ref_grads = _jax_out_and_grads(jfn, js)
    world = [sp_world(x) for x in js]
    res = _across((1, 1, 1, 1), {"seq": 4}, lambda mesh: _sp_run(
        name, *(t[mesh.local_ranks] for t in world), mesh))
    got = [torch.cat([r[i] for _, r in res]) for i in range(4)]
    _close(_global(got[0]), ref_out, "float32", "out")
    for g, r in zip(got[1:], ref_grads):
        _close(_global(g), r, "float32", "grad")


# ---- pipeline parallelism ----

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq_len=16, use_flash_attention=True)


def _pp_inputs(dtype, m=6):
    cfg = TransformerConfig(dtype=dtype, **SMALL)
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tree = weights.transformer_params_to_numpy(model.state_dict(), cfg)
    rng = np.random.RandomState(1)
    xs = torch.from_numpy(rng.randn(4, m, 1, 16, 32).astype(
        np.float32)).to(dtype)
    ys = torch.from_numpy(rng.randn(4, m, 1, 16, 32).astype(np.float32))
    return cfg, tree, xs, ys


def _mse(out, target):
    return ((out.float() - target) ** 2).mean(tuple(range(1, out.dim())))


def _pp_run(schedule, cfg, tree, xs, ys, mesh):
    stages = weights.pipeline_stages_from_numpy(tree, cfg, mesh)
    stage_fn = functools.partial(world_block, cfg)
    if schedule == "gpipe":
        with torch.no_grad():
            return [pp.pipeline_apply(stage_fn, stages, xs, "pipe",
                                      mesh=mesh)]
    grads, loss = pp.pipeline_train_1f1b(stage_fn, _mse, stages, xs, ys,
                                         "pipe", mesh=mesh)
    return [loss] + [grads[k] for k in sorted(grads)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [(1, 1, 1, 1), (1, 3), (2, 2)],
                         ids=["4x1", "1+3", "2x2"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_across_processes_is_the_world(schedule, counts, dtype):
    """GPipe and 1F1B with one transformer block per stage on each
    process's local rows (the stages' weights, inputs and targets), the
    activations and cotangents on the transport: bitwise the one-process
    world's rows."""
    cfg, tree, xs, ys = _pp_inputs(dtype)
    want = _pp_run(schedule, cfg, tree, xs, ys,
                   make_mesh({"pipe": 4}, devices=["cpu"] * 4))
    for local, got in _across(counts, {"pipe": 4}, lambda mesh: _pp_run(
            schedule, cfg, tree, xs[mesh.local_ranks], ys[mesh.local_ranks],
            mesh)):
        for g, w in zip(got, want):
            _assert_rows(g, w, local, schedule)


def test_gpipe_across_processes_matches_jax():
    """pipeline_apply with a tanh stage over 4 "processes" against
    gloo_tpu.parallel.pipeline_apply in shard_map, f32, to
    tests/test_torch_pp.py's rtol 1e-5 / atol 1e-6."""
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.parallel import pipeline_apply as jax_apply
    from test_torch_pp import (_jax_mesh, _jax_tanh_stage, _tanh_stage,
                               _world as pp_world)

    rng = np.random.RandomState(7)
    ws = rng.randn(4, 8, 8).astype(np.float32) * 0.3
    x = rng.randn(5, 4, 8).astype(np.float32)
    f = jax.jit(jax.shard_map(
        lambda w, xs: jax_apply(_jax_tanh_stage, w[0], xs, "pipe"),
        mesh=_jax_mesh(), in_specs=(P("pipe"), P()), out_specs=P("pipe")))
    want = np.asarray(f(ws, x)).reshape(4, 5, 4, 8)
    wt, xw = torch.from_numpy(ws), pp_world(x)
    res = _across((1, 1, 1, 1), {"pipe": 4}, lambda mesh: pp.pipeline_apply(
        _tanh_stage, wt[mesh.local_ranks], xw[mesh.local_ranks], "pipe",
        mesh=mesh))
    got = torch.cat([out for _, out in res])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pipeline_across_processes_matches_jax():
    """The 1F1B step with one transformer block per stage over 4
    "processes" against gloo_tpu.parallel.pp's in shard_map
    (check_vma=False: the interpreted flash VJP), f32, to
    tests/test_torch_pp.py's rtol 1e-5 / atol 1e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from test_torch_pp import _jax_1f1b, _jax_mse

    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **SMALL))
    tree = jm.init(jax.random.PRNGKey(0))
    jlayers = jax.tree.map(lambda *a: jnp.stack(a), *tree["layers"])

    def jax_stage(layer, h):
        h = h + jm._attention(layer, jm._rmsnorm(h, layer["ln1"]["scale"]))
        return h + jm._mlp(layer, jm._rmsnorm(h, layer["ln2"]["scale"]))

    m = 4
    rng = np.random.RandomState(5)
    x = rng.randn(m, 2, 16, 32).astype(np.float32)
    y = rng.randn(m, 2, 16, 32).astype(np.float32)
    jgrads, jloss = _jax_1f1b(jax_stage, _jax_mse, jlayers, x, y,
                              check_vma=False)
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    ntree = jax.tree.map(np.asarray, tree)
    xw = torch.from_numpy(x).expand(4, *x.shape)
    yw = torch.from_numpy(y).expand(4, *y.shape)

    def fn(mesh):
        stages = weights.pipeline_stages_from_numpy(ntree, cfg, mesh)
        return pp.pipeline_train_1f1b(
            functools.partial(world_block, cfg),
            lambda o, t: ((o - t) ** 2).mean(tuple(range(1, o.dim()))),
            stages, xw[mesh.local_ranks], yw[mesh.local_ranks], "pipe",
            mesh=mesh)

    res = _across((1, 1, 1, 1), {"pipe": 4}, fn)
    loss = torch.cat([r[1] for _, r in res])
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-6)
    want = {"ln1.scale": jgrads["ln1"]["scale"],
            "ln2.scale": jgrads["ln2"]["scale"]}
    want.update({k: jgrads[k] for k in ("wqkv", "wo", "w_up", "w_down")})
    for name, ref in want.items():
        got = torch.cat([r[0][name] for _, r in res])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---- the three entries ----

def _entries(name, fn, size=4, **kwargs):
    """fn(rank, paths) -> result in `size` thread "processes" of the
    multihost entry `name` (a dict of paths whose steps share a context)
    over a fresh address ("cpu"); returns the results."""
    address = f"127.0.0.1:{_free_port()}"
    results, errors = [None] * size, []

    def worker(rank):
        try:
            paths = getattr(entry_mod, name)(
                rank, size, address, "cpu", device_hostname="127.0.0.1",
                **kwargs)
            try:
                results[rank] = fn(rank, paths)
            finally:
                next(iter(paths.values()))[0].context.close()
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


def _flat(res):
    return [res] if isinstance(res, torch.Tensor) else \
        [t for part in res for t in (part if isinstance(part, (tuple, list))
                                     else part.values()
                                     if isinstance(part, dict) else [part])]


def test_multihost_ring_variants_entry_is_ring_variants_entry():
    """multihost_ring_variants_entry over 4 "processes": each holds
    ring_variants_entry()'s buffer at its rank's row, and each variant's
    forward and VJP is the world's, bitwise."""
    paths = entry_mod.ring_variants_entry("cpu")
    want = {name: fn(*args) for name, (fn, args) in paths.items()}

    def fn(rank, local_paths):
        out = {}
        for name, (step, args) in local_paths.items():
            assert torch.equal(args[1], paths[name][1][1][[rank]])
            y, g = step(*args)
            out[name] = torch.equal(y, want[name][0][[rank]]) and \
                torch.equal(g, want[name][1][[rank]])
        return out

    assert _entries("multihost_ring_variants_entry", fn) == [
        dict.fromkeys(paths, True)] * 4


def test_multihost_sp_entry_is_sp_entry():
    """multihost_sp_entry over 4 "processes" (a global sequence of 256):
    sp_entry()'s q, k, v at each rank's row, and the three paths the
    world's, bitwise."""
    paths = entry_mod.sp_entry("cpu", seq=256)
    want = {name: _flat(fn(*args)) for name, (fn, args) in paths.items()}

    def fn(rank, local_paths):
        out = {}
        for name, (step, args) in local_paths.items():
            for got, ref in zip(args[1:4], paths[name][1][1:4]):
                assert torch.equal(got, ref[[rank]])
            out[name] = all(torch.equal(g, w[[rank]]) for g, w in zip(
                _flat(step(*args)), want[name]))
        return out

    assert _entries("multihost_sp_entry", fn, seq=256) == [
        dict.fromkeys(paths, True)] * 4


def test_multihost_pp_entry_is_pp_entry():
    """multihost_pp_entry over 4 "processes" at the flagship's width: its
    stage's weights at each rank's row, the GPipe forward and the 1F1B
    step the world's rows, bitwise."""
    paths = entry_mod.pp_entry("cpu")
    want = {name: _flat(fn(*args)) for name, (fn, args) in paths.items()}

    def fn(rank, local_paths):
        out = {}
        stages = local_paths["1f1b"][1][2]
        for key, w in paths["1f1b"][1][2].items():
            assert torch.equal(stages[key], w[[rank]])
        for name, (step, args) in local_paths.items():
            out[name] = all(torch.equal(g, w[[rank]]) for g, w in zip(
                _flat(step(*args)), want[name]))
        return out

    assert _entries("multihost_pp_entry", fn) == [
        dict.fromkeys(paths, True)] * 4


def test_new_multihost_entries_refuse_a_size_that_does_not_split_the_mesh():
    for name in ("multihost_ring_variants_entry", "multihost_sp_entry",
                 "multihost_pp_entry"):
        with pytest.raises(ValueError, match="splits its 4 ranks"):
            getattr(entry_mod, name)(0, 3, f"127.0.0.1:{_free_port()}",
                                     "cpu")


# ---- what stays world-only ----

def test_what_stays_world_only_refuses_a_process_mesh():
    """The two-level DDP (HierarchicalGroup over a mesh,
    make_hierarchical_ddp) and dp_tp.unshard_state have no cross-process
    form: on a process mesh each raises NotImplementedError naming the
    ROADMAP item before it reads the local rows as the world. (FSDP took
    a process mesh since: tests/test_torch_multihost_fsdp.py.)"""
    mesh = make_mesh({"data": 4}, devices=["cpu"] * 4,
                     process_of=[0, 0, 1, 1], process=1)
    for call in (
            lambda: HierarchicalGroup(None, mesh),
            lambda: make_hierarchical_ddp(lambda m, b: 0.0,
                                          HierarchicalGroup(None, ["cpu"]),
                                          mesh=mesh),
            lambda: dp_tp.unshard_state({}, TransformerConfig(), mesh)):
        with pytest.raises(NotImplementedError,
                           match=MULTI_PROCESS_ITEM[:20]):
            call()
    # One process: the mesh's own devices.
    one = make_mesh({"local": 2}, devices=["cpu"] * 2)
    assert HierarchicalGroup(None, one).devices == [torch.device("cpu")] * 2


def test_checks_raise_in_every_process_before_any_launch():
    """Every process raises the same error for a bad variant call, and on
    the card's path (a meta tensor takes it, with no workspace to use)
    the checks come first; the transport on a one-process card mesh
    refuses."""
    x = _world(torch.float32, (4, 64, 256), 1)

    def bad_calls(mesh, xs):
        return [lambda: ring.ring_allreduce_q8(xs.double(), "data", mesh),
                lambda: ring.ring_allreduce_q8(xs[:, :48], "data", mesh),
                lambda: ring.ring_allreduce_bidir(xs[..., :100], "data",
                                                  mesh),
                lambda: ring.ring_allreduce_hbm(xs[:, :3], "data", mesh),
                lambda: ring.ring_allreduce_hbm(xs.to(torch.bool), "data",
                                                mesh)]

    def fn(mesh):
        errors = []
        for call in bad_calls(mesh, x[mesh.local_ranks]):
            with pytest.raises((ValueError, TypeError)) as info:
                call()
            errors.append(f"{info.type.__name__}: {info.value}")
        return errors

    res = _across((1, 1, 1, 1), None, fn)
    assert all(errors == res[0][1] for _, errors in res)
    meta = make_mesh({"data": 4}, devices=["meta"] * 4,
                     process_of=[0, 1, 2, 3], process=2)
    xm = torch.empty(1, 64, 256, device="meta")
    for call in bad_calls(meta, xm):
        with pytest.raises((ValueError, TypeError)):
            call()
    card = make_mesh({"x": 2}, devices=["meta"] * 2)
    with pytest.raises(ValueError, match="process mesh"):
        permute.pull(torch.empty(2, 4, device="meta"), "x", card, [1, 0],
                     [0, 0], 4)


# ---- on the card ----

_CARD_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    from gloo_tpu_torch.ops import permute, ring
    from gloo_tpu_torch.tpu import init_multihost, make_mesh, spmd

    rank, size, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ctx, mesh = init_multihost(rank, size, address, timeout=60.0,
                               device_hostname="127.0.0.1")
    dev = mesh.device
    world = make_mesh({"data": size}, devices=[dev] * size)
    mine = mesh.local_ranks
    gen = torch.Generator(dev).manual_seed(0)
    ok = []
    for k in range(3):
        for name, dtype, cols in (("hbm", torch.bfloat16, 99),
                                  ("q8", torch.float32, 100),
                                  ("bidir", torch.float32, 512)):
            fn = getattr(ring, "ring_allreduce_" + name)
            x = torch.randn((size, 96 * size, cols), generator=gen,
                            device=dev).to(dtype)
            ok.append(torch.equal(fn(x[mine], "data", mesh),
                                  fn(x, "data", world)[mine]))
        x = torch.randn((size, 3, 12, 5), generator=gen, device=dev)
        for op in (lambda t, m: spmd.shift(t, "data", 1, mesh=m),
                   lambda t, m: spmd.shift(t, "data", -1, wrap=False,
                                           mesh=m),
                   lambda t, m: spmd.broadcast(t, "data", 1, mesh=m),
                   lambda t, m: spmd.scatter(t, "data", 0, scatter_axis=1,
                                             mesh=m)):
            ok.append(torch.equal(op(x[mine], mesh), op(x, world)[mine]))
    launches = [ring.ring_allreduce_hbm.launches,
                ring.ring_allreduce_q8.launches,
                ring.ring_allreduce_bidir.launches, permute.pull.launches]
    ctx.close()
    print(json.dumps({"ok": ok, "launches": launches}))
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cross-process kernels and the "
                    "transport map device memory between processes with "
                    "CUDA IPC")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [2, 3])
def test_variants_and_transport_on_card(cuda_device, size):
    """`size` processes on the card: B9 (bf16, padded columns), B10 and
    B11 bitwise the one-card kernels on the world, and the transport's
    shift, broadcast and scatter bitwise the world's spmd, three rounds
    each; world launches count too."""
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
        assert all(res["ok"]) and len(res["ok"]) == 21
        # Each variant: 3 across processes and 3 on the world; 12 pulls.
        assert res["launches"] == [6, 6, 6, 12]
