"""gloo_tpu_torch.ops.overlap against gloo_tpu.ops.overlap.

On the CPU the port runs the plain twins of the collective matmul kernels
(B5a matmul_reduce_scatter, B5b allgather_matmul); they are held against
the JAX Pallas kernels run as tests/test_overlap.py runs them:
jax.shard_map(..., check_vma=False) over jax.devices()[:n] with
interpret=True, the same numpy inputs on both sides, the JAX global arrays
split into the port's world tensors (row r what rank r holds).

Tolerances. f32: rtol 1e-5, atol 1e-5; each partial is a dot summed in
another order than the interpreted kernel's, the ring's adds are the same.
bf16: within two bf16 ulps of the largest |JAX| value; each partial is
accumulated in f32 and rounded to bf16 before the ring's add, so a
last-bit difference in the f32 sum can flip the rounded partial by one ulp
of its size, and the one add after it by one more. Gradients (f32): rtol
2e-4, atol 2e-5, test_overlap.py's own bounds against the plain
composition.

Tests marked `cuda` hold each kernel against its twin on the card and skip
without one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.ops import allgather_matmul as jax_ag  # noqa: E402
from gloo_tpu.ops import matmul_reduce_scatter as jax_rs  # noqa: E402
from gloo_tpu_torch.ops import overlap, ring  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _rand(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(dtype)


def _torch(a):
    """A numpy array (f32 or bf16) as a torch tensor of the same dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n], dtype=object).reshape(shape),
                   names)


def _run(fn, mesh, in_specs, out_specs, *args):
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False))
    return np.asarray(f(*args).astype(jnp.float32))


def _cols(a, n):
    """(rows, n c) -> world (n, rows, c): rank r the r-th column block."""
    return np.stack(np.split(a, n, axis=1))


def _rows(a, n):
    return np.stack(np.split(a, n, axis=0))


def _assert_close(ours, ref, dtype):
    ours = ours.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        peak = float(np.abs(ref).max())
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert np.abs(ours - ref).max() <= 2 * ulp, (
            np.abs(ours - ref).max(), ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_matmul_reduce_scatter_matches_jax_kernel(n, dtype):
    npt, _ = DTYPES[dtype]
    m, k_total, cols = 8 * n, 16 * n, 128
    x = _rand((m, k_total), 0, npt)
    w = _rand((k_total, cols), 1, npt)
    ref = _run(lambda xs, ws: jax_rs(xs, ws, "x", interpret=True),
               _jax_mesh((n,), ("x",)), (P(None, "x"), P("x", None)),
               P("x", None), x, w)
    out = overlap.matmul_reduce_scatter(
        _torch(_cols(x, n)), _torch(_rows(w, n)), "x",
        make_mesh({"x": n}, devices=["cpu"] * n))
    assert out.shape == (n, 8, cols) and out.dtype == DTYPES[dtype][1]
    _assert_close(out.reshape(m, cols), ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_allgather_matmul_matches_jax_kernel(n, dtype):
    """A replicated w: the port takes it as a stride-0 expanded view."""
    npt, _ = DTYPES[dtype]
    m_total, k, cols = 8 * n, 16 * n, 128
    x = _rand((m_total, k), 2, npt)
    w = _rand((k, cols), 3, npt)
    ref = _run(lambda xs, ws: jax_ag(xs, ws, "x", interpret=True),
               _jax_mesh((n,), ("x",)), (P("x", None), P(None, None)),
               P(None, None), x, w)
    xw = _torch(_rows(x, n))
    shared = _torch(w).expand(n, -1, -1)
    assert shared.stride(0) == 0
    y, gx = overlap.allgather_matmul_fwd(
        xw, shared, "x", make_mesh({"x": n}, devices=["cpu"] * n))
    assert y.shape == (n, m_total, cols) and gx.shape == (n, m_total, k)
    for r in range(n):
        _assert_close(y[r], ref, dtype)
        assert torch.equal(y[r], y[0])
        assert torch.equal(gx[r], xw.reshape(m_total, k))


def test_allgather_matmul_column_sharded_w(n=4):
    m_total, k, cols = 8 * n, 32, 128 * n
    x = _rand((m_total, k), 4)
    w = _rand((k, cols), 5)
    ref = _run(lambda xs, ws: jax_ag(xs, ws, "x", interpret=True),
               _jax_mesh((n,), ("x",)), (P("x", None), P(None, "x")),
               P(None, "x"), x, w)
    y = overlap.allgather_matmul(_torch(_rows(x, n)), _torch(_cols(w, n)),
                                 "x", make_mesh({"x": n}, devices=["cpu"] * n))
    for r in range(n):
        np.testing.assert_allclose(y[r].numpy(), _cols(ref, n)[r], rtol=1e-5,
                                   atol=1e-5)


def _mesh_2x2_world(a, along, m_axis):
    """World tensor of a 2 x 2 ("data", "model") mesh: rank (d, i) holds
    block i of `a` along `along`, the same on both data ranks."""
    blocks = np.split(a, 2, axis=along)
    return np.stack([blocks[i] for _ in range(2) for i in range(2)])


def test_ring_along_model_of_a_2x2_mesh():
    """test_matmul_reduce_scatter_multi_axis_mesh: the ring over the minor
    "model" axis; the mesh's ring tables route it (no mesh_axes)."""
    jmesh = _jax_mesh((2, 2), ("data", "model"))
    mesh = make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    m, k_total, cols = 16, 32, 128
    x = _rand((m, k_total), 30)
    w = _rand((k_total, cols), 31)
    ref = _run(lambda xs, ws: jax_rs(xs, ws, "model", interpret=True,
                                     mesh_axes=("data", "model")),
               jmesh, (P(None, "model"), P("model", None)),
               P("model", None), x, w)
    out = overlap.matmul_reduce_scatter(
        _torch(_mesh_2x2_world(x, 1, 2)), _torch(_mesh_2x2_world(w, 0, 2)),
        "model", mesh)
    for r, i in enumerate(mesh.ring_index("model")):
        np.testing.assert_allclose(out[r].numpy(), _rows(ref, 2)[i],
                                   rtol=1e-5, atol=1e-5)
    xs = _rand((16, 32), 32)
    ws = _rand((32, cols), 33)
    ref = _run(lambda a, b: jax_ag(a, b, "model", interpret=True,
                                   mesh_axes=("data", "model")),
               jmesh, (P("model", None), P(None, None)), P(None, None),
               xs, ws)
    y = overlap.allgather_matmul(_torch(_mesh_2x2_world(xs, 0, 2)),
                                 _torch(ws).expand(4, -1, -1), "model", mesh)
    for r in range(4):
        np.testing.assert_allclose(y[r].numpy(), ref, rtol=1e-5, atol=1e-5)


def test_matmul_reduce_scatter_grads_match_jax(n=4):
    """test_overlap.py::test_matmul_reduce_scatter_grads: the VJP (one ring
    allgather of the cotangent, two dots) against jax.grad through the
    interpreted JAX op."""
    mesh = _jax_mesh((n,), ("x",))
    m, k_total, cols = 8 * n, 16 * n, 128
    x = _rand((m, k_total), 6)
    w = _rand((k_total, cols), 7)

    def fused_loss(xv, wv):
        y = jax.shard_map(lambda xs, ws: jax_rs(xs, ws, "x", interpret=True),
                          mesh=mesh, in_specs=(P(None, "x"), P("x", None)),
                          out_specs=P("x", None), check_vma=False)(xv, wv)
        return jnp.sum(jnp.sin(y))

    gx_ref, gw_ref = jax.grad(fused_loss, argnums=(0, 1))(x, w)
    xw = _torch(_cols(x, n)).requires_grad_()
    ww = _torch(_rows(w, n)).requires_grad_()
    y = overlap.matmul_reduce_scatter(
        xw, ww, "x", make_mesh({"x": n}, devices=["cpu"] * n))
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(np.concatenate(list(xw.grad.numpy()), 1),
                               np.asarray(gx_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ww.grad.reshape(k_total, cols).numpy(),
                               np.asarray(gw_ref), rtol=2e-4, atol=2e-5)


def test_allgather_matmul_grads_match_jax(n=4):
    """test_overlap.py::test_allgather_matmul_grads: the VJP runs the dual
    B5a. The JAX loss reads the replicated product once, so the port's
    reads rank 0's copy; w is one shared leaf, expanded."""
    mesh = _jax_mesh((n,), ("x",))
    m_total, k, cols = 8 * n, 32, 128
    x = _rand((m_total, k), 8)
    w = _rand((k, cols), 9)

    def fused_loss(xv, wv):
        y = jax.shard_map(lambda xs, ws: jax_ag(xs, ws, "x", interpret=True),
                          mesh=mesh, in_specs=(P("x", None), P(None, None)),
                          out_specs=P(None, None), check_vma=False)(xv, wv)
        return jnp.sum(jnp.cos(y))

    gx_ref, gw_ref = jax.grad(fused_loss, argnums=(0, 1))(x, w)
    xw = _torch(_rows(x, n)).requires_grad_()
    leaf = _torch(w).requires_grad_()
    y = overlap.allgather_matmul(xw, leaf.expand(n, -1, -1), "x",
                                 make_mesh({"x": n}, devices=["cpu"] * n))
    torch.cos(y[0]).sum().backward()
    np.testing.assert_allclose(xw.grad.reshape(m_total, k).numpy(),
                               np.asarray(gx_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gw_ref),
                               rtol=2e-4, atol=2e-5)


def test_megatron_sp_roundtrip_matches_jax(n=4):
    """test_overlap.py::test_megatron_sp_roundtrip_fused: sequence-sharded
    x -> allgather_matmul (up) -> tanh GELU -> matmul_reduce_scatter
    (down) -> sequence-sharded y."""
    from gloo_tpu.parallel.tp import (allgather_matmul_dense,
                                      row_parallel_dense_scattered)
    from gloo_tpu_torch.parallel import tp

    seq, d, h = 8 * n, 32, 16 * n
    x, w_up, w_down = _rand((seq, d), 20), _rand((d, h), 21), \
        _rand((h, d), 22)

    def shard(xs, wu, wd):
        hidden = jax.nn.gelu(allgather_matmul_dense(xs, wu, "x",
                                                    interpret=True))
        return row_parallel_dense_scattered(hidden, wd, "x", interpret=True)

    ref = _run(shard, _jax_mesh((n,), ("x",)),
               (P("x", None), P(None, "x"), P("x", None)), P("x", None),
               x, w_up, w_down)
    mesh = make_mesh({"x": n}, devices=["cpu"] * n)
    hidden = tp.allgather_matmul_dense(_torch(_rows(x, n)),
                                       _torch(_cols(w_up, n)), "x", mesh=mesh)
    out = tp.row_parallel_dense_scattered(
        F.gelu(hidden, approximate="tanh"), _torch(_rows(w_down, n)), "x",
        mesh=mesh)
    np.testing.assert_allclose(out.reshape(seq, d).numpy(), ref, rtol=2e-4,
                               atol=2e-5)


def test_ring_reduce_scatter_and_allgather_are_dual():
    """The ring reduce-scatter and allgather wrappers are differentiable,
    each the other's VJP: gradients equal autograd through the twins'
    plain arithmetic (the closed forms on the CPU)."""
    mesh = make_mesh({"x": 4}, devices=["cpu"] * 4)
    x = torch.from_numpy(_rand((4, 8, 6), 40)).requires_grad_()
    g = torch.from_numpy(_rand((4, 2, 6), 41))
    ring.ring_reduce_scatter(x, "x", mesh).backward(g)
    assert torch.equal(x.grad, ring.ring_allgather_plain(g, "x", mesh))
    y = torch.from_numpy(_rand((4, 2, 6), 42)).requires_grad_()
    h = torch.from_numpy(_rand((4, 8, 6), 43))
    ring.ring_allgather(y, "x", mesh).backward(h)
    assert torch.equal(y.grad, ring.ring_reduce_scatter_plain(h, "x", mesh))


def test_cpu_runs_the_twins_and_counts_no_launch():
    mesh = make_mesh({"x": 4}, devices=["cpu"] * 4)
    x = torch.from_numpy(_rand((4, 32, 16), 50))
    w = torch.from_numpy(_rand((4, 16, 24), 51))
    before = (overlap.matmul_reduce_scatter.launches,
              overlap.allgather_matmul.launches)
    assert torch.equal(overlap.matmul_reduce_scatter(x, w, "x", mesh),
                       overlap.matmul_reduce_scatter_plain(x, w, "x", mesh))
    y, gx = overlap.allgather_matmul_plain(x, w, "x", mesh)
    assert torch.equal(overlap.allgather_matmul(x, w, "x", mesh), y)
    assert (overlap.matmul_reduce_scatter.launches,
            overlap.allgather_matmul.launches) == before
    # A ring of one: the plain dot with f32 accumulation, no kernel.
    one = make_mesh({"x": 4, "one": 1}, devices=["cpu"] * 4)
    torch.testing.assert_close(overlap.matmul_reduce_scatter(x, w, "one", one),
                               x @ w)
    y1, g1 = overlap.allgather_matmul_fwd(x, w, "one", one)
    assert g1 is x


def test_wrappers_reject_what_they_do_not_take():
    mesh = make_mesh({"x": 4}, devices=["cpu"] * 4)
    x = torch.zeros((4, 30, 16))
    with pytest.raises(ValueError, match="not divisible"):
        overlap.matmul_reduce_scatter(x, torch.zeros((4, 16, 8)), "x", mesh)
    with pytest.raises(ValueError, match="w must be"):
        overlap.allgather_matmul(x, torch.zeros((4, 15, 8)), "x", mesh)
    with pytest.raises(TypeError, match="bfloat16"):
        overlap.allgather_matmul(x, torch.zeros((4, 16, 8),
                                                dtype=torch.bfloat16),
                                 "x", mesh)
    with pytest.raises(ValueError, match="world tensor"):
        overlap.allgather_matmul(torch.zeros((3, 8, 16)),
                                 torch.zeros((3, 16, 8)), "x", mesh)
    with pytest.raises(ValueError, match="lies on"):
        overlap.matmul_reduce_scatter(torch.zeros((4, 8, 16), device="meta"),
                                      torch.zeros((4, 16, 8), device="meta"),
                                      "x", mesh)


# ---- the launch plan (what Python decides for the kernels) ----

@pytest.mark.parametrize("case", ["mlp", "mlp_wT", "rows8", "cols100",
                                  "f32_k36", "deep"])
def test_launch_plan(case):
    """The plan at the fused MLP's shapes (B5b and B5a, and B5a with the
    transposed w of B5b's VJP), at 8-row chunks and at cols 100: 64 x 64
    tiles (4 x 4 at the MLP), W resident up to 8 slabs, a transposed bf16
    w taken as it lies, strides TMA cannot describe padded."""
    bf16, f32 = torch.bfloat16, torch.float32
    dtype, rows, k, cols, strides, want = {
        "mlp": (bf16, 256, 256, 256, (65536, 256, 1),
                (4, 4, 4, 8, True, "rows", 256, 256)),
        "mlp_wT": (bf16, 256, 256, 256, (65536, 1, 256),
                   (4, 4, 4, 8, True, "cols", 256, 256)),
        "rows8": (bf16, 8, 16, 128, (2048, 128, 1),
                  (1, 2, 1, 2, True, "rows", 16, 128)),
        "cols100": (bf16, 20, 40, 100, (4000, 100, 1),
                    (1, 2, 1, 2, True, "copy", 40, 104)),
        "f32_k36": (f32, 20, 36, 100, (3600, 100, 1),
                    (1, 2, 2, 4, True, "rows", 36, 100)),
        "deep": (bf16, 64, 1024, 128, (0, 128, 1),
                 (1, 2, 16, 8, False, "rows", 1024, 128)),
    }[case]
    plan = overlap.launch_plan(dtype, rows, k, cols, strides)
    assert tuple(plan) == want
    assert plan.tiles == want[0] * want[1]
    w_bufs = plan.slabs if plan.w_resident else plan.ring
    assert plan.smem == (w_bufs + plan.ring) * 8192 + 8 * (plan.ring + 1) \
        + 1024
    if case == "mlp":
        assert 4 * plan.tiles == 64  # blocks at the MLP's shape, 4 ranks


def test_launch_plan_pads_what_tma_cannot_describe():
    """bf16 k 36 (72-byte rows) pads x to 40; a transposed bf16 w with a
    ragged stride, or an f32 one, is copied to padded rows; a shared w
    (rank stride 0) stays shared; an unaligned start is copied."""
    plan = overlap.launch_plan(torch.bfloat16, 8, 36, 64, (0, 64, 1))
    assert (plan.x_ld, plan.w_layout) == (40, "rows")
    plan = overlap.launch_plan(torch.bfloat16, 8, 36, 64, (2304, 1, 36))
    assert (plan.w_layout, plan.w_ld) == ("copy", 64)
    plan = overlap.launch_plan(torch.float32, 8, 32, 64, (2048, 1, 32))
    assert plan.w_layout == "copy"
    plan = overlap.launch_plan(torch.bfloat16, 8, 32, 64, (2048, 64, 1),
                               aligned=False)
    assert plan.w_layout == "copy"


def test_plan_stages_operands_as_the_kernels_take_them():
    """_plan's padded copies hold the operands' values, zeros beside them;
    a shared w stays one buffer (rank stride 0)."""
    x = torch.from_numpy(_rand((3, 60, 36), 60)).bfloat16()
    w = torch.from_numpy(_rand((1, 36, 100), 61)).bfloat16() \
        .expand(3, -1, -1)
    xs, ws, plan = overlap._plan(x, w, 20)
    assert xs.shape == (3, 60, 40) and torch.equal(xs[..., :36], x)
    assert not xs[..., 36:].any()
    assert ws.shape == w.shape and ws.stride() == (0, 104, 1)
    assert torch.equal(ws, w) and plan.w_layout == "copy"
    x32 = torch.from_numpy(_rand((3, 60, 36), 62))
    w32 = torch.from_numpy(_rand((3, 36, 100), 63))
    xs, ws, plan = overlap._plan(x32, w32, 20)
    assert xs is x32 and ws is w32 and plan.w_layout == "rows"


def test_kernel_w_takes_a_transposed_bf16_w_as_a_view():
    """B5b's VJP hands B5a w^T: bf16 goes through as the view (wgmma reads
    it K-major); f32 is still copied to unit column stride."""
    w = torch.from_numpy(_rand((4, 32, 48), 64))
    for dtype in (torch.bfloat16, torch.float32):
        wt = w.to(dtype).transpose(1, 2)
        got = overlap._kernel_w(wt)
        if dtype == torch.bfloat16:
            assert got is wt
        else:
            assert got.is_contiguous() and got.data_ptr() != wt.data_ptr()
            assert torch.equal(got, wt)
    shared = w[:1].expand(4, -1, -1)
    assert overlap._kernel_w(shared) is shared


def test_matmul_reduce_scatter_allocates_no_stage():
    """B5a's buffers are the output, the two comm slots per rank that the
    left neighbour's epilogue fills (8-byte words: a tile's accumulators
    beside their write's tag, 16 per thread in bf16, 32 in f32) and the
    flags, slots and flags zeroed by one fill: no staging buffer. The
    kernel's C signature takes no stage pointer either."""
    x = torch.zeros((4, 1024, 256), dtype=torch.bfloat16)
    bufs = overlap._rs_buffers(x, 256, 256, 16, 100)
    assert len(bufs) == 3
    out, comm, flags = bufs
    assert out.shape == (4, 256, 256) and out.dtype == torch.bfloat16
    assert comm.shape == (4, 2, 16 * 128 * 16) and comm.dtype == torch.int64
    assert flags.shape == (400,) and flags.dtype == torch.int32
    assert not comm.any() and not flags.any()
    assert comm.untyped_storage().data_ptr() == \
        flags.untyped_storage().data_ptr()
    f32 = overlap._rs_buffers(x.float(), 20, 99, 2, 7)
    assert f32[1].shape == (4, 2, 2 * 128 * 32) and f32[2].shape == (28,)
    # x, x_ld, w and its strides, out, comm, flags, stride, the ring
    # tables (host) and their device copy, ranks, n, slices, rows, k,
    # cols, the plan's four, dtype, stream.
    assert len(overlap._SIGNATURES["gtt_matmul_rs"]) == 26
    assert len(overlap._SIGNATURES["gtt_ag_matmul"]) == 26


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the overlap kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _ulps_close(a, b):
    """Within two bf16 ulps of the largest |b| (the tolerance above)."""
    peak = float(b.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    return float((a.float() - b.float()).abs().max()) <= 2 * ulp


# (n, rows of a B5a chunk, k, cols, dtype, shared w, transposed w): the
# first six are the small rings of 8-row chunks, then chunk rows that are
# not multiples of 64, the fused MLP's full bf16 shape, its B5a with the
# transposed w of B5b's VJP, a shared (rank stride 0) w, and n = 8 at a
# deeper k.
CARD_CASES = [
    (2, 8, 16, 128, torch.float32, False, False),
    (3, 8, 16, 128, torch.float32, False, False),
    (4, 8, 16, 128, torch.float32, False, False),
    (8, 8, 16, 128, torch.float32, False, False),
    (4, 8, 16, 128, torch.bfloat16, False, False),
    (8, 8, 16, 128, torch.bfloat16, False, False),
    (3, 8, 40, 100, torch.bfloat16, False, False),
    (3, 20, 36, 100, torch.float32, False, False),
    (2, 100, 64, 160, torch.bfloat16, False, False),
    (4, 256, 256, 256, torch.bfloat16, False, False),
    (4, 256, 256, 256, torch.bfloat16, False, True),
    (4, 64, 256, 256, torch.bfloat16, True, False),
    (8, 64, 128, 128, torch.bfloat16, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,k,cols,dtype,shared,transposed", CARD_CASES)
def test_kernels_match_twins_on_card(cuda_device, n, rows, k, cols, dtype,
                                     shared, transposed):
    """Each case three times in a row: an ordering fault between the TMA
    stores, the flags and the loads shows as a result that differs now and
    then."""
    mesh = make_mesh({"x": n}, devices=[cuda_device] * n)
    gen = torch.Generator(cuda_device).manual_seed(n * rows + k)
    x = torch.randn((n, n * rows, k), generator=gen, device=cuda_device)
    if transposed:
        w = torch.randn((n, cols, k), generator=gen, device=cuda_device) \
            .transpose(1, 2)
    else:
        w = torch.randn((1 if shared else n, k, cols), generator=gen,
                        device=cuda_device).expand(n, -1, -1)
    x, w = x.to(dtype), (w / k ** 0.5).to(dtype)
    xs = x[:, :rows].contiguous()
    for _ in range(3):
        before = overlap.matmul_reduce_scatter.launches
        out = overlap.matmul_reduce_scatter(x, w, "x", mesh)
        ref = overlap.matmul_reduce_scatter_plain(x, w, "x", mesh)
        torch.cuda.synchronize()
        assert overlap.matmul_reduce_scatter.launches == before + 1
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        else:
            assert _ulps_close(out, ref)
        before = overlap.allgather_matmul.launches
        y, gx = overlap.allgather_matmul_fwd(xs, w, "x", mesh)
        ry, rgx = overlap.allgather_matmul_plain(xs, w, "x", mesh)
        torch.cuda.synchronize()
        assert overlap.allgather_matmul.launches == before + 1
        assert torch.equal(gx, rgx)
        if dtype == torch.float32:
            torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
        else:
            assert _ulps_close(y, ry)
