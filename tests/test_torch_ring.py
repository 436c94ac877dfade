"""gloo_tpu_torch.ops.ring and tpu.mesh against gloo_tpu.ops.pallas_ring.

On the CPU the port runs its plain twins of the ring kernels; they are held
against the JAX Pallas kernels run as tests/test_pallas_ring.py runs them:
jax.shard_map(..., check_vma=False) over jax.devices()[:n] with
interpret=True. Inputs are made with numpy from a seed and handed to both.

Tolerance: none. The twins walk the ring with the TPU kernels' chunk
indices and add in the same order, one add per step in the input dtype, so
f32 and bf16 results are bitwise equal to the interpreted kernels (f32
adds are IEEE in both; a bf16 add is an f32 add rounded once to bf16 in
both).

Tests marked `cuda` hold each kernel against its twin on the card (bitwise)
and skip without one; they import no JAX, so they run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.tpu import make_mesh
from gloo_tpu_torch.tpu.mesh import Mesh


def _jax():
    return pytest.importorskip("jax")


def _jax_ring(fn, n, x, mesh_shape=None, axes=("x",)):
    """fn inside shard_map over the first devices, each device one row of
    the world array x (P, rows, cols)."""
    jax = _jax()
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    grid = np.asarray(jax.devices()[:n], dtype=object)
    mesh = JaxMesh(grid.reshape(mesh_shape or (n,)), axes)
    spec = P(axes if len(axes) > 1 else axes[0])
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                              check_vma=False))
    out = np.asarray(f(x.reshape(-1, x.shape[-1])))
    return out.reshape(x.shape[0], -1, x.shape[-1])


def _cpu_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_allreduce_matches_jax_kernel(n):
    _jax()
    from gloo_tpu.ops import ring_allreduce as jax_ring_allreduce

    x = np.random.RandomState(n).randn(n, n * 8, 128).astype(np.float32)
    ref = _jax_ring(lambda s: jax_ring_allreduce(s, "x", interpret=True),
                    n, x)
    out = ring.ring_allreduce(torch.from_numpy(x), "x", _cpu_mesh({"x": n}))
    np.testing.assert_array_equal(out.numpy(), ref)
    for r in range(1, n):
        assert torch.equal(out[r], out[0])


def test_allreduce_bf16_matches_jax_kernel():
    _jax()
    ml_dtypes = pytest.importorskip("ml_dtypes")

    from gloo_tpu.ops import ring_allreduce as jax_ring_allreduce

    n = 4
    x = np.random.RandomState(9).randn(n, n * 16, 128).astype(
        ml_dtypes.bfloat16)
    ref = _jax_ring(lambda s: jax_ring_allreduce(s, "x", interpret=True),
                    n, x)
    ours = torch.from_numpy(x.astype(np.float32)).bfloat16()
    out = ring.ring_allreduce(ours, "x", _cpu_mesh({"x": n}))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.astype(np.float32))


def test_reduce_scatter_and_allgather_match_jax_kernels():
    _jax()
    from gloo_tpu.ops import ring_allgather as jax_ring_allgather
    from gloo_tpu.ops import ring_reduce_scatter as jax_ring_reduce_scatter

    n = 4
    mesh = _cpu_mesh({"x": n})
    x = np.random.RandomState(0).randn(n, 16, 100).astype(np.float32)
    ref = _jax_ring(lambda s: jax_ring_reduce_scatter(s, "x", interpret=True),
                    n, x)
    out = ring.ring_reduce_scatter(torch.from_numpy(x), "x", mesh)
    assert out.shape == (n, 4, 100)
    np.testing.assert_array_equal(out.numpy(), ref)
    y = np.random.RandomState(1).randn(n, 4, 100).astype(np.float32)
    ref = _jax_ring(lambda s: jax_ring_allgather(s, "x", interpret=True),
                    n, y)
    out = ring.ring_allgather(torch.from_numpy(y), "x", mesh)
    assert out.shape == (n, 16, 100)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_torus_matches_jax_on_2x2():
    _jax()
    from gloo_tpu.ops import ring_allreduce_torus as jax_torus

    z = np.random.RandomState(2).randn(4, 8, 128).astype(np.float32)
    ref = _jax_ring(lambda s: jax_torus(s, ("x", "y"), mesh_axes=("y", "x"),
                                        interpret=True),
                    4, z, mesh_shape=(2, 2), axes=("y", "x"))
    before = (ring.ring_reduce_scatter.launches,
              ring.ring_allgather.launches)
    out = ring.ring_allreduce_torus(torch.from_numpy(z), ("x", "y"),
                                    _cpu_mesh({"y": 2, "x": 2}))
    np.testing.assert_array_equal(out.numpy(), ref)
    # The twins launch nothing: the counters count kernel launches only.
    assert (ring.ring_reduce_scatter.launches,
            ring.ring_allgather.launches) == before


def test_autograd_matches_jax_grad():
    """Port of test_pallas_ring.py::test_ring_allreduce_grad: the VJP of
    the sum-allreduce is the allreduce of the cotangent."""
    jax = _jax()
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.ops import ring_allreduce as jax_ring_allreduce

    n, per = 4, 32
    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))

    def loss(x):
        y = jax.shard_map(lambda s: jax_ring_allreduce(s, "x",
                                                       interpret=True),
                          mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                          check_vma=False)(x)
        return (y ** 2).sum()

    x = np.linspace(-1, 1, n * per * 128).astype(np.float32).reshape(
        n * per, 128)
    ref = np.asarray(jax.jit(jax.grad(loss))(x)).reshape(n, per, 128)
    leaf = torch.from_numpy(x.reshape(n, per, 128).copy()).requires_grad_()
    y = ring.ring_allreduce(leaf, "x", _cpu_mesh({"x": n}))
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), ref)


# ---- the mesh ----

def test_make_mesh_rules_and_errors_match_jax():
    _jax()
    from gloo_tpu.tpu import make_mesh as jax_make_mesh

    import jax

    devs = jax.devices()[:8]
    mesh = make_mesh({"data": 2, "model": -1}, devices=["cpu"] * 8)
    ref = jax_make_mesh({"data": 2, "model": -1}, devices=devs)
    assert mesh.shape == dict(ref.shape) and mesh.axis_names == \
        tuple(ref.axis_names)
    assert _cpu_mesh({"a": 8}).shape == {"a": 8}
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3}
    for axes in ({"a": -1, "b": -1}, {"a": 3, "b": -1}, {"a": 3, "b": 2}):
        with pytest.raises(ValueError) as ours:
            make_mesh(axes, devices=["cpu"] * 8)
        with pytest.raises(ValueError) as theirs:
            jax_make_mesh(axes, devices=devs)
        assert str(ours.value) == str(theirs.value)


def test_make_mesh_default_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()


@pytest.mark.parametrize("shape,names", [((2, 2), ("y", "x")),
                                         ((2, 4), ("a", "b"))])
def test_ring_tables_match_jax_neighbors(shape, names):
    """Each flat rank's (ring index, right, left) along every axis against
    pallas_ring.py's _ring_neighbors evaluated inside shard_map."""
    jax = _jax()
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.ops.pallas_ring import _ring_neighbors

    size = int(np.prod(shape))
    jmesh = JaxMesh(np.asarray(jax.devices()[:size],
                               dtype=object).reshape(shape), names)
    mesh = make_mesh(dict(zip(names, shape)), devices=["cpu"] * size)
    for axis in names:
        def tables(_):
            _, right, left = _ring_neighbors(axis, names)
            return jnp.stack([lax.axis_index(axis), right, left])[None]

        f = jax.jit(jax.shard_map(tables, mesh=jmesh, in_specs=P(names),
                                  out_specs=P(names), check_vma=False))
        ref = np.asarray(f(jnp.zeros((size,))))
        assert [list(t) for t in ref.T] == \
            [list(t) for t in mesh.ring_neighbors(axis)]


def test_twins_on_a_2x4_mesh():
    mesh = _cpu_mesh({"a": 2, "b": 4})
    x = torch.from_numpy(np.random.RandomState(3).randn(8, 8, 6).astype(
        np.float32))
    members = mesh.ring_members("b")
    out = ring.ring_allreduce(x, "b", mesh)
    rs = ring.ring_reduce_scatter(x, "b", mesh)
    ag = ring.ring_allgather(x, "a", mesh)
    for r in range(8):
        total = x[members[r]].sum(0)
        torch.testing.assert_close(out[r], total, rtol=1e-6, atol=1e-6)
        assert torch.equal(out[r], out[members[r][0]])
        # B4a starts its ring one chunk later than B3: same sum, another
        # order of adds.
        i = mesh.ring_index("b")[r]
        torch.testing.assert_close(rs[r], total[2 * i:2 * i + 2], rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(ag[r], torch.cat([x[m] for m in
                                             mesh.ring_members("a")[r]]))


def test_wrappers_reject_what_they_do_not_take():
    mesh = _cpu_mesh({"x": 4})
    x = torch.zeros((4, 6, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring.ring_allreduce(x, "x", mesh)
    with pytest.raises(ValueError, match="not divisible"):
        ring.ring_reduce_scatter(x, "x", mesh)
    with pytest.raises(ValueError, match="world tensor"):
        ring.ring_allreduce(torch.zeros((3, 8, 8)), "x", mesh)
    with pytest.raises(ValueError, match="axis"):
        ring.ring_allgather(x, "y", mesh)
    # Ring size 1: x itself, no launch and no copy.
    one = _cpu_mesh({"x": 4, "one": 1})
    for fn in (ring.ring_allreduce, ring.ring_reduce_scatter,
               ring.ring_allgather):
        assert fn(x, "one", one) is x
    # A mesh over distinct devices names the multi-card item.
    two = Mesh(["cpu", "meta"], ["x"], [2])
    with pytest.raises(NotImplementedError, match="multi-card"):
        ring.ring_allreduce(torch.zeros((2, 2, 4)), "x", two)
    # CUDA tensors launch the kernel or raise; a tensor off the mesh's
    # device is refused before any launch.
    with pytest.raises(ValueError, match="lies on"):
        ring.ring_allreduce(torch.zeros((4, 8, 8), device="meta"), "x", mesh)


ALL_DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
              torch.int64, torch.float16, torch.bfloat16, torch.float32,
              torch.float64, torch.complex64]


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=str)
def test_sum_kernels_take_the_same_dtypes_on_every_device(dtype):
    """B3 and B4a take SUM_DTYPES and refuse the rest with the same
    TypeError on the CPU and on the card's path (a meta tensor goes the
    card's way and, past the dtype check, stops at the missing nvcc). The
    allgather moves bytes and takes every dtype on both."""
    cpu = _cpu_mesh({"x": 4})
    meta = make_mesh({"x": 4}, devices=["meta"] * 4)
    x = torch.ones((4, 8, 16), dtype=dtype)
    takes = dtype in ring.SUM_DTYPES
    for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                      (ring.ring_reduce_scatter,
                       ring.ring_reduce_scatter_plain)):
        if takes:
            assert torch.equal(fn(x, "x", cpu), plain(x, "x", cpu))
            with pytest.raises(RuntimeError, match="nvcc"):
                fn(x.to("meta"), "x", meta)
        else:
            for mesh, t in ((cpu, x), (meta, x.to("meta"))):
                with pytest.raises(TypeError, match="ring_"):
                    fn(t, "x", mesh)
    if takes:
        code, vec, units = ring._kernel_layout(x, 32)
        assert (code, vec, units) == (ring.SUM_DTYPES[dtype], 1,
                                      32 * x.element_size() // 16)
    assert torch.equal(ring.ring_allgather(x[:, :2], "x", cpu),
                       ring.ring_allgather_plain(x[:, :2], "x", cpu))
    with pytest.raises(RuntimeError, match="nvcc"):
        ring.ring_allgather(x[:, :2].to("meta"), "x", meta)


def test_cooperative_grid_sizes_the_launch(monkeypatch):
    """Slices: as many as `want`, no more than fit beside the other ranks'
    blocks (blocks_per_slice per rank and slice); zeroed flags for every
    block plus `extra`; the ring tables of every rank. The occupancy query
    is asked once per device."""
    import contextlib

    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    asked = []

    def max_blocks(ref):
        asked.append(1)
        ref._obj.value = 100
        return 0

    mesh = make_mesh({"x": 4}, devices=["meta"] * 4)
    x = torch.zeros((4, 8, 8), device="meta")
    cache = {}
    for want, per_slice, extra, slices in ((7, 1, 0, 7), (99, 1, 0, 25),
                                           (99, 2, 5, 12), (0, 1, 0, 1)):
        got, flags, tables = ring.cooperative_grid(
            x, mesh, "x", None, max_blocks, cache, want, 6, per_slice, extra)
        assert got == slices
        assert flags.shape == (4 * per_slice * slices * 6 + extra,)
        assert [list(t) for t in tables] == [list(t) for t in
                                             mesh.ring_neighbors("x")]
    assert asked == [1] and cache == {0: 100}
    with pytest.raises(RuntimeError, match="co-resident"):
        ring.cooperative_grid(torch.zeros((2, 8, 8), device="meta"),
                              make_mesh({"x": 2}, devices=["meta"] * 2),
                              "x", None, max_blocks, {0: 3}, 1, 6, 2)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("axes,axis,dtype,cols", [
    ({"x": 2}, "x", torch.float32, 128), ({"x": 3}, "x", torch.float32, 128),
    ({"x": 4}, "x", torch.float32, 128), ({"x": 8}, "x", torch.float32, 128),
    ({"x": 4}, "x", torch.bfloat16, 128), ({"x": 4}, "x", torch.float32, 100),
    ({"x": 4}, "x", torch.bfloat16, 33),
    ({"y": 2, "x": 2}, "y", torch.float32, 128),
    ({"y": 2, "x": 2}, "x", torch.bfloat16, 100)])
def test_kernels_match_twins_on_card(cuda_device, axes, axis, dtype, cols):
    """Each kernel bitwise against its twin, three times in a row (an
    ordering fault between flags and data shows now and then), over rings
    of 2 to 8 and along each axis of a 2 x 2 torus, where flat rank and
    ring index differ."""
    size = int(np.prod(list(axes.values())))
    n = axes[axis]
    mesh = make_mesh(axes, devices=[cuda_device] * size)
    gen = torch.Generator(cuda_device).manual_seed(n)
    x = torch.randn((size, n * 8, cols), generator=gen,
                    device=cuda_device).to(dtype)
    for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                      (ring.ring_reduce_scatter,
                       ring.ring_reduce_scatter_plain),
                      (ring.ring_allgather, ring.ring_allgather_plain)):
        want = plain(x, axis, mesh)
        for _ in range(3):
            before = fn.launches
            out = fn(x, axis, mesh)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert torch.equal(out, want)


@pytest.mark.cuda
def test_torus_and_autograd_on_card(cuda_device):
    mesh = make_mesh({"y": 2, "x": 2}, devices=[cuda_device] * 4)
    z = torch.randn((4, 8, 128), device=cuda_device)
    before = ring.ring_reduce_scatter.launches + ring.ring_allgather.launches
    out = ring.ring_allreduce_torus(z, ("x", "y"), mesh)
    assert ring.ring_reduce_scatter.launches + \
        ring.ring_allgather.launches == before + 4
    torch.testing.assert_close(out, z.sum(0).expand(4, 8, 128))
    leaf = z.clone().requires_grad_()
    flat = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    before = ring.ring_allreduce.launches
    ring.ring_allreduce(leaf, "x", flat).sum().backward()
    assert ring.ring_allreduce.launches == before + 2
    torch.testing.assert_close(leaf.grad, torch.full_like(z, 4.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32,
                                   torch.int64, torch.int8, torch.uint8,
                                   torch.int16], ids=str)
@pytest.mark.parametrize("cols", [128, 7])
def test_sum_kernels_at_more_dtypes_on_card(cuda_device, dtype, cols):
    mesh = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    gen = torch.Generator(cuda_device).manual_seed(cols)
    if dtype.is_floating_point:
        x = torch.randn((4, 32, cols), generator=gen,
                        device=cuda_device).to(dtype)
    else:
        x = torch.randint(-2 ** 30, 2 ** 30, (4, 32, cols), generator=gen,
                          device=cuda_device).to(dtype)
    for fn, plain in ((ring.ring_allreduce, ring.ring_allreduce_plain),
                      (ring.ring_reduce_scatter,
                       ring.ring_reduce_scatter_plain)):
        before = fn.launches
        out = fn(x, "x", mesh)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(out, plain(x, "x", mesh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.float16,
                                   torch.int64, torch.complex64], ids=str)
@pytest.mark.parametrize("cols", [128, 3])
def test_allgather_moves_any_dtype_on_card(cuda_device, dtype, cols):
    mesh = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    x = torch.arange(4 * 8 * cols, device=cuda_device).reshape(
        4, 8, cols).to(dtype)
    out = ring.ring_allgather(x, "x", mesh)
    assert torch.equal(out, ring.ring_allgather_plain(x, "x", mesh))
    assert torch.equal(out[2], x.reshape(32, cols))
