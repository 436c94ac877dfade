"""gloo_tpu_torch's all-to-all (B8: ops.ring.alltoall, spmd.alltoall,
CudaProcessGroup.alltoall) against gloo_tpu's.

On the CPU the port runs alltoall_plain, the step-by-step twin of
csrc/alltoall.cu; it is held against pallas_alltoall run as
tests/test_pallas_ring.py runs it: jax.shard_map(..., check_vma=False) over
the first n CPU devices with interpret=True. spmd.alltoall and the process
group are held against gloo_tpu.tpu.spmd.alltoall (lax.all_to_all) and
TpuProcessGroup. Inputs are made with numpy from a seed.

Tolerance: none. An all-to-all moves bytes, so every result is bitwise
equal to JAX's, in f32, bf16 and int32 alike.

Tests marked `cuda` hold the kernel against its twin on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.ops import pallas_alltoall  # noqa: E402
from gloo_tpu.tpu import TpuProcessGroup  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu.tpu import spmd as jax_spmd  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd  # noqa: E402


def _cpu_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _jax_world(fn, x, shape, names, axis):
    """fn inside shard_map, each device one row of the world array x (P,
    rows, cols), the devices arranged as `shape` with axes `names`."""
    size = int(np.prod(shape))
    mesh = JaxMesh(np.asarray(jax.devices()[:size], dtype=object).reshape(
        shape), names)
    spec = P(names if len(names) > 1 else names[0])
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                              check_vma=False))
    return np.asarray(f(x.reshape(-1, x.shape[-1]))).reshape(x.shape)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_twin_matches_jax_kernel(n):
    x = np.random.RandomState(n).randn(n, 3 * n, 128).astype(np.float32)
    ref = _jax_world(lambda s: pallas_alltoall(s, "x", interpret=True), x,
                     (n,), ("x",), "x")
    out = ring.alltoall(torch.from_numpy(x), "x", _cpu_mesh({"x": n}))
    np.testing.assert_array_equal(out.numpy(), ref)
    blocks = x.reshape(n, n, 3, 128)
    np.testing.assert_array_equal(
        out.numpy(), blocks.transpose(1, 0, 2, 3).reshape(x.shape))


def test_twin_matches_jax_kernel_bf16():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    n = 4
    x = np.random.RandomState(9).randn(n, 2 * n, 96).astype(
        ml_dtypes.bfloat16)
    ref = _jax_world(lambda s: pallas_alltoall(s, "x", interpret=True), x,
                     (n,), ("x",), "x")
    ours = torch.from_numpy(x.astype(np.float32)).bfloat16()
    out = ring.alltoall(ours, "x", _cpu_mesh({"x": n}))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("axis", ["a", "b"])
def test_twin_along_one_axis_of_a_2x2_mesh(axis):
    x = np.random.RandomState(4).randn(4, 8, 128).astype(np.float32)
    ref = _jax_world(
        lambda s: pallas_alltoall(s, axis, interpret=True,
                                  mesh_axes=("a", "b")),
        x, (2, 2), ("a", "b"), axis)
    out = ring.alltoall(torch.from_numpy(x), axis, _cpu_mesh({"a": 2, "b": 2}))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_int32_blocks_of_odd_bytes():
    """Any dtype: int32 blocks of 3 x 5 elements (60 bytes)."""
    mesh = _cpu_mesh({"x": 3})
    x = torch.arange(3 * 9 * 5, dtype=torch.int32).reshape(3, 9, 5)
    out = ring.alltoall(x, "x", mesh)
    want = x.reshape(3, 3, 3, 5).transpose(0, 1).reshape(3, 9, 5)
    assert torch.equal(out, want)


def test_vjp_matches_jax_grad():
    """Port of test_pallas_ring.py::test_pallas_alltoall_grad: the block
    swap is an involution, so the VJP is another all-to-all."""
    n = 4
    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))
    import jax.numpy as jnp

    x = np.random.RandomState(5).randn(n * n * 2, 128).astype(np.float32)
    w = np.random.RandomState(6).randn(n * n * 2, 128).astype(np.float32)

    def loss(x):
        f = jax.shard_map(
            lambda s, ww: jnp.sum(pallas_alltoall(s, "x", interpret=True)
                                  * ww)[None],
            mesh=mesh, in_specs=(P("x"), P("x")), out_specs=P("x"),
            check_vma=False)
        return jnp.sum(f(x, w))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x))).reshape(n, n * 2, 128)
    leaf = torch.from_numpy(x.reshape(n, n * 2, 128).copy()).requires_grad_()
    y = ring.alltoall(leaf, "x", _cpu_mesh({"x": n}))
    (y * torch.from_numpy(w.reshape(n, n * 2, 128))).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), ref)


@pytest.mark.parametrize("split_axis,concat_axis", [
    (0, 0), (1, 0), (0, 1), (1, 2), (2, 1), (2, 2), (2, 0)])
def test_spmd_alltoall_matches_jax(split_axis, concat_axis):
    """spmd.alltoall against lax.all_to_all (tiled) over (4, 8, 12) local
    values; (1, 2) and (2, 1) are Ulysses' two exchanges."""
    x = np.random.RandomState(7).randn(4, 4, 8, 12).astype(np.float32)
    mesh = jax_make_mesh({"seq": 4}, devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(
        lambda s: jax_spmd.alltoall(s[0], "seq", split_axis=split_axis,
                                    concat_axis=concat_axis)[None],
        mesh=mesh, in_specs=P("seq"), out_specs=P("seq")))
    want = np.asarray(f(x))
    got = spmd.alltoall(torch.from_numpy(x), "seq", split_axis=split_axis,
                        concat_axis=concat_axis, mesh=_cpu_mesh({"seq": 4}))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmd_alltoall_is_differentiable():
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 4, 8, 4).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(np.random.RandomState(9).randn(4, 1, 32, 4).astype(
        np.float32))
    mesh = _cpu_mesh({"seq": 4})
    y = spmd.alltoall(x, "seq", split_axis=0, concat_axis=1, mesh=mesh)
    (y * w).sum().backward()
    # The adjoint of the exchange is the inverse exchange.
    back = spmd.alltoall(w, "seq", split_axis=1, concat_axis=0, mesh=mesh)
    np.testing.assert_array_equal(x.grad.numpy(), back.numpy())


def test_group_alltoall_matches_tpu_group():
    ours = CudaProcessGroup(make_mesh({"data": 4}, devices=["cpu"] * 4))
    ref = TpuProcessGroup(jax_make_mesh({"data": 4},
                                        devices=jax.devices()[:4]))
    x = np.random.RandomState(3).randn(4, 8, 3, 5).astype(np.float32)
    got = ours.unshard(ours.alltoall(ours.shard(x)))
    want = ref.unshard(ref.alltoall(ref.shard(x)))
    np.testing.assert_array_equal(got, want)


def test_rejects_what_it_does_not_take():
    mesh = _cpu_mesh({"x": 4})
    with pytest.raises(ValueError, match="not divisible"):
        ring.alltoall(torch.zeros((4, 6, 8)), "x", mesh)
    with pytest.raises(ValueError, match="not divisible"):
        spmd.alltoall(torch.zeros((4, 6, 8)), "x", split_axis=0, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        spmd.alltoall(torch.zeros((4, 8, 6)), "x", split_axis=1, mesh=mesh)
    with pytest.raises(ValueError, match="world tensor"):
        ring.alltoall(torch.zeros((3, 8, 8)), "x", mesh)
    # Ring size 1: x itself; the twin launches nothing.
    x = torch.zeros((4, 8, 8))
    assert ring.alltoall(x, "one", _cpu_mesh({"x": 4, "one": 1})) is x
    before = ring.alltoall.launches
    ring.alltoall(x, "x", mesh)
    assert ring.alltoall.launches == before


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the all-to-all kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,cols", [
    (2, torch.float32, 128), (3, torch.bfloat16, 100), (4, torch.int32, 7),
    (8, torch.float32, 128)])
def test_kernel_matches_twin_on_card(cuda_device, n, dtype, cols):
    mesh = make_mesh({"x": n}, devices=[cuda_device] * n)
    x = torch.randint(-1000, 1000, (n, 4 * n, cols), device=cuda_device).to(
        dtype)
    before = ring.alltoall.launches
    out = ring.alltoall(x, "x", mesh)
    torch.cuda.synchronize()
    assert ring.alltoall.launches == before + 1
    assert torch.equal(out, ring.alltoall_plain(x, "x", mesh))
