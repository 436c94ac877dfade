"""The sum collectives at the small integer types and bool, against
TpuProcessGroup.

The reference's TpuProcessGroup (lax.psum, lax.psum_scatter) sums int8,
uint8, int16, uint16 and uint32 in their own type, wrapping on overflow;
a bool allreduce returns int32 counts and a bool reduce-scatter raises
TypeError. The port sums all five the same way on the ring kernels B3 and
B4a (one wrapping add per member in the type on the card), and returns
int32 counts for a bool allreduce. This PyTorch has no add, max or
index_put for uint16 and uint32 on the CPU, so their twins (and the max)
compute in int32 / int64 and cast back once: a sum mod 2**bits has the
same bits in any order.

Inputs are made with numpy from a seed and handed to both groups (4 ranks,
a 4-device CPU mesh on the reference's side). Tolerance: none; integer
sums wrap to the same bits in any order.

Tests marked `cuda` hold the kernels against the CPU's twins on the card.
"""

import numpy as np
import pytest
import torch

from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd

SMALL = [np.int8, np.uint8, np.int16, np.uint16, np.uint32]


@pytest.fixture(scope="module")
def groups():
    jax = pytest.importorskip("jax")
    from gloo_tpu.tpu import TpuProcessGroup
    from gloo_tpu.tpu import make_mesh as jax_make_mesh

    ours = CudaProcessGroup(make_mesh({"data": 4}, devices=["cpu"] * 4))
    ref = TpuProcessGroup(jax_make_mesh({"data": 4},
                                        devices=jax.devices()[:4]))
    return ours, ref


def _both(groups, method, x, **kw):
    ours, ref = groups
    got = ours.unshard(getattr(ours, method)(ours.shard(x), **kw))
    want = ref.unshard(getattr(ref, method)(ref.shard(x), **kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def _wrapping(dtype, seed, cols=12):
    """(4, 4 * cols) values over the type's whole range, so that most sums
    wrap."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)
    return rng.randint(info.min, int(info.max) + 1, size=(4, 4 * cols),
                       dtype=np.int64).astype(dtype)


def test_int8_overflow_of_the_review(groups):
    """0, 150, 300 and 450 cast to int8 (0, -106, 44, -62) sum to -124 on
    every rank, in both."""
    x = np.array([0, 150, 300, 450]).astype(np.int8)[:, None].repeat(8, 1)
    got, want = _both(groups, "allreduce", x)
    np.testing.assert_array_equal(got, want)
    assert (got == -124).all()


@pytest.mark.parametrize("dtype", SMALL, ids=lambda d: d.__name__)
@pytest.mark.parametrize("method,kw", [
    ("allreduce", {}), ("reduce_scatter", {}), ("reduce", {"root": 2}),
    ("allreduce", {"op": "max"}), ("allgather", {})])
def test_small_integers_match_the_reference_bitwise(groups, dtype, method,
                                                    kw):
    x = _wrapping(dtype, seed=np.dtype(dtype).itemsize)
    got, want = _both(groups, method, x, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", SMALL, ids=lambda d: d.__name__)
@pytest.mark.parametrize("axis", ["x", "y"])
def test_small_integers_along_each_axis_of_a_2x2_mesh(dtype, axis):
    """spmd.allreduce and reduce_scatter over one axis of a 2 x 2 mesh
    against gloo_tpu.tpu.spmd inside shard_map."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.tpu import spmd as jax_spmd

    mesh = JaxMesh(np.asarray(jax.devices()[:4], dtype=object).reshape(2, 2),
                   ("y", "x"))
    x = _wrapping(dtype, seed=7).reshape(4, 8, 6)
    ours = make_mesh({"y": 2, "x": 2}, devices=["cpu"] * 4)
    for name in ("allreduce", "reduce_scatter"):
        f = jax.jit(jax.shard_map(
            lambda s: getattr(jax_spmd, name)(s[0], axis)[None], mesh=mesh,
            in_specs=P(("y", "x")), out_specs=P(("y", "x")),
            check_vma=False))
        want = np.asarray(f(x))
        got = getattr(spmd, name)(torch.from_numpy(x), axis, mesh=ours)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_bool_allreduce_counts_in_int32(groups):
    x = np.arange(4 * 10).reshape(4, 10) % 3 == 0
    for method, kw in (("allreduce", {}), ("reduce", {"root": 1})):
        got, want = _both(groups, method, x, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_bool_reduce_scatter_raises_in_both(groups):
    ours, ref = groups
    x = np.ones((4, 8), dtype=bool)
    with pytest.raises(TypeError):
        ref.unshard(ref.reduce_scatter(ref.shard(x)))
    with pytest.raises(TypeError, match="ring_reduce_scatter"):
        ours.reduce_scatter(ours.shard(x))


@pytest.mark.parametrize("dtype", [torch.uint16, torch.uint32], ids=str)
def test_unsigned_wide_types_gather_as_they_lie(dtype):
    """The allgather, a byte move, takes the wide unsigned types as it
    takes every dtype: its twin's output is the plain gather, bit for
    bit."""
    mesh = make_mesh({"x": 4}, devices=["cpu"] * 4)
    x = torch.from_numpy(_wrapping({torch.uint16: np.uint16,
                                    torch.uint32: np.uint32}[dtype],
                                   seed=5, cols=4).reshape(4, 8, 2))
    out = ring.ring_allgather(x, "x", mesh)
    assert out.dtype == dtype
    assert torch.equal(out, ring.ring_allgather_plain(x, "x", mesh))
    assert torch.equal(out, x.reshape(1, 32, 2).expand(4, -1, -1))


TWIN_TYPES = {torch.int8: np.int8, torch.uint8: np.uint8,
              torch.int16: np.int16, torch.uint16: np.uint16,
              torch.uint32: np.uint32}


@pytest.mark.parametrize("dtype", list(TWIN_TYPES), ids=str)
def test_twins_add_once_per_step_in_the_type(dtype):
    """The twins' sums equal the wrapped exact sum: one add per member in
    the type, never in a wider one that would saturate or differ."""
    mesh = make_mesh({"x": 4}, devices=["cpu"] * 4)
    x = torch.from_numpy(_wrapping(TWIN_TYPES[dtype], seed=3).reshape(
        4, 8, 6))
    exact = x.long().sum(0).to(dtype)  # wraps once, mod 2**bits
    out = ring.ring_allreduce(x, "x", mesh)
    assert out.dtype == dtype
    assert torch.equal(out, exact.expand(4, -1, -1))
    rs = ring.ring_reduce_scatter(x, "x", mesh)
    assert torch.equal(rs, exact.view(4, 2, 6))


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16,
                                   torch.uint16, torch.uint32, torch.bool],
                         ids=str)
@pytest.mark.parametrize("cols", [128, 7])
def test_small_types_on_card_match_the_cpu(cuda_device, dtype, cols):
    """allreduce and reduce_scatter on B3/B4a (bool: allreduce as int32)
    and allgather on B4b, bitwise against the same calls on the CPU."""
    mesh = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    cpu = make_mesh({"x": 4}, devices=["cpu"] * 4)
    gen = torch.Generator().manual_seed(cols)
    bits = 31 if dtype == torch.uint32 else 15  # sums that wrap the type
    x = torch.randint(-2 ** bits, 2 ** bits, (4, 16, cols), generator=gen)
    x = x.to(dtype) if dtype != torch.bool else x % 3 == 0
    calls = [("allreduce", lambda t, m: spmd.allreduce(t, "x", mesh=m)),
             ("allgather", lambda t, m: spmd.allgather(t, "x", mesh=m))]
    if dtype != torch.bool:
        calls.append(("reduce_scatter",
                      lambda t, m: spmd.reduce_scatter(t, "x", mesh=m)))
    for _, call in calls:
        for _ in range(3):
            out = call(x.to(cuda_device), mesh)
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), call(x, cpu))
