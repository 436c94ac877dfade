"""gloo_tpu_torch.tpu (spmd, CudaProcessGroup) against gloo_tpu.tpu.

Every collective of CudaProcessGroup over a CPU world of 4 is held against
TpuProcessGroup over a 4-device CPU mesh on the same numpy inputs (the
cases of tests/test_tpu_spmd.py), and the spmd functions' axis arguments
(gather and scatter axes, tiled or not, shift without wrap) against
gloo_tpu.tpu.spmd inside shard_map.

Tolerances: data movement (broadcast, allgather, alltoall, scatter, shift,
max, min) is exact. Sums: the port adds in ring order, XLA's psum in its
own order, so f32 sums of 4 values of size ~10 agree to a few ulps (rtol
1e-6); the closed-form checks of test_tpu_spmd.py keep its rtol 1e-6.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.tpu import TpuProcessGroup  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu.tpu import spmd as jax_spmd  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.tpu import CudaProcessGroup, make_mesh, spmd  # noqa: E402

SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def groups():
    ours = CudaProcessGroup(make_mesh({"data": 4}, devices=["cpu"] * 4))
    ref = TpuProcessGroup(jax_make_mesh({"data": 4},
                                        devices=jax.devices()[:4]))
    return ours, ref


def rows(p, cols=16):
    return np.arange(p * cols, dtype=np.float32).reshape(p, cols) + 1.0


def _both(groups, method, x, **kw):
    ours, ref = groups
    got = ours.unshard(getattr(ours, method)(ours.shard(x), **kw))
    want = ref.unshard(getattr(ref, method)(ref.shard(x), **kw))
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


@pytest.mark.parametrize("op", ["sum", "max", "min", "product"])
def test_allreduce(groups, op):
    x = rows(4) * 0.5
    got, want = _both(groups, "allreduce", x, op=op)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    closed = {"sum": np.sum, "max": np.max, "min": np.min,
              "product": np.prod}[op](x, axis=0)
    for r in range(4):
        np.testing.assert_allclose(got[r], closed, rtol=1e-5)
        np.testing.assert_array_equal(got[r], got[0])


@pytest.mark.parametrize("method,kw", [
    ("broadcast", {"root": 2}), ("allgather", {}), ("shift", {"offset": 1}),
    ("shift", {"offset": -2}), ("send_recv", {"perm": [(0, 2), (2, 1)]})])
def test_data_movement(groups, method, kw):
    got, want = _both(groups, method, rows(4), **kw)
    np.testing.assert_array_equal(got, want)


def test_allgather_shape(groups):
    got, _ = _both(groups, "allgather", rows(4))
    assert got.shape == (4, 4, 16)
    for r in range(4):
        np.testing.assert_array_equal(got[r], rows(4))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_root_only(groups, op):
    x = rows(4)
    got, want = _both(groups, "reduce", x, root=1, op=op)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    for r in (0, 2, 3):
        np.testing.assert_array_equal(got[r], np.zeros_like(x[0]))


@pytest.mark.parametrize("op", ["sum", "min"])
def test_reduce_scatter(groups, op):
    per = 4
    x = rows(4, cols=1)[:, :1] * np.ones((4, 4 * per), np.float32)
    x = x[..., None] + np.arange(3, dtype=np.float32)
    got, want = _both(groups, "reduce_scatter", x, op=op)
    assert got.shape == (4, per, 3)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize("dtype", [np.int32, np.float16])
@pytest.mark.parametrize("method,kw", [
    ("allreduce", {}), ("allreduce", {"op": "product"}),
    ("reduce", {"root": 1}), ("reduce_scatter", {}), ("allgather", {})])
def test_group_at_int32_and_f16(groups, dtype, method, kw):
    """The sum kernels take int32 and f16 as psum does (B3, B4a), the
    allgather moves them (B4b). Small integers make every sum and product
    exact in both types, so the results are equal whatever the order of
    the adds; int32 column 0 wraps past 2**31 in both."""
    x = (rows(4) % 5 + 1).astype(dtype)
    if dtype == np.int32 and kw.get("op") != "product":
        x[:, 0] = 2 ** 30 + np.arange(4)
    got, want = _both(groups, method, x, **kw)
    np.testing.assert_array_equal(got, want)


def test_alltoall_and_scatter(groups):
    x = (np.arange(4)[:, None] * 100 + np.arange(4)[None, :]).astype(
        np.float32)[..., None] * np.ones((4, 4, 8), np.float32)
    got, want = _both(groups, "alltoall", x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.transpose(1, 0, 2))
    y = rows(4, cols=12).reshape(4, 4, 3)
    got, want = _both(groups, "scatter", y, root=0)
    np.testing.assert_array_equal(got, want)


def test_barrier(groups):
    ours, _ = groups
    ours.barrier()
    assert spmd.barrier("data", mesh=ours.mesh).tolist() == [4] * 4


def test_group_rules():
    mesh = make_mesh({"y": 2, "x": 2}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axis required"):
        CudaProcessGroup(mesh)
    with pytest.raises(ValueError, match="leading axis"):
        CudaProcessGroup(mesh, "x").shard(np.zeros((4, 3)))


def test_group_on_a_multi_axis_mesh():
    """A group along one axis of a 2x2 mesh: its rows ride every ring of
    that axis, as TpuProcessGroup's P(axis) rows are replicated over the
    other axis."""
    ours = CudaProcessGroup(make_mesh({"y": 2, "x": 2}, devices=["cpu"] * 4),
                            "x")
    ref = TpuProcessGroup(jax_make_mesh({"y": 2, "x": 2},
                                        devices=jax.devices()[:4]), "x")
    x = rows(2)
    for method in ("allreduce", "allgather", "shift"):
        got = ours.unshard(getattr(ours, method)(ours.shard(x)))
        want = ref.unshard(getattr(ref, method)(ref.shard(x)))
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


def _jax_spmd(fn, x, axis="data"):
    mesh = jax_make_mesh({axis: 4}, devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(lambda s: fn(s[0])[None], mesh=mesh,
                              in_specs=P(axis), out_specs=P(axis)))
    return np.asarray(f(x))


@pytest.mark.parametrize("name,kw", [
    ("allgather", {"gather_axis": 0, "tiled": True}),
    ("allgather", {"gather_axis": 1, "tiled": True}),
    ("allgather", {"gather_axis": 1, "tiled": False}),
    ("reduce_scatter", {"scatter_axis": 1}),
    ("reduce_scatter", {"op": "max", "scatter_axis": 1}),
    ("alltoall", {"split_axis": 1, "concat_axis": 0}),
    ("scatter", {"root": 3, "scatter_axis": 1}),
    ("shift", {"offset": 1, "wrap": False}),
    ("mean", {}),
])
def test_spmd_axes_match_jax(name, kw):
    x = np.random.RandomState(5).randn(4, 4, 8).astype(np.float32)
    want = _jax_spmd(lambda s: getattr(jax_spmd, name)(s, "data", **kw), x)
    got = getattr(spmd, name)(torch.from_numpy(x), "data",
                              mesh=make_mesh({"data": 4},
                                             devices=["cpu"] * 4), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL,
                               atol=1e-6)


def test_sum_collectives_ride_the_ring(monkeypatch):
    """allreduce and mean through B3, reduce_scatter through B4a,
    allgather (and product) through B4b: each calls its ring wrapper
    once."""
    calls = []
    for name in ("ring_allreduce", "ring_reduce_scatter", "ring_allgather"):
        real = getattr(ring, name)
        monkeypatch.setattr(
            spmd, name,
            lambda *a, _real=real, _name=name: calls.append(_name)
            or _real(*a))
    mesh = make_mesh({"data": 4}, devices=["cpu"] * 4)
    x = torch.ones((4, 8, 2))
    for fn in (spmd.allreduce, spmd.mean, spmd.reduce_scatter,
               spmd.allgather):
        fn(x, "data", mesh=mesh)
    spmd.allreduce(x, "data", "product", mesh=mesh)
    assert calls == ["ring_allreduce", "ring_allreduce",
                     "ring_reduce_scatter", "ring_allgather",
                     "ring_allgather"]


def test_grad_through_allreduce():
    mesh = make_mesh({"data": 4}, devices=["cpu"] * 4)
    x = torch.from_numpy(rows(4)).requires_grad_()
    spmd.allreduce(x ** 2, "data", mesh=mesh).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * rows(4) * 4, rtol=1e-6)
