"""Collectives over a tuple of mesh axes against gloo_tpu.tpu.spmd.

The reference's `Axis` is a name or a sequence of names; lax.psum and the
rest run over the product of the named axes, and lax.axis_index of a tuple
numbers the ranks row-major over the names as given. The port's Mesh
builds one ring over such a tuple (ring_members first, ring_index and
ring_neighbors from it), and every spmd function takes it. Each is held
against the same gloo_tpu.tpu.spmd call inside shard_map over CPU devices
arranged as the same mesh, on the same numpy inputs, and the ring tables
against lax.axis_index.

Tolerances: data movement, max and min are exact, and so are the integer
sums (int32, whatever the order of the adds). f32 sums: the port adds in
ring order and XLA's psum in its own, so sums of up to 8 values of size
~1 agree to a few ulps (rtol 1e-6, atol 1e-6).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.tpu import spmd as jax_spmd  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh, spmd  # noqa: E402

SUM_RTOL = 1e-6

# (mesh axes, the tuple axis): both orders on a 2 x 2 mesh, a tuple that
# skips an axis on a 2 x 2 x 2 mesh in reverse order, and one of all three.
MESHES = [({"a": 2, "b": 2}, ("a", "b")),
          ({"a": 2, "b": 2}, ("b", "a")),
          ({"a": 2, "b": 2, "c": 2}, ("c", "a")),
          ({"a": 2, "b": 2, "c": 2}, ("b", "c", "a"))]
IDS = ["2x2_ab", "2x2_ba", "2x2x2_ca", "2x2x2_bca"]


def _jax_mesh(axes):
    size = int(np.prod(list(axes.values())))
    grid = np.asarray(jax.devices()[:size], dtype=object)
    return JaxMesh(grid.reshape(tuple(axes.values())), tuple(axes))


def _jax_world(fn, x, axes):
    """fn(local value) inside shard_map, device r (row-major over the mesh)
    holding row r of the world array x."""
    names = tuple(axes)
    f = jax.jit(jax.shard_map(lambda s: fn(s[0])[None], mesh=_jax_mesh(axes),
                              in_specs=P(names), out_specs=P(names),
                              check_vma=False))
    return np.asarray(f(x))


def _ours(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(
        axes.values()))))


@pytest.mark.parametrize("axes,axis", MESHES, ids=IDS)
def test_ring_tables_match_axis_index(axes, axis):
    """ring_index is lax.axis_index of the tuple; ring_members[r][k] is the
    rank with index k that shares r's position on every other axis; the
    neighbours are the members at index +- 1."""
    size = int(np.prod(list(axes.values())))
    others = [a for a in axes if a not in axis]

    def tables(_):
        pos = [lax.axis_index(a) for a in others] or [jnp.int32(0)]
        return jnp.stack([lax.axis_index(axis), *pos])

    ref = _jax_world(tables, np.zeros((size, 1), np.float32), axes)
    mesh = _ours(axes)
    index = ref[:, 0].tolist()
    assert mesh.ring_index(axis) == index
    assert mesh.axis_size(axis) == int(np.prod([axes[a] for a in axis]))
    members = mesh.ring_members(axis)
    for r in range(size):
        want = [next(m for m in range(size) if index[m] == k
                     and (ref[m, 1:] == ref[r, 1:]).all())
                for k in range(mesh.axis_size(axis))]
        assert members[r] == want
    my, right, left = mesh.ring_neighbors(axis)
    n = mesh.axis_size(axis)
    assert my == index
    assert right == [members[r][(index[r] + 1) % n] for r in range(size)]
    assert left == [members[r][(index[r] - 1) % n] for r in range(size)]


def test_single_names_keep_their_tables():
    """A one-name tuple is that name; a single name keeps the stride form
    of pallas_ring.py's _peer_logical_id."""
    mesh = _ours({"a": 2, "b": 4})
    for axis, stride in (("a", 4), ("b", 1)):
        n = mesh.shape[axis]
        my = mesh.ring_index(axis)
        assert mesh.ring_members((axis,)) == mesh.ring_members(axis)
        assert mesh.ring_neighbors(axis) == (
            my, [r + ((m + 1) % n - m) * stride for r, m in enumerate(my)],
            [r + ((m - 1) % n - m) * stride for r, m in enumerate(my)])


@pytest.mark.parametrize("axes,axis", MESHES, ids=IDS)
def test_kernel_tables_are_made_once_per_mesh_and_axis(axes, axis):
    """What the ring kernels take: the mesh's tables as ctypes int arrays
    (ring index, right, left, and the members table row by row), made once
    per (mesh, axis) and handed to every launch; a list of names is its
    tuple, and the tables a caller gets are its own copies."""
    mesh = _ours(axes)
    tables = ring._ctypes_tables(mesh, ring._axis_key(axis))
    assert ring._ctypes_tables(mesh, ring._axis_key(list(axis))) is tables
    assert tables.members is tables[3]
    table = ring.ring_table(mesh, ring._axis_key(axis))
    assert ring.ring_table(mesh, ring._axis_key(list(axis))) is table
    assert table.dtype == torch.int32 and table.tolist() == [
        *(m for t in mesh.ring_neighbors(axis) for m in t),
        *mesh.local_ranks, *tables[3]]
    assert [list(t) for t in tables[:3]] == list(mesh.ring_neighbors(axis))
    assert list(tables[3]) == [m for row in mesh.ring_members(axis)
                               for m in row]
    mesh.ring_members(axis)[0][0] = -1
    mesh.ring_index(axis)[0] = -1
    assert mesh.ring_members(axis) == _ours(axes).ring_members(axis)
    assert mesh.ring_index(axis) == _ours(axes).ring_index(axis)


@pytest.mark.parametrize("axis", [("a", "z"), ("a", "a"), ()])
def test_bad_tuples_raise(axis):
    mesh = _ours({"a": 2, "b": 2})
    with pytest.raises(ValueError, match="axis"):
        mesh.ring_members(axis)
    with pytest.raises(ValueError, match="axis"):
        spmd.allreduce(torch.zeros((4, 4)), axis, mesh=mesh)


# (name, kwargs, dtype): every spmd function that takes an axis.
CASES = [
    ("allreduce", {"op": "sum"}, np.float32),
    ("allreduce", {"op": "sum"}, np.int32),
    ("allreduce", {"op": "max"}, np.float32),
    ("allreduce", {"op": "min"}, np.float32),
    ("allreduce", {"op": "product"}, np.float32),
    ("mean", {}, np.float32),
    ("reduce_scatter", {}, np.float32),
    ("reduce_scatter", {"scatter_axis": 1}, np.int32),
    ("reduce_scatter", {"op": "max", "scatter_axis": 1}, np.float32),
    ("allgather", {"gather_axis": 0, "tiled": True}, np.float32),
    ("allgather", {"gather_axis": 1, "tiled": False}, np.int32),
    ("alltoall", {"split_axis": 0, "concat_axis": 1}, np.float32),
    ("broadcast", {"root": 1}, np.float32),
    ("reduce", {"root": 2}, np.float32),
    ("scatter", {"root": 3, "scatter_axis": 1}, np.float32),
    ("ppermute", {"perm": ((0, 2), (2, 1), (1, 0))}, np.float32),
    ("shift", {"offset": 1}, np.float32),
    ("shift", {"offset": -1, "wrap": False}, np.int32),
]


def _input(size, n, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(-50, 50, size=(size, 2 * n, 8)).astype(np.int32)
    return (rng.rand(size, 2 * n, 8) + 0.5).astype(np.float32)


@pytest.mark.parametrize("axes,axis", MESHES, ids=IDS)
@pytest.mark.parametrize("name,kw,dtype", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_spmd_over_a_tuple_matches_jax(axes, axis, name, kw, dtype):
    size = int(np.prod(list(axes.values())))
    n = int(np.prod([axes[a] for a in axis]))
    x = _input(size, n, dtype, seed=size + n + len(name))
    want = _jax_world(lambda s: getattr(jax_spmd, name)(s, axis, **kw), x,
                      axes)
    got = getattr(spmd, name)(torch.from_numpy(x), axis, mesh=_ours(axes),
                              **kw)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    if dtype == np.float32 and name in ("allreduce", "mean",
                                        "reduce_scatter", "reduce"):
        np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axes,axis", MESHES, ids=IDS)
def test_rank_size_and_barrier_over_a_tuple(axes, axis):
    size = int(np.prod(list(axes.values())))
    want = _jax_world(lambda s: jnp.stack([
        jax_spmd.rank(axis), jnp.int32(jax_spmd.size(axis)),
        jax_spmd.barrier(axis)]), np.zeros((size, 1), np.float32), axes)
    mesh = _ours(axes)
    assert spmd.rank(axis, mesh=mesh).tolist() == want[:, 0].tolist()
    assert spmd.size(axis, mesh=mesh) == int(want[0, 1])
    assert spmd.barrier(axis, mesh=mesh).tolist() == want[:, 2].tolist()


def test_the_sums_ride_the_ring_kernels_over_a_tuple(monkeypatch):
    """allreduce, reduce_scatter and allgather over ("b", "a") call B3, B4a
    and B4b once each, with the tuple as their axis."""
    calls = []
    for fn in ("ring_allreduce", "ring_reduce_scatter", "ring_allgather"):
        real = getattr(ring, fn)
        monkeypatch.setattr(
            spmd, fn, lambda x, axis, mesh, _real=real, _fn=fn:
            calls.append((_fn, axis)) or _real(x, axis, mesh))
    mesh = _ours({"a": 2, "b": 2})
    x = torch.ones((4, 8, 2))
    for fn in (spmd.allreduce, spmd.reduce_scatter, spmd.allgather):
        fn(x, ("b", "a"), mesh=mesh)
    assert calls == [("ring_allreduce", ("b", "a")),
                     ("ring_reduce_scatter", ("b", "a")),
                     ("ring_allgather", ("b", "a"))]


def test_ring_kernels_over_a_tuple_are_their_twins():
    """The world-tensor wrappers over a tuple on the CPU: B3's sum, B4a's
    slice and B4b's gather are those of the flat ring that the tuple
    names."""
    mesh = _ours({"a": 2, "b": 2, "c": 2})
    x = torch.from_numpy(_input(8, 4, np.int32, seed=3))
    members = torch.tensor(mesh.ring_members(("c", "a")))
    for fn in (ring.ring_allreduce, ring.ring_reduce_scatter,
               ring.ring_allgather):
        out = fn(x, ("c", "a"), mesh)
        for ring_ranks in {tuple(m) for m in members.tolist()}:
            sub = x[list(ring_ranks)]
            want = fn(sub, "r", _ours({"r": 4}))
            assert torch.equal(out[list(ring_ranks)], want)
