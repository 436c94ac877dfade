"""The one-pass kernels of csrc/ring.cu (the member-order sums B3 and B4a,
the read-once allgather B4b), proved on the CPU.

On the card, B3 (ring_allreduce) and B4a (ring_reduce_scatter) do not walk
the ring: the rank that finishes chunk c reads chunk c of every member of
its ring, in the order in which the ring would have added it up, and
writes the sum once (B4a: into its own output; B3: into chunk c of every
member's output). `member_order` below is a plain model of that pass, with
the kernel's indexing: one add per member in the element type, members
my + 1, my + 2, ..., my + n = my of the ring of the rank with ring index
my, which finishes chunk my + 1 (B3) or my (B4a).

B4b (ring_allgather) does not forward chunks around the ring either: the
rank that owns a chunk reads it once and stores it at offset (its ring
index) into the output of every member of its ring. `member_gather` models
that pass block by block and checks that every input chunk is read once
and every output chunk written once.

The models are held bitwise (tolerance: none) against the plain twins, and
against the interpreted JAX kernels (B4b also against lax.all_gather), so
the order and placement the kernels use are proved here before the card
runs them. bf16 and f16 round after every add in both; integers wrap in
their own width. Inputs are made with numpy from a seed.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.tpu import make_mesh

KINDS = {"allreduce": (False, ring.ring_allreduce_plain),
         "reduce_scatter": (True, ring.ring_reduce_scatter_plain)}

# (name, mesh axes, ring axis): rings of 2 to 8, and each axis of a 2 x 2
# and a 2 x 4 mesh (flat rank differs from ring index there).
MESHES = [("P2", {"x": 2}, "x"), ("P3", {"x": 3}, "x"), ("P4", {"x": 4}, "x"),
          ("P8", {"x": 8}, "x"), ("2x2_y", {"y": 2, "x": 2}, "y"),
          ("2x2_x", {"y": 2, "x": 2}, "x"), ("2x4_a", {"a": 2, "b": 4}, "a"),
          ("2x4_b", {"a": 2, "b": 4}, "b")]


def member_order(x, axis, mesh, reduce_scatter):
    """B3's or B4a's pass in plain PyTorch, rank by rank as the kernel's
    blocks run it. Also checks that every output chunk is written exactly
    once."""
    n = mesh.shape[axis]
    ranks, rows, cols = x.shape
    # uint16 and uint32 add in ring.WIDENED's type and wrap once at the
    # end: the same bits as one wrapping add per member.
    chunks = ring.widened(x).reshape(ranks, n, rows // n, cols)
    out = torch.empty((ranks, 1 if reduce_scatter else n, rows // n, cols),
                      dtype=chunks.dtype)
    written = torch.zeros(out.shape[:2], dtype=torch.int64)
    for r, (my, members) in enumerate(zip(mesh.ring_index(axis),
                                          mesh.ring_members(axis))):
        c = my if reduce_scatter else (my + 1) % n
        acc = chunks[members[(my + 1) % n], c]
        for k in range(2, n + 1):
            acc = chunks[members[(my + k) % n], c] + acc
        targets = [(r, 0)] if reduce_scatter else [(m, c) for m in members]
        for rank, slot in targets:
            out[rank, slot] = acc
            written[rank, slot] += 1
    assert bool((written == 1).all()), written
    return out.reshape(ranks, -1, cols).to(x.dtype)


def member_gather(x, axis, mesh):
    """B4b's pass in plain PyTorch, rank by rank as the kernel's blocks run
    it: rank r's chunk is read once and stored as chunk (r's ring index) of
    every member's output. Also checks that every output chunk is written
    exactly once."""
    n = mesh.axis_size(axis)
    ranks, rows, cols = x.shape
    out = torch.empty((ranks, n, rows, cols), dtype=x.dtype)
    written = torch.zeros((ranks, n), dtype=torch.int64)
    for r, (my, members) in enumerate(zip(mesh.ring_index(axis),
                                          mesh.ring_members(axis))):
        chunk = x[r].clone()  # the one read of rank r's input
        for m in members:
            out[m, my] = chunk
            written[m, my] += 1
    assert bool((written == 1).all()), written
    return out.reshape(ranks, n * rows, cols)


def _input(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if not dtype.is_floating_point:
        # Values over the whole range, so that the sums wrap.
        info = torch.iinfo(dtype)
        return torch.from_numpy(rng.randint(
            info.min, info.max, size=shape, dtype=np.int64)).to(dtype)
    # Magnitudes spread over six decades, so that the order of the adds
    # shows in the rounding.
    x = rng.randn(*shape) * 10.0 ** rng.uniform(-3, 3, size=shape)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", list(ring.SUM_DTYPES), ids=str)
@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_member_order_is_bitwise_the_twin(name, axes, axis, dtype, kind):
    size = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=["cpu"] * size)
    n = axes[axis]
    x = _input(dtype, (size, n * 3, 20), seed=size * 10 + n)
    reduce_scatter, plain = KINDS[kind]
    got = member_order(x, axis, mesh, reduce_scatter)
    want = plain(x, axis, mesh)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [3, 8])
def test_an_order_off_by_one_member_is_caught(n):
    """The bitwise comparison has teeth: walking the members from my
    instead of my + 1 (B4a's finished chunk with B3's order) gives nearly
    equal f32 sums that are not the twin's."""
    mesh = make_mesh({"x": n}, devices=["cpu"] * n)
    x = _input(torch.float32, (n, n * 3, 20), seed=n)
    chunks = x.reshape(n, n, 3, 20)
    shifted = torch.stack([
        _fold([chunks[(my + k) % n, my] for k in range(n)])
        for my in range(n)]).reshape(n, 3, 20)
    want = ring.ring_reduce_scatter_plain(x, "x", mesh)
    torch.testing.assert_close(shifted, want, rtol=1e-5, atol=1e-3)
    assert not torch.equal(shifted, want)


def _fold(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = t + acc
    return acc


def _jax_ring(fn, n, x):
    """fn inside shard_map over the first n devices, each one row of the
    world array x (P, rows, cols), interpreted as tests/test_pallas_ring.py
    runs the Pallas kernels."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("x"),
                              out_specs=P("x"), check_vma=False))
    out = np.asarray(f(x.reshape(-1, x.shape[-1])))
    return out.reshape(x.shape[0], -1, x.shape[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_member_order_is_bitwise_the_jax_kernel(n, dtype, kind):
    pytest.importorskip("jax")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from gloo_tpu.ops import ring_allreduce, ring_reduce_scatter

    x32 = np.random.RandomState(n).randn(n, n * 8, 128).astype(np.float32)
    ours = torch.from_numpy(x32).to(dtype)
    theirs = x32 if dtype == torch.float32 else x32.astype(ml_dtypes.bfloat16)
    reduce_scatter, _ = KINDS[kind]
    jax_fn = ring_reduce_scatter if reduce_scatter else ring_allreduce
    ref = _jax_ring(lambda s: jax_fn(s, "x", interpret=True), n, theirs)
    got = member_order(ours, "x", make_mesh({"x": n}, devices=["cpu"] * n),
                       reduce_scatter)
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.astype(np.float32))


# (name, mesh axes, ring axis) of the gather: MESHES and tuple axes.
GATHER_MESHES = MESHES + [("2x2_xy", {"y": 2, "x": 2}, ("x", "y")),
                          ("2x2x2_ca", {"a": 2, "b": 2, "c": 2}, ("c", "a"))]
GATHER_DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.int64]


@pytest.mark.parametrize("dtype", GATHER_DTYPES, ids=str)
@pytest.mark.parametrize("name,axes,axis", GATHER_MESHES,
                         ids=[m[0] for m in GATHER_MESHES])
def test_gather_model_is_bitwise_the_twin(name, axes, axis, dtype):
    size = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=["cpu"] * size)
    x = _input(dtype, (size, 3, 20), seed=size + len(name))
    got = member_gather(x, axis, mesh)
    want = ring.ring_allgather_plain(x, axis, mesh)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(ring.ring_allgather(x, axis, mesh), want)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_gather_model_is_bitwise_the_jax_kernel_and_all_gather(n, dtype):
    pytest.importorskip("jax")
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from jax import lax

    from gloo_tpu.ops import ring_allgather

    x32 = np.random.RandomState(n).randn(n, 8, 128).astype(np.float32)
    ours = torch.from_numpy(x32).to(dtype)
    theirs = x32 if dtype == torch.float32 else x32.astype(ml_dtypes.bfloat16)
    got = member_gather(ours, "x", make_mesh({"x": n}, devices=["cpu"] * n))
    for fn in (lambda s: ring_allgather(s, "x", interpret=True),
               lambda s: lax.all_gather(s, "x", axis=0, tiled=True)):
        ref = _jax_ring(fn, n, theirs)
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref.astype(np.float32))


def test_gather_model_matches_all_gather_on_a_2x2_mesh_and_a_tuple():
    """Along each axis of a 2 x 2 mesh and over the tuple ("x", "y"),
    against lax.all_gather inside shard_map over the same mesh, in int64."""
    jax = pytest.importorskip("jax")
    from jax import lax
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    jmesh = JaxMesh(np.asarray(jax.devices()[:4], dtype=object).reshape(
        2, 2), ("y", "x"))
    mesh = make_mesh({"y": 2, "x": 2}, devices=["cpu"] * 4)
    x = np.random.RandomState(2).randint(-9, 9, size=(4, 2, 16)).astype(
        np.int32)
    for axis in ("y", "x", ("x", "y")):
        f = jax.jit(jax.shard_map(
            lambda s: lax.all_gather(s, axis, axis=0, tiled=True),
            mesh=jmesh, in_specs=P(("y", "x")), out_specs=P(("y", "x")),
            check_vma=False))
        ref = np.asarray(f(x.reshape(-1, 16))).reshape(4, -1, 16)
        got = member_gather(torch.from_numpy(x), axis, mesh)
        np.testing.assert_array_equal(got.numpy(), ref)


class _FakeLib:
    """Stands in for csrc/ring.cu's library: records each launch."""

    def __init__(self):
        self.calls = []

    def gtt_ring_flag_stride(self, n):
        return 1  # the members barrier's one flag, whatever n

    def gtt_ring_max_blocks(self, ref):
        ref._obj.value = 96
        return 0

    def gtt_ring_allreduce(self, *args):
        self.calls.append(("allreduce", args))
        return 0

    def gtt_ring_reduce_scatter(self, *args):
        self.calls.append(("reduce_scatter", args))
        return 0

    def gtt_ring_allgather(self, *args):
        self.calls.append(("allgather", args))
        return 0


def _record_allocations(monkeypatch, allocated):
    """Records the outermost torch allocation calls (the meta device builds
    zeros from empty)."""
    inside = []
    for alloc in ("empty", "empty_like", "zeros", "zeros_like"):
        real = getattr(torch, alloc)

        def record(*args, real=real, alloc=alloc, **kwargs):
            inside.append(alloc)
            try:
                t = real(*args, **kwargs)
            finally:
                inside.pop()
            if not inside:
                allocated.append((alloc, tuple(t.shape), t.dtype))
            return t

        monkeypatch.setattr(torch, alloc, record)


def _fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ring, "_ring_lib", lambda: lib)
    monkeypatch.setattr(ring, "_max_blocks", {})
    monkeypatch.setattr(ring, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return lib


@pytest.mark.parametrize("axes,axis", [({"x": 4}, "x"),
                                       ({"y": 2, "x": 2}, "y"),
                                       ({"y": 2, "x": 2}, "x")])
def test_sum_wrappers_launch_with_members_and_no_buffers(monkeypatch, axes,
                                                          axis):
    """The card's path of B3 and B4a, up to the launch, on meta tensors:
    the only allocations are the output and the zeroed flags (no working
    copy, no comm slots); the kernel gets each rank's ring index and its
    ring's members in ring order, and slices that give each thread
    SUM_UNITS_PER_THREAD units."""
    lib = _fake_card(monkeypatch)
    allocated = []
    _record_allocations(monkeypatch, allocated)
    mesh = make_mesh(axes, devices=["meta"] * 4)
    n = axes[axis]
    rows, cols = n * 512, 256  # chunks of 512 x 256 f32: 32768 16-byte units
    x = torch.ones((4, rows, cols), device="meta")
    units = rows // n * cols // 4
    slices = min(96 // 4, -(-units // (ring.KERNEL_THREADS
                                       * ring.SUM_UNITS_PER_THREAD)))
    stride = lib.gtt_ring_flag_stride(n)
    members = [m for row in mesh.ring_members(axis) for m in row]
    for kind, fn in (("allreduce", ring.ring_allreduce),
                     ("reduce_scatter", ring.ring_reduce_scatter)):
        allocated.clear()
        out = fn(x, axis, mesh)
        out_shape = (4, rows, cols) if kind == "allreduce" else \
            (4, rows // n, cols)
        assert out.shape == out_shape
        assert sorted(allocated) == sorted([
            ("empty_like" if kind == "allreduce" else "empty", out_shape,
             torch.float32),
            ("zeros", (4 * slices * stride,), torch.int32)])
        name, args = lib.calls[-1]
        assert name == kind
        tail = args[-11:]  # flags .. stream
        assert tail[1] == stride
        assert list(tail[2]) == mesh.ring_index(axis)
        assert list(tail[3]) == members
        assert tail[4:10] == (4, n, slices, units, ring.SUM_DTYPES[x.dtype],
                              1)


@pytest.mark.parametrize("axes,axis", [({"x": 4}, "x"),
                                       ({"y": 2, "x": 2}, "x"),
                                       ({"y": 2, "x": 2}, ("x", "y"))])
@pytest.mark.parametrize("rows,cols,dtype,unit", [
    (512, 256, torch.float32, 16), (171, 3, torch.int8, 1)])
def test_gather_wrapper_launches_with_members_and_no_buffers(
        monkeypatch, axes, axis, rows, cols, dtype, unit):
    """The card's path of B4b, up to the launch, on meta tensors: the only
    allocations are the output and the one barrier flag per block (no
    step flags); the kernel gets each rank's ring index and its ring's
    members (no neighbour tables), the unit width and slices that give each
    thread SUM_UNITS_PER_THREAD units."""
    lib = _fake_card(monkeypatch)
    allocated = []
    _record_allocations(monkeypatch, allocated)
    mesh = make_mesh(axes, devices=["meta"] * 4)
    n = mesh.axis_size(axis)
    x = torch.ones((4, rows, cols), dtype=dtype, device="meta")
    allocated.clear()
    chunk = rows * cols * x.element_size()
    units = chunk // unit
    slices = min(96 // 4, -(-units // (ring.KERNEL_THREADS
                                       * ring.SUM_UNITS_PER_THREAD)))
    out = ring.ring_allgather(x, axis, mesh)
    assert out.shape == (4, n * rows, cols) and out.dtype == dtype
    assert sorted(allocated) == sorted([
        ("empty", (4, n * rows, cols), dtype),
        ("zeros", (4 * slices,), torch.int32)])
    name, args = lib.calls[-1]
    assert name == "allgather"
    assert args[1] == chunk and args[3] == n * chunk and args[5] == 1
    assert list(args[6]) == mesh.ring_index(axis)
    assert list(args[7]) == [m for row in mesh.ring_members(axis)
                             for m in row]
    assert args[8:13] == (4, n, slices, units, unit)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", list(ring.SUM_DTYPES), ids=str)
@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_kernels_are_bitwise_the_member_order_on_card(cuda_device, name,
                                                      axes, axis, dtype,
                                                      kind):
    size = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=[cuda_device] * size)
    cpu = make_mesh(axes, devices=["cpu"] * size)
    x = _input(dtype, (size, axes[axis] * 3, 20), seed=size * 10 + 1)
    reduce_scatter, _ = KINDS[kind]
    fn = ring.ring_reduce_scatter if reduce_scatter else ring.ring_allreduce
    want = member_order(x, axis, cpu, reduce_scatter)
    for _ in range(3):
        out = fn(x.to(cuda_device), axis, mesh)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GATHER_DTYPES, ids=str)
@pytest.mark.parametrize("name,axes,axis", GATHER_MESHES,
                         ids=[m[0] for m in GATHER_MESHES])
def test_gather_kernel_is_bitwise_the_model_on_card(cuda_device, name, axes,
                                                    axis, dtype):
    size = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=[cuda_device] * size)
    cpu = make_mesh(axes, devices=["cpu"] * size)
    x = _input(dtype, (size, 3, 20), seed=size + 2)
    want = member_gather(x, axis, cpu)
    for _ in range(3):
        before = ring.ring_allgather.launches
        out = ring.ring_allgather(x.to(cuda_device), axis, mesh)
        torch.cuda.synchronize()
        assert ring.ring_allgather.launches == before + 1
        assert torch.equal(out.cpu(), want)
