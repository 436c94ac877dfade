"""The one-pass pull of csrc/alltoall.cu's B8 over strided blocks, proved on
the CPU.

On the card, B8 does not walk the TPU kernel's push schedule: block (r, s)
of the launch plays rank r on slice s of its block positions and, for each,
loads the unit from block my[r] of every ring member's input and stores it
into block k of rank r's own output. A block is a strided slab of each
rank's local value (lax.all_to_all's split and concat axes): rows of
`in_run` bytes on the input, rows of `out_run` bytes on the output, copied
in runs of gcd(in_run, out_run) bytes whose offsets are computed once per
run. `pull_pass` below is a plain model of that pass with the kernel's
indexing (ring.alltoall_plan's numbers, the kernel's slices and run
offsets); it also checks that every output unit is written exactly once.

The model is held bitwise (tolerance: none; an all-to-all moves bytes)
against the plain twin, the interpreted JAX kernel and lax.all_to_all, so
the kernel's offsets are proved here before the card runs them. The
wrappers are checked up to the launch on meta tensors with a fake library.
Inputs are made with numpy from a seed.
"""

import contextlib
import itertools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.ops import pallas_alltoall  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu.tpu import spmd as jax_spmd  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh, spmd  # noqa: E402

# (name, mesh axes, ring axis): rings of 2 to 8, and each axis of a 2 x 2
# mesh (flat rank differs from ring index there).
MESHES = [("P2", {"x": 2}, "x"), ("P3", {"x": 3}, "x"), ("P4", {"x": 4}, "x"),
          ("P8", {"x": 8}, "x"), ("2x2_a", {"a": 2, "b": 2}, "a"),
          ("2x2_b", {"a": 2, "b": 2}, "b")]


def _cpu_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * math.prod(axes.values()))


def pull_pass(x, axis, mesh, split=0, concat=0, slices=3):
    """B8's pass in plain PyTorch, block by block of the launch's (rank,
    slice) grid, over the bytes of x (P, *local)."""
    n = mesh.shape[axis]
    ranks, local = x.shape[0], tuple(x.shape[1:])
    plan = ring.alltoall_plan(local, x.element_size(), n, split, concat, 0)
    unit, run = plan.unit, plan.run // plan.unit
    runs = plan.block // plan.run
    in_runs, out_runs = plan.in_run // plan.run, plan.out_run // plan.run
    in_pitch, out_pitch = plan.in_pitch // unit, plan.out_pitch // unit
    in_block, out_block = plan.in_run // unit, plan.out_run // unit
    src_units = x.contiguous().view(torch.uint8).reshape(ranks, -1, unit)
    out = torch.zeros_like(src_units)
    written = torch.zeros(out.shape[:2], dtype=torch.int64)
    for r, (my, members) in enumerate(zip(mesh.ring_index(axis),
                                          mesh.ring_members(axis))):
        for s in range(slices):
            if plan.group == ring.ALLTOALL_THREADS:
                total = runs * run
                lo, hi = total * s // slices, total * (s + 1) // slices
                spans = [(j, max(lo - j * run, 0), min(hi - j * run, run))
                         for j in range(lo // run, runs) if j * run < hi]
            else:
                spans = [(j, 0, run) for j in range(runs * s // slices,
                                                    runs * (s + 1) // slices)]
            for j, w0, w1 in spans:
                src = (j // in_runs * in_pitch + my * in_block
                       + j % in_runs * run)
                dst = j // out_runs * out_pitch + j % out_runs * run
                for k, m in enumerate(members):
                    at = dst + k * out_block
                    out[r, at + w0:at + w1] = src_units[m, src + w0:src + w1]
                    written[r, at + w0:at + w1] += 1
    assert bool((written == 1).all()), written
    return out.reshape(ranks, -1).view(x.dtype).reshape(ranks,
                                                        *plan.out_local)


def _input(dtype, shape, seed):
    x = np.random.RandomState(seed).randint(-1000, 1000, shape)
    return torch.from_numpy(x).to(dtype)


def _jax_world(fn, x, shape, names):
    """fn inside shard_map, each device one row of the world array x (P,
    rows, cols), the devices arranged as `shape` with axes `names`."""
    size = int(np.prod(shape))
    mesh = JaxMesh(np.asarray(jax.devices()[:size], dtype=object).reshape(
        shape), names)
    spec = P(names if len(names) > 1 else names[0])
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                              check_vma=False))
    return np.asarray(f(x.reshape(-1, x.shape[-1]))).reshape(x.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_pull_pass_is_bitwise_the_twin(name, axes, axis, dtype):
    size = math.prod(axes.values())
    n = axes[axis]
    mesh = _cpu_mesh(axes)
    x = _input(dtype, (size, 3 * n, 20), seed=size + n)
    want = ring.alltoall_plain(x, axis, mesh)
    for slices in (1, 3, 7):
        assert torch.equal(pull_pass(x, axis, mesh, slices=slices), want)
    assert torch.equal(ring.alltoall(x, axis, mesh), want)


@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_pull_pass_is_bitwise_the_jax_kernel(name, axes, axis):
    size = math.prod(axes.values())
    n = axes[axis]
    x = np.random.RandomState(size * 3 + n).randn(size, 2 * n, 128).astype(
        np.float32)
    names = tuple(axes)
    ref = _jax_world(
        lambda s: pallas_alltoall(s, axis, interpret=True, mesh_axes=names),
        x, tuple(axes.values()), names)
    got = pull_pass(torch.from_numpy(x), axis, _cpu_mesh(axes), slices=5)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_a_ring_one_member_off_is_caught():
    # The pass must take block k from member k, not from its neighbour.
    mesh = _cpu_mesh({"x": 4})
    x = _input(torch.int32, (4, 8, 6), seed=1)
    want = ring.alltoall_plain(x, "x", mesh)
    rows = mesh.ring_members("x")
    off = _cpu_mesh({"x": 4})
    off.ring_members = lambda axis: [row[1:] + row[:1] for row in rows]
    assert not torch.equal(pull_pass(x, "x", off), want)


LOCALS = [(4, 8, 12), (4, 4, 8, 4)]
PAIRS = [(local, s, c) for local in LOCALS
         for s, c in itertools.product(range(len(local)), repeat=2)]


def _lax_all_to_all(x, split, concat):
    mesh = jax_make_mesh({"seq": 4}, devices=jax.devices()[:4])
    f = jax.jit(jax.shard_map(
        lambda s: jax_spmd.alltoall(s[0], "seq", split_axis=split,
                                    concat_axis=concat)[None],
        mesh=mesh, in_specs=P("seq"), out_specs=P("seq")))
    return np.asarray(f(x))


@pytest.mark.parametrize("local,split,concat", PAIRS,
                         ids=[f"{len(p[0])}d_s{p[1]}_c{p[2]}" for p in PAIRS])
def test_strided_pass_matches_lax_all_to_all(local, split, concat):
    """Every (split, concat) pair of 3-D and 4-D locals; (1, 2) and (2, 1)
    of the 4-D local are Ulysses' two exchanges."""
    x = np.random.RandomState(len(local) * 10 + split * 3 + concat).randn(
        4, *local).astype(np.float32)
    want = _lax_all_to_all(x, split, concat)
    mesh = _cpu_mesh({"seq": 4})
    xt = torch.from_numpy(x)
    got = spmd.alltoall(xt, "seq", split_axis=split, concat_axis=concat,
                        mesh=mesh)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    model = pull_pass(xt, "seq", mesh, split, concat, slices=3)
    np.testing.assert_array_equal(model.numpy(), want)


@pytest.mark.parametrize("split,concat", [(1, 2), (2, 1), (0, 2), (2, 0)])
def test_vjp_with_split_and_concat_apart_matches_jax_grad(split, concat):
    local = (4, 4, 8, 4)
    x = np.random.RandomState(split * 5 + concat).randn(4, *local).astype(
        np.float32)
    out_shape = list(local)
    out_shape[split] //= 4
    out_shape[concat] *= 4
    w = np.random.RandomState(11).randn(4, *out_shape).astype(np.float32)
    mesh = jax_make_mesh({"seq": 4}, devices=jax.devices()[:4])

    def loss(x):
        f = jax.shard_map(
            lambda s, ww: jnp.sum(jax_spmd.alltoall(
                s[0], "seq", split_axis=split, concat_axis=concat)
                * ww[0])[None],
            mesh=mesh, in_specs=(P("seq"), P("seq")), out_specs=P("seq"))
        return jnp.sum(f(x, w))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    leaf = torch.from_numpy(x.copy()).requires_grad_()
    y = spmd.alltoall(leaf, "seq", split_axis=split, concat_axis=concat,
                      mesh=_cpu_mesh({"seq": 4}))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), ref)


def test_zero_size_split_gives_an_empty_result():
    mesh = _cpu_mesh({"seq": 4})
    x = torch.zeros((4, 0, 8))
    out = spmd.alltoall(x, "seq", split_axis=0, concat_axis=1, mesh=mesh)
    assert tuple(out.shape) == (4, 0, 32)


# ---- the wrapper up to the launch ----

class _FakeLib:
    """Stands in for csrc/alltoall.cu's library: records each launch."""

    def __init__(self):
        self.calls = []

    def gtt_alltoall_flag_stride(self):
        return 1

    def gtt_alltoall_max_blocks(self, ref):
        ref._obj.value = 1024
        return 0

    def gtt_alltoall(self, *args):
        self.calls.append(args)
        return 0


# (name, mesh axes, ring axis, world shape, dtype, split, concat, run
# bytes, unit, group, slices).
WRAPPER_CASES = [
    # Ulysses' exchanges at the long-context path: (b, h, t_local, d) =
    # (2, 4, 1024, 64) bf16 per rank; runs of 128 KiB, 32 slices of 512
    # threads' worth of 2 16-byte units.
    ("ulysses_in", {"seq": 4}, "seq", (4, 2, 4, 1024, 64), torch.bfloat16,
     1, 2, 131072, 16, 256, 32),
    ("ulysses_out", {"seq": 4}, "seq", (4, 2, 1, 4096, 64), torch.bfloat16,
     2, 1, 131072, 16, 256, 32),
    # The MoE exchange: one run per block.
    ("ep", {"expert": 4}, "expert", (4, 4, 64, 256), torch.bfloat16,
     0, 0, 32768, 16, 256, 4),
    # int32 blocks of odd width: 3 x 5 elements, one 60-byte run.
    ("int32_odd", {"x": 3}, "x", (3, 9, 5), torch.int32, 0, 0, 60, 4, 8, 1),
    # bf16 runs of 6 bytes: 2-byte units, 3 to a run, 2 threads a run.
    ("bf16_2byte", {"x": 2}, "x", (2, 3, 6), torch.bfloat16, 1, 0, 6, 2, 2,
     1),
    # A non-leading split along each axis of a 2 x 2 mesh.
    ("2x2_a", {"a": 2, "b": 2}, "a", (4, 6, 8, 4), torch.float32, 1, 0, 64,
     16, 4, 1),
    ("2x2_b", {"a": 2, "b": 2}, "b", (4, 6, 8, 4), torch.float32, 2, 1, 8, 8,
     1, 1),
]


@pytest.mark.parametrize("case", WRAPPER_CASES,
                         ids=[c[0] for c in WRAPPER_CASES])
def test_wrapper_launches_once_on_x_as_it_lies(monkeypatch, case):
    """The card's path of B8 (spmd.alltoall), up to the launch, on meta
    tensors: exactly one launch, x's own data_ptr, the output already in
    its final shape and the zeroed flags the only allocations; the run,
    unit, group and slices as designed."""
    name, axes, axis, shape, dtype, split, concat, run, unit, group, \
        slices = case
    lib = _FakeLib()
    monkeypatch.setattr(ring, "_alltoall_lib", lambda: lib)
    monkeypatch.setattr(ring, "_a2a_max_blocks", {})
    monkeypatch.setattr(ring, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    allocated, inside = [], []
    for alloc in ("empty", "empty_like", "zeros", "zeros_like"):
        real = getattr(torch, alloc)

        def record(*args, real=real, alloc=alloc, **kwargs):
            # The meta device builds zeros from empty: count the outer call.
            inside.append(alloc)
            try:
                t = real(*args, **kwargs)
            finally:
                inside.pop()
            if not inside:
                allocated.append((alloc, tuple(t.shape), t.dtype))
            return t

        monkeypatch.setattr(torch, alloc, record)
    size = math.prod(axes.values())
    n = axes[axis]
    mesh = make_mesh(axes, devices=["meta"] * size)
    x = torch.ones(shape, dtype=dtype, device="meta")
    before = ring.alltoall.launches
    allocated.clear()
    out = spmd.alltoall(x, axis, split_axis=split, concat_axis=concat,
                        mesh=mesh)
    assert ring.alltoall.launches == before + 1 and len(lib.calls) == 1
    local = list(shape[1:])
    local[split] //= n
    local[concat] *= n
    assert tuple(out.shape) == (size, *local)
    assert allocated == [("empty", (size, *local), dtype),
                         ("zeros", (size * slices,), torch.int32)]
    args = lib.calls[0]
    elt = x.element_size()
    rank_bytes = math.prod(shape[1:]) * elt
    assert args[0] == x.data_ptr() and args[2] == out.data_ptr()
    assert (args[1], args[3], args[5]) == (rank_bytes, rank_bytes, 1)
    assert list(args[6]) == mesh.ring_index(axis)
    assert list(args[7]) == [m for row in mesh.ring_members(axis)
                             for m in row]
    assert args[8:11] == (size, n, slices)
    in_run = shape[1 + split] // n * math.prod(shape[2 + split:]) * elt
    out_run = local[concat] // n * math.prod(local[concat + 1:]) * elt
    assert args[11:19] == (rank_bytes // n, in_run, n * in_run, out_run,
                           n * out_run, run, unit, group)
    assert math.gcd(in_run, out_run) == run


def test_zero_size_and_ring_of_one_launch_nothing(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ring, "_alltoall_lib", lambda: lib)
    mesh = make_mesh({"x": 4}, devices=["meta"] * 4)
    x = torch.ones((4, 0, 8), device="meta")
    out = spmd.alltoall(x, "x", split_axis=0, concat_axis=1, mesh=mesh)
    assert tuple(out.shape) == (4, 0, 32) and not lib.calls
    one = make_mesh({"x": 4, "one": 1}, devices=["meta"] * 4)
    y = torch.ones((4, 8, 8), device="meta")
    assert ring.alltoall(y, "one", one, 1, 0) is y and not lib.calls


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the all-to-all kernel has no CPU "
                    "mode")
    return torch.device("cuda")


# (mesh axes, ring axis, world shape, dtype, split, concat).
CARD_CASES = [
    ({"seq": 4}, "seq", (4, 2, 4, 256, 64), torch.bfloat16, 1, 2),
    ({"seq": 4}, "seq", (4, 2, 1, 1024, 64), torch.bfloat16, 2, 1),
    ({"a": 2, "b": 2}, "a", (4, 6, 8, 4), torch.float32, 1, 0),
    ({"a": 2, "b": 2}, "b", (4, 6, 8, 4), torch.float32, 2, 1),
    ({"x": 3}, "x", (3, 9, 5), torch.int32, 0, 0),
    ({"x": 3}, "x", (3, 4, 9, 5), torch.int32, 1, 2),
    ({"x": 2}, "x", (2, 3, 6), torch.bfloat16, 1, 0),
    ({"x": 8}, "x", (8, 16, 3, 40), torch.float32, 0, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("axes,axis,shape,dtype,split,concat", CARD_CASES)
def test_kernel_is_bitwise_the_pull_pass_on_card(cuda_device, axes, axis,
                                                 shape, dtype, split, concat):
    size = math.prod(axes.values())
    mesh = make_mesh(axes, devices=[cuda_device] * size)
    cpu = _cpu_mesh(axes)
    x = _input(dtype, shape, seed=sum(shape))
    want = pull_pass(x, axis, cpu, split, concat)
    assert torch.equal(want, ring.alltoall_plain(x, axis, cpu, split, concat))
    for _ in range(3):
        before = ring.alltoall.launches
        out = ring.alltoall(x.to(cuda_device), axis, mesh, split, concat)
        torch.cuda.synchronize()
        assert ring.alltoall.launches == before + 1
        assert torch.equal(out.cpu(), want)
