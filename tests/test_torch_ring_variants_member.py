"""The member-order passes of csrc/ring_variants.cu's B11, B9 and B10,
proved on the CPU.

On the card, B11 (ring_allreduce_bidir) and B9 (ring_allreduce_hbm) do not
walk the ring: the block that finishes a chunk reads it from every member
of its ring, in the order in which the ring would have added it up, and
writes the sum once into that chunk of every member's output. The models
below are plain versions of those passes with the kernels' indexing, one
add per member in the element type (bf16 rounds after every add):
  - B11: the rank with ring index my sums chunk my + 1 of the left column
    half over members my + 1, my + 2, ..., my + n (B3's order) and chunk
    my - 1 of the right half over members my - 1, my - 2, ..., my - n (the
    mirrored ring's order);
  - B9: the rank with ring index my sums chunk my + 1 in B3's order, tile
    by tile, member by member, as its bulk-copy pipeline feeds the adds;
  - B10: the rank with ring index my walks the chain of chunk my, members
    my, my + 1, ..., my + n - 1, its S slice blocks each folding their
    units' max into the chunk's max at every hop, quantizing the partial
    with it and adding the next member's input (fma); the last partial is
    quantized once more and its decoded values stored into chunk my of
    every member's output. The partial rides in registers, or (the
    out-of-register form) in the rank's own output chunk between hops.

Tolerance: none. The models are held bitwise against the plain twins that
walk the ring step by step and against the interpreted JAX kernels; an
order one member off, or B3's order on B11's right half, gives nearly
equal floats that these comparisons catch. B9's stage ring (K stages, load
i = tile * n + member in stage i mod K, phase i / K) is simulated with the
kernel's counters. The wrappers' launch arguments and allocations are
checked on meta tensors with a fake library. Inputs are made with numpy
from a seed.
"""

import contextlib

import numpy as np
import pytest
import torch

from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.tpu import make_mesh

# (name, mesh axes, ring axis): rings of 2 to 8, and each axis of a 2 x 2
# and a 2 x 4 mesh (flat rank differs from ring index there).
MESHES = [("P2", {"x": 2}, "x"), ("P3", {"x": 3}, "x"), ("P4", {"x": 4}, "x"),
          ("P5", {"x": 5}, "x"), ("P8", {"x": 8}, "x"),
          ("2x2_y", {"y": 2, "x": 2}, "y"), ("2x2_x", {"y": 2, "x": 2}, "x"),
          ("2x4_a", {"a": 2, "b": 4}, "a"), ("2x4_b", {"a": 2, "b": 4}, "b")]
DTYPES = [torch.float32, torch.bfloat16]


def bidir_member_order(x, axis, mesh, right_order=-1):
    """B11's pass in plain PyTorch, block by block as the kernel runs it:
    for each rank and column half d, the chunk it finishes summed over the
    members in its half's order, stored into that chunk's half of every
    member's output. `right_order` is the walk of the right half (-1: the
    mirrored ring's; +1 would be B3's). Checks that every output unit is
    written exactly once."""
    n = mesh.shape[axis]
    ranks, rows, cols = x.shape
    h = cols // 2
    chunks = x.reshape(ranks, n, rows // n, cols)
    out = torch.empty_like(chunks)
    written = torch.zeros((ranks, n, 2), dtype=torch.int64)
    for my, members in zip(mesh.ring_index(axis), mesh.ring_members(axis)):
        for d, step in ((0, 1), (1, right_order)):
            c = (my + step) % n
            half = slice(d * h, (d + 1) * h)
            acc = chunks[members[c], c, :, half]
            for k in range(2, n + 1):
                acc = chunks[members[(my + step * k) % n], c, :, half] + acc
            for m in members:
                out[m, c, :, half] = acc
                written[m, c, d] += 1
    assert bool((written == 1).all()), written
    return out.reshape(ranks, rows, cols)


def hbm_tiles(x, axis, mesh, tile):
    """B9's pass in plain PyTorch: for each rank, chunk my + 1 cut into
    tiles of `tile` elements (the last one short), each tile summed member
    by member in B3's order and stored into every member's output. Checks
    that every output element is written exactly once."""
    n = mesh.shape[axis]
    ranks, rows, cols = x.shape
    chunks = x.reshape(ranks, n, -1)
    elems = chunks.shape[2]
    out = torch.empty_like(chunks)
    written = torch.zeros(chunks.shape, dtype=torch.int64)
    for my, members in zip(mesh.ring_index(axis), mesh.ring_members(axis)):
        c = (my + 1) % n
        for t in range(-(-elems // tile)):
            seg = slice(t * tile, min((t + 1) * tile, elems))
            acc = None
            for k in range(n):
                v = chunks[members[(my + 1 + k) % n], c, seg]
                acc = v if acc is None else v + acc
            for m in members:
                out[m, c, seg] = acc
                written[m, c, seg] += 1
    assert bool((written == 1).all())
    return out.reshape(ranks, rows, cols)


def _input(dtype, shape, seed):
    # Magnitudes spread over six decades, so that the order of the adds
    # shows in the rounding.
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * 10.0 ** rng.uniform(-3, 3, size=shape)
    return torch.from_numpy(x).to(dtype)


def _mesh(axes, device="cpu"):
    return make_mesh(axes, devices=[device] * int(np.prod(list(
        axes.values()))))


# ---- B11 ----

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_bidir_member_order_is_bitwise_the_twin(name, axes, axis, dtype):
    mesh = _mesh(axes)
    n = axes[axis]
    x = _input(dtype, (mesh.size, n * 3, 256), seed=mesh.size * 10 + n)
    got = bidir_member_order(x, axis, mesh)
    want = ring.ring_allreduce_bidir_plain(x, axis, mesh)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n", [3, 8])
def test_b3_order_on_the_right_half_is_caught(n):
    """Only the left half may take B3's order: B3's walk on the right half
    gives nearly equal f32 sums that are not the twin's."""
    mesh = _mesh({"x": n})
    x = _input(torch.float32, (n, n * 3, 256), seed=n)
    want = ring.ring_allreduce_bidir_plain(x, "x", mesh)
    wrong = bidir_member_order(x, "x", mesh, right_order=1)
    assert torch.equal(wrong[..., :128], want[..., :128])
    torch.testing.assert_close(wrong, want, rtol=1e-5, atol=1e-3)
    assert not torch.equal(wrong[..., 128:], want[..., 128:])


def _jax_ring(name, x):
    """gloo_tpu's ring_allreduce_<name> inside shard_map over the first n
    CPU devices, device r holding row r of the world array x (n, rows,
    cols), interpreted as tests/test_pallas_ring.py runs it."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.ops import pallas_ring

    kernel = getattr(pallas_ring, f"ring_allreduce_{name}")
    n = x.shape[0]
    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))
    f = jax.jit(jax.shard_map(lambda s: kernel(s, "x", interpret=True),
                              mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                              check_vma=False))
    return np.asarray(f(x.reshape(-1, x.shape[-1]))).reshape(x.shape)


def _both(dtype, x32):
    """(the port's tensor, JAX's array) of the same f32 values in dtype."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    ours = torch.from_numpy(x32).to(dtype)
    theirs = x32 if dtype == torch.float32 \
        else x32.astype(ml_dtypes.bfloat16)
    return ours, theirs


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_bidir_member_order_is_bitwise_the_jax_kernel(n, dtype):
    x32 = np.random.RandomState(n).randn(n, n * 8, 256).astype(np.float32)
    ours, theirs = _both(dtype, x32)
    ref = _jax_ring("bidir", theirs)
    got = bidir_member_order(ours, "x", _mesh({"x": n}))
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.astype(np.float32))


# ---- B9 ----

# (n, rows per rank, cols, tile in elements): the odd-tile shapes of
# tests/test_pallas_ring.py and chip_smoke's VARIANT_CASES, with tiles that
# leave a short last tile of every chunk.
HBM_CASES = [(2, 528, 128, 4096), (3, 792, 128, 4096), (2, 1040, 128, 4096),
             (4, 32, 128, 384), (8, 64, 128, 96), (3, 24, 128, 160)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,rows,cols,tile", HBM_CASES)
def test_hbm_tiles_are_bitwise_b3(n, rows, cols, tile, dtype):
    mesh = _mesh({"x": n})
    assert (rows // n * cols) % tile, "the case must leave a short tile"
    x = _input(dtype, (n, rows, cols), seed=rows + n)
    got = hbm_tiles(x, "x", mesh, tile)
    assert torch.equal(got, ring.ring_allreduce_plain(x, "x", mesh))


@pytest.mark.parametrize("n,rows,cols,tile", HBM_CASES[:3])
def test_hbm_tiles_are_bitwise_the_jax_kernel(n, rows, cols, tile):
    x32 = np.random.RandomState(rows).randn(n, rows, cols).astype(np.float32)
    ref = _jax_ring("hbm", x32)
    got = hbm_tiles(torch.from_numpy(x32), "x", _mesh({"x": n}), tile)
    np.testing.assert_array_equal(got.numpy(), ref)


def _stage_ring(n, tiles, stages, warps, seed):
    """B9's stage ring run by a random scheduler, with the kernel's own
    counters: the producer loads (tile, member) into stage s, waiting on
    the stage's empty barrier for parity phase ^ 1 once the ring has
    wrapped; each consumer warp waits on the full barrier for parity
    `phase`, reads, and arrives on the empty barrier. A barrier is its
    count of completed phases; a wait for parity P passes once the count's
    parity differs from P. Returns what each warp read, in order."""
    rng = np.random.RandomState(seed)
    full = [0] * stages  # completed phases
    empty = [0] * stages
    arrivals = [0] * stages  # empty arrivals in the current phase
    data = [None] * stages
    loads = [(t, m) for t in range(tiles) for m in range(n)]
    prod = {"i": 0, "s": 0, "phase": 0, "refill": False}
    cons = [{"i": 0, "s": 0, "phase": 0} for _ in range(warps)]
    seen = [[] for _ in range(warps)]

    def producer_step():
        s = prod["s"]
        if prod["refill"] and (empty[s] & 1) == (prod["phase"] ^ 1):
            return False  # the stage's last phase is not yet read
        data[s] = loads[prod["i"]]
        full[s] += 1  # one arrival with its bytes: the phase completes
        prod["i"] += 1
        prod["s"] += 1
        if prod["s"] == stages:
            prod["s"], prod["phase"], prod["refill"] = 0, prod["phase"] ^ 1, \
                True
        return True

    def consumer_step(w):
        c = cons[w]
        s = c["s"]
        if (full[s] & 1) == c["phase"]:
            return False
        seen[w].append(data[s])
        arrivals[s] += 1
        if arrivals[s] == warps:
            arrivals[s] = 0
            empty[s] += 1
        c["i"] += 1
        c["s"] += 1
        if c["s"] == stages:
            c["s"], c["phase"] = 0, c["phase"] ^ 1
        return True

    while prod["i"] < len(loads) or any(c["i"] < len(loads) for c in cons):
        actors = ([None] if prod["i"] < len(loads) else []) + [
            w for w in range(warps) if cons[w]["i"] < len(loads)]
        progressed = False
        for a in rng.permutation(len(actors)):
            actor = actors[a]
            if (producer_step() if actor is None else consumer_step(actor)):
                progressed = True
                break
        assert progressed, "deadlock"
    return loads, seen


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("tiles,stages", [(1, 4), (3, 4), (5, 3), (3, 1),
                                          (7, 5)])
def test_hbm_stage_ring_feeds_every_load_in_order(n, tiles, stages):
    """Where K does not divide n x tiles too, every warp reads every load
    once, in issue order, and the producer never refills a stage that a
    warp has not read."""
    for seed in range(3):
        loads, seen = _stage_ring(n, tiles, stages, warps=8, seed=seed)
        assert all(s == loads for s in seen)


# ---- B10 ----

def q8_chain(x, axis, mesh, slices, stash=False):
    """B10's pass in plain PyTorch, block by block as the kernel runs it:
    for each rank, the chain of chunk my over members my, my + 1, ...,
    my + n - 1, its 16-byte units cut into `slices` slices as the kernel's
    blocks cut them (unevenly where S does not divide them). At each hop
    every slice's max |partial| is folded into the chunk's max, the scale
    is max * f32(1 / 127), and each slice's partial is quantized with it
    and the next member's input added (the twin's f64 sum of one rounding,
    the kernel's fma). The partial stays with its slice, or with `stash`
    is written into the rank's own output chunk after each hop and read
    back at the next (the out-of-register form). The last partial is
    quantized once more and its decoded values are stored into chunk my of
    every member's output. Checks that every output unit is written
    exactly once."""
    n = mesh.axis_size(axis)
    ranks = x.shape[0]
    chunks = x.reshape(ranks, n, -1)
    units = chunks.shape[2] // 4
    out = torch.full_like(chunks, float("nan"))
    written = torch.zeros((ranks, n, units), dtype=torch.int64)
    inv127 = torch.tensor(ring._INV_127, dtype=torch.float32)
    bounds = [(4 * (units * j // slices), 4 * (units * (j + 1) // slices))
              for j in range(slices)]
    for my, members in zip(mesh.ring_index(axis), mesh.ring_members(axis)):
        r = members[my]
        parts = [chunks[r, my, lo:hi].clone() for lo, hi in bounds]
        for k in range(1, n + 1):
            # The cross-block max of this hop, from every slice's own max.
            peak = max(float(p.abs().max()) if p.numel() else 0.0
                       for p in parts)
            scale = torch.tensor(peak, dtype=torch.float32) * inv127
            safe = scale.clamp_min(1e-30)
            codes = [torch.round(p / safe).clamp(-127, 127) for p in parts]
            if k == n:
                break
            nxt = chunks[members[(my + k) % n], my]
            parts = [(nxt[lo:hi].double() + q.double() * scale.double())
                     .float() for q, (lo, hi) in zip(codes, bounds)]
            if stash:
                for p, (lo, hi) in zip(parts, bounds):
                    out[r, my, lo:hi] = p
                parts = [out[r, my, lo:hi].clone() for lo, hi in bounds]
        for q, (lo, hi) in zip(codes, bounds):
            for m in members:
                out[m, my, lo:hi] = q * scale
                written[m, my, lo // 4:hi // 4] += 1
    assert bool((written == 1).all()), written
    return out.reshape(x.shape)


Q8_MESHES = MESHES + [("2x2_yx", {"y": 2, "x": 2}, ("y", "x")),
                      ("2x4_ba", {"a": 2, "b": 4}, ("b", "a"))]


@pytest.mark.parametrize("stash", [False, True], ids=["registers", "memory"])
@pytest.mark.parametrize("name,axes,axis", Q8_MESHES,
                         ids=[m[0] for m in Q8_MESHES])
def test_q8_chain_is_bitwise_the_twin(name, axes, axis, stash):
    mesh = _mesh(axes)
    n = mesh.axis_size(axis)
    x = _input(torch.float32, (mesh.size, n * 32, 128), seed=mesh.size + n)
    want = ring.ring_allreduce_q8_plain(x, axis, mesh)
    for slices in (1, 3, 7):  # 7 cuts the 1024 units of a chunk unevenly
        got = q8_chain(x, axis, mesh, slices, stash)
        assert torch.equal(got, want), slices


@pytest.mark.parametrize("n", [2, 3, 4])
def test_q8_chain_is_bitwise_the_jax_kernel(n):
    x32 = np.random.RandomState(n).randn(n, n * 32, 128).astype(np.float32)
    ref = _jax_ring("q8", x32)
    got = q8_chain(torch.from_numpy(x32), "x", _mesh({"x": n}), 5)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_q8_chain_quantizes_every_hop():
    """The chain quantizes each partial with the max of the whole chunk: a
    model that skipped the hops' quantization (an f32 sum, quantized once
    at the end) gives other values."""
    mesh = _mesh({"x": 4})
    x = _input(torch.float32, (4, 128, 128), seed=9)
    want = ring.ring_allreduce_q8_plain(x, "x", mesh)
    chunks = x.reshape(4, 4, -1)
    total = chunks.sum(0)  # each chunk's sum, ring order aside
    q, scale = ring._quantize(total)
    assert not torch.equal((q * scale[:, None]).reshape(1, 128, 128)
                           .expand(4, -1, -1), want)


# ---- the wrappers' launches, on meta tensors ----

class _FakeLib:
    """Stands in for csrc/ring_variants.cu's library: records each launch
    and each occupancy query."""

    def __init__(self):
        self.calls, self.queries = [], []

    def gtt_ring_variants_flag_stride(self, n):
        return 8

    def gtt_ring_variants_max_blocks(self, variant, tile, stages, ref):
        self.queries.append((variant, tile, stages))
        ref._obj.value = 96
        return 0

    def gtt_ring_allreduce_hbm(self, *args):
        self.calls.append(("hbm", args))
        return 0

    def gtt_ring_allreduce_bidir(self, *args):
        self.calls.append(("bidir", args))
        return 0

    def gtt_ring_allreduce_q8(self, *args):
        self.calls.append(("q8", args))
        return 0


@pytest.mark.parametrize("axes,axis", [({"x": 4}, "x"),
                                       ({"y": 2, "x": 2}, "y"),
                                       ({"y": 2, "x": 2}, "x")])
def test_hbm_and_bidir_launch_with_members_and_no_buffers(monkeypatch, axes,
                                                          axis):
    """The card's path of B9 and B11, up to the launch: the only
    allocations are the output and the zeroed flags (no comm slots, no
    working copy); the kernel gets each rank's ring index and its ring's
    members in ring order; B9 its tile and stages, and slices from its own
    occupancy query."""
    lib = _FakeLib()
    monkeypatch.setattr(ring, "_variants_lib", lambda: lib)
    monkeypatch.setattr(ring, "_var_max_blocks", {})
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
    mesh = make_mesh(axes, devices=["meta"] * 4)
    n = axes[axis]
    rows, cols = n * 512, 256  # chunks of 512 x 256 f32: 32768 16-byte units
    x = torch.ones((4, rows, cols), device="meta")
    units = rows // n * cols // 4
    stride = lib.gtt_ring_variants_flag_stride(n)
    members = [m for row in mesh.ring_members(axis) for m in row]
    my = mesh.ring_index(axis)
    tiles = -(-units * 16 // ring.HBM_TILE_BYTES)
    half_units = cols // 2 * 4 // 16
    bidir_slices = min(96 // 8, -(-rows // n * half_units // (
        ring.KERNEL_THREADS * ring.SUM_UNITS_PER_THREAD)))
    for kind, fn, slices, sets in (
            ("hbm", ring.ring_allreduce_hbm, min(96 // 4, tiles), 1),
            ("bidir", ring.ring_allreduce_bidir, bidir_slices, 2)):
        allocated.clear()
        out = fn(x, axis, mesh)
        assert out.shape == x.shape
        assert sorted(allocated) == sorted([
            ("empty_like", tuple(x.shape), torch.float32),
            ("zeros", (4 * sets * slices * stride,), torch.int32)])
        name, args = lib.calls[-1]
        assert name == kind
        assert args[2] == rows * cols * 4  # each rank's stride in bytes
        assert args[4] == stride
        assert list(args[5]) == my and list(args[6]) == members
        assert args[7:10] == (4, n, slices)
        if kind == "hbm":
            assert args[10:14] == (units, ring.HBM_TILE_BYTES,
                                   ring.HBM_STAGES, 1)
        else:
            assert args[10:13] == (rows // n, half_units, 1)
    assert lib.queries == [(0, ring.HBM_TILE_BYTES, ring.HBM_STAGES),
                           (2, 0, 0)]


@pytest.mark.parametrize("axes,axis", [({"x": 4}, "x"),
                                       ({"y": 2, "x": 2}, "x"),
                                       ({"y": 2, "x": 2}, ("y", "x"))])
def test_q8_launches_with_members_and_no_wire(monkeypatch, axes, axis):
    """B10's path on the card, up to the launch: the only allocations are
    the output and the zeroed flags with the chains' cells after them (no
    wire, no scales); the kernel gets each rank's ring index and its
    ring's members; the register form while the resident grid holds the
    chunk at Q8_REGISTER_UNITS units a thread (the fake card: 96 blocks,
    24 per rank of 4, 49152 units), past it the out-of-register form on
    its own occupancy query."""
    lib = _FakeLib()
    monkeypatch.setattr(ring, "_variants_lib", lambda: lib)
    monkeypatch.setattr(ring, "_var_max_blocks", {})
    monkeypatch.setattr(ring, "_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    allocated = []
    for alloc in ("empty", "empty_like", "zeros", "zeros_like"):
        real = getattr(torch, alloc)

        def record(*args, real=real, alloc=alloc, **kwargs):
            t = real(*args, **kwargs)
            allocated.append((alloc, tuple(t.shape), t.dtype))
            return t

        monkeypatch.setattr(torch, alloc, record)
    mesh = make_mesh(axes, devices=["meta"] * 4)
    n = mesh.axis_size(axis)
    members = [m for row in mesh.ring_members(axis) for m in row]
    capacity = 96 // 4 * ring.KERNEL_THREADS * ring.Q8_REGISTER_UNITS
    for chunk_rows, form in ((512, 1), (1024, 0)):
        rows, cols = n * chunk_rows, 256
        units = chunk_rows * cols // 4
        assert (units <= capacity) == bool(form)
        x = torch.ones((4, rows, cols), device="meta")
        allocated.clear()
        out = ring.ring_allreduce_q8(x, axis, mesh)
        assert out.shape == x.shape
        slices = min(96 // 4, -(-units // ring.KERNEL_THREADS))
        # The meta device may build zeros from empty: the outer calls.
        assert ("empty_like", tuple(x.shape), torch.float32) in allocated
        assert ("zeros", (4 * slices * 8 + 2 * n * 4,), torch.int32) \
            in allocated
        assert not [a for a in allocated if a[2] == torch.int8]
        name, args = lib.calls[-1]
        assert name == "q8"
        assert args[2] == rows * cols * 4  # each rank's stride in bytes
        assert args[4] == 8
        assert list(args[5]) == mesh.ring_index(axis)
        assert list(args[6]) == members
        assert args[7:12] == (4, n, slices, units, form)
    assert lib.queries == [(1, 0, 0), (3, 0, 0)]


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the variant kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,axes,axis", MESHES, ids=[m[0] for m in MESHES])
def test_bidir_is_bitwise_the_member_order_on_card(cuda_device, name, axes,
                                                   axis, dtype):
    mesh = _mesh(axes, cuda_device)
    n = axes[axis]
    x = _input(dtype, (mesh.size, n * 24, 512), seed=mesh.size * 10 + 1)
    want = bidir_member_order(x, axis, _mesh(axes))
    for _ in range(3):
        out = ring.ring_allreduce_bidir(x.to(cuda_device), axis, mesh)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,stages", [(8192, 1), (8192, 3), (16384, 4),
                                         (32768, 2)])
@pytest.mark.parametrize("n,rows,cols", [(2, 528, 128), (3, 792, 128),
                                         (8, 2056, 128)])
def test_hbm_stages_and_tiles_on_card(cuda_device, monkeypatch, n, rows,
                                      cols, tile, stages):
    """B9 at each tile and stage count bitwise B3's twin, three times, where
    the stages do not divide n x tiles."""
    monkeypatch.setattr(ring, "HBM_TILE_BYTES", tile)
    monkeypatch.setattr(ring, "HBM_STAGES", stages)
    mesh = _mesh({"x": n}, cuda_device)
    x = _input(torch.float32, (n, rows, cols), seed=rows)
    want = ring.ring_allreduce_plain(x, "x", _mesh({"x": n}))
    for _ in range(3):
        out = ring.ring_allreduce_hbm(x.to(cuda_device), "x", mesh)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["registers", "memory"])
@pytest.mark.parametrize("name,axes,axis", Q8_MESHES,
                         ids=[m[0] for m in Q8_MESHES])
def test_q8_is_bitwise_the_twin_on_card(cuda_device, monkeypatch, name, axes,
                                        axis, form):
    """B10 in each form (the out-of-register one forced) bitwise its twin,
    three calls in a row, at chunks of 96 rows of 256 f32."""
    if form == "memory":
        monkeypatch.setattr(ring, "q8_in_registers", lambda *args: False)
    mesh = _mesh(axes, cuda_device)
    n = mesh.axis_size(axis)
    x = _input(torch.float32, (mesh.size, n * 96, 256), seed=mesh.size + 3)
    want = ring.ring_allreduce_q8_plain(x, axis, _mesh(axes))
    for _ in range(3):
        out = ring.ring_allreduce_q8(x.to(cuda_device), axis, mesh)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)
