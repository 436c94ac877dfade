"""The ring allreduce variants of gloo_tpu_torch.ops.ring against
gloo_tpu.ops.pallas_ring: ring_allreduce_hbm (B9), ring_allreduce_q8 (B10)
and ring_allreduce_bidir (B11).

On the CPU the port runs its plain twins; they are held against the JAX
Pallas kernels run as tests/test_pallas_ring.py runs them (shard_map over
the first n CPU devices, interpret=True) on numpy inputs from a seed.

Tolerance: none. B9 and B11 add in B3's order (B11's right half on the
mirrored ring), one add per step in the input dtype, at every dtype of
ring.SUM_DTYPES (f64 and int64, which the reference cannot take with jax's
x64 off, against B3's twin and numpy's fold in member order). B10 is
bitwise too: the interpreted reference computes its scale as max|chunk| *
f32(1/127) (XLA's form of max / 127), divides by the scale truly, and
accumulates o + q * scale with one rounding (an fma); the twin does the
same, the fma as an f64 product and sum cast once to f32.

The dry run's shapes at n = 8 are held to their closed forms on the twins
alone (the interpreter at n = 8 is slow). Tests marked `cuda` hold each
kernel against its twin on the card, bitwise, and skip without one.
"""

import numpy as np
import pytest
import torch

from gloo_tpu_torch.entry import DDP_WORLD, ring_variants_entry
from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.tpu import make_mesh

VARIANTS = {"hbm": ring.ring_allreduce_hbm, "q8": ring.ring_allreduce_q8,
            "bidir": ring.ring_allreduce_bidir}
PLAIN = {"hbm": ring.ring_allreduce_hbm_plain,
         "q8": ring.ring_allreduce_q8_plain,
         "bidir": ring.ring_allreduce_bidir_plain}


def _jax():
    return pytest.importorskip("jax")


def _jax_kernel(name):
    _jax()
    from gloo_tpu.ops import pallas_ring

    return getattr(pallas_ring, f"ring_allreduce_{name}")


def _jax_ring(kernel, x):
    """kernel inside shard_map over the first n devices, device r holding
    row r of the world array x (n, rows, cols)."""
    jax = _jax()
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    n = x.shape[0]
    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))
    f = jax.jit(jax.shard_map(lambda s: kernel(s, "x", interpret=True),
                              mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                              check_vma=False))
    return np.asarray(f(x.reshape(-1, x.shape[-1]))).reshape(x.shape)


def _cpu_mesh(n):
    return make_mesh({"x": n}, devices=["cpu"] * n)


def _ours(name, x):
    return VARIANTS[name](torch.from_numpy(x), "x", _cpu_mesh(x.shape[0]))


# ---- each twin against its interpreted JAX kernel, bitwise ----

@pytest.mark.parametrize("n,per_rows", [
    (2, 16), (3, 24), (2, 1024), (4, 32), (2, 528), (3, 792), (2, 1040)])
def test_hbm_matches_jax_kernel(n, per_rows):
    x = np.random.RandomState(per_rows).randn(n, per_rows, 128).astype(
        np.float32)
    ref = _jax_ring(_jax_kernel("hbm"), x)
    np.testing.assert_array_equal(_ours("hbm", x).numpy(), ref)


@pytest.mark.parametrize("name,cols", [("hbm", 128), ("bidir", 256)])
def test_bf16_matches_jax_kernel(name, cols):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    n = 4
    x = np.random.RandomState(9).randn(n, n * 16, cols).astype(
        ml_dtypes.bfloat16)
    ref = _jax_ring(_jax_kernel(name), x)
    out = VARIANTS[name](torch.from_numpy(x.astype(np.float32)).bfloat16(),
                         "x", _cpu_mesh(n))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_q8_matches_jax_kernel(n, seed):
    x = np.random.RandomState(seed).randn(n, n * 32, 128).astype(np.float32)
    ref = _jax_ring(_jax_kernel("q8"), x)
    out = _ours("q8", x).numpy()
    np.testing.assert_array_equal(out, ref)
    for r in range(1, n):
        np.testing.assert_array_equal(out[r], out[0])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_bidir_matches_jax_kernel(n):
    x = np.random.RandomState(n).randn(n, n * 8, 256).astype(np.float32)
    ref = _jax_ring(_jax_kernel("bidir"), x)
    np.testing.assert_array_equal(_ours("bidir", x).numpy(), ref)


# ---- against B3's twin ----

@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_hbm_is_b3(n):
    x = torch.from_numpy(np.random.RandomState(n).randn(
        n, n * 8, 128).astype(np.float32))
    mesh = _cpu_mesh(n)
    assert torch.equal(ring.ring_allreduce_hbm(x, "x", mesh),
                       ring.ring_allreduce_plain(x, "x", mesh))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_bidir_halves_are_b3_on_each_direction(n):
    """The left half is B3 on the ring; the right half is B3 on the reversed
    ring (rank r at ring index -r) with chunk c' standing for chunk -c'."""
    rows, cols, h = n * 4, 256, 128
    x = torch.from_numpy(np.random.RandomState(n).randn(
        n, rows, cols).astype(np.float32))
    mesh = _cpu_mesh(n)
    out = ring.ring_allreduce_bidir(x, "x", mesh)
    assert torch.equal(out[..., :h],
                       ring.ring_allreduce_plain(x[..., :h].contiguous(),
                                                 "x", mesh))
    mirror = (-torch.arange(n)) % n  # an involution on ranks and chunks
    right = x[..., h:].reshape(n, n, rows // n, h)
    walked = ring.ring_allreduce_plain(
        right[mirror][:, mirror].reshape(n, rows, h), "x", mesh)
    back = walked.reshape(n, n, rows // n, h)[mirror][:, mirror]
    assert torch.equal(out[..., h:], back.reshape(n, rows, h))


# ---- the dry run's last section at n = 8, on the twins ----

def test_dry_run_section_at_n8():
    """__graft_entry__.py:340-373: q8 at (8, 256, 128), bidir at (8, 64,
    256), hbm at (8, 64, 128), drawn in that order from RandomState(7);
    q8 within rel 0.05 of the sum and bitwise equal on every rank, the
    others within the dry run's rtol 1e-5 plus an atol of 2e-6: the ring
    adds in another order than numpy's sum, and a sum near zero of 8
    values of size ~3 misses rtol alone by a few f32 roundings (4.1e-7)."""
    n = 8
    rng = np.random.RandomState(7)
    mesh = _cpu_mesh(n)
    for name, per, cols, lossy in (("q8", n * 32, 128, True),
                                   ("bidir", n * 8, 256, False),
                                   ("hbm", n * 8, 128, False)):
        xs = rng.randn(n, per, cols).astype(np.float32)
        out = VARIANTS[name](torch.from_numpy(xs), "x", mesh).numpy()
        expected = xs.sum(axis=0)
        if lossy:
            rel = np.abs(out[0] - expected).max() / np.abs(expected).max()
            assert rel < 0.05, rel
            for i in range(1, n):
                np.testing.assert_array_equal(out[i], out[0])
        else:
            for i in range(n):
                np.testing.assert_allclose(out[i], expected, rtol=1e-5,
                                           atol=2e-6)


# ---- the VJPs against jax.grad ----

@pytest.mark.parametrize("name,cols", [("hbm", 128), ("q8", 128),
                                       ("bidir", 256)])
def test_vjp_matches_jax_grad(name, cols):
    """Port of test_pallas_ring.py::test_ring_allreduce_grad for each
    variant: the VJP of the allreduce is the same allreduce of the
    cotangent (for q8 the straight-through estimator)."""
    jax = _jax()
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    kernel = _jax_kernel(name)
    n, per = 4, 4 * 32
    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))

    def loss(x):
        y = jax.shard_map(lambda s: kernel(s, "x", interpret=True),
                          mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                          check_vma=False)(x)
        return (y ** 2).sum()

    x = np.linspace(-1, 1, n * per * cols).astype(np.float32).reshape(
        n * per, cols)
    ref = np.asarray(jax.jit(jax.grad(loss))(x)).reshape(n, per, cols)
    leaf = torch.from_numpy(x.reshape(n, per, cols).copy()).requires_grad_()
    y = VARIANTS[name](leaf, "x", _cpu_mesh(n))
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), ref)


# ---- what the wrappers take ----

def test_ring_of_one_returns_x():
    one = make_mesh({"x": 4, "one": 1}, devices=["cpu"] * 4)
    x = torch.zeros((4, 8, 256))
    for fn in VARIANTS.values():
        assert fn(x, "one", one) is x
    # JAX's q8 and bidir return x before any shape check; so do the port's.
    assert ring.ring_allreduce_q8(torch.zeros((4, 3, 5)), "one", one) \
        .shape == (4, 3, 5)
    assert ring.ring_allreduce_bidir(torch.zeros((4, 3, 5)), "one", one) \
        .shape == (4, 3, 5)


@pytest.mark.parametrize("name,shape,dtype,error", [
    ("q8", (4, 128, 128), np.float16, TypeError),   # not f32
    ("q8", (4, 64, 128), np.float32, ValueError),   # chunk rows 16 % 32
    ("q8", (4, 130, 128), np.float32, ValueError),  # rows % n
    ("bidir", (4, 32, 128), np.float32, ValueError),  # cols % 256
    ("bidir", (4, 30, 256), np.float32, ValueError),  # rows % n
    ("hbm", (4, 30, 128), np.float32, ValueError),    # rows % n
])
def test_wrappers_reject_what_jax_rejects(name, shape, dtype, error):
    x = np.zeros(shape, dtype)
    with pytest.raises(error):
        VARIANTS[name](torch.from_numpy(x), "x", _cpu_mesh(shape[0]))
    with pytest.raises(AssertionError):
        _jax_ring(_jax_kernel(name), x)


# ---- B9 and B11 at every sum dtype ----

# The dtypes of ring.SUM_DTYPES that the interpreted JAX kernels take here
# (jax's x64 is off, so not f64 and int64), by their torch dtype.
JAX_SUM_TYPES = {torch.bfloat16: "bfloat16", torch.float16: np.float16,
                 torch.float32: np.float32, torch.int8: np.int8,
                 torch.uint8: np.uint8, torch.int16: np.int16,
                 torch.uint16: np.uint16, torch.int32: np.int32,
                 torch.uint32: np.uint32}
COLS = {"hbm": 128, "bidir": 256}


def _sum_input(np_dtype, shape, seed):
    """Values that round (floats, at many magnitudes) or wrap (integers,
    over the whole range of the type) when summed."""
    rng = np.random.RandomState(seed)
    if np_dtype == "bfloat16":
        import ml_dtypes

        return (rng.randn(*shape) * 64).astype(ml_dtypes.bfloat16)
    if np.issubdtype(np_dtype, np.floating):
        return (rng.randn(*shape) * 10.0 ** rng.randint(-2, 3, shape)) \
            .astype(np_dtype)
    info = np.iinfo(np_dtype)
    return rng.randint(info.min, info.max, shape, dtype=np.int64) \
        .astype(np_dtype)


def _member_order_sum(x, direction):
    """numpy's model of the member-order fold, x (n, rows, cols): chunk c
    is in_c[c], then + in_{c+1}[c], + in_{c+2}[c], ... in B3's order
    (direction 1) or + in_{c-1}[c], + in_{c-2}[c], ... in the mirrored
    ring's (direction -1); every rank holds the whole sum."""
    n, rows, cols = x.shape
    chunks = x.reshape(n, n, rows // n, cols)
    out = np.empty_like(chunks[0])
    for c in range(n):
        acc = chunks[c, c].copy()
        for k in range(1, n):
            acc = chunks[(c + direction * k) % n, c] + acc
        out[c] = acc
    return np.broadcast_to(out.reshape(rows, cols), x.shape)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", list(JAX_SUM_TYPES), ids=str)
@pytest.mark.parametrize("name", ["hbm", "bidir"])
def test_hbm_and_bidir_match_jax_kernels_at_every_dtype(name, dtype, n):
    """The twins of B9 and B11 bitwise against the interpreted JAX
    kernels at each sum dtype the reference takes here."""
    if dtype == torch.bfloat16:
        pytest.importorskip("ml_dtypes")
    x = _sum_input(JAX_SUM_TYPES[dtype], (n, n * 8, COLS[name]),
                   n + 7 * list(JAX_SUM_TYPES).index(dtype))
    ref = _jax_ring(_jax_kernel(name), x)
    ours = torch.from_numpy(x.astype(np.float32)).bfloat16() \
        if dtype == torch.bfloat16 else torch.from_numpy(x)
    out = VARIANTS[name](ours, "x", _cpu_mesh(n))
    assert out.dtype == dtype
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(out.float().numpy(),
                                      ref.astype(np.float32))
    else:
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64], ids=str)
@pytest.mark.parametrize("name", ["hbm", "bidir"])
def test_hbm_and_bidir_at_f64_and_int64(name, dtype, n):
    """f64 and int64, which the reference cannot take here: bitwise B3's
    twin (B9; B11's left half) and numpy's member-order fold (B11's right
    half in the mirrored ring's order)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.int64
    cols = COLS[name]
    x = _sum_input(np_dtype, (n, n * 8, cols), n)
    mesh = _cpu_mesh(n)
    out = VARIANTS[name](torch.from_numpy(x), "x", mesh)
    assert out.dtype == dtype
    b3 = ring.ring_allreduce_plain(torch.from_numpy(x), "x", mesh).numpy()
    if name == "hbm":
        np.testing.assert_array_equal(out.numpy(), b3)
        np.testing.assert_array_equal(out.numpy(), _member_order_sum(x, 1))
        return
    h = cols // 2
    np.testing.assert_array_equal(out[..., :h].numpy(), b3[..., :h])
    np.testing.assert_array_equal(out[..., :h].numpy(),
                                  _member_order_sum(x[..., :h], 1))
    np.testing.assert_array_equal(out[..., h:].numpy(),
                                  _member_order_sum(x[..., h:], -1))


@pytest.mark.parametrize("name", ["hbm", "bidir"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hbm_and_bidir_take_sum_dtypes_on_every_device(name, device):
    """B9 and B11 take every dtype of SUM_DTYPES on the CPU and on the
    card's path (a meta tensor goes the card's way and, past the dtype
    check, stops at the missing nvcc), and refuse the rest with the same
    TypeError on both, before any work."""
    mesh = make_mesh({"x": 2}, devices=[device] * 2)
    for dtype in ring.SUM_DTYPES:
        x = torch.ones((2, 4, 256), dtype=dtype, device=device)
        if device == "meta":
            with pytest.raises(RuntimeError, match="nvcc"):
                VARIANTS[name](x, "x", mesh)
        else:
            assert torch.equal(VARIANTS[name](x, "x", mesh),
                               torch.full_like(x, 2))
    for dtype in (torch.bool, torch.uint64, torch.complex64):
        with pytest.raises(TypeError, match="bfloat16, float32, float16"):
            VARIANTS[name](torch.zeros((2, 4, 256), dtype=dtype,
                                       device=device), "x", mesh)


def test_twins_count_no_launches_and_walk_a_2x2_mesh():
    mesh = make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 64, 256).astype(
        np.float32))
    before = [fn.launches for fn in VARIANTS.values()]
    for axis in ("data", "model"):
        members = torch.tensor(mesh.ring_members(axis))
        total = x.double()[members].sum(1)
        for name, fn in VARIANTS.items():
            out = fn(x, axis, mesh)
            err = (out.double() - total).abs().max() / total.abs().max()
            assert err < (0.05 if name == "q8" else 1e-6), (name, axis)
            for r in range(4):
                assert torch.equal(out[r], out[members[r, 0]])
    assert [fn.launches for fn in VARIANTS.values()] == before


# ---- the entry ----

def test_ring_variants_entry_on_cpu():
    path = ring_variants_entry("cpu")
    assert set(path) == {"hbm", "q8", "bidir"}
    x = path["hbm"][1][1]
    assert x.shape == (DDP_WORLD, 6912, 256) and x.dtype == torch.float32
    assert all(args[1] is x for _, args in path.values())
    numel = 1738000  # buffer_width of the flagship's gradients and loss
    assert bool((x.reshape(DDP_WORLD, -1)[:, numel:] == 0).all())
    first = np.random.RandomState(7).randn(1, 8)
    assert np.array_equal(x[0, 0, :8].numpy(), first[0].astype(np.float32))
    total = x.double().sum(0)
    for name, (fn, args) in path.items():
        y, g = fn(*args)
        tol = 0.05 if name == "q8" else 1e-6
        for got, want in ((y, total), (g, 2 * DDP_WORLD * total)):
            rel = (got.double() - want).abs().max() / want.abs().max()
            assert rel < tol, (name, float(rel))
            assert all(torch.equal(got[r], got[0]) for r in range(DDP_WORLD))


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the variant kernels have no CPU "
                    "mode")
    return torch.device("cuda")


# (variant, mesh axes, ring axis, rows per rank, cols, dtype).
CARD_CASES = [
    (name, {"x": n}, "x", per, cols, dtype)
    for name, n, per, cols, dtype in (
        ("hbm", 2, 16, 128, torch.float32), ("hbm", 3, 792, 128,
                                             torch.float32),
        ("hbm", 8, 64, 128, torch.float32), ("hbm", 4, 64, 128,
                                             torch.bfloat16),
        ("hbm", 4, 32, 33, torch.bfloat16),
        ("q8", 2, 64, 128, torch.float32), ("q8", 3, 96, 128, torch.float32),
        ("q8", 8, 256, 128, torch.float32),
        ("bidir", 2, 16, 256, torch.float32), ("bidir", 3, 24, 512,
                                               torch.float32),
        ("bidir", 8, 64, 256, torch.float32), ("bidir", 4, 64, 256,
                                               torch.bfloat16))] + [
    (name, {"data": 2, "model": 2}, axis, 64, 256, torch.float32)
    for axis in ("data", "model") for name in ("hbm", "q8", "bidir")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,axes,axis,per,cols,dtype", CARD_CASES)
def test_kernels_match_twins_on_card(cuda_device, name, axes, axis, per,
                                     cols, dtype):
    """Each case three times in a row (an ordering fault between bulk
    copies, barriers and flags shows now and then), bitwise the twin."""
    ranks = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=[cuda_device] * ranks)
    gen = torch.Generator(cuda_device).manual_seed(ranks)
    x = torch.randn((ranks, per, cols), generator=gen,
                    device=cuda_device).to(dtype)
    fn = VARIANTS[name]
    want = PLAIN[name](x, axis, mesh)
    for _ in range(3):
        before = fn.launches
        out = fn(x, axis, mesh)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(out, want)
    if name == "hbm":
        assert torch.equal(out, ring.ring_allreduce(x, axis, mesh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ring.SUM_DTYPES), ids=str)
@pytest.mark.parametrize("name", ["hbm", "bidir"])
def test_kernels_match_twins_at_every_sum_dtype_on_card(cuda_device, name,
                                                        dtype):
    """Each code of SUM_DTYPES, bitwise the twin (on a CPU copy) and
    bitwise B3 (B9; B11's left half), three calls in a row."""
    mesh = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    cols = COLS[name]
    if dtype.is_floating_point:
        x = torch.randn((4, 64, cols), device=cuda_device).to(dtype)
    else:
        bits = 31 if dtype in (torch.int64, torch.uint32) else \
            torch.iinfo(dtype).bits - 1
        x = torch.randint(0, 2 ** bits, (4, 64, cols), dtype=torch.int64,
                          device=cuda_device).to(dtype)
    cpu = _cpu_mesh(4)
    want = VARIANTS[name](x.cpu(), "x", cpu)
    fn = VARIANTS[name]
    for _ in range(3):
        before = fn.launches
        out = fn(x, "x", mesh)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert out.dtype == dtype and torch.equal(out.cpu(), want)
    h = cols if name == "hbm" else cols // 2
    assert torch.equal(out[..., :h], ring.ring_allreduce(
        x[..., :h].contiguous(), "x", mesh))


@pytest.mark.cuda
def test_autograd_on_card(cuda_device):
    mesh = make_mesh({"x": 4}, devices=[cuda_device] * 4)
    x = torch.randn((4, 128, 256), device=cuda_device)
    for name, fn in VARIANTS.items():
        leaf = x.clone().requires_grad_()
        before = fn.launches
        fn(leaf, "x", mesh).sum().backward()
        assert fn.launches == before + 2
        torch.testing.assert_close(leaf.grad, torch.full_like(x, 4.0))
