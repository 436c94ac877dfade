"""Flash attention at head dims other than the kernels' 64 and 128.

The reference's flash_attention takes any head_dim (its tests run 16, 32
and 128; the dry run's dp x tp config has head_dim 8). The port's kernels
have instances for 64 and 128; the wrappers zero-pad q, k and v (and dO,
out and the carried acc) along d up to the next instance and slice the
results back, with the scale of the unpadded d. That is exact: padded q
and k columns add 0 to every score, padded v and dO columns fill only
output columns that are cut off, and delta gains only 0 * 0 terms.

On the CPU the twins run unpadded; they are held against the interpreted
JAX kernel at the reference tests' shapes (out, and dq/dk/dv from jax.vjp
with the same cotangent). The padding itself is the card's path, followed
here on meta tensors with a fake library up to the launch: what reaches
the kernel is d = 64 or 128 with padded, contiguous strides and the
unpadded d's scale, and what comes back has q's head_dim. The state a
padded step returns (a view of its padded acc) is what the next ring step
takes.

Tolerances are test_torch_attention.py's: f32 rtol 1e-4 / atol 1e-5
(other tiles, other sum orders); bf16 out rtol 1.6e-2 / atol 1e-2 (p and
out rounded to bf16, one flipped ulp allowed twice over); bf16 gradients
rtol 1.6e-2 / atol 8e-3 of the largest |reference| (p and ds rounded to
bf16 inside the sums).

Tests marked `cuda` run the kernels at these head dims and skip without a
card.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from gloo_tpu_torch.ops import attention as attn

TOL = {
    "float32": {"out": (1e-4, 1e-5), "grad": (1e-4, 1e-5)},
    "bfloat16": {"out": (1.6e-2, 1e-2), "grad": (1.6e-2, 8e-3)},
}
HEAD_DIMS = [8, 16, 32, 48, 96]
# (b, h, h_kv, t): tests/test_flash_attention.py's GQA shapes (b 2, t 32,
# (8, 2) and (4, 1) heads).
SHAPES = [(2, 8, 2, 32), (2, 4, 1, 32)]


def _inputs(b, h, h_kv, t, d, dtype, seed):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.RandomState(seed)
    js = [jnp.asarray(rng.randn(b, n, t, d).astype(np.float32),
                      jnp.dtype(dtype)) for n in (h, h_kv, h_kv)]
    g = jnp.asarray(rng.randn(b, h, t, d).astype(np.float32),
                    jnp.dtype(dtype))
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in (*js, g)]
    return js, g, ts


def _close(ours, ref, rtol, atol, relative=False):
    ref = np.asarray(ref, dtype=np.float32)
    if relative:
        atol *= float(np.abs(ref).max())
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,h_kv,t", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_and_grads_match_the_jax_kernel(d, b, h, h_kv, t, causal,
                                                dtype):
    jax = pytest.importorskip("jax")
    from gloo_tpu.ops import attention as jattn

    (jq, jk, jv), jg, (q, k, v, g) = _inputs(b, h, h_kv, t, d, dtype,
                                             seed=d + h)
    ref, vjp = jax.vjp(lambda *a: jattn.flash_attention(
        *a, causal=causal, interpret=True), jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = attn.flash_attention(*leaves, causal=causal)
    assert out.shape == (b, h, t, d) and out.dtype == q.dtype
    _close(out.detach(), ref.astype(np.float32), *TOL[dtype]["out"])
    grads = torch.autograd.grad(out, leaves, g)
    for ours, theirs in zip(grads, vjp(jg)):
        assert ours.shape == theirs.shape
        _close(ours, theirs.astype(np.float32), *TOL[dtype]["grad"],
               relative=dtype == "bfloat16")


class _FakeLib:
    """Stands in for the flash sources' libraries: records each launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("gtt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The card's path of the flash wrappers on meta tensors, up to the
    launch, with every torch allocation recorded."""
    lib = _FakeLib()
    monkeypatch.setattr(attn, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(attn, "_check_device", lambda named: None)
    monkeypatch.setattr(attn, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    lib.allocated = []
    for alloc in ("empty", "zeros"):
        real = getattr(torch, alloc)

        def record(*args, real=real, alloc=alloc, **kwargs):
            t = real(*args, **kwargs)
            lib.allocated.append((alloc, tuple(t.shape), t.dtype))
            return t

        monkeypatch.setattr(torch, alloc, record)
    return lib


def _meta(*shape, dtype=torch.bfloat16):
    return torch.ones(shape, dtype=dtype, device="meta")


def _contiguous(heads, t, dim):
    return (heads * t * dim, t * dim, dim)


@pytest.mark.parametrize("d,dim", [(8, 64), (48, 64), (64, 64), (96, 128)])
def test_forward_pads_to_the_instance(fake_card, d, dim):
    b, h, h_kv, t = 2, 4, 2, 72
    q, k, v = _meta(b, h, t, d), _meta(b, h_kv, t, d), _meta(b, h_kv, t, d)
    out, lse = attn.flash_attention_fwd(q, k, v, True)
    assert out.shape == (b, h, t, d) and lse.shape == (b, h, t)
    name, args = fake_card.calls[-1]
    assert name == "gtt_flash_fwd"
    assert args[5:12] == (0, b, h, h_kv, t, dim, 1)
    assert args[12] == attn._folded_scale(d, torch.bfloat16)
    want = _contiguous(h, t, dim) + _contiguous(h_kv, t, dim) * 2
    if d == dim:  # q, k and v as they lie
        want = tuple(x for s in (q, k, v) for x in s.stride()[:3])
    assert args[13:22] == want


@pytest.mark.parametrize("d,dim", [(8, 64), (32, 64), (96, 128)])
def test_backward_pads_and_makes_three_launches(fake_card, d, dim):
    """One library call, whose three launches make delta and dq_acc's
    zeros themselves: the wrapper allocates only empty work buffers (the
    lse and delta rows per query tile, dq_acc) and the outputs, at the
    padded width; no torch.zeros, no delta in PyTorch."""
    b, h, h_kv, t = 2, 4, 2, 72
    q, out, do = _meta(b, h, t, d), _meta(b, h, t, d), _meta(b, h, t, d)
    k, v = _meta(b, h_kv, t, d), _meta(b, h_kv, t, d)
    lse = _meta(b, h, t, dtype=torch.float32)
    fake_card.allocated.clear()
    dq, dk, dv = attn.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert (dq.shape, dk.shape, dv.shape) == ((b, h, t, d),
                                             (b, h_kv, t, d),
                                             (b, h_kv, t, d))
    [(name, args)] = fake_card.calls
    assert name == "gtt_flash_bwd"
    assert args[11:18] == (0, b, h, h_kv, t, dim, 1)
    assert args[18:20] == (attn._folded_scale(d, torch.bfloat16),
                           attn._dq_scale(d))
    heads = (h, h_kv, h_kv, h, h)  # q, k, v, dO, out
    assert args[20:35] == tuple(x for n in heads
                                for x in _contiguous(n, t, dim))
    bf16, f32 = torch.bfloat16, torch.float32
    assert sorted(fake_card.allocated, key=str) == sorted([
        ("empty", (b * h, 2, 2 * attn.BLOCK_Q), f32),
        ("empty", (b, h, t, dim), f32),
        ("empty", (b, h, t, dim), bf16),
        ("empty", (b, h_kv, t, dim), bf16),
        ("empty", (b, h_kv, t, dim), bf16)], key=str)


def test_backward_launch_plan_and_names():
    """flash_bwd_plan copies only what TMA cannot read (a dO whose head_dim
    is not contiguous); the three kernels of each dtype are named
    flash_bwd_*, defined in csrc/flash_bwd.cu and launched there, the
    first from delta's inputs (dO and out)."""
    b, h, t, d = 2, 4, 72, 64
    qkv = torch.empty((b, t, 3 * h * d), dtype=torch.bfloat16, device="meta")
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
               .transpose(1, 2) for i in range(3))
    out = torch.empty((b, h, t, d), dtype=torch.bfloat16, device="meta")
    do = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                     device="meta").transpose(1, 2)
    plan = attn.flash_bwd_plan(q, k, v, do, out)
    assert plan.copies == ()
    assert plan.strides == (t * 3 * h * d, d, 3 * h * d) * 3 + (
        t * h * d, d, h * d) + _contiguous(h, t, d)
    cols = torch.empty((b, h, d, t), dtype=torch.bfloat16,
                       device="meta").transpose(2, 3)
    assert attn.flash_bwd_plan(q, k, v, cols, out).copies == ("do",)
    source = (attn._build.CSRC_DIR / "flash_bwd.cu").read_text()
    for dtype, names in attn.FLASH_BWD_KERNELS.items():
        assert len(names) == 3 and all("flash_bwd" in n for n in names)
        for n in names:
            assert re.search(r"__global__ void (__launch_bounds__\([^)]*\)"
                             rf"\s+)?{n}\(", source), n
            assert re.search(rf"{n}(<[^>]*>)?\s*<<<", source), n
    assert "flash_bwd_prep_kernel" in source.split("PrepParams pp{")[0]
    assert "PrepParams pp{dout, out," in source


def test_step_kernels_pad_to_the_instance(fake_card):
    """B6 and the fused B7a + B7b: d 40 runs on the d 64 instance with the
    scale of 40 (after the prep launch that splits the padded f32 dO), and
    the f32 state and gradients come back at 40."""
    bh, tq, d = 4, 64, 40
    q, k, v = _meta(bh, tq, d), _meta(bh, tq, d), _meta(bh, tq, d)
    f32 = torch.float32
    acc = _meta(bh, tq, d, dtype=f32)
    m, l = _meta(bh, tq, 1, dtype=f32), _meta(bh, tq, 1, dtype=f32)
    state = attn.flash_attention_step(q, k, v, acc, m, l, 0, 0)
    assert [x.shape for x in state] == [(bh, tq, d), (bh, tq, 1),
                                       (bh, tq, 1)]
    name, args = fake_card.calls[-1]
    # The kernel's head_dim, the state's width as it lies, the scale of d.
    assert name == "gtt_flash_step" and args[13:15] == (64, d)
    assert args[16] == attn._folded_scale(d, torch.bfloat16)
    do = _meta(bh, tq, d, dtype=f32)
    dq, dk, dv = attn.flash_attention_bwd_step(q, k, v, do, m, l, 0, 0)
    assert dq.shape == dk.shape == dv.shape == (bh, tq, d)
    (n1, a1), (n2, a2) = fake_card.calls[-2:]
    assert (n1, a1[8]) == ("gtt_flash_bwd_step_prep", 64)
    assert (n2, a2[19], a2[22:24]) == (
        "gtt_flash_bwd_step", 64,
        (attn._folded_scale(d, torch.bfloat16), attn._dq_scale(d)))


def test_step_cotangent_is_held_to_its_q(fake_card):
    """The accumulating step launches with a cotangent prepared for its q
    (bf16: dO_hi, dO_lo and the packed rows; f32: the f32 dO) and refuses
    one prepared for a q of the other dtype before any launch."""
    bh, t, d = 4, 64, 40
    f32 = torch.float32
    q = _meta(bh, t, d)
    do, lse = _meta(bh, t, d, dtype=f32), _meta(bh, t, 1, dtype=f32)
    bufs = [_meta(bh, t, 64, dtype=f32) for _ in range(3)]
    cots = {torch.bfloat16: attn.prepare_bwd_step(q, do, lse, lse),
            f32: attn.prepare_bwd_step(q.float(), do, lse, lse)}
    assert [n for n, _ in fake_card.calls] == ["gtt_flash_bwd_step_prep"]
    assert cots[f32].rows is None and cots[f32].do.shape == (bh, t, 64)
    for dtype, cot in cots.items():
        x = q.to(dtype)
        attn.flash_attention_bwd_step_into(x, x, x, cot, 0, 0, *bufs)
        other = q.to(f32 if dtype == torch.bfloat16 else torch.bfloat16)
        with pytest.raises(ValueError, match="prepared for another q"):
            attn.flash_attention_bwd_step_into(other, other, other, cot, 0,
                                               0, *bufs)
    launches = [(n, a[13]) for n, a in fake_card.calls[1:]]
    assert launches == [("gtt_flash_bwd_step", 0), ("gtt_flash_bwd_step", 1)]


@pytest.mark.parametrize("d,dim", [(32, 64), (96, 128)])
def test_step_kernel_takes_the_state_it_returns(fake_card, d, dim):
    """A ring loop hands each B6 step the (acc, m, l) of the step before:
    at a padded head_dim q, k and v run on the next instance while the
    kernel reads and writes the d-wide acc as it lies (its width passed
    beside the instance's)."""
    bh, tq = 4, 64
    q, k, v = _meta(bh, tq, d), _meta(bh, tq, d), _meta(bh, tq, d)
    f32 = torch.float32
    state = (_meta(bh, tq, d, dtype=f32), _meta(bh, tq, 1, dtype=f32),
             _meta(bh, tq, 1, dtype=f32))
    for _ in range(3):
        state = attn.flash_attention_step(q, k, v, *state, 0, 0)
        assert [x.shape for x in state] == [(bh, tq, d), (bh, tq, 1),
                                           (bh, tq, 1)]
    assert [(n, a[13], a[14]) for n, a in fake_card.calls] == \
        [("gtt_flash_step", dim, d)] * 3


@pytest.mark.parametrize("d", [264, 12, 512])
def test_head_dims_no_instance_takes_raise(fake_card, d):
    q = _meta(1, 2, 64, d)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_attention_fwd(q, q, q, True)
    lse = _meta(1, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_attention_bwd(q, q, q, q, lse, q, True)
    assert fake_card.calls == []


def test_instances_cover_every_multiple_of_8():
    assert [attn.kernel_head_dim(d) for d in range(8, 129, 8)] == \
        [64] * 8 + [128] * 8


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernels_at_head_dims_match_plain_on_card(cuda_device, d, dtype):
    gen = torch.Generator(cuda_device).manual_seed(d)
    tdtype = getattr(torch, dtype)
    b, h, h_kv, t = 2, 4, 2, 136
    q, k, v = (torch.randn((b, n, t, d), generator=gen, device=cuda_device)
               .to(tdtype) for n in (h, h_kv, h_kv))
    do = torch.randn((b, h, t, d), generator=gen,
                     device=cuda_device).to(tdtype)
    before = (attn.flash_attention_fwd.launches,
              attn.flash_attention_bwd.launches)
    out, lse = attn.flash_attention_fwd(q, k, v, True)
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    assert (attn.flash_attention_fwd.launches,
            attn.flash_attention_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    ref_out, ref_lse = attn.flash_attention_plain(q, k, v, True)
    _close(out.cpu(), ref_out.float().cpu().numpy(), *TOL[dtype]["out"])
    plain = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    for a, r in zip(grads, plain):
        assert a.shape == r.shape
        _close(a.cpu(), r.float().cpu().numpy(), *TOL[dtype]["grad"],
               relative=dtype == "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96])
def test_ring_flash_attention_at_head_dims_matches_plain_on_card(
        cuda_device, d):
    """The ring-flash path at a padded head_dim: 4 ring steps, each B6
    launch taking the state the one before returned, then the ring
    backward, against the same path on CPU tensors (the step twins)."""
    from gloo_tpu_torch.parallel import sp
    from gloo_tpu_torch.tpu import make_mesh

    ranks, b, h, h_kv, t = 4, 1, 4, 2, 128
    rng = np.random.RandomState(d)
    host = [torch.from_numpy(rng.randn(ranks, b, n, t, d).astype(np.float32))
            .to(torch.bfloat16) for n in (h, h_kv, h_kv)]
    g = torch.from_numpy(rng.randn(ranks, b, h, t, d).astype(np.float32))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        mesh = make_mesh({"seq": ranks}, devices=[dev] * ranks)
        leaves = [x.to(dev).requires_grad_(True) for x in host]
        before = attn.flash_attention_step.launches
        out = sp.ring_flash_attention(*leaves, "seq", True, mesh=mesh)
        grads = torch.autograd.grad(out, leaves, g.to(dev, out.dtype))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert attn.flash_attention_step.launches == before + ranks
        results.append([x.detach().cpu() for x in (out, *grads)])
    (out, *grads), (ref, *ref_grads) = results
    assert out.shape == (ranks, b, h, t, d)
    _close(out, ref.float().numpy(), *TOL["bfloat16"]["out"])
    for a, r in zip(grads, ref_grads):
        assert a.shape == r.shape
        _close(a, r.float().numpy(), *TOL["bfloat16"]["grad"],
               relative=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 96])
def test_step_kernels_at_head_dims_match_plain_on_card(cuda_device, d):
    gen = torch.Generator(cuda_device).manual_seed(d)
    bh, t = 4, 128
    q, k, v = (torch.randn((bh, t, d), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    acc = torch.zeros((bh, t, d), device=cuda_device)
    m = torch.full((bh, t, 1), -float("inf"), device=cuda_device)
    l = torch.zeros((bh, t, 1), device=cuda_device)
    got = attn.flash_attention_step(q, k, v, acc, m, l, 0, 0)
    want = attn.flash_attention_step_plain(q, k, v, acc, m, l, 0, 0)
    for a, r in zip(got, want):
        _close(a.cpu(), r.cpu().numpy(), *TOL["bfloat16"]["grad"],
               relative=True)
    do = torch.randn((bh, t, d), generator=gen, device=cuda_device)
    lse = got[1] + torch.log(got[2])
    delta = (do * (got[0] / got[2])).sum(-1, keepdim=True)
    got = attn.flash_attention_bwd_step(q, k, v, do, delta, lse, 0, 0)
    want = (attn.flash_attention_bwd_dq_step_plain(q, k, v, do, delta, lse,
                                                   0, 0),
            *attn.flash_attention_bwd_dkv_step_plain(q, k, v, do, delta, lse,
                                                     0, 0))
    for a, r in zip(got, want):
        assert a.shape == r.shape
        _close(a.cpu(), r.cpu().numpy(), *TOL["bfloat16"]["grad"],
               relative=True)
