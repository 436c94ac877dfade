"""gloo_tpu_torch.ops.attention against gloo_tpu.ops.attention.

On the CPU the port runs flash_attention_plain and
flash_attention_bwd_plain, the step-by-step twins of the CUDA kernels; they
are held against the JAX flash_attention in Pallas interpret mode (out,
and dq/dk/dv from jax.vjp of it with the same cotangent) and against
jax.nn.logsumexp over the JAX kernel's scaled, masked scores (lse). Inputs
are made with numpy from a seed and handed to both.

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the two walk different tiles, so
the online softmax rescales and the gradient sums add up at other places;
~2e-6 seen on gradients of size ~5). bf16 out rtol 1.6e-2 / atol 1e-2: p
and out are rounded to bf16, and a last-bit difference before a rounding
flips one bf16 ulp (2**-8 relative), two allowed. bf16 gradients rtol
1.6e-2 / atol 8e-3 of the tensor's largest magnitude: p and ds are
rounded to bf16 inside the sums, so a flipped ulp there moves an element
by a fraction of an ulp of the largest terms (one ulp of the largest seen).
lse is f32 in both: rtol 1e-5 / atol 1e-4.

Tests marked `cuda` run the kernels themselves and skip without a card.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gloo_tpu.ops import attention as jattn  # noqa: E402
from gloo_tpu_torch.ops import attention as attn  # noqa: E402

TOL = {
    "float32": {"out": (1e-4, 1e-5), "lse": (1e-5, 1e-4),
                "grad": (1e-4, 1e-5)},
    "bfloat16": {"out": (1.6e-2, 1e-2), "lse": (1e-5, 1e-4),
                 "grad": (1.6e-2, 8e-3)},
}
# (h, h_kv, t, d) of the CPU comparisons with JAX.
SHAPES = [
    (4, 4, 128, 32),   # two of the kernel's 64-key tiles; 1/sqrt(32) is
                       # not exact in bf16
    (4, 2, 72, 16),    # GQA, and a ragged last tile (72 = 64 + 8)
    (4, 1, 64, 64),    # multi-query, one tile
]


def _inputs(b, h, h_kv, t, d, dtype, seed=0):
    """Identical q, k, v for both frameworks: numpy f32 rounded once to
    `dtype` by JAX, then carried over exactly."""
    rng = np.random.RandomState(seed)
    jdtype = jnp.dtype(dtype)
    tdtype = getattr(torch, dtype)
    js = [jnp.asarray(rng.randn(b, n, t, d).astype(np.float32), jdtype)
          for n in (h, h_kv, h_kv)]
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdtype)
          for x in js]
    return js, ts


def _jax_lse(q, k, causal):
    """logsumexp rows of the JAX kernel's scores: q * scale in q's dtype,
    f32 products, -inf above the diagonal."""
    h, h_kv, t, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k = jnp.repeat(k, h // h_kv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q * (1.0 / math.sqrt(d)), k,
                   preferred_element_type=jnp.float32)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((t, t), jnp.bool_)), s, -jnp.inf)
    return jax.nn.logsumexp(s, axis=-1)


def _assert_close(ours, ref, rtol, atol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=rtol, atol=atol)


def _assert_grad_close(ours, ref, dtype):
    """Gradients: rtol as stated, atol relative to the largest |ref| in
    bf16 and absolute in f32 (module docstring)."""
    ref = np.asarray(ref.astype(jnp.float32))
    rtol, atol = TOL[dtype]["grad"]
    if dtype == "bfloat16":
        atol *= float(np.abs(ref).max())
    _assert_close(ours, ref, rtol, atol)


def _jax_and_port_grads(dtype, causal, h, h_kv, t, d, seed=0):
    """(jax dq, dk, dv), (port dq, dk, dv) and the port's inputs for one
    cotangent, through the interpreted JAX kernel and the autograd
    flash_attention."""
    (jq, jk, jv), (q, k, v) = _inputs(2, h, h_kv, t, d, dtype, seed)
    jg = jnp.asarray(np.random.RandomState(seed + 100).randn(
        2, h, t, d).astype(np.float32), jnp.dtype(dtype))
    g = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(q.dtype)
    _, vjp = jax.vjp(lambda *a: jattn.flash_attention(
        *a, causal=causal, interpret=True), jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = attn.flash_attention(*leaves, causal=causal)
    return vjp(jg), torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,t,d", SHAPES)
def test_plain_matches_jax_flash(dtype, causal, h, h_kv, t, d):
    (jq, jk, jv), (q, k, v) = _inputs(2, h, h_kv, t, d, dtype)
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    out, lse = attn.flash_attention_plain(q, k, v, causal)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    _assert_close(out, ref.astype(jnp.float32), *TOL[dtype]["out"])
    _assert_close(lse, _jax_lse(jq, jk, causal), *TOL[dtype]["lse"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,t,d", SHAPES + [(2, 2, 72, 128)])
def test_backward_matches_jax_vjp(dtype, causal, h, h_kv, t, d):
    ref, ours = _jax_and_port_grads(dtype, causal, h, h_kv, t, d)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == getattr(torch, dtype), name
        assert tuple(a.shape) == r.shape, name
        _assert_grad_close(a, r, dtype)


@pytest.mark.parametrize("h,h_kv,t,d,causal", [(4, 2, 72, 32, True),
                                               (2, 2, 72, 128, False)])
def test_dq_takes_the_unrounded_scale(monkeypatch, h, h_kv, t, d, causal):
    # dK carries the scale rounded to bf16 (it contracts ds with q * scale
    # in q's dtype); dQ takes the unrounded f32 1/sqrt(d) at the end. At
    # these d the two differ by ~1.1e-4 relative, far under a bf16 ulp, so
    # it shows as a bias of dq against JAX summed over all elements:
    # ~1e-5 or less with the right scale, ~1e-4 with the rounded one.
    def bias():
        ref, ours = _jax_and_port_grads("bfloat16", causal, h, h_kv, t, d)
        a = ours[0].float().numpy()
        r = np.asarray(ref[0].astype(jnp.float32))
        return float(np.sum((a - r) * np.sign(r)) / np.sum(np.abs(r)))

    assert abs(bias()) < 5e-5
    monkeypatch.setattr(attn, "_dq_scale",
                        lambda d: attn._folded_scale(d, torch.bfloat16))
    assert abs(bias()) > 5e-5


def test_grad_mode_decides_what_is_kept():
    # Training keeps (q, k, v, out, lse) for the backward; serving keeps
    # nothing and runs the forward alone, even on inputs that require grad.
    _, (q, k, v) = _inputs(1, 2, 1, 24, 8, "float32", seed=4)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    for mode, n_saved in ((torch.inference_mode, 0), (torch.no_grad, 0),
                          (torch.enable_grad, 5)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x), mode():
            out = attn.flash_attention(*leaves, causal=True)
        assert len(saved) == n_saved, mode
        assert (out.grad_fn is None) == (n_saved == 0), mode
        torch.testing.assert_close(
            out.detach(), attn.flash_attention_plain(q, k, v, True)[0],
            rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    (jq, jk, jv), (q, k, v) = _inputs(2, 2, 2, 40, 16, "float32", seed=3)
    ref = jattn._reference_attention(jq, jk, jv, causal)
    _assert_close(attn.reference_attention(q, k, v, causal), ref,
                  *TOL["float32"]["out"])


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    _, (q, k, v) = _inputs(1, 2, 1, 24, 8, "float32", seed=1)
    before = attn.flash_attention_fwd.launches
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    plain_out, plain_lse = attn.flash_attention_plain(q, k, v, True)
    assert torch.equal(out, plain_out) and torch.equal(lse, plain_lse)
    assert torch.equal(attn.flash_attention(q, k, v), plain_out)
    assert attn.flash_attention_fwd.launches == before
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    before_bwd = attn.flash_attention_bwd.launches
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    plain = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert attn.flash_attention_bwd.launches == before_bwd


def test_plain_is_differentiable_on_cpu():
    _, (q, k, v) = _inputs(1, 2, 2, 16, 8, "float32", seed=2)
    q.requires_grad_(True)
    attn.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 8, 8), (1, 2, 8, 8), (1, 1, 8, 8)), "v has 1"),
    (((1, 3, 8, 8), (1, 2, 8, 8), (1, 2, 8, 8)), "multiple of kv heads"),
    (((1, 4, 8, 8), (1, 2, 16, 8), (1, 2, 16, 8)), "must be"),
    (((4, 8, 8), (4, 8, 8), (4, 8, 8)), "batch, heads"),
])
def test_bad_shapes_raise(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        attn.flash_attention(q, k, v)


def test_non_cpu_tensor_never_takes_the_plain_path():
    # A tensor off the CPU goes to the kernel's checks, which take CUDA
    # tensors only: it raises, it does not fall back.
    q = torch.zeros((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_attention(q, q, q)


# (name, b, h, h_kv, t, d, dtype).
PLAN_CASES = [
    ("entry", 8, 4, 4, 128, 64, torch.bfloat16),
    ("t1024_d128", 4, 8, 8, 1024, 128, torch.bfloat16),
    ("ulysses", 8, 1, 1, 4096, 64, torch.bfloat16),
    ("ragged_gqa", 2, 8, 2, 200, 128, torch.bfloat16),
    ("f32", 2, 4, 2, 100, 128, torch.float32),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_forward_launch_plan(case):
    """Contiguous q, k and v (GQA's k/v with their own head count) go to
    the kernel as they lie, with their (b, h, t) strides in elements."""
    _, b, h, h_kv, t, d, dtype = case
    q = torch.empty((b, h, t, d), dtype=dtype, device="meta")
    k = torch.empty((b, h_kv, t, d), dtype=dtype, device="meta")
    plan = attn.flash_fwd_plan(q, k, k)
    strides = (h * t * d, t * d, d) + (h_kv * t * d, t * d, d) * 2
    assert plan == ((), strides)


def test_forward_plan_copies_only_what_tma_cannot_read():
    """The transformer's fused-qkv views go as they lie; a view whose row
    stride is not a multiple of 16 bytes, whose start is not 16-byte
    aligned, or whose head_dim is not contiguous is made contiguous first.
    A dimension of size 1 has no stride that matters."""
    b, h, t, d = 2, 4, 72, 64
    qkv = torch.empty((b, t, 3 * h * d), dtype=torch.bfloat16, device="meta")
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
               .transpose(1, 2) for i in range(3))
    plan = attn.flash_fwd_plan(q, k, v)
    assert plan.copies == ()
    assert plan.strides == (t * 3 * h * d, d, 3 * h * d) * 3
    odd = torch.empty((b, t, h * d + 4), dtype=torch.bfloat16,
                      device="meta")[..., :h * d].view(b, t, h, d) \
        .transpose(1, 2)
    plan = attn.flash_fwd_plan(odd, k, v)
    assert plan.copies == ("q",)
    # The copy's strides, q's (contiguous) layout, go to the kernel.
    assert plan.strides[:3] == (h * t * d, t * d, d)
    shifted = torch.empty((b, h, t, d + 8), dtype=torch.bfloat16,
                          device="meta")[..., 1:d + 1]
    assert attn.flash_fwd_plan(q, shifted, v).copies == ("k",)
    cols = torch.empty((b, h, d, t), dtype=torch.bfloat16,
                       device="meta").transpose(2, 3)
    assert attn.flash_fwd_plan(q, k, cols).copies == ("v",)
    one = torch.empty((1, 1, t, d), dtype=torch.bfloat16, device="meta")
    one = one.as_strided(one.shape, (3, 5, d, 1))
    plan = attn.flash_fwd_plan(one, one, one)
    assert plan.copies == () and plan.strides == (t * d, t * d, d) * 3


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, dtype, causal):
    _, (q, k, v) = _inputs(2, 4, 2, 136, 64, dtype)
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    before = attn.flash_attention_fwd.launches
    out, lse = attn.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = attn.flash_attention_plain(q, k, v, causal)
    assert attn.flash_attention_fwd.launches == before + 1
    tol = TOL[dtype]
    _assert_close(out.cpu(), ref_out.float().cpu().numpy(), *tol["out"])
    _assert_close(lse.cpu(), ref_lse.cpu().numpy(), *tol["lse"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_kernel_matches_plain_on_card(cuda_device, dtype, causal):
    _, (q, k, v) = _inputs(2, 4, 2, 136, 64, dtype)
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    # dO as the transformer hands it over: a strided (b, h, t, d) view.
    do = torch.randn((2, 136, 4, 64), generator=torch.Generator(
        cuda_device).manual_seed(1), device=cuda_device).to(q.dtype)
    do = do.transpose(1, 2)
    out, lse = attn.flash_attention_fwd(q, k, v, causal)
    before = attn.flash_attention_bwd.launches
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, causal)
    plain = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    assert attn.flash_attention_bwd.launches == before + 1
    rtol, atol = TOL[dtype]["grad"]
    for a, r in zip(grads, plain):
        r = r.float().cpu()
        scale = float(r.abs().max()) if dtype == "bfloat16" else 1.0
        _assert_close(a.cpu(), r.numpy(), rtol, atol * scale)


# (b, h, h_kv, t, d, dtype, causal, layout): the bf16 kernel's tiles,
# k/v stages (3 at d 64, 2 at d 128) and masks; "fused" q/k/v views of one
# projection, "odd" a q whose row stride is not a multiple of 16 bytes
# (copied first).
CARD_CASES = [
    (8, 4, 4, 128, 64, "bfloat16", True, "fused"),
    (2, 8, 2, 200, 128, "bfloat16", True, "fused"),
    (2, 4, 4, 320, 64, "bfloat16", False, "contiguous"),
    (1, 2, 1, 1000, 128, "bfloat16", True, "odd"),
    (2, 4, 4, 64, 64, "bfloat16", True, "odd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,h_kv,t,d,dtype,causal,layout", CARD_CASES)
def test_kernel_matches_plain_at_its_tiles_on_card(cuda_device, b, h, h_kv,
                                                   t, d, dtype, causal,
                                                   layout):
    _, (q, k, v) = _inputs(b, h, h_kv, t, d, dtype, seed=t + d)
    q, k, v = (x.to(cuda_device) for x in (q, k, v))
    if layout == "fused":
        qkv = torch.cat([x.transpose(1, 2).reshape(b, t, -1)
                         for x in (q, k, v)], -1)
        q, k, v = (qkv[..., a:a + n * d].view(b, t, n, d).transpose(1, 2)
                   for a, n in ((0, h), (h * d, h_kv),
                                ((h + h_kv) * d, h_kv)))
    elif layout == "odd":
        wide = torch.zeros((b, h, t, d + 4), dtype=q.dtype,
                           device=cuda_device)
        wide[..., :d] = q
        q = wide[..., :d]
    plan = attn.flash_fwd_plan(q, k, v)
    assert plan.copies == (("q",) if layout == "odd" else ())
    for _ in range(3):
        before = attn.flash_attention_fwd.launches
        out, lse = attn.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        assert attn.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = attn.flash_attention_plain(q, k, v, causal)
    tol = TOL[dtype]
    _assert_close(out.cpu(), ref_out.float().cpu().numpy(), *tol["out"])
    _assert_close(lse.cpu(), ref_lse.cpu().numpy(), *tol["lse"])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    ok = torch.zeros((1, 2, 64, 64), device=cuda_device,
                     dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attn.flash_attention(ok.double(), ok.double(), ok.double())
    with pytest.raises(ValueError, match="head_dim"):
        bad = torch.zeros((1, 2, 64, 264), device=cuda_device,
                          dtype=torch.bfloat16)
        attn.flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_attention(ok, ok.cpu(), ok)
    # With grad on, the op trains through the backward kernel.
    q = ok.float().requires_grad_(True)
    before = attn.flash_attention_bwd.launches
    attn.flash_attention(q, ok.float(), ok.float()).sum().backward()
    assert attn.flash_attention_bwd.launches == before + 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
