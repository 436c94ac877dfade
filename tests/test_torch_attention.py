"""gloo_tpu_torch.ops.attention against gloo_tpu.ops.attention.

On the CPU the port runs flash_attention_plain, the step-by-step twin of
the CUDA kernel; it is held against the JAX flash_attention in Pallas
interpret mode (out) and against jax.nn.logsumexp over the JAX kernel's
scaled, masked scores (lse). Inputs are made with numpy from a seed and
handed to both.

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the two walk different kv tiles,
so the online softmax rescales at other places). bf16 out rtol 1.6e-2 /
atol 1e-2: p and out are rounded to bf16, and a last-bit difference
before a rounding flips one bf16 ulp (2**-8 relative), two allowed. lse
is f32 in both: rtol 1e-5 / atol 1e-4.

Tests marked `cuda` run the kernel itself and skip without a card.
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
    "float32": {"out": (1e-4, 1e-5), "lse": (1e-5, 1e-4)},
    "bfloat16": {"out": (1.6e-2, 1e-2), "lse": (1e-5, 1e-4)},
}


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,t,d", [
    (4, 4, 128, 32),   # two of the kernel's 64-key tiles
    (4, 2, 72, 16),    # GQA, and a ragged last tile (72 = 64 + 8)
    (4, 1, 64, 64),    # multi-query, one tile
])
def test_plain_matches_jax_flash(dtype, causal, h, h_kv, t, d):
    (jq, jk, jv), (q, k, v) = _inputs(2, h, h_kv, t, d, dtype)
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    out, lse = attn.flash_attention_plain(q, k, v, causal)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    _assert_close(out, ref.astype(jnp.float32), *TOL[dtype]["out"])
    _assert_close(lse, _jax_lse(jq, jk, causal), *TOL[dtype]["lse"])


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
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    ok = torch.zeros((1, 2, 64, 64), device=cuda_device,
                     dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attn.flash_attention(ok.half(), ok.half(), ok.half())
    with pytest.raises(ValueError, match="head_dim"):
        bad = ok[..., :32].contiguous()
        attn.flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="CUDA"):
        attn.flash_attention(ok, ok.cpu(), ok)
    with pytest.raises(NotImplementedError, match="training"):
        attn.flash_attention(ok.float().requires_grad_(True), ok.float(),
                             ok.float())
