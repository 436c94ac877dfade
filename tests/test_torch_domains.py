"""The flash kernels' and the collective matmuls' whole domain: f16, head
dims up to 256, and any batch * heads.

The reference's Pallas kernels take any dtype whose dots they can run
(their dots run in the inputs' dtype with f32 accumulation), any head_dim
and any number of rows (b * h, their leading grid axis). The port's
kernels have bf16, f16 and f32 instances at d 64, 128 and 256 (136-248
zero-padded to 256) and spread rows past the grid's 65535 over its y and
z axes.

On the CPU the twins run; they are held against the JAX package run as
its own tests run it (Pallas in interpret mode, JAX's blocks at the twins'
64-row tiles), from numpy inputs made from a seed:
  - B1/B2 through flash_attention and its VJP at f16 d 64, and bf16, f16
    and f32 at d 256 and d 200 (GQA among them);
  - B6/B7 through the step functions at f16 and at d 256;
  - B5a/B5b at f16 over the virtual CPU mesh, as test_torch_overlap.py
    runs them;
  - the d 256 f16 flagship (D256_F16_CONFIG) at a small size (1 layer,
    d_ff 256, vocab 64, batch 2, seq 64): logits, loss and every gradient,
    the JAX init going through gloo_tpu_torch.weights.
The card's path of the wrappers is followed on meta tensors with a fake
library up to the launch (test_torch_head_dims.py's fixture): the d 256
instance with the unpadded d's scale for d 136-256, dtype code 2 for f16,
no refusal at b * h = 65 540, and refusals of d 264 and f64.

Tolerances, as (rtol, atol). f32 (1e-4, 1e-5): the same arithmetic
summed in another order. bf16: out (1.6e-2, 1e-2), gradients and step
outputs (1.6e-2, 8e-3 x the largest |reference|): p and ds are rounded to
bf16 inside the sums, so a last-bit difference of an f32 score flips one
bf16 ulp (2**-8 relative) of a term. f16: the same bounds at f16's ulp
(2**-11 relative), so the bf16 ones times 2**-3: out (2e-3, 1.25e-3),
gradients and step outputs (2e-3, 1e-3 x the largest |reference|); the
step's m and l are f32 and keep (1e-5, 1e-5 x their largest value).
B5 in f16: two f16 ulps of the largest |JAX value|, as bf16's two bf16
ulps (a flipped rounded partial and the add after it). The f16 flagship:
logits (2.5e-3, 2.5e-3), bf16's (2e-2, 2e-2) at f16's ulp, every
activation rounded to f16 where XLA and PyTorch round at other places
(7.9e-4 seen); loss rtol 1e-4 (1.3e-6 seen) and gradients 1e-2 in the
per-tensor relative norm |g - g_ref| / |g_ref| (test_torch_transformer.
py's measure; 1.7e-3 seen), bf16's 5e-4 and 5e-2 at f16's finer ulp with
a factor 2 kept for the reductions.

Tests marked `cuda` hold each new instance against its twin on the card
and skip without one.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from gloo_tpu_torch.entry import D256_F16_CONFIG, ENTRY_CONFIG
from gloo_tpu_torch.ops import attention as attn
from gloo_tpu_torch.ops import overlap

TOL = {
    "float32": {"out": (1e-4, 1e-5), "grad": (1e-4, 1e-5)},
    "bfloat16": {"out": (1.6e-2, 1e-2), "grad": (1.6e-2, 8e-3)},
    "float16": {"out": (2e-3, 1.25e-3), "grad": (2e-3, 1e-3)},
}
STATE_TOL = (1e-5, 1e-5)
# (dtype, d, (b, h, h_kv, t), causal): the flash cases against JAX.
FLASH = [
    ("float16", 64, (2, 4, 4, 64), True),
    ("bfloat16", 256, (1, 2, 2, 64), True),
    ("float16", 256, (1, 2, 2, 128), False),
    ("float32", 256, (1, 2, 1, 64), True),
    ("bfloat16", 200, (2, 4, 2, 64), False),
    ("float16", 200, (2, 4, 2, 64), True),
    ("float32", 200, (1, 4, 2, 64), False),
]
# (dtype, d, group): the step cases against JAX, t_q = t_kv = 64.
STEPS = [("float16", 64, 1), ("float16", 64, 2), ("bfloat16", 256, 1),
         ("float16", 256, 2), ("float32", 256, 1)]
FLAGSHIP_SMALL = dict(vocab_size=64, n_layers=1, d_ff=256, max_seq_len=64)
LOGIT_TOL = (2.5e-3, 2.5e-3)
GRAD_TOL = (1e-4, 1e-2)  # (loss rtol, per-tensor relative norm)


def _jnp():
    return pytest.importorskip("jax.numpy")


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(a, dtype):
    """(the JAX array of a in dtype, the same values as a torch tensor)."""
    jnp = _jnp()
    j = jnp.asarray(a, jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _close(ours, ref, rtol, atol, relative=False):
    ref = np.asarray(ref, dtype=np.float32)
    if relative:
        finite = np.isfinite(ref)
        atol *= max(float(np.abs(ref[finite]).max()), 1.0) \
            if finite.any() else 1.0
    got = ours.float().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=atol)


# ---- B1/B2 against the interpreted JAX kernel ----

@pytest.mark.parametrize("dtype,d,shape,causal", FLASH)
def test_flash_attention_and_vjp_match_jax(dtype, d, shape, causal):
    jax = pytest.importorskip("jax")
    from gloo_tpu.ops import attention as jattn

    b, h, h_kv, t = shape
    seed = d + h + t
    (jq, q), (jk, k), (jv, v), (jg, g) = (
        _pair(_randn((b, n, t, d), seed + i), dtype)
        for i, n in enumerate((h, h_kv, h_kv, h)))
    blocks = dict(block_q=min(t, attn.BLOCK_Q), block_k=min(t, attn.BLOCK_K))
    ref, vjp = jax.vjp(lambda *a: jattn.flash_attention(
        *a, causal=causal, interpret=True, **blocks), jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = attn.flash_attention(*leaves, causal=causal)
    assert out.shape == (b, h, t, d) and out.dtype == q.dtype
    _close(out.detach(), ref.astype(np.float32), *TOL[dtype]["out"])
    grads = torch.autograd.grad(out, leaves, g)
    for ours, theirs in zip(grads, vjp(jg)):
        assert ours.shape == theirs.shape and ours.dtype == q.dtype
        _close(ours, theirs.astype(np.float32), *TOL[dtype]["grad"],
               relative=dtype != "float32")


# ---- B6/B7 against the interpreted JAX step kernels ----

def _step_inputs(dtype, d, group, seed, t=64, bh=4):
    (jq, q), (jk, k), (jv, v) = (
        _pair(_randn((rows, t, d), seed + i), dtype)
        for i, rows in enumerate((bh, bh // group, bh // group)))
    return (jq, jk, jv), (q, k, v)


@pytest.mark.parametrize("dtype,d,group", STEPS)
def test_step_and_bwd_step_match_jax(dtype, d, group):
    """One B6 step from a fresh state over a block straddling the
    diagonal, then B7 from that forward's lse with an f32 cotangent (the
    ring backward's), dK/dV group-summed."""
    pytest.importorskip("jax")
    jnp = _jnp()
    from gloo_tpu.ops import attention as jattn

    bh, t = 4, 64
    (jq, jk, jv), (q, k, v) = _step_inputs(dtype, d, group, d + group)
    blocks = dict(block_q=t, block_k=t)
    fresh = (np.zeros((bh, t, d), np.float32),
             np.full((bh, t, 1), -np.inf, np.float32),
             np.zeros((bh, t, 1), np.float32))
    ref = jattn.flash_attention_step(
        jq, jk, jv, *(jnp.asarray(x) for x in fresh), jnp.int32(t),
        jnp.int32(t), causal=True, interpret=True, kv_group=group, **blocks)
    ours = attn.flash_attention_step(
        q, k, v, *(torch.from_numpy(x) for x in fresh), t, t, causal=True,
        kv_group=group)
    for name, a, r in zip(("acc", "m", "l"), ours, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
        if name == "acc":
            _close(a, r, *TOL[dtype]["grad"], relative=True)
        else:
            _close(a, r, *STATE_TOL, relative=True)
    acc, m, l = (np.asarray(x) for x in ref)
    l_safe = np.maximum(l, 1e-30)
    lse = m + np.log(l_safe)
    do = _randn((bh, t, d), 7 * d)
    delta = (do * (acc / l_safe)).sum(-1, keepdims=True)
    jref = jattn.flash_attention_bwd_step(
        jq, jk, jv, jnp.asarray(do), jnp.asarray(delta), jnp.asarray(lse),
        jnp.int32(t), jnp.int32(t), causal=True, interpret=True,
        kv_group=group, **blocks)
    got = attn.flash_attention_bwd_step(
        q, k, v, *(torch.from_numpy(x) for x in (do, delta, lse)), t, t,
        causal=True, kv_group=group)
    dq, dk, dv = got
    _close(dq, jref[0], *TOL[dtype]["grad"], relative=True)
    for ours, theirs in ((dk, jref[1]), (dv, jref[2])):
        _close(attn.group_sum_kv(ours, group),
               jattn.group_sum_kv(theirs, group), *TOL[dtype]["grad"],
               relative=True)


# ---- B5a/B5b at f16 on the virtual CPU mesh ----

def _jax_shard(fn, n, in_specs, out_specs, *args):
    jax = pytest.importorskip("jax")
    jnp = _jnp()
    from jax.sharding import Mesh as JaxMesh

    mesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object), ("x",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False))
    return np.asarray(f(*args).astype(jnp.float32))


def _within_two_ulps(ours, ref):
    peak = float(np.abs(ref).max())
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 10)
    err = float(np.abs(ours.float().numpy() - ref).max())
    assert err <= 2 * ulp, (err, ulp)


@pytest.mark.parametrize("n", [2, 4])
def test_collective_matmuls_at_f16_match_jax(n):
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.ops import allgather_matmul as jax_ag
    from gloo_tpu.ops import matmul_reduce_scatter as jax_rs
    from gloo_tpu_torch.tpu import make_mesh

    rng = np.random.RandomState(n)
    m, k, cols = 8 * n, 16 * n, 128
    x = rng.uniform(-1, 1, (m, k)).astype(np.float16)
    w = rng.uniform(-1, 1, (k, cols)).astype(np.float16)
    mesh = make_mesh({"x": n}, devices=["cpu"] * n)
    world = lambda a, axis: torch.from_numpy(  # noqa: E731
        np.stack(np.split(a, n, axis=axis)))
    ref = _jax_shard(lambda xs, ws: jax_rs(xs, ws, "x", interpret=True), n,
                     (P(None, "x"), P("x", None)), P("x", None), x, w)
    out = overlap.matmul_reduce_scatter(world(x, 1), world(w, 0), "x", mesh)
    assert out.dtype == torch.float16 and out.shape == (n, 8, cols)
    _within_two_ulps(out.reshape(m, cols), ref)
    ref = _jax_shard(lambda xs, ws: jax_ag(xs, ws, "x", interpret=True), n,
                     (P("x", None), P(None, None)), P(None, None), x, w)
    xw = world(x, 0)
    y, gx = overlap.allgather_matmul_fwd(
        xw, torch.from_numpy(w).expand(n, -1, -1), "x", mesh)
    assert y.dtype == torch.float16 and y.shape == (n, m, cols)
    for r in range(n):
        _within_two_ulps(y[r], ref)
        assert torch.equal(gx[r], xw.reshape(m, k))


# ---- the d 256 f16 flagship ----

def test_d256_f16_flagship_matches_jax():
    """D256_F16_CONFIG at a small size: the JAX model initialised from
    PRNGKey(0), its tree through gloo_tpu_torch.weights, the same tokens;
    logits, then the loss and every gradient of jax.value_and_grad."""
    jax = pytest.importorskip("jax")
    jnp = _jnp()
    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from gloo_tpu_torch import weights
    from gloo_tpu_torch.models import Transformer

    cfg = _small_d256()
    assert cfg.head_dim == 256 and cfg.dtype == torch.float16
    jm = JaxTransformer(JaxConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len,
        dtype=jnp.float16, use_flash_attention=True))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(cfg, device="cpu")
    tm.load_state_dict(weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 64))
    targets = np.roll(tokens, -1, axis=1)
    jt = jnp.asarray(tokens, jnp.int32)
    with torch.no_grad():
        logits = tm(torch.as_tensor(tokens, dtype=torch.int32))
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(
        jm.apply(jparams, jt), np.float32), rtol=LOGIT_TOL[0],
        atol=LOGIT_TOL[1])
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, (jt, jnp.asarray(targets, jnp.int32)))
    loss = tm.loss(torch.as_tensor(tokens, dtype=torch.int32),
                   torch.as_tensor(targets, dtype=torch.int32))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_TOL[0])
    grads = weights.transformer_params_to_numpy(
        {name: p.grad for name, p in tm.named_parameters()}, tm.cfg)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, ref), ours in zip(flat, jax.tree.leaves(grads)):
        ref = np.asarray(ref, np.float32)
        rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        assert rel <= GRAD_TOL[1], (jax.tree_util.keystr(path), rel)


def _small_d256():
    import dataclasses

    return dataclasses.replace(D256_F16_CONFIG, **FLAGSHIP_SMALL)


def test_d256_f16_config_is_the_flagship_at_one_head():
    want = dict(vocab_size=512, d_model=256, n_heads=1, n_layers=2,
                d_ff=1024, max_seq_len=128, dtype=torch.float16,
                use_flash_attention=True)
    assert {k: getattr(D256_F16_CONFIG, k) for k in want} == want
    assert D256_F16_CONFIG.head_dim == 256
    for field in ("vocab_size", "d_model", "n_layers", "d_ff",
                  "max_seq_len", "use_flash_attention"):
        assert getattr(D256_F16_CONFIG, field) == getattr(ENTRY_CONFIG,
                                                          field)


# ---- the card's path up to the launch, on meta tensors ----

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
    launch."""
    lib = _FakeLib()
    monkeypatch.setattr(attn, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(attn, "_check_device", lambda named: None)
    monkeypatch.setattr(attn, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


def _meta(*shape, dtype=torch.bfloat16):
    return torch.ones(shape, dtype=dtype, device="meta")


CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


@pytest.mark.parametrize("dtype", list(CODES), ids=str)
@pytest.mark.parametrize("d", [136, 200, 248, 256])
def test_flash_runs_d136_to_256_on_the_256_instance(fake_card, d, dtype):
    b, h, h_kv, t = 2, 4, 2, 72
    q, out, do = (_meta(b, h, t, d, dtype=dtype) for _ in range(3))
    k, v = _meta(b, h_kv, t, d, dtype=dtype), _meta(b, h_kv, t, d,
                                                    dtype=dtype)
    lse = _meta(b, h, t, dtype=torch.float32)
    got, _ = attn.flash_attention_fwd(q, k, v, True)
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert got.shape == (b, h, t, d) and got.dtype == dtype
    assert [x.shape for x in grads] == [(b, h, t, d), (b, h_kv, t, d),
                                        (b, h_kv, t, d)]
    (f, fa), (g, ga) = fake_card.calls
    assert (f, g) == ("gtt_flash_fwd", "gtt_flash_bwd")
    assert fa[5:12] == (CODES[dtype], b, h, h_kv, t, 256, 1)
    assert fa[12] == attn._folded_scale(d, dtype)
    assert ga[11:18] == (CODES[dtype], b, h, h_kv, t, 256, 1)
    assert ga[18:20] == (attn._folded_scale(d, dtype), attn._dq_scale(d))


@pytest.mark.parametrize("d,dim", [(64, 64), (256, 256), (200, 256)])
def test_f16_steps_launch_with_code_2(fake_card, d, dim):
    """B6, B7's prep (an f32 dO split into f16 hi and lo), the fused step
    and the dQ finish all get f16's code 2 at the instance's width."""
    bh, t, f16, f32 = 4, 64, torch.float16, torch.float32
    q, k, v = (_meta(bh, t, d, dtype=f16) for _ in range(3))
    acc = _meta(bh, t, d, dtype=f32)
    m, l = _meta(bh, t, 1, dtype=f32), _meta(bh, t, 1, dtype=f32)
    attn.flash_attention_step(q, k, v, acc, m, l, 0, 0)
    cot = attn.prepare_bwd_step(q, _meta(bh, t, d, dtype=f32), m, l)
    assert cot.do.dtype == cot.do_lo.dtype == f16
    assert cot.do.shape == (bh, t, dim)
    bufs = [_meta(bh, t, dim, dtype=f32) for _ in range(3)]
    attn.flash_attention_bwd_step_into(q, k, v, cot, 0, 0, *bufs)
    dq = attn.flash_bwd_step_finish(bufs[0], d, f16)
    assert dq.shape == (bh, t, d) and dq.dtype == f16
    names = [n for n, _ in fake_card.calls]
    assert names == ["gtt_flash_step", "gtt_flash_bwd_step_prep",
                     "gtt_flash_bwd_step", "gtt_flash_bwd_step_dq"]
    step, prep, bwd, fin = (a for _, a in fake_card.calls)
    assert step[8] == 2 and step[13:15] == (dim, d)
    assert prep[6:10] == (bh, t, dim, 2)
    assert bwd[13] == 2 and bwd[19] == dim
    assert bwd[22] == attn._folded_scale(d, f16)
    assert fin[2] == 2 and fin[3] == attn._dq_scale(d)


def test_rows_past_65535_are_not_refused(fake_card):
    """b * h = 65 540 rows: the wrappers launch, the grid is the kernels'
    concern (rows_grid in flash_common.cuh)."""
    b, h, t, d = 16385, 4, 64, 64
    assert b * h == 65540
    q, out, do = (_meta(b, h, t, d) for _ in range(3))
    lse = _meta(b, h, t, dtype=torch.float32)
    attn.flash_attention_fwd(q, q, q, True)
    attn.flash_attention_bwd(q, q, q, out, lse, do, True)
    qs = _meta(b * h, t, d)
    f32 = torch.float32
    acc = _meta(b * h, t, d, dtype=f32)
    m = _meta(b * h, t, 1, dtype=f32)
    attn.flash_attention_step(qs, qs, qs, acc, m, m, 0, 0)
    attn.flash_attention_bwd_step(qs, qs, qs, _meta(b * h, t, d, dtype=f32),
                                  m, m, 0, 0)
    calls = [(n, a) for n, a in fake_card.calls]
    assert [n for n, _ in calls] == [
        "gtt_flash_fwd", "gtt_flash_bwd", "gtt_flash_step",
        "gtt_flash_bwd_step_prep", "gtt_flash_bwd_step"]
    assert calls[0][1][6:8] == (b, h) and calls[1][1][12:14] == (b, h)
    assert calls[2][1][9] == b * h and calls[3][1][6] == b * h
    assert calls[4][1][14] == b * h


@pytest.mark.parametrize("d,dtype,error", [
    (264, torch.float16, ValueError), (512, torch.bfloat16, ValueError),
    (64, torch.float64, TypeError), (256, torch.float64, TypeError)])
def test_the_card_refuses_past_its_domain(fake_card, d, dtype, error):
    q = _meta(1, 2, 64, d, dtype=dtype)
    lse = _meta(1, 2, 64, dtype=torch.float32)
    with pytest.raises(error, match="head_dim" if error is ValueError
                       else "bf16, f16 or f32"):
        attn.flash_attention_fwd(q, q, q, True)
    with pytest.raises(error):
        attn.flash_attention_bwd(q, q, q, q, lse, q, True)
    qs = _meta(2, 64, d, dtype=dtype)
    f32 = torch.float32
    with pytest.raises(error):
        attn.flash_attention_step(qs, qs, qs, _meta(2, 64, d, dtype=f32),
                                  *(_meta(2, 64, 1, dtype=f32),) * 2, 0, 0)
    assert fake_card.calls == []


def test_every_multiple_of_8_up_to_256_has_an_instance():
    assert [attn.kernel_head_dim(d) for d in range(8, 257, 8)] == \
        [64] * 8 + [128] * 8 + [256] * 16
    assert attn.KERNEL_DTYPES == CODES
    assert attn.FLASH_BWD_KERNELS[torch.float16] == \
        attn.FLASH_BWD_KERNELS[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_overlap_plan_reads_a_transposed_16_bit_w_as_it_lies(dtype):
    """B5's plan: f16 stages like bf16 (64 depths per 128-byte slab, a
    transposed w read K-major without a copy) under code 2."""
    plan = overlap.launch_plan(dtype, 256, 256, 256, (256 * 256, 1, 256))
    assert (plan.slabs, plan.w_layout, plan.x_ld) == (4, "cols", 256)
    assert overlap.KERNEL_DTYPES[dtype] == CODES[dtype]
    t = torch.ones((4, 256, 256), dtype=dtype).transpose(1, 2)
    assert overlap._kernel_w(t) is t


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_close(ours, ref, dtype, kind):
    rtol, atol = TOL[str(dtype)[6:]][kind]
    _close(ours.cpu(), ref.float().cpu().numpy(), rtol, atol,
           relative=kind == "grad" and dtype != torch.float32)


def _held_rows(n):
    """The leading-axis slices held against the twin: all of them, or past
    a few thousand the first 4 and the last 4 (those beyond the grid's
    65535 rows among them; rows are independent, so the twin runs on the
    slice alone and the card keeps room for what else shares it)."""
    return [slice(0, n)] if n <= 4096 else [slice(0, 4), slice(n - 4, n)]


CARD_FLASH = [
    ("float16", 64, (8, 4, 4, 128), True),
    ("float16", 256, (8, 1, 1, 128), True),
    ("bfloat16", 256, (2, 4, 4, 256), False),
    ("float16", 200, (2, 8, 2, 256), True),
    ("float32", 256, (2, 2, 2, 100), False),
    ("bfloat16", 64, (16385, 4, 4, 64), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,shape,causal", CARD_FLASH)
def test_flash_instances_match_twins_on_card(cuda_device, dtype, d, shape,
                                             causal):
    tdtype = getattr(torch, dtype)
    b, h, h_kv, t = shape
    gen = torch.Generator(cuda_device).manual_seed(d + t)
    q, k, v, do = (torch.randn((b, n, t, d), generator=gen,
                               device=cuda_device).to(tdtype)
                   for n in (h, h_kv, h_kv, h))
    before = (attn.flash_attention_fwd.launches,
              attn.flash_attention_bwd.launches)
    out, lse = attn.flash_attention_fwd(q, k, v, causal)
    grads = attn.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (attn.flash_attention_fwd.launches,
            attn.flash_attention_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    for s in _held_rows(b):
        ref_out, _ = attn.flash_attention_plain(q[s], k[s], v[s], causal)
        _card_close(out[s], ref_out, tdtype, "out")
        plain = attn.flash_attention_bwd_plain(q[s], k[s], v[s], out[s],
                                               lse[s], do[s], causal)
        for a, r in zip(grads, plain):
            assert a[s].shape == r.shape and a.dtype == r.dtype
            _card_close(a[s], r, tdtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,group", STEPS + [("bfloat16", 64, 1)])
def test_step_instances_match_twins_on_card(cuda_device, dtype, d, group):
    """B6 and the fused B7 (an f32 cotangent split into hi and lo in q's
    dtype) at the new instances; the last case at 65 540 rows."""
    tdtype = getattr(torch, dtype)
    bh = 65540 if (dtype, d) == ("bfloat16", 64) else 8
    t = 64
    gen = torch.Generator(cuda_device).manual_seed(d + group)
    q = torch.randn((bh, t, d), generator=gen, device=cuda_device).to(tdtype)
    k, v = (torch.randn((bh // group, t, d), generator=gen,
                        device=cuda_device).to(tdtype) for _ in range(2))
    acc = torch.zeros((bh, t, d), device=cuda_device)
    m = torch.full((bh, t, 1), -math.inf, device=cuda_device)
    l = torch.zeros((bh, t, 1), device=cuda_device)
    got = attn.flash_attention_step(q, k, v, acc, m, l, t, t, True, group)
    do = torch.randn((bh, t, d), generator=gen, device=cuda_device)
    lse = got[1] + torch.log(got[2])
    delta = (do * (got[0] / got[2])).sum(-1, keepdim=True)
    args = (q, k, v, do, delta, lse, t, t, True, group)
    grads = attn.flash_attention_bwd_step(*args)
    for s in _held_rows(bh):
        kv = slice(s.start // group, s.stop // group)
        want = attn.flash_attention_step_plain(
            q[s], k[kv], v[kv], acc[s], m[s], l[s], t, t, True, group)
        _card_close(got[0][s], want[0], tdtype, "grad")
        plain = attn.flash_attention_bwd_step_plain(
            q[s], k[kv], v[kv], do[s], delta[s], lse[s], t, t, True, group)
        for a, r in zip(grads, plain):
            assert a[s].shape == r.shape
            _card_close(a[s], r, tdtype, "grad")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 4])
def test_collective_matmuls_at_f16_match_twins_on_card(cuda_device, n):
    from gloo_tpu_torch.tpu import make_mesh

    gen = torch.Generator(cuda_device).manual_seed(n)
    mesh = make_mesh({"x": n}, devices=[cuda_device] * n)
    rows, k, cols = 20 * n, 40, 100
    x = torch.randn((n, n * rows, k), generator=gen,
                    device=cuda_device).half()
    w = (torch.randn((n, k, cols), generator=gen, device=cuda_device)
         / math.sqrt(k)).half()
    out = overlap.matmul_reduce_scatter(x, w, "x", mesh)
    ref = overlap.matmul_reduce_scatter_plain(x, w, "x", mesh)
    _within_two_ulps(out.cpu(), ref.float().cpu().numpy())
    xs = x[:, :rows].contiguous()
    y, gx = overlap.allgather_matmul_fwd(xs, w, "x", mesh)
    ry, _ = overlap.allgather_matmul_plain(xs, w, "x", mesh)
    _within_two_ulps(y.cpu(), ry.float().cpu().numpy())
