"""Flash attention at head dims other than the kernels' 64, 128 and 256.

The reference's flash_attention takes any head_dim (its tests run 16, 32
and 128; the dry run's dp x tp config has head_dim 8). The port's kernels
have instances for 64, 128 and 256, and past 256 wide kernels
(csrc/flash_wide.cuh) at d rounded up to a multiple of 8, in column parts
of 128. The wrappers zero-pad q, k and v (and dO, out and the carried
acc) along d up to the kernel's width (attention.kernel_head_dim) and
slice the results back, with the scale of the unpadded d. That is exact:
padded q and k columns add 0 to every score, padded v and dO columns fill
only output columns that are cut off, and delta gains only 0 * 0 terms.

On the CPU the twins run unpadded; they are held against the interpreted
JAX kernels at the reference tests' shapes (out, and dq/dk/dv from
jax.vjp with the same cotangent), at ANY_DIMS too (odd, not a multiple of
8, and past 256), with the step kernels, ring-flash and the flagship at
head widths 36 and 512. The padding itself is the card's path, followed
here on meta tensors with a fake library up to the launch: what reaches
the kernel is the instance's or the wide width with padded, contiguous
strides and the unpadded d's scale, and what comes back has q's head_dim.
The state a padded step returns (a view of its padded acc) is what the
next ring step takes, at odd widths too.

Tolerances are test_torch_attention.py's: f32 rtol 1e-4 / atol 1e-5
(other tiles, other sum orders); bf16 out rtol 1.6e-2 / atol 1e-2 (p and
out rounded to bf16, one flipped ulp allowed twice over); bf16 gradients
rtol 1.6e-2 / atol 8e-3 of the largest |reference| (p and ds rounded to
bf16 inside the sums). The flagship configurations take
test_torch_transformer.py's bf16 model tolerances (MODEL_TOL).

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
# Head dims no instance has: odd, not multiples of 8 (padded to the d 64
# instance), and past 256 (the wide kernels).
ANY_DIMS = [3, 12, 36, 264, 512]
# The flagship against the JAX model in bf16: logits (rtol, atol), then
# (loss rtol, per-tensor relative norm of each gradient), as
# test_torch_transformer.py holds it (bf16 activations through the layers).
MODEL_TOL = {"logits": (2e-2, 2e-2), "grads": (5e-4, 5e-2)}
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", ANY_DIMS)
def test_forward_and_grads_match_the_jax_kernel_at_any_head_dim(d, dtype):
    """The twins at ANY_DIMS against the interpreted JAX kernel, causal,
    GQA (4 query heads on 2 kv heads) at d 36."""
    jax = pytest.importorskip("jax")
    from gloo_tpu.ops import attention as jattn

    b, h, h_kv, t = (1, 4, 2, 32) if d == 36 else (1, 2, 2, 32)
    (jq, jk, jv), jg, (q, k, v, g) = _inputs(b, h, h_kv, t, d, dtype,
                                             seed=d)
    ref, vjp = jax.vjp(lambda *a: jattn.flash_attention(
        *a, causal=True, interpret=True), jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = attn.flash_attention(*leaves, causal=True)
    assert out.shape == (b, h, t, d) and out.dtype == q.dtype
    _close(out.detach(), ref.astype(np.float32), *TOL[dtype]["out"])
    grads = torch.autograd.grad(out, leaves, g)
    for ours, theirs in zip(grads, vjp(jg)):
        assert ours.shape == theirs.shape
        _close(ours, theirs.astype(np.float32), *TOL[dtype]["grad"],
               relative=dtype == "bfloat16")


def _step_inputs(bh, group, t, d, seed):
    """bf16 q (bh, t, d), k and v (bh / group, t, d), and an f32 dO, as
    (jax arrays, torch tensors)."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.RandomState(seed)
    js = [jnp.asarray(rng.randn(n, t, d).astype(np.float32), jnp.bfloat16)
          for n in (bh, bh // group, bh // group)]
    js.append(jnp.asarray(rng.randn(bh, t, d).astype(np.float32)))
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in js]
    return js, [x.to(torch.bfloat16) for x in ts[:3]] + [ts[3]]


@pytest.mark.parametrize("d", [25, 300])
def test_step_kernels_match_jax_at_any_head_dim(d):
    """B6 and B7's twins at an odd d and one past 256 against the
    interpreted JAX step kernels: two chained forward steps (a block wholly
    visible, then one on the diagonal, GQA 2), then the backward step of
    the second block from the completed state's lse and delta."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gloo_tpu.ops import attention as jattn

    bh, group, t = 4, 2, 32
    (jq, jk, jv, jdo), (q, k, v, do) = _step_inputs(bh, group, t, d, d)
    jstate = (jnp.zeros((bh, t, d), jnp.float32),
              jnp.full((bh, t, 1), -jnp.inf, jnp.float32),
              jnp.zeros((bh, t, 1), jnp.float32))
    state = tuple(torch.from_numpy(np.array(x)) for x in jstate)
    blocks = dict(block_q=t, block_k=t, interpret=True, kv_group=group)
    for qo, ko in ((t, 0), (t, t)):
        jstate = jattn.flash_attention_step(jq, jk, jv, *jstate, jnp.int32(qo),
                                            jnp.int32(ko), **blocks)
        state = attn.flash_attention_step(q, k, v, *state, qo, ko,
                                          kv_group=group)
        for a, r in zip(state, jstate):
            r = np.asarray(r)
            assert a.shape == r.shape
            _close(a, r, *TOL["bfloat16"]["grad"], relative=True)
    acc, m, l = state
    lse = m + torch.log(l)
    delta = (do * (acc / l).to(torch.bfloat16).float()).sum(-1, keepdim=True)
    jlse, jdelta = (jnp.asarray(x.numpy()) for x in (lse, delta))
    ref = jattn.flash_attention_bwd_step(jq, jk, jv, jdo, jdelta, jlse,
                                         jnp.int32(t), jnp.int32(t),
                                         **blocks)
    ours = attn.flash_attention_bwd_step(q, k, v, do, delta, lse, t, t,
                                         kv_group=group)
    for a, r in zip(ours, ref):
        r = np.asarray(r)
        assert a.shape == r.shape and a.dtype == torch.float32
        _close(a, r, *TOL["bfloat16"]["grad"], relative=True)


@pytest.mark.parametrize("d", [25, 300])
def test_ring_flash_attention_matches_jax_at_any_head_dim(d):
    """ring_flash_attention over 4 ranks at an odd d and one past 256, bf16,
    causal, GQA 2: the output and the grads of sum(sin(out)) against the
    reference's ring-flash in shard_map (interpreted, blocks of t_local)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gloo_tpu.parallel import sp as jsp
    from gloo_tpu.tpu import make_mesh as jax_make_mesh
    from gloo_tpu_torch.parallel import sp
    from gloo_tpu_torch.tpu import make_mesh

    n, b, h, h_kv, t_local = 4, 1, 2, 1, 16
    rng = np.random.RandomState(d)
    js = [jnp.asarray(rng.randn(b, x, n * t_local, d).astype(np.float32),
                      jnp.bfloat16) for x in (h, h_kv, h_kv)]
    jmesh = jax_make_mesh({"seq": n}, devices=jax.devices()[:n])

    def loss_j(q, k, v):
        out = jax.shard_map(
            lambda *a: jsp.ring_flash_attention(
                *a, "seq", causal=True, block_q=t_local, block_k=t_local,
                interpret=True),
            mesh=jmesh, in_specs=(P(None, None, "seq"),) * 3,
            out_specs=P(None, None, "seq"), check_vma=False)(q, k, v)
        return jnp.sum(jnp.sin(out)), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(*js)

    def world(x):  # global (b, h, t, d) -> (n, b, h, t_local, d)
        a = np.array(x.astype(jnp.float32)).reshape(b, -1, n, t_local, d)
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(2, 0, 1, 3, 4))).to(torch.bfloat16)

    def whole(w):  # and back, as f32 numpy
        return w.float().permute(1, 2, 0, 3, 4).reshape(
            b, -1, n * t_local, d).numpy()

    leaves = [world(x).requires_grad_() for x in js]
    out = sp.ring_flash_attention(*leaves, "seq", True, mesh=make_mesh(
        {"seq": n}, devices=["cpu"] * n))
    torch.sin(out).sum().backward()
    _close(torch.from_numpy(whole(out.detach())),
           np.asarray(ref, np.float32), *TOL["bfloat16"]["out"],
           relative=True)
    for leaf, r in zip(leaves, ref_grads):
        assert leaf.grad.dtype == torch.bfloat16
        _close(torch.from_numpy(whole(leaf.grad)), np.asarray(r, np.float32),
               *TOL["bfloat16"]["grad"], relative=True)


@pytest.mark.parametrize("name", ["D36_CONFIG", "D512_CONFIG"])
def test_head_width_configs_match_jax(name):
    """D36_CONFIG and D512_CONFIG at depth 1 and seq 32 (vocab 64, d_ff
    256; their head widths as they are): the JAX model with flash on,
    initialised from PRNGKey(0), its tree carried by gloo_tpu_torch.weights;
    logits, then the loss and every gradient of jax.value_and_grad."""
    jax = pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp
    from gloo_tpu.models import Transformer as JaxTransformer
    from gloo_tpu.models import TransformerConfig as JaxConfig
    from gloo_tpu_torch import entry, weights
    from gloo_tpu_torch.models import Transformer

    cfg = dataclasses.replace(getattr(entry, name), vocab_size=64,
                              n_layers=1, d_ff=256, max_seq_len=32)
    assert cfg.head_dim == {"D36_CONFIG": 36, "D512_CONFIG": 512}[name]
    jm = JaxTransformer(JaxConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len,
        dtype=jnp.bfloat16, use_flash_attention=True))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(cfg, device="cpu")
    tm.load_state_dict(weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 32))
    targets = np.roll(tokens, -1, axis=1)
    jt = jnp.asarray(tokens, jnp.int32)
    with torch.no_grad():
        logits = tm(torch.as_tensor(tokens, dtype=torch.int32))
    assert logits.shape == (2, 32, 64)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jm.apply(jparams, jt), np.float32),
        rtol=MODEL_TOL["logits"][0], atol=MODEL_TOL["logits"][1])
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, (jt, jnp.asarray(targets, jnp.int32)))
    loss = tm.loss(torch.as_tensor(tokens, dtype=torch.int32),
                   torch.as_tensor(targets, dtype=torch.int32))
    loss.backward()
    loss_rtol, grad_tol = MODEL_TOL["grads"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=loss_rtol)
    grads = weights.transformer_params_to_numpy(
        {n: p.grad for n, p in tm.named_parameters()}, tm.cfg)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, ref), ours in zip(flat, jax.tree.leaves(grads)):
        ref = np.asarray(ref, np.float32)
        rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        assert rel <= grad_tol, (jax.tree_util.keystr(path), rel)


def test_head_width_configs_are_the_flagship():
    from gloo_tpu_torch import entry

    for cfg, (d_model, heads) in ((entry.D36_CONFIG, (288, 8)),
                                  (entry.D512_CONFIG, (512, 1))):
        assert (cfg.d_model, cfg.n_heads) == (d_model, heads)
        assert cfg.dtype == torch.bfloat16 and cfg.use_flash_attention
        for field in ("vocab_size", "n_layers", "d_ff", "max_seq_len"):
            assert getattr(cfg, field) == getattr(entry.ENTRY_CONFIG, field)
    assert attn.kernel_head_dim(entry.D36_CONFIG.head_dim) == 64
    assert attn.kernel_head_dim(entry.D512_CONFIG.head_dim) == 512


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


@pytest.mark.parametrize("d,dim", [(8, 64), (48, 64), (64, 64), (96, 128),
                                   (3, 64), (12, 64), (36, 64), (200, 256)])
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


@pytest.mark.parametrize("d,dim", [(8, 64), (32, 64), (96, 128),
                                   (12, 64), (36, 64), (300, 304)])
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


@pytest.mark.parametrize("d,dim", [(32, 64), (96, 128), (25, 64),
                                   (300, 304), (263, 264)])
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
    """Head dims no instance has launch all the same (they raised before
    the wide kernels and the padding of any d): 12 on the padded d 64
    instance, 264 and 512 on the wide kernels as they are, the forward
    and the backward's one call. Only a head_dim below 1 is refused."""
    q = _meta(1, 2, 64, d)
    out, lse = attn.flash_attention_fwd(q, q, q, True)
    grads = attn.flash_attention_bwd(q, q, q, q, lse, q, True)
    assert out.shape == q.shape and all(x.shape == q.shape for x in grads)
    dim = {264: 264, 12: 64, 512: 512}[d]
    (fwd, a_fwd), (bwd, a_bwd) = fake_card.calls
    assert (fwd, a_fwd[10], bwd, a_bwd[16]) == ("gtt_flash_fwd", dim,
                                                "gtt_flash_bwd", dim)
    with pytest.raises(ValueError, match="head_dim"):
        attn.kernel_head_dim(0)


@pytest.mark.parametrize("d,dim", [(264, 264), (300, 304), (512, 512),
                                   (1024, 1024)])
def test_wide_head_dims_launch_the_wide_kernels(fake_card, d, dim):
    """Past 256 every entry launches at d rounded up to a multiple of 8
    (zero-padded where that is larger), with the scale of d. The step's
    acc stays d wide, and the accumulating backward's buffers take the
    wide width, as sp.py's carriers do."""
    assert attn.kernel_head_dim(d) == dim
    b, h, h_kv, t = 2, 4, 2, 72
    q, out, do = _meta(b, h, t, d), _meta(b, h, t, d), _meta(b, h, t, d)
    k, v = _meta(b, h_kv, t, d), _meta(b, h_kv, t, d)
    out_, lse = attn.flash_attention_fwd(q, k, v, True)
    dq, dk, dv = attn.flash_attention_bwd(q, k, v, out, lse, do, True)
    assert out_.shape == q.shape and (dq.shape, dk.shape) == (q.shape,
                                                              k.shape)
    bh, f32 = b * h, torch.float32
    qs, ks = _meta(bh, t, d), _meta(bh // 2, t, d)
    acc, m = _meta(bh, t, d, dtype=f32), _meta(bh, t, 1, dtype=f32)
    state = attn.flash_attention_step(qs, ks, ks, acc, m, m, 0, 0,
                                      kv_group=2)
    assert state[0].shape == (bh, t, d)
    grads = attn.flash_attention_bwd_step(qs, ks, ks, acc, m, m, 0, 0,
                                          kv_group=2)
    assert [x.shape for x in grads] == [(bh, t, d), (bh, t, d), (bh, t, d)]
    cot = attn.prepare_bwd_step(qs, acc, m, m)
    bufs = (_meta(bh, t, dim, dtype=f32),
            *(_meta(bh // 2, t, dim, dtype=f32) for _ in range(2)))
    attn.flash_attention_bwd_step_into(qs, ks, ks, cot, 0, 0, *bufs,
                                       kv_group=2)
    scale = attn._folded_scale(d, torch.bfloat16)
    calls = fake_card.calls
    assert [n for n, _ in calls] == [
        "gtt_flash_fwd", "gtt_flash_bwd", "gtt_flash_step",
        "gtt_flash_bwd_step_prep", "gtt_flash_bwd_step",
        "gtt_flash_bwd_step_prep", "gtt_flash_bwd_step"]
    assert calls[0][1][10] == dim and calls[0][1][12] == scale
    assert calls[1][1][16] == dim and calls[1][1][18] == scale
    assert calls[2][1][13:15] == (dim, d) and calls[2][1][16] == scale
    assert calls[3][1][8] == dim and calls[4][1][19] == dim
    assert calls[6][1][15:17] == (2, 2) and calls[6][1][21] == 1


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
@pytest.mark.parametrize("d", HEAD_DIMS + ANY_DIMS)
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
@pytest.mark.parametrize("d", [32, 96, 25, 300])
def test_ring_flash_attention_at_head_dims_matches_plain_on_card(
        cuda_device, d):
    """The ring-flash path at a padded or wide head_dim: 4 ring steps,
    each B6 launch taking the state the one before returned, then the
    ring backward, against the same path on CPU tensors (the step
    twins)."""
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
@pytest.mark.parametrize("d", [16, 96, 25, 300, 512])
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
