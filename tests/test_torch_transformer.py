"""gloo_tpu_torch's Transformer and MLP against gloo_tpu's on the CPU.

The JAX model is initialised from PRNGKey(0); its parameter tree goes
through gloo_tpu_torch.weights into the port, so both run identical
weights on identical tokens. JAX's flash path runs the Pallas kernel in
interpret mode, the port's the kernel's plain twin.

Tolerances on logits (|logits| <= ~1.5 at these sizes): f32 rtol 1e-5 /
atol 1e-5 (sums in another order; ~4e-7 seen). bf16 rtol 2e-2 / atol 2e-2:
every activation is rounded to bf16, and XLA and PyTorch round elementwise
chains (GELU, RMSNorm) and products at different places, each difference
one bf16 ulp (2**-8 relative) that two layers carry on (~1.1e-2 seen at the
entry width, ~6e-3 at the small one).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from gloo_tpu.models import MLP as JaxMLP  # noqa: E402
from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu_torch import weights  # noqa: E402
from gloo_tpu_torch.entry import ENTRY_CONFIG, entry  # noqa: E402
from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig  # noqa: E402,E501

LOGIT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

SMALL = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=32)


def _pair(dtype="float32", **overrides):
    """(jax model, jax params, port model) with identical weights."""
    kw = {**SMALL, **overrides}
    jcfg = JaxConfig(dtype=jnp.dtype(dtype), **kw)
    jm = JaxTransformer(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=getattr(torch, dtype), **kw)
    tm = Transformer(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tm.load_state_dict(weights.transformer_params_from_numpy(tree, cfg,
                                                             "cpu"))
    return jm, jparams, tm


def _tokens(b, t, vocab, seed=0):
    toks = np.random.RandomState(seed).randint(0, vocab, (b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks,
                                                         dtype=torch.int32)


def _assert_logits_close(ours, ref, dtype):
    rtol, atol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("variant", [
    {},                                  # multi-head, learned positions
    {"n_kv_heads": 2},                   # GQA
    {"n_kv_heads": 1, "use_rope": True},  # multi-query with RoPE
])
def test_forward_matches_jax(dtype, flash, variant):
    jm, jparams, tm = _pair(dtype, use_flash_attention=flash, **variant)
    jt, tt = _tokens(2, 16, SMALL["vocab_size"])
    with torch.no_grad():
        ours = tm(tt)
    assert ours.dtype == torch.float32 and ours.shape == (2, 16, 64)
    _assert_logits_close(ours, jm.apply(jparams, jt), dtype)


def test_flash_gate_takes_materialized_path_off_multiples_of_8():
    # t = 12 is not a multiple of 8: both models take the materialized
    # path even with use_flash_attention set.
    jm, jparams, tm = _pair("float32", use_flash_attention=True)
    jt, tt = _tokens(2, 12, SMALL["vocab_size"], seed=4)
    with torch.no_grad():
        ours = tm(tt)
    _assert_logits_close(ours, jm.apply(jparams, jt), "float32")


def test_entry_width_matches_jax_entry():
    jfn, (jparams, jtokens) = __graft_entry__.entry()
    cfg = ENTRY_CONFIG
    tm = Transformer(cfg, device="cpu")
    tm.load_state_dict(weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    fn, (_, tokens) = entry("cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    ours = fn(tm, tokens)
    _assert_logits_close(ours, jax.jit(jfn)(jparams, jtokens), "bfloat16")


@pytest.mark.parametrize("variant", [{}, {"n_kv_heads": 2, "use_rope": True},
                                     {"n_kv_heads": 1}])
def test_decode_step_matches_full_forward(variant):
    _, _, tm = _pair("float32", **variant)
    _, tt = _tokens(2, 12, SMALL["vocab_size"])
    full = tm(tt).detach()
    cache = tm.init_cache(2, 12)
    steps = []
    for i in range(12):
        logits, cache = tm.decode_step(cache, tt[:, i])
        steps.append(logits)
    assert cache["len"] == 12
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_greedy_matches_jax(dtype):
    jm, jparams, tm = _pair(dtype, n_kv_heads=2, use_rope=True)
    jp, tp = _tokens(2, 4, SMALL["vocab_size"], seed=1)
    ours = tm.generate(tp, max_new=6)
    ref = np.asarray(jm.generate(jparams, jp, max_new=6))
    assert ours.shape == (2, 10) and ours.dtype == tp.dtype
    if dtype == "float32":
        np.testing.assert_array_equal(ours.numpy(), ref)
    # Self-consistency in either dtype: the first new token is the argmax
    # of the full forward at the last prompt position.
    with torch.no_grad():
        full = tm(tp)
    assert torch.equal(ours[:, 4], full[:, -1].argmax(-1).to(ours.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    # The served dtype is bf16, where greedy tokens may part at near-ties:
    # hold each cached step's logits against JAX's decode_step on the same
    # cache and tokens, within the file's logits tolerance.
    jm, jparams, tm = _pair(dtype, n_kv_heads=2, use_rope=True)
    jt, tt = _tokens(2, 10, SMALL["vocab_size"], seed=5)
    jcache, cache = jm.init_cache(2, 10), tm.init_cache(2, 10)
    for i in range(10):
        ref, jcache = jm.decode_step(jparams, jcache, jt[:, i])
        with torch.no_grad():
            ours, cache = tm.decode_step(cache, tt[:, i])
        assert ours.dtype == torch.float32 and ours.shape == (2, 64)
        _assert_logits_close(ours, ref, dtype)


def test_generate_sampling():
    _, _, tm = _pair("float32")
    _, tp = _tokens(2, 4, SMALL["vocab_size"], seed=2)
    greedy = tm.generate(tp, max_new=5)
    # top_k = 1 leaves only the argmax to sample.
    top1 = tm.generate(tp, max_new=5, temperature=0.7, top_k=1,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(top1, greedy)
    a, b = (tm.generate(tp, max_new=5, temperature=1.0, top_k=8,
                        generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < SMALL["vocab_size"]
    assert torch.equal(tm.generate(tp, max_new=0), tp)
    with pytest.raises(ValueError, match="generator"):
        tm.generate(tp, max_new=2, temperature=1.0)
    with pytest.raises(ValueError, match="temperature"):
        tm.generate(tp, max_new=2, temperature=-1.0)
    with pytest.raises(ValueError, match="top_k"):
        tm.generate(tp, max_new=2, top_k=0)


def test_cache_limits():
    _, _, tm = _pair("float32", n_kv_heads=1)
    assert tm.init_cache(1, 32)["k"][0].shape == (1, 1, 32, 16)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.init_cache(1, 33)
    cache = tm.init_cache(1, 2)
    for i in range(2):
        tm.decode_step(cache, torch.tensor([i]))
    with pytest.raises(ValueError, match="full"):
        tm.decode_step(cache, torch.tensor([2]))


@pytest.mark.parametrize("variant", [{}, {"n_kv_heads": 2, "use_rope": True}])
def test_weights_round_trip(variant):
    cfg = TransformerConfig(**SMALL, **variant)
    tree = jax.tree.map(
        np.asarray, JaxTransformer(JaxConfig(**SMALL, **variant)).init(
            jax.random.PRNGKey(1)))
    sd = weights.transformer_params_from_numpy(tree, cfg, "cpu")
    back = weights.transformer_params_to_numpy(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    tm = Transformer(cfg, device="cpu")
    tm.load_state_dict(sd)
    again = weights.transformer_params_to_numpy(tm.state_dict(), cfg)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_weights_reject_mismatched_config():
    tree = jax.tree.map(np.asarray, JaxTransformer(JaxConfig(**SMALL)).init(
        jax.random.PRNGKey(0)))
    gqa = TransformerConfig(**SMALL, n_kv_heads=2)
    with pytest.raises(ValueError, match="wqkv"):
        weights.transformer_params_from_numpy(tree, gqa, "cpu")
    rope = TransformerConfig(**SMALL, use_rope=True)
    with pytest.raises(ValueError, match="unexpected"):
        weights.transformer_params_from_numpy(tree, rope, "cpu")


def test_init_shapes_scales_and_seed():
    cfg = dataclasses.replace(ENTRY_CONFIG, n_kv_heads=2)
    a = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    jtree = jax.tree.map(np.asarray, JaxTransformer(JaxConfig(
        vocab_size=512, d_model=256, n_heads=4, n_layers=2, d_ff=1024,
        max_seq_len=128, n_kv_heads=2)).init(jax.random.PRNGKey(0)))
    ours = weights.transformer_params_to_numpy(a.state_dict(), cfg)
    for x, y in zip(jax.tree.leaves(ours), jax.tree.leaves(jtree)):
        assert x.shape == y.shape and x.dtype == y.dtype
        # Same scale: the spreads agree within sampling noise.
        assert abs(x.std() - y.std()) <= 0.1 * y.std() + 1e-6
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)


def test_mlp_matches_jax():
    sizes = (12, 32, 16, 4)
    jm = JaxMLP(sizes)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = MLP(sizes, device="cpu")
    tm.load_state_dict({
        f"layers.{i}.{name}": torch.from_numpy(np.array(layer[name]))
        for i, layer in enumerate(jparams) for name in ("w", "b")})
    rng = np.random.RandomState(0)
    x = rng.randn(8, 12).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        loss = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(jparams, x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss),
                               float(jm.loss(jparams, (x, y))), rtol=1e-5)
    fresh = MLP(sizes, device="cpu").init(torch.Generator().manual_seed(0))
    w, b = fresh.layers[0].w.detach(), fresh.layers[0].b.detach()
    assert float(b.abs().max()) == 0.0
    assert abs(float(w.std()) - (2 / 12) ** 0.5) < 0.1
