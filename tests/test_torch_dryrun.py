"""entry.dryrun_multichip against __graft_entry__.dryrun_multichip.

At n = 8 (tests/conftest.py gives 8 CPU devices) the port's sections are
held on values against the reference's sections that need no Pallas
interpreter, each built as the reference builds it (its shapes, inputs,
shard_map specs): ring attention, GPipe, the 1F1B step, dispatch_combine
and FSDP, f32 throughout (rtol 1e-6, atol 1e-7: the same few adds in
another order at most). The dp x tp step is held at rtol 1e-5 on its loss,
with the reference's weights (the JAX init at PRNGKey(0), converted with
gloo_tpu_torch.weights) and the JAX step built as tests/test_torch_dp_tp.py
builds it, both in f32; the dry run itself keeps the reference's bf16. The
Pallas sections (Ulysses, the fused pair and its *_auto arms, the ring
variants) are held at n <= 8 by test_torch_sp.py, test_torch_overlap.py,
test_torch_tp.py and test_torch_ring_variants.py; here the port's dry run
runs them with the reference's asserts.

At n = 64 the port's dry run runs whole on the CPU with the reference's
asserts (there is no JAX oracle past 32 ranks: the interpreted reference
kernels over 33 CPU devices do not finish in minutes), and its results
are held to what the reference's inputs imply: every token doubled by its
expert, the FSDP loss 0.04 on every rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from __graft_entry__ import _shard_map  # noqa: E402
from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.parallel import (dispatch_combine, make_fsdp_train_step,  # noqa: E402,E501
                               pipeline_apply, pipeline_train_1f1b,
                               ring_attention, shard_params)
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import entry  # noqa: E402

N = 8
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ours():
    """The port's dry run at n = 8 on the CPU (its own asserts run)."""
    return entry.dryrun_multichip(N, device="cpu")


def _flat():
    return jax_make_mesh({"x": N}, devices=jax.devices()[:N])


def _run(fn, in_specs, out_specs, *args, check_vma=True):
    return jax.jit(_shard_map(fn, mesh=_flat(), in_specs=in_specs,
                              out_specs=out_specs,
                              check_vma=check_vma))(*args)


def _tanh(p, h):
    return jnp.tanh(h @ p)


def _jax_section(name):
    """The reference's section `name` at n = 8, as dryrun_multichip runs
    it."""
    n = N
    if name == "ring_attention":
        q = jnp.ones((1, 1, 8 * n, 4), jnp.float32)
        return _run(lambda a, b, c: ring_attention(a, b, c, "x"),
                    (P(None, None, "x"),) * 3, P(None, None, "x"), q, q, q)
    ws = jnp.ones((n, 4, 4), jnp.float32) * 0.1
    if name == "gpipe":
        xs = jnp.ones((3, 2, 4), jnp.float32)
        return _run(lambda w, x: pipeline_apply(_tanh, w[0], x, "x"),
                    (P("x"), P()), P("x"), ws, xs)
    if name == "1f1b":
        xs = jnp.ones((n + 2, 2, 4), jnp.float32)
        ys = jnp.zeros((n + 2, 2, 4), jnp.float32)

        def train(w, x, y):
            g, loss = pipeline_train_1f1b(
                _tanh, lambda o, t: jnp.mean((o - t) ** 2), w[0], x, y, "x")
            return g[None], loss[None]

        return _run(train, (P("x"), P(), P()), (P("x"), P("x")), ws, xs, ys)
    if name == "dispatch_combine":
        toks = jnp.ones((n * 4, 8), jnp.float32)
        idx = jnp.zeros((n * 4,), jnp.int32)
        return _run(lambda t, i: dispatch_combine(lambda x: x * 2.0, t, i, 8,
                                                  "x"),
                    (P("x"), P("x")), P("x"), toks, idx)
    assert name == "fsdp"
    params = {"w": jnp.ones((8, 4), jnp.float32) * 0.1,
              "b": jnp.zeros((4,), jnp.float32)}
    step = make_fsdp_train_step(
        lambda p, batch: jnp.mean((batch[0] @ p["w"] + p["b"] - batch[1])
                                  ** 2), params, "x")
    fx = jnp.ones((2 * n, 8), jnp.float32)
    fy = jnp.ones((2 * n, 4), jnp.float32)

    def run(p, x, y):
        return step(shard_params(p, "x"), (x, y))[1]

    return _run(run, (P(), P("x"), P("x")), P(), params, fx, fy,
                check_vma=False)


def _ours_as_jax(name, out):
    """The port's world tensors in the layout of the reference's result."""
    if name == "ring_attention":
        return out.permute(1, 2, 0, 3, 4).reshape(1, 1, 8 * N, 4)
    if name in ("gpipe", "dispatch_combine"):
        return out.reshape(-1, *out.shape[2:])
    if name == "fsdp":
        assert torch.equal(out, out[:1].expand_as(out))
        return out[0]
    return out


@pytest.mark.parametrize("name", ["ring_attention", "gpipe", "1f1b",
                                  "dispatch_combine", "fsdp"])
def test_sections_match_the_reference_at_8(ours, name):
    ref = _jax_section(name)
    got = ours[name]
    if name == "1f1b":
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
        return
    np.testing.assert_allclose(_ours_as_jax(name, got).numpy(),
                               np.asarray(ref), **TOL)


def test_pallas_sections_run_with_the_reference_asserts_at_8(ours):
    """Ulysses and the fused pair are finite and of the reference's shapes
    (their values are held at n <= 8 by their own files); the *_auto arms
    were held within rtol 1e-5 of the fused pair and the ring variants to
    the sum inside the dry run."""
    assert tuple(ours["ulysses"].shape) == (N, 1, N, 8, 4)
    assert tuple(ours["fused"].shape) == (N, 8, 128)
    for key in ("ulysses", "fused", "fused_auto", "unfused_auto", "q8",
                "bidir", "hbm"):
        assert torch.isfinite(ours[key]).all(), key
    assert tuple(ours["q8"].shape) == (N, 32 * N, 128)


def test_dp_tp_step_matches_the_gspmd_step_at_8():
    """One dp x tp Adam step at dryrun_config(8) ({"data": 2, "model": 4},
    d_model 32, 4 heads), f32 on both sides, from the reference's init."""
    axes, cfg = entry.dryrun_config(N)
    assert axes == {"data": 2, "model": 4}
    jcfg = JaxConfig(**{**dataclasses.asdict(cfg), "dtype": jnp.float32})
    jm = JaxTransformer(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    numpy_params = jax.tree.map(np.asarray, jparams)
    mesh = jax_make_mesh(axes, devices=jax.devices()[:N])

    def layer_spec(_):
        return {"ln1": {"scale": P()}, "ln2": {"scale": P()},
                "wqkv": P(None, "model"), "wo": P("model", None),
                "w_up": P(None, "model"), "w_down": P("model", None)}

    specs = {"embed": P(), "pos": P(), "ln_f": {"scale": P()},
             "layers": [layer_spec(layer) for layer in jparams["layers"]]}
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    jparams = jax.tree.map(jax.device_put, jparams, shardings)
    optimizer = optax.adam(1e-3)
    state = optimizer.init(jparams)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2 * axes["data"], cfg.max_seq_len)).astype(
            np.int32)
    batch = NamedSharding(mesh, P("data"))

    @jax.jit
    def step(params, state, tokens, targets):
        loss, grads = jax.value_and_grad(jm.loss)(params, (tokens, targets))
        updates, state = optimizer.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    _, _, jloss = step(jparams, state, jax.device_put(tokens, batch),
                       jax.device_put(np.roll(tokens, -1, axis=1), batch))
    loss = entry.dryrun_dp_tp(N, "cpu", params=numpy_params,
                              dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_dryrun_config_scales_as_the_reference():
    """__graft_entry__.py:125-135 at n = 8, 63 and 64."""
    for n, axes, heads, d_model in ((8, {"data": 2, "model": 4}, 4, 32),
                                    (63, {"data": 1, "model": 63}, 64, 504),
                                    (64, {"data": 2, "model": 32}, 32, 256)):
        got_axes, cfg = entry.dryrun_config(n)
        assert got_axes == axes
        assert (cfg.n_heads, cfg.d_model, cfg.d_ff) == (heads, d_model,
                                                        2 * d_model)
        assert (cfg.vocab_size, cfg.n_layers, cfg.max_seq_len) == (128, 2,
                                                                   16)
        assert cfg.dtype == torch.bfloat16


def test_dryrun_at_64_ranks_on_the_cpu():
    """The whole dry run at 64 ranks: the reference's asserts run inside it
    (finite dp x tp loss; q8 within 5% and bitwise the same on every rank;
    B9 and B11 within rtol 1e-5 of the sum's largest value; the *_auto arms
    within rtol 1e-5 of the fused pair)."""
    out = entry.dryrun_multichip(64, device="cpu")
    assert torch.isfinite(out["dp_tp"])
    assert torch.equal(out["dispatch_combine"],
                       torch.full((64, 4, 8), 2.0))
    torch.testing.assert_close(out["fsdp"], torch.full((64,), 0.04))
    assert tuple(out["ulysses"].shape) == (64, 1, 64, 8, 4)
    assert tuple(out["fused"].shape) == (64, 8, 128)
    grads, loss = out["1f1b"]
    assert tuple(grads.shape) == (64, 4, 4) and tuple(loss.shape) == (64,)
