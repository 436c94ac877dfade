"""gloo_tpu_torch.parallel.pp against gloo_tpu.parallel.pp, on a CPU world.

The JAX schedules run inside shard_map over a CPU mesh of 4 devices
("pipe"), as tests/test_parallel.py runs them; the port's over
make_mesh({"pipe": 4}, devices=["cpu"] * 4), every stage in one call on
world tensors. Inputs come from numpy seeds; the transformer stage's
weights from the JAX init, converted with gloo_tpu_torch.weights.

Tolerances (f32): rtol 1e-5 / atol 1e-6 throughout. The schedules add
the same terms in the same order; what differs is the order of sums inside
the products and the attention (the port's flash twin against the
interpreted Pallas kernel for the transformer stage, the JAX model's own
_rmsnorm, _attention and _mlp there), which leaves at most ~3e-7 absolute
on outputs and gradients of magnitude ~1. (The reference's own 1F1B test
holds the schedule against jax.grad to rtol 2e-4.)

The transformer stage's JAX 1F1B runs with check_vma=False: the
interpreted Pallas flash VJP fails shard_map's varying-manual-axes check
("Custom VJP bwd rule must produce an output with the same type"), the
reference-side fault the dry run also steps around.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.parallel import pipeline_apply as jax_apply  # noqa: E402
from gloo_tpu.parallel import pipeline_train_1f1b as jax_1f1b  # noqa: E402
from gloo_tpu.parallel.pp import _build_1f1b_tables as jax_tables  # noqa: E402,E501
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import weights  # noqa: E402
from gloo_tpu_torch.entry import (  # noqa: E402
    ENTRY_CONFIG,
    PP_MESH,
    PP_MICROBATCHES,
    PP_STAGES,
    pp_entry,
)
from gloo_tpu_torch.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
    _rmsnorm,
    world_block,
)
from gloo_tpu_torch.parallel import pp  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

STAGES = 4
D = 6


def _mesh():
    return make_mesh({"pipe": STAGES}, devices=["cpu"] * STAGES)


def _jax_mesh():
    return jax_make_mesh({"pipe": STAGES}, devices=jax.devices()[:STAGES])


def _world(x):
    """Every rank's row the same (P, ...) view of x, as shard_map's P()."""
    x = torch.as_tensor(x)
    return x.expand(STAGES, *x.shape)


def _tanh_stage(w, h):
    return torch.tanh(torch.matmul(h, w))


def _jax_tanh_stage(w, h):
    return jnp.tanh(h @ w)


def _mse(out, target):
    return ((out - target) ** 2).mean(tuple(range(1, out.dim())))


def _jax_mse(out, target):
    return jnp.mean((out - target) ** 2)


@pytest.mark.parametrize("stages,m", [(2, 3), (4, 8), (4, 4), (8, 8),
                                      (3, 12), (4, 3)])
def test_1f1b_tables_equal_jax(stages, m):
    fwd, bwd = pp._build_1f1b_tables(stages, m)
    jfwd, jbwd = jax_tables(stages, m)
    assert fwd.dtype == jfwd.dtype and bwd.dtype == jbwd.dtype
    np.testing.assert_array_equal(fwd, jfwd)
    np.testing.assert_array_equal(bwd, jbwd)


@pytest.mark.parametrize("m", [3, 5, 8])
def test_pipeline_apply_matches_jax(m):
    rng = np.random.RandomState(7)
    ws = rng.randn(STAGES, 8, 8).astype(np.float32) * 0.3
    x = rng.randn(m, 4, 8).astype(np.float32)

    f = jax.jit(jax.shard_map(
        lambda w, xs: jax_apply(_jax_tanh_stage, w[0], xs, "pipe"),
        mesh=_jax_mesh(), in_specs=(P("pipe"), P()), out_specs=P("pipe")))
    want = np.asarray(f(ws, x)).reshape(STAGES, m, 4, 8)
    got = pp.pipeline_apply(_tanh_stage, torch.from_numpy(ws), _world(x),
                            "pipe", mesh=_mesh())
    assert got.shape == (STAGES, m, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # Zeros off the last stage, the stages applied in order on it.
    assert not got[:-1].any()
    expected = x
    for s in range(STAGES):
        expected = np.tanh(expected @ ws[s])
    np.testing.assert_allclose(got[-1].numpy(), expected, rtol=1e-5,
                               atol=1e-6)


def _jax_1f1b(stage_fn, loss_fn, params, x, y, check_vma=True):
    def shard_fn(w_stage, xs, ys):
        w = jax.tree.map(lambda a: a[0], w_stage)
        grads, loss = jax_1f1b(stage_fn, loss_fn, w, xs, ys, "pipe")
        return jax.tree.map(lambda g: g[None], grads), loss[None]

    f = jax.jit(jax.shard_map(
        shard_fn, mesh=_jax_mesh(), in_specs=(P("pipe"), P(), P()),
        out_specs=(P("pipe"), P("pipe")), check_vma=check_vma))
    return f(params, x, y)


@pytest.mark.parametrize("m", [3, 4, 8])
def test_1f1b_matches_jax_tanh_stage(m):
    rng = np.random.RandomState(11)
    ws = rng.randn(STAGES, D, D).astype(np.float32) * 0.4
    x = rng.randn(m, 4, D).astype(np.float32)
    y = rng.randn(m, 4, D).astype(np.float32)
    jgrads, jloss = _jax_1f1b(_jax_tanh_stage, _jax_mse, ws, x, y)
    grads, loss_sum = pp.pipeline_train_1f1b(
        _tanh_stage, _mse, torch.from_numpy(ws), _world(x), _world(y),
        "pipe", mesh=_mesh())
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss_sum.numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-6)
    assert not loss_sum[:-1].any()


SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=STAGES, d_ff=64,
             max_seq_len=16, use_flash_attention=True)


def test_1f1b_matches_jax_transformer_stage():
    """The 1F1B step with one pre-norm transformer block per stage: d_model
    32, 4 heads of 8, M = 8, flash attention on both sides."""
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **SMALL))
    tree = jm.init(jax.random.PRNGKey(0))
    jlayers = jax.tree.map(lambda *a: jnp.stack(a), *tree["layers"])

    def jax_stage(layer, h):
        h = h + jm._attention(layer, jm._rmsnorm(h, layer["ln1"]["scale"]))
        return h + jm._mlp(layer, jm._rmsnorm(h, layer["ln2"]["scale"]))

    m, t, d = 8, SMALL["max_seq_len"], SMALL["d_model"]
    rng = np.random.RandomState(5)
    x = rng.randn(m, 2, t, d).astype(np.float32)
    y = rng.randn(m, 2, t, d).astype(np.float32)
    jgrads, jloss = _jax_1f1b(jax_stage, _jax_mse, jlayers, x, y,
                              check_vma=False)

    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    stages = weights.pipeline_stages_from_numpy(
        jax.tree.map(np.asarray, tree), cfg, _mesh())
    grads, loss_sum = pp.pipeline_train_1f1b(
        functools.partial(world_block, cfg), _mse, stages, _world(x),
        _world(y), "pipe", mesh=_mesh())
    np.testing.assert_allclose(loss_sum.numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-6)
    want = {"ln1.scale": jgrads["ln1"]["scale"],
            "ln2.scale": jgrads["ln2"]["scale"]}
    want.update({k: jgrads[k] for k in ("wqkv", "wo", "w_up", "w_down")})
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kw,t", [
    ({}, 16), ({"use_flash_attention": False}, 16), ({}, 12),
    ({"use_rope": True}, 16), ({"n_kv_heads": 2}, 16)],
    ids=["flash", "scores", "t12_scores", "rope", "gqa"])
def test_world_block_is_the_transformer_block(kw, t):
    """world_block on a world of 2 stages is, on each row, the pre-norm
    block of Transformer.forward with that stage's layer: flash (a t that
    divides by 8) and the materialized scores, RoPE, GQA. f32: the
    world's batched products sum like the one model's, rtol 1e-5 / atol
    1e-6."""
    cfg = TransformerConfig(**{**SMALL, "n_layers": 2, "dtype": torch.float32,
                               **kw})
    model = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    mesh = make_mesh({"pipe": 2}, devices=["cpu"] * 2)
    stages = weights.pipeline_stages_from_numpy(
        weights.transformer_params_to_numpy(model.state_dict(), cfg), cfg,
        mesh)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 3, t, cfg.d_model).astype(np.float32))
    got = world_block(cfg, stages, x)
    with torch.no_grad():
        for r, layer in enumerate(model.layers):
            y = x[r] + model._attention(layer, _rmsnorm(x[r],
                                                        layer.ln1.scale))
            y = y + model._mlp(layer, _rmsnorm(y, layer.ln2.scale))
            torch.testing.assert_close(got[r], y, rtol=1e-5, atol=1e-6)


def _sequential(stage_fn, stages, x):
    """x (1, ...) through every stage in turn, each stage's own weights."""
    for s in range(PP_STAGES):
        x = stage_fn({k: v[s:s + 1] for k, v in stages.items()}, x)
    return x


def test_pp_entry_on_cpu_matches_the_sequential_composition():
    """pp_entry("cpu"): the flagship's width at depth 4, bf16 activations,
    8 microbatches. GPipe's last stage is bitwise the 4 blocks applied in
    sequence (the same per-row arithmetic: the world's batched products
    and flash over its P sequences take each row alone on the CPU); the
    1F1B gradients and loss_sum are autograd of that composition summed
    over the microbatches, to f32 rounding of the sums (rtol 1e-5 on the
    loss, 1e-5 relative in norm on each gradient)."""
    paths = pp_entry("cpu")
    fn, (stage_fn, stages, xs, mesh) = paths["gpipe"]
    assert mesh.shape == PP_MESH
    assert xs.shape == (PP_STAGES, PP_MICROBATCHES, 1,
                        ENTRY_CONFIG.max_seq_len, ENTRY_CONFIG.d_model)
    assert xs.dtype == torch.bfloat16
    out = fn(stage_fn, stages, xs, mesh)
    ref = torch.cat([_sequential(stage_fn, stages, xs[:1, i])
                     for i in range(PP_MICROBATCHES)])
    assert torch.equal(out[-1], ref)

    fn, (stage_fn, loss_fn, stages, xs, ys, mesh) = paths["1f1b"]
    grads, loss_sum = fn(stage_fn, loss_fn, stages, xs, ys, mesh)
    leaves = {k: v.clone().requires_grad_() for k, v in stages.items()}
    total = sum(loss_fn(_sequential(stage_fn, leaves, xs[:1, i]),
                        ys[:1, i]).sum() for i in range(PP_MICROBATCHES))
    total.backward()
    assert not loss_sum[:-1].any()
    np.testing.assert_allclose(float(loss_sum[-1]), float(total.detach()),
                               rtol=1e-5)
    for name, leaf in leaves.items():
        rel = float((grads[name] - leaf.grad).norm() / leaf.grad.norm())
        assert rel < 1e-5, (name, rel)


def test_pipeline_rejects_what_it_does_not_take():
    ws = torch.zeros(STAGES, D, D)
    with pytest.raises(ValueError, match="world tensor"):
        pp.pipeline_apply(_tanh_stage, ws, torch.zeros(3, 4, D), "pipe",
                          mesh=_mesh())
    with pytest.raises(ValueError, match="world tensor"):
        pp.pipeline_train_1f1b(_tanh_stage, _mse, ws,
                               torch.zeros(STAGES, 3, 4, D),
                               torch.zeros(2, 3, 4, D), "pipe", mesh=_mesh())
    cfg = dataclasses.replace(TransformerConfig(**SMALL), n_layers=2)
    tree = {"embed": np.zeros((64, 32)), "pos": np.zeros((16, 32)),
            "ln_f": {"scale": np.ones(32)},
            "layers": [{"ln1": {"scale": np.ones(32)},
                        "ln2": {"scale": np.ones(32)},
                        "wqkv": np.zeros((32, 96)), "wo": np.zeros((32, 32)),
                        "w_up": np.zeros((32, 64)),
                        "w_down": np.zeros((64, 32))}] * 2}
    with pytest.raises(ValueError, match="one layer per rank"):
        weights.pipeline_stages_from_numpy(tree, cfg, _mesh())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pp_entry_on_the_card(cuda_device):
    """pp_entry() on the card: GPipe's last stage against the sequential
    composition (bf16: rtol 2e-2 in norm, the batched and single products
    may round differently), the 1F1B loss within 1e-3 and its gradients
    within 2e-2 in norm of autograd of that composition."""
    paths = pp_entry(cuda_device)
    fn, (stage_fn, stages, xs, mesh) = paths["gpipe"]
    out = fn(stage_fn, stages, xs, mesh)
    ref = torch.cat([_sequential(stage_fn, stages, xs[:1, i])
                     for i in range(PP_MICROBATCHES)])
    rel = float((out[-1].float() - ref.float()).norm() / ref.float().norm())
    assert rel < 2e-2
    fn, (stage_fn, loss_fn, stages, xs, ys, mesh) = paths["1f1b"]
    grads, loss_sum = fn(stage_fn, loss_fn, stages, xs, ys, mesh)
    leaves = {k: v.clone().requires_grad_() for k, v in stages.items()}
    total = sum(loss_fn(_sequential(stage_fn, leaves, xs[:1, i]),
                        ys[:1, i]).sum() for i in range(PP_MICROBATCHES))
    total.backward()
    total = float(total.detach())
    assert abs(float(loss_sum[-1]) - total) <= 1e-3 * total
    for name, leaf in leaves.items():
        rel = float((grads[name] - leaf.grad).norm() / leaf.grad.norm())
        assert rel < 2e-2, (name, rel)
