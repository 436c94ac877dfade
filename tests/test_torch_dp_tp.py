"""gloo_tpu_torch.parallel.dp_tp against the GSPMD dp x tp step of
__graft_entry__.dryrun_multichip, on a CPU world {"data": 2, "model": 2}.

The JAX step is built as dryrun_multichip builds it: the parameters placed
with NamedSharding per its layer_spec (wqkv, w_up column-parallel; wo,
w_down row-parallel; the rest replicated) over a 4-device CPU mesh, the
batch sharded over "data", a jitted value_and_grad(model.loss) and
optax.adam(1e-3). The port's step runs the TPTransformer over a CPU world
of 4 ranks (B1, B2, B3 as their plain twins). Both start from the same JAX
init, converted with gloo_tpu_torch.weights. f32 throughout.

The JAX side runs with use_flash_attention=True: the interpreted Pallas
flash kernel and its custom VJP go through the sharded jit (unlike
shard_map, jit does not check varying manual axes). The port's side runs
its flash path too (the kernels' twins).

Tolerances, with the reasoning of tests/test_torch_ddp.py: the per-rank
arithmetic agrees to ~1e-6 relative (sums in another order: the row-
parallel partials are summed in ring order here and in XLA's order
there), so the loss agrees to rtol 1e-5 and the parameters after three
Adam(1e-3) steps to atol 1e-5 (Adam moves each parameter by about lr per
step whatever the gradient's size).
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

from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import weights  # noqa: E402
from gloo_tpu_torch.entry import (  # noqa: E402
    ADAM_SETTINGS,
    DP_TP_MESH,
    ENTRY_CONFIG,
    dp_tp_train_entry,
    train_entry,
    train_step,
)
from gloo_tpu_torch.models import Transformer, TransformerConfig  # noqa: E402,E501
from gloo_tpu_torch.ops import attention as attn  # noqa: E402
from gloo_tpu_torch.ops import overlap, ring  # noqa: E402
from gloo_tpu_torch.parallel import dp_tp  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

SMALL = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=32, use_flash_attention=True)
BATCH = 4


def _mesh():
    return make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)


def _jax_step(jm, params):
    """dryrun_multichip's step and shardings on a 4-device CPU mesh."""
    mesh = jax_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])

    def layer_spec(_):
        return {"ln1": {"scale": P()}, "ln2": {"scale": P()},
                "wqkv": P(None, "model"), "wo": P("model", None),
                "w_up": P(None, "model"), "w_down": P("model", None)}

    specs = {"embed": P(), "pos": P(), "ln_f": {"scale": P()},
             "layers": [layer_spec(layer) for layer in params["layers"]]}
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    params = jax.tree.map(jax.device_put, params, shardings)
    optimizer = optax.adam(1e-3)
    state = optimizer.init(params)
    batch_sharding = NamedSharding(mesh, P("data"))

    @jax.jit
    def step(params, state, tokens, targets):
        loss, grads = jax.value_and_grad(jm.loss)(params, (tokens, targets))
        updates, state = optimizer.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    def run(params, state, tokens, targets):
        return step(params, state, jax.device_put(tokens, batch_sharding),
                    jax.device_put(targets, batch_sharding))

    return params, state, run


def test_step_matches_the_gspmd_jax_step():
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **SMALL))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    mesh = _mesh()
    model = weights.tp_transformer_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, mesh)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    step = dp_tp.make_dp_tp_train_step(mesh)
    jparams, jstate, jstep = _jax_step(jm, jparams)
    rng = np.random.RandomState(0)
    for _ in range(3):
        tokens = rng.randint(0, cfg.vocab_size, (BATCH, 32)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        jparams, jstate, jloss = jstep(jparams, jstate, tokens, targets)
        loss = step(model, optimizer, torch.from_numpy(tokens),
                    torch.from_numpy(targets))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    ours = dp_tp.unshard_transformer(model)
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def _small(dtype=torch.float32, **kw):
    cfg = TransformerConfig(dtype=dtype, **{**SMALL, **kw})
    return cfg, Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2, "use_rope": True}])
def test_shard_and_unshard_round_trip_bitwise(kw):
    cfg, model = _small(**kw)
    mesh = _mesh()
    tp_model = dp_tp.shard_transformer(model, mesh)
    back = dp_tp.unshard_transformer(tp_model)
    state = model.state_dict()
    assert set(back) == set(state)
    for name, x in state.items():
        assert torch.equal(back[name], x), name
    # Rank r holds its model index's heads: q, k, v columns of its heads.
    hd = cfg.head_dim
    wqkv = tp_model.layers[0].wqkv
    full = model.layers[0].wqkv
    for r, i in enumerate(mesh.ring_index("model")):
        assert torch.equal(wqkv[r][:, :2 * hd], full[:, 2 * i * hd:
                                                       2 * (i + 1) * hd])


def test_step_equals_train_step_on_the_whole_batch():
    """The global mean loss and the reassembled gradients of one dp x tp
    step equal train_step's over the whole batch (f32)."""
    cfg, model = _small()
    mesh = _mesh()
    tp_model = dp_tp.shard_transformer(model, mesh)
    optimizer = torch.optim.SGD(tp_model.parameters(), lr=0.1)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 32), generator=gen,
                           dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    loss = dp_tp.make_dp_tp_train_step(mesh)(tp_model, optimizer, tokens,
                                             targets)
    ref = train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                     tokens, targets)
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    grads = dp_tp.unshard_state(
        {n: p.grad for n, p in tp_model.named_parameters()}, cfg, mesh)
    for name, p in model.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-5,
                                   atol=1e-7, msg=name)
    after = dp_tp.unshard_transformer(tp_model)
    for name, p in model.named_parameters():
        torch.testing.assert_close(after[name], p.detach(), rtol=0,
                                   atol=1e-6, msg=name)


def _assert_replicas_and_shards_equal(tp_model, mesh):
    """Replicated copies bitwise equal on every rank, shards bitwise equal
    across data ranks (ranks with the same model index)."""
    model_index = mesh.ring_index("model")
    for name, p in tp_model.named_parameters():
        for r in range(1, mesh.size):
            if name.split(".")[-1] in dp_tp.SHARDED:
                twin = model_index.index(model_index[r])
                assert torch.equal(p[r], p[twin]), (name, r)
            else:
                assert torch.equal(p[r], p[0]), (name, r)


def test_replicas_and_shards_stay_bitwise_equal():
    cfg, model = _small(dtype=torch.bfloat16)
    mesh = _mesh()
    tp_model = dp_tp.shard_transformer(model, mesh)
    optimizer = torch.optim.Adam(tp_model.parameters(), **ADAM_SETTINGS)
    step = dp_tp.make_dp_tp_train_step(mesh)
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 32), generator=gen,
                           dtype=torch.int32)
    losses = [float(step(tp_model, optimizer, tokens, tokens.roll(-1, 1)))
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    _assert_replicas_and_shards_equal(tp_model, mesh)


def test_step_rejects_what_it_does_not_take():
    cfg, model = _small()
    mesh = _mesh()
    tp_model = dp_tp.shard_transformer(model, mesh)
    optimizer = torch.optim.SGD(tp_model.parameters(), lr=0.1)
    step = dp_tp.make_dp_tp_train_step(mesh)
    tokens = torch.zeros((3, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        step(tp_model, optimizer, tokens, tokens)
    with pytest.raises(ValueError, match="another mesh"):
        dp_tp.make_dp_tp_train_step(_mesh())(tp_model, optimizer,
                                             tokens[:2], tokens[:2])
    with pytest.raises(ValueError, match="not divisible"):
        dp_tp.TPTransformer(dataclasses.replace(cfg, d_ff=129), mesh)


def test_dp_tp_train_entry_on_cpu():
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd,
                ring.ring_allreduce, overlap.matmul_reduce_scatter,
                overlap.allgather_matmul)
    before = [c.launches for c in counters]
    step, (tp_model, optimizer, tokens, targets) = dp_tp_train_entry("cpu")
    _, (model, _, ttokens, ttargets) = train_entry("cpu")
    assert torch.equal(tokens, ttokens) and torch.equal(targets, ttargets)
    assert tp_model.cfg == ENTRY_CONFIG
    assert tp_model.mesh.shape == DP_TP_MESH
    back = dp_tp.unshard_transformer(tp_model)
    for name, p in model.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    assert {k: optimizer.defaults[k] for k in ADAM_SETTINGS} == ADAM_SETTINGS
    loss = step(tp_model, optimizer, tokens, targets)
    assert loss.shape == () and bool(torch.isfinite(loss))
    _assert_replicas_and_shards_equal(tp_model, tp_model.mesh)
    # The CPU runs the twins: no kernel launched.
    assert [c.launches for c in counters] == before
