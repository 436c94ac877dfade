"""gloo_tpu_torch.parallel.make_ddp_train_step against
gloo_tpu.parallel.make_ddp_train_step, on a CPU world of 4.

The JAX step runs over a 4-device CPU mesh (its gradient psum inside
shard_map); the port's over make_mesh({"data": 4}, devices=["cpu"] * 4),
one replica and one optimizer per rank, with the gradient mean on the ring
allreduce's plain twin. Weights come from the JAX init, inputs from numpy
seeds, so both sides start equal (the cases of tests/test_parallel.py).

Tolerances (f32 throughout): the per-rank gradients agree to ~1e-6
relative (sums in another order), the ring adds rank gradients in ring
order and XLA's psum in its own, so the loss agrees to rtol 1e-5 and
parameters after SGD(0.1) or three Adam(1e-2) steps to atol 1e-5 (Adam
moves each parameter by about lr per step, whatever the gradient's size,
so a relative gradient difference of 1e-6 stays ~1e-8 there).

The transformer against JAX runs with use_flash_attention=False on both
sides: the interpreted Pallas flash kernel's custom VJP fails shard_map's
varying-manual-axes check inside the JAX make_ddp_train_step. The port's
own DDP tests below run its flash path (the kernels' twins).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from gloo_tpu.models import MLP as JaxMLP  # noqa: E402
from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.parallel import make_ddp_train_step as jax_ddp  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import weights  # noqa: E402
from gloo_tpu_torch.entry import (  # noqa: E402
    ADAM_SETTINGS,
    DDP_WORLD,
    ENTRY_CONFIG,
    ddp_train_entry,
    train_entry,
    train_step,
)
from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig  # noqa: E402,E501
from gloo_tpu_torch.ops import attention as attn  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.parallel import make_ddp_train_step  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

WORLD = 4
SMALL = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=32, use_flash_attention=True)


def _mesh():
    return make_mesh({"data": WORLD}, devices=["cpu"] * WORLD)


def _jax_mesh():
    return jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _mlp_replicas(sizes, jparams):
    state = {f"layers.{i}.{name}": torch.from_numpy(np.array(layer[name]))
             for i, layer in enumerate(jparams) for name in ("w", "b")}
    replicas = []
    for _ in range(WORLD):
        m = MLP(sizes, device="cpu")
        m.load_state_dict(state)
        replicas.append(m)
    return replicas


def _mlp_loss(model, batch):
    return model.loss(*batch)


@pytest.mark.parametrize("opt,steps", [("sgd", 1), ("adam", 3)])
def test_mlp_matches_jax_ddp(opt, steps):
    sizes = (4, 8, 2)
    jm = JaxMLP(sizes)
    jparams = jm.init(jax.random.PRNGKey(1))
    tx = optax.sgd(0.1) if opt == "sgd" else optax.adam(1e-2)
    jstate = tx.init(jparams)
    jstep = jax_ddp(jm.loss, tx, _jax_mesh())
    replicas = _mlp_replicas(sizes, jparams)
    optimizers = [torch.optim.SGD(m.parameters(), lr=0.1) if opt == "sgd"
                  else torch.optim.Adam(m.parameters(), lr=1e-2,
                                        betas=(0.9, 0.999), eps=1e-8)
                  for m in replicas]
    step = make_ddp_train_step(_mlp_loss, _mesh())
    rng = np.random.RandomState(1)
    for _ in range(steps):
        x = rng.randn(16, 4).astype(np.float32)
        y = rng.randn(16, 2).astype(np.float32)
        jparams, jstate, jloss = jstep(jparams, jstate, (x, y))
        loss = step(replicas, optimizers,
                    (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for m in replicas:
        for i, layer in enumerate(jparams):
            for name in ("w", "b"):
                np.testing.assert_allclose(
                    getattr(m.layers[i], name).detach().numpy(),
                    np.asarray(layer[name]), rtol=0, atol=1e-5)


def test_transformer_matches_jax_ddp():
    kw = {**SMALL, "use_flash_attention": False}
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    tx = optax.sgd(0.1)
    jstep = jax_ddp(jm.loss, tx, _jax_mesh())
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    state = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    replicas = [Transformer(cfg, device="cpu") for _ in range(WORLD)]
    for m in replicas:
        m.load_state_dict(state)
    optimizers = [torch.optim.SGD(m.parameters(), lr=0.1) for m in replicas]
    step = make_ddp_train_step(lambda m, b: m.loss(*b), _mesh())
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 32))
    targets = np.roll(tokens, -1, axis=1)
    jparams, _, jloss = jstep(jparams, tx.init(jparams),
                              (jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(targets, jnp.int32)))
    loss = step(replicas, optimizers,
                (torch.as_tensor(tokens, dtype=torch.int32),
                 torch.as_tensor(targets, dtype=torch.int32)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for name, p in replicas[0].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def _small_replicas(dtype, world=WORLD):
    cfg = TransformerConfig(dtype=dtype, **SMALL)
    first = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    replicas = [first]
    for _ in range(world - 1):
        m = Transformer(cfg, device="cpu")
        m.load_state_dict(first.state_dict())
        replicas.append(m)
    return cfg, replicas


def test_ddp_step_equals_train_step_on_the_whole_batch():
    """Mean of the rank losses and of the rank gradients = the loss and
    gradient of the whole batch (equal micro-batches), f32."""
    cfg, replicas = _small_replicas(torch.float32, WORLD + 1)
    single = replicas.pop()
    optimizers = [torch.optim.SGD(m.parameters(), lr=0.1) for m in replicas]
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen,
                           dtype=torch.int32)
    targets = tokens.roll(-1, dims=1)
    step = make_ddp_train_step(lambda m, b: m.loss(*b), _mesh())
    loss = step(replicas, optimizers, (tokens, targets))
    ref = train_step(single, torch.optim.SGD(single.parameters(), lr=0.1),
                     tokens, targets)
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    for (name, p), q in zip(replicas[0].named_parameters(),
                            single.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-7,
                                   msg=name)
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=name)


def test_replicas_stay_bitwise_equal():
    cfg, replicas = _small_replicas(torch.bfloat16)
    optimizers = [torch.optim.Adam(m.parameters(), **ADAM_SETTINGS)
                  for m in replicas]
    step = make_ddp_train_step(lambda m, b: m.loss(*b), _mesh())
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen,
                           dtype=torch.int32)
    losses = [float(step(replicas, optimizers,
                         (tokens, tokens.roll(-1, dims=1))))
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for m in replicas[1:]:
        for p, q in zip(m.parameters(), replicas[0].parameters()):
            assert torch.equal(p, q)
            assert torch.equal(p.grad, q.grad)


def test_ddp_rejects_what_it_does_not_take():
    cfg, replicas = _small_replicas(torch.float32)
    optimizers = [torch.optim.SGD(m.parameters(), lr=0.1) for m in replicas]
    step = make_ddp_train_step(lambda m, b: m.loss(*b), _mesh())
    tokens = torch.zeros((6, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        step(replicas, optimizers, (tokens, tokens))
    with pytest.raises(ValueError, match="one replica"):
        step(replicas[:3], optimizers[:3], (tokens[:4], tokens[:4]))


def test_ddp_train_entry_on_cpu():
    before = (attn.flash_attention_fwd.launches,
              attn.flash_attention_bwd.launches, ring.ring_allreduce.launches)
    step, (replicas, optimizers, (tokens, targets)) = ddp_train_entry("cpu")
    _, (model, _, ttokens, ttargets) = train_entry("cpu")
    assert len(replicas) == len(optimizers) == DDP_WORLD
    assert torch.equal(tokens, ttokens) and torch.equal(targets, ttargets)
    assert all(m.cfg == ENTRY_CONFIG for m in replicas)
    for m in replicas:
        for p, q in zip(m.parameters(), model.parameters()):
            assert torch.equal(p, q)
    assert all({k: o.defaults[k] for k in ADAM_SETTINGS} == ADAM_SETTINGS
               for o in optimizers)
    loss = step(replicas, optimizers, (tokens, targets))
    assert loss.shape == () and bool(torch.isfinite(loss))
    # The CPU runs the twins: no kernel launched.
    assert (attn.flash_attention_fwd.launches,
            attn.flash_attention_bwd.launches,
            ring.ring_allreduce.launches) == before
