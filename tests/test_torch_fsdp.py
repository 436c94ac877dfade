"""gloo_tpu_torch.parallel.fsdp against gloo_tpu.parallel.fsdp, on a CPU
world.

The JAX functions run inside shard_map over the virtual CPU mesh, as
tests/test_parallel.py runs them (check_vma=False: unshard_params' output
is replicated in value but varying in type, and the interpreted Pallas
flash VJP of the transformer case fails the varying-manual-axes check,
"Custom VJP bwd rule must produce an output with the same type"). The
port's run over make_mesh({"data": n}, devices=["cpu"] * n) with the ring
twins (B4b, B4a, B3) and the flash twin. Parameters come from the JAX
init, inputs from numpy seeds.

Tolerances: shard_params and unshard_params move bytes, so they are held
bitwise. The steps are f32: per-rank products and attention sum in other
orders than XLA's, and the shard gradients are summed in ring order, so
losses and parameters after 3 SGD steps agree to rtol 1e-5 (atol 1e-6 for
parameters near 0), the reference's own FSDP test's tolerance against
plain SGD.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from gloo_tpu.models import MLP as JaxMLP  # noqa: E402
from gloo_tpu.models import Transformer as JaxTransformer  # noqa: E402
from gloo_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from gloo_tpu.parallel import make_fsdp_train_step as jax_step  # noqa: E402
from gloo_tpu.parallel import shard_params as jax_shard  # noqa: E402
from gloo_tpu.parallel import unshard_params as jax_unshard  # noqa: E402
from gloo_tpu.tpu import make_mesh as jax_make_mesh  # noqa: E402
from gloo_tpu_torch import weights  # noqa: E402
from gloo_tpu_torch.entry import (  # noqa: E402
    ENTRY_CONFIG,
    FSDP_LR,
    FSDP_MESH,
    fsdp_train_entry,
    train_entry,
)
from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig  # noqa: E402,E501
from gloo_tpu_torch.ops import attention as attn  # noqa: E402
from gloo_tpu_torch.ops import ring  # noqa: E402
from gloo_tpu_torch.parallel import (  # noqa: E402
    make_fsdp_train_step,
    shard_params,
    unshard_params,
)
from gloo_tpu_torch.parallel.dp_tp import world_batch  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZES = (8, 17, 4)  # the odd hidden width exercises the padding
LR = 0.1


def _meshes(n):
    return (make_mesh({"data": n}, devices=["cpu"] * n),
            jax_make_mesh({"data": n}, devices=jax.devices()[:n]))


def _mlp_named(jparams):
    """The JAX MLP tree (a list of {"w", "b"}) by the port's names."""
    return {f"layers.{i}.{k}": np.array(layer[k])
            for i, layer in enumerate(jparams) for k in ("w", "b")}


def _mlp_state(jparams):
    return {k: torch.from_numpy(v) for k, v in _mlp_named(jparams).items()}


def _mlp_loss(shell):
    def loss_fn(params, batch):
        x, y = batch
        pred = torch.func.functional_call(shell, params, (x,))
        return ((pred - y) ** 2).mean()

    return loss_fn


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_and_unshard_bitwise_equal_jax(n):
    mesh, jmesh = _meshes(n)
    jparams = JaxMLP(SIZES).init(jax.random.PRNGKey(0))

    def run(params):
        sharded = jax_shard(params, "data")
        return sharded, jax_unshard(sharded, params, "data")

    jsharded, jfull = jax.jit(jax.shard_map(
        run, mesh=jmesh, in_specs=(P(),), out_specs=(P("data"), P()),
        check_vma=False))(jparams)
    state = _mlp_state(jparams)
    sharded = shard_params(state, "data", mesh=mesh)
    full = unshard_params(sharded, state, "data", mesh=mesh)
    jsharded, jfull = _mlp_named(jsharded), _mlp_named(jfull)
    for name, piece in sharded.items():
        assert piece.shape == (n, jsharded[name].size // n), name
        np.testing.assert_array_equal(piece.numpy(),
                                      jsharded[name].reshape(n, -1))
    for name, got in full.items():
        for r in range(n):
            np.testing.assert_array_equal(got[r].numpy(), jfull[name],
                                          err_msg=name)
        assert torch.equal(got[0], state[name])


def test_mlp_step_matches_jax():
    n = 8
    mesh, jmesh = _meshes(n)
    jm = JaxMLP(SIZES)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    xs = rng.randn(4 * n, 8).astype(np.float32)
    ys = rng.randn(4 * n, 4).astype(np.float32)

    def jloss(p, batch):
        x, y = batch
        return jnp.mean((jm.apply(p, x) - y) ** 2)

    jstep = jax_step(jloss, jparams, "data", lr=LR)

    def run(params, xs, ys):
        sharded = jax_shard(params, "data")
        losses = []
        for _ in range(3):
            sharded, loss = jstep(sharded, (xs, ys))
            losses.append(loss)
        return jax_unshard(sharded, params, "data"), jnp.stack(losses)

    jfinal, jlosses = jax.jit(jax.shard_map(
        run, mesh=jmesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))(jparams, xs, ys)

    state = _mlp_state(jparams)
    step = make_fsdp_train_step(_mlp_loss(MLP(SIZES, device="meta")), state,
                                "data", lr=LR, mesh=mesh)
    sharded = shard_params(state, "data", mesh=mesh)
    batch = (world_batch(torch.from_numpy(xs), mesh),
             world_batch(torch.from_numpy(ys), mesh))
    losses = []
    for _ in range(3):
        sharded, loss = step(sharded, batch)
        assert loss.shape == (n,) and torch.equal(loss, loss[:1].expand(n))
        losses.append(float(loss[0]))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    assert losses[2] < losses[0]
    final = unshard_params(sharded, state, "data", mesh=mesh)
    for name, want in _mlp_named(jfinal).items():
        np.testing.assert_allclose(final[name][0].numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_mlp_step_equals_full_batch_sgd():
    """The FSDP step is full-batch SGD on the mean of the rank losses: the
    gradient comes out 1/n of the summed shard gradients, not n times too
    large (the pitfall of differentiating through the loss's allreduce).
    f32; rtol 1e-5 as above."""
    n = 4
    mesh, _ = _meshes(n)
    model = MLP(SIZES, device="cpu").init(torch.Generator().manual_seed(3))
    state = {k: p.detach() for k, p in model.named_parameters()}
    rng = np.random.RandomState(4)
    xs = torch.from_numpy(rng.randn(4 * n, 8).astype(np.float32))
    ys = torch.from_numpy(rng.randn(4 * n, 4).astype(np.float32))
    step = make_fsdp_train_step(_mlp_loss(MLP(SIZES, device="meta")), state,
                                "data", lr=LR, mesh=mesh)
    sharded, loss = step(shard_params(state, "data", mesh=mesh),
                         (world_batch(xs, mesh), world_batch(ys, mesh)))
    ref = model.loss(xs, ys)
    ref.backward()
    np.testing.assert_allclose(float(loss[0]), float(ref.detach()),
                               rtol=1e-5)
    final = unshard_params(sharded, state, "data", mesh=mesh)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            final[name][0].numpy(), (p - LR * p.grad).detach().numpy(),
            rtol=1e-5, atol=1e-6, err_msg=name)


SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=16, use_flash_attention=True)


def _lm_loss(shell):
    def loss_fn(params, batch):
        tokens, targets = batch
        logits = torch.func.functional_call(shell, params, (tokens,))
        return F.cross_entropy(logits.flatten(0, 1),
                               targets.flatten().long())

    return loss_fn


def test_transformer_step_matches_jax():
    """d_model 32, 4 heads of 8, 2 layers, flash attention on both sides,
    f32; 4 ranks with 2 sequences each, 3 SGD steps at lr 0.1."""
    n = 4
    mesh, jmesh = _meshes(n)
    jm = JaxTransformer(JaxConfig(dtype=jnp.float32, **SMALL))
    jparams = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(
        0, SMALL["vocab_size"], (2 * n, SMALL["max_seq_len"])).astype(
            np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jstep = jax_step(jm.loss, jparams, "data", lr=LR)

    def run(params, tokens, targets):
        sharded = jax_shard(params, "data")
        losses = []
        for _ in range(3):
            sharded, loss = jstep(sharded, (tokens, targets))
            losses.append(loss)
        return jax_unshard(sharded, params, "data"), jnp.stack(losses)

    jfinal, jlosses = jax.jit(jax.shard_map(
        run, mesh=jmesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False))(jparams, tokens, targets)

    cfg = TransformerConfig(dtype=torch.float32, **SMALL)
    state = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    step = make_fsdp_train_step(_lm_loss(Transformer(cfg, device="meta")),
                                state, "data", lr=LR, mesh=mesh)
    sharded = shard_params(state, "data", mesh=mesh)
    batch = (world_batch(torch.from_numpy(tokens), mesh),
             world_batch(torch.from_numpy(targets), mesh))
    losses = []
    for _ in range(3):
        sharded, loss = step(sharded, batch)
        losses.append(float(loss[0]))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    want = weights.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jfinal), cfg, "cpu")
    final = unshard_params(sharded, state, "data", mesh=mesh)
    assert set(final) == set(want)
    for name, got in final.items():
        np.testing.assert_allclose(got[0].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


_COUNTERS = (ring.ring_allgather, ring.ring_reduce_scatter,
             ring.ring_allreduce, attn.flash_attention_fwd,
             attn.flash_attention_bwd)


def _entry_first_step(device):
    """fsdp_train_entry's first step: the parameters before and after it
    (unsharded), its loss, the kernel launches it made (B4b, B4a, B3, B1,
    B2), and train_entry()'s model with the gradient of its loss over the
    whole batch."""
    step, (sharded, batch) = fsdp_train_entry(device)
    before = [c.launches for c in _COUNTERS]
    new, loss = step(sharded, batch)
    launches = [c.launches - b for c, b in zip(_COUNTERS, before)]
    _, (model, _, tokens, targets) = train_entry(device)
    ref = model.loss(tokens, targets)
    ref.backward()
    template = Transformer(ENTRY_CONFIG, device="meta").state_dict()
    mesh = make_mesh(FSDP_MESH, devices=[tokens.device] * 4)
    old = unshard_params(sharded, template, "data", mesh=mesh)
    full = unshard_params(new, template, "data", mesh=mesh)
    return old, full, loss, launches, model, ref


def test_fsdp_train_entry_on_cpu():
    """fsdp_train_entry("cpu")'s first step against SGD at FSDP_LR on one
    model over the whole batch, both bf16 activations over f32
    parameters: the loss to rtol 1e-4, and the step's implied gradient
    (old - new) / lr to 2e-2 in relative norm per leaf. Two things part
    them: the world's per-rank bf16 products may round differently from
    the whole batch's, and the new parameters are rounded to f32 at their
    own magnitude, up to ulp(p) / lr in the implied gradient (together
    0.002-0.007 here).
    Every rank's copy of every leaf is the same, and nothing launched a
    kernel (the CPU runs the twins)."""
    old, full, loss, launches, model, ref = _entry_first_step("cpu")
    assert launches == [0] * len(_COUNTERS)
    assert len(full) == 15 and loss.shape == (4,)
    np.testing.assert_allclose(float(loss[0]), float(ref.detach()),
                               rtol=1e-4)
    for name, p in model.named_parameters():
        assert torch.equal(old[name][0], p.detach()), name
        assert all(torch.equal(full[name][0], full[name][r])
                   for r in range(4)), name
        implied = (old[name][0] - full[name][0]) / FSDP_LR
        rel = float((implied - p.grad).norm() / p.grad.norm())
        assert rel < 2e-2, (name, rel)


def test_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_fsdp_long_context.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "fsdp + long-context example OK" in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fsdp_train_entry_on_the_card(cuda_device):
    """fsdp_train_entry() on the card: per step 15 B4b, 15 B4a, one B3,
    and 8 B1 and 8 B2 (2 layers on each of 4 ranks); the first step
    against one model's SGD over the whole batch on the card (bf16: loss
    to 1e-3, implied gradients to 5e-2 in relative norm, the tolerance of
    the card's training checks)."""
    old, full, loss, launches, model, ref = _entry_first_step(cuda_device)
    torch.cuda.synchronize()
    assert launches == [15, 15, 1, 8, 8]
    assert abs(float(loss[0]) - float(ref.detach())) <= 1e-3 * float(
        ref.detach())
    for name, p in model.named_parameters():
        implied = (old[name][0] - full[name][0]) / FSDP_LR
        rel = float((implied - p.grad).norm() / p.grad.norm())
        assert rel < 5e-2, (name, rel)
