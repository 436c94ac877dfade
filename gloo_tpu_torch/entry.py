"""Entry points: the flagship transformer's forward and training step on
one GPU, and its data-parallel and data x tensor parallel training steps
over a world of ranks.

``entry()`` is the counterpart of ``__graft_entry__.entry()``: the same
configuration (vocab 512, d_model 256, 4 heads, 2 layers, d_ff 1024, seq
128, batch 8, bf16 activations, flash attention) and the same tokens from
``np.random.RandomState(0)``; the weights come from a ``torch.Generator``
seeded with 0. ``train_entry()`` is the one-device counterpart of the
training step of ``__graft_entry__.dryrun_multichip``: the same model and
tokens, next-token targets, and Adam at optax.adam(1e-3)'s settings.
``ddp_train_entry()`` is the data-parallel counterpart of that training
step: DDP_WORLD ranks on one card, each with a replica of the same model,
train_entry()'s tokens and targets as the global batch, and the gradient
mean on the ring allreduce kernel. ``dp_tp_train_entry()`` is the dp x tp
training step of dryrun_multichip: a mesh DP_TP_MESH of ranks on one card,
the weights split over "model" as its layer_spec splits them, the same
global batch split over "data".
"""

from __future__ import annotations

import numpy as np
import torch

from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.models.transformer import Transformer, TransformerConfig
from gloo_tpu_torch.parallel.ddp import make_ddp_train_step
from gloo_tpu_torch.parallel.dp_tp import (make_dp_tp_train_step,
                                           shard_transformer)
from gloo_tpu_torch.tpu.mesh import make_mesh

ENTRY_CONFIG = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                                 n_layers=2, d_ff=1024, max_seq_len=128,
                                 use_flash_attention=True)
ENTRY_BATCH = 8
# optax.adam(1e-3): its defaults, eps outside the square root, no decay.
ADAM_SETTINGS = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
# Ranks of ddp_train_entry's world, all on one card: ENTRY_BATCH / DDP_WORLD
# sequences each.
DDP_WORLD = 4
# dp_tp_train_entry's mesh, all on one card: ENTRY_BATCH / 2 sequences per
# data rank, two heads and d_ff / 2 per model rank.
DP_TP_MESH = {"data": 2, "model": 2}


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The served forward: logits (batch, seq, vocab) f32."""
    with torch.inference_mode():
        return model(tokens)


def _entry_tokens() -> np.ndarray:
    cfg = ENTRY_CONFIG
    return np.random.RandomState(0).randint(
        0, cfg.vocab_size, (ENTRY_BATCH, cfg.max_seq_len))


def entry(device="cuda"):
    """Returns (fn, (model, tokens)) with both on `device`; fn(model,
    tokens) is the transformer forward."""
    dev = resolve_device(device)
    model = Transformer(ENTRY_CONFIG, device=dev).init(
        torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(_entry_tokens(), dtype=torch.int32, device=dev)
    return forward, (model, tokens)


def train_step(model: Transformer, optimizer: torch.optim.Optimizer,
               tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One step: loss, gradients, Adam update. Returns the loss (a 0-d f32
    tensor on the model's device, computed before the update); the
    gradients stay in the parameters' .grad until the next step."""
    optimizer.zero_grad(set_to_none=True)
    loss = model.loss(tokens, targets)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_entry(device="cuda"):
    """Returns (train_step, (model, optimizer, tokens, targets)) on
    `device`: entry()'s model and tokens, targets the tokens shifted left
    by one (np.roll, as the JAX step), and torch.optim.Adam at
    ADAM_SETTINGS."""
    _, (model, tokens) = entry(device)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    return train_step, (model, optimizer, tokens, _entry_targets(tokens))


def _entry_targets(tokens: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.roll(_entry_tokens(), -1, axis=1),
                           dtype=torch.int32, device=tokens.device)


def _lm_loss(model: Transformer, batch) -> torch.Tensor:
    tokens, targets = batch
    return model.loss(tokens, targets)


def ddp_train_entry(device="cuda"):
    """Returns (step, (replicas, optimizers, (tokens, targets))) on
    `device`: a mesh {"data": DDP_WORLD} of ranks on that one device, one
    replica per rank loaded from train_entry()'s weights, one Adam at
    ADAM_SETTINGS each, and train_entry()'s tokens and targets as the
    global batch. step(replicas, optimizers, (tokens, targets)) is
    make_ddp_train_step's: it returns the mean of the rank losses."""
    _, (model, tokens) = entry(device)
    dev = tokens.device
    mesh = make_mesh({"data": DDP_WORLD}, devices=[dev] * DDP_WORLD)
    replicas = [model]
    for _ in range(DDP_WORLD - 1):
        replica = Transformer(ENTRY_CONFIG, device=dev)
        replica.load_state_dict(model.state_dict())
        replicas.append(replica)
    optimizers = [torch.optim.Adam(m.parameters(), **ADAM_SETTINGS)
                  for m in replicas]
    step = make_ddp_train_step(_lm_loss, mesh, "data")
    return step, (replicas, optimizers, (tokens, _entry_targets(tokens)))


def dp_tp_train_entry(device="cuda"):
    """Returns (step, (tp_model, optimizer, tokens, targets)) on `device`:
    a mesh DP_TP_MESH of ranks on that one device, train_entry()'s weights
    sharded along "model" (shard_transformer), one Adam at ADAM_SETTINGS
    over the world parameters, and train_entry()'s tokens and targets as
    the global batch. step(tp_model, optimizer, tokens, targets) is
    make_dp_tp_train_step's: it returns the global mean loss."""
    _, (model, tokens) = entry(device)
    dev = tokens.device
    ranks = DP_TP_MESH["data"] * DP_TP_MESH["model"]
    mesh = make_mesh(DP_TP_MESH, devices=[dev] * ranks)
    tp_model = shard_transformer(model, mesh, "model")
    optimizer = torch.optim.Adam(tp_model.parameters(), **ADAM_SETTINGS)
    step = make_dp_tp_train_step(mesh, "data", "model")
    return step, (tp_model, optimizer, tokens, _entry_targets(tokens))
