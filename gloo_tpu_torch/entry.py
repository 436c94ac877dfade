"""Entry points: the flagship transformer's forward and training step on
one GPU.

``entry()`` is the counterpart of ``__graft_entry__.entry()``: the same
configuration (vocab 512, d_model 256, 4 heads, 2 layers, d_ff 1024, seq
128, batch 8, bf16 activations, flash attention) and the same tokens from
``np.random.RandomState(0)``; the weights come from a ``torch.Generator``
seeded with 0. ``train_entry()`` is the one-device counterpart of the
training step of ``__graft_entry__.dryrun_multichip``: the same model and
tokens, next-token targets, and Adam at optax.adam(1e-3)'s settings.
"""

from __future__ import annotations

import numpy as np
import torch

from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.models.transformer import Transformer, TransformerConfig

ENTRY_CONFIG = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                                 n_layers=2, d_ff=1024, max_seq_len=128,
                                 use_flash_attention=True)
ENTRY_BATCH = 8
# optax.adam(1e-3): its defaults, eps outside the square root, no decay.
ADAM_SETTINGS = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


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
    targets = torch.as_tensor(np.roll(_entry_tokens(), -1, axis=1),
                              dtype=torch.int32, device=tokens.device)
    optimizer = torch.optim.Adam(model.parameters(), **ADAM_SETTINGS)
    return train_step, (model, optimizer, tokens, targets)
