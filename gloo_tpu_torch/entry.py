"""Entry point: the flagship transformer forward on one GPU.

Counterpart of ``__graft_entry__.entry()``: the same configuration (vocab
512, d_model 256, 4 heads, 2 layers, d_ff 1024, seq 128, batch 8, bf16
activations, flash attention) and the same tokens from
``np.random.RandomState(0)``; the weights come from a
``torch.Generator`` seeded with 0.
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


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The served forward: logits (batch, seq, vocab) f32."""
    with torch.inference_mode():
        return model(tokens)


def entry(device="cuda"):
    """Returns (fn, (model, tokens)) with both on `device`; fn(model,
    tokens) is the transformer forward."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    model = Transformer(cfg, device=dev).init(
        torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(
            0, cfg.vocab_size, (ENTRY_BATCH, cfg.max_seq_len)),
        dtype=torch.int32, device=dev)
    return forward, (model, tokens)
