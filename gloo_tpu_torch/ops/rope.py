"""Rotary position embeddings (RoPE) with explicit positions.

Counterpart of gloo_tpu/ops/rope.py: the half-split (rotate_half) layout,
angles in f32, results in x's dtype. Positions are an argument, so a
sequence-parallel shard rotates by its global offsets. Plain elementwise
PyTorch: the TPU version has no kernel either.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> torch.Tensor:
    """(..., t) int positions -> (..., t, head_dim // 2) f32 angles."""
    if head_dim % 2 != 0:
        raise ValueError(f"head_dim {head_dim} must be even for RoPE")
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    return positions.to(torch.float32)[..., None] * inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate x: (..., t, head_dim) by its positions: (t,) or broadcastable
    to x's leading dims + (t,). Returns x's dtype."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_positions(t: int, offset: int = 0, device=None) -> torch.Tensor:
    """Global positions for a local block of length t starting at offset
    (e.g. offset = rank * t_local under sequence parallelism)."""
    return offset + torch.arange(t, dtype=torch.int32, device=device)
