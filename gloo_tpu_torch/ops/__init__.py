"""Tensor ops of the port: the flash-attention kernel and RoPE."""

from gloo_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
    reference_attention,
)
from gloo_tpu_torch.ops.kernel_table import KERNELS
from gloo_tpu_torch.ops.rope import apply_rope, rope_angles, rope_positions

__all__ = [
    "KERNELS",
    "apply_rope",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_plain",
    "reference_attention",
    "rope_angles",
    "rope_positions",
]
