"""Tensor ops of the port: the flash-attention kernels and the
ring-attention step kernels, the ring collective kernels and the
all-to-all, the collective matmul kernels and RoPE."""

from gloo_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv_step,
    flash_attention_bwd_dkv_step_plain,
    flash_attention_bwd_dq_step,
    flash_attention_bwd_dq_step_plain,
    flash_attention_bwd_plain,
    flash_attention_bwd_step,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_step,
    flash_attention_step_plain,
    group_sum_kv,
    reference_attention,
)
from gloo_tpu_torch.ops.kernel_table import KERNELS
from gloo_tpu_torch.ops.overlap import (
    allgather_matmul,
    allgather_matmul_fwd,
    allgather_matmul_plain,
    matmul_reduce_scatter,
    matmul_reduce_scatter_plain,
)
from gloo_tpu_torch.ops.ring import (
    alltoall,
    alltoall_plain,
    ring_allgather,
    ring_allgather_plain,
    ring_allreduce,
    ring_allreduce_plain,
    ring_allreduce_torus,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
)
from gloo_tpu_torch.ops.rope import apply_rope, rope_angles, rope_positions

__all__ = [
    "KERNELS",
    "allgather_matmul",
    "allgather_matmul_fwd",
    "allgather_matmul_plain",
    "alltoall",
    "alltoall_plain",
    "apply_rope",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv_step",
    "flash_attention_bwd_dkv_step_plain",
    "flash_attention_bwd_dq_step",
    "flash_attention_bwd_dq_step_plain",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_step",
    "flash_attention_fwd",
    "flash_attention_plain",
    "flash_attention_step",
    "flash_attention_step_plain",
    "group_sum_kv",
    "matmul_reduce_scatter",
    "matmul_reduce_scatter_plain",
    "reference_attention",
    "ring_allgather",
    "ring_allgather_plain",
    "ring_allreduce",
    "ring_allreduce_plain",
    "ring_allreduce_torus",
    "ring_reduce_scatter",
    "ring_reduce_scatter_plain",
    "rope_angles",
    "rope_positions",
]
