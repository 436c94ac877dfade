"""Parallelism strategies on the port's device plane: data parallelism with
the gradient mean on the ring allreduce kernel (counterpart of
gloo_tpu/parallel/ddp.py's make_ddp_train_step) and across processes on
the host plane (its HostGradSync), tensor parallelism on
world tensors with the collective matmul kernels (gloo_tpu/parallel/tp.py),
the dp x tp training step of the flagship transformer (the GSPMD step of
__graft_entry__.dryrun_multichip), sequence parallelism on the ring-attention
step kernels and the all-to-all (gloo_tpu/parallel/sp.py), expert
parallelism on the all-to-all (gloo_tpu/parallel/ep.py), fully-sharded
data parallelism on the ring allgather and its reduce-scatter VJP
(gloo_tpu/parallel/fsdp.py), and GPipe and 1F1B pipeline parallelism
(gloo_tpu/parallel/pp.py)."""

from gloo_tpu_torch.parallel.ddp import HostGradSync, make_ddp_train_step
from gloo_tpu_torch.parallel.ep import dispatch_combine
from gloo_tpu_torch.parallel.fsdp import (make_fsdp_train_step, shard_params,
                                          unshard_params)
from gloo_tpu_torch.parallel.pp import pipeline_apply, pipeline_train_1f1b
from gloo_tpu_torch.parallel.dp_tp import (TPTransformer,
                                           make_dp_tp_train_step,
                                           shard_transformer,
                                           unshard_transformer)
from gloo_tpu_torch.parallel.sp import (ring_attention, ring_flash_attention,
                                        ulysses_attention)
from gloo_tpu_torch.parallel.tp import (allgather_matmul_dense,
                                        allgather_matmul_dense_auto,
                                        column_parallel_dense,
                                        estimate_comm_share,
                                        measure_fused_ratio,
                                        row_parallel_dense,
                                        row_parallel_dense_scattered,
                                        row_parallel_dense_scattered_auto,
                                        tp_mlp_block, use_fused_overlap)

__all__ = [
    "HostGradSync",
    "TPTransformer",
    "allgather_matmul_dense",
    "allgather_matmul_dense_auto",
    "column_parallel_dense",
    "dispatch_combine",
    "estimate_comm_share",
    "make_ddp_train_step",
    "make_dp_tp_train_step",
    "make_fsdp_train_step",
    "measure_fused_ratio",
    "pipeline_apply",
    "pipeline_train_1f1b",
    "ring_attention",
    "ring_flash_attention",
    "row_parallel_dense",
    "row_parallel_dense_scattered",
    "row_parallel_dense_scattered_auto",
    "shard_params",
    "shard_transformer",
    "tp_mlp_block",
    "ulysses_attention",
    "unshard_params",
    "unshard_transformer",
    "use_fused_overlap",
]
