"""Every Pallas kernel of the JAX package and its Hopper counterpart.

One row per ``pl.pallas_call`` site in gloo_tpu/ops: the kernel function
(file, ``def`` line, call line), the wrapper that reaches it, and its port
status: ``ported: <source>`` or ``to port: slice <n>``. The slices are the
order of the port: 1 serving (flash forward), 2 training on one card
(flash backward), 3 the device plane on more than one card (ring
allreduce, reduce-scatter, allgather), 4 tensor parallelism (collective
matmuls), 5 sequence and expert parallelism (ring-attention steps,
all-to-all), 6 the remaining ring variants. tests/test_torch_isolation.py holds this table against the
JAX sources.
"""

from __future__ import annotations

from typing import NamedTuple


class Kernel(NamedTuple):
    id: str
    file: str          # in the repo, relative to its root
    function: str      # the kernel body passed to pl.pallas_call
    def_line: int
    call_line: int     # the pl.pallas_call site
    wrapper: str
    status: str


_A = "gloo_tpu/ops/attention.py"
_O = "gloo_tpu/ops/overlap.py"
_R = "gloo_tpu/ops/pallas_ring.py"

KERNELS = (
    Kernel("B1", _A, "_flash_kernel", 92, 237, "flash_attention",
           "ported: gloo_tpu_torch/csrc/flash_fwd.cu"),
    Kernel("B2", _A, "_flash_bwd_fused_kernel", 313, 430,
           "flash_attention_bwd_fused",
           "ported: gloo_tpu_torch/csrc/flash_bwd.cu"),
    Kernel("B6", _A, "_flash_step_kernel", 477, 534, "flash_attention_step",
           "to port: slice 5"),
    Kernel("B7a", _A, "_flash_bwd_dq_step_kernel", 588, 730,
           "flash_attention_bwd_step", "to port: slice 5"),
    Kernel("B7b", _A, "_flash_bwd_dkv_step_kernel", 635, 765,
           "flash_attention_bwd_step", "to port: slice 5"),
    Kernel("B5a", _O, "_matmul_rs_kernel", 38, 185, "matmul_reduce_scatter",
           "to port: slice 4"),
    Kernel("B5b", _O, "_ag_matmul_kernel", 205, 294, "allgather_matmul",
           "to port: slice 4"),
    Kernel("B3", _R, "_ring_allreduce_kernel", 63, 183, "ring_allreduce",
           "to port: slice 3"),
    Kernel("B9", _R, "_ring_allreduce_hbm_kernel", 246, 440,
           "ring_allreduce_hbm", "to port: slice 6"),
    Kernel("B10", _R, "_ring_allreduce_q8_kernel", 485, 654,
           "ring_allreduce_q8", "to port: slice 6"),
    Kernel("B11", _R, "_ring_allreduce_bidir_kernel", 691, 842,
           "ring_allreduce_bidir", "to port: slice 6"),
    Kernel("B4a", _R, "_ring_reduce_scatter_kernel", 876, 963,
           "ring_reduce_scatter", "to port: slice 3"),
    Kernel("B4b", _R, "_ring_allgather_kernel", 995, 1050, "ring_allgather",
           "to port: slice 3"),
    Kernel("B8", _R, "_alltoall_kernel", 1109, 1178, "pallas_alltoall",
           "to port: slice 5"),
)
