"""Every Pallas kernel of the JAX package and its Hopper counterpart.

One row per ``pl.pallas_call`` site in gloo_tpu/ops: the kernel function
(file, ``def`` line, call line), the wrapper that reaches it, and its port
status: ``ported: <source>``, followed by ``; redesigned, PR <n>`` where
a later PR redesigned the port's first design for Hopper. The slices were
the order of the port: 1 serving (flash forward), 2 training on one card
(flash backward), 3 the device plane (ring allreduce, reduce-scatter,
allgather) over a world of ranks on one card, 4 tensor parallelism
(collective matmuls), 5 sequence and expert parallelism (ring-attention
steps, all-to-all), 6 the ring allreduce variants (HBM-streaming,
int8-wire, bidirectional). PRs 7-13 redesigned every first design for
Hopper (PERF.md §6). B7a and B7b are one fused launch. B9 and B11 take
every dtype of ring.SUM_DTYPES, as B3 and B4a do; their status says so
after the redesign. PR 18 gave B1, B2, B6, B7a, B7b (f16, head dims up to
256, any number of rows past the grid's 65535) and B5a, B5b (f16) the
reference's domain on the card; their statuses say so. PR 26 gave B1,
B2, B6, B7a and B7b any head_dim: 1-255 zero-padded to an instance, and
past 256 the wide kernels of csrc/flash_wide.cuh (FMA, column parts);
their statuses say so last. The FSDP and
pipeline slice ports no kernel and adds launches of five: an
FSDP step (parallel/fsdp.py) launches B4b and B4a once per leaf (the
allgather and its VJP), B3 once (the loss mean) and B1 and B2 once per
rank and layer; a 1F1B step (parallel/pp.py) B1 twice per tick (the
forward and the recompute) and B2 once; a GPipe forward B1 once per
tick. PR 21 added the cross-process instances of B3, B4a and B4b (one
cooperative launch per process over CUDA IPC peer-mapped memory, for a
process mesh of tpu/multihost.py); their statuses say so last. PR 22
added those of B5a, B5b and B8 in the same way, PR 23 those of B9, B10
and B11. Until PR 27 the collective kernels (B3-B5b, B8-B11) took at most
32 ranks, the size of the per-rank tables in their parameters; PR 27
moved those tables into device memory, so they take any world whose
blocks the card holds at once (ops/ring.py's residency), and their
statuses say so last.
tests/test_torch_isolation.py holds this table against the JAX sources.
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
           "ported: gloo_tpu_torch/csrc/flash_fwd.cu; redesigned, PR 10; "
           "f16, d 256, rows > 65535, PR 18; any head_dim, PR 26"),
    Kernel("B2", _A, "_flash_bwd_fused_kernel", 313, 430,
           "flash_attention_bwd_fused",
           "ported: gloo_tpu_torch/csrc/flash_bwd.cu; redesigned, PR 11; "
           "f16, d 256, rows > 65535, PR 18; any head_dim, PR 26"),
    Kernel("B6", _A, "_flash_step_kernel", 477, 534, "flash_attention_step",
           "ported: gloo_tpu_torch/csrc/flash_step.cu; redesigned, PR 13; "
           "f16, d 256, rows > 65535, PR 18; any head_dim, PR 26"),
    Kernel("B7a", _A, "_flash_bwd_dq_step_kernel", 588, 730,
           "flash_attention_bwd_step",
           "ported: gloo_tpu_torch/csrc/flash_bwd_step.cu; "
           "redesigned, PR 12; f16, d 256, rows > 65535, PR 18; "
           "any head_dim, PR 26"),
    Kernel("B7b", _A, "_flash_bwd_dkv_step_kernel", 635, 765,
           "flash_attention_bwd_step",
           "ported: gloo_tpu_torch/csrc/flash_bwd_step.cu; "
           "redesigned, PR 12; f16, d 256, rows > 65535, PR 18; "
           "any head_dim, PR 26"),
    Kernel("B5a", _O, "_matmul_rs_kernel", 38, 185, "matmul_reduce_scatter",
           "ported: gloo_tpu_torch/csrc/overlap.cu; redesigned, PR 7; "
           "f16, PR 18; across processes (CUDA IPC), PR 22; any ranks up "
           "to the card's residency, PR 27"),
    Kernel("B5b", _O, "_ag_matmul_kernel", 205, 294, "allgather_matmul",
           "ported: gloo_tpu_torch/csrc/overlap.cu; redesigned, PR 7; "
           "f16, PR 18; across processes (CUDA IPC), PR 22; any ranks up "
           "to the card's residency, PR 27"),
    Kernel("B3", _R, "_ring_allreduce_kernel", 63, 183, "ring_allreduce",
           "ported: gloo_tpu_torch/csrc/ring.cu; redesigned, PR 8; "
           "across processes (CUDA IPC), PR 21; any ranks up to the card's "
           "residency, PR 27"),
    Kernel("B9", _R, "_ring_allreduce_hbm_kernel", 246, 440,
           "ring_allreduce_hbm",
           "ported: gloo_tpu_torch/csrc/ring_variants.cu; redesigned, PR 9; "
           "every dtype of SUM_DTYPES; across processes (CUDA IPC), PR 23; "
           "any ranks up to the card's residency, PR 27"),
    Kernel("B10", _R, "_ring_allreduce_q8_kernel", 485, 654,
           "ring_allreduce_q8",
           "ported: gloo_tpu_torch/csrc/ring_variants.cu; redesigned, PR 13; "
           "across processes (CUDA IPC), PR 23; any ranks up to the card's "
           "residency, PR 27"),
    Kernel("B11", _R, "_ring_allreduce_bidir_kernel", 691, 842,
           "ring_allreduce_bidir",
           "ported: gloo_tpu_torch/csrc/ring_variants.cu; redesigned, PR 9; "
           "every dtype of SUM_DTYPES; across processes (CUDA IPC), PR 23; "
           "any ranks up to the card's residency, PR 27"),
    Kernel("B4a", _R, "_ring_reduce_scatter_kernel", 876, 963,
           "ring_reduce_scatter",
           "ported: gloo_tpu_torch/csrc/ring.cu; redesigned, PR 8; "
           "across processes (CUDA IPC), PR 21; any ranks up to the card's "
           "residency, PR 27"),
    Kernel("B4b", _R, "_ring_allgather_kernel", 995, 1050, "ring_allgather",
           "ported: gloo_tpu_torch/csrc/ring.cu; redesigned, PR 11; "
           "across processes (CUDA IPC), PR 21; any ranks up to the card's "
           "residency, PR 27"),
    Kernel("B8", _R, "_alltoall_kernel", 1109, 1178, "pallas_alltoall",
           "ported: gloo_tpu_torch/csrc/alltoall.cu; redesigned, PR 10; "
           "across processes (CUDA IPC), PR 22; any ranks up to the card's "
           "residency, PR 27"),
)
