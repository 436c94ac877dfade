"""Megatron-style tensor parallelism over a mesh axis, on world tensors.

Counterpart of gloo_tpu/parallel/tp.py. There is no shard_map: each
function takes world tensors (P, ...) whose row r is flat rank r's value
(its activation, its weight shard) and the `mesh` by keyword, and returns
a world tensor. The collectives are the port's kernels: the row-parallel
sum is ``spmd.allreduce`` (B3), the Megatron-SP pair the collective
matmuls of gloo_tpu_torch.ops.overlap (B5a, B5b), and the unfused arms of
the dispatch a plain dot beside ``spmd.reduce_scatter`` (B4a) or
``spmd.allgather`` (B4b).

The fused/unfused dispatch keeps the JAX rule and none of its TPU
calibration: fuse iff the collective's share of the unfused step exceeds
the fused kernels' compute penalty, share > 1 - ratio. The share and the
rates behind an estimate are the caller's to give; the ratio is this
process's measurement (``measure_fused_ratio``, B5a on the card against a
plain product of the same FLOPs) or the caller's. Where either is missing
the ``*_auto`` wrappers take the unfused arm. ``TPUCOLL_TP_OVERLAP=
fused|unfused|auto`` forces either arm, read at every call (PyTorch runs
eagerly, so there is no trace-time capture to beware of).

On a process mesh (tpu/multihost.py) every function takes this process's
local tensors (one row per local rank) and the collectives are the
kernels' cross-process instances. There the ``*_auto`` dispatch must
agree in every process of a ring: one process in B5a while another is in
B4a would hang the ring until the kernels' spin bound traps. So the
inputs of the decision are made collective through the mesh's host
plane: the processes exchange their TPUCOLL_TP_OVERLAP (raising in every
process where they differ), their shares and their ratios, and decide on
the least share and the least ratio (none where any process has none).
"""

from __future__ import annotations

import os
import time

import torch
import torch.nn.functional as F

from gloo_tpu_torch.ops.overlap import (_dot, allgather_matmul,
                                        matmul_reduce_scatter)
from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Mesh, make_mesh
from gloo_tpu_torch.tpu.peer import exchange
from gloo_tpu_torch.utils.tracing import annotate


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_parallel_dense(x: torch.Tensor, w_shard: torch.Tensor, axis: str,
                          *, mesh: Mesh | None = None) -> torch.Tensor:
    """y_shard = x @ w_shard with w split along its output dim: no
    communication. x (P, ..., d), w_shard (P, d, cols)."""
    return torch.matmul(x, w_shard)


def row_parallel_dense(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       axis: str, *, mesh: Mesh) -> torch.Tensor:
    """y = sum over the ring of x_shard @ w_shard: w split along its input
    dim, x arriving split (from a column-parallel layer). The sum is the
    ring allreduce (B3), whose VJP is B3 of the cotangent."""
    partial = torch.matmul(x_shard, w_shard)
    with annotate("gloo_tpu.tp.row_sync"):
        return spmd.allreduce(partial, axis, mesh=mesh)


def tp_mlp_block(x: torch.Tensor, w_up_shard: torch.Tensor,
                 w_down_shard: torch.Tensor, axis: str, activation=None, *,
                 mesh: Mesh) -> torch.Tensor:
    """Column-parallel up-projection, the activation on the shard (tanh
    GELU by default, as jax.nn.gelu), row-parallel down-projection: one
    allreduce per block."""
    act = activation if activation is not None else _gelu_tanh
    h = act(column_parallel_dense(x, w_up_shard, axis, mesh=mesh))
    return row_parallel_dense(h, w_down_shard, axis, mesh=mesh)


def row_parallel_dense_scattered(x_shard: torch.Tensor,
                                 w_shard: torch.Tensor, axis: str, *,
                                 mesh: Mesh) -> torch.Tensor:
    """Row-parallel dense with its output scattered over rows (the sequence
    dim), the reduce-scatter fused into the product (B5a). x_shard
    (P, m, k_shard), w_shard (P, k_shard, cols) -> (P, m / n, cols)."""
    return matmul_reduce_scatter(x_shard, w_shard, axis, mesh)


def allgather_matmul_dense(x_rows_shard: torch.Tensor, w: torch.Tensor,
                           axis: str, *, mesh: Mesh) -> torch.Tensor:
    """gather(x) @ w with the allgather fused into the product (B5b): the
    dual of row_parallel_dense_scattered. x_rows_shard (P, rows, k),
    w (P, k, cols) -> (P, n rows, cols)."""
    return allgather_matmul(x_rows_shard, w, axis, mesh)


# ---------------------------------------------------------------------------
# Fused/unfused dispatch.
# ---------------------------------------------------------------------------


def estimate_comm_share(m: int, k: int, cols: int, axis_size: int,
                        dtype_bytes: int = 2, *, link_bytes_per_s: float,
                        flops_per_s: float,
                        wire_elems: int | None = None) -> float:
    """Estimated collective share of the unfused step for a per-shard
    [m, k] @ [k, cols] product and its TP collective over axis_size ranks,
    from the caller's rates: the per-hop ring bandwidth and the plain
    product's rate. `wire_elems` is what the collective moves (default
    m * cols, the reduce-scatter's result; the allgather side passes its
    input, m * k)."""
    if axis_size <= 1:
        return 0.0
    if wire_elems is None:
        wire_elems = m * cols
    wire_bytes = wire_elems * dtype_bytes * (axis_size - 1) / axis_size
    t_comm = wire_bytes / link_bytes_per_s
    t_mm = 2.0 * m * k * cols / flops_per_s
    return t_comm / (t_comm + t_mm)


def _overlap_mode() -> str:
    mode = os.environ.get("TPUCOLL_TP_OVERLAP", "auto")
    if mode not in ("fused", "unfused", "auto", ""):
        raise ValueError(
            f"TPUCOLL_TP_OVERLAP must be fused|unfused|auto, got: {mode}")
    return mode


def use_fused_overlap(m: int, k: int, cols: int, axis_size: int,
                      comm_share: float | None = None,
                      ratio: float | None = None) -> bool:
    """The dispatch decision: fuse iff share > 1 - ratio, where share is
    the collective's share of the unfused step and ratio the fused
    kernels' compute throughput over the plain product's (from
    measure_fused_ratio). A ring of one has no collective (share 0).
    Without a share or a ratio there is nothing to decide on, and the
    answer is the unfused arm. TPUCOLL_TP_OVERLAP=fused|unfused forces
    either way (auto or unset: decide); anything else raises."""
    mode = _overlap_mode()
    if mode in ("fused", "unfused"):
        return mode == "fused"
    if axis_size <= 1:
        comm_share = 0.0
    if comm_share is None or ratio is None:
        return False
    return comm_share > 1.0 - ratio


_PROBE_CACHE: dict = {}
PROBE_AXIS = "_probe"


def fused_ratio_operands(m: int, k: int, axis_size: int,
                         dtype: torch.dtype = torch.bfloat16,
                         device="cuda"):
    """The operands of measure_fused_ratio's A/B: (mesh, x, w), a world of
    axis_size ranks on `device` along PROBE_AXIS, x (P, m, k) of ones and
    w (P, k, k) of 1 / k (the square member of the shape family, as in
    JAX)."""
    dev = torch.device(device)
    mesh = make_mesh({PROBE_AXIS: axis_size}, devices=[dev] * axis_size)
    x = torch.ones((axis_size, m, k), dtype=dtype, device=dev)
    w = torch.full((axis_size, k, k), 1.0 / k, dtype=dtype, device=dev)
    return mesh, x, w


def measure_fused_ratio(m: int, k: int, axis_size: int,
                        dtype: torch.dtype = torch.bfloat16, chain: int = 64,
                        reps: int = 3, device="cuda") -> float:
    """The fused kernel's throughput relative to a plain product of the same
    FLOPs, measured: B5a over a world of axis_size ranks on `device`
    (fused_ratio_operands) against one torch.matmul of the same world
    product, each timed over `chain` calls, the best of `reps`. Cached per
    (m, k, axis_size, dtype) for the process. On the CPU it runs the plain
    twin and returns a number that says nothing about a card; that one is
    never cached."""
    key = (m, k, axis_size, str(dtype))
    dev = torch.device(device)
    if dev.type == "cuda" and key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    if m % axis_size:
        raise ValueError(f"rows {m} not divisible by ring size {axis_size}")
    if chain < 2:
        raise ValueError(f"chain must be >= 2, got {chain}")
    mesh, x, w = fused_ratio_operands(m, k, axis_size, dtype, dev)

    def fused():
        matmul_reduce_scatter(x, w, PROBE_AXIS, mesh)

    def plain():
        _dot(x, w)

    def best(fn):
        fn()
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(chain):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / chain)
            else:
                t0 = time.perf_counter()
                for _ in range(chain):
                    fn()
                times.append((time.perf_counter() - t0) / chain)
        return max(min(times), 1e-12)

    with torch.no_grad():
        ratio = best(plain) / best(fused)
    if dev.type == "cuda":
        _PROBE_CACHE[key] = ratio
    return ratio


def _cached_ratio(m: int, k: int, axis_size: int, dtype) -> float | None:
    return _PROBE_CACHE.get((m, k, axis_size, str(dtype)))


def _least(values):
    return None if any(v is None for v in values) else min(values)


def agreed_dispatch(mesh: Mesh, m: int, k: int, cols: int, axis_size: int,
                    comm_share: float | None,
                    ratio: float | None) -> bool:
    """use_fused_overlap's decision, the same in every process of a
    process mesh: every process's TPUCOLL_TP_OVERLAP, share and ratio go
    through the mesh's host plane (collective), a mode that differs raises
    ValueError in every process, and the decision takes the least share
    and the least ratio. On a one-process mesh, use_fused_overlap
    itself."""
    if mesh.processes == 1:
        return use_fused_overlap(m, k, cols, axis_size,
                                 comm_share=comm_share, ratio=ratio)
    mode = _overlap_mode() or "auto"
    records = exchange(mesh.context, mesh.store,
                       "gloo_tpu_torch/tp_dispatch",
                       [mode, comm_share, ratio])
    modes = [r[0] for r in records]
    if len(set(modes)) > 1:
        raise ValueError(f"TPUCOLL_TP_OVERLAP differs across the processes "
                         f"of the mesh ({modes}, by process): the fused and "
                         f"unfused arms cannot meet on one ring")
    return use_fused_overlap(m, k, cols, axis_size,
                             comm_share=_least([r[1] for r in records]),
                             ratio=_least([r[2] for r in records]))


def row_parallel_dense_scattered_auto(x_shard: torch.Tensor,
                                      w_shard: torch.Tensor, axis: str,
                                      comm_share: float | None = None,
                                      ratio: float | None = None, *,
                                      mesh: Mesh) -> torch.Tensor:
    """row_parallel_dense_scattered with the arm chosen by
    use_fused_overlap: the fused B5a, or the plain dot with f32
    accumulation and spmd.reduce_scatter (B4a), the same (P, m / n, cols)
    result. The ratio defaults to this process's cached probe for
    (m, k, n, dtype); on a process mesh the decision is agreed_dispatch's."""
    _, m, k = x_shard.shape
    p = spmd.size(axis, mesh=mesh)
    if ratio is None:
        ratio = _cached_ratio(m, k, p, x_shard.dtype)
    if agreed_dispatch(mesh, m, k, w_shard.shape[2], p, comm_share, ratio):
        return row_parallel_dense_scattered(x_shard, w_shard, axis,
                                            mesh=mesh)
    partial = _dot(x_shard, w_shard)
    with annotate("gloo_tpu.tp.row_scatter"):
        return spmd.reduce_scatter(partial, axis, scatter_axis=0, mesh=mesh)


def allgather_matmul_dense_auto(x_rows_shard: torch.Tensor, w: torch.Tensor,
                                axis: str, comm_share: float | None = None,
                                ratio: float | None = None, *,
                                mesh: Mesh) -> torch.Tensor:
    """allgather_matmul_dense with the arm chosen by use_fused_overlap (the
    same rule as the reduce-scatter side), else spmd.allgather (B4b) and
    the plain dot. The probe's m is the gathered rows, rows * n, as in
    JAX."""
    _, rows, k = x_rows_shard.shape
    p = spmd.size(axis, mesh=mesh)
    if ratio is None:
        ratio = _cached_ratio(rows * p, k, p, x_rows_shard.dtype)
    if agreed_dispatch(mesh, rows * p, k, w.shape[2], p, comm_share, ratio):
        return allgather_matmul_dense(x_rows_shard, w, axis, mesh=mesh)
    with annotate("gloo_tpu.tp.allgather_x"):
        gathered = spmd.allgather(x_rows_shard, axis, gather_axis=0,
                                  mesh=mesh)
    return _dot(gathered, w)
