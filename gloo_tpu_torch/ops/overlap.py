"""Collective matmuls on hand-written Hopper kernels.

Counterpart of gloo_tpu/ops/overlap.py: ``matmul_reduce_scatter`` (B5a)
and ``allgather_matmul`` (B5b), each the other's transpose. The Pallas
kernels become ``csrc/overlap.cu``, one source with two entry points.

Every function takes world tensors (ring.py's convention): x (P, rows, k)
and w (P, k, cols), row r of each what flat rank r holds. w may be an
``expand``ed view with rank stride 0, one weight shared by every rank. The
rings run along one mesh axis, every ring of that axis in the same launch;
the mesh carries the axis order, so the JAX ``mesh_axes`` argument has no
counterpart. Results, as in JAX:
  - matmul_reduce_scatter: x (P, m, k) -> (P, m / n, cols), rank r rows
    [i m / n, (i + 1) m / n) of sum over its ring of x_d @ w_d, i its ring
    index;
  - allgather_matmul: x (P, rows, k) -> (P, n rows, cols), the ring's x
    rows stacked in ring order times the rank's own w.
With a ring of one the result is the plain dot with f32 accumulation and
no kernel runs.

Both are differentiable and exactly dual, as in JAX: B5a's VJP is the ring
allgather (B4b) of the cotangent and two dots, B5b's is B5a of the
cotangent with w transposed and one dot (the gathered x is kept from the
forward). The dots are one 2D product per rank, so a process of a process
mesh computes its rows bit for bit as the one-process world does.

On a process mesh (tpu/multihost.py) both take this process's local x
and w (local ranks, ...) and return its local result: on CUDA tensors
one launch of the kernel's cross-process instance (csrc/overlap.cu's
gtt_overlap_peer) or an error; on CPU tensors the twin on the world
gathered through the host plane. The VJPs cross processes too: B5a's
through the cross-process B4b, B5b's through the cross-process B5a.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain twin, which walks the ring step by step with the
kernel's block indices and add order: each partial is
``(x_b.float() @ w.float()).to(dtype)``, rounded before the one add per
step in the element type, as the TPU kernel rounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, NamedTuple

import torch

from gloo_tpu_torch import _build
from gloo_tpu_torch.ops.ring import (KERNEL_DTYPES, _axis_key, _check_rows,
                                     _ctypes_tables, _gather_world,
                                     _raise_on, _ring_size, _stream,
                                     resident_blocks, residency,
                                     ring_allgather, ring_allgather_plain,
                                     ring_table)

if TYPE_CHECKING:
    from gloo_tpu_torch.tpu.mesh import Mesh

_lib: ctypes.CDLL | None = None
# Most co-resident blocks of the overlap kernels (and of their
# cross-process instances) per bytes of shared memory per block, then per
# device index.
_max_blocks: dict[int, dict[int, int]] = {}
_peer_max_blocks: dict[int, dict[int, int]] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_W = [_P, _L, _P, _L, _L, _L]  # x, its row stride, w, its three strides
# my, right, left (host arrays), the device ring table, ranks, n, slices,
# rows, k, cols, slabs, ring, w_resident, smem, dtype, stream
_TAIL = [_IP, _IP, _IP, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {
    "gtt_matmul_rs": _W + [_P, _P, _P, _I] + _TAIL,
    "gtt_ag_matmul": _W + [_P, _P, _P, _I] + _TAIL,
}

# The kernels' launch plan (csrc/overlap.cu): one block of 128 threads per
# (rank, TILE_M x TILE_N output tile); operands staged by TMA in slabs of
# SLAB_BYTES of depth per row; W's column tile resident in shared memory up
# to MAX_RESIDENT_SLABS slabs deep; a ring of at most MAX_RING x slabs.
TILE_M = TILE_N = 64
SLAB_BYTES = 128
MAX_RESIDENT_SLABS = 8
MAX_RING = 8


class LaunchPlan(NamedTuple):
    """How one call of B5a or B5b is launched. `w_layout`: "rows" (w as it
    lies, unit column stride: MN-major), "cols" (a transposed bf16 view as
    it lies, unit row stride: K-major) or "copy" (copied to rows of w_ld
    elements, for strides TMA cannot describe). x_ld: x's (and gx's) row
    stride in the kernel, k or k padded to 16 bytes."""
    row_tiles: int
    col_tiles: int
    slabs: int
    ring: int
    w_resident: bool
    w_layout: str
    x_ld: int
    w_ld: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory per block (smem_bytes in
        csrc/overlap.cu, which refuses less): the W slabs, the x ring,
        their mbarriers, 1024-byte alignment."""
        w_bufs = self.slabs if self.w_resident else self.ring
        return (w_bufs + self.ring) * TILE_M * SLAB_BYTES \
            + 8 * (self.ring + 1) + 1024


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def launch_plan(dtype: torch.dtype, rows: int, k: int, cols: int,
                w_strides: tuple[int, int, int],
                aligned: bool = True) -> LaunchPlan:
    """The launch plan for chunks of `rows` rows, depth k, `cols` columns,
    and w's element strides (rank, row, column; rank 0 for a shared w).
    `aligned`: x's and w's first elements lie on 16-byte boundaries."""
    elt = torch.tensor([], dtype=dtype).element_size()
    vec = 16 // elt  # elements per 16 bytes: TMA's stride unit
    slabs = -(-k // (SLAB_BYTES // elt))
    w_resident = slabs <= MAX_RESIDENT_SLABS
    ring = min(2 * slabs, MAX_RING) if w_resident else MAX_RING
    rank, sk, sn = w_strides
    w_ok = aligned and rank % vec == 0
    if w_ok and elt == 2 and sk == 1 and sn != 1 \
            and sn % vec == 0:
        layout, w_ld = "cols", sn
    elif w_ok and sn == 1 and sk % vec == 0:
        layout, w_ld = "rows", sk
    else:
        layout, w_ld = "copy", _round_up(cols, vec)
    return LaunchPlan(-(-rows // TILE_M), -(-cols // TILE_N), slabs, ring,
                      w_resident, layout, _round_up(k, vec), w_ld)


def _overlap_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("overlap")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("gtt_overlap_max_blocks",
                     "gtt_overlap_peer_max_blocks"):
            getattr(lib, name).argtypes = [_I, _IP]
            getattr(lib, name).restype = ctypes.c_int
        lib.gtt_overlap_peer.argtypes = [
            _I, _P, _L, _P, _L, _L, _L, _P, _P, _L, _P, _P, _P, _P, _I, _IP,
            _I, _IP, _IP, _IP, _P] + [_I] * 13 + [_P]
        lib.gtt_overlap_peer.restype = ctypes.c_int
        for name in ("gtt_overlap_peer_tile_flags",
                     "gtt_overlap_peer_max_local"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.gtt_overlap_flag_stride.argtypes = [_I]
        lib.gtt_overlap_flag_stride.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [_I]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _operands(x: torch.Tensor, w: torch.Tensor, axis_name: str,
              mesh: Mesh, world: bool = False) -> int:
    """Checks that hold on every device; returns the ring size n. On a
    process mesh x and w are this process's local tensors, unless `world`
    (the twins, which take the world on any mesh)."""
    n = _ring_size(x, axis_name, mesh, local_rows=len(mesh.local_ranks)
                   if mesh.processes > 1 and not world else None)
    if w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"w must be (ranks={x.shape[0]}, k={x.shape[2]}, "
                         f"cols); got {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w lies on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} but w is {w.dtype}")
    return n


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in f32 and rounded once to a's dtype (JAX's
    jnp.dot(..., preferred_element_type=f32).astype(dtype))."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _rank_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_dot of each rank's rows, one 2D product per rank: a batched
    product may split its sums another way for another number of ranks
    (on the CPU and in cuBLAS alike), and this one is the same whether a
    process holds the world or its local ranks only."""
    return torch.stack([_dot(a[r], b[r]) for r in range(a.shape[0])])


def _kernel_w(w: torch.Tensor) -> torch.Tensor:
    """w as the kernels take it: bf16 and f16 as it lies (wgmma reads a
    transposed view, such as B5b's VJP hands B5a, as K-major); f32 with
    unit column stride (a transposed view is copied once). A shared weight
    expanded with rank stride 0 stays one buffer."""
    return w if w.stride(2) == 1 or w.element_size() == 2 \
        else w.contiguous()


def _w_strides(w: torch.Tensor) -> tuple[int, int, int]:
    """w's rank stride in bytes (0 for a shared weight) and its row and
    column strides in elements."""
    return w.stride(0) * w.element_size(), w.stride(1), w.stride(2)


def _plan(x: torch.Tensor, w: torch.Tensor, rows: int):
    """(x, w, plan): the kernels' operands as the plan stages them. x is
    contiguous, its rows padded to x_ld where k * element size is not a
    multiple of 16 bytes; w is copied to rows of w_ld elements where TMA
    cannot describe it as it lies (one copy for a shared w)."""
    x, w = x.contiguous(), _kernel_w(w)
    k, cols = w.shape[1], w.shape[2]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = launch_plan(x.dtype, rows, k, cols,
                       (w.stride(0), w.stride(1), w.stride(2)), aligned)
    if plan.x_ld != k or x.data_ptr() % 16:
        padded = x.new_zeros((*x.shape[:2], plan.x_ld))
        padded[..., :k] = x
        x = padded
    if plan.w_layout == "copy":
        src = w[:1] if w.stride(0) == 0 else w
        padded = w.new_zeros((src.shape[0], k, plan.w_ld))
        padded[..., :cols] = src
        w = padded[..., :cols].expand(x.shape[0], -1, -1)
    return x, w, plan


def _check_kernel(x: torch.Tensor) -> None:
    """The same error on every process before any launch: x's dtype."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the overlap kernels take bf16, f16 or f32, got "
                        f"{x.dtype}")


def _resident(x: torch.Tensor, lib: ctypes.CDLL, plan: LaunchPlan,
              peer: bool = False) -> int:
    """The most blocks of the one-card (or the cross-process) kernels, with
    the plan's shared memory, resident at once on x's card."""
    query = lib.gtt_overlap_peer_max_blocks if peer \
        else lib.gtt_overlap_max_blocks
    cache = (_peer_max_blocks if peer else _max_blocks).setdefault(
        plan.smem, {})
    return resident_blocks(x, lib, functools.partial(query, plan.smem),
                           cache)


def _launch_setup(x: torch.Tensor, mesh: Mesh, axis_name: str,
                  plan: LaunchPlan, kernel: str):
    """(lib, slices, flag stride, ctypes ring tables, device ring table):
    each rank's tiles spread over as many slices as can be resident beside
    the other ranks' (all of them at the fused MLP's shape)."""
    _check_kernel(x)
    lib = _overlap_lib()
    stride = lib.gtt_overlap_flag_stride(mesh.axis_size(axis_name))
    per_rank = residency(kernel, x.shape[0], _resident(x, lib, plan))
    names = _axis_key(axis_name)
    return (lib, min(per_rank, plan.tiles), stride,
            _ctypes_tables(mesh, names), ring_table(mesh, names).data_ptr())


def _plan_args(plan: LaunchPlan) -> tuple[int, int, int, int]:
    return plan.slabs, plan.ring, int(plan.w_resident), plan.smem


# ---- B5a and B5b across processes ----

def _peer_launch(rs: bool, x: torch.Tensor, w: torch.Tensor, axis_name: str,
                 mesh: Mesh, rows: int):
    """One cross-process launch of B5a (`rs`) or B5b on this process's
    local x (local ranks, n rows or rows, k) and w (local ranks, k, cols),
    `rows` the rows of one chunk: (out, None) for B5a, (y, gx) for B5b.
    x, w and the outputs stay in this process's memory; what neighbours
    write (B5a's comm slots, B5b's gx, both kernels' flags) lies in the
    mesh's peer workspace. The family's tag and barrier counts before the
    call come from the workspace ("overlap_tag", "overlap_barrier")."""
    _check_kernel(x)
    n = mesh.axis_size(axis_name)
    local, _, k = x.shape
    cols = w.shape[2]
    x, w, plan = _plan(x, w, rows)
    lib = _overlap_lib()
    if local > lib.gtt_overlap_peer_max_local():
        raise ValueError(f"the cross-process overlap kernels take at most "
                         f"{lib.gtt_overlap_peer_max_local()} local ranks "
                         f"per process, got {local}")
    stride = lib.gtt_overlap_flag_stride(n)
    resident = _resident(x, lib, plan, peer=True)
    ws = mesh.workspace
    elt = x.element_size()
    name = "matmul_reduce_scatter" if rs else "allgather_matmul"
    with torch.cuda.device(x.device):
        per_rank = residency(name, local, resident, functools.partial(
            ws.agree, f"overlap/{plan.smem}"))
        slices = min(per_rank, plan.tiles)
        regions = {"ov_flags": (lib.gtt_overlap_peer_tile_flags()
                                + plan.tiles * stride) * 4}
        if rs:
            regions["comm"] = 2 * plan.tiles * 128 * (
                16 if elt == 2 else 32) * 8
        else:
            regions["gx"] = n * rows * plan.x_ld * elt
        ws.reserve(regions)
        out = torch.empty((local, rows if rs else n * rows, cols),
                          dtype=x.dtype, device=x.device)
        names = _axis_key(axis_name)
        tables = _ctypes_tables(mesh, names)
        empty = (_P * mesh.size)()
        ws.start_together(torch.cuda.current_stream(x.device))
        err = lib.gtt_overlap_peer(
            int(rs), x.data_ptr(), plan.x_ld, w.data_ptr(), *_w_strides(w),
            out.data_ptr(), empty if rs else ws.table("gx"),
            0 if rs else ws.caps["gx"], ws.table("comm") if rs else empty,
            ws.table("ov_flags"), ws.device_table("comm") if rs else None,
            ws.device_table("ov_flags"), stride, tables.local, local,
            tables.my, tables.right, tables.left,
            ring_table(mesh, names).data_ptr(), mesh.size, n, slices, rows,
            k, cols, *_plan_args(plan), KERNEL_DTYPES[x.dtype],
            ws.advance("overlap_tag", n - 1),
            ws.advance("overlap_barrier", (n - 1) * slices), _stream(x))
        _raise_on(err, name, lib)
        if rs:
            return out, None
        # gx is the workspace's until the next call: the caller's copy.
        gx = ws.view("gx", x.dtype, (n * rows, plan.x_ld))
        return out, (gx if plan.x_ld == k else gx[..., :k]).clone()


# ---- B5a: matmul fused with the ring reduce-scatter ----

def _matmul_rs(x: torch.Tensor, w: torch.Tensor, axis_name: str,
               mesh: Mesh) -> torch.Tensor:
    n = _operands(x, w, axis_name, mesh)
    ranks, m, k = x.shape
    cols = w.shape[2]
    _check_rows(m, n)
    if n == 1:
        return _dot(x, w)
    if mesh.processes > 1:
        if x.device.type == "cpu":
            return matmul_reduce_scatter_plain(
                _gather_world(x, mesh), _gather_world(w, mesh), axis_name,
                mesh)[torch.tensor(mesh.local_ranks)]
        out = _peer_launch(True, x, w, axis_name, mesh, m // n)[0]
        matmul_reduce_scatter.launches += 1
        return out
    if x.device.type == "cpu":
        return matmul_reduce_scatter_plain(x, w, axis_name, mesh)
    rows = m // n
    x, w, plan = _plan(x, w, rows)
    lib, slices, stride, tables, table = _launch_setup(
        x, mesh, axis_name, plan, "matmul_reduce_scatter")
    out, comm, flags = _rs_buffers(x, rows, cols, plan.tiles,
                                   plan.tiles * stride)
    with torch.cuda.device(x.device):
        err = lib.gtt_matmul_rs(
            x.data_ptr(), plan.x_ld, w.data_ptr(), *_w_strides(w),
            out.data_ptr(), comm.data_ptr(), flags.data_ptr(), stride,
            tables.my, tables.right, tables.left, table, ranks, n, slices,
            rows, k, cols,
            *_plan_args(plan), KERNEL_DTYPES[x.dtype], _stream(x))
    _raise_on(err, "matmul_reduce_scatter", lib)
    matmul_reduce_scatter.launches += 1
    return out


def _rs_buffers(x: torch.Tensor, rows: int, cols: int, tiles: int,
                flag_ints: int):
    """B5a's buffers: the output (P, rows, cols); per rank two comm slots
    (P, 2, tiles * 128 threads * words): a tile's accumulators as 8-byte
    words (16 per thread in bf16, a pair in each; 32 in f32), each beside
    the tag of the write that stored it; and `flag_ints` int32 flags per
    rank. Slots and flags are zeroed by one fill of one buffer."""
    ranks = x.shape[0]
    words = tiles * 128 * (16 if x.element_size() == 2 else 32)
    flags = ranks * flag_ints
    buf = torch.zeros(ranks * 2 * words + -(-flags // 2), dtype=torch.int64,
                      device=x.device)
    out = torch.empty((ranks, rows, cols), dtype=x.dtype, device=x.device)
    return (out, buf[:ranks * 2 * words].view(ranks, 2, words),
            buf[ranks * 2 * words:].view(torch.int32)[:flags])


class _MatmulReduceScatter(torch.autograd.Function):
    """overlap.py's VJP: dx = gather(g) @ w^T, dw = x^T @ gather(g), one
    ring allgather (B4b) of the cotangent."""

    @staticmethod
    def forward(ctx, x, w, axis_name, mesh):
        ctx.save_for_backward(x, w)
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return _matmul_rs(x, w, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gfull = ring_allgather(g.contiguous(), ctx.axis_name, ctx.mesh)
        dx = _rank_dot(gfull, w.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        dw = _rank_dot(x.transpose(1, 2), gfull) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                          mesh: Mesh) -> torch.Tensor:
    """Rows [i m / n, (i + 1) m / n) of sum_d x_d @ w_d over the ring along
    `axis_name` (i the rank's ring index), the reduce-scatter overlapped
    with the per-block products. x (P, m, k), w (P, k, cols) ->
    (P, m / n, cols); m % n == 0. The row-parallel TP forward with its
    output scattered over rows. Differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad) \
            and _operands(x, w, axis_name, mesh) > 1:
        return _MatmulReduceScatter.apply(x, w, axis_name, mesh)
    return _matmul_rs(x, w, axis_name, mesh)


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
matmul_reduce_scatter.launches = 0


def matmul_reduce_scatter_plain(x: torch.Tensor, w: torch.Tensor,
                                axis_name: str, mesh: Mesh) -> torch.Tensor:
    """B5a's arithmetic in plain PyTorch: stage partial(my - 1), then at
    step s receive the left neighbour's running sum and add partial
    (my - 2 - s), one add in the element type per step."""
    n = _operands(x, w, axis_name, mesh, world=True)
    ranks, m, k = x.shape
    _check_rows(m, n)
    my, _, left = (torch.tensor(t, device=x.device)
                   for t in mesh.ring_neighbors(axis_name))
    ar = torch.arange(ranks, device=x.device)
    blocks = x.reshape(ranks, n, m // n, k)

    def partial(b):
        return _dot(blocks[ar, b], w)

    stage = partial((my - 1) % n)
    for s in range(n - 1):
        stage = stage[left] + partial((my - 2 - s) % n)
    return stage


# ---- B5b: ring allgather fused with the matmul ----

def allgather_matmul_fwd(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                         mesh: Mesh):
    """(y (P, n rows, cols), gx (P, n rows, k)): gather_rows(x) @ w and the
    gathered x itself, bitwise the gathered input. Not differentiable; see
    allgather_matmul."""
    n = _operands(x, w, axis_name, mesh)
    ranks, rows, k = x.shape
    cols = w.shape[2]
    if n == 1:
        return _dot(x, w), x
    if mesh.processes > 1:
        if x.device.type == "cpu":
            mine = torch.tensor(mesh.local_ranks)
            y, gx = allgather_matmul_plain(
                _gather_world(x, mesh), _gather_world(w, mesh), axis_name,
                mesh)
            return y[mine], gx[mine]
        y, gx = _peer_launch(False, x, w, axis_name, mesh, rows)
        allgather_matmul.launches += 1
        return y, gx
    if x.device.type == "cpu":
        return allgather_matmul_plain(x, w, axis_name, mesh)
    x, w, plan = _plan(x, w, rows)
    y = torch.empty((ranks, n * rows, cols), dtype=x.dtype, device=x.device)
    gx = torch.empty((ranks, n * rows, plan.x_ld), dtype=x.dtype,
                     device=x.device)
    lib, slices, stride, tables, table = _launch_setup(
        x, mesh, axis_name, plan, "allgather_matmul")
    flags = torch.zeros(ranks * plan.tiles * stride, dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gtt_ag_matmul(
            x.data_ptr(), plan.x_ld, w.data_ptr(), *_w_strides(w),
            y.data_ptr(), gx.data_ptr(), flags.data_ptr(), stride,
            tables.my, tables.right, tables.left, table, ranks, n, slices,
            rows, k, cols, *_plan_args(plan),
            KERNEL_DTYPES[x.dtype], _stream(x))
    _raise_on(err, "allgather_matmul", lib)
    allgather_matmul.launches += 1
    return y, (gx if plan.x_ld == k else gx[..., :k].contiguous())


class _AllgatherMatmul(torch.autograd.Function):
    """overlap.py's VJP: dx = matmul_reduce_scatter(g, w^T) on the dual
    kernel (B5a), dw = gathered(x)^T @ g with the gathered x kept from the
    forward."""

    @staticmethod
    def forward(ctx, x, w, axis_name, mesh):
        y, gx = allgather_matmul_fwd(x, w, axis_name, mesh)
        ctx.save_for_backward(gx, w)
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return y

    @staticmethod
    def backward(ctx, g):
        gx, w = ctx.saved_tensors
        g = g.contiguous()
        dx = _matmul_rs(g, w.transpose(1, 2), ctx.axis_name, ctx.mesh) \
            if ctx.needs_input_grad[0] else None
        dw = _rank_dot(gx.transpose(1, 2), g) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                     mesh: Mesh) -> torch.Tensor:
    """gather_rows(x over `axis_name`) @ w, the ring allgather overlapped
    with the per-chunk products. x (P, rows, k), w (P, k, cols) ->
    (P, n rows, cols). The column-parallel TP pattern (w may be each rank's
    column shard). Differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad) \
            and _operands(x, w, axis_name, mesh) > 1:
        return _AllgatherMatmul.apply(x, w, axis_name, mesh)
    return allgather_matmul_fwd(x, w, axis_name, mesh)[0]


allgather_matmul.launches = 0


def allgather_matmul_plain(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                           mesh: Mesh):
    """B5b's arithmetic in plain PyTorch: (y, gx). The ring walk of the
    allgather (ring_allgather_plain: own rows into chunk my, then n - 1
    steps that forward chunk my - s), then each chunk's product rounded
    once; every y element is one product, so the order of the chunks does
    not change it."""
    _operands(x, w, axis_name, mesh, world=True)
    gx = ring_allgather_plain(x, axis_name, mesh)
    return _dot(gx, w), gx
