"""Ring allreduce, reduce-scatter, allgather, the allreduce variants and
the all-to-all on hand-written Hopper kernels.

Counterpart of gloo_tpu/ops/pallas_ring.py's ``ring_allreduce`` (B3),
``ring_reduce_scatter`` (B4a), ``ring_allgather`` (B4b), their
composition ``ring_allreduce_torus``, the allreduce variants
``ring_allreduce_hbm`` (B9), ``ring_allreduce_q8`` (B10) and
``ring_allreduce_bidir`` (B11), and ``pallas_alltoall`` (B8, here
``alltoall``). The ring kernels become ``csrc/ring.cu``, one source with
three entry points; the variants ``csrc/ring_variants.cu``; the
all-to-all ``csrc/alltoall.cu``.

Every function takes a world tensor ``x`` of shape (P, rows, cols): the
leading axis is the flat rank of ``mesh`` (the TpuProcessGroup
convention), and row r is what rank r holds. The rings run along one mesh
axis, or one ring over a tuple of axes (tpu/mesh.py), every ring of it in
the same launch; ``rows`` must divide by the ring size n. Results, as in
JAX:
  - ring_allreduce: (P, rows, cols), each rank the sum over its ring;
  - ring_reduce_scatter: (P, rows / n, cols), rank r chunk r of the sum;
  - ring_allgather: (P, n rows, cols), the ring's rows in ring order;
  - ring_allreduce_hbm, ring_allreduce_q8, ring_allreduce_bidir: as
    ring_allreduce (q8 an int8-wire approximation of the sum);
  - alltoall: (P, rows, cols), block j of rank r (rows / n rows each) is
    block (ring index of r) of ring member j; any world (P, *local) with a
    split and a concat axis, as lax.all_to_all (tiled).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain twin (``*_plain``), which walks the ring step by step
with the TPU kernel's send and receive chunk indices and adds in the same
order, one add per step in the input dtype (bf16 rounds after every step,
as the TPU kernel's ``o_ref[...] + comm_ref[slot]`` does). A chunk's B3
sum is thus x[c + n - 1] + (... + (x[c + 1] + x[c])), ring indices mod n.
B3, B4a, B9 and B11 do not walk the ring on the card: the rank that
finishes a chunk reads it from every member of its ring in that same order
and adds it up in one pass (csrc/ring.cu, csrc/ring_variants.cu; B11's
right half in the mirrored ring's order, B9 through TMA bulk copies), so
their sums are the twins' bit for bit. The sum kernels B3, B4a, B9 and
B11 take SUM_DTYPES on the card and on the CPU alike (the twins add uint16
and uint32 in a WIDENED type); B10 takes f32. The allgather and the all-to-all move bytes only, in any dtype. The
allgather's kernel and twin push each rank's chunk once into the output
of every member of its ring; the all-to-all's twin moves the split axis
to the front, makes the TPU kernel's block copies and concatenates, while
its kernel pulls each rank's blocks from every member in one pass over
strided blocks (csrc/alltoall.cu), the same bytes to the same places.

No kernel bounds the world's ranks: each reads its rank tables from
device memory (ring_table: one int32 tensor per mesh and axes, built once;
across processes the workspace's device_table of peer pointers). What
bounds a world on one card is the cooperative launch: one slice of every
rank's blocks must be resident at once (residency), or the wrapper raises
naming the kernel.

On a process mesh (tpu/multihost.py's init_multihost: flat ranks spread
over OS processes), ring_allreduce, ring_reduce_scatter and ring_allgather
take this process's local tensor (local ranks, rows, cols), the rows of
``mesh.local_ranks``, and return its local result. On CUDA tensors each
launches the cross-process instance of its kernel (csrc/ring.cu's
gtt_ring_peer, one cooperative launch per process over the peer-mapped
workspace of tpu/peer.py) or raises; on CPU tensors it gathers the world
through the mesh's host-plane Context, runs the twin and keeps the local
rows, so the adds are the kernel's own. The all-to-all does the same
(csrc/alltoall.cu's gtt_alltoall_peer: every member reads the inputs in
the workspace, each rank stores into its own output), and so do the
variants (csrc/ring_variants.cu's gtt_ring_variants_peer: the inputs and
outputs in the workspace, every member's finished chunk stored into every
member's output, as on one card).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from gloo_tpu_torch import _build

if TYPE_CHECKING:
    # gloo_tpu_torch.tpu imports this module; the mesh is only read here.
    from gloo_tpu_torch.tpu.mesh import Axis, Mesh

# Element types of the collective matmul kernels (B5a/B5b in overlap.py)
# by csrc dtype code: bf16 and f16 on wgmma, f32 on the FMA units.
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
# Element types of the sum kernels B3, B4a, B9 and B11 by csrc dtype code
# (GTT_SUM_TYPES of csrc/ring_common.cuh):
# one add per step in the type, as PyTorch adds on the CPU (bf16 and f16 in
# f32 rounded once, integers wrapping in their own width). The twins refuse
# the rest too.
SUM_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2,
              torch.float64: 3, torch.int32: 4, torch.int64: 5,
              torch.int8: 6, torch.uint8: 7, torch.int16: 8,
              torch.uint16: 9, torch.uint32: 10}
# The unsigned types this PyTorch has no add, max or index_put for on the
# CPU, by the signed type that holds their sums over any ring a card can
# hold: n uint16 values fit int32 up to n = 32768, n uint32 values int64 up
# to n = 2**32, and one card holds at most 132 SMs x 32 blocks = 4224 ranks
# of a cooperative launch. The twins add in that type and cast back once: a
# sum mod 2**bits has the same bits in any order, so that is the kernels'
# one wrapping add per member in the type, bit for bit.
WIDENED = {torch.uint16: torch.int32, torch.uint32: torch.int64}
# Threads per block of csrc/ring.cu (kThreads). No kernel has a rank
# ceiling: their rank tables live in device memory (ring_table), and what
# bounds a world on one card is the residency of its cooperative launch
# (residency).
KERNEL_THREADS = 256
# Units (16-byte vectors or elements) of its chunk that each thread of B3
# and B4a sums: the wrapper asks for as many slices as give every thread
# this many (two passes of csrc/ring.cu's kUnroll), as far as the card
# holds them.
SUM_UNITS_PER_THREAD = 4

_lib: ctypes.CDLL | None = None
# Most co-resident ring blocks per device index (gtt_ring_max_blocks), and
# of the cross-process instances (gtt_ring_peer_max_blocks).
_max_blocks: dict[int, int] = {}
_peer_max_blocks: dict[int, int] = {}
# Ints of flags per (local rank, slice) of gtt_ring_peer: ring.cu's
# kPeerFlags (the members barrier's and the exit barrier's).
PEER_FLAGS = 2
# gtt_ring_peer's modes.
_PEER_MODES = {"ring_allreduce": 0, "ring_reduce_scatter": 1,
               "ring_allgather": 2}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
# my, members (host arrays), the device ring table, ranks, n, slices, chunk
_MEMBERS = [_IP, _IP, _P, _I, _I, _I, _L]
_SIGNATURES = {
    # ... dtype, vec, stream
    "gtt_ring_allreduce": [_P, _P, _L, _P, _I] + _MEMBERS + [_I, _I, _P],
    "gtt_ring_reduce_scatter": [_P, _L, _P, _L, _P, _I] + _MEMBERS
    + [_I, _I, _P],
    # ... unit bytes, stream
    "gtt_ring_allgather": [_P, _L, _P, _L, _P, _I] + _MEMBERS + [_I, _P],
}


def _ring_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ring")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # mode, in, out, flags (host), the same (device), local, local ranks
        lib.gtt_ring_peer.argtypes = [_I, _P, _P, _P, _P, _P, _P, _IP, _I] \
            + _MEMBERS + [_I, _I, _I, _P]
        lib.gtt_ring_peer.restype = ctypes.c_int
        for name in ("gtt_ring_max_blocks", "gtt_ring_peer_max_blocks"):
            getattr(lib, name).argtypes = [_IP]
            getattr(lib, name).restype = ctypes.c_int
        lib.gtt_ring_flag_stride.argtypes = [_I]
        lib.gtt_ring_flag_stride.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [_I]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.gtt_error_string(err).decode()} (cudaError {err})")


def _ring_size(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
               local_dims: int | None = 2,
               local_rows: int | None = None) -> int:
    """Checks that hold on every device; returns the ring size n. x is a
    world tensor (P, *local) with `local_dims` local axes (None: any
    number, at least one), or on a process mesh this process's
    (local_rows, *local)."""
    n = mesh.axis_size(axis_name)
    dims_ok = x.dim() >= 2 if local_dims is None \
        else x.dim() == 1 + local_dims
    ranks = mesh.size if local_rows is None else local_rows
    if not dims_ok or x.shape[0] != ranks:
        want = "..." if local_dims is None else "rows, cols"
        what = "a world tensor" if local_rows is None else \
            "this process's local tensor"
        raise ValueError(f"x must be {what} (ranks={ranks}, "
                         f"{want}); got {tuple(x.shape)}")
    dev = mesh.device
    if x.device.type != dev.type or (
            dev.type == "cuda" and dev.index is not None
            and x.device.index != dev.index):
        raise ValueError(f"x lies on {x.device}, the mesh on {dev}")
    return n


def _check_rows(rows: int, n: int) -> None:
    if rows % n != 0:
        raise ValueError(f"rows {rows} not divisible by ring size {n}")


def _check_dtype(x: torch.Tensor, dtypes, what: str) -> None:
    """The same TypeError on the CPU and on the card, before any work."""
    if x.dtype not in dtypes:
        names = ", ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what} takes {names}; got {x.dtype}")


def widened(x: torch.Tensor) -> torch.Tensor:
    """x in the type of WIDENED that holds its sums, else x itself."""
    return x.to(WIDENED.get(x.dtype, x.dtype))


def _kernel_layout(x: torch.Tensor, chunk_elems: int, *more: torch.Tensor):
    """(dtype code, vec, units per chunk) of B3 and B4a: 16-byte units
    where every chunk is a whole number of them and every buffer is
    16-byte aligned."""
    per_vec = 16 // x.element_size()
    vec = chunk_elems % per_vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, *more))
    return (SUM_DTYPES[x.dtype], int(vec),
            chunk_elems // per_vec if vec else chunk_elems)


def _unit_bytes(nbytes: int, *addresses: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) that divides a piece of
    nbytes and every buffer's start address."""
    return next(unit for unit in (16, 8, 4, 2, 1)
                if nbytes % unit == 0 and all(a % unit == 0
                                              for a in addresses))


def resident_blocks(x: torch.Tensor, lib: ctypes.CDLL, max_blocks,
                    cache: dict[int, int]) -> int:
    """The most blocks of one kernel that can be resident at once on x's
    card, as the library's occupancy query `max_blocks` reports it (cached
    per device index in `cache`)."""
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    if index not in cache:
        resident = ctypes.c_int(0)
        with torch.cuda.device(index):
            _raise_on(max_blocks(ctypes.byref(resident)), "occupancy query",
                      lib)
        cache[index] = resident.value
    return cache[index]


def residency(kernel: str, blocks: int, resident: int, agree=None) -> int:
    """How many times `blocks` blocks (one slice of a launch of `kernel`
    over all its ranks) fit beside each other in the `resident` blocks a
    card holds at once (resident_blocks): the slices per rank a
    cooperative launch may take, at most 65535 where `agree` is given (a
    collective that returns the least over a process mesh's processes, so
    that every process launches alike). Raises a RuntimeError naming the
    kernel when not even one slice fits: this is the only limit on the
    ranks of a world, on one card or across processes."""
    per = resident // blocks
    if agree is not None:
        per = agree(min(per, 65535))
    if per < 1:
        where = f"the card holds {resident}" if agree is None \
            else "a card of the mesh holds fewer"
        raise RuntimeError(f"{kernel}: {blocks} blocks must be resident at "
                           f"once (one slice of every rank of the launch); "
                           f"{where}")
    return per


def cooperative_grid(x: torch.Tensor, mesh: Mesh, axis_name: Axis,
                     lib: ctypes.CDLL, max_blocks, cache: dict[int, int],
                     want: int, stride: int, kernel: str,
                     blocks_per_slice: int = 1, extra: int = 0):
    """(slices, zeroed flags, ctypes ring tables, device ring table) for a
    cooperative launch of `kernel`, `blocks_per_slice` blocks per (rank,
    slice), each with its own `stride` flags: at most `want` slices, and no
    more than can be resident beside the other ranks' blocks (residency).
    `extra` zeroed ints follow the flags."""
    ranks = x.shape[0]
    blocks = ranks * blocks_per_slice  # per slice of the world
    per_rank = residency(kernel, blocks,
                         resident_blocks(x, lib, max_blocks, cache))
    slices = max(1, min(per_rank, want))
    flags = torch.zeros(blocks * slices * stride + extra, dtype=torch.int32,
                        device=x.device)
    names = _axis_key(axis_name)
    return (slices, flags, _ctypes_tables(mesh, names),
            ring_table(mesh, names).data_ptr())


def _launch_setup(x: torch.Tensor, mesh: Mesh, axis_name: Axis,
                  units: int, kernel: str, per_thread: int = 1):
    """(lib, slices, zeroed flags, flag stride, ctypes ring tables, device
    ring table) for `units` per chunk, `per_thread` of them to each
    thread."""
    lib = _ring_lib()
    stride = lib.gtt_ring_flag_stride(mesh.axis_size(axis_name))
    slices, flags, tables, table = cooperative_grid(
        x, mesh, axis_name, lib, lib.gtt_ring_max_blocks, _max_blocks,
        -(-units // (KERNEL_THREADS * per_thread)), stride, kernel)
    return lib, slices, flags, stride, tables, table


def _axis_key(axis_name: Axis) -> tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


class RingTables(NamedTuple):
    """The ring tables along some axes as ctypes int arrays, the host
    copies that the C entries check before a launch: each flat rank's ring
    index, right and left neighbours, the members table (ranks x n, each
    rank's ring in ring order), and this process's local ranks."""
    my: ctypes.Array
    right: ctypes.Array
    left: ctypes.Array
    members: ctypes.Array
    local: ctypes.Array


@functools.lru_cache(maxsize=64)
def _ctypes_tables(mesh: Mesh, names: tuple[str, ...]) -> RingTables:
    """The ring tables along `names` as ctypes int arrays (RingTables): one
    set serves every call on the mesh."""
    ranks = mesh.size
    rows = mesh.ring_members(names)
    local = mesh.local_ranks
    return RingTables(
        *((ctypes.c_int * ranks)(*t) for t in mesh.ring_neighbors(names)),
        (ctypes.c_int * (ranks * len(rows[0])))(
            *(m for row in rows for m in row)),
        (ctypes.c_int * len(local))(*local))


def ring_table_values(mesh: Mesh, names: tuple[str, ...]) -> list[int]:
    """The device ring table's int32 values (csrc/ring_common.cuh's Rings):
    my (ranks), right (ranks), left (ranks), local (this process's flat
    ranks), then members (ranks x n), row r rank r's ring in ring order."""
    my, right, left = mesh.ring_neighbors(names)
    members = [m for row in mesh.ring_members(names) for m in row]
    return [*my, *right, *left, *mesh.local_ranks, *members]


@functools.lru_cache(maxsize=64)
def ring_table(mesh: Mesh, names: tuple[str, ...]) -> torch.Tensor:
    """The ring tables along `names` as one int32 tensor on the mesh's
    device (ring_table_values), built once per (mesh, axes) and kept: the
    kernels read it where they read their rank tables, so a launch copies
    no table, and a world's ranks are bounded by nothing but the card's
    residency. A mesh is never changed once made."""
    return torch.tensor(ring_table_values(mesh, names), dtype=torch.int32,
                        device=mesh.device)


def _sum_launch(x: torch.Tensor, out: torch.Tensor, axis_name: Axis,
                mesh: Mesh, reduce_scatter: bool) -> None:
    """Launches B4a (`reduce_scatter`) or B3 from the contiguous world
    tensor x into out: no buffers but the zeroed flags of one members
    barrier."""
    n = mesh.axis_size(axis_name)
    ranks, rows, cols = x.shape
    dtype, vec, units = _kernel_layout(x, rows // n * cols, out)
    name = "ring_reduce_scatter" if reduce_scatter else "ring_allreduce"
    lib, slices, flags, stride, tables, table = _launch_setup(
        x, mesh, axis_name, units, name, SUM_UNITS_PER_THREAD)
    tail = (flags.data_ptr(), stride, tables.my, tables.members, table,
            ranks, n, slices, units, dtype, vec, _stream(x))
    in_stride = x[0].numel() * x.element_size()
    with torch.cuda.device(x.device):
        if reduce_scatter:
            err = lib.gtt_ring_reduce_scatter(
                x.data_ptr(), in_stride, out.data_ptr(),
                out[0].numel() * out.element_size(), *tail)
        else:
            err = lib.gtt_ring_allreduce(x.data_ptr(), out.data_ptr(),
                                         in_stride, *tail)
    _raise_on(err, name, lib)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---- B3, B4a and B4b across processes ----

def _out_shape(name: str, rows: int, cols: int, n: int) -> tuple[int, int]:
    return {"ring_allreduce": (rows, cols),
            "ring_reduce_scatter": (rows // n, cols),
            "ring_allgather": (n * rows, cols)}[name]


def _gather_world(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The world tensor (P, *local) of a process mesh on the CPU: every
    process's local rows gathered as bytes through the mesh's host-plane
    Context (padded to the most local ranks of any process), in flat-rank
    order."""
    counts = [mesh.process_of.count(q) for q in range(mesh.processes)]
    rows = x.reshape(x.shape[0], -1).contiguous().view(torch.uint8)
    padded = rows.new_zeros((max(counts), rows.shape[1]))
    padded[:rows.shape[0]] = rows
    gathered = mesh.context.allgather(padded)
    world = torch.cat([gathered[q, :c] for q, c in enumerate(counts)])
    return world.view(x.dtype).view(mesh.size, *x.shape[1:])


def _local_rows(mesh: Mesh) -> int | None:
    """The rows of a process mesh's local tensor, None on a one-process
    mesh (a world tensor)."""
    return len(mesh.local_ranks) if mesh.processes > 1 else None


def _on_world(plain, x: torch.Tensor, axis_name: Axis, mesh: Mesh,
              *args) -> torch.Tensor:
    """The twin plain(x, axis_name, mesh, *args) on the CPU: on x itself,
    or on a process mesh on the world gathered through the host plane,
    keeping the local rows."""
    if mesh.processes == 1:
        return plain(x, axis_name, mesh, *args)
    ranks = torch.tensor(mesh.local_ranks)
    return plain(_gather_world(x, mesh), axis_name, mesh, *args)[ranks]


def _peer_reserve(name: str, mesh: Mesh, axis_name: Axis,
                  dtype: torch.dtype, rows: int, cols: int):
    """(library, workspace) with room for a call of `name` on (rows, cols)
    of dtype per local rank of a process mesh on the card (collective)."""
    lib = _ring_lib()
    local = len(mesh.local_ranks)
    resident = resident_blocks(torch.empty(0, device=mesh.device), lib,
                               lib.gtt_ring_peer_max_blocks,
                               _peer_max_blocks)
    out_rows, out_cols = _out_shape(name, rows, cols,
                                    mesh.axis_size(axis_name))
    elt = torch.tensor([], dtype=dtype).element_size()
    ws = mesh.workspace
    with torch.cuda.device(mesh.device):
        slices = residency(name, local, resident,
                           functools.partial(ws.agree, "ring"))
        ws.reserve({"in": rows * cols * elt,
                    "out": out_rows * out_cols * elt,
                    "ring_flags": slices * PEER_FLAGS * 4})
    return lib, ws, slices


def peer_input(name: str, mesh: Mesh, axis_name: Axis, dtype: torch.dtype,
               rows: int, cols: int) -> torch.Tensor:
    """The input rows (local ranks, rows, cols) of the peer workspace of a
    process mesh on the card, reserved for a call of `name`
    ("ring_allreduce", "ring_reduce_scatter" or "ring_allgather") on that
    shape: a call on this very tensor copies nothing in. Valid until the
    workspace grows or closes."""
    _, ws, _ = _peer_reserve(name, mesh, axis_name, dtype, rows, cols)
    return ws.view("in", dtype, (rows, cols))


def _peer_launch(name: str, x: torch.Tensor, axis_name: Axis,
                 mesh: Mesh) -> torch.Tensor:
    """One cross-process launch of B3, B4a or B4b (`name`) on this
    process's local tensor x (local ranks, rows, cols): x goes into the
    workspace's input rows (unless it is them), every process of the mesh
    launches gtt_ring_peer over the same tables, and a copy of the output
    rows comes back. The flags' count before the call comes from the
    workspace's "ring" family, to which the call adds n - 1."""
    n = mesh.axis_size(axis_name)
    local, rows, cols = x.shape
    lib, ws, slices = _peer_reserve(name, mesh, axis_name, x.dtype, rows,
                                    cols)
    out_shape = _out_shape(name, rows, cols, n)
    elt = x.element_size()
    in_bytes = rows * cols * elt
    with torch.cuda.device(x.device):
        if not ws.holds("in", x):
            ws.view("in", x.dtype, (rows, cols)).copy_(x)
        if name == "ring_allgather":
            # The workspace's rows are ALIGN-aligned: the unit divides the
            # chunk alone.
            unit = _unit_bytes(in_bytes)
            dtype, vec, units = unit, 0, in_bytes // unit
        else:
            per_vec = 16 // elt
            chunk_elems = rows // n * cols
            dtype, vec = SUM_DTYPES[x.dtype], int(chunk_elems % per_vec == 0)
            units = chunk_elems // per_vec if vec else chunk_elems
        names = _axis_key(axis_name)
        tables = _ctypes_tables(mesh, names)
        ws.start_together(torch.cuda.current_stream(x.device))
        err = lib.gtt_ring_peer(
            _PEER_MODES[name], *_peer_tables(ws, "in", "out", "ring_flags"),
            tables.local, local, tables.my, tables.members,
            ring_table(mesh, names).data_ptr(), mesh.size, n, slices, units,
            dtype, vec, ws.advance("ring", n - 1), _stream(x))
        _raise_on(err, name, lib)
        return ws.view("out", x.dtype, out_shape).clone()


def _peer_tables(ws, *regions: str) -> tuple:
    """The workspace's pointer tables of `regions`: the host arrays (which
    the C entries check), then the device arrays (which the kernels read),
    in the order of the regions."""
    return (*(ws.table(r) for r in regions),
            *(ws.device_table(r) for r in regions))


def _across(wrapper, plain, x: torch.Tensor, axis_name: Axis,
            mesh: Mesh) -> torch.Tensor:
    """B3, B4a or B4b (`wrapper`, twin `plain`) on a process mesh: x is
    this process's local tensor (local ranks, rows, cols)."""
    name = wrapper.__name__
    n = _ring_size(x, axis_name, mesh, local_rows=len(mesh.local_ranks))
    if name != "ring_allgather":
        _check_dtype(x, SUM_DTYPES, name)
        _check_rows(x.shape[1], n)
    if n == 1:
        return x
    if x.device.type == "cpu":
        return _on_world(plain, x, axis_name, mesh)
    out = _peer_launch(name, x, axis_name, mesh)
    wrapper.launches += 1
    return out


# ---- B3: ring allreduce ----

def _allreduce(x: torch.Tensor, axis_name: Axis, mesh: Mesh) -> torch.Tensor:
    if mesh.processes > 1:
        return _across(ring_allreduce, ring_allreduce_plain, x, axis_name,
                       mesh)
    n = _ring_size(x, axis_name, mesh)
    _check_rows(x.shape[1], n)
    _check_dtype(x, SUM_DTYPES, "ring_allreduce")
    if n == 1:
        return x
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, axis_name, mesh)
    x = x.contiguous()
    out = torch.empty_like(x)
    _sum_launch(x, out, axis_name, mesh, reduce_scatter=False)
    ring_allreduce.launches += 1
    return out


class _SumAllreduce(torch.autograd.Function):
    """A sum-allreduce is linear: the VJP is the same allreduce of the
    cotangent, on the same kernel (pallas_ring.py's _differentiable); for
    the int8 ring that is the straight-through estimator."""

    @staticmethod
    def forward(ctx, x, impl, axis_name, mesh):
        ctx.impl, ctx.axis_name, ctx.mesh = impl, axis_name, mesh
        return impl(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        return ctx.impl(g.contiguous(), ctx.axis_name, ctx.mesh), None, \
            None, None


def _differentiable(impl, x: torch.Tensor, axis_name: Axis,
                    mesh: Mesh) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad \
            and mesh.axis_size(axis_name) > 1:
        return _SumAllreduce.apply(x, impl, axis_name, mesh)
    return impl(x, axis_name, mesh)


def ring_allreduce(x: torch.Tensor, axis_name: Axis,
                   mesh: Mesh) -> torch.Tensor:
    """Sum-allreduce of the world tensor x (P, rows, cols) along
    `axis_name`: every rank gets the sum over its ring, bitwise the same on
    every rank of a ring. Differentiable."""
    return _differentiable(_allreduce, x, axis_name, mesh)


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
ring_allreduce.launches = 0


def _ring_tables(mesh: Mesh, axis_name: Axis, device):
    """(ring index, right, left) of every flat rank as tensors."""
    return tuple(torch.tensor(t, device=device)
                 for t in mesh.ring_neighbors(axis_name))


def _b3_walk(o: torch.Tensor, my: torch.Tensor, left: torch.Tensor,
             n: int) -> torch.Tensor:
    """B3's schedule on the chunks o (P, n, C), in place: reduce-scatter
    then allgather, with the kernel's chunk indices and add order. `my`
    and `left` are each flat rank's ring index and the flat rank it
    receives from."""
    ar = torch.arange(o.shape[0], device=o.device)
    for s in range(n - 1):
        # Every rank sends chunk (my - s) to its right neighbour, whose
        # receive chunk (my_right - s - 1) is that same chunk; rank q gets
        # its left neighbour's.
        sent = o[ar, (my - s) % n]
        recv = (my - s - 1) % n
        o[ar, recv] = o[ar, recv] + sent[left]
    for s in range(n - 1):
        # Rank q's left neighbour forwards its chunk (my_left + 1 - s) into
        # q's output at the same offset, verbatim.
        idx = (my[left] + 1 - s) % n
        o[ar, idx] = o[left, idx]
    return o


def ring_allreduce_plain(x: torch.Tensor, axis_name: Axis,
                         mesh: Mesh) -> torch.Tensor:
    """B3's arithmetic in plain PyTorch: reduce-scatter then allgather,
    step by step, with the kernel's chunk indices and add order."""
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    _check_rows(rows, n)
    my, _, left = _ring_tables(mesh, axis_name, x.device)
    o = widened(x).reshape(ranks, n, rows // n * cols).clone()
    return _b3_walk(o, my, left, n).reshape(ranks, rows, cols).to(x.dtype)


# ---- B4a: ring reduce-scatter ----

def _reduce_scatter(x: torch.Tensor, axis_name: Axis,
                    mesh: Mesh) -> torch.Tensor:
    if mesh.processes > 1:
        return _across(ring_reduce_scatter, ring_reduce_scatter_plain, x,
                       axis_name, mesh)
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    _check_dtype(x, SUM_DTYPES, "ring_reduce_scatter")
    if n == 1:
        return x
    _check_rows(rows, n)
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x, axis_name, mesh)
    x = x.contiguous()
    out = torch.empty((ranks, rows // n, cols), dtype=x.dtype,
                      device=x.device)
    _sum_launch(x, out, axis_name, mesh, reduce_scatter=True)
    ring_reduce_scatter.launches += 1
    return out


class _RingReduceScatter(torch.autograd.Function):
    """The VJP of a reduce-scatter is the allgather of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return _reduce_scatter(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        return _allgather(g.contiguous(), ctx.axis_name, ctx.mesh), None, None


def ring_reduce_scatter(x: torch.Tensor, axis_name: Axis,
                        mesh: Mesh) -> torch.Tensor:
    """Ring reduce-scatter of the world tensor x (P, rows, cols) along
    `axis_name`: (P, rows / n, cols), rank r holding chunk (ring index of
    r) of its ring's sum. Differentiable (the VJP is B4b)."""
    if torch.is_grad_enabled() and x.requires_grad \
            and mesh.axis_size(axis_name) > 1:
        return _RingReduceScatter.apply(x, axis_name, mesh)
    return _reduce_scatter(x, axis_name, mesh)


ring_reduce_scatter.launches = 0


def ring_reduce_scatter_plain(x: torch.Tensor, axis_name: Axis,
                              mesh: Mesh) -> torch.Tensor:
    """B4a's arithmetic in plain PyTorch: the reduce-scatter phase with
    start shift -1 (send chunk my - 1 - s, receive my - 2 - s), then each
    rank keeps chunk my."""
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    _check_rows(rows, n)
    my, _, left = _ring_tables(mesh, axis_name, x.device)
    ar = torch.arange(ranks, device=x.device)
    work = widened(x).reshape(ranks, n, rows // n * cols).clone()
    for s in range(n - 1):
        sent = work[ar, (my - 1 - s) % n]
        recv = (my - 2 - s) % n
        work[ar, recv] = work[ar, recv] + sent[left]
    return work[ar, my].reshape(ranks, rows // n, cols).to(x.dtype)


# ---- B4b: ring allgather ----

def _allgather(x: torch.Tensor, axis_name: Axis, mesh: Mesh) -> torch.Tensor:
    if mesh.processes > 1:
        return _across(ring_allgather, ring_allgather_plain, x, axis_name,
                       mesh)
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    if n == 1:
        return x
    if x.device.type == "cpu":
        return ring_allgather_plain(x, axis_name, mesh)
    x = x.contiguous()
    chunk_bytes = rows * cols * x.element_size()
    out = torch.empty((ranks, n * rows, cols), dtype=x.dtype,
                      device=x.device)
    # A copy: any dtype, moved in the widest unit that fits.
    unit = _unit_bytes(chunk_bytes, x.data_ptr(), out.data_ptr())
    lib, slices, flags, stride, tables, table = _launch_setup(
        x, mesh, axis_name, chunk_bytes // unit, "ring_allgather",
        SUM_UNITS_PER_THREAD)
    with torch.cuda.device(x.device):
        err = lib.gtt_ring_allgather(
            x.data_ptr(), chunk_bytes, out.data_ptr(), n * chunk_bytes,
            flags.data_ptr(), stride, tables.my, tables.members, table,
            ranks, n, slices, chunk_bytes // unit, unit, _stream(x))
    _raise_on(err, "ring_allgather", lib)
    ring_allgather.launches += 1
    return out


class _RingAllgather(torch.autograd.Function):
    """The VJP of an allgather is the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return _allgather(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g.contiguous(), ctx.axis_name, ctx.mesh),
                None, None)


def ring_allgather(x: torch.Tensor, axis_name: Axis,
                   mesh: Mesh) -> torch.Tensor:
    """Ring allgather of the world tensor x (P, rows, cols) along
    `axis_name`: (P, n rows, cols), every rank of a ring holding the ring's
    x rows stacked in ring order. Differentiable (the VJP is B4a)."""
    if torch.is_grad_enabled() and x.requires_grad \
            and mesh.axis_size(axis_name) > 1:
        return _RingAllgather.apply(x, axis_name, mesh)
    return _allgather(x, axis_name, mesh)


ring_allgather.launches = 0


def ring_allgather_plain(x: torch.Tensor, axis_name: Axis,
                         mesh: Mesh) -> torch.Tensor:
    """B4b's data movement in plain PyTorch: each rank's rows, read once,
    stored as chunk (its ring index) of the output of every member of its
    ring, itself included (the TPU kernel's n - 1 forwarding steps put the
    same bytes in the same places). A byte move, as the kernel's, so it
    takes every dtype."""
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    my = torch.tensor(mesh.ring_index(axis_name), device=x.device)
    members = torch.tensor(mesh.ring_members(axis_name), device=x.device)
    flat = x.reshape(ranks, rows * cols).contiguous().view(torch.uint8)
    o = torch.empty((ranks, n, flat.shape[1]), dtype=torch.uint8,
                    device=x.device)
    for k in range(n):
        o[members[:, k], my] = flat
    return o.view(x.dtype).reshape(ranks, n * rows, cols)


# ---- the torus composition (no kernel of its own) ----

def ring_allreduce_torus(x: torch.Tensor, axis_names, mesh: Mesh):
    """Dimension-ordered allreduce over a multi-axis mesh: reduce-scatter
    along each of `axis_names` in order, then allgather in reverse order;
    2 len(axis_names) launches. rows must divide by the product of the
    axes' sizes. The mesh carries its own axis order, so the JAX version's
    `mesh_axes` argument has no counterpart."""
    axes = list(axis_names)
    for ax in axes:
        x = ring_reduce_scatter(x, ax, mesh)
    for ax in reversed(axes):
        x = ring_allgather(x, ax, mesh)
    return x


# ---- B9, B10, B11: the allreduce variants ----

_var_lib: ctypes.CDLL | None = None
# Most co-resident blocks per (variant, tile bytes, stages), then per
# device index (gtt_ring_variants_max_blocks; each kernel its own query).
_var_max_blocks: dict[tuple[int, int, int], dict[int, int]] = {}
# The same for the cross-process instances
# (gtt_ring_variants_peer_max_blocks).
_var_peer_max_blocks: dict[tuple[int, int, int], dict[int, int]] = {}
# csrc/ring_variants.cu's variant codes (B10's register form is _Q8).
_HBM, _Q8, _BIDIR = 0, 1, 2
# B9's stream: bytes per tile (8192, 16384 or 32768: 2, 4 or 8 16-byte
# units per consumer thread) and the shared-memory stages of one tile each
# that the bulk copies fill ahead of the adds. The launch takes (stages +
# 2) tiles of shared memory per block.
HBM_TILE_BYTES = 16384
HBM_STAGES = 4
# B10's register form: the 16-byte units of its chunk that each thread
# holds in registers across the chain (csrc/ring_variants.cu's kQ8Units).
# A chunk past what the resident grid holds that way runs the
# out-of-register form, which keeps the partial in memory between hops.
Q8_REGISTER_UNITS = 8
_Q8_MEM = 3


def _variants_lib() -> ctypes.CDLL:
    global _var_lib
    if _var_lib is None:
        lib = _build.load("ring_variants")
        # x, out, rank stride, flags, flag stride, my, members, device ring
        # table, ranks, n, slices
        head = [_P, _P, _L, _P, _I, _IP, _IP, _P, _I, _I, _I]
        for name, argtypes in (
                ("gtt_ring_allreduce_hbm", head + [_L, _I, _I, _I, _P]),
                ("gtt_ring_allreduce_q8", head + [_L, _I, _P]),
                ("gtt_ring_allreduce_bidir", head + [_L, _L, _I, _P])):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gtt_ring_variants_peer.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _IP, _IP, _P, _I, _I,
            _I, _L, _L, _L, _I, _I, _I, _I, _P]
        lib.gtt_ring_variants_peer.restype = ctypes.c_int
        for name in ("gtt_ring_variants_max_blocks",
                     "gtt_ring_variants_peer_max_blocks"):
            getattr(lib, name).argtypes = [_I, _I, _I, _IP]
            getattr(lib, name).restype = ctypes.c_int
        lib.gtt_ring_variants_flag_stride.argtypes = [_I]
        lib.gtt_ring_variants_flag_stride.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [_I]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _var_lib = lib
    return _var_lib


def _padded_cols(rows: int, cols: int, elt: int, n: int) -> int:
    """The columns the variant kernels take for (rows, cols) of elt-byte
    elements over a ring of n: cols where each chunk of rows / n rows is a
    whole number of 16-byte units, else cols widened to whole units."""
    per_vec = 16 // elt
    return cols if rows // n * cols % per_vec == 0 \
        else -(-cols // per_vec) * per_vec


def _vector_input(x: torch.Tensor, n: int) -> torch.Tensor:
    """x as the variant kernels take it: contiguous, 16-byte aligned, each
    chunk of rows / n rows a whole number of 16-byte units. Otherwise a
    zero-padded copy with cols widened to whole units (padding adds zeros
    to zeros and is cut off again: no value changes)."""
    x = x.contiguous()
    ranks, rows, cols = x.shape
    wide = _padded_cols(rows, cols, x.element_size(), n)
    if wide == cols and x.data_ptr() % 16 == 0:
        return x
    padded = x.new_zeros((ranks, rows, wide))
    padded[..., :cols] = x
    return padded


def _variant_blocks(variant: int, lib: ctypes.CDLL, peer: bool = False):
    """(the occupancy query of `variant`'s kernel, its per-device cache):
    B9's at HBM_TILE_BYTES and HBM_STAGES, each other kernel its own; of
    the cross-process instance where `peer`."""
    tile, stages = (HBM_TILE_BYTES, HBM_STAGES) if variant == _HBM \
        else (0, 0)
    query = lib.gtt_ring_variants_peer_max_blocks if peer \
        else lib.gtt_ring_variants_max_blocks
    cache = _var_peer_max_blocks if peer else _var_max_blocks
    return (lambda ref: query(variant, tile, stages, ref),
            cache.setdefault((variant, tile, stages), {}))


# The wrapper of each variant code, by which a launch is named.
_VARIANT_NAMES = {_HBM: "ring_allreduce_hbm", _Q8: "ring_allreduce_q8",
                  _BIDIR: "ring_allreduce_bidir", _Q8_MEM: "ring_allreduce_q8"}


def _variant_setup(x: torch.Tensor, mesh: Mesh, axis_name: Axis,
                   variant: int, want: int, blocks_per_slice: int = 1,
                   extra: int = 0):
    """(lib, slices, zeroed flags, flag stride, ctypes ring tables, device
    ring table) for a launch of `variant`, its slices bounded by that
    kernel's own occupancy."""
    lib = _variants_lib()
    stride = lib.gtt_ring_variants_flag_stride(mesh.axis_size(axis_name))
    slices, flags, tables, table = cooperative_grid(
        x, mesh, axis_name, lib, *_variant_blocks(variant, lib), want,
        stride, _VARIANT_NAMES[variant], blocks_per_slice, extra)
    return lib, slices, flags, stride, tables, table


def _allreduce_hbm(x: torch.Tensor, axis_name: Axis,
                   mesh: Mesh) -> torch.Tensor:
    n = _ring_size(x, axis_name, mesh, local_rows=_local_rows(mesh))
    ranks, rows, cols = x.shape
    _check_rows(rows, n)
    _check_dtype(x, SUM_DTYPES, "ring_allreduce_hbm")
    if n == 1:
        return x
    if x.device.type == "cpu":
        return _on_world(ring_allreduce_hbm_plain, x, axis_name, mesh)
    if mesh.processes > 1:
        out = _variant_peer(_HBM, x, axis_name, mesh)
        ring_allreduce_hbm.launches += 1
        return out
    xv = _vector_input(x, n)
    per_rank = xv[0].numel() * xv.element_size()
    units = per_rank // n // 16
    out = torch.empty_like(xv)
    # At most one slice per tile; each block streams a run of whole tiles.
    lib, slices, flags, stride, tables, table = _variant_setup(
        xv, mesh, axis_name, _HBM, -(-units * 16 // HBM_TILE_BYTES))
    with torch.cuda.device(x.device):
        err = lib.gtt_ring_allreduce_hbm(
            xv.data_ptr(), out.data_ptr(), per_rank, flags.data_ptr(),
            stride, tables.my, tables.members, table, ranks, n, slices,
            units, HBM_TILE_BYTES, HBM_STAGES, SUM_DTYPES[x.dtype],
            _stream(x))
    _raise_on(err, "ring_allreduce_hbm", lib)
    ring_allreduce_hbm.launches += 1
    return out if xv.shape == x.shape else out[..., :cols]


def ring_allreduce_hbm(x: torch.Tensor, axis_name: Axis,
                       mesh: Mesh) -> torch.Tensor:
    """B9: the sum-allreduce of ring_allreduce, each member's tile of the
    chunk streamed through shared-memory stages by TMA bulk copies and the
    sums stored back by bulk copies. B3's add order, so its result is
    bitwise B3's. SUM_DTYPES; rows % n == 0. Differentiable."""
    return _differentiable(_allreduce_hbm, x, axis_name, mesh)


ring_allreduce_hbm.launches = 0


def ring_allreduce_hbm_plain(x: torch.Tensor, axis_name: Axis,
                             mesh: Mesh) -> torch.Tensor:
    """B9's arithmetic in plain PyTorch: B3's walk (the tiles of the stream
    change no value, the add being elementwise)."""
    return ring_allreduce_plain(x, axis_name, mesh)


def _allreduce_q8(x: torch.Tensor, axis_name: Axis,
                  mesh: Mesh) -> torch.Tensor:
    n = _ring_size(x, axis_name, mesh, local_rows=_local_rows(mesh))
    ranks, rows, cols = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"ring_allreduce_q8 quantizes f32 payloads; got "
                        f"{x.dtype}")
    if n == 1:
        return x  # nothing moves, nothing is quantized
    _check_rows(rows, n)
    if rows // n % 32:
        raise ValueError(f"chunk rows {rows // n} not divisible by 32 (the "
                         f"int8 tiling of the TPU kernel)")
    if x.device.type == "cpu":
        return _on_world(ring_allreduce_q8_plain, x, axis_name, mesh)
    if mesh.processes > 1:
        out = _variant_peer(_Q8, x, axis_name, mesh)
        ring_allreduce_q8.launches += 1
        return out
    xv = _vector_input(x, n)
    units = xv[0].numel() // n // 4  # 16-byte units per chunk
    out = torch.empty_like(xv)
    lib = _variants_lib()
    in_registers = q8_in_registers(
        units, ranks, resident_blocks(xv, lib, *_variant_blocks(_Q8, lib)))
    # As many slices as give each thread one unit, as far as the card holds
    # them; the cells of each chain's maxima follow the flags.
    _, slices, flags, stride, tables, table = _variant_setup(
        xv, mesh, axis_name, _Q8 if in_registers else _Q8_MEM,
        -(-units // KERNEL_THREADS), extra=2 * n * ranks)
    with torch.cuda.device(x.device):
        err = lib.gtt_ring_allreduce_q8(
            xv.data_ptr(), out.data_ptr(), n * units * 16, flags.data_ptr(),
            stride, tables.my, tables.members, table, ranks, n, slices,
            units, int(in_registers), _stream(x))
    _raise_on(err, "ring_allreduce_q8", lib)
    ring_allreduce_q8.launches += 1
    return out


def q8_in_registers(units: int, ranks: int, resident: int) -> bool:
    """Whether B10's register form holds a chunk of `units` 16-byte units:
    every rank's chain gets resident // ranks co-resident blocks of
    KERNEL_THREADS threads, each holding Q8_REGISTER_UNITS units."""
    return resident // ranks * KERNEL_THREADS * Q8_REGISTER_UNITS >= units


def ring_allreduce_q8(x: torch.Tensor, axis_name: Axis,
                      mesh: Mesh) -> torch.Tensor:
    """B10: sum-allreduce over an int8 wire with one f32 scale per chunk
    hop (EQuARX-style), accumulating in f32; every rank of a ring decodes
    bitwise the same result. f32; rows % n == 0 and (rows / n) % 32 == 0;
    a ring of one returns x. Differentiable (straight-through: the VJP is
    the same quantized allreduce of the cotangent)."""
    return _differentiable(_allreduce_q8, x, axis_name, mesh)


ring_allreduce_q8.launches = 0


# f32(1 / 127): the JAX reference's max|chunk| / 127 is a product with it
# once XLA has compiled it (bitwise against the interpreted kernel; a true
# division differs in the last bit now and then).
_INV_127 = float(np.float32(1 / 127))


def _quantize(c: torch.Tensor):
    """(codes as f32, scale) of each row of c (P, C): scale = max|c| *
    f32(1 / 127), codes = clip(round-half-even(c / max(scale, 1e-30)),
    +-127), a true division."""
    scale = c.abs().amax(1) * _INV_127
    safe = scale.clamp_min(1e-30)
    return torch.round(c / safe[:, None]).clamp(-127, 127), scale


def ring_allreduce_q8_plain(x: torch.Tensor, axis_name: Axis,
                            mesh: Mesh) -> torch.Tensor:
    """B10's arithmetic in plain PyTorch: B3's chunk order, each hop's
    chunk quantized whole; the receiver adds q * scale into its f32 chunk
    rounded once (the product and sum in f64, exact in practice, cast once
    to f32: the kernel's fma). Allgather: the owner of chunk my + 1
    quantizes it once and adopts q * scale; the codes and scale travel
    verbatim and every rank decodes q * scale (f32)."""
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    _check_rows(rows, n)
    my, _, left = _ring_tables(mesh, axis_name, x.device)
    ar = torch.arange(ranks, device=x.device)
    o = x.reshape(ranks, n, rows // n * cols).clone()
    for s in range(n - 1):
        q, scale = _quantize(o[ar, (my - s) % n])
        recv = (my - s - 1) % n
        o[ar, recv] = (o[ar, recv].double() + q[left].double()
                       * scale[left].double()[:, None]).float()
    own = (my + 1) % n
    q, scale = _quantize(o[ar, own])
    o[ar, own] = q * scale[:, None]
    for s in range(n - 1):
        # Step s: each rank gets from its left neighbour the codes it holds
        # (its own chunk's at s = 0, then what it got at step s - 1), those
        # of chunk my - s.
        q, scale = q[left], scale[left]
        o[ar, (my - s) % n] = q * scale[:, None]
    return o.reshape(ranks, rows, cols)


def _allreduce_bidir(x: torch.Tensor, axis_name: Axis,
                     mesh: Mesh) -> torch.Tensor:
    n = _ring_size(x, axis_name, mesh, local_rows=_local_rows(mesh))
    ranks, rows, cols = x.shape
    if n == 1:
        return x
    _check_rows(rows, n)
    if cols % 256:
        raise ValueError(f"the bidirectional split needs cols % 256 == 0; "
                         f"got {cols}")
    _check_dtype(x, SUM_DTYPES, "ring_allreduce_bidir")
    if x.device.type == "cpu":
        return _on_world(ring_allreduce_bidir_plain, x, axis_name, mesh)
    if mesh.processes > 1:
        out = _variant_peer(_BIDIR, x, axis_name, mesh)
        ring_allreduce_bidir.launches += 1
        return out
    xv = _vector_input(x, n)
    elt = x.element_size()
    half_units = cols // 2 * elt // 16
    chunk_rows = rows // n
    out = torch.empty_like(xv)
    lib, slices, flags, stride, tables, table = _variant_setup(
        xv, mesh, axis_name, _BIDIR,
        -(-chunk_rows * half_units // (KERNEL_THREADS
                                       * SUM_UNITS_PER_THREAD)),
        blocks_per_slice=2)
    with torch.cuda.device(x.device):
        err = lib.gtt_ring_allreduce_bidir(
            xv.data_ptr(), out.data_ptr(), rows * cols * elt,
            flags.data_ptr(), stride, tables.my, tables.members, table,
            ranks, n, slices, chunk_rows, half_units,
            SUM_DTYPES[x.dtype], _stream(x))
    _raise_on(err, "ring_allreduce_bidir", lib)
    ring_allreduce_bidir.launches += 1
    return out


def ring_allreduce_bidir(x: torch.Tensor, axis_name: Axis,
                         mesh: Mesh) -> torch.Tensor:
    """B11: sum-allreduce on two counter-rotating rings: columns
    [0, cols/2) summed in B3's order, columns [cols/2, cols) in the
    mirrored ring's. SUM_DTYPES; rows % n == 0 and cols % 256 == 0; a
    ring of one returns x. Differentiable."""
    return _differentiable(_allreduce_bidir, x, axis_name, mesh)


ring_allreduce_bidir.launches = 0


def ring_allreduce_bidir_plain(x: torch.Tensor, axis_name: Axis,
                               mesh: Mesh) -> torch.Tensor:
    """B11's arithmetic in plain PyTorch: B3's walk on the left half, and
    on the right half B3's walk on the reversed ring (ring index -my,
    receiving from the right) with chunk c' standing for chunk -c'. uint16
    and uint32 add in WIDENED's type and are cast back once, as B3's twin
    does."""
    n = _ring_size(x, axis_name, mesh)
    ranks, rows, cols = x.shape
    _check_rows(rows, n)
    my, right, left = _ring_tables(mesh, axis_name, x.device)
    h = cols // 2
    mirror = (-torch.arange(n, device=x.device)) % n
    w = widened(x)
    o0 = w[..., :h].reshape(ranks, n, -1).clone()
    o1 = w[..., h:].reshape(ranks, n, -1)[:, mirror].clone()
    _b3_walk(o0, my, left, n)
    _b3_walk(o1, (-my) % n, right, n)
    return torch.cat([o0.view(ranks, rows, h),
                      o1[:, mirror].reshape(ranks, rows, h)], -1).to(x.dtype)


# ---- B9, B10, B11 across processes ----


def _variant_peer_slices(variant: int, lib: ctypes.CDLL, mesh: Mesh,
                         want: int, blocks_per_slice: int = 1) -> int:
    """Slices of one cross-process launch of `variant`: at most `want`,
    and no more than every process's card holds beside its other local
    ranks' blocks (the least over the processes, agreed once per variant
    and kept), so that every process of a ring launches alike."""
    resident = resident_blocks(torch.empty(0, device=mesh.device), lib,
                               *_variant_blocks(variant, lib, peer=True))
    most = residency(_VARIANT_NAMES[variant],
                     len(mesh.local_ranks) * blocks_per_slice, resident,
                     functools.partial(mesh.workspace.agree,
                                       f"variants/{variant}"))
    return max(1, min(most, want))


def _variant_peer(variant: int, x: torch.Tensor, axis_name: Axis,
                  mesh: Mesh) -> torch.Tensor:
    """One cross-process launch of B9, B10 or B11 on this process's local
    tensor x (local ranks, rows, cols), already checked: x goes into the
    workspace's input rows (cols zero-padded to whole 16-byte units where
    a chunk is not, as _vector_input does), every process launches
    gtt_ring_variants_peer over the same tables, and a copy of the output
    rows comes back. B10 takes its register form where the agreed slices
    hold its chunk in registers, else the out-of-register form; its chain
    cells are this process's own, zeroed before the launch. The flags'
    count before the call comes from the workspace's "variants" family, to
    which a call adds (n - 1) x the blocks per rank."""
    n = mesh.axis_size(axis_name)
    local, rows, cols = x.shape
    lib = _variants_lib()
    elt = x.element_size()
    wide = _padded_cols(rows, cols, elt, n)
    nbytes = rows * wide * elt
    units = nbytes // n // 16  # 16-byte units per chunk
    chunk_rows, half_units, bps, cells = 0, 0, 1, None
    ws = mesh.workspace
    with torch.cuda.device(x.device):
        if variant == _HBM:
            slices = _variant_peer_slices(
                _HBM, lib, mesh, -(-units * 16 // HBM_TILE_BYTES))
            code = _HBM
        elif variant == _Q8:
            slices = _variant_peer_slices(_Q8, lib, mesh,
                                          -(-units // KERNEL_THREADS))
            code = _Q8 if -(-units // slices) <= KERNEL_THREADS \
                * Q8_REGISTER_UNITS else _Q8_MEM
            if code == _Q8_MEM:
                slices = _variant_peer_slices(_Q8_MEM, lib, mesh,
                                              -(-units // KERNEL_THREADS))
            cells = torch.zeros(local * 2 * n, dtype=torch.int32,
                                device=x.device)
        else:
            chunk_rows, half_units, bps = rows // n, cols // 2 * elt // 16, 2
            slices = _variant_peer_slices(
                _BIDIR, lib, mesh,
                -(-chunk_rows * half_units // (KERNEL_THREADS
                                               * SUM_UNITS_PER_THREAD)),
                blocks_per_slice=2)
            code = _BIDIR
        ws.reserve({"in": nbytes, "out": nbytes,
                    "var_flags": PEER_FLAGS * 4})
        xin = ws.view("in", x.dtype, (rows, wide))
        if wide != cols:
            xin[..., cols:] = 0
            xin[..., :cols] = x
        elif not ws.holds("in", x):
            xin.copy_(x)
        names = _axis_key(axis_name)
        tables = _ctypes_tables(mesh, names)
        ws.start_together(torch.cuda.current_stream(x.device))
        err = lib.gtt_ring_variants_peer(
            code, *_peer_tables(ws, "in", "out", "var_flags"),
            None if cells is None else cells.data_ptr(), tables.local,
            local, tables.my, tables.members,
            ring_table(mesh, names).data_ptr(), mesh.size, n, slices, units,
            chunk_rows, half_units, HBM_TILE_BYTES, HBM_STAGES,
            SUM_DTYPES[x.dtype],
            ws.advance("variants", (n - 1) * slices * bps), _stream(x))
        _raise_on(err, _VARIANT_NAMES[variant], lib)
        out = ws.view("out", x.dtype, (rows, wide)).clone()
    return out if wide == cols else out[..., :cols]


# ---- B8: the all-to-all ----

_a2a_lib: ctypes.CDLL | None = None
_a2a_max_blocks: dict[int, int] = {}
_a2a_peer_max_blocks: dict[int, int] = {}
# Threads per block of csrc/alltoall.cu (kThreads), and units each thread
# moves per member where runs are long: the wrapper asks for as many slices
# as give every thread this many (one pass of the kernel's kUnroll), as far
# as the card holds them.
ALLTOALL_THREADS = 256
ALLTOALL_UNITS_PER_THREAD = 2


def _alltoall_lib() -> ctypes.CDLL:
    global _a2a_lib
    if _a2a_lib is None:
        lib = _build.load("alltoall")
        lib.gtt_alltoall.argtypes = [_P, _L, _P, _L, _P, _I, _IP, _IP, _P,
                                     _I, _I, _I, _L, _L, _L, _L, _L, _L, _I,
                                     _I, _P]
        lib.gtt_alltoall.restype = ctypes.c_int
        lib.gtt_alltoall_peer.argtypes = [_P, _P, _L, _P, _P, _P, _IP, _I,
                                          _IP, _IP, _P, _I, _I, _I, _L, _L,
                                          _L, _L, _L, _L, _I, _I, _I, _P]
        lib.gtt_alltoall_peer.restype = ctypes.c_int
        for name in ("gtt_alltoall_max_blocks",
                     "gtt_alltoall_peer_max_blocks"):
            getattr(lib, name).argtypes = [_IP]
            getattr(lib, name).restype = ctypes.c_int
        lib.gtt_alltoall_flag_stride.argtypes = []
        lib.gtt_alltoall_flag_stride.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [_I]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _a2a_lib = lib
    return _a2a_lib


class AlltoallPlan(NamedTuple):
    """One launch of csrc/alltoall.cu, in bytes: a block is `block` bytes,
    rows of `in_run` bytes `in_pitch` apart on the input and of `out_run`
    bytes `out_pitch` apart on the output; `run` = gcd(in_run, out_run) is
    copied as one piece, in accesses of `unit` bytes, by `group` threads;
    `want` slices give each thread ALLTOALL_UNITS_PER_THREAD units per
    member (long runs) or one run (short runs)."""
    out_local: tuple
    block: int
    in_run: int
    in_pitch: int
    out_run: int
    out_pitch: int
    run: int
    unit: int
    group: int
    want: int


def alltoall_plan(local, elt: int, n: int, split: int, concat: int,
                  *addresses: int) -> AlltoallPlan:
    """The plan for each rank's contiguous local value of shape `local`
    (elements of `elt` bytes) split along `split` and concatenated along
    `concat` over a ring of n, with the buffers at `addresses` (each rank's
    input and output start at one of them plus a multiple of a rank's
    bytes)."""
    local = tuple(local)
    c = local[split] // n
    out_local = list(local)
    out_local[split] = c
    out_local[concat] *= n
    in_run = c * math.prod(local[split + 1:]) * elt
    out_run = (out_local[concat] // n * math.prod(out_local[concat + 1:])
               * elt)
    block = math.prod(local) * elt // n
    run = math.gcd(in_run, out_run) or 1  # 1 for an empty block
    unit = _unit_bytes(run, *addresses)
    units = run // unit
    group = ALLTOALL_THREADS if units >= ALLTOALL_THREADS \
        else 1 << (units.bit_length() - 1)
    if group == ALLTOALL_THREADS:
        want = -(-block // unit
                 // (ALLTOALL_THREADS * ALLTOALL_UNITS_PER_THREAD))
    else:
        want = -(-(block // run) // (ALLTOALL_THREADS // group))
    return AlltoallPlan(tuple(out_local), block, in_run, n * in_run,
                        out_run, n * out_run, run, unit, group, want)


def _alltoall(x: torch.Tensor, axis_name: Axis, mesh: Mesh, split: int,
              concat: int) -> torch.Tensor:
    across = mesh.processes > 1
    n = _ring_size(x, axis_name, mesh, local_dims=None,
                   local_rows=_local_rows(mesh))
    _check_rows(x.shape[1 + split], n)
    if n == 1:
        return x
    if x.device.type == "cpu":
        return _on_world(alltoall_plain, x, axis_name, mesh, split, concat)
    if across:
        out = _alltoall_peer(x, axis_name, mesh, split, concat)
        alltoall.launches += 1
        return out
    x = x.contiguous()
    ranks = x.shape[0]
    # A new output starts on the allocator's 512-byte boundary: only x's
    # start limits the unit (the kernel checks both).
    plan = alltoall_plan(x.shape[1:], x.element_size(), n, split, concat,
                         x.data_ptr())
    out = torch.empty((ranks, *plan.out_local), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _alltoall_lib()
    stride = lib.gtt_alltoall_flag_stride()
    slices, flags, tables, table = cooperative_grid(
        x, mesh, axis_name, lib, lib.gtt_alltoall_max_blocks,
        _a2a_max_blocks, plan.want, stride, "alltoall")
    rank_bytes = n * plan.block
    with torch.cuda.device(x.device):
        err = lib.gtt_alltoall(
            x.data_ptr(), rank_bytes, out.data_ptr(), rank_bytes,
            flags.data_ptr(), stride, tables.my, tables.members, table,
            ranks, n, slices,
            plan.block,
            plan.in_run, plan.in_pitch, plan.out_run, plan.out_pitch,
            plan.run, plan.unit, plan.group, _stream(x))
    _raise_on(err, "alltoall", lib)
    alltoall.launches += 1
    return out


def _alltoall_peer(x: torch.Tensor, axis_name: Axis, mesh: Mesh, split: int,
                   concat: int) -> torch.Tensor:
    """One cross-process launch of B8 on this process's local tensor x
    (local ranks, *local): x goes into the workspace's input rows, which
    every member reads, and the result into a new local tensor. The flags'
    count before the call comes from the workspace's "alltoall" family,
    to which the call adds (n - 1) slices."""
    n = mesh.axis_size(axis_name)
    lib = _alltoall_lib()
    local = x.shape[0]
    resident = resident_blocks(x, lib, lib.gtt_alltoall_peer_max_blocks,
                               _a2a_peer_max_blocks)
    ws = mesh.workspace
    elt = x.element_size()
    with torch.cuda.device(x.device):
        per_rank = residency("alltoall", local, resident,
                             functools.partial(ws.agree, "alltoall"))
        ws.reserve({"in": x[0].numel() * elt, "a2a_flags": PEER_FLAGS * 4})
        xin = ws.view("in", x.dtype, x.shape[1:])
        if not ws.holds("in", x):
            xin.copy_(x)
        # The workspace's rows are ALIGN-aligned and a new output starts on
        # the allocator's 512-byte boundary: the geometry limits the unit.
        plan = alltoall_plan(x.shape[1:], elt, n, split, concat)
        out = torch.empty((local, *plan.out_local), dtype=x.dtype,
                          device=x.device)
        if out.numel() == 0:
            return out
        slices = max(1, min(per_rank, plan.want))
        names = _axis_key(axis_name)
        tables = _ctypes_tables(mesh, names)
        ws.start_together(torch.cuda.current_stream(x.device))
        err = lib.gtt_alltoall_peer(
            ws.table("in"), out.data_ptr(), out[0].numel() * elt,
            ws.table("a2a_flags"), ws.device_table("in"),
            ws.device_table("a2a_flags"), tables.local, local, tables.my,
            tables.members, ring_table(mesh, names).data_ptr(), mesh.size,
            n, slices, plan.block, plan.in_run, plan.in_pitch,
            plan.out_run, plan.out_pitch, plan.run, plan.unit, plan.group,
            ws.advance("alltoall", (n - 1) * slices), _stream(x))
    _raise_on(err, "alltoall", lib)
    return out


class _Alltoall(torch.autograd.Function):
    """lax.all_to_all's transpose: the VJP is the same all-to-all of the
    cotangent with the split and concat axes swapped (for the block swap
    along the leading axis, the same all-to-all: pallas_ring.py's custom
    VJP)."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh, split, concat):
        ctx.args = (axis_name, mesh, concat, split)
        return _alltoall(x, axis_name, mesh, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _alltoall(g.contiguous(), *ctx.args), None, None, None, None


def alltoall(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
             split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """All-to-all of the world tensor x (P, *local) along `axis_name`, as
    lax.all_to_all (tiled): each rank's local value is split into n blocks
    along `split_axis`, block k goes to ring member k, and each rank
    concatenates the blocks it receives along `concat_axis` in ring order.
    For x (P, rows, cols) and the default axes, block j of rank r's rows is
    block (ring index of r) of its ring member j. Any dtype (a byte copy).
    One launch on the card, reading x as it lies (made contiguous first if
    it is not) into a new output. Differentiable (the VJP swaps the
    axes)."""
    n = _ring_size(x, axis_name, mesh, local_dims=None,
                   local_rows=_local_rows(mesh))
    split = split_axis % (x.dim() - 1)
    concat = concat_axis % (x.dim() - 1)
    if torch.is_grad_enabled() and x.requires_grad and n > 1:
        return _Alltoall.apply(x, axis_name, mesh, split, concat)
    return _alltoall(x, axis_name, mesh, split, concat)


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
alltoall.launches = 0


def _alltoall_leading(x: torch.Tensor, axis_name: Axis,
                      mesh: Mesh) -> torch.Tensor:
    """The TPU kernel's copies over (P, rows, cols), in its order: each
    rank's own block into place, then at step s = 1 .. n - 1 block (my + s)
    of every rank into slot my of its ring member (my + s)."""
    n = mesh.axis_size(axis_name)
    ranks, rows, cols = x.shape
    my = torch.tensor(mesh.ring_index(axis_name), device=x.device)
    members = torch.tensor(mesh.ring_members(axis_name), device=x.device)
    ar = torch.arange(ranks, device=x.device)
    blocks = x.reshape(ranks, n, rows // n * cols)
    o = torch.empty_like(blocks)
    o[ar, my] = blocks[ar, my]
    for s in range(1, n):
        dst = (my + s) % n
        o[members[ar, dst], my] = blocks[ar, dst]
    return o.reshape(ranks, rows, cols)


def alltoall_plain(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
                   split_axis: int = 0, concat_axis: int = 0) -> torch.Tensor:
    """B8 in plain PyTorch: the split axis moved to the front of each
    rank's value, the TPU kernel's block copies in its order, and the
    received blocks concatenated along the concat axis."""
    n = _ring_size(x, axis_name, mesh, local_dims=None)
    local = x.shape[1:]
    split = split_axis % len(local)
    concat = concat_axis % len(local)
    _check_rows(local[split], n)
    moved = x.movedim(1 + split, 1)
    rest = moved.shape[2:]
    out = _alltoall_leading(
        moved.reshape(mesh.size, local[split], math.prod(rest)), axis_name,
        mesh)
    out = out.reshape(mesh.size, n, local[split] // n, *rest)
    out = out.movedim(2, 2 + split).movedim(1, 1 + concat)
    return out.flatten(1 + concat, 2 + concat)
