"""The point-to-point transport of spmd across processes: one pull over
the peer workspace on a hand-written Hopper kernel (csrc/permute.cu).

The JAX package has no Pallas kernel here: ppermute, shift, broadcast and
scatter are XLA collectives there (gloo_tpu/tpu/spmd.py:89-131), which
span hosts once jax.distributed has joined them. On a process mesh
(tpu/multihost.py) the port moves them through the same peer-mapped
workspace as the ring kernels' cross-process instances (tpu/peer.py):

    pull(x, axis, mesh, sources, offsets, count)

x is this process's local tensor (local ranks, *value), the rows of
``mesh.local_ranks``. Along `axis` every rank with ring index k receives
`count` elements of the flattened value of the member with ring index
``sources[k]``, starting ``offsets[k]`` elements in, or zeros where
``sources[k]`` is -1. The result is (local ranks, count) in x's dtype.

On CUDA tensors the wrapper launches the kernel or raises: each local
rank's value goes into its row of the workspace's "in" region, every
process makes one cooperative launch (an entry barrier among each ring's
members, the copies, an exit barrier), and the outputs are new tensors.
On CPU tensors it gathers the world through the mesh's host-plane
Context and runs the twin, ``pull_plain``, then keeps the local rows; a
byte copy either way, so the two agree bit for bit in any dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, NamedTuple, Sequence

import torch

from gloo_tpu_torch import _build
from gloo_tpu_torch.ops.ring import (PEER_FLAGS, _axis_key, _ctypes_tables,
                                     _on_world, _raise_on, _stream,
                                     _unit_bytes, resident_blocks, residency,
                                     ring_table)

if TYPE_CHECKING:
    # gloo_tpu_torch.tpu imports this module; the mesh is only read here.
    from gloo_tpu_torch.tpu.mesh import Axis, Mesh

# Threads per block of csrc/permute.cu (kThreads), and units each thread
# moves: the wrapper asks for as many slices as give every thread this
# many (one pass of the kernel's kUnroll), as far as the card holds them.
PERMUTE_THREADS = 256
PERMUTE_UNITS_PER_THREAD = 4

_lib: ctypes.CDLL | None = None
_max_blocks: dict[int, int] = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


def _permute_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("permute")
        # in, out, out stride, flags (host), in, flags (device), local,
        # local ranks, my, members, the device ring table, ranks, n, src,
        # offset (host), the pairs (device), slices, count, unit, before,
        # stream
        lib.gtt_permute_peer.argtypes = [
            _P, _P, _L, _P, _P, _P, _IP, _I, _IP, _IP, _P, _I, _I, _IP,
            ctypes.POINTER(_L), _P, _I, _L, _I, _I, _P]
        lib.gtt_permute_peer.restype = ctypes.c_int
        lib.gtt_permute_peer_max_blocks.argtypes = [_IP]
        lib.gtt_permute_peer_max_blocks.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [_I]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x: torch.Tensor, rows: int, sources: Sequence[int],
           offsets: Sequence[int], count: int, n: int) -> None:
    """The same ValueError in every process, before any work."""
    if x.dim() < 1 or x.shape[0] != rows:
        raise ValueError(f"x must have one row per rank ({rows}); got "
                         f"{tuple(x.shape)}")
    value = x[0].numel() if x.shape[0] else 0
    if len(sources) != n or len(offsets) != n:
        raise ValueError(f"sources and offsets need one entry per ring "
                         f"index ({n}); got {len(sources)} and "
                         f"{len(offsets)}")
    for k, (src, off) in enumerate(zip(sources, offsets)):
        if not -1 <= src < n:
            raise ValueError(f"source {src} of ring index {k} is not a "
                             f"ring index of {n} or -1")
        if src >= 0 and not 0 <= off <= off + count <= value:
            raise ValueError(f"ring index {k} pulls elements [{off}, "
                             f"{off + count}) of a value of {value}")
    if count < 0:
        raise ValueError(f"count {count} < 0")


class PullPlan(NamedTuple):
    """One launch of csrc/permute.cu for this process's local ranks: per
    local rank the flat rank it pulls from (-1: zeros) and the offset in
    accesses; the access in bytes, accesses per output, and slices."""
    src: list[int]
    offset: list[int]
    unit: int
    units: int
    slices: int


def pull_plan(mesh: Mesh, axis_name: Axis, sources: Sequence[int],
              offsets: Sequence[int], count: int, elt: int,
              most: int) -> PullPlan:
    """The plan of a pull of `count` elements of elt bytes (sources and
    offsets as pull takes them), at most `most` slices. The access is the
    widest that divides the count and every offset the ring pulls from
    (each row starts on the workspace's ALIGN boundary and a new output on
    the allocator's): it reads the whole tables, not this process's part,
    so that every process of a ring launches alike and advances the flags
    by the same count."""
    unit = _unit_bytes(count * elt, *(o * elt for s, o in zip(sources, offsets)
                                      if s >= 0))
    units = count * elt // unit
    slices = max(1, min(most, -(-units // (PERMUTE_THREADS
                                           * PERMUTE_UNITS_PER_THREAD))))
    my_index = mesh.ring_index(axis_name)
    members = mesh.ring_members(axis_name)
    mine = [my_index[r] for r in mesh.local_ranks]
    src = [members[r][sources[k]] if sources[k] >= 0 else -1
           for r, k in zip(mesh.local_ranks, mine)]
    off = [offsets[k] * elt // unit if sources[k] >= 0 else 0 for k in mine]
    return PullPlan(src, off, unit, units, slices)


def pull_plain(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
               sources: Sequence[int], offsets: Sequence[int],
               count: int) -> torch.Tensor:
    """The transport on the world tensor x (P, *value) in plain PyTorch:
    row r is `count` elements of its source's flattened value from the
    source's offset, or zeros. A byte copy, as the kernel's."""
    n = mesh.axis_size(axis_name)
    _check(x, mesh.size, sources, offsets, count, n)
    members, my = mesh.ring_members(axis_name), mesh.ring_index(axis_name)
    flat = x.reshape(mesh.size, -1)
    out = flat.new_zeros((mesh.size, count))
    for r in range(mesh.size):
        src = sources[my[r]]
        if src >= 0:
            off = offsets[my[r]]
            out[r] = flat[members[r][src], off:off + count]
    return out


def pull(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
         sources: Sequence[int], offsets: Sequence[int],
         count: int) -> torch.Tensor:
    """Each rank's `count` elements of its source's value along
    `axis_name` (see the module's note), on a process mesh. Collective:
    every process of the mesh makes the same calls in the same order.
    One launch on the card per call, counted on ``pull.launches``."""
    sources = [int(s) for s in sources]
    offsets = [int(o) for o in offsets]
    count = int(count)
    n = mesh.axis_size(axis_name)
    rows = len(mesh.local_ranks)
    _check(x, rows, sources, offsets, count, n)
    if x.device.type == "cpu":
        return _on_world(pull_plain, x, axis_name, mesh, sources, offsets,
                         count)
    if mesh.processes == 1 or mesh.workspace is None:
        raise ValueError("pull moves values between the processes of a "
                         "process mesh (init_multihost) on the card; this "
                         "mesh has no peer workspace")
    out = _pull_peer(x, axis_name, mesh, sources, offsets, count)
    pull.launches += 1
    return out


# Launches of the CUDA kernel in this process; counts nothing on the CPU.
pull.launches = 0


def _pull_peer(x: torch.Tensor, axis_name: Axis, mesh: Mesh,
               sources: list[int], offsets: list[int],
               count: int) -> torch.Tensor:
    """One cross-process launch: x goes into the workspace's input rows
    (unless it is them), every process launches gtt_permute_peer over the
    same tables, and the local outputs are new tensors. The flags' count
    before the call comes from the workspace's "permute" family, to which
    the call adds (n - 1) slices."""
    n = mesh.axis_size(axis_name)
    local = x.shape[0]
    elt = x.element_size()
    value = x[0].numel()
    lib = _permute_lib()
    ws = mesh.workspace
    with torch.cuda.device(x.device):
        resident = resident_blocks(x, lib, lib.gtt_permute_peer_max_blocks,
                                   _max_blocks)
        most = residency("the transport", local, resident,
                         functools.partial(ws.agree, "permute"))
        ws.reserve({"in": max(value * elt, 1), "perm_flags": PEER_FLAGS * 4})
        out = torch.empty((local, count), dtype=x.dtype, device=x.device)
        if count == 0:
            return out
        flat = x.reshape(local, value)
        xin = ws.view("in", x.dtype, (value,))
        if not ws.holds("in", flat):
            xin.copy_(flat)
        plan = pull_plan(mesh, axis_name, sources, offsets, count, elt,
                         most)
        names = _axis_key(axis_name)
        tables = _ctypes_tables(mesh, names)
        # The sources, then the offsets, as the kernel reads them.
        pairs = torch.tensor([*plan.src, *plan.offset], dtype=torch.int64,
                             device=x.device)
        ws.start_together(torch.cuda.current_stream(x.device))
        err = lib.gtt_permute_peer(
            ws.table("in"), out.data_ptr(), count * elt,
            ws.table("perm_flags"), ws.device_table("in"),
            ws.device_table("perm_flags"), tables.local, local, tables.my,
            tables.members, ring_table(mesh, names).data_ptr(), mesh.size,
            n, (ctypes.c_int * local)(*plan.src),
            (ctypes.c_longlong * local)(*plan.offset), pairs.data_ptr(),
            plan.slices, plan.units, plan.unit,
            ws.advance("permute", (n - 1) * plan.slices), _stream(x))
    _raise_on(err, "the transport", lib)
    return out
