"""Peer-mapped device memory across the processes of a mesh (CUDA IPC).

Counterpart of what ``jax.distributed`` gives the reference's ring
kernels (gloo_tpu/tpu/multihost.py, gloo_tpu/ops/pallas_ring.py): chips
that other processes own, addressable from inside a kernel. Here each
process allocates one workspace with ``cudaMalloc`` (csrc/peer.cu),
exports its IPC handle through the host plane's store, and opens every
other process's handle; the ring kernels' cross-process instances
(csrc/ring.cu's ``gtt_ring_peer``, csrc/alltoall.cu's
``gtt_alltoall_peer``, csrc/overlap.cu's ``gtt_overlap_peer``,
csrc/ring_variants.cu's ``gtt_ring_variants_peer``) and the
point-to-point transport (csrc/permute.cu's ``gtt_permute_peer``) then load
and store through those pointers and signal through flags in them at
system scope. The pointer tables live in device memory (``device_table``),
filled where the peers are mapped, so no kernel parameter bounds the
world's ranks.

A dedicated allocation, not PyTorch's caching allocator: its base is
known (an IPC handle maps a whole allocation), it is not carved into
expandable segments (``cudaIpcGetMemHandle`` refuses those), and it is
freed only after every peer has closed its mapping. PyTorch sees it as a
uint8 tensor through ``__cuda_array_interface__``.

One process's workspace holds named regions (REGIONS), each a piece per
local rank in the order of ``mesh.local_ranks``, every piece 256-byte
aligned: the ring kernels' inputs, outputs and flags, the all-to-all's
flags, the collective matmuls' flags, B5a's comm slots and B5b's
gathered x, the allreduce variants' flags and the transport's flags. Flags are counters or tags that only grow: each kernel
family keeps a count of its own (``advance``), the same in every
process, from which a call derives the value every flag of the family
had before it. They are never zeroed while mapped, since a peer's store
may land at any time after it entered.

Processes that share one card do not run side by side: the card
time-slices their contexts, and a kernel that spins on a peer's flag
holds the card for whole time slices while that peer still has work
queued. So where two processes of the mesh map the same card
(``shared_card``), a call first finishes this process's queued work and
meets the others at a host-plane barrier, and the kernels start
together; their flags still order everything, as they do across cards.

``pingpong`` is the probe of the hand-off between two processes.
"""

from __future__ import annotations

import ctypes
import json
import math
import time
from typing import Mapping

import torch

from gloo_tpu_torch import _build

# Alignment of every piece of a workspace (bytes).
ALIGN = 256
# The named regions of a workspace, each per local rank, in the order of
# the allocation:
#   "in", "out": the inputs and outputs of B3, B4a, B4b, B9, B10 and B11
#     (ops/ring.py), and the inputs of B8 and of the point-to-point
#     transport (ops/permute.py), which every member of a ring reads;
#   "ring_flags": slices x ops.ring.PEER_FLAGS ints of B3, B4a and B4b;
#   "a2a_flags": B8's entry and exit barriers;
#   "ov_flags": the collective matmuls' barriers and tile flags, "comm"
#     B5a's slots, "gx" B5b's gathered x (ops/overlap.py);
#   "var_flags": B9's, B10's and B11's entry and exit barriers;
#   "perm_flags": the transport's entry and exit barriers.
REGIONS = ("in", "out", "ring_flags", "a2a_flags", "ov_flags", "comm", "gx",
           "var_flags", "perm_flags")

_lib: ctypes.CDLL | None = None
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _peer_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("peer")
        for name, argtypes in {
                "gtt_peer_handle_bytes": [],
                "gtt_peer_alloc": [_L, ctypes.POINTER(_P)],
                "gtt_peer_free": [_P],
                "gtt_peer_export": [_P, _P, _P, ctypes.POINTER(_L)],
                "gtt_peer_open": [_P, ctypes.POINTER(_P)],
                "gtt_peer_close": [_P],
                "gtt_peer_pingpong": [_P, _P, _I, _I, _P]}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gtt_peer_error_string.argtypes = [_I]
        lib.gtt_peer_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} failed: {_peer_lib().gtt_peer_error_string(err).decode()}"
            f" (cudaError {err})")


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def card_id(device: torch.device) -> str:
    """The physical card behind a CUDA device: its UUID (or PCI address),
    the same in every process whatever the device's index there."""
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{props.pci_domain_id}:{props.pci_bus_id}:{props.pci_device_id}"


class _DeviceBytes:
    """A raw device allocation as PyTorch's CUDA array interface sees it:
    torch.as_tensor(obj, device=...) makes a uint8 tensor over it and keeps
    obj alive."""

    def __init__(self, ptr: int, nbytes: int):
        self.ptr, self.nbytes = ptr, nbytes

    @property
    def __cuda_array_interface__(self):
        return {"shape": (self.nbytes,), "typestr": "|u1",
                "data": (self.ptr, False), "version": 2}


class _Allocation:
    """cudaMalloc'd, zeroed bytes on the current device; free() once."""

    def __init__(self, nbytes: int, device: torch.device):
        ptr = _P()
        with torch.cuda.device(device):
            _check(_peer_lib().gtt_peer_alloc(nbytes, ctypes.byref(ptr)),
                   f"cudaMalloc of {nbytes} bytes")
        self.ptr, self.nbytes, self.device = ptr.value, nbytes, device
        self.bytes = torch.as_tensor(_DeviceBytes(self.ptr, nbytes),
                                     device=device)

    def handle(self) -> bytes:
        lib = _peer_lib()
        out = ctypes.create_string_buffer(lib.gtt_peer_handle_bytes())
        offset = _L()
        with torch.cuda.device(self.device):
            _check(lib.gtt_peer_export(self.ptr, self.ptr, out,
                                       ctypes.byref(offset)),
                   "cudaIpcGetMemHandle")
        return out.raw

    def free(self) -> None:
        if self.ptr:
            self.bytes = None
            with torch.cuda.device(self.device):
                _check(_peer_lib().gtt_peer_free(self.ptr), "cudaFree")
            self.ptr = 0


class _Mappings:
    """The peers' allocations this process has opened, by handle bytes: a
    handle is opened once, never this process's own, and closed before
    its owner frees it (close_all, then a host-plane barrier)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.opened: dict[bytes, int] = {}

    def open(self, handle: bytes) -> int:
        if handle not in self.opened:
            ptr = _P()
            with torch.cuda.device(self.device):
                _check(_peer_lib().gtt_peer_open(handle, ctypes.byref(ptr)),
                       "cudaIpcOpenMemHandle")
            self.opened[handle] = ptr.value
        return self.opened[handle]

    def close_all(self) -> None:
        with torch.cuda.device(self.device):
            while self.opened:
                _, ptr = self.opened.popitem()
                _check(_peer_lib().gtt_peer_close(ptr),
                       "cudaIpcCloseMemHandle")


def exchange(ctx, store, key: str, record) -> list:
    """Every process's record (JSON) under `key`, by process index (the
    host plane's rank): one set and size - 1 gets on the store. The k-th
    exchange under a key on a context uses its own keys (every process
    makes the same exchanges in the same order), so no process reads a
    record of an earlier one. After a barrier, rank 0, which hosts the
    store (init_multihost), deletes them all: a delete by another rank
    could reach the store after rank 0 had gone on, closed its context
    and with it the store's server."""
    counts = ctx.__dict__.setdefault("_exchanges", {})
    counts[key] = counts.get(key, 0) + 1
    prefix = f"{key}/{counts[key]}"
    store.set(f"{prefix}/{ctx.rank}", json.dumps(record).encode())
    records = [record if q == ctx.rank else
               json.loads(store.get(f"{prefix}/{q}", timeout=ctx._timeout))
               for q in range(ctx.size)]
    ctx.barrier()
    if ctx.rank == 0:
        for q in range(ctx.size):
            store.delete(f"{prefix}/{q}")
    return records


class PeerWorkspace:
    """This process's symmetric region of a process mesh, mapped into
    every other process of it.

    Made by init_multihost (nothing is allocated until the first call
    that needs it). The allocation holds named regions (REGIONS), each
    ``caps[name]`` bytes per local rank, and each kernel family keeps its
    own flags in a region of its own and its own count of them
    (``advance``): a count that only grows cannot be shared by kernels
    that add different amounts per call, or that touch a different part
    of the flags. ``reserve`` and ``agree`` are collective, as the calls
    that use them are: every process makes the same calls in the same
    order. ``close`` (also collective; the mesh's Context runs it before
    it closes) closes the peers' mappings, meets the others at a
    host-plane barrier, and frees this process's allocation."""

    def __init__(self, mesh, ctx, store, device: torch.device):
        self.mesh, self.ctx, self.store = mesh, ctx, store
        self.device = torch.device(device)
        self.local = len(mesh.local_ranks)
        # Bytes per local rank of each named region, and where the
        # region's first rank starts in this process's allocation.
        self.caps: dict[str, int] = {}
        self._offsets: dict[str, int] = {}
        # Whether two processes of the mesh share a card (time-sliced).
        self.shared_card = False
        # Each family's count before its next call.
        self.counts: dict[str, int] = {}
        self._agreed: dict[str, int] = {}
        self._alloc: _Allocation | None = None
        self._maps = _Mappings(self.device)
        self._tables: dict[str, ctypes.Array] = {}
        # The same tables in device memory, one int64 row per region.
        self._device_tables: torch.Tensor | None = None
        self._device_rows: dict[str, int] = {}

    def reserve(self, regions: Mapping[str, int]) -> None:
        """Makes room for regions[name] bytes per local rank in each named
        region: a new allocation, exchanged and mapped anew, where a
        region is missing or smaller (collective; it at least doubles a
        region that grows). A new allocation is zeroed, so every family's
        count restarts at 0."""
        unknown = set(regions) - set(REGIONS)
        if unknown:
            raise ValueError(f"unknown workspace regions {sorted(unknown)}; "
                             f"the regions are {REGIONS}")
        if self._alloc is not None and all(
                b <= self.caps.get(name, 0) for name, b in regions.items()):
            return
        caps = dict(self.caps)
        for name, b in regions.items():
            if b > caps.get(name, 0):
                caps[name] = _aligned(max(b, 2 * caps.get(name, 0)))
        self._release()
        offsets, at = {}, 0
        for name in REGIONS:
            if name in caps:
                offsets[name] = at
                at += self.local * caps[name]
        self._alloc = _Allocation(at, self.device)
        record = dict(offsets=offsets, caps=caps,
                      handle=self._alloc.handle().hex(),
                      ranks=list(self.mesh.local_ranks),
                      card=card_id(self.device))
        records = exchange(self.ctx, self.store, "gloo_tpu_torch/peer",
                           record)
        self.caps, self._offsets = caps, offsets
        self.shared_card = len({r["card"] for r in records}) < len(records)
        self.counts = {}
        tables = {name: [0] * self.mesh.size for name in caps}
        for q, rec in enumerate(records):
            base = self._alloc.ptr if q == self.ctx.rank else \
                self._maps.open(bytes.fromhex(rec["handle"]))
            for i, r in enumerate(rec["ranks"]):
                for name in caps:
                    tables[name][r] = (base + rec["offsets"][name]
                                       + i * rec["caps"][name])
        self._tables = {name: (_P * self.mesh.size)(*t)
                        for name, t in tables.items()}
        self._device_rows = {name: i for i, name in enumerate(tables)}
        self._device_tables = torch.tensor(list(tables.values()),
                                           dtype=torch.int64,
                                           device=self.device)
        # No peer may launch on this allocation before every process has
        # mapped every other one.
        self.ctx.barrier()

    def table(self, region: str):
        """Every flat rank's part of `region` as the ctypes array of
        device pointers the kernels take (peer-mapped, or this process's
        own for its local ranks)."""
        return self._tables[region]

    def device_table(self, region: str) -> int:
        """The address of table(region) in device memory, where the kernels
        read it (a kernel's parameters hold no per-rank table, so a world
        has no rank ceiling): valid until the next reserve that grows the
        workspace, or close."""
        return self._device_tables[self._device_rows[region]].data_ptr()

    def view(self, region: str, dtype: torch.dtype, shape) -> torch.Tensor:
        """The local ranks' parts of `region` as a (local ranks, *shape)
        tensor of dtype (each rank's part contiguous, caps[region] bytes
        apart): valid until the next reserve that grows the workspace, or
        close."""
        nbytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
        cap = self.caps[region]
        if nbytes > cap:
            raise ValueError(f"{nbytes} bytes per rank do not fit the "
                             f"{cap} of region {region!r}")
        start = self._offsets[region]
        rows = self._alloc.bytes[start:start + self.local * cap]
        return rows.view(self.local, cap)[:, :nbytes].view(dtype).view(
            self.local, *shape)

    def holds(self, region: str, x: torch.Tensor) -> bool:
        """Whether x is view(region, x.dtype, x.shape[1:]) itself, so no
        copy into it is needed."""
        if self._alloc is None or region not in self.caps or x.dim() < 2 \
                or x.shape[0] != self.local:
            return False
        nbytes = x[0].numel() * x.element_size()
        if nbytes > self.caps[region]:
            return False
        want = self.view(region, x.dtype, x.shape[1:])
        return (x.data_ptr() == want.data_ptr()
                and x.stride() == want.stride())

    def agree(self, key: str, value: int) -> int:
        """The least `value` over the processes under `key` (collective the
        first time a key is asked for, then cached): a launch's slices,
        which every process of a ring must take alike, from each card's
        occupancy and each process's number of local ranks."""
        if key not in self._agreed:
            self._agreed[key] = min(int(v) for v in exchange(
                self.ctx, self.store, f"gloo_tpu_torch/agree/{key}",
                int(value)))
        return self._agreed[key]

    def start_together(self, stream) -> None:
        """On a shared card: finish this process's queued work on
        `stream`, then meet every process at a host-plane barrier, so that
        no launch spins through time slices a peer still needs."""
        if self.shared_card:
            stream.synchronize()
            self.ctx.barrier()

    def advance(self, family: str, amount: int) -> int:
        """Family `family`'s count before its next call, which then adds
        `amount` to it: the value every flag or tag of the family had
        before the call, the same in every process."""
        before = self.counts.get(family, 0)
        self.counts[family] = before + amount
        return before

    def _release(self) -> None:
        """Closes the peers' mappings, meets every process at a barrier
        (then no peer maps this allocation), and frees it."""
        if self._alloc is None:
            return
        torch.cuda.synchronize(self.device)
        self._maps.close_all()
        self.ctx.barrier()
        self._alloc.free()
        self._alloc = None
        self._tables = {}
        self._device_tables = None
        self._device_rows = {}

    def close(self) -> None:
        """Collective: every process of the mesh closes its workspace."""
        self._release()


def pingpong(ctx, store, rounds: int, device="cuda") -> dict:
    """The probe of the hand-off between processes: ranks 0 and 1 of the
    host plane's Context `ctx` each map the other's flag (one int in a
    workspace of their own) and bounce a counter through them `rounds`
    times, one spinning thread each (csrc/peer.cu). Returns {"rounds",
    "ms" (CUDA events around the launch), "round_trips_per_s"}; the other
    ranks only meet the barriers."""
    device = torch.device(device)
    alloc = _Allocation(ALIGN, device)
    maps = _Mappings(device)
    records = exchange(ctx, store, "gloo_tpu_torch/pingpong",
                       {"handle": alloc.handle().hex()})
    out = {"rounds": rounds}
    try:
        if ctx.rank < 2:
            peer = maps.open(bytes.fromhex(records[1 - ctx.rank]["handle"]))
        ctx.barrier()
        if ctx.rank < 2:
            lib = _peer_lib()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(device)
            t0 = time.perf_counter()
            start.record(stream)
            _check(lib.gtt_peer_pingpong(alloc.ptr, peer, int(ctx.rank == 0),
                                         rounds, stream.cuda_stream),
                   "the ping-pong launch")
            end.record(stream)
            end.synchronize()
            out["host_s"] = time.perf_counter() - t0
            out["ms"] = start.elapsed_time(end)
            out["round_trips_per_s"] = rounds / (out["ms"] / 1e3)
    finally:
        torch.cuda.synchronize(device)
        maps.close_all()
        ctx.barrier()
        alloc.free()
    return out
