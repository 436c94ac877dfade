"""Host data plane over torch tensors: stores, devices, contexts and the
collectives of the C++ core.

Counterpart of gloo_tpu/core.py (the part the port needs), with torch
tensors standing in for numpy arrays. A CPU tensor is reduced in place,
with no copy: its ``data_ptr()`` goes to the native call. A CUDA tensor is
staged through pinned host memory, the role of the reference's host
workspace (``CudaHostPointer``, gloo/cuda_collectives_host.h): a pinned
buffer from the context's pool (keyed by dtype and length, so the native
plan cache sees a stable pointer) takes a device-to-host copy, the tensor's
stream is synchronized, the native collective runs on the buffer, and a
host-to-device copy brings the result back on the input's device. The
buffer goes back to the pool with an event recorded after that copy, and
is not handed out again before the event has completed.

Every collective must be entered by every rank with matching arguments,
as in the reference; concurrent collectives on one context need distinct
tags.
"""

from __future__ import annotations

import ctypes
import json
import os
import weakref
from typing import Optional, Sequence

import torch

from gloo_tpu_torch import _lib
from gloo_tpu_torch._lib import (Aborted, Error, IoError, TimeoutError,
                                 check, check_handle)

__all__ = [
    "Aborted",
    "AsyncEngine",
    "Context",
    "Device",
    "Error",
    "FileStore",
    "HashStore",
    "IoError",
    "PrefixStore",
    "ReduceOp",
    "Store",
    "TcpStore",
    "TcpStoreServer",
    "TimeoutError",
    "Work",
]

# The native dtype codes (gloo_tpu/core.py:55-66). bfloat16 is its own code,
# so the native bf16 add runs.
_DTYPE_CODES = {
    torch.int8: 0,
    torch.uint8: 1,
    torch.int32: 2,
    torch.uint32: 3,
    torch.int64: 4,
    torch.uint64: 5,
    torch.float16: 6,
    torch.bfloat16: 7,
    torch.float32: 8,
    torch.float64: 9,
}


class ReduceOp:
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3

    _BY_NAME = {"sum": SUM, "product": PRODUCT, "prod": PRODUCT, "min": MIN,
                "max": MAX}

    @classmethod
    def parse(cls, op) -> int:
        if isinstance(op, str):
            return cls._BY_NAME[op.lower()]
        return int(op)


def _dtype_code(t: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise Error(f"unsupported dtype: {str(t.dtype).removeprefix('torch.')}")
    return code


def _check_tensor(t) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"tensor must be a torch tensor, got {type(t)}")
    if not t.is_contiguous():
        raise Error("tensor must be C-contiguous")
    return t


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _counts_arg(counts: Sequence[int]):
    return (ctypes.c_size_t * len(counts))(*counts)


def _resolve_recv_counts(recv_counts, numel: int, size: int):
    if recv_counts is None:
        if numel % size != 0:
            raise Error("reduce_scatter: array size not divisible by "
                        "group size (pass recv_counts)")
        return [numel // size] * size
    recv_counts = list(recv_counts)
    if len(recv_counts) != size:
        raise Error(f"reduce_scatter: recv_counts needs one entry per "
                    f"rank ({size}), got {len(recv_counts)}")
    if sum(recv_counts) != numel:
        raise Error("reduce_scatter: sum(recv_counts) != array.size")
    return recv_counts


# ---- staging of CUDA tensors through pinned host memory ----
# The four steps are module functions so that a test can stand them in on
# a machine without a card and see their order.

def _pinned_empty(numel: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(numel, dtype=dtype, pin_memory=True)


def _to_host(host: torch.Tensor, t: torch.Tensor) -> None:
    host.copy_(t.reshape(-1), non_blocking=True)


def _sync(device: torch.device) -> None:
    torch.cuda.current_stream(device).synchronize()


def _to_device(t: torch.Tensor, host: torch.Tensor) -> None:
    t.view(-1).copy_(host.view(-1), non_blocking=True)


def _record(device: torch.device):
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _PinnedPool:
    """Pinned host buffers keyed by (dtype, numel). A buffer is handed out
    once the event recorded after its last host-to-device copy has
    completed."""

    _CAP = 4  # buffers kept per key

    def __init__(self):
        self._free: dict[tuple, list] = {}

    def take(self, dtype: torch.dtype, numel: int) -> torch.Tensor:
        stack = self._free.get((dtype, numel))
        if stack:
            buf, event = stack.pop()
            if event is not None:
                event.synchronize()
            return buf
        return _pinned_empty(numel, dtype)

    def give(self, buf: torch.Tensor, event) -> None:
        stack = self._free.setdefault((buf.dtype, buf.numel()), [])
        if len(stack) < self._CAP:
            stack.append((buf, event))


def _staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


class Store:
    """Base rendezvous store handle."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, handle: int):
        self._handle = handle
        # Bound at construction: module globals may already be cleared
        # when __del__ runs during interpreter shutdown.
        self._free = _lib.lib().tc_store_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)

    def set(self, key: str, value: bytes) -> None:
        data = (ctypes.c_uint8 * len(value)).from_buffer_copy(value) \
            if value else (ctypes.c_uint8 * 0)()
        check(_lib.lib().tc_store_set(self._handle, key.encode(), data,
                                      len(value)))

    def get(self, key: str, timeout: float = 30.0) -> bytes:
        return _lib.copy_out(_lib.lib().tc_store_get, self._handle,
                             key.encode(), int(timeout * 1000))

    def add(self, key: str, delta: int) -> int:
        result = ctypes.c_int64()
        check(_lib.lib().tc_store_add(self._handle, key.encode(), delta,
                                      ctypes.byref(result)))
        return result.value

    def delete(self, key: str) -> bool:
        """Remove `key`; True when it existed. A waiter blocked on a deleted
        key keeps waiting: deletion is namespace hygiene (lease reaping,
        retired rebuild namespaces), not signalling."""
        deleted = ctypes.c_int(0)
        check(_lib.lib().tc_store_delete(self._handle, key.encode(),
                                         ctypes.byref(deleted)))
        return bool(deleted.value)

    def list(self, prefix: str = "") -> "list[str]":
        """Keys present under `prefix` (relative to this store's namespace),
        in no set order; a snapshot: keys created or deleted meanwhile may
        or may not appear."""
        return json.loads(_lib.copy_out(_lib.lib().tc_store_list,
                                        self._handle, prefix.encode()))


class HashStore(Store):
    """In-process store for multi-rank-in-one-process tests."""

    def __init__(self):
        super().__init__(check_handle(_lib.lib().tc_hash_store_new()))


class FileStore(Store):
    """Store over a shared filesystem directory."""

    def __init__(self, path: str):
        super().__init__(
            check_handle(_lib.lib().tc_file_store_new(path.encode())))


class PrefixStore(Store):
    """Namespacing decorator over another store."""

    def __init__(self, base: Store, prefix: str):
        super().__init__(check_handle(_lib.lib().tc_prefix_store_new(
            base._handle, prefix.encode())))
        self._base = base  # keep the base handle alive


class TcpStoreServer:
    """Hosts the rendezvous key/value service (typically on rank 0)."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._handle = check_handle(
            _lib.lib().tc_tcp_store_server_new(host.encode(), port))
        self.port = _lib.lib().tc_tcp_store_server_port(self._handle)
        self._free = _lib.lib().tc_tcp_store_server_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)


class TcpStore(Store):
    """Client for a TcpStoreServer; retries while the server comes up."""

    def __init__(self, host: str, port: int):
        super().__init__(
            check_handle(_lib.lib().tc_tcp_store_new(host.encode(), port)))


class Device:
    """Transport endpoint: event-engine loop thread + shared listener, on
    `hostname` and `port` (0: any free port). The reference's security,
    interface and engine arguments (gloo_tpu/core.py:434) are not ported:
    no caller of the port sets them, so the device takes the core's
    defaults (plain TCP, TPUCOLL_ENGINE)."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, hostname: str = "127.0.0.1", port: int = 0):
        self._handle = check_handle(_lib.lib().tc_device_new(
            hostname.encode(), port, None, 0, None, 0, None, None))
        self._free = _lib.lib().tc_device_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)


class Work:
    """Handle for one async collective issued on an :class:`AsyncEngine`.

    The handle pins the buffers until completion. Errors surface typed at
    :meth:`wait` (TimeoutError, IoError, or Aborted when the engine shut
    down with the op queued or in flight). The collective runs in place,
    so after an error the tensor's contents are undefined from the moment
    the op was issued. For a CUDA tensor the op ran on a pinned buffer, and
    a successful wait() copies the result back to the card."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, engine: "AsyncEngine", handle: int, op: str,
                 tensors, result, staged=None):
        self._engine = engine
        self._handle = handle
        self.op = op
        self._tensors = tensors  # pin the buffers until completion
        #: The reduced tensor (the input itself: the op is in place).
        self.result = result
        # (device tensor, pinned buffer) for a CUDA input, else None.
        self._staged = staged
        self._free = _lib.lib().tc_work_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if not handle:
            return
        if _lib.lib().tc_work_status(handle) >= 2:  # done/error
            self._free(handle)
        else:
            # Still in flight: the lane thread may write our buffers, so
            # the engine keeps them until its lanes are joined.
            self._engine._park(handle, self._tensors)

    def wait(self):
        """Block until the op completes (the op's collective timeout
        bounds every blocking step); raises its typed error if it failed.
        Returns :attr:`result`."""
        check(_lib.lib().tc_work_wait(self._handle, 0))
        if self._staged is not None:
            tensor, host = self._staged
            self._staged = None
            _to_device(tensor, host)
            self._engine._context._pool.give(host, _record(tensor.device))
        return self.result

    def test(self) -> bool:
        """Non-blocking: True once the op finished (successfully or
        not). A failure still surfaces only at wait()."""
        status = _lib.lib().tc_work_status(self._handle)
        if status < 0:
            raise Error(_lib.last_error())
        return status >= 2


class AsyncEngine:
    """Async collective work queue over a pool of lanes.

    Each lane is a worker thread owning a privately tagged forked
    sub-context of the parent; submission i runs on lane i % lanes.
    Construction is a collective (it forks over the parent): every rank
    constructs concurrently with the same lane count, and issues its ops
    in the same order. Prefer :meth:`Context.async_engine`, which also
    shuts the engine down in the context's close()."""

    _handle = None
    _free = staticmethod(lambda handle: None)
    _parked = ()
    _work_free = staticmethod(lambda handle: None)

    def __init__(self, context: "Context", lanes: Optional[int] = None):
        if lanes is None:
            raw = os.environ.get("TPUCOLL_ASYNC_LANES", "2")
            try:
                lanes = int(raw)
                if lanes < 1:
                    raise ValueError(raw)
            except ValueError:
                raise Error(f"TPUCOLL_ASYNC_LANES: not a positive "
                            f"integer: {raw!r}") from None
        # (handle, tensors) of Works dropped while still in flight; their
        # buffers must outlive the lane threads.
        self._parked = []
        self._work_free = _lib.lib().tc_work_free
        self._handle = check_handle(
            _lib.lib().tc_async_new(context._handle, lanes, 0))
        self._context = context
        self.lanes = lanes
        self._free = _lib.lib().tc_async_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)
        self._release_parked()

    def _park(self, work_handle: int, tensors) -> None:
        self._parked.append((work_handle, tensors))

    def _release_parked(self) -> None:
        # Only safe once the lane threads are joined (shutdown/free).
        parked, self._parked = self._parked, []
        for handle, _ in parked:
            self._work_free(handle)

    def shutdown(self) -> None:
        """Fail queued work (Aborted), abort the in-flight op on every
        lane, join the lane threads. Idempotent."""
        if self._handle:
            check(_lib.lib().tc_async_shutdown(self._handle))
            self._release_parked()

    def allreduce_async(self, tensor: torch.Tensor, op="sum",
                        algorithm: str = "auto",
                        wire: Optional[str] = None) -> Work:
        """In-place async allreduce; returns a :class:`Work`. Same
        semantics as Context.allreduce. From issue until wait() returns,
        `tensor` must not be read or written. A CUDA tensor is copied to a
        pinned buffer here, before the op is issued, and back in wait()."""
        algorithm = Context._resolve_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("async allreduce does not support callable "
                        "reductions (lane threads cannot enter Python)")
        code = _dtype_code(tensor)
        staged = None
        buf = tensor
        if _staged(tensor):
            buf = self._context._pool.take(tensor.dtype, tensor.numel())
            _to_host(buf, tensor)
            _sync(tensor.device)
            staged = (tensor, buf)
        handle = check_handle(_lib.lib().tc_async_allreduce_inplace(
            self._handle, _ptr(buf), buf.numel(), code, ReduceOp.parse(op),
            Context._ALGORITHMS[algorithm], 0))
        return Work(self, handle, "allreduce", (tensor, buf), tensor, staged)


class Context:
    """A connected process group: the host plane's collectives over torch
    tensors.

    One Context per (process, group). All collective calls are blocking
    and must be entered by every rank with matching arguments; concurrent
    collectives on one context need distinct tags. The collectives reduce
    in place: if a call raises, the tensor's contents are undefined and
    the context is poisoned (rebuild it)."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, rank: int, size: int, timeout: float = 30.0):
        self.rank = rank
        self.size = size
        self._timeout = timeout
        self._handle = check_handle(_lib.lib().tc_context_new(rank, size))
        _lib.lib().tc_context_set_timeout(self._handle, int(timeout * 1000))
        self._store = None
        self._device = None
        self._engines = []
        self._pool = _PinnedPool()
        self._free = _lib.lib().tc_context_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)

    def connect_full_mesh(self, store: Store, device: Device) -> None:
        check(_lib.lib().tc_context_connect(self._handle, store._handle,
                                            device._handle))
        self._store = store
        self._device = device

    def fork(self, tag: int = 0xFFFFFF0) -> "Context":
        """A fresh, independently tagged context over this one's device,
        bootstrapped through this context's own collectives."""
        child = Context(self.rank, self.size, timeout=self._timeout)
        check(_lib.lib().tc_context_fork(child._handle, self._handle, tag))
        child._device = self._device
        return child

    @classmethod
    def _from_handle(cls, handle: int, timeout: float,
                     parent: Optional["Context"] = None,
                     store: Optional[Store] = None,
                     device: Optional[Device] = None) -> "Context":
        """Wrap a native context handle produced by a split (`parent` is
        pinned and its device shared) or by an elastic rebuild (`store`
        and `device` are kept alive); ownership transfers to the
        wrapper."""
        obj = cls.__new__(cls)
        obj.rank = int(_lib.lib().tc_context_rank(handle))
        obj.size = int(_lib.lib().tc_context_size(handle))
        obj._timeout = timeout
        obj._handle = handle
        obj._store = store
        obj._device = parent._device if parent is not None else device
        obj._engines = []
        obj._pool = _PinnedPool()
        obj._parent = parent
        obj._free = _lib.lib().tc_context_free
        return obj

    def set_host_id(self, host_id: str) -> None:
        """Override this context's host fingerprint for topology
        discovery; call it before connect_full_mesh. Ranks with equal
        fingerprints are co-hosted (docs/topology.md)."""
        check(_lib.lib().tc_context_set_host_id(self._handle,
                                                host_id.encode()))

    def topology(self) -> dict:
        """Host topology discovered at bootstrap: {"rank", "host_index",
        "local_rank", "local_size", "leader", "is_leader", "n_hosts",
        "non_flat", "hosts": [...]}."""
        return json.loads(_lib.copy_out(_lib.lib().tc_topology_json,
                                        self._handle))

    def group_tag(self) -> str:
        """Group-tag namespace: "" for a bootstrap context, split segments
        for subgroups."""
        return _lib.copy_out(_lib.lib().tc_context_group_tag,
                             self._handle).decode()

    def split(self, color: int, key: int = 0,
              tag: int = 0) -> Optional["Context"]:
        """MPI_Comm_split: ranks passing the same non-negative `color` form
        a subset Context ranked by (key, parent rank); a negative color
        opts out and returns None. A collective over the parent."""
        out = ctypes.c_void_p()
        check(_lib.lib().tc_split(self._handle, int(color), int(key), tag,
                                  ctypes.byref(out)))
        if not out.value:
            return None
        return Context._from_handle(out.value, self._timeout, self)

    def split_by_host(self, tag: int = 0) -> "Context":
        """split(color = host index, key = rank): the intra-host
        communicator."""
        out = ctypes.c_void_p()
        check(_lib.lib().tc_split_by_host(self._handle, tag,
                                          ctypes.byref(out)))
        return Context._from_handle(check_handle(out.value), self._timeout,
                                    self)

    def shm_stats(self) -> dict:
        """Shared-memory payload-plane stats: bytes moved through the
        same-host rings and how many pairs negotiated the plane."""
        tx, rx, pairs = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_int()
        _lib.lib().tc_context_shm_stats(self._handle, ctypes.byref(tx),
                                        ctypes.byref(rx), ctypes.byref(pairs))
        return {"tx_bytes": tx.value, "rx_bytes": rx.value,
                "active_pairs": pairs.value}

    def metrics(self) -> dict:
        """The context's metrics registry as a dict (gloo_tpu/core.py's
        Context.metrics: "rank", "size", "ops", "transport" keyed by peer
        rank, "watchdog": {"stalls", "last"}, "transport_failure", ...).
        The reference's "async" gauges of live engines are not ported."""
        snap = json.loads(_lib.copy_out(_lib.lib().tc_metrics_json,
                                        self._handle, 0))
        snap["transport"] = {int(k): v
                             for k, v in snap["transport"].items()}
        return snap

    def flightrec(self) -> dict:
        """The always-on flight recorder as a dict: {"rank", "size",
        "next_seq", "events": [{"seq", "cseq", "op", "fp", "state", ...}],
        ...}; cseq is the cross-rank collective sequence number (None for
        point-to-point ops) and fp the desync fingerprint."""
        return json.loads(_lib.copy_out(_lib.lib().tc_flightrec_json,
                                        self._handle))

    def flightrec_seq(self) -> int:
        """Ops recorded so far (the next op's sequence number)."""
        return int(_lib.lib().tc_flightrec_seq(self._handle))

    def close(self) -> None:
        """Close the context, shutting down its async engines first."""
        for ref in self._engines:
            engine = ref()
            if engine is not None:
                engine.shutdown()
        check(_lib.lib().tc_context_close(self._handle))

    def async_engine(self, lanes: Optional[int] = None) -> AsyncEngine:
        """An :class:`AsyncEngine` over this context; a collective call
        (default lanes: TPUCOLL_ASYNC_LANES, else 2). close() shuts it
        down."""
        engine = AsyncEngine(self, lanes=lanes)
        self._engines = [r for r in self._engines if r() is not None]
        self._engines.append(weakref.ref(engine))
        return engine

    def plan_cache_clear(self) -> None:
        """Drop every cached native plan (one per repeated collective:
        op, algorithm, dtype, tag, buffer pointer, bytes); safe whenever no
        collective is running on this context. The q8 wire's result on a
        reused plan differs
        from a fresh plan's (a fault of the C++ core, ROADMAP.md C.7), so
        a bitwise comparison of two q8 calls clears the cache before each
        on every rank."""
        _lib.lib().tc_plan_cache_clear(self._handle)

    # ---- collectives ----

    _HIER_ALGORITHMS = {"auto": 0, "hier": 1}
    _ALGORITHMS = {"auto": 0, "ring": 1, "halving_doubling": 2, "hd": 2,
                   "bcube": 3, "ring_bf16_wire": 4,
                   "recursive_doubling": 5, "rd": 5,
                   "hd_fold": 6, "hd_blocks": 7,
                   "ring_q8_wire": 8, "q8": 8,
                   "auto_lossy_wire": 9, "auto_lossy": 9,
                   "hier": 10,
                   "ring_q4_wire": 11, "q4": 11}
    _RS_ALGORITHMS = {"auto": 0, "ring": 1, "halving_doubling": 2,
                      "hd": 2, "direct": 3, "ring_q8_wire": 4, "q8": 4,
                      "hier": 5,
                      "ring_q4_wire": 6, "q4": 6}
    # wire= shorthand -> allreduce algorithm (float32 sum only).
    _WIRE_ALGORITHMS = {"q8": "ring_q8_wire", "q4": "ring_q4_wire",
                        "bf16": "ring_bf16_wire",
                        "lossy": "auto_lossy_wire"}

    @classmethod
    def _resolve_wire(cls, wire, algorithm):
        if wire is None:
            return algorithm
        mapped = cls._WIRE_ALGORITHMS.get(wire)
        if mapped is None:
            raise Error(f"wire= must be one of "
                        f"{sorted(cls._WIRE_ALGORITHMS)}, got {wire!r}")
        if (algorithm != "auto" and
                cls._ALGORITHMS.get(algorithm) != cls._ALGORITHMS[mapped]):
            raise Error(f"wire={wire!r} conflicts with "
                        f"algorithm={algorithm!r}")
        return mapped

    @classmethod
    def _resolve_rs_wire(cls, wire, algorithm):
        if wire is None:
            return algorithm
        if wire not in ("q8", "q4"):
            raise Error(f"reduce_scatter wire= supports only 'q8' or "
                        f"'q4', got {wire!r}")
        mapped = f"ring_{wire}_wire"
        if (algorithm != "auto" and
                cls._RS_ALGORITHMS.get(algorithm) !=
                cls._RS_ALGORITHMS[mapped]):
            raise Error(f"wire={wire!r} conflicts with "
                        f"algorithm={algorithm!r}")
        return mapped

    def _in_place(self, tensor: torch.Tensor, call) -> torch.Tensor:
        """Run call(host tensor) on `tensor`'s memory: the tensor itself on
        the CPU, a pinned copy of it for a CUDA tensor (copied back)."""
        if not _staged(tensor):
            call(tensor)
            return tensor
        host = self._pool.take(tensor.dtype, tensor.numel())
        _to_host(host, tensor)
        _sync(tensor.device)
        call(host)
        _to_device(tensor, host)
        self._pool.give(host, _record(tensor.device))
        return tensor

    def barrier(self, tag: int = 0, algorithm: str = "auto") -> None:
        check(_lib.lib().tc_barrier(self._handle,
                                    self._HIER_ALGORITHMS[algorithm], tag,
                                    0))

    def broadcast(self, tensor: torch.Tensor, root: int = 0, tag: int = 0,
                  algorithm: str = "auto") -> torch.Tensor:
        """In-place broadcast of root's `tensor`."""
        _check_tensor(tensor)
        code = _dtype_code(tensor)
        return self._in_place(tensor, lambda t: check(
            _lib.lib().tc_broadcast(self._handle, _ptr(t), t.numel(), code,
                                    root, self._HIER_ALGORITHMS[algorithm],
                                    tag, 0)))

    def allreduce(self, tensor: torch.Tensor, op="sum",
                  algorithm: str = "auto", tag: int = 0,
                  wire: Optional[str] = None) -> torch.Tensor:
        """In-place allreduce of `tensor` across the group.

        algorithm and wire are the reference's (gloo_tpu/core.py:1541):
        "auto", "ring", "hd", "rd", "hd_fold", "hd_blocks", "bcube",
        "ring_bf16_wire", "ring_q8_wire", "ring_q4_wire", "hier"; wire=
        "q8" / "q4" / "bf16" / "lossy" (float32 sum only). op is "sum",
        "prod", "min" or "max"; callable reductions are not ported."""
        algorithm = self._resolve_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("callable reductions are not supported by the "
                        "port's Context")
        code = _dtype_code(tensor)
        op_code = ReduceOp.parse(op)
        return self._in_place(tensor, lambda t: check(
            _lib.lib().tc_allreduce_inplace(
                self._handle, _ptr(t), t.numel(), code, op_code,
                self._ALGORITHMS[algorithm], tag, 0)))

    def allgather(self, tensor: torch.Tensor, tag: int = 0,
                  algorithm: str = "auto") -> torch.Tensor:
        """Allgather into a new (size, *shape) tensor on the input's
        device. algorithm="hier" composes intra-host allgather and a
        leader-only exchange on a non-flat topology."""
        _check_tensor(tensor)
        code = _dtype_code(tensor)
        shape = (self.size,) + tuple(tensor.shape)
        staged = _staged(tensor)
        if staged:
            src = self._pool.take(tensor.dtype, tensor.numel())
            _to_host(src, tensor)
            out = self._pool.take(tensor.dtype, self.size * tensor.numel())
            _sync(tensor.device)
        else:
            src = tensor
            out = torch.empty(shape, dtype=tensor.dtype)
        check(_lib.lib().tc_allgather(self._handle, _ptr(src), _ptr(out),
                                      tensor.numel(), code,
                                      self._HIER_ALGORITHMS[algorithm], tag,
                                      0))
        if not staged:
            return out
        result = torch.empty(shape, dtype=tensor.dtype, device=tensor.device)
        _to_device(result, out)
        event = _record(tensor.device)
        self._pool.give(src, None)
        self._pool.give(out, event)
        return result

    def reduce_scatter(self, tensor: torch.Tensor,
                       recv_counts: Optional[Sequence[int]] = None,
                       op="sum", algorithm: str = "auto", tag: int = 0,
                       wire: Optional[str] = None) -> torch.Tensor:
        """Reduce then scatter: this rank's block (recv_counts[rank]
        elements of the flattened sum, even blocks by default) as a new 1-d
        tensor on the input's device. algorithm: "auto", "ring", "hd",
        "direct", "ring_q8_wire", "ring_q4_wire" or "hier"; wire="q8" /
        "q4" (float32 sum only)."""
        algorithm = self._resolve_rs_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("callable reductions are not supported by the "
                        "port's Context")
        code = _dtype_code(tensor)
        recv_counts = _resolve_recv_counts(recv_counts, tensor.numel(),
                                           self.size)
        count = int(recv_counts[self.rank])
        staged = _staged(tensor)
        if staged:
            src = self._pool.take(tensor.dtype, tensor.numel())
            _to_host(src, tensor)
            out = self._pool.take(tensor.dtype, count)
            _sync(tensor.device)
        else:
            src = tensor
            out = torch.empty(count, dtype=tensor.dtype)
        check(_lib.lib().tc_reduce_scatter(
            self._handle, _ptr(src), _ptr(out), _counts_arg(recv_counts),
            code, ReduceOp.parse(op), self._RS_ALGORITHMS[algorithm], tag,
            0))
        if not staged:
            return out
        result = torch.empty(count, dtype=tensor.dtype, device=tensor.device)
        _to_device(result, out)
        event = _record(tensor.device)
        self._pool.give(src, None)
        self._pool.give(out, event)
        return result
