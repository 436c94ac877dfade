"""Host data plane over torch tensors: stores, devices, contexts, the
collectives of the C++ core, point-to-point buffers, persistent plans and
the wire codecs.

Counterpart of gloo_tpu/core.py's tensor-taking surface, with torch
tensors standing in for numpy arrays. A CPU tensor goes to the native call
in place, with no copy: its ``data_ptr()`` is the pointer. A CUDA tensor is
staged through pinned host memory, the role of the reference's host
workspace (``CudaHostPointer``, gloo/cuda_collectives_host.h): each CUDA
tensor a call reads is copied into a pinned buffer from the context's pool
(keyed by dtype and length, so the native plan cache sees a stable
pointer), the tensors' streams are synchronized, the native call runs on
the buffers, and a host-to-device copy brings each result back on the
input's device. A buffer that took such a copy goes back to the pool with
an event recorded after it, and is not handed out again before the event
has completed. There is no fallback: a result is never left on the CPU
for a CUDA input.

Every collective must be entered by every rank with matching arguments,
as in the reference; concurrent collectives on one context need distinct
tags. ``timeout=None`` takes the context's timeout.
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
    "CollectivePlan",
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
    "UnboundBuffer",
    "Work",
    "codec_pipeline",
    "codec_threads",
    "q4_block",
    "q4_decode",
    "q4_encode",
    "q4_wire_bytes",
    "q8_block",
    "q8_decode",
    "q8_encode",
    "q8_wire_bytes",
    "set_connect_debug_logger",
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


_REDUCE_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_size_t)


def _wrap_reduce_fn(fn, dtype: torch.dtype):
    """Wrap a Python accumulate callable as the C ReduceFn ABI.

    `fn(acc, inp)` receives two length-n CPU tensors of the collective's
    dtype, viewing the native buffers, and must write the combined result
    into `acc` in place. For a CUDA input these are views of the pinned
    buffers the call is staged through; the callable may run on a native
    thread and must not touch CUDA. The operation must be commutative and
    associative: the schedules apply it in rank-dependent orders.

    An exception raised inside `fn` cannot cross the C boundary
    mid-collective (the segment is left unreduced, and peers may receive
    it), so the first one is captured and re-raised to this caller after
    the collective returns: treat it as poisoning the result on all ranks.
    Returns (the CFUNCTYPE object, which the caller keeps alive for the
    whole call; its address; raise_pending, to call after the C call).
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    pending = []

    def view(ptr, n):
        if n == 0:
            return torch.empty(0, dtype=dtype)
        return torch.frombuffer(
            (ctypes.c_char * (n * itemsize)).from_address(ptr), dtype=dtype)

    def thunk(acc_ptr, in_ptr, n):
        try:
            fn(view(acc_ptr, int(n)), view(in_ptr, int(n)))
        except BaseException as e:  # noqa: BLE001 - must not cross C frame
            if not pending:
                pending.append(e)

    def raise_pending():
        if pending:
            raise Error(
                "custom reduction callable raised; the collective result "
                "is invalid on all ranks") from pending[0]

    cb = _REDUCE_CFUNC(thunk)
    return cb, ctypes.cast(cb, ctypes.c_void_p), raise_pending


def _reduced(op, dtype: torch.dtype, call) -> None:
    """Run the native reduction `call(op_arg, custom)`: op_arg is the
    ReduceOp code, or for a callable `op` the address of its C wrapper
    (custom True: the caller picks the *_fn entry point)."""
    if not callable(op):
        check(call(ReduceOp.parse(op), False))
        return
    cb, fnp, raise_pending = _wrap_reduce_fn(op, dtype)
    check(call(fnp, True))
    del cb  # alive until the native call has returned
    raise_pending()


def _dtype_code(t: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise Error(f"unsupported dtype: {_dtype_name(t.dtype)}")
    return code


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _check_tensor(t, name: str = "tensor") -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch tensor, got {type(t)}")
    if not t.is_contiguous():
        raise Error(f"{name} must be C-contiguous")
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counts_arg(counts: Sequence[int]):
    return (ctypes.c_size_t * len(counts))(*counts)


def _timeout_ms(timeout: Optional[float]) -> int:
    # 0 tells the native side to use the context default.
    return 0 if timeout is None else max(1, int(timeout * 1000))


def _resolve_output(output, like: torch.Tensor, count: int,
                    op_name: str) -> torch.Tensor:
    """A new 1-d result of `count` elements of `like`'s dtype on its
    device, or the caller's preallocated `output` once checked. A stable
    output is the plan-cache hot path: repeated calls replay a cached
    native plan."""
    if output is None:
        return torch.empty(count, dtype=like.dtype, device=like.device)
    out = _check_tensor(output, "output")
    if out.dtype != like.dtype or out.numel() != count:
        raise Error(f"{op_name} output must match dtype "
                    f"{_dtype_name(like.dtype)} and hold {count} elements")
    if out.device != like.device:
        raise Error(f"{op_name} output must be on the input's device "
                    f"({like.device}), not {out.device}")
    return out


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


def _check_counts(op_name: str, counts, size: int) -> list:
    """Per-rank counts as a list of one int per rank: typed errors where
    the reference asserts (an assert vanishes under python -O, and a short
    vector would be read past its end by the C layer)."""
    counts = [int(c) for c in counts]
    if len(counts) != size:
        raise Error(f"{op_name}: counts needs one entry per rank ({size}), "
                    f"got {len(counts)}")
    return counts


# ---- staging of CUDA tensors through pinned host memory ----
# The steps are module functions so that a test can stand them in on a
# machine without a card and see their order.

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


# What the native call does with a tensor: reads it, writes it, or both.
_IN, _OUT, _INOUT = 1, 2, 3


def _stage_in(pool: Optional[_PinnedPool], entries):
    """Host memory for each (tensor or None, mode) of `entries`: the
    tensor itself on the CPU, else a pinned buffer (from `pool`, or a new
    one when pool is None) that takes a copy of the tensor when the call
    reads it. The streams of the staged tensors are synchronized before
    this returns. Returns (hosts, staged): staged lists (tensor, host,
    mode) for :func:`_stage_out`."""
    hosts, staged = [], []
    for t, mode in entries:
        if t is None or not _staged(t):
            hosts.append(t)
            continue
        host = (pool.take(t.dtype, t.numel()) if pool is not None
                else _pinned_empty(t.numel(), t.dtype))
        if mode & _IN:
            _to_host(host, t)
        hosts.append(host)
        staged.append((t, host, mode))
    for device in {t.device for t, _, _ in staged}:
        _sync(device)
    return hosts, staged


def _stage_out(pool: Optional[_PinnedPool], staged) -> None:
    """Copy each staged buffer the call wrote back into its tensor; with
    a `pool`, record an event on each device after those copies and give
    the buffers back (a buffer no copy reads goes back with no event).
    Without one, the buffers are dropped: PyTorch's pinned allocator
    keeps a block until the copies that read it have completed."""
    devices = set()
    for t, host, mode in staged:
        if mode & _OUT:
            _to_device(t, host)
            devices.add(t.device)
    if pool is None:
        return
    events = {device: _record(device) for device in devices}
    for t, host, mode in staged:
        pool.give(host, events[t.device] if mode & _OUT else None)


def _on_host(pool: Optional[_PinnedPool], call, *entries):
    """call(*hosts) on host memory standing for each (tensor or None,
    mode) of `entries` (see :func:`_stage_in`); the tensors the call
    writes get its results. Returns call's result."""
    hosts, staged = _stage_in(pool, entries)
    result = call(*hosts)
    _stage_out(pool, staged)
    return result


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
    `hostname` and `port` (0: any free port).

    auth_key: a pre-shared key that turns on the mutual HMAC handshake on
    every connection (every rank passes the same). keyring: the per-rank
    tier instead, a string from derive_keyring(); a connection then
    authenticates with the pairwise key only its two ends hold. The two
    exclude each other. encrypt=True also encrypts the data plane with
    per-connection ChaCha20-Poly1305 keys from the handshake (needs
    auth_key or keyring; every rank agrees). iface binds by interface name
    (its first address overrides hostname). busy_poll=True spins instead of
    sleeping, in the loop thread and in blocking waits. engine picks the
    event engine, "epoll", "uring" or "auto" (default: TPUCOLL_ENGINE,
    else auto)."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, hostname: str = "127.0.0.1", port: int = 0,
                 auth_key: Optional[str] = None, encrypt: bool = False,
                 iface: Optional[str] = None, busy_poll: bool = False,
                 engine: Optional[str] = None,
                 keyring: Optional[str] = None):
        if encrypt and not (auth_key or keyring):
            raise ValueError("encrypt=True requires auth_key or keyring")
        if auth_key and keyring:
            raise ValueError("auth_key and keyring are mutually exclusive")
        self._handle = check_handle(_lib.lib().tc_device_new(
            hostname.encode(), port,
            auth_key.encode() if auth_key else None, 1 if encrypt else 0,
            iface.encode() if iface else None, 1 if busy_poll else 0,
            engine.encode() if engine else None,
            keyring.encode() if keyring else None))
        self._free = _lib.lib().tc_device_free

    def engine_stats(self) -> dict:
        """Event-engine submission counters since the device was made:
        {"enters": io_uring_enter calls, "sqes": ops submitted, "cqes":
        completions drained}; zeros on the epoll engine."""
        enters, sqes, cqes = (ctypes.c_uint64(), ctypes.c_uint64(),
                              ctypes.c_uint64())
        _lib.lib().tc_device_engine_stats(
            self._handle, ctypes.byref(enters), ctypes.byref(sqes),
            ctypes.byref(cqes))
        return {"enters": enters.value, "sqes": sqes.value,
                "cqes": cqes.value}

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)


def q8_block() -> int:
    """Resolved TPUCOLL_Q8_BLOCK: elements per q8 wire block (default
    256). Must match on every rank."""
    block = int(_lib.lib().tc_q8_block())
    if block == 0:
        raise Error(_lib.last_error())
    return block


def q8_wire_bytes(count: int) -> int:
    """Wire bytes a `count`-element float32 stream occupies in the q8
    codec: one float32 scale per block plus one int8 code per element."""
    nbytes = int(_lib.lib().tc_q8_wire_bytes(count))
    if nbytes == 0 and count > 0:
        # 0 is the C boundary's error sentinel (malformed TPUCOLL_Q8_BLOCK).
        raise Error(_lib.last_error())
    return nbytes


def q4_block() -> int:
    """Resolved TPUCOLL_Q4_BLOCK: elements per q4 wire block (default
    256). Must match on every rank."""
    block = int(_lib.lib().tc_q4_block())
    if block == 0:
        raise Error(_lib.last_error())
    return block


def q4_wire_bytes(count: int) -> int:
    """Wire bytes a `count`-element float32 stream occupies in the q4
    codec: one float32 scale per block plus one packed-nibble byte per
    element pair."""
    nbytes = int(_lib.lib().tc_q4_wire_bytes(count))
    if nbytes == 0 and count > 0:
        raise Error(_lib.last_error())
    return nbytes


def _encode(codec: str, wire_bytes, tensor: torch.Tensor) -> torch.Tensor:
    _check_tensor(tensor)
    if tensor.dtype != torch.float32:
        raise Error(f"{codec}_encode requires a float32 array")
    out = torch.empty(wire_bytes(tensor.numel()), dtype=torch.uint8,
                      device=tensor.device)
    native = getattr(_lib.lib(), f"tc_{codec}_encode")
    _on_host(None, lambda src, dst: check(native(
        _ptr(src), src.numel(), _ptr(dst), dst.numel())),
        (tensor, _IN), (out, _OUT))
    return out


def _decode(codec: str, wire: torch.Tensor, count: int) -> torch.Tensor:
    _check_tensor(wire, "wire")
    if wire.dtype != torch.uint8:
        raise Error(f"{codec}_decode requires a uint8 wire array")
    out = torch.empty(count, dtype=torch.float32, device=wire.device)
    native = getattr(_lib.lib(), f"tc_{codec}_decode")
    _on_host(None, lambda src, dst: check(native(
        _ptr(src), src.numel(), _ptr(dst), count)),
        (wire, _IN), (out, _OUT))
    return out


def q8_encode(tensor: torch.Tensor) -> torch.Tensor:
    """Encode a float32 tensor into its q8 wire stream (a uint8 tensor on
    the input's device): the per-hop codec of ring_q8_wire."""
    return _encode("q8", q8_wire_bytes, tensor)


def q8_decode(wire: torch.Tensor, count: int) -> torch.Tensor:
    """Decode a q8 wire stream (uint8, from q8_encode) back to `count`
    float32 elements on the wire's device."""
    return _decode("q8", wire, count)


def q4_encode(tensor: torch.Tensor) -> torch.Tensor:
    """Encode a float32 tensor into its q4 wire stream (a uint8 tensor on
    the input's device): the per-hop codec of ring_q4_wire. Round-trip
    error is bounded by max|block| / 14 per block."""
    return _encode("q4", q4_wire_bytes, tensor)


def q4_decode(wire: torch.Tensor, count: int) -> torch.Tensor:
    """Decode a q4 wire stream (uint8, from q4_encode) back to `count`
    float32 elements on the wire's device."""
    return _decode("q4", wire, count)


def codec_threads() -> int:
    """Resolved TPUCOLL_CODEC_THREADS: the codec pool width the wire rings
    shard encode and dequant-accumulate across. Sharding is byte-identical
    to serial."""
    n = int(_lib.lib().tc_codec_threads())
    if n == 0:
        raise Error(_lib.last_error())
    return n


def codec_pipeline() -> int:
    """Resolved TPUCOLL_CODEC_PIPELINE: the sub-blocks each wire-ring hop
    is split into. Must match on every rank."""
    n = int(_lib.lib().tc_codec_pipeline())
    if n == 0:
        raise Error(_lib.last_error())
    return n


def uring_available() -> bool:
    """True when the io_uring event engine can run here (kernel and
    sandbox); Device(engine="uring") raises when it cannot."""
    return bool(_lib.lib().tc_uring_available())


def derive_keyring(root_key: str, rank: int, size: int) -> str:
    """Rank `rank`'s keyring of pairwise keys, derived from a root secret
    the launcher keeps: hand only the returned string to that worker
    (Device(keyring=...)), so a leaked keyring impersonates one rank, not
    the mesh."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    check(_lib.lib().tc_derive_keyring(root_key.encode(), rank, size,
                                       ctypes.byref(out)))
    s = ctypes.cast(out, ctypes.c_char_p).value.decode()
    _lib.lib().tc_buf_free(out)
    return s


def crypto_isa_tier() -> int:
    """The AEAD bulk tier this process dispatches to: 2 fused AVX-512, 1
    AVX2 8-block, 0 scalar. Every tier is wire-compatible."""
    return int(_lib.lib().tc_crypto_isa_tier())


_CONNECT_LOGGER_CFUNC = ctypes.CFUNCTYPE(
    None, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p)
# Every callback stays alive for the process's life: a connect in flight
# on the loop thread may hold the one a later call replaced, and a
# collected callback is a call into freed memory.
_connect_logger_keepalive = []


def set_connect_debug_logger(fn) -> None:
    """Register a process-wide hook that receives a dict per outbound
    connection attempt: {self_rank, peer_rank, remote, local, attempt, ok,
    will_retry, error}. It runs on the connecting threads; keep it cheap.
    None clears it. The hook is the port's library's own: a process that
    also loads another build of the core has a hook per build."""
    if fn is None:
        _lib.lib().tc_set_connect_debug_logger(None)
        return

    def thunk(self_rank, peer_rank, remote, local, attempt, ok, will_retry,
              error):
        try:
            fn({"self_rank": self_rank, "peer_rank": peer_rank,
                "remote": (remote or b"").decode(),
                "local": (local or b"").decode(), "attempt": attempt,
                "ok": bool(ok), "will_retry": bool(will_retry),
                "error": (error or b"").decode()})
        except Exception:  # noqa: BLE001 - must not cross the C frame
            pass

    cb = _CONNECT_LOGGER_CFUNC(thunk)
    _connect_logger_keepalive.append(cb)
    _lib.lib().tc_set_connect_debug_logger(ctypes.cast(cb, ctypes.c_void_p))


class UnboundBuffer:
    """Registered region of a CPU tensor for tagged point-to-point send and
    recv and one-sided put and get.

    A registration holds the tensor's host pointer for its whole life, and
    any peer may write it at any time (put, get, recv), so a CUDA tensor
    has no single moment at which it could be copied back: it raises.
    Peer-mapped registration of device memory is ROADMAP.md A.7.
    :meth:`Context.send` and :meth:`Context.recv`, one call each, do stage
    CUDA tensors."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, context: "Context", tensor: torch.Tensor):
        _check_tensor(tensor)
        if _staged(tensor):
            raise Error(
                f"register: a tensor on {tensor.device} cannot be "
                f"registered: peers write a registration at any time, so "
                f"it must be host memory (pass a CPU tensor; peer-mapped "
                f"device registration is ROADMAP.md A.7)")
        self._tensor = tensor  # pin the memory
        self._nbytes = _nbytes(tensor)
        self._context = context
        self._handle = check_handle(_lib.lib().tc_buffer_new(
            context._handle, _ptr(tensor), self._nbytes))
        self._free = _lib.lib().tc_buffer_free

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._free(handle)

    def send(self, dst: int, slot: int, offset: int = 0,
             nbytes: Optional[int] = None) -> None:
        if nbytes is None:
            nbytes = self._nbytes - offset
        check(_lib.lib().tc_buffer_send(self._handle, dst, slot, offset,
                                        nbytes))

    def recv(self, src, slot: int, offset: int = 0,
             nbytes: Optional[int] = None) -> None:
        """Post a receive from rank `src`, or from any rank of the list
        `src`."""
        if nbytes is None:
            nbytes = self._nbytes - offset
        if isinstance(src, int):
            check(_lib.lib().tc_buffer_recv(self._handle, src, slot, offset,
                                            nbytes))
        else:
            srcs = (ctypes.c_int * len(src))(*src)
            check(_lib.lib().tc_buffer_recv_any(self._handle, srcs, len(src),
                                                slot, offset, nbytes))

    def _wait(self, fn, timeout, with_src: bool):
        src = ctypes.c_int(-1)
        args = (ctypes.byref(src),) if with_src else ()
        code = fn(self._handle, self._context._resolve_timeout_ms(timeout),
                  *args)
        if code == _lib.TC_ERR_ABORTED:
            return None
        check(code)
        return src.value if with_src else True

    def wait_send(self, timeout: Optional[float] = None) -> bool:
        """True once the send (or put) completed; False if aborted."""
        return bool(self._wait(_lib.lib().tc_buffer_wait_send, timeout,
                               False))

    def wait_recv(self, timeout: Optional[float] = None) -> Optional[int]:
        """Returns the source rank, or None if the wait was aborted."""
        return self._wait(_lib.lib().tc_buffer_wait_recv, timeout, True)

    def wait_put(self, timeout: Optional[float] = None) -> Optional[int]:
        """Wait for one notify-put arrival into this buffer's exported
        region; returns the source rank, or None if aborted. A queue apart
        from wait_recv's: one-sided arrivals never satisfy a posted recv."""
        return self._wait(_lib.lib().tc_buffer_wait_put, timeout, True)

    def abort_wait_send(self) -> None:
        _lib.lib().tc_buffer_abort_wait_send(self._handle)

    def abort_wait_recv(self) -> None:
        _lib.lib().tc_buffer_abort_wait_recv(self._handle)

    def get_remote_key(self) -> bytes:
        """Export this buffer as a one-sided target: bytes to hand to peers
        (typically allgathered), which put()/get() against them with no
        posted operation on this side. Valid as long as this buffer."""
        n = _lib.lib().tc_remote_key_size()
        out = ctypes.create_string_buffer(n)
        check(_lib.lib().tc_buffer_remote_key(self._handle, out, n))
        return out.raw

    def put(self, remote_key: bytes, offset: int = 0, roffset: int = 0,
            nbytes: Optional[int] = None, notify: bool = False) -> None:
        """One-sided write of local [offset, offset + nbytes) into the
        remote region at roffset; completion via wait_send. notify=True
        also completes a wait_put on the exporting buffer when the payload
        lands. Bounds are checked against the key before anything moves."""
        if nbytes is None:
            nbytes = self._nbytes - offset
        check(_lib.lib().tc_buffer_put(self._handle, remote_key,
                                       len(remote_key), offset, roffset,
                                       nbytes, 1 if notify else 0))

    def get(self, remote_key: bytes, slot: int, offset: int = 0,
            roffset: int = 0, nbytes: Optional[int] = None) -> None:
        """One-sided read of the remote region [roffset, roffset + nbytes)
        into local [offset, ...); completion via wait_recv. `slot` must not
        carry other traffic with that peer."""
        if nbytes is None:
            nbytes = self._nbytes - offset
        check(_lib.lib().tc_buffer_get(self._handle, remote_key,
                                       len(remote_key), slot, offset,
                                       roffset, nbytes))


class Work:
    """Handle for one async collective issued on an :class:`AsyncEngine`.

    The handle pins the buffers until completion. Errors surface typed at
    :meth:`wait` (TimeoutError, IoError, or Aborted when the engine shut
    down with the op queued or in flight). After an error the buffers'
    contents are undefined from the moment the op was issued. For a CUDA
    tensor the op ran on pinned buffers, and a successful wait() copies
    the result back to the card."""

    _handle = None
    _free = staticmethod(lambda handle: None)

    def __init__(self, engine: "AsyncEngine", handle: int, op: str,
                 tensors, result, staged=()):
        self._engine = engine
        self._handle = handle
        self.op = op
        self._tensors = tensors  # pin the buffers until completion
        #: The result: the input itself for allreduce, the output tensor
        #: for allgather and reduce_scatter.
        self.result = result
        # (tensor, pinned buffer, mode) of each CUDA tensor of the op.
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

    def wait(self, timeout: Optional[float] = None):
        """Block until the op completes; raises its typed error if it
        failed. timeout=None sets no deadline of the wait's own (the op's
        collective timeout still bounds every blocking step); a wait that
        times out raises TimeoutError and does not cancel the op. Returns
        :attr:`result`."""
        ms = 0 if timeout is None else max(1, int(timeout * 1000))
        check(_lib.lib().tc_work_wait(self._handle, ms))
        staged, self._staged = self._staged, ()
        _stage_out(self._engine._context._pool, staged)
        return self.result

    def test(self) -> bool:
        """Non-blocking: True once the op finished (successfully or
        not). A failure still surfaces only at wait()."""
        status = _lib.lib().tc_work_status(self._handle)
        if status < 0:
            raise Error(_lib.last_error())
        return status >= 2

    def error(self) -> Optional[str]:
        """Error message of a failed op, or None (pending or succeeded)."""
        msg = _lib.copy_out(_lib.lib().tc_work_error_message,
                            self._handle).decode()
        return msg or None


class AsyncEngine:
    """Async collective work queue over a pool of lanes.

    Each lane is a worker thread owning a privately tagged forked
    sub-context of the parent (tags from `tag_base`); submission i runs on
    lane i % lanes. Construction is a collective (it forks over the
    parent): every rank constructs concurrently with the same lane count,
    and issues its ops in the same order. Prefer
    :meth:`Context.async_engine`, which also shuts the engine down in the
    context's close(). Callable reductions are refused: lane threads
    cannot enter Python."""

    _handle = None
    _free = staticmethod(lambda handle: None)
    _parked = ()
    _work_free = staticmethod(lambda handle: None)

    def __init__(self, context: "Context", lanes: Optional[int] = None,
                 tag_base: int = 0):
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
            _lib.lib().tc_async_new(context._handle, lanes, tag_base))
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def _issue(self, op: str, call, result, *entries) -> Work:
        """Issue call(*hosts) (see :func:`_stage_in`): CUDA tensors are
        copied to pinned buffers here, before the op is issued, and back
        in Work.wait()."""
        hosts, staged = _stage_in(self._context._pool, entries)
        handle = check_handle(call(*hosts))
        tensors = tuple(t for t, _ in entries) + tuple(hosts)
        return Work(self, handle, op, tensors, result, staged)

    @staticmethod
    def _refuse_callable(op, name: str) -> None:
        if callable(op):
            raise Error(f"async {name} does not support callable "
                        f"reductions (lane threads cannot enter Python)")

    def allreduce_async(self, tensor: torch.Tensor, op="sum",
                        algorithm: str = "auto",
                        timeout: Optional[float] = None,
                        wire: Optional[str] = None) -> Work:
        """In-place async allreduce; returns a :class:`Work`. Same
        semantics as Context.allreduce. From issue until wait() returns,
        `tensor` must not be read or written."""
        algorithm = Context._resolve_wire(wire, algorithm)
        _check_tensor(tensor)
        self._refuse_callable(op, "allreduce")
        code, op_code = _dtype_code(tensor), ReduceOp.parse(op)
        return self._issue("allreduce", lambda t: _lib.lib()
                           .tc_async_allreduce_inplace(
                               self._handle, _ptr(t), t.numel(), code,
                               op_code, Context._ALGORITHMS[algorithm],
                               _timeout_ms(timeout)),
                           tensor, (tensor, _INOUT))

    def reduce_scatter_async(self, tensor: torch.Tensor,
                             recv_counts: Optional[Sequence[int]] = None,
                             op="sum", algorithm: str = "auto",
                             timeout: Optional[float] = None,
                             wire: Optional[str] = None,
                             output: Optional[torch.Tensor] = None) -> Work:
        """Async reduce_scatter; this rank's block is ``work.result`` (the
        preallocated `output` when given, recv_counts[rank] elements)."""
        algorithm = Context._resolve_rs_wire(wire, algorithm)
        _check_tensor(tensor)
        self._refuse_callable(op, "reduce_scatter")
        size, rank = self._context.size, self._context.rank
        recv_counts = _resolve_recv_counts(recv_counts, tensor.numel(), size)
        out = _resolve_output(output, tensor, int(recv_counts[rank]),
                              "reduce_scatter")
        counts = _counts_arg(recv_counts)
        code, op_code = _dtype_code(tensor), ReduceOp.parse(op)
        work = self._issue("reduce_scatter", lambda t, o: _lib.lib()
                           .tc_async_reduce_scatter(
                               self._handle, _ptr(t), _ptr(o), counts, size,
                               code, op_code,
                               Context._RS_ALGORITHMS[algorithm],
                               _timeout_ms(timeout)),
                           out, (tensor, _IN), (out, _OUT))
        work._tensors += (counts,)
        return work

    def allgather_async(self, tensor: torch.Tensor,
                        timeout: Optional[float] = None,
                        output: Optional[torch.Tensor] = None,
                        algorithm: str = "auto") -> Work:
        """Async allgather; the (size, *shape) result is ``work.result``
        (the preallocated `output` when given, size * numel elements)."""
        _check_tensor(tensor)
        size = self._context.size
        out = _resolve_output(output, tensor, size * tensor.numel(),
                              "allgather")
        if output is None:
            out = out.view((size,) + tuple(tensor.shape))
        code = _dtype_code(tensor)
        return self._issue("allgather", lambda t, o: _lib.lib()
                           .tc_async_allgather(
                               self._handle, _ptr(t), _ptr(o), t.numel(),
                               code, Context._HIER_ALGORITHMS[algorithm],
                               _timeout_ms(timeout)),
                           out, (tensor, _IN), (out, _OUT))

    def stats(self) -> dict:
        """Engine counters: {"lanes", "in_flight", "submitted",
        "completed", "errors", "per_lane": [{"submitted", "completed",
        "errors", "queue_depth", "poisoned"}, ...]}."""
        return json.loads(_lib.copy_out(_lib.lib().tc_async_stats_json,
                                        self._handle))

    def _lane_handle(self, lane: int) -> int:
        return check_handle(
            _lib.lib().tc_async_lane_context(self._handle, lane))

    def lane_metrics(self, lane: int, drain: bool = False) -> dict:
        """Context.metrics() of lane `lane`'s forked sub-context, where
        the async ops are recorded."""
        snap = json.loads(_lib.copy_out(_lib.lib().tc_metrics_json,
                                        self._lane_handle(lane),
                                        1 if drain else 0))
        snap["transport"] = {int(k): v
                             for k, v in snap["transport"].items()}
        return snap

    def lane_profile(self, lane: int) -> dict:
        """Context.profile() of lane `lane`'s sub-context. Lane k's cseq
        axis is comparable across ranks per lane: merge lane k with the
        peers' lane k, never across lanes."""
        return json.loads(_lib.copy_out(_lib.lib().tc_profile_json,
                                        self._lane_handle(lane)))

    def lane_flightrec(self, lane: int) -> dict:
        """Context.flightrec() of lane `lane`'s sub-context; merge per
        lane, never across lanes."""
        return json.loads(_lib.copy_out(_lib.lib().tc_flightrec_json,
                                        self._lane_handle(lane)))

    def flightrec_dump(self, directory: str) -> dict:
        """Dump every lane's flight recorder under `directory`, one
        subdirectory per lane (``<directory>/lane<k>/flightrec-rank<r>
        .json``) for utils.flightrec.merge() to read lane by lane.
        Returns {lane: path}."""
        paths = {}
        for lane in range(self.lanes):
            lane_dir = os.path.join(directory, f"lane{lane}")
            os.makedirs(lane_dir, exist_ok=True)
            path = os.path.join(
                lane_dir, f"flightrec-rank{self._context.rank}.json")
            check(_lib.lib().tc_flightrec_dump(self._lane_handle(lane),
                                               path.encode()))
            paths[lane] = path
        return paths


class CollectivePlan:
    """Persistent handle for one repeated collective: validation and the
    ctypes arguments are made once, and each ``plan()`` is one foreign call
    whose stable pointers hit the native plan cache.

    Built by :meth:`Context.allreduce_plan`,
    :meth:`Context.reduce_scatter_plan` and :meth:`Context.allgather_plan`.
    The plan pins its tensors; the
    collective runs on them every call (``result`` is the output). For a
    CUDA tensor the plan owns a pinned mirror for its whole life, since the
    marshalled pointers must stay: each replay copies the inputs to their
    mirrors, synchronizes, calls, and copies the outputs back to the card.
    Every rank must call matching plans in matching order, and on error the
    buffers' contents are undefined."""

    __slots__ = ("_context", "_fn", "_args", "_tensors", "_staged",
                 "result")

    def __init__(self, context, fn, make_args, result, *entries):
        # Pin the owning Context: the marshalled args embed its native
        # handle.
        self._context = context
        self._fn = fn
        hosts, self._staged = [], []
        for t, mode in entries:
            host = t
            if _staged(t):
                host = _pinned_empty(t.numel(), t.dtype)
                self._staged.append((t, host, mode))
            hosts.append(host)
        self._args = make_args(*hosts)
        self._tensors = (tuple(t for t, _ in entries) + tuple(hosts)
                         + self._args)
        self.result = result

    def __call__(self):
        for t, host, mode in self._staged:
            if mode & _IN:
                _to_host(host, t)
        for device in {t.device for t, _, _ in self._staged}:
            _sync(device)
        check(self._fn(*self._args))
        for t, host, mode in self._staged:
            if mode & _OUT:
                _to_device(t, host)
        return self.result


class Context:
    """A connected process group: the host plane's collectives and
    point-to-point messaging over torch tensors.

    One Context per (process, group). All collective calls are blocking
    and must be entered by every rank with matching arguments; concurrent
    collectives on one context need distinct tags. The collectives work in
    place: if a call raises, the contents of the tensors it writes are
    undefined and the context is poisoned (rebuild it)."""

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

    def _resolve_timeout_ms(self, timeout: Optional[float]) -> int:
        return _timeout_ms(self._timeout if timeout is None else timeout)

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

    def next_slot(self, num: int = 1) -> int:
        """Reserve `num` consecutive point-to-point slots; returns the
        first. Every rank draws the same sequence."""
        return _lib.lib().tc_next_slot(self._handle, num)

    def shm_stats(self) -> dict:
        """Shared-memory payload-plane stats: bytes moved through the
        same-host rings and how many pairs negotiated the plane."""
        tx, rx, pairs = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_int()
        _lib.lib().tc_context_shm_stats(self._handle, ctypes.byref(tx),
                                        ctypes.byref(rx), ctypes.byref(pairs))
        return {"tx_bytes": tx.value, "rx_bytes": rx.value,
                "active_pairs": pairs.value}

    def metrics(self, drain: bool = False) -> dict:
        """The context's metrics registry as a dict (gloo_tpu/core.py's
        Context.metrics: "rank", "size", "ops", "phases", "faults",
        "anomalies", "plan_hits", "plan_misses", "transport" keyed by peer
        rank, "watchdog": {"stalls", "last"}, "transport_failure", ...).
        drain=True resets the counters after the snapshot. With a live
        async engine, "async" holds the engines' in-flight depth and
        stats()."""
        snap = json.loads(_lib.copy_out(_lib.lib().tc_metrics_json,
                                        self._handle, 1 if drain else 0))
        snap["transport"] = {int(k): v
                             for k, v in snap["transport"].items()}
        engines = [e() for e in self._engines]
        engines = [e for e in engines if e is not None and e._handle]
        if engines:
            snap["async"] = {
                "in_flight": sum(e.stats()["in_flight"] for e in engines),
                "engines": [e.stats() for e in engines],
            }
        return snap

    def metrics_enable(self, on: bool = True) -> None:
        """Toggle counter collection (on by default)."""
        _lib.lib().tc_metrics_enable(self._handle, 1 if on else 0)

    def metrics_enabled(self) -> bool:
        return bool(_lib.lib().tc_metrics_enabled(self._handle))

    def set_watchdog(self, threshold: Optional[float]) -> None:
        """Arm the straggler watchdog: a blocking wait that makes no
        progress for `threshold` seconds is logged and recorded in
        metrics()["watchdog"]. None or 0 disarms."""
        disarm = threshold is None or threshold <= 0
        _lib.lib().tc_metrics_set_watchdog(
            self._handle, 0 if disarm else max(1, int(threshold * 1000)))

    def flightrec(self) -> dict:
        """The always-on flight recorder as a dict: {"rank", "size",
        "next_seq", "events": [{"seq", "cseq", "op", "fp", "state", ...}],
        ...}; cseq is the cross-rank collective sequence number (None for
        point-to-point ops) and fp the desync fingerprint."""
        return json.loads(_lib.copy_out(_lib.lib().tc_flightrec_json,
                                        self._handle))

    def flightrec_dump(self, path: str) -> str:
        """Write the flight recorder to `path` as JSON; returns the
        path."""
        check(_lib.lib().tc_flightrec_dump(self._handle, path.encode()))
        return path

    def flightrec_seq(self) -> int:
        """Ops recorded so far (the next op's sequence number)."""
        return int(_lib.lib().tc_flightrec_seq(self._handle))

    def debug_dump(self) -> None:
        """Print the transport's state (posted receives, stash occupancy,
        backpressure flags) to stderr: the deadlock diagnosis."""
        _lib.lib().tc_debug_dump(self._handle)

    # ---- span tracer ----

    def trace_start(self) -> None:
        """Begin recording one span per collective on this context."""
        _lib.lib().tc_trace_start(self._handle)

    def trace_stop(self) -> None:
        _lib.lib().tc_trace_stop(self._handle)

    def trace_json(self) -> str:
        """Drain the recorded spans as Chrome trace-event JSON
        (utils.tracing.merge_traces joins the ranks')."""
        return _lib.copy_out(_lib.lib().tc_trace_json,
                             self._handle).decode()

    def trace_dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.trace_json())

    # ---- phase profiler ----

    def profile(self) -> dict:
        """The phase profiler's ring as a dict: {"rank", "size", "group",
        "enabled", "now_us", "next_seq", "capacity", "dropped", "ops":
        [{"seq", "cseq", "op", "algo", "bytes", "start_us", "total_us",
        "phases": {"pack"|"post"|"wire_wait"|"reduce"|"unpack"|"intra"|
        "inter"|"fanout": us}}, ...]}. The phases are those of the native
        call: the staging of a CUDA tensor through pinned memory lies
        outside them. utils.profile merges and attributes the ranks'."""
        return json.loads(_lib.copy_out(_lib.lib().tc_profile_json,
                                        self._handle))

    def profile_enable(self, on: bool = True) -> None:
        """Toggle the phase profiler (overrides TPUCOLL_PROFILE for this
        context)."""
        _lib.lib().tc_profile_enable(self._handle, 1 if on else 0)

    def profile_enabled(self) -> bool:
        return bool(_lib.lib().tc_profile_enabled(self._handle))

    # ---- causal span recorder ----

    def spans(self) -> dict:
        """The causal span recorder's ring as a dict: {"rank", "size",
        "group", "enabled", "now_us", "next_seq", "capacity", "dropped",
        "spans": [{"seq", "cseq", "id", "kind": "send"|"recv"|"wait"|
        "local", "phase", "peer", "slot", "bytes", "t0_us", "t1_us",
        "op"}, ...]}. utils.critpath merges the ranks' and finds the
        critical path. Off by default (TPUCOLL_SPANS)."""
        return json.loads(_lib.copy_out(_lib.lib().tc_spans_json,
                                        self._handle))

    def spans_enable(self, on: bool = True) -> None:
        """Toggle the causal span recorder (overrides TPUCOLL_SPANS for
        this context)."""
        _lib.lib().tc_spans_enable(self._handle, 1 if on else 0)

    def spans_enabled(self) -> bool:
        return bool(_lib.lib().tc_spans_enabled(self._handle))

    # ---- fleet observability plane ----

    def fleetobs_start(self) -> None:
        """Start the in-band telemetry fold: members report to their host
        leader over the transport, leaders relay one host document to rank
        0, which merges the fleet view (fleet()) and runs the anomaly
        detectors. Needs a connected context; a no-op under
        TPUCOLL_FLEETOBS=0 or when running."""
        check(_lib.lib().tc_fleetobs_start(self._handle))

    def fleetobs_stop(self) -> None:
        """Stop and join the aggregation thread (close() does too)."""
        check(_lib.lib().tc_fleetobs_stop(self._handle))

    def fleetobs_running(self) -> bool:
        return bool(_lib.lib().tc_fleetobs_running(self._handle))

    def fleetobs_set_aux(self, aux: dict) -> None:
        """Attach a JSON-serializable dict to this rank's next fleet report
        as its "aux" field. Raises if the plane was never started."""
        check(_lib.lib().tc_fleetobs_set_aux(
            self._handle, json.dumps(aux).encode()))

    def fleet(self) -> dict:
        """The merged fleet document on rank 0 with the plane running
        (coverage, host summaries with the ranks' reports, the straggler
        leaderboard, slow links, anomalies); elsewhere a stub whose
        "role" and "note" say where the view lives."""
        return json.loads(_lib.copy_out(_lib.lib().tc_fleet_json,
                                        self._handle))

    def close(self) -> None:
        """Close the context, shutting down its async engines first."""
        for ref in self._engines:
            engine = ref()
            if engine is not None:
                engine.shutdown()
        check(_lib.lib().tc_context_close(self._handle))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def async_engine(self, lanes: Optional[int] = None,
                     tag_base: int = 0) -> AsyncEngine:
        """An :class:`AsyncEngine` over this context; a collective call
        (default lanes: TPUCOLL_ASYNC_LANES, else 2). close() shuts it
        down."""
        engine = AsyncEngine(self, lanes=lanes, tag_base=tag_base)
        self._engines = [r for r in self._engines if r() is not None]
        self._engines.append(weakref.ref(engine))
        return engine

    def register(self, tensor: torch.Tensor) -> UnboundBuffer:
        """An :class:`UnboundBuffer` over a CPU tensor."""
        return UnboundBuffer(self, tensor)

    # ---- persistent collective plans ----

    def allreduce_plan(self, tensor: torch.Tensor, op="sum",
                       algorithm: str = "auto", tag: int = 0,
                       timeout: Optional[float] = None,
                       wire: Optional[str] = None) -> CollectivePlan:
        """A persistent in-place allreduce over `tensor` (the arguments of
        :meth:`allreduce`, callable reductions excluded); ``plan()``
        replays it."""
        algorithm = self._resolve_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("allreduce_plan does not support callable "
                        "reductions (build per-call instead)")
        code, op_code = _dtype_code(tensor), ReduceOp.parse(op)
        return CollectivePlan(
            self, _lib.lib().tc_allreduce_inplace,
            lambda t: (self._handle, _ptr(t), t.numel(), code, op_code,
                       self._ALGORITHMS[algorithm], tag,
                       _timeout_ms(timeout)),
            tensor, (tensor, _INOUT))

    def reduce_scatter_plan(self, tensor: torch.Tensor,
                            recv_counts: Optional[Sequence[int]] = None,
                            op="sum", algorithm: str = "auto",
                            tag: int = 0,
                            timeout: Optional[float] = None,
                            wire: Optional[str] = None,
                            output: Optional[torch.Tensor] = None
                            ) -> CollectivePlan:
        """A persistent reduce_scatter: ``plan()`` reduces `tensor` and
        writes this rank's block into ``plan.result`` (the preallocated
        `output` when given)."""
        algorithm = self._resolve_rs_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("reduce_scatter_plan does not support callable "
                        "reductions (build per-call instead)")
        recv_counts = _resolve_recv_counts(recv_counts, tensor.numel(),
                                           self.size)
        out = _resolve_output(output, tensor, int(recv_counts[self.rank]),
                              "reduce_scatter")
        counts = _counts_arg(recv_counts)  # pinned by the plan's args
        code, op_code = _dtype_code(tensor), ReduceOp.parse(op)
        return CollectivePlan(
            self, _lib.lib().tc_reduce_scatter,
            lambda t, o: (self._handle, _ptr(t), _ptr(o), counts, code,
                          op_code, self._RS_ALGORITHMS[algorithm], tag,
                          _timeout_ms(timeout)),
            out, (tensor, _IN), (out, _OUT))

    def allgather_plan(self, tensor: torch.Tensor, tag: int = 0,
                       timeout: Optional[float] = None,
                       output: Optional[torch.Tensor] = None
                       ) -> CollectivePlan:
        """A persistent allgather: ``plan()`` gathers `tensor` from every
        rank into ``plan.result`` ((size, *shape), or the preallocated
        `output`)."""
        _check_tensor(tensor)
        out = _resolve_output(output, tensor, self.size * tensor.numel(),
                              "allgather")
        if output is None:
            out = out.view((self.size,) + tuple(tensor.shape))
        code = _dtype_code(tensor)
        return CollectivePlan(
            self, _lib.lib().tc_allgather,
            lambda t, o: (self._handle, _ptr(t), _ptr(o), t.numel(), code,
                          self._HIER_ALGORITHMS["auto"], tag,
                          _timeout_ms(timeout)),
            out, (tensor, _IN), (out, _OUT))

    def plan_cache_size(self) -> int:
        """Entries in this context's native plan LRU (one per repeated
        collective: op, algorithm, dtype, tag, buffer pointers, bytes)."""
        return int(_lib.lib().tc_plan_cache_size(self._handle))

    def plan_cache_clear(self) -> None:
        """Drop every cached native plan; safe whenever no collective is
        running on this context. The q8 wire's result on a reused plan
        differs from a fresh plan's (a fault of the C++ core, ROADMAP.md
        C.7), so a bitwise comparison of two q8 calls clears the cache
        before each on every rank."""
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
    _REDUCE_ALGORITHMS = {"auto": 0, "binomial": 1, "ring": 2}
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

    def barrier(self, tag: int = 0, timeout: Optional[float] = None,
                algorithm: str = "auto") -> None:
        check(_lib.lib().tc_barrier(self._handle,
                                    self._HIER_ALGORITHMS[algorithm], tag,
                                    _timeout_ms(timeout)))

    def broadcast(self, tensor: torch.Tensor, root: int = 0, tag: int = 0,
                  timeout: Optional[float] = None,
                  algorithm: str = "auto") -> torch.Tensor:
        """In-place broadcast of root's `tensor`."""
        _check_tensor(tensor)
        code = _dtype_code(tensor)
        _on_host(self._pool, lambda t: check(_lib.lib().tc_broadcast(
            self._handle, _ptr(t), t.numel(), code, root,
            self._HIER_ALGORITHMS[algorithm], tag, _timeout_ms(timeout))),
            (tensor, _INOUT))
        return tensor

    def allreduce(self, tensor: torch.Tensor, op="sum",
                  algorithm: str = "auto", tag: int = 0,
                  timeout: Optional[float] = None,
                  wire: Optional[str] = None) -> torch.Tensor:
        """In-place allreduce of `tensor` across the group.

        algorithm and wire are the reference's (gloo_tpu/core.py:1529):
        "auto", "ring", "hd", "rd", "hd_fold", "hd_blocks", "bcube",
        "ring_bf16_wire", "ring_q8_wire", "ring_q4_wire", "hier"; wire=
        "q8" / "q4" / "bf16" / "lossy" (float32 sum only). op is "sum",
        "prod", "min", "max", or a callable `fn(acc, inp)` that combines
        two CPU tensors in place into acc (see :func:`_wrap_reduce_fn`)."""
        algorithm = self._resolve_wire(wire, algorithm)
        _check_tensor(tensor)
        code, algo = _dtype_code(tensor), self._ALGORITHMS[algorithm]
        ms = _timeout_ms(timeout)

        def native(t):
            lib = _lib.lib()
            _reduced(op, t.dtype, lambda o, custom: (
                lib.tc_allreduce_fn(self._handle, _ptr(t), _ptr(t),
                                    t.numel(), code, o, algo, tag, ms)
                if custom else
                lib.tc_allreduce_inplace(self._handle, _ptr(t), t.numel(),
                                         code, o, algo, tag, ms)))

        _on_host(self._pool, native, (tensor, _INOUT))
        return tensor

    def allreduce_multi(self, tensors, op="sum", algorithm: str = "auto",
                        tag: int = 0, timeout: Optional[float] = None,
                        wire: Optional[str] = None):
        """Allreduce N local tensors together (a local reduction first, one
        network pass, the result fanned out to every tensor), in place on
        all of them; returns the list."""
        algorithm = self._resolve_wire(wire, algorithm)
        tensors = [_check_tensor(t) for t in tensors]
        if not tensors:
            raise Error("allreduce_multi needs at least one array")
        first = tensors[0]
        if any(t.dtype != first.dtype or t.numel() != first.numel()
               for t in tensors):
            raise Error("allreduce_multi arrays must match in dtype and "
                        "size")
        code, algo = _dtype_code(first), self._ALGORITHMS[algorithm]
        ms = _timeout_ms(timeout)

        def native(*hosts):
            ptrs = (ctypes.c_void_p * len(hosts))(
                *[t.data_ptr() for t in hosts])
            lib = _lib.lib()
            _reduced(op, first.dtype, lambda o, custom: (
                lib.tc_allreduce_multi_fn if custom
                else lib.tc_allreduce_multi)(
                    self._handle, ptrs, ptrs, len(hosts), first.numel(),
                    code, o, algo, tag, ms))

        _on_host(self._pool, native, *[(t, _INOUT) for t in tensors])
        return tensors

    def reduce(self, tensor: torch.Tensor, root: int = 0, op="sum",
               output: Optional[torch.Tensor] = None,
               algorithm: str = "auto", tag: int = 0,
               timeout: Optional[float] = None) -> Optional[torch.Tensor]:
        """Reduce to `root`: the result (a new tensor of `tensor`'s shape
        on its device, or `output`) on root, None elsewhere. algorithm:
        "auto", "binomial" or "ring"."""
        _check_tensor(tensor)
        algo = self._REDUCE_ALGORITHMS[algorithm]
        out = None
        if self.rank == root:
            out = torch.empty_like(tensor) if output is None else \
                _resolve_output(output, tensor, tensor.numel(), "reduce")
        code, ms = _dtype_code(tensor), _timeout_ms(timeout)

        def native(t, o):
            lib = _lib.lib()
            _reduced(op, t.dtype, lambda op_arg, custom: (
                lib.tc_reduce_fn if custom else lib.tc_reduce)(
                    self._handle, _ptr(t), _ptr(o), t.numel(), code,
                    op_arg, root, algo, tag, ms))

        _on_host(self._pool, native, (tensor, _IN), (out, _OUT))
        return out

    def gather(self, tensor: torch.Tensor, root: int = 0, tag: int = 0,
               timeout: Optional[float] = None) -> Optional[torch.Tensor]:
        """Gather equal-size tensors to root; returns (size, *shape) on
        root, None elsewhere."""
        _check_tensor(tensor)
        out = None
        if self.rank == root:
            out = torch.empty((self.size,) + tuple(tensor.shape),
                              dtype=tensor.dtype, device=tensor.device)
        code = _dtype_code(tensor)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_gather(
            self._handle, _ptr(t), _ptr(o), t.numel(), code, root, tag,
            _timeout_ms(timeout))), (tensor, _IN), (out, _OUT))
        return out

    def gatherv(self, tensor: torch.Tensor, counts: Sequence[int],
                root: int = 0, tag: int = 0,
                timeout: Optional[float] = None) -> Optional[torch.Tensor]:
        """Gather counts[r] elements from each rank r to root; returns the
        1-d concatenation on root, None elsewhere."""
        _check_tensor(tensor)
        counts = _check_counts("gatherv", counts, self.size)
        if tensor.numel() != counts[self.rank]:
            raise Error("gatherv: input size != counts[rank]")
        out = None
        if self.rank == root:
            out = torch.empty(sum(counts), dtype=tensor.dtype,
                              device=tensor.device)
        code, counts_arg = _dtype_code(tensor), _counts_arg(counts)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_gatherv(
            self._handle, _ptr(t), _ptr(o), counts_arg, code, root, tag,
            _timeout_ms(timeout))), (tensor, _IN), (out, _OUT))
        return out

    def scatter(self, tensor: Optional[torch.Tensor], root: int = 0,
                output: Optional[torch.Tensor] = None, tag: int = 0,
                timeout: Optional[float] = None) -> torch.Tensor:
        """Scatter the rows of root's `tensor` (shape (size, ...)): each
        rank gets its row, in `output` or a new tensor on root's input
        device. Off root `tensor` may be None and `output` is needed."""
        if self.rank == root:
            _check_tensor(tensor)
            if tensor.shape[0] != self.size:
                raise Error("scatter input rows != size")
            chunk = output
            if output is None:
                chunk = torch.empty(tuple(tensor.shape[1:]),
                                    dtype=tensor.dtype, device=tensor.device)
        else:
            if output is None:
                raise Error("non-root scatter needs output array")
            chunk = output
            tensor = None
        _check_tensor(chunk, "output")
        code = _dtype_code(chunk)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_scatter(
            self._handle, _ptr(t), _ptr(o), o.numel(), code, root, tag,
            _timeout_ms(timeout))), (tensor, _IN), (chunk, _OUT))
        return chunk

    def allgather(self, tensor: torch.Tensor, tag: int = 0,
                  timeout: Optional[float] = None,
                  output: Optional[torch.Tensor] = None,
                  algorithm: str = "auto") -> torch.Tensor:
        """Allgather into a new (size, *shape) tensor on the input's
        device, or into `output` (size * numel elements of the input's
        dtype on its device: a stable pointer for the plan cache).
        algorithm="hier" composes intra-host allgather and a leader-only
        exchange on a non-flat topology."""
        _check_tensor(tensor)
        out = _resolve_output(output, tensor, self.size * tensor.numel(),
                              "allgather")
        if output is None:
            out = out.view((self.size,) + tuple(tensor.shape))
        code = _dtype_code(tensor)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_allgather(
            self._handle, _ptr(t), _ptr(o), t.numel(), code,
            self._HIER_ALGORITHMS[algorithm], tag, _timeout_ms(timeout))),
            (tensor, _IN), (out, _OUT))
        return out

    def allgatherv(self, tensor: torch.Tensor, counts: Sequence[int],
                   tag: int = 0,
                   timeout: Optional[float] = None) -> torch.Tensor:
        """Every rank gets the 1-d concatenation of counts[r] elements
        from each rank r."""
        _check_tensor(tensor)
        counts = _check_counts("allgatherv", counts, self.size)
        if tensor.numel() != counts[self.rank]:
            raise Error("allgatherv: input size != counts[rank]")
        out = torch.empty(sum(counts), dtype=tensor.dtype,
                          device=tensor.device)
        code, counts_arg = _dtype_code(tensor), _counts_arg(counts)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_allgatherv(
            self._handle, _ptr(t), _ptr(o), counts_arg, code, tag,
            _timeout_ms(timeout))), (tensor, _IN), (out, _OUT))
        return out

    def alltoall(self, tensor: torch.Tensor, tag: int = 0,
                 timeout: Optional[float] = None) -> torch.Tensor:
        """Row r of `tensor` (first axis: the group size) goes to rank r;
        returns a tensor of the same shape whose row r came from rank r."""
        _check_tensor(tensor)
        if tensor.shape[0] != self.size:
            raise Error("alltoall input rows != size")
        out = torch.empty_like(tensor)
        code = _dtype_code(tensor)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_alltoall(
            self._handle, _ptr(t), _ptr(o), t.numel() // self.size, code,
            tag, _timeout_ms(timeout))), (tensor, _IN), (out, _OUT))
        return out

    def alltoallv(self, tensor: torch.Tensor, in_counts: Sequence[int],
                  out_counts: Sequence[int], tag: int = 0,
                  timeout: Optional[float] = None) -> torch.Tensor:
        """in_counts[r] elements of `tensor` go to rank r, in rank order;
        returns the 1-d concatenation of out_counts[r] elements from each
        rank r."""
        _check_tensor(tensor)
        in_counts = _check_counts("alltoallv", in_counts, self.size)
        out_counts = _check_counts("alltoallv", out_counts, self.size)
        if tensor.numel() != sum(in_counts):
            raise Error("alltoallv: input size != sum(in_counts)")
        out = torch.empty(sum(out_counts), dtype=tensor.dtype,
                          device=tensor.device)
        code = _dtype_code(tensor)
        in_arg, out_arg = _counts_arg(in_counts), _counts_arg(out_counts)
        _on_host(self._pool, lambda t, o: check(_lib.lib().tc_alltoallv(
            self._handle, _ptr(t), in_arg, _ptr(o), out_arg, code, tag,
            _timeout_ms(timeout))), (tensor, _IN), (out, _OUT))
        return out

    def reduce_scatter(self, tensor: torch.Tensor,
                       recv_counts: Optional[Sequence[int]] = None,
                       op="sum", algorithm: str = "auto", tag: int = 0,
                       timeout: Optional[float] = None,
                       wire: Optional[str] = None,
                       output: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Reduce then scatter: this rank's block (recv_counts[rank]
        elements of the flattened reduction, even blocks by default) as a
        new 1-d tensor on the input's device, or in `output`. algorithm:
        "auto", "ring", "hd", "direct", "ring_q8_wire", "ring_q4_wire" or
        "hier"; wire="q8" / "q4" (float32 sum only); op may be a callable
        as for :meth:`allreduce`."""
        algorithm = self._resolve_rs_wire(wire, algorithm)
        _check_tensor(tensor)
        algo = self._RS_ALGORITHMS[algorithm]
        recv_counts = _resolve_recv_counts(recv_counts, tensor.numel(),
                                           self.size)
        out = _resolve_output(output, tensor, int(recv_counts[self.rank]),
                              "reduce_scatter")
        code, counts = _dtype_code(tensor), _counts_arg(recv_counts)
        ms = _timeout_ms(timeout)

        def native(t, o):
            lib = _lib.lib()
            _reduced(op, t.dtype, lambda op_arg, custom: (
                lib.tc_reduce_scatter_fn if custom
                else lib.tc_reduce_scatter)(
                    self._handle, _ptr(t), _ptr(o), counts, code, op_arg,
                    algo, tag, ms))

        _on_host(self._pool, native, (tensor, _IN), (out, _OUT))
        return out

    def reduce_scatter_inplace(self, tensor: torch.Tensor,
                               recv_counts: Optional[Sequence[int]] = None,
                               op="sum", algorithm: str = "auto",
                               tag: int = 0,
                               timeout: Optional[float] = None,
                               wire: Optional[str] = None) -> torch.Tensor:
        """reduce_scatter with no output: this rank's reduced block
        (recv_counts[rank] elements) lands at the front of `tensor`, and
        the returned value is ``tensor[:recv_counts[rank]]``. The rest of
        `tensor` is unspecified afterwards (for a CUDA tensor the whole
        staged buffer is copied back, so its bytes equal the CPU call's)."""
        algorithm = self._resolve_rs_wire(wire, algorithm)
        _check_tensor(tensor)
        if callable(op):
            raise Error("reduce_scatter_inplace does not support callable "
                        "reductions (use reduce_scatter)")
        recv_counts = _resolve_recv_counts(recv_counts, tensor.numel(),
                                           self.size)
        code, op_code = _dtype_code(tensor), ReduceOp.parse(op)
        counts = _counts_arg(recv_counts)
        _on_host(self._pool, lambda t: check(
            _lib.lib().tc_reduce_scatter_inplace(
                self._handle, _ptr(t), counts, code, op_code,
                self._RS_ALGORITHMS[algorithm], tag, _timeout_ms(timeout))),
            (tensor, _INOUT))
        return tensor[:int(recv_counts[self.rank])]

    # ---- blocking point-to-point ----

    def send(self, tensor: torch.Tensor, dst: int, slot: int,
             timeout: Optional[float] = None) -> None:
        """Send `tensor` to rank `dst` on `slot` and wait until it went. A
        CUDA tensor is copied to pinned memory (and synchronized) first."""
        _check_tensor(tensor)

        def native(t):
            buf = self.register(t)
            buf.send(dst, slot)
            buf.wait_send(timeout)

        _on_host(self._pool, native, (tensor, _IN))

    def recv(self, tensor: torch.Tensor, src, slot: int,
             timeout: Optional[float] = None) -> int:
        """Receive into `tensor` on `slot` from rank `src` or from any rank
        of the list `src`; returns the source rank. A CUDA tensor receives
        into pinned memory and takes a copy after the wait returns."""
        _check_tensor(tensor)

        def native(t):
            buf = self.register(t)
            buf.recv(src, slot)
            rank = buf.wait_recv(timeout)
            if rank is None:
                raise Aborted("recv: the wait was aborted")
            return rank

        return _on_host(self._pool, native, (tensor, _OUT))
