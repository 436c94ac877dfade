"""ctypes binding to the host library, the C core of csrc/tpucoll/capi.cc.

Counterpart of gloo_tpu/_lib.py: the same error classes and codes, and the
prototypes of the C functions that the port calls. The library is the
port's own build (``_build.build_host_library``), made and loaded at first
use; ``import gloo_tpu_torch`` neither builds nor loads it.
"""

from __future__ import annotations

import ctypes
import threading

from gloo_tpu_torch import _build


class Error(RuntimeError):
    """Base error from the tpucoll native core."""


class IoError(Error):
    """Transport failure: peer died, connection reset, context poisoned."""


class TimeoutError(IoError):  # noqa: A001 - mirrors the C++ hierarchy
    """A blocking wait exceeded its deadline."""


class Aborted(Exception):
    """A wait was cancelled (an async engine shut down with the op queued
    or in flight)."""


TC_OK = 0
TC_ERR = 1
TC_ERR_TIMEOUT = 2
TC_ERR_IO = 3
TC_ERR_ABORTED = 4

_c = ctypes.c_void_p
_sz = ctypes.c_size_t
_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_u32 = ctypes.c_uint32
_int = ctypes.c_int
_bytes_out = (ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
              ctypes.POINTER(_sz))

_PROTOTYPES = {
    "tc_last_error": (ctypes.c_char_p, []),
    "tc_buf_free": (None, [ctypes.POINTER(ctypes.c_uint8)]),
    # stores
    "tc_hash_store_new": (_c, []),
    "tc_file_store_new": (_c, [ctypes.c_char_p]),
    "tc_prefix_store_new": (_c, [_c, ctypes.c_char_p]),
    "tc_tcp_store_server_new": (_c, [ctypes.c_char_p, ctypes.c_uint16]),
    "tc_tcp_store_server_port": (ctypes.c_uint16, [_c]),
    "tc_tcp_store_server_free": (None, [_c]),
    "tc_tcp_store_new": (_c, [ctypes.c_char_p, ctypes.c_uint16]),
    "tc_store_free": (None, [_c]),
    "tc_store_set": (_int, [_c, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_uint8), _sz]),
    "tc_store_get": (_int, [_c, ctypes.c_char_p, _i64, *_bytes_out]),
    "tc_store_add": (_int, [_c, ctypes.c_char_p, _i64,
                            ctypes.POINTER(_i64)]),
    "tc_store_delete": (_int, [_c, ctypes.c_char_p, ctypes.POINTER(_int)]),
    "tc_store_list": (_int, [_c, ctypes.c_char_p, *_bytes_out]),
    "tc_device_new": (_c, [ctypes.c_char_p, ctypes.c_uint16,
                           ctypes.c_char_p, _int, ctypes.c_char_p, _int,
                           ctypes.c_char_p, ctypes.c_char_p]),
    "tc_device_free": (None, [_c]),
    "tc_device_engine_stats": (None, [_c, ctypes.POINTER(_u64),
                                      ctypes.POINTER(_u64),
                                      ctypes.POINTER(_u64)]),
    # security, engines and the connect debug hook
    "tc_derive_keyring": (_int, [ctypes.c_char_p, _int, _int,
                                 ctypes.POINTER(
                                     ctypes.POINTER(ctypes.c_uint8))]),
    "tc_uring_available": (_int, []),
    "tc_crypto_isa_tier": (_int, []),
    "tc_set_connect_debug_logger": (None, [_c]),
    "tc_context_new": (_c, [_int, _int]),
    "tc_context_set_timeout": (None, [_c, _i64]),
    "tc_context_connect": (_int, [_c, _c, _c]),
    "tc_context_fork": (_int, [_c, _c, _u32]),
    "tc_context_close": (_int, [_c]),
    "tc_context_free": (None, [_c]),
    "tc_context_rank": (_int, [_c]),
    "tc_context_size": (_int, [_c]),
    "tc_context_set_host_id": (_int, [_c, ctypes.c_char_p]),
    "tc_topology_json": (_int, [_c, *_bytes_out]),
    "tc_context_group_tag": (_int, [_c, *_bytes_out]),
    "tc_split": (_int, [_c, _int, _int, _u32, ctypes.POINTER(_c)]),
    "tc_split_by_host": (_int, [_c, _u32, ctypes.POINTER(_c)]),
    "tc_context_shm_stats": (None, [_c, ctypes.POINTER(_u64),
                                    ctypes.POINTER(_u64),
                                    ctypes.POINTER(_int)]),
    # collectives
    "tc_barrier": (_int, [_c, _int, _u32, _i64]),
    "tc_broadcast": (_int, [_c, _c, _sz, _int, _int, _int, _u32, _i64]),
    "tc_allreduce_inplace": (_int, [_c, _c, _sz, _int, _int, _int, _u32,
                                    _i64]),
    "tc_allgather": (_int, [_c, _c, _c, _sz, _int, _int, _u32, _i64]),
    "tc_reduce_scatter": (_int, [_c, _c, _c, ctypes.POINTER(_sz), _int,
                                 _int, _int, _u32, _i64]),
    "tc_reduce_scatter_inplace": (_int, [_c, _c, ctypes.POINTER(_sz),
                                         _int, _int, _int, _u32, _i64]),
    "tc_allreduce_multi": (_int, [_c, ctypes.POINTER(_c),
                                  ctypes.POINTER(_c), _sz, _sz, _int,
                                  _int, _int, _u32, _i64]),
    "tc_reduce": (_int, [_c, _c, _c, _sz, _int, _int, _int, _int, _u32,
                         _i64]),
    "tc_gather": (_int, [_c, _c, _c, _sz, _int, _int, _u32, _i64]),
    "tc_gatherv": (_int, [_c, _c, _c, ctypes.POINTER(_sz), _int, _int,
                          _u32, _i64]),
    "tc_scatter": (_int, [_c, _c, _c, _sz, _int, _int, _u32, _i64]),
    "tc_allgatherv": (_int, [_c, _c, _c, ctypes.POINTER(_sz), _int, _u32,
                             _i64]),
    "tc_alltoall": (_int, [_c, _c, _c, _sz, _int, _u32, _i64]),
    "tc_alltoallv": (_int, [_c, _c, ctypes.POINTER(_sz), _c,
                            ctypes.POINTER(_sz), _int, _u32, _i64]),
    # callable reductions: the _c before the algorithm is the C ReduceFn
    "tc_allreduce_fn": (_int, [_c, _c, _c, _sz, _int, _c, _int, _u32,
                               _i64]),
    "tc_allreduce_multi_fn": (_int, [_c, ctypes.POINTER(_c),
                                     ctypes.POINTER(_c), _sz, _sz, _int,
                                     _c, _int, _u32, _i64]),
    "tc_reduce_fn": (_int, [_c, _c, _c, _sz, _int, _c, _int, _int, _u32,
                            _i64]),
    "tc_reduce_scatter_fn": (_int, [_c, _c, _c, ctypes.POINTER(_sz), _int,
                                    _c, _int, _u32, _i64]),
    # persistent plans
    "tc_plan_cache_size": (_sz, [_c]),
    "tc_plan_cache_clear": (None, [_c]),
    # int8 and int4 block-quantized wire codecs
    "tc_q8_block": (_sz, []),
    "tc_q8_wire_bytes": (_sz, [_sz]),
    "tc_q8_encode": (_int, [_c, _sz, _c, _sz]),
    "tc_q8_decode": (_int, [_c, _sz, _c, _sz]),
    "tc_q4_block": (_sz, []),
    "tc_q4_wire_bytes": (_sz, [_sz]),
    "tc_q4_encode": (_int, [_c, _sz, _c, _sz]),
    "tc_q4_decode": (_int, [_c, _sz, _c, _sz]),
    "tc_codec_threads": (_int, []),
    "tc_codec_pipeline": (_int, []),
    # metrics, straggler watchdog and flight recorder
    "tc_metrics_enable": (None, [_c, _int]),
    "tc_metrics_enabled": (_int, [_c]),
    "tc_metrics_set_watchdog": (None, [_c, _i64]),
    "tc_metrics_json": (_int, [_c, _int, *_bytes_out]),
    "tc_flightrec_json": (_int, [_c, *_bytes_out]),
    "tc_flightrec_dump": (_int, [_c, ctypes.c_char_p]),
    "tc_flightrec_seq": (_u64, [_c]),
    "tc_flightrec_install_signal_handler": (None, []),
    # span tracer, phase profiler, causal span recorder, fleet plane
    "tc_debug_dump": (None, [_c]),
    "tc_trace_start": (None, [_c]),
    "tc_trace_stop": (None, [_c]),
    "tc_trace_json": (_int, [_c, *_bytes_out]),
    "tc_profile_json": (_int, [_c, *_bytes_out]),
    "tc_profile_enable": (None, [_c, _int]),
    "tc_profile_enabled": (_int, [_c]),
    "tc_spans_json": (_int, [_c, *_bytes_out]),
    "tc_spans_enable": (None, [_c, _int]),
    "tc_spans_enabled": (_int, [_c]),
    "tc_fleetobs_start": (_int, [_c]),
    "tc_fleetobs_stop": (_int, [_c]),
    "tc_fleetobs_running": (_int, [_c]),
    "tc_fleetobs_set_aux": (_int, [_c, ctypes.c_char_p]),
    "tc_fleet_json": (_int, [_c, *_bytes_out]),
    # fault injection (a table per library, so per process)
    "tc_fault_install": (_int, [ctypes.c_char_p]),
    "tc_fault_clear": (None, []),
    "tc_fault_report": (_int, [*_bytes_out]),
    # tuning tables and schedules
    "tc_tune": (_int, [_c, _sz, _sz, _int, _int, _u32, _i64, *_bytes_out]),
    "tc_tuning_install": (_int, [_c, ctypes.c_char_p]),
    "tc_tuning_json": (_int, [_c, *_bytes_out]),
    "tc_schedule_install": (_int, [_c, ctypes.c_char_p]),
    "tc_schedule_json": (_int, [_c, *_bytes_out]),
    "tc_schedule_list": (_int, [_c, *_bytes_out]),
    "tc_schedule_describe": (_int, [_c, ctypes.c_char_p, *_bytes_out]),
    "tc_schedule_generate": (_int, [ctypes.c_char_p, _int,
                                    ctypes.c_char_p, *_bytes_out]),
    "tc_schedule_families": (_int, [*_bytes_out]),
    "tc_schedule_verify": (_int, [ctypes.c_char_p]),
    # async engine and work handles
    "tc_async_new": (_c, [_c, _int, _u32]),
    "tc_async_shutdown": (_int, [_c]),
    "tc_async_free": (None, [_c]),
    "tc_async_lanes": (_int, [_c]),
    "tc_async_lane_context": (_c, [_c, _int]),
    "tc_async_stats_json": (_int, [_c, *_bytes_out]),
    "tc_async_allreduce_inplace": (_c, [_c, _c, _sz, _int, _int, _int,
                                        _i64]),
    "tc_async_reduce_scatter": (_c, [_c, _c, _c, ctypes.POINTER(_sz),
                                     _int, _int, _int, _int, _i64]),
    "tc_async_allgather": (_c, [_c, _c, _c, _sz, _int, _int, _i64]),
    "tc_work_wait": (_int, [_c, _i64]),
    "tc_work_status": (_int, [_c]),
    "tc_work_error_message": (_int, [_c, *_bytes_out]),
    "tc_work_free": (None, [_c]),
    # point-to-point buffers and one-sided put/get
    "tc_next_slot": (_u64, [_c, _u32]),
    "tc_buffer_new": (_c, [_c, _c, _sz]),
    "tc_buffer_free": (None, [_c]),
    "tc_buffer_send": (_int, [_c, _int, _u64, _sz, _sz]),
    "tc_buffer_recv": (_int, [_c, _int, _u64, _sz, _sz]),
    "tc_buffer_recv_any": (_int, [_c, ctypes.POINTER(_int), _sz, _u64, _sz,
                                  _sz]),
    "tc_buffer_wait_send": (_int, [_c, _i64]),
    "tc_buffer_wait_recv": (_int, [_c, _i64, ctypes.POINTER(_int)]),
    "tc_buffer_wait_put": (_int, [_c, _i64, ctypes.POINTER(_int)]),
    "tc_remote_key_size": (_sz, []),
    "tc_buffer_remote_key": (_int, [_c, ctypes.c_char_p, _sz]),
    "tc_buffer_put": (_int, [_c, ctypes.c_char_p, _sz, _sz, _sz, _sz,
                             _int]),
    "tc_buffer_get": (_int, [_c, ctypes.c_char_p, _sz, _u64, _sz, _sz,
                             _sz]),
    "tc_buffer_abort_wait_send": (None, [_c]),
    "tc_buffer_abort_wait_recv": (None, [_c]),
    # elastic membership plane (lease liveness, epoch transitions)
    "tc_elastic_new": (_c, [_c, _c, _int, _int, _int, _int,
                            ctypes.c_char_p, _i64]),
    "tc_elastic_rebuild": (_int, [_c, _i64, ctypes.POINTER(_c)]),
    "tc_elastic_note_failure": (_int, [_c, ctypes.c_char_p]),
    "tc_elastic_stop": (_int, [_c]),
    "tc_elastic_free": (None, [_c]),
    "tc_elastic_epoch": (_u64, [_c]),
    "tc_elastic_head_epoch": (_u64, [_c]),
    "tc_elastic_poll": (_int, [_c]),
    "tc_elastic_status_json": (_int, [_c, *_bytes_out]),
}

_cdll = None
_load_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The host library with its prototypes set, built first if needed."""
    global _cdll
    if _cdll is None:
        with _load_lock:
            if _cdll is None:
                cdll = ctypes.CDLL(str(_build.build_host_library()))
                for name, (restype, argtypes) in _PROTOTYPES.items():
                    fn = getattr(cdll, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _cdll = cdll
    return _cdll


def last_error() -> str:
    msg = lib().tc_last_error()
    return msg.decode("utf-8", "replace") if msg else ""


def check(code: int) -> None:
    """Raise the Python mapping of a TC_ERR_* code."""
    if code == TC_OK:
        return
    msg = last_error()
    if code == TC_ERR_TIMEOUT:
        raise TimeoutError(msg)
    if code == TC_ERR_IO:
        raise IoError(msg)
    if code == TC_ERR_ABORTED:
        raise Aborted(msg)
    raise Error(msg)


def check_handle(handle: int | None) -> int:
    if not handle:
        raise Error(last_error())
    return handle


def copy_out(fn, *args) -> bytes:
    """Call a C function whose trailing parameters are (uint8_t** out,
    size_t* out_len), copy the buffer, and free it via tc_buf_free."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    check(fn(*args, ctypes.byref(out), ctypes.byref(out_len)))
    try:
        return bytes(bytearray(out[: out_len.value]))
    finally:
        lib().tc_buf_free(out)
