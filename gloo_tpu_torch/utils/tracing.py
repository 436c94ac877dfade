"""Tracing for the port's device plane.

Counterpart of gloo_tpu/utils/tracing.py. ``device_trace`` wraps
``torch.profiler`` (CPU activity, and the card's kernels through CUPTI
when a CUDA device is present) and writes one Chrome trace into a
directory; open it with Perfetto. ``annotate`` labels a region under a
name, as ``jax.named_scope`` does in the reference: the port's collectives
and the exchanges of its parallel strategies run under the reference's
names (``gloo_tpu.allreduce``, ``gloo_tpu.fsdp.unshard``,
``gloo_tpu.pp.fwd_shift`` ...), so a profile puts device time under them
(``scope_device_ms``). ``merge_traces`` combines per-rank host traces into
one timeline, as in the reference.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import math
import os
import time
from typing import Iterable

import torch

# Device events of a Kineto trace: kernels, copies and fills on the card.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the region into `logdir`: one Chrome trace,
    ``<pid>.<ns>.pt.trace.json``, written when the region ends (also when
    it raises). Yields the torch.profiler.profile, whose key_averages() the
    caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@functools.cache
def _nvtx_available() -> bool:
    return torch.cuda.is_available()


class annotate:
    """``with annotate(name):`` labels the region in a running
    torch.profiler trace (``record_function``) and, on a machine with a
    CUDA device, as an NVTX range. With no profiler running it enters no
    record_function: one flag read, so the label can stay on every
    collective of the hot path."""

    __slots__ = ("name", "_scope", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._scope = None
        self._nvtx = False

    def __enter__(self):
        if _nvtx_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        if torch.autograd._profiler_enabled():
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        if self._scope is not None:
            scope, self._scope = self._scope, None
            scope.__exit__(*exc)
        if self._nvtx:
            self._nvtx = False
            torch.cuda.nvtx.range_pop()
        return False


def _trace_events(trace) -> list:
    """The event list of a Chrome trace given as a path or parsed (a dict
    with ``traceEvents``)."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    return [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]


def scope_device_ms(trace, name: str) -> tuple[float, int]:
    """(device ms, device events) launched under the scopes named `name`
    in a Kineto Chrome trace (device_trace's file, or that file parsed):
    the kernels, copies and
    fills whose launch (a CUDA runtime or driver call, or a CPU op, on the
    scope's thread) lies inside one of its spans. A launch is matched to
    its device event by the trace's ``correlation`` or ``External id``.
    Work launched outside the span, such as the backward of an op the
    scope ran (autograd runs it on its own thread), is not counted."""
    events = _trace_events(trace)
    spans: dict[tuple, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == name \
                and e.get("cat") in ("user_annotation", "cpu_op"):
            spans.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    for row in spans.values():
        row.sort()
    corr, ext = set(), set()
    for e in events:
        row = spans.get((e.get("pid"), e.get("tid")))
        if not row or e.get("ph") != "X" or e.get("cat") in _DEVICE_CATS:
            continue
        ts = e.get("ts", 0)
        i = bisect.bisect_right(row, (ts, math.inf)) - 1
        if i >= 0 and row[i][0] <= ts <= row[i][1]:
            args = e.get("args", {})
            if "correlation" in args:
                corr.add(args["correlation"])
            if "External id" in args:
                ext.add(args["External id"])
    total, count = 0.0, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
            continue
        args = e.get("args", {})
        if args.get("correlation") in corr or args.get("External id") in ext:
            total += e.get("dur", 0.0)
            count += 1
    return total / 1e3, count


def merge_traces(jsons: Iterable[str]) -> str:
    """Merge per-rank Chrome trace JSON arrays into one document.

    Emits `process_name`/`process_sort_index` metadata ("M") events per
    rank pid so Perfetto shows labeled per-rank rows, and sorts data
    events by timestamp so the merged document reads as one timeline
    (inputs with unsorted timestamps are fine). Pre-existing metadata
    events in the inputs are preserved (except process_name/
    process_sort_index, which are regenerated). Degrades gracefully over
    a crashed rank's leavings: empty or unparseable documents are
    skipped — the merge of the survivors must not throw.
    """
    events = []
    for doc in jsons:
        if not doc:
            continue
        try:
            parsed = json.loads(doc)
        except ValueError:
            continue
        if isinstance(parsed, list):
            events.extend(e for e in parsed if isinstance(e, dict))
    data = [e for e in events
            if e.get("ph") != "M"
            or e.get("name") not in ("process_name",
                                     "process_sort_index")]
    data.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    pids = sorted({e.get("pid", 0) for e in data})
    meta = []
    for pid in pids:
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"rank {pid}"}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"sort_index": pid}})
    return json.dumps(meta + data)
