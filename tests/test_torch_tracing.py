"""gloo_tpu_torch.utils.tracing against gloo_tpu.utils.tracing, and the
port's profiling scopes.

- merge_traces is the reference's, document for document (JSON text
  compared exactly), broken and empty documents included.
- Every jax.named_scope name of the reference's device plane
  (gloo_tpu/tpu/spmd.py and gloo_tpu/parallel/*.py) shows up as a
  record_function event in a CPU torch.profiler run of the port's
  counterpart: each spmd collective, the FSDP step, the GPipe forward and
  the 1F1B step, the sp, tp, ep and ddp exchanges, and the host plane's
  HostGradSync (gloo_tpu.ddp.host_grad_sync).
- annotate enters no record_function with no profiler running.
- device_trace writes a Chrome trace that holds the scopes, and
  scope_device_ms sums the device events launched under a scope.
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gloo_tpu.utils.tracing import merge_traces as jax_merge_traces
from gloo_tpu_torch import core
from gloo_tpu_torch.entry import (ddp_train_entry, dp_tp_train_entry,
                                  ep_entry, fsdp_train_entry,
                                  pp_entry, sp_forward, sp_step)
from gloo_tpu_torch.parallel import (HostGradSync,
                                     allgather_matmul_dense_auto,
                                     ring_attention, ring_flash_attention,
                                     row_parallel_dense_scattered_auto,
                                     ulysses_attention)
from gloo_tpu_torch.tpu import make_mesh, spmd
from gloo_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reference_scopes():
    names = set()
    for path in [REPO / "gloo_tpu/tpu/spmd.py",
                 *sorted((REPO / "gloo_tpu/parallel").glob("*.py"))]:
        names |= set(re.findall(r'(?:named_scope|annotate)\("(gloo_tpu\.'
                                r'[a-z_.]+)"\)', path.read_text()))
    return names


def _world():
    return make_mesh({"data": 4}, devices=["cpu"] * 4)


def _x(*shape):
    return torch.from_numpy(np.random.RandomState(0).randn(
        4, *shape).astype(np.float32))


def _spmd(fn):
    return lambda: fn(_world())


def _sp(attn, step=sp_step):
    def run():
        mesh = make_mesh({"seq": 4}, devices=["cpu"] * 4)
        q, k, v = (_x(1, 4, 16, 8) for _ in range(3))
        step(attn, q, k, v, mesh)
    return run


def _fsdp():
    step, (sharded, batch) = fsdp_train_entry("cpu")
    step(sharded, batch)


def _gpipe():
    fn, args = pp_entry("cpu")["gpipe"]
    fn(*args)


def _one_f_one_b():
    fn, args = pp_entry("cpu")["1f1b"]
    fn(*args)


def _ddp():
    step, args = ddp_train_entry("cpu")
    step(*args)


def _dp_tp():
    step, args = dp_tp_train_entry("cpu")
    step(*args)


def _tp_unfused(fn, x, w):
    """A *_auto dispatch's unfused arm: the arm it takes on the CPU, where
    no fused ratio has been measured."""
    return lambda: fn(x, w, "data", mesh=_world())


def _ep():
    fn, args = ep_entry("cpu")
    fn(*args)


def _host_grad_sync():
    """HostGradSync over a context of one rank (the profiler records the
    scope on this thread)."""
    ctx = core.Context(0, 1, timeout=10)
    ctx.connect_full_mesh(core.HashStore(), core.Device())
    try:
        HostGradSync(ctx).average({"w": _x(8), "b": torch.ones(3)})
    finally:
        ctx.close()


RUNS = {
    "allreduce": _spmd(lambda m: spmd.allreduce(_x(8), "data", mesh=m)),
    "mean": _spmd(lambda m: spmd.mean(_x(8), "data", mesh=m)),
    "reduce_scatter": _spmd(
        lambda m: spmd.reduce_scatter(_x(8), "data", mesh=m)),
    "allgather": _spmd(lambda m: spmd.allgather(_x(8), "data", mesh=m)),
    "alltoall": _spmd(lambda m: spmd.alltoall(_x(8), "data", mesh=m)),
    "broadcast": _spmd(lambda m: spmd.broadcast(_x(8), "data", mesh=m)),
    "ppermute": _spmd(lambda m: spmd.ppermute(_x(8), "data", [(0, 1)],
                                              mesh=m)),
    "shift": _spmd(lambda m: spmd.shift(_x(8), "data", mesh=m)),
    "barrier": _spmd(lambda m: spmd.barrier("data", mesh=m)),
    "fsdp_step": _fsdp,
    "gpipe": _gpipe,
    "1f1b": _one_f_one_b,
    "ring_attention": _sp(ring_attention, sp_forward),
    "ring_flash_attention": _sp(ring_flash_attention),
    "ulysses_attention": _sp(ulysses_attention),
    "dp_tp_step": _dp_tp,
    "tp_row_scatter": _tp_unfused(row_parallel_dense_scattered_auto,
                                  _x(8, 16), _x(16, 8)),
    "tp_allgather_x": _tp_unfused(allgather_matmul_dense_auto, _x(2, 16),
                                  _x(16, 8)),
    "ep": _ep,
    "ddp_step": _ddp,
    "host_grad_sync": _host_grad_sync,
}

# Each reference scope and the run of the port that must show it.
EXPECTED = {
    "gloo_tpu.allreduce": ["allreduce", "mean", "fsdp_step"],
    "gloo_tpu.reduce_scatter": ["reduce_scatter"],
    "gloo_tpu.allgather": ["allgather", "fsdp_step"],
    "gloo_tpu.alltoall": ["alltoall", "ulysses_attention", "ep"],
    "gloo_tpu.broadcast": ["broadcast"],
    "gloo_tpu.ppermute": ["ppermute", "shift", "gpipe", "1f1b",
                          "ring_attention", "ring_flash_attention"],
    "gloo_tpu.barrier": ["barrier"],
    "gloo_tpu.fsdp.unshard": ["fsdp_step"],
    "gloo_tpu.pp.stage_shift": ["gpipe"],
    "gloo_tpu.pp.fwd_shift": ["1f1b"],
    "gloo_tpu.pp.bwd_shift": ["1f1b"],
    "gloo_tpu.sp.ring_shift": ["ring_attention", "ring_flash_attention"],
    "gloo_tpu.sp.ulysses_exchange": ["ulysses_attention"],
    "gloo_tpu.tp.row_sync": ["dp_tp_step"],
    "gloo_tpu.tp.row_scatter": ["tp_row_scatter"],
    "gloo_tpu.tp.allgather_x": ["tp_allgather_x"],
    "gloo_tpu.ep.dispatch": ["ep"],
    "gloo_tpu.ep.combine": ["ep"],
    "gloo_tpu.ddp.grad_sync": ["ddp_step"],
    "gloo_tpu.ddp.host_grad_sync": ["host_grad_sync"],
}


def test_every_reference_scope_is_covered():
    assert set(EXPECTED) == _reference_scopes()
    assert {run for runs in EXPECTED.values() for run in runs} == set(RUNS)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_scopes_show_in_a_cpu_profile(run, monkeypatch):
    monkeypatch.delenv("TPUCOLL_TP_OVERLAP", raising=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        RUNS[run]()
    names = {e.name for e in prof.events()}
    want = {scope for scope, runs in EXPECTED.items() if run in runs}
    assert want <= names, want - names
    # Nothing but the reference's names is made up under its prefix.
    assert {n for n in names if n.startswith("gloo_tpu.")} <= set(EXPECTED)


def test_annotate_enters_no_record_function_without_a_profiler(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with tracing.annotate("gloo_tpu.allreduce"):
        out = spmd.allreduce(_x(8), "data", mesh=_world())
    assert out.shape == (4, 8)


def test_annotate_nests_and_leaves_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with tracing.annotate("outer"):
                with tracing.annotate("inner"):
                    raise ValueError("leaves both scopes")
        with tracing.annotate("after"):
            torch.ones(1).add_(1)
    events = {e.name: e for e in prof.events()}
    assert {"outer", "inner", "after"} <= set(events)
    assert events["after"].time_range.start >= \
        events["outer"].time_range.end


def test_device_trace_writes_a_trace_with_the_scopes(tmp_path):
    with tracing.device_trace(str(tmp_path / "trace")) as prof:
        spmd.allgather(_x(8), "data", mesh=_world())
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "gloo_tpu.allgather" in names
    assert any(e.key == "gloo_tpu.allgather" for e in prof.key_averages())
    # No device here: nothing ran on a card under the scope.
    assert tracing.scope_device_ms(str(files[0]),
                                   "gloo_tpu.allgather") == (0.0, 0)


def test_device_trace_writes_its_trace_when_the_region_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with tracing.device_trace(str(tmp_path)):
            raise RuntimeError("region failed")
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


def test_scope_device_ms_sums_what_launched_under_the_scope():
    """A Kineto-shaped trace: one span of the scope on thread 1 with a
    runtime launch (matched by correlation) and a CPU op (matched by
    External id) inside, a launch outside it, and a span of the same name
    on another thread; durations in µs."""
    def x(cat, name, tid, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    events = [
        x("user_annotation", "scope", 1, 100, 50, **{"External id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", 1, 110, 5, correlation=10),
        x("cpu_op", "aten::copy_", 1, 120, 10, **{"External id": 2}),
        x("cuda_runtime", "cudaLaunchKernel", 1, 200, 5, correlation=11),
        x("user_annotation", "scope", 2, 300, 20, **{"External id": 3}),
        x("cuda_runtime", "cudaMemsetAsync", 2, 305, 2, correlation=12),
        x("kernel", "ring_kernel", 0, 115, 30, correlation=10),
        x("gpu_memcpy", "Memcpy DtoD", 0, 150, 4, **{"External id": 2}),
        x("kernel", "other", 0, 210, 1000, correlation=11),
        x("gpu_memset", "Memset", 0, 310, 6, correlation=12),
    ]
    doc = {"traceEvents": events}
    assert tracing.scope_device_ms(doc, "scope") == (0.04, 3)
    assert tracing.scope_device_ms(doc, "absent") == (0.0, 0)


MERGE_CASES = {
    "two_ranks": [
        json.dumps([{"name": "a", "ph": "X", "pid": 1, "ts": 5, "dur": 1},
                    {"name": "process_name", "ph": "M", "pid": 1,
                     "args": {"name": "old"}}]),
        json.dumps([{"name": "b", "ph": "X", "pid": 0, "ts": 3, "dur": 2},
                    {"name": "thread_name", "ph": "M", "pid": 0, "tid": 4,
                     "args": {"name": "t"}}])],
    "unsorted_same_ts": [
        json.dumps([{"name": "c", "ph": "X", "pid": 2, "ts": 9},
                    {"name": "d", "ph": "X", "pid": 1, "ts": 9},
                    {"name": "e", "ph": "X", "pid": 1, "ts": 1}])],
    "broken_and_empty": ["", "[{\"name\": \"x\"", "not json",
                         json.dumps({"traceEvents": []}),
                         json.dumps([1, "two", {"name": "f", "ph": "X",
                                                "pid": 3, "ts": 2}])],
    "nothing": [],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_traces_equals_the_reference(case):
    docs = MERGE_CASES[case]
    assert tracing.merge_traces(docs) == jax_merge_traces(docs)
