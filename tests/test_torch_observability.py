"""The observability surface of gloo_tpu_torch.core against gloo_tpu.core's:
the span tracer (trace_*), the phase profiler (profile*), the causal span
recorder (spans*), the fleet plane (fleetobs_*, fleet), metrics() with its
"async" gauges, AsyncEngine.stats() and lane_*, debug_dump, the context
managers and the connect debug logger.

Both packages run the same workload, their ranks as threads of this
process over their own builds of the native core. The snapshots must have
the reference's structure: the same keys, op names, algorithms, cseq
sequence, byte and message counts, span kinds and wire spans. Timestamps
and durations are left out, and so are which phases and histogram buckets
a collective's microseconds fell into: those follow the clock.
"""

import json
import re
import threading
import time

import numpy as np
import pytest
import torch

import gloo_tpu
from gloo_tpu_torch import core
from gloo_tpu_torch.utils import fleet as fleet_util
from tests.harness import spawn as ref_spawn
from tests.test_torch_host import spawn, to_torch

PHASE_NAMES = {"pack", "post", "wire_wait", "reduce", "unpack", "intra",
               "inter", "fanout"}
# Keys whose values follow the clock.
TIMED = {"ts", "dur", "buckets"}


def _untimed(doc):
    """doc without the values that follow the clock: keys ending in _us or
    _bps, ts, dur, histogram buckets, and the phases (a phase appears only
    where it took time), which are checked to bear canonical names."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "phases":
                if "rank" in doc:  # a metrics snapshot's {op: {algo: ...}}
                    v = {p for algos in v.values()
                         for table in algos.values() for p in table}
                assert set(v) <= PHASE_NAMES, v
            elif not str(k).endswith(("_us", "_bps")) and k not in TIMED:
                out[k] = _untimed(v)
        return out
    if isinstance(doc, list):
        return [_untimed(v) for v in doc]
    return doc


def _spans(snap):
    """The span recorder's snapshot: its header, its wire spans in order,
    and the set of (cseq, op, kind, phase) over every span (how many local
    and wait spans a phase leaves follows the clock)."""
    spans = snap["spans"]
    wire = [{k: v for k, v in s.items() if k != "seq"}
            for s in spans if s["kind"] in ("send", "recv")]
    kinds = sorted({(s["cseq"], s["op"], s["kind"], s["phase"])
                    for s in spans}, key=str)
    head = {k: v for k, v in snap.items() if k != "spans"}
    return _untimed(head), _untimed(wire), kinds


def _metrics(snap):
    """A metrics snapshot without what follows the clock: the per-loop
    and per-channel counters and the per-peer transport figures (control
    messages and connects land when they land) give way to the keys a
    peer's entry has."""
    out = _untimed({k: v for k, v in snap.items()
                    if k not in ("loops", "channels", "transport")})
    out["transport"] = sorted({k for peer in snap["transport"].values()
                               for k in peer})
    return out


def _workload(port, ctx, rank):
    """Collectives with the tracer, the profiler and the span recorder on,
    then three async allreduces on an engine of 2 lanes. Returns every
    snapshot, with the clock's values left out."""
    mk = to_torch if port else np.copy
    ctx.profile_enable(True)
    ctx.spans_enable(True)
    ctx.trace_start()
    enabled = (ctx.profile_enabled(), ctx.spans_enabled())
    x = mk(np.arange(4096, dtype=np.float32) + rank)
    ctx.allreduce(x, algorithm="ring")
    ctx.allreduce(x)
    ctx.broadcast(x, root=ctx.size - 1)
    ctx.allgather(mk(np.ones(100, np.int32)))
    ctx.reduce_scatter(mk(np.ones(600 * ctx.size, np.float32)))
    ctx.barrier()
    trace = json.loads(ctx.trace_json())
    ctx.trace_stop()
    ctx.barrier()
    after_stop = json.loads(ctx.trace_json())
    engine = ctx.async_engine(lanes=2)
    # One buffer: its pointer keys the lanes' plan caches.
    buf = mk(np.ones(1000, np.float32))
    for _ in range(3):
        engine.allreduce_async(buf).wait()
    out = {
        "enabled": enabled, "trace": _untimed(trace),
        "after_stop": after_stop,
        "profile": _untimed(ctx.profile()), "spans": _spans(ctx.spans()),
        "metrics": _metrics(ctx.metrics()), "fleet": _untimed(ctx.fleet()),
        "flightrec": _untimed(ctx.flightrec()), "stats": engine.stats(),
        "lane_metrics": [_metrics(engine.lane_metrics(k))
                         for k in range(2)],
        "lane_profile": [_untimed(engine.lane_profile(k))
                         for k in range(2)],
        "lane_flightrec": [_untimed(engine.lane_flightrec(k))
                           for k in range(2)]}
    engine.shutdown()
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("size", [2, 3])
def test_snapshots_have_the_references_structure(size):
    ref = ref_spawn(size, lambda c, r: _workload(False, c, r), timeout=60)
    port = spawn(size, lambda c, r: _workload(True, c, r))
    for rank in range(size):
        for key in ref[rank]:
            assert port[rank][key] == ref[rank][key], (rank, key)
    first = port[0]
    assert first["enabled"] == [True, True]
    assert first["after_stop"] == []
    assert [e["name"] for e in first["trace"]] == [
        "allreduce", "allreduce", "broadcast", "allgather",
        "reduce_scatter", "barrier"]
    assert first["stats"]["completed"] == 3
    assert {k[2] for k in first["spans"][2]} >= {"send", "recv", "wait"}
    cseqs = [o["cseq"] for o in first["profile"]["ops"]]
    assert cseqs == sorted(cseqs) and len(set(cseqs)) == len(cseqs)


def test_metrics_carry_the_engines_gauges():
    """metrics()["async"] holds the engines' in-flight depth and stats(),
    as the reference's, before and after the engine's shutdown."""
    def run(port, ctx, rank):
        mk = to_torch if port else np.copy
        engine = ctx.async_engine(lanes=2)
        engine.allreduce_async(mk(np.ones(64, np.float32))).wait()
        live = ctx.metrics()["async"]
        engine.shutdown()
        return live, ctx.metrics()["async"]

    ref = ref_spawn(2, lambda c, r: run(False, c, r))
    port = spawn(2, lambda c, r: run(True, c, r))
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
    assert port[0][0]["in_flight"] == 0
    assert port[0][0]["engines"][0]["completed"] == 1


def test_profile_and_spans_are_off_by_default():
    def run(ctx, rank):
        ctx.barrier()
        snaps = (ctx.profile(), ctx.spans())
        return (ctx.profile_enabled(), ctx.spans_enabled(),
                len(snaps[0]["ops"]), len(snaps[1]["spans"]))

    assert spawn(2, run) == ref_spawn(2, run)


def test_trace_dump_writes_the_drained_trace(tmp_path):
    def run(ctx, rank):
        ctx.trace_start()
        ctx.allreduce(torch.ones(256))
        path = str(tmp_path / f"trace{rank}.json")
        ctx.trace_dump(path)
        with open(path) as f:
            events = json.load(f)
        return [(e["name"], e["pid"], e["args"]["bytes"]) for e in events], \
            json.loads(ctx.trace_json())

    for rank, (events, rest) in enumerate(spawn(2, run)):
        assert events == [("allreduce", rank, 1024)] and rest == []


def test_fleet_document_has_the_references_structure(monkeypatch):
    """The fleet plane over 2 ranks: rank 0's merged document reaches full
    coverage in-band, and its keys, coverage and per-rank report keys are
    the reference's; rank 1 answers with the reference's stub."""
    monkeypatch.setenv("TPUCOLL_FLEETOBS_INTERVAL_MS", "50")
    monkeypatch.setenv("TPUCOLL_FLEETOBS_WINDOW", "5")

    def run(port, ctx, rank):
        mk = to_torch if port else np.copy
        before = (ctx.fleetobs_running(), sorted(ctx.fleet()))
        ctx.fleetobs_start()
        ctx.fleetobs_set_aux({"job": "parity"})
        for _ in range(3):
            ctx.allreduce(mk(np.ones(256, np.float32)))
        doc = None
        deadline = time.monotonic() + 20
        while True:
            flag = mk(np.zeros(1, np.float32))
            if rank == 0 and doc is None:
                got = ctx.fleet()
                if fleet_util.coverage(got)["complete"]:
                    doc = got
            if rank == 0 and doc is not None:
                flag[0] = 1.0
            ctx.allreduce(flag)
            if float(flag[0]) > 0 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if rank != 0:
            doc = ctx.fleet()
        running = ctx.fleetobs_running()
        ctx.fleetobs_stop()
        return before, running, ctx.fleetobs_running(), _fleet_shape(doc)

    ref = ref_spawn(2, lambda c, r: run(False, c, r), timeout=60)
    port = spawn(2, lambda c, r: run(True, c, r))
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
    before, running, after, shape = port[0]
    assert not before[0] and running and not after
    assert shape["coverage"] == {"expected": 2, "reported": 2,
                                 "missing": [], "complete": True}


def _fleet_shape(doc):
    """A fleet document's structure: its keys, coverage, role, and the
    keys and ranks of the embedded reports."""
    reports = fleet_util.reports(doc)
    return {"keys": sorted(doc), "coverage": fleet_util.coverage(doc),
            "role": doc.get("role"), "enabled": doc.get("enabled"),
            "report_ranks": sorted(reports),
            "report_keys": sorted({k for r in reports.values() for k in r}),
            "aux": [r.get("aux") for _, r in sorted(reports.items())]}


def test_context_managers_close_the_context_and_the_engine():
    """`with engine:` shuts the engine down and `with ctx:` closes the
    context: later calls fail with the reference's classes and words."""
    def run(port, ctx, rank):
        mk = to_torch if port else np.copy
        engine = ctx.async_engine(lanes=2)
        with engine as entered:
            assert entered is engine
            engine.allreduce_async(mk(np.ones(4, np.float32))).wait()
        out = []
        try:
            engine.allreduce_async(mk(np.ones(4, np.float32)))
        except Exception as exc:  # noqa: BLE001 - compared below
            out.append((type(exc).__name__, str(exc)))
        with ctx as entered:
            assert entered is ctx
        try:
            ctx.barrier()
        except Exception as exc:  # noqa: BLE001 - compared below
            out.append((type(exc).__name__, str(exc)))
        return out, engine.stats()

    ref = ref_spawn(2, lambda c, r: run(False, c, r))
    port = spawn(2, lambda c, r: run(True, c, r))
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
    assert [cls for cls, _ in port[0][0]] == ["Error", "IoError"]


def test_debug_dump_writes_the_references_sections(capfd):
    def run(ctx, rank):
        if rank == 0:
            ctx.debug_dump()
        ctx.barrier()

    capfd.readouterr()
    ref_spawn(2, run)
    ref = capfd.readouterr().err
    spawn(2, run)
    port = capfd.readouterr().err
    assert ref.startswith("rank 0: posted=")
    # The counts (stash occupancy, queued sends) follow the clock.
    assert re.sub(r"\d+", "N", port) == re.sub(r"\d+", "N", ref)


def test_connect_debug_logger_sees_the_references_events():
    """Each package's hook (one per build of the native core) receives a
    record per outbound connect; the port's records are the reference's
    with the ephemeral ports left out."""
    def collect(pkg, run):
        records, lock = [], threading.Lock()

        def logger(rec):
            with lock:
                records.append(rec)

        pkg.set_connect_debug_logger(logger)
        try:
            run(3, lambda ctx, rank: ctx.barrier())
        finally:
            pkg.set_connect_debug_logger(None)
        return sorted(
            (json.dumps({k: (v.rsplit(":", 1)[0] if k in ("remote", "local")
                             else v) for k, v in r.items()}, sort_keys=True)
             for r in records))

    ref = collect(gloo_tpu, ref_spawn)
    port = collect(core, spawn)
    assert port == ref and ref
    ok = [json.loads(r) for r in port if json.loads(r)["ok"]]
    assert {(r["self_rank"], r["peer_rank"]) for r in ok} == \
        {(1, 0), (2, 0), (2, 1)}
    assert all(r["remote"] == "127.0.0.1" and r["attempt"] == 1
               for r in ok)
