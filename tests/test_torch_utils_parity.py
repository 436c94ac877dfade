"""gloo_tpu_torch.utils against gloo_tpu.utils: profile, critpath, metrics,
fleet, flightrec, and telemetry (healthz and the live endpoint).

The per-rank snapshots come from the reference's own run at P = 3 with a
delay fault on rank 1; both packages' pure tools take the same
snapshots, and their outputs must compare equal, with == on dicts and
strings. A delay fault on the port's rank 1 must make the port's
leaderboard blame rank 1, as the reference's does. The port's telemetry
endpoint serves over loopback what utils.metrics renders of the same
snapshot, in a form that passes tests/test_prometheus_lint.py's checks.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gloo_tpu import fault as ref_fault
from gloo_tpu.utils import critpath as ref_critpath
from gloo_tpu.utils import fleet as ref_fleet
from gloo_tpu.utils import flightrec as ref_flightrec
from gloo_tpu.utils import metrics as ref_metrics
from gloo_tpu.utils import profile as ref_profile
from gloo_tpu.utils import telemetry as ref_telemetry
from gloo_tpu_torch import _lib, fault
from gloo_tpu_torch.utils import (critpath, fleet, flightrec, metrics,
                                  profile, telemetry)
from tests.harness import spawn as ref_spawn
from tests.test_fleet import _SYNTH_FLEET
from tests.test_prometheus_lint import _base_family, _parse
from tests.test_prometheus_lint import _snapshot as hostile_snapshot
from tests.test_torch_host import spawn

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

SIZE = 3
# tests/test_profile.py's attribution schedule: rank 1's data sends wait
# 50 ms, six times.
DELAY = {"seed": 7, "faults": [
    {"when": {"rank": 1, "opcode": "data", "min_bytes": 1024},
     "action": "delay", "ms": 50, "count": 6}]}


def _workload(port, ctx, rank):
    """Four ring allreduces of 1 MiB with the profiler and the span
    recorder on; returns every snapshot the tools read."""
    ctx.profile_enable(True)
    ctx.spans_enable(True)
    x = torch.ones(1 << 18) if port else np.ones(1 << 18, np.float32)
    for _ in range(4):
        ctx.allreduce(x, algorithm="ring")
        x[:] = 1.0
    ctx.barrier()
    return {"profile": ctx.profile(), "spans": ctx.spans(),
            "metrics": ctx.metrics(), "flightrec": ctx.flightrec()}


def _delayed(port):
    mod, run = (fault, spawn) if port else (ref_fault, ref_spawn)
    mod.install(DELAY)
    try:
        snaps = run(SIZE, lambda c, r: _workload(port, c, r), timeout=60)
        fired = mod.report()
    finally:
        mod.clear()
    assert any(e["action"] == "delay" and e["rank"] == 1 for e in fired)
    return snaps


@pytest.fixture(scope="module")
def snaps():
    """The reference's per-rank snapshots of the delayed run."""
    return _delayed(port=False)


def _of(snaps, key):
    return [copy.deepcopy(s[key]) for s in snaps]


def test_profile_tools_are_the_references(snaps):
    docs = _of(snaps, "profile")
    merged = profile.merge(docs)
    assert merged == ref_profile.merge(docs)
    assert profile.merge(docs, group="") == ref_profile.merge(docs, group="")
    assert profile.merge_by_group(docs) == ref_profile.merge_by_group(docs)
    attributed = profile.attribute(merged)
    assert attributed == ref_profile.attribute(merged)
    assert profile.leaderboard(attributed) == \
        ref_profile.leaderboard(attributed)
    assert profile.to_perfetto(docs) == ref_profile.to_perfetto(docs)


def test_critpath_tools_are_the_references(snaps):
    docs = _of(snaps, "spans")
    merged = critpath.merge(docs)
    assert merged == ref_critpath.merge(docs)
    assert critpath.merge_by_group(docs) == ref_critpath.merge_by_group(docs)
    for clock in ("auto", "raw", "align"):
        analysis = critpath.analyze(merged, clock=clock)
        assert analysis == ref_critpath.analyze(merged, clock=clock)
    assert critpath.to_perfetto(merged, analysis) == \
        ref_critpath.to_perfetto(merged, analysis)
    assert critpath.to_perfetto(merged) == ref_critpath.to_perfetto(merged)


def test_critpath_finds_a_path_for_every_allreduce(snaps):
    analysis = critpath.analyze(critpath.merge(_of(snaps, "spans")))
    ops = [o for o in analysis["ops"] if o["op"] == "allreduce"]
    assert len(ops) == 4 and all(o["path"] for o in ops)


def test_metrics_tools_are_the_references(snaps):
    docs = _of(snaps, "metrics") + [hostile_snapshot()]
    for snap in docs:
        assert metrics.to_prometheus(snap) == ref_metrics.to_prometheus(snap)
        assert metrics.summarize_ops(snap) == ref_metrics.summarize_ops(snap)
        for op in snap.get("ops", {}).values():
            for q in (0.5, 0.95, 1.0):
                assert metrics.histogram_quantile(op["latency_us"], q) == \
                    ref_metrics.histogram_quantile(op["latency_us"], q)
    assert metrics.merge_snapshots(docs) == ref_metrics.merge_snapshots(docs)


def test_fleet_tools_are_the_references():
    stub = {"enabled": False, "note": "fleet view is aggregated at rank 0"}
    clipped = {k: v for k, v in _SYNTH_FLEET.items() if k != "coverage"}
    for doc in (_SYNTH_FLEET, clipped, stub):
        for name in ("reports", "coverage", "unhealthy", "summarize",
                     "render"):
            assert getattr(fleet, name)(doc) == \
                getattr(ref_fleet, name)(doc), name


def _desynced(docs):
    """The flight records with rank 2's second collective turned into
    another op: a desync at that cseq."""
    docs = copy.deepcopy(docs)
    events = [e for e in docs[2]["events"] if e["cseq"] is not None]
    events[1]["fp"] = "ffff"
    events[1]["op"] = "broadcast"
    return docs


def test_flightrec_tools_are_the_references(snaps, tmp_path):
    docs = _of(snaps, "flightrec")
    for records in (docs, _desynced(docs), docs[:2] + [None]):
        merged = flightrec.merge(records)
        assert merged == ref_flightrec.merge(records)
        verdict = flightrec.analyze(merged)
        assert verdict == ref_flightrec.analyze(merged)
        assert flightrec.to_perfetto(merged) == \
            ref_flightrec.to_perfetto(merged)
        if verdict["kind"] == "desync":
            with pytest.raises(flightrec.DesyncError) as port:
                flightrec.raise_on_desync(merged)
            with pytest.raises(ref_flightrec.DesyncError) as ref:
                ref_flightrec.raise_on_desync(merged)
            assert str(port.value) == str(ref.value)
            assert port.value.report == ref.value.report
        else:
            assert flightrec.raise_on_desync(merged) == \
                ref_flightrec.raise_on_desync(merged)
    tails = {r: d["events"] for r, d in enumerate(_desynced(docs))}
    assert flightrec.detect_desync(tails) == ref_flightrec.detect_desync(tails)
    for e in docs[0]["events"]:
        assert flightrec.describe_event(e) == ref_flightrec.describe_event(e)
    # Dumps in a directory: one empty, one cut short, one tagged.
    d = tmp_path / "dumps"
    d.mkdir()
    for r, doc in enumerate(docs):
        (d / f"flightrec-rank{r}.json").write_text(json.dumps(doc))
    (d / "flightrec-rank1.json").write_text("")
    (d / "flightrec-rank2-g1.json").write_text(json.dumps(docs[2]))
    (d / "flightrec-rank0-lane0.json").write_text('{"rank": 0, "ev')
    assert flightrec.merge(str(d)) == ref_flightrec.merge(str(d))
    assert flightrec.merge_by_tag(str(d)) == ref_flightrec.merge_by_tag(str(d))
    for name in sorted(os.listdir(d)):
        assert flightrec.load(str(d / name)) == \
            ref_flightrec.load(str(d / name))


def test_dumps_name_their_files_as_the_references(tmp_path):
    """flightrec.dump and critpath.dump on the port's contexts write the
    reference's file names, which the reference's loaders read."""
    def run(ctx, rank):
        ctx.spans_enable(True)
        ctx.allreduce(torch.ones(1024))
        return (flightrec.dump(ctx, str(tmp_path / "fr")),
                critpath.dump(ctx, str(tmp_path / "cp")))

    paths = spawn(2, run)
    for rank, (fr, cp) in enumerate(paths):
        assert os.path.basename(fr) == f"flightrec-rank{rank}.json"
        assert ref_flightrec.load(fr)["rank"] == rank
        assert os.path.basename(cp) == f"spans-rank{rank}.json"
    merged = ref_flightrec.merge(str(tmp_path / "fr"))
    assert sorted(merged["ranks"]) == [0, 1] and not merged["missing"]


def test_port_attribution_blames_the_delayed_rank(snaps):
    """The port's own run under the port's fault plane, and the reference's
    snapshots, both put rank 1 first on the leaderboard."""
    for docs in (_of(_delayed(port=True), "profile"), _of(snaps, "profile")):
        board = profile.leaderboard(profile.attribute(profile.merge(docs)))
        assert board[0]["rank"] == 1, board
        assert board[0]["blamed_us"] > 50_000, board


def _healthz_cases(snaps):
    base = copy.deepcopy(snaps[0]["metrics"])
    stalled = copy.deepcopy(base)
    stalled["watchdog"] = {"stalls": 1, "last": {
        "op": "allreduce", "peer": 1, "waited_us": 5000, "age_us": 200,
        "at_us": 10}}
    stale = copy.deepcopy(stalled)
    stale["watchdog"]["last"]["age_us"] = 10_000_000
    failed = copy.deepcopy(base)
    failed["transport_failure"] = {"peer": 2, "count": 1,
                                   "message": "closed by peer"}
    elastic = copy.deepcopy(base)
    elastic["elastic"] = {"epoch": 2, "head_epoch": 3, "size": 1,
                          "min_size": 2, "join_pending": False}
    return [base, stalled, stale, failed, elastic, hostile_snapshot()]


def test_healthz_is_the_references(snaps):
    for snap in _healthz_cases(snaps):
        for window in (None, 50.0):
            assert telemetry.healthz(snap, window) == \
                ref_telemetry.healthz(snap, window)


class Frozen:
    """A context stand-in that serves fixed snapshots (the telemetry
    server takes any object with the Context's surface)."""

    rank = 0

    def __init__(self, snap):
        self._snap = snap

    def metrics(self):
        return copy.deepcopy(self._snap["metrics"])

    def profile(self):
        return self._snap["profile"]

    def spans(self):
        return self._snap["spans"]

    def flightrec(self):
        return self._snap["flightrec"]

    def fleet(self):
        return _SYNTH_FLEET


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_served_routes_are_the_references(snaps):
    """Every route of the port's server answers what the reference's
    answers over the same snapshots; /metrics is to_prometheus of the
    snapshot and passes the exposition lint."""
    frozen = Frozen(snaps[0])
    with telemetry.serve_telemetry(frozen, port=0) as srv, \
            ref_telemetry.serve_telemetry(frozen, port=0) as ref_srv:
        for route in ("/metrics", "/healthz", "/profile.json", "/spans",
                      "/flightrec", "/fleet", "/", "/flightrec/dump",
                      "/nope"):
            assert _get(srv.url + route) == _get(ref_srv.url + route), route
        status, text = _get(srv.url + "/metrics")
    assert status == 200
    assert text == metrics.to_prometheus(frozen.metrics())
    _, types, samples = _parse(text)
    assert samples
    assert all(_base_family(n, types) in types for n, _, _ in samples)


def test_token_guards_every_route(snaps):
    frozen = Frozen(snaps[0])
    with telemetry.serve_telemetry(frozen, port=0, token="s3cret") as srv:
        assert _get(srv.url + "/healthz")[0] == 403
        assert _get(srv.url + "/healthz?token=wrong")[0] == 403
        assert _get(srv.url + "/healthz?token=s3cret")[0] == 200
        assert _get(srv.url + "/metrics",
                    {"X-TpuColl-Token": "s3cret"})[0] == 200
        assert telemetry.fetch_route(srv.url, "/healthz",
                                     token="s3cret")["ok"]


def test_strict_telemetry_port(monkeypatch):
    for value in ("80x", "-1", "70000"):
        monkeypatch.setenv("TPUCOLL_TELEMETRY_PORT", value)
        with pytest.raises(ValueError) as ref:
            ref_telemetry.serve_telemetry(Frozen({}))
        with pytest.raises(ValueError) as port:
            telemetry.serve_telemetry(Frozen({}))
        assert str(port.value) == str(ref.value)


def test_live_contexts_serve_health_and_metrics(tmp_path, monkeypatch):
    """The port's server over live port contexts: /healthz is 200,
    /metrics lints, the dump route writes this rank's ring."""
    monkeypatch.setenv("TPUCOLL_FLIGHTREC_DIR", str(tmp_path))

    def run(ctx, rank):
        ctx.allreduce(torch.ones(4096))
        with telemetry.serve_telemetry(ctx, port=0) as srv:
            health = _get(srv.url + "/healthz")
            status, text = _get(srv.url + "/metrics")
            _parse(text)
            req = urllib.request.Request(srv.url + "/flightrec/dump",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10) as resp:
                path = json.load(resp)["path"]
        ctx.barrier()
        return health[0], json.loads(health[1])["ok"], status, path

    for rank, (code, ok, status, path) in enumerate(spawn(2, run)):
        assert (code, ok, status) == (200, True, 200)
        assert path.endswith(f"flightrec-rank{rank}.json")
        assert ref_flightrec.load(path)["rank"] == rank


def test_serves_an_elastic_context():
    """An ElasticContext forwards the Context's surface through
    __getattr__; the server takes it, and /healthz reads its epoch."""
    import gloo_tpu_torch
    from gloo_tpu_torch import elastic

    ectx = elastic.ElasticContext(gloo_tpu_torch.HashStore(),
                                  gloo_tpu_torch.Device(), rank=0,
                                  world_size=1)
    try:
        with telemetry.serve_telemetry(ectx, port=0) as srv:
            health = telemetry.fetch_route(srv.url, "/healthz")
            for route in ("/profile.json", "/spans", "/flightrec", "/fleet"):
                assert telemetry.fetch_route(srv.url, route)["rank"] == 0
            status, text = _get(srv.url + "/metrics")
    finally:
        ectx.close()
    assert health["ok"] and health["epoch"] == 1 and health["members"] == 1
    assert status == 200 and "gloo_tpu_collective_calls_total" in text


def test_signal_handler_dumps_on_a_fatal_signal(tmp_path):
    """install_signal_handler (in a subprocess of its own): SIGTERM dumps
    every live context's ring before the process dies."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {repo!r})
        import torch
        import gloo_tpu_torch as g
        from gloo_tpu_torch.utils import flightrec
        flightrec.install_signal_handler()
        ctx = g.Context(0, 1)
        ctx.connect_full_mesh(g.HashStore(), g.Device())
        ctx.allreduce(torch.ones(8))
        os.kill(os.getpid(), signal.SIGTERM)
    """)
    env = dict(os.environ, TPUCOLL_FLIGHTREC_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM, proc.stderr
    merged = ref_flightrec.merge(str(tmp_path))
    assert list(merged["ranks"]) == [0]
    assert any(e["op"] == "allreduce" for e in merged["timeline"])
