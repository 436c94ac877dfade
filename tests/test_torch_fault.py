"""gloo_tpu_torch.fault against gloo_tpu.fault.

The fault table is process-global per library: the reference's build and
the port's each hold one, so each side installs its schedule through its
own module and runs its ranks as threads of this process (the rules pin
the injecting rank). The same seeded schedule at P = 3, over the same
workload, must fire the same faults: every rank's report(rank) equals the
reference's, and equals itself across two runs of the port. A
destructive fault fails the ranks with the reference's error classes and
words. Every test clears both tables when it ends.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gloo_tpu
from gloo_tpu import fault as ref_fault
from gloo_tpu_torch import Error, _lib, fault
from tests.harness import spawn as ref_spawn
from tests.test_torch_host import spawn

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

SIZE = 3
ROUNDS = 3
SCHEDULES = {
    "delay": {"seed": 1, "faults": [
        {"when": {"rank": 1, "peer": 2, "opcode": "data"},
         "action": "delay", "ms": 20, "count": 2}]},
    "dup": {"seed": 2, "faults": [
        {"when": {"rank": 1, "opcode": "data", "min_bytes": 1},
         "action": "dup", "count": 2}]},
    "mixed": {"seed": 11, "faults": [
        {"when": {"rank": 2, "opcode": "data"}, "action": "delay",
         "ms": 1, "prob": 0.5, "seed": 99},
        {"when": {"rank": 0, "peer": 1, "opcode": "data", "nth": 2},
         "action": "dup"},
        {"when": {"rank": 1, "peer": 2, "opcode": "data", "nth": 1},
         "action": "delay", "ms": 15}]},
    "truncate": {"seed": 5, "faults": [
        {"when": {"rank": 1, "peer": 2, "opcode": "data", "nth": 1,
                  "min_bytes": 1024}, "action": "truncate"}]},
    "kill": {"seed": 6, "faults": [
        {"when": {"rank": 1, "peer": 2, "opcode": "data", "nth": 1,
                  "min_bytes": 1024}, "action": "kill"}]},
}
# What each rank's error must say (tests/test_chaos.py's expectations, on
# the ring's link from rank 1 to its right neighbour, rank 2).
WORDS = {
    "truncate": {2: "rank 1",
                 1: "fault injection: truncated message to rank 2"},
    "kill": {2: "rank 1", 1: "fault injection: killed connection to rank 2"},
}
TOLERATED = ("delay", "dup", "mixed")


@pytest.fixture(autouse=True)
def _clear_tables():
    yield
    ref_fault.clear()
    fault.clear()


def _workload(port, ctx, rank):
    """ROUNDS ring allreduces of 4096 f32 under unique tags; stops at the
    first failure. Returns (results ok, error class, error words, the
    context's fault counters, this rank's fired counts by action)."""
    err = (None, None)
    ok = True
    for i in range(ROUNDS):
        x = (torch.full((4096,), float(rank + 1)) if port
             else np.full(4096, float(rank + 1), dtype=np.float32))
        try:
            ctx.allreduce(x, algorithm="ring", tag=i + 1, timeout=3.0)
        except Exception as exc:  # noqa: BLE001 - compared by the tests
            err = (type(exc).__name__, str(exc))
            break
        ok = ok and float(x[0]) == SIZE * (SIZE + 1) / 2
    mod = fault if port else ref_fault
    faults = ctx.metrics()["faults"]
    fired = {a: mod.fired_count(a, rank=rank)
             for a in ("delay", "dup", "truncate", "kill")}
    return ok, err[0], err[1], faults, fired


def _run(name, port):
    """Install SCHEDULES[name] on one side, run the workload, return
    (per-rank workload results, per-rank report(rank))."""
    mod, run = (fault, spawn) if port else (ref_fault, ref_spawn)
    mod.install(SCHEDULES[name])
    try:
        results = [None] * SIZE

        def fn(ctx, rank):
            results[rank] = _workload(port, ctx, rank)

        try:
            run(SIZE, fn, timeout=60)
        except AssertionError:
            pass  # a rank that failed in close(): its result is kept
        return results, [mod.report(rank=r) for r in range(SIZE)]
    finally:
        mod.clear()


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_reports_are_the_references_and_repeat(name):
    ref_results, ref_reports = _run(name, port=False)
    port_results, port_reports = _run(name, port=True)
    _, again = _run(name, port=True)
    assert any(ref_reports), "the schedule fired nothing"
    assert json.dumps(port_reports, sort_keys=True) == \
        json.dumps(ref_reports, sort_keys=True)
    assert json.dumps(again, sort_keys=True) == \
        json.dumps(port_reports, sort_keys=True)
    for rank in range(SIZE):
        ok, cls, words, _, fired = port_results[rank]
        ref_ok, ref_cls, ref_words, _, ref_fired = ref_results[rank]
        assert fired == ref_fired, rank
        if name in TOLERATED:
            assert ok and cls is None and ref_ok and ref_cls is None, \
                (rank, words)
        elif rank in WORDS[name]:
            assert cls == ref_cls == "IoError", (rank, words, ref_words)
            assert WORDS[name][rank] in words
            assert WORDS[name][rank] in ref_words


@pytest.mark.parametrize("name", TOLERATED)
def test_fired_count_agrees_with_metrics(name):
    """Each rank's metrics()["faults"] counts, by action, what
    fired_count(action, rank) reports, as on the reference."""
    for port in (False, True):
        results, reports = _run(name, port)
        for rank, (_, _, _, faults, fired) in enumerate(results):
            assert faults.get("total", 0) == len(reports[rank])
            for action, n in fired.items():
                assert faults.get(action, 0) == n, (port, rank, action)


def test_kill_raises_the_references_words():
    """The injecting rank's IoError carries the reference's message word
    for word."""
    ref_results, _ = _run("kill", port=False)
    port_results, _ = _run("kill", port=True)
    assert port_results[1][2] == ref_results[1][2]
    assert WORDS["kill"][1] in port_results[1][2]


@pytest.mark.parametrize("bad", [
    "{not json", {"faults": [{"action": "explode"}]},
    {"faults": [{"when": {"rnak": 1}, "action": "delay", "ms": 1}]},
    {"faults": [{"action": "delay", "mss": 500}]}],
    ids=["not_json", "unknown_action", "unknown_when", "unknown_field"])
def test_malformed_schedules_fail_as_the_reference(bad):
    with pytest.raises(gloo_tpu.Error) as ref:
        ref_fault.install(bad)
    with pytest.raises(Error) as port:
        fault.install(bad)
    assert str(port.value) == str(ref.value)
    assert fault.report() == ref_fault.report() == []


def test_tables_are_per_library():
    """A schedule installed through one package fires nothing through the
    other's build."""
    ref_fault.install(SCHEDULES["delay"])
    results = spawn(SIZE, lambda ctx, rank: _workload(True, ctx, rank))
    assert [fault.report(rank=r) for r in range(SIZE)] == [[], [], []]
    assert all(r[0] for r in results)


def test_fault_file_is_loaded_at_connect(tmp_path):
    """TPUCOLL_FAULT_FILE (read by every build at connect, so set only in
    a process of its own): the port's contexts load the schedule, and it
    fires as the same schedule installed through the reference's API."""
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(SCHEDULES["delay"]))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = f"""
import json, sys
sys.path.insert(0, {repo!r})
from gloo_tpu_torch import fault
from tests.test_torch_fault import SIZE, _workload
from tests.test_torch_host import spawn

spawn(SIZE, lambda ctx, rank: _workload(True, ctx, rank))
print(json.dumps([fault.report(rank=r) for r in range(SIZE)]))
"""
    proc = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, TPUCOLL_FAULT_FILE=str(path)))
    assert proc.returncode == 0, proc.stderr
    _, ref_reports = _run("delay", port=False)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ref_reports
