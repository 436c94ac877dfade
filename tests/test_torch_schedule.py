"""gloo_tpu_torch.schedule and gloo_tpu_torch.tuning against gloo_tpu's.

The context-free calls (families, generate, verify) must give the
reference's bytes and words. A collective under an installed schedule may
sum in another order than the native algorithm, so the port is held
against the reference under the same installed table, never against the
native dispatch: the same inputs, made with numpy from a seed per rank,
go through both, and the results are compared as raw bytes. The sweep and
the tuner time host tensors; each must elect one table on every rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gloo_tpu
from gloo_tpu import schedule as ref_schedule
from gloo_tpu import tuning as ref_tuning
from gloo_tpu_torch import Error, schedule, tuning
from tests.harness import spawn as ref_spawn
from tests.test_schedule import _GOOD_C0, RING, _elect, _fixture
from tests.test_torch_host import raw, spawn, to_torch

WORLDS = (2, 3, 4)


def _ref_or_error(fn, *args):
    """fn(*args) as JSON text, or the words of the error it raises."""
    try:
        return json.dumps(fn(*args), sort_keys=True)
    except (gloo_tpu.Error, Error) as exc:
        return f"error: {exc}"


def test_families_are_the_references():
    assert schedule.families() == ref_schedule.families()


@pytest.mark.parametrize("world", WORLDS)
def test_generate_is_the_references(world):
    """Every family of families() at worlds 2-4: the same table, byte for
    byte, or the same words where the family refuses the world."""
    for fam in ref_schedule.families():
        assert _ref_or_error(schedule.generate, fam, world) == \
            _ref_or_error(ref_schedule.generate, fam, world), fam


@pytest.mark.parametrize("fam,params", [
    ("ring", {"depth": 2}), ("ring", {"depth": 4}),
    ("hier", {"ranks_per_host": 2}), ("ring", {"bogus": 1}),
    ("hier", {"ranks_per_host": 3}), ("nope", {})], ids=str)
def test_generate_params_are_the_references(fam, params):
    for world in (4, 6):
        assert _ref_or_error(schedule.generate, fam, world, params) == \
            _ref_or_error(ref_schedule.generate, fam, world, params)


def _rejections():
    """The reference's rejection cases (tests/test_schedule.py)."""
    full = _GOOD_C0 + [
        {"op": "send", "peer": RING, "chunk": 1},
        {"op": "recv", "peer": RING, "chunk": 1, "slot": 1},
        {"op": "reduce_local", "chunk": 1, "slot": 1, "deps": [3, 4]}]
    raw_ring = json.dumps(ref_schedule.generate("ring", 2))
    cases = {
        "chunk_reduced_twice": _fixture(_GOOD_C0 + [
            {"op": "reduce_local", "chunk": 0, "slot": 0, "deps": [2],
             "note": "double_fold"}]),
        "undelivered": _fixture(list(_GOOD_C0)),
        "dependency_cycle": _fixture([
            {"op": "send", "peer": RING, "chunk": 0, "deps": [1]},
            {"op": "recv", "peer": RING, "chunk": 0, "slot": 0,
             "deps": [0]},
            {"op": "reduce_local", "chunk": 0, "slot": 0, "deps": [0, 1]}]),
        "wire_hazard": _fixture([
            {"op": "send", "peer": RING, "chunk": 0},
            {"op": "recv_reduce", "peer": RING, "chunk": 0, "slot": 0},
            {"op": "send", "peer": RING, "chunk": 1, "deps": [1]},
            {"op": "recv", "peer": RING, "chunk": 1, "slot": 1,
             "deps": [1]},
            {"op": "reduce_local", "chunk": 1, "slot": 1, "deps": [2, 3]}]),
        "pipeline_on_send": _fixture(_GOOD_C0 + [
            {"op": "send", "peer": RING, "chunk": 1, "pipeline": 4,
             "note": "piped_send"},
            {"op": "recv", "peer": RING, "chunk": 1, "slot": 1},
            {"op": "reduce_local", "chunk": 1, "slot": 1, "deps": [3, 4]}]),
        "duplicate_key": raw_ring.replace(
            '"op": "send"', '"op": "send", "op": "send"', 1),
        "top_level_duplicate": raw_ring[:-1] + ', "version": 1}',
        "malformed": "{not json",
    }
    for depth in (0, 33):
        steps = [dict(s) for s in full]
        steps[4]["pipeline"] = depth
        cases[f"pipeline_{depth}"] = _fixture(steps)
    return cases


@pytest.mark.parametrize("case", sorted(_rejections()))
def test_verify_refuses_with_the_references_words(case):
    table = _rejections()[case]
    with pytest.raises(gloo_tpu.Error) as ref:
        ref_schedule.verify(table)
    with pytest.raises(Error) as port:
        schedule.verify(table)
    assert str(port.value) == str(ref.value)


def test_verify_accepts_what_the_reference_accepts():
    table = _fixture(_GOOD_C0 + [
        {"op": "send", "peer": RING, "chunk": 1},
        {"op": "recv", "peer": RING, "chunk": 1, "slot": 1},
        {"op": "reduce_local", "chunk": 1, "slot": 1, "deps": [3, 4]}])
    ref_schedule.verify(table)
    schedule.verify(table)


def test_install_list_describe_round_trip(tmp_path):
    """install, installed, list_schedules, describe, merge, save and load
    give the reference's documents on an unconnected context; a refused
    install leaves the installed plane as it was."""
    from gloo_tpu_torch import Context

    table = ref_schedule.merge(ref_schedule.generate("ring", 2),
                               ref_schedule.generate("hd", 4))
    assert schedule.merge(schedule.generate("ring", 2),
                          schedule.generate("hd", 4)) == table
    ref_ctx, ctx = gloo_tpu.Context(0, 2), Context(0, 2)
    ref_schedule.install(ref_ctx, table)
    schedule.install(ctx, table)
    assert schedule.installed(ctx) == ref_schedule.installed(ref_ctx)
    assert schedule.list_schedules(ctx) == \
        ref_schedule.list_schedules(ref_ctx)
    assert schedule.describe(ctx, "ring_p2") == \
        ref_schedule.describe(ref_ctx, "ring_p2")
    with pytest.raises(Error, match="no installed"):
        schedule.describe(ctx, "nope")
    with pytest.raises(Error, match="undelivered"):
        schedule.install(ctx, _fixture(list(_GOOD_C0)))
    assert schedule.installed(ctx) == ref_schedule.installed(ref_ctx)
    path = str(tmp_path / "sched.json")
    schedule.save(schedule.installed(ctx), path)
    assert schedule.load(path) == schedule.installed(ctx)
    with pytest.raises(ValueError, match="duplicate schedule name"):
        schedule.merge(table, table)
    schedule.clear(ctx)
    assert schedule.installed(ctx) is None


def _rank_data(world, rank, count, dtype):
    """Rank `rank`'s input: fractions for f32 (so the order of the sums
    shows in the bits), signed integers for int32."""
    rng = np.random.RandomState(7919 * world + 31 * rank + count)
    if dtype == np.float32:
        return rng.standard_normal(count).astype(np.float32)
    return rng.randint(-1000, 1000, count).astype(np.int32)


def _scheduled(lib, ctx, rank, collective, fam, params, dtype, per):
    """The collective under the elected schedule, twice (the fresh plan and
    its warm replay), as raw bytes."""
    world = ctx.size
    port = lib is None
    sched = schedule if port else ref_schedule
    count = per * world if collective != "allgather" else per
    base = _rank_data(world, rank, count, dtype)
    nbytes = base.nbytes * (world if collective == "allgather" else 1)
    sched.install(ctx, _elect(sched.generate(fam, world, params),
                              collective, world, nbytes))
    ctx.plan_cache_clear()
    ctx.barrier()
    out = []
    for _ in range(2):
        x = to_torch(base) if port else base.copy()
        if collective == "allreduce":
            ctx.allreduce(x)
            out.append(raw(x))
        elif collective == "reduce_scatter":
            out.append(raw(ctx.reduce_scatter(x)))
        else:
            out.append(raw(ctx.allgather(x)))
    algos = [e["algo"] for e in ctx.flightrec()["events"]
             if e["op"] == collective][-2:]
    sched.clear(ctx)
    return out, algos


CASES = [("allreduce", "ring", {}), ("allreduce", "ring", {"depth": 2}),
         ("allreduce", "ring", {"depth": 4}), ("allreduce", "hd", {}),
         ("allreduce", "bcube", {}),
         ("allreduce", "hier", {"ranks_per_host": 2}),
         ("reduce_scatter", "ring_rs", {}), ("reduce_scatter", "hd_rs", {}),
         ("allgather", "ring_ag", {}), ("allgather", "hd_ag", {})]


# Every case at every world it generates for (hd needs a power of two,
# hier a world that ranks_per_host divides).
RUNS = [(c, f, p, w) for c, f, p in CASES for w in WORLDS
        if not (f.startswith("hd") and w & (w - 1))
        and not (f == "hier" and w % p["ranks_per_host"])]


@pytest.mark.parametrize("collective,fam,params,world", RUNS,
                         ids=lambda v: str(v))
def test_collectives_under_a_schedule_are_the_references(collective, fam,
                                                         params, world):
    results = {}
    for dtype in (np.float32, np.int32):
        for side, (run, lib) in (("ref", (ref_spawn, gloo_tpu)),
                                 ("port", (spawn, None))):
            results[side, dtype] = run(world, lambda ctx, rank: _scheduled(
                lib, ctx, rank, collective, fam, params, dtype, 96),
                timeout=60)
    for dtype in (np.float32, np.int32):
        ref, port = results["ref", dtype], results["port", dtype]
        assert [r[0] for r in port] == [r[0] for r in ref], dtype
        for out, algos in port:
            assert out[0] == out[1]
            assert all(a.startswith("sched:") for a in algos), algos


@pytest.mark.parametrize("world", WORLDS)
def test_coded_schedule_needs_the_lossy_opt_in(world):
    """The bf16-wire ring fires only under wire="lossy" on float32 sums,
    on the port as on the reference, with the reference's bits."""
    def run(lib, ctx, rank):
        port = lib is None
        sched = schedule if port else ref_schedule
        base = _rank_data(world, rank, 384, np.float32)
        table = _elect(sched.generate("ring_bf16", world), "allreduce",
                       world, base.nbytes)
        sched.install(ctx, table)
        ctx.plan_cache_clear()
        ctx.barrier()
        coded = to_torch(base) if port else base.copy()
        ctx.allreduce(coded, wire="lossy")
        plain = to_torch(base) if port else base.copy()
        ctx.allreduce(plain)
        algos = [e["algo"] for e in ctx.flightrec()["events"]
                 if e["op"] == "allreduce"][-2:]
        sched.clear(ctx)
        return raw(coded), raw(plain), algos

    ref = ref_spawn(world, lambda c, r: run(gloo_tpu, c, r), timeout=60)
    port = spawn(world, lambda c, r: run(None, c, r), timeout=60)
    assert [p[:2] for p in port] == [r[:2] for r in ref]
    name = f"sched:{ref_schedule.generate('ring_bf16', world)['schedules'][0]['name']}"
    for _, _, algos in port:
        assert algos[0] == name and algos[1] != name, algos


@pytest.mark.parametrize("world", (2, 3))
def test_sweep_elects_one_table_on_every_rank(world):
    """sweep() at 1-64 KiB with 2 timed iterations: every rank installs
    the same table, and an allreduce under it sums right."""
    def fn(ctx, rank):
        table = schedule.sweep(ctx, min_bytes=1 << 10, max_bytes=64 << 10,
                               iters=2, warmup=1,
                               candidates=[("ring", {"depth": 2}),
                                           ("bcube", {})])
        installed = schedule.installed(ctx)
        x = torch.full((4096,), float(rank + 1))
        ctx.allreduce(x)
        assert torch.equal(x, torch.full((4096,),
                                         world * (world + 1) / 2))
        return json.dumps(table, sort_keys=True), \
            json.dumps(installed, sort_keys=True)

    results = spawn(world, fn, timeout=120)
    assert len({r[0] for r in results}) == 1
    table = json.loads(results[0][0])
    assert set(table) == {"version", "schedules", "elections"}
    for e in table["elections"]:
        assert e["collective"] == "allreduce" and e["world_size"] == world
        assert 10 <= e["bucket"] <= 16


@pytest.mark.parametrize("world", (2, 3))
def test_tune_elects_one_table_on_every_rank(world):
    def fn(ctx, rank):
        table = tuning.tune(ctx, min_bytes=4096, max_bytes=16384, iters=2,
                            warmup=1)
        x = torch.full((256,), float(rank + 1))
        ctx.allreduce(x)
        assert torch.equal(x, torch.full((256,), world * (world + 1) / 2))
        assert tuning.installed_table(ctx) == table
        return json.dumps(table, sort_keys=True)

    results = spawn(world, fn, timeout=120)
    assert len(set(results)) == 1
    table = json.loads(results[0])
    assert {e["collective"] for e in table["entries"]} == \
        {"allreduce", "reduce", "reduce_scatter"}
    assert {e["bucket"] for e in table["entries"]} == {12, 13, 14}


def test_tuning_table_round_trips(tmp_path):
    """install_table, installed_table, save_table/load_table,
    set_transport_hints and clear_table as on the reference."""
    from gloo_tpu_torch import Context

    table = {"version": 1, "entries": [
        {"collective": "allreduce", "algorithm": "ring", "world_size": 2,
         "dtype": "float32", "bucket": b, "cost_us": c}
        for b, c in ((20, 1500.0), (10, 80.5))] + [
        {"collective": "reduce_scatter", "algorithm": "direct",
         "world_size": 4, "dtype": "float32", "bucket": 12,
         "cost_us": 55.125}]}
    hinted = tuning.set_transport_hints(table, channels=4,
                                        stripe_bytes=1 << 20)
    assert hinted == ref_tuning.set_transport_hints(table, channels=4,
                                                    stripe_bytes=1 << 20)
    for bad in ({"channels": 9}, {"stripe_bytes": -1}):
        with pytest.raises(ValueError) as ref:
            ref_tuning.set_transport_hints(table, **bad)
        with pytest.raises(ValueError) as port:
            tuning.set_transport_hints(table, **bad)
        assert str(port.value) == str(ref.value)
    path = str(tmp_path / "table.json")
    tuning.save_table(hinted, path)
    assert tuning.load_table(path) == hinted
    ref_ctx, ctx = gloo_tpu.Context(0, 2), Context(0, 2)
    assert tuning.installed_table(ctx) is None
    ref_tuning.install_table(ref_ctx, hinted)
    tuning.install_table(ctx, tuning.load_table(path))
    assert tuning.installed_table(ctx) == \
        ref_tuning.installed_table(ref_ctx)
    with pytest.raises(Error):
        tuning.install_table(ctx, {"version": 99, "entries": []})
    tuning.clear_table(ctx)
    assert tuning.installed_table(ctx) is None


def test_schedule_file_is_installed_at_connect(tmp_path):
    """TPUCOLL_SCHEDULE_FILE (read by every build at connect, so set only
    in a process of its own): the port's contexts install the file's table
    and dispatch its election."""
    table = _elect(ref_schedule.generate("ring", 2, {"depth": 2}),
                   "allreduce", 2, 4096)
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(table))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = f"""
import json, sys, torch
sys.path.insert(0, {repo!r})
from gloo_tpu_torch import schedule
from tests.test_torch_host import spawn

def fn(ctx, rank):
    x = torch.full((1024,), float(rank + 1))
    ctx.allreduce(x)
    algo = [e["algo"] for e in ctx.flightrec()["events"]
            if e["op"] == "allreduce"][-1]
    return schedule.installed(ctx), algo, float(x[0])

print(json.dumps(spawn(2, fn)))
"""
    proc = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, TPUCOLL_SCHEDULE_FILE=str(path)))
    assert proc.returncode == 0, proc.stderr
    ref_ctx = gloo_tpu.Context(0, 2)
    ref_schedule.install(ref_ctx, table)
    for installed, algo, value in json.loads(
            proc.stdout.strip().splitlines()[-1]):
        assert installed == ref_schedule.installed(ref_ctx)
        assert algo == f"sched:{table['schedules'][0]['name']}"
        assert value == 3.0
