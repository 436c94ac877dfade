"""gloo_tpu_torch.elastic: the port's counterparts of tests/test_elastic.py,
with torch tensors.

Three worker processes over a FileStore (real processes, real sockets,
real SIGKILLs), with lease knobs (TPUCOLL_LEASE_MS=250,
TPUCOLL_LEASE_GRACE=5000) that make detection take test-sized time and
still let a live worker's heartbeat through on a machine loaded by the
other test workers (with the reference tests' 1.2 s grace, a survivor's
lease expired there now and then). No worker body calls a rebuild
itself: run_elastic detects the membership change and drives it. Each
run has its own timeout, and the bounds on times leave room for a loaded
machine.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import textwrap

from gloo_tpu_torch import core, elastic

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GRACE_MS = 5000
_LEASE_ENV = {"TPUCOLL_LEASE_MS": "250", "TPUCOLL_LEASE_GRACE": str(_GRACE_MS),
              "OMP_NUM_THREADS": "1"}
_RUN_TIMEOUT = 240


def _spawn(body, rank, size, store, extra_env=None):
    env = dict(os.environ, **_LEASE_ENV)
    env.pop("TPUCOLL_FAULT_FILE", None)
    if extra_env:
        env.update(extra_env)
    prog = textwrap.dedent("""
        import json, os, signal, sys, time
        sys.path.insert(0, {repo!r})
        import torch
        import gloo_tpu_torch
        from gloo_tpu_torch import elastic

        rank = {rank}; size = {size}
        store = gloo_tpu_torch.FileStore({store!r})
        device = gloo_tpu_torch.Device()
    """).format(repo=_REPO, rank=rank, size=size, store=store) + \
        textwrap.dedent(body)
    return subprocess.Popen([sys.executable, "-c", prog],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _run(body, size=3, extra_env=None):
    """The body in `size` processes; (return codes, (out, err) each). No
    process outlives the call."""
    store = tempfile.mkdtemp()
    procs = [_spawn(body, r, size, store, extra_env) for r in range(size)]
    try:
        outs = [p.communicate(timeout=_RUN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _summary(out):
    line = [ln for ln in out[0].splitlines() if ln.startswith("OK ")]
    assert line, out
    return json.loads(line[0][3:])


# Every step allreduces a consensus stop flag (so that ranks end at the
# same step across membership changes), then a payload checked against the
# current size. `victim` SIGKILLs itself at step 3.
_STEP_BODY = """
victim = {victim}
target_steps = {target_steps}
stop_at_size = {stop_at_size}

def step_fn(ectx, step, state):
    if rank == victim and step == 3:
        os.kill(os.getpid(), signal.SIGKILL)
    flag = torch.zeros(1)
    if ectx.rank == 0 and state["done"] >= target_steps and \\
            ectx.size == stop_at_size:
        flag[0] = 1.0
    ectx.allreduce(flag, tag=0)
    if flag[0] > 0:
        raise StopIteration
    x = torch.full((1 << 14,), float(ectx.rank + 1))
    ectx.allreduce(x, tag=1)
    n = ectx.size
    assert float(x[0]) == n * (n + 1) / 2, (step, float(x[0]), n)
    state["done"] += 1
    return state

t0 = time.time()
res = elastic.run_elastic(step_fn, store=store, device=device,
                          rank=rank, world_size=size, min_size={min_size},
                          state={{"done": 0}}, timeout=90.0)
res["wall_s"] = round(time.time() - t0, 2)
res.pop("state")
print("OK", json.dumps(res))
"""


def test_sigkill_mid_allreduce_auto_recovery():
    """A SIGKILL of one rank is detected by lease expiry alone; the
    survivors resume in epoch 2 at size 2, and the agent's counters show
    the one transition, with no rebuild call in the worker body."""
    codes, outs = _run(_STEP_BODY.format(victim=2, target_steps=6,
                                         stop_at_size=2, min_size=2))
    assert codes[2] == -signal.SIGKILL, outs[2]
    for r in (0, 1):
        assert codes[r] == 0, (r, outs[r])
        res = _summary(outs[r])
        assert res["rebuilds"] == 1, res
        assert [(e["epoch"], e["size"], e["group"]) for e in
                res["epochs"]] == [(1, 3, "e1"), (2, 2, "e2")], res
        st = res["elastic"]
        assert st["epoch"] == 2 and st["size"] == 2, st
        assert st["members"] == [0, 1], st
        assert st["leases_renewed"] >= 2, st
        assert st["rebuilds"] == 2, st  # the founding bind and the recovery
        assert res["rebuild_ms"][0] < 6 * _GRACE_MS, res
        assert res["wall_s"] < 150, res
    assert _summary(outs[0])["elastic"]["bumps_published"] == 1
    assert _summary(outs[1])["elastic"]["bumps_published"] == 0


def test_shrink_below_min_size_fails_loudly():
    """With min_size == world_size, losing a rank raises the typed
    BelowMinSize on every survivor: not a hang, not a silent small
    group."""
    body = """
def step_fn(ectx, step, state):
    if rank == 2 and step == 2:
        os.kill(os.getpid(), signal.SIGKILL)
    ectx.allreduce(torch.ones(1024), tag=1)
    return state

try:
    elastic.run_elastic(step_fn, store=store, device=device, rank=rank,
                        world_size=size, min_size=3, steps=50,
                        timeout=90.0)
    print("UNEXPECTED-SUCCESS"); sys.exit(3)
except elastic.BelowMinSize as e:
    assert "below min_size 3" in str(e), e
    print("OK", json.dumps({"typed": True, "message": str(e)[:120]}))
"""
    codes, outs = _run(body)
    assert codes[2] == -signal.SIGKILL, outs[2]
    for r in (0, 1):
        assert codes[r] == 0, (r, outs[r])
        assert _summary(outs[r])["typed"] is True


def test_graceful_leave_is_immediate():
    """ElasticContext.leave() deletes the lease: the others shrink at the
    next monitor poll, without waiting out the grace."""
    body = """
def step_fn(ectx, step, state):
    if rank == 2 and step == 3:
        ectx.leave()
    flag = torch.zeros(1)
    if ectx.rank == 0 and ectx.size == 2 and state["post"] >= 2:
        flag[0] = 1.0
    ectx.allreduce(flag, tag=0)
    if flag[0] > 0:
        raise StopIteration
    x = torch.full((1024,), float(ectx.rank + 1))
    ectx.allreduce(x, tag=1)
    n = ectx.size
    assert float(x[0]) == n * (n + 1) / 2, (step, float(x[0]), n)
    if ectx.size == 2:
        state["post"] += 1
    return state

res = elastic.run_elastic(step_fn, store=store, device=device, rank=rank,
                          world_size=size, min_size=2,
                          state={"post": 0}, timeout=90.0)
res.pop("state")
print("OK", json.dumps(res))
"""
    codes, outs = _run(body)
    for r in range(3):
        assert codes[r] == 0, (r, outs[r])
    for r in (0, 1):
        res = _summary(outs[r])
        assert res["elastic"]["members"] == [0, 1], res
        assert res["elastic"]["epoch"] == 2, res
    assert _summary(outs[2])["left"] is True, outs[2]


def test_run_elastic_restores_from_checkpointer():
    """run_elastic with the port's StepCheckpointer: after the shrink every
    survivor resumes from the newest committed step, and the restored
    accumulator, advanced through the remaining steps, is the same on
    both."""
    ckdir = tempfile.mkdtemp()
    body = """
from gloo_tpu_torch.checkpoint import StepCheckpointer

ckpt = StepCheckpointer({ckdir!r}, keep=3)

def step_fn(ectx, step, state):
    if rank == 2 and step == 4:
        os.kill(os.getpid(), signal.SIGKILL)
    x = torch.ones(256)
    ectx.allreduce(x, tag=1)
    state = {{"acc": state["acc"] + x[0].double()}}
    if ectx.rank == 0:
        ckpt.save(step, state, force=True)
    return state

res = elastic.run_elastic(
    step_fn, store=store, device=device, rank=rank, world_size=size,
    min_size=2, steps=8, state={{"acc": torch.zeros((), dtype=torch.float64)}},
    checkpointer=ckpt,
    template={{"acc": torch.zeros((), dtype=torch.float64)}},
    timeout=90.0)
acc = res["state"]["acc"]
assert acc.dtype == torch.float64, acc.dtype
print("OK", json.dumps({{"acc": float(acc), "rebuilds": res["rebuilds"],
                         "sizes": [e["size"] for e in res["epochs"]]}}))
""".format(ckdir=ckdir)
    codes, outs = _run(body)
    assert codes[2] == -signal.SIGKILL, outs[2]
    results = []
    for r in (0, 1):
        assert codes[r] == 0, (r, outs[r])
        results.append(_summary(outs[r]))
    for res in results:
        assert res["rebuilds"] == 1 and res["sizes"] == [3, 2], res
    assert results[0]["acc"] == results[1]["acc"], results
    assert results[0]["acc"] > 0, results


def test_lease_knobs_are_strict():
    """TPUCOLL_LEASE_MS and TPUCOLL_LEASE_GRACE take the strict parsers:
    a malformed value, or a grace shorter than two renewal periods, fails
    loudly at agent construction."""
    prog = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_REPO!r})
        import gloo_tpu_torch
        from gloo_tpu_torch import elastic
        try:
            elastic.ElasticAgent(gloo_tpu_torch.HashStore(),
                                 gloo_tpu_torch.Device(), rank=0,
                                 world_size=1)
            print("UNEXPECTED"); sys.exit(3)
        except gloo_tpu_torch.core.Error as e:
            assert "TPUCOLL_LEASE" in str(e), e
            print("LOUD")
    """)
    for env_extra in ({"TPUCOLL_LEASE_MS": "fast"},
                      {"TPUCOLL_LEASE_MS": "500",
                       "TPUCOLL_LEASE_GRACE": "600"}):
        env = dict(os.environ, **env_extra)
        p = subprocess.run([sys.executable, "-c", prog],
                           capture_output=True, text=True, env=env,
                           timeout=_RUN_TIMEOUT)
        assert p.returncode == 0 and "LOUD" in p.stdout, (
            env_extra, p.stdout, p.stderr)


def test_elastic_context_wraps_the_collectives_the_port_has():
    """ElasticContext wraps each of the reference's collectives that the
    port's Context has: since the rest of the Context surface was ported,
    all 16 of them."""
    assert elastic.WRAPPED == elastic.REFERENCE_WRAPPED
    assert len(elastic.WRAPPED) == 16
    assert set(elastic.WRAPPED) == {
        name for name in elastic.REFERENCE_WRAPPED
        if hasattr(core.Context, name)}
    for name in elastic.REFERENCE_WRAPPED:
        method = getattr(elastic.ElasticContext, name, None)
        assert method.__qualname__ == f"ElasticContext.{name}"


# Every step allreduces a consensus stop flag (set after two steps back
# at the full size), then runs wrapped
# collectives of the rest of the surface (reduce, alltoall) and averages a
# gradient through ectx.bucketer(bucket_bytes, lanes), checked against the
# current size. `leaver` leaves gracefully at step 3; every worker names
# its host (host_id=), so the final epoch's topology has one host per
# member.
_JOIN_BODY = """
leaver = {leaver}

def step_fn(ectx, step, state):
    if rank == leaver and step == 3:
        ectx.leave()
    state["hosts"] = [h["fingerprint"] for h in ectx.topology()["hosts"]]
    # Rank 0 (wid 0) stops the run after 2 steps back at size 3.
    flag = torch.zeros(1)
    if ectx.rank == 0 and state["grown"] >= 2:
        flag[0] = 1.0
    ectx.allreduce(flag, tag=0)
    if flag[0] > 0:
        raise StopIteration
    n = ectx.size
    x = torch.full((256,), float(ectx.rank + 1))
    total = ectx.reduce(x, root=0, tag=1)
    assert (total is None) == (ectx.rank != 0)
    assert total is None or float(total[0]) == n * (n + 1) / 2
    rows = ectx.alltoall(torch.arange(n, dtype=torch.int32).view(n, 1) +
                         100 * ectx.rank, tag=2)
    assert rows.view(-1).tolist() == [100 * r + ectx.rank for r in range(n)]
    grad = torch.full((64,), float(ectx.rank))
    bucketer = ectx.bucketer(bucket_bytes=128, lanes=1)
    bucketer.add(grad)
    bucketer.finish()
    assert float(grad[0]) == (n - 1) / 2, (float(grad[0]), n)
    state["shrunk"] |= n == 2
    state["grown"] += state["shrunk"] and n == 3
    return state

res = elastic.run_elastic(step_fn, store=store, device=device, rank=rank,
                          world_size=size, min_size=2, join={join},
                          host_id="elastic-host%d" % rank,
                          state={{"shrunk": False, "grown": 0}},
                          timeout=90.0)
res["topology"] = res.pop("state")["hosts"]
print("OK", json.dumps(res))
"""


def test_a_joiner_rejoins_after_a_member_leaves():
    """Grow path: after rank 2 leaves, a fresh worker started with
    join=True is admitted at the next epoch boundary, back to the world
    size; all three then run the wrapped collectives. host_id= reaches
    every epoch's topology."""
    store = tempfile.mkdtemp()
    procs = [_spawn(_JOIN_BODY.format(leaver=2, join=False), r, 3, store)
             for r in range(3)]
    try:
        assert procs[2].wait(timeout=_RUN_TIMEOUT) == 0, \
            procs[2].communicate()
        joiner = _spawn(_JOIN_BODY.format(leaver=-1, join=True), 9, 3,
                        store)
        procs.append(joiner)
        outs = [p.communicate(timeout=_RUN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r in (0, 1, 3):
        assert procs[r].returncode == 0, (r, outs[r])
    for r in (0, 1):
        res = _summary(outs[r])
        assert [e["size"] for e in res["epochs"]] == [3, 2, 3], res
        assert res["elastic"]["members"] == [0, 1, 3], res
        hosts = res["topology"]
        assert sorted(hosts) == ["elastic-host0", "elastic-host1",
                                 "elastic-host9"], res
    jres = _summary(outs[3])
    st = jres["elastic"]
    assert st["wid"] == 3 and st["rank"] == 2 and st["size"] == 3, st
    assert jres["steps"] == 2 and jres["stopped"], jres
    assert _summary(outs[2])["left"] is True


def test_max_rebuilds_stops_run_elastic():
    """With max_rebuilds=0 the first membership change is not recovered
    from: run_elastic re-raises the EpochChanged on every survivor."""
    body = """
def step_fn(ectx, step, state):
    if rank == 2 and step == 2:
        ectx.leave()
    ectx.allreduce(torch.ones(1024), tag=1)
    return state

try:
    res = elastic.run_elastic(step_fn, store=store, device=device,
                              rank=rank, world_size=size, min_size=2,
                              steps=500, max_rebuilds=0, timeout=90.0)
    print("OK", json.dumps({"left": res["left"]}))
except elastic.EpochChanged as e:
    print("OK", json.dumps({"epoch_changed": e.epoch}))
"""
    codes, outs = _run(body)
    for r in range(3):
        assert codes[r] == 0, (r, outs[r])
    for r in (0, 1):
        assert _summary(outs[r]) == {"epoch_changed": 2}, outs[r]
    assert _summary(outs[2]) == {"left": True}


def test_reference_wraps_the_same_names():
    from gloo_tpu import elastic as ref

    for name in elastic.REFERENCE_WRAPPED:
        assert getattr(ref.ElasticContext, name).__qualname__ == \
            f"ElasticContext.{name}"
