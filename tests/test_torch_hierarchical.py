"""gloo_tpu_torch.tpu.hierarchical against gloo_tpu.tpu.hierarchical.

Every test of tests/test_hierarchical.py that has a counterpart, on the
port's host plane with CPU "devices" (["cpu"] * L stands for L local ranks
of a card, as make_mesh's devices do): the partials of 2 hosts x 4
devices, one tensor per host with its ops, the mean over uneven counts,
broadcast and allgather, the native splits of 4 processes presenting as 2
hosts x 2, and a run of two OS processes over a FileStore. The reference
runs the same cases on the 8-device virtual CPU mesh and its results are
compared bitwise where both sides run the same arithmetic.

make_hierarchical_ddp trains the reference test's linear model for 30 SGD
steps on both sides (2 hosts x 2 local ranks; parameters to rtol 1e-5,
bitwise across hosts), and the flagship at its 2 layers runs 2 hosts x 2
local ranks against the port's own 4-rank make_ddp_train_step (the first
step's loss and gradients to rtol 1e-5: the sums differ in order,
(a + b) / 2 + (c + d) / 2 over 2 against a ring of 4).
"""

import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from gloo_tpu.tpu import HierarchicalGroup as JaxGroup  # noqa: E402
from gloo_tpu.tpu import make_hierarchical_ddp as jax_hier_ddp  # noqa: E402
from gloo_tpu_torch import _lib  # noqa: E402
from gloo_tpu_torch.entry import (ddp_train_entry, hier_ddp_entry,  # noqa: E402,E501
                                  host_ddp_entry)
from gloo_tpu_torch.tpu import (HierarchicalGroup,  # noqa: E402
                                make_hierarchical_ddp)
from tests.harness import spawn as jax_spawn  # noqa: E402
from tests.test_group import spawn_topo as jax_spawn_topo  # noqa: E402
from tests.test_torch_host import raw, spawn  # noqa: E402

# The host library, built (under its lock) while this file is collected,
# so that no test's threads or processes meet its build inside their
# timeouts.
_lib.lib()

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_devices(rank, per_host):
    return jax.devices()[rank * per_host:(rank + 1) * per_host]


def _cpus(n):
    return [torch.device("cpu")] * n


def _partials(port, ctx, rank, hosts, per_host, n):
    if port:
        group = HierarchicalGroup(ctx, devices=_cpus(per_host))
        parts = [torch.full((n,), float(rank * per_host + d + 1))
                 for d in range(per_host)]
        before = [p.clone() for p in parts]
        out = group.allreduce(parts)
        assert all(torch.equal(a, b) for a, b in zip(parts, before))
        assert len({o.data_ptr() for o in out}) == per_host  # copies
        return [raw(o) for o in out]
    devs = _jax_devices(rank, per_host)
    group = JaxGroup(ctx, devices=devs)
    parts = [jax.device_put(np.full(n, rank * per_host + d + 1, np.float32),
                            devs[d]) for d in range(per_host)]
    return [raw(np.asarray(o)) for o in group.allreduce(parts)]


def test_allreduce_partials():
    """2 hosts x 4 devices: the partials fold on the first device, the
    hosts combine over the host plane, and every device gets the sum
    (1 + ... + 8 = 36)."""
    hosts, per_host, n = 2, 4, 1 << 14
    ref = jax_spawn(hosts, lambda c, r: _partials(False, c, r, hosts,
                                                  per_host, n), timeout=90)
    got = spawn(hosts, lambda c, r: _partials(True, c, r, hosts, per_host,
                                              n), timeout=90)
    assert got == ref
    assert got[0][0] == raw(torch.full((n,), 36.0))


def _single_and_ops(port, ctx, rank):
    if port:
        group = HierarchicalGroup(ctx, devices=_cpus(4))
        x = torch.full((64,), float(rank + 1))
        out = group.allreduce(x, op="max")
        assert isinstance(out, torch.Tensor) and out is not x
        assert float(x[0]) == rank + 1  # the caller's tensor is untouched
        y = torch.full((64,), float(rank + 2))
        out2 = group.allreduce(y, op="sum")
        ints = group.allreduce([torch.full((3,), rank + 2, dtype=torch.int32),
                                torch.full((3,), 3, dtype=torch.int32)],
                               op="prod")
        mins = group.allreduce(torch.tensor([rank, -rank], dtype=torch.int64),
                               op="min")
        return [raw(out), raw(out2), raw(ints[0]), raw(mins)]
    devs = _jax_devices(rank, 4)
    group = JaxGroup(ctx, devices=devs)
    x = jax.device_put(np.full(64, float(rank + 1), np.float32), devs[0])
    out = group.allreduce(x, op="max")
    out2 = group.allreduce(np.full(64, float(rank + 2), np.float32))
    ints = group.allreduce([jax.device_put(np.full(3, rank + 2, np.int32),
                                           devs[0]),
                            jax.device_put(np.full(3, 3, np.int32),
                                           devs[1])], op="prod")
    mins = group.allreduce(np.array([rank, -rank], np.int64), op="min")
    return [raw(np.asarray(out)), raw(out2), raw(np.asarray(ints[0])),
            raw(mins)]


def test_allreduce_single_tensor_and_ops():
    ref = jax_spawn(2, lambda c, r: _single_and_ops(False, c, r), timeout=60)
    got = spawn(2, lambda c, r: _single_and_ops(True, c, r), timeout=60)
    assert got == ref
    assert got[0][0] == raw(torch.full((64,), 2.0))
    assert got[0][1] == raw(torch.full((64,), 5.0))


def test_tensor_in_gives_a_tensor_on_its_device():
    """A list in gives one copy per device; a tensor in gives a tensor on
    its own device."""
    def fn(ctx, rank):
        group = HierarchicalGroup(ctx, devices=["cpu", "cpu"])
        out = group.allreduce([torch.ones(4), torch.ones(4)])
        single = group.broadcast(torch.full((2,), float(rank)), root=1)
        return ([o.device.type for o in out], out[0].data_ptr() !=
                out[1].data_ptr(), single.device.type, float(single[0]))

    assert spawn(2, fn) == [(["cpu", "cpu"], True, "cpu", 1.0)] * 2


def test_default_devices_are_the_card():
    group = HierarchicalGroup(None)
    assert group.devices == [torch.device("cuda")]
    assert group._hier_algo == "auto"  # no context to ask: flat


def _uneven(port, ctx, rank):
    nlocal = 3 if rank == 0 else 2
    if port:
        group = HierarchicalGroup(ctx, devices=_cpus(4))
        out = group.mean([torch.full((8,), 10.0) for _ in range(nlocal)])
        return [raw(o) for o in out]
    devs = _jax_devices(rank, 4)
    group = JaxGroup(ctx, devices=devs)
    out = group.mean([jax.device_put(np.full(8, 10.0, np.float32), devs[d])
                      for d in range(nlocal)])
    return [raw(np.asarray(o)) for o in out]


def test_mean_uneven_counts():
    """Host 0 contributes 3 partials, host 1 two: the mean divides by the
    true count, 5."""
    ref = jax_spawn(2, lambda c, r: _uneven(False, c, r), timeout=60)
    got = spawn(2, lambda c, r: _uneven(True, c, r), timeout=60)
    assert got == ref
    assert got[1][0] == raw(torch.full((8,), 10.0))


def _bcast_gather(port, ctx, rank):
    if port:
        group = HierarchicalGroup(ctx, devices=_cpus(4))
        x = torch.full((32,), float(rank + 1))
        b = group.broadcast(x, root=1)
        g = group.allgather([x, x * 2])
        return [raw(b), raw(g), tuple(g.shape)]
    devs = _jax_devices(rank, 4)
    group = JaxGroup(ctx, devices=devs)
    x = jax.device_put(np.full(32, float(rank + 1), np.float32), devs[0])
    b = group.broadcast(x, root=1)
    g = group.allgather([x, jax.device_put(np.asarray(x) * 2, devs[1])])
    return [raw(np.asarray(b)), raw(g), tuple(g.shape)]


def test_broadcast_allgather():
    ref = jax_spawn(2, lambda c, r: _bcast_gather(False, c, r), timeout=60)
    got = spawn(2, lambda c, r: _bcast_gather(True, c, r), timeout=60)
    assert got == ref
    assert got[0][2] == (2, 32)


def _native_splits(port, ctx, rank):
    group = (HierarchicalGroup(ctx, devices=[]) if port
             else JaxGroup(ctx, devices=[]))
    assert group._hier_algo == "hier"

    def arr(values, dtype=np.float32):
        a = np.asarray(values, dtype=dtype)
        return torch.from_numpy(a) if port else a

    out = [raw(group.allreduce(arr([rank + 1.0] * 512))),
           raw(group.broadcast(arr([float(rank)] * 16), root=3)),
           raw(group.allgather(arr([float(rank)] * 4)))]
    group.barrier()
    local = group.local_group()
    leaders = group.leader_group()
    out.append((local.size, local.group_tag() != ""))
    out.append(raw(local.allreduce(arr([1.0] * 8))))
    if ctx.topology()["is_leader"]:
        out.append((leaders.size, raw(leaders.allreduce(arr([1.0] * 8)))))
    else:
        out.append(leaders)
    return out


def test_host_plane_on_native_splits():
    """Four processes presenting as 2 hosts x 2: the host hop runs the
    native hierarchical schedules, and the intra-host and leader
    communicators come from native splits."""
    ref = jax_spawn_topo(4, 2, lambda c, r: _native_splits(False, c, r),
                         timeout=90)
    got = spawn(4, lambda c, r: _native_splits(True, c, r), timeout=90,
                host_of=lambda r: r // 2)
    assert got == ref
    assert got[0][0] == raw(torch.full((512,), 10.0))
    assert got[1][-1] is None and got[2][-1][0] == 2


def test_cross_process():
    """Two OS processes, four CPU "devices" each, over a FileStore; the
    host hop of a 256 KiB payload rides the shm plane."""
    store = tempfile.mkdtemp()
    body = textwrap.dedent("""
        import sys
        sys.path.insert(0, {repo!r})
        import torch
        import gloo_tpu_torch
        from gloo_tpu_torch.tpu import HierarchicalGroup

        rank = int(sys.argv[1])
        ctx = gloo_tpu_torch.Context(rank, 2, timeout=60)
        ctx.connect_full_mesh(gloo_tpu_torch.FileStore({store!r}),
                              gloo_tpu_torch.Device())
        group = HierarchicalGroup(ctx, devices=["cpu"] * 4)
        partials = [torch.full((1 << 16,), float(rank * 4 + d + 1))
                    for d in range(4)]
        out = group.allreduce(partials)
        assert float(out[0][0]) == 36.0 and float(out[3][-1]) == 36.0
        assert ctx.shm_stats()["tx_bytes"] > 0
        group.barrier()
        ctx.close()
        print("HIER-OK")
    """).format(repo=str(REPO), store=store)
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for (stdout, stderr), p in zip(outs, procs):
        assert p.returncode == 0, (stdout, stderr[-3000:])
        assert "HIER-OK" in stdout


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))


def _linear_loss(model, batch):
    x, y = batch
    return ((x @ model.w + model.b - y) ** 2).mean()


def _linear_data(rank, steps=30):
    rng = np.random.RandomState(rank)
    w_true = np.arange(1.0, 5.0).reshape(4, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.rand(8, 4).astype(np.float32)
        out.append((x, x @ w_true + 0.5))
    return out


def _linear_run(port, ctx, rank):
    if port:
        group = HierarchicalGroup(ctx, devices=_cpus(2))
        replicas = [_Linear(), _Linear()]
        opts = [torch.optim.SGD(m.parameters(), lr=0.1) for m in replicas]
        step = make_hierarchical_ddp(_linear_loss, group)
        losses = [float(step(replicas, opts, (torch.from_numpy(x),
                                               torch.from_numpy(y))))
                  for x, y in _linear_data(rank)]
        group.barrier()
        assert all(torch.equal(a, b) for a, b in zip(
            replicas[0].parameters(), replicas[1].parameters()))
        return (losses, replicas[0].w.detach().numpy().ravel().copy(),
                replicas[0].b.detach().numpy().copy())
    group = JaxGroup(ctx, devices=_jax_devices(rank, 2))

    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)

    opt = optax.sgd(0.1)
    params = {"w": jnp.zeros((4, 1)), "b": jnp.zeros((1,))}
    opt_state = opt.init(params)
    step = jax_hier_ddp(loss_fn, opt, group)
    losses = []
    for x, y in _linear_data(rank):
        params, opt_state, loss = step(params, opt_state, (x, y))
        losses.append(float(loss))
    group.barrier()
    return (losses, np.asarray(params["w"]).ravel(),
            np.asarray(params["b"]))


def test_hierarchical_ddp_linear_model_matches_the_reference():
    """The reference test's model and data, 2 hosts x 2 local ranks, 30
    SGD(0.1) steps: losses and parameters to rtol 1e-5 of gloo_tpu's,
    parameters bitwise equal across hosts, the loss down tenfold."""
    ref = jax_spawn(2, lambda c, r: _linear_run(False, c, r), timeout=120,
                    context_timeout=60)
    got = spawn(2, lambda c, r: _linear_run(True, c, r), timeout=120)
    for (losses, w, b), (ref_losses, ref_w, ref_b) in zip(got, ref):
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
        np.testing.assert_allclose(w, ref_w, rtol=1e-5)
        np.testing.assert_allclose(b, ref_b, rtol=1e-5)
        assert losses[-1] < losses[0] * 0.1
    np.testing.assert_array_equal(got[0][1], got[1][1])
    np.testing.assert_array_equal(got[0][2], got[1][2])


def test_flagship_two_hosts_match_the_four_rank_ddp_step():
    """hier_ddp_entry on the CPU, 2 hosts x 2 local ranks of 2 sequences,
    against ddp_train_entry's 4 ranks of 2 sequences: the first step's
    loss (the hosts' mean) and every replica's gradient to rtol 1e-5 (and
    an atol of 1e-5 of the gradient's largest entry: entries near zero
    carry the other sum order's rounding), replicas bitwise equal on
    both hosts."""
    store = tempfile.mkdtemp()
    got = [None, None]
    errors = []

    def host(rank):
        try:
            step, (replicas, opts, batch) = hier_ddp_entry(rank, 2, store,
                                                           "cpu")
            loss = float(step(replicas, opts, batch))
            got[rank] = (loss, [[p.grad.clone() for p in m.parameters()]
                                for m in replicas],
                         [p.detach().clone()
                          for p in replicas[0].parameters()])
            step.group.ctx.close()
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=host, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    step, (replicas, opts, batch) = ddp_train_entry("cpu")
    loss = float(step(replicas, opts, batch))
    want = [p.grad for p in replicas[0].parameters()]
    np.testing.assert_allclose((got[0][0] + got[1][0]) / 2, loss, rtol=1e-5)
    for _, grads, _ in got:
        for replica in grads:
            for g, w in zip(replica, want):
                np.testing.assert_allclose(
                    g.numpy(), w.numpy(), rtol=1e-5,
                    atol=1e-5 * float(w.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(got[0][2], got[1][2]))
    assert all(torch.equal(a, b) for g in got for a, b in
               zip(g[1][0], g[1][1]))


ENTRY_SCRIPT = textwrap.dedent("""
    import hashlib, json, sys, tempfile
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(2)
    from gloo_tpu_torch.entry import hier_ddp_entry, host_ddp_entry

    rank, hier_store, host_store = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    def digest(params):
        h = hashlib.sha256()
        for p in params:
            h.update(p.detach().contiguous().view(torch.uint8).numpy())
        return h.hexdigest()

    step, (replicas, opts, batch) = hier_ddp_entry(rank, 2, hier_store,
                                                   "cpu")
    hier = [float(step(replicas, opts, batch)) for _ in range(2)]
    hier_digest = digest(replicas[0].parameters())
    assert digest(replicas[1].parameters()) == hier_digest
    step.group.ctx.close()
    step, (model, opt, batch) = host_ddp_entry(rank, 2, host_store, "cpu")
    host = [float(step(model, opt, batch)) for _ in range(2)]
    step.sync.context.close()
    print(json.dumps({{"hier": hier, "hier_digest": hier_digest,
                      "host": host,
                      "host_digest": digest(model.parameters())}}))
""")


def test_entries_on_the_cpu_in_two_processes():
    """hier_ddp_entry and host_ddp_entry(bucketed) with device="cpu" in two
    OS processes: 2 steps each, finite losses, parameters bitwise equal
    across the processes."""
    import json

    stores = [tempfile.mkdtemp(), tempfile.mkdtemp()]
    script = ENTRY_SCRIPT.format(repo=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               *stores], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for (stdout, stderr), p in zip(outs, procs):
        assert p.returncode == 0, stderr[-3000:]
    res = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    assert res[0]["hier_digest"] == res[1]["hier_digest"]
    assert res[0]["host_digest"] == res[1]["host_digest"]
    for r in res:
        assert np.isfinite(r["hier"] + r["host"]).all()


@pytest.mark.parametrize("example", ["torch_host_ddp.py",
                                     "torch_hierarchical.py"])
def test_example_runs_on_cpu(example):
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / example), "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "example OK" in out.stdout
