"""The port's acceptance run: the host plane, the two-level DDP, a
SIGKILL, the rebuild and the resume from a checkpoint, in one job.

Counterpart of tests/test_e2e_acceptance.py over torch tensors. Four
worker processes, each a simulated host with a 2-rank CPU world:

  1. ``gloo_tpu_torch.init_from_env()`` from torchrun-style variables
     (rank 0 serves the TcpStore);
  2. ``make_hierarchical_ddp`` training of the reference's least-squares
     model with ``torch.optim.SGD(0.1)``: the gradient mean over the local
     ranks (the ring allreduce's CPU twin), then across the processes
     over the C++ host plane; rank 0 saves a checkpoint every 2 steps;
  3. rank 3 SIGKILLs itself at step 6;
  4. the survivors catch the IoError, form a 3-process group with
     ``rebuild_after_failure`` through the same TcpStore, and resume from
     ``StepCheckpointer.load_latest`` to step 12, with their final
     parameters bitwise equal.

The same run at the flagship's width, as chip_smoke.py's phase 29 drives
it on the card, runs here on the CPU through ``elastic_train_entry``
(three processes, one SIGKILLed at step 4), and so does the example
``examples/torch_elastic_checkpoint.py`` (run_elastic over the
flagship). The workers split the machine's cores: several processes'
intra-op thread pools otherwise oversubscribe them.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 4
LOCAL = 2
KILL_RANK = 3          # never rank 0: it serves the TcpStore
KILL_STEP = 6
TOTAL_STEPS = 12
CKPT_EVERY = 2

WORKER = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    import gloo_tpu_torch
    from gloo_tpu_torch.checkpoint import StepCheckpointer
    from gloo_tpu_torch.resilience import rebuild_after_failure
    from gloo_tpu_torch.tpu import HierarchicalGroup, make_hierarchical_ddp

    LOCAL, KILL_RANK, KILL_STEP = {local}, {kill_rank}, {kill_step}
    TOTAL_STEPS, CKPT_EVERY = {total_steps}, {ckpt_every}
    ckpt_dir = sys.argv[1]

    ctx, server = gloo_tpu_torch.init_from_env(timeout=60.0)
    rank, size = ctx.rank, ctx.size
    print(f"rank {{rank}}: bootstrapped {{rank}}/{{size}}", flush=True)

    # The reference's least-squares model, so that SGD lowers the loss.
    w_true = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    rng = np.random.RandomState(1234 + rank)

    def make_batch():
        x = rng.randn(4, 8).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(x @ w_true)

    class LeastSquares(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(8))

    def loss_fn(model, batch):
        x, y = batch
        return (x @ model.w - y).square().mean()

    replicas = [LeastSquares() for _ in range(LOCAL)]

    def optimizers_for(models):
        return [torch.optim.SGD(m.parameters(), lr=0.1) for m in models]

    def make_step(c):
        group = HierarchicalGroup(c, devices=["cpu"] * LOCAL)
        return make_hierarchical_ddp(loss_fn, group)

    optimizers = optimizers_for(replicas)
    step_fn = make_step(ctx)
    ckpt = StepCheckpointer(ckpt_dir, keep=3)

    step = 0
    rebuilt = False
    first_loss = None
    while step < TOTAL_STEPS:
        if rank == KILL_RANK and step == KILL_STEP:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            loss = step_fn(replicas, optimizers, make_batch())
        except gloo_tpu_torch.core.IoError as exc:
            assert not rebuilt, "a second failure is not part of this run"
            print(f"rank {{rank}}: step {{step}} failed "
                  f"({{str(exc)[:40]}}); rebuilding", flush=True)
            store = gloo_tpu_torch.TcpStore(
                os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]))
            ctx.close()
            ctx, rank, size = rebuild_after_failure(
                store, gloo_tpu_torch.Device(), old_rank=rank,
                old_size=size, generation=1, settle=3.0, timeout=60.0)
            assert ctx is not None and size == {size} - 1, (rank, size)
            step_fn = make_step(ctx)
            ck_step, state = ckpt.load_latest(
                {{"w": replicas[0].w.detach(), "step": 0}})
            assert ck_step is not None, "no committed checkpoint found"
            with torch.no_grad():
                for m in replicas:
                    m.w.copy_(state["w"])
            optimizers = optimizers_for(replicas)
            step = int(state["step"])
            rebuilt = True
            print(f"rank {{rank}}: resumed from step {{ck_step}} "
                  f"(train step {{step}}) in world of {{size}}", flush=True)
            continue
        loss = float(loss)
        if first_loss is None:
            first_loss = loss
        if rank == 0 and step % CKPT_EVERY == 0:
            # force=True: the replay after the resume saves steps again.
            ckpt.save(step, {{"w": replicas[0].w.detach().clone(),
                             "step": step}}, force=True)
        step += 1

    assert rebuilt, "the failure and rebuild never ran"
    assert loss < first_loss, (first_loss, loss)
    final = replicas[0].w.detach().clone()
    assert all(torch.equal(m.w, final) for m in replicas[1:])
    gathered = ctx.allgather(final)
    for row in gathered:
        assert torch.equal(row, final), "parameters diverged"
    ctx.barrier()
    print(f"rank {{rank}}: DONE loss {{first_loss:.4f}} -> {{loss:.4f}}",
          flush=True)
""").format(repo=_REPO, local=LOCAL, kill_rank=KILL_RANK,
            kill_step=KILL_STEP, total_steps=TOTAL_STEPS,
            ckpt_every=CKPT_EVERY, size=SIZE)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_acceptance_run():
    ckpt_dir = tempfile.mkdtemp()
    port = _free_port()
    procs = []
    for r in range(SIZE):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(SIZE),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, ckpt_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    assert codes[KILL_RANK] == -signal.SIGKILL, (codes, outs[KILL_RANK])
    for r in range(SIZE):
        if r == KILL_RANK:
            continue
        assert codes[r] == 0, (r, codes, outs[r][-2000:])
        assert "resumed from step" in outs[r], (r, outs[r][-2000:])
        assert "DONE" in outs[r], (r, outs[r][-2000:])


# elastic_train_entry's run: process ENTRY_KILL[0] dies at step
# ENTRY_KILL[1], one trained step after the checkpoint of step 2, so the
# restore rolls the survivors back; they train steps 0 to ENTRY_STEPS - 1.
ENTRY_RANKS = 3
ENTRY_KILL = (2, 4)
ENTRY_STEPS = 9

ENTRY_WORKER = textwrap.dedent("""
    import json, os, signal, sys
    sys.path.insert(0, {repo!r})
    import torch
    from gloo_tpu_torch.checkpoint import state_digest
    from gloo_tpu_torch.core import IoError
    from gloo_tpu_torch.entry import elastic_train_entry

    rank, size, ckpt_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    trainer = elastic_train_entry(rank, size, ckpt_dir, "cpu")
    kv = trainer.store()
    losses, step, resumed = {{}}, 0, None
    while step < {steps}:
        if (rank, step) == {kill}:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            losses[step] = float(trainer.step(step))
        except IoError:
            assert resumed is None, "a second failure"
            assert trainer.rebuild(generation=1, min_size=2, settle=3.0)
            newest = max(trainer.checkpointer.steps())
            before = state_digest(trainer.state(newest))
            at, state = trainer.restore()
            want = kv.get(f"sha256/{{at}}").decode()
            assert at == newest and before != want, (at, newest)
            assert state_digest(state) == want, at
            for i in range(len(trainer.replicas)):
                assert state_digest(trainer.state(at, i)) == want, (at, i)
            step = resumed = at + 1
            continue
        if trainer.save(step):
            kv.set(f"sha256/{{step}}",
                   state_digest(trainer.state(step)).encode())
        step += 1
    flat = torch.cat([p.detach().reshape(-1)
                      for p in trainer.replicas[0].parameters()])
    rows = trainer.ctx.allgather(flat)
    trainer.ctx.barrier()
    print(json.dumps({{"resumed": resumed, "size": trainer.ctx.size,
                      "losses": [losses[0], losses[{steps} - 1]],
                      "equal": all(torch.equal(r, flat) for r in rows),
                      "saved": trainer.checkpointer.steps()}}))
""").format(repo=_REPO, steps=ENTRY_STEPS, kill=ENTRY_KILL)


def test_elastic_train_entry_recovers_on_cpu():
    """The flagship's acceptance run on the CPU: the survivors rebuild to
    size 2, roll back to step 2's checkpoint (the loaded state and then
    every local replica and Adam with the sha256 that rank 0 saved, where
    the live state had moved past it), train on with a falling loss, and
    end with bitwise-equal parameters."""
    ckpt_dir = tempfile.mkdtemp()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", ENTRY_WORKER, str(r), str(ENTRY_RANKS),
         ckpt_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), OMP_NUM_THREADS="2"))
        for r in range(ENTRY_RANKS)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    victim = ENTRY_KILL[0]
    assert procs[victim].returncode == -signal.SIGKILL, outs[victim]
    for r in range(ENTRY_RANKS):
        if r == victim:
            continue
        assert procs[r].returncode == 0, (r, outs[r][1][-3000:])
        res = json.loads(outs[r][0].strip().splitlines()[-1])
        assert res["resumed"] == 3 and res["size"] == ENTRY_RANKS - 1, res
        assert res["equal"], res
        assert res["losses"][1] < res["losses"][0], res
        assert res["saved"] == [6, 8], res  # keep=2


def test_elastic_checkpoint_example_runs_on_cpu():
    repo = pathlib.Path(_REPO)
    out = subprocess.run(
        [sys.executable, str(repo / "examples" /
                             "torch_elastic_checkpoint.py"), "--device",
         "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "example OK" in out.stdout
