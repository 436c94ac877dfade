"""Elastic training with checkpoints, on the PyTorch/CUDA port: three
processes train the flagship transformer (one replica each, Adam, the
gradients averaged with the epoch's GradientBucketer) under
gloo_tpu_torch.elastic.run_elastic, and one of them is SIGKILLed mid-run.
The survivors' agents see its lease expire, agree on the next epoch,
rebuild a 2-process group, reload the newest committed step from the
port's StepCheckpointer (torch.save into a directory per step, an atomic
rename), and train on to the last step, their parameters bitwise equal.

The counterpart of examples/example_elastic_checkpoint.py, with the
automatic recovery of run_elastic in place of the manual one. It launches
its own processes, which rendezvous over a FileStore:
    python examples/torch_elastic_checkpoint.py                # one card
    python examples/torch_elastic_checkpoint.py --device cpu   # the CPU
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

import gloo_tpu_torch  # noqa: E402
from gloo_tpu_torch import elastic  # noqa: E402
from gloo_tpu_torch.checkpoint import (StepCheckpointer,  # noqa: E402
                                       state_digest)
from gloo_tpu_torch.entry import ELASTIC_KEEP, elastic_step_fn  # noqa: E402

RANKS = 3
STEPS = 6
VICTIM, KILL_STEP = 2, 3
# Short leases: a member is declared dead 5 s after its last renewal.
LEASE_ENV = {"TPUCOLL_LEASE_MS": "250", "TPUCOLL_LEASE_GRACE": "5000"}


def worker(args):
    if args.device == "cpu":
        torch.set_num_threads(1)  # the processes share the machine's cores
    ckpt = StepCheckpointer(os.path.join(args.store, "ckpt"),
                            keep=ELASTIC_KEEP)
    step_fn, template = elastic_step_fn(args.rank, ckpt, args.device)

    def step(ectx, i, state):
        if args.rank == VICTIM and i == KILL_STEP:
            os.kill(os.getpid(), signal.SIGKILL)
        state = step_fn(ectx, i, state)
        if ectx.rank == 0:
            print(f"step {i} in epoch {ectx.epoch()} of size {ectx.size}",
                  flush=True)
        return state

    store = gloo_tpu_torch.FileStore(os.path.join(args.store, "rdv"))
    summary = elastic.run_elastic(
        step, store=store, device=gloo_tpu_torch.Device(), rank=args.rank,
        world_size=RANKS,
        steps=STEPS, min_size=2, checkpointer=ckpt, template=template,
        timeout=120.0)
    print(json.dumps({"rebuilds": summary["rebuilds"],
                      "sizes": [e["size"] for e in summary["epochs"]],
                      "params": state_digest(list(
                          step_fn.model.parameters()))}))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        worker(args)
        return
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    store = tempfile.mkdtemp(prefix="torch_elastic_checkpoint-")
    os.makedirs(os.path.join(store, "rdv"))
    cmd = [sys.executable, __file__, "--device", args.device, "--store",
           store]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE, text=True,
                              env=dict(os.environ, **LEASE_ENV))
             for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    codes = [p.returncode for p in procs]
    if codes[VICTIM] != -signal.SIGKILL or any(
            c for r, c in enumerate(codes) if r != VICTIM):
        raise SystemExit(f"unexpected exit codes {codes}")
    results = []
    for r, out in enumerate(outs):
        if r == VICTIM:
            continue
        *steps, last = out.strip().splitlines()
        for line in steps:
            print(line)
        results.append(json.loads(last))
    if len({res["params"] for res in results}) != 1 or any(
            res["rebuilds"] != 1 or res["sizes"] != [RANKS, RANKS - 1]
            for res in results):
        raise SystemExit(f"recovery went wrong: {results}")
    print(f"process {VICTIM} killed at step {KILL_STEP}; the survivors "
          f"rebuilt once, resumed from the checkpoint, and ended with "
          f"bitwise-equal parameters")
    print("elastic checkpoint example OK")


if __name__ == "__main__":
    main()
