"""Failure recovery on the PyTorch/CUDA port: survivors rebuild the group
after a rank dies.

The counterpart of examples/example_recovery.py. Three processes over a
FileStore, allreducing torch tensors on --device (CUDA tensors are staged
through pinned host memory); rank 2 SIGKILLs itself at step 10. The
survivors see the failure (IoError within milliseconds), re-rendezvous
through gloo_tpu_torch.resilience and go on in a world of 2.
    python examples/torch_recovery.py              # on the card
    python examples/torch_recovery.py --device cpu # CPU tensors
"""

import argparse
import os
import signal
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

SIZE = 3
STEPS = 100
KILL = (2, 10)  # (rank, step) of the simulated hard failure
WORKER_TIMEOUT = 300


def worker(rank, store_dir, dev):
    import gloo_tpu_torch
    from gloo_tpu_torch.resilience import rebuild_after_failure

    size = SIZE
    store = gloo_tpu_torch.FileStore(store_dir)
    ctx = gloo_tpu_torch.Context(rank, size, timeout=10.0)
    ctx.connect_full_mesh(store, gloo_tpu_torch.Device())

    grads = torch.full((1 << 16,), float(rank + 1), device=dev)
    for step in range(STEPS):
        if (rank, step) == KILL:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            ctx.allreduce(grads, timeout=2.0)
            want = size * (size + 1) / 2
            if float(grads[0]) != want:
                raise AssertionError(f"step {step}: allreduce gave "
                                     f"{float(grads[0])}, not {want}")
        except gloo_tpu_torch.IoError as exc:
            print(f"rank {rank}: step {step} failed ({str(exc)[:40]}); "
                  "rebuilding", flush=True)
            ctx, rank2, size2 = rebuild_after_failure(
                store, gloo_tpu_torch.Device(), old_rank=rank, old_size=size,
                generation=1, settle=3.0, timeout=30.0)
            if ctx is None:
                raise SystemExit(f"rank {rank}: the rebuild left no group")
            print(f"rank {rank} -> {rank2}/{size2}; resuming", flush=True)
            rank, size = rank2, size2
        grads.fill_(float(rank + 1))
    ctx.close()
    print(f"rank {rank}: finished {STEPS} steps in world of {size}",
          flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // SIZE))
        worker(args.rank, args.store, torch.device(args.device))
        return
    from gloo_tpu_torch.device import resolve_device

    resolve_device(args.device)
    store = tempfile.mkdtemp(prefix="torch_recovery-")
    cmd = [sys.executable, os.path.abspath(__file__), "--device",
           args.device, "--store", store]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(SIZE)]
    try:
        codes = [p.wait(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    killed = KILL[0]
    if codes[killed] != -signal.SIGKILL or any(
            c for r, c in enumerate(codes) if r != killed):
        raise SystemExit(f"exit codes {codes}: rank {killed} must end by "
                         f"its SIGKILL and the others with 0")
    print("recovery example: OK")


if __name__ == "__main__":
    main()
