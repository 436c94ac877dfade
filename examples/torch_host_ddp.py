"""Multi-process data-parallel training over the host plane, on the
PyTorch/CUDA port: an MLP trained data-parallel, its gradients averaged
through the C++ allreduce (HostGradSync); CUDA gradients are staged
through pinned host memory.

The counterpart of examples/example_host_ddp.py. It launches its own
processes, one rank each, which rendezvous over a FileStore:
    python examples/torch_host_ddp.py                # 2 processes, one card
    python examples/torch_host_ddp.py --device cpu   # on the CPU
    python examples/torch_host_ddp.py --ranks 4 --bucketed
"""

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import gloo_tpu_torch  # noqa: E402
from gloo_tpu_torch.models import MLP  # noqa: E402
from gloo_tpu_torch.parallel import HostGradSync  # noqa: E402

STEPS = 50


def worker(args):
    if args.device == "cpu":
        torch.set_num_threads(1)  # the processes share the machine's cores
    ctx = gloo_tpu_torch.Context(args.rank, args.ranks, timeout=60.0)
    ctx.connect_full_mesh(gloo_tpu_torch.FileStore(args.store),
                          gloo_tpu_torch.Device())
    sync = HostGradSync(ctx, bucketed=args.bucketed)
    dev = torch.device(args.device)
    # The same seed on every rank: the replicas start equal.
    model = MLP([16, 64, 1], device=dev).init(
        torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    rng = np.random.RandomState(1000 + args.rank)  # each rank its own shard
    for step in range(STEPS):
        x = torch.as_tensor(rng.randn(32, 16).astype(np.float32), device=dev)
        y = x.sum(1, keepdim=True) * 0.1
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(x, y)
        loss.backward()
        params = dict(model.named_parameters())
        mean = sync.average({k: p.grad for k, p in params.items()})
        for k, p in params.items():
            p.grad = mean[k]
        optimizer.step()
        if args.rank == 0 and step % 10 == 0:
            print(f"step {step:3d} loss {loss.item():.4f}")
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = ctx.allgather(flat)
    assert all(torch.equal(every[0], every[r]) for r in range(args.ranks))
    ctx.barrier()
    ctx.close()
    if args.rank == 0:
        print(f"replicas bitwise equal on {args.ranks} ranks after {STEPS} "
              f"steps")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--bucketed", action="store_true")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        worker(args)
        return
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    store = tempfile.mkdtemp(prefix="torch_host_ddp-")
    cmd = [sys.executable, __file__, "--device", args.device, "--ranks",
           str(args.ranks), "--store", store] + (
        ["--bucketed"] if args.bucketed else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)])
             for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"a rank failed: exit codes {codes}")
    print("host ddp example OK")


if __name__ == "__main__":
    main()
