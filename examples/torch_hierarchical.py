"""Two-level data-parallel training across host processes, on the
PyTorch/CUDA port.

Each process stands for one host: a local world of ranks on its device
(gradients averaged by the ring allreduce kernel, B3, inside the step)
plus one host-plane rank. The host plane then averages the per-host means
through the C++ transport; processes of one machine exchange through the
shm payload rings.

The counterpart of examples/example_hierarchical.py. It launches its own
processes, which rendezvous over a FileStore:
    python examples/torch_hierarchical.py               # 2 "hosts", one card
    python examples/torch_hierarchical.py --device cpu  # on the CPU
"""

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

import gloo_tpu_torch  # noqa: E402
from gloo_tpu_torch.tpu import (HierarchicalGroup,  # noqa: E402
                                make_hierarchical_ddp)

LOCAL = 2
STEPS = 60


class TanhMLP(nn.Module):
    def __init__(self, device, hidden=8192):
        super().__init__()
        gen = torch.Generator().manual_seed(0)  # the same init everywhere
        self.w1 = nn.Parameter((torch.randn(8, hidden, generator=gen)
                                * 0.3).to(device))
        self.b1 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w2 = nn.Parameter((torch.randn(hidden, 1, generator=gen)
                                * 0.03).to(device))
        self.b2 = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def loss_fn(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def worker(args):
    if args.device == "cpu":
        torch.set_num_threads(1)  # the processes share the machine's cores
    ctx = gloo_tpu_torch.Context(args.rank, args.hosts, timeout=60.0)
    ctx.connect_full_mesh(gloo_tpu_torch.FileStore(args.store),
                          gloo_tpu_torch.Device())
    dev = torch.device(args.device)
    group = HierarchicalGroup(ctx, devices=[dev] * LOCAL)
    print(f"[host {args.rank}] local ranks: {len(group.devices)}, hosts: "
          f"{args.hosts}, shm pairs: {ctx.shm_stats()['active_pairs']}")
    replicas = [TanhMLP(dev) for _ in range(LOCAL)]
    # Adam at 1e-3: at the reference example's 1e-2 the 8192 output
    # weights overshoot together and the loss does not settle.
    optimizers = [torch.optim.Adam(m.parameters(), lr=1e-3)
                  for m in replicas]
    step = make_hierarchical_ddp(loss_fn, group)
    rng = np.random.RandomState(100 + args.rank)  # per-host data shard
    w_true = np.linspace(-1, 1, 8).reshape(8, 1).astype(np.float32)
    for it in range(STEPS):
        x = rng.rand(16, 8).astype(np.float32)
        y = (x @ w_true + 0.2).astype(np.float32)
        batch = (torch.as_tensor(x, device=dev), torch.as_tensor(y,
                                                                 device=dev))
        loss = step(replicas, optimizers, batch)
        if it % 20 == 0 or it == STEPS - 1:
            print(f"[host {args.rank}] step {it:3d} loss {float(loss):.5f}")
    flat = torch.cat([p.detach().reshape(-1)
                      for p in replicas[0].parameters()])
    every = group.allgather(flat)
    assert all(torch.equal(every[0], every[h]) for h in range(args.hosts))
    assert all(torch.equal(a, b) for m in replicas[1:]
               for a, b in zip(m.parameters(), replicas[0].parameters()))
    group.barrier()
    shm = ctx.shm_stats()
    print(f"[host {args.rank}] done; the host hop rode shm: "
          f"{shm['tx_bytes']} tx / {shm['rx_bytes']} rx bytes")
    ctx.close()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hosts", type=int, default=2)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--store", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        worker(args)
        return
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    store = tempfile.mkdtemp(prefix="torch_hierarchical-")
    cmd = [sys.executable, __file__, "--device", args.device, "--hosts",
           str(args.hosts), "--store", store]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)])
             for r in range(args.hosts)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"a host failed: exit codes {codes}")
    print("hierarchical example OK")


if __name__ == "__main__":
    main()
