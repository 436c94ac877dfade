"""FSDP + long-context tour on the PyTorch/CUDA port: ZeRO-3-style sharded
training and two sequence-parallel attention recipes (ring, Ulysses),
over a world of ranks on one card.

The counterpart of examples/example_fsdp_long_context.py:
    python examples/torch_fsdp_long_context.py              # on the card
    python examples/torch_fsdp_long_context.py --device cpu # plain twins
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gloo_tpu_torch.models import MLP  # noqa: E402
from gloo_tpu_torch.parallel import (make_fsdp_train_step,  # noqa: E402
                                     ring_attention, shard_params,
                                     ulysses_attention, unshard_params)
from gloo_tpu_torch.parallel.dp_tp import world_batch  # noqa: E402
from gloo_tpu_torch.tpu import make_mesh  # noqa: E402

RANKS = 4


def fsdp_demo(mesh):
    n = mesh.shape["data"]
    shell = MLP([16, 64, 1], device="meta")
    model = MLP([16, 64, 1], device=mesh.device).init(
        torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    rng = np.random.RandomState(0)
    xs = torch.as_tensor(rng.randn(8 * n, 16).astype(np.float32),
                         device=mesh.device)
    ys = torch.sin(xs.sum(-1, keepdim=True))

    def loss_fn(p, batch):
        x, y = batch
        return ((torch.func.functional_call(shell, p, (x,)) - y) ** 2).mean()

    step = make_fsdp_train_step(loss_fn, params, "data", lr=0.05, mesh=mesh)
    sharded = shard_params(params, "data", mesh=mesh)  # 1/n per rank
    batch = (world_batch(xs, mesh), world_batch(ys, mesh))
    for _ in range(20):
        sharded, loss = step(sharded, batch)
    full = unshard_params(sharded, params, "data", mesh=mesh)
    assert all(torch.equal(v[0], v[r]) for v in full.values()
               for r in range(n))
    print(f"fsdp      : 20 SGD steps, final global loss {float(loss[0]):.4f}"
          f" (params sharded 1/{n} per rank, grads reduce-scattered by the "
          "allgather's VJP)")


def sequence_parallel_demo(mesh):
    n = mesh.shape["data"]
    b, h, t, d = 1, n, 16 * n, 32
    rng = np.random.RandomState(1)
    q = torch.as_tensor(rng.randn(b, h, t, d).astype(np.float32),
                        device=mesh.device)
    # The sequence split over the ranks: (n, b, h, t / n, d).
    qw = q.view(b, h, n, t // n, d).permute(2, 0, 1, 3, 4).contiguous()
    with torch.no_grad():
        r = ring_attention(qw, qw, qw, "data", mesh=mesh)
        u = ulysses_attention(qw, qw, qw, "data", mesh=mesh)
    print(f"ring vs ulysses attention: max delta "
          f"{float((r - u).abs().max()):.2e} (same math, a shift ring vs "
          "one all-to-all per direction)")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dev = torch.device(args.device)
    mesh = make_mesh({"data": RANKS}, devices=[dev] * RANKS)
    print(f"mesh: {mesh.shape} on {dev}")
    fsdp_demo(mesh)
    sequence_parallel_demo(mesh)
    print("fsdp + long-context example OK")


if __name__ == "__main__":
    main()
