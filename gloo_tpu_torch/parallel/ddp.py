"""Data-parallel training on the port's device plane.

Counterpart of the device-plane half of gloo_tpu/parallel/ddp.py
(``make_ddp_train_step``): the batch is split along dim 0 over the ranks of
a mesh axis, each rank's gradients are averaged over that axis, and the
optimizer runs on every replica. In the PyTorch idiom the state is one
``nn.Module`` replica and one optimizer per flat rank, all on the mesh's
card. After each replica's backward its gradients (and its loss) go into
row r of one flat f32 world buffer; one ring allreduce (kernel B3) sums the
rows of each ring, a division by the ring size makes the means, and each
replica's ``.grad`` becomes a view of its row. B3 forwards finished chunks
verbatim, so every rank's mean is bitwise the same and the replicas stay
bitwise identical step after step.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from gloo_tpu_torch.ops.ring import ring_allreduce
from gloo_tpu_torch.tpu.mesh import Mesh
from gloo_tpu_torch.utils.tracing import annotate

# Each rank's row is padded to a multiple of n * _ALIGN f32, so that every
# ring chunk is a whole number of the kernel's 16-byte vectors.
_ALIGN = 4


def buffer_width(numel: int, n: int) -> int:
    """f32 per rank of the step's world buffer: `numel` gradient values and
    the loss, padded to whole 16-byte vectors in each of the n chunks."""
    return -(-(numel + 1) // (n * _ALIGN)) * n * _ALIGN


def make_ddp_train_step(loss_fn: Callable, mesh: Mesh, axis: str = "data"):
    """Build step(replicas, optimizers, batch) -> loss with the gradient
    mean over `axis`.

    `loss_fn(model, batch)` consumes one rank's micro-batch: every leaf of
    `batch` is split into n = mesh.shape[axis] equal parts along dim 0, and
    rank r gets part (r's position along `axis`). `replicas` and
    `optimizers` hold one module and one optimizer per flat rank of the
    mesh. The step zeroes the gradients, runs each replica's forward and
    backward, averages gradients and losses with one ring allreduce, steps
    every optimizer, and returns the mean of the rank losses (a 0-d f32
    tensor, spmd.mean of the losses)."""
    n = mesh.shape[axis]
    my = mesh.ring_index(axis)

    def step(replicas: Sequence[torch.nn.Module],
             optimizers: Sequence[torch.optim.Optimizer], batch):
        ranks = mesh.size
        if len(replicas) != ranks or len(optimizers) != ranks:
            raise ValueError(f"need one replica and one optimizer per rank "
                             f"({ranks}); got {len(replicas)} and "
                             f"{len(optimizers)}")
        for leaf in batch:
            if leaf.shape[0] % n != 0:
                raise ValueError(f"batch dim {leaf.shape[0]} is not "
                                 f"divisible by the axis size {n}")
        parts = [leaf.chunk(n) for leaf in batch]
        params = [list(m.parameters()) for m in replicas]
        numel = sum(p.numel() for p in params[0])
        width = buffer_width(numel, n)
        buf = torch.empty((ranks, width), dtype=torch.float32,
                          device=mesh.device)
        buf[:, numel + 1:] = 0
        for r, (model, opt) in enumerate(zip(replicas, optimizers)):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, tuple(p[my[r]] for p in parts))
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params[r]]
            torch.cat([g.reshape(-1) for g in grads]
                      + [loss.detach().reshape(1)], out=buf[r, :numel + 1])
        with annotate("gloo_tpu.ddp.grad_sync"):
            mean = ring_allreduce(buf.view(ranks, n, -1), axis, mesh)
            mean = mean.view(ranks, width).div_(n)
        for r, opt in enumerate(optimizers):
            offset = 0
            for p in params[r]:
                p.grad = mean[r, offset:offset + p.numel()].view_as(p)
                offset += p.numel()
            opt.step()
        return mean[0, numel].clone()

    return step
