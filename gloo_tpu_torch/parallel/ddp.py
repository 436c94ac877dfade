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
bitwise identical step after step. ``local_grad_mean`` is that stage
alone, which the two-level step of gloo_tpu_torch.tpu.hierarchical shares.

Host plane: ``HostGradSync`` averages gradient trees of torch tensors
across OS processes with the C++ allreduce of gloo_tpu_torch.core, the
role the reference plays as PyTorch's ProcessGroup backend for DDP.
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


def local_grad_mean(loss_fn: Callable, mesh: Mesh, axis: str = "data"):
    """The local stage of a data-parallel step: stage(replicas, optimizers,
    batch) -> (mean, params, numel).

    It zeroes every replica's gradients, runs each replica's forward and
    backward on its part of `batch` (every leaf split into n =
    mesh.shape[axis] equal parts along dim 0), puts each rank's gradients
    and loss into row r of one flat f32 world buffer, and sums the rows of
    each ring with one ring allreduce (B3) divided by n. `mean` is that
    (ranks, buffer_width) buffer: numel gradient means, then the loss mean.
    `params` lists each replica's parameters."""
    n = mesh.shape[axis]
    my = mesh.ring_index(axis)

    def stage(replicas: Sequence[torch.nn.Module],
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
        return mean, params, numel

    return stage


def apply_grad_mean(mean: torch.Tensor, params, optimizers) -> None:
    """Makes each replica's .grad a view of its row of `mean` and steps
    its optimizer."""
    for r, opt in enumerate(optimizers):
        offset = 0
        for p in params[r]:
            p.grad = mean[r, offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        opt.step()


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
    stage = local_grad_mean(loss_fn, mesh, axis)

    def step(replicas: Sequence[torch.nn.Module],
             optimizers: Sequence[torch.optim.Optimizer], batch):
        mean, params, numel = stage(replicas, optimizers, batch)
        apply_grad_mean(mean, params, optimizers)
        return mean[0, numel].clone()

    return step


def _flatten(tree):
    """(leaves, rebuild) of a tree of dicts, lists and tuples, dict keys
    sorted (jax.tree.flatten's order)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]
    kind = type(tree)

    def rebuild(leaves):
        out, off = [], 0
        for (_, sub), k in zip(parts, sizes):
            out.append(sub(leaves[off:off + k]))
            off += k
        if keys is not None:
            return dict(zip(keys, out))
        return kind(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def _divide(t: torch.Tensor, size: int) -> torch.Tensor:
    """t / size as numpy divides (gloo_tpu/parallel/ddp.py:123): in the
    tensor's float dtype, an integer dtype through float64 and cast back
    (the truncated mean)."""
    if t.is_floating_point():
        return t / size
    return (t.double() / size).to(t.dtype)


class HostGradSync:
    """Average gradient trees across processes via the host data plane.

    Counterpart of gloo_tpu/parallel/ddp.py:63. Each training process
    builds a connected gloo_tpu_torch.Context, computes its local
    gradients (torch tensors on the CPU or a card), then calls
    ``average(grads)`` before the optimizer step: allreduce(SUM), then a
    division by the world size. The result is on the gradients' device.

    bucketed=True switches to the async engine and the gradient bucketer:
    leaves are packed into per-dtype buckets (25 MiB by default) issued
    asynchronously. Construction is then a collective (it forks lane
    sub-contexts), as is every average() call. The two arms round
    differently: the sequential one divides by the size, the bucketed one
    multiplies by 1/size (each as the reference does)."""

    def __init__(self, context, bucketed: bool = False,
                 bucket_bytes=None, lanes=None, wire=None):
        """wire: opt-in wire compression for float32 gradients ("q8",
        "bf16", "lossy"); other leaves always ride the lossless path."""
        self.context = context
        self._tag = 1 << 20  # leave low tags to the application
        self._bucketer = None
        self._wire = wire
        if bucketed:
            from gloo_tpu_torch.bucketer import GradientBucketer

            engine = context.async_engine(lanes=lanes)
            self._bucketer = GradientBucketer(
                engine, bucket_bytes=bucket_bytes, average=True,
                wire=wire)

    def average(self, grads):
        """The mean of `grads` (a dict, list or tuple of tensors, possibly
        nested) over the context's ranks, as the same structure of new
        tensors; the caller's tensors are left unchanged."""
        size = self.context.size
        leaves, rebuild = _flatten(grads)
        with annotate("gloo_tpu.ddp.host_grad_sync"):
            copies = [leaf.detach().clone(
                memory_format=torch.contiguous_format) for leaf in leaves]
            if self._bucketer is not None:
                for t in copies:
                    self._bucketer.add(t)
                self._bucketer.finish()  # copies now hold the means
                return rebuild(copies)
            out = []
            for i, t in enumerate(copies):
                wire = self._wire if t.dtype == torch.float32 else None
                self.context.allreduce(t, op="sum", tag=self._tag + i,
                                       wire=wire)
                out.append(_divide(t, size))
            return rebuild(out)
