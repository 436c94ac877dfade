"""Hierarchical collectives: the device plane and the host plane composed.

Counterpart of gloo_tpu/tpu/hierarchical.py. Independent per-host
processes, whose cards cannot form one program, are served as the
reference's CUDA host-workspace algorithms serve them
(gloo/cuda_collectives_host.h: local reduce, host ring, local broadcast):
per-device partials are reduced on the first local device, one copy
crosses to the host, the cross-host hop rides the C++ host plane
(gloo_tpu_torch.core.Context: TCP, or the shm payload rings between
processes of one machine), and the result returns to the local devices.

``make_hierarchical_ddp`` is the two-level data-parallel step: the local
ranks average their gradients with the ring allreduce kernel (B3) inside
the step, then the host plane averages the per-host means.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from gloo_tpu_torch.bucketer import scale_inplace
from gloo_tpu_torch.tpu.mesh import make_mesh

_COMBINE = {"sum": torch.add, "prod": torch.mul, "product": torch.mul,
            "max": torch.maximum, "min": torch.minimum}


class HierarchicalGroup:
    """Cross-host collectives over (local devices) x (host Context).

    ctx: a connected gloo_tpu_torch.Context, one rank per host process.
    devices: the process-local devices (default [torch.device("cuda")]; a
    world of ranks on one card repeats it, as make_mesh's devices do).

    A collective takes either a list of per-device tensors (same shape and
    dtype), the local partials, reduced on devices[0] first; or one
    tensor, this host's single contribution. The reference also rejects a
    jax array sharded over the local devices (its slices are not
    partials); a torch tensor carries no sharding, so that input has no
    counterpart here.
    """

    def __init__(self, ctx, devices: Optional[Sequence] = None,
                 tag: int = 0x51):
        self.ctx = ctx
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else [torch.device("cuda")])
        self.tag = tag
        # On a topology with several processes per machine the host hop
        # runs the native hierarchical schedules (intra-host shm plane,
        # leader-only exchange); on a flat one "hier" would degrade to the
        # flat schedules natively, and "auto" is what the reference picks.
        try:
            self._hier_algo = ("hier" if ctx.topology().get("non_flat")
                               else "auto")
        except Exception:  # not connected
            self._hier_algo = "auto"
        self._local_ctx = None
        self._leader_ctx = None
        self._planes_built = False

    # ---- native split planes ----

    def _ensure_planes(self):
        """The intra-host and leader sub-communicators, by native splits:
        a collective over the host context on first use."""
        if not self._planes_built:
            self._local_ctx = self.ctx.split_by_host(tag=0x51C0)
            topo = self.ctx.topology()
            self._leader_ctx = self.ctx.split(
                0 if topo["is_leader"] else -1, key=self.ctx.rank,
                tag=0x51C4)
            self._planes_built = True
        return self._local_ctx, self._leader_ctx

    def local_group(self):
        """Native intra-host communicator. A collective on first use."""
        return self._ensure_planes()[0]

    def leader_group(self):
        """Native leader communicator (one process per host), or None on
        the other processes. A collective on first use."""
        return self._ensure_planes()[1]

    # ---- local stage ----

    def _reduce_list(self, xs, op: str) -> torch.Tensor:
        """The partials folded in list order on devices[0], then one host
        copy."""
        combine = _COMBINE[op]
        dev0 = self.devices[0]
        acc = xs[0].to(dev0)
        for x in xs[1:]:
            acc = combine(acc, x.to(dev0))
        return acc.to("cpu", copy=True).contiguous()

    def _local_value(self, x, op: str = "sum") -> torch.Tensor:
        """One host copy of this process's contribution. Always a copy:
        the host collectives reduce in place, and the caller's tensor must
        not be overwritten."""
        if isinstance(x, (list, tuple)):
            if len(x) == 0:
                raise ValueError("empty input list")
            return self._reduce_list(list(x), op)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        return x.to("cpu", copy=True).contiguous()

    def _put_back(self, host: torch.Tensor, like):
        """A list in gives a list of per-device copies (the reference's
        local broadcast); a tensor in gives a tensor on its device."""
        if isinstance(like, (list, tuple)):
            return [host.to(d, copy=True) for d in self.devices]
        if isinstance(like, torch.Tensor):
            return host.to(like.device)
        return host

    # ---- hierarchical collectives ----

    def allreduce(self, x, op: str = "sum"):
        """Local reduce, host-plane allreduce, back to the local devices.
        Returns x's structure: list in, per-device list out; tensor in,
        tensor on its device out."""
        host = self._local_value(x, op)
        self.ctx.allreduce(host.view(-1), op=op, tag=self.tag,
                           algorithm=self._hier_algo)
        return self._put_back(host, x)

    def mean(self, x):
        """allreduce(sum) / the total contribution count (hosts x local
        partials, allgathered so that uneven local counts stay right)."""
        nlocal = len(x) if isinstance(x, (list, tuple)) else 1
        counts = torch.tensor([nlocal], dtype=torch.int64)
        total = int(self.ctx.allgather(counts, tag=self.tag + 1).sum())
        out = self.allreduce(x, op="sum")
        scale = 1.0 / total
        if isinstance(out, list):
            return [scale_inplace(a, scale) for a in out]
        return scale_inplace(out, scale)

    def broadcast(self, x, root: int = 0):
        """Root host's value to every host's local devices."""
        host = self._local_value(x)
        self.ctx.broadcast(host.view(-1), root=root, tag=self.tag,
                           algorithm=self._hier_algo)
        return self._put_back(host, x)

    def allgather(self, x) -> torch.Tensor:
        """Each host's (locally reduced) contribution stacked: (H, ...) on
        the CPU of every host."""
        host = self._local_value(x)
        out = self.ctx.allgather(host.view(-1), tag=self.tag,
                                 algorithm=self._hier_algo)
        return out.view((self.ctx.size,) + tuple(host.shape))

    def barrier(self) -> None:
        self.ctx.barrier(tag=self.tag, algorithm=self._hier_algo)


def make_hierarchical_ddp(loss_fn: Callable, group: HierarchicalGroup,
                          mesh=None, axis: str = "local"):
    """Two-level DDP: step(replicas, optimizers, batch) -> loss.

    The local stage is make_ddp_train_step's (parallel/ddp.py): one
    replica and one optimizer per local rank of `mesh` (default
    {axis: len(group.devices)} over group.devices), each rank's forward
    and backward on its part of `batch`, one ring allreduce (B3) over the
    local ring and the division by its size. When the host context has
    more than one rank, rank 0's row of gradient means (one flat f32
    buffer, without the loss) then crosses to the host (a CUDA buffer is
    staged through pinned memory), one host-plane allreduce sums it over
    the hosts, and it is divided by their number (gloo_tpu/tpu/
    hierarchical.py:276-286). Every local rank's row takes the result and
    each optimizer steps. The loss returned is the local mean, as in the
    reference. The group is the step's attribute ``group``."""
    # parallel.ddp imports this package's mesh module, so it is imported
    # here rather than at the top.
    from gloo_tpu_torch.parallel.ddp import apply_grad_mean, local_grad_mean

    if mesh is None:
        mesh = make_mesh({axis: len(group.devices)}, devices=group.devices)
    stage = local_grad_mean(loss_fn, mesh, mesh.axis_names[0])

    def step(replicas, optimizers, batch):
        mean, params, numel = stage(replicas, optimizers, batch)
        if group.ctx.size > 1:
            flat = mean[0, :numel]
            group.ctx.allreduce(flat, tag=group.tag,
                                algorithm=group._hier_algo)
            flat.div_(group.ctx.size)
            mean[1:, :numel] = flat
        apply_grad_mean(mean, params, optimizers)
        return mean[0, numel].clone()

    step.group = group
    return step
