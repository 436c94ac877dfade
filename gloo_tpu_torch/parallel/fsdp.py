"""ZeRO-3 / FSDP-style fully-sharded data parallelism on world tensors.

Counterpart of gloo_tpu/parallel/fsdp.py. Every parameter lives flattened,
zero-padded and sharded over a mesh axis: rank r holds chunk (r's ring
index) of each leaf, a (P, chunk) world tensor. On a process mesh (the
reference under multi-process JAX) a process holds its local ranks' rows
only, (len(mesh.local_ranks), chunk), and the collectives below are their
cross-process instances. The step gathers each leaf
just in time with ``spmd.allgather`` (B4b, one launch per leaf), and the
backward produces gradients that are already sharded: the allgather's VJP
is the ring reduce-scatter (B4a, gloo_tpu_torch.ops.ring), the transpose
the reference recovers from ``lax.all_gather`` by autodiff. No separate
reduce-scatter pass is written anywhere.

Parameters are a dict of tensors (a state dict). There is no shard_map:
the loss is evaluated per rank on that rank's row of the gathered world
and its batch shard, and the ranks' backward flows into one B4a per leaf.

    sharded = shard_params(params, "data", mesh=mesh)
    step = make_fsdp_train_step(loss_fn, params, "data", mesh=mesh)
    sharded, loss = step(sharded, batch)           # repeat
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Axis, Mesh
from gloo_tpu_torch.utils.tracing import annotate


def shard_params(params: dict, axis: Axis, *, mesh: Mesh) -> dict:
    """Flatten each leaf, zero-pad it to a multiple of the axis size n, and
    keep each rank's 1/n chunk at its ring index: {name: (P, chunk)} world
    tensors on the mesh's device, in each leaf's dtype; on a process mesh
    the local ranks' rows, (len(mesh.local_ranks), chunk)."""
    n = mesh.axis_size(axis)
    index = mesh.ring_index(axis)
    my = torch.tensor([index[r] for r in mesh.local_ranks],
                      device=mesh.device)
    sharded = {}
    for name, p in params.items():
        flat = p.detach().reshape(-1).to(mesh.device)
        flat = F.pad(flat, (0, -flat.numel() % n))
        sharded[name] = flat.view(n, -1)[my]
    return sharded


def unshard_params(sharded: dict, template: dict, axis: Axis, *,
                   mesh: Mesh) -> dict:
    """All-gather every leaf back to its full shape: {name: (P, *shape)}
    world tensors (the local ranks' rows on a process mesh), every rank of
    a ring holding the whole leaf in the template's dtype. `template` maps
    each name to anything with the original .shape and .dtype (the
    parameters, or meta tensors)."""
    full = {}
    for name, piece in sharded.items():
        ref = template[name]
        with annotate("gloo_tpu.fsdp.unshard"):
            gathered = spmd.allgather(piece, axis, mesh=mesh)
        full[name] = gathered[:, :ref.numel()].reshape(
            len(mesh.local_ranks), *ref.shape).to(ref.dtype)
    return full


def make_fsdp_train_step(loss_fn: Callable, template: dict, axis: Axis,
                         lr: float = 1e-2, *, mesh: Mesh):
    """SGD train step over fully-sharded parameters.

    loss_fn(params, batch) -> 0-d local loss, where params is one rank's
    row of the gathered parameters ({name: tensor of the leaf's shape}) and
    batch that rank's row of the world batch (a tuple of (P, ...) world
    tensors, row r rank r's shard; on a process mesh the local ranks'
    rows). step(sharded, batch, step_lr=lr) returns (new sharded params,
    (P,) world tensor of the global mean loss, the local ranks' rows on a
    process mesh). The gradient of the summed local losses comes out of the
    allgather's VJP already reduce-scattered; divided by n it is the
    global-mean gradient, and the update touches 1/n of each leaf per rank.
    """
    # Shapes and dtypes only (meta tensors): the step keeps no unsharded
    # copy of the model.
    template = {name: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for name, p in template.items()}
    n = mesh.axis_size(axis)

    def step(sharded: dict, batch, step_lr: float = lr):
        leaves = {k: v.detach().requires_grad_() for k, v in sharded.items()}
        with torch.enable_grad():
            params = unshard_params(leaves, template, axis, mesh=mesh)
            losses = torch.stack([
                loss_fn({k: v[r] for k, v in params.items()},
                        tuple(b[r] for b in batch))
                for r in range(len(mesh.local_ranks))])
            # The LOCAL losses only: an allreduce inside the differentiated
            # function would sum the cotangent again and scale the
            # gradients by n (the reference's ddp.py and fsdp.py pitfall).
            grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        new = {k: v.detach() - step_lr * (g / n)
               for (k, v), g in zip(leaves.items(), grads)}
        return new, spmd.allreduce(losses.detach(), axis, mesh=mesh) / n

    return step
