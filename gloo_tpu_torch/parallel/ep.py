"""Expert parallelism: MoE token routing over the all-to-all kernel.

Counterpart of gloo_tpu/parallel/ep.py. Each rank along `axis` holds one
expert; tokens are bucketed by their assigned expert with a fixed capacity
per (source rank, expert), dispatched with one all-to-all, processed by
the local expert and combined back with a second all-to-all. Both
exchanges are ``spmd.alltoall``, one launch of B8 each (and one each in
the backward). The routing around them is plain torch over world tensors.

On a process mesh (tpu/multihost.py) tokens and expert_idx are this
process's local rows, and both exchanges are the cross-process B8.

Fixed capacity keeps shapes static, as in JAX: tokens past an expert's
capacity, and tokens assigned to an expert that does not exist, are dropped
(their output is zero).
"""

from __future__ import annotations

from typing import Callable

import torch

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Mesh
from gloo_tpu_torch.utils.tracing import annotate


def dispatch_combine(expert_fn: Callable, tokens: torch.Tensor,
                     expert_idx: torch.Tensor, capacity: int, axis: str, *,
                     mesh: Mesh) -> torch.Tensor:
    """Route tokens to experts and back.

    tokens: (P, T, D) world tensor, rank r's T local tokens; expert_idx:
    (P, T) integer expert per token (expert e lives at ring index e of
    `axis`); capacity: slots each rank reserves PER expert. expert_fn maps
    the world tensor (P, n * capacity, D) of arrived slots to the processed
    slots of the same shape (rank r's rows through rank r's expert).
    Returns (P, T, D): each token's expert output, zero for dropped
    tokens. Differentiable in the tokens and in whatever expert_fn
    closes over."""
    n = spmd.size(axis, mesh=mesh)
    ranks, t_local, d = tokens.shape
    if tuple(expert_idx.shape) != (ranks, t_local):
        raise ValueError(f"expert_idx must be ({ranks}, {t_local}); got "
                         f"{tuple(expert_idx.shape)}")
    idx = expert_idx.long()
    # Position of each token within its expert bucket; an out-of-range
    # assignment has no bucket (its one-hot row is zero) and is dropped.
    one_hot = (idx[..., None] == torch.arange(n, device=idx.device)).long()
    pos = ((torch.cumsum(one_hot, dim=1) - 1) * one_hot).sum(-1)
    keep = (pos < capacity) & (idx >= 0) & (idx < n)

    # Overflow tokens go to a dummy expert row (cut off below), so they can
    # never overwrite a kept token's slot.
    ar = torch.arange(ranks, device=tokens.device)[:, None]
    slot = torch.where(keep, pos, 0)
    send = tokens.new_zeros((ranks, n + 1, capacity, d)).index_put(
        (ar, torch.where(keep, idx, n), slot), tokens)
    send = send[:, :n]

    # Dispatch: slot (e, c) goes to expert e.
    with annotate("gloo_tpu.ep.dispatch"):
        arrived = spmd.alltoall(send, axis, split_axis=0, concat_axis=0,
                                mesh=mesh)
    processed = expert_fn(arrived.reshape(ranks, n * capacity, d))
    processed = processed.reshape(ranks, n, capacity, d)
    # Combine: the results go back to their source ranks.
    with annotate("gloo_tpu.ep.combine"):
        returned = spmd.alltoall(processed, axis, split_axis=0,
                                 concat_axis=0, mesh=mesh)
    # Un-scatter to token order. JAX clips out-of-range gather indices and
    # zeroes the row; torch would raise (on the card, a device-side assert
    # that poisons the context), so the expert index is clamped first.
    out = returned[ar, idx.clamp(0, n - 1), slot]
    return torch.where(keep[..., None], out, torch.zeros_like(out))
