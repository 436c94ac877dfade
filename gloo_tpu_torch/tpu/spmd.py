"""Collective primitives over world tensors and a mesh axis.

Counterpart of gloo_tpu/tpu/spmd.py, with the same names and semantics.
There is no shard_map: a function takes the world tensor x (P, ...) whose
row r is flat rank r's local value, and runs the collective along `axis`
of `mesh` (given by keyword), every ring of that axis at once. The result
is again a world tensor. `axis` is a name or a tuple of names, as in the
reference: a tuple is one ring over the product of those axes, numbered
row-major over the names as given (lax.axis_index of the tuple).

The sum collectives ride the ring kernels of gloo_tpu_torch.ops.ring:
``allreduce`` and ``mean`` B3, ``reduce_scatter`` B4a (both in
ring.SUM_DTYPES, on the card and on the CPU alike, uint16 and uint32
included; a bool allreduce sums as int32 and returns int32 counts, as
lax.psum does), ``allgather`` B4b (any dtype);
``alltoall`` rides the all-to-all kernel B8 (one launch each on the card,
over strided blocks: no copy around it).
``max``/``min``/``product``, ``broadcast``, ``scatter``, ``ppermute``,
``shift`` and ``barrier`` are plain torch across the rank axis: the JAX
package has no Pallas kernel for them (they are XLA collectives there).

On a process mesh (tpu/multihost.py's init_multihost) a function takes
this process's local tensor, the rows of ``mesh.local_ranks``, and
returns its local result; ``rank`` and ``size`` answer for the local
rows. The kernel collectives (``allreduce`` and ``mean`` with the sum,
``reduce`` and ``reduce_scatter`` with the sum, ``allgather``,
``alltoall``) run the kernels' cross-process instances on the card and
their twins on the world gathered through the host plane on the CPU.
The point-to-point ones (``ppermute``, ``shift``, ``broadcast``,
``scatter``) ride the transport of ops/permute.py, one pull over the peer
workspace (csrc/permute.cu; NCCL refuses two ranks of one group on one
card); the max/min/product reductions the cross-process allgather (B4b)
and a local reduction; ``barrier`` the cross-process B3 on int32 ones,
which is the reference's psum of ones.

Every collective runs under ``annotate("gloo_tpu.<op>")``, the reference's
``jax.named_scope`` names (``shift`` under ``gloo_tpu.ppermute``), so a
profile puts its device time under the collective.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from gloo_tpu_torch.ops import ring
from gloo_tpu_torch.ops.permute import pull
from gloo_tpu_torch.ops.ring import (ring_allgather, ring_allreduce,
                                     ring_reduce_scatter)
from gloo_tpu_torch.tpu.mesh import Axis, Mesh
from gloo_tpu_torch.utils.tracing import annotate


def rank(axis: Axis, *, mesh: Mesh) -> torch.Tensor:
    """Each rank's position along `axis` (P,) int64, on the mesh's device
    (on a process mesh, the local ranks')."""
    index = mesh.ring_index(axis)
    return torch.tensor([index[r] for r in mesh.local_ranks],
                        device=mesh.device)


def size(axis: Axis, *, mesh: Mesh) -> int:
    return mesh.axis_size(axis)


def _members(axis: Axis, mesh: Mesh) -> torch.Tensor:
    """(P, n): the flat ranks of each rank's ring, in ring order."""
    return torch.tensor(mesh.ring_members(axis), device=mesh.device)


def _per_rank(x: torch.Tensor, mesh: Mesh) -> int:
    """The rows x must have: one per rank, or on a process mesh one per
    local rank."""
    rows = len(mesh.local_ranks)
    if x.dim() < 1 or x.shape[0] != rows:
        what = "a world tensor" if mesh.processes == 1 \
            else "this process's local tensor"
        raise ValueError(f"x must be {what} with {rows} rows (one per "
                         f"{'local ' if mesh.processes > 1 else ''}rank); "
                         f"got {tuple(x.shape)}")
    return rows


def allreduce(x: torch.Tensor, axis: Axis, op: str = "sum", *,
              mesh: Mesh) -> torch.Tensor:
    rows = _per_rank(x, mesh)
    with annotate("gloo_tpu.allreduce"):
        if op == "sum":
            if x.dtype == torch.bool:
                x = x.to(torch.int32)
            n = mesh.axis_size(axis)
            flat = x.reshape(rows, -1)
            pad = -flat.shape[1] % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(rows, pad)], 1)
            out = ring_allreduce(flat.view(rows, n, -1), axis, mesh)
            out = out.reshape(rows, -1)[:, :x[0].numel()]
            return out.reshape(x.shape)
        if op in ("max", "min"):
            # uint16 and uint32 have no amax/amin (nor, on the card, an
            # index) in this PyTorch: compared in ring.WIDENED's type, which
            # holds every value exactly. Across processes every member's
            # value comes by B4b.
            wide = ring.widened(x)
            gathered = allgather(wide, axis, tiled=False, mesh=mesh) \
                if mesh.processes > 1 else wide[_members(axis, mesh)]
            return (gathered.amax(1) if op == "max"
                    else gathered.amin(1)).to(x.dtype)
        if op in ("product", "prod"):
            # No product collective: gather and reduce locally, as in JAX.
            return allgather(x, axis, tiled=False, mesh=mesh).prod(
                1, dtype=x.dtype)
        raise ValueError(f"unknown op: {op}")


def mean(x: torch.Tensor, axis: Axis, *, mesh: Mesh) -> torch.Tensor:
    return allreduce(x, axis, mesh=mesh) / mesh.axis_size(axis)


def reduce_scatter(x: torch.Tensor, axis: Axis, op: str = "sum",
                   scatter_axis: int = 0, *, mesh: Mesh) -> torch.Tensor:
    """Reduce across `axis` and leave each rank with its 1/n slice along
    `scatter_axis` of its local value."""
    rows = _per_rank(x, mesh)
    with annotate("gloo_tpu.reduce_scatter"):
        n = mesh.axis_size(axis)
        dim = 1 + scatter_axis % (x.dim() - 1)
        if x.shape[dim] % n != 0:
            raise ValueError(f"dim {dim - 1} of size {x.shape[dim]} is not "
                             f"divisible by the axis size {n}")
        chunk = x.shape[dim] // n
        if op != "sum":
            # The sum-only kernel: other ops are allreduce plus slice.
            full = allreduce(x, axis, op, mesh=mesh)
            idx = rank(axis, mesh=mesh)[:, None] * chunk + torch.arange(
                chunk, device=x.device)
            moved = full.movedim(dim, 1)
            picked = moved[torch.arange(rows, device=x.device)[:, None],
                           idx]
            return picked.movedim(1, dim)
        moved = x.movedim(dim, 1)
        rest = moved.shape[2:]
        out = ring_reduce_scatter(moved.reshape(rows, x.shape[dim], -1),
                                  axis, mesh)
        return out.reshape(rows, chunk, *rest).movedim(1, dim)


def allgather(x: torch.Tensor, axis: Axis, gather_axis: int = 0,
              tiled: bool = True, *, mesh: Mesh) -> torch.Tensor:
    """Every rank's local value along `gather_axis`: concatenated when
    `tiled`, else stacked on a new axis there (lax.all_gather)."""
    rows = _per_rank(x, mesh)
    with annotate("gloo_tpu.allgather"):
        n = mesh.axis_size(axis)
        local = x.shape[1:]
        out = ring_allgather(x.reshape(rows, 1, -1), axis, mesh)
        out = out.reshape(rows, n, *local)
        if not tiled:
            return out.movedim(1, 1 + gather_axis % (len(local) + 1))
        dim = gather_axis % len(local)
        out = out.movedim(1, 1 + dim)
        return out.flatten(1 + dim, 2 + dim)


def alltoall(x: torch.Tensor, axis: Axis, split_axis: int = 0,
             concat_axis: int = 0, *, mesh: Mesh) -> torch.Tensor:
    """Scatter `split_axis` across the ring and gather along `concat_axis`
    (tiled): block k of rank r's value goes to ring member k, and rank r
    concatenates the blocks it receives in ring order. One B8 launch that
    reads x's blocks as strided slabs where they lie and writes the result
    in its final layout: no copy before or after it. Raises ValueError
    when the split axis does not divide by the ring size, as
    lax.all_to_all does."""
    _per_rank(x, mesh)
    with annotate("gloo_tpu.alltoall"):
        n = mesh.axis_size(axis)
        local = x.shape[1:]
        split = split_axis % len(local)
        if local[split] % n != 0:
            raise ValueError(f"split axis {split_axis} of size "
                             f"{local[split]} is not divisible by the axis "
                             f"size {n}")
        return ring.alltoall(x, axis, mesh, split, concat_axis % len(local))


def _pulled(x: torch.Tensor, axis: Axis, mesh: Mesh,
            sources: Sequence[int]) -> torch.Tensor:
    """Each local rank's value from the member at ring index sources[k]
    (k its own ring index), or zeros for -1: the transport's pull of whole
    values, in x's shape."""
    n = mesh.axis_size(axis)
    return pull(x, axis, mesh, sources, [0] * n,
                x[0].numel()).view(x.shape)


class _Permute(torch.autograd.Function):
    """ppermute across processes: the VJP is the inverse permutation of
    the cotangent (lax.ppermute's transpose), on the same transport."""

    @staticmethod
    def forward(ctx, x, axis, mesh, sources):
        ctx.args = (axis, mesh, sources)
        return _pulled(x, axis, mesh, sources)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, sources = ctx.args
        inverse = [-1] * len(sources)
        for dst, src in enumerate(sources):
            if src >= 0:
                if inverse[src] >= 0:
                    raise ValueError(f"ring index {src} is the source of "
                                     f"two pairs: no inverse permutation")
                inverse[src] = dst
        return _pulled(g.contiguous(), axis, mesh, inverse), None, None, \
            None


def broadcast(x: torch.Tensor, axis: Axis, root: int = 0, *,
              mesh: Mesh) -> torch.Tensor:
    """Every rank receives the value of its ring's rank `root`."""
    _per_rank(x, mesh)
    with annotate("gloo_tpu.broadcast"):
        if mesh.processes > 1:
            return _pulled(x, axis, mesh, [root] * mesh.axis_size(axis))
        return x[_members(axis, mesh)[:, root]]


def reduce(x: torch.Tensor, axis: Axis, root: int = 0, op: str = "sum", *,
           mesh: Mesh) -> torch.Tensor:
    """Full reduction; non-root ranks receive zeros."""
    full = allreduce(x, axis, op, mesh=mesh)
    keep = (rank(axis, mesh=mesh) == root).view(-1, *[1] * (full.dim() - 1))
    return torch.where(keep, full, torch.zeros_like(full))


def scatter(x: torch.Tensor, axis: Axis, root: int = 0,
            scatter_axis: int = 0, *, mesh: Mesh) -> torch.Tensor:
    """Root's value is split into n slices along `scatter_axis`; ring
    member i receives slice i. Across processes every member pulls its own
    slice of the root's value (moved to the front), and nothing more."""
    dim = 1 + scatter_axis % (x.dim() - 1)
    n = mesh.axis_size(axis)
    chunk = x.shape[dim] // n
    if mesh.processes > 1:
        rows = _per_rank(x, mesh)
        with annotate("gloo_tpu.broadcast"):
            moved = x.movedim(dim, 1).contiguous()
            rest = moved.shape[2:]
            piece = chunk * math.prod(rest)
            out = pull(moved, axis, mesh, [root] * n,
                       [k * piece for k in range(n)], piece)
        return out.view(rows, chunk, *rest).movedim(1, dim)
    rooted = broadcast(x, axis, root, mesh=mesh)
    my = mesh.ring_index(axis)
    return torch.stack([rooted[r].narrow(dim - 1, my[r] * chunk, chunk)
                        for r in range(mesh.size)])


def _mesh_order(axis: Axis, mesh: Mesh) -> Axis:
    """A tuple's names in the mesh's own order: lax.ppermute numbers the
    ranks of a tuple of axes so, whatever order the tuple gives (unlike
    lax.axis_index)."""
    mesh.axis_size(axis)  # raises for what is not an axis
    if isinstance(axis, str):
        return axis
    return tuple(sorted(axis, key=mesh.axis_names.index))


def ppermute(x: torch.Tensor, axis: Axis, perm: Sequence[tuple], *,
             mesh: Mesh) -> torch.Tensor:
    """Point-to-point: pairs (source, destination) of ring indices, a tuple
    of axes numbered in the mesh's order as lax.ppermute numbers it; a rank
    that no pair names as destination receives zeros. Across processes one
    launch of the transport (differentiable: the VJP is the inverse
    permutation)."""
    _per_rank(x, mesh)
    with annotate("gloo_tpu.ppermute"):
        source = {int(dst): int(src) for src, dst in perm}
        axis = _mesh_order(axis, mesh)
        if mesh.processes > 1:
            sources = [source.get(k, -1)
                       for k in range(mesh.axis_size(axis))]
            if torch.is_grad_enabled() and x.requires_grad:
                return _Permute.apply(x, axis, mesh, sources)
            return _pulled(x, axis, mesh, sources)
        members, my = mesh.ring_members(axis), mesh.ring_index(axis)
        return torch.stack([
            x[members[r][source[my[r]]]] if my[r] in source
            else torch.zeros_like(x[r]) for r in range(mesh.size)])


def shift(x: torch.Tensor, axis: Axis, offset: int = 1, wrap: bool = True, *,
          mesh: Mesh) -> torch.Tensor:
    """Send each rank's value to ring index + offset (ppermute's
    numbering)."""
    p = mesh.axis_size(axis)
    if wrap:
        perm = [(i, (i + offset) % p) for i in range(p)]
    else:
        perm = [(i, i + offset) for i in range(p) if 0 <= i + offset < p]
    return ppermute(x, axis, perm, mesh=mesh)


def barrier(axis: Axis, *, mesh: Mesh) -> torch.Tensor:
    """A (P,) int32 world tensor whose value, the ring size, depends on
    every participant (the sum of ones over the ring). Across processes
    the local ranks' rows, from one cross-process B3 of int32 ones."""
    with annotate("gloo_tpu.barrier"):
        if mesh.processes > 1:
            return allreduce(torch.ones(len(mesh.local_ranks),
                                        dtype=torch.int32,
                                        device=mesh.device), axis,
                             mesh=mesh)
        ones = torch.ones(mesh.size, dtype=torch.int32, device=mesh.device)
        return ones[_members(axis, mesh)].sum(1, dtype=torch.int32)
