"""Device mesh: named axes over a row-major grid of devices.

Counterpart of gloo_tpu/tpu/mesh.py. The JAX mesh arranges chips into a
``jax.sharding.Mesh``; here a small ``Mesh`` holds a grid of
``torch.device``s, its axis names and sizes. A device may repeat:
``[torch.device("cuda:0")] * 4`` is a world of 4 ranks on one card (each
rank's buffers are rows of one world tensor, and the ring kernels run every
rank's part as its own thread blocks), the counterpart of the JAX tests'
virtual CPU devices; ``["cpu"] * 4`` is the world the CPU tests use.

A world tensor has the flat rank as its leading axis: row r belongs to the
device at row-major position r of the grid.

The ring tables (``ring_members``, ``ring_index``, ``ring_neighbors``) are
the host-side port of gloo_tpu/ops/pallas_ring.py's ``_peer_logical_id``
and ``_ring_neighbors``: the kernels take them as tables, one entry per
flat rank. An axis is a name or a sequence of names (the reference's
``Axis``); a sequence is one ring over the product of those axes,
row-major over the names as given, which is what ``lax.axis_index`` of
the same tuple numbers.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Union

import torch

# Where a mesh over more than one card is taken up (peer-mapped memory,
# one cooperative launch per card).
MULTI_CARD_ITEM = "ROADMAP.md queue A, item 7 (the multi-card launch)"

# A mesh axis name, or a sequence of them for one ring over their product.
Axis = Union[str, Sequence[str]]


class Mesh:
    """A row-major grid of devices with named axes.

    ``devices`` is the flat list in row-major order, ``axis_names`` the
    names in grid order and ``shape`` maps each name to its size (in that
    order, as ``jax.sharding.Mesh.shape``)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 sizes: Sequence[int]):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape.values())} devices, "
                             f"have {len(self.devices)}")
        # Per tuple of axis names: (members, ring index, right, left).
        self._rings: dict[tuple[str, ...], tuple] = {}

    @property
    def size(self) -> int:
        """Number of flat ranks."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every rank of the mesh lives on. A mesh over more
        than one distinct device raises NotImplementedError: the port's
        collectives run a world of ranks on one card so far."""
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) != 1:
            raise NotImplementedError(
                f"the mesh spans {len(distinct)} distinct devices "
                f"({', '.join(distinct)}); collectives across cards are "
                f"{MULTI_CARD_ITEM}")
        return self.devices[0]

    def _names(self, axis: Axis) -> tuple[str, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in names if a not in self.shape]
        if unknown or not names or len(set(names)) != len(names):
            raise ValueError(f"axis {axis!r} is not one of, or a tuple of "
                             f"distinct names among, {self.axis_names}")
        return names

    def axis_size(self, axis: Axis) -> int:
        """Ranks in one ring along `axis` (lax.axis_size): the product of
        the sizes of its names."""
        return math.prod(self.shape[a] for a in self._names(axis))

    def _ring(self, axis: Axis) -> tuple:
        """(members, ring index, right, left) along `axis`, made once per
        tuple of names."""
        names = self._names(axis)
        if names not in self._rings:
            strides = {a: math.prod(self.shape[b] for b in
                                    self.axis_names[i + 1:])
                       for i, a in enumerate(self.axis_names)}
            # Offsets of ring index k from the ring's origin: the last name
            # runs fastest.
            offsets = [0]
            for a in names:
                offsets = [o + i * strides[a] for o in offsets
                           for i in range(self.shape[a])]
            origin = [r - sum((r // strides[a]) % self.shape[a] * strides[a]
                              for a in names) for r in range(self.size)]
            members = [[o + off for off in offsets] for o in origin]
            my = [row.index(r) for r, row in enumerate(members)]
            n = len(offsets)
            self._rings[names] = (
                members, my,
                [row[(m + 1) % n] for row, m in zip(members, my)],
                [row[(m - 1) % n] for row, m in zip(members, my)])
        return self._rings[names]

    def ring_members(self, axis: Axis) -> list[list[int]]:
        """For each flat rank, the flat ranks of its ring along `axis` in
        ring order (entry k has ring index k): the ranks that share its
        position on every other axis, numbered row-major over the names of
        `axis` as given."""
        return [list(row) for row in self._ring(axis)[0]]

    def ring_index(self, axis: Axis) -> list[int]:
        """Each flat rank's position along `axis` (lax.axis_index)."""
        return list(self._ring(axis)[1])

    def ring_neighbors(self, axis: Axis) -> tuple[list[int], list[int],
                                                  list[int]]:
        """(ring index, right, left) of every flat rank along `axis`: the
        members at ring index + 1 and - 1 mod n, as flat ranks
        (_ring_neighbors)."""
        _, my, right, left = self._ring(axis)
        return list(my), list(right), list(left)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(axes: Optional[Mapping[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh over `devices` (default: every visible CUDA card).

    `axes` maps axis name -> size; one axis size may be -1 to absorb the
    remaining devices (like a reshape). Default: a single "data" axis over
    everything. A device may repeat (a world of ranks on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * n to "
                "make_mesh to run on the CPU with the plain PyTorch "
                "versions of the kernels")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if axes is None:
        axes = {"data": len(devs)}
    names = list(axes.keys())
    sizes = list(axes.values())
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError("at most one axis size may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if n_free == 1:
        if len(devs) % known != 0:
            raise ValueError(
                f"{len(devs)} devices not divisible by fixed axes {axes}")
        sizes[sizes.index(-1)] = len(devs) // known
    return Mesh(devs, names, sizes)
