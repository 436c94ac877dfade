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

The ring tables (``ring_index``, ``ring_neighbors``) are the host-side port
of gloo_tpu/ops/pallas_ring.py's ``_peer_logical_id`` and
``_ring_neighbors``: the kernels take them as tables, one entry per flat
rank.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch

# Where a mesh over more than one card is taken up (peer-mapped memory,
# one cooperative launch per card).
MULTI_CARD_ITEM = "ROADMAP.md queue A, item 7 (the multi-card launch)"


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

    def _stride(self, axis: str) -> int:
        names = self.axis_names
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} is not one of {names}")
        return math.prod(self.shape[a] for a in names[names.index(axis) + 1:])

    def ring_index(self, axis: str) -> list[int]:
        """Each flat rank's position along `axis` (lax.axis_index)."""
        stride, n = self._stride(axis), self.shape[axis]
        return [(r // stride) % n for r in range(self.size)]

    def ring_neighbors(self, axis: str) -> tuple[list[int], list[int],
                                                 list[int]]:
        """(ring index, right, left) of every flat rank along `axis`: the
        right neighbour is ring index + 1 mod n, the left one - 1 mod n,
        both as flat ranks; a peer along one axis differs by that axis's
        stride (_peer_logical_id)."""
        stride, n = self._stride(axis), self.shape[axis]
        my = self.ring_index(axis)
        right = [r + ((m + 1) % n - m) * stride for r, m in enumerate(my)]
        left = [r + ((m - 1) % n - m) * stride for r, m in enumerate(my)]
        return my, right, left

    def ring_members(self, axis: str) -> list[list[int]]:
        """For each flat rank, the flat ranks of its ring along `axis` in
        ring order (entry k has ring index k)."""
        stride = self._stride(axis)
        my = self.ring_index(axis)
        return [[r + (k - m) * stride for k in range(self.shape[axis])]
                for r, m in enumerate(my)]

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
