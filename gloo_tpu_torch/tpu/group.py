"""CudaProcessGroup: the array-level process group of the device plane.

Counterpart of gloo_tpu/tpu/group.py's TpuProcessGroup: one "rank" per
position along one mesh axis, the host Context's collective names and
semantics, on world tensors in place of sharded jax arrays. The leading
axis of every operand is the rank axis: a tensor (P, ...) whose row i is
rank i's value. ``shard``/``unshard`` convert between host numpy and this
layout. The sum collectives run on the ring kernels (B3, B4a, B4b) and
``alltoall`` on the all-to-all kernel (B8); PyTorch runs eagerly, so the JAX version's cache of compiled programs has no
counterpart.

On a multi-axis mesh the group's P = mesh.shape[axis] rows are replicated
over the other axes (as a P(axis) sharding is) and read back from the ring
of flat rank 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.mesh import Mesh


class CudaProcessGroup:
    def __init__(self, mesh: Mesh, axis: Optional[str] = None):
        if axis is None:
            if len(mesh.axis_names) != 1:
                raise ValueError("axis required for multi-axis mesh")
            axis = mesh.axis_names[0]
        self.mesh = mesh
        self.axis = axis
        self.size = mesh.shape[axis]
        self._flat = len(mesh.axis_names) == 1
        self._ring_index = torch.tensor(mesh.ring_index(axis))
        self._ring0 = torch.tensor(mesh.ring_members(axis)[0])

    # ---- data movement helpers ----

    def shard(self, array) -> torch.Tensor:
        """A (P, ...) host array as a tensor on the mesh's device."""
        t = torch.as_tensor(np.asarray(array))
        if t.shape[0] != self.size:
            raise ValueError(
                f"leading axis {t.shape[0]} != group size {self.size}")
        return t.to(self.mesh.device)

    def unshard(self, tensor: torch.Tensor) -> np.ndarray:
        return tensor.detach().cpu().numpy()

    def _run(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn on the world tensor of x (the group's rows replicated over
        the mesh's other axes), read back along the ring of flat rank 0."""
        if self._flat:
            return fn(x)
        out = fn(x[self._ring_index.to(x.device)])
        return out[self._ring0.to(out.device)]

    # ---- collectives (each rank's operand is its row) ----

    def allreduce(self, x, op: str = "sum"):
        return self._run(
            lambda s: spmd.allreduce(s, self.axis, op, mesh=self.mesh), x)

    def broadcast(self, x, root: int = 0):
        return self._run(
            lambda s: spmd.broadcast(s, self.axis, root, mesh=self.mesh), x)

    def reduce(self, x, root: int = 0, op: str = "sum"):
        return self._run(
            lambda s: spmd.reduce(s, self.axis, root, op, mesh=self.mesh), x)

    def allgather(self, x):
        # (P, P, ...): row i is rank i's copy of the gathered buffer
        # (identical rows, as in the host API).
        return self._run(
            lambda s: spmd.allgather(s, self.axis, gather_axis=0,
                                     tiled=False, mesh=self.mesh), x)

    def reduce_scatter(self, x, op: str = "sum"):
        """x rows are (P*k, ...); rank i keeps slice i of the sum."""
        return self._run(
            lambda s: spmd.reduce_scatter(s, self.axis, op, scatter_axis=0,
                                          mesh=self.mesh), x)

    def alltoall(self, x):
        """Row i holds P blocks along axis 1; block j goes to rank j (one
        B8 launch)."""
        return self._run(
            lambda s: spmd.alltoall(s, self.axis, split_axis=0,
                                    concat_axis=0, mesh=self.mesh), x)

    def scatter(self, x, root: int = 0):
        return self._run(
            lambda s: spmd.scatter(s, self.axis, root, scatter_axis=0,
                                   mesh=self.mesh), x)

    def send_recv(self, x, perm: Sequence[tuple]):
        perm = tuple((int(a), int(b)) for a, b in perm)
        return self._run(
            lambda s: spmd.ppermute(s, self.axis, perm, mesh=self.mesh), x)

    def shift(self, x, offset: int = 1):
        return self._run(
            lambda s: spmd.shift(s, self.axis, offset, mesh=self.mesh), x)

    def barrier(self):
        out = spmd.barrier(self.axis, mesh=self.mesh)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
