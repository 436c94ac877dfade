"""Device plane of the port: a mesh of ranks, the SPMD collectives over
world tensors, the array-level process group, and the hierarchical group
that composes the local devices with the host plane.

Counterpart of gloo_tpu/tpu. The sum collectives run on the hand-written
ring kernels of gloo_tpu_torch.ops.ring; a mesh may put a world of ranks on
one card.
"""

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.group import CudaProcessGroup
from gloo_tpu_torch.tpu.mesh import Mesh, make_mesh
from gloo_tpu_torch.tpu.hierarchical import (HierarchicalGroup,
                                             make_hierarchical_ddp)

__all__ = ["CudaProcessGroup", "HierarchicalGroup", "Mesh",
           "make_hierarchical_ddp", "make_mesh", "spmd"]
