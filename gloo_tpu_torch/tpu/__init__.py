"""Device plane of the port: a mesh of ranks, the SPMD collectives over
world tensors, and the array-level process group.

Counterpart of gloo_tpu/tpu. The sum collectives run on the hand-written
ring kernels of gloo_tpu_torch.ops.ring; a mesh may put a world of ranks on
one card.
"""

from gloo_tpu_torch.tpu import spmd
from gloo_tpu_torch.tpu.group import CudaProcessGroup
from gloo_tpu_torch.tpu.mesh import Mesh, make_mesh

__all__ = ["CudaProcessGroup", "Mesh", "make_mesh", "spmd"]
