"""gloo_tpu_torch: the gloo_tpu models and kernels on PyTorch and CUDA.

A port of the JAX package ``gloo_tpu`` to NVIDIA Hopper GPUs. It imports
nothing of ``gloo_tpu`` or JAX. Entry points run on ``cuda`` unless given
``device="cpu"``; kernels are built with nvcc from ``csrc/`` at first use,
and on CPU tensors their plain PyTorch versions run instead.
"""

from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig
from gloo_tpu_torch.ops import flash_attention

__version__ = "0.1.0"

__all__ = ["MLP", "Transformer", "TransformerConfig", "flash_attention"]
