"""gloo_tpu_torch: the gloo_tpu models and kernels on PyTorch and CUDA.

A port of the JAX package ``gloo_tpu`` to NVIDIA Hopper GPUs. It imports
nothing of ``gloo_tpu`` or JAX. Entry points run on ``cuda`` unless given
``device="cpu"``; kernels are built with nvcc from ``csrc/`` at first use,
and on CPU tensors their plain PyTorch versions run instead. The host
plane (stores, devices, contexts with the whole collective suite,
point-to-point buffers, persistent plans and the wire codecs: the C++ core
of the repo's ``csrc/tpucoll``) is built with g++ at first use, and stages
CUDA tensors through pinned host memory. ``init_from_env`` connects a
Context from a launcher's environment; ``checkpoint``, ``resilience`` and
``elastic`` carry training across the loss of a process; ``fault``,
``schedule`` and ``tuning`` script faults, install collective schedules
and tuning tables, and ``utils`` reads the native tracer, profiler, span
recorder and fleet plane.
"""

from gloo_tpu_torch import elastic, fault, schedule, tuning
from gloo_tpu_torch.bootstrap import detect_launch_env, init_from_env
from gloo_tpu_torch.bucketer import GradientBucketer
from gloo_tpu_torch.core import (Aborted, AsyncEngine, CollectivePlan,
                                 Context, Device, Error, FileStore,
                                 HashStore, IoError, PrefixStore, ReduceOp,
                                 Store, TcpStore, TcpStoreServer,
                                 TimeoutError, UnboundBuffer, Work,
                                 codec_pipeline, codec_threads,
                                 crypto_isa_tier, derive_keyring, q4_block,
                                 q4_decode, q4_encode, q4_wire_bytes,
                                 q8_block, q8_decode, q8_encode,
                                 q8_wire_bytes, set_connect_debug_logger,
                                 uring_available)
from gloo_tpu_torch.models import MLP, Transformer, TransformerConfig
from gloo_tpu_torch.ops import flash_attention

__version__ = "0.1.0"

__all__ = ["Aborted", "AsyncEngine", "CollectivePlan", "Context", "Device",
           "Error", "FileStore", "GradientBucketer", "HashStore", "IoError",
           "MLP", "PrefixStore", "ReduceOp", "Store", "TcpStore",
           "TcpStoreServer", "TimeoutError", "Transformer",
           "TransformerConfig", "UnboundBuffer", "Work", "__version__",
           "codec_pipeline", "codec_threads", "crypto_isa_tier",
           "derive_keyring", "detect_launch_env", "elastic", "fault",
           "flash_attention", "init_from_env", "q4_block", "q4_decode",
           "q4_encode", "q4_wire_bytes", "q8_block", "q8_decode",
           "q8_encode", "q8_wire_bytes", "schedule",
           "set_connect_debug_logger", "tuning", "uring_available"]
