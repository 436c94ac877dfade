"""Utilities of the port: tracing (gloo_tpu/utils/tracing.py)."""

from gloo_tpu_torch.utils.tracing import (annotate, device_trace,
                                          merge_traces, scope_device_ms)

__all__ = ["annotate", "device_trace", "merge_traces", "scope_device_ms"]
