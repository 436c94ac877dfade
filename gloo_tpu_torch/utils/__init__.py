"""Utilities of the port: tracing, metrics exposition, cross-rank profile
and critical-path analysis, the fleet document, the flight recorder's
post-mortem tools and the live telemetry endpoint (gloo_tpu/utils)."""

from gloo_tpu_torch.utils import critpath, fleet, flightrec, profile
from gloo_tpu_torch.utils.flightrec import DesyncError
from gloo_tpu_torch.utils.metrics import (histogram_quantile,
                                          merge_snapshots, summarize_ops,
                                          to_prometheus)
from gloo_tpu_torch.utils.telemetry import TelemetryServer, serve_telemetry
from gloo_tpu_torch.utils.tracing import (annotate, device_trace,
                                          merge_traces, scope_device_ms)

__all__ = [
    "DesyncError",
    "TelemetryServer",
    "annotate",
    "device_trace",
    "fleet",
    "flightrec",
    "histogram_quantile",
    "merge_snapshots",
    "merge_traces",
    "profile",
    "scope_device_ms",
    "serve_telemetry",
    "summarize_ops",
    "to_prometheus",
]
