"""Serving tier (port of ``repro.serve``): continuous batching over the
plan/execute API.

A :class:`ServingEngine` is the front door for interaction requests of
varying ``(N, grid, kernel, fields)``: each is normalized onto a padded
:class:`ShapeClass`, bucketed with compatible requests, and dispatched
through one ``execute_batch`` call (on the card, one chain of kernel
launches for the batch), keeping per-class plans and executors warm so
steady-state traffic builds nothing and times nothing.
:class:`TrajectoryService` serves multi-step simulation jobs the same way.
"""

from .bucketing import (MIN_N_CAP, ShapeClass, classify, pad_state,
                        quantize_batch, quantize_n, split_batch,
                        stack_states)
from .engine import (ADMISSION_POLICIES, RESPONSE_STATUSES, Request,
                     Response, ServingEngine)
from .metrics import LatencyStats, ServeMetrics, VirtualClock, percentile
from .trajectory import (TrajectoryRequest, TrajectoryResponse,
                         TrajectoryService)

__all__ = [
    "ADMISSION_POLICIES", "LatencyStats", "MIN_N_CAP", "Request",
    "RESPONSE_STATUSES", "Response", "ServeMetrics", "ServingEngine",
    "ShapeClass", "TrajectoryRequest", "TrajectoryResponse",
    "TrajectoryService", "VirtualClock", "classify", "pad_state",
    "percentile", "quantize_batch", "quantize_n", "split_batch",
    "stack_states",
]
