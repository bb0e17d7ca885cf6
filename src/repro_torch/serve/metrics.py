"""Latency observability for the serving tier (port of
``repro.serve.metrics``).

Everything the front door needs to answer "how is serving going": per-request latency histograms (queue / dispatch /
total), throughput (requests per second), batch-fill fraction, and the two
staleness counters the steady-state guarantee is asserted against —
executor builds (``core.api.recompile_count``) and autotune stopwatch
runs (``core.autotune.timing_run_count``). The engine feeds these; tests
and ``chip_smoke.py``'s serving phase read ``snapshot()``.

Timestamps come from an injectable clock so benchmarks can drive an
open-loop simulated workload: :class:`VirtualClock` advances only when told
to (arrivals jump it to the schedule, dispatches advance it by the *real*
measured compute time), which makes queueing delay well-defined without
running wall-clock-long experiments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from ..obs import metrics as _obs_metrics

__all__ = ["LatencyStats", "ServeMetrics", "VirtualClock", "percentile"]

# ServeMetrics int counter fields mirrored into the port's metrics
# registry as ``serve_<field>`` gauges (gauges, not counters: the mirror is
# last-writer-wins across engines, and ``breaker_open_classes`` already has
# gauge semantics). The dataclass stays the serving tier's source of truth
# — the mirror only makes ``obs.render_prom()`` / ``obs.snapshot()`` show
# serving next to the core counters.
_MIRRORED_FIELDS = frozenset({
    "submitted", "served", "rejected", "shed", "batches", "recompiles",
    "replans", "autotune_timing_runs", "autotune_cache_hits",
    "deadline_expired", "failed", "faults", "nonfinite_batches", "retries",
    "breaker_opens", "breaker_closes", "breaker_open_classes",
})


def percentile(samples: List[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default rule) of raw
    samples; NaN on an empty list so a missing series is visible, not a
    silent zero."""
    if not samples:
        return math.nan
    xs = sorted(samples)
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass
class LatencyStats:
    """One latency series: raw samples plus the summary the BENCH record
    wants (p50/p99/mean). Samples are kept raw — serving benchmarks run
    thousands of requests, not millions, and exact percentiles beat bucket
    error at that scale."""

    samples: List[float] = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.samples.append(float(seconds))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return (sum(self.samples) / len(self.samples) if self.samples
                else math.nan)

    def p(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_s": self.mean,
                "p50_s": self.p(50.0), "p99_s": self.p(99.0),
                "max_s": max(self.samples) if self.samples else math.nan}


class VirtualClock:
    """A monotonic clock that moves only when told to.

    ``now()`` reads; ``advance(dt)`` moves forward; ``advance_to(t)`` jumps
    (never backward). The serving engine calls ``advance`` with the *real*
    measured compute time of each dispatched batch, so simulated arrival
    schedules compose with measured service times into honest queueing
    latencies.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backward (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t


@dataclasses.dataclass
class ServeMetrics:
    """The serving tier's observability surface (see module docstring).

    Counters move only through the engine; ``snapshot()`` is the one read
    path (tests, the benchmark, and the README example all consume it).
    """

    # latency histograms (seconds)
    queue_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)        # submit -> batch dispatch
    dispatch_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)        # batch dispatch -> results ready
    total_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)        # submit -> results ready
    batch_fill: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)        # real reqs / padded batch slots

    # request accounting
    submitted: int = 0
    served: int = 0
    rejected: int = 0                        # admission refused (queue full)
    shed: int = 0                            # evicted by shed-oldest policy
    batches: int = 0                         # execute_batch dispatches
    # staleness accounting (deltas of the core counters, attributed to
    # serving work only)
    recompiles: int = 0                      # executor builds
    replans: int = 0                         # per-class bound growth events
    autotune_timing_runs: int = 0            # stopwatch candidate timings
    autotune_cache_hits: int = 0             # warm winner lookups
    # resilience accounting (the retry/deadline/breaker machinery)
    deadline_expired: int = 0                # "deadline" terminal responses
    failed: int = 0                          # retry budget exhausted
    faults: int = 0                          # failed dispatch attempts
    nonfinite_batches: int = 0               # dispatches with non-finite out
    retries: int = 0                         # re-queued request attempts
    breaker_opens: int = 0                   # class quarantined to fallback
    breaker_closes: int = 0                  # class restored to primary
    breaker_open_classes: int = 0            # gauge: currently quarantined

    # throughput window
    t_first_submit: Optional[float] = None
    t_last_done: Optional[float] = None

    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        if name in _MIRRORED_FIELDS:
            _obs_metrics.registry.gauge(f"serve_{name}").set(value)

    def note_submit(self, t: float) -> None:
        self.submitted += 1
        if self.t_first_submit is None:
            self.t_first_submit = t

    def note_served(self, t_submit: float, t_dispatch: float,
                    t_done: float) -> None:
        self.served += 1
        self.queue_latency.record(t_dispatch - t_submit)
        self.dispatch_latency.record(t_done - t_dispatch)
        self.total_latency.record(t_done - t_submit)
        self.t_last_done = (t_done if self.t_last_done is None
                            else max(self.t_last_done, t_done))

    @property
    def rps(self) -> float:
        """Served requests per second over the first-submit .. last-done
        window (the open-loop benchmark's throughput figure)."""
        if (self.t_first_submit is None or self.t_last_done is None
                or self.t_last_done <= self.t_first_submit):
            return math.nan
        return self.served / (self.t_last_done - self.t_first_submit)

    def snapshot(self) -> Dict[str, object]:
        """The whole observability surface as one JSON-able dict."""
        return {
            "submitted": self.submitted,
            "served": self.served,
            "rejected": self.rejected,
            "shed": self.shed,
            "batches": self.batches,
            "recompiles": self.recompiles,
            "replans": self.replans,
            "autotune_timing_runs": self.autotune_timing_runs,
            "autotune_cache_hits": self.autotune_cache_hits,
            "deadline_expired": self.deadline_expired,
            "failed": self.failed,
            "faults": self.faults,
            "nonfinite_batches": self.nonfinite_batches,
            "retries": self.retries,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "breaker_open_classes": self.breaker_open_classes,
            "rps": self.rps,
            "batch_fill": self.batch_fill.mean,
            "queue_latency": self.queue_latency.summary(),
            "dispatch_latency": self.dispatch_latency.summary(),
            "total_latency": self.total_latency.summary(),
        }
