"""Observability (port of ``repro.obs``): tracing spans, metrics registry,
traffic audit.

* **Spans & events** (:mod:`repro_torch.obs.trace`) — ``obs.trace(name,
  **attrs)`` context-manager spans and ``obs.event(...)`` instants in a
  bounded ring buffer; off by default, exportable as JSONL or Chrome
  ``trace_event`` JSON.
* **Metrics registry** (:mod:`repro_torch.obs.metrics`) — labeled
  counters / gauges / histograms, rendered by ``obs.render_prom()`` /
  ``obs.snapshot()``.
* **Traffic audit** (:mod:`repro_torch.obs.audit`) — the model-vs-measured
  "model drift" metric the autotuner records with every prune decision.

The registry and the ring buffer are this package's own: nothing is shared
with the JAX package's ``repro.obs``. ``trace``/``metrics`` import nothing
from the library, so ``core`` can depend on them without cycles; ``audit``
(which imports ``core``) is loaded lazily on first attribute access (PEP
562). ``profile`` is not ported yet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, registry,
                      render_prom, snapshot)
from .trace import (DEFAULT_CAPACITY, chrome_events, clear, disable, enable,
                    event, export_chrome_trace, export_jsonl, spans, stats,
                    trace, tracing, tracing_enabled)

__all__ = [
    # trace
    "trace", "event", "enable", "disable", "tracing", "tracing_enabled",
    "spans", "clear", "stats", "export_jsonl", "export_chrome_trace",
    "chrome_events", "DEFAULT_CAPACITY",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "render_prom", "snapshot",
    # lazy: audit
    "MeasuredTraffic", "measured_traffic", "neighbor_pair_count",
    "model_drift", "audit_candidate",
]

_LAZY = {
    "MeasuredTraffic": "audit", "measured_traffic": "audit",
    "neighbor_pair_count": "audit", "model_drift": "audit",
    "audit_candidate": "audit",
}

# what the JAX package's obs has and this port does not yet, with the
# ROADMAP.md Queue 1 item that ports it
_NOT_PORTED = {"profile": 10, "ProfileReport": 10}


def __getattr__(name):
    item = _NOT_PORTED.get(name)
    if item is not None:
        raise AttributeError(
            f"repro_torch.obs.{name} is not ported yet (ROADMAP.md Queue 1 "
            f"item {item})")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
