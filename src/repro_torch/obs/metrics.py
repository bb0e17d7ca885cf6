"""The metrics registry (port of ``repro.obs.metrics``): named counters,
gauges and histograms with labels.

One process-wide :class:`MetricsRegistry` (``repro_torch.obs.registry``),
separate from the JAX package's. The autotuner counts its stopwatch runs
and cache lookups here (``repro_torch_autotune_timing_runs_total``,
``repro_torch_autotune_cache_total``; ``core.autotune.timing_run_count``
reads the first), and the traffic audit sets its model-drift gauge
(``obs.audit``). ``render_prom()`` and ``snapshot()`` expose every family
with its labels.

Conventions (Prometheus-style):

* counter names end in ``_total`` and only go up (until ``reset()``);
* gauges are set to the current value;
* histograms keep a bounded summary (count / sum / min / max), rendered
  as a Prometheus *summary* pair (``_count`` / ``_sum``) plus min/max
  gauges.

``reset()`` zeroes every instrument **in place**: objects handed out by
``counter()``/``gauge()``/``histogram()`` stay live, so cached references
survive a reset. ``reset(name)`` zeroes one metric family (e.g. only the
autotune timing-run counter).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "render_prom", "snapshot"]

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotonic counter (until a registry reset)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def _zero(self) -> None:
        self.value = 0.0

    def _render(self) -> float:
        return self.value


class Gauge:
    """A value that goes up and down; ``set()`` is last-writer-wins."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def _zero(self) -> None:
        self.value = 0.0

    def _render(self) -> float:
        return self.value


class Histogram:
    """Bounded distribution summary: count / sum / min / max."""

    __slots__ = ("count", "total", "vmin", "vmax")
    kind = "histogram"

    def __init__(self):
        self._zero()

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if math.isnan(self.vmin) else min(self.vmin, v)
        self.vmax = v if math.isnan(self.vmax) else max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def _zero(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.nan
        self.vmax = math.nan

    def _render(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax}


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class MetricsRegistry:
    """Named, labeled metric families (see module docstring).

    ``counter(name, **labels)`` (and ``gauge``/``histogram``) return the
    live instrument for that (name, label set), creating it on first use;
    re-registering a name under a different kind is an error — one name,
    one kind, any number of label sets.
    """

    def __init__(self):
        self._metrics: Dict[str, Dict[LabelKey, object]] = {}
        self._kinds: Dict[str, type] = {}

    def _get(self, cls, name: str, labels: Dict[str, object]):
        kind = self._kinds.setdefault(name, cls)
        if kind is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {kind.kind}, "
                f"not {cls.kind}")
        family = self._metrics.setdefault(name, {})
        key = _label_key(labels)
        inst = family.get(key)
        if inst is None:
            inst = family[key] = cls()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- read side ---------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def total(self, name: str) -> float:
        """Sum of a counter/gauge family across all label sets (0.0 when
        the family does not exist yet — reads never create)."""
        family = self._metrics.get(name)
        if not family:
            return 0.0
        return sum(m.value if not isinstance(m, Histogram) else m.count
                   for m in family.values())

    def get(self, name: str, **labels):
        """The live instrument for one (name, labels), or None."""
        return self._metrics.get(name, {}).get(_label_key(labels))

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Everything, JSON-able: ``{name: {label_str: value}}`` (scalar
        for counters/gauges, a count/sum/min/max dict for histograms)."""
        return {name: {_label_str(k): m._render()
                       for k, m in sorted(family.items())}
                for name, family in sorted(self._metrics.items())}

    def render_prom(self) -> str:
        """Prometheus text exposition of every family (histograms as the
        summary subset: ``_count``/``_sum`` plus min/max gauges)."""
        lines: List[str] = []
        for name in self.names():
            cls = self._kinds[name]
            family = self._metrics[name]
            if cls is Histogram:
                lines.append(f"# TYPE {name} summary")
                for key, m in sorted(family.items()):
                    ls = _label_str(key)
                    lines.append(f"{name}_count{ls} {m.count}")
                    lines.append(f"{name}_sum{ls} {_fmt(m.total)}")
                    lines.append(f"{name}_min{ls} {_fmt(m.vmin)}")
                    lines.append(f"{name}_max{ls} {_fmt(m.vmax)}")
            else:
                lines.append(f"# TYPE {name} {cls.kind}")
                for key, m in sorted(family.items()):
                    lines.append(f"{name}{_label_str(key)} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- reset -------------------------------------------------------------

    def reset(self, name: Optional[str] = None) -> None:
        """Zero instruments in place (cached references stay live). With
        ``name``, only that family; otherwise everything."""
        families: Iterable[Dict[LabelKey, object]]
        if name is not None:
            families = ([self._metrics[name]] if name in self._metrics
                        else [])
        else:
            families = self._metrics.values()
        for family in families:
            for m in family.values():
                m._zero()


def _fmt(v: float) -> str:
    # NaN first: an empty histogram's min/max render as NaN, and int(nan)
    # raises
    if isinstance(v, float) and math.isfinite(v) and v == int(v) \
            and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


registry = MetricsRegistry()


def snapshot() -> Dict[str, Dict[str, object]]:
    """``obs.snapshot()`` — the process registry as one JSON-able dict."""
    return registry.snapshot()


def render_prom() -> str:
    """``obs.render_prom()`` — the process registry as Prometheus text."""
    return registry.render_prom()
