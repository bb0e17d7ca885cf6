"""Structured tracing spans and events (port of ``repro.obs.trace``).

One process-wide tracer with its own ring buffer, separate from the JAX
package's, off by default. When enabled (``obs.enable()``, the
``obs.tracing()`` context manager, or the ``REPRO_TORCH_OBS_TRACE``
environment variable), instrumented code records *spans* — named,
attributed durations from ``with obs.trace(name, **attrs):`` — and
instantaneous *events* (``obs.event(name, **attrs)``) into a bounded
in-memory ring buffer. When disabled, ``trace()`` returns a shared no-op
span and ``event()`` returns immediately: a caller pays one predicate and
nothing is recorded.

Exports: :func:`export_jsonl` (one JSON object per record) and
:func:`export_chrome_trace` (Chrome ``trace_event`` JSON — load it at
``chrome://tracing`` or https://ui.perfetto.dev). The records have the
JAX package's schema, so ``tools/trace_view.py`` reads the JSONL form too.

Record schema (the JSONL form)::

    {"name": "autotune.time", "ph": "X",    # "X" span | "i" instant
     "ts": 0.0123,                          # seconds since enable()
     "dur": 0.0004,                         # seconds (spans only)
     "tid": 140023, "attrs": {...}}

The buffer is a ``collections.deque(maxlen=capacity)``: a long run keeps
the newest ``capacity`` records and counts what it dropped
(:func:`stats`).
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import threading
import time
from typing import Deque, Dict, List, Optional

__all__ = ["trace", "event", "enable", "disable", "tracing",
           "tracing_enabled", "spans", "clear", "stats",
           "export_jsonl", "export_chrome_trace", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 65536

_enabled = False
_buf: Deque[dict] = collections.deque(maxlen=DEFAULT_CAPACITY)
_t0 = 0.0
_total = 0                 # records ever offered (drops = _total - len(_buf))


def tracing_enabled() -> bool:
    """True while the tracer records (the one predicate hot paths pay)."""
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on. ``capacity`` resizes the ring buffer (existing
    records are kept up to the new bound); the time origin is set on the
    first enable only, so re-enabling composes with earlier records."""
    global _enabled, _buf, _t0
    if capacity is not None and capacity != _buf.maxlen:
        _buf = collections.deque(_buf, maxlen=int(capacity))
    if not _enabled and _t0 == 0.0:
        _t0 = time.perf_counter()
    _enabled = True


def disable() -> None:
    """Turn tracing off (records are kept; ``clear()`` drops them)."""
    global _enabled
    _enabled = False


def clear() -> None:
    """Drop every recorded span/event and reset the drop accounting."""
    global _total, _t0
    _buf.clear()
    _total = 0
    _t0 = time.perf_counter() if _enabled else 0.0


def spans() -> List[dict]:
    """The recorded span/event dicts, oldest first (a copy)."""
    return list(_buf)


def stats() -> Dict[str, int]:
    """Ring-buffer accounting: recorded / capacity / dropped."""
    return {"recorded": len(_buf), "capacity": int(_buf.maxlen or 0),
            "dropped": _total - len(_buf), "enabled": int(_enabled)}


class tracing:
    """Context manager: tracing on inside, restored outside.

    >>> with obs.tracing():
    ...     plan.execute(state)
    ... obs.export_chrome_trace("trace.json")
    """

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity
        self._was = False

    def __enter__(self):
        self._was = _enabled
        enable(self._capacity)
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._was:
            disable()
        return False


def _record(rec: dict) -> None:
    global _total
    _total += 1
    _buf.append(rec)


class _Span:
    """A live span: ``with obs.trace(name, **attrs) as sp: sp.set(...)``.
    Recorded at exit; an exception inside marks ``attrs["error"]``."""

    __slots__ = ("name", "attrs", "_start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._start = 0.0

    def set(self, **attrs) -> "_Span":
        """Annotate the span mid-flight (no-op on the disabled tracer)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _record({"name": self.name, "ph": "X", "ts": self._start - _t0,
                 "dur": end - self._start, "tid": threading.get_ident(),
                 "attrs": self.attrs})
        return False


class _NullSpan:
    """The shared disabled-tracer span: every operation is a no-op."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullSpan()


def trace(name: str, **attrs):
    """A span context manager around a named operation.

    Cheap by construction: when tracing is disabled this returns one
    shared no-op object — no allocation, no clock read, nothing recorded.
    Attribute values should be JSON-able scalars (str/int/float/bool)."""
    if not _enabled:
        return _NULL
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Record one instantaneous event (Chrome ``ph: "i"``)."""
    if not _enabled:
        return
    _record({"name": name, "ph": "i", "ts": time.perf_counter() - _t0,
             "tid": threading.get_ident(), "attrs": attrs})


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def export_jsonl(path) -> int:
    """Write the buffer as JSON Lines (one record per line). -> count."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    recs = spans()
    with open(p, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, default=str) + "\n")
    return len(recs)


def chrome_events(records: Optional[List[dict]] = None) -> List[dict]:
    """The buffer (or ``records`` in the JSONL schema) as Chrome
    ``trace_event`` dicts — ``ts``/``dur`` in microseconds, span records
    as complete ("X") events, instants as "i" (thread scope)."""
    pid = os.getpid()
    out = []
    for rec in (spans() if records is None else records):
        ev = {"name": rec["name"], "ph": rec["ph"],
              "ts": rec["ts"] * 1e6, "pid": pid, "tid": rec["tid"],
              "args": rec.get("attrs", {})}
        if rec["ph"] == "X":
            ev["dur"] = rec.get("dur", 0.0) * 1e6
        else:
            ev["s"] = "t"
        out.append(ev)
    return out


def export_chrome_trace(path, records: Optional[List[dict]] = None) -> int:
    """Write the buffer (or ``records``) as a Chrome ``trace_event`` file
    (``{"traceEvents": [...]}``) viewable at ``chrome://tracing`` or
    https://ui.perfetto.dev. -> event count."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    evs = chrome_events(records)
    with open(p, "w") as f:
        json.dump({"traceEvents": evs,
                   "displayTimeUnit": "ms"}, f, default=str)
    return len(evs)


if os.environ.get("REPRO_TORCH_OBS_TRACE", "").strip() not in ("", "0"):
    enable()
