"""Kernel profiling hooks (port of ``repro.obs.profile``):
``obs.profile(plan, state)``.

A one-call harness around a plan's hot path: times ``plan.execute`` with
the library stopwatch (``core.timing.time_fn``: a warm-up call excluded,
then back-to-back calls between two synchronizes), wraps the timed region
in ``torch.profiler`` when a trace directory is asked for, and writes the
trace there as a Chrome trace (``plan_profile.trace.json``), and runs the
model-vs-measured traffic audit (:mod:`repro_torch.obs.audit`) on the same
positions. Results land in three places at once: the returned
:class:`ProfileReport`, a ``plan.profile`` span in the tracer, and the
port's registry (the ``repro_torch_execute_seconds`` histogram and the
model-drift gauge).

What differs from JAX: a profiler that cannot start raises, where JAX's
harness quietly falls back to timing only. ``seconds_per_call`` always
comes from the stopwatch, never from the trace: ``torch.profiler`` may
drop some of the card's records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
from typing import Optional

from . import audit as _audit
from . import metrics as _metrics
from .trace import trace as _trace_span

__all__ = ["ProfileReport", "profile"]

EXEC_HIST = "repro_torch_execute_seconds"
TRACE_FILE = "plan_profile.trace.json"


@dataclasses.dataclass(frozen=True)
class ProfileReport:
    """What one :func:`profile` call measured."""

    seconds_per_call: float
    reps: int
    backend: str
    strategy: str
    layout: str
    modelled_bpi: float          # traffic model's bytes / interaction
    measured_bpi: float          # occupancy-probe measured estimate
    drift: float                 # measured / modelled - 1
    interactions: float          # measured candidate pair slots
    profiler_dir: Optional[str]  # directory of the Chrome trace, or None


def profile(plan, state, *, reps: Optional[int] = None,
            budget_s: float = 0.2,
            trace_dir: Optional[str] = None) -> ProfileReport:
    """Time one plan on one state, audit the traffic model, record both.

    ``trace_dir`` asks for a ``torch.profiler`` trace of the timed region
    (CPU activity, and the card's where the plan runs there), written to
    ``<trace_dir>/plan_profile.trace.json`` (Perfetto, chrome://tracing)."""
    import torch

    from ..core.api import active_unit_count, n_units
    from ..core.timing import time_fn

    prof = None
    ctx = contextlib.nullcontext()
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if plan.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        ctx = prof = torch.profiler.profile(activities=activities)
    with _trace_span("plan.profile", backend=plan.backend,
                     strategy=plan.strategy, layout=plan.layout) as sp:
        with ctx:
            secs, r = time_fn(plan.execute, state, reps=reps,
                              budget_s=budget_s)
        sp.set(seconds_per_call=secs, reps=r)
    if prof is not None:
        out = pathlib.Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / TRACE_FILE))

    fill = 1.0
    if plan.compact:
        fill = (active_unit_count(plan.domain, state.positions,
                                  plan.strategy, box=plan.box)
                / max(n_units(plan.domain, plan.strategy, box=plan.box), 1))
    aud = _audit.audit_candidate(
        plan.domain, state.positions, strategy=plan.strategy, m_c=plan.m_c,
        layout=plan.layout, compact=plan.compact, subbox=plan.box,
        fill=fill, valid=state.valid)

    _metrics.registry.histogram(
        EXEC_HIST, backend=plan.backend, strategy=plan.strategy,
        layout=plan.layout).observe(secs)
    return ProfileReport(
        seconds_per_call=secs, reps=r, backend=plan.backend,
        strategy=plan.strategy, layout=plan.layout,
        modelled_bpi=aud["modelled_bpi"], measured_bpi=aud["measured_bpi"],
        drift=aud["drift"], interactions=aud["interactions"],
        profiler_dir=None if trace_dir is None else str(trace_dir))
