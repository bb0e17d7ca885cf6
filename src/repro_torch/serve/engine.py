"""ServingEngine: the continuous-batching front door (port of
``repro.serve.engine``).

Requests of varying ``(N, domain, kernel, fields)`` arrive one at a time;
the engine normalizes each onto a :class:`~repro_torch.serve.bucketing.
ShapeClass` (padded N cap + grid + kernel digest + field names), queues
compatible requests together, and dispatches each bucket, when it fills to
``max_batch`` or its oldest request has waited ``max_wait``, through one
``plan.execute_batch`` call: on the card, one chain of kernel launches
for the whole batch. Per class it keeps a plan (built once from the first
request, by the measured autotuner when ``autotune=True``) and relies on
the core executor LRU to keep that plan's executor warm, so steady-state
traffic performs **zero executor builds and zero autotune timing runs**
(``core.recompile_count()`` / ``core.autotune.timing_run_count()``).

Admission control bounds the queue: when ``max_queue`` requests are
already waiting, policy ``"reject"`` refuses the newcomer and policy
``"shed_oldest"`` evicts the longest-waiting request to admit it (both
produce terminal Responses, counted in metrics). A request whose
particles overflow the class plan's static bounds triggers a per-class
replan (the :meth:`InteractionPlan.replan` contract) that replaces only
that class's plan; other classes keep their warm executors.

Time comes from an injectable clock (default: a fresh
:class:`~repro_torch.serve.metrics.VirtualClock`). Arrival timestamps are
whatever the clock reads at ``submit``; each dispatch advances the clock
by the *measured* wall time of stacking the batch, executing it and
checking its outputs, whose one host read waits for the card, so the
latency counts the card's work and not only the time to enqueue it.

**Resilience**: a request may carry a deadline; an expired request is
answered ``"deadline"`` and never takes a dispatch slot. A dispatch that
fails (an injected fault at the ``serve.dispatch`` fault point of
``repro_torch.testing.chaos``, or a non-finite output batch found by the
output check) re-queues its requests with bounded exponential backoff and
deterministic per-request jitter; a request that exhausts ``max_retries``
is answered ``"failed"``. Repeated failures trip a per-shape-class circuit
breaker that quarantines the class onto its fallback plan
(``core.api.fallback_plan``: dense and uncompacted; on the card it stays
on the kernels, on the CPU it is the reference backend); after
``breaker_recovery`` consecutive clean dispatches the primary plan (and
its still-warm executor) is restored.

What differs from JAX: nothing is caught. JAX's dispatch also catches any
``RuntimeError``, ``ValueError`` or ``FloatingPointError`` of the
executor; here such a real exception (a CUDA error, a failed nvcc build)
propagates out of ``submit``/``poll``/``flush``, so a broken kernel is
never hidden behind retries.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional

import torch

from ..core import api
from ..core import autotune as at
from ..core._device import resolve_device
from ..core.api import InteractionPlan, ParticleState, plan as make_plan
from ..core.domain import Domain
from ..core.interactions import PairKernel, make_lennard_jones
from ..obs.trace import event as _obs_event, trace as _obs_trace
from ..testing import chaos
from .bucketing import (MIN_N_CAP, ShapeClass, classify, quantize_batch,
                        split_batch, stack_states)
from .metrics import ServeMetrics, VirtualClock

__all__ = ["Request", "Response", "ServingEngine", "ADMISSION_POLICIES",
           "RESPONSE_STATUSES"]

ADMISSION_POLICIES = ("reject", "shed_oldest")

RESPONSE_STATUSES = ("ok", "rejected", "shed", "deadline", "failed")


@dataclasses.dataclass
class Request:
    """One admitted unit of work, as tracked internally."""
    req_id: int
    shape_class: ShapeClass
    state: ParticleState            # raw, unpadded (N rows)
    kernel: PairKernel
    t_submit: float
    deadline: Optional[float] = None   # absolute clock time; None = never
    attempts: int = 0                  # failed dispatch attempts so far
    not_before: float = 0.0            # retry backoff holdback


@dataclasses.dataclass
class Response:
    """Terminal outcome of a request. ``status`` is one of
    ``RESPONSE_STATUSES``: ``"ok"`` (results attached, trimmed to the
    request's true N), ``"rejected"`` (admission refused — queue full
    under the reject policy), ``"shed"`` (evicted by shed_oldest after
    admission), ``"deadline"`` (expired before results — never given a
    dispatch slot past its deadline) or ``"failed"`` (every retry of a
    faulting dispatch exhausted). Latencies are clock-seconds; None for
    requests that never dispatched."""
    req_id: int
    status: str
    forces: Optional[torch.Tensor] = None
    potential: Optional[torch.Tensor] = None
    shape_class: Optional[str] = None
    queue_latency: Optional[float] = None
    dispatch_latency: Optional[float] = None
    total_latency: Optional[float] = None
    attempts: int = 0


@dataclasses.dataclass
class _ClassBreaker:
    """Per-shape-class circuit breaker (hysteresis: consecutive counts)."""
    open: bool = False
    consec_failures: int = 0
    consec_clean: int = 0


class ServingEngine:
    """Continuous-batching front door over the plan/execute API.

    Args:
      kernel: default pair kernel for requests that don't bring their own.
      max_batch: bucket dispatch threshold and upper batch-shape cap; live
        batches are padded up to the next power of two below this, so the
        steady state sees a handful of batch shapes per class, not one per
        occupancy level.
      max_queue: admission bound on the total number of waiting requests.
      admission: ``"reject"`` (refuse the newcomer) or ``"shed_oldest"``
        (evict the longest-waiting request to make room).
      max_wait: clock-seconds a bucket's oldest request may wait before
        ``poll()`` dispatches the bucket part-full.
      autotune: build each class's plan with ``strategy="autotune"``
        (measured winners, persisted in the on-disk cache) instead of the
        analytical ``"auto"`` model.
      clock: injectable time source (``() -> float``); defaults to a fresh
        VirtualClock. Pass ``time.perf_counter`` for wall-clock serving.
      min_n_cap: smallest shape-class particle cap (see bucketing).
      plan_opts: extra keyword arguments forwarded to ``plan()``
        (e.g. ``strategy="xpencil"``, ``layout="packed"``); ignored when
        ``autotune=True``.
      tune_opts: extra keyword arguments forwarded to ``tune()`` when
        ``autotune=True`` (e.g. ``budget_s=0.05``).
      max_retries: failed dispatch attempts a request survives before a
        terminal ``"failed"`` response (the retry bound).
      retry_base_s / retry_cap_s: exponential-backoff schedule for
        re-queued requests — attempt k is held back
        ``base * 2**(k-1)`` seconds (capped at ``retry_cap_s``), scaled
        by a deterministic per-request jitter so retry waves decorrelate
        reproducibly.
      breaker_threshold / breaker_recovery: consecutive failed dispatches
        that quarantine a shape class onto its fallback plan, and
        consecutive clean dispatches that restore the primary.
      device: where the plans run and the batches are stacked; None means
        the CUDA card (raises without one), ``"cpu"`` the plain versions.
        Requests may lie on the host: each batch moves in one copy.
    """

    def __init__(self, kernel: Optional[PairKernel] = None, *,
                 max_batch: int = 8, max_queue: int = 64,
                 admission: str = "reject", max_wait: float = 0.05,
                 autotune: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 min_n_cap: int = MIN_N_CAP,
                 plan_opts: Optional[dict] = None,
                 tune_opts: Optional[dict] = None,
                 max_retries: int = 3, retry_base_s: float = 0.005,
                 retry_cap_s: float = 0.5, breaker_threshold: int = 3,
                 breaker_recovery: int = 5, device=None):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {admission!r}; "
                             f"have {ADMISSION_POLICIES}")
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be positive")
        if max_retries < 0 or breaker_threshold < 1 or breaker_recovery < 1:
            raise ValueError("max_retries must be >= 0; breaker_threshold "
                             "and breaker_recovery must be >= 1")
        self.kernel = kernel or make_lennard_jones()
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.admission = admission
        self.max_wait = float(max_wait)
        self.autotune = bool(autotune)
        self.clock = clock if clock is not None else VirtualClock()
        self.min_n_cap = int(min_n_cap)
        self.plan_opts = dict(plan_opts or {})
        self.tune_opts = dict(tune_opts or {})
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_recovery = int(breaker_recovery)
        self.metrics = ServeMetrics()
        self._queues: Dict[ShapeClass, List[Request]] = {}
        self._plans: Dict[ShapeClass, InteractionPlan] = {}
        self._primary: Dict[ShapeClass, InteractionPlan] = {}
        self._breakers: Dict[ShapeClass, _ClassBreaker] = {}
        self._kernels: Dict[str, PairKernel] = {}
        self._responses: List[Response] = []
        self._next_id = 0

    # -- admission ---------------------------------------------------------

    def submit(self, domain: Domain, state: ParticleState,
               kernel: Optional[PairKernel] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit one request; returns its ``req_id``. The outcome arrives
        later as a :class:`Response` (drain with :meth:`take_responses`).
        A full queue resolves per the admission policy: ``"reject"``
        terminates the *newcomer* immediately; ``"shed_oldest"`` evicts
        the longest-waiting admitted request instead. Admission may also
        dispatch the request's bucket if it just filled.

        ``deadline_s`` (clock-seconds from now) bounds how long the
        request may wait: once expired it is answered ``"deadline"`` and
        never occupies a dispatch slot (an already-expired deadline
        terminates right here)."""
        kernel = kernel or self.kernel
        req_id = self._next_id
        self._next_id += 1
        now = self.clock()
        self.metrics.note_submit(now)
        deadline = None if deadline_s is None else now + float(deadline_s)
        if deadline is not None and deadline <= now:
            self.metrics.deadline_expired += 1
            self._responses.append(Response(req_id, "deadline"))
            _obs_event("serve.admission", req_id=req_id, outcome="deadline")
            return req_id
        if self._queued_total() >= self.max_queue:
            if self.admission == "reject":
                self.metrics.rejected += 1
                self._responses.append(Response(req_id, "rejected"))
                _obs_event("serve.admission", req_id=req_id,
                           outcome="rejected")
                return req_id
            self._shed_oldest()
        sc = classify(domain, kernel, state.positions.shape[0],
                      tuple(state.fields), self.min_n_cap)
        _obs_event("serve.admission", req_id=req_id, outcome="queued",
                   shape_class=sc.label())
        self._kernels.setdefault(sc.kernel_id, kernel)
        self._queues.setdefault(sc, []).append(
            Request(req_id, sc, state, kernel, now, deadline=deadline))
        if len(self._queues[sc]) >= self.max_batch:
            self._dispatch(sc)
        return req_id

    def _queued_total(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _shed_oldest(self) -> None:
        sc, queue = min(((sc, q) for sc, q in self._queues.items() if q),
                        key=lambda item: item[1][0].t_submit)
        victim = queue.pop(0)
        if not queue:
            del self._queues[sc]
        self.metrics.shed += 1
        self._responses.append(Response(victim.req_id, "shed",
                                        shape_class=sc.label()))
        _obs_event("serve.shed", req_id=victim.req_id,
                   shape_class=sc.label())

    # -- dispatch ----------------------------------------------------------

    def poll(self) -> int:
        """Dispatch every bucket that is full or whose oldest request has
        waited ``max_wait`` clock-seconds. Returns batches dispatched.
        Call after advancing the clock (or on a timer under wall-clock).
        Expired deadlines are swept first — an expired request neither
        occupies a dispatch slot nor holds its bucket open."""
        self._sweep_deadlines()
        now = self.clock()
        due = [sc for sc, q in self._queues.items()
               if len(q) >= self.max_batch
               or (q and now - q[0].t_submit >= self.max_wait)]
        for sc in due:
            self._dispatch(sc)
        return len(due)

    def flush(self) -> int:
        """Dispatch every non-empty bucket regardless of age or fill
        (retry holdbacks included — a flush is the drain-everything call).
        Returns batches dispatched."""
        self._sweep_deadlines()
        due = [sc for sc, q in self._queues.items() if q]
        for sc in due:
            self._dispatch(sc, drain=True)
        return len(due)

    def _sweep_deadlines(self) -> None:
        now = self.clock()
        for sc in list(self._queues):
            alive = []
            for req in self._queues[sc]:
                if req.deadline is not None and req.deadline <= now:
                    self.metrics.deadline_expired += 1
                    self._responses.append(Response(
                        req.req_id, "deadline", shape_class=sc.label(),
                        attempts=req.attempts))
                else:
                    alive.append(req)
            if alive:
                self._queues[sc] = alive
            else:
                del self._queues[sc]

    def take_responses(self) -> List[Response]:
        """Drain and return all terminal responses produced so far."""
        out, self._responses = self._responses, []
        return out

    def class_plan(self, sc: ShapeClass) -> Optional[InteractionPlan]:
        """The plan currently serving a shape class (None before its
        first dispatch) — the reference executor for parity checks. While
        the class's breaker is open this is the quarantine fallback plan;
        the primary is parked in :meth:`class_primary`."""
        return self._plans.get(sc)

    def class_primary(self, sc: ShapeClass) -> Optional[InteractionPlan]:
        """The parked primary plan of a quarantined class (None unless
        the breaker is open)."""
        return self._primary.get(sc)

    def class_breaker(self, sc: ShapeClass) -> Optional[_ClassBreaker]:
        """The class's circuit-breaker state (None before any failure)."""
        return self._breakers.get(sc)

    def pending(self) -> int:
        """Requests currently queued (including retry holdbacks) — zero
        once the workload is fully drained."""
        return self._queued_total()

    def prewarm(self, domain: Domain, state: ParticleState,
                kernel: Optional[PairKernel] = None) -> ShapeClass:
        """Cold-start avoidance: given one representative request, build
        the class's plan and its batched executor, and run it at **every**
        quantized batch size up to ``max_batch`` (the card's allocator and
        the kernel libraries warm up with it). After prewarming no bucket
        composition the dispatcher can form for this class builds
        anything; the steady state starts at request one. Returns the
        shape class."""
        kernel = kernel or self.kernel
        sc = classify(domain, kernel, state.positions.shape[0],
                      tuple(state.fields), self.min_n_cap)
        self._kernels.setdefault(sc.kernel_id, kernel)
        if sc not in self._plans:
            self._plans[sc] = self._build_plan(
                sc, Request(-1, sc, state, kernel, self.clock()))
        p = self._plans[sc]
        if p.check_overflow(state):
            p = p.replan(state)
            self.metrics.replans += 1
            self._plans[sc] = p
        b = 1
        while True:
            cap = quantize_batch(b, self.max_batch)
            batched = stack_states([state], sc.n_cap, cap, self.device)
            forces, potential = p.execute_batch(batched)
            api._output_check(forces, potential, batched.positions,
                              batched.valid, sc.domain.box)  # waits
            if cap >= self.max_batch:
                return sc
            b = cap + 1                  # next quantized size up

    # -- internals ---------------------------------------------------------

    def _build_plan(self, sc: ShapeClass,
                    first: Request) -> InteractionPlan:
        """Class plan from the first request's raw particles. Bounds are
        measured with the replan contract's slack, so siblings in the
        class usually fit without replanning; autotune winners persist in
        the on-disk cache, so a re-created engine re-tunes nothing."""
        if self.autotune:
            result = at.tune(sc.domain, first.kernel,
                             first.state.positions.to(self.device),
                             device=self.device, **self.tune_opts)
            self.metrics.autotune_cache_hits += int(result.cache_hit)
            return result.plan
        return make_plan(sc.domain, first.kernel,
                         positions=first.state.positions,
                         device=self.device, **self.plan_opts)

    def _dispatch(self, sc: ShapeClass, drain: bool = False) -> None:
        queue = self._queues.pop(sc, [])
        now = self.clock()
        # retry holdback: backed-off requests wait out their not_before
        # (except under flush(drain=True), the drain-everything call)
        ready = [r for r in queue if drain or r.not_before <= now]
        held = [r for r in queue if not (drain or r.not_before <= now)]
        if held:
            self._queues[sc] = held
        # a retry wave can leave more than max_batch ready requests in
        # the bucket — dispatch in batch-cap chunks, never one over-cap
        # batch (which would be a fresh executor shape)
        while ready:
            batch, ready = ready[:self.max_batch], ready[self.max_batch:]
            self._dispatch_batch(sc, batch)

    def _dispatch_batch(self, sc: ShapeClass, ready: List[Request]) -> None:
        with _obs_trace("serve.dispatch", shape_class=sc.label(),
                        requests=len(ready)) as sp:
            self._dispatch_batch_impl(sc, ready, sp)

    def _dispatch_batch_impl(self, sc: ShapeClass, ready: List[Request],
                             sp) -> None:
        rc0, tr0 = api.recompile_count(), at.timing_run_count()
        if sc not in self._plans:
            self._plans[sc] = self._build_plan(sc, ready[0])
        p = self._plans[sc]
        # Overflow safety net: grow this class's bounds to cover every
        # request in the bucket (replacing only this class's plan — the
        # new plan is a new executor-cache key; other classes stay warm).
        for req in ready:
            if p.check_overflow(req.state):
                p = p.replan(req.state)
                self.metrics.replans += 1
        self._plans[sc] = p

        b_cap = quantize_batch(len(ready), self.max_batch)
        t_dispatch = self.clock()
        t0 = _time.perf_counter()
        batched = stack_states([r.state for r in ready], sc.n_cap, b_cap,
                               self.device)
        # the serve-dispatch fault point: straggler latency rides the
        # engine clock; an injected error or shard loss takes JAX's except
        # branch without raising, as does a non-finite output batch
        # (injected or real) found by the output check, whose one host read
        # also waits for the card. A real exception propagates.
        chaos.maybe_delay(
            "serve.dispatch",
            sleep=(self.clock.advance
                   if isinstance(self.clock, VirtualClock)
                   else _time.sleep))
        fault = chaos.injected_fault("serve.dispatch")
        forces = potential = None
        if fault is None:
            forces, potential = p.execute_batch(batched)
            forces = chaos.corrupt("serve.dispatch", forces)
            bad, _ = api._output_check(forces, potential, batched.positions,
                                       batched.valid, sc.domain.box)
            if bad:
                self.metrics.nonfinite_batches += 1
                fault = chaos.TransientBackendError(
                    f"{bad} non-finite output element(s)")
        elapsed = _time.perf_counter() - t0
        if isinstance(self.clock, VirtualClock):
            self.clock.advance(elapsed)
        t_done = self.clock()
        self.metrics.recompiles += api.recompile_count() - rc0
        self.metrics.autotune_timing_runs += at.timing_run_count() - tr0

        if fault is not None:
            self.metrics.faults += 1
            sp.set(outcome="fault", fault=type(fault).__name__)
            self._note_class_failure(sc)
            self._requeue_failed(sc, ready, t_done)
            return

        self._note_class_success(sc)
        self.metrics.batches += 1
        self.metrics.batch_fill.record(len(ready) / b_cap)
        sp.set(outcome="ok", batch_cap=b_cap, fill=len(ready) / b_cap,
               seconds=elapsed)
        sizes = [r.state.positions.shape[0] for r in ready]
        for req, (f, pot) in zip(ready, split_batch(forces, potential,
                                                    sizes)):
            self.metrics.note_served(req.t_submit, t_dispatch, t_done)
            self._responses.append(Response(
                req.req_id, "ok", forces=f, potential=pot,
                shape_class=sc.label(),
                queue_latency=t_dispatch - req.t_submit,
                dispatch_latency=t_done - t_dispatch,
                total_latency=t_done - req.t_submit,
                attempts=req.attempts))

    # -- resilience internals ----------------------------------------------

    def _backoff(self, req: Request) -> float:
        """Exponential backoff with a cap and deterministic per-request
        jitter (a Knuth-hash fraction of ``req_id``): reproducible, and
        retry waves from one failed batch decorrelate instead of
        thundering back as one bucket."""
        base = self.retry_base_s * (2.0 ** max(req.attempts - 1, 0))
        jitter = 1.0 + 0.5 * (((req.req_id * 2654435761) & 0xFFFF)
                              / float(1 << 16))
        return min(base * jitter, self.retry_cap_s)

    def _requeue_failed(self, sc: ShapeClass, batch: List[Request],
                        now: float) -> None:
        """Route every request of a failed dispatch: bounded retry with
        backoff, or a terminal ``"failed"`` response past the bound."""
        retry: List[Request] = []
        for req in batch:
            req.attempts += 1
            if req.attempts > self.max_retries:
                self.metrics.failed += 1
                self._responses.append(Response(
                    req.req_id, "failed", shape_class=sc.label(),
                    attempts=req.attempts))
            else:
                self.metrics.retries += 1
                req.not_before = now + self._backoff(req)
                _obs_event("serve.retry", req_id=req.req_id,
                           attempts=req.attempts,
                           not_before=req.not_before)
                retry.append(req)
        if retry:
            # re-admit at the front: retried requests are the oldest and
            # keep their FIFO position for the shed/due bookkeeping
            self._queues.setdefault(sc, [])[:0] = retry

    def _note_class_failure(self, sc: ShapeClass) -> None:
        br = self._breakers.setdefault(sc, _ClassBreaker())
        br.consec_clean = 0
        br.consec_failures += 1
        if not br.open and br.consec_failures >= self.breaker_threshold:
            # quarantine: the class moves onto its fallback plan (dense,
            # uncompacted; on the card still the kernels, on the CPU the
            # reference backend). The primary plan object is parked
            # untouched, so its warm executor stays in the LRU and
            # restoration is a dict swap, not a rebuild.
            br.open = True
            br.consec_failures = 0
            self.metrics.breaker_opens += 1
            self.metrics.breaker_open_classes += 1
            _obs_event("serve.breaker", transition="open",
                       shape_class=sc.label())
            primary = self._plans.get(sc)
            if primary is not None:
                self._primary[sc] = primary
                self._plans[sc] = api.fallback_plan(primary)

    def _note_class_success(self, sc: ShapeClass) -> None:
        br = self._breakers.get(sc)
        if br is None:
            return
        br.consec_failures = 0
        if br.open:
            br.consec_clean += 1
            if br.consec_clean >= self.breaker_recovery:
                br.open = False
                br.consec_clean = 0
                self.metrics.breaker_closes += 1
                self.metrics.breaker_open_classes -= 1
                _obs_event("serve.breaker", transition="close",
                           shape_class=sc.label())
                if sc in self._primary:
                    self._plans[sc] = self._primary.pop(sc)
