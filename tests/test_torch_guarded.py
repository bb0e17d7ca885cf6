"""Guarded execution (``execute_checked``), serving under chaos, the
steady-state counters and ``obs.profile`` of the port, against the JAX
package's.

The same requests and the same seeded fault schedule go through both
packages: ``ExecutionReport`` fields (status, overflow, replans, retries,
nonfinite, out-of-domain, fault texts, ladder level, breaker trips,
recovery) equal, with ``"cuda"`` where JAX says ``"pallas"``; the serving
engine's statuses and counters equal; forces within a scale-relative 3e-4
of JAX's and, within the port, bit-equal to ``execute``. Where JAX catches
a real exception of the executor, the port lets it through: that is
tested too. The counters, spans and profile follow JAX's operation for
operation.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.core import ParticleState as JState
from repro.core import api as japi
from repro.core import plan as j_plan
from repro.core.domain import Domain as JDomain
from repro.serve import ServingEngine as JEngine
from repro.testing import chaos as jchaos
from repro_torch import obs
from repro_torch.convert import domain_from_jax
from repro_torch.core import (ExecutionReport, ParticleState,
                              clear_executor_cache, degradation_ladder,
                              dispatch_count, make_lennard_jones, plan,
                              plan_health, recompile_count, reset_counters)
from repro_torch.core import api
from repro_torch.core import autotune as at
from repro_torch.serve import (RESPONSE_STATUSES, ServeMetrics,
                               ServingEngine, VirtualClock, classify)
from repro_torch.testing import chaos

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    clear_executor_cache()
    reset_counters()
    api.reset_health()
    japi.reset_health()
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()
    jobs.disable()
    jobs.clear()


class ManualClock:
    """A clock only the test moves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


JDOM = JDomain.cubic(4, cutoff=1.0)
DOM = domain_from_jax(JDOM)


def _pos(n=80, seed=0, side=4.0):
    return (np.random.default_rng(seed).random((n, 3)) * side).astype(
        np.float32)


def _states(n=80, seed=0):
    pos = _pos(n, seed)
    return ParticleState(torch.from_numpy(pos)), JState(jnp.asarray(pos))


def _plans(pos, **opts):
    """(port plan on the CPU, JAX plan) of one configuration. The port's
    "cuda" backend (its kernels' plain versions here) stands where JAX's
    reference backend does unless ``backend`` says otherwise."""
    mine = plan(DOM, make_lennard_jones(), positions=torch.from_numpy(pos),
                device="cpu", **opts)
    jopts = dict(opts)
    if jopts.get("backend") == "cuda":
        jopts.update(backend="pallas", interpret=True)
    from repro.core import make_lennard_jones as j_lj
    theirs = j_plan(JDOM, j_lj(), positions=jnp.asarray(pos), **jopts)
    return mine, theirs


FIELDS = ("status", "overflow", "replans", "retries", "nonfinite",
          "out_of_domain", "faults", "ladder_level", "layout",
          "breaker_trips", "recovered", "shard_shrinks")


def _same_report(mine, theirs):
    assert isinstance(mine, ExecutionReport)
    for f in FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    want = {"pallas": "cuda"}.get(theirs.backend, theirs.backend)
    assert mine.backend == want


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _close(got, want, tol=3e-4):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


def _both(p, jp, state, jstate, specs=(), seed=0, **kw):
    """execute_checked under the same schedule in both packages."""
    clocks = (VirtualClock(), VirtualClock())
    out = []
    for mod, pl, st, clock in ((chaos, p, state, clocks[0]),
                               (jchaos, jp, jstate, clocks[1])):
        with mod.inject(*(mod.FaultSpec(*s[:2], **s[2]) for s in specs),
                        seed=seed):
            out.append(pl.execute_checked(st, sleep=clock.advance, **kw))
    assert clocks[0].now() == clocks[1].now()
    return out


# ---------------------------------------------------------------------------
# execute_checked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_clean_path_bit_identical_and_report_as_jax(backend):
    state, jstate = _states()
    p, jp = _plans(_pos(), strategy="xpencil", backend=backend)
    (f, u), report = p.execute_checked(state)
    _bitwise((f, u), p.execute(state))
    (jf, ju), jreport = jp.execute_checked(jstate)
    _same_report(report, jreport)
    assert report.status == "ok" and report.plan is p
    _close((f, u), (jf, ju))


@pytest.mark.parametrize("name,specs,kw", [
    ("nonfinite", [("core.dispatch", "nonfinite", dict(max_fires=1))], {}),
    ("always failing", [("core.dispatch", "error", {})],
     dict(max_retries=5)),
    ("straggler", [("core.dispatch", "delay",
                    dict(param=1.5, max_fires=1))], {}),
    ("forced overflow", [("core.binning", "overflow", {})],
     dict(max_replans=3)),
    ("shard loss, one shard", [("core.dispatch", "shard_loss",
                                dict(max_fires=2))], {}),
    ("mixed", [("core.dispatch", "error", dict(p=0.4)),
               ("core.dispatch", "nonfinite", dict(p=0.2)),
               ("core.dispatch", "delay", dict(p=0.3, param=0.01)),
               ("core.binning", "overflow", dict(p=0.2))], {}),
])
def test_faults_take_jaxs_branches(name, specs, kw):
    state, jstate = _states()
    p, jp = _plans(_pos(), strategy="xpencil", backend="reference")
    want = p.execute(state)
    seeds = range(5) if name == "mixed" else (0,)
    for seed in seeds:
        ((f, u), report), ((jf, ju), jreport) = _both(
            p, jp, state, jstate, specs, seed=seed, **kw)
        _same_report(report, jreport)
        if report.status == "failed":
            assert not f.any() and not u.any()
            assert f.shape == (80, 3) and u.shape == (80,)
        else:
            _bitwise((f, u), want)
            _close((f, u), (jf, ju))
    if name == "always failing":
        assert report.status == "failed" and report.retries == 6
    if name == "nonfinite":
        assert report.nonfinite == 1 and report.retries == 1
        assert report.faults == ["_NonFiniteOutput: 1 non-finite output "
                                 "element(s)"]
    if name == "forced overflow":
        assert report.overflow == "injected" and report.replans == 1


def test_breaker_trips_down_and_recovers_as_jax():
    state, jstate = _states()
    p, jp = _plans(_pos(), strategy="xpencil", layout="packed",
                   backend="reference")
    want = p.execute(state)
    trip = [("core.dispatch", "error",
             dict(max_fires=api._FAILURE_THRESHOLD))]
    ((f, u), report), (_, jreport) = _both(p, jp, state, jstate, trip)
    _same_report(report, jreport)
    assert report.status == "degraded" and report.layout == "dense"
    assert plan_health(p).level == 1
    _bitwise((f, u), want)
    recovered = []
    for _ in range(api._RECOVERY_THRESHOLD):
        (_, r), (_, jr) = _both(p, jp, state, jstate)
        _same_report(r, jr)
        recovered.append(r.recovered)
    assert any(recovered) and plan_health(p).level == 0


def test_cuda_plan_on_the_cpu_steps_onto_reference_as_pallas_does():
    """On the CPU a "cuda" plan's ladder starts with cuda -> reference,
    as JAX's pallas -> reference; the trip lands on the same rung."""
    state, jstate = _states()
    p, jp = _plans(_pos(), strategy="xpencil", backend="cuda")
    assert [r.backend for r in degradation_ladder(p)] == ["cuda",
                                                           "reference"]
    trip = [("core.dispatch", "error",
             dict(max_fires=api._FAILURE_THRESHOLD))]
    ((f, u), report), (_, jreport) = _both(p, jp, state, jstate, trip)
    _same_report(report, jreport)
    assert report.backend == "reference" and report.status == "degraded"
    _bitwise((f, u), p.execute(state))


def test_out_of_domain_counted_as_jax():
    pos = _pos()
    pos[:5] += 10.0                        # five particles past the box
    state, jstate = ParticleState(torch.from_numpy(pos)), JState(
        jnp.asarray(pos))
    p, jp = _plans(_pos(), strategy="xpencil", backend="reference")
    (_, report), (_, jreport) = _both(p, jp, state, jstate)
    _same_report(report, jreport)
    assert report.out_of_domain == 5


def test_output_check_one_system_and_stacked():
    forces = torch.zeros(2, 6, 3)
    pot = torch.zeros(2, 6)
    forces[0, 1, 2] = math.nan
    pot[1, 5] = math.inf
    pos = torch.full((2, 6, 3), 1.0)
    pos[1, 0, 0] = -1.0
    valid = torch.ones(2, 6, dtype=torch.bool)
    assert api._output_check(forces, pot, pos, valid, (4.0,) * 3) == (2, 1)
    valid[1, 5] = False                    # a padding row is not counted
    assert api._output_check(forces, pot, pos, valid, (4.0,) * 3) == (1, 1)
    assert api._output_check(forces[0], pot[0], pos[0], None,
                             (4.0,) * 3) == (1, 0)


def test_a_real_exception_propagates(monkeypatch):
    """JAX's execute_checked and engine catch a RuntimeError of the
    executor; the port's let it through, so a CUDA error or a failed build
    is never hidden behind retries."""
    state, _ = _states()
    p, _ = _plans(_pos(), strategy="xpencil", backend="reference")

    def broken(self, states):
        raise RuntimeError("a kernel failed")
    monkeypatch.setattr(api._Executor, "batch", broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        p.execute_checked(state)
    eng = ServingEngine(max_batch=1, device="cpu")
    with pytest.raises(RuntimeError, match="a kernel failed"):
        eng.submit(DOM, state)
    assert eng.metrics.faults == 0


# ---------------------------------------------------------------------------
# serving under chaos, against JAX's engine
# ---------------------------------------------------------------------------

def _engines(**kw):
    plan_opts = kw.pop("plan_opts", {"strategy": "xpencil"})
    return (ServingEngine(clock=ManualClock(), device="cpu",
                          plan_opts=plan_opts, **kw),
            JEngine(clock=ManualClock(), plan_opts=plan_opts, **kw))


def _drain(eng, max_rounds=500):
    for _ in range(max_rounds):
        if eng.pending() == 0:
            return
        eng.clock.advance(eng.retry_cap_s)
        eng.flush()
    raise AssertionError(f"queue did not drain ({eng.pending()} pending)")


def _serve(eng, jeng, workload, specs=(), seed=0, poll_every=None):
    """The same workload and fault schedule through both engines. ->
    (port responses by id, JAX responses by id, port fires, JAX fires)."""
    out = []
    for e, dom, mod, k in ((eng, DOM, chaos, 0), (jeng, JDOM, jchaos, 1)):
        with mod.inject(*(mod.FaultSpec(*s[:2], **s[2]) for s in specs),
                        seed=seed) as st:
            for n, s, deadline in workload:
                e.submit(dom, _states(n, s)[k], deadline_s=deadline)
                if poll_every is not None:
                    e.clock.advance(poll_every)
                    e.poll()
            _drain(e)
            fired = st.fire_count()
        out.append(({r.req_id: r for r in e.take_responses()}, fired))
    (mine, f1), (theirs, f2) = out
    return mine, theirs, f1, f2


def _same_serving(eng, jeng, mine, theirs):
    assert sorted(mine) == sorted(theirs)
    for rid, r in mine.items():
        jr = theirs[rid]
        assert (r.status, r.attempts, r.shape_class) == (
            jr.status, jr.attempts, jr.shape_class), rid
        if r.status == "ok":
            _close((r.forces, r.potential), (jr.forces, jr.potential))
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    for k in snap:
        if k not in ("recompiles", "rps", "queue_latency", "dispatch_latency",
                     "total_latency"):
            assert str(snap[k]) == str(jsnap[k]), k      # nan == nan


def test_serving_retries_bounded_and_terminal_as_jax():
    eng, jeng = _engines(max_batch=2, max_wait=0.01, max_retries=3)
    mine, theirs, *_ = _serve(eng, jeng, [(40, i, None) for i in range(4)],
                              [("serve.dispatch", "error", {})])
    _same_serving(eng, jeng, mine, theirs)
    assert all(r.status == "failed" and r.attempts == 4
               for r in mine.values())
    assert eng.metrics.failed == 4 and eng.pending() == 0


def test_transient_fault_recovers_with_parity():
    eng, jeng = _engines(max_batch=2, max_wait=0.01)
    mine, theirs, *_ = _serve(eng, jeng, [(40, 0, None)],
                              [("serve.dispatch", "error",
                                dict(max_fires=1))])
    _same_serving(eng, jeng, mine, theirs)
    (r,) = mine.values()
    assert r.status == "ok" and r.attempts == 1
    sc = classify(DOM, eng.kernel, 40, (), eng.min_n_cap)
    _bitwise((r.forces, r.potential),
             eng.class_plan(sc).execute(_states(40, 0)[0]))


def test_class_breaker_quarantines_onto_reference_on_the_cpu():
    """JAX's breaker contract on the port: the class moves onto
    ``fallback_plan`` (on the CPU the reference backend, dense), answers
    bit-identically there and is restored after the recovery streak."""
    eng, jeng = _engines(max_batch=1, max_wait=0.01, max_retries=0,
                         breaker_threshold=2, breaker_recovery=2,
                         plan_opts={"strategy": "xpencil",
                                    "layout": "packed"})
    sc = classify(DOM, eng.kernel, 40, (), eng.min_n_cap)
    mine, theirs, *_ = _serve(eng, jeng, [(40, 0, None), (40, 1, None)],
                              [("serve.dispatch", "error",
                                dict(max_fires=2))])
    _same_serving(eng, jeng, mine, theirs)
    assert eng.class_breaker(sc).open
    primary, quarantined = eng.class_primary(sc), eng.class_plan(sc)
    assert quarantined == api.fallback_plan(primary)
    assert (quarantined.backend, quarantined.layout) == ("reference",
                                                         "dense")
    state = _states(40, 5)[0]
    rid = eng.submit(DOM, state)
    eng.flush()
    (r,) = eng.take_responses()
    assert r.req_id == rid and r.status == "ok"
    _bitwise((r.forces, r.potential), primary.execute(state))
    eng.submit(DOM, _states(40, 9)[0])
    eng.flush()
    assert not eng.class_breaker(sc).open
    assert eng.metrics.breaker_closes == 1
    assert eng.metrics.breaker_open_classes == 0
    assert eng.class_plan(sc) == primary


def test_quarantine_does_not_poison_other_classes():
    eng, jeng = _engines(max_batch=1, max_wait=0.01, max_retries=0,
                         breaker_threshold=1, breaker_recovery=100)
    mine, theirs, *_ = _serve(eng, jeng, [(40, 0, None), (200, 1, None)],
                              [("serve.dispatch", "error",
                                dict(max_fires=1))])
    _same_serving(eng, jeng, mine, theirs)
    small = classify(DOM, eng.kernel, 40, (), eng.min_n_cap)
    big = classify(DOM, eng.kernel, 200, (), eng.min_n_cap)
    assert eng.class_breaker(small).open
    assert eng.class_breaker(big) is None
    assert eng.class_primary(big) is None


@pytest.mark.parametrize("seed", [42, 7])
def test_mixed_fault_schedule_matches_jax(seed):
    """A seeded mixed schedule over a workload with deadlines: the same
    statuses, attempts and counters as JAX's engine; nothing raises, the
    queue drains, every "ok" is bit-equal to its class plan's execute."""
    eng, jeng = _engines(max_batch=4, max_wait=0.01, max_retries=3)
    workload = [(40 + 10 * (i % 3), i, None if i % 5 else 0.02)
                for i in range(24)]
    specs = [("serve.dispatch", "error", dict(p=0.3)),
             ("serve.dispatch", "delay", dict(p=0.2, param=0.02)),
             ("serve.dispatch", "nonfinite", dict(p=0.1)),
             ("serve.dispatch", "shard_loss", dict(p=0.05))]
    mine, theirs, fired, jfired = _serve(eng, jeng, workload, specs,
                                         seed=seed, poll_every=0.005)
    assert fired == jfired > 0
    _same_serving(eng, jeng, mine, theirs)
    assert all(r.status in RESPONSE_STATUSES for r in mine.values())
    snap = eng.metrics.snapshot()
    assert snap["faults"] > 0
    assert (snap["served"] + snap["failed"] + snap["deadline_expired"]
            == len(workload))
    states = {i: _states(n, s)[0] for i, (n, s, _) in enumerate(workload)}
    for rid, r in mine.items():
        if r.status == "ok":
            sc = classify(DOM, eng.kernel, states[rid].n, (),
                          eng.min_n_cap)
            p = eng.class_primary(sc) or eng.class_plan(sc)
            _bitwise((r.forces, r.potential), p.execute(states[rid]))


def test_fault_free_serving_keeps_zero_builds():
    eng = ServingEngine(max_batch=4, max_wait=0.01, device="cpu")
    states = [_states(50, i)[0] for i in range(8)]

    def one_pass():
        for s in states:
            eng.submit(DOM, s)
            eng.clock.advance(0.02)
            eng.poll()
        eng.flush()
        return {r.req_id: r for r in eng.take_responses()}

    first = one_pass()
    eng.clock, eng.metrics = VirtualClock(), ServeMetrics()
    rc0, tr0 = recompile_count(), at.timing_run_count()
    second = one_pass()
    assert recompile_count() == rc0 and at.timing_run_count() == tr0
    assert all(r.status == "ok" for r in second.values())
    for a, b in zip(sorted(first), sorted(second)):
        _bitwise((first[a].forces, first[a].potential),
                 (second[b].forces, second[b].potential))
    snap = eng.metrics.snapshot()
    assert snap["faults"] == snap["retries"] == snap["failed"] == 0


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------

def test_counters_and_one_reset(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    state, _ = _states()
    p, _ = _plans(_pos(), strategy="xpencil")
    p.execute(state)
    p.execute(state)
    p.execute_batch(ParticleState(state.positions[None]))
    assert dispatch_count() == 3
    assert recompile_count() == 2             # single and batch executor
    p.replan(ParticleState(state.positions * 0 + 0.5))   # all in one cell
    assert api.replan_count() == 1
    p.replan(state)                           # nothing to grow
    assert api.replan_count() == 1
    at.tune(DOM, make_lennard_jones(), state.positions, top_k=2, reps=1,
            budget_s=0.01)
    assert at.timing_run_count() > 0
    text = obs.render_prom()
    assert ('repro_torch_dispatch_total{backend="cuda",layout="dense",'
            'strategy="xpencil"} 3') in text
    reset_counters()
    for fn in (dispatch_count, recompile_count, api.replan_count,
               at.timing_run_count):
        assert fn() == 0, fn.__name__
    p.execute(state)
    assert dispatch_count() == 1 and recompile_count() == 0


def test_spans_only_while_tracing_and_named_as_jax():
    state, jstate = _states()
    p, jp = _plans(_pos(), strategy="xpencil", backend="reference")
    p.execute(state)
    p.execute_batch(ParticleState(state.positions[None]))
    assert obs.spans() == []                  # the disabled path
    names = []
    for o, pl, st, stack in ((obs, p, state, ParticleState),
                             (jobs, jp, jstate, JState)):
        o.enable()
        pl.execute(st)
        pl.execute_batch(stack(st.positions[None]))
        pl.execute_checked(st)
        pl.replan(stack(st.positions * 0 + 0.5))
        names.append([r["name"] for r in o.spans()])
        o.disable()
    assert names[0] == names[1]
    assert {"plan.execute", "plan.execute_batch", "plan.execute_checked",
            "plan.replan"} <= set(names[0])


# ---------------------------------------------------------------------------
# obs.profile
# ---------------------------------------------------------------------------

def test_profile_times_audits_and_records_as_jax(tmp_path):
    state, jstate = _states(200, 3)
    p, jp = _plans(_pos(200, 3), strategy="xpencil", backend="reference")
    rep = obs.profile(p, state, budget_s=0.02)
    jrep = jobs.profile(jp, jstate, budget_s=0.02)
    assert rep.seconds_per_call > 0 and rep.reps >= 1
    for f in ("backend", "strategy", "layout", "profiler_dir"):
        assert getattr(rep, f) == getattr(jrep, f), f
    for f in ("modelled_bpi", "measured_bpi", "drift", "interactions"):
        assert getattr(rep, f) == pytest.approx(getattr(jrep, f),
                                                rel=1e-6), f
    assert math.isfinite(rep.drift)
    h = obs.registry.get("repro_torch_execute_seconds", backend="reference",
                         strategy="xpencil", layout="dense")
    assert h.count == 1 and h.total == pytest.approx(rep.seconds_per_call)
    obs.enable()
    rep2 = obs.profile(p, state, reps=2, trace_dir=str(tmp_path / "tr"))
    names = [r["name"] for r in obs.spans()]
    assert names.count("plan.profile") == 1 and names[-1] == "traffic.audit"
    assert rep2.profiler_dir == str(tmp_path / "tr") and rep2.reps == 2
    trace = json.loads((tmp_path / "tr" / "plan_profile.trace.json"
                        ).read_text())
    assert trace["traceEvents"]


def test_profile_of_a_compacted_plan_audits_its_fill():
    pos = _pos(60, 4) * 0.5                   # a corner of the box
    state, jstate = ParticleState(torch.from_numpy(pos)), JState(
        jnp.asarray(pos))
    p, jp = _plans(pos, strategy="xpencil", compact=True,
                   backend="reference")
    rep = obs.profile(p, state, reps=1)
    jrep = jobs.profile(jp, jstate, reps=1)
    assert rep.drift == pytest.approx(jrep.drift, rel=1e-6)
    assert rep.modelled_bpi == pytest.approx(jrep.modelled_bpi, rel=1e-6)
