"""The port's fault registry (``repro_torch.testing.chaos``) and circuit
breaker (``repro_torch.core.api``), against the JAX package's.

The same specs and seed fire on the same visits, draw for draw; the
exception-kind point raises (or, with ``injected_fault``, returns) what
JAX's raises, in its order; the ladder has JAX's rungs with ``"cuda"`` in
place of ``"pallas"``; the breaker trips and recovers on the same event
sequences. ``execute_checked`` and the serving tier under chaos are held
against JAX's in ``test_torch_guarded.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.core import api as japi
from repro.core import make_lennard_jones as j_lj, plan as j_plan
from repro.testing import chaos as jchaos
from repro_torch.convert import domain_from_jax
from repro_torch.core import (ParticleState, PlanHealth, degradation_ladder,
                              fallback_plan, make_lennard_jones, plan,
                              plan_health, reset_health)
from repro_torch.core import api
from repro_torch.testing import chaos


@pytest.fixture(autouse=True)
def _fresh_health():
    reset_health()
    japi.reset_health()
    yield
    reset_health()
    japi.reset_health()


def _pos(n=80, seed=0, side=4.0):
    return (np.random.default_rng(seed).random((n, 3)) * side).astype(
        np.float32)


SPEC_SETS = {
    "thinned": [("s", "error", dict(p=0.3))],
    "window": [("s", "error", dict(after=2, max_fires=3))],
    "mixed": [("traj.step", "error", dict(p=0.5, max_fires=4)),
              ("traj.step", "shard_loss", dict(p=0.2, after=3)),
              ("traj.step", "nonfinite", dict(p=0.7)),
              ("core.binning", "overflow", dict(p=0.4, after=1)),
              ("traj.step", "error", dict(p=0.9))],
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SPEC_SETS))
def test_fire_schedule_equals_jax(name, seed):
    """The same visits, in the same order, to both registries: the same
    fires, logs, counts and snapshots."""
    specs = SPEC_SETS[name]
    points = sorted({(s, k) for s, k, _ in specs}) + [("other", "delay")]
    order = np.random.default_rng(seed + 1).integers(0, len(points), 300)
    runs = {}
    for mod in (chaos, jchaos):
        with mod.inject(*(mod.FaultSpec(s, k, **kw) for s, k, kw in specs),
                        seed=seed) as st:
            hits = []
            for i in order:
                hit = st.fire(*points[i])
                hits.append(None if hit is None else (hit.site, hit.kind,
                                                      hit.p))
            runs[mod.__name__] = (hits, list(st.log), st.fire_count(),
                                  st.snapshot())
    mine, theirs = runs[chaos.__name__], runs[jchaos.__name__]
    assert mine == theirs
    assert 0 < mine[2] < len(order)


def test_exception_points_equal_jax():
    """``maybe_raise`` visits ``shard_loss`` then ``error``, as JAX's does;
    ``injected_fault`` returns what it would raise and visits the same."""
    specs = [("x", "shard_loss", dict(p=0.5)), ("x", "error", dict(p=0.5))]
    seen = {}
    for mod in (chaos, jchaos):
        out = []
        with mod.inject(*(mod.FaultSpec(s, k, **kw) for s, k, kw in specs),
                        seed=3) as st:
            for _ in range(40):
                with _Catch() as c:
                    mod.maybe_raise("x")
                out.append(c.text)
            seen[mod.__name__] = (out, list(st.log))
    assert seen[chaos.__name__] == seen[jchaos.__name__]
    assert {t.split(":")[0] for t in seen[chaos.__name__][0]} == {
        "", "ShardLost", "TransientBackendError"}
    with chaos.inject(*(chaos.FaultSpec(s, k, **kw) for s, k, kw in specs),
                      seed=3) as st:
        got = [chaos.injected_fault("x") for _ in range(40)]
    texts = ["" if f is None else f"{type(f).__name__}: {f}" for f in got]
    assert texts == seen[chaos.__name__][0]


class _Catch:
    """Record the exception a block raises as ``"Type: message"`` (``""``
    when none) and swallow it: the registry's own raise is under test."""

    text = ""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.text = "" if exc is None else f"{exc_type.__name__}: {exc}"
        return True


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.FaultSpec("core.dispatch", "explode")
    with pytest.raises(ValueError, match="p must be"):
        chaos.FaultSpec("core.dispatch", "error", p=1.5)
    assert math.isnan(chaos.FaultSpec("s", "delay").param)


def test_inactive_fault_points_are_noops():
    assert not chaos.active()
    assert chaos.fire("s", "error") is None
    assert chaos.injected_fault("s") is None
    chaos.maybe_raise("s")
    assert chaos.maybe_delay("s") == 0.0
    x = torch.ones((3, 3))
    assert chaos.corrupt("s", x) is x
    assert not chaos.forced_overflow("s")
    assert chaos.snapshot()["total_fires"] == 0


def test_contexts_nest_and_restore_also_on_a_raise():
    with chaos.inject(chaos.FaultSpec("outer", "error")) as outer:
        with chaos.inject(chaos.FaultSpec("inner", "error")) as inner:
            assert chaos.state() is inner
            assert chaos.fire("outer", "error") is None
        assert chaos.state() is outer
        assert chaos.fire("outer", "error") is not None
        with _Catch() as c:
            with chaos.inject(chaos.FaultSpec("inner", "error")):
                chaos.maybe_raise("inner")
        assert c.text.startswith("TransientBackendError")
        assert chaos.state() is outer
    assert chaos.state() is None


def test_corrupt_delay_and_overflow_points():
    x = torch.arange(6.0).reshape(2, 3)
    naps = []
    with chaos.inject(chaos.FaultSpec("s", "nonfinite", max_fires=1),
                      chaos.FaultSpec("s", "delay", param=0.25),
                      chaos.FaultSpec("t", "nonfinite", param=7.0),
                      chaos.FaultSpec("s", "overflow", after=1)):
        y = chaos.corrupt("s", x)
        assert torch.isnan(y[0, 0]) and torch.equal(y.view(-1)[1:],
                                                    x.view(-1)[1:])
        assert float(x[0, 0]) == 0.0                  # input untouched
        a, b = chaos.corrupt("t", x, x)
        assert float(a[0, 0]) == 7.0 and b is x
        assert chaos.corrupt("s", x) is x             # max_fires spent
        assert chaos.maybe_delay("s", sleep=naps.append) == 0.25
        assert [chaos.forced_overflow("s") for _ in range(3)] == [
            False, True, True]
    assert naps == [0.25]


def test_core_binning_overflow_point():
    """``overflow_class`` answers ``"injected"`` when the ``core.binning``
    point fires, as JAX's does, before any bound is measured."""
    pos = _pos()
    jdom = JDomain.cubic(4, cutoff=1.0)
    p = plan(domain_from_jax(jdom), make_lennard_jones(),
             positions=torch.from_numpy(pos), strategy="xpencil",
             device="cpu")
    jp = j_plan(jdom, j_lj(), positions=jnp.asarray(pos), strategy="xpencil")
    state, jstate = ParticleState(torch.from_numpy(pos)), \
        japi.ParticleState(jnp.asarray(pos))
    assert p.overflow_class(state) is None and \
        jp.overflow_class(jstate) is None
    for mod, q, st in ((chaos, p, state), (jchaos, jp, jstate)):
        with mod.inject(mod.FaultSpec("core.binning", "overflow",
                                      max_fires=1)):
            assert q.overflow_class(st) == "injected"
            assert q.overflow_class(st) is None
    assert p.replan(state) == p


# ---------------------------------------------------------------------------
# the degradation ladder and the circuit breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(strategy="xpencil"),
    dict(strategy="xpencil", layout="packed"),
    dict(strategy="xpencil", compact=True),
    dict(strategy="xpencil", layout="packed", compact=True),
    dict(strategy="allin"),
    dict(strategy="cell_dense", layout="sfc"),
    dict(strategy="xpencil", backend="reference"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_degradation_ladder_equals_jax(kw):
    """The port's rungs are JAX's, ``"cuda"`` for ``"pallas"``."""
    pos = _pos()
    jdom = JDomain.cubic(4, cutoff=1.0)
    backend = kw.get("backend", "cuda")
    p = plan(domain_from_jax(jdom), make_lennard_jones(),
             positions=torch.from_numpy(pos), device="cpu", **kw)
    jkw = dict(kw, backend="pallas" if backend == "cuda" else backend)
    jp = j_plan(jdom, j_lj(), positions=jnp.asarray(pos), interpret=True,
                **jkw)

    def rungs(ladder, cuda_name):
        return [("cuda" if r.backend == cuda_name else r.backend, r.layout,
                 r.compact, r.strategy) for r in ladder]

    assert rungs(degradation_ladder(p), "cuda") == \
        rungs(japi.degradation_ladder(jp), "pallas")
    assert degradation_ladder(p)[0] is p
    fb = fallback_plan(p)
    assert (fb.backend, fb.layout, fb.compact) == ("reference", "dense",
                                                   False)
    for r in degradation_ladder(p)[1:]:      # every rung runs
        f, u = r.execute(ParticleState(torch.from_numpy(pos)))
        assert bool(torch.isfinite(f).all())


def test_breaker_equals_jax_on_random_event_sequences():
    assert (api._FAILURE_THRESHOLD, api._RECOVERY_THRESHOLD) == \
        (japi._FAILURE_THRESHOLD, japi._RECOVERY_THRESHOLD)
    rng = np.random.default_rng(0)
    for n_rungs in (1, 2, 3, 4):
        mine, theirs = PlanHealth(), japi.PlanHealth()
        for fail in rng.random(400) < 0.45:
            if fail:
                assert mine.note_failure(n_rungs) == \
                    theirs.note_failure(n_rungs)
            else:
                assert mine.note_success() == theirs.note_success()
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.trips > 0 or n_rungs == 1


def test_breaker_trips_down_and_recovers():
    p = plan(domain_from_jax(JDomain.cubic(4, cutoff=1.0)),
             make_lennard_jones(), positions=torch.from_numpy(_pos()),
             strategy="xpencil", layout="packed", device="cpu")
    health = plan_health(p)
    n = len(degradation_ladder(p))
    assert [health.note_failure(n)
            for _ in range(api._FAILURE_THRESHOLD)][-1]
    assert health.level == 1 and health.trips == 1
    assert [health.note_success()
            for _ in range(api._RECOVERY_THRESHOLD)][-1]
    assert health.level == 0 and health.recoveries == 1


def test_health_key_survives_replan():
    p = plan(domain_from_jax(JDomain.cubic(4, cutoff=1.0)),
             make_lennard_jones(), positions=torch.from_numpy(_pos()),
             strategy="xpencil", device="cpu")
    health = plan_health(p)
    health.consec_failures = 2
    grown = dataclasses.replace(p, m_c=p.m_c + 8)
    assert plan_health(grown) is health
    assert plan_health(dataclasses.replace(p, layout="dense",
                                           backend="reference")) \
        is not health
    reset_health()
    assert plan_health(p) is not health
