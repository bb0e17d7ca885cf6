"""The port's observability (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

* The metrics registry and the tracer, driven through the same sequence of
  operations, give the same ``snapshot()``, ``render_prom()`` text and
  span records (timestamps aside), and share no state with ``repro.obs``.
* The traffic audit's ``neighbor_pair_count``, ``measured_traffic`` and
  ``audit_candidate`` equal JAX's on the same positions.
* ``profile`` is ported: the same lazy surface as JAX's, and on the same
  plan and positions the same audit numbers and report fields.
"""

import dataclasses
import importlib
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.core import Domain as JDomain
from repro.core.binning import cell_counts as j_cell_counts
from repro_torch import obs
from repro_torch.convert import domain_from_jax
from repro_torch.core import cell_counts
from test_torch_sparse import blob

torch.set_num_threads(1)


def _reset_tracers():
    # the same state in both, whatever a test run earlier in this process
    # left: tests/test_obs.py resizes the JAX tracer's ring buffer
    for m in (obs, jobs):
        m.enable(capacity=importlib.import_module(
            m.__name__ + ".trace").DEFAULT_CAPACITY)
        m.disable()
        m.clear()


@pytest.fixture(autouse=True)
def _clean_tracers():
    _reset_tracers()
    yield
    _reset_tracers()


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("jobs_total", backend="cuda", strategy="xpencil").inc()
    reg.counter("jobs_total", backend="cuda", strategy="xpencil").inc(2)
    reg.counter("jobs_total", backend="reference", strategy="allin").inc(0.5)
    reg.gauge("queue_depth").set(7)
    reg.gauge("queue_depth").inc(-2.25)
    reg.gauge("drift", layout="packed", strategy="xpencil").set(-0.125)
    h = reg.histogram("latency_seconds", route="a")
    for v in (0.5, 0.25, 3.0):
        h.observe(v)
    reg.histogram("empty_seconds")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("jobs_total")
    out = [reg.snapshot(), reg.render_prom(), reg.names(),
           reg.total("jobs_total"), reg.total("latency_seconds"),
           reg.total("missing"), reg.get("queue_depth").value,
           reg.get("nope", a=1), h.mean]
    reg.reset("jobs_total")
    out += [reg.snapshot(), reg.render_prom()]
    reg.reset()
    out += [reg.snapshot(), reg.render_prom(), h.count]
    return out


def _nan_safe(x):
    return json.loads(json.dumps(x, default=str).replace("NaN", '"nan"'))


def test_registry_matches_jax_operation_for_operation():
    got, want = _drive_registry(obs), _drive_registry(jobs)
    assert _nan_safe(got) == _nan_safe(want)
    assert "# TYPE latency_seconds summary" in got[1]
    assert 'jobs_total{backend="cuda",strategy="xpencil"} 3' in got[1]


def test_process_registries_are_separate():
    obs.registry.counter("only_in_the_port_total").inc()
    assert "only_in_the_port_total" in obs.snapshot()
    assert "only_in_the_port_total" not in jobs.snapshot()
    assert obs.registry is not jobs.registry
    obs.registry.reset("only_in_the_port_total")


def _drive_tracer(mod):
    with mod.trace("disabled.span", k=1):
        pass
    mod.event("disabled.event")
    before = mod.stats()
    mod.enable()
    with mod.trace("outer", layer="test") as sp:
        sp.set(extra=7)
        mod.event("tick", n=1)
    with pytest.raises(ValueError):
        with mod.trace("boom"):
            raise ValueError("x")
    with mod.tracing():
        mod.event("inside")
    mod.disable()
    with mod.tracing(capacity=3):
        for i in range(5):
            mod.event("e", i=i)
    return before, mod.stats(), mod.spans(), mod.tracing_enabled()


def _untimed(records, keys=("ts", "dur")):
    return [{k: v for k, v in r.items() if k not in keys} for r in records]


def test_tracer_matches_jax_operation_for_operation(tmp_path):
    b1, s1, r1, e1 = _drive_tracer(obs)
    b2, s2, r2, e2 = _drive_tracer(jobs)
    assert (b1, s1, e1) == (b2, s2, e2)
    assert _untimed(r1) == _untimed(r2)
    assert [r["name"] for r in r1] == ["e", "e", "e"]
    assert all(r["ts"] >= 0.0 for r in r1)
    # the exports: same records, same Chrome events, timestamps aside
    n1 = obs.export_jsonl(tmp_path / "a" / "t.jsonl")
    n2 = jobs.export_jsonl(tmp_path / "b" / "t.jsonl")
    assert n1 == n2 == 3
    load = [[json.loads(line) for line in
             (tmp_path / d / "t.jsonl").read_text().splitlines()]
            for d in "ab"]
    assert _untimed(load[0]) == _untimed(load[1])
    c1 = obs.export_chrome_trace(tmp_path / "a.json")
    c2 = jobs.export_chrome_trace(tmp_path / "b.json")
    assert c1 == c2
    ev = [json.loads((tmp_path / f"{d}.json").read_text()) for d in "ab"]
    assert ev[0]["displayTimeUnit"] == ev[1]["displayTimeUnit"]
    assert _untimed(ev[0]["traceEvents"]) == _untimed(ev[1]["traceEvents"])
    assert _untimed(obs.chrome_events(r2)) == _untimed(jobs.chrome_events(r2))
    obs.clear()
    assert obs.spans() == [] and len(jobs.spans()) == 3


def test_profile_matches_jax():
    from repro.core import make_lennard_jones as j_lj, plan as j_plan
    from repro_torch.core import ParticleState, make_lennard_jones, plan
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        obs.nothing
    assert set(jobs.__all__) == set(obs.__all__)
    assert {"measured_traffic", "profile", "ProfileReport"} <= set(dir(obs))
    jdom = JDomain.cubic(4, cutoff=1.0)
    pos = (np.random.default_rng(2).random((120, 3)) * 4.0).astype(
        np.float32)
    p = plan(domain_from_jax(jdom), make_lennard_jones(),
             positions=torch.from_numpy(pos), device="cpu",
             strategy="xpencil", layout="packed")
    jp = j_plan(jdom, j_lj(), positions=jnp.asarray(pos),
                strategy="xpencil", layout="packed")
    rep = obs.profile(p, ParticleState(torch.from_numpy(pos)), reps=2)
    jrep = jobs.profile(jp, jobs_state(pos), reps=2)
    assert isinstance(rep, obs.ProfileReport) and rep.reps == 2
    assert rep.seconds_per_call > 0 and rep.profiler_dir is None
    assert (rep.strategy, rep.layout) == (jrep.strategy, jrep.layout)
    for f in ("modelled_bpi", "measured_bpi", "drift", "interactions"):
        assert getattr(rep, f) == pytest.approx(getattr(jrep, f), rel=1e-6)


def jobs_state(pos):
    from repro.core import ParticleState as JState
    return JState(jnp.asarray(pos))


def _scenes():
    rng = np.random.default_rng(3)
    for periodic in (False, True):
        jdom = JDomain.cubic(6, cutoff=1.0, periodic=periodic)
        pos = (rng.random((400, 3)) * 6.0).astype(np.float32)
        yield f"uniform-{periodic}", jdom, pos
        yield f"blob-{periodic}", jdom, blob(6, 300, seed=4,
                                             periodic=periodic)[1]


SHAPES = [("naive_n2", "dense", False), ("par_part", "dense", False),
          ("cell_dense", "dense", False), ("cell_dense", "dense", True),
          ("cell_dense", "sfc", False), ("xpencil", "dense", False),
          ("xpencil", "dense", True), ("xpencil", "packed", False),
          ("xpencil", "packed", True), ("allin", "dense", False),
          ("allin", "dense", True)]


@pytest.mark.parametrize("name,jdom,pos", [
    pytest.param(*scene, id=scene[0]) for scene in _scenes()])
def test_audit_equals_jax(name, jdom, pos):
    from repro.obs import audit as jaudit
    from repro_torch.obs import audit
    dom = domain_from_jax(jdom)
    tpos = torch.from_numpy(pos)
    counts = cell_counts(dom, tpos)
    jcounts = j_cell_counts(jdom, jnp.asarray(pos))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert obs.neighbor_pair_count(dom, counts) == \
        jobs.neighbor_pair_count(jdom, jcounts)
    for strategy, layout, compact in SHAPES:
        for m_c in (8, 24):
            subbox = (3, 2, 3) if strategy == "allin" else None
            kw = dict(strategy=strategy, m_c=m_c, layout=layout,
                      compact=compact, subbox=subbox)
            got = obs.measured_traffic(dom, tpos, **kw)
            want = jobs.measured_traffic(jdom, jnp.asarray(pos), **kw)
            assert got == audit.MeasuredTraffic(
                **dataclasses.asdict(want)), kw
            assert obs.measured_traffic(dom, counts=counts, **kw) == got
            a = obs.audit_candidate(dom, tpos, fill=0.5, **kw)
            b = jobs.audit_candidate(jdom, jnp.asarray(pos), fill=0.5, **kw)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-12, nan_ok=True), (
                    kw, k)
    labels = dict(strategy="xpencil_compact", layout="packed")
    assert obs.registry.get(audit.DRIFT_GAUGE, **labels).value == \
        pytest.approx(jobs.registry.get(jaudit.DRIFT_GAUGE, **labels).value,
                      rel=1e-12)
    assert audit.DRIFT_GAUGE == "repro_torch_traffic_model_drift"


def test_model_drift_edges():
    assert obs.model_drift(2.0, 3.0) == 0.5
    assert math.isnan(obs.model_drift(0.0, 1.0))
    assert math.isnan(obs.model_drift(float("inf"), 1.0))
    with pytest.raises(ValueError, match="positions or counts"):
        obs.measured_traffic(domain_from_jax(JDomain.cubic(3)),
                             strategy="xpencil", m_c=8)
