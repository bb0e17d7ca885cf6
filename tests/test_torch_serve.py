"""The port's serving tier (``repro_torch.serve``) and executor cache,
against the JAX package's.

Against JAX on the same seeded numpy requests: bucketing (``quantize_n``,
``quantize_batch``, ``classify`` labels, ``pad_state``, ``stack_states``,
``split_batch``) equal; the engine's statuses and metrics counters equal
(executor builds aside: JAX's counter also moves for every new batch
shape, the port's only for a new plan or field set) and its forces within
a scale-relative 3e-4; admission, deadlines and per-class replans equal;
``TrajectoryService`` within JAX's trajectory tolerances. Within the port:
every response bit-equal to ``class_plan(sc).execute`` of its request,
padded = unpadded and batched = looped on every path, zero executor
builds and timing runs once warm, and an evicted executor rebuilt, counted
and bit-identical.

Engines compared with JAX run on a clock that only the test moves, so a
dispatch's measured time cannot change which requests batch together.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ParticleState as JState
from repro.core import api as japi
from repro.core.domain import Domain as JDomain
from repro.core.interactions import make_lennard_jones as j_lj
from repro.core.interactions import make_low_flop as j_low_flop
from repro.serve import (ServingEngine as JEngine, TrajectoryRequest as JReq,
                         TrajectoryService as JService)
from repro.serve import bucketing as jb
from repro.serve import metrics as jm
from repro_torch import obs
from repro_torch.convert import domain_from_jax
from repro_torch.core import (ParticleState, clear_executor_cache,
                              executor_cache_info, make_lennard_jones,
                              make_low_flop, plan, recompile_count,
                              reset_counters, set_executor_cache_size)
from repro_torch.core import api
from repro_torch.core import autotune as at
from repro_torch.serve import (MIN_N_CAP, LatencyStats, ServeMetrics,
                               ServingEngine, ShapeClass, TrajectoryRequest,
                               TrajectoryService, VirtualClock, classify,
                               pad_state, percentile, quantize_batch,
                               quantize_n, split_batch, stack_states)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    """Cold executor caches, zero counters and healthy breakers: the
    caches and the registry are process-wide."""
    clear_executor_cache()
    reset_counters()
    api.reset_health()
    japi.reset_health()
    yield


class ManualClock:
    """A clock only the test moves (not a VirtualClock, so no engine
    advances it by a dispatch's measured time)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _jdom(division=4, periodic=False):
    return JDomain.cubic(division, cutoff=1.0, periodic=periodic)


def _pos(n, seed, side=4.0, scene="uniform"):
    rng = np.random.default_rng(seed)
    if scene == "blob":
        pos = side / 2 + 0.05 * side * rng.standard_normal((n, 3))
        return np.clip(pos, 1e-3, side - 1e-3).astype(np.float32)
    return (rng.random((n, 3)) * side).astype(np.float32)


def _states(n, seed, fields=False, **kw):
    """(port state, JAX state) of one seeded request."""
    pos = _pos(n, seed, **kw)
    f = ({"mass": (np.random.default_rng(seed + 7).random(n) + 0.5
                   ).astype(np.float32)} if fields else {})
    return (ParticleState(torch.from_numpy(pos),
                          {k: torch.from_numpy(v) for k, v in f.items()}),
            JState(jnp.asarray(pos), {k: jnp.asarray(v)
                                      for k, v in f.items()}))


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _close(got, want, tol=3e-4):
    """Scale-relative closeness of port tensors to JAX arrays."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


COUNTERS = ("submitted", "served", "rejected", "shed", "batches", "replans",
            "autotune_timing_runs", "autotune_cache_hits",
            "deadline_expired", "failed", "faults", "nonfinite_batches",
            "retries", "breaker_opens", "breaker_closes",
            "breaker_open_classes")


def _counters(eng):
    snap = eng.metrics.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _engines(**kw):
    """(port engine, JAX engine): the same options, the X-pencil (the two
    packages' "auto" may differ below division 12), manual clocks."""
    opts = dict(kw)
    plan_opts = opts.pop("plan_opts", {"strategy": "xpencil"})
    return (ServingEngine(clock=ManualClock(), device="cpu",
                          plan_opts=plan_opts, **opts),
            JEngine(clock=ManualClock(), plan_opts=plan_opts, **opts))


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def test_serve_all_covers_jax():
    import repro.serve as jserve
    import repro_torch.serve as tserve
    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None, name


def test_quantizers_equal_jax():
    for n in (1, 3, 63, 64, 65, 1000, 1024, 1025):
        assert quantize_n(n) == jb.quantize_n(n)
        assert quantize_n(n, 16) == jb.quantize_n(n, 16)
    for b, cap in ((1, 8), (3, 8), (5, 8), (5, 6), (9, 8)):
        assert quantize_batch(b, cap) == jb.quantize_batch(b, cap)
    assert MIN_N_CAP == jb.MIN_N_CAP
    for bad in (quantize_n, lambda n: quantize_batch(n, 8)):
        with pytest.raises(ValueError):
            bad(0)


def test_classify_labels_equal_jax():
    jdom = _jdom()
    dom = domain_from_jax(jdom)
    for kern, jkern in ((make_lennard_jones(), j_lj()),
                        (make_low_flop(), j_low_flop())):
        for n, names in ((50, ()), (60, ("mass",)), (200, ("vx", "mass"))):
            mine = classify(dom, kern, n, names)
            assert isinstance(mine, ShapeClass)
            assert mine.label() == jb.classify(jdom, jkern, n,
                                               names).label()
    a = classify(dom, make_lennard_jones(), 50, ())
    assert a == classify(dom, make_lennard_jones(), 60, ())
    assert a != classify(dom, make_low_flop(), 50, ())
    assert a != classify(domain_from_jax(_jdom(3)), make_lennard_jones(),
                         50, ())
    assert a != classify(dom, make_lennard_jones(), MIN_N_CAP + 1, ())


def test_pad_and_stack_equal_jax():
    mine, theirs = zip(*(_states(n, s, fields=True)
                         for n, s in ((50, 0), (64, 1), (10, 2))))
    p, j = pad_state(mine[0], 64), jb.pad_state(theirs[0], 64)
    for a, b in ((p.positions, j.positions), (p.valid, j.valid),
                 (p.fields["mass"], j.fields["mass"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        pad_state(mine[0], 32)
    st, jst = stack_states(mine, 64, 4), jb.stack_states(theirs, 64, 4)
    assert st.positions.shape == (4, 64, 3)
    for a, b in ((st.positions, jst.positions), (st.valid, jst.valid),
                 (st.fields["mass"], jst.fields["mass"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="mixed field sets"):
        stack_states([mine[0], _states(10, 3)[0]], 64)
    with pytest.raises(ValueError, match="exceed batch cap"):
        stack_states(mine, 64, 2)
    forces = torch.arange(4 * 64 * 3, dtype=torch.float32).view(4, 64, 3)
    pot = forces[..., 0]
    for (f, u), (jf, ju), n in zip(
            split_batch(forces, pot, [50, 64, 10]),
            jb.split_batch(jnp.asarray(forces.numpy()),
                           jnp.asarray(pot.numpy()), [50, 64, 10]),
            [50, 64, 10]):
        assert f.shape == (n, 3)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


@pytest.mark.parametrize("opts", [
    {"strategy": "xpencil"},
    {"strategy": "xpencil", "layout": "packed"},
    {"strategy": "xpencil", "compact": True},
    {"strategy": "xpencil", "layout": "packed", "compact": True},
    {"strategy": "allin"},
    {"strategy": "cell_dense", "layout": "sfc"},
    {"strategy": "xpencil", "backend": "reference"},
])
def test_padded_equals_unpadded_and_batched_equals_looped(opts):
    """Within the port, bit for bit on every "cuda" path: a padded state,
    a stacked batch with all-padding systems and the lone request."""
    states = [_states(n, s, fields=True)[0]
              for n, s in ((50, 0), (60, 1), (37, 2))]
    ref = torch.cat([s.positions for s in states])
    p = plan(domain_from_jax(_jdom()), positions=ref, device="cpu", **opts)
    alone = [p.execute(s) for s in states]
    for s, want in zip(states, alone):
        f, u = p.execute(pad_state(s, 128))
        _bitwise((f[:s.n], u[:s.n]), want)
    bf, bu = p.execute_batch(stack_states(states, 64, 4))
    for (f, u), want in zip(split_batch(bf, bu, [s.n for s in states]),
                            alone):
        _bitwise((f, u), want)


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

def _wave(eng, jeng, seed0, fields=False):
    """Two classes (n_cap 64 and 256), eight requests, then a flush."""
    jdom = _jdom()
    dom = domain_from_jax(jdom)
    ids = []
    for i in range(8):
        n = [50, 60, 200, 250][i % 4]
        st, jst = _states(n, seed0 + i, fields=fields)
        ids.append((eng.submit(dom, st), jeng.submit(jdom, jst), st, n))
    eng.flush()
    jeng.flush()
    mine = {r.req_id: r for r in eng.take_responses()}
    theirs = {r.req_id: r for r in jeng.take_responses()}
    return [(mine[a], theirs[b], st, n) for a, b, st, n in ids]


def test_engine_wave_matches_jax_and_execute():
    eng, jeng = _engines(max_batch=4, max_wait=0.0)
    for r, jr, st, n in _wave(eng, jeng, 0, fields=True):
        assert r.status == jr.status == "ok"
        assert r.shape_class == jr.shape_class
        assert r.forces.shape == (n, 3) and r.potential.shape == (n,)
        sc = classify(domain_from_jax(_jdom()), eng.kernel, n, ("mass",))
        _bitwise((r.forces, r.potential), eng.class_plan(sc).execute(st))
        _close((r.forces, r.potential), (jr.forces, jr.potential))
    assert _counters(eng) == _counters(jeng)
    assert eng.metrics.batch_fill.samples == jeng.metrics.batch_fill.samples
    # two classes, one batch shape each: two executor builds
    assert eng.metrics.recompiles == 2


def test_steady_state_builds_nothing_and_times_nothing():
    eng, jeng = _engines(max_batch=4, max_wait=0.0)
    _wave(eng, jeng, 0)
    reset_counters()
    at.reset_timing_runs()
    served = _wave(eng, jeng, 100)
    assert recompile_count() == 0
    assert at.timing_run_count() == 0
    assert api.dispatch_count() == 2          # one full batch a class
    for r, jr, st, n in served:
        sc = classify(domain_from_jax(_jdom()), eng.kernel, n, ())
        _bitwise((r.forces, r.potential), eng.class_plan(sc).execute(st))


def test_prewarm_makes_first_requests_steady_state():
    dom = domain_from_jax(_jdom())
    eng = ServingEngine(max_batch=4, max_wait=0.0, device="cpu")
    eng.prewarm(dom, _states(60, 0)[0])
    reset_counters()
    for i in range(7):                        # a full batch, then 3
        eng.submit(dom, _states(60, 1 + i)[0])
    eng.flush()
    assert recompile_count() == 0
    assert all(r.status == "ok" for r in eng.take_responses())


@pytest.mark.parametrize("admission", ["reject", "shed_oldest"])
def test_admission_matches_jax(admission):
    eng, jeng = _engines(max_batch=100, max_queue=3, admission=admission,
                         max_wait=1e9)
    jdom = _jdom()
    dom = domain_from_jax(jdom)
    for i in range(5):
        st, jst = _states(20, i)
        assert eng.submit(dom, st) == jeng.submit(jdom, jst)
        eng.clock.advance(1.0)
        jeng.clock.advance(1.0)
    eng.flush()
    jeng.flush()
    mine = sorted((r.req_id, r.status) for r in eng.take_responses())
    assert mine == sorted((r.req_id, r.status)
                          for r in jeng.take_responses())
    assert _counters(eng) == _counters(jeng)


def test_poll_and_deadlines_match_jax():
    eng, jeng = _engines(max_batch=100, max_wait=0.5)
    jdom = _jdom()
    dom = domain_from_jax(jdom)
    for e, d, mod in ((eng, dom, 0), (jeng, jdom, 1)):
        st = _states(20, 0)[mod]
        e.submit(d, st, deadline_s=0.0)          # expired at submit
        e.submit(d, st, deadline_s=0.3)          # expires while queued
        e.submit(d, st)
        assert e.poll() == 0                     # too young
        e.clock.advance(0.6)
        assert e.poll() == 1                     # now overdue
    mine = sorted((r.req_id, r.status, r.queue_latency)
                  for r in eng.take_responses())
    theirs = sorted((r.req_id, r.status, r.queue_latency)
                    for r in jeng.take_responses())
    assert mine == theirs
    assert [s for _, s, _ in mine] == ["deadline", "deadline", "ok"]
    assert mine[2][2] == pytest.approx(0.6)
    assert _counters(eng) == _counters(jeng)


def test_overflow_replans_only_that_class_as_jax():
    eng, jeng = _engines(max_batch=2, max_wait=0.0)
    jdom = _jdom()
    dom = domain_from_jax(jdom)
    for n in (60, 200):
        for i in range(2):
            st, jst = _states(n, i)
            eng.submit(dom, st)
            jeng.submit(jdom, jst)
    eng.flush()
    jeng.flush()
    sc_a = classify(dom, eng.kernel, 60, ())
    sc_b = classify(dom, eng.kernel, 200, ())
    plan_a0, plan_b0 = eng.class_plan(sc_a), eng.class_plan(sc_b)
    clustered, jclustered = _states(60, 99, scene="blob")
    assert plan_a0.check_overflow(clustered)
    for e, d, st in ((eng, dom, clustered), (jeng, jdom, jclustered)):
        e.submit(d, st)
    eng.submit(dom, _states(60, 3)[0])
    jeng.submit(jdom, _states(60, 3)[1])
    eng.flush()
    jeng.flush()
    resp = {r.req_id: r for r in eng.take_responses()}
    jresp = {r.req_id: r for r in jeng.take_responses()}
    assert _counters(eng) == _counters(jeng)
    assert eng.metrics.replans == 1
    plan_a1 = eng.class_plan(sc_a)
    assert plan_a1.m_c > plan_a0.m_c
    assert plan_a1.m_c == jeng.class_plan(jb.classify(
        jdom, jeng.kernel, 60, ())).m_c
    assert eng.class_plan(sc_b) is plan_b0
    _bitwise((resp[4].forces, resp[4].potential),
             plan_a1.execute(clustered))
    _close((resp[4].forces, resp[4].potential),
           (jresp[4].forces, jresp[4].potential))


# ---------------------------------------------------------------------------
# the executor cache
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_batch_cache():
    clear_executor_cache()
    set_executor_cache_size(batch=2)
    yield
    set_executor_cache_size(single=128, batch=32)
    clear_executor_cache()


def test_lru_eviction_rebuilds_counted_and_bit_identical(small_batch_cache):
    eng = ServingEngine(max_batch=2, max_wait=0.0, device="cpu",
                        plan_opts={"strategy": "xpencil"})
    mixes = [(3, 40, 0), (4, 100, 1), (5, 300, 2)]

    def run_round():
        out = {}
        for division, n, seed in mixes:
            dom = domain_from_jax(_jdom(division))
            sts = [_states(n, seed + 10 * j, side=float(division))[0]
                   for j in range(2)]
            ids = [eng.submit(dom, s) for s in sts]
            eng.flush()
            resp = {r.req_id: r for r in eng.take_responses()}
            out[n] = [(resp[i].forces, resp[i].potential) for i in ids]
        return out

    first = run_round()
    info = executor_cache_info()["batch"]
    assert info.maxsize == 2 and info.currsize == 2 and info.misses == 3
    reset_counters()
    second = run_round()
    # three plans through two slots, least recent first: every one rebuilt
    assert recompile_count() == 3
    assert executor_cache_info()["batch"].misses == 6
    for n in first:
        for a, b in zip(first[n], second[n]):
            _bitwise(a, b)


def test_clear_executor_cache_mid_stream_costs_a_rebuild_only():
    dom = domain_from_jax(_jdom())
    eng = ServingEngine(max_batch=2, max_wait=0.0, device="cpu")
    sts = [_states(60, i)[0] for i in range(2)]
    ids = [eng.submit(dom, s) for s in sts]
    eng.flush()
    first = {r.req_id: r for r in eng.take_responses()}
    clear_executor_cache()
    reset_counters()
    ids2 = [eng.submit(dom, s) for s in sts]
    eng.flush()
    second = {r.req_id: r for r in eng.take_responses()}
    assert recompile_count() == 1
    assert eng.metrics.recompiles == 2        # the cold build, the rebuild
    for a, b in zip(ids, ids2):
        _bitwise((first[a].forces, first[a].potential),
                 (second[b].forces, second[b].potential))


def test_executor_cache_surface():
    with pytest.raises(ValueError):
        set_executor_cache_size(batch=0)
    with pytest.raises(ValueError):
        set_executor_cache_size(single=0)
    info = executor_cache_info()
    assert set(info) == {"single", "batch"}
    assert info["single"]._fields == ("hits", "misses", "maxsize",
                                      "currsize")
    clear_executor_cache()
    assert executor_cache_info()["single"].currsize == 0
    # a plan that differs only in a bound is another executor; a new field
    # set of the same plan is another executor too
    dom = domain_from_jax(_jdom())
    st, _ = _states(60, 0, fields=True)
    p = plan(dom, positions=st.positions, device="cpu", strategy="xpencil")
    reset_counters()
    p.execute(st)
    p.execute(ParticleState(st.positions))
    p.execute(st)
    plan(dom, m_c=p.m_c + 8, device="cpu", strategy="xpencil").execute(st)
    assert recompile_count() == 3
    assert executor_cache_info()["single"].hits == 1



@pytest.mark.parametrize("opts, want", [
    ({"strategy": "naive_n2"}, None),
    ({"strategy": "xpencil"}, ("prefix_sum.cu", "xpencil.cu")),
    ({"strategy": "xpencil", "compact": True},
     ("prefix_sum.cu", "xpencil.cu")),
    ({"strategy": "xpencil", "layout": "packed"},
     ("prefix_sum.cu", "pack.cu", "xpencil.cu")),
    ({"strategy": "allin"}, ("prefix_sum.cu", "allin.cu")),
    ({"strategy": "cell_dense", "layout": "sfc"},
     ("prefix_sum.cu", "sfc.cu")),
    ({"strategy": "xpencil", "backend": "reference"}, None),
])
def test_card_executor_loads_the_sources_its_backend_names(monkeypatch,
                                                           opts, want):
    """An executor of a plan on the card loads, when it is built, the CUDA
    sources its backend's registration names (the scan first, the pack
    kernel in the packed layout, then the force kernel); a ``naive_n2``
    plan, which no registration serves, and a reference plan load none.
    The card is stood in for by the plan's device and a recording
    loader."""
    from repro_torch.kernels import _build
    dom = domain_from_jax(_jdom())
    st, _ = _states(60, 0)
    p = plan(dom, positions=st.positions, device="cpu", **opts)
    from repro_torch.core import binning
    loaded = []
    monkeypatch.setattr(_build, "load_all", loaded.append)
    for staged in ("sfc_device_tables", "sfc_device_slot_tables"):
        monkeypatch.setattr(binning, staged, lambda *a: None)
    on_card = copy.copy(p)
    object.__setattr__(on_card, "device", torch.device("cuda", 0))
    api._Executor(on_card, ())
    assert loaded == ([] if want is None else [want])
    assert set(want or ()) <= set(_build.SIGNATURES)

def test_autotuned_class_times_once_then_serves_warm(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))

    def fake_time(fn, *args, reps=None, budget_s=3.0):
        fn(*args)
        return 1e-3, reps or 1
    monkeypatch.setattr(at, "time_fn", fake_time)
    dom = domain_from_jax(_jdom())
    eng = ServingEngine(max_batch=2, max_wait=0.0, autotune=True,
                        device="cpu",
                        tune_opts=dict(reps=1, budget_s=0.01, top_k=2))
    for i in range(2):
        eng.submit(dom, _states(60, i)[0])
    eng.flush()
    assert all(r.status == "ok" for r in eng.take_responses())
    assert eng.metrics.autotune_timing_runs > 0
    at.reset_timing_runs()
    tr0 = eng.metrics.autotune_timing_runs
    for i in range(2):
        eng.submit(dom, _states(60, 100 + i)[0])
    eng.flush()
    assert eng.metrics.autotune_timing_runs == tr0
    assert at.timing_run_count() == 0
    # a new engine on the class answers from the tuner's disk cache
    eng2 = ServingEngine(max_batch=2, max_wait=0.0, autotune=True,
                         device="cpu",
                         tune_opts=dict(reps=1, budget_s=0.01, top_k=2))
    eng2.submit(dom, _states(60, 0)[0])       # the first engine's first
    eng2.flush()
    assert eng2.metrics.autotune_cache_hits == 1
    assert at.timing_run_count() == 0


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrajectoryService()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_latency_metrics_equal_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = list(rng.random(n))
        for q in (0.0, 50.0, 75.0, 99.0, 100.0):
            a, b = percentile(xs, q), jm.percentile(xs, q)
            assert (math.isnan(a) and math.isnan(b)) or a == b
        s, js = LatencyStats(), jm.LatencyStats()
        for x in xs:
            s.record(x)
            js.record(x)
        assert str(s.summary()) == str(js.summary())
    c, jc = VirtualClock(), jm.VirtualClock()
    for op, v in (("advance", 2.0), ("advance_to", 1.0), ("advance", 0.5),
                  ("advance_to", 5.0)):
        assert getattr(c, op)(v) == getattr(jc, op)(v)
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_serve_metrics_snapshot_and_registry_mirror():
    m, jmetrics = ServeMetrics(), jm.ServeMetrics()
    for mm in (m, jmetrics):
        mm.note_submit(0.0)
        mm.note_submit(1.0)
        mm.note_served(t_submit=1.0, t_dispatch=1.5, t_done=2.0)
        mm.note_served(t_submit=0.0, t_dispatch=0.5, t_done=3.0)
        mm.batches += 1
        mm.batch_fill.record(0.5)
    assert str(m.snapshot()) == str(jmetrics.snapshot())
    assert obs.registry.get("serve_submitted").value == 2.0
    assert obs.registry.get("serve_batches").value == 1.0
    assert "serve_served 2" in obs.render_prom()


# ---------------------------------------------------------------------------
# TrajectoryService
# ---------------------------------------------------------------------------

DT = 1e-3


@pytest.fixture(scope="module")
def traj_scene():
    jdom = _jdom(5, periodic=True)
    rng = np.random.default_rng(5)
    pos = (rng.random((200, 3)) * 5.0).astype(np.float32)
    vel = (0.1 * rng.standard_normal((200, 3))).astype(np.float32)
    return jdom, pos, vel


def test_trajectory_service_warm_class_padding_and_jax(traj_scene):
    jdom, pos, vel = traj_scene
    dom = domain_from_jax(jdom)
    kern = make_lennard_jones(sigma=0.3, eps=1e-4)
    svc = TrajectoryService(skin=0.25, device="cpu", strategy="xpencil")
    req = TrajectoryRequest("job-a", dom, kern,
                            ParticleState(torch.from_numpy(pos[:150])), 16,
                            DT, velocities=torch.from_numpy(vel[:150]),
                            opts={"segment_len": 8})
    ra = svc.submit(req)
    assert ra.status == "ok" and ra.n == 150
    assert ra.state.positions.shape == (150, 3)

    # the same class (150 and 180 pad to 256): no executor built
    before = recompile_count()
    rb = svc.submit(TrajectoryRequest(
        "job-b", dom, kern, ParticleState(torch.from_numpy(pos[:180])), 16,
        DT, velocities=torch.from_numpy(vel[:180]),
        opts={"segment_len": 8}))
    assert rb.status == "ok" and svc.jobs_served == 2
    assert recompile_count() == before

    # padded = unpadded on the class's skin plan, bit for bit
    (base, traj), = svc._plans.values()
    direct = base.trajectory(ParticleState(torch.from_numpy(pos[:150])), 16,
                             DT, velocities=torch.from_numpy(vel[:150]),
                             traj_plan=traj, segment_len=8)
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(ra.state, f), getattr(direct.state, f))

    # JAX's service on the same job: JAX's trajectory tolerances
    jsvc = JService(skin=0.25, strategy="xpencil")
    jr = jsvc.submit(JReq("job-a", jdom, j_lj(sigma=0.3, eps=1e-4),
                          JState(jnp.asarray(pos[:150])), 16, DT,
                          velocities=jnp.asarray(vel[:150]),
                          opts={"segment_len": 8}))
    assert jr.status == ra.status and jr.shape_class == ra.shape_class
    np.testing.assert_allclose(ra.state.positions.numpy(),
                               np.asarray(jr.state.positions), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ra.state.velocities.numpy(),
                               np.asarray(jr.state.velocities), atol=1e-4,
                               rtol=1e-4)
    assert ra.result.rebins == jr.result.rebins


def test_trajectory_service_resume(traj_scene, tmp_path):
    jdom, pos, vel = traj_scene
    dom = domain_from_jax(jdom)
    svc = TrajectoryService(skin=0.25, checkpoint_root=tmp_path / "jobs",
                            device="cpu")
    req = TrajectoryRequest("job-r", dom,
                            make_lennard_jones(sigma=0.3, eps=1e-4),
                            ParticleState(torch.from_numpy(pos)), 32, DT,
                            velocities=torch.from_numpy(vel),
                            opts={"segment_len": 8, "checkpoint_every": 16})
    first = svc.submit(req)
    assert first.status == "ok" and first.result.checkpoints >= 1
    again = svc.submit(req)
    assert again.result.resumed_from == 32 and again.result.steps == 32
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(again.state, f), getattr(first.state, f))


def test_trajectory_counts_its_replans(traj_scene):
    """A skin plan whose m_c the lattice outgrows mid-run: the engine's
    replan is counted, as JAX counts it."""
    jdom, pos, vel = traj_scene
    dom = domain_from_jax(jdom)
    kern = make_lennard_jones(sigma=0.3, eps=1e-4)
    p = plan(dom, kern, positions=torch.from_numpy(pos), device="cpu")
    from repro_torch.testing import chaos
    with chaos.inject(chaos.FaultSpec("traj.rebin", "overflow",
                                      max_fires=1)):
        res = p.trajectory(ParticleState(torch.from_numpy(pos)), 16, DT,
                           velocities=torch.from_numpy(vel), skin=0.0,
                           segment_len=8)
    assert res.status == "ok" and "overflow:injected" in res.faults
    assert api.replan_count() == res.replans == 0
    tight = plan(dom, kern, m_c=2, device="cpu", strategy="xpencil")
    reset_counters()
    res = tight.trajectory(ParticleState(torch.from_numpy(pos)), 8, DT,
                           velocities=torch.from_numpy(vel), skin=0.0,
                           segment_len=4)
    assert res.status == "ok" and res.replans >= 1
    assert api.replan_count() == res.replans
    assert obs.registry.total(api.REPLAN_TOTAL) == res.replans
