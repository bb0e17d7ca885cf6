"""The port's halo engine (``backend="halo"``, ``repro_torch.dist``) against
the JAX package's ``repro.dist``, on the CPU.

* The probes and the partition (``shard_slab_counts``,
  ``shard_pencil_active``, ``shard_ids``, ``suggest_shard_cap``,
  ``suggest_shard_max_active``, ``partition_by_shard``,
  ``shard_sfc_pairs``) equal JAX's; the exchange of stacked shards equals
  a numpy model of JAX's two ``ppermute`` rings.
* Plans: JAX's validation messages, the single-shard fallback bit for bit,
  ``distribute``, replans that grow only the bound that overflowed.
* Execution: the stacked shards (``mesh=None``) against JAX's one-device
  ``execute()`` within a scale-relative 3e-4 for every strategy and
  layout, periodic and open; within the port, compact = packed = dense
  halo and batch = loop bit for bit; fields riding through; the boundary
  pair against ``naive_n2``; JAX's own halo on 4 emulated devices (a
  subprocess) within 3e-4.
* Resilience and tuning: the shard-loss shrink of ``execute_checked``, the
  tuner's shard axis against JAX's, the trajectory's refusal.

The route of one slab per rank of a process group is in
``test_torch_halo_ranks.py``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ParticleState as JState
from repro.core import autotune as jat
from repro.core import plan as j_plan
from repro.core.binning import cell_counts as j_cell_counts
from repro.core.binning import shard_pencil_active as j_shard_pencil_active
from repro.core.binning import shard_slab_counts as j_shard_slab_counts
from repro.core.domain import Domain as JDomain
from repro.dist import engine as jengine
from repro.dist import halo as JH
from repro_torch import obs
from repro_torch.convert import domain_from_jax
from repro_torch.core import (ParticleState, clear_executor_cache,
                              make_lennard_jones, plan, recompile_count,
                              reset_counters)
from repro_torch.core import api
from repro_torch.core import autotune as at
from repro_torch.core.binning import (cell_counts, sfc_pair_count,
                                      shard_pencil_active, shard_slab_counts)
from repro_torch.dist import engine
from repro_torch.dist import halo as H
from repro_torch.obs import metrics
from repro_torch.testing import chaos

torch.set_num_threads(1)

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
TOL = 3e-4


@pytest.fixture(autouse=True)
def _fresh():
    clear_executor_cache()
    reset_counters()
    api.reset_health()
    yield
    obs.disable()
    obs.clear()


def _uniform(division, n, seed, periodic=False):
    jdom = JDomain.cubic(division, cutoff=1.0, periodic=periodic)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.asarray(jdom.box)).astype(np.float32)
    return jdom, domain_from_jax(jdom), pos


def _low_z(division, n, seed):
    """Clustered low in Z: uneven shards, some slabs nearly empty."""
    jdom, dom, pos = _uniform(division, n, seed)
    pos[:, 2] *= 0.5
    return jdom, dom, pos


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1.0)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# probes and partition against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("periodic", [False, True])
def test_shard_probes_equal_jax(n_shards, periodic):
    jdom, dom, pos = _low_z(8, 700, seed=2)
    jdom = JDomain.cubic(8, cutoff=1.0, periodic=periodic)
    dom = domain_from_jax(jdom)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    counts, jcounts = cell_counts(dom, tpos), j_cell_counts(jdom, jpos)
    np.testing.assert_array_equal(
        shard_slab_counts(dom, counts, n_shards).numpy(),
        np.asarray(j_shard_slab_counts(jdom, jcounts, n_shards)))
    np.testing.assert_array_equal(
        shard_pencil_active(dom, counts, n_shards).numpy(),
        np.asarray(j_shard_pencil_active(jdom, jcounts, n_shards)))
    np.testing.assert_array_equal(H.shard_ids(dom, tpos, n_shards).numpy(),
                                  np.asarray(JH.shard_ids(jdom, jpos,
                                                          n_shards)))
    np.testing.assert_array_equal(H.shard_loads(dom, tpos, n_shards).numpy(),
                                  np.asarray(JH.shard_loads(jdom, jpos,
                                                            n_shards)))
    assert H.suggest_shard_cap(dom, tpos, n_shards) == \
        JH.suggest_shard_cap(jdom, jpos, n_shards)
    assert H.suggest_shard_max_active(dom, tpos, n_shards) == \
        JH.suggest_shard_max_active(jdom, jpos, n_shards)
    assert engine.shard_sfc_pairs(dom, counts, n_shards) == \
        jengine.shard_sfc_pairs(jdom, jcounts, n_shards)
    with pytest.raises(ValueError, match="not divisible"):
        shard_slab_counts(dom, counts, 3)


@pytest.mark.parametrize("cap", [None, 40], ids=["measured", "overflow"])
def test_partition_equals_jax(cap):
    jdom, dom, pos = _low_z(8, 500, seed=1)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    mass = np.linspace(1.0, 2.0, 500, dtype=np.float32)
    cap = cap or H.suggest_shard_cap(dom, tpos, 4)
    gidx, part, fields = H.partition_by_shard(
        dom, tpos, {"mass": torch.from_numpy(mass)}, 4, cap)
    jg, jp, jf = JH.partition_by_shard(jdom, jpos,
                                       {"mass": jnp.asarray(mass)}, 4, cap)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(part.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(fields["mass"].numpy(),
                                  np.asarray(jf["mass"]))
    back = H.scatter_from_shards(gidx, 500, part)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JH.scatter_from_shards(jg, 500, jp)))


def test_partition_of_stacked_systems_and_padding():
    """Each system of a stack partitions as it does alone; rows whose
    ``valid`` is False go to no shard and scatter back as 0."""
    _, dom, pos = _uniform(4, 120, seed=4)
    stack = torch.stack([torch.from_numpy(pos), torch.from_numpy(pos[::-1]
                                                                 .copy())])
    valid = torch.ones(2, 120, dtype=torch.bool)
    valid[1, ::3] = False
    cap = 80
    gidx, part, _ = H.partition_by_shard(dom, stack, None, 2, cap,
                                         valid=valid)
    g0, p0, _ = H.partition_by_shard(dom, stack[0], None, 2, cap)
    assert torch.equal(gidx[0], g0) and torch.equal(part[0], p0)
    kept = gidx[1][gidx[1] < 120].long()
    assert set(kept.tolist()) == set(torch.nonzero(valid[1])[:, 0].tolist())
    back = H.scatter_from_shards(gidx, 120, part)
    assert torch.equal(back[0], stack[0])
    assert torch.equal(back[1][valid[1]], stack[1][valid[1]])
    assert not back[1][~valid[1]].any()


# --------------------------------------------------------------------------
# the exchange against a numpy model of JAX's ppermute rings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("nz_loc", [1, 2])
@pytest.mark.parametrize("periodic", [False, True])
def test_exchange_halo_matches_the_ring_model(n_shards, nz_loc, periodic):
    rng = np.random.default_rng(7)
    planes = rng.random((2, n_shards, nz_loc + 2, 3, 5)).astype(np.float32)
    shift, fill = 2.5, -9.0
    want = planes.copy()
    for s in range(n_shards):
        want[:, s, 0] = planes[:, (s - 1) % n_shards, nz_loc] - shift
        want[:, s, nz_loc + 1] = planes[:, (s + 1) % n_shards, 1] + shift
    if not periodic:
        want[:, 0, 0] = fill
        want[:, -1, nz_loc + 1] = fill
    got = H.exchange_halo(torch.from_numpy(planes.copy()),
                          n_shards=n_shards, nz_loc=nz_loc,
                          periodic_z=periodic, fill=fill, coord_shift=shift)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(strategy="par_part"), "cell schedule"),
    (dict(strategy="xpencil", n_shards=3), "divisible"),
    (dict(strategy="allin", n_shards=2, compact=True,
          halo_inner="reference"), "pencil schedules"),
    (dict(strategy="xpencil", n_shards=2, m_c=8, positions=None),
     "shard_cap"),
    (dict(strategy="xpencil", n_shards=2, halo_inner="halo"),
     "concrete per-shard backend"),
])
def test_halo_plan_validation_messages_are_jax_s(kwargs, match):
    _, dom, pos = _uniform(8, 100, seed=0)
    args = dict(positions=torch.from_numpy(pos), backend="halo",
                device="cpu")
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        plan(dom, make_lennard_jones(), **args)


def test_single_shard_fallback_is_the_inner_plan():
    _, dom, pos = _uniform(6, 600, seed=3, periodic=True)
    state = ParticleState(torch.from_numpy(pos))
    p = plan(dom, positions=state.positions, strategy="xpencil",
             device="cpu")
    ph = plan(dom, positions=state.positions, strategy="xpencil",
              backend="halo", device="cpu")
    assert ph.n_shards == 1 == engine.default_n_shards(dom, device="cpu")
    assert engine.default_n_shards(dom, device_count=4) == 3
    _equal(ph.execute(state), p.execute(state))
    _equal(dataclasses.replace(p, backend="halo", n_shards=1,
                               halo_inner="cuda").execute(state),
           p.execute(state))


def test_distribute_builds_the_halo_twin():
    jdom, dom, pos = _uniform(8, 900, seed=4, periodic=True)
    tpos = torch.from_numpy(pos)
    p = plan(dom, positions=tpos, strategy="xpencil", compact=True,
             backend="reference", device="cpu")
    d = p.distribute(n_shards=4, positions=tpos)
    jd = j_plan(jdom, positions=jnp.asarray(pos), strategy="xpencil",
                compact=True).distribute(n_shards=4,
                                         positions=jnp.asarray(pos))
    assert (d.backend, d.halo_inner, d.n_shards, d.shard_cap, d.max_active) \
        == (jd.backend, jd.halo_inner, jd.n_shards, jd.shard_cap,
            jd.max_active)
    assert d.max_active <= p.max_active
    with pytest.raises(ValueError, match="shard_cap or positions"):
        p.distribute(n_shards=2)
    assert p.distribute(n_shards=1).n_shards == 1


@pytest.mark.parametrize("bound", ["shard_cap", "max_active", "row_cap",
                                   "pair_cap"])
def test_replan_grows_only_the_bound_that_overflowed(bound):
    jdom, dom, pos = _low_z(8, 600, seed=5)
    state = ParticleState(torch.from_numpy(pos))
    opts = {"shard_cap": dict(strategy="xpencil"),
            "max_active": dict(strategy="xpencil", compact=True),
            "row_cap": dict(strategy="xpencil", layout="packed"),
            "pair_cap": dict(strategy="cell_dense", layout="sfc")}[bound]
    p = plan(dom, positions=state.positions, backend="halo", n_shards=4,
             device="cpu", **opts)
    tight = dataclasses.replace(p, **{bound: 2})
    assert tight.overflow_class(state) == bound
    grown = tight.replan(state)
    assert getattr(grown, bound) > 2 and not grown.check_overflow(state)
    for other in ("m_c", "shard_cap", "max_active", "row_cap", "pair_cap"):
        if other != bound:
            assert getattr(grown, other) == getattr(p, other), other
    _equal(grown.execute(state), p.execute(state))
    # JAX grows the same bound to the same value
    jp = j_plan(jdom, positions=jnp.asarray(pos), backend="halo",
                n_shards=4, m_c=p.m_c, **opts)
    jgrown = dataclasses.replace(jp, **{bound: 2}).replan(
        JState(jnp.asarray(pos)))
    assert getattr(grown, bound) == getattr(jgrown, bound)


# --------------------------------------------------------------------------
# execution: stacked shards against JAX's one device and against each other
# --------------------------------------------------------------------------

PATHS = {
    "dense": dict(strategy="xpencil"),
    "compact": dict(strategy="xpencil", compact=True),
    "packed": dict(strategy="xpencil", layout="packed"),
    "packed_compact": dict(strategy="xpencil", layout="packed",
                           compact=True),
    "allin": dict(strategy="allin"),
    "sfc": dict(strategy="cell_dense", layout="sfc"),
}


@pytest.fixture(scope="module", params=[False, True], ids=["open",
                                                           "periodic"])
def scene(request):
    """One scene per Z periodicity and JAX's one-device X-pencil on it."""
    jdom, dom, pos = _uniform(8, 1500, seed=3, periodic=request.param)
    jp = j_plan(jdom, positions=jnp.asarray(pos), strategy="xpencil")
    jf, ju = jp.execute(JState(jnp.asarray(pos)))
    return dom, pos, jp.m_c, np.asarray(jf), np.asarray(ju)


def test_stacked_halo_paths_match_jax_one_device(scene):
    dom, pos, m_c, jf, ju = scene
    state = ParticleState(torch.from_numpy(pos))
    out = {}
    for name, opts in PATHS.items():
        p = plan(dom, positions=state.positions, m_c=m_c, backend="halo",
                 n_shards=4, device="cpu", **opts)
        f, u = out[name] = p.execute(state)
        assert _scale_err(f, jf) <= TOL, name
        assert _scale_err(u, ju) <= TOL, name
    for name in ("compact", "packed", "packed_compact"):
        _equal(out[name], out["dense"])
    # the reference schedules per shard give the same physics
    p = plan(dom, positions=state.positions, m_c=m_c, backend="halo",
             n_shards=2, halo_inner="reference", strategy="xpencil",
             device="cpu")
    assert _scale_err(p.execute(state)[0], jf) <= TOL


def test_batch_equals_loop_and_fields_ride_through():
    _, dom, pos = _uniform(4, 300, seed=0, periodic=True)
    tpos = torch.from_numpy(pos)
    p = plan(dom, positions=tpos, strategy="xpencil", backend="halo",
             n_shards=2, device="cpu")
    stack = torch.stack([tpos + 0.002 * i for i in range(3)])
    fb, ub = p.execute_batch(ParticleState(stack))
    for i in range(3):
        _equal((fb[i], ub[i]), p.execute(ParticleState(stack[i])))
    f0 = p.execute(ParticleState(tpos))
    _equal(p.execute(ParticleState(tpos, {"mass": torch.ones(300)})), f0)
    # padding rows interact with nothing and read 0
    valid = torch.ones(300, dtype=torch.bool)
    valid[-20:] = False
    padded = torch.cat([tpos[:-20], torch.full((20, 3), 2.0)])
    fp, up = p.execute(ParticleState(padded, valid=valid))
    want = plan(dom, m_c=p.m_c, strategy="xpencil", device="cpu").execute(
        ParticleState(tpos[:-20]))
    _equal((fp[:-20], up[:-20]), p.execute(ParticleState(tpos[:-20])))
    assert _scale_err(fp[:-20], want[0]) <= TOL
    assert not fp[-20:].any() and not up[-20:].any()


def test_boundary_pair_against_naive_n2():
    """A pair straddling the global Z boundary interacts through the wrap
    iff Z is periodic (JAX's ``tests/test_halo.py`` regression)."""
    from repro_torch.core import Domain
    pos = torch.tensor([[2.1, 2.1, 0.15], [2.1, 2.1, 3.85]])
    state = ParticleState(pos)
    for periodic_z in (True, False):
        dom = Domain(box=(4., 4., 4.), ncells=(4, 4, 4), cutoff=1.0,
                     periodic=(False, False, periodic_z))
        f_n2, _ = plan(dom, m_c=8, strategy="naive_n2",
                       device="cpu").execute(state)
        f_h, _ = plan(dom, m_c=8, positions=pos, strategy="xpencil",
                      backend="halo", n_shards=2, device="cpu").execute(state)
        np.testing.assert_allclose(f_h.numpy(), f_n2.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert (f_h.abs().max() > 0) == periodic_z


def test_executor_build_counts_the_exchange_and_records_spans():
    _, dom, pos = _uniform(4, 200, seed=2)
    state = ParticleState(torch.from_numpy(pos), {"q": torch.ones(200)})
    p = plan(dom, positions=state.positions, strategy="xpencil",
             backend="halo", n_shards=2, device="cpu")
    obs.enable()
    p.execute(state)
    p.execute(state)
    assert recompile_count() == 1
    assert metrics.registry.total(engine.GHOST_EXCHANGE_TOTAL) == 4
    names = [s["name"] for s in obs.spans()]
    for span in ("dist.partition", "dist.shard_dispatch",
                 "dist.ghost_exchange"):
        assert names.count(span) == 1, span
    assert all(s["attrs"]["phase"] == "trace" for s in obs.spans()
               if s["name"].startswith("dist."))


def test_matches_jax_halo_on_four_emulated_devices(tmp_path):
    """JAX's own halo (``shard_map`` on 4 emulated host devices) in a
    subprocess, against the port's stacked shards: within 3e-4."""
    out = tmp_path / "jax_halo.npz"
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import numpy as np
        import jax.numpy as jnp
        from repro.core import Domain, ParticleState, plan
        res = {{}}
        for periodic in (False, True):
            dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
            pos = np.random.default_rng(11).random((1200, 3)).astype(
                np.float32) * 8.0
            for name, kw in (("dense", {{}}),
                             ("packed", dict(layout="packed",
                                             compact=True))):
                p = plan(dom, positions=jnp.asarray(pos), m_c=16,
                         strategy="xpencil", backend="halo", n_shards=4,
                         **kw)
                f, u = p.execute(ParticleState(jnp.asarray(pos)))
                res[f"{{name}}_{{periodic}}_f"] = np.asarray(f)
                res[f"{{name}}_{{periodic}}_u"] = np.asarray(u)
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(out)
    from repro_torch.core import Domain
    pos = np.random.default_rng(11).random((1200, 3)).astype(
        np.float32) * 8.0
    state = ParticleState(torch.from_numpy(pos))
    for periodic in (False, True):
        dom = Domain.cubic(8, cutoff=1.0, periodic=periodic)
        for name, kw in (("dense", {}),
                         ("packed", dict(layout="packed", compact=True))):
            p = plan(dom, positions=state.positions, m_c=16,
                     strategy="xpencil", backend="halo", n_shards=4,
                     device="cpu", **kw)
            f, u = p.execute(state)
            assert _scale_err(f, want[f"{name}_{periodic}_f"]) <= TOL
            assert _scale_err(u, want[f"{name}_{periodic}_u"]) <= TOL


# --------------------------------------------------------------------------
# resilience, tuning, trajectories
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,survivors", [(2, 1), (4, 2)])
def test_shard_loss_shrinks_and_matches(n_shards, survivors):
    """JAX's ``tests/test_chaos.py`` shard-loss case: one injected loss at
    ``dist.exchange`` shrinks the plan and the result equals the survivor
    plan's (the inner plan's bit for bit at one shard)."""
    _, dom, pos = _uniform(4, 300, seed=9, periodic=True)
    state = ParticleState(torch.from_numpy(pos))
    p_ref = plan(dom, positions=state.positions, strategy="xpencil",
                 device="cpu")
    p = plan(dom, positions=state.positions, strategy="xpencil",
             backend="halo", n_shards=n_shards, device="cpu")
    obs.enable()
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = p.execute_checked(state)
    assert report.shard_shrinks == 1 and report.status == "ok"
    assert report.plan.n_shards == survivors and report.plan.mesh is None
    assert report.faults == ["shard_loss:injected shard loss at "
                             "'dist.exchange'"]
    assert [e["attrs"]["n_shards"] for e in obs.spans()
            if e["name"] == "plan.shard_shrink"] == [survivors]
    _equal((f, u), report.plan.execute(state))
    if survivors == 1:
        _equal((f, u), p_ref.execute(state))
    else:
        assert _scale_err(f, p_ref.execute(state)[0]) <= TOL
    # a single-shard plan: a plain failure, retried
    with chaos.inject(chaos.FaultSpec("core.dispatch", "shard_loss",
                                      max_fires=1)):
        _, report = p_ref.execute_checked(state)
    assert report.shard_shrinks == 0 and report.retries == 1


@pytest.mark.parametrize("n_shards,survivors", [(2, 1), (4, 2)])
def test_shard_loss_shrink_remeasures_the_sfc_pair_cap(n_shards, survivors):
    """Fewer slabs each hold more cluster pairs: the shrunk sfc plan's
    ``pair_cap`` covers its busiest shard's list (the whole grid's at one
    shard), where the old per-shard cap would cut pairs, so the result
    matches the one-device plan (the inner plan's bit for bit at one
    shard)."""
    _, dom, pos = _uniform(8, 1500, seed=4)
    state = ParticleState(torch.from_numpy(pos))
    kw = dict(positions=state.positions, strategy="cell_dense",
              layout="sfc", device="cpu")
    p_ref = plan(dom, **kw)
    p = plan(dom, m_c=p_ref.m_c, backend="halo", n_shards=n_shards, **kw)
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = p.execute_checked(state)
    q = report.plan
    assert report.shard_shrinks == 1 and report.status == "ok"
    assert q.n_shards == survivors
    counts = cell_counts(dom, state.positions)
    need = (max(engine.shard_sfc_pairs(dom, counts, survivors))
            if survivors > 1 else sfc_pair_count(dom, counts=counts))
    assert p.pair_cap < need <= q.pair_cap
    assert q.overflow_class(state) is None
    # without positions the bounds scale by the load ratio and still cover
    assert engine.elastic_shrink(p).pair_cap >= need
    if survivors == 1:
        _equal((f, u), p_ref.execute(state))
    else:
        want = p_ref.execute(state)
        assert _scale_err(f, want[0]) <= TOL
        assert _scale_err(u, want[1]) <= TOL


def test_ladder_of_a_halo_plan_steps_its_inner_plan():
    _, dom, pos = _uniform(8, 400, seed=1)
    p = plan(dom, positions=torch.from_numpy(pos), strategy="xpencil",
             layout="packed", compact=True, backend="halo", n_shards=2,
             device="cpu")
    rungs = api.degradation_ladder(p)
    assert [(r.backend, r.halo_inner, r.layout, r.compact, r.n_shards)
            for r in rungs] == [
        ("halo", "cuda", "packed", True, 2),
        ("halo", "reference", "packed", True, 2),
        ("halo", "reference", "dense", True, 2),
        ("halo", "reference", "dense", False, 2)]
    assert api._health_key(p) != api._health_key(rungs[1])


def test_halo_twins_equal_jax():
    jdom, dom, pos = _uniform(8, 600, seed=5)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    base = [at.Candidate("xpencil", "reference", 64, 16),
            at.Candidate("xpencil", "reference", 64, 16, compact=True,
                         max_active=64),
            at.Candidate("par_part", "reference", 64, 16),
            at.Candidate("allin", "reference", 64, 16, box=(2, 2, 2),
                         compact=True, max_active=64),
            at.Candidate("cell_dense", "reference", 64, 16, layout="sfc",
                         pair_cap=800)]
    jbase = [jat.Candidate.from_json(c.to_json()) for c in base]
    # the port's twins stack their shards on one device: JAX's with every
    # count's devices present
    mine = at.halo_twins(dom, tpos, base, (2, 3, 4, 16))
    theirs = jat.halo_twins(jdom, jpos, jbase, (2, 3, 4, 16),
                            device_count=16)
    assert [c.to_json() for c in mine] == [c.to_json() for c in theirs]
    assert {c.n_shards for c in mine} == {2, 4}       # the divisors of nz
    assert at.halo_twins(dom, tpos, base, (2, 4)) == mine
    kept, _ = at.prune_candidates(dom, 600 / dom.n_cells, base[:1] + mine,
                                  top_k=3)
    jkept, _ = jat.prune_candidates(jdom, 600 / jdom.n_cells,
                                    jbase[:1] + theirs, top_k=3)
    assert [c.to_json() for c in kept] == [c.to_json() for c in jkept]
    assert any(c.distributed for c in kept)
    assert at.Candidate.from_json(mine[0].to_json()) == mine[0]


def test_tune_times_the_shard_axis(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    jdom, dom, pos = _uniform(4, 200, seed=6)
    tpos = torch.from_numpy(pos)
    # an explicit shard axis on one CPU device: the twins stack their shards
    res = at.tune(dom, None, tpos, strategies=("xpencil",),
                  backends=("cuda",), shard_counts=(2,),
                  include_packed=False, include_sfc=False, top_k=8,
                  reps=2, budget_s=0.01)
    halo = [c for c in res.timings if c.distributed]
    assert halo and all(c.n_shards == 2 for c in halo)
    assert "dev2" in at.cache_key("cpu", dom, 8, 1.0, make_lennard_jones(),
                                  ("cuda",), device_count=2)
    state = ParticleState(tpos)
    for c in halo:
        p = c.plan(dom, make_lennard_jones(), "cpu")
        assert p.backend == "halo" and p.halo_inner == "cuda"
        _equal(p.execute(state), plan(
            dom, m_c=c.m_c, strategy="xpencil", backend="halo", n_shards=2,
            shard_cap=c.shard_cap, compact=c.compact,
            max_active=c.max_active, device="cpu").execute(state))
    # the default axis on one device is empty, as JAX's
    res1 = at.tune(dom, None, tpos, strategies=("xpencil",),
                   include_packed=False, include_sfc=False, reps=2,
                   budget_s=0.01)
    assert not [c for c in res1.timings if c.distributed]
    # on two visible devices it is (2,), and the cache key says dev2
    monkeypatch.setattr(engine, "visible_devices", lambda device=None: 2)
    res2 = at.tune(dom, None, tpos, strategies=("xpencil",),
                   include_packed=False, include_sfc=False, top_k=8,
                   reps=2, budget_s=0.01)
    assert {c.n_shards for c in res2.timings if c.distributed} == {2}
    keys = json.loads(pathlib.Path(res2.cache_file).read_text())
    assert any("|dev2|" in k for k in keys)


def test_trajectory_refuses_multi_shard_plans():
    _, dom, pos = _uniform(4, 100, seed=1, periodic=True)
    tpos = torch.from_numpy(pos)
    p = plan(dom, positions=tpos, strategy="xpencil", backend="halo",
             n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="multi-shard halo plans"):
        p.trajectory(tpos, 2, 1e-3)
    one = dataclasses.replace(p, n_shards=1, shard_cap=None)
    res = one.trajectory(tpos, 2, 1e-3, skin=0.0)
    want = plan(dom, m_c=p.m_c, strategy="xpencil", device="cpu").trajectory(
        tpos, 2, 1e-3, skin=0.0)
    assert torch.equal(res.state.positions, want.state.positions)
