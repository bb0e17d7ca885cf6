"""The port's trajectory engine (``repro_torch.traj``) and its skin helpers.

Against the JAX package on the same numpy inputs (JAX's 200-particle
periodic scene of ``tests/test_traj.py``): ``max_displacement``,
``image_positions`` and ``refresh_bins`` bit for bit, open and periodic,
with ``valid`` masks (every slot but the corner slot where JAX parks the
particles its binning dropped; with an ``m_c`` overflow, the forces after
the refresh); ``run_trajectory`` at ``skin=0`` and ``0.25`` within 1e-5 in
positions and a scale-relative 3e-4 in the energy traces, with the same
``rebinned`` trace; the fault texts.

Within the port: JAX's ``tests/test_traj.py`` contracts (skin-0 parity for
both integrators, few rebins, coarsening, langevin at gamma 0, resume dense
and packed, mismatched-config refusal, NaN rollback, transient retry,
straggler, checkpoint crash, forced and initial overflow, energy budget,
monitor convention, breach order, ``physics.run``); dense = packed =
compact = allin trajectories bit for bit; langevin resume bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import api as japi
from repro.core import binning as JB
from repro.core.domain import Domain as JDomain
from repro.core.interactions import make_lennard_jones as j_lj
from repro.physics.integrators import MDState as JMD
from repro.testing import chaos as jchaos
from repro.traj import engine as JE
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import domain_from_jax
from repro_torch.core import (ParticleState, binning as TB, make_low_flop,
                              make_lennard_jones, plan, reset_health)
from repro_torch.core.domain import effective_skin, skin_domain
from repro_torch.physics import MDState, init_state, run as integ_run
from repro_torch.testing import chaos
from repro_torch.traj import (classify_breach, engine as TE, init_monitors,
                              reference_step, run_trajectory,
                              trajectory_plan)
from repro_torch.traj import monitors as M

torch.set_num_threads(1)

DT = 1e-3
N = 200


@pytest.fixture(autouse=True)
def _fresh_health():
    reset_health()
    japi.reset_health()
    yield
    reset_health()
    japi.reset_health()


def _inputs(seed=0, vel_scale=0.1):
    rng = np.random.default_rng(seed)
    pos = (rng.random((N, 3)) * 6.0).astype(np.float32)
    vel = (vel_scale * rng.standard_normal((N, 3))).astype(np.float32)
    return pos, vel


@pytest.fixture(scope="module")
def setup():
    """The port's side of JAX's scene: a dense X-pencil plan on the CPU
    (the ``"cuda"`` backend's plain versions)."""
    jdom = JDomain.cubic(6, cutoff=1.0, periodic=True)
    dom = domain_from_jax(jdom)
    pos, vel = _inputs()
    pos, vel = torch.from_numpy(pos), torch.from_numpy(vel)
    kern = make_lennard_jones(sigma=0.3, eps=1e-4)
    p = plan(dom, kern, positions=pos, strategy="xpencil", device="cpu")
    return dom, pos, vel, kern, p


def _baseline(p, md0, n_steps, integrator="velocity_verlet"):
    step = reference_step(p, integrator=integrator)
    md = md0
    for _ in range(n_steps):
        md = step(md, DT)
    return md


def _bitwise(a: MDState, b: MDState):
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _close_min_image(dom, got, want, atol, rtol):
    """assert_allclose on the minimum-image difference (a particle may sit
    on either side of a periodic face)."""
    d = dom.minimum_image(got - want).abs()
    bad = d > atol + rtol * want.abs()
    assert not bool(bad.any()), float(d.max())


def _scale_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the skin helpers against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
@pytest.mark.parametrize("m_c", [16, 1], ids=["fits", "overflow"])
def test_skin_helpers_bit_equal_jax(periodic, m_c):
    jdom = JDomain.cubic(6, cutoff=1.0, periodic=periodic)
    dom = domain_from_jax(jdom)
    pos0, _ = _inputs()
    rng = np.random.default_rng(1)
    moved = pos0 + rng.normal(0, 0.05, pos0.shape).astype(np.float32)
    if periodic:
        moved = np.mod(moved, np.float32(6.0)).astype(np.float32)
    valid = rng.random(N) > 0.1
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    jr, tr = jnp.asarray(pos0), torch.from_numpy(pos0)
    jm, tm = jnp.asarray(moved), torch.from_numpy(moved)

    for v_j, v_t in ((None, None), (jv, tv)):
        assert float(JB.max_displacement(jdom, jm, jr, v_j)) == \
            float(TB.max_displacement(dom, tm, tr, v_t))
    jimg = JB.image_positions(jdom, jm, jr)
    timg = TB.image_positions(dom, tm, tr)
    np.testing.assert_array_equal(np.asarray(jimg), timg.numpy())

    jbins = JB.bin_particles(jdom, jr, m_c=m_c, valid=jv)
    tbins = TB.bin_particles(dom, tr[None], m_c=m_c, valid=tv[None])
    jref = JB.refresh_bins(jdom, jbins, jimg, valid=jv)
    tref = TB.refresh_bins(dom, tbins, timg[None], valid=tv[None])
    for k in "xyz":
        want = np.asarray(jref.planes[k]).reshape(-1)
        got = tref.planes[k][0].numpy().reshape(-1)
        # slot 0: where JAX parks the rows its binning dropped
        np.testing.assert_array_equal(got[1:], want[1:], err_msg=k)
    if m_c == 1:
        assert int(jnp.max(jbins.counts)) > m_c        # premise: overflow
        jp = japi.plan(jdom, j_lj(sigma=0.3, eps=1e-4), m_c=m_c,
                       strategy="xpencil")
        tp = plan(dom, make_lennard_jones(sigma=0.3, eps=1e-4), m_c=m_c,
                  strategy="xpencil", device="cpu")
        jf, ju = JE._forces(jp, jref, jimg, {}, jv)
        tf, tu = TE._forces(tp, tref, timg, {}, tv)
        assert _scale_rel(tf.numpy(), jf) <= 3e-4
        assert _scale_rel(tu.numpy(), ju) <= 3e-4


def test_refresh_bins_stacked_systems_equal_one_by_one():
    dom = domain_from_jax(JDomain.cubic(6, cutoff=1.0, periodic=True))
    pos0, _ = _inputs()
    pos1, _ = _inputs(seed=3)
    stack = torch.from_numpy(np.stack([pos0, pos1]))
    valid = torch.ones((2, N), dtype=torch.bool)
    valid[1, ::7] = False
    bins = TB.bin_particles(dom, stack, m_c=4, valid=valid)
    moved = TB.image_positions(dom, torch.remainder(stack + 0.03, 6.0), stack)
    out = TB.refresh_bins(dom, bins, moved, valid=valid)
    for b in range(2):
        one = TB.refresh_bins(dom, TB.bin_particles(
            dom, stack[b:b + 1], m_c=4, valid=valid[b:b + 1]),
            moved[b:b + 1], valid=valid[b:b + 1])
        for k in "xyz":
            assert torch.equal(out.planes[k][b], one.planes[k][0])


# ---------------------------------------------------------------------------
# run_trajectory against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``run_trajectory`` on its reference X-pencil, 64 steps, and
    its ``rebinned`` trace from the segment executor that run compiled."""
    jdom = JDomain.cubic(6, cutoff=1.0, periodic=True)
    jk = j_lj(sigma=0.3, eps=1e-4)
    out = {}
    for label, skin, vel_scale in (("skin0", 0.0, 0.1), ("skin", 0.25, 0.1),
                                   ("skin hot", 0.25, 3.0)):
        pos, vel = _inputs(vel_scale=vel_scale)
        jp = japi.plan(jdom, jk, positions=jnp.asarray(pos),
                       strategy="xpencil")
        f0, u0 = jp.execute(japi.ParticleState(jnp.asarray(pos)))
        md0 = JMD(jnp.asarray(pos), jnp.asarray(vel), f0, u0, jnp.int32(0))
        res = JE.run_trajectory(jp, md0, 64, DT, skin=skin, segment_len=16)
        tp = res.plan
        eff = 0.0 if skin == 0 else JE.effective_skin(tp.domain)
        carry = JE._init_exec(tp, 1.0, (), False, True)(
            md0.positions, md0.velocities, jnp.int32(0), {}, None,
            jax.random.PRNGKey(0), f0, u0)
        seg = JE._segment_exec(tp, "velocity_verlet", 16, float(eff), 1.0,
                               (), False)
        flags = []
        for _ in range(4):
            carry, ys = seg(carry, jnp.float32(DT), jnp.float32(0.1),
                            jnp.float32(0.0), {}, None)
            flags.append(np.asarray(ys["rebinned"]))
        np.testing.assert_array_equal(np.asarray(carry.md.positions),
                                      np.asarray(res.state.positions))
        out[label] = (skin, vel_scale, res, np.concatenate(flags),
                      np.asarray(f0), np.asarray(u0))
    return out


@pytest.mark.parametrize("label", ["skin0", "skin", "skin hot"])
def test_run_trajectory_against_jax(jax_runs, label):
    skin, vel_scale, jres, jflags, f0, u0 = jax_runs[label]
    dom = domain_from_jax(JDomain.cubic(6, cutoff=1.0, periodic=True))
    pos, vel = (torch.from_numpy(a) for a in _inputs(vel_scale=vel_scale))
    p = plan(dom, make_lennard_jones(sigma=0.3, eps=1e-4), positions=pos,
             strategy="xpencil", device="cpu")
    assert p.m_c == jres.plan.m_c or skin > 0
    md0 = MDState(pos, vel, torch.tensor(f0), torch.tensor(u0))
    res = run_trajectory(p, md0, 64, DT, skin=skin, segment_len=16)
    assert res.status == "ok" and res.steps == 64
    assert res.plan.domain.ncells == tuple(jres.plan.domain.ncells)
    assert res.plan.m_c == jres.plan.m_c
    assert res.rebins == int(jres.rebins)
    _close_min_image(dom, res.state.positions,
                     torch.from_numpy(np.array(jres.state.positions)),
                     atol=1e-5, rtol=1e-5)
    for k in ("kinetic", "potential", "total"):
        assert _scale_rel(res.traces[k], jres.traces[k]) <= 3e-4, k
    np.testing.assert_array_equal(res.traces["rebinned"], jflags)
    if label == "skin hot":
        assert 1 <= res.rebins < 64            # premise: the trace moves
    # no step's predicate sits on the edge, where an ulp could flip it
    half = res.eff_skin * 0.5
    assert res.eff_skin == pytest.approx(JE.effective_skin(jres.plan.domain)
                                         if skin else 0.0)
    if skin:
        assert np.all(np.abs(res.traces["displacement"] - half) > 1e-6)


# ---------------------------------------------------------------------------
# JAX's tests/test_traj.py contracts on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog"])
def test_skin0_bitwise_parity(setup, integrator):
    """skin=0 forces a rebin every step; the trajectory must then match the
    per-step plan.execute loop bit for bit."""
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    res = run_trajectory(p, md0, 24, DT, integrator=integrator, skin=0.0,
                         segment_len=8)
    assert res.status == "ok"
    assert res.rebins == 24
    assert res.steps == 24
    _bitwise(res.state, _baseline(p, md0, 24, integrator))


def test_skin_reuse_few_rebins(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    res = run_trajectory(p, md0, 100, DT, skin=0.25, segment_len=16)
    assert res.status == "ok"
    assert res.rebins < 100 // 10
    assert res.eff_skin > 0
    md = _baseline(p, md0, 100)
    _close_min_image(dom, res.state.positions, md.positions, 1e-5, 1e-5)
    assert torch.allclose(res.state.velocities, md.velocities, atol=1e-4,
                          rtol=1e-4)
    assert len(res.traces["total"]) == 100


def test_trajectory_plan_coarsens(setup):
    dom, pos, vel, kern, p = setup
    tp = trajectory_plan(p, 0.25, pos)
    assert all(a <= b for a, b in zip(tp.domain.ncells, dom.ncells))
    assert tp.domain.cutoff == dom.cutoff
    assert effective_skin(tp.domain) >= 0.25 - 1e-6
    assert tp.m_c >= p.m_c
    assert skin_domain(dom, 0.0) is dom


def test_langevin_gamma0_matches_verlet(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    ra = run_trajectory(p, md0, 20, DT, integrator="langevin", gamma=0.0,
                        skin=0.0, segment_len=8)
    rb = run_trajectory(p, md0, 20, DT, skin=0.0, segment_len=8)
    _close_min_image(dom, ra.state.positions, rb.state.positions, 1e-5, 0.0)


@pytest.mark.parametrize("plan_kw", [
    {"strategy": "xpencil"},
    {"strategy": "xpencil", "layout": "packed"},
], ids=["dense", "packed"])
def test_resume_bit_identical(setup, tmp_path, plan_kw):
    """Interrupt at step 16 of 32, resume from the checkpoint: the final
    state is bit-identical to the uninterrupted run."""
    dom, pos, vel, kern, _ = setup
    p = plan(dom, kern, positions=pos, device="cpu", **plan_kw)
    md0 = init_state(p, pos, vel)
    kw = dict(skin=0.25, segment_len=4, checkpoint_every=8, seed=7)
    full = run_trajectory(p, md0, 32, DT, **kw)
    assert full.status == "ok"
    d = tmp_path / "ck"
    part = run_trajectory(p, md0, 16, DT, checkpoint_dir=d, **kw)
    assert part.status == "ok" and part.checkpoints >= 1
    assert ckpt.latest_step(d) == 16
    res = run_trajectory(p, md0, 32, DT, checkpoint_dir=d, resume=True, **kw)
    assert res.resumed_from == 16
    assert res.steps == 32
    _bitwise(res.state, full.state)
    assert len(res.traces["total"]) == 16


def test_langevin_resume_bit_identical(setup, tmp_path):
    """The generator's state rides in the carry and the checkpoint, so a
    resumed langevin run draws the noise the uninterrupted one drew."""
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    kw = dict(integrator="langevin", gamma=0.1, kT=1e-3, skin=0.25,
              segment_len=4, checkpoint_every=8, seed=11)
    full = run_trajectory(p, md0, 24, DT, **kw)
    other = run_trajectory(p, md0, 24, DT, **{**kw, "seed": 12})
    assert not torch.equal(full.state.velocities, other.state.velocities)
    d = tmp_path / "ck"
    run_trajectory(p, md0, 16, DT, checkpoint_dir=d, **kw)
    res = run_trajectory(p, md0, 24, DT, checkpoint_dir=d, **kw)
    assert res.resumed_from == 16
    _bitwise(res.state, full.state)


def test_resume_refuses_mismatched_config(setup, tmp_path):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    d = tmp_path / "ck"
    run_trajectory(p, md0, 16, DT, skin=0.25, segment_len=8,
                   checkpoint_dir=d, checkpoint_every=8)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_trajectory(p, md0, 32, DT, skin=0.25, segment_len=8,
                       checkpoint_dir=d, integrator="leapfrog")


def test_dense_packed_compact_allin_trajectories_bitwise(setup):
    dom, pos, vel, kern, _ = setup
    outs = {}
    for label, kw in (("dense", {}), ("packed", {"layout": "packed"}),
                      ("compact", {"compact": True}),
                      ("packed compact", {"layout": "packed",
                                          "compact": True})):
        p = plan(dom, kern, positions=pos, device="cpu", strategy="xpencil",
                 **kw)
        outs[label] = run_trajectory(p, init_state(p, pos, vel), 24, DT,
                                     skin=0.25, segment_len=8)
    pa = plan(dom, kern, positions=pos, device="cpu", strategy="allin")
    outs["allin"] = run_trajectory(pa, init_state(pa, pos, vel), 8, DT,
                                   skin=0.25, segment_len=8)
    short = run_trajectory(plan(dom, kern, positions=pos, device="cpu",
                                strategy="xpencil"),
                           init_state(pa, pos, vel), 8, DT, skin=0.25,
                           segment_len=8)
    for label, res in outs.items():
        assert res.status == "ok", label
        _bitwise(res.state, short.state if label == "allin"
                 else outs["dense"].state)


def test_injected_nan_rolls_back_and_recovers(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    clean = run_trajectory(p, md0, 32, DT, skin=0.25, segment_len=8)
    with chaos.inject(chaos.FaultSpec("traj.step", "nonfinite", p=1.0,
                                      after=1, max_fires=1), seed=3):
        res = run_trajectory(p, md0, 32, DT, skin=0.25, segment_len=8)
    assert res.status == "ok"
    assert res.rollbacks >= 1
    assert res.forced_rebins >= 1
    assert any(f.startswith("breach:nonfinite") for f in res.faults)
    assert res.steps == 32
    assert bool(torch.isfinite(res.state.positions).all())
    assert bool(torch.isfinite(res.state.velocities).all())
    _close_min_image(dom, res.state.positions, clean.state.positions,
                     1e-5, 1e-5)


def test_transient_error_retries_bitwise(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    clean = run_trajectory(p, md0, 24, DT, skin=0.25, segment_len=8)
    with chaos.inject(chaos.FaultSpec("traj.step", "error", p=1.0,
                                      after=1, max_fires=2), seed=5):
        res = run_trajectory(p, md0, 24, DT, skin=0.25, segment_len=8)
    assert res.status in ("ok", "degraded")
    assert res.retries == 2
    assert res.steps == 24
    _bitwise(res.state, clean.state)


def test_straggler_delay_completes(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    naps = []
    with chaos.inject(chaos.FaultSpec("traj.step", "delay", p=1.0,
                                      max_fires=2, param=0.5), seed=1):
        res = run_trajectory(p, md0, 16, DT, skin=0.25, segment_len=8,
                             sleep=naps.append)
    assert res.status == "ok" and res.steps == 16
    assert naps == [0.5, 0.5]


@pytest.mark.parametrize("site", ["traj.checkpoint", "ckpt.save"])
def test_checkpoint_crash_never_kills_run(setup, tmp_path, site):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    d = tmp_path / "ck"
    with chaos.inject(chaos.FaultSpec(site, "error", p=1.0, max_fires=1),
                      seed=2):
        res = run_trajectory(p, md0, 32, DT, skin=0.25, segment_len=8,
                             checkpoint_dir=d, checkpoint_every=8)
    assert res.status == "ok" and res.steps == 32
    assert "checkpoint:TransientBackendError" in res.faults
    assert res.checkpoints == 3
    assert ckpt.latest_step(d) == 32
    assert not [f for f in d.iterdir() if f.name.startswith(".tmp_")]


def test_forced_overflow_recorded(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    with chaos.inject(chaos.FaultSpec("traj.rebin", "overflow", p=1.0,
                                      max_fires=1), seed=4):
        res = run_trajectory(p, md0, 16, DT, skin=0.25, segment_len=8)
    assert res.status == "ok" and res.steps == 16
    assert "overflow:injected" in res.faults


def test_initial_overflow_replans(setup):
    """A skin plan measured on sparse positions grows its bounds when
    handed a clustered initial state (the grow-only replan contract)."""
    dom, pos, vel, kern, p = setup
    base = plan(dom, make_low_flop(), positions=pos, strategy="xpencil",
                device="cpu")
    sparse = trajectory_plan(base, 0.25, pos)
    rng = np.random.default_rng(2)
    # wider than JAX's 0.45, which on the plain CPU schedule grows m_c to
    # 224 and costs seconds a step
    blob = torch.from_numpy(np.mod(
        1.0 * rng.standard_normal((N, 3)) + 2.25, 6.0).astype(np.float32))
    assert sparse.check_overflow(ParticleState(blob))   # premise
    res = run_trajectory(base, blob, 2, 1e-6, segment_len=2, skin=0.25,
                         traj_plan=sparse)
    assert res.status == "ok"
    assert res.replans >= 1
    assert res.plan.m_c > sparse.m_c


def test_in_run_overflow_grows_m_c_and_replays(setup):
    """Particles converging mid-segment overflow ``m_c``: the monitors
    record it, the host grows ``m_c`` and replays from the anchor, and the
    result equals a run planned with the grown bound from the start."""
    dom, pos, vel, kern, _ = setup
    base = plan(dom, make_low_flop(), m_c=8, strategy="xpencil",
                device="cpu")
    start = torch.from_numpy(_inputs()[0])
    assert not base.check_overflow(ParticleState(start))   # premise
    inward = (3.0 - start) * 7.5           # converge on the center
    res = run_trajectory(base, start, 8, 1e-2, velocities=inward, skin=0.0,
                         segment_len=4)
    assert res.status == "ok" and res.replans >= 1
    assert res.plan.m_c > base.m_c
    assert not res.plan.check_overflow(ParticleState(res.state.positions))
    again = run_trajectory(dataclasses.replace(base, m_c=res.plan.m_c),
                           start, 8, 1e-2, velocities=inward, skin=0.0,
                           segment_len=4)
    _close_min_image(dom, res.state.positions, again.state.positions,
                     1e-6, 1e-6)


def test_energy_budget_breach_fails_to_anchor(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    res = run_trajectory(p, md0, 16, DT, skin=0.25, segment_len=8,
                         energy_budget=0.0, max_rollbacks=1)
    assert res.status == "failed"
    assert res.steps < 16
    assert any(f.startswith("breach:energy") for f in res.faults)
    assert bool(torch.isfinite(res.state.positions).all())


def test_energy_budget_healthy_run_not_breached(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    assert float(md0.potential.sum()) != 0.0             # premise
    res = run_trajectory(p, md0, 32, DT, skin=0.25, segment_len=8,
                         energy_budget=1e-2)
    assert res.status == "ok"
    assert res.rollbacks == 0


def test_monitor_energy_convention_matches_e0():
    pot = torch.tensor([2.0, 4.0])
    vel = torch.ones((2, 3))
    ke = 0.5 * torch.sum(vel ** 2)
    pe = 0.5 * torch.sum(pot)
    assert float(pe) != 0.0
    mon = init_monitors(ke + pe)
    mon2 = M.update(mon, positions=torch.zeros((2, 3)), velocities=vel,
                    forces=torch.zeros((2, 3)), potential=pot, valid=None,
                    kinetic=ke, potential_energy=pe,
                    step_disp=torch.tensor(0.0), eff_skin=0.5,
                    cell_max=torch.tensor(1, dtype=torch.int32),
                    row_max=torch.tensor(0, dtype=torch.int32),
                    units=torch.tensor(0, dtype=torch.int32))
    assert float(mon2.max_drift) == 0.0
    host = M.to_host(mon2)
    assert host.max_cell_count == 1 and isinstance(host.max_cell_count, int)


def test_classify_breach_ordering():
    prev = M.to_host(init_monitors(torch.tensor(1.0)))
    cur = dataclasses.replace(prev, nonfinite_steps=1, skin_steps=1,
                              max_drift=9.0)
    assert classify_breach(prev, cur, energy_budget=0.1) == "nonfinite"
    cur2 = dataclasses.replace(cur, nonfinite_steps=0)
    assert classify_breach(prev, cur2, energy_budget=0.1) == "skin"
    cur3 = dataclasses.replace(cur2, skin_steps=0)
    assert classify_breach(prev, cur3, energy_budget=0.1) == "energy"
    assert classify_breach(prev, cur3, energy_budget=None) is None
    assert classify_breach(prev, prev, energy_budget=0.1) is None


def test_integrators_run_routes_through_trajectory(setup):
    dom, pos, vel, kern, p = setup
    md0 = init_state(p, pos, vel)
    state, traces = integ_run(p, md0, 24, DT, skin=0.0, segment_len=8)
    assert traces["total"].shape == (24,)
    _bitwise(state, _baseline(p, md0, 24))


def test_integrators_run_legacy_rejects_traj_opts(setup):
    from repro_torch.core.engine import CellListEngine
    dom, pos, vel, kern, p = setup
    eng = CellListEngine(dom, kern, m_c=8, device="cpu")
    md0 = init_state(eng, pos, vel)
    for kw in (dict(skin=0.25), dict(integrator="langevin"),
               dict(integrator="nope")):
        with pytest.raises(ValueError, match="legacy per-step scan"):
            integ_run(eng, md0, 4, DT, **kw)
    state, traces = integ_run(eng, md0, 4, DT)
    assert traces["total"].shape == (4,)


def test_unsupported_strategy_and_state_raise(setup):
    dom, pos, vel, kern, p = setup
    pp = plan(dom, kern, positions=pos, strategy="par_part",
              backend="reference", device="cpu")
    with pytest.raises(ValueError, match="needs a cell schedule"):
        run_trajectory(pp, pos, 4, DT)
    with pytest.raises(ValueError, match="unknown integrator"):
        run_trajectory(p, pos, 4, DT, integrator="euler")
    with pytest.raises(ValueError, match="move the state"):
        run_trajectory(p, pos.to("meta"), 4, DT)


# ---------------------------------------------------------------------------
# fault texts: JAX's except branches, reached without one
# ---------------------------------------------------------------------------

def test_fault_texts_equal_jax(setup, tmp_path):
    jdom = JDomain.cubic(6, cutoff=1.0, periodic=True)
    dom, pos, vel, kern, p = setup
    jp = japi.plan(jdom, j_lj(sigma=0.3, eps=1e-4),
                   positions=jnp.asarray(pos.numpy()), strategy="xpencil")
    specs = (("traj.step", "error"), ("traj.step", "shard_loss"),
             ("traj.checkpoint", "error"), ("ckpt.save", "error"))
    faults = {}
    for pkg, run, spec_cls, inject, state in (
            ("jax", JE.run_trajectory, jchaos.FaultSpec, jchaos.inject,
             jnp.asarray(pos.numpy())),
            ("torch", run_trajectory, chaos.FaultSpec, chaos.inject, pos)):
        q = jp if pkg == "jax" else p
        with inject(*(spec_cls(s, k, max_fires=1) for s, k in specs),
                    seed=0):
            res = run(q, state, 16, DT, skin=0.25, segment_len=8,
                      checkpoint_dir=tmp_path / pkg, checkpoint_every=8)
        faults[pkg] = (res.faults, res.retries, res.checkpoints, res.status)
    assert faults["torch"] == faults["jax"]
    assert faults["torch"][0][:2] == [
        "ShardLost: injected shard loss at 'traj.step'",
        "TransientBackendError: injected transient error at 'traj.step'"]
    # a lost shard while checkpointing is no checkpoint failure: both
    # packages let it through
    with jchaos.inject(jchaos.FaultSpec("ckpt.save", "shard_loss")):
        with pytest.raises(jchaos.ShardLost):
            JE.run_trajectory(jp, jnp.asarray(pos.numpy()), 8, DT,
                              skin=0.25, segment_len=8, checkpoint_every=8,
                              checkpoint_dir=tmp_path / "jax2")
    with chaos.inject(chaos.FaultSpec("ckpt.save", "shard_loss")):
        with pytest.raises(chaos.ShardLost):
            run_trajectory(p, pos, 8, DT, skin=0.25, segment_len=8,
                           checkpoint_every=8,
                           checkpoint_dir=tmp_path / "torch2")
