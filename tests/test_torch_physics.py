"""The port's MD/SPH substrate (``repro_torch.physics``).

JAX's ``tests/test_physics.py`` on the port (energy and momentum
conservation, particles kept in the box, SPH density near uniform, Verlet
reversibility), on inputs made with numpy; one step of each integrator and
the observables within 1e-6 of JAX's on the same inputs; ``sph.density``
and ``sph_step`` on the ``"cuda"`` backend's plain versions within a
scale-relative 3e-4 of JAX's reference backend.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CellListEngine as JEngine, Domain as JDomain
from repro.core import make_lennard_jones as j_lj
from repro.physics import init_state as j_init, leapfrog as j_leapfrog
from repro.physics import observables as JO, sph as jsph
from repro.physics import velocity_verlet as j_vv
from repro_torch.convert import domain_from_jax
from repro_torch.core import (CellListEngine, Domain, make_lennard_jones,
                              make_sph_density, suggest_m_c)
from repro_torch.physics import (init_state, leapfrog, run, temperature,
                                 total_energy, total_momentum,
                                 velocity_verlet)
from repro_torch.physics import observables as O, sph

torch.set_num_threads(1)


def _uniform(dom, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((n, 3)) *
                             np.asarray(dom.box)).astype(np.float32))


@pytest.fixture(scope="module")
def md_setup():
    dom = Domain.cubic(4, cutoff=1.0, periodic=True)
    pos = _uniform(dom, 200, 0)
    kern = make_lennard_jones(sigma=0.25, eps=1.0, softening=1e-4)
    eng = CellListEngine(dom, kern, m_c=max(16, suggest_m_c(dom, pos)),
                         strategy="xpencil", device="cpu")
    # relax overlaps first (clipped-force descent, JAX's recipe)
    box = torch.tensor(dom.box)
    for _ in range(120):
        f, _ = eng.compute(pos)
        pos = torch.remainder(pos + torch.clamp(f, -1.0, 1.0) * 2e-3, box)
    rng = np.random.default_rng(1)
    vel = torch.from_numpy((0.05 * rng.standard_normal((200, 3))).astype(
        np.float32))
    return dom, eng, init_state(eng, pos, vel)


def test_energy_conservation(md_setup):
    dom, eng, state = md_setup
    final, traces = run(eng, state, n_steps=200, dt=1e-4)
    e = traces["total"].numpy()
    drift = abs(e[-1] - e[0]) / (abs(e[0]) + 1e-9)
    assert drift < 5e-2, f"energy drift {drift:.3e}"
    assert bool(torch.isfinite(final.positions).all())
    assert final.step == 200


def test_momentum_conservation(md_setup):
    dom, eng, state = md_setup
    p0 = total_momentum(state.velocities)
    final, _ = run(eng, state, n_steps=100, dt=1e-4)
    assert torch.allclose(total_momentum(final.velocities), p0, atol=5e-3)


def test_particles_stay_in_box(md_setup):
    dom, eng, state = md_setup
    final, _ = run(eng, state, n_steps=50, dt=1e-4)
    pos = final.positions
    assert bool((pos >= 0).all()) and bool(
        (pos <= torch.tensor(dom.box)).all())


def test_sph_density_positive_and_near_uniform():
    dom = Domain.cubic(5, cutoff=1.0, periodic=True)
    pos = _uniform(dom, 5 ** 3 * 20, 2)
    rho = sph.density(dom, pos, sph.SPHParams(h=1.0, mass=1.0),
                      suggest_m_c(dom, pos))
    assert bool((rho > 0).all())
    cv = float(rho.std() / rho.mean())
    assert cv < 0.5, f"density CV {cv:.3f} too high for uniform input"


def test_integrator_reversibility():
    dom = Domain.cubic(3, cutoff=1.0, periodic=True)
    pos = _uniform(dom, 80, 4)
    kern = make_lennard_jones(sigma=0.2, softening=1e-4)
    eng = CellListEngine(dom, kern, m_c=24, strategy="cell_dense",
                         backend="reference", device="cpu")
    rng = np.random.default_rng(5)
    vel = torch.from_numpy((0.02 * rng.standard_normal((80, 3))).astype(
        np.float32))
    state = init_state(eng, pos, vel)
    fwd, _ = run(eng, state, n_steps=20, dt=5e-5)
    back = init_state(eng, fwd.positions, -fwd.velocities)
    rev, _ = run(eng, back, n_steps=20, dt=5e-5)
    assert torch.allclose(rev.positions, state.positions, rtol=1e-3,
                          atol=1e-3)


# ---------------------------------------------------------------------------
# against JAX on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog"])
def test_one_step_and_observables_equal_jax(integrator):
    jdom = JDomain.cubic(4, cutoff=1.0, periodic=True)
    dom = domain_from_jax(jdom)
    pos = _uniform(dom, 120, 6)
    rng = np.random.default_rng(7)
    vel = torch.from_numpy((0.3 * rng.standard_normal((120, 3))).astype(
        np.float32))
    jeng = JEngine(jdom, j_lj(sigma=0.25, eps=1.0, softening=1e-4), m_c=16,
                   strategy="xpencil")
    eng = CellListEngine(dom, make_lennard_jones(sigma=0.25, eps=1.0,
                                                 softening=1e-4),
                         m_c=16, strategy="xpencil", device="cpu")
    jstate = j_init(jeng, jnp.asarray(pos.numpy()),
                    jnp.asarray(vel.numpy()))
    state = init_state(eng, pos, vel)
    factories = {"velocity_verlet": (velocity_verlet, j_vv),
                 "leapfrog": (leapfrog, j_leapfrog)}[integrator]
    new = factories[0](eng, 2e-3)(state)
    jnew = factories[1](jeng, 2e-3)(jstate)

    def close(got, want, what, scale=None):
        want = np.asarray(want, np.float64)
        got = np.asarray(got, np.float64)
        if scale is None:
            scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= 1e-6 * scale, what

    for f in ("positions", "velocities", "forces", "potential"):
        close(getattr(new, f), getattr(jnew, f), f)
    assert new.step == int(jnew.step) == 1
    v, u = new.velocities, new.potential
    jv, ju = jnew.velocities, jnew.potential
    close(O.kinetic_energy(v, 2.0), JO.kinetic_energy(jv, 2.0), "kinetic")
    close(O.potential_energy(u), JO.potential_energy(ju), "potential")
    close(total_energy(v, u), JO.total_energy(jv, ju), "total")
    # a sum of terms that cancel: relative to the sum of their sizes
    close(total_momentum(v), JO.total_momentum(jv), "momentum",
          scale=float(np.abs(np.asarray(jv)).sum()))
    close(temperature(v), JO.temperature(jv), "temperature")


def _scale_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_sph_against_jax_reference():
    jdom = JDomain.cubic(4, cutoff=1.0, periodic=True)
    dom = domain_from_jax(jdom)
    pos = _uniform(dom, 4 ** 3 * 10, 8)
    m_c = suggest_m_c(dom, pos)
    params = sph.SPHParams(h=1.0, mass=1.0)
    jparams = jsph.SPHParams(h=1.0, mass=1.0)
    jpos = jnp.asarray(pos.numpy())
    rho = sph.density(dom, pos, params, m_c)
    jrho = jsph.density(jdom, jpos, jparams, m_c)
    assert _scale_rel(rho, jrho) <= 3e-4
    vel = torch.zeros_like(pos)
    got = sph.sph_step(dom, pos, vel, params, m_c, dt=1e-3)
    want = jsph.sph_step(jdom, jpos, jnp.zeros_like(jpos), jparams, m_c,
                         dt=1e-3)
    for g, w, what in zip(got, want, ("positions", "velocities", "rho")):
        assert _scale_rel(g, w) <= 3e-4, what
    assert float(got[1].abs().max()) > 0                 # premise: moved
    # the pressure kernel's CUDA form: the density's, with its scale as the
    # coefficient's third parameter (1.0 for the density itself)
    kern = sph.make_pressure_kernel(params, 1000.0, 1.0)
    dens = make_sph_density(1.0).cuda
    assert kern.cuda.kind == dens.kind
    assert kern.cuda.params[:2] == dens.params[:2] and dens.params[2] == 1.0
    assert kern.cuda.params[2] == -1.0 * 2.0 * 1.0 / 1000.0 ** 2
    r2 = torch.tensor([0.01, 0.3, 0.81])
    want_c = jsph.make_pressure_kernel(jparams, 1000.0, 1.0).coeff(
        jnp.asarray(r2.numpy()))
    assert _scale_rel(kern.coeff(r2), want_c) <= 1e-6
