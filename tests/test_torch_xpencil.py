"""The port's X-pencil path against the JAX package's.

Same inputs (numpy, from a seed) through both packages: the port's plain
X-pencil (what the CUDA kernel's wrapper runs on a CPU tensor) against
JAX's reference strategy and its Pallas kernel in interpret mode, and the
port's ``plan(..., device="cpu").execute()`` against JAX's
``plan(...).execute()`` and both packages' O(N^2) oracles. Forces are not
bit-equal across frameworks (the summation order differs), so each element
is held to rtol 3e-4 and an atol of 3e-4 times the sum of the sizes of its
own pair terms. Rounding cannot reach that, a wrong or missing term does,
and a near-overlap elsewhere (LJ forces reach 1e15 here) does not widen the
tolerance of the other elements. Within the port, padded input gives the
real rows the same bits as unpadded input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import strategies as JS
from repro.core import interactions as JI
from repro.kernels.xpencil import xpencil_forces as j_pallas_xpencil
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 state_from_numpy)
from repro_torch.core import ParticleState, bin_particles, plan
from repro_torch.core.interactions import PairKernel
from repro_torch.core import strategies as S
from repro_torch.kernels.ref import xpencil_ref
from repro_torch.kernels.xpencil import xpencil_forces

torch.set_num_threads(1)

J_KERNELS = {
    "lennard_jones": JI.make_lennard_jones,
    "low_flop": JI.make_low_flop,
    # 4 extra terms, not 25: the same code at a fifth of XLA's compile time
    "high_flop": lambda: JI.make_high_flop(extra_terms=4),
    "gravity": JI.make_gravity,
    "sph_density": lambda: JI.make_sph_density(1.0),
}
DIVISION, N = 3, 150

_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_XPENCIL = jax.jit(JS.xpencil, static_argnames=("domain", "kernel"))
_J_NAIVE = jax.jit(JS.naive_n2, static_argnames=("domain", "kernel"))


def _term_sizes(kern):
    """Pair kernels whose potential channel sums, per target, the size of
    each pair term: |coeff| * r bounds every force component's term,
    |potential| the potential's."""
    return (PairKernel("force_term_size", torch.zeros_like,
                       lambda r2: kern.coeff(r2).abs() * r2.sqrt(), flops=0),
            PairKernel("potential_term_size", torch.zeros_like,
                       lambda r2: kern.potential(r2).abs(), flops=0))


def _close(got, want, size, what):
    """|got - want| <= 3e-4 * (|want| + size), element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    size = np.asarray(size, np.float64)
    assert np.all(np.isfinite(got)), what
    bad = np.abs(got - want) > 3e-4 * (np.abs(want) + size)
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} "
                           f"elements off, e.g. {got[bad][:3]} vs "
                           f"{want[bad][:3]} (term sizes {size[bad][:3]})")


def _case(name, periodic, seed=0):
    jdom = JDomain.cubic(DIVISION, cutoff=1.0, periodic=periodic)
    jk = J_KERNELS[name]()
    pos = (np.random.default_rng(seed).uniform(0, 1, (N, 3))
           * DIVISION).astype(np.float32)
    return jdom, jk, domain_from_jax(jdom), kernel_from_jax(jk), pos


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(J_KERNELS))
def test_xpencil_matches_jax(name, periodic):
    jdom, jk, dom, kern, pos = _case(name, periodic)
    m_c = 16
    nx, ny, nz = dom.ncells

    # planes: port plain kernel vs JAX reference strategy and Pallas kernel
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=m_c)
    jb = _J_BIN(jdom, jnp.asarray(pos), m_c=m_c)
    got = xpencil_forces(tb.planes, tb.slot_id, nx=nx, m_c=m_c, kernel=kern,
                         cutoff2=1.0)
    ref = xpencil_ref(dom, tb, kern)
    jref = [np.asarray(o).reshape(nz, ny, nx * m_c)
            for o in _J_XPENCIL(jdom, jb, jk)]
    jpal = j_pallas_xpencil(jb.planes, jb.slot_id, nx=nx, m_c=m_c, kernel=jk,
                            cutoff2=1.0, interpret=True)
    fsize, usize = (S.xpencil_planes(
        tb.planes["x"], tb.planes["y"], tb.planes["z"], tb.slot_id, nx=nx,
        m_c=m_c, kernel=k, cutoff2=1.0)[3] for k in _term_sizes(kern))
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        assert got[i].shape == (nz, ny, nx * m_c)
        np.testing.assert_array_equal(got[i].numpy(), ref[i].numpy())
        size = usize if what == "pot" else fsize
        _close(got[i].numpy(), jref[i], size, f"{what} vs JAX reference")
        _close(got[i].numpy(), np.asarray(jpal[i]), size,
               f"{what} vs JAX Pallas")

    # end to end: plan/execute in both packages and both O(N^2) oracles
    state = state_from_numpy(pos, device="cpu")
    f, u = plan(dom, kern, positions=state.positions,
                device="cpu", strategy="xpencil").execute(state)
    jf, ju = j_plan(jdom, jk, positions=jnp.asarray(pos),
                    strategy="xpencil").execute(JState(jnp.asarray(pos)))
    *nf, nu = S.naive_n2(dom, state.positions, kern)
    nf = torch.stack(nf, -1)
    jn = _J_NAIVE(jdom, jnp.asarray(pos), jk)
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(kern))
    for what, want_f, want_u in (("JAX plan", jf, ju),
                                 ("port naive_n2", nf, nu),
                                 ("JAX naive_n2", np.stack(jn[:3], -1), jn[3])):
        _close(f.numpy(), want_f, fsize[:, None], f"forces vs {what}")
        _close(u.numpy(), want_u, usize, f"potential vs {what}")


@pytest.mark.parametrize("periodic", [False, True])
def test_padded_equals_unpadded_bitwise(periodic):
    _, _, dom, kern, pos = _case("lennard_jones", periodic, seed=3)
    rng = np.random.default_rng(4)
    n_pad = 40
    where = np.sort(rng.choice(N + n_pad, n_pad, replace=False))
    real = np.setdiff1d(np.arange(N + n_pad), where)
    padded = np.zeros((N + n_pad, 3), np.float32)
    padded[real] = pos
    padded[where] = rng.uniform(0, DIVISION, (n_pad, 3))
    valid = np.ones(N + n_pad, bool)
    valid[where] = False

    p = plan(dom, kern, m_c=16, device="cpu", strategy="xpencil")
    f, u = p.execute(state_from_numpy(pos, device="cpu"))
    fp, up = p.execute(state_from_numpy(padded, valid=valid, device="cpu"))
    np.testing.assert_array_equal(fp[real].numpy(), f.numpy())
    np.testing.assert_array_equal(up[real].numpy(), u.numpy())
    assert not fp[where].any() and not up[where].any()


def test_cuda_and_reference_backends_agree_on_cpu():
    """On CPU tensors the cuda backend's wrapper runs the plain version, so
    both backends give the same bits."""
    _, _, dom, kern, pos = _case("gravity", True, seed=5)
    state = state_from_numpy(pos, device="cpu")
    a = plan(dom, kern, m_c=16, device="cpu",
             strategy="xpencil").execute(state)
    b = plan(dom, kern, m_c=16, device="cpu",
             backend="reference", strategy="xpencil").execute(state)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_naive_n2_through_plan():
    _, _, dom, kern, pos = _case("low_flop", False, seed=6)
    state = ParticleState(torch.from_numpy(pos))
    f, u = plan(dom, kern, m_c=16, strategy="naive_n2",
                device="cpu").execute(state)
    fx, fy, fz, pot = S.naive_n2(dom, state.positions, kern)
    np.testing.assert_array_equal(f.numpy(), torch.stack([fx, fy, fz], -1))
    np.testing.assert_array_equal(u.numpy(), pot.numpy())
