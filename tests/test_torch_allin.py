"""The port's All-in-SM path against the JAX package's.

Same inputs (numpy, from a seed) through both packages. The sub-box sizing
at the JAX package's VMEM budget gives the JAX box, and the port's Hopper
defaults give halo blocks that fit a block's 232,448 B of shared memory.
The sub-box occupancy is pure data movement and bit-equal to JAX's. The
port's ``allin`` (dense and compacted, the plain version of kernel E) is
held against JAX's reference backend at a common box, each element within
rtol 3e-4 plus 3e-4 times the sizes of its own pair terms (the tolerance
of ``test_torch_xpencil.py``). JAX's Pallas ``allin_forces`` cannot run on
the installed JAX (ROADMAP Queue 3), so it is not used. Within the port,
compacted, padded and X-pencil results are bit-equal to dense All-in-SM,
and the sub-box follows ``m_c`` on replan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import strategies as JS
from repro.core.binning import (subbox_counts as j_subbox_counts,
                                subbox_occupancy as j_subbox_occupancy)
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 occupancy_to_numpy, state_from_numpy)
from repro_torch.core import (Domain, active_unit_count, bin_particles,
                              n_units, plan, subbox_counts, subbox_occupancy)
from repro_torch.core import strategies as S
from repro_torch.kernels.allin import allin_forces, halo_bytes
from repro_torch.kernels.ref import allin_ref, xpencil_ref
from test_torch_sparse import blob
from test_torch_xpencil import J_KERNELS, _close, _term_sizes

torch.set_num_threads(1)

JAX_BUDGET = dict(smem_budget_bytes=8 * 2 ** 20, min_blocks=8)

_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_ALLIN = jax.jit(JS.allin, static_argnames=("domain", "kernel", "box"))


def _bins(jdom, pos, m_c):
    return (bin_particles(domain_from_jax(jdom), torch.from_numpy(pos),
                          m_c=m_c),
            _J_BIN(jdom, jnp.asarray(pos), m_c=m_c))


# ---------------------------------------------------------------------------
# sub-box sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncells", [(4, 4, 4), (16, 16, 16), (64, 64, 64),
                                    (12, 5, 3), (1, 5, 5), (40, 1, 2)])
@pytest.mark.parametrize("m_c", [1, 8, 24, 72, 600])
def test_subbox_dims_at_jax_budget_give_the_jax_box(ncells, m_c):
    jdom = JDomain(box=tuple(float(n) for n in ncells), ncells=ncells,
                   cutoff=1.0)
    dom = domain_from_jax(jdom)
    got = S.subbox_dims(dom, m_c, **JAX_BUDGET)
    assert got == JS.subbox_dims(jdom, m_c)
    assert S.shrink_to_divisors(dom, got) == \
        JS.shrink_to_divisors(jdom, JS.subbox_dims(jdom, m_c))


@pytest.mark.parametrize("division,m_c,box", [
    (64, 24, (4, 4, 4)), (32, 40, (4, 4, 4)), (64, 72, (4, 4, 2))])
def test_hopper_defaults_give_the_worked_boxes(division, m_c, box):
    dom = Domain.cubic(division)
    got = S.shrink_to_divisors(dom, S.subbox_dims(dom, m_c))
    assert got == box
    assert halo_bytes(got, m_c) == {24: 82944, 40: 138240,
                                    72: 165888}[m_c]


@pytest.mark.parametrize("division", [4, 16, 64])
def test_hopper_default_halos_fit_shared_memory(division):
    dom = Domain.cubic(division)
    for m_c in (1, 4, 8, 16, 24, 40, 72, 128, 256, 538):
        box = S.shrink_to_divisors(dom, S.subbox_dims(dom, m_c))
        assert halo_bytes(box, m_c) <= S.SMEM_BUDGET_BYTES, (m_c, box)
    # past m_c 538 not even a (1, 1, 1) box fits: the wrapper raises
    assert halo_bytes((1, 1, 1), 539) > S.SMEM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# sub-box occupancy, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_active", ["overflowed", "exact", "all"])
@pytest.mark.parametrize("case", ["open", "periodic", "thin"])
def test_subbox_occupancy_bit_equal_to_jax(case, max_active):
    if case == "thin":       # 1-cell-thick periodic X axis
        jdom = JDomain(box=(1.0, 6.0, 4.0), ncells=(1, 6, 4), cutoff=1.0,
                       periodic=True)
        pos = (np.random.default_rng(7).uniform(0, 1, (60, 3))
               * np.asarray(jdom.box) * [1.0, 0.5, 1.0]).astype(np.float32)
        box = (1, 2, 2)
    else:
        jdom, pos = blob(6, 200, seed=0, periodic=case == "periodic")
        box = (2, 3, 1)
    dom = domain_from_jax(jdom)
    tb, jb = _bins(jdom, pos, m_c=16)
    np.testing.assert_array_equal(
        subbox_counts(dom, tb.counts, box).numpy(),
        np.asarray(j_subbox_counts(jdom, jb.counts, box)))
    n_act = active_unit_count(dom, None, "allin", box=box, counts=tb.counts)
    total = n_units(dom, "allin", box=box)
    assert 0 < n_act < total                          # some boxes are empty
    bound = {"overflowed": n_act - 1, "exact": n_act, "all": total}
    occ = subbox_occupancy(dom, tb.counts, box, bound[max_active])
    jocc = j_subbox_occupancy(jdom, jb.counts, box, bound[max_active])
    got = occupancy_to_numpy(occ)
    want = {"unit_counts": jocc.unit_counts, "active": jocc.active,
            "n_active": jocc.n_active,
            "scatter_indices": jocc.scatter_indices()}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert bool(occ.overflowed) == (max_active == "overflowed")


# ---------------------------------------------------------------------------
# the schedule against JAX's reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", ["lennard_jones", "low_flop", "gravity"])
def test_allin_plain_matches_jax_reference(name, periodic):
    jdom, pos = blob(4, 150, seed=1, periodic=periodic, sigma_frac=0.25)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    m_c, box = 16, (2, 2, 1)
    nx, ny, nz = dom.ncells
    tb, jb = _bins(jdom, pos, m_c)
    got = allin_forces(tb.planes, tb.slot_id, box=box, m_c=m_c, kernel=kern,
                       cutoff2=1.0)
    jref = [np.asarray(o).reshape(nz, ny, nx * m_c)
            for o in _J_ALLIN(jdom, jb, jk, box=box)]
    fsize, usize = (S.allin_planes(
        tb.planes["x"], tb.planes["y"], tb.planes["z"], tb.slot_id, box=box,
        m_c=m_c, kernel=k, cutoff2=1.0)[3] for k in _term_sizes(kern))
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        assert got[i].shape == (nz, ny, nx * m_c)
        _close(got[i].numpy(), jref[i], usize if what == "pot" else fsize,
               f"{what} vs JAX allin")
    # the plain twins of kernels E and B give the same bits
    for a, b, c in zip(got, allin_ref(dom, tb, kern, box),
                       xpencil_ref(dom, tb, kern)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_allin_plan_matches_jax_reference(compact, periodic):
    jdom, pos = blob(6, 200, seed=3, periodic=periodic)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    state = state_from_numpy(pos, device="cpu")
    box = (2, 2, 1)
    p = plan(dom, kern, positions=state.positions, device="cpu",
             strategy="allin", backend="reference", compact=compact, box=box)
    jp = j_plan(jdom, jk, positions=jnp.asarray(pos), strategy="allin",
                backend="reference", compact=compact, box=box)
    assert (p.m_c, p.box, p.max_active) == (jp.m_c, jp.box, jp.max_active)
    if compact:
        assert p.max_active < n_units(dom, "allin", box=box)
    f, u = p.execute(state)
    jf, ju = jp.execute(JState(jnp.asarray(pos)))
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(kern))
    _close(f.numpy(), jf, fsize[:, None], "forces vs JAX allin plan")
    _close(u.numpy(), ju, usize, "potential vs JAX allin plan")


# ---------------------------------------------------------------------------
# bit identities within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_allin_compact_equals_dense_and_xpencil_bitwise(periodic):
    jdom, pos = blob(6, 200, seed=4, periodic=periodic)
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    xp = plan(dom, positions=state.positions, device="cpu",
              strategy="xpencil").execute(state)
    for box in (None, (2, 2, 2), (3, 6, 1)):
        for compact, backend in ((False, "reference"), (True, "reference"),
                                 (False, "cuda")):
            p = plan(dom, positions=state.positions, device="cpu",
                     strategy="allin", compact=compact, backend=backend,
                     box=box)
            for a, b in zip(p.execute(state), xp):
                assert torch.equal(a, b), (box, compact, backend)


def test_cuda_allin_on_cpu_runs_the_plain_version():
    jdom, pos = blob(4, 120, seed=5, periodic=True)
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    p = plan(dom, positions=state.positions, device="cpu", strategy="allin")
    assert p.backend == "cuda"
    allin_forces.launches = 0
    got = p.execute(state)
    ref = plan(dom, positions=state.positions, device="cpu",
               strategy="allin", backend="reference").execute(state)
    assert allin_forces.launches == 0                  # no kernel on the CPU
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_allin_padded_equals_unpadded_bitwise():
    jdom, pos = blob(4, 150, seed=6, periodic=True)
    dom = domain_from_jax(jdom)
    rng = np.random.default_rng(8)
    n, n_pad = pos.shape[0], 30
    where = np.sort(rng.choice(n + n_pad, n_pad, replace=False))
    real = np.setdiff1d(np.arange(n + n_pad), where)
    padded = np.zeros((n + n_pad, 3), np.float32)
    padded[real] = pos
    padded[where] = rng.uniform(0, 4, (n_pad, 3))
    valid = np.ones(n + n_pad, bool)
    valid[where] = False
    for compact, backend in ((False, "cuda"), (True, "reference")):
        p = plan(dom, m_c=24, device="cpu", strategy="allin",
                 backend=backend, compact=compact, max_active=8)
        f, u = p.execute(state_from_numpy(pos, device="cpu"))
        fp, up = p.execute(state_from_numpy(padded, valid=valid,
                                            device="cpu"))
        assert torch.equal(fp[real], f) and torch.equal(up[real], u)
        assert not fp[where].any() and not up[where].any()


def test_allin_wrapper_checks_the_box():
    dom = Domain.cubic(4)
    pos = dom.sample_uniform(50, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    bins = bin_particles(dom, pos, m_c=8)
    kern = kernel_from_jax(J_KERNELS["low_flop"]())
    for box in ((3, 1, 1), (1, 1, 0), (8, 4, 4)):
        with pytest.raises(ValueError, match="must divide the grid"):
            allin_forces(bins.planes, bins.slot_id, box=box, m_c=8,
                         kernel=kern, cutoff2=1.0)
    with pytest.raises(ValueError, match="do not match m_c=5"):
        allin_forces(bins.planes, bins.slot_id, box=(1, 1, 1), m_c=5,
                     kernel=kern, cutoff2=1.0)


# ---------------------------------------------------------------------------
# the replan contract: the sub-box follows m_c
# ---------------------------------------------------------------------------

def _clustered(seed=9):
    """300 particles on a (12, 6, 6) grid, 14 of them in one cell: m_c 8
    overflows and grows to 24, and the Hopper-default sub-box of the grid
    changes with it, from (2, 1, 1) to (3, 1, 1). The port's twin of the
    JAX package's test_replan_resizes_allin_subbox."""
    dom = Domain(box=(12.0, 6.0, 6.0), ncells=(12, 6, 6), cutoff=1.0)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (300, 3)) * [12.0, 6.0, 6.0]
    pos[:14] = [5.0, 2.0, 2.0] + rng.uniform(0.1, 0.9, (14, 3))
    return dom, state_from_numpy(pos.astype(np.float32), device="cpu")


def test_replan_resizes_allin_subbox():
    dom, state = _clustered()
    p0 = plan(dom, m_c=8, device="cpu", strategy="allin")
    assert p0.box == (2, 1, 1)
    assert p0.overflow_class(state) == "m_c"
    (f, u), p1 = p0.execute_or_replan(state)
    assert p1.m_c == 24 and p1.box == (3, 1, 1)
    assert p1.box == S.shrink_to_divisors(dom, S.subbox_dims(dom, p1.m_c))
    *nf, nu = S.naive_n2(dom, state.positions, p0.kernel)
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(p0.kernel))
    _close(f.numpy(), torch.stack(nf, -1), fsize[:, None], "forces")
    _close(u.numpy(), nu, usize, "potential")
    # an explicit box is kept while m_c holds
    p2 = plan(dom, m_c=24, device="cpu", strategy="allin", box=(2, 2, 2))
    assert p2.replan(state) == p2


def test_replan_remeasures_compact_allin_on_the_new_tiling():
    dom, state = _clustered()
    p0 = plan(dom, m_c=8, device="cpu", strategy="allin", backend="reference",
              compact=True, max_active=1, box=(2, 2, 2))
    p1 = p0.replan(state)
    assert (p1.m_c, p1.box) == (24, (3, 1, 1))
    n_act = active_unit_count(dom, state.positions, "allin", box=p1.box)
    assert p1.max_active >= n_act > 1
    assert not p1.check_overflow(state)
    dense = plan(dom, m_c=24, device="cpu", strategy="xpencil").execute(state)
    for a, b in zip(p1.execute(state), dense):
        assert torch.equal(a, b)
