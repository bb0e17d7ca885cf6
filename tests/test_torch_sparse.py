"""The port's occupancy-compacted X-pencil path against the JAX package's.

Same inputs (numpy, from a seed) through both packages. The occupancy
summary is pure data movement and bit-equal to JAX's. Kernel C's plain
version (what its wrapper runs on a CPU tensor) is held against JAX's
Pallas kernel in interpret mode and JAX's reference strategy, and
``plan(..., compact=True).execute()`` against JAX's plan and both O(N^2)
oracles, each element within rtol 3e-4 plus 3e-4 times the sizes of its
own pair terms (the tolerance of ``test_torch_xpencil.py``: the summation
order differs across frameworks). Within the port, compacted and dense
results are bit-equal, and the ``max_active`` bound keeps the replan
contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import strategies as JS
from repro.core.api import (active_unit_count as j_active_unit_count,
                            n_units as j_n_units,
                            suggest_max_active as j_suggest_max_active)
from repro.core.binning import (gather_pencil_rows as j_gather_pencil_rows,
                                pencil_occupancy as j_pencil_occupancy)
from repro.kernels.xpencil import xpencil_sparse_forces as j_pallas_sparse
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 occupancy_to_numpy, state_from_numpy)
from repro_torch.core import (Domain, active_unit_count, bin_particles,
                              n_units, pencil_occupancy, plan, scenarios,
                              suggest_m_c, suggest_max_active)
from repro_torch.core import strategies as S
from repro_torch.core.binning import gather_pencil_rows
from repro_torch.kernels.ref import xpencil_sparse_ref
from repro_torch.kernels.xpencil import xpencil_sparse_forces
from test_torch_xpencil import J_KERNELS, _close, _term_sizes

torch.set_num_threads(1)


def blob(division, n, seed, periodic=False, sigma_frac=0.15):
    """The clustered scene of ``test_layout_matrix.py`` (one Gaussian blob
    at the box centre, clipped inside the box), made with numpy; a wider
    blob than there keeps ``m_c`` (and the CPU time) small."""
    jdom = JDomain.cubic(division, cutoff=1.0, periodic=periodic)
    box = np.asarray(jdom.box, np.float32)
    rng = np.random.default_rng(seed)
    pos = box * 0.5 + (sigma_frac * float(min(jdom.box))
                       * rng.standard_normal((n, 3)))
    return jdom, np.clip(pos, 1e-4, box - 1e-4).astype(np.float32)


_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_SPARSE = jax.jit(JS.xpencil_sparse, static_argnames=("domain", "kernel"))
_J_NAIVE = jax.jit(JS.naive_n2, static_argnames=("domain", "kernel"))


def _bins(jdom, pos, m_c):
    return (bin_particles(domain_from_jax(jdom), torch.from_numpy(pos),
                          m_c=m_c),
            _J_BIN(jdom, jnp.asarray(pos), m_c=m_c))


# ---------------------------------------------------------------------------
# the occupancy summary, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_active", ["overflowed", "exact", "all"])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_occupancy_bit_equal_to_jax(periodic, max_active):
    jdom, pos = blob(6, 200, seed=0, periodic=periodic)
    dom = domain_from_jax(jdom)
    tb, jb = _bins(jdom, pos, m_c=16)
    n_act = active_unit_count(dom, None, counts=tb.counts)
    bound = {"overflowed": 3, "exact": n_act, "all": dom.nz * dom.ny}
    occ = pencil_occupancy(dom, tb.counts, bound[max_active])
    jocc = j_pencil_occupancy(jdom, jb.counts, bound[max_active])
    got = occupancy_to_numpy(occ)
    want = {"unit_counts": jocc.unit_counts, "active": jocc.active,
            "n_active": jocc.n_active,
            "scatter_indices": jocc.scatter_indices()}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert bool(occ.overflowed) == (max_active == "overflowed")
    assert 0 < float(occ.fill_fraction) < 1       # the blob is clustered


def test_gather_pencil_rows_bit_equal_to_jax():
    jdom, pos = blob(4, 120, seed=1)
    tb, jb = _bins(jdom, pos, m_c=16)
    act = np.asarray([0, 5, 9, 14], np.int32)
    for dz, dy in ((0, 0), (-1, 1), (1, -1)):
        np.testing.assert_array_equal(
            gather_pencil_rows(tb.planes["x"], torch.from_numpy(act), 4,
                               dz, dy).numpy(),
            np.asarray(j_gather_pencil_rows(jb.planes["x"], jnp.asarray(act),
                                            4, dz, dy)))


def test_bound_probes_match_jax():
    for periodic in (False, True):
        jdom, pos = blob(6, 200, seed=2, periodic=periodic)
        dom, tpos, jpos = domain_from_jax(jdom), torch.from_numpy(pos), \
            jnp.asarray(pos)
        assert active_unit_count(dom, tpos) == j_active_unit_count(jdom, jpos)
        assert n_units(dom) == j_n_units(jdom) == 36
        for slack in (1.0, 1.25, 100.0):
            assert suggest_max_active(dom, tpos, slack=slack) == \
                j_suggest_max_active(jdom, jpos, slack=slack)
        # huge slack clips to the total pencil count, never beyond
        assert suggest_max_active(dom, tpos, slack=100.0) == n_units(dom)
        # the sub-box units of allin, on tilings given to both packages
        for box in ((2, 3, 1), (3, 3, 3), (4, 1, 2)):
            assert active_unit_count(dom, tpos, "allin", box=box) == \
                j_active_unit_count(jdom, jpos, "allin", box=box)
            assert n_units(dom, "allin", box=box) == \
                j_n_units(jdom, "allin", box=box)
            assert suggest_max_active(dom, tpos, "allin", box=box) == \
                j_suggest_max_active(jdom, jpos, "allin", box=box)


# ---------------------------------------------------------------------------
# kernel C's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", sorted(J_KERNELS))
def test_sparse_kernel_plain_matches_jax(name, periodic):
    jdom, pos = blob(4, 120, seed=0, periodic=periodic)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    nx, ny, nz = dom.ncells
    m_c = suggest_m_c(dom, torch.from_numpy(pos))
    tb, jb = _bins(jdom, pos, m_c)
    n_act = active_unit_count(dom, None, counts=tb.counts)
    max_active = n_act + 5                        # padding rows exist
    assert max_active < nz * ny
    occ = pencil_occupancy(dom, tb.counts, max_active)
    jocc = j_pencil_occupancy(jdom, jb.counts, max_active)

    got = xpencil_sparse_forces(tb.planes, tb.slot_id, occ.active, nx=nx,
                                ny=ny, m_c=m_c, kernel=kern, cutoff2=1.0)
    jpal = j_pallas_sparse(jb.planes, jb.slot_id, jocc.active, nx=nx, ny=ny,
                           m_c=m_c, kernel=jk, cutoff2=1.0, interpret=True)
    dense = S.xpencil_planes(tb.planes["x"], tb.planes["y"], tb.planes["z"],
                             tb.slot_id, nx=nx, m_c=m_c, kernel=kern,
                             cutoff2=1.0)
    fsize, usize = (S.xpencil_sparse_planes(
        tb.planes["x"], tb.planes["y"], tb.planes["z"], tb.slot_id,
        occ.active, nx=nx, ny=ny, m_c=m_c, kernel=k, cutoff2=1.0)[3]
        for k in _term_sizes(kern))
    rows = occ.active.long()
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        assert got[i].shape == (max_active, nx * m_c)
        size = usize if what == "pot" else fsize
        _close(got[i].numpy(), np.asarray(jpal[i]), size,
               f"{what} vs JAX Pallas")
        # every row, padding rows included, is its pencil's dense row
        np.testing.assert_array_equal(
            got[i].numpy(), dense[i].reshape(nz * ny, -1)[rows].numpy())

    # scattered back: JAX's reference strategy, and 0 off the active list
    sparse = xpencil_sparse_ref(dom, tb, kern, occ)     # (nz, ny, nx*m_c)
    jsparse = _J_SPARSE(jdom, jb, jk, jocc)
    fsize_d, usize_d = (S.xpencil_planes(
        tb.planes["x"], tb.planes["y"], tb.planes["z"], tb.slot_id, nx=nx,
        m_c=m_c, kernel=k, cutoff2=1.0)[3] for k in _term_sizes(kern))
    active = (tb.counts.reshape(nz, ny, nx).sum(-1) > 0)
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        size = usize_d if what == "pot" else fsize_d
        _close(sparse[i].numpy(), np.asarray(jsparse[i]).reshape(nz, ny, -1),
               size, f"{what} vs JAX xpencil_sparse")
        assert not sparse[i][~active].any()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_compact_plan_matches_jax_and_oracles(periodic):
    jdom, pos = blob(6, 200, seed=3, periodic=periodic)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    state = state_from_numpy(pos, device="cpu")
    p = plan(dom, kern, positions=state.positions, device="cpu", compact=True,
             strategy="xpencil")
    f, u = p.execute(state)
    jp = j_plan(jdom, jk, positions=jnp.asarray(pos), strategy="xpencil",
                backend="pallas", compact=True, interpret=True)
    assert (p.m_c, p.max_active) == (jp.m_c, jp.max_active)
    jf, ju = jp.execute(JState(jnp.asarray(pos)))
    *nf, nu = S.naive_n2(dom, state.positions, kern)
    jn = _J_NAIVE(jdom, jnp.asarray(pos), jk)
    fsize, usize = (S.naive_n2(dom, state.positions, k)[3]
                    for k in _term_sizes(kern))
    for what, want_f, want_u in (
            ("JAX pallas plan", jf, ju),
            ("port naive_n2", torch.stack(nf, -1), nu),
            ("JAX naive_n2", np.stack(jn[:3], -1), jn[3])):
        _close(f.numpy(), want_f, fsize[:, None], f"forces vs {what}")
        _close(u.numpy(), want_u, usize, f"potential vs {what}")


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_compact_equals_dense_bitwise(backend, periodic):
    jdom, pos = blob(6, 200, seed=4, periodic=periodic)
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    dense = plan(dom, positions=state.positions, device="cpu",
                 backend=backend, strategy="xpencil").execute(state)
    comp = plan(dom, positions=state.positions, device="cpu",
                backend=backend, compact=True,
                strategy="xpencil").execute(state)
    for a, b in zip(comp, dense):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the max_active replan contract
# ---------------------------------------------------------------------------

def _scene(seed=5):
    jdom, pos = blob(6, 200, seed=seed)
    return domain_from_jax(jdom), state_from_numpy(pos, device="cpu")


def test_max_active_exactly_full_does_not_overflow():
    dom, state = _scene()
    n_act = active_unit_count(dom, state.positions)
    p = plan(dom, positions=state.positions, device="cpu", compact=True,
             max_active=n_act, strategy="xpencil")
    assert not p.check_overflow(state)
    assert not bool(pencil_occupancy(dom, p.bin(state).counts,
                                     n_act).overflowed)
    dense = plan(dom, positions=state.positions, device="cpu",
                 strategy="xpencil").execute(state)
    for a, b in zip(p.execute(state), dense):
        assert torch.equal(a, b)
    tight = plan(dom, positions=state.positions, device="cpu", compact=True,
                 max_active=n_act - 1, strategy="xpencil")
    assert tight.overflow_class(state) == "max_active"
    assert tight.replan(state).max_active >= n_act


def test_max_active_overflow_detected_and_replanned():
    dom, state = _scene()
    f_d, u_d = plan(dom, positions=state.positions,
                    device="cpu", strategy="xpencil").execute(state)
    p0 = plan(dom, positions=state.positions, device="cpu", compact=True,
              max_active=2, strategy="xpencil")
    assert p0.check_overflow(state)
    (f1, u1), p1 = p0.execute_or_replan(state)
    assert p1.max_active > p0.max_active
    assert (p1.m_c, p1.row_cap, p1.layout) == (p0.m_c, p0.row_cap,
                                               p0.layout)   # only it grew
    assert not p1.check_overflow(state)
    fresh = plan(dom, m_c=p1.m_c, device="cpu", compact=True,
                 max_active=p1.max_active, strategy="xpencil").execute(state)
    for a, b, c in zip((f1, u1), fresh, (f_d, u_d)):
        assert torch.equal(a, b) and torch.equal(a, c)
    # an overflowed bound really does drop pencils: forces are wrong
    f_bad, _ = p0.execute(state)
    assert not torch.equal(f_bad, f_d)


def test_compact_plan_validation():
    dom, state = _scene()
    with pytest.raises(ValueError, match="max_active|positions"):
        plan(dom, m_c=16, device="cpu", compact=True, strategy="xpencil")
    with pytest.raises(ValueError, match="compact=True is not defined"):
        plan(dom, m_c=16, device="cpu", strategy="naive_n2", compact=True)
    with pytest.raises(ValueError, match="positive static max_active"):
        plan(dom, m_c=16, device="cpu", compact=True, max_active=0,
             strategy="xpencil")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_scenarios_inside_the_box_and_clustered(name):
    dom = Domain.cubic(6)
    gen = torch.Generator().manual_seed(0)
    pos = scenarios.sample(name, dom, 500, generator=gen, device="cpu")
    assert pos.shape == (500, 3) and pos.dtype == torch.float32
    assert bool((pos > 0).all()) and bool((pos < 6).all())
    again = scenarios.sample(name, dom, 500, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(pos, again)
    fill = active_unit_count(dom, pos) / n_units(dom)
    assert (fill > 0.9) if name == "uniform" else (fill < 0.9)
