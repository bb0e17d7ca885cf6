"""The port's packed-row (CSR) X-pencil path against the JAX package's.

Same inputs (numpy, from a seed) through both packages. ``pack_rows`` is
pure data movement and bit-equal to JAX's, ghost rows, 1-cell-thick
periodic axes and dropped particles included. Kernel D's plain version is
held against JAX's Pallas kernel in interpret mode and JAX's reference
strategy, and ``plan(..., layout="packed")`` (with and without
``compact``) against JAX's plan and both O(N^2) oracles, within the
term-relative tolerance of ``test_torch_xpencil.py``. Within the port the
dense, compacted, packed and packed+compacted paths give the same bits
(the reference's "dense = compact = packed" invariant), and ``row_cap``
keeps the replan contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import strategies as JS
from repro.core.api import suggest_row_cap as j_suggest_row_cap
from repro.core.binning import (cell_counts as j_cell_counts,
                                full_pencil_occupancy as j_full_occupancy,
                                pack_rows as j_pack_rows,
                                padded_row_counts as j_padded_row_counts,
                                pencil_occupancy as j_pencil_occupancy)
from repro.kernels.xpencil import xpencil_packed_forces as j_pallas_packed
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 packed_to_numpy, state_from_numpy)
from repro_torch.core import (Domain, ParticleState, active_unit_count,
                              bin_particles, cell_counts,
                              full_pencil_occupancy, pack_rows,
                              padded_row_counts, pencil_occupancy, plan,
                              suggest_m_c, suggest_row_cap, unpack_scatter)
from repro_torch.core import strategies as S
from repro_torch.kernels.ref import xpencil_packed_ref
from repro_torch.kernels.xpencil import xpencil_packed_forces
from test_torch_sparse import blob
from test_torch_xpencil import J_KERNELS, _close, _term_sizes

torch.set_num_threads(1)

_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_PACK = jax.jit(j_pack_rows, static_argnames=("domain", "row_cap"))
_J_PACKED = jax.jit(JS.xpencil_packed, static_argnames=("domain", "kernel"))
_J_NAIVE = jax.jit(JS.naive_n2, static_argnames=("domain", "kernel"))

# (name, JAX domain, positions): open and periodic blobs, a periodic X axis
# one cell thick (its cell appears three times per row), and 5 x 1 x 1 fully
# periodic
def _thin(ncells, periodic, n, seed):
    jdom = JDomain(box=tuple(float(c) for c in ncells), ncells=ncells,
                   cutoff=1.0, periodic=periodic)
    pos = (np.random.default_rng(seed).uniform(0, 1, (n, 3))
           * np.asarray(ncells)).astype(np.float32)
    return jdom, pos


SCENES = {
    "open": lambda: blob(6, 200, seed=6),
    "periodic": lambda: blob(6, 200, seed=7, periodic=True),
    "thin_x_periodic": lambda: _thin((1, 5, 5), (True, True, False), 120, 8),
    "5x1x1_periodic": lambda: _thin((5, 1, 1), True, 80, 9),
}


def _packs(jdom, pos, m_c, row_cap):
    dom = domain_from_jax(jdom)
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=m_c)
    jb = _J_BIN(jdom, jnp.asarray(pos), m_c=m_c)
    return (dom, tb, jb, pack_rows(dom, tb, row_cap),
            _J_PACK(jdom, jb, row_cap))


# ---------------------------------------------------------------------------
# the packed layout, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bounds", ["measured", "m_c_overflow",
                                    "row_cap_overflow"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_packed_rows_bit_equal_to_jax(scene, bounds):
    jdom, pos = SCENES[scene]()
    dom = domain_from_jax(jdom)
    m_c = suggest_m_c(dom, torch.from_numpy(pos))
    row_cap = suggest_row_cap(dom, torch.from_numpy(pos))
    if bounds == "m_c_overflow":           # dropped particles clamp
        m_c = 2
    if bounds == "row_cap_overflow":       # rows drop their tails
        row_cap = 8
    _, _, _, tp, jp = _packs(jdom, pos, m_c, row_cap)
    got = packed_to_numpy(tp)
    want = {k: np.asarray(v) for k, v in jp.planes.items()}
    for name in ("slot_id", "slot_cell", "cell_offsets", "row_counts",
                 "counts", "particle_slot"):
        want[name] = np.asarray(getattr(jp, name))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if got[k].dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(got[k]),
                                          np.signbit(want[k]), err_msg=k)
    assert bool(tp.overflowed) == bool(jp.overflowed)
    assert bool(tp.overflowed) == (bounds == "row_cap_overflow")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_row_bounds_match_jax(scene):
    jdom, pos = SCENES[scene]()
    dom = domain_from_jax(jdom)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    np.testing.assert_array_equal(
        padded_row_counts(dom, cell_counts(dom, tpos)).numpy(),
        np.asarray(j_padded_row_counts(jdom, j_cell_counts(jdom, jpos))))
    for slack in (1.0, 1.25, 3.0):
        assert suggest_row_cap(dom, tpos, slack=slack) == \
            j_suggest_row_cap(jdom, jpos, slack=slack)


def test_thin_periodic_x_counts_its_cell_three_times():
    dom = Domain(box=(1.0, 3.0, 3.0), ncells=(1, 3, 3), cutoff=1.0,
                 periodic=(True, False, False))
    pos = torch.full((5, 3), 0.5)
    assert int(padded_row_counts(dom, cell_counts(dom, pos)).max()) == 15


def test_unpack_scatter_round_trips_a_field():
    jdom, pos = SCENES["periodic"]()
    dom = domain_from_jax(jdom)
    tpos = torch.from_numpy(pos)
    mass = torch.arange(pos.shape[0], dtype=torch.float32)
    bins = bin_particles(dom, tpos, {"mass": mass}, m_c=suggest_m_c(dom, tpos))
    pk = pack_rows(dom, bins, suggest_row_cap(dom, tpos))
    back = unpack_scatter(dom, pk, pk.planes["mass"][1:dom.nz + 1,
                                                     1:dom.ny + 1, :])
    assert torch.equal(back, mass)


# ---------------------------------------------------------------------------
# kernel D's plain version against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", sorted(J_KERNELS))
def test_packed_kernel_plain_matches_jax(name, periodic):
    jdom, pos = blob(4, 120, seed=0, periodic=periodic)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    nx, ny, nz = dom.ncells
    tpos = torch.from_numpy(pos)
    m_c, row_cap = suggest_m_c(dom, tpos), suggest_row_cap(dom, tpos)
    _, tb, jb, tp, jp = _packs(jdom, pos, m_c, row_cap)
    # every row, then an active list with padding rows
    max_active = active_unit_count(dom, tpos) + 3
    lists = [(full_pencil_occupancy(dom, "cpu"), j_full_occupancy(jdom)),
             (pencil_occupancy(dom, tb.counts, max_active),
              j_pencil_occupancy(jdom, jb.counts, max_active))]
    active = torch.cat([o.active for o, _ in lists])
    jactive = jnp.concatenate([o.active for _, o in lists])
    args = (tp.planes, tp.slot_id, tp.slot_cell, tp.cell_offsets, active)
    got = xpencil_packed_forces(*args, nx=nx, ny=ny, m_c=m_c, kernel=kern,
                                cutoff2=1.0)
    jpal = j_pallas_packed(jp.planes, jp.slot_id, jp.slot_cell,
                           jp.cell_offsets, jactive, nx=nx, ny=ny, m_c=m_c,
                           row_cap=row_cap, kernel=jk, cutoff2=1.0,
                           interpret=True)
    fsize, usize = (xpencil_packed_forces(*args, nx=nx, ny=ny, m_c=m_c,
                                          kernel=k, cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    # no list (None) means every row in pencil-id order
    every = xpencil_packed_forces(*args[:4], None, nx=nx, ny=ny, m_c=m_c,
                                  kernel=kern, cutoff2=1.0)
    for e, g in zip(every, got):
        assert torch.equal(e, g[:nz * ny])
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        assert got[i].shape == (active.shape[0], row_cap)
        size = usize if what == "pot" else fsize
        _close(got[i].numpy(), np.asarray(jpal[i]), size,
               f"{what} vs JAX Pallas")
        assert not got[i][(tp.slot_id[1:nz + 1, 1:ny + 1]
                           .reshape(nz * ny, -1)[active.long()] < 0)].any()

    # the reference strategy over the active list, scattered back; the
    # every-row part of the term sizes is in pencil order
    occ, jocc = lists[1]
    ref = xpencil_packed_ref(dom, tp, kern, occ)
    jref = _J_PACKED(jdom, jp, jk, jocc)
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        size = (usize if what == "pot" else fsize)[:nz * ny]
        _close(ref[i].numpy(), np.asarray(jref[i]), size,
               f"{what} vs JAX xpencil_packed")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("compact", [False, True], ids=["rows", "compact"])
def test_packed_plan_matches_jax_and_oracles(compact, periodic):
    jdom, pos = blob(6, 200, seed=3, periodic=periodic)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    state = state_from_numpy(pos, device="cpu")
    p = plan(dom, kern, positions=state.positions, device="cpu",
             layout="packed", compact=compact, strategy="xpencil")
    f, u = p.execute(state)
    jp = j_plan(jdom, jk, positions=jnp.asarray(pos), strategy="xpencil",
                backend="pallas", layout="packed", compact=compact,
                interpret=True)
    assert (p.m_c, p.row_cap, p.max_active) == (jp.m_c, jp.row_cap,
                                                jp.max_active)
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


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_dense_compact_packed_bitwise_equal(backend, scene):
    jdom, pos = SCENES[scene]()
    dom = domain_from_jax(jdom)
    state = state_from_numpy(pos, device="cpu")
    runs = {(compact, layout): plan(
        dom, positions=state.positions, device="cpu", backend=backend,
        compact=compact, layout=layout, strategy="xpencil").execute(state)
        for compact in (False, True) for layout in ("dense", "packed")}
    f_d, u_d = runs[(False, "dense")]
    for key, (f, u) in runs.items():
        assert torch.equal(f, f_d) and torch.equal(u, u_d), key


# ---------------------------------------------------------------------------
# the row_cap replan contract
# ---------------------------------------------------------------------------

def _scene():
    jdom, pos = blob(6, 200, seed=5)
    return domain_from_jax(jdom), state_from_numpy(pos, device="cpu")


def test_row_cap_exactly_full_does_not_overflow():
    dom, state = _scene()
    exact = int(padded_row_counts(dom, cell_counts(dom, state.positions))
                .max())
    p = plan(dom, positions=state.positions, device="cpu", layout="packed",
             row_cap=exact, strategy="xpencil")
    pk = p.pack(p.bin(state))
    assert int(pk.row_counts.max()) == exact and not bool(pk.overflowed)
    assert not p.check_overflow(state)
    dense = plan(dom, positions=state.positions, device="cpu",
                 strategy="xpencil").execute(state)
    for a, b in zip(p.execute(state), dense):
        assert torch.equal(a, b)
    tight = plan(dom, positions=state.positions, device="cpu",
                 layout="packed", row_cap=exact - 1, strategy="xpencil")
    assert tight.overflow_class(state) == "row_cap"
    assert tight.replan(state).row_cap >= exact


def test_row_cap_overflow_detected_and_replanned():
    dom, state = _scene()
    f_d, u_d = plan(dom, positions=state.positions,
                    device="cpu", strategy="xpencil").execute(state)
    p0 = plan(dom, positions=state.positions, device="cpu", layout="packed",
              row_cap=8, strategy="xpencil")
    assert p0.check_overflow(state)
    (f1, u1), p1 = p0.execute_or_replan(state)
    assert p1.row_cap > p0.row_cap
    assert (p1.m_c, p1.max_active) == (p0.m_c, p0.max_active)
    assert not p1.check_overflow(state)
    fresh = plan(dom, m_c=p1.m_c, device="cpu", layout="packed",
                 row_cap=p1.row_cap, strategy="xpencil").execute(state)
    for a, b, c in zip((f1, u1), fresh, (f_d, u_d)):
        assert torch.equal(a, b) and torch.equal(a, c)
    f_bad, _ = p0.execute(state)
    assert not torch.equal(f_bad, f_d)


def test_each_bound_grows_alone():
    """m_c, max_active and row_cap of one packed+compacted plan: only the
    bound that overflowed grows."""
    dom, state = _scene()
    good = plan(dom, positions=state.positions, device="cpu",
                layout="packed", compact=True, strategy="xpencil")
    assert good.overflow_class(state) is None
    assert good.replan(state) == good
    for bound, small in (("m_c", 8), ("max_active", 2), ("row_cap", 8)):
        p0 = plan(dom, positions=state.positions, device="cpu",
                  layout="packed", compact=True, strategy="xpencil",
                  **{bound: small})
        assert p0.overflow_class(state) == bound
        (f, u), p1 = p0.execute_or_replan(state)
        grown = {b: getattr(p1, b) != getattr(good, b)
                 for b in ("m_c", "max_active", "row_cap")}
        assert getattr(p1, bound) > small
        assert not any(v for b, v in grown.items() if b != bound), grown
        fresh = dict(m_c=p1.m_c, max_active=p1.max_active,
                     row_cap=p1.row_cap)
        want = plan(dom, device="cpu", layout="packed", compact=True,
                    strategy="xpencil", **fresh).execute(state)
        assert torch.equal(f, want[0]) and torch.equal(u, want[1])


def test_packed_plan_validation():
    dom, state = _scene()
    with pytest.raises(ValueError, match="row_cap|positions"):
        plan(dom, m_c=16, device="cpu", layout="packed", strategy="xpencil")
    with pytest.raises(ValueError, match="not defined for 'naive_n2'"):
        plan(dom, m_c=16, device="cpu", strategy="naive_n2",
             layout="packed", row_cap=8)
    with pytest.raises(ValueError, match="unknown layout"):
        plan(dom, m_c=16, device="cpu", layout="csr", strategy="xpencil")
    p = plan(dom, m_c=16, device="cpu", layout="packed", row_cap=8,
             strategy="xpencil")
    with pytest.raises(ValueError, match="move the state"):
        p.execute(ParticleState(state.positions.to("meta")))
