"""The port's binning is bit-equal to the JAX package's.

Binning is pure data movement, so every output (counts, offsets,
particle_slot, slot_id and the planes) must match bit for bit, including
where JAX semantics do not carry over by themselves: drop-mode scatters
(m_c overflow, valid padding), clamped gathers, floor-mod wrap of cell
coordinates, and the aliasing order of the periodic ghost fill on
1-cell-thick axes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core.interactions import make_low_flop as j_low_flop
from repro_torch.convert import (bins_to_numpy, domain_from_jax,
                                 kernel_from_jax, state_from_numpy)
from repro_torch.core import Domain, bin_particles, plan, suggest_m_c
from repro_torch.core.binning import EMPTY_POS, GHOST_ID_BUMP

torch.set_num_threads(1)


def _positions(box, n, seed, edge=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(box)
    if edge:
        # on the faces, just inside and just outside the box
        b = np.asarray(box, np.float32)
        pos[:6] = [[0, 0, 0], b, [b[0], 0, b[2] / 2], [-1e-6, 0.5, 0.5],
                   b + 1e-6, [b[0] / 2, -1e-6, b[2] + 1e-6]]
    return pos.astype(np.float32)


_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))


def _j_bins(jdom, pos, m_c, valid=None, fields=None):
    return _J_BIN(jdom, jnp.asarray(pos),
                 None if fields is None else
                 {k: jnp.asarray(v) for k, v in fields.items()},
                 m_c=m_c, valid=None if valid is None else jnp.asarray(valid))


def _assert_bins_equal(jb, tb):
    got = bins_to_numpy(tb)
    want = {k: np.asarray(v) for k, v in jb.planes.items()}
    want.update(slot_id=np.asarray(jb.slot_id), counts=np.asarray(jb.counts),
                offsets=np.asarray(jb.offsets),
                particle_slot=np.asarray(jb.particle_slot))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if got[k].dtype.kind == "f":    # bit-equal, signed zeros included
            np.testing.assert_array_equal(got[k].view(np.int32),
                                          want[k].view(np.int32), err_msg=k)


CASES = [
    # box, ncells, periodic, n, edge
    ((4.0, 4.0, 4.0), (4, 4, 4), False, 300, True),
    ((4.0, 4.0, 4.0), (4, 4, 4), True, 300, True),
    ((5.0, 1.0, 1.0), (5, 1, 1), True, 80, False),
    ((1.0, 5.0, 5.0), (1, 5, 5), True, 120, False),
    ((3.0, 2.0, 4.0), (3, 2, 4), (True, False, True), 150, True),
]


@pytest.mark.parametrize("box,ncells,periodic,n,edge", CASES)
def test_bins_bit_equal(box, ncells, periodic, n, edge):
    jdom = JDomain(box=box, ncells=ncells, cutoff=1.0, periodic=periodic)
    dom = domain_from_jax(jdom)
    pos = _positions(box, n, seed=n, edge=edge)
    mass = np.random.default_rng(1).uniform(1, 2, n).astype(np.float32)
    state = state_from_numpy(pos, {"mass": mass}, device="cpu")
    m_c = suggest_m_c(dom, state.positions)
    np.testing.assert_array_equal(
        dom.cell_coords(state.positions).numpy(),
        np.asarray(jdom.cell_coords(jnp.asarray(pos))))
    _assert_bins_equal(_j_bins(jdom, pos, m_c, fields={"mass": mass}),
                       bin_particles(dom, state.positions, state.fields,
                                     m_c=m_c))


@pytest.mark.parametrize("periodic", [False, True])
def test_valid_padding_bit_equal(periodic):
    jdom = JDomain.cubic(4, cutoff=1.0, periodic=periodic)
    dom = domain_from_jax(jdom)
    pos = _positions(jdom.box, 260, seed=3, edge=True)
    valid = np.ones(260, bool)
    valid[200:] = False
    pos[200:] = 0.0                      # padding rows all sit in cell 0
    valid[::17] = False                  # and some holes among real rows
    state = state_from_numpy(pos, valid=valid, device="cpu")
    _assert_bins_equal(_j_bins(jdom, pos, 16, valid=valid),
                       bin_particles(dom, state.positions, m_c=16,
                                     valid=state.valid))


@pytest.mark.parametrize("periodic", [False, True])
def test_overflow_drops_bit_equal_and_zero_force(periodic):
    """m_c too small: the particles past it are dropped by both packages and
    read back exactly 0 force and potential (JAX's gather clamps to the last
    ghost slot)."""
    jdom = JDomain.cubic(3, cutoff=1.0, periodic=periodic)
    dom = domain_from_jax(jdom)
    pos = _positions(jdom.box, 200, seed=5)
    m_c = 4
    state = state_from_numpy(pos, device="cpu")
    tb = bin_particles(dom, state.positions, m_c=m_c)
    _assert_bins_equal(_j_bins(jdom, pos, m_c), tb)
    total = tb.slot_id.numel()
    dropped = tb.particle_slot.numpy() == total
    assert dropped.sum() > 10

    jk = j_low_flop()
    jf, jp = j_plan(jdom, jk, m_c=m_c, strategy="xpencil").execute(
        JState(jnp.asarray(pos)))
    tf, tp = plan(dom, kernel_from_jax(jk), m_c=m_c,
                  device="cpu", strategy="xpencil").execute(state)
    for f, p in ((np.asarray(jf), np.asarray(jp)), (tf.numpy(), tp.numpy())):
        assert np.all(f[dropped] == 0.0) and np.all(p[dropped] == 0.0)
        assert np.any(f[~dropped] != 0.0)


def test_constants_and_ghost_ids():
    assert EMPTY_POS == 1.0e8 and GHOST_ID_BUMP == 1_000_000_000
    dom = Domain(box=(5.0, 1.0, 1.0), ncells=(5, 1, 1), cutoff=1.0,
                 periodic=True)
    pos = torch.from_numpy(_positions(dom.box, 20, seed=9))
    b = bin_particles(dom, pos, m_c=16)
    assert b.slot_id.dtype == torch.int32 and b.planes["x"].dtype == torch.float32
    ghost = b.slot_id[0]                 # a whole ghost z-plane
    real = ghost[ghost >= 0]
    assert real.numel() and bool((real >= GHOST_ID_BUMP).all())
    assert bool((real < 2 * GHOST_ID_BUMP).all())   # bumped once, not twice
