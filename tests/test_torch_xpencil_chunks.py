"""Kernels B and C's contract and geometry, on the CPU.

Kernels B and C compact each staged neighbour row to its real sources, so
they must honour planes with ``slot_id == -1`` anywhere in a cell, not only
after a cell's last particle. Here holes are punched into non-trailing
slots of a binned scene, and the port's plain ``xpencil_planes`` and
``xpencil_sparse_planes`` (what the wrappers run on a CPU tensor) are held
against JAX's Pallas ``xpencil_forces`` and ``xpencil_sparse_forces`` in
interpret mode on the same planes: scale-relative 3e-4, and each element
within 3e-4 of its own pair-term sizes. The chunk geometry (shared memory
per block, chunk width, the largest ``m_c``) is checked against the CUDA
source's constants.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.kernels.xpencil import xpencil_forces as j_pallas_xpencil
from repro.kernels.xpencil import xpencil_sparse_forces as j_pallas_sparse
from repro_torch.convert import domain_from_jax, kernel_from_jax
from repro_torch.core import bin_particles, pencil_occupancy
from repro_torch.core import strategies as S
from repro_torch.kernels import xpencil as XP
from repro_torch.kernels._common import MAX_SMEM
from test_torch_xpencil import J_KERNELS, _close, _term_sizes

DIVISION, N, M_C = 3, 150, 16
CSRC = (pathlib.Path(XP.__file__).resolve().parent / "csrc"
        / "xpencil.cu").read_text()


def punch_holes(slot_id: np.ndarray, m_c: int, rng, frac: float = 0.35):
    """-1 in about ``frac`` of the occupied slots that have an occupied
    slot after them in their cell -> (planes' slot_id, holes punched)."""
    s = slot_id.reshape(-1, m_c).copy()
    occ = s >= 0
    later = np.flip(np.cumsum(np.flip(occ, -1), -1), -1) - occ
    pick = occ & (later > 0) & (rng.random(s.shape) < frac)
    s[pick] = -1
    return s.reshape(slot_id.shape), int(pick.sum())


def _scale_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    assert err <= 3e-4, f"{what}: scale-relative error {err:.3e}"


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", ["lennard_jones", "low_flop"])
def test_plain_with_holes_matches_jax(name, periodic):
    jdom = JDomain.cubic(DIVISION, cutoff=1.0, periodic=periodic)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    nx, ny, nz = dom.ncells
    rng = np.random.default_rng(7)
    pos = (rng.uniform(0, 1, (N, 3)) * DIVISION).astype(np.float32)
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=M_C)
    holed, n_holes = punch_holes(tb.slot_id.numpy(), M_C, rng)
    assert n_holes > 20
    sid = torch.from_numpy(holed)
    xyz = [tb.planes[c] for c in "xyz"]
    jplanes = {c: jnp.asarray(tb.planes[c].numpy()) for c in "xyz"}
    jsid = jnp.asarray(holed)

    # kernel B's plain version (the wrapper on a CPU tensor) vs JAX's
    got = XP.xpencil_forces(tb.planes, sid, nx=nx, m_c=M_C, kernel=kern,
                            cutoff2=1.0)
    jpal = j_pallas_xpencil(jplanes, jsid, nx=nx, m_c=M_C, kernel=jk,
                            cutoff2=1.0, interpret=True)
    fsize, usize = (S.xpencil_planes(*xyz, sid, nx=nx, m_c=M_C, kernel=k,
                                     cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        _scale_close(got[i].numpy(), jpal[i], f"{what} dense vs JAX")
        _close(got[i].numpy(), jpal[i], usize if what == "pot" else fsize,
               f"{what} dense vs JAX")
        assert np.all(got[i].numpy()[holed[1:-1, 1:-1, M_C:-M_C] < 0] == 0)

    # kernel C's plain version over an active list with padding rows
    occ = pencil_occupancy(dom, tb.counts, nz * ny - 2)
    got = XP.xpencil_sparse_forces(tb.planes, sid, occ.active, nx=nx, ny=ny,
                                   m_c=M_C, kernel=kern, cutoff2=1.0)
    jpal = j_pallas_sparse(jplanes, jsid, jnp.asarray(occ.active.numpy()),
                           nx=nx, ny=ny, m_c=M_C, kernel=jk, cutoff2=1.0,
                           interpret=True)
    rows = occ.active.long()
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        size = (usize if what == "pot" else fsize).reshape(nz * ny, -1)[rows]
        _scale_close(got[i].numpy(), jpal[i], f"{what} sparse vs JAX")
        _close(got[i].numpy(), jpal[i], size, f"{what} sparse vs JAX")


def test_pencil_smem_counts_the_layout():
    # mbarriers, compacted sources, two staging buffers, offsets, targets,
    # warp counts
    cx, m_c = 32, 24
    want = (16 + 16 * (cx + 2) * m_c + 2 * 16 * (cx + 2) * m_c
            + 4 * (cx + 3) + 4 * cx * m_c + 4 * XP.PENCIL_WARPS)
    assert XP.pencil_smem_bytes(cx, m_c) == want == 42412
    assert XP.pencil_smem_bytes(1, XP.MAX_M_C) <= MAX_SMEM
    assert XP.pencil_smem_bytes(1, XP.MAX_M_C + 1) > MAX_SMEM
    assert XP.MAX_M_C == 1570 > 1024


@pytest.mark.parametrize("nx,m_c,want", [
    (64, 24, 32), (32, 40, 16), (32, 48, 16), (64, 72, 11), (64, 32, 22),
    (16, 24, 16), (1, 5, 1), (7, 1100, 1), (100, 4, 50), (65, 8, 33)])
def test_chunk_cells(nx, m_c, want):
    cx = XP.chunk_cells(nx, m_c)
    assert cx == want
    n_chunks = -(-nx // cx)
    assert (n_chunks - 1) * cx < nx <= n_chunks * cx   # no empty chunk
    assert cx == 1 or XP.pencil_smem_bytes(cx, m_c) <= XP.CHUNK_SMEM
    assert XP.pencil_smem_bytes(cx, m_c) <= MAX_SMEM


def test_python_mirror_matches_cuda_constants():
    def const(name):
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", CSRC)
        assert m, name
        return eval(m.group(1), {"kPencilThreads": 128})
    assert const("kPencilThreads") // 32 == XP.PENCIL_WARPS
    assert const("kMaxChunkCells") == XP.MAX_CHUNK_CELLS
    assert const("kChunkSmem") == XP.CHUNK_SMEM
    body = re.search(r"pencil_smem\(int cx, int m_c\) \{(.*?)\}", CSRC,
                     re.S).group(1)
    assert re.sub(r"\s+", " ", body).strip() == (
        "return 16 + (size_t)48 * (cx + 2) * m_c + (size_t)4 * ((size_t)cx "
        "* m_c + cx + 3 + kPencilWarps);")


def test_chunk_width_is_checked_and_does_not_change_the_plain_result():
    dom = domain_from_jax(JDomain.cubic(DIVISION, cutoff=1.0))
    pos = (np.random.default_rng(3).uniform(0, 1, (60, 3))
           * DIVISION).astype(np.float32)
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=8)
    kern = kernel_from_jax(J_KERNELS["low_flop"]())
    kw = dict(nx=DIVISION, m_c=8, kernel=kern, cutoff2=1.0)
    want = XP.xpencil_forces(tb.planes, tb.slot_id, **kw)
    for cx in (1, 2, DIVISION):
        got = XP.xpencil_forces(tb.planes, tb.slot_id, cx_cells=cx, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for cx in (0, DIVISION + 1):
        with pytest.raises(ValueError, match="chunk width"):
            XP.xpencil_forces(tb.planes, tb.slot_id, cx_cells=cx, **kw)


def test_m_c_limit_states_the_shared_memory():
    planes = {c: torch.zeros((3, 3, 3 * (XP.MAX_M_C + 1))) for c in "xyz"}
    sid = torch.full((3, 3, 3 * (XP.MAX_M_C + 1)), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(MAX_SMEM)):
        XP._dense_planes(planes["x"], planes["y"], planes["z"], sid, 1,
                         XP.MAX_M_C + 1, "xpencil_forces")
    ok = {c: p[..., :3 * XP.MAX_M_C].contiguous() for c, p in planes.items()}
    assert XP._dense_planes(ok["x"], ok["y"], ok["z"],
                            sid[..., :3 * XP.MAX_M_C].contiguous(), 1,
                            XP.MAX_M_C, "xpencil_forces") == (1, 1)
