"""Kernels E and F's contract and geometry, on the CPU.

Kernels E (All-in-SM) and F (SFC clusters) stage each cell compacted to its
real particles, so they must honour planes with ``slot_id == -1`` anywhere
in a cell, not only after a cell's last particle. Here holes are punched
into non-trailing slots of a binned scene, and the port's plain
``allin_planes`` and ``cell_sfc_tiles`` (what the wrappers run on a CPU
tensor) are held against the JAX package on the same planes: E against
JAX's reference ``allin`` (its Pallas kernel cannot run on the installed
JAX), F against JAX's Pallas SFC kernel in interpret mode, each element
within 3e-4 of its own pair-term sizes. E's plain version stays bit-equal
to B's, and F's to itself across clusterings. The shared-memory formulas
that the wrappers mirror are checked against the CUDA sources.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bin_particles as j_bin
from repro.core import binning as JB
from repro.core import strategies as JS
from repro.kernels.ops import cell_sfc_interactions as j_pallas_sfc
from repro_torch.convert import domain_from_jax, kernel_from_jax
from repro_torch.core import (bin_particles, build_sfc_clusters,
                              make_low_flop, sfc_to_particles)
from repro_torch.core import binning as B
from repro_torch.core import strategies as S
from repro_torch.kernels import allin as AL
from repro_torch.kernels import sfc as SF
from repro_torch.kernels._common import MAX_SMEM
from test_torch_sparse import blob
from test_torch_xpencil import J_KERNELS, _close, _term_sizes
from test_torch_xpencil_chunks import punch_holes

torch.set_num_threads(1)

CSRC = pathlib.Path(AL.__file__).resolve().parent / "csrc"
_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_ALLIN = jax.jit(JS.allin, static_argnames=("domain", "kernel", "box"))
_J_BUILD = jax.jit(JB.build_sfc_clusters,
                   static_argnames=("domain", "pair_cap", "csize", "curve"))


def _holed(jdom, pos, m_c, seed):
    """Both packages' bins of ``pos`` with the same holes punched into
    non-trailing slots -> (port bins, JAX bins, holes punched)."""
    tb = bin_particles(domain_from_jax(jdom), torch.from_numpy(pos), m_c=m_c)
    jb = _J_BIN(jdom, jnp.asarray(pos), m_c=m_c)
    holed, n = punch_holes(tb.slot_id.numpy(), m_c,
                           np.random.default_rng(seed))
    return (dataclasses.replace(tb, slot_id=torch.from_numpy(holed)),
            dataclasses.replace(jb, slot_id=jnp.asarray(holed)), n)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", ["lennard_jones", "low_flop", "gravity"])
def test_allin_plain_with_holes_matches_jax(name, periodic):
    jdom, pos = blob(4, 150, seed=5, periodic=periodic, sigma_frac=0.25)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    nx, ny, nz = dom.ncells
    m_c, box = 16, (2, 2, 1)
    tb, jb, n_holes = _holed(jdom, pos, m_c, seed=9)
    assert n_holes > 20
    xyz = [tb.planes[c] for c in "xyz"]
    got = AL.allin_forces(tb.planes, tb.slot_id, box=box, m_c=m_c,
                          kernel=kern, cutoff2=1.0)
    jref = [np.asarray(o).reshape(nz, ny, nx * m_c)
            for o in _J_ALLIN(jdom, jb, jk, box=box)]
    fsize, usize = (S.allin_planes(*xyz, tb.slot_id, box=box, m_c=m_c,
                                   kernel=k, cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    real = tb.slot_id[1:-1, 1:-1, m_c:-m_c] >= 0
    b = S.xpencil_planes(*xyz, tb.slot_id, nx=nx, m_c=m_c, kernel=kern,
                         cutoff2=1.0)
    for i, what in enumerate(("fx", "fy", "fz", "pot")):
        _close(got[i].numpy(), jref[i], usize if what == "pot" else fsize,
               f"{what} allin with holes vs JAX")
        assert not bool(got[i][~real].any()), f"{what}: empty slot not 0"
        assert torch.equal(got[i], b[i]), f"{what}: E's plain != B's"


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("csize,curve", [(4, "morton"), (8, "hilbert")])
def test_sfc_plain_with_holes_matches_jax_pallas(csize, curve, periodic):
    jdom, pos = blob(4, 150, seed=6, periodic=periodic, sigma_frac=0.25)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    m_c = 16
    tb, jb, n_holes = _holed(jdom, pos, m_c, seed=10)
    assert n_holes > 20
    cap = B.sfc_n_clusters(dom, csize) * 27
    got = build_sfc_clusters(dom, tb, cap, csize, curve)
    want = _J_BUILD(jdom, jb, pair_cap=cap, csize=csize, curve=curve)
    tgt, src = B.sfc_device_slot_tables(dom, m_c, csize, curve,
                                        torch.device("cpu"))
    tiles = SF.cell_sfc_forces(tb.planes, tb.slot_id, got.codes, tgt, src,
                               m_c=m_c, kernel=kern, cutoff2=1.0)
    f, u = sfc_to_particles(dom, got, *tiles)
    jf, ju = j_pallas_sfc(jdom, want, jk, interpret=True)
    sizes = [sfc_to_particles(dom, got, *SF.cell_sfc_forces(
        tb.planes, tb.slot_id, got.codes, tgt, src, m_c=m_c, kernel=k,
        cutoff2=1.0))[1] for k in _term_sizes(kern)]
    _close(f.numpy(), jf, sizes[0][:, None].numpy(), "forces with holes")
    _close(u.numpy(), ju, sizes[1].numpy(), "potential with holes")
    real = tb.slot_id.reshape(-1)[tb.particle_slot.long()] >= 0
    assert not bool(f[~real].any()) and not bool(u[~real].any())
    # per particle the same bits as Par-Cell over the dense cells
    ref = S.cell_dense(dom, tb, kern)
    f_d, u_d = B.dense_to_particles(dom, tb, *ref)
    assert torch.equal(f, f_d) and torch.equal(u, u_d)


def _source_const(text, name):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", text)
    assert m, name
    return int(m.group(1))


def _source_body(text, signature):
    body = re.search(re.escape(signature) + r" \{(.*?)\n\}", text, re.S)
    assert body, signature
    return re.sub(r"\s+", " ", body.group(1)).strip()


def test_sfc_python_mirror_matches_cuda_source():
    text = (CSRC / "sfc.cu").read_text()
    assert _source_const(text, "kSfcStageBytes") == SF.SFC_STAGE_BYTES
    assert _source_body(text, "constexpr int sfc_group(int tile)") == (
        "return 64 * tile <= kSfcStageBytes ? 4 : 32 * tile <= "
        "kSfcStageBytes ? 2 : 1;")
    assert _source_body(text, "constexpr size_t sfc_warp_smem(int csize, "
                        "int m_c)") == (
        "return ((size_t)16 * sfc_group(csize * m_c) * csize * m_c + "
        "(size_t)4 * csize * m_c + (size_t)128 * csize + 128 + 15) / 16 * "
        "16;")
    # the kernel's shared-memory regions: slabs, targets, bases, k slots
    assert "(size_t)gmax * tile" in text and "32 * csize" in text


@pytest.mark.parametrize("csize,m_c,group,warp", [
    (4, 24, 4, 7168), (4, 40, 2, 6400), (4, 72, 1, 6400), (8, 24, 2, 8064),
    (1, 24, 4, 1888), (8, 129, 1, 21792), (8, 1100, 1, 177152)])
def test_sfc_warp_smem_counts_the_layout(csize, m_c, group, warp):
    tile = csize * m_c
    assert SF.sfc_group(tile) == group
    want = 16 * group * tile + 4 * tile + 128 * csize + 128
    assert SF.sfc_warp_smem_bytes(csize, m_c) == -(-want // 16) * 16 == warp
    assert warp <= MAX_SMEM            # csize * m_c past 1024 runs too


def test_sfc_tile_limit_is_shared_memory():
    big = next(m for m in range(11000, 12000)
               if SF.sfc_warp_smem_bytes(1, m) > MAX_SMEM)
    assert SF.sfc_warp_smem_bytes(1, big - 1) <= MAX_SMEM
    assert 11000 < big < 12000          # not the old 1024 threads


def test_allin_halo_bytes_match_cuda_source():
    text = (CSRC / "allin.cu").read_text()
    assert ("16 * (bz + 2) * (by + 2) * (bx + 2) * (size_t)m_c"
            in re.sub(r"\s+", " ", text))
    assert "extern __shared__ float4 halo[]" in text
    assert AL.halo_bytes((4, 4, 4), 24) == 82944
    assert AL.halo_bytes((1, 1, 1), 538) <= MAX_SMEM
    assert AL.halo_bytes((1, 1, 1), 539) > MAX_SMEM


def test_allin_threads_follow_the_blocks_an_sm_holds():
    text = (CSRC / "allin.cu").read_text()
    assert _source_const(text, "kAllinMaxThreads") == AL.MAX_THREADS
    assert "__launch_bounds__(kAllinMaxThreads)" in text
    # two halos fit an SM at m_c 24 (division 64), one at m_c 40
    # (division 32) and on the blob's box (4, 4, 2) at m_c 72
    assert AL.allin_threads((4, 4, 4), 24) == 512
    assert AL.allin_threads((4, 4, 4), 40) == 1024
    assert AL.allin_threads((4, 4, 2), 72) == 1024
    largest_pair = max(m for m in range(1, 100)
                       if AL.allin_threads((4, 4, 4), m) == 512)
    assert 2 * (AL.halo_bytes((4, 4, 4), largest_pair) + 1024) <= 233472
    assert 2 * (AL.halo_bytes((4, 4, 4), largest_pair + 1) + 1024) > 233472


@pytest.mark.parametrize("threads", [0, 48, 1056])
def test_allin_wrapper_rejects_a_thread_count(threads):
    planes = {c: torch.zeros((3, 3, 3 * 4)) for c in "xyz"}
    sid = torch.full((3, 3, 3 * 4), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 32"):
        AL.allin_forces(planes, sid, box=(1, 1, 1), m_c=4,
                        kernel=make_low_flop(), cutoff2=1.0, threads=threads)
