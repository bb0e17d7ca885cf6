"""The port's SFC cluster layout (``layout="sfc"``) against the JAX
package's.

Same inputs (numpy, from a seed) through both packages. The curve codecs,
the cluster and slot tables, the pair-list codec, the built pair list
(codes, ``n_pairs``, ``cluster_counts``), ``sfc_pair_count`` and
``suggest_pair_cap`` are host or integer data and bit-equal to JAX's.
Forces and potentials of ``plan(..., layout="sfc")`` are held against JAX's
reference sfc plan (and in one small case its Pallas kernel in interpret
mode) per element within 1e-4 of |reference| plus the sizes of the
element's own pair terms, and scale-relative 3e-4: the summation order
differs across frameworks. Within the port the sfc path gives the dense
``cell_dense`` bits, whatever the curve, cluster size, ``pair_cap`` or
chunking, and ``pair_cap`` keeps the replan contract.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain, ParticleState as JState
from repro.core import bin_particles as j_bin, plan as j_plan
from repro.core import binning as JB
from repro.core.api import suggest_pair_cap as j_suggest_pair_cap
from repro.kernels.ops import cell_sfc_interactions as j_pallas_sfc
from repro_torch.convert import (domain_from_jax, kernel_from_jax,
                                 sfc_to_numpy, state_from_numpy)
from repro_torch.core import (bin_particles, build_sfc_clusters,
                              cell_counts, decode_pair_codes,
                              encode_pair_masks, hilbert_decode,
                              hilbert_encode, morton_decode, morton_encode,
                              plan, sfc_cluster_tables, sfc_pair_count,
                              sfc_slot_tables, sfc_to_particles, suggest_m_c,
                              suggest_pair_cap)
from repro_torch.core import binning as B
from repro_torch.core import strategies as S
from repro_torch.kernels.ref import cell_sfc_ref
from repro_torch.kernels.sfc import cell_sfc_forces
from test_torch_sparse import blob
from test_torch_xpencil import J_KERNELS, _term_sizes

torch.set_num_threads(1)

_J_BIN = jax.jit(j_bin, static_argnames=("domain", "m_c"))
_J_BUILD = jax.jit(JB.build_sfc_clusters,
                   static_argnames=("domain", "pair_cap", "csize", "curve"))



def _grid(ncells, periodic, n, seed):
    """A box of unit cells with ``n`` uniform particles (numpy)."""
    jdom = JDomain(box=tuple(float(c) for c in ncells), ncells=ncells,
                   cutoff=1.0, periodic=periodic)
    pos = (np.random.default_rng(seed).uniform(0, 1, (n, 3))
           * np.asarray(ncells)).astype(np.float32)
    return jdom, pos


# the grids: open, periodic, 1-cell-thick periodic axes
# ((5,1,1) fully periodic and (1,5,5) periodic in x and y) and (3,4,5)
GRIDS = {
    "open": lambda: blob(4, 150, seed=11),
    "periodic": lambda: blob(4, 150, seed=12, periodic=True),
    "5x1x1_periodic": lambda: _grid((5, 1, 1), True, 60, 13),
    "1x5x5_periodic_xy": lambda: _grid((1, 5, 5), (True, True, False), 90,
                                       14),
    "3x4x5_open": lambda: _grid((3, 4, 5), False, 120, 15),
}


def _close(got, want, size, what, tol=1e-4):
    """|got - want| <= tol * (|want| + size) per element, and within a
    scale-relative 3e-4 (the repo's measure, tests/test_dist.py)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    size = np.asarray(size, np.float64)
    assert np.all(np.isfinite(got)), what
    bad = np.abs(got - want) > tol * (np.abs(want) + size)
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.size} "
                           f"elements off, e.g. {got[bad][:3]} vs "
                           f"{want[bad][:3]} (term sizes {size[bad][:3]})")
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) / scale <= 3e-4, what


def _equal(a, b, what=""):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), what)


# ---------------------------------------------------------------------------
# host tables and codecs, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 3, 6])
def test_curve_codecs_match_jax(bits):
    rng = np.random.default_rng(bits)
    ix, iy, iz = rng.integers(0, 1 << bits, (3, 64))
    for enc, jenc, dec, jdec in (
            (morton_encode, JB.morton_encode, morton_decode,
             JB.morton_decode),
            (hilbert_encode, JB.hilbert_encode, hilbert_decode,
             JB.hilbert_decode)):
        codes = enc(ix, iy, iz, bits)
        np.testing.assert_array_equal(codes, jenc(ix, iy, iz, bits))
        _equal(dec(codes, bits), jdec(codes, bits))
        _equal(dec(codes, bits), (ix, iy, iz))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("csize", [1, 3, 4, 8])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_cluster_and_slot_tables_match_jax(grid, csize, curve):
    jdom, _ = GRIDS[grid]()
    dom = domain_from_jax(jdom)
    got, want = (sfc_cluster_tables(dom, csize, curve),
                 JB.sfc_cluster_tables(jdom, csize, curve))
    for name in ("order", "cell_cluster", "cell_pos", "cluster_cells",
                 "tgt_pcell", "src_pcell"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert (got.n_clusters, got.n_pcells) == (want.n_clusters,
                                              want.n_pcells)
    assert B.sfc_n_clusters(dom, csize) == JB.sfc_n_clusters(jdom, csize)
    _equal(sfc_slot_tables(dom, 8, csize, curve),
           JB.sfc_slot_tables(jdom, 8, csize, curve))
    tgt, src = B.sfc_device_slot_tables(dom, 8, csize, curve,
                                        torch.device("cpu"))
    _equal((tgt.numpy(), src.numpy()), sfc_slot_tables(dom, 8, csize, curve))


def test_unknown_curve_and_bad_csize_raise():
    dom = domain_from_jax(JDomain.cubic(3))
    with pytest.raises(ValueError, match="unknown curve 'peano'"):
        sfc_cluster_tables(dom, 4, "peano")
    with pytest.raises(ValueError, match="csize must be >= 1"):
        sfc_cluster_tables(dom, 0)


@pytest.mark.parametrize("seed", range(4))
def test_pair_codec_matches_jax(seed):
    rng = np.random.default_rng(seed)
    masks = rng.random((1 + seed * 3, 27)) < 0.3
    kept = int(masks.sum())
    for cap in (max(kept - 3, 1), kept, kept + 5):
        codes = encode_pair_masks(masks, cap)
        np.testing.assert_array_equal(codes, JB.encode_pair_masks(masks, cap))
        np.testing.assert_array_equal(decode_pair_codes(codes, len(masks)),
                                      JB.decode_pair_codes(codes, len(masks)))
    np.testing.assert_array_equal(
        decode_pair_codes(encode_pair_masks(masks, kept), len(masks)), masks)


# ---------------------------------------------------------------------------
# the pair list built on the device, bit for bit
# ---------------------------------------------------------------------------

def _both_lists(jdom, pos, m_c, pair_cap, csize=4, curve="morton",
                valid=None):
    dom = domain_from_jax(jdom)
    vt = None if valid is None else torch.from_numpy(valid)
    tb = bin_particles(dom, torch.from_numpy(pos), m_c=m_c, valid=vt)
    jb = _J_BIN(jdom, jnp.asarray(pos), m_c=m_c,
               valid=None if valid is None else jnp.asarray(valid))
    got = build_sfc_clusters(dom, tb, pair_cap, csize, curve)
    want = _J_BUILD(jdom, jb, pair_cap=pair_cap, csize=csize, curve=curve)
    return dom, got, want


def _assert_lists_equal(got, want):
    g = sfc_to_numpy(got)
    for name in ("codes", "n_pairs", "cluster_counts"):
        w = np.asarray(getattr(want, name))
        assert g[name].dtype == w.dtype, name
        np.testing.assert_array_equal(g[name], w, name)
    assert bool(got.overflowed) == bool(want.overflowed)


@pytest.mark.parametrize("cap", ["below", "at", "above"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_build_sfc_clusters_matches_jax(grid, cap):
    jdom, pos = GRIDS[grid]()
    dom = domain_from_jax(jdom)
    m_c = suggest_m_c(dom, torch.from_numpy(pos))
    n_pairs = sfc_pair_count(dom, torch.from_numpy(pos))
    pair_cap = {"below": max(n_pairs // 2, 1), "at": n_pairs,
                "above": B.sfc_n_clusters(dom) * 27 + 5}[cap]
    _, got, want = _both_lists(jdom, pos, m_c, pair_cap)
    _assert_lists_equal(got, want)
    assert int(got.n_pairs) == n_pairs
    assert bool(got.overflowed) == (cap == "below")


@pytest.mark.parametrize("curve,csize", [("hilbert", 8), ("morton", 3)])
def test_build_sfc_clusters_padded_and_overflowing(curve, csize):
    """``valid``-padded rows and cells past ``m_c``: the list is JAX's, and
    a dropped particle reads exactly 0 through ``sfc_to_particles``."""
    jdom, pos = blob(4, 200, seed=16, sigma_frac=0.1)
    valid = np.random.default_rng(17).random(200) < 0.8
    _, got, want = _both_lists(jdom, pos, 8, 300, csize, curve, valid)
    _assert_lists_equal(got, want)
    dom = domain_from_jax(jdom)
    counts = cell_counts(dom, torch.from_numpy(pos))
    assert int(counts.max()) > 8                      # m_c overflowed
    _, got, want = _both_lists(jdom, pos, 8, 300, csize, curve)
    _assert_lists_equal(got, want)
    tiles = cell_sfc_ref(dom, got, kernel_from_jax(J_KERNELS["low_flop"]()))
    f, u = sfc_to_particles(dom, got, *tiles)
    dropped = got.bins.particle_slot.numpy() == got.bins.slot_id.numel()
    assert dropped.any() and not f[dropped].any() and not u[dropped].any()
    assert u[~dropped].abs().sum() > 0


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pair_count_and_suggest_pair_cap_match_jax(grid):
    jdom, pos = GRIDS[grid]()
    dom = domain_from_jax(jdom)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    for csize, curve in ((4, "morton"), (8, "hilbert")):
        assert sfc_pair_count(dom, tpos, csize=csize, curve=curve) == \
            JB.sfc_pair_count(jdom, jpos, csize=csize, curve=curve)
    counts = cell_counts(dom, tpos)
    assert sfc_pair_count(dom, counts=counts) == \
        JB.sfc_pair_count(jdom, counts=np.asarray(counts))
    nx, ny, _ = dom.ncells
    rng = np.random.default_rng(18)
    ghost_z = tuple(rng.integers(0, 2, (ny, nx)) for _ in range(2))
    assert sfc_pair_count(dom, tpos, ghost_z=tuple(
        torch.from_numpy(g) for g in ghost_z)) == \
        JB.sfc_pair_count(jdom, jpos, ghost_z=ghost_z)
    for slack in (1.25, 3.0, 1e6):
        assert suggest_pair_cap(dom, tpos, slack=slack) == \
            j_suggest_pair_cap(jdom, jpos, slack=slack)


# ---------------------------------------------------------------------------
# forces against JAX's reference sfc plan and its Pallas kernel
# ---------------------------------------------------------------------------

def _sizes(dom, kern, state, **kw):
    """Per-particle sums of the force and potential term sizes."""
    return tuple(plan(dom, k, positions=state.positions, device="cpu",
                      backend="reference", **kw).execute(state)[1]
                 for k in _term_sizes(kern))


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
@pytest.mark.parametrize("name", sorted(J_KERNELS))
def test_sfc_plan_matches_jax_reference(name, periodic):
    jdom, pos = blob(4, 160, seed=19, periodic=periodic, sigma_frac=0.2)
    jk = J_KERNELS[name]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    state = state_from_numpy(pos, device="cpu")
    kw = dict(strategy="cell_dense", layout="sfc")
    p = plan(dom, kern, positions=state.positions, device="cpu",
             backend="reference", **kw)
    jp = j_plan(jdom, jk, positions=jnp.asarray(pos), backend="reference",
                **kw)
    assert (p.m_c, p.pair_cap) == (jp.m_c, jp.pair_cap)
    f, u = p.execute(state)
    jf, ju = jp.execute(JState(jnp.asarray(pos)))
    fsize, usize = _sizes(dom, kern, state, **kw)
    _close(f.numpy(), jf, fsize[:, None], f"forces vs JAX sfc, {name}")
    _close(u.numpy(), ju, usize, f"potential vs JAX sfc, {name}")


def test_sfc_kernel_plain_matches_jax_pallas_interpret():
    """Kernel F's plain version (the cuda backend on CPU tensors) against
    JAX's Pallas SFC kernel in interpret mode, Hilbert clusters of 8."""
    jdom, pos = blob(4, 120, seed=20, periodic=True, sigma_frac=0.2)
    jk = J_KERNELS["lennard_jones"]()
    dom, kern = domain_from_jax(jdom), kernel_from_jax(jk)
    m_c = suggest_m_c(dom, torch.from_numpy(pos))
    pair_cap = sfc_pair_count(dom, torch.from_numpy(pos), csize=8,
                              curve="hilbert")
    _, got, want = _both_lists(jdom, pos, m_c, pair_cap, 8, "hilbert")
    tgt, src = B.sfc_device_slot_tables(dom, m_c, 8, "hilbert",
                                        torch.device("cpu"))
    tiles = cell_sfc_forces(got.bins.planes, got.bins.slot_id, got.codes, tgt,
                            src, m_c=m_c, kernel=kern, cutoff2=1.0)
    assert tiles[0].shape == (8, 8 * m_c)
    f, u = sfc_to_particles(dom, got, *tiles)
    jf, ju = j_pallas_sfc(jdom, want, jk, interpret=True)
    state = state_from_numpy(pos, device="cpu")
    fsize, usize = _sizes(dom, kern, state, m_c=m_c, strategy="xpencil")
    _close(f.numpy(), jf, fsize[:, None], "forces vs JAX Pallas sfc")
    _close(u.numpy(), ju, usize, "potential vs JAX Pallas sfc")


# ---------------------------------------------------------------------------
# within the port: sfc = cell_dense, whatever the clustering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sfc_equals_cell_dense_bitwise(grid):
    """The reference's "dense = sfc" invariant, on both backends. Unlike
    JAX's (ROADMAP Queue 3), the port holds it on the (5, 1, 1) fully
    periodic box too."""
    jdom, pos = GRIDS[grid]()
    dom = domain_from_jax(jdom)
    kern = kernel_from_jax(J_KERNELS["lennard_jones"]())
    state = state_from_numpy(pos, device="cpu")
    want = plan(dom, kern, positions=state.positions, device="cpu",
                strategy="cell_dense", backend="reference").execute(state)
    for backend in ("reference", "cuda"):
        got = plan(dom, kern, positions=state.positions, device="cpu",
                   strategy="cell_dense", layout="sfc",
                   backend=backend).execute(state)
        _equal(got, want, f"sfc ({backend}) vs cell_dense, {grid}")


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_clustering_and_chunking_change_no_bit(periodic):
    """Per particle: Morton = Hilbert = every cluster size = a full
    ``pair_cap`` = any ``batch_size``, through kernel F's plain version."""
    jdom, pos = blob(5, 200, seed=21, periodic=periodic, sigma_frac=0.15)
    dom = domain_from_jax(jdom)
    kern = kernel_from_jax(J_KERNELS["gravity"]())
    tpos = torch.from_numpy(pos)
    bins = bin_particles(dom, tpos, m_c=suggest_m_c(dom, tpos))
    runs = {}
    for curve in ("morton", "hilbert"):
        for csize in (1, 3, 4, 8):
            n_pairs = sfc_pair_count(dom, counts=bins.counts, csize=csize,
                                     curve=curve)
            for pair_cap in (n_pairs, B.sfc_n_clusters(dom, csize) * 27):
                sfc = build_sfc_clusters(dom, bins, pair_cap, csize, curve)
                assert not bool(sfc.overflowed)
                for batch in ((64, 7) if (curve, csize) == ("morton", 4)
                              else (64,)):
                    tiles = S.cell_sfc(dom, sfc, kern, batch_size=batch)
                    runs[(curve, csize, pair_cap, batch)] = \
                        sfc_to_particles(dom, sfc, *tiles)
    first = next(iter(runs.values()))
    assert first[1].abs().sum() > 0
    for key, out in runs.items():
        _equal(out, first, str(key))


def test_cuda_backend_on_cpu_gives_reference_bits():
    jdom, pos = blob(4, 150, seed=22, periodic=True, sigma_frac=0.2)
    dom = domain_from_jax(jdom)
    kern = kernel_from_jax(J_KERNELS["sph_density"]())
    state = state_from_numpy(pos, device="cpu")
    kw = dict(positions=state.positions, device="cpu",
              strategy="cell_dense", layout="sfc")
    cuda = plan(dom, kern, **kw)
    assert cuda.backend == "cuda"
    _equal(cuda.execute(state),
           plan(dom, kern, backend="reference", **kw).execute(state))
    # compact=True is accepted and changes nothing, as in JAX
    _equal(plan(dom, kern, compact=True, **kw).execute(state),
           cuda.execute(state))


# ---------------------------------------------------------------------------
# the replan contract and plan validation
# ---------------------------------------------------------------------------

def test_pair_cap_replan_grows_only_pair_cap():
    """A plan sized on a tight blob, run on a wider scene: ``overflow_class``
    says ``"pair_cap"``, ``replan`` grows ``pair_cap`` alone (aligned,
    strictly past the old value, to JAX's value), and the result equals a
    fresh plan's."""
    jdom, tight = blob(6, 150, seed=23, sigma_frac=0.05)
    _, wide = blob(6, 150, seed=24, sigma_frac=0.3)
    dom = domain_from_jax(jdom)
    kern = kernel_from_jax(J_KERNELS["lennard_jones"]())
    p0 = plan(dom, kern, positions=torch.from_numpy(tight), device="cpu",
              strategy="cell_dense", layout="sfc")
    state = state_from_numpy(wide, device="cpu")
    assert int(cell_counts(dom, state.positions).max()) <= p0.m_c
    assert p0.overflow_class(state) == "pair_cap"
    p1 = p0.replan(state)
    assert (p1.m_c, p1.max_active, p1.row_cap) == (p0.m_c, None, None)
    assert p1.pair_cap > p0.pair_cap and p1.pair_cap % 8 == 0
    assert p1.pair_cap >= sfc_pair_count(dom, state.positions)
    assert p1.overflow_class(state) is None
    jp0 = j_plan(jdom, J_KERNELS["lennard_jones"](),
                 positions=jnp.asarray(tight), strategy="cell_dense",
                 layout="sfc")
    assert jp0.pair_cap == p0.pair_cap
    assert jp0.overflow_class(JState(jnp.asarray(wide))) == "pair_cap"
    assert jp0.replan(JState(jnp.asarray(wide))).pair_cap == p1.pair_cap
    (f, u), p2 = p0.execute_or_replan(state)
    assert p2 == p1
    fresh = plan(dom, kern, m_c=p1.m_c, pair_cap=p1.pair_cap, device="cpu",
                 strategy="cell_dense", layout="sfc").execute(state)
    _equal((f, u), fresh)
    # the truncated list (the old plan run anyway) misses interactions
    sfc = p0.clusters(p0.bin(state))
    assert bool(sfc.overflowed)


def test_sfc_plan_validation():
    """sfc only for cell_dense, and a pair_cap or positions needed, with
    JAX's messages."""
    jdom, pos = blob(4, 100, seed=25)
    dom = domain_from_jax(jdom)
    with pytest.raises(ValueError, match='layout="sfc" is not defined for '
                                         "'xpencil'; sfc strategies: "
                                         r"\['cell_dense'\]"):
        plan(dom, m_c=8, device="cpu", layout="sfc", pair_cap=8,
             strategy="xpencil")
    with pytest.raises(ValueError, match='layout="sfc" needs either pair_cap '
                                         "or positions"):
        plan(dom, m_c=8, device="cpu", strategy="cell_dense", layout="sfc")
    p = plan(dom, m_c=8, device="cpu", strategy="cell_dense", layout="sfc",
             pair_cap=16)
    with pytest.raises(ValueError, match='layout="sfc" needs a positive '
                                         "static pair_cap bound"):
        dataclasses.replace(p, pair_cap=0)
    assert plan(dom, positions=torch.from_numpy(pos), device="cpu",
                strategy="cell_dense", layout="sfc").pair_cap == \
        j_plan(jdom, positions=jnp.asarray(pos), strategy="cell_dense",
               layout="sfc").pair_cap
