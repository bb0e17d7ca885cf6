"""The CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device (decided inside the fixture, never at import).
On the card: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` repeats these checks at the main path's sizes.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.core import (Domain, ParticleState, degradation_ladder,
                              full_pencil_occupancy,
                              make_gravity, make_high_flop,
                              make_lennard_jones, make_low_flop,
                              make_sph_density, pack_rows,
                              pencil_occupancy, plan, scenarios,
                              suggest_m_c, suggest_row_cap)
from repro_torch.core import prefix as plain_prefix
from repro_torch.core import strategies as S
from repro_torch.core.interactions import PairKernel
from repro_torch.core.binning import (bin_particles, build_sfc_clusters,
                                      sfc_device_slot_tables, sfc_n_clusters,
                                      sfc_pair_count, sfc_to_particles)
from repro_torch.core.binning import CellBins, pack_slots_plain, system
from repro_torch.kernels.allin import allin_forces, halo_bytes
from repro_torch.kernels.pack import pack_slots
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.kernels.sfc import cell_sfc_forces, sfc_warp_smem_bytes
from repro_torch.kernels.window_attn import (bwd_route, route,
                                             window_attention,
                                             window_attention_bwd,
                                             window_attention_bwd_plain,
                                             window_attention_plain,
                                             window_attention_with_lse)
from repro_torch.kernels.xpencil import (MAX_M_C, MAX_ROW_CAP, MAX_SMEM,
                                         MAX_TILE_ROWS, chunk_cells,
                                         packed_smem_bytes, packed_tile_rows,
                                         pencil_smem_bytes, xpencil_forces,
                                         xpencil_packed_forces,
                                         xpencil_sparse_forces)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 5000, 1024 ** 2 + 3])
def test_scan_kernel_exact(gen, n):
    x = torch.randint(0, 10, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    assert torch.equal(prefix_sum(x), torch.cumsum(x, 0, dtype=torch.int32))
    assert torch.equal(plain_prefix.exclusive_prefix_sum(x, scan=prefix_sum),
                       plain_prefix.exclusive_prefix_sum(x))


def test_scan_kernel_exact_over_reused_calls(gen):
    """50 calls on one stream's status buffer, lengths up and down, each
    bit-equal to torch.cumsum, one launch each."""
    sizes = [262_144, 5000, 1024 ** 2 + 3, 1, 70_000] * 10
    prefix_sum.launches = 0
    for n in sizes:
        x = torch.randint(-50, 50, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        assert torch.equal(prefix_sum(x), torch.cumsum(x, 0,
                                                       dtype=torch.int32))
    assert prefix_sum.launches == len(sizes)


def test_scan_kernel_exact_on_two_streams(gen):
    """Scans issued on two streams at once each use their own status
    buffer."""
    xs = [torch.randint(0, 10, (3_000_000,), generator=gen, device="cuda",
                        dtype=torch.int32) for _ in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in xs]
    outs = [[], []]
    for _ in range(5):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                outs[i].append(prefix_sum(x))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        want = torch.cumsum(x, 0, dtype=torch.int32)
        assert all(torch.equal(g, want) for g in got)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [8, 24, 300])
def test_xpencil_kernel_matches_plain(gen, periodic, m_c):
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = dom.sample_uniform(240, generator=gen, device="cuda")
    bins = bin_particles(dom, pos, m_c=m_c)
    kern = make_low_flop()
    got = xpencil_forces(bins.planes, bins.slot_id, nx=5, m_c=m_c,
                         kernel=kern, cutoff2=1.0)
    want = S.xpencil_planes(bins.planes["x"], bins.planes["y"],
                            bins.planes["z"], bins.slot_id, nx=5, m_c=m_c,
                            kernel=kern, cutoff2=1.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_main_path_launches_both_kernels(gen):
    dom = Domain.cubic(6, periodic=True)
    pos = dom.sample_uniform(800, generator=gen, device="cuda")
    p = plan(dom, positions=pos, strategy="xpencil")
    prefix_sum.launches = xpencil_forces.launches = 0
    f, u = p.execute(ParticleState(pos))
    torch.cuda.synchronize()
    assert prefix_sum.launches == 1 and xpencil_forces.launches == 1
    assert bool(f.isfinite().all()) and bool(u.isfinite().all())


def _blob(gen, division, n, periodic=False, sigma_frac=0.15):
    dom = Domain.cubic(division, periodic=periodic)
    return dom, scenarios.sample_gaussian_blob(
        dom, n, generator=gen, device="cuda", sigma_frac=sigma_frac)


@pytest.mark.parametrize("periodic", [False, True])
def test_sparse_kernel_matches_plain(gen, periodic):
    dom, pos = _blob(gen, 8, 1500, periodic)
    m_c = suggest_m_c(dom, pos)
    bins = bin_particles(dom, pos, m_c=m_c)
    n_act = int((bins.counts.view(8, 8, 8).sum(-1) > 0).sum())
    occ = pencil_occupancy(dom, bins.counts, n_act + 7)   # padding rows
    kern = make_low_flop()
    args = (bins.planes, bins.slot_id, occ.active)
    got = xpencil_sparse_forces(*args, nx=8, ny=8, m_c=m_c, kernel=kern,
                                cutoff2=1.0)
    want = S.xpencil_sparse_planes(bins.planes["x"], bins.planes["y"],
                                   bins.planes["z"], bins.slot_id,
                                   occ.active, nx=8, ny=8, m_c=m_c,
                                   kernel=kern, cutoff2=1.0)
    dense = xpencil_forces(bins.planes, bins.slot_id, nx=8, m_c=m_c,
                           kernel=kern, cutoff2=1.0)
    for g, w, d in zip(got, want, dense):
        assert g.shape == (n_act + 7, 8 * m_c)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(g, d.reshape(64, -1)[occ.active.long()])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ppc", [4, 40])
def test_packed_kernel_matches_plain(gen, periodic, ppc):
    """ppc 40 gives a row_cap above 256, the block size of the first
    kernel D."""
    dom = Domain.cubic(8, periodic=periodic)
    pos = dom.sample_uniform(8 ** 3 * ppc, generator=gen, device="cuda")
    m_c, row_cap = suggest_m_c(dom, pos), suggest_row_cap(dom, pos)
    assert (row_cap > 256) == (ppc == 40)
    packed = pack_rows(dom, bin_particles(dom, pos, m_c=m_c), row_cap)
    kern = make_low_flop()
    active = full_pencil_occupancy(dom, "cuda").active
    args = (packed.planes, packed.slot_id, packed.slot_cell,
            packed.cell_offsets, active)
    got = xpencil_packed_forces(*args, nx=8, ny=8, m_c=m_c, kernel=kern,
                                cutoff2=1.0)
    want = S.xpencil_packed_planes(packed.planes["x"], packed.planes["y"],
                                   packed.planes["z"], *args[1:], nx=8,
                                   ny=8, m_c=m_c, kernel=kern, cutoff2=1.0)
    every = xpencil_packed_forces(*args[:4], None, nx=8, ny=8, m_c=m_c,
                                  kernel=kern, cutoff2=1.0)
    for g, w, e in zip(got, want, every):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(e, g)          # no list: every row in id order


@pytest.mark.parametrize("periodic", [False, True])
def test_dense_compact_packed_equal_and_launch(gen, periodic):
    dom, pos = _blob(gen, 8, 3000, periodic)
    state = ParticleState(pos)
    kern = make_lennard_jones()
    runs = {}
    for compact, layout, want in (
            (False, "dense", {"prefix_sum": 1, "xpencil_forces": 1}),
            (True, "dense", {"prefix_sum": 1, "xpencil_sparse_forces": 1}),
            (False, "packed", {"prefix_sum": 1, "pack_slots": 1,
                               "xpencil_packed_forces": 1}),
            (True, "packed", {"prefix_sum": 1, "pack_slots": 1,
                              "xpencil_packed_forces": 1})):
        p = plan(dom, kern, positions=pos, compact=compact, layout=layout,
                 strategy="xpencil")
        counters = (prefix_sum, pack_slots, xpencil_forces,
                    xpencil_sparse_forces, xpencil_packed_forces)
        for c in counters:
            c.launches = 0
        runs[(compact, layout)] = p.execute(state)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters if c.launches}
        assert got == want, (compact, layout, got)
    f_d, u_d = runs[(False, "dense")]
    assert bool(f_d.isfinite().all())
    for key, (f, u) in runs.items():
        assert torch.equal(f, f_d) and torch.equal(u, u_d), key


# -- kernels B and C: real particles only, holes anywhere, any chunk width --

PAIR_KINDS = {"lennard_jones": make_lennard_jones, "low_flop": make_low_flop,
              "high_flop": make_high_flop, "gravity": make_gravity,
              "sph_density": lambda: make_sph_density(1.0)}


def _term_close(got, want, size, what, tol=1e-4):
    """|got - want| <= tol * (|want| + size) per element, ``size`` the sum
    of the element's own pair-term sizes (chip_smoke.py's gate)."""
    assert bool(got.isfinite().all()), what
    want = want.double()
    bad = (got.double() - want).abs() > tol * (want.abs() + size.double())
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} elements off, "
                                 f"e.g. {got[bad][:3].tolist()} vs "
                                 f"{want[bad][:3].tolist()}")


def _term_sizes(kern):
    return (PairKernel("force_term_size", torch.zeros_like,
                       lambda r2: kern.coeff(r2).abs() * r2.sqrt(), flops=0),
            PairKernel("potential_term_size", torch.zeros_like,
                       lambda r2: kern.potential(r2).abs(), flops=0))


def _punch_holes(slot_id, m_c, gen, frac=0.35):
    """-1 in about ``frac`` of the occupied slots that have an occupied
    slot after them in their cell."""
    s = slot_id.view(-1, m_c).clone()
    occ = s >= 0
    later = occ.flip(-1).int().cumsum(-1).flip(-1) - occ.int()
    pick = occ & (later > 0) & (torch.rand(s.shape, generator=gen,
                                           device=s.device) < frac)
    s[pick] = -1
    return s.view(slot_id.shape), int(pick.sum())


def _pack_stably(planes, sid, nx, m_c, row_cap=None):
    """Kernel D's packed rows of dense planes whose cells may hold holes:
    each padded row's real slots in slot order, the first ``row_cap`` of
    them (None: the fullest row's count), as ``pack_rows`` drops a row's
    tail -> (packed planes, slot_id, slot_cell, cell_offsets, the packed
    position of every dense slot, the dense slot_id with the dropped slots
    emptied)."""
    nzp, nyp, w = sid.shape
    occ = sid >= 0
    rank = occ.int().cumsum(-1) - 1
    row_counts = occ.sum(-1, dtype=torch.int32)
    if row_cap is None:
        row_cap = max(int(row_counts.max()), 1)
    cell_occ = occ.view(nzp, nyp, nx + 2, m_c).sum(-1, dtype=torch.int32)
    off = cell_occ.cumsum(-1, dtype=torch.int32) - cell_occ
    cell_offsets = torch.cat([off, row_counts[..., None]], -1).contiguous()
    keep = occ & (rank < row_cap)
    dest = torch.where(keep, rank, row_cap).long()

    def pack(plane, fill):
        out = torch.full((nzp, nyp, row_cap + 1), fill, dtype=plane.dtype,
                         device=plane.device)
        out.scatter_(-1, dest, plane)
        return out[..., :row_cap].contiguous()

    cell = (torch.arange(w, device=sid.device, dtype=torch.int32)
            // m_c).expand(nzp, nyp, w)
    return ({c: pack(planes[c], 1.0e8) for c in "xyz"}, pack(sid, -1),
            pack(cell.contiguous(), 1), cell_offsets, rank,
            torch.where(keep, sid, -1))


def _d_lists(nz, ny, gen):
    """Active lists for kernel D: a run of pencils across a z boundary,
    lone pencils in random order, every pencil in order, repeats and
    padding entries (pencil 0)."""
    n = nz * ny
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    lone = ids[torch.randperm(n, generator=gen, device="cuda")][:n // 2]
    return torch.cat([ids[max(ny - 2, 0):ny + 3], lone, ids, lone[:3],
                      torch.zeros(5, dtype=torch.int32, device="cuda")])


def _check_d(dom, planes, sid, m_c, kern, what, gen, row_cap=None,
             tiles=None):
    """Kernel D over the stably packed rows of dense planes: against its
    plain version (per element, term sizes), 0 in every padding slot,
    bit-equal per particle to kernel B on the dense planes less the slots
    the packed rows drop, the same bits at each tile size (``tiles``, None:
    every one that fits), and the same rows over the active lists of
    ``_d_lists``. -> D's outputs."""
    nx, ny, nz = dom.ncells
    kw = dict(nx=nx, ny=ny, m_c=m_c, kernel=kern, cutoff2=1.0)
    p_planes, p_sid, p_cell, p_off, rank, kept = _pack_stably(
        planes, sid, nx, m_c, row_cap)
    cap = p_sid.shape[-1]
    args = (p_planes, p_sid, p_cell, p_off)
    plain_args = (p_planes["x"], p_planes["y"], p_planes["z"], p_sid, p_cell,
                  p_off, torch.arange(nz * ny, dtype=torch.int32,
                                      device="cuda"))
    d = xpencil_packed_forces(*args, None, **kw)
    want = S.xpencil_packed_planes(*plain_args, **kw)
    fsize, usize = (S.xpencil_packed_planes(*plain_args, nx=nx, ny=ny,
                                            m_c=m_c, kernel=k, cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    n_real = p_off[1:-1, 1:-1, -1].clamp(max=cap).reshape(-1, 1)
    pad = torch.arange(cap, device="cuda") >= n_real
    for g, w, part in zip(d, want, ("fx", "fy", "fz", "pot")):
        assert g.shape == (nz * ny, cap)
        _term_close(g, w, usize if part == "pot" else fsize,
                    f"D {part} {what}")
        assert not bool(g[pad].any()), f"D {part} {what}: padding not 0"

    b = xpencil_forces(planes, kept, nx=nx, m_c=m_c, kernel=kern,
                       cutoff2=1.0)
    pos = rank[1:-1, 1:-1, m_c:-m_c].clamp(0, cap - 1).long()
    real = kept[1:-1, 1:-1, m_c:-m_c] >= 0
    for g, bb in zip(d, b):
        per_slot = g.view(nz, ny, -1).gather(-1, pos)
        assert torch.equal(per_slot[real], bb[real]), f"D vs B {what}"

    if tiles is None:
        tiles = [r for r in range(MAX_TILE_ROWS + 1)
                 if packed_smem_bytes(r, cap) <= MAX_SMEM]
    for r in tiles:
        got = xpencil_packed_forces(*args, None, tile_rows=r, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, d)), (what, r)
    act = _d_lists(nz, ny, gen)
    for r in sorted({0, 1, 3, packed_tile_rows(cap, act.shape[0])}
                    & set(tiles)):
        got = xpencil_packed_forces(*args, act, tile_rows=r, **kw)
        assert all(torch.equal(g, w.view(nz * ny, -1)[act.long()])
                   for g, w in zip(got, d)), (what, "active list", r)
    return d


def _check_b_c_d(dom, planes, sid, m_c, kern, what, gen):
    """Kernel B against its plain version and, bit for bit, against itself
    at every chunk width, kernel C (every pencil, shuffled, plus padding)
    and kernel D over the same real particles packed stably."""
    nx, ny, nz = dom.ncells
    kw = dict(m_c=m_c, kernel=kern, cutoff2=1.0)
    xyz = [planes[c] for c in "xyz"]
    b = xpencil_forces(planes, sid, nx=nx, **kw)
    want = S.xpencil_planes(*xyz, sid, nx=nx, **kw)
    fsize, usize = (S.xpencil_planes(*xyz, sid, nx=nx, m_c=m_c, kernel=k,
                                     cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    real = sid[1:-1, 1:-1, m_c:-m_c] >= 0
    for g, w, part in zip(b, want, ("fx", "fy", "fz", "pot")):
        _term_close(g, w, usize if part == "pot" else fsize,
                    f"B {part} {what}")
        assert not bool(g[~real].any()), f"B {part} {what}: empty slot not 0"
    for cx in sorted({1, min(3, nx), nx, chunk_cells(nx, m_c)}):
        if pencil_smem_bytes(cx, m_c) > MAX_SMEM:
            continue
        got = xpencil_forces(planes, sid, nx=nx, cx_cells=cx, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, b)), (what, cx)

    act = torch.randperm(nz * ny, device=sid.device).int()
    act = torch.cat([act, torch.zeros(3, dtype=torch.int32,
                                      device=sid.device)])
    c = xpencil_sparse_forces(planes, sid, act, nx=nx, ny=ny, **kw)
    want_c = S.xpencil_sparse_planes(*xyz, sid, act, nx=nx, ny=ny, **kw)
    rows = act.long()
    for g, w, bb, part in zip(c, want_c, b, ("fx", "fy", "fz", "pot")):
        size = (usize if part == "pot" else fsize).reshape(nz * ny, -1)
        _term_close(g, w, size[rows], f"C {part} {what}")
        assert torch.equal(g, bb.reshape(nz * ny, -1)[rows]), f"C {what}"
    if nx > 1:
        got = xpencil_sparse_forces(planes, sid, act, nx=nx, ny=ny,
                                    cx_cells=nx - 1, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, c)), what

    _check_d(dom, planes, sid, m_c, kern, what, gen)
    return b


def _scene(gen, ncells, ppc, m_c, periodic, full_cell=False, half_y=False):
    dom = Domain(box=tuple(float(c) for c in ncells), ncells=ncells,
                 cutoff=1.0, periodic=periodic)
    n = ncells[0] * ncells[1] * ncells[2] * ppc
    pos = dom.sample_uniform(n, generator=gen, device="cuda")
    if half_y:                    # every pencil row with y >= ny/2 is empty
        pos = pos * torch.tensor([1.0, 0.5, 1.0], device="cuda")
    if full_cell:                 # cell (1, 1, 1) holds m_c or more
        extra = 1.0 + torch.rand((m_c + 2, 3), generator=gen, device="cuda")
        pos = torch.cat([pos, extra])
    bins = bin_particles(dom, pos, m_c=m_c)
    return dom, bins


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [7, 24])            # cp.async; TMA bulk
@pytest.mark.parametrize("name", sorted(PAIR_KINDS))
def test_xpencil_kernels_with_holes(gen, periodic, m_c, name):
    """Holes in the middle of cells, nx = 7 (widths 1, 3, 7 and the
    policy's), every pair kind."""
    dom, bins = _scene(gen, (7, 5, 4), 4, m_c, periodic, full_cell=True)
    sid, n_holes = _punch_holes(bins.slot_id, m_c, gen)
    assert n_holes > 50
    _check_b_c_d(dom, bins.planes, sid, m_c, PAIR_KINDS[name](),
                 f"holes m_c={m_c} periodic={periodic}", gen)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [7, 24])
@pytest.mark.parametrize("scene", ["full_cell", "empty_rows", "empty_grid"])
def test_xpencil_kernels_on_edge_scenes(gen, periodic, m_c, scene):
    dom, bins = _scene(gen, (9, 6, 5), 3, m_c, periodic,
                       full_cell=scene == "full_cell",
                       half_y=scene == "empty_rows")
    sid = bins.slot_id
    counts = (sid >= 0).view(-1, m_c).sum(-1)
    if scene == "full_cell":
        assert int(counts.max()) == m_c
    elif scene == "empty_rows":
        rows = (sid[1:-1, 1:-1] >= 0).any(-1)
        assert bool((~rows).any()) and bool(rows.any())
    else:
        sid = torch.full_like(sid, -1)
    b = _check_b_c_d(dom, bins.planes, sid, m_c, make_lennard_jones(),
                     f"{scene} m_c={m_c} periodic={periodic}", gen)
    if scene == "empty_grid":
        assert not any(bool(o.any()) for o in b)


@pytest.mark.parametrize("periodic", [False, True])
def test_xpencil_kernels_one_cell_wide(gen, periodic):
    dom, bins = _scene(gen, (1, 4, 3), 5, 12, periodic, full_cell=True)
    sid, _ = _punch_holes(bins.slot_id, 12, gen)
    _check_b_c_d(dom, bins.planes, sid, 12, make_gravity(),
                 f"nx=1 periodic={periodic}", gen)


def test_xpencil_kernels_above_1024_slots_a_cell(gen):
    """m_c past the old one-thread-per-slot limit, up to the shared-memory
    one: a cell of 1100 particles, against the plain version."""
    m_c = 1100
    dom, bins = _scene(gen, (3, 2, 2), 20, m_c, False)
    dense = 1.0 + torch.rand((m_c + 50, 3), generator=gen, device="cuda")
    pos = torch.cat([torch.rand((200, 3), generator=gen, device="cuda")
                     * torch.tensor([3.0, 2.0, 2.0], device="cuda"), dense])
    bins = bin_particles(dom, pos, m_c=m_c)
    assert int((bins.slot_id >= 0).view(-1, m_c).sum(-1).max()) == m_c
    _check_b_c_d(dom, bins.planes, bins.slot_id, m_c, make_low_flop(),
                 "m_c=1100", gen)
    big = MAX_M_C + 1
    planes = {c: torch.zeros((3, 3, 3 * big), device="cuda") for c in "xyz"}
    with pytest.raises(ValueError, match="shared memory"):
        xpencil_forces(planes, torch.full((3, 3, 3 * big), -1,
                                          dtype=torch.int32, device="cuda"),
                       nx=1, m_c=big, kernel=make_low_flop(), cutoff2=1.0)


# -- kernel D: real targets, rows shared across neighbouring pencils -------

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("cap", ["fullest", "bulk", "cp_async", "overflow",
                                 "overflow_cp_async"])
def test_packed_kernel_row_caps(gen, periodic, cap):
    """Kernel D (``_check_d``) at a row_cap that is a multiple of 4 (TMA
    bulk copies) and one that is not (cp.async), and below the fullest row
    (its tail dropped, its offsets running past row_cap); holes in the
    cells and a full cell."""
    dom, bins = _scene(gen, (7, 5, 4), 4, 24, periodic, full_cell=True)
    sid, n_holes = _punch_holes(bins.slot_id, 24, gen)
    assert n_holes > 50
    full = int((sid >= 0).sum(-1).max())
    row_cap = {"fullest": None, "bulk": -(-full // 4) * 4 + 4,
               "cp_async": -(-full // 4) * 4 + 5,
               "overflow": (full - 6) // 4 * 4,
               "overflow_cp_async": (full - 6) // 4 * 4 + 1}[cap]
    if row_cap is not None:
        assert (row_cap % 4 == 0) == (cap in ("bulk", "overflow"))
        assert (row_cap < full) == cap.startswith("overflow")
    _check_d(dom, bins.planes, sid, 24, make_lennard_jones(),
             f"row_cap {cap} periodic={periodic}", gen, row_cap)


def test_packed_kernel_past_48kb_and_at_its_limit(gen):
    """Kernel D with more than 48 KB of shared memory a block: row_cap 700
    at its tile (one pencil, two buffers of three rows and 768 sums, 79,504
    B) and every other that fits, row_cap 4000 (one row a step, 64,000 B)
    and MAX_ROW_CAP (232,448 B); one slot more, or a tile that does not
    fit, raises."""
    dom, bins = _scene(gen, (4, 3, 3), 4, 16, True)
    kern = make_lennard_jones()
    assert packed_smem_bytes(0, MAX_ROW_CAP) == MAX_SMEM == 232448
    for row_cap, tiles in ((700, None), (4000, None), (MAX_ROW_CAP, [0])):
        r = packed_tile_rows(row_cap, 9)
        assert packed_smem_bytes(r, row_cap) > 48 * 1024
        assert (r == 0) == (row_cap > 700)
        _check_d(dom, bins.planes, bins.slot_id, 16, kern,
                 f"row_cap {row_cap}", gen, row_cap, tiles)
    xpencil_packed_forces.launches = 0
    for row_cap, kw in ((MAX_ROW_CAP + 1, {}),
                        (700, {"tile_rows": MAX_TILE_ROWS + 1}),
                        (700, {"tile_rows": 9})):
        args = _pack_stably(bins.planes, bins.slot_id, 4, 16, row_cap)[:4]
        with pytest.raises(ValueError, match="row_cap|tile_rows"):
            xpencil_packed_forces(*args, None, nx=4, ny=3, m_c=16,
                                  kernel=kern, cutoff2=1.0, **kw)
    assert xpencil_packed_forces.launches == 0


def test_packed_kernel_over_occupancy_lists(gen):
    """Kernel D over the blob's occupancy list (runs of consecutive
    pencils, padding entries) equals its rows over every pencil, at the
    plan's row_cap."""
    dom, pos = _blob(gen, 12, 4000, sigma_frac=0.1)
    m_c, row_cap = suggest_m_c(dom, pos), suggest_row_cap(dom, pos)
    bins = bin_particles(dom, pos, m_c=m_c)
    packed = pack_rows(dom, bins, row_cap)
    n_act = int((bins.counts.view(12, 12, 12).sum(-1) > 0).sum())
    occ = pencil_occupancy(dom, bins.counts, n_act + 9)
    args = (packed.planes, packed.slot_id, packed.slot_cell,
            packed.cell_offsets)
    kw = dict(nx=12, ny=12, m_c=m_c, kernel=make_lennard_jones(),
              cutoff2=1.0)
    every = xpencil_packed_forces(*args, None, **kw)
    for r in (None, 0, 1, 2, 5):
        got = xpencil_packed_forces(*args, occ.active, tile_rows=r, **kw)
        for g, e in zip(got, every):
            assert torch.equal(g, e[occ.active.long()]), r


# -- the pack kernel ---------------------------------------------------------

def _halo_pack_input(gen, periodic):
    """The stacked shards' bins that ``dist.engine`` hands ``pack_rows`` on
    a packed halo plan (slot ids offset by each shard's index), and its
    local domain and row_cap."""
    from repro_torch.dist import engine as E
    dom = Domain.cubic(8, periodic=periodic)
    pos = dom.sample_uniform(8 ** 3 * 4, generator=gen, device="cuda")
    p = plan(dom, positions=pos, backend="halo", n_shards=4,
             halo_inner="cuda", strategy="xpencil", layout="packed")
    seen, real = [], E.pack_rows
    E.pack_rows = lambda d, b, row_cap: seen.append((d, b, row_cap)) or \
        real(d, b, row_cap)
    try:
        E.halo_impl(p).layout(ParticleState(pos[None]))
    finally:
        E.pack_rows = real
    return seen[0]


PACK_OUTPUTS = ("slot_id", "slot_cell", "cell_offsets", "row_counts",
                "particle_slot")


@pytest.mark.parametrize("scene", ["open", "periodic", "row_cap_overflow",
                                   "m_c_overflow", "m_c_odd", "blob",
                                   "fields", "stacked", "refresh_bins",
                                   "halo", "halo_periodic"])
def test_pack_kernel_equals_plain(gen, scene):
    """Every output of the pack kernel (the planes, ids, cells, cell
    offsets, row counts and particle slots) torch.equal to its plain
    version on the same bins: an overflowing row_cap, particles the dense
    binning dropped, m_c not a multiple of 4 (the kernel reads one id a
    load), the blob, extra float and int fields, stacked systems with a
    padding system, ``refresh_bins``' bins, the halo's shards with offset
    slot ids; one launch of the wrapper, and ``pack_rows`` on the card
    equal to ``pack_rows`` on the CPU."""
    from repro_torch.core.binning import refresh_bins
    row_cap = None
    if scene == "blob":
        dom, pos = _blob(gen, 16, 20000, sigma_frac=0.1)
    elif scene.startswith("halo"):
        dom, bins, row_cap = _halo_pack_input(gen, scene == "halo_periodic")
    else:
        dom = Domain(box=(7.0, 5.0, 4.0), ncells=(7, 5, 4), cutoff=1.0,
                     periodic=scene in ("periodic", "refresh_bins"))
        pos = dom.sample_uniform(500, generator=gen, device="cuda")
    nx, ny, nz = dom.ncells
    if row_cap is None:
        m_c = suggest_m_c(dom, pos)
        m_c = {"m_c_overflow": 3, "m_c_odd": m_c | 1}.get(scene, m_c)
        row_cap = 12 if scene == "row_cap_overflow" else suggest_row_cap(
            dom, pos)
        fields = None
        if scene == "fields":
            fields = {"mass": torch.rand(pos.shape[0], generator=gen,
                                         device="cuda"),
                      "tag": torch.arange(pos.shape[0], dtype=torch.int32,
                                          device="cuda")}
        if scene == "stacked":              # system 1 padding throughout
            dom, states = _stacked_scene(gen, True, n=500, ncells=(7, 5, 4))
            every = states.positions.reshape(-1, 3)   # covers each system
            m_c = suggest_m_c(dom, every)
            row_cap = suggest_row_cap(dom, every)
            bins = bin_particles(dom, states.positions, m_c=m_c,
                                 valid=states.valid)
        else:
            bins = bin_particles(dom, pos, fields, m_c=m_c)
        if scene == "refresh_bins":
            bins = refresh_bins(dom, bins, pos + 0.01 * torch.randn(
                pos.shape, generator=gen, device="cuda"))
    m_c = bins.m_c
    if scene == "m_c_odd":
        assert m_c % 4 != 0                 # one id a load
    total = math.prod(bins.slot_id.shape[-3:])      # one system's dump slot
    if scene in ("open", "periodic", "row_cap_overflow", "m_c_overflow",
                 "blob", "fields", "m_c_odd"):
        assert bool((bins.particle_slot == total).any()) == (
            scene == "m_c_overflow")
    kw = dict(nx=nx, ny=ny, row_cap=row_cap)
    pack_slots.launches = 0
    got = pack_slots(bins, **kw)
    torch.cuda.synchronize()
    assert pack_slots.launches == 1
    want = pack_slots_plain(bins, **kw)
    assert sorted(got[0]) == sorted(want[0]) == sorted(bins.planes)
    for name in want[0]:
        g, w = got[0][name], want[0][name]
        assert g.dtype == w.dtype and torch.equal(g, w), name
    for g, w, name in zip(got[1:], want[1:], PACK_OUTPUTS, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert (int(got[4].max()) > row_cap) == (scene == "row_cap_overflow")
    if scene.startswith("halo"):
        assert bool((bins.slot_id[1] >= bins.particle_slot.shape[-1]).any())

    on_card = pack_rows(dom, bins, row_cap)
    assert pack_slots.launches == 2
    on_cpu = pack_rows(dom, CellBins(
        planes={k: v.cpu() for k, v in bins.planes.items()},
        slot_id=bins.slot_id.cpu(), counts=bins.counts.cpu(),
        offsets=bins.offsets.cpu(), particle_slot=bins.particle_slot.cpu(),
        m_c=m_c), row_cap)
    assert pack_slots.launches == 2
    for name in PACK_OUTPUTS:
        assert torch.equal(getattr(on_card, name).cpu(),
                           getattr(on_cpu, name)), name
    for name in on_cpu.planes:
        assert torch.equal(on_card.planes[name].cpu(), on_cpu.planes[name])
    if scene == "fields":
        bins.planes["mass"] = bins.planes["mass"].double()
        with pytest.raises(ValueError, match="4-byte"):
            pack_slots(bins, **kw)
        assert pack_slots.launches == 2


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [8, 24])
@pytest.mark.parametrize("box", [(1, 1, 1), (3, 2, 1), (2, 4, 3), (6, 4, 3)])
def test_allin_kernel_matches_plain_and_kernel_b(gen, periodic, m_c, box):
    """Kernel E against its plain version, and E == B bit for bit whatever
    the box; (6, 4, 3) at m_c 24 stages 92,160 B, past the 48 KB default."""
    dom = Domain(box=(6.0, 4.0, 3.0), ncells=(6, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = dom.sample_uniform(300, generator=gen, device="cuda")
    bins = bin_particles(dom, pos, m_c=m_c)
    for kern in (make_low_flop(), make_lennard_jones(), make_gravity()):
        got = allin_forces(bins.planes, bins.slot_id, box=box, m_c=m_c,
                           kernel=kern, cutoff2=1.0)
        want = S.allin_planes(bins.planes["x"], bins.planes["y"],
                              bins.planes["z"], bins.slot_id, box=box,
                              m_c=m_c, kernel=kern, cutoff2=1.0)
        b = xpencil_forces(bins.planes, bins.slot_id, nx=6, m_c=m_c,
                           kernel=kern, cutoff2=1.0)
        for g, w, bb in zip(got, want, b):
            assert g.shape == (3, 4, 6 * m_c)
            if kern.name == "low_flop":
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
            assert torch.equal(g, bb), kern.name


def test_allin_wrapper_raises_above_shared_memory(gen):
    dom = Domain.cubic(3)
    pos = dom.sample_uniform(30, generator=gen, device="cuda")
    bins = bin_particles(dom, pos, m_c=540)
    assert halo_bytes((1, 1, 1), 538) <= 232448 < halo_bytes((1, 1, 1), 539)
    allin_forces.launches = 0
    with pytest.raises(ValueError, match="232448"):
        allin_forces(bins.planes, bins.slot_id, box=(1, 1, 1), m_c=540,
                     kernel=make_lennard_jones(), cutoff2=1.0)
    with pytest.raises(ValueError, match="must divide the grid"):
        allin_forces(bins.planes, bins.slot_id, box=(2, 1, 1), m_c=540,
                     kernel=make_lennard_jones(), cutoff2=1.0)
    assert allin_forces.launches == 0


@pytest.mark.parametrize("periodic", [False, True])
def test_allin_main_path_launches_kernel_e(gen, periodic):
    dom, pos = _blob(gen, 8, 3000, periodic)
    state = ParticleState(pos)
    p = plan(dom, positions=pos, strategy="allin")
    prefix_sum.launches = allin_forces.launches = xpencil_forces.launches = 0
    f, u = p.execute(state)
    torch.cuda.synchronize()
    assert (prefix_sum.launches, allin_forces.launches,
            xpencil_forces.launches) == (1, 1, 0)
    f_b, u_b = plan(dom, positions=pos, strategy="xpencil").execute(state)
    assert torch.equal(f, f_b) and torch.equal(u, u_b)


# -- kernel E: compacted halo cells, real targets only ---------------------

def _real_pairs(sid, m_c):
    """Pair steps a kernel that visits only real particles takes: for each
    real interior target, the real slots of its 27 neighbour cells in the
    padded planes (itself included, the ghost ring holding the periodic
    images)."""
    nzp, nyp, w = sid.shape
    cnt = (sid >= 0).view(nzp, nyp, w // m_c, m_c).sum(-1).long()
    nbr = sum(cnt[1 + dz:nzp - 1 + dz, 1 + dy:nyp - 1 + dy,
                  1 + dx:w // m_c - 1 + dx]
              for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return int((cnt[1:-1, 1:-1, 1:-1] * nbr).sum())


def _check_e(dom, planes, sid, m_c, kern, boxes, what):
    """Kernel E at each box against its plain version (per element, term
    sizes), bit-equal to kernel B per slot, 0 in every empty slot, and its
    pair steps exactly the real pairs."""
    nx, ny, nz = dom.ncells
    xyz = [planes[c] for c in "xyz"]
    b = xpencil_forces(planes, sid, nx=nx, m_c=m_c, kernel=kern, cutoff2=1.0)
    fsize, usize = (S.xpencil_planes(*xyz, sid, nx=nx, m_c=m_c, kernel=k,
                                     cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    real = sid[1:-1, 1:-1, m_c:-m_c] >= 0
    for box in boxes:
        visits = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = allin_forces(planes, sid, box=box, m_c=m_c, kernel=kern,
                           cutoff2=1.0, visits=visits)
        want = S.allin_planes(*xyz, sid, box=box, m_c=m_c, kernel=kern,
                              cutoff2=1.0)
        for g, w, bb, part in zip(got, want, b, ("fx", "fy", "fz", "pot")):
            _term_close(g, w, usize if part == "pot" else fsize,
                        f"E {part} box {box} {what}")
            assert torch.equal(g, bb), f"E != B: {part} box {box} {what}"
            assert not bool(g[~real].any()), f"E {part} {what}: empty slot"
        assert int(visits) == _real_pairs(sid, m_c), (box, what)
    return b


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [7, 24])
@pytest.mark.parametrize("name", sorted(PAIR_KINDS))
def test_allin_kernel_with_holes(gen, periodic, m_c, name):
    """Holes in the middle of cells, a full cell, every pair kind, boxes
    from one cell to the whole grid."""
    dom, bins = _scene(gen, (6, 4, 3), 4, m_c, periodic, full_cell=True)
    sid, n_holes = _punch_holes(bins.slot_id, m_c, gen)
    assert n_holes > 30
    _check_e(dom, bins.planes, sid, m_c, PAIR_KINDS[name](),
             [(1, 1, 1), (3, 2, 1), (2, 4, 3), (6, 4, 3)],
             f"holes m_c={m_c} periodic={periodic}")


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [7, 24, 33])
@pytest.mark.parametrize("scene", ["full_cell", "empty_rows", "empty_grid"])
def test_allin_kernel_on_edge_scenes(gen, periodic, m_c, scene):
    """Full cells (count = m_c), empty pencil rows, an all-empty grid; m_c
    below, at and above a warp's 32 slots."""
    dom, bins = _scene(gen, (6, 6, 4), 3, m_c, periodic,
                       full_cell=scene == "full_cell",
                       half_y=scene == "empty_rows")
    sid = bins.slot_id
    if scene == "full_cell":
        assert int((sid >= 0).view(-1, m_c).sum(-1).max()) == m_c
    if scene == "empty_grid":
        sid = torch.full_like(sid, -1)
    b = _check_e(dom, bins.planes, sid, m_c, make_lennard_jones(),
                 [(1, 1, 1), (2, 3, 2), (6, 6, 4)],
                 f"{scene} m_c={m_c} periodic={periodic}")
    if scene == "empty_grid":
        assert not any(bool(o.any()) for o in b)


@pytest.mark.parametrize("m_c", [7, 24, 40])
def test_allin_kernel_bits_do_not_depend_on_threads(gen, m_c):
    """Kernel E at every block size, from one warp to 1024 threads (the
    launch bound), and at allin_threads' choice: B's bits and the real
    pairs' steps each time; with holes and a full cell."""
    dom, bins = _scene(gen, (4, 4, 4), 5, m_c, False, full_cell=True)
    sid, n_holes = _punch_holes(bins.slot_id, m_c, gen)
    assert n_holes > 30
    kern = make_lennard_jones()
    b = xpencil_forces(bins.planes, sid, nx=4, m_c=m_c, kernel=kern,
                       cutoff2=1.0)
    for box in ((4, 4, 4), (2, 2, 1)):
        for threads in (32, 96, 256, 512, 1024, None):
            visits = torch.zeros(1, dtype=torch.int64, device="cuda")
            got = allin_forces(bins.planes, sid, box=box, m_c=m_c,
                               kernel=kern, cutoff2=1.0, visits=visits,
                               threads=threads)
            for g, bb, part in zip(got, b, ("fx", "fy", "fz", "pot")):
                assert torch.equal(g, bb), (part, box, threads)
            assert int(visits) == _real_pairs(sid, m_c), (box, threads)


def _sfc_tiles(dom, bins, kern, csize, curve, pair_cap=None, plain=False):
    """Kernel F (or its plain version) over the pair list of ``bins``."""
    if pair_cap is None:
        pair_cap = sfc_pair_count(dom, counts=bins.counts, csize=csize,
                                  curve=curve)
    sfc = build_sfc_clusters(dom, bins, pair_cap, csize, curve)
    tgt, src = sfc_device_slot_tables(dom, bins.m_c, csize, curve,
                                      bins.slot_id.device)
    if plain:
        return sfc, S.cell_sfc_tiles(
            bins.planes["x"], bins.planes["y"], bins.planes["z"],
            bins.slot_id, sfc.codes, tgt, src, m_c=bins.m_c, kernel=kern,
            cutoff2=1.0)
    return sfc, cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt,
                                src, m_c=bins.m_c, kernel=kern, cutoff2=1.0)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("csize,curve", [(4, "morton"), (8, "hilbert")])
def test_sfc_kernel_matches_plain(gen, periodic, csize, curve):
    """Kernel F against its plain version at two clusterings; a 5 x 4 x 3
    grid leaves the last cluster padded with sentinel cells."""
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = dom.sample_uniform(240, generator=gen, device="cuda")
    bins = bin_particles(dom, pos, m_c=24)
    for kern in (make_low_flop(), make_lennard_jones(), make_gravity()):
        _, got = _sfc_tiles(dom, bins, kern, csize, curve)
        _, want = _sfc_tiles(dom, bins, kern, csize, curve, plain=True)
        for g, w in zip(got, want):
            assert g.shape == (sfc_n_clusters(dom, csize), csize * 24)
            assert bool(g.isfinite().all())
            if kern.name == "low_flop":
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("periodic", [False, True])
def test_sfc_kernel_bits_do_not_depend_on_clustering(gen, periodic):
    """Per particle, kernel F gives the same bits for Morton and Hilbert,
    csize 1, 4 and 8, and pair_cap n_pairs or n_clusters * 27."""
    dom, pos = _blob(gen, 8, 3000, periodic)
    bins = bin_particles(dom, pos, m_c=suggest_m_c(dom, pos))
    kern = make_lennard_jones()
    runs = []
    for curve in ("morton", "hilbert"):
        for csize in (1, 4, 8):
            for full in (False, True):
                cap = sfc_n_clusters(dom, csize) * 27 if full else None
                sfc, tiles = _sfc_tiles(dom, bins, kern, csize, curve, cap)
                assert not bool(sfc.overflowed)
                runs.append(sfc_to_particles(dom, sfc, *tiles))
    for f, u in runs[1:]:
        assert torch.equal(f, runs[0][0]) and torch.equal(u, runs[0][1])


def test_sfc_kernel_past_1024_slots_a_tile(gen):
    """csize * m_c past the old one-thread-per-slot limit (8 x 129 = 1032
    slots, full cells) runs and matches the plain version; the limit is a
    warp's shared memory, stated with the byte count."""
    dom = Domain.cubic(3)
    pos = torch.cat([dom.sample_uniform(60, generator=gen, device="cuda"),
                     1.0 + torch.rand((140, 3), generator=gen,
                                      device="cuda")])
    bins = bin_particles(dom, pos, m_c=129)
    assert int((bins.slot_id >= 0).view(-1, 129).sum(-1).max()) == 129
    kern = make_low_flop()
    cell_sfc_forces.launches = 0
    sfc, got = _sfc_tiles(dom, bins, kern, 8, "morton")
    _, want = _sfc_tiles(dom, bins, kern, 8, "morton", plain=True)
    assert got[0].shape == (4, 8 * 129) and cell_sfc_forces.launches == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    big = next(m for m in range(11000, 12000)
               if sfc_warp_smem_bytes(1, m) > MAX_SMEM)
    planes = {c: torch.zeros((3, 3, 3 * big), device="cuda") for c in "xyz"}
    sid = torch.full((3, 3, 3 * big), -1, dtype=torch.int32, device="cuda")
    one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=str(MAX_SMEM)):
        cell_sfc_forces(planes, sid, one.view(1), one,
                        torch.zeros((1, 27, 1), dtype=torch.int32,
                                    device="cuda"),
                        m_c=big, kernel=kern, cutoff2=1.0)
    assert cell_sfc_forces.launches == 1


def test_sfc_kernel_tile_past_the_default_shared_memory(gen):
    """A warp that needs more than the 48 KB a block gets without opting
    in (csize 8 x m_c 400, full cells): matches the plain version, takes
    exactly the real pairs' steps and gives csize 1's bits per particle."""
    m_c = 400
    assert sfc_warp_smem_bytes(8, m_c) > 48 * 1024
    assert sfc_warp_smem_bytes(1, m_c) <= 48 * 1024
    dom = Domain.cubic(3)
    pos = torch.cat([dom.sample_uniform(1500, generator=gen, device="cuda"),
                     1.0 + torch.rand((420, 3), generator=gen,
                                      device="cuda")])
    bins = bin_particles(dom, pos, m_c=m_c)
    assert int((bins.slot_id >= 0).view(-1, m_c).sum(-1).max()) == m_c
    kern = make_lennard_jones()
    visits = torch.zeros(1, dtype=torch.int64, device="cuda")
    sfc = build_sfc_clusters(dom, bins, sfc_pair_count(
        dom, counts=bins.counts, csize=8, curve="morton"), 8, "morton")
    tgt, src = sfc_device_slot_tables(dom, m_c, 8, "morton", "cuda")
    got = cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt, src,
                          m_c=m_c, kernel=kern, cutoff2=1.0, visits=visits)
    assert got[0].shape == (4, 8 * m_c)
    assert int(visits) == _real_pairs(bins.slot_id, m_c)
    args = (bins.planes["x"], bins.planes["y"], bins.planes["z"],
            bins.slot_id, sfc.codes, tgt, src)
    want = S.cell_sfc_tiles(*args, m_c=m_c, kernel=kern, cutoff2=1.0)
    fsize, usize = (S.cell_sfc_tiles(*args, m_c=m_c, kernel=k,
                                     cutoff2=1.0)[3]
                    for k in _term_sizes(kern))
    for g, w, part in zip(got, want, ("fx", "fy", "fz", "pot")):
        _term_close(g, w, usize if part == "pot" else fsize,
                    f"F {part} csize 8 m_c {m_c}")
    sfc1, one = _sfc_tiles(dom, bins, kern, 1, "morton")
    f8, u8 = sfc_to_particles(dom, sfc, *got)
    f1, u1 = sfc_to_particles(dom, sfc1, *one)
    assert torch.equal(f8, f1) and torch.equal(u8, u1)


@pytest.mark.parametrize("periodic", [False, True])
def test_sfc_main_path_launches_kernel_f(gen, periodic):
    dom, pos = _blob(gen, 8, 3000, periodic)
    state = ParticleState(pos)
    kern = make_low_flop()
    p = plan(dom, kern, positions=pos, strategy="cell_dense", layout="sfc")
    counters = (prefix_sum, cell_sfc_forces, xpencil_forces)
    for c in counters:
        c.launches = 0
    f, u = p.execute(state)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [1, 1, 0]
    f_r, u_r = plan(dom, kern, positions=pos, strategy="cell_dense",
                    layout="sfc", backend="reference").execute(state)
    torch.testing.assert_close(f, f_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(u, u_r, rtol=1e-4, atol=1e-4)


# -- kernel F: compacted slabs, real targets only ---------------------------

CLUSTERINGS = [(c, k) for k in ("morton", "hilbert") for c in (1, 4, 8)]


def _check_f(dom, bins, kern, what, full_list=True):
    """Kernel F at every clustering and both pair_caps: against its plain
    version (per element, term sizes), per particle the same bits every
    time, 0 in every empty target slot, its pair steps exactly the real
    pairs. -> per-particle (forces, potential)."""
    m_c = bins.m_c
    runs = []
    for csize, curve in CLUSTERINGS:
        caps = [sfc_pair_count(dom, counts=bins.counts, csize=csize,
                               curve=curve), sfc_n_clusters(dom, csize) * 27]
        for cap in caps:
            visits = torch.zeros(1, dtype=torch.int64, device="cuda")
            sfc = build_sfc_clusters(dom, bins, cap, csize, curve)
            assert not bool(sfc.overflowed)
            tgt, src = sfc_device_slot_tables(dom, m_c, csize, curve,
                                              bins.slot_id.device)
            got = cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt,
                                  src, m_c=m_c, kernel=kern, cutoff2=1.0,
                                  visits=visits)
            runs.append(sfc_to_particles(dom, sfc, *got))
            if cap != caps[0] or csize == 8:
                continue
            args = (bins.planes["x"], bins.planes["y"], bins.planes["z"],
                    bins.slot_id, sfc.codes, tgt, src)
            want = S.cell_sfc_tiles(*args, m_c=m_c, kernel=kern, cutoff2=1.0)
            fsize, usize = (S.cell_sfc_tiles(*args, m_c=m_c, kernel=k,
                                             cutoff2=1.0)[3]
                            for k in _term_sizes(kern))
            real = bins.slot_id.view(-1)[
                (tgt.long()[..., None] + torch.arange(m_c, device="cuda"))
                .clamp(max=bins.slot_id.numel() - 1)].view(got[0].shape) >= 0
            real &= (tgt.long() < bins.slot_id.numel()).repeat_interleave(
                m_c, -1)
            for g, w, part in zip(got, want, ("fx", "fy", "fz", "pot")):
                _term_close(g, w, usize if part == "pot" else fsize,
                            f"F {part} {csize} {curve} {what}")
                assert not bool(g[~real].any()), f"F {part} {what}: empty"
            if full_list:
                assert int(visits) == _real_pairs(bins.slot_id, m_c), what
    for f, u in runs[1:]:
        assert torch.equal(f, runs[0][0]) and torch.equal(u, runs[0][1]), \
            what
    return runs[0]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m_c", [7, 24])
@pytest.mark.parametrize("name", ["lennard_jones", "low_flop", "gravity"])
def test_sfc_kernel_with_holes(gen, periodic, m_c, name):
    """Holes in the middle of cells and a full cell; a 5 x 4 x 3 grid
    leaves clusters padded with sentinel cells."""
    dom, bins = _scene(gen, (5, 4, 3), 4, m_c, periodic, full_cell=True)
    sid, n_holes = _punch_holes(bins.slot_id, m_c, gen)
    assert n_holes > 30
    bins = dataclasses.replace(bins, slot_id=sid)
    _check_f(dom, bins, PAIR_KINDS[name](), f"holes m_c={m_c} "
             f"periodic={periodic}")


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("scene", ["full_cell", "empty_rows", "empty_grid"])
def test_sfc_kernel_on_edge_scenes(gen, periodic, scene):
    """Full cells (count = m_c), half the grid empty (clusters with no kept
    code, whose tiles must be 0), an all-empty grid."""
    m_c = 24
    dom, bins = _scene(gen, (8, 8, 4), 3, m_c, periodic,
                       full_cell=scene == "full_cell",
                       half_y=scene == "empty_rows")
    if scene == "empty_grid":
        bins = dataclasses.replace(bins,
                                   slot_id=torch.full_like(bins.slot_id, -1))
    f, u = _check_f(dom, bins, make_lennard_jones(),
                    f"{scene} periodic={periodic}")
    if scene == "empty_rows":
        sfc = build_sfc_clusters(dom, bins, sfc_n_clusters(dom, 4) * 27, 4,
                                 "morton")
        kept = torch.zeros(sfc_n_clusters(dom, 4) + 1, dtype=torch.bool,
                           device="cuda")
        kept[(sfc.codes.long() >> 5)] = True
        assert not bool(kept[:-1].all())       # some clusters keep no code
        tgt, src = sfc_device_slot_tables(dom, m_c, 4, "morton", "cuda")
        tiles = cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt,
                                src, m_c=m_c, kernel=make_lennard_jones(),
                                cutoff2=1.0)
        assert not any(bool(t[~kept[:-1]].any()) for t in tiles)
    if scene == "empty_grid":
        assert not bool(f.any()) and not bool(u.any())


def test_sfc_kernel_takes_each_code_once(gen):
    """Repeated codes and codes past the 27 stencil slots are taken as the
    plain version takes them: once, and not at all."""
    dom, pos = _blob(gen, 6, 1500)
    bins = bin_particles(dom, pos, m_c=suggest_m_c(dom, pos))
    kern = make_low_flop()
    sfc, want = _sfc_tiles(dom, bins, kern, 4, "morton",
                           sfc_n_clusters(dom, 4) * 27)
    codes = sfc.codes[:int(sfc.n_pairs)]
    extra = torch.cat([codes[::3], (codes[::5] | 31)])
    noisy = torch.sort(torch.cat([sfc.codes, extra])).values
    tgt, src = sfc_device_slot_tables(dom, bins.m_c, 4, "morton", "cuda")
    got = cell_sfc_forces(bins.planes, bins.slot_id, noisy, tgt, src,
                          m_c=bins.m_c, kernel=kern, cutoff2=1.0)
    plain = S.cell_sfc_tiles(bins.planes["x"], bins.planes["y"],
                             bins.planes["z"], bins.slot_id, noisy, tgt, src,
                             m_c=bins.m_c, kernel=kern, cutoff2=1.0)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kh,s,d,window,softcap", [
    (1, 4, 4, 128, 16, 5, 0.0), (2, 8, 2, 256, 64, 100, 50.0),
    (1, 6, 1, 96, 256, 300, 0.0), (2, 8, 4, 192, 64, 64, 50.0),
    (1, 4, 2, 40, 20, 13, 0.0)])
def test_window_kernel_matches_plain(gen, b, h, kh, s, d, window, softcap,
                                     dtype, tol):
    q = torch.randn((b, h, s, d), generator=gen, device="cuda") * 2
    k = torch.randn((b, kh, s, d), generator=gen, device="cuda") * 2
    v = torch.randn((b, kh, s, d), generator=gen, device="cuda")
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    blk = 8 if s % 32 else 32
    window_attention.launches = 0
    window_attention.launches_by_route = dict.fromkeys(
        window_attention.launches_by_route, 0)
    got = window_attention(q, k, v, window=window, blk=blk, softcap=softcap)
    torch.cuda.synchronize()
    assert window_attention.launches == 1 and got.dtype == dtype
    assert window_attention.launches_by_route[route(dtype, d)] == 1
    want = window_attention_plain(q, k, v, window=window, blk=blk,
                                  softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kh,s,d,window,softcap", [
    (2, 4, 2, 256, 128, 100, 50.0), (1, 8, 4, 384, 256, 200, 50.0),
    (1, 4, 1, 200, 64, 77, 0.0), (2, 4, 2, 128, 64, 1, 50.0),
    (1, 8, 1, 256, 128, 96, 0.0), (1, 2, 2, 96, 48, 40, 0.0)],
    ids=["d128", "d256", "ragged-s200", "window1", "gqa8", "d48"])
def test_window_wgmma_route_matches_plain(gen, b, h, kh, s, d, window,
                                          softcap):
    """bf16 shapes that the tensor-core route must take, within 2e-2 of the
    plain version."""
    q = torch.randn((b, h, s, d), generator=gen, device="cuda") * 4
    k = torch.randn((b, kh, s, d), generator=gen, device="cuda") * 4
    v = torch.randn((b, kh, s, d), generator=gen, device="cuda")
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    blk = 8
    window_attention.launches_by_route = dict.fromkeys(
        window_attention.launches_by_route, 0)
    got = window_attention(q, k, v, window=window, blk=blk, softcap=softcap)
    torch.cuda.synchronize()
    assert window_attention.launches_by_route == {"wgmma": 1, "simt": 0}
    want = window_attention_plain(q, k, v, window=window, blk=blk,
                                  softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_window_wrapper_raises_past_head_dim_256(gen):
    q = torch.zeros((1, 2, 32, 264), device="cuda")
    with pytest.raises(ValueError, match="head_dim <= 256"):
        window_attention(q, q, q, window=8, blk=32)
    with pytest.raises(ValueError, match="one dtype"):
        window_attention(q[..., :8].half(), q[..., :8].half(),
                         q[..., :8].half(), window=8, blk=32)


def test_gemma_smoke_prefill_launches_kernel_g(gen):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("gemma2-2b")
    params = M.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device="cuda")
    window_attention.launches = 0
    window_attention.launches_by_route = dict.fromkeys(
        window_attention.launches_by_route, 0)
    logits, cache = M.prefill(cfg, params, tokens, max_len=36)
    torch.cuda.synchronize()
    assert window_attention.launches == cfg.n_layers // 2
    assert window_attention.launches_by_route["simt"] == cfg.n_layers // 2
    want, cache_cpu = M.prefill(cfg, _to_cpu(params), tokens.cpu(),
                                max_len=36)
    torch.testing.assert_close(logits.cpu(), want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(cache["k"].cpu(), cache_cpu["k"], rtol=2e-3,
                               atol=2e-3)


def _window_bwd_inputs(gen, b, h, kh, s, d, window, softcap, dtype):
    """((q, k, v, out, dout), lse): kernel G's out and lse (None on G's SIMT
    route, whose Gb computes its own) and a random dout."""
    q = torch.randn((b, h, s, d), generator=gen, device="cuda") * 2
    k = torch.randn((b, kh, s, d), generator=gen, device="cuda") * 2
    v = torch.randn((b, kh, s, d), generator=gen, device="cuda")
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out, lse = window_attention_with_lse(q, k, v, window=window, blk=1,
                                         softcap=softcap)
    dout = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    return (q, k, v, out, dout), lse


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kh,s,d,window,softcap", [
    (1, 4, 4, 128, 16, 5, 0.0), (2, 8, 2, 256, 64, 100, 50.0),
    (1, 6, 1, 96, 256, 300, 0.0), (2, 8, 4, 192, 64, 64, 50.0),
    (1, 4, 2, 40, 20, 13, 0.0), (1, 8, 4, 200, 256, 77, 50.0),
    (1, 8, 1, 130, 128, 1, 50.0), (2, 4, 4, 320, 128, 37, 0.0),
    (1, 2, 1, 100, 256, 500, 50.0)])
def test_window_bwd_kernel_matches_plain(gen, b, h, kh, s, d, window,
                                         softcap, dtype, tol):
    """Kernel Gb against its plain version: fp32 within 3e-4 of each
    gradient's own scale, bf16 within 2e-2 relative L2 (kernel G's
    tolerances); at window 1 a row sees one key, so dq and dk are zero but
    for rounding and are held to dv's scale. One call a launch on the route
    ``bwd_route`` names (bf16 at D % 16 == 0: the wgmma route, reading G's
    lse), the same bits twice, outputs in the inputs' dtype. GQA 1 to 8, S
    not a multiple of 64, windows 1, below a tile and past S."""
    args, lse = _window_bwd_inputs(gen, b, h, kh, s, d, window, softcap,
                                   dtype)
    way = bwd_route(dtype, d)
    assert (lse is not None) == (way == "wgmma")
    window_attention_bwd.launches = 0
    window_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
    got = window_attention_bwd(*args, window=window, softcap=softcap,
                               lse=lse)
    again = window_attention_bwd(*args, window=window, softcap=softcap,
                                 lse=lse)
    torch.cuda.synchronize()
    assert window_attention_bwd.launches == 2
    assert window_attention_bwd.launches_by_route[way] == 2
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = window_attention_bwd_plain(*args, window=window, softcap=softcap)
    dv_scale = float(want[2].float().abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        if window == 1 and name != "dv":
            err = float((g - w).abs().max()) / dv_scale
        elif dtype == torch.float32:
            err = float((g - w).abs().max() / w.abs().max())
        else:
            err = float((g - w).norm() / w.norm())
        assert err <= tol, name


def test_window_bwd_kernel_is_deterministic(gen):
    """No atomics: two runs give the same bits, at a GQA shape whose dK and
    dV sum four query heads, on both routes."""
    for dtype in (torch.bfloat16, torch.float32):
        args, lse = _window_bwd_inputs(gen, 2, 8, 2, 320, 128, 100, 50.0,
                                       dtype)
        first = window_attention_bwd(*args, window=100, softcap=50.0,
                                     lse=lse)
        for _ in range(3):
            again = window_attention_bwd(*args, window=100, softcap=50.0,
                                         lse=lse)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_window_attention_backward_launches_kernel_gb(gen):
    """loss.backward() through window_attention on the card runs kernel Gb
    once, on the wgmma route with the lse kernel G saved, and its gradients
    equal a direct window_attention_bwd call with G's lse."""
    (q, k, v, _, dout), lse = _window_bwd_inputs(
        gen, 1, 4, 2, 128, 64, 48, 50.0, torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    window_attention.launches = window_attention_bwd.launches = 0
    window_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
    out = window_attention(*leaves, window=48, blk=32, softcap=50.0)
    out.backward(dout)
    assert window_attention.launches == 1
    assert window_attention_bwd.launches == 1
    assert window_attention_bwd.launches_by_route == {"wgmma": 1, "simt": 0}
    want = window_attention_bwd(q, k, v, out.detach(), dout, window=48,
                                softcap=50.0, lse=lse)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_window_kernels_launch_from_a_fresh_thread(gen):
    """G's and Gb's wgmma routes encode TMA maps, which needs a current
    context: from a thread that has made no CUDA call yet (autograd's
    backward thread can be one) they bind the tensors' device first and
    give the main thread's bits."""
    import threading
    args, lse = _window_bwd_inputs(gen, 1, 4, 2, 128, 64, 48, 50.0,
                                   torch.bfloat16)
    want = (window_attention_with_lse(*args[:3], window=48, blk=1,
                                      softcap=50.0),
            window_attention_bwd(*args, window=48, softcap=50.0, lse=lse))
    got = []

    def run():
        try:
            got.append((window_attention_with_lse(*args[:3], window=48,
                                                  blk=1, softcap=50.0),
                        window_attention_bwd(*args, window=48, softcap=50.0,
                                             lse=lse)))
            torch.cuda.synchronize()
        except Exception as e:               # raised again below
            got.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert len(got) == 1 and not isinstance(got[0], Exception), got
    for g, w in zip(got[0], want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_window_bwd_wrapper_raises_past_head_dim_256(gen):
    q = torch.zeros((1, 2, 32, 264), device="cuda")
    with pytest.raises(ValueError, match="head_dim <= 256"):
        window_attention_bwd(q, q, q, q, q, window=8)
    h = q[..., :8].half()
    with pytest.raises(ValueError, match="one dtype"):
        window_attention_bwd(h, h, h, h, h, window=8)
    # the wgmma route reads G's lse and never recomputes it
    b16 = q[..., :64].bfloat16().contiguous()
    with pytest.raises(ValueError, match="lse residual"):
        window_attention_bwd(b16, b16, b16, b16, b16, window=8)


@pytest.mark.parametrize("b,h,kh,s,d,window,softcap", [
    (2, 8, 2, 256, 64, 100, 50.0), (1, 8, 4, 200, 256, 77, 0.0),
    (1, 4, 1, 130, 128, 1, 50.0), (1, 2, 2, 96, 32, 500, 50.0)])
def test_window_kernel_lse_matches_plain(gen, b, h, kh, s, d, window,
                                         softcap):
    """Kernel G's wgmma route writes each row's log-sum-exp within 1e-4 of
    its plain version's (scores summed in another order, the softcap's
    tanh within ~1e-7), and its o is the same bit for bit with or without
    the lse."""
    q = (torch.randn((b, h, s, d), generator=gen, device="cuda") * 2
         ).bfloat16()
    k = (torch.randn((b, kh, s, d), generator=gen, device="cuda") * 2
         ).bfloat16()
    v = torch.randn((b, kh, s, d), generator=gen, device="cuda").bfloat16()
    assert route(torch.bfloat16, d) == "wgmma"
    out, lse = window_attention_with_lse(q, k, v, window=window, blk=1,
                                         softcap=softcap)
    plain = window_attention(q, k, v, window=window, blk=1, softcap=softcap)
    _, want = window_attention_plain(q, k, v, window=window, blk=1,
                                     softcap=softcap, return_lse=True)
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert float((lse - want).abs().max()) <= 1e-4


def test_gemma_smoke_train_step_runs_g_and_gb(gen):
    """One smoke-width train step on the card: each local layer runs G
    twice (forward and remat's recompute) and Gb once, on the SIMT routes
    (fp32); the loss and the updated params match the same step on the CPU
    (plain versions) within 2e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = get_smoke_config("gemma2-2b")
    opt_cfg = AdamConfig(lr=1e-4, total_steps=8, warmup_steps=1)
    params = M.init_params(cfg, 0)
    params_cpu = _to_cpu(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(cfg, opt_cfg)
    window_attention.launches = window_attention_bwd.launches = 0
    window_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
    m, params, _ = step(params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    n_local = cfg.n_layers // 2
    assert window_attention.launches == 2 * n_local
    assert window_attention_bwd.launches == n_local
    assert window_attention_bwd.launches_by_route == {"wgmma": 0,
                                                      "simt": n_local}
    m_cpu, params_cpu, _ = step(params_cpu, init_opt_state(params_cpu,
                                                           opt_cfg),
                                _to_cpu(batch))
    assert abs(float(m["loss"]) - float(m_cpu["loss"])) <= \
        2e-3 * abs(float(m_cpu["loss"]))
    torch.testing.assert_close(_to_cpu(params), params_cpu, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("e", [8, 128])
def test_moe_dispatch_runs_kernel_a_once_a_call(gen, e):
    """``moe_mlp`` on the card: kernel A scans the expert counts once a
    call, its offsets equal the plain scan's, and the output and aux loss
    equal the same call on the CPU (the plain scan) within 2e-3."""
    from repro_torch.models.moe import init_moe, moe_mlp
    p = init_moe(gen, 64, 96, e, torch.float32, "cuda")
    x = torch.randn((2, 300, 64), generator=gen, device="cuda")
    prefix_sum.launches = 0
    moe_mlp.log = []
    out, aux = moe_mlp(x, p, top_k=2, capacity_factor=1.25)
    torch.cuda.synchronize()
    [r], moe_mlp.log = moe_mlp.log, None
    assert prefix_sum.launches == 1
    assert torch.equal(r.offsets, plain_prefix.exclusive_prefix_sum(
        r.counts, scan=plain_prefix.paper_prefix_sum))
    want, want_aux = moe_mlp(x.cpu(), _to_cpu(p), top_k=2,
                             capacity_factor=1.25)
    torch.testing.assert_close(out.cpu(), want, rtol=2e-3, atol=2e-3)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_smoke_prefill_and_decode_launch_kernel_a(gen, arch):
    """The MoE smoke configs on the card: kernel A once a layer in the
    prefill and in a decode step; the logits and the KV cache equal the
    CPU's within 2e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device="cuda")
    prefix_sum.launches = 0
    logits, cache = M.prefill(cfg, params, tokens[:, :32], max_len=33)
    torch.cuda.synchronize()
    assert prefix_sum.launches == cfg.n_layers
    lg, cache = M.decode_step(cfg, params, cache, tokens[:, 32:], 32)
    torch.cuda.synchronize()
    assert prefix_sum.launches == 2 * cfg.n_layers
    params_cpu = _to_cpu(params)
    want, cache_cpu = M.prefill(cfg, params_cpu, tokens[:, :32].cpu(),
                                max_len=33)
    want_lg, cache_cpu = M.decode_step(cfg, params_cpu, cache_cpu,
                                       tokens[:, 32:].cpu(), 32)
    torch.testing.assert_close(logits.cpu(), want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(lg.cpu(), want_lg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(cache["k"].cpu(), cache_cpu["k"], rtol=2e-3,
                               atol=2e-3)


def test_moe_smoke_train_step_runs_kernel_a_twice_a_layer(gen):
    """grok-1-314b's smoke train step on the card: kernel A twice a layer
    (the forward and remat's recompute); the loss, the aux loss and the
    updated params equal the CPU step's within 2e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = get_smoke_config("grok-1-314b")
    opt_cfg = AdamConfig(lr=1e-4, total_steps=8, warmup_steps=1)
    params = M.init_params(cfg, 0)
    params_cpu = _to_cpu(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = make_train_step(cfg, opt_cfg)
    prefix_sum.launches = 0
    m, params, _ = step(params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    assert prefix_sum.launches == 2 * cfg.n_layers
    m_cpu, params_cpu, _ = step(params_cpu, init_opt_state(params_cpu,
                                                           opt_cfg),
                                _to_cpu(batch))
    for k in ("loss", "aux"):
        assert abs(float(m[k]) - float(m_cpu[k])) <= \
            2e-3 * abs(float(m_cpu[k])), k
    torch.testing.assert_close(_to_cpu(params), params_cpu, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_smoke_generate_on_the_card_matches_cpu(gen, arch):
    """The SSM and hybrid smoke configs: ``generate`` (the prompt replayed
    through decode steps) on the card launches no kernel; its prefill
    logits equal the CPU's within 2e-3 and a no-cache forward's last
    logits equal the replay's within 2e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.serving import generate
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen,
                           device="cuda")
    prefix_sum.launches = window_attention.launches = 0
    tokens, logits = generate(cfg, params, prompt, 4)
    torch.cuda.synchronize()
    assert prefix_sum.launches == window_attention.launches == 0
    _, want = generate(cfg, _to_cpu(params), prompt.cpu(), 4)
    torch.testing.assert_close(logits.cpu(), want, rtol=2e-3, atol=2e-3)
    cache = M.init_cache(cfg, 2, 21)
    for t in range(20):
        lg, cache = M.decode_step(cfg, params, cache, prompt[:, t:t + 1], t)
    torch.testing.assert_close(lg[:, 0], logits[:, -1], rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(lg.argmax(-1), tokens[:, :1])


def test_bf16_smoke_train_step_takes_the_wgmma_routes(gen):
    """The smoke-width model in bf16 (head_dim 16): a train step runs every
    local layer's G twice and its Gb once, all on the wgmma routes, with a
    finite loss and gradient norm."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.optim import AdamConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(get_smoke_config("gemma2-2b"), dtype="bfloat16")
    opt_cfg = AdamConfig(lr=1e-4, total_steps=8, warmup_steps=1)
    params = M.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    window_attention.launches_by_route = {"wgmma": 0, "simt": 0}
    window_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
    m, _, _ = make_train_step(cfg, opt_cfg)(
        params, init_opt_state(params, opt_cfg), batch)
    torch.cuda.synchronize()
    n_local = cfg.n_layers // 2
    assert window_attention.launches_by_route == {"wgmma": 2 * n_local,
                                                  "simt": 0}
    assert window_attention_bwd.launches_by_route == {"wgmma": n_local,
                                                      "simt": 0}
    assert all(math.isfinite(float(m[key])) for key in ("loss",
                                                         "grad_norm"))


def test_batch_at_same_tokens_on_cpu_and_card(gen):
    """The token stream does not depend on the device: batch_at on the card
    equals batch_at on the CPU, so a run resumed on the other device trains
    on the same tokens."""
    from repro_torch.data import DataConfig, batch_at
    data = DataConfig(vocab_size=50_000, seq_len=257, global_batch=4,
                      stream_id=3)
    for step, host, n_hosts in ((0, 0, 1), (7, 1, 2)):
        cpu = batch_at(data, step, host, n_hosts, device="cpu")
        card = batch_at(data, step, host, n_hosts, device="cuda")
        assert all(c.device.type == "cuda" for c in card)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


# -- stacked systems: one launch a batch, each system as if launched alone --

def _stacked_scene(gen, periodic, b=3, n=200, ncells=(5, 4, 3)):
    """B uniform systems with a fifth of their rows padding, system 1
    padding throughout."""
    dom = Domain(box=tuple(float(v) for v in ncells), ncells=ncells,
                 cutoff=1.0, periodic=periodic)
    pos = torch.stack([dom.sample_uniform(n, generator=gen, device="cuda")
                       for _ in range(b)])
    valid = torch.rand((b, n), generator=gen, device="cuda") > 0.2
    valid[1] = False
    return dom, ParticleState(pos, valid=valid)


BATCH_WRAPPERS = {"B": xpencil_forces, "C": xpencil_sparse_forces,
                  "D": xpencil_packed_forces, "E": allin_forces,
                  "F": cell_sfc_forces, "pack": pack_slots}


def _kernel_outputs(which, dom, bins, kern, plain=False, **kw):
    """Kernel ``which`` (or its plain version) on one system's or stacked
    ``bins``, the layout it reads built from them -> its outputs."""
    nx, ny, nz = dom.ncells
    m_c = bins.m_c
    xyz = (bins.planes["x"], bins.planes["y"], bins.planes["z"])
    args = dict(kernel=kern, cutoff2=1.0)
    if which == "B":
        if plain:
            return S.xpencil_planes(*xyz, bins.slot_id, nx=nx, m_c=m_c, **args)
        return xpencil_forces(bins.planes, bins.slot_id, nx=nx, m_c=m_c,
                              **args, **kw)
    if which == "C":
        act = pencil_occupancy(dom, bins.counts, nz * ny - 2).active
        if plain:
            return S.xpencil_sparse_planes(*xyz, bins.slot_id, act, nx=nx,
                                           ny=ny, m_c=m_c, **args)
        return xpencil_sparse_forces(bins.planes, bins.slot_id, act, nx=nx,
                                     ny=ny, m_c=m_c, **args, **kw)
    if which == "D":
        pk = pack_rows(dom, bins, 40)
        act = pencil_occupancy(dom, bins.counts, nz * ny - 2).active
        parts = (pk.slot_id, pk.slot_cell, pk.cell_offsets, act)
        if plain:
            return S.xpencil_packed_planes(pk.planes["x"], pk.planes["y"],
                                           pk.planes["z"], *parts, nx=nx,
                                           ny=ny, m_c=m_c, **args)
        return xpencil_packed_forces(pk.planes, *parts, nx=nx, ny=ny,
                                     m_c=m_c, **args, **kw)
    if which == "E":
        box = (1, 2, 3)
        if plain:
            return S.allin_planes(*xyz, bins.slot_id, box=box, m_c=m_c,
                                  **args)
        return allin_forces(bins.planes, bins.slot_id, box=box, m_c=m_c,
                            **args, **kw)
    if which == "F":
        sfc = build_sfc_clusters(dom, bins, 27 * sfc_n_clusters(dom))
        tgt, src = sfc_device_slot_tables(dom, m_c, sfc.csize, sfc.curve,
                                          bins.slot_id.device)
        if plain:
            return S.cell_sfc_tiles(*xyz, bins.slot_id, sfc.codes, tgt, src,
                                    m_c=m_c, **args)
        return cell_sfc_forces(bins.planes, bins.slot_id, sfc.codes, tgt, src,
                               m_c=m_c, **args, **kw)
    fn = pack_slots_plain if plain else pack_slots
    planes, *rest = fn(bins, nx=nx, ny=ny, row_cap=40)
    return (*planes.values(), *rest)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("which", sorted(BATCH_WRAPPERS))
def test_batched_kernel_matches_plain_and_single_launches(gen, periodic,
                                                          which):
    """One launch for three systems (one of them all padding), within
    1e-4 of the batched plain version (the pack kernel: equal) and equal
    bit for bit, system by system, to a launch on that system alone."""
    dom, states = _stacked_scene(gen, periodic)
    bins = bin_particles(dom, states.positions, m_c=24, valid=states.valid)
    kern = make_low_flop()
    wrapper = BATCH_WRAPPERS[which]
    wrapper.launches = 0
    got = _kernel_outputs(which, dom, bins, kern)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    want = _kernel_outputs(which, dom, bins, kern, plain=True)
    for g, w in zip(got, want, strict=True):
        assert g.shape[0] == 3 and g.shape == w.shape
        if which == "pack":
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
            assert not bool(g[1].any())        # the all-padding system
    for i in range(3):
        one = _kernel_outputs(which, dom, system(bins, i), kern)
        for g, o in zip(got, one, strict=True):
            assert torch.equal(g[i], o), (which, i)


@pytest.mark.parametrize("periodic", [False, True])
def test_packed_kernel_tiles_across_a_system_boundary(gen, periodic):
    """Every tile that fits, most of which do not divide a system's 12 rows
    (a tiling of the flat batch list would put those across two systems),
    over every row and over active lists: each system's rows equal a
    launch on that system alone."""
    dom, states = _stacked_scene(gen, periodic, b=4)
    bins = bin_particles(dom, states.positions, m_c=24, valid=states.valid)
    pk = pack_rows(dom, bins, 40)
    kern = make_low_flop()
    for act in (None, pencil_occupancy(dom, bins.counts, 10).active):
        kw = dict(nx=5, ny=4, m_c=24, kernel=kern, cutoff2=1.0)
        alone = [xpencil_packed_forces(
            system(pk, i).planes, system(pk, i).slot_id,
            system(pk, i).slot_cell, system(pk, i).cell_offsets,
            None if act is None else act[i], **kw) for i in range(4)]
        for r in range(MAX_TILE_ROWS + 1):
            if packed_smem_bytes(r, 40) > MAX_SMEM:
                continue
            got = xpencil_packed_forces(pk.planes, pk.slot_id, pk.slot_cell,
                                        pk.cell_offsets, act, tile_rows=r,
                                        **kw)
            for i in range(4):
                assert all(torch.equal(g[i], w)
                           for g, w in zip(got, alone[i])), (r, i)


def _covering_plan(dom, states, **kw):
    each = [system(states, b) for b in range(states.positions.shape[0])]
    p = plan(dom, positions=each[0].positions, **kw)
    grown = True
    while grown:
        grown = False
        for st in each:
            while p.check_overflow(st):
                p, grown = p.replan(st), True
    return p


@pytest.mark.parametrize("periodic", [False, True])
def test_execute_batch_launches_once_and_equals_loop(gen, periodic):
    """Every "cuda" path: one launch of its kernels for four systems
    (kernel A once, in the binning), each system's result equal bit for bit to
    ``execute`` on it alone, the all-padding system's 0."""
    dom, states = _stacked_scene(gen, periodic, b=4, n=300)
    counters = (prefix_sum, pack_slots, xpencil_forces, xpencil_sparse_forces,
                xpencil_packed_forces, allin_forces, cell_sfc_forces)
    for kw, want in (
            (dict(strategy="xpencil"), {"prefix_sum": 1,
                                        "xpencil_forces": 1}),
            (dict(strategy="xpencil", compact=True),
             {"prefix_sum": 1, "xpencil_sparse_forces": 1}),
            (dict(strategy="xpencil", layout="packed"),
             {"prefix_sum": 1, "pack_slots": 1, "xpencil_packed_forces": 1}),
            (dict(strategy="xpencil", layout="packed", compact=True),
             {"prefix_sum": 1, "pack_slots": 1, "xpencil_packed_forces": 1}),
            (dict(strategy="allin"), {"prefix_sum": 1, "allin_forces": 1}),
            (dict(strategy="cell_dense", layout="sfc"),
             {"prefix_sum": 1, "cell_sfc_forces": 1})):
        p = _covering_plan(dom, states, **kw)
        for c in counters:
            c.launches = 0
        fb, ub = p.execute_batch(states)
        torch.cuda.synchronize()
        assert {c.__name__: c.launches for c in counters if c.launches} \
            == want, kw
        for i in range(4):
            f, u = p.execute(system(states, i))
            assert torch.equal(fb[i], f) and torch.equal(ub[i], u), (kw, i)
        assert not bool(fb[1].any()) and bool(fb[0].isfinite().all())


def test_wrappers_refuse_two_leading_axes(gen):
    plane = torch.zeros((2, 2, 3, 3, 24), device="cuda")
    with pytest.raises(ValueError, match="stacked on a leading axis"):
        xpencil_forces({"x": plane, "y": plane, "z": plane},
                       plane.to(torch.int32), nx=1, m_c=8,
                       kernel=make_low_flop(), cutoff2=1.0)


# ---------------------------------------------------------------------------
# plan.trajectory on the card (repro_torch.traj)
# ---------------------------------------------------------------------------

def _traj_scene(gen, division=8):
    """4 particles a cell on a jittered FCC lattice (chip_smoke.py's
    trajectory scene, smaller): uniform draws put pairs deep in LJ's core,
    whose kick the skin monitor rightly reports."""
    dom = Domain.cubic(division, periodic=True)
    basis = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                          [0.0, 0.5, 0.5]], device="cuda") + 0.25
    idx = torch.arange(division, device="cuda", dtype=torch.float32)
    cz, cy, cx = torch.meshgrid(idx, idx, idx, indexing="ij")
    pos = (torch.stack([cx, cy, cz], -1).reshape(-1, 1, 3) + basis).reshape(
        -1, 3)
    pos = pos + 0.05 * (2 * torch.rand(pos.shape, generator=gen,
                                       device="cuda") - 1)
    vel = 0.1 * torch.randn(pos.shape, generator=gen, device="cuda")
    return dom, pos, vel, make_lennard_jones(sigma=0.3, eps=1e-4)


def _md_equal(a, b, what):
    for f in ("positions", "velocities", "forces", "potential"):
        assert torch.equal(getattr(a, f), getattr(b, f)), (what, f)


@pytest.mark.parametrize("kw,kernels", [
    (dict(strategy="xpencil"), (xpencil_forces,)),
    (dict(strategy="xpencil", layout="packed"),
     (pack_slots, xpencil_packed_forces)),
    (dict(strategy="xpencil", compact=True), (xpencil_sparse_forces,)),
    (dict(strategy="allin"), (allin_forces,)),
], ids=["dense", "packed", "compact", "allin"])
@pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog"])
def test_trajectory_skin0_equals_reference_loop(gen, kw, kernels,
                                                integrator):
    """skin=0 on the card: the trajectory equals a loop of
    ``reference_step`` (one ``execute()`` a step) bit for bit, and launches
    the path's kernels every step and kernel A on every rebin."""
    from repro_torch.physics import init_state
    from repro_torch.traj import reference_step
    dom, pos, vel, kern = _traj_scene(gen)
    p = plan(dom, kern, positions=pos, **kw)
    md0 = init_state(p, pos, vel)
    for k in (prefix_sum, *kernels):
        k.launches = 0
    res = p.trajectory(md0, 16, 1e-3, integrator=integrator, skin=0.0,
                       segment_len=8)
    torch.cuda.synchronize()
    assert res.status == "ok" and res.rebins == 16
    assert all(k.launches >= 16 for k in (prefix_sum, *kernels))
    step = reference_step(p, integrator=integrator)
    md = md0
    for _ in range(16):
        md = step(md, 1e-3)
    _md_equal(res.state, md, kw)


@pytest.mark.parametrize("kw,integ", [
    (dict(strategy="xpencil"), {}),
    (dict(strategy="xpencil", layout="packed"), {}),
    (dict(strategy="xpencil"), dict(integrator="langevin", gamma=0.1,
                                    kT=1e-3)),
], ids=["dense", "packed", "langevin"])
def test_trajectory_resume_bit_identical(gen, tmp_path, kw, integ):
    """Stopped at 16 of 32 steps and resumed from its checkpoint on the
    card: bit-equal to the uninterrupted run; dense = packed."""
    from repro_torch.physics import init_state
    dom, pos, vel, kern = _traj_scene(gen)
    p = plan(dom, kern, positions=pos, **kw)
    md0 = init_state(p, pos, vel)
    opts = dict(skin=0.25, segment_len=8, checkpoint_every=8, seed=3,
                **integ)
    full = p.trajectory(md0, 32, 1e-3, **opts)
    part = p.trajectory(md0, 16, 1e-3, checkpoint_dir=tmp_path, **opts)
    assert part.checkpoints == 2
    res = p.trajectory(md0, 32, 1e-3, checkpoint_dir=tmp_path, **opts)
    assert res.resumed_from == 16 and res.status == "ok"
    _md_equal(res.state, full.state, kw)
    if not integ:
        dense = plan(dom, kern, m_c=p.m_c, strategy="xpencil").trajectory(
            md0, 32, 1e-3, **opts)
        _md_equal(full.state, dense.state, "packed vs dense")


def _own_scale_err(got, want):
    """max |got - want| / max |want|: relative to the quantity's own size,
    with no floor, so a velocity of 1e-5 is held to its own digits."""
    scale = float(want.abs().max())
    assert scale > 0
    return float((got.double() - want.double()).abs().max()) / scale


def test_sph_step_on_card_matches_reference(gen):
    """``sph_step`` through kernel B (the density, then the pressure
    kernel's scaled coefficient, ``PairParams.p2``) against the reference
    backend on the same card: density and velocities within 1e-4 of their
    own scale, and the pressure force per particle within 1e-4 of its own
    term sizes, so a zero, flipped or mis-scaled ``p2`` fails."""
    from repro_torch.physics import sph
    dom = Domain.cubic(8, periodic=True)
    pos = dom.sample_uniform(8 ** 3 * 10, generator=gen, device="cuda")
    m_c = suggest_m_c(dom, pos)
    params = sph.SPHParams(h=1.0)
    vel = torch.zeros_like(pos)
    xpencil_forces.launches = 0
    got = sph.sph_step(dom, pos, vel, params, m_c, dt=1e-3)
    assert xpencil_forces.launches == 2
    want = sph.sph_step(dom, pos, vel, params, m_c, dt=1e-3,
                        backend="reference")
    scale = max(float(want[0].abs().max()), 1.0)
    assert float((got[0] - want[0]).abs().max()) <= 3e-4 * scale
    assert _own_scale_err(got[1], want[1]) <= 1e-4
    assert _own_scale_err(got[2], want[2]) <= 1e-4
    kern = sph.make_pressure_kernel(params, float(params.rho0), 1.0)
    fp = plan(dom, kern, m_c=m_c, strategy="xpencil")
    state = ParticleState(pos)
    f, _ = fp.execute(state)
    ref = dataclasses.replace(fp, backend="reference")
    rf, _ = ref.execute(state)
    fsize = dataclasses.replace(ref, kernel=_term_sizes(kern)[0]).execute(
        state)[1]
    _term_close(f, rf, fsize[:, None], "sph pressure force")
    assert float(rf.abs().max()) > 0                 # premise: a force


def test_trajectory_ladder_stays_on_the_kernels(gen, monkeypatch):
    """A card plan's degradation ladder keeps the ``"cuda"`` backend on
    every rung; a trajectory that breaches on every segment steps down the
    kernel rungs and ends ``"failed"`` without a segment on the reference
    backend. Every force evaluation's plan is recorded (the executors'
    ``forces``), whether its executor was cached or built."""
    from repro_torch.core import api, degradation_ladder, reset_health
    from repro_torch.physics import init_state
    from repro_torch.testing import chaos
    dom, pos, vel, kern = _traj_scene(gen)
    p = plan(dom, kern, positions=pos, strategy="xpencil", layout="packed",
             compact=True)
    rungs = degradation_ladder(p)
    assert [(r.backend, r.layout, r.compact) for r in rungs] == [
        ("cuda", "packed", True), ("cuda", "dense", True),
        ("cuda", "dense", False)]
    used = []
    real = api._Executor.forces

    def spy(self, bins, states):
        used.append((self.plan.backend, self.plan.layout, self.plan.compact))
        return real(self, bins, states)
    monkeypatch.setattr(api._Executor, "forces", spy)
    md0 = init_state(p, pos, vel)
    reset_health()
    with chaos.inject(chaos.FaultSpec("traj.step", "nonfinite", p=1.0)):
        res = p.trajectory(md0, 16, 1e-3, segment_len=4, max_rollbacks=8)
    reset_health()
    assert res.status == "failed" and res.rollbacks == 9
    assert res.ladder_level == len(rungs) - 1
    assert set(used) == {(r.backend, r.layout, r.compact) for r in rungs}


def test_naive_n2_plan_on_the_card_runs_the_oracle(gen):
    """A ``naive_n2`` plan on the card (default backend ``"cuda"``) runs the
    O(N^2) oracle through its executor, alone and batched, launching no
    kernel; tuning over that strategy on the card returns such a plan."""
    from repro_torch.core import make_lennard_jones, tune
    dom = Domain.cubic(6, cutoff=1.0)
    pos = dom.sample_uniform(800, generator=gen, device="cuda")
    p = plan(dom, positions=pos, strategy="naive_n2")
    assert (p.backend, p.device.type) == ("cuda", "cuda")
    fx, fy, fz, pot = S.naive_n2(dom, pos, p.kernel)
    prefix_sum.launches = 0
    f, u = p.execute(ParticleState(pos))
    assert torch.equal(f, torch.stack([fx, fy, fz], dim=-1))
    assert torch.equal(u, pot)
    fb, ub = p.execute_batch(ParticleState(torch.stack([pos, pos])))
    assert torch.equal(fb[1], f) and torch.equal(ub[1], u)
    assert prefix_sum.launches == 0
    res = tune(dom, make_lennard_jones(), pos, backends=("cuda",),
               strategies=("naive_n2",), budget_s=0.01, use_cache=False)
    assert res.plan.strategy == "naive_n2" and res.plan.backend == "cuda"
    assert torch.equal(res.plan.execute(ParticleState(pos))[0], f)


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------

def _serve_requests(gen, dom, sizes):
    """Requests made on the host, as a front door receives them."""
    g = torch.Generator().manual_seed(int(torch.randint(
        1 << 30, (1,), generator=gen, device="cuda")))
    return [ParticleState(dom.sample_uniform(n, generator=g, device="cpu"))
            for n in sizes]


@pytest.mark.parametrize("opts", [
    {}, {"strategy": "xpencil"}, {"strategy": "xpencil", "compact": True},
    {"strategy": "xpencil", "layout": "packed"},
    {"strategy": "cell_dense", "layout": "sfc"},
])
def test_engine_on_the_card_equals_execute_and_warms(gen, opts):
    from repro_torch.core import api, recompile_count
    from repro_torch.serve import ServingEngine, classify
    dom = Domain.cubic(8, cutoff=1.0)
    eng = ServingEngine(max_batch=4, max_wait=0.0, plan_opts=opts)
    reqs = _serve_requests(gen, dom, [2000, 1500, 1100, 1800, 600, 900])
    for rnd in range(2):
        if rnd:
            rc0 = recompile_count()
        ids = [(eng.submit(dom, st), st) for st in reqs]
        eng.flush()
        resp = {r.req_id: r for r in eng.take_responses()}
        for rid, st in ids:
            r = resp[rid]
            assert r.status == "ok" and r.forces.is_cuda
            p = eng.class_plan(classify(dom, eng.kernel, st.n, ()))
            assert p.backend == "cuda" and p.device.type == "cuda"
            f, u = p.execute(ParticleState(st.positions.cuda()))
            assert torch.equal(r.forces, f) and torch.equal(r.potential, u)
    assert recompile_count() == rc0          # the second round built nothing
    assert api.executor_cache_info()["batch"].currsize >= 1


def test_quarantine_on_the_card_stays_on_the_kernels(gen):
    from repro_torch.core import api
    from repro_torch.serve import ServingEngine, classify
    from repro_torch.testing import chaos
    dom = Domain.cubic(8, cutoff=1.0)
    eng = ServingEngine(max_batch=1, max_wait=0.0, max_retries=0,
                        breaker_threshold=2, breaker_recovery=100,
                        plan_opts={"strategy": "xpencil",
                                   "layout": "packed", "compact": True})
    reqs = _serve_requests(gen, dom, [1500, 1400, 1300])
    sc = classify(dom, eng.kernel, 1500, ())
    with chaos.inject(chaos.FaultSpec("serve.dispatch", "error",
                                      max_fires=2)):
        for st in reqs[:2]:
            eng.submit(dom, st)
            eng.flush()
    primary, quarantined = eng.class_primary(sc), eng.class_plan(sc)
    assert eng.class_breaker(sc).open
    assert quarantined == api.fallback_plan(primary)
    assert (quarantined.backend, quarantined.layout,
            quarantined.compact) == ("cuda", "dense", False)
    eng.submit(dom, reqs[2])
    eng.flush()
    r = eng.take_responses()[-1]
    assert r.status == "ok"
    f, u = primary.execute(ParticleState(reqs[2].positions.cuda()))
    assert torch.equal(r.forces, f) and torch.equal(r.potential, u)


def test_execute_checked_on_the_card(gen):
    from repro_torch.testing import chaos
    dom = Domain.cubic(8, cutoff=1.0)
    pos = dom.sample_uniform(2000, generator=gen, device="cuda")
    state = ParticleState(pos)
    p = plan(dom, positions=pos, strategy="xpencil", layout="packed")
    want = p.execute(state)
    (f, u), report = p.execute_checked(state)
    assert report.status == "ok" and report.backend == "cuda"
    assert torch.equal(f, want[0]) and torch.equal(u, want[1])
    with chaos.inject(chaos.FaultSpec("core.dispatch", "nonfinite",
                                      max_fires=1)):
        (f, u), report = p.execute_checked(state)
    assert report.nonfinite == 1 and report.retries == 1
    assert torch.equal(f, want[0]) and torch.equal(u, want[1])


# ---------------------------------------------------------------------------
# the halo engine: Z-slab shards stacked on the card's system axis
# ---------------------------------------------------------------------------

HALO_OPTS = [dict(strategy="xpencil"),
             dict(strategy="xpencil", compact=True),
             dict(strategy="xpencil", layout="packed", compact=True),
             dict(strategy="allin"),
             dict(strategy="cell_dense", layout="sfc")]


def _halo_forces(p, data, kern):
    """The force kernel of halo plan ``p``'s path on its stacked shards, and
    its plain version on each shard alone (stacked)."""
    dom = slab_of(p)
    kw = dict(m_c=p.m_c, kernel=kern, cutoff2=1.0)
    n_sys = p.n_shards
    if p.layout == "packed":
        act = (pencil_occupancy(dom, data.counts, p.max_active).active
               if p.compact else None)
        rows = (full_pencil_occupancy(dom, data.counts.device).active.expand(
            n_sys, -1) if act is None else act)
        got = xpencil_packed_forces(data.planes, data.slot_id, data.slot_cell,
                                    data.cell_offsets, act, nx=dom.nx,
                                    ny=dom.ny, **kw)
        want = [S.xpencil_packed_planes(
            q.planes["x"], q.planes["y"], q.planes["z"], q.slot_id,
            q.slot_cell, q.cell_offsets, rows[i], nx=dom.nx, ny=dom.ny, **kw)
            for i, q in ((i, system(data, i)) for i in range(n_sys))]
    elif p.layout == "sfc":
        bins = data.bins
        tgt, src = sfc_device_slot_tables(dom, p.m_c, data.csize, data.curve,
                                          bins.slot_id.device)
        got = cell_sfc_forces(bins.planes, bins.slot_id, data.codes, tgt, src,
                              **kw)
        want = [S.cell_sfc_tiles(
            b.planes["x"], b.planes["y"], b.planes["z"], b.slot_id, c.codes,
            tgt, src, **kw)
            for b, c in ((system(bins, i), system(data, i))
                         for i in range(n_sys))]
    elif p.strategy == "allin":
        got = allin_forces(data.planes, data.slot_id, box=p.box, **kw)
        want = [S.allin_planes(b.planes["x"], b.planes["y"], b.planes["z"],
                               b.slot_id, box=p.box, **kw)
                for b in (system(data, i) for i in range(n_sys))]
    elif p.compact:
        act = pencil_occupancy(dom, data.counts, p.max_active).active
        got = xpencil_sparse_forces(data.planes, data.slot_id, act, nx=dom.nx,
                                    ny=dom.ny, **kw)
        want = [S.xpencil_sparse_planes(
            b.planes["x"], b.planes["y"], b.planes["z"], b.slot_id, act[i],
            nx=dom.nx, ny=dom.ny, **kw)
            for i, b in ((i, system(data, i)) for i in range(n_sys))]
    else:
        got = xpencil_forces(data.planes, data.slot_id, nx=dom.nx, **kw)
        want = [S.xpencil_planes(b.planes["x"], b.planes["y"], b.planes["z"],
                                 b.slot_id, nx=dom.nx, **kw)
                for b in (system(data, i) for i in range(n_sys))]
    return got, tuple(torch.stack(w) for w in zip(*want))


def slab_of(p):
    from repro_torch.core.domain import slab_domain
    return slab_domain(p.domain, p.n_shards)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("opts", HALO_OPTS,
                         ids=["dense", "compact", "packed", "allin", "sfc"])
def test_halo_plan_on_the_card_matches_one_device_and_plain(gen, periodic,
                                                            opts):
    """A 4-shard halo plan on the card against the same strategy's
    one-device plan (scale-relative 3e-4) with the same launches, and its
    force kernel on the stacked shards against the plain version on each
    shard."""
    from repro_torch.dist.engine import halo_impl
    dom = Domain.cubic(16, cutoff=1.0, periodic=periodic)
    pos = dom.sample_uniform(16 ** 3 * 4, generator=gen, device="cuda")
    state = ParticleState(pos)
    kern = make_lennard_jones()
    p1 = plan(dom, kern, positions=pos, **opts)
    ph = plan(dom, kern, positions=pos, m_c=p1.m_c, backend="halo",
              n_shards=4, **opts)
    f1, u1 = p1.execute(state)
    f, u = ph.execute(state)
    for g, w in ((f, f1), (u, u1)):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) / scale <= 3e-4
    data, inner = halo_impl(ph).layout(ParticleState(pos[None]))
    assert inner.backend == "cuda"
    got, want = _halo_forces(ph, data, kern)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) / scale <= 3e-4


def test_halo_paths_on_the_card_are_bit_equal_and_batch_equals_loop(gen):
    dom = Domain.cubic(16, cutoff=1.0)
    pos = dom.sample_uniform(16 ** 3 * 4, generator=gen, device="cuda")
    state = ParticleState(pos)
    kern = make_lennard_jones()
    pd = plan(dom, kern, positions=pos, backend="halo", n_shards=4,
              strategy="xpencil")
    want = pd.execute(state)
    for opts in HALO_OPTS[1:3]:
        got = plan(dom, kern, positions=pos, m_c=pd.m_c, backend="halo",
                   n_shards=4, **opts).execute(state)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    stack = torch.stack([pos, pos.flip(0)])
    fb, ub = pd.execute_batch(ParticleState(stack))
    for i in range(2):
        fi, ui = pd.execute(ParticleState(stack[i]))
        assert torch.equal(fb[i], fi) and torch.equal(ub[i], ui)
    xpencil_forces.launches = 0
    pd.execute_batch(ParticleState(stack))
    torch.cuda.synchronize()
    assert xpencil_forces.launches == 1


def test_halo_shard_loss_on_the_card_shrinks(gen):
    from repro_torch.testing import chaos
    dom = Domain.cubic(16, cutoff=1.0, periodic=True)
    pos = dom.sample_uniform(16 ** 3 * 4, generator=gen, device="cuda")
    state = ParticleState(pos)
    p = plan(dom, make_lennard_jones(), positions=pos, backend="halo",
             n_shards=4, strategy="xpencil", layout="packed")
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = p.execute_checked(state)
    assert report.shard_shrinks == 1 and report.plan.n_shards == 2
    assert report.plan.halo_inner == "cuda"
    got = report.plan.execute(state)
    assert torch.equal(f, got[0]) and torch.equal(u, got[1])
    assert all(r.halo_inner == "cuda" for r in degradation_ladder(p))


def test_halo_sfc_shard_loss_on_the_card_covers_its_pairs(gen):
    """The sfc plan's shrink re-measures its per-shard ``pair_cap``: 2 slabs
    each hold about twice the cluster pairs of 4."""
    from repro_torch.core import cell_counts
    from repro_torch.dist.engine import shard_sfc_pairs
    from repro_torch.testing import chaos
    dom = Domain.cubic(16, cutoff=1.0)
    pos = dom.sample_uniform(16 ** 3 * 4, generator=gen, device="cuda")
    state = ParticleState(pos)
    kw = dict(positions=pos, strategy="cell_dense", layout="sfc")
    p1 = plan(dom, make_lennard_jones(), **kw)
    p = plan(dom, make_lennard_jones(), m_c=p1.m_c, backend="halo",
             n_shards=4, **kw)
    with chaos.inject(chaos.FaultSpec("dist.exchange", "shard_loss",
                                      max_fires=1)):
        (f, u), report = p.execute_checked(state)
    q = report.plan
    assert report.shard_shrinks == 1 and q.n_shards == 2
    assert q.pair_cap >= max(shard_sfc_pairs(dom, cell_counts(dom, pos), 2))
    f1, u1 = p1.execute(state)
    scale = max(float(f1.abs().max()), 1.0)
    assert float((f - f1).abs().max()) / scale <= 3e-4
    assert float((u - u1).abs().max()) / max(float(u1.abs().max()),
                                             1.0) <= 3e-4
