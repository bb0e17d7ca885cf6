"""Kernel D's tiles and the pack kernel's contract, on the CPU.

Kernel D takes a tile of ``packed_tile_rows(row_cap, n_rows)`` pencils,
split into blocks of ``packed_split`` targets, its shared memory
``packed_smem_bytes``; all three are written twice, in
``kernels/xpencil.py`` and in ``csrc/xpencil.cu``, and checked here against
each other, as ``test_torch_xpencil_chunks.py`` checks B's chunk width.

The pack kernel (``kernels/pack.py::pack_slots``, ``csrc/pack.cu``) is all
of ``pack_rows``; on CPU tensors its wrapper runs the plain version, held
here against JAX's ``pack_rows`` on every output, on the bins of every
producer (``bin_particles`` with and without ``valid``, stacked systems,
``refresh_bins``, the halo's shards with offset slot ids). The kernel
gathers where JAX scatters: a Python mirror of its indexing (the search of
each packed position in the row's offsets, then slot ``c * m_c + r``) must
equal the scatters, and every producer must leave each cell's particles in
its first slots, the precondition under which the two agree. The kernels
themselves run in ``test_torch_cuda.py`` on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.core.binning import CellBins as JCellBins
from repro.core.binning import pack_rows as j_pack_rows
from repro_torch.convert import domain_from_jax
from repro_torch.core import (Domain, ParticleState, bin_particles,
                              make_low_flop, pack_rows, plan, suggest_m_c,
                              suggest_row_cap)
from repro_torch.core.binning import (EMPTY_POS, CellBins, pack_slots_plain,
                                      refresh_bins, system)
from repro_torch.dist import engine as E
from repro_torch.kernels import pack as PK
from repro_torch.kernels import xpencil as XP
from repro_torch.kernels._common import MAX_SMEM
from test_torch_sparse import blob

_J_PACK = jax.jit(j_pack_rows, static_argnames=("domain", "row_cap"))

CSRC = pathlib.Path(XP.__file__).resolve().parent / "csrc"
XPENCIL_CU = (CSRC / "xpencil.cu").read_text()
PACK_CU = (CSRC / "pack.cu").read_text()


def _const(source, name, env=None):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", source)
    assert m, name
    text = m.group(1).replace("true", "True").replace("false", "False")
    return eval(text, dict(env or {}))


def _body(source, head):
    """The normalised body of the C function whose signature ends in
    ``head``."""
    m = re.search(re.escape(head) + r" \{(.*?)\n\}", source, re.S)
    assert m, head
    return re.sub(r"\s+", " ", m.group(1)).strip()


def test_packed_smem_counts_the_layout():
    # mbarriers, two buffers of x, y, z, id over tile_rows + 2 rows and the
    # block's sums; one row of one buffer at tile_rows 0
    assert XP.packed_smem_bytes(6, 392) == (16 + 2 * 16 * 8 * 392
                                            + 16 * 768) == 112656
    assert XP.packed_smem_bytes(0, 392) == 16 * 392
    assert XP.packed_smem_bytes(0, XP.MAX_ROW_CAP) == MAX_SMEM
    assert XP.MAX_ROW_CAP == 14528          # the limit of the first kernel D
    assert XP.packed_smem_bytes(1, 2293) <= MAX_SMEM < XP.packed_smem_bytes(
        1, 2294)


@pytest.mark.parametrize("tile_rows,row_cap,want", [
    (6, 392, 588), (2, 656, 656), (1, 700, 700), (1, 1000, 500),
    (32, 8, 256), (0, 392, 196), (0, 14528, 383), (0, 384, 384)])
def test_packed_split(tile_rows, row_cap, want):
    split = XP.packed_split(tile_rows, row_cap)
    assert split == want
    slots = max(tile_rows, 1) * row_cap
    parts = -(-slots // split)
    cap = XP.PACKED_TARGETS if tile_rows else XP.PACKED_THREADS
    assert split <= cap and (parts - 1) * split < slots <= parts * split
    assert parts == -(-slots // cap)        # the fewest parts


@pytest.mark.parametrize("row_cap,n_rows,want", [
    (8, 10 ** 6, 32), (64, 10 ** 6, 32), (100, 10 ** 6, 22),
    (392, 10 ** 6, 4), (392, 4096, 4), (392, 1000, 3), (384, 4096, 4),
    (408, 4096, 3), (656, 2216, 1), (700, 10 ** 6, 1), (1024, 10 ** 6, 1),
    (100, 2216, 8), (8, 256, 1),
    (2293, 10 ** 6, 1), (2294, 10 ** 6, 0), (4000, 10 ** 6, 0),
    (14528, 10 ** 6, 0)])
def test_packed_tile_rows(row_cap, n_rows, want):
    r = XP.packed_tile_rows(row_cap, n_rows)
    assert r == want
    assert XP.packed_smem_bytes(r, row_cap) <= MAX_SMEM
    if r > 1:
        assert XP.packed_smem_bytes(r, row_cap) <= XP.PACKED_SMEM
        assert r * XP.MIN_TILES <= n_rows
    if 1 <= r < XP.MAX_TILE_ROWS:
        assert (XP.packed_smem_bytes(r + 1, row_cap) > XP.PACKED_SMEM
                or (r + 1) * XP.MIN_TILES > n_rows)


def test_python_mirror_matches_cuda_constants():
    threads = _const(XPENCIL_CU, "kPackedThreads")
    assert threads == XP.PACKED_THREADS
    assert _const(XPENCIL_CU, "kPackedTargets",
                  {"kPackedThreads": threads}) == XP.PACKED_TARGETS
    assert _const(XPENCIL_CU, "kMinTiles") == XP.MIN_TILES
    assert _const(XPENCIL_CU, "kMaxTileRows") == XP.MAX_TILE_ROWS
    assert _const(XPENCIL_CU, "kPackedSmem") == XP.PACKED_SMEM
    assert _body(XPENCIL_CU, "packed_smem(int tile_rows, int row_cap)") == (
        "return tile_rows > 0 ? 16 + (size_t)32 * (tile_rows + 2) * row_cap "
        "+ (size_t)16 * kPackedTargets : (size_t)16 * row_cap;")
    assert _body(XPENCIL_CU, "int packed_tile_rows(int row_cap, int n_rows)"
                 ) == (
        "if (packed_smem(1, row_cap) > kMaxSmem) return 0; int r = "
        "kMaxTileRows; while (r > 1 && (packed_smem(r, row_cap) > kPackedSmem "
        "|| (long long)r * kMinTiles > n_rows)) --r; return r;")
    assert _body(XPENCIL_CU, "int packed_split(int tile_rows, int row_cap)"
                 ) == (
        "const long long slots = (long long)(tile_rows > 0 ? tile_rows : 1) "
        "* row_cap; const int cap = tile_rows > 0 ? kPackedTargets : "
        "kPackedThreads; const long long parts = (slots + cap - 1) / cap; "
        "return (int)((slots + parts - 1) / parts);")
    assert _const(PACK_CU, "kMaxFields") == PK.MAX_FIELDS
    # the pack kernel: a block's threads, the rows a block packs, the most
    # cells a row may have (a block's offsets, warp sums and row totals
    # within the 48 KB a block gets without opting in)
    threads = _const(PACK_CU, "kPackThreads")
    warps = int(_const(PACK_CU, "kWarps", {"kPackThreads": threads}))
    assert threads == PK.PACK_THREADS == 32 * warps
    assert _const(PACK_CU, "kMaxRowsPerBlock") == PK.MAX_ROWS_PER_BLOCK
    assert _const(PACK_CU, "kRowWork") == PK.ROW_WORK
    assert _const(PACK_CU, "kMaxRowCells") == PK.MAX_ROW_CELLS
    assert PK.MAX_ROW_CELLS % 16 == 0
    fixed = 4 * warps + 4 * PK.MAX_ROWS_PER_BLOCK
    assert 4 * PK.MAX_ROW_CELLS + fixed <= 48 * 1024 < (
        4 * (PK.MAX_ROW_CELLS + 16) + fixed)
    assert PK.PACK_THREADS // PK.MAX_ROWS_PER_BLOCK >= 32   # a warp a row
    assert _body(PACK_CU, "int rows_per_block(int nx, int m_c, int row_cap)"
                 ) == (
        "const int loads = ((nx + 2) * m_c + 3) / 4; const int work = "
        "row_cap > loads ? row_cap : loads; int rows = kMaxRowsPerBlock; "
        "while (rows > 1 && kPackThreads / rows * kRowWork < work) rows /= "
        "2; return rows;")
    assert "nx + 3 > kMaxRowCells" in PACK_CU


def _scene(seed=0, periodic=True, fields=None):
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = dom.sample_uniform(200, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    m_c = suggest_m_c(dom, pos)
    return dom, bin_particles(dom, pos, fields, m_c=m_c), \
        suggest_row_cap(dom, pos)


def test_tile_rows_are_checked_and_change_no_plain_bit():
    dom, bins, row_cap = _scene()
    pk = pack_rows(dom, bins, row_cap)
    args = (pk.planes, pk.slot_id, pk.slot_cell, pk.cell_offsets, None)
    kw = dict(nx=5, ny=4, m_c=bins.m_c, kernel=make_low_flop(), cutoff2=1.0)
    want = XP.xpencil_packed_forces(*args, **kw)
    for r in (0, 1, XP.packed_tile_rows(row_cap, 12), XP.MAX_TILE_ROWS):
        got = XP.xpencil_packed_forces(*args, tile_rows=r, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for r in (-1, XP.MAX_TILE_ROWS + 1):
        with pytest.raises(ValueError, match="tile_rows"):
            XP.xpencil_packed_forces(*args, tile_rows=r, **kw)


@pytest.mark.parametrize("nx,m_c,row_cap,want", [
    (64, 24, 384, 2), (64, 32, 392, 1), (64, 80, 664, 1), (16, 32, 152, 4),
    (16, 40, 192, 4), (16, 16, 96, 8), (4, 8, 20, 8), (5, 12, 40, 8),
    (2000, 8, 40, 1), (12237, 1, 1, 1), (2046, 1, 1, 2), (2047, 1, 1, 1)])
def test_pack_rows_per_block(nx, m_c, row_cap, want):
    """Main cases (a) and (b), batch (f), small scenes, the widest rows
    two to a block, and rows whose offsets fill a block's shared memory:
    a row's threads take at most ROW_WORK positions and loads each, and
    half as many threads would not do; the rows' offsets fit."""
    rows = PK.rows_per_block(nx, m_c, row_cap)
    assert rows == want
    row_threads = PK.PACK_THREADS // rows
    work = max(row_cap, ((nx + 2) * m_c + 3) // 4)
    assert rows * (nx + 3) <= PK.MAX_ROW_CELLS
    assert rows == 1 or row_threads * PK.ROW_WORK >= work
    if rows < PK.MAX_ROWS_PER_BLOCK:
        assert row_threads // 2 * PK.ROW_WORK < work


def test_outputs_are_disjoint_aligned_views_of_one_allocation():
    """The pack wrapper's outputs: each contiguous, of its dtype and shape,
    starting on a 512-byte boundary, none overlapping another."""
    specs = [(torch.float32, (3, 6, 5, 40)), (torch.int32, (3, 6, 5, 40)),
             (torch.int32, (6, 5, 7)), (torch.int32, (6, 5)),
             (torch.int32, (3, 101))]
    out = PK._outputs("cpu", specs)
    base = out[0].untyped_storage().data_ptr()
    spans = []
    for t, (dtype, shape) in zip(out, specs, strict=True):
        assert t.dtype == dtype and tuple(t.shape) == shape
        assert t.is_contiguous()
        assert t.untyped_storage().data_ptr() == base
        start = t.data_ptr() - base
        assert start % 512 == 0
        spans.append((start, start + 4 * t.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= out[0].untyped_storage().nbytes()


def test_fill_bits_are_the_plain_fills():
    f32 = torch.tensor([EMPTY_POS], dtype=torch.float32).view(torch.int32)
    assert PK._fill_bits("x", torch.float32) == int(f32) > 0
    assert PK._fill_bits("z", torch.float32) == int(f32)
    assert PK._fill_bits("mass", torch.float32) == 0
    assert PK._fill_bits("tag", torch.int32) == 0


def test_pack_slots_on_the_cpu_is_the_plain_version():
    fields = {"mass": torch.arange(200, dtype=torch.float32),
              "tag": torch.arange(200, dtype=torch.int32)}
    dom, bins, row_cap = _scene(1, fields=fields)
    nx, ny, _ = dom.ncells
    PK.pack_slots.launches = 0
    for cap in (row_cap, 6):                       # 6: rows drop their tails
        got = PK.pack_slots(bins, nx=nx, ny=ny, row_cap=cap)
        want = pack_slots_plain(bins, nx=nx, ny=ny, row_cap=cap)
        for name in want[0]:
            assert torch.equal(got[0][name], want[0][name]), name
            assert got[0][name].dtype == bins.planes[name].dtype
        for g, w in zip(got[1:], want[1:], strict=True):
            assert torch.equal(g, w)
        # every packed slot is a moved particle or a fill, never both
        row_counts = got[4]
        assert torch.equal(row_counts, got[3][..., -1])
        moved = got[1] >= 0
        n_moved = torch.clamp(row_counts, max=cap)
        assert torch.equal(moved.sum(-1, dtype=torch.int32), n_moved)
        assert torch.equal(moved, torch.arange(cap) < n_moved[..., None])
        assert bool((got[0]["x"][~moved] == np.float32(EMPTY_POS)).all())
        assert bool((got[2][~moved] == 1).all())
    assert PK.pack_slots.launches == 0


def test_wrappers_raise_off_cpu_and_cuda():
    dom, bins, row_cap = _scene(2)
    meta = CellBins(
        planes={k: v.to("meta") for k, v in bins.planes.items()},
        slot_id=bins.slot_id.to("meta"), counts=bins.counts.to("meta"),
        offsets=bins.offsets.to("meta"),
        particle_slot=bins.particle_slot.to("meta"), m_c=bins.m_c)
    nx, ny, _ = dom.ncells
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        PK.pack_slots(meta, nx=nx, ny=ny, row_cap=row_cap)
    pk = pack_rows(dom, bins, row_cap)
    on_meta = [{k: v.to("meta") for k, v in pk.planes.items()}] + [
        t.to("meta") for t in (pk.slot_id, pk.slot_cell, pk.cell_offsets)]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        XP.xpencil_packed_forces(*on_meta, None, nx=nx, ny=ny, m_c=bins.m_c,
                                 kernel=make_low_flop(), cutoff2=1.0)


# ---------------------------------------------------------------------------
# the pack kernel's contract: the plain version against JAX, the kernel's
# gather against the scatters, the precondition of every producer
# ---------------------------------------------------------------------------

def _uniform(periodic, n=200, seed=0, fields=None):
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=periodic)
    pos = torch.from_numpy((np.random.default_rng(seed).uniform(0, 1, (n, 3))
                            * np.asarray(dom.box)).astype(np.float32))
    return dom, pos


def _bins_of(dom, pos, fields=None, m_c=None, valid=None):
    m_c = m_c or suggest_m_c(dom, pos.reshape(-1, 3))
    return bin_particles(dom, pos, fields, m_c=m_c, valid=valid)


def _scene_uniform(periodic):
    dom, pos = _uniform(periodic, seed=1)
    return dom, _bins_of(dom, pos), suggest_row_cap(dom, pos)


def _scene_blob(periodic):
    jdom, pos = blob(6, 300, seed=5, periodic=periodic)
    dom, tpos = domain_from_jax(jdom), torch.from_numpy(pos)
    return dom, _bins_of(dom, tpos), suggest_row_cap(dom, tpos)


def _scene_row_cap_overflow():
    dom, pos = _uniform(True, seed=2)
    bins = _bins_of(dom, pos)
    fullest = int(((bins.slot_id >= 0).sum(-1)).max())
    return dom, bins, fullest // 2            # rows drop their tails


def _scene_m_c_overflow():
    dom, pos = _uniform(False, seed=3)
    return dom, _bins_of(dom, pos, m_c=2), suggest_row_cap(dom, pos)


def _scene_fields():
    dom, pos = _uniform(True, seed=4)
    fields = {"mass": torch.rand(200, generator=torch.Generator()
                                 .manual_seed(4)),
              "tag": torch.arange(200, dtype=torch.int32)}
    return dom, _bins_of(dom, pos, fields), suggest_row_cap(dom, pos)


def _scene_stacked():
    """Three systems, the middle one padding throughout."""
    dom = Domain(box=(5.0, 4.0, 3.0), ncells=(5, 4, 3), cutoff=1.0,
                 periodic=True)
    rng = np.random.default_rng(6)
    pos = torch.from_numpy((rng.uniform(0, 1, (3, 150, 3))
                            * np.asarray(dom.box)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(3, 150)) > 0.2)
    valid[1] = False
    bins = _bins_of(dom, pos, m_c=12, valid=valid)
    return dom, bins, 40


def _scene_refresh():
    """Bins from ``refresh_bins``: the slots of a first binning, the values
    of positions moved a little, the ghost ring refilled."""
    dom, pos = _uniform(True, seed=7)
    bins = _bins_of(dom, pos)
    moved = pos + 0.01 * torch.from_numpy(
        np.random.default_rng(7).standard_normal(pos.shape)
        .astype(np.float32))
    return dom, refresh_bins(dom, bins, moved), suggest_row_cap(dom, pos)


def _halo_bins(periodic):
    """What ``dist.engine`` hands ``pack_rows`` on a packed halo plan: the
    stacked shards' bins, slot ids offset by each shard's index."""
    dom = Domain.cubic(4, cutoff=1.0, periodic=periodic)
    pos = torch.from_numpy((np.random.default_rng(8).uniform(0, 4, (300, 3)))
                           .astype(np.float32))
    p = plan(dom, positions=pos, backend="halo", n_shards=2,
             strategy="xpencil", layout="packed", device="cpu")
    seen = []
    real = E.pack_rows
    E.pack_rows = lambda d, b, row_cap: seen.append((d, b, row_cap)) or \
        real(d, b, row_cap)
    try:
        E.halo_impl(p).layout(ParticleState(pos[None]))
    finally:
        E.pack_rows = real
    (ldom, bins, row_cap), = seen
    return ldom, bins, row_cap


PACK_SCENES = {
    "open uniform": lambda: _scene_uniform(False),
    "periodic uniform": lambda: _scene_uniform(True),
    "open blob": lambda: _scene_blob(False),
    "periodic blob": lambda: _scene_blob(True),
    "row_cap overflow": _scene_row_cap_overflow,
    "m_c overflow": _scene_m_c_overflow,
    "fields": _scene_fields,
    "stacked with a padding system": _scene_stacked,
    "refresh_bins": _scene_refresh,
    "halo shards": lambda: _halo_bins(False),
    "periodic halo shards": lambda: _halo_bins(True),
}
PACK_OUTPUTS = ("slot_id", "slot_cell", "cell_offsets", "row_counts",
                "particle_slot")


def _systems(bins):
    if bins.slot_id.dim() == 4:
        return [system(bins, b) for b in range(bins.slot_id.shape[0])]
    return [bins]


def _bits(t):
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jax_pack(dom, bins, row_cap):
    """JAX's ``pack_rows`` on one system's bins (the same arrays)."""
    jdom = JDomain(box=dom.box, ncells=dom.ncells, cutoff=dom.cutoff,
                   periodic=dom.periodic)
    jb = JCellBins(planes={k: jnp.asarray(v.numpy())
                           for k, v in bins.planes.items()},
                   slot_id=jnp.asarray(bins.slot_id.numpy()),
                   counts=jnp.asarray(bins.counts.numpy()),
                   offsets=jnp.asarray(bins.offsets.numpy()),
                   particle_slot=jnp.asarray(bins.particle_slot.numpy()),
                   m_c=bins.m_c)
    return _J_PACK(jdom, jb, row_cap)


@pytest.mark.parametrize("scene", sorted(PACK_SCENES))
def test_pack_slots_on_the_cpu_equals_jax(scene):
    """Every output of the wrapper on CPU tensors (its plain version)
    bit-equal to JAX's ``pack_rows``, system by system; no launch."""
    dom, bins, row_cap = PACK_SCENES[scene]()
    nx, ny, _ = dom.ncells
    PK.pack_slots.launches = 0
    planes, *rest = PK.pack_slots(bins, nx=nx, ny=ny, row_cap=row_cap)
    assert PK.pack_slots.launches == 0
    got = dict(zip(PACK_OUTPUTS, rest))
    assert sorted(planes) == sorted(bins.planes)
    for b, one in enumerate(_systems(bins)):
        want = _jax_pack(dom, one, row_cap)
        lead = (b,) if bins.slot_id.dim() == 4 else ()
        for name in PACK_OUTPUTS:
            g = got[name][lead]
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(want, name)), err_msg=name)
        for name, plane in planes.items():
            assert plane.dtype == bins.planes[name].dtype, name
            np.testing.assert_array_equal(
                _bits(plane[lead].numpy()), _bits(want.planes[name]),
                err_msg=name)
    fullest = int(got["row_counts"].max())
    assert (fullest > row_cap) == (scene == "row_cap overflow")


def _gather_mirror(bins, nx, ny, row_cap):
    """The pack kernel's indexing in Python, on one system: each row's
    counts of ids >= 0 and their exclusive scan; packed position ``d``
    below ``min(count, row_cap)`` takes cell ``c``, the last whose offset
    is <= d, and dense slot ``c * m_c + d - offsets[c]``; the positions
    after it take the fills; each particle reads its row's offsets at the
    ``nx + 3`` stride of ``cell_offsets``."""
    sid, m_c = bins.slot_id, bins.m_c
    nzp, nyp, w = sid.shape
    counts = (sid.view(nzp, nyp, nx + 2, m_c) >= 0).sum(-1, dtype=torch.int32)
    off = counts.cumsum(-1, dtype=torch.int32) - counts
    total = counts.sum(-1, dtype=torch.int32)
    cell_offsets = torch.cat([off, total[..., None]], -1)
    d = torch.arange(row_cap, dtype=torch.int32).expand(nzp, nyp, row_cap)
    c = torch.searchsorted(off, d.contiguous(), right=True) - 1
    moved = d < torch.clamp(total, max=row_cap)[..., None]
    slot = torch.where(moved, c * m_c + d - torch.gather(off, -1, c), 0)

    def gather(plane, fill):
        return torch.where(moved, torch.gather(plane, -1, slot), fill)

    planes = {k: gather(v, EMPTY_POS if k in ("x", "y", "z") else 0)
              for k, v in bins.planes.items()}
    ds = bins.particle_slot.long()
    zp, rem = ds // (nyp * w), ds % (nyp * w)
    yp, col = rem // w, rem % w
    zc = torch.clamp(zp, max=nzp - 1)
    pos = cell_offsets.reshape(-1)[(zc * nyp + yp) * (nx + 3) + col // m_c]
    pos = torch.clamp(pos + col % m_c, max=row_cap)
    pslot = (((zp - 1) * ny + yp - 1) * (row_cap + 1) + pos).to(torch.int32)
    return (planes, gather(sid, -1), torch.where(moved, c.int(), 1),
            cell_offsets, total, pslot)


@pytest.mark.parametrize("scene", sorted(PACK_SCENES))
def test_kernel_gather_mirror_equals_the_scatters(scene):
    dom, bins, row_cap = PACK_SCENES[scene]()
    nx, ny, _ = dom.ncells
    for one in _systems(bins):
        want = pack_slots_plain(one, nx=nx, ny=ny, row_cap=row_cap)
        got = _gather_mirror(one, nx, ny, row_cap)
        for name in want[0]:
            assert torch.equal(got[0][name], want[0][name]), name
        for g, w, name in zip(got[1:], want[1:], PACK_OUTPUTS, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w), name


PRODUCERS = {
    "bin_particles with valid": _scene_stacked,
    "refresh_bins": _scene_refresh,
    "periodic ghost fill": lambda: _scene_uniform(True),
    "halo shards": lambda: _halo_bins(False),
    "periodic halo shards": lambda: _halo_bins(True),
}


@pytest.mark.parametrize("producer", sorted(PRODUCERS))
def test_producers_leave_each_cell_s_particles_in_its_first_slots(producer):
    """The pack kernel's precondition: in every cell of the dense bins the
    occupied slots are the first ``count`` ones."""
    dom, bins, _ = PRODUCERS[producer]()
    m_c = bins.m_c
    occ = bins.slot_id.reshape(-1, m_c) >= 0
    count = occ.sum(-1)
    assert torch.equal(occ, torch.arange(m_c) < count[:, None])
    assert bool(occ.any())
    # the case each producer stands for is really in its bins
    sid = bins.slot_id
    if producer == "bin_particles with valid":
        assert not bool((sid[1] >= 0).any())
    if producer.endswith("ghost fill"):
        assert bool((sid[0] >= 0).any())            # a ghost z plane
    if "halo" in producer:
        n = bins.particle_slot.shape[-1]
        assert bool((sid[1] >= n).any())            # offset ids
