"""Kernel D's tiles and the pack kernel's contract, on the CPU.

Kernel D takes a tile of ``packed_tile_rows(row_cap, n_rows)`` pencils,
split into blocks of ``packed_split`` targets, its shared memory
``packed_smem_bytes``; all three are written twice, in
``kernels/xpencil.py`` and in ``csrc/xpencil.cu``, and checked here against
each other, as ``test_torch_xpencil_chunks.py`` checks B's chunk width. The
pack kernel's wrapper (``kernels/pack.py::pack_slots``) runs the plain
scatters on CPU tensors, which ``test_torch_packed.py`` holds bit for bit
against JAX's ``pack_rows``; here its constants, fill bits and device
checks. The kernels themselves run in ``test_torch_cuda.py`` on the card.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import (Domain, bin_particles, make_low_flop,
                              pack_rows, suggest_m_c, suggest_row_cap)
from repro_torch.core.binning import (EMPTY_POS, CellBins, pack_slots_plain)
from repro_torch.kernels import pack as PK
from repro_torch.kernels import xpencil as XP
from repro_torch.kernels._common import MAX_SMEM

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
    nx, ny, nz = dom.ncells
    occ = bins.slot_id.view(nz + 2, ny + 2, nx + 2, bins.m_c) >= 0
    cc = occ.sum(-1, dtype=torch.int32)
    offsets, row_counts = cc.cumsum(-1, dtype=torch.int32) - cc, cc.sum(
        -1, dtype=torch.int32)
    PK.pack_slots.launches = 0
    for cap in (row_cap, 6):                       # 6: rows drop their tails
        got = PK.pack_slots(bins, offsets, row_counts, nx=nx, ny=ny,
                            row_cap=cap)
        want = pack_slots_plain(bins, offsets, row_counts, nx=nx, ny=ny,
                                row_cap=cap)
        for name in want[0]:
            assert torch.equal(got[0][name], want[0][name]), name
            assert got[0][name].dtype == bins.planes[name].dtype
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
        # every packed slot is a moved particle or a fill, never both
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
    nx, ny, nz = dom.ncells
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        PK.pack_slots(meta, torch.empty((nz + 2, ny + 2, nx + 2),
                                        dtype=torch.int32, device="meta"),
                      torch.empty((nz + 2, ny + 2), dtype=torch.int32,
                                  device="meta"),
                      nx=nx, ny=ny, row_cap=row_cap)
    pk = pack_rows(dom, bins, row_cap)
    on_meta = [{k: v.to("meta") for k, v in pk.planes.items()}] + [
        t.to("meta") for t in (pk.slot_id, pk.slot_cell, pk.cell_offsets)]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        XP.xpencil_packed_forces(*on_meta, None, nx=nx, ny=ny, m_c=bins.m_c,
                                 kernel=make_low_flop(), cutoff2=1.0)
