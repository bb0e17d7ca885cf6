"""Scheduling strategies in plain PyTorch (port of ``repro.core.strategies``).

  naive_n2        O(N^2) masked all-pairs: the correctness oracle.
  par_part        Par-Part: parallel over particles; each gathers the 27*m_c
                  slots of its 27 neighbour cells (no staging, no reuse).
  cell_dense      Par-Cell: parallel over cells; the m_c targets of a cell
                  meet 27 one-cell source slabs, in the order dz, dy, dx.
  xpencil         the paper's X-pencil: parallel over (z, y) pencils; the
                  target pencil is staged once, the 9 (dz, dy) neighbour
                  pencils are visited one at a time, and the X window of a
                  target cell is a contiguous 3*m_c slice of the neighbour
                  pencil row.
  allin           the paper's All-in-SM: parallel over sub-boxes; a halo
                  block of (bz+2, by+2, bx+2) cells is staged once and every
                  interior target reads its 9 X windows from it.
  *_sparse        the cell schedules over the occupancy summary's active
                  units only (pencils, or sub-boxes for ``allin``), results
                  scattered back into the dense planes.
  xpencil_packed  the X-pencil pair terms over packed (CSR) rows: each
                  target's window is re-expanded to the dense 3*m_c shape.
  cell_sfc        Par-Cell over curve-ordered cell clusters, visiting only
                  the kept (cluster, stencil slot) pairs of the compressed
                  pair list (layout="sfc").

``xpencil_planes``, ``xpencil_sparse_planes``, ``xpencil_packed_planes``,
``allin_planes`` and ``cell_sfc_tiles`` are the plain versions of the CUDA
kernels B, C, D, E and F (``repro_torch.kernels``), with their signatures:
like the kernels they take an optional leading system axis, and run their
per-system body once for each system, in order.
JAX's ``lax.map`` over units becomes a Python loop over chunks of
``batch_size`` units, which bounds peak memory; the last chunk is ragged,
so JAX's padding of the active list to whole chunks (``_chunked_active``)
is not needed. Every compacted, packed or clustered variant shares the
per-unit body and the order of its sums with its dense schedule, so
compaction, packing and clustering change no computed value.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .binning import (EMPTY_POS, CellBins, Occupancy, PackedRows,
                      SfcClusters, gather_pencil_rows, scatter_rows,
                      sfc_device_slot_tables)
from .domain import Domain
from .interactions import PairKernel, pair_contribution

ForceOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def each_system(*ranks: Optional[int]):
    """Let a per-system plain version take stacked systems: ``ranks[i]`` is
    the rank of positional argument i for one system (None: shared by every
    system). Called with one more axis on its first argument, the body runs
    once per system, in order, and its outputs are stacked."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if args[0].dim() == ranks[0]:
                return fn(*args, **kw)
            outs = [fn(*(a if r is None else a[b]
                         for a, r in zip(args, ranks)), **kw)
                    for b in range(args[0].shape[0])]
            return tuple(torch.stack(o) for o in zip(*outs))
        return run
    return deco


def naive_n2(domain: Domain, positions: torch.Tensor, kernel: PairKernel,
             row_chunk: int = 1024) -> ForceOut:
    """All pairs with the cutoff mask; per-particle potential channel."""
    n = positions.shape[0]
    cut2 = domain.cutoff ** 2
    cols = torch.arange(n, device=positions.device)
    outs = []
    for lo in range(0, n, row_chunk):
        rows = cols[lo:lo + row_chunk]
        d = domain.minimum_image(positions[rows][:, None, :]
                                 - positions[None, :, :])
        mask = cols[None, :] != rows[:, None]
        fx, fy, fz, pot = pair_contribution(
            kernel, d[..., 0], d[..., 1], d[..., 2], mask, cut2)
        outs.append(tuple(o.sum(-1) for o in (fx, fy, fz, pot)))
    return tuple(torch.cat(o) for o in zip(*outs))


def _window_indices(nx: int, m_c: int, device) -> torch.Tensor:
    """(nx, 3*m_c) gather map: target cell x -> its contiguous source window
    [x*m_c, (x+3)*m_c) inside a padded pencil row (ghost cell at each end)."""
    return (torch.arange(nx, device=device)[:, None] * m_c
            + torch.arange(3 * m_c, device=device)[None, :])


def _pair_reduce(kernel, cut2, tx, ty, tz, tid, sx, sy, sz, sid):
    """targets (..., T) x sources (..., S) -> per-target (fx, fy, fz, pot)."""
    ddx = tx[..., :, None] - sx[..., None, :]
    ddy = ty[..., :, None] - sy[..., None, :]
    ddz = tz[..., :, None] - sz[..., None, :]
    mask = ((sid[..., None, :] != tid[..., :, None])
            & (sid[..., None, :] >= 0) & (tid[..., :, None] >= 0))
    fx, fy, fz, pot = pair_contribution(kernel, ddx, ddy, ddz, mask, cut2)
    return fx.sum(-1), fy.sum(-1), fz.sum(-1), pot.sum(-1)


# --------------------------------------------------------------------------
# Par-Part: parallel over particles, gather everything
# --------------------------------------------------------------------------

def par_part(domain: Domain, bins: CellBins, positions: torch.Tensor,
             kernel: PairKernel, batch_size: int = 4096) -> ForceOut:
    """One target per particle; the 27 * m_c slots of its 27 neighbour cells
    are gathered for it. Returns per-particle outputs (N,) directly: this
    schedule builds no dense output plane. Targets are ``positions`` as
    given, so a row the binning dropped (``valid`` False, or past ``m_c``)
    still gets the forces of the binned particles around it, as in JAX."""
    n = positions.shape[0]
    nx, ny, _ = domain.ncells
    m_c = bins.m_c
    dev = positions.device
    row_len = (nx + 2) * m_c
    coords = domain.cell_coords(positions).long()                 # (N, 3)
    offs = torch.from_numpy(domain.neighbor_offsets()).to(dev).long()
    flat = [p.reshape(-1) for p in (bins.planes["x"], bins.planes["y"],
                                    bins.planes["z"], bins.slot_id)]
    slot = torch.arange(m_c, device=dev)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    outs = []
    for lo in range(0, n, batch_size):
        # padded coordinates of the 27 neighbour cells are always in range,
        # thanks to the ghost ring
        ncell = coords[lo:lo + batch_size, None, :] + offs + 1   # (B, 27, 3)
        base = ((ncell[..., 2] * (ny + 2) + ncell[..., 1]) * row_len
                + ncell[..., 0] * m_c)                            # (B, 27)
        idx = (base[..., None] + slot).flatten(1)                 # (B, 27*m_c)
        sx, sy, sz, sid = (f[idx] for f in flat)
        pos = positions[lo:lo + batch_size]
        mask = (sid >= 0) & (sid != pid[lo:lo + batch_size, None])
        out = pair_contribution(kernel, pos[:, 0:1] - sx, pos[:, 1:2] - sy,
                                pos[:, 2:3] - sz, mask, domain.cutoff ** 2)
        outs.append(tuple(o.sum(-1) for o in out))
    return tuple(torch.cat(o) for o in zip(*outs))


# --------------------------------------------------------------------------
# Par-Cell: parallel over cells, 27 one-cell slabs
# --------------------------------------------------------------------------

def _scatter_pencils(domain: Domain, m_c: int, occ: Occupancy,
                     out) -> ForceOut:
    """Compact ``(max_active, nx*m_c)`` pencil rows -> dense (nz, ny, nx,
    m_c) planes, 0 where no active pencil lands."""
    nx, ny, nz = domain.ncells
    idx = occ.scatter_indices()
    return tuple(scatter_rows(o, idx, occ.n_units).reshape(nz, ny, nx, m_c)
                 for o in out)


def _cell_dense_pencils(x, y, z, slot_id, active_zy, *, nx: int, ny: int,
                        m_c: int, kernel: PairKernel, cutoff2: float,
                        batch_size: int = 64) -> ForceOut:
    """Par-Cell over the listed (z, y) pencils -> 4 x (len(active_zy),
    nx*m_c). Within a pencil every target cell meets its 27 neighbour cells
    as 27 separate m_c-slot slabs (the Par-Cell staging granularity),
    accumulated in the order dz, dy, dx."""
    fields = (x, y, z, slot_id)
    outs = []
    for start in range(0, active_zy.shape[0], batch_size):
        zy = active_zy[start:start + batch_size]
        tx, ty, tz, tid = (gather_pencil_rows(f, zy, ny)[:, m_c:(nx + 1) * m_c]
                           .reshape(-1, nx, m_c) for f in fields)
        acc = None
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                rows = [gather_pencil_rows(f, zy, ny, dz, dy) for f in fields]
                for dx in (-1, 0, 1):
                    sl = slice((1 + dx) * m_c, (1 + dx + nx) * m_c)
                    sx, sy, sz, sid = (r[:, sl].reshape(-1, nx, m_c)
                                       for r in rows)
                    out = _pair_reduce(kernel, cutoff2, tx, ty, tz, tid,
                                       sx, sy, sz, sid)
                    acc = out if acc is None else tuple(
                        a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o).reshape(-1, nx * m_c) for o in zip(*outs))


def cell_dense(domain: Domain, bins: CellBins, kernel: PairKernel,
               batch_size: int = 64) -> ForceOut:
    """Par-Cell over every pencil -> 4 x (nz, ny, nx, m_c)."""
    nx, ny, nz = domain.ncells
    every = torch.arange(nz * ny, dtype=torch.int32,
                         device=bins.slot_id.device)
    out = _cell_dense_pencils(
        bins.planes["x"], bins.planes["y"], bins.planes["z"], bins.slot_id,
        every, nx=nx, ny=ny, m_c=bins.m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return tuple(o.reshape(nz, ny, nx, bins.m_c) for o in out)


def cell_dense_sparse(domain: Domain, bins: CellBins, kernel: PairKernel,
                      occ: Occupancy, batch_size: int = 64) -> ForceOut:
    """Occupancy-compacted Par-Cell: only the active pencils are visited;
    within a pencil the staging stays the one-cell slab. Same dense planes
    as :func:`cell_dense` (empty pencils are 0)."""
    nx, ny, _ = domain.ncells
    out = _cell_dense_pencils(
        bins.planes["x"], bins.planes["y"], bins.planes["z"], bins.slot_id,
        occ.active, nx=nx, ny=ny, m_c=bins.m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return _scatter_pencils(domain, bins.m_c, occ, out)


def xpencil(domain: Domain, bins: CellBins, kernel: PairKernel,
            batch_size: int = 64) -> ForceOut:
    """X-pencil schedule over the dense planes -> 4 x (nz, ny, nx, m_c)."""
    nx, ny, nz = domain.ncells
    out = xpencil_planes(bins.planes["x"], bins.planes["y"], bins.planes["z"],
                         bins.slot_id, nx=nx, m_c=bins.m_c, kernel=kernel,
                         cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return tuple(o.reshape(nz, ny, nx, bins.m_c) for o in out)


@each_system(3, 3, 3, 3)
def xpencil_planes(x, y, z, slot_id, *, nx: int, m_c: int,
                   kernel: PairKernel, cutoff2: float,
                   batch_size: int = 64) -> ForceOut:
    """The X-pencil schedule on padded ``(nz+2, ny+2, (nx+2)*m_c)`` planes
    -> 4 x (nz, ny, nx*m_c): the plain version of CUDA kernel B, with its
    signature.

    For each (z, y) target pencil: take the pencil's target slots, then
    visit the 9 (dz, dy) neighbour pencils in the order k = 3*(dz+1) +
    (dy+1); each target cell's sources are the contiguous 3*m_c window of
    the neighbour row.
    """
    nz, ny = x.shape[0] - 2, x.shape[1] - 2
    every = torch.arange(nz * ny, dtype=torch.int32, device=x.device)
    out = xpencil_sparse_planes(x, y, z, slot_id, every, nx=nx, ny=ny,
                                m_c=m_c, kernel=kernel, cutoff2=cutoff2,
                                batch_size=batch_size)
    return tuple(o.reshape(nz, ny, nx * m_c) for o in out)


@each_system(3, 3, 3, 3, 1)
def xpencil_sparse_planes(x, y, z, slot_id, active_zy, *, nx: int, ny: int,
                          m_c: int, kernel: PairKernel, cutoff2: float,
                          batch_size: int = 64) -> ForceOut:
    """The X-pencil schedule over the listed pencils -> 4 x (len(active_zy),
    nx*m_c): the plain version of CUDA kernel C, with its signature.

    Row ``a`` holds the interior forces of pencil ``active_zy[a] = z * ny +
    y`` of the padded planes; padding entries (pencil 0) recompute pencil 0
    and are dropped by the caller's scatter."""
    fields = (x, y, z, slot_id)
    widx = _window_indices(nx, m_c, x.device)
    lo, hi = m_c, (nx + 1) * m_c
    outs = []
    for start in range(0, active_zy.shape[0], batch_size):
        zy = active_zy[start:start + batch_size]
        tx, ty, tz, tid = (gather_pencil_rows(f, zy, ny)[:, lo:hi]
                           .reshape(-1, nx, m_c) for f in fields)
        acc = None
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                sx, sy, sz, sid = (gather_pencil_rows(f, zy, ny, dz, dy)
                                   [:, widx] for f in fields)  # (B,nx,3m_c)
                out = _pair_reduce(kernel, cutoff2, tx, ty, tz, tid,
                                   sx, sy, sz, sid)
                acc = out if acc is None else tuple(
                    a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o).reshape(-1, nx * m_c) for o in zip(*outs))


def xpencil_sparse(domain: Domain, bins: CellBins, kernel: PairKernel,
                   occ: Occupancy, batch_size: int = 64) -> ForceOut:
    """Occupancy-compacted X-pencil: only active (z, y) pencils are staged;
    results land in the same dense (nz, ny, nx, m_c) planes as
    :func:`xpencil`'s (empty pencils are 0)."""
    nx, ny, _ = domain.ncells
    out = xpencil_sparse_planes(
        bins.planes["x"], bins.planes["y"], bins.planes["z"], bins.slot_id,
        occ.active, nx=nx, ny=ny, m_c=bins.m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return _scatter_pencils(domain, bins.m_c, occ, out)


# --------------------------------------------------------------------------
# All-in-SM: stage a whole sub-box and its halo
# --------------------------------------------------------------------------

# Shared memory one block of an H100 may opt in to, and its SM count: the
# defaults of the All-in-SM sub-box sizing (the JAX package sizes it from an
# 8 MiB VMEM budget and at least 8 sub-boxes).
SMEM_BUDGET_BYTES = 232448
MIN_BLOCKS = 132


def subbox_dims(domain: Domain, m_c: int, fields: int = 4,
                smem_budget_bytes: int = SMEM_BUDGET_BYTES,
                min_blocks: int = MIN_BLOCKS) -> Tuple[int, int, int]:
    """The paper's sub-box sizing (Section 5.1), with a block's shared
    memory as the budget.

    max cells = budget / (m_c * fields * 4 B); find the largest
    (bx+2)(by+2)(bz+2) <= max cells with the paper's p3 search, then shrink
    (paper: "reduce the size of the sub-box to ensure enough parallelism")
    until there are at least ``min_blocks`` sub-boxes. Below 27 cells the
    box stays (1, 1, 1), whose halo may then exceed the budget.
    """
    per_cell = m_c * fields * 4
    max_cells = max(27, smem_budget_bytes // per_cell)
    p3 = 3
    while (p3 + 1) ** 3 <= max_cells:
        p3 += 1
    candidates = [(p3, p3, p3), (p3 + 1, p3, p3), (p3 + 1, p3 + 1, p3),
                  (p3 + 2, p3, p3)]
    best = max((c for c in candidates if c[0] * c[1] * c[2] <= max_cells),
               key=lambda c: c[0] * c[1] * c[2], default=(3, 3, 3))
    bx, by, bz = (max(1, b - 2) for b in best)   # interior target cells
    bx, by, bz = (min(b, n) for b, n in zip((bx, by, bz), domain.ncells))

    def n_blocks(b):
        return (-(-domain.nx // b[0]) * -(-domain.ny // b[1])
                * -(-domain.nz // b[2]))

    while n_blocks((bx, by, bz)) < min_blocks and max(bx, by, bz) > 1:
        if bz >= by and bz >= bx:
            bz = max(1, bz // 2)
        elif by >= bx:
            by = max(1, by // 2)
        else:
            bx = max(1, bx // 2)
    return bx, by, bz


def shrink_to_divisors(domain: Domain,
                       box: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Shrink a sub-box to a divisor of each grid axis (exact tiling)."""
    def divisor_leq(n, b):
        b = min(b, n)
        while n % b:
            b -= 1
        return b

    return tuple(divisor_leq(n, b) for n, b in zip(domain.ncells, box))


def _allin_boxes(x, y, z, slot_id, box_ids, *, box: Tuple[int, int, int],
                 m_c: int, kernel: PairKernel, cutoff2: float,
                 batch_size: int = 8) -> ForceOut:
    """The All-in-SM body over the listed sub-boxes -> 4 x (len(box_ids),
    bz, by, bx*m_c).

    Sub-box ``b = iz*(gy*gx) + iy*gx + ix`` stages the overlapping halo
    block ``(bz+2, by+2, (bx+2)*m_c)`` of the padded planes at ``(iz*bz,
    iy*by, ix*bx*m_c)`` (the ghost ring supplies the out-of-domain reads);
    each interior target then meets the 9 (dz, dy) rows of the block in the
    order k = 3*(dz+1) + (dy+1), its sources the contiguous 3*m_c window of
    each row. ``box`` must divide the grid.
    """
    nz, ny = x.shape[0] - 2, x.shape[1] - 2
    nx = x.shape[2] // m_c - 2
    bx, by, bz = box
    gx, gy = nx // bx, ny // by
    dev = x.device
    hz = torch.arange(bz + 2, device=dev)[:, None, None]
    hy = torch.arange(by + 2, device=dev)[None, :, None]
    hc = torch.arange((bx + 2) * m_c, device=dev)[None, None, :]
    widx = _window_indices(bx, m_c, dev)
    outs = []
    for start in range(0, box_ids.shape[0], batch_size):
        bid = box_ids[start:start + batch_size].long()[:, None, None, None]
        iz, iy, ix = bid // (gy * gx), (bid // gx) % gy, bid % gx
        halo = [f[iz * bz + hz, iy * by + hy, ix * (bx * m_c) + hc]
                for f in (x, y, z, slot_id)]    # (B, bz+2, by+2, (bx+2)*m_c)
        tx, ty, tz, tid = (h[:, 1:bz + 1, 1:by + 1, m_c:(bx + 1) * m_c]
                           .reshape(-1, bz, by, bx, m_c) for h in halo)
        acc = None
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                sx, sy, sz, sid = (h[:, 1 + dz:1 + dz + bz,
                                     1 + dy:1 + dy + by][..., widx]
                                   for h in halo)  # (B, bz, by, bx, 3*m_c)
                out = _pair_reduce(kernel, cutoff2, tx, ty, tz, tid,
                                   sx, sy, sz, sid)
                acc = out if acc is None else tuple(
                    a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o).reshape(-1, bz, by, bx * m_c)
                 for o in zip(*outs))


def _assemble_boxes(blocks: torch.Tensor, grid: Tuple[int, int, int],
                    box: Tuple[int, int, int], m_c: int) -> torch.Tensor:
    """(gz*gy*gx, ...) per-sub-box blocks -> (nz, ny, nx*m_c) planes."""
    gx, gy, gz = grid
    bx, by, bz = box
    b = blocks.reshape(gz, gy, gx, bz, by, bx * m_c)
    return b.permute(0, 3, 1, 4, 2, 5).reshape(gz * bz, gy * by,
                                               gx * bx * m_c)


@each_system(3, 3, 3, 3)
def allin_planes(x, y, z, slot_id, *, box: Tuple[int, int, int], m_c: int,
                 kernel: PairKernel, cutoff2: float,
                 batch_size: int = 8) -> ForceOut:
    """All-in-SM over every sub-box on padded ``(nz+2, ny+2, (nx+2)*m_c)``
    planes -> 4 x (nz, ny, nx*m_c): the plain version of CUDA kernel E, with
    its signature. ``box`` must divide the grid."""
    nz, ny = x.shape[0] - 2, x.shape[1] - 2
    nx = x.shape[2] // m_c - 2
    bx, by, bz = box
    grid = (nx // bx, ny // by, nz // bz)
    every = torch.arange(grid[0] * grid[1] * grid[2], dtype=torch.int32,
                         device=x.device)
    out = _allin_boxes(x, y, z, slot_id, every, box=box, m_c=m_c,
                           kernel=kernel, cutoff2=cutoff2,
                           batch_size=batch_size)
    return tuple(_assemble_boxes(o, grid, box, m_c) for o in out)


def allin(domain: Domain, bins: CellBins, kernel: PairKernel,
          box: Optional[Tuple[int, int, int]] = None,
          batch_size: int = 8) -> ForceOut:
    """All-in-SM schedule -> 4 x (nz, ny, nx, m_c). The sub-box defaults to
    :func:`subbox_dims` and is shrunk to a divisor of each axis, so the
    sub-boxes tile the grid exactly."""
    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    box = shrink_to_divisors(domain, box or subbox_dims(domain, m_c))
    out = allin_planes(bins.planes["x"], bins.planes["y"], bins.planes["z"],
                       bins.slot_id, box=box, m_c=m_c, kernel=kernel,
                       cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return tuple(o.reshape(nz, ny, nx, m_c) for o in out)


def allin_sparse(domain: Domain, bins: CellBins, kernel: PairKernel,
                 occ: Occupancy, box: Tuple[int, int, int],
                 batch_size: int = 8) -> ForceOut:
    """Occupancy-compacted All-in-SM: empty sub-boxes are skipped. ``box``
    must divide the grid and be the tiling ``occ`` was built with
    (``binning.subbox_occupancy``); the per-box body is the dense one."""
    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    bx, by, bz = box
    out = _allin_boxes(
        bins.planes["x"], bins.planes["y"], bins.planes["z"], bins.slot_id,
        occ.active, box=box, m_c=m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    idx = occ.scatter_indices()
    grid = (nx // bx, ny // by, nz // bz)
    return tuple(
        _assemble_boxes(scatter_rows(o.flatten(1), idx, occ.n_units), grid,
                        box, m_c).reshape(nz, ny, nx, m_c)
        for o in out)


# --------------------------------------------------------------------------
# packed-row (CSR) X-pencil: dense windows re-expanded from packed rows
# --------------------------------------------------------------------------

def _packed_window(off, rows, scell, tcell, nx: int, m_c: int):
    """Expand packed source rows into per-target dense 3-cell windows.

    Each packed source row is first scattered back into its dense
    ``(nx+2)*m_c`` row (every packed slot knows its dense position ``cell *
    m_c + rank``; untouched slots keep the sentinel, so the row is
    bit-equal to the one the dense layout stores), then each target slot
    takes its cell's 3*m_c window of it.

    Args:
      off: (chunk, nx+3) per-source-row cell offsets.
      rows: field name -> (chunk, row_cap) packed source rows ("id" is the
        slot-id row; ids >= 0 mark real particles).
      scell: (chunk, row_cap) the source rows' packed slot cells.
      tcell: (chunk, row_cap) target padded cell, clipped to [1, nx].
    Returns:
      field name -> (chunk, row_cap, 3*m_c) window values per target slot.
    """
    chunk, row_cap = scell.shape
    dev = scell.device
    row_len = (nx + 2) * m_c
    scell = scell.long()
    start = torch.gather(off, 1, scell)
    rank = torch.arange(row_cap, device=dev) - start
    valid = rows["id"] >= 0
    dest = torch.where(valid, scell * m_c + rank,
                       torch.full_like(scell, row_len))      # pads dumped
    flat = (torch.arange(chunk, device=dev)[:, None] * (row_len + 1)
            + dest).reshape(-1)
    widx = _window_indices(nx, m_c, dev)
    sel = (torch.arange(chunk, device=dev)[:, None], tcell.long() - 1)
    out = {}
    for name, row in rows.items():
        fill = -1 if name == "id" else EMPTY_POS
        dense = torch.full((chunk * (row_len + 1),), fill, dtype=row.dtype,
                           device=dev)
        dense[flat] = row.reshape(-1)
        dense = dense.view(chunk, row_len + 1)[:, :row_len]
        out[name] = dense[:, widx][sel]
    return out


@each_system(3, 3, 3, 3, 3, 3, 1)
def xpencil_packed_planes(x, y, z, slot_id, slot_cell, cell_offsets,
                          active_zy, *, nx: int, ny: int, m_c: int,
                          kernel: PairKernel, cutoff2: float,
                          batch_size: int = 64) -> ForceOut:
    """The packed-row X-pencil over the listed pencil rows -> 4 x
    (len(active_zy), row_cap): the plain version of CUDA kernel D, with its
    signature.

    Planes, ids and cells are the packed layout's ``(nz+2, ny+2, row_cap)``
    arrays, offsets ``(nz+2, ny+2, nx+3)``. Row ``a`` holds the packed-slot
    forces of pencil ``active_zy[a]``; padding entries recompute pencil 0.
    """
    outs = []
    for start in range(0, active_zy.shape[0], batch_size):
        zy = active_zy[start:start + batch_size]
        tx, ty, tz, tid = (gather_pencil_rows(f, zy, ny)
                           for f in (x, y, z, slot_id))
        tcell = torch.clamp(gather_pencil_rows(slot_cell, zy, ny), 1, nx)
        acc = None
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                rows = {f: gather_pencil_rows(p, zy, ny, dz, dy)
                        for f, p in (("x", x), ("y", y), ("z", z),
                                     ("id", slot_id))}
                w = _packed_window(
                    gather_pencil_rows(cell_offsets, zy, ny, dz, dy), rows,
                    gather_pencil_rows(slot_cell, zy, ny, dz, dy), tcell,
                    nx, m_c)
                sid = w["id"]
                mask = ((sid != tid[..., None]) & (sid >= 0)
                        & (tid[..., None] >= 0))
                fx, fy, fz, pot = pair_contribution(
                    kernel, tx[..., None] - w["x"], ty[..., None] - w["y"],
                    tz[..., None] - w["z"], mask, cutoff2)
                out = (fx.sum(-1), fy.sum(-1), fz.sum(-1), pot.sum(-1))
                acc = out if acc is None else tuple(
                    a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o) for o in zip(*outs))


def xpencil_packed(domain: Domain, packed: PackedRows, kernel: PairKernel,
                   occ: Occupancy, batch_size: int = 64) -> ForceOut:
    """Packed-row X-pencil over the occupancy's active rows (pass
    ``binning.full_pencil_occupancy`` for every row) -> packed ``(nz * ny,
    row_cap)`` planes in pencil-id order, for
    :func:`binning.packed_to_particles`."""
    nx, ny, nz = domain.ncells
    out = xpencil_packed_planes(
        packed.planes["x"], packed.planes["y"], packed.planes["z"],
        packed.slot_id, packed.slot_cell, packed.cell_offsets, occ.active,
        nx=nx, ny=ny, m_c=packed.m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    idx = occ.scatter_indices()
    return tuple(scatter_rows(o, idx, nz * ny) for o in out)


# --------------------------------------------------------------------------
# SFC cluster schedule: the compressed cluster-pair list (layout="sfc")
# --------------------------------------------------------------------------

@each_system(3, 3, 3, 3, 1, None, None)
def cell_sfc_tiles(x, y, z, slot_id, codes, tgt_base, src_base, *, m_c: int,
                   kernel: PairKernel, cutoff2: float,
                   batch_size: int = 64) -> ForceOut:
    """Par-Cell over SFC clusters on padded ``(nz+2, ny+2, (nx+2)*m_c)``
    planes -> 4 x (n_clusters, csize*m_c) tiles: the plain version of CUDA
    kernel F, with its signature.

    ``tgt_base`` (n_clusters, csize) and ``src_base`` (n_clusters, 27,
    csize) are the flat slot bases of ``binning.sfc_slot_tables``, a base
    past the planes (``total``) meaning the always-empty sentinel cell.
    Target slot (cell j of cluster a, rank r) meets the m_c sources of cell
    j shifted by stencil slot k, for k = 0..26 in ascending order, each
    slab reduced to a partial and added to the accumulator: ``cell_dense``'s
    order, so per particle the tiles hold ``cell_dense``'s bits. A slab
    whose (cluster, k) code is not in ``codes`` is masked out (it is empty
    unless ``pair_cap`` truncated the list). Clusters are taken
    ``batch_size`` at a time; that changes no bit.
    """
    n_clusters, csize = tgt_base.shape
    dev = x.device

    def ext(plane: torch.Tensor, fill) -> torch.Tensor:  # + sentinel cell
        flat = plane.reshape(-1)
        return torch.cat([flat, flat.new_full((m_c,), fill)])

    xs, ys, zs = (ext(p, EMPTY_POS) for p in (x, y, z))
    ids = ext(slot_id, -1)
    # kept (cluster, k) pairs; sentinel codes land in the dump row
    kept = torch.zeros(((n_clusters + 1) * 32,), dtype=torch.bool, device=dev)
    kept[codes.long()] = True
    kept = kept.view(n_clusters + 1, 32)[:n_clusters, :27]
    rank = torch.arange(m_c, device=dev)
    outs = []
    for start in range(0, n_clusters, batch_size):
        stop = min(start + batch_size, n_clusters)
        tidx = tgt_base[start:stop].long()[..., None] + rank  # (B, csize, m_c)
        tx, ty, tz, tid = (f[tidx] for f in (xs, ys, zs, ids))
        acc = None
        for k in range(27):
            sidx = src_base[start:stop, k].long()[..., None] + rank
            sid = torch.where(kept[start:stop, k, None, None], ids[sidx], -1)
            out = _pair_reduce(kernel, cutoff2, tx, ty, tz, tid, xs[sidx],
                               ys[sidx], zs[sidx], sid)
            acc = out if acc is None else tuple(
                a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o).reshape(n_clusters, csize * m_c)
                 for o in zip(*outs))


def cell_sfc(domain: Domain, sfc: SfcClusters, kernel: PairKernel,
             batch_size: int = 64) -> ForceOut:
    """The SFC cluster schedule over the compressed pair list -> 4 x
    (n_clusters, csize*m_c) tiles, for :func:`binning.sfc_to_particles`.
    ``batch_size`` counts clusters per chunk."""
    bins = sfc.bins
    tgt_base, src_base = sfc_device_slot_tables(
        domain, bins.m_c, sfc.csize, sfc.curve, bins.slot_id.device)
    return cell_sfc_tiles(bins.planes["x"], bins.planes["y"],
                          bins.planes["z"], bins.slot_id, sfc.codes, tgt_base,
                          src_base, m_c=bins.m_c, kernel=kernel,
                          cutoff2=domain.cutoff ** 2, batch_size=batch_size)


STRATEGIES = {"par_part": par_part, "cell_dense": cell_dense,
              "xpencil": xpencil, "allin": allin}
SPARSE_STRATEGIES = {"cell_dense": cell_dense_sparse,
                     "xpencil": xpencil_sparse, "allin": allin_sparse}
PACKED_STRATEGIES = {"xpencil": xpencil_packed}
SFC_STRATEGIES = {"cell_dense": cell_sfc}
