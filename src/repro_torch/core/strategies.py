"""Scheduling strategies in plain PyTorch (port of ``repro.core.strategies``).

  naive_n2        O(N^2) masked all-pairs: the correctness oracle.
  xpencil         the paper's X-pencil: parallel over (z, y) pencils; the
                  target pencil is staged once, the 9 (dz, dy) neighbour
                  pencils are visited one at a time, and the X window of a
                  target cell is a contiguous 3*m_c slice of the neighbour
                  pencil row.
  xpencil_sparse  the same body over the occupancy summary's active pencils
                  only, results scattered back into the dense planes.
  xpencil_packed  the same pair terms over packed (CSR) rows: each target's
                  window is re-expanded to the dense 3*m_c shape.

``xpencil_planes``, ``xpencil_sparse_planes`` and ``xpencil_packed_planes``
are the plain versions of the CUDA kernels B, C and D
(``repro_torch.kernels.xpencil``), with their signatures. JAX's ``lax.map``
over pencils becomes a Python loop over chunks of ``batch_size`` pencils,
which bounds peak memory; the last chunk is ragged, so JAX's padding of the
active list to whole chunks (``_chunked_active``) is not needed. Every
variant shares the per-pencil body and the order of its sums with the
dense schedule, so compaction and packing change no computed value.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .binning import (EMPTY_POS, CellBins, Occupancy, PackedRows,
                      gather_pencil_rows, scatter_rows)
from .domain import Domain
from .interactions import PairKernel, pair_contribution

ForceOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


def xpencil(domain: Domain, bins: CellBins, kernel: PairKernel,
            batch_size: int = 64) -> ForceOut:
    """X-pencil schedule over the dense planes -> 4 x (nz, ny, nx, m_c)."""
    nx, ny, nz = domain.ncells
    out = xpencil_planes(bins.planes["x"], bins.planes["y"], bins.planes["z"],
                         bins.slot_id, nx=nx, m_c=bins.m_c, kernel=kernel,
                         cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    return tuple(o.reshape(nz, ny, nx, bins.m_c) for o in out)


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
    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    out = xpencil_sparse_planes(
        bins.planes["x"], bins.planes["y"], bins.planes["z"], bins.slot_id,
        occ.active, nx=nx, ny=ny, m_c=m_c, kernel=kernel,
        cutoff2=domain.cutoff ** 2, batch_size=batch_size)
    idx = occ.scatter_indices()
    return tuple(scatter_rows(o, idx, occ.n_units).reshape(nz, ny, nx, m_c)
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
