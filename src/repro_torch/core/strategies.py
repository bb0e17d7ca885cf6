"""Scheduling strategies in plain PyTorch (port of ``repro.core.strategies``).

  naive_n2  O(N^2) masked all-pairs: the correctness oracle (small inputs).
  xpencil   the paper's X-pencil: parallel over (z, y) pencils; the target
            pencil is staged once, the 9 (dz, dy) neighbour pencils are
            visited one at a time, and the X window of a target cell is a
            contiguous 3*m_c slice of the neighbour pencil row.

``xpencil`` is the plain version of the CUDA X-pencil kernel
(``repro_torch.kernels.xpencil``). JAX's ``lax.map`` over pencils becomes a
Python loop over chunks of ``batch_size`` pencils, which bounds peak memory.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .binning import CellBins
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
    -> 4 x (nz, ny, nx*m_c): the plain version of the CUDA kernel, with its
    signature.

    For each (z, y) target pencil: take the pencil's target slots, then
    visit the 9 (dz, dy) neighbour pencils in the order k = 3*(dz+1) +
    (dy+1); each target cell's sources are the contiguous 3*m_c window of
    the neighbour row.
    """
    nz, ny = x.shape[0] - 2, x.shape[1] - 2
    dev = slot_id.device
    widx = _window_indices(nx, m_c, dev)
    fields = (x, y, z, slot_id)
    lo, hi = m_c, (nx + 1) * m_c

    outs = []
    for start in range(0, nz * ny, batch_size):
        zy = torch.arange(start, min(start + batch_size, nz * ny), device=dev)
        pz, py = zy // ny + 1, zy % ny + 1        # padded pencil coordinates
        tx, ty, tz, tid = (f[pz, py, lo:hi].reshape(-1, nx, m_c)
                           for f in fields)
        acc = None
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                sx, sy, sz, sid = (f[pz + dz, py + dy][:, widx]
                                   for f in fields)   # (B, nx, 3*m_c)
                out = _pair_reduce(kernel, cutoff2, tx, ty, tz, tid,
                                   sx, sy, sz, sid)
                acc = out if acc is None else tuple(
                    a + o for a, o in zip(acc, out))
        outs.append(acc)
    return tuple(torch.cat(o).reshape(nz, ny, nx * m_c) for o in zip(*outs))
