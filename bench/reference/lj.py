"""Cell-list Lennard-Jones forces and one integrator step, in plain PyTorch.

Every pair within the cutoff under the minimum image of a periodic cube,
found on a grid of its own (cell width >= cutoff); the pair term is the
configuration's: ``4 eps ((s2/r2')^6 - (s2/r2')^3)`` with ``r2' = r2 +
softening``, force ``24 eps (2 a12 - a6) / r2'`` along ``x_i - x_j``.

``dtype`` is the precision of the pair arithmetic, the sums and the
integrator's velocities. The coordinate differences are taken in
``coord_dtype`` (float64 by default, the input's float32 for the bfloat16
control) before the cast, so the control keeps its coordinates and changes
only the arithmetic a faster kernel would be tempted to lower.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def lj_forces(pos: torch.Tensor, box: float, cutoff: float, *,
              sigma: float = 1.0, eps: float = 1.0, softening: float = 0.0,
              dtype: torch.dtype = torch.float64,
              coord_dtype: Optional[torch.dtype] = None,
              block: int = 1 << 23
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """-> (forces (N, 3), per-particle potential (N,), unordered pairs
    within the cutoff). ``pos`` (N, 3) lies in a periodic cube of side
    ``box``; the work is cut into blocks of about ``block`` candidate
    pairs so that it fits beside whatever else is on the device."""
    coord_dtype = coord_dtype or (torch.float64 if dtype == torch.float64
                                  else pos.dtype)
    dev = pos.device
    n = pos.shape[0]
    nc = int(box / cutoff)
    if nc < 3:
        raise ValueError(f"box {box} holds fewer than 3 cells of {cutoff}")
    width = box / nc
    x = pos.to(coord_dtype)
    c3 = torch.remainder(torch.floor(x / width).long(), nc)
    cid = (c3[:, 2] * nc + c3[:, 1]) * nc + c3[:, 0]
    order = torch.argsort(cid)
    xs, c3s = x[order], c3[order]
    counts = torch.bincount(cid, minlength=nc ** 3)
    start = torch.cumsum(counts, 0) - counts
    m = int(counts.max())
    k = torch.arange(m, device=dev)
    f = torch.zeros((n, 3), dtype=dtype, device=dev)
    u = torch.zeros((n,), dtype=dtype, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    s2, rc2 = sigma * sigma, cutoff * cutoff
    rows = max(1, block // m)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        me = torch.arange(lo, hi, device=dev)
        fb = torch.zeros((hi - lo, 3), dtype=dtype, device=dev)
        ub = torch.zeros((hi - lo,), dtype=dtype, device=dev)
        for off in _OFFSETS:
            nb = torch.remainder(c3s[lo:hi] + torch.tensor(off, device=dev),
                                 nc)
            ncid = (nb[:, 2] * nc + nb[:, 1]) * nc + nb[:, 0]
            j = start[ncid][:, None] + k[None, :]
            live = (k[None, :] < counts[ncid][:, None]) & (j != me[:, None])
            j = torch.where(live, j, torch.zeros_like(j))
            d = xs[lo:hi, None, :] - xs[j]
            d = (d - box * torch.round(d / box)).to(dtype)
            r2 = (d * d).sum(-1)
            live &= r2 < rc2
            r2s = torch.where(live, r2 + softening, torch.ones_like(r2))
            inv = s2 / r2s
            a6 = inv * inv * inv
            a12 = a6 * a6
            w = live.to(dtype)
            coeff = 24.0 * eps * (2.0 * a12 - a6) / r2s * w
            fb += (coeff[..., None] * d).sum(1)
            ub += (4.0 * eps * (a12 - a6) * w).sum(1)
            pairs += live.sum()
        f[lo:hi] = fb
        u[lo:hi] = ub
    out_f = torch.empty_like(f)
    out_u = torch.empty_like(u)
    out_f[order] = f
    out_u[order] = u
    return out_f, out_u, int(pairs) // 2


def _wrap(x: torch.Tensor, box: float) -> torch.Tensor:
    return torch.remainder(x, box)


def verlet_step(force_fn, x: torch.Tensor, v: torch.Tensor, dt: float,
                box: float, mass: float = 1.0,
                dtype: torch.dtype = torch.float64):
    """One velocity-Verlet step from (x, v): -> (x', v', f', u'). The
    coordinates keep their own dtype; velocities and forces are ``dtype``."""
    f0, _, _ = force_fn(x)
    kick = 0.5 * dt / mass
    v_half = v.to(dtype) + kick * f0
    x1 = _wrap(x + dt * v_half.to(x.dtype), box)
    f1, u1, _ = force_fn(x1)
    return x1, v_half + kick * f1, f1, u1


def baoab_step(force_fn, x: torch.Tensor, v: torch.Tensor, dt: float,
               box: float, gamma: float, mass: float = 1.0,
               dtype: torch.dtype = torch.float64):
    """One BAOAB Langevin step at zero temperature (the noise term is
    ``sqrt(kT (1 - c1^2) / m) = 0``): B(dt/2) A(dt/2) O(dt) A(dt/2)
    B(dt/2). -> (x', v', f', u')."""
    f0, _, _ = force_fn(x)
    kick, half = 0.5 * dt / mass, 0.5 * dt
    c1 = math.exp(-gamma * dt)
    v1 = v.to(dtype) + kick * f0
    x1 = x + half * v1.to(x.dtype)
    v2 = c1 * v1
    x2 = _wrap(x1 + half * v2.to(x.dtype), box)
    f2, u2, _ = force_fn(x2)
    return x2, v2 + kick * f2, f2, u2


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64."""
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w).clamp_min(1e-300))
