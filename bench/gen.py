"""Inputs made from the seed: lattices, velocities and arrival schedules.

Particle data is made on the device with a ``torch.Generator`` there, in a
few large calls; an arrival schedule is made on the host with numpy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

FCC_BASIS = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.0), (0.5, 0.0, 0.5),
             (0.0, 0.5, 0.5))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def fcc_lattice(n_cells: int, a: float, jitter: float, gen, device,
                gaussian: bool = False, batch: Optional[int] = None
                ) -> torch.Tensor:
    """(4 n_cells^3, 3) float32: an fcc lattice of constant ``a`` filling a
    periodic cube of side ``n_cells * a``, offset by a quarter cell, each
    coordinate moved by at most ``jitter`` (uniform) or by a normal of
    standard deviation ``jitter`` (``gaussian``), wrapped into the box.
    With ``batch``, that many independent copies, (batch, N, 3), drawn in
    one call. Every coordinate lies in [0, side)."""
    basis = torch.tensor(FCC_BASIS, device=device) + 0.25
    idx = torch.arange(n_cells, device=device, dtype=torch.float32)
    cz, cy, cx = torch.meshgrid(idx, idx, idx, indexing="ij")
    cells = torch.stack([cx, cy, cz], -1).reshape(-1, 1, 3)
    pos = ((cells + basis) * a).reshape(-1, 3)
    if batch is not None:
        pos = pos.expand(batch, -1, -1)
    if gaussian:
        noise = torch.randn(pos.shape, generator=gen, device=device)
    else:
        noise = 2.0 * torch.rand(pos.shape, generator=gen, device=device) - 1
    side = n_cells * a
    pos = torch.remainder(pos + jitter * noise, side)
    # float32 rounding can give the side itself; keep every input in [0, L)
    return torch.where(pos >= side, pos - side, pos)


def velocities(n: int, temperature: float, gen, device,
               mass: float = 1.0) -> torch.Tensor:
    """(n, 3) float32 normal velocities with zero total momentum, scaled so
    the kinetic temperature over 3n - 3 degrees of freedom is exact."""
    v = torch.randn((n, 3), generator=gen, device=device, dtype=torch.float64)
    v -= v.mean(0)
    t_now = mass * (v * v).sum() / (3 * n - 3)
    return (v * torch.sqrt(temperature / t_now)).to(torch.float32)


def poisson_arrivals(rate: float, seconds: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Arrival offsets in [0, seconds) of an open loop at ``rate`` per
    second: exponential gaps, drawn in one call."""
    n = int(rate * seconds + 10 * math.sqrt(rate * seconds) + 10)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < seconds]
