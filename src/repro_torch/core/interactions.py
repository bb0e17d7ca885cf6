"""Pairwise interaction kernels (PyTorch port of ``repro.core.interactions``).

Central-force form shared by every schedule and the CUDA kernel:

    F_ij = coeff(r2) * (r_i - r_j)        (force on target i from source j)
    U_i  = sum_j potential(r2)            (per-particle potential channel)

``coeff``/``potential`` receive a masked-safe r2 (1.0 for excluded pairs,
whose contribution is then multiplied by 0), so they never see r2 == 0.

Each factory also gives the kernel a :class:`CudaForm`: the id the CUDA
X-pencil kernel switches on and its float parameters, with every Python-float
constant folded on the host in double precision exactly as Python folds it
before it reaches float32 (``24.0 * eps``, ``1 / (pi * hh**3)``). The torch
expressions below keep the JAX package's evaluation order; a Python float
divided by a tensor goes through ``_rdiv`` because ``float / tensor`` in
PyTorch is a reciprocal followed by a multiply, which rounds differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

# kernel ids of csrc/xpencil.cu (enum PairKind there)
LJ, LOW_FLOP, HIGH_FLOP, GRAVITY, SPH_DENSITY = range(5)


@dataclasses.dataclass(frozen=True)
class CudaForm:
    """What the CUDA kernel needs to evaluate a pair kernel: its id, up to
    four float parameters (folded on the host in double precision) and the
    number of extra polynomial terms (``high_flop`` only)."""

    kind: int
    params: Tuple[float, ...] = ()
    n_extra: int = 0


@dataclasses.dataclass(frozen=True)
class PairKernel:
    """A cutoff pair interaction. Hash/eq are value-based on
    ``(name, flops, static_params)``, so two ``make_lennard_jones()`` calls
    give equal kernels. ``cuda`` is None for a user's own kernel, which then
    runs only on ``backend="reference"``."""

    name: str
    coeff: Callable[[torch.Tensor], torch.Tensor]
    potential: Callable[[torch.Tensor], torch.Tensor]
    flops: int  # per-interaction FLOP count, paper's convention
    static_params: Tuple = ()
    cuda: Optional[CudaForm] = None

    def __hash__(self):
        return hash((self.name, self.flops, self.static_params))

    def __eq__(self, other):
        if not isinstance(other, PairKernel):
            return NotImplemented
        return (self.name, self.flops, self.static_params) == \
            (other.name, other.flops, other.static_params)


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one float32 division (PyTorch's ``float / tensor`` is
    ``t.reciprocal() * a``)."""
    return torch.full_like(t, a) / t


def _lj_terms(r2, sigma2: float):
    inv = _rdiv(sigma2, r2)
    a6 = inv * inv * inv
    a12 = a6 * a6
    return a6, a12


def make_lennard_jones(sigma: float = 0.2, eps: float = 1.0,
                       softening: float = 1e-6) -> PairKernel:
    """Lennard-Jones 12-6 with the paper's softening against overlaps."""
    sigma2 = sigma * sigma

    def coeff(r2):
        r2 = r2 + softening
        a6, a12 = _lj_terms(r2, sigma2)
        return 24.0 * eps * (2.0 * a12 - a6) / r2

    def potential(r2):
        r2 = r2 + softening
        a6, a12 = _lj_terms(r2, sigma2)
        return 4.0 * eps * (a12 - a6)

    return PairKernel("lennard_jones", coeff, potential, flops=21,
                      static_params=(sigma, eps, softening),
                      cuda=CudaForm(LJ, (sigma2, softening, 24.0 * eps,
                                         4.0 * eps)))


def make_low_flop() -> PairKernel:
    """~5 FLOP: the paper's memory-bound probe (sums, no divisions)."""

    def coeff(r2):
        return r2 * 0.5

    def potential(r2):
        return r2 + 1.0

    return PairKernel("low_flop", coeff, potential, flops=5,
                      cuda=CudaForm(LOW_FLOP))


def make_high_flop(extra_terms: int = 25, sigma: float = 0.2,
                   eps: float = 1.0, softening: float = 1e-6) -> PairKernel:
    """LJ + ``6 * extra_terms`` FLOP of r2-dependent polynomial work
    (25 terms -> 168 FLOP total, the paper's Figure 8)."""
    lj = make_lennard_jones(sigma, eps, softening)

    def extra(r2):
        acc = r2
        for k in range(extra_terms):
            acc = acc * 0.9999 + r2 * (1e-3 * (k + 1)) + 1e-7
            acc = acc * 1.0001
        return acc * 1e-30

    def coeff(r2):
        return lj.coeff(r2) + extra(r2)

    def potential(r2):
        return lj.potential(r2) + extra(r2)

    return PairKernel("high_flop", coeff, potential,
                      flops=21 + 6 * extra_terms,
                      static_params=(extra_terms, sigma, eps, softening),
                      cuda=CudaForm(HIGH_FLOP, lj.cuda.params, extra_terms))


def make_gravity(g: float = 1.0, softening: float = 1e-4) -> PairKernel:
    """Softened attractive 1/r2 (Nyland et al.'s n-body kernel)."""

    def coeff(r2):
        d = r2 + softening
        return -g * torch.rsqrt(d) / d

    def potential(r2):
        return -g * torch.rsqrt(r2 + softening)

    return PairKernel("gravity", coeff, potential, flops=14,
                      static_params=(g, softening),
                      cuda=CudaForm(GRAVITY, (-g, softening)))


def make_sph_density(h: float) -> PairKernel:
    """Cubic-spline SPH density accumulation (potential channel = sum of W),
    smoothing length h/2 so the support radius equals the cutoff h."""
    hh = h / 2.0
    s = 1.0 / (math.pi * hh ** 3)

    def potential(r2):
        q = torch.sqrt(r2) / hh
        w1 = 1.0 - 1.5 * q * q + 0.75 * (q * q * q)
        t = 2.0 - q
        w2 = 0.25 * (t * t * t)
        zero = torch.zeros_like(q)
        w = torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, zero))
        return s * w

    def coeff(r2):
        q = torch.sqrt(torch.clamp(r2, min=1e-12)) / hh
        g1 = -3.0 * q + 2.25 * q * q
        t = 2.0 - q
        g2 = -0.75 * (t * t)
        zero = torch.zeros_like(q)
        g = torch.where(q < 1.0, g1, torch.where(q < 2.0, g2, zero))
        r = torch.clamp(torch.sqrt(r2), min=1e-12)
        return s * g / (hh * r)

    # p2 scales the coefficient in the CUDA form (1.0 here; the pressure
    # kernel of ``repro_torch.physics.sph`` passes its scale)
    return PairKernel("sph_density", coeff, potential, flops=18,
                      static_params=(h,),
                      cuda=CudaForm(SPH_DENSITY, (hh, s, 1.0)))


def pair_contribution(kernel: PairKernel, dx, dy, dz, mask, cutoff2: float):
    """Masked force coefficient + potential for a batch of candidate pairs.

    Returns (fx, fy, fz, pot); excluded pairs contribute exactly 0 with no
    NaN/Inf leakage (masked-safe r2 substitution).
    """
    r2 = dx * dx + dy * dy + dz * dz
    m = mask & (r2 < cutoff2) & (r2 > 0.0)
    r2_safe = torch.where(m, r2, torch.ones_like(r2))
    w = m.to(dx.dtype)
    s = kernel.coeff(r2_safe) * w
    pot = kernel.potential(r2_safe) * w
    return s * dx, s * dy, s * dz, pot
