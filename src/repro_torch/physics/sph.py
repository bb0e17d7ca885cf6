"""Weakly-compressible SPH on the plan/execute API (port of
``repro.physics.sph``).

A minimal WCSPH pipeline (density summation -> Tait EOS pressure ->
mean-field symmetric pressure force) whose neighbor loops all run through
``plan(...).execute(...)``, so any strategy and backend serves the SPH sums.
The default backend is ``"cuda"``, as ``plan()``'s is: the density and the
pressure force both have a CUDA form (kind ``SPH_DENSITY``, whose third
parameter scales the coefficient). The plans run on the positions' device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.api import ParticleState, plan
from ..core.domain import Domain
from ..core.interactions import (SPH_DENSITY, CudaForm, PairKernel,
                                 make_sph_density)


@dataclasses.dataclass(frozen=True)
class SPHParams:
    h: float                  # support radius (= cell cutoff)
    rho0: float = 1000.0      # rest density
    c0: float = 30.0          # speed of sound (Tait)
    gamma: float = 7.0
    alpha: float = 0.1        # artificial viscosity
    mass: float = 1.0


def density(domain: Domain, positions: torch.Tensor, params: SPHParams,
            m_c: int, strategy: str = "xpencil", batch_size: int = 64,
            backend: str = "cuda") -> torch.Tensor:
    """rho_i = m * sum_j W(r_ij) (self term included analytically)."""
    p = plan(domain, make_sph_density(params.h), m_c=m_c, strategy=strategy,
             backend=backend, batch_size=batch_size,
             device=positions.device)
    _, w = p.execute(ParticleState(positions))
    w_self = p.kernel.potential(torch.zeros_like(w))
    return params.mass * (w + w_self)


def pressure(rho: torch.Tensor, params: SPHParams) -> torch.Tensor:
    """Tait equation of state (WCSPH)."""
    b = params.rho0 * params.c0 ** 2 / params.gamma
    return b * ((rho / params.rho0) ** params.gamma - 1.0)


def make_pressure_kernel(params: SPHParams, rho_bar: float,
                         p_bar: float) -> PairKernel:
    """Mean-field symmetric pressure force kernel: the cubic spline's
    coefficient channel (grad W / r) times ``-2 m p_bar / rho_bar^2``, the
    density's potential channel. Its CUDA form is the density's with that
    scale as the third parameter, applied after the coefficient, in JAX's
    order (``scale * base.coeff(r2)``)."""
    base = make_sph_density(params.h)
    scale = -params.mass * 2.0 * p_bar / max(rho_bar, 1e-9) ** 2

    def coeff(r2):
        return scale * base.coeff(r2)

    def potential(r2):
        return base.potential(r2)

    hh, s = base.cuda.params[:2]
    return PairKernel("sph_pressure", coeff, potential, flops=24,
                      static_params=(params.h, params.mass, rho_bar, p_bar),
                      cuda=CudaForm(SPH_DENSITY, (hh, s, scale)))


def sph_step(domain: Domain, positions: torch.Tensor,
             velocities: torch.Tensor, params: SPHParams, m_c: int,
             dt: float, strategy: str = "xpencil", backend: str = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One WCSPH step: density -> EOS -> pressure accel -> symplectic
    Euler. -> (positions, velocities, density)."""
    rho = density(domain, positions, params, m_c, strategy, backend=backend)
    p = pressure(rho, params)
    kern = make_pressure_kernel(params, float(params.rho0), 1.0)
    fplan = plan(domain, kern, m_c=m_c, strategy=strategy, backend=backend,
                 device=positions.device)
    f, _ = fplan.execute(ParticleState(positions))
    accel = f * (torch.mean(p) / params.rho0)
    vel = velocities + dt * accel
    pos = positions + dt * vel
    box = torch.tensor(domain.box, dtype=pos.dtype, device=pos.device)
    if domain.any_periodic:     # every axis, as in the JAX package
        pos = torch.remainder(pos, box)
    else:
        pos = torch.minimum(torch.clamp(pos, min=0.0), box)
    return pos, vel, rho
