"""Scalar observables for MD/SPH runs (port of
``repro.physics.observables``). Each returns a 0-d tensor on the input's
device."""

from __future__ import annotations

import torch


def kinetic_energy(velocities: torch.Tensor, mass: float = 1.0
                   ) -> torch.Tensor:
    return 0.5 * mass * torch.sum(velocities ** 2)


def potential_energy(per_particle_potential: torch.Tensor) -> torch.Tensor:
    """Pairs are counted twice across particles (paper's convention)."""
    return 0.5 * torch.sum(per_particle_potential)


def total_energy(velocities: torch.Tensor,
                 per_particle_potential: torch.Tensor,
                 mass: float = 1.0) -> torch.Tensor:
    return kinetic_energy(velocities, mass) + potential_energy(
        per_particle_potential)


def total_momentum(velocities: torch.Tensor, mass: float = 1.0
                   ) -> torch.Tensor:
    return mass * torch.sum(velocities, dim=0)


def temperature(velocities: torch.Tensor, mass: float = 1.0) -> torch.Tensor:
    n = velocities.shape[0]
    return 2.0 * kinetic_energy(velocities, mass) / (3.0 * n)
