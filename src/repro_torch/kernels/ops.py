"""Entry points of the CUDA kernels at the port's level of abstraction.

``xpencil_interactions`` runs the X-pencil kernel over binned planes and
scatters the result back to particle order; ``prefix_sum`` is the paper's
§6 scan. Each wrapper runs its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.binning import CellBins, dense_to_particles
from ..core.domain import Domain
from ..core.interactions import PairKernel
from .prefix_sum import prefix_sum
from .xpencil import xpencil_forces

__all__ = ["prefix_sum", "xpencil_interactions"]


def xpencil_interactions(domain: Domain, bins: CellBins, kernel: PairKernel
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X-pencil kernel -> per-particle (forces (N,3), potential (N,))."""
    fx, fy, fz, pot = xpencil_forces(
        bins.planes, bins.slot_id, nx=domain.nx, m_c=bins.m_c, kernel=kernel,
        cutoff2=float(domain.cutoff) ** 2)
    return dense_to_particles(domain, bins, fx, fy, fz, pot)
