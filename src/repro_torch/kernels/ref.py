"""Plain PyTorch versions of the CUDA kernels (the allclose targets).

The X-pencil kernel is held against the X-pencil strategy of ``core`` (the
same schedule); the scan against ``torch.cumsum``, independent of the
paper's own schedule.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import strategies as S
from ..core.binning import CellBins
from ..core.domain import Domain
from ..core.interactions import PairKernel


def xpencil_ref(domain: Domain, bins: CellBins, kernel: PairKernel
                ) -> Tuple[torch.Tensor, ...]:
    """(nz, ny, nx*m_c) interior force/potential planes."""
    nx, ny, nz = domain.ncells
    out = S.xpencil(domain, bins, kernel)
    return tuple(o.reshape(nz, ny, nx * bins.m_c) for o in out)


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=x.dtype)
