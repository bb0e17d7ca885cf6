"""Engine API over the plan/execute layer (port of ``repro.core.engine``).

New code should use the plan/execute API directly:

    p = plan(domain, make_lennard_jones(), positions=pos, strategy="xpencil")
    forces, potential = p.execute(ParticleState(pos))

``CellListEngine`` and ``compute_interactions`` are the JAX package's thin
shims, kept so its call sites port unchanged: each owns one
:class:`~repro_torch.core.api.InteractionPlan` and delegates to it. Two
differences from JAX: the default backend is ``"cuda"`` and the plan runs
on the card unless ``device="cpu"`` is given (JAX's default is
``"reference"``), and there is no ``jit`` switch, since PyTorch runs
eagerly.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .api import InteractionPlan, ParticleState, plan as make_plan
from .binning import CellBins, bin_particles, cell_counts
from .domain import Domain
from .interactions import PairKernel, make_lennard_jones


def suggest_m_c(domain: Domain, positions: torch.Tensor, slack: float = 1.5,
                align: int = 8) -> int:
    """M_C choice: the max cell count times ``slack``, rounded up to a
    multiple of ``align``. Gives the same bound as the JAX package, so the
    two packages' bins can be compared slot for slot."""
    mx = int(cell_counts(domain, positions).max())
    m_c = max(1, int(mx * slack + 0.999))
    return -(-m_c // align) * align


class CellListEngine:
    """Cutoff pair-interaction engine over a uniform cell grid (shim)."""

    def __init__(self, domain: Domain, kernel: Optional[PairKernel] = None,
                 m_c: int = 8, strategy: str = "xpencil",
                 batch_size: int = 64, backend: str = "cuda", device=None):
        self.plan = make_plan(domain, kernel or make_lennard_jones(),
                              m_c=m_c, strategy=strategy, backend=backend,
                              batch_size=batch_size, device=device)

    @property
    def domain(self) -> Domain:
        return self.plan.domain

    @property
    def kernel(self) -> PairKernel:
        return self.plan.kernel

    @property
    def m_c(self) -> int:
        return self.plan.m_c

    @property
    def strategy(self) -> str:
        return self.plan.strategy

    @property
    def batch_size(self) -> int:
        return self.plan.batch_size

    def bin(self, positions: torch.Tensor,
            fields: Optional[Dict[str, torch.Tensor]] = None) -> CellBins:
        return bin_particles(self.domain, positions, fields, m_c=self.m_c)

    def compute(self, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (forces (N, 3), per-particle potential (N,)). Total potential
        energy is ``0.5 * potential.sum()`` (each pair counted twice)."""
        return self.plan.execute(ParticleState(positions))

    def check_m_c(self, positions: torch.Tensor) -> bool:
        """True if the current M_C bound still holds for these positions."""
        return not self.plan.check_overflow(ParticleState(positions))


@functools.lru_cache(maxsize=None)
def _cached_plan(domain: Domain, kernel: PairKernel, m_c: int, strategy: str,
                 batch_size: int, backend: str,
                 device: torch.device) -> InteractionPlan:
    return make_plan(domain, kernel, m_c=m_c, strategy=strategy,
                     backend=backend, batch_size=batch_size, device=device)


def compute_interactions(domain: Domain, positions: torch.Tensor,
                         kernel: Optional[PairKernel] = None,
                         m_c: Optional[int] = None,
                         strategy: str = "xpencil", batch_size: int = 64,
                         backend: str = "cuda", device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Functional one-shot API (plans cached by their static choices)."""
    kernel = kernel or make_lennard_jones()
    if m_c is None:
        m_c = suggest_m_c(domain, positions)
    dev = torch.device("cuda" if device is None else device)
    p = _cached_plan(domain, kernel, m_c, strategy, batch_size, backend, dev)
    return p.execute(ParticleState(positions))
