"""The port's core: domain, pair kernels, binning, schedules, plan/execute."""

from .api import (InteractionPlan, ParticleState, get_backend, plan,
                  register_backend)
from .binning import (EMPTY_POS, GHOST_ID_BUMP, CellBins, bin_particles,
                      cell_counts, dense_to_particles, gather_to_particles)
from .domain import Domain
from .engine import suggest_m_c
from .interactions import (PairKernel, make_gravity, make_high_flop,
                           make_lennard_jones, make_low_flop, make_sph_density)

__all__ = [
    "CellBins", "Domain", "EMPTY_POS", "GHOST_ID_BUMP", "InteractionPlan",
    "PairKernel", "ParticleState", "bin_particles", "cell_counts",
    "dense_to_particles", "gather_to_particles", "get_backend",
    "make_gravity", "make_high_flop", "make_lennard_jones", "make_low_flop",
    "make_sph_density", "plan", "register_backend", "suggest_m_c",
]
