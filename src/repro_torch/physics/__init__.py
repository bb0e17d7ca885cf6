"""MD/SPH substrate on top of the cell-list engine (port of
``repro.physics``)."""

from .integrators import MDState, init_state, leapfrog, run, velocity_verlet
from .observables import (kinetic_energy, potential_energy, temperature,
                          total_energy, total_momentum)
from . import sph

__all__ = ["MDState", "init_state", "leapfrog", "run", "velocity_verlet",
           "kinetic_energy", "potential_energy", "temperature",
           "total_energy", "total_momentum", "sph"]
