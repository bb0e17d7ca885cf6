"""The particle system a configuration states: its cube, its grids, its
pair kernel and its start, made from the seed. Shared by the traffic
kinds; the reference gets the same numbers from the configuration."""

from __future__ import annotations

from repro_torch.core import Domain, make_lennard_jones

from .. import gen


def box(cfg: dict) -> float:
    return cfg["unit_cells"] * cfg["lattice_constant"]


def n_atoms(cfg: dict) -> int:
    return 4 * cfg["unit_cells"] ** 3


def cutoff_domain(cfg: dict) -> Domain:
    """The periodic cube on its cutoff grid (cell width >= cutoff): the
    grid a user hands ``plan()``; a trajectory coarsens it by the skin."""
    side = box(cfg)
    nc = int(side / cfg["cutoff"] + 1e-9)
    return Domain(box=(side,) * 3, ncells=(nc,) * 3, cutoff=cfg["cutoff"],
                  periodic=True)


def kernel(cfg: dict):
    return make_lennard_jones(sigma=cfg["sigma"], eps=cfg["epsilon"],
                              softening=cfg["softening"])


def reference_kwargs(cfg: dict) -> dict:
    return {"sigma": cfg["sigma"], "eps": cfg["epsilon"],
            "softening": cfg["softening"]}


def start(cfg: dict, seed: int, device, jitter: float,
          gaussian: bool = False):
    """(positions, velocities) of the configuration's start: its fcc
    lattice, jittered, and velocities at its temperature."""
    g = gen.generator(seed, device)
    pos = gen.fcc_lattice(cfg["unit_cells"], cfg["lattice_constant"],
                          jitter, g, device, gaussian=gaussian)
    vel = gen.velocities(pos.shape[0], cfg["temperature"], g, device,
                         cfg["mass"])
    return pos, vel
