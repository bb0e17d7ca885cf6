"""Simulation domain and uniform cell grid (PyTorch port of ``repro.core.domain``).

A 3-D box divided into a regular grid whose cell width is at least the
cutoff radius ``r_c``, so every interaction partner of a particle lives in the
particle's own cell or one of its 26 neighbours. Cells are linearized
X-fastest, so a pencil of cells along X is contiguous in memory.

Cell coordinates must be bit-identical to the JAX package's, or particles
land in different cells: positions are divided by a float32 width tensor and
floored, periodic axes wrap with a floor-mod (``torch.remainder``, not
``fmod``) and open axes clip.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Domain:
    """A rectangular simulation box with a uniform cell grid.

    Attributes:
      box: physical box lengths ``(Lx, Ly, Lz)``.
      ncells: grid shape ``(nx, ny, nz)``; cell width = L / n >= cutoff.
      cutoff: interaction cutoff radius ``r_c``.
      periodic: wrap neighbour lookups (minimum image), for all axes or per
        axis.
    """

    box: Tuple[float, float, float]
    ncells: Tuple[int, int, int]
    cutoff: float
    periodic: bool | Tuple[bool, bool, bool] = False

    def __post_init__(self):
        for length, n in zip(self.box, self.ncells):
            width = length / n
            if width + 1e-9 < self.cutoff:
                raise ValueError(
                    f"cell width {width} < cutoff {self.cutoff}; the 27-cell "
                    "neighborhood would miss interactions"
                )

    @property
    def periodic_axes(self) -> Tuple[bool, bool, bool]:
        if isinstance(self.periodic, tuple):
            return self.periodic
        return (bool(self.periodic),) * 3

    @property
    def any_periodic(self) -> bool:
        return any(self.periodic_axes)

    # -- static geometry ----------------------------------------------------

    @property
    def nx(self) -> int:
        return self.ncells[0]

    @property
    def ny(self) -> int:
        return self.ncells[1]

    @property
    def nz(self) -> int:
        return self.ncells[2]

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def cell_width(self) -> Tuple[float, float, float]:
        return tuple(l / n for l, n in zip(self.box, self.ncells))

    @classmethod
    def cubic(cls, division: int, cutoff: float = 1.0,
              periodic: bool = False) -> "Domain":
        """The paper's benchmark geometry: a cube of ``division**3`` cells
        whose width equals the cutoff (box side = division * cutoff)."""
        side = division * cutoff
        return cls(box=(side,) * 3, ncells=(division,) * 3, cutoff=cutoff,
                   periodic=periodic)

    # -- indexing ------------------------------------------------------------

    def cell_coords(self, positions: torch.Tensor) -> torch.Tensor:
        """(N, 3) positions -> (N, 3) int32 cell coordinates (ix, iy, iz)."""
        dev = positions.device
        widths = torch.tensor(self.cell_width, dtype=positions.dtype,
                              device=dev)
        coords = torch.floor(positions / widths).to(torch.int32)
        ns = torch.tensor(self.ncells, dtype=torch.int32, device=dev)
        wrapped = torch.remainder(coords, ns)
        clipped = torch.minimum(torch.clamp(coords, min=0), ns - 1)
        per = torch.tensor(self.periodic_axes, device=dev)
        return torch.where(per, wrapped, clipped)

    def linearize(self, coords: torch.Tensor) -> torch.Tensor:
        """(..., 3) cell coords -> linear index, X fastest (paper layout)."""
        ix, iy, iz = coords[..., 0], coords[..., 1], coords[..., 2]
        return (iz * self.ny + iy) * self.nx + ix

    def cell_ids(self, positions: torch.Tensor) -> torch.Tensor:
        return self.linearize(self.cell_coords(positions))

    def neighbor_offsets(self) -> np.ndarray:
        """The (27, 3) stencil of neighbour cell offsets, X fastest."""
        offs = [(dx, dy, dz)
                for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        return np.asarray(offs, dtype=np.int32)

    def box_tensors(self, device, dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(box lengths (3,), periodic mask (3,) bool, a 0-d zero) on
        ``device``, made once per (domain, device, dtype) and shared: a
        tensor built from a Python list on the card is a copy that waits
        for the device, which a per-step caller should not pay. Never
        write to them."""
        return _box_tensors(self, torch.device(device), dtype)

    def minimum_image(self, delta: torch.Tensor) -> torch.Tensor:
        """Wrap a displacement vector into the minimum image (periodic axes)."""
        if not self.any_periodic:
            return delta
        box, per, zero = self.box_tensors(delta.device, delta.dtype)
        return delta - torch.where(per, box * torch.round(delta / box), zero)

    def sample_uniform(self, n: int, *,
                       generator: Optional[torch.Generator] = None,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None
                       ) -> torch.Tensor:
        """Uniformly distributed particles (the paper's benchmark input).
        Draws from ``generator``, which must live on ``device``. ``device``
        None means the CUDA card, and raises when none is visible."""
        device = resolve_device(device)
        box = torch.tensor(self.box, dtype=dtype, device=device)
        return torch.rand((n, 3), generator=generator, dtype=dtype,
                          device=device) * box


@functools.lru_cache(maxsize=64)
def _box_tensors(domain: Domain, device: torch.device, dtype: torch.dtype):
    return (torch.tensor(domain.box, dtype=dtype, device=device),
            torch.tensor(domain.periodic_axes, device=device),
            torch.zeros((), dtype=dtype, device=device))


def skin_domain(domain: Domain, skin: float) -> Domain:
    """The Verlet-skin twin of a domain: same box, cutoff and periodicity,
    but a grid coarse enough that every cell width is at least
    ``cutoff + skin``. ``skin=0`` returns the domain unchanged."""
    if skin < 0:
        raise ValueError(f"skin must be >= 0, got {skin}")
    if skin == 0:
        return domain
    width = domain.cutoff + skin
    ncells = tuple(max(1, int(length / width + 1e-9))
                   for length in domain.box)
    return Domain(box=domain.box, ncells=ncells, cutoff=domain.cutoff,
                  periodic=domain.periodic)


def effective_skin(domain: Domain) -> float:
    """The Verlet-skin margin a domain's grid actually provides:
    ``min(cell_width) - cutoff`` (>= 0 by the Domain validation)."""
    return max(0.0, min(domain.cell_width) - domain.cutoff)


def slab_domain(domain: Domain, n_shards: int) -> Domain:
    """The Z-slab subdomain one halo shard owns: the global grid split into
    ``n_shards`` equal slabs along Z, with Z forced non-periodic (a shard's
    Z ghost planes come from the halo exchange, never from local wrapping).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if domain.nz % n_shards:
        raise ValueError(
            f"nz={domain.nz} not divisible by n_shards={n_shards}")
    px, py, _ = domain.periodic_axes
    return Domain(
        box=(domain.box[0], domain.box[1], domain.box[2] / n_shards),
        ncells=(domain.nx, domain.ny, domain.nz // n_shards),
        cutoff=domain.cutoff, periodic=(px, py, False))
