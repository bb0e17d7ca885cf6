"""Dense cell-slot binning (PyTorch port of the dense part of
``repro.core.binning``).

Pipeline (paper order, atomic-free apart from the per-cell count):
  1. per-particle cell index,
  2. per-cell counts (``index_add_``, the port of ``segment_sum``),
  3. cell start offsets by the paper's prefix sum (the CUDA scan kernel on
     a CUDA tensor),
  4. stable sort by cell id -> rank of each particle within its cell,
  5. dense slot layout: every cell owns ``m_c`` contiguous slots in SoA
     planes of shape ``(nz+2, ny+2, (nx+2)*m_c)``, with a one-cell ghost ring
     (empty for open boundaries, wrapped copies for periodic ones).

Every output (``counts``, ``offsets``, ``particle_slot``, ``slot_id`` and the
position planes) is pure data movement and bit-identical to the JAX
package's. Where JAX's semantics do not carry over by themselves:

  * ``.at[flat].set(..., mode="drop")`` drops out-of-range rows; torch
    raises. Dropped rows (rank >= ``m_c``, ``valid`` False) are routed to
    one extra dump slot past the planes, which is then cut off.
  * ``plane.reshape(-1)[particle_slot]`` clamps in JAX, so a dropped
    particle (``particle_slot == total``) reads the last ghost slot, which
    is 0 in every output plane. ``gather_to_particles`` clamps the same way.
  * Torch slices alias where JAX's ``.at`` copies; every ghost fill below
    reads a freshly computed tensor, so the x -> y -> z order of the JAX
    code holds even on 1-cell-thick axes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .domain import Domain
from .prefix import exclusive_prefix_sum

# Sentinel coordinate for empty slots: far outside any box, finite.
EMPTY_POS = 1.0e8

# Slot-id offset carried by periodic ghost copies, so a particle interacts
# with its own periodic image but never with itself.
GHOST_ID_BUMP = 1_000_000_000


@dataclasses.dataclass
class CellBins:
    """Dense cell-slot state. All planes share shape (nz+2, ny+2, (nx+2)*m_c)."""

    planes: Dict[str, torch.Tensor]   # SoA field planes ("x","y","z",...)
    slot_id: torch.Tensor             # int32 particle index per slot, -1 empty
    counts: torch.Tensor              # (n_cells,) int32 particles per cell
    offsets: torch.Tensor             # (n_cells,) int32 exclusive prefix
    particle_slot: torch.Tensor       # (N,) int32 flat slot of each particle
    m_c: int


def padded_shape(domain: Domain, m_c: int) -> Tuple[int, int, int]:
    nx, ny, nz = domain.ncells
    return (nz + 2, ny + 2, (nx + 2) * m_c)


def _segment_count(cids: torch.Tensor, weights: torch.Tensor,
                   n_cells: int) -> torch.Tensor:
    counts = torch.zeros((n_cells,), dtype=torch.int32, device=cids.device)
    return counts.index_add_(0, cids.long(), weights)


def cell_counts(domain: Domain, positions: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_cells,) int32 particles per cell; ``valid`` False rows weigh 0."""
    weights = (torch.ones((positions.shape[0],), dtype=torch.int32,
                          device=positions.device) if valid is None
               else valid.to(torch.int32))
    return _segment_count(domain.cell_ids(positions), weights, domain.n_cells)


def bin_particles(domain: Domain, positions: torch.Tensor,
                  fields: Optional[Dict[str, torch.Tensor]] = None, *,
                  m_c: int, valid: Optional[torch.Tensor] = None) -> CellBins:
    """Bin particles into the dense slot layout.

    Args:
      positions: (N, 3) float32 tensor.
      fields: optional extra per-particle scalars to bin alongside x/y/z.
      m_c: max-particles-per-cell bound (paper's M_C); particles past it in
        a cell are dropped and read back as exactly 0.
      valid: optional (N,) bool mask; False rows are excluded from counts
        and never land in a slot.
    """
    # imported here: the kernels package registers into core.api, which
    # imports this module
    from ..kernels.prefix_sum import prefix_sum

    dev = positions.device
    n = positions.shape[0]
    nx, ny, nz = domain.ncells
    n_cells = domain.n_cells
    shape = padded_shape(domain, m_c)
    total = shape[0] * shape[1] * shape[2]
    if total >= 2 ** 31:
        raise ValueError(f"{total} slots exceed the int32 slot index; "
                         "use a smaller m_c or grid")

    coords = domain.cell_coords(positions)          # (N, 3) int32
    cids = domain.linearize(coords)                 # (N,)

    if valid is None:
        weights = torch.ones((n,), dtype=torch.int32, device=dev)
        sort_key = cids
    else:
        # invalid rows carry weight 0 in cell 0 and sort past every cell
        weights = valid.to(torch.int32)
        cids = torch.where(valid, cids, torch.zeros_like(cids))
        sort_key = torch.where(valid, cids, torch.full_like(cids, n_cells))

    counts = _segment_count(cids, weights, n_cells)
    offsets = exclusive_prefix_sum(counts, scan=prefix_sum)

    # rank of each particle within its cell via one stable sort
    sorted_key, order = torch.sort(sort_key, stable=True)
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - offsets[torch.clamp(sorted_key, 0, n_cells - 1).long()])

    cxyz = coords[order].long()
    row_len = (nx + 2) * m_c
    slot_col = (cxyz[:, 0] + 1) * m_c + rank
    flat = ((cxyz[:, 2] + 1) * (ny + 2) + (cxyz[:, 1] + 1)) * row_len + slot_col
    keep = (rank < m_c) & (sorted_key < n_cells)
    flat = torch.where(keep, flat, torch.full_like(flat, total))

    def scatter(sorted_values: torch.Tensor, fill, dtype) -> torch.Tensor:
        # slot ``total`` is the dump slot of dropped rows, cut off below
        plane = torch.full((total + 1,), fill, dtype=dtype, device=dev)
        plane[flat] = sorted_values.to(dtype)
        return plane[:total].view(shape)

    pdt = positions.dtype
    sorted_pos = positions[order]
    planes = {
        "x": scatter(sorted_pos[:, 0], EMPTY_POS, pdt),
        "y": scatter(sorted_pos[:, 1], EMPTY_POS, pdt),
        "z": scatter(sorted_pos[:, 2], EMPTY_POS, pdt),
    }
    for k, v in (fields or {}).items():
        planes[k] = scatter(v[order], 0.0, v.dtype)

    slot_id = scatter(order, -1, torch.int32)

    particle_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    particle_slot[order] = flat.to(torch.int32)

    bins = CellBins(planes=planes, slot_id=slot_id, counts=counts,
                    offsets=offsets, particle_slot=particle_slot, m_c=m_c)
    if domain.any_periodic:
        _fill_periodic_ghosts(domain, bins)
    return bins


def _fill_periodic_ghosts(domain: Domain, bins: CellBins) -> None:
    """Copy wrapped interior slabs into the ghost ring (minimum image), per
    periodic axis, in place. Axes go x, then y, then z, each reading what the
    previous one wrote; every right-hand side is a new tensor, so a source
    that overlaps its target (1-cell-thick axes) is read before the write."""
    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    lx, ly, lz = domain.box
    px, py, pz = domain.periodic_axes

    def shifted(src: torch.Tensor, d: float) -> torch.Tensor:
        return src + d if d else src.clone()

    for field, plane in bins.planes.items():
        if px:
            dx = lx if field == "x" else 0.0
            left = shifted(plane[:, :, nx * m_c:(nx + 1) * m_c], -dx)
            right = shifted(plane[:, :, m_c:2 * m_c], dx)
            plane[:, :, 0:m_c] = left
            plane[:, :, (nx + 1) * m_c:] = right
        if py:
            dy = ly if field == "y" else 0.0
            plane[:, 0, :] = shifted(plane[:, ny, :], -dy)
            plane[:, ny + 1, :] = shifted(plane[:, 1, :], dy)
        if pz:
            dz = lz if field == "z" else 0.0
            plane[0, :, :] = shifted(plane[nz, :, :], -dz)
            plane[nz + 1, :, :] = shifted(plane[1, :, :], dz)

    # Ghost slots mirror the interior ids bumped by GHOST_ID_BUMP; the bump
    # is computed from the plane as it stands before each axis's writes.
    s = bins.slot_id

    def bump(t):
        return torch.where((t >= 0) & (t < GHOST_ID_BUMP), t + GHOST_ID_BUMP, t)

    if px:
        big = bump(s)
        s[:, :, 0:m_c] = big[:, :, nx * m_c:(nx + 1) * m_c]
        s[:, :, (nx + 1) * m_c:] = big[:, :, m_c:2 * m_c]
    if py:
        big = bump(s)
        s[:, 0, :] = big[:, ny, :]
        s[:, ny + 1, :] = big[:, 1, :]
    if pz:
        big = bump(s)
        s[0, :, :] = big[nz, :, :]
        s[nz + 1, :, :] = big[1, :, :]


def gather_to_particles(bins: CellBins, plane: torch.Tensor) -> torch.Tensor:
    """Read a per-slot plane back to particle order (inverse of scatter).
    Indices clamp to the last slot, as JAX's gather does: dropped particles
    carry ``particle_slot == total`` and read the last ghost slot."""
    flat = plane.reshape(-1)
    idx = torch.clamp(bins.particle_slot, max=flat.shape[0] - 1).long()
    return flat[idx]


def interior(domain: Domain, plane: torch.Tensor, m_c: int) -> torch.Tensor:
    """View of the non-ghost region, reshaped to (nz, ny, nx, m_c)."""
    nx, ny, nz = domain.ncells
    core = plane[1:nz + 1, 1:ny + 1, m_c:(nx + 1) * m_c]
    return core.reshape(nz, ny, nx, m_c)


def interior_to_padded(domain: Domain, plane: torch.Tensor,
                       m_c: int) -> torch.Tensor:
    """(nz, ny, nx, m_c) interior tensor -> padded plane (ghosts zero)."""
    nx, ny, nz = domain.ncells
    padded = torch.zeros(padded_shape(domain, m_c), dtype=plane.dtype,
                         device=plane.device)
    padded[1:nz + 1, 1:ny + 1, m_c:(nx + 1) * m_c] = \
        plane.reshape(nz, ny, nx * m_c)
    return padded


def dense_to_particles(domain: Domain, bins: CellBins, fx, fy, fz, pot
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (nz, ny, nx, m_c) schedule outputs -> per-particle
    (forces (N, 3), potential (N,)), the backend-registry output contract."""
    out = []
    for plane in (fx, fy, fz, pot):
        shaped = plane.reshape(domain.nz, domain.ny, domain.nx, bins.m_c)
        out.append(gather_to_particles(
            bins, interior_to_padded(domain, shaped, bins.m_c)))
    return torch.stack(out[:3], dim=-1), out[3]
