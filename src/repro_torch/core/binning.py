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


# --------------------------------------------------------------------------
# occupancy: the sparsity summary behind the compacted schedules
# --------------------------------------------------------------------------
#
# Port of the JAX package's occupancy summary: per-unit particle counts plus
# a compacted list of the active units ((z, y) pencils, or the sub-boxes of
# the All-in-SM tiling) under a static ``max_active`` bound that follows the
# m_c replan contract (overflow is detectable, never silent).
# ``jnp.nonzero(size=..., fill_value=0)`` has no static-size torch twin and
# ``torch.nonzero`` waits on the device, so the list is built without a host
# sync: a running count of the active units gives each its place, and
# inactive or overflowing units go to a dump slot that is cut off.


@dataclasses.dataclass
class Occupancy:
    """Compacted active-work-unit summary (pencils or sub-boxes).

    ``active`` holds the linearized ids of the units with at least one
    particle, in ascending order, padded to the static bound ``max_active``
    with unit 0 (always a valid unit to *read*; padded entries are dropped
    on the write side via :meth:`scatter_indices`). ``n_active`` is the true
    count; above ``max_active`` the summary has overflowed and results
    computed from it miss units, exactly like a cell overflowing m_c.
    """

    unit_counts: torch.Tensor     # (n_units,) int32 particles per work unit
    active: torch.Tensor          # (max_active,) int32 unit ids, 0-padded
    n_active: torch.Tensor        # () int32 true number of active units
    max_active: int
    n_units: int

    @property
    def overflowed(self) -> torch.Tensor:
        """True when active units were dropped from ``active`` (replan)."""
        return self.n_active > self.max_active

    def scatter_indices(self) -> torch.Tensor:
        """(max_active,) write-side unit ids: padding entries point at
        ``n_units``, the dump row of a ``(n_units + 1, ...)`` scatter."""
        slot = torch.arange(self.max_active, dtype=torch.int32,
                            device=self.active.device)
        return torch.where(slot < self.n_active, self.active,
                           torch.full_like(self.active, self.n_units))

    @property
    def fill_fraction(self) -> torch.Tensor:
        return self.n_active / max(self.n_units, 1)


def _compact_active(unit_counts: torch.Tensor, max_active: int,
                    n_units: int) -> Occupancy:
    flag = unit_counts > 0
    place = torch.cumsum(flag.to(torch.int32), 0, dtype=torch.int32) - 1
    dest = torch.where(flag & (place < max_active), place,
                       torch.full_like(place, max_active)).long()
    buf = torch.zeros((max_active + 1,), dtype=torch.int32,
                      device=unit_counts.device)
    buf[dest] = torch.arange(n_units, dtype=torch.int32,
                             device=unit_counts.device)
    return Occupancy(unit_counts=unit_counts, active=buf[:max_active],
                     n_active=flag.sum(dtype=torch.int32),
                     max_active=max_active, n_units=n_units)


def scatter_rows(rows: torch.Tensor, idx: torch.Tensor,
                 n_units: int) -> torch.Tensor:
    """(max_active, W) compact rows -> (n_units, W), zero where no row
    lands; rows whose ``idx`` is ``n_units`` (``scatter_indices``'s
    padding) go to a dump row that is cut off."""
    out = rows.new_zeros((n_units + 1, rows.shape[-1]))
    out[idx.long()] = rows
    return out[:n_units]


def full_pencil_occupancy(domain: Domain,
                          device: torch.device | str = "cpu") -> Occupancy:
    """The identity occupancy: every (z, y) pencil active, in order, so the
    packed runners iterate all rows through the active-list machinery."""
    n = domain.nz * domain.ny
    return Occupancy(
        unit_counts=torch.ones((n,), dtype=torch.int32, device=device),
        active=torch.arange(n, dtype=torch.int32, device=device),
        n_active=torch.tensor(n, dtype=torch.int32, device=device),
        max_active=n, n_units=n)


def counts_grid(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """(n_cells,) linear cell counts -> (nz, ny, nx) grid (X fastest)."""
    return counts.reshape(domain.nz, domain.ny, domain.nx)


def pencil_counts(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """(n_cells,) cell counts -> (nz*ny,) int32 particles per (z, y)
    X-pencil; unit id = z * ny + y."""
    return counts_grid(domain, counts).sum(-1, dtype=torch.int32).reshape(-1)


def pencil_occupancy(domain: Domain, counts: torch.Tensor,
                     max_active: int) -> Occupancy:
    """Active (z, y) X-pencils of ``CellBins.counts``."""
    return _compact_active(pencil_counts(domain, counts), max_active,
                           domain.nz * domain.ny)


def subbox_counts(domain: Domain, counts: torch.Tensor,
                  box: Tuple[int, int, int]) -> torch.Tensor:
    """(n_cells,) cell counts -> (gz*gy*gx,) int32 particles per sub-box of
    the All-in-SM tiling. ``box`` = (bx, by, bz) must divide the grid; unit
    id = iz*(gy*gx) + iy*gx + ix, the sub-box order of the allin schedule."""
    nx, ny, nz = domain.ncells
    bx, by, bz = box
    grid = counts_grid(domain, counts).reshape(nz // bz, bz, ny // by, by,
                                               nx // bx, bx)
    return grid.sum((1, 3, 5), dtype=torch.int32).reshape(-1)


def subbox_occupancy(domain: Domain, counts: torch.Tensor,
                     box: Tuple[int, int, int], max_active: int) -> Occupancy:
    """Active sub-boxes of ``CellBins.counts`` (unit ids as in
    :func:`subbox_counts`)."""
    nx, ny, nz = domain.ncells
    bx, by, bz = box
    return _compact_active(subbox_counts(domain, counts, box), max_active,
                           (nx // bx) * (ny // by) * (nz // bz))


def gather_pencil_rows(plane: torch.Tensor, active_zy: torch.Tensor, ny: int,
                       dz: int = 0, dy: int = 0) -> torch.Tensor:
    """One padded row per pencil id: row ``a`` is the padded
    ``(z + dz + 1, y + dy + 1)`` row of ``plane`` for ``active_zy[a] =
    z * ny + y``."""
    zy = active_zy.long()
    return plane[zy // ny + 1 + dz, zy % ny + 1 + dy]


# --------------------------------------------------------------------------
# packed-row layout: CSR-style slot compaction per pencil row
# --------------------------------------------------------------------------
#
# Each padded (z, y) pencil row stores its particles contiguously (cell
# order kept) under a static ``row_cap`` bound with the replan contract of
# m_c; per-cell start offsets come from the paper's §6 scan (kernel A on a
# CUDA tensor), so the dense layout's contiguous 3-cell X-window becomes an
# (offset, length) range.


@dataclasses.dataclass
class PackedRows:
    """CSR cell layout: per-pencil packed rows + scan-built cell offsets.

    Every padded (z, y) pencil row, ghost ring included, owns ``row_cap``
    slots; the row's particles (X-ghost copies included) sit at the front
    in cell-then-rank order, the dense row's order minus its empty slots.
    ``cell_offsets[..., c]`` is where padded cell ``c`` starts, so a target
    in cell ``c`` reads ``[cell_offsets[c-1], cell_offsets[c+2])``. A row
    holding more than ``row_cap`` particles drops its tail (``overflowed``).
    """

    planes: Dict[str, torch.Tensor]   # (nz+2, ny+2, row_cap) packed fields
    slot_id: torch.Tensor             # (nz+2, ny+2, row_cap) int32, -1 pad
    slot_cell: torch.Tensor           # (nz+2, ny+2, row_cap) int32 cell
    cell_offsets: torch.Tensor        # (nz+2, ny+2, nx+3) int32
    row_counts: torch.Tensor          # (nz+2, ny+2) int32 particles per row
    counts: torch.Tensor              # (n_cells,) pass-through from CellBins
    particle_slot: torch.Tensor       # (N,) int32 interior packed slot
    row_cap: int
    m_c: int

    @property
    def overflowed(self) -> torch.Tensor:
        """True when some row held more than ``row_cap`` particles."""
        return self.row_counts.max() > self.row_cap


def padded_row_counts(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """(n_cells,) cell counts -> (nz, ny) int32 particles per *padded*
    pencil row: the interior particles plus, under a periodic X axis, the
    ghost copies of the first and last cell (a 1-cell-thick periodic X axis
    counts its cell three times). Ghost Y/Z rows copy interior rows, so the
    interior maximum covers every padded row."""
    grid = counts_grid(domain, counts)
    per_row = grid.sum(-1, dtype=torch.int32)
    if domain.periodic_axes[0]:
        per_row = per_row + grid[..., 0] + grid[..., -1]
    return per_row


def pack_rows(domain: Domain, bins: CellBins, row_cap: int) -> PackedRows:
    """Compact a dense :class:`CellBins` into the packed-row layout.

    Per padded row, the occupied slots give per-cell counts, the §6 scan
    turns them into start offsets, and every occupied dense slot (cell c,
    rank r) moves to packed position ``offsets[c] + r``. The scan is one
    rank-1 exclusive scan over all rows' counts (kernel A on a CUDA tensor)
    minus each row's first entry: exact in int32 and equal to a per-row
    scan. Slots past ``row_cap`` go to a dump slot that is cut off.
    """
    from ..kernels.prefix_sum import prefix_sum

    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    nzp, nyp = nz + 2, ny + 2
    dev = bins.slot_id.device
    shape4 = (nzp, nyp, nx + 2, m_c)

    occupied = bins.slot_id.view(shape4) >= 0
    cell_counts_p = occupied.sum(-1, dtype=torch.int32)    # (nzp, nyp, nx+2)
    flat_scan = exclusive_prefix_sum(cell_counts_p.reshape(-1),
                                     scan=prefix_sum).view(cell_counts_p.shape)
    offsets = flat_scan - flat_scan[..., :1]
    row_counts = cell_counts_p.sum(-1, dtype=torch.int32)  # (nzp, nyp)
    cell_offsets = torch.cat([offsets, row_counts[..., None]], dim=-1)

    rank = torch.arange(m_c, dtype=torch.int32, device=dev)
    dest = offsets[..., None] + rank                       # (nzp,nyp,nx+2,m_c)
    row_base = (torch.arange(nzp, device=dev)[:, None] * nyp
                + torch.arange(nyp, device=dev)[None, :])
    total = nzp * nyp * row_cap
    flat = row_base[..., None, None] * row_cap + dest
    flat = torch.where(occupied & (dest < row_cap), flat,
                       torch.full_like(flat, total)).reshape(-1)

    def pack(plane: torch.Tensor, fill) -> torch.Tensor:
        # slot ``total`` is the dump slot of empty and overflowing slots
        out = torch.full((total + 1,), fill, dtype=plane.dtype, device=dev)
        out[flat] = plane.reshape(-1)
        return out[:total].view(nzp, nyp, row_cap)

    planes = {name: pack(plane, EMPTY_POS if name in ("x", "y", "z") else 0.0)
              for name, plane in bins.planes.items()}
    slot_id = pack(bins.slot_id, -1)
    # padding slots read cell 1 (a valid interior cell) so window arithmetic
    # stays in bounds; their results are masked by slot_id == -1
    cell_idx = torch.arange(nx + 2, dtype=torch.int32, device=dev)
    slot_cell = pack(cell_idx[:, None].expand(shape4), 1)

    # per-particle packed slot (interior rows only). JAX clamps each gather
    # index, so a particle the dense binning dropped (particle_slot ==
    # total) reads offsets[nz+1, 0, 0] == 0 and lands past the unpacked
    # array, where unpack_scatter's clamp reads the zero pad slot.
    row_len = (nx + 2) * m_c
    ds = bins.particle_slot.long()
    zp = ds // (nyp * row_len)
    rem = ds % (nyp * row_len)
    yp = rem // row_len
    col = rem % row_len
    c = col // m_c
    r = col % m_c
    pos_in_row = offsets[torch.clamp(zp, max=nzp - 1), yp, c] + r
    pos_in_row = torch.clamp(pos_in_row, max=row_cap)
    particle_slot = (((zp - 1) * ny + (yp - 1)) * (row_cap + 1)
                     + pos_in_row).to(torch.int32)

    return PackedRows(planes=planes, slot_id=slot_id, slot_cell=slot_cell,
                      cell_offsets=cell_offsets, row_counts=row_counts,
                      counts=bins.counts, particle_slot=particle_slot,
                      row_cap=row_cap, m_c=m_c)


def unpack_scatter(domain: Domain, packed: PackedRows,
                   rows: torch.Tensor) -> torch.Tensor:
    """Packed per-slot values back to particle order.

    ``rows`` holds one value per *interior* packed slot, ``(nz * ny,
    row_cap)`` in pencil-id order. Particles past ``row_cap`` read a zero
    pad slot; particles the dense binning dropped point past the array and
    are clamped onto the last pad slot, as JAX's gather clamps."""
    nz, ny = domain.nz, domain.ny
    per_row = rows.reshape(nz * ny, packed.row_cap)
    padded = torch.cat([per_row, per_row.new_zeros((nz * ny, 1))], dim=-1)
    flat = padded.reshape(-1)
    idx = torch.clamp(packed.particle_slot, max=flat.shape[0] - 1).long()
    return flat[idx]


def packed_to_particles(domain: Domain, packed: PackedRows, fx, fy, fz, pot
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed ``(nz * ny, row_cap)`` schedule outputs -> per-particle
    (forces (N, 3), potential (N,)), the same contract as
    :func:`dense_to_particles`."""
    out = [unpack_scatter(domain, packed, p) for p in (fx, fy, fz, pot)]
    return torch.stack(out[:3], dim=-1), out[3]
