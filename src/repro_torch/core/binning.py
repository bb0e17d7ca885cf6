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

Stacked systems (the port of JAX's ``vmap`` over ``bin_particles``):
positions ``(B, N, 3)`` are binned in the launches of one system, and every
output gains a leading system axis. The cell key is ``b * n_cells + cell``,
so one count, one scan and one stable sort cover the batch; each system's
ranks, slots and ids (``slot_id`` holds indices in [0, N)) equal what
binning it alone gives. Dump slots and gather clamps stay per system. The
occupancy, packing, SFC and scatter-back functions below take the same
optional leading axis.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .domain import Domain
from .prefix import exclusive_prefix_sum

# Sentinel coordinate for empty slots: far outside any box, finite.
EMPTY_POS = 1.0e8

# Slot-id offset carried by periodic ghost copies, so a particle interacts
# with its own periodic image but never with itself.
GHOST_ID_BUMP = 1_000_000_000


@dataclasses.dataclass
class CellBins:
    """Dense cell-slot state. All planes share shape (nz+2, ny+2, (nx+2)*m_c);
    stacked systems add a leading axis to every tensor."""

    planes: Dict[str, torch.Tensor]   # SoA field planes ("x","y","z",...)
    slot_id: torch.Tensor             # int32 particle index per slot, -1 empty
    counts: torch.Tensor              # (n_cells,) int32 particles per cell
    offsets: torch.Tensor             # (n_cells,) int32 exclusive prefix
    particle_slot: torch.Tensor       # (N,) int32 flat slot of each particle
    m_c: int


def _system_of(value, b: int):
    if isinstance(value, torch.Tensor):
        return value[b]
    if isinstance(value, dict):
        return {k: _system_of(v, b) for k, v in value.items()}
    if dataclasses.is_dataclass(value):
        return system(value, b)
    return value


def system(data, b: int):
    """System ``b`` of stacked data (``CellBins``, ``PackedRows``,
    ``SfcClusters``, ``Occupancy`` or a ``ParticleState``): every tensor
    indexed on its leading axis, as views; bounds and names kept."""
    return dataclasses.replace(data, **{
        f.name: _system_of(getattr(data, f.name), b)
        for f in dataclasses.fields(data)})


def _system_bases(lead: Tuple[int, ...], stride: int,
                  device) -> torch.Tensor:
    """(*lead, 1) int64 start of each system's block of ``stride``
    elements in a flat buffer over the batch. Callers skip it for one
    system, whose block starts the buffer, so that ``execute`` launches
    what it launched before batches existed."""
    n_sys = math.prod(lead)
    return torch.arange(0, n_sys * stride, stride,
                        device=device).view(*lead, 1)


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
      positions: (N, 3) float32 tensor, or (B, N, 3) for B systems stacked
        on a leading axis (fields and ``valid`` then (B, N)); stacked
        systems are binned in one chain of launches, and every output gains
        the leading axis.
      fields: optional extra per-particle scalars to bin alongside x/y/z.
      m_c: max-particles-per-cell bound (paper's M_C); particles past it in
        a cell are dropped and read back as exactly 0.
      valid: optional (N,) bool mask; False rows are excluded from counts
        and never land in a slot.
    """
    if positions.dim() == 2:          # one system: the batch of one
        return system(bin_particles(
            domain, positions[None],
            {k: v[None] for k, v in (fields or {}).items()}, m_c=m_c,
            valid=None if valid is None else valid[None]), 0)
    # imported here: the kernels package registers into core.api, which
    # imports this module
    from ..kernels.prefix_sum import prefix_sum

    dev = positions.device
    n_sys, n = positions.shape[:2]
    nx, ny, nz = domain.ncells
    n_cells = domain.n_cells
    shape = padded_shape(domain, m_c)
    total = shape[0] * shape[1] * shape[2]
    if n_sys * total >= 2 ** 31:
        raise ValueError(f"{n_sys} x {total} slots exceed the int32 slot "
                         "index; use a smaller m_c, grid or batch")
    n_keys = n_sys * n_cells          # one key per (system, cell)

    coords = domain.cell_coords(positions)          # (B, N, 3) int32
    key = domain.linearize(coords)                  # (B, N)
    if valid is not None:
        # invalid rows carry weight 0 in their system's cell 0 and sort
        # past every cell of every system
        key = torch.where(valid, key, 0)
    if n_sys > 1:                                   # b * n_cells + cid
        key = key + torch.arange(0, n_keys, n_cells, dtype=torch.int32,
                                 device=dev)[:, None]
    if valid is None:
        weights = torch.ones((n_sys, n), dtype=torch.int32, device=dev)
        sort_key = key
    else:
        weights = valid.to(torch.int32)
        sort_key = torch.where(valid, key, n_keys)

    counts = _segment_count(key.reshape(-1), weights.reshape(-1), n_keys)
    start = exclusive_prefix_sum(counts, scan=prefix_sum)

    # rank of each particle within its cell via one stable sort: it keeps
    # each system's order, so ranks are those of a per-system sort
    sorted_key, order = torch.sort(sort_key.reshape(-1), stable=True)
    rank = (torch.arange(n_sys * n, dtype=torch.int32, device=dev)
            - start[torch.clamp(sorted_key, 0, n_keys - 1).long()])

    cxyz = coords.reshape(-1, 3)[order].long()
    row_len = (nx + 2) * m_c
    slot_col = (cxyz[:, 0] + 1) * m_c + rank
    flat = ((cxyz[:, 2] + 1) * (ny + 2) + (cxyz[:, 1] + 1)) * row_len + slot_col
    keep = (rank < m_c) & (sorted_key < n_keys)
    # ``total`` is each system's dump slot of dropped rows (particle_slot);
    # in the batch's planes they all go to one dump slot, cut off below
    flat = torch.where(keep, flat, total)
    dest, ids = flat, order
    if n_sys > 1:
        owner = order // n                           # system of each row
        dest = torch.where(keep, flat + owner * total, n_sys * total)
        ids = order - owner * n

    def scatter(sorted_values: torch.Tensor, fill, dtype) -> torch.Tensor:
        plane = torch.full((n_sys * total + 1,), fill, dtype=dtype, device=dev)
        plane[dest] = sorted_values.to(dtype)
        return plane[:n_sys * total].view(n_sys, *shape)

    pdt = positions.dtype
    sorted_pos = positions.reshape(-1, 3)[order]
    planes = {
        "x": scatter(sorted_pos[:, 0], EMPTY_POS, pdt),
        "y": scatter(sorted_pos[:, 1], EMPTY_POS, pdt),
        "z": scatter(sorted_pos[:, 2], EMPTY_POS, pdt),
    }
    for k, v in (fields or {}).items():
        planes[k] = scatter(v.reshape(-1)[order], 0.0, v.dtype)

    slot_id = scatter(ids, -1, torch.int32)

    particle_slot = torch.empty((n_sys * n,), dtype=torch.int32, device=dev)
    particle_slot[order] = flat.to(torch.int32)

    start = start.view(n_sys, n_cells)
    bins = CellBins(planes=planes, slot_id=slot_id,
                    counts=counts.view(n_sys, n_cells),
                    offsets=start - start[:, :1] if n_sys > 1 else start,
                    particle_slot=particle_slot.view(n_sys, n), m_c=m_c)
    if domain.any_periodic:
        _fill_periodic_ghosts(domain, bins)
    return bins


def _fill_periodic_ghosts(domain: Domain, bins: CellBins) -> None:
    """Copy wrapped interior slabs into the ghost ring (minimum image), per
    periodic axis, in place. Axes go x, then y, then z, each reading what the
    previous one wrote; every right-hand side is a new tensor, so a source
    that overlaps its target (1-cell-thick axes) is read before the write.
    Planes may carry leading system axes."""
    _fill_ghost_planes(domain, bins.planes, bins.m_c)
    nx, ny, nz = domain.ncells
    m_c = bins.m_c
    px, py, pz = domain.periodic_axes

    # Ghost slots mirror the interior ids bumped by GHOST_ID_BUMP; the bump
    # is computed from the plane as it stands before each axis's writes.
    s = bins.slot_id

    def bump(t):
        return torch.where((t >= 0) & (t < GHOST_ID_BUMP), t + GHOST_ID_BUMP, t)

    if px:
        big = bump(s)
        s[..., 0:m_c] = big[..., nx * m_c:(nx + 1) * m_c]
        s[..., (nx + 1) * m_c:] = big[..., m_c:2 * m_c]
    if py:
        big = bump(s)
        s[..., 0, :] = big[..., ny, :]
        s[..., ny + 1, :] = big[..., 1, :]
    if pz:
        big = bump(s)
        s[..., 0, :, :] = big[..., nz, :, :]
        s[..., nz + 1, :, :] = big[..., 1, :, :]


def _fill_ghost_planes(domain: Domain, planes: Dict[str, torch.Tensor],
                       m_c: int) -> None:
    """The value planes' part of :func:`_fill_periodic_ghosts`, in place."""
    nx, ny, nz = domain.ncells
    lx, ly, lz = domain.box
    px, py, pz = domain.periodic_axes

    def shifted(src: torch.Tensor, d: float) -> torch.Tensor:
        return src + d if d else src.clone()

    for field, plane in planes.items():
        if px:
            dx = lx if field == "x" else 0.0
            left = shifted(plane[..., nx * m_c:(nx + 1) * m_c], -dx)
            right = shifted(plane[..., m_c:2 * m_c], dx)
            plane[..., 0:m_c] = left
            plane[..., (nx + 1) * m_c:] = right
        if py:
            dy = ly if field == "y" else 0.0
            plane[..., 0, :] = shifted(plane[..., ny, :], -dy)
            plane[..., ny + 1, :] = shifted(plane[..., 1, :], dy)
        if pz:
            dz = lz if field == "z" else 0.0
            plane[..., 0, :, :] = shifted(plane[..., nz, :, :], -dz)
            plane[..., nz + 1, :, :] = shifted(plane[..., 1, :, :], dz)


def gather_to_particles(bins: CellBins, plane: torch.Tensor) -> torch.Tensor:
    """Read a per-slot plane back to particle order (inverse of scatter).
    Indices clamp to the last slot of the particle's own system, as JAX's
    gather does: dropped particles carry ``particle_slot == total`` and read
    their system's last ghost slot."""
    lead = bins.particle_slot.shape[:-1]
    flat = plane.reshape(*lead, -1)
    idx = torch.clamp(bins.particle_slot, max=flat.shape[-1] - 1).long()
    return torch.gather(flat, -1, idx)


def interior(domain: Domain, plane: torch.Tensor, m_c: int) -> torch.Tensor:
    """View of the non-ghost region, reshaped to (nz, ny, nx, m_c)."""
    nx, ny, nz = domain.ncells
    core = plane[..., 1:nz + 1, 1:ny + 1, m_c:(nx + 1) * m_c]
    return core.reshape(*plane.shape[:-3], nz, ny, nx, m_c)


def interior_to_padded(domain: Domain, plane: torch.Tensor,
                       m_c: int) -> torch.Tensor:
    """(nz, ny, nx, m_c) interior tensor -> padded plane (ghosts zero)."""
    nx, ny, nz = domain.ncells
    lead = plane.shape[:-4]
    padded = torch.zeros((*lead, *padded_shape(domain, m_c)),
                         dtype=plane.dtype, device=plane.device)
    padded[..., 1:nz + 1, 1:ny + 1, m_c:(nx + 1) * m_c] = \
        plane.reshape(*lead, nz, ny, nx * m_c)
    return padded


def dense_to_particles(domain: Domain, bins: CellBins, fx, fy, fz, pot
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (nz, ny, nx, m_c) schedule outputs -> per-particle
    (forces (N, 3), potential (N,)), the backend-registry output contract."""
    lead = bins.particle_slot.shape[:-1]
    out = []
    for plane in (fx, fy, fz, pot):
        shaped = plane.reshape(*lead, domain.nz, domain.ny, domain.nx,
                               bins.m_c)
        out.append(gather_to_particles(
            bins, interior_to_padded(domain, shaped, bins.m_c)))
    return torch.stack(out[:3], dim=-1), out[3]


# --------------------------------------------------------------------------
# Verlet-skin reuse: refresh slot contents without re-binning
# --------------------------------------------------------------------------
#
# Port of the JAX package's skin helpers. The trajectory engine
# (``repro_torch.traj``) keeps a slot assignment across timesteps and
# refreshes slot contents in place each step. As long as no particle has
# drifted more than skin/2 from the position it was binned at, the 27-cell
# neighborhood of a grid whose cells are ``cutoff + skin`` wide still covers
# every pair within the cutoff. ``max_displacement`` is the rebin predicate;
# ``refresh_bins`` is the per-step scatter that replaces a full
# ``bin_particles`` pass while the predicate says the bins still hold.


def max_displacement(domain: Domain, positions: torch.Tensor,
                     ref: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0-d max over particles of |positions - ref| (minimum image); 0 for
    no particles. Padding rows (``valid`` False) contribute zero. Stays on
    the device."""
    d = domain.minimum_image(positions - ref)
    mag = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                     + d[..., 2] * d[..., 2])
    if valid is not None:
        mag = torch.where(valid, mag, torch.zeros_like(mag))
    return torch.cat([mag.reshape(-1), mag.new_zeros(1)]).max()


def image_positions(domain: Domain, positions: torch.Tensor,
                    ref: torch.Tensor) -> torch.Tensor:
    """Positions shifted to the periodic image nearest ``ref``.

    Stale bins store each particle near where it was binned; a particle
    that wrapped across a periodic face since then is presented to its old
    neighborhood unwrapped. The shift is an exact multiple of the box, so a
    particle that did not wrap keeps its bits."""
    if not domain.any_periodic:
        return positions
    box, per, zero = domain.box_tensors(positions.device, positions.dtype)
    shift = torch.where(per, box * torch.round((positions - ref) / box),
                        zero)
    return positions - shift


def refresh_bins(domain: Domain, bins: CellBins, positions: torch.Tensor,
                 fields: Optional[Dict[str, torch.Tensor]] = None,
                 valid: Optional[torch.Tensor] = None) -> CellBins:
    """Scatter current particle values into the *existing* slot layout.

    Slot assignment (``particle_slot``, ``slot_id``, ``counts``,
    ``offsets``) is reused from the last ``bin_particles`` pass; only the
    value planes are rewritten, into new tensors, and the periodic ghost
    ring is refilled from the refreshed interior. ``positions`` must
    already be imaged next to the binned reference
    (:func:`image_positions`). Stacked bins take stacked positions,
    fields and ``valid``.

    JAX scatters with ``mode="drop"``; torch raises on an index out of
    range, on the card as a sticky device-side assert. So each system's
    plane gets one dump slot past its end, as ``bin_particles``'s scatter
    does: particles ``bin_particles`` dropped (``particle_slot == total``)
    and padding rows (``valid`` False) land there, and it is cut off. JAX
    parks dropped particles in ghost slot 0 instead, which its periodic
    ghost refill rewrites and which holds a stale value under open
    boundaries."""
    lead = bins.particle_slot.shape[:-1]
    n_sys = math.prod(lead)
    size = bins.slot_id.numel()          # the batch's slots; dump = size
    total = size // n_sys                # one system's slots
    idx = bins.particle_slot.long()
    if n_sys > 1:                        # system b's slots start at b*total
        idx = torch.where(idx < total, idx + _system_bases(
            lead, total, idx.device), size)
    if valid is not None:
        idx = torch.where(valid, idx, size)
    idx = idx.reshape(-1)
    planes = {}
    for name, plane in bins.planes.items():
        if name in ("x", "y", "z"):
            vals = positions[..., "xyz".index(name)]
        else:
            vals = (fields or {})[name]
        buf = torch.empty((size + 1,), dtype=plane.dtype, device=plane.device)
        buf[:size] = plane.reshape(-1)
        buf[idx] = vals.reshape(-1).to(plane.dtype)
        planes[name] = buf[:size].view(plane.shape)
    if domain.any_periodic:
        _fill_ghost_planes(domain, planes, bins.m_c)
    return dataclasses.replace(bins, planes=planes)


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
    # (stacked systems: each with a leading system axis, each bound per
    # system)
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
        return torch.where(slot < self.n_active[..., None], self.active,
                           torch.full_like(self.active, self.n_units))

    @property
    def fill_fraction(self) -> torch.Tensor:
        return self.n_active / max(self.n_units, 1)


def _compact(flag: torch.Tensor, values: torch.Tensor, cap: int,
             fill: int) -> torch.Tensor:
    """(cap,) the ``values`` whose ``flag`` (last axis; leading axes are
    systems, each compacted on its own) is set, in order, then ``fill``; no
    host sync. A running count gives each flagged value its place, and
    unflagged or overflowing values go to a dump slot that is cut off."""
    lead = flag.shape[:-1]
    n_sys = math.prod(lead)
    place = torch.cumsum(flag.to(torch.int32), -1, dtype=torch.int32) - 1
    kept = flag & (place < cap)
    if n_sys > 1:
        place = place + _system_bases(lead, cap, flag.device)
    dest = torch.where(kept, place, n_sys * cap).reshape(-1).long()
    buf = torch.full((n_sys * cap + 1,), fill, dtype=values.dtype,
                     device=values.device)
    buf[dest] = values.expand(flag.shape).reshape(-1)
    return buf[:n_sys * cap].view(*lead, cap)


def _compact_active(unit_counts: torch.Tensor, max_active: int,
                    n_units: int) -> Occupancy:
    flag = unit_counts > 0
    ids = torch.arange(n_units, dtype=torch.int32, device=unit_counts.device)
    return Occupancy(unit_counts=unit_counts,
                     active=_compact(flag, ids, max_active, 0),
                     n_active=flag.sum(-1, dtype=torch.int32),
                     max_active=max_active, n_units=n_units)


def scatter_rows(rows: torch.Tensor, idx: torch.Tensor,
                 n_units: int) -> torch.Tensor:
    """(max_active, W) compact rows -> (n_units, W), zero where no row
    lands; rows whose ``idx`` is ``n_units`` (``scatter_indices``'s
    padding) go to a dump row that is cut off. Leading axes of ``idx``
    (and ``rows``) are systems, each scattered into its own rows."""
    lead = idx.shape[:-1]
    n_sys = math.prod(lead)
    width = rows.shape[-1]
    dest = idx
    if n_sys > 1:
        dest = torch.where(idx < n_units,
                           idx + _system_bases(lead, n_units, idx.device),
                           n_sys * n_units)
    dest = dest.reshape(-1).long()
    out = rows.new_zeros((n_sys * n_units + 1, width))
    out[dest] = rows.reshape(-1, width)
    return out[:n_sys * n_units].view(*lead, n_units, width)


def full_pencil_occupancy(domain: Domain,
                          device: torch.device | str | None = None
                          ) -> Occupancy:
    """The identity occupancy: every (z, y) pencil active, in order, so the
    packed runners iterate all rows through the active-list machinery.
    ``device`` None is the CUDA card (raises without one)."""
    device = resolve_device(device)
    n = domain.nz * domain.ny
    return Occupancy(
        unit_counts=torch.ones((n,), dtype=torch.int32, device=device),
        active=torch.arange(n, dtype=torch.int32, device=device),
        n_active=torch.tensor(n, dtype=torch.int32, device=device),
        max_active=n, n_units=n)


def counts_grid(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """(n_cells,) linear cell counts -> (nz, ny, nx) grid (X fastest);
    leading system axes kept."""
    return counts.reshape(*counts.shape[:-1], domain.nz, domain.ny,
                          domain.nx)


def pencil_counts(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """(n_cells,) cell counts -> (nz*ny,) int32 particles per (z, y)
    X-pencil; unit id = z * ny + y."""
    return counts_grid(domain, counts).sum(-1, dtype=torch.int32).flatten(-2)


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
    grid = counts_grid(domain, counts).reshape(
        *counts.shape[:-1], nz // bz, bz, ny // by, by, nx // bx, bx)
    return grid.sum((-5, -3, -1), dtype=torch.int32).flatten(-3)


def subbox_occupancy(domain: Domain, counts: torch.Tensor,
                     box: Tuple[int, int, int], max_active: int) -> Occupancy:
    """Active sub-boxes of ``CellBins.counts`` (unit ids as in
    :func:`subbox_counts`)."""
    nx, ny, nz = domain.ncells
    bx, by, bz = box
    return _compact_active(subbox_counts(domain, counts, box), max_active,
                           (nx // bx) * (ny // by) * (nz // bz))


def shard_slab_counts(domain: Domain, counts: torch.Tensor,
                      n_shards: int) -> torch.Tensor:
    """(n_cells,) cell counts -> (n_shards,) int32 particles per Z-slab
    shard: the load the halo engine's ``shard_cap`` bound must cover."""
    if domain.nz % n_shards:
        raise ValueError(
            f"nz={domain.nz} not divisible by n_shards={n_shards}")
    per_plane = counts_grid(domain, counts).sum((-2, -1), dtype=torch.int32)
    return per_plane.unflatten(-1, (n_shards, domain.nz // n_shards)).sum(
        -1, dtype=torch.int32)


def shard_pencil_active(domain: Domain, counts: torch.Tensor,
                        n_shards: int) -> torch.Tensor:
    """(n_cells,) cell counts -> (n_shards,) int32 active (z, y) pencils per
    Z-slab shard: what the compacted halo path's one ``max_active`` bound,
    shared by every shard, must cover on the busiest one."""
    if domain.nz % n_shards:
        raise ValueError(
            f"nz={domain.nz} not divisible by n_shards={n_shards}")
    active = (pencil_counts(domain, counts) > 0).to(torch.int32)
    return active.unflatten(-1, (n_shards, -1)).sum(-1, dtype=torch.int32)


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
# m_c; per-cell start offsets come from the paper's §6 scan of each row
# (inside the pack kernel on a CUDA tensor), so the dense layout's
# contiguous 3-cell X-window becomes an (offset, length) range.


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
    # (stacked systems: each tensor with a leading system axis)

    @property
    def overflowed(self) -> torch.Tensor:
        """True when some row (of any system) held more than ``row_cap``
        particles."""
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
    rank r) moves to packed position ``offsets[c] + r``; slots past
    ``row_cap`` are dropped. All of it is ``kernels.pack.pack_slots``: one
    call of the pack kernel on a CUDA tensor, :func:`pack_slots_plain` on a
    CPU one.
    """
    from ..kernels.pack import pack_slots

    nx, ny, _ = domain.ncells
    planes, slot_id, slot_cell, cell_offsets, row_counts, particle_slot = \
        pack_slots(bins, nx=nx, ny=ny, row_cap=row_cap)
    return PackedRows(planes=planes, slot_id=slot_id, slot_cell=slot_cell,
                      cell_offsets=cell_offsets, row_counts=row_counts,
                      counts=bins.counts, particle_slot=particle_slot,
                      row_cap=row_cap, m_c=bins.m_c)


def pack_slots_plain(bins: CellBins, *, nx: int, ny: int, row_cap: int):
    """The plain version of ``kernels.pack.pack_slots``, JAX's
    ``pack_rows`` in PyTorch: each padded row's cell counts and their
    exclusive §6 scan, then the scatters of every field, id and cell
    through a destination per dense slot, and the per-particle map. ->
    (planes, slot_id, slot_cell, cell_offsets, row_counts, particle_slot).
    Stacked bins run system by system."""
    if bins.slot_id.dim() == 4:
        outs = [pack_slots_plain(system(bins, b), nx=nx, ny=ny,
                                 row_cap=row_cap)
                for b in range(bins.slot_id.shape[0])]
        return ({k: torch.stack([o[0][k] for o in outs]) for k in bins.planes},
                *(torch.stack([o[i] for o in outs]) for i in range(1, 6)))
    m_c = bins.m_c
    nzp, nyp = bins.slot_id.shape[:2]
    dev = bins.slot_id.device
    shape4 = (nzp, nyp, nx + 2, m_c)
    occupied = bins.slot_id.view(shape4) >= 0
    cell_counts_p = occupied.sum(-1, dtype=torch.int32)    # (nzp, nyp, nx+2)
    offsets = exclusive_prefix_sum(cell_counts_p)          # §6 scan, per row
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
    return (planes, slot_id, slot_cell, cell_offsets, row_counts,
            particle_slot)


def unpack_scatter(domain: Domain, packed: PackedRows,
                   rows: torch.Tensor) -> torch.Tensor:
    """Packed per-slot values back to particle order.

    ``rows`` holds one value per *interior* packed slot, ``(nz * ny,
    row_cap)`` in pencil-id order. Particles past ``row_cap`` read a zero
    pad slot; particles the dense binning dropped point past the array and
    are clamped onto the last pad slot of their own system, as JAX's
    gather clamps."""
    nz, ny = domain.nz, domain.ny
    lead = packed.particle_slot.shape[:-1]
    per_row = rows.reshape(*lead, nz * ny, packed.row_cap)
    padded = torch.cat([per_row, per_row.new_zeros((*lead, nz * ny, 1))],
                       dim=-1)
    flat = padded.reshape(*lead, -1)
    idx = torch.clamp(packed.particle_slot, max=flat.shape[-1] - 1).long()
    return torch.gather(flat, -1, idx)


def packed_to_particles(domain: Domain, packed: PackedRows, fx, fy, fz, pot
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed ``(nz * ny, row_cap)`` schedule outputs -> per-particle
    (forces (N, 3), potential (N,)), the same contract as
    :func:`dense_to_particles`."""
    out = [unpack_scatter(domain, packed, p) for p in (fx, fy, fz, pot)]
    return torch.stack(out[:3], dim=-1), out[3]


# --------------------------------------------------------------------------
# SFC cluster layout: curve-ordered cell clusters + compressed pair list
# --------------------------------------------------------------------------
#
# Cells are ordered along a space-filling curve (Morton or Hilbert) and
# grouped into clusters of ``csize`` consecutive cells; the per-step work
# list is a compressed cluster-pair list: the kept (cluster, stencil slot k)
# pairs as sorted ``cluster * 32 + k`` codes under a static ``pair_cap``
# bound that follows the replan contract. The curve and cluster tables are
# host numpy, as in JAX (the codecs are carried over verbatim); their
# tensors are cached per device, so an ``execute()`` copies nothing from the
# host. The pair list is built on the device with no host sync: the
# candidates are enumerated cluster-major, k-minor, which is already their
# sorted order, so the running-count compaction gives JAX's sorted codes.
#
# Bit identity with the dense Par-Cell schedule: each kept (cluster, k) pair
# evaluates the per-cell m_c x m_c reduction ``cell_dense`` evaluates for
# stencil slot k, accumulated in the same ascending-k order, and a dropped
# pair's slab is empty. Dropping a pair is only possible through
# ``pair_cap`` overflow, which ``SfcClusters.overflowed`` detects.

DEFAULT_CSIZE = 4
DEFAULT_CURVE = "morton"
SFC_CURVES = ("morton", "hilbert")


def morton_encode(ix, iy, iz, bits: int) -> np.ndarray:
    """Interleave 3 coordinate arrays into Morton (Z-order) codes (host)."""
    ix = np.asarray(ix, np.int64)
    iy = np.asarray(iy, np.int64)
    iz = np.asarray(iz, np.int64)
    code = np.zeros(np.broadcast(ix, iy, iz).shape, np.int64)
    for b in range(bits):
        code |= ((ix >> b) & 1) << (3 * b)
        code |= ((iy >> b) & 1) << (3 * b + 1)
        code |= ((iz >> b) & 1) << (3 * b + 2)
    return code


def morton_decode(codes, bits: int) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Inverse of :func:`morton_encode` (host)."""
    codes = np.asarray(codes, np.int64)
    ix = np.zeros(codes.shape, np.int64)
    iy = np.zeros(codes.shape, np.int64)
    iz = np.zeros(codes.shape, np.int64)
    for b in range(bits):
        ix |= ((codes >> (3 * b)) & 1) << b
        iy |= ((codes >> (3 * b + 1)) & 1) << b
        iz |= ((codes >> (3 * b + 2)) & 1) << b
    return ix, iy, iz


def _hilbert_axes_to_transpose(ix, iy, iz, bits: int):
    """Skilling's AxesToTranspose, vectorized over numpy arrays."""
    X = [np.array(ix, np.int64), np.array(iy, np.int64),
         np.array(iz, np.int64)]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:                       # inverse undo
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0 = np.where(cond, X[0] ^ P, X[0] ^ t)
            X[i] = np.where(cond, X[i], X[i] ^ t)
            X[0] = x0
        Q >>= 1
    for i in range(1, 3):              # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = np.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = np.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [x ^ t for x in X]


def _hilbert_transpose_to_axes(X, bits: int):
    """Skilling's TransposeToAxes (inverse of the above), vectorized."""
    X = [np.array(x, np.int64) for x in X]
    N = 2 << (bits - 1)
    t = X[2] >> 1                      # Gray decode by H ^ (H/2)
    for i in range(2, 0, -1):
        X[i] = X[i] ^ X[i - 1]
    X[0] = X[0] ^ t
    Q = 2
    while Q != N:                      # undo excess work
        P = Q - 1
        for i in range(2, -1, -1):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0 = np.where(cond, X[0] ^ P, X[0] ^ t)
            X[i] = np.where(cond, X[i], X[i] ^ t)
            X[0] = x0
        Q <<= 1
    return X


def hilbert_encode(ix, iy, iz, bits: int) -> np.ndarray:
    """Hilbert-curve codes for 3-D coordinates (host, Skilling 2004)."""
    X = _hilbert_axes_to_transpose(ix, iy, iz, bits)
    code = np.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):  # X[0] most significant per bit-plane
        for i in range(3):
            code = (code << 1) | ((X[i] >> b) & 1)
    return code


def hilbert_decode(codes, bits: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Inverse of :func:`hilbert_encode` (host)."""
    codes = np.asarray(codes, np.int64)
    X = [np.zeros(codes.shape, np.int64) for _ in range(3)]
    for b in range(bits):
        for i in range(3):
            shift = 3 * b + (2 - i)
            X[i] |= ((codes >> shift) & 1) << b
    ix, iy, iz = _hilbert_transpose_to_axes(X, bits)
    return ix, iy, iz


def _curve_bits(nx: int, ny: int, nz: int) -> int:
    return max(int(max(nx, ny, nz) - 1).bit_length(), 1)


@dataclasses.dataclass(frozen=True)
class SfcTables:
    """Static (host, geometry-only) cluster tables of an SFC layout.

    ``order`` lists the cell ids along the curve; cluster ``a`` owns cells
    ``order[a*csize:(a+1)*csize]`` (the last cluster is padded with the
    sentinel cell -1). ``tgt_pcell``/``src_pcell`` hold *padded-grid* flat
    cell indices: ``src_pcell[a, k, j]`` is cell j of cluster a shifted by
    stencil offset k (``domain.neighbor_offsets()`` order, k = 13 is self);
    sentinel cells map to ``n_pcells``, one past the padded grid, an
    always-empty cell.
    """

    order: np.ndarray           # (n_cells,) cell ids in curve order
    cell_cluster: np.ndarray    # (n_cells,) cluster id per cell
    cell_pos: np.ndarray        # (n_cells,) position of cell in its cluster
    cluster_cells: np.ndarray   # (n_clusters, csize) cell ids, -1 pad
    tgt_pcell: np.ndarray       # (n_clusters, csize) padded flat cell
    src_pcell: np.ndarray       # (n_clusters, 27, csize) padded flat cell
    n_clusters: int
    n_pcells: int


@functools.lru_cache(maxsize=None)
def sfc_cluster_tables(domain: Domain, csize: int = DEFAULT_CSIZE,
                       curve: str = DEFAULT_CURVE) -> SfcTables:
    """Build the static SFC cluster tables (cached per geometry)."""
    if curve not in SFC_CURVES:
        raise ValueError(f"unknown curve {curve!r}; have {SFC_CURVES}")
    if csize < 1:
        raise ValueError(f"csize must be >= 1, got {csize}")
    nx, ny, nz = domain.ncells
    n_cells = domain.n_cells
    cid = np.arange(n_cells, dtype=np.int64)
    ix, iy, iz = cid % nx, (cid // nx) % ny, cid // (nx * ny)
    bits = _curve_bits(nx, ny, nz)
    enc = morton_encode if curve == "morton" else hilbert_encode
    codes = enc(ix, iy, iz, bits)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_clusters = -(-n_cells // csize)
    pos = np.arange(n_cells, dtype=np.int64)
    cell_cluster = np.empty(n_cells, np.int32)
    cell_pos = np.empty(n_cells, np.int32)
    cell_cluster[order] = (pos // csize).astype(np.int32)
    cell_pos[order] = (pos % csize).astype(np.int32)
    cluster_cells = np.full((n_clusters * csize,), -1, np.int32)
    cluster_cells[:n_cells] = order
    cluster_cells = cluster_cells.reshape(n_clusters, csize)

    n_pcells = (nz + 2) * (ny + 2) * (nx + 2)
    pad = cluster_cells < 0
    safe = np.where(pad, 0, cluster_cells).astype(np.int64)
    cx, cy, cz = safe % nx, (safe // nx) % ny, safe // (nx * ny)

    def pcell(jx, jy, jz):
        return ((jz + 1) * (ny + 2) + (jy + 1)) * (nx + 2) + (jx + 1)

    tgt_pcell = np.where(pad, n_pcells, pcell(cx, cy, cz)).astype(np.int32)
    offs = domain.neighbor_offsets()                      # (27, 3) (dx,dy,dz)
    src_pcell = np.empty((n_clusters, 27, csize), np.int64)
    for k, (dx, dy, dz) in enumerate(offs):
        src_pcell[:, k, :] = pcell(cx + dx, cy + dy, cz + dz)
    src_pcell = np.where(pad[:, None, :], n_pcells,
                         src_pcell).astype(np.int32)
    return SfcTables(order=order, cell_cluster=cell_cluster,
                     cell_pos=cell_pos, cluster_cells=cluster_cells,
                     tgt_pcell=tgt_pcell, src_pcell=src_pcell,
                     n_clusters=n_clusters, n_pcells=n_pcells)


def sfc_n_clusters(domain: Domain, csize: int = DEFAULT_CSIZE) -> int:
    return -(-domain.n_cells // csize)


@functools.lru_cache(maxsize=None)
def sfc_slot_tables(domain: Domain, m_c: int, csize: int = DEFAULT_CSIZE,
                    curve: str = DEFAULT_CURVE
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat *slot* base offsets of the cluster tables for a given ``m_c``:
    ``(tgt_base (n_clusters, csize), src_base (n_clusters, 27, csize))``,
    each ``pcell * m_c``, indexing the flattened padded planes; sentinel
    cells land at ``n_pcells * m_c``, one past the planes."""
    t = sfc_cluster_tables(domain, csize, curve)
    tgt = (t.tgt_pcell.astype(np.int64) * m_c).astype(np.int32)
    src = (t.src_pcell.astype(np.int64) * m_c).astype(np.int32)
    return tgt, src


@functools.lru_cache(maxsize=16)
def sfc_device_tables(domain: Domain, csize: int, curve: str,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """The cluster tables as int32 tensors on ``device`` (cached): the
    per-execute pair-list build and scatter-back read them from there."""
    t = sfc_cluster_tables(domain, csize, curve)
    return {name: torch.from_numpy(getattr(t, name)).to(device)
            for name in ("tgt_pcell", "src_pcell", "cell_cluster",
                         "cell_pos")}


@functools.lru_cache(maxsize=16)
def sfc_device_slot_tables(domain: Domain, m_c: int, csize: int, curve: str,
                           device: torch.device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sfc_slot_tables` as int32 tensors on ``device`` (cached per
    ``(domain, m_c, csize, curve, device)``). At division 64 ``src_base``
    is 28 MB: a host-to-device copy of it in every ``execute()`` would cost
    more than the force kernel and wait on the host."""
    tgt, src = sfc_slot_tables(domain, m_c, csize, curve)
    return torch.from_numpy(tgt).to(device), torch.from_numpy(src).to(device)


def encode_pair_masks(masks: np.ndarray, pair_cap: int) -> np.ndarray:
    """(n_clusters, 27) bool stencil bitmask -> sorted compressed codes.

    Each kept pair becomes ``cluster * 32 + k`` (5 bits for the stencil
    slot); codes are sorted ascending (cluster-major, k-minor, the
    accumulation order of the dense Par-Cell sweep), padded to ``pair_cap``
    with the sentinel ``n_clusters * 32`` and truncated on overflow (host
    twin of the device encoder inside :func:`build_sfc_clusters`)."""
    masks = np.asarray(masks, bool)
    n_clusters = masks.shape[0]
    a, k = np.nonzero(masks)
    codes = np.sort(a.astype(np.int64) * 32 + k)
    out = np.full((pair_cap,), n_clusters * 32, np.int32)
    m = min(pair_cap, codes.size)
    out[:m] = codes[:m]
    return out


def decode_pair_codes(codes: np.ndarray, n_clusters: int) -> np.ndarray:
    """Sorted compressed codes -> (n_clusters, 27) bool bitmask (inverse
    of :func:`encode_pair_masks` whenever no pair was truncated)."""
    codes = np.asarray(codes, np.int64)
    masks = np.zeros((n_clusters, 27), bool)
    valid = (codes >= 0) & (codes < n_clusters * 32)
    masks[codes[valid] >> 5, codes[valid] & 31] = True
    return masks


@dataclasses.dataclass
class SfcClusters:
    """SFC cluster layout state: dense bins + the compressed pair list.

    ``codes`` is the sorted compressed cluster-pair list (see
    :func:`encode_pair_masks`) under the static ``pair_cap`` bound;
    ``n_pairs`` is the true pair count, and above ``pair_cap`` pairs were
    truncated (:attr:`overflowed`; replan grows ``pair_cap``). The slot
    data stays the dense ``CellBins`` planes: the pair list compresses the
    schedule, so a cluster with no occupied stencil neighbourhood costs
    nothing.
    """

    bins: CellBins                # dense slot planes the tiles are read from
    codes: torch.Tensor           # (pair_cap,) int32 sorted pair codes
    n_pairs: torch.Tensor         # () int32 true (untruncated) pair count
    cluster_counts: torch.Tensor  # (n_clusters,) int32 particles per cluster
    # (stacked systems: each tensor with a leading system axis, pair_cap
    # codes a system)
    pair_cap: int
    csize: int
    curve: str

    @property
    def overflowed(self) -> torch.Tensor:
        """True when pairs were truncated from ``codes`` (replan)."""
        return self.n_pairs > self.pair_cap


def build_sfc_clusters(domain: Domain, bins: CellBins, pair_cap: int,
                       csize: int = DEFAULT_CSIZE,
                       curve: str = DEFAULT_CURVE) -> SfcClusters:
    """Build the compressed cluster-pair list from binned occupancy, on the
    bins' device, with no host sync.

    The bitmask is driven by *padded-cell slot occupancy* (``slot_id >=
    0``), so periodic ghost copies and open (always-empty) ghosts follow
    one rule: a (cluster, k) pair is kept iff the cluster holds a particle
    and its k-shifted cells hold one.
    """
    dev = bins.slot_id.device
    tables = sfc_device_tables(domain, csize, curve, dev)
    n_clusters = tables["tgt_pcell"].shape[0]
    nx, ny, nz = domain.ncells
    lead = bins.slot_id.shape[:-3]
    occ = (bins.slot_id.view(*lead, nz + 2, ny + 2, nx + 2, bins.m_c) >= 0
           ).sum(-1, dtype=torch.int32).reshape(*lead, -1)
    occ_ext = torch.cat([occ, occ.new_zeros((*lead, 1))], dim=-1)
    cluster_counts = occ_ext[..., tables["tgt_pcell"].long()].sum(
        -1, dtype=torch.int32)
    src_counts = occ_ext[..., tables["src_pcell"].long()].sum(
        -1, dtype=torch.int32)
    bits = ((cluster_counts[..., None] > 0) & (src_counts > 0)).flatten(-2)
    a = torch.arange(n_clusters, dtype=torch.int32, device=dev)
    k = torch.arange(27, dtype=torch.int32, device=dev)
    candidates = (a[:, None] * 32 + k).reshape(-1)
    codes = _compact(bits, candidates, pair_cap, n_clusters * 32)
    return SfcClusters(bins=bins, codes=codes,
                       n_pairs=bits.sum(-1, dtype=torch.int32),
                       cluster_counts=cluster_counts, pair_cap=pair_cap,
                       csize=csize, curve=curve)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def sfc_pair_count(domain: Domain, positions: Optional[torch.Tensor] = None,
                   *, counts=None, csize: int = DEFAULT_CSIZE,
                   curve: str = DEFAULT_CURVE, ghost_z=None) -> int:
    """Host-side pair-list length probe (the ``pair_cap`` counterpart of
    ``padded_row_counts``; waits for the device): padded-cell occupancy
    rebuilt from interior cell counts (periodic ghosts copied in the x ->
    y -> z order of the binning's ghost fill, so corners compose the same
    way), then the bitmask rule of :func:`build_sfc_clusters`. It reads
    counts, not slots, so it bounds the built ``n_pairs`` from above and
    equals it whenever no cell overflows ``m_c``.

    ``ghost_z``: optional ``(below, above)`` interior cell counts, each
    ``(ny, nx)``, that override the Z ghost planes: the halo engine's
    per-shard probe, where the Z ghosts come from neighbouring shards
    instead of this domain's own periodic wrap. Their X/Y ghost columns
    get the same periodic copies the exchanged planes carry."""
    if counts is None:
        if positions is None:
            raise ValueError("sfc_pair_count needs positions or counts")
        counts = cell_counts(domain, positions)
    nx, ny, nz = domain.ncells
    grid = _host(counts).reshape(nz, ny, nx)
    occ = np.zeros((nz + 2, ny + 2, nx + 2), np.int64)
    occ[1:nz + 1, 1:ny + 1, 1:nx + 1] = grid
    px, py, pz = domain.periodic_axes
    if ghost_z is not None:
        below, above = ghost_z
        occ[0, 1:ny + 1, 1:nx + 1] = _host(below).reshape(ny, nx)
        occ[nz + 1, 1:ny + 1, 1:nx + 1] = _host(above).reshape(ny, nx)
    if px:
        occ[:, :, 0] = occ[:, :, nx]
        occ[:, :, nx + 1] = occ[:, :, 1]
    if py:
        occ[:, 0, :] = occ[:, ny, :]
        occ[:, ny + 1, :] = occ[:, 1, :]
    if pz and ghost_z is None:
        occ[0] = occ[nz]
        occ[nz + 1] = occ[1]
    t = sfc_cluster_tables(domain, csize, curve)
    occ_ext = np.concatenate([occ.reshape(-1), np.zeros((1,), np.int64)])
    cc = occ_ext[t.tgt_pcell].sum(-1)
    sc = occ_ext[t.src_pcell].sum(-1)
    return int(((cc[:, None] > 0) & (sc > 0)).sum())


def sfc_to_particles(domain: Domain, sfc: SfcClusters, fx, fy, fz, pot
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SFC cluster-tile outputs ``(n_clusters, csize * m_c)`` -> per-particle
    (forces (N, 3), potential (N,)), the same contract as
    :func:`dense_to_particles`. A particle the binning dropped
    (``particle_slot == total``) gets exactly 0."""
    bins = sfc.bins
    nx, ny, nz = domain.ncells
    m_c, csize = bins.m_c, sfc.csize
    tables = sfc_device_tables(domain, csize, sfc.curve, bins.slot_id.device)

    # dense flat slot -> (z, y, cell x, rank) -> cluster-tile flat slot
    row_len = (nx + 2) * m_c
    ds = bins.particle_slot.long()
    zp = ds // ((ny + 2) * row_len)
    rem = ds % ((ny + 2) * row_len)
    yp = rem // row_len
    col = rem % row_len
    cx = col // m_c - 1
    r = col % m_c
    iz, iy = zp - 1, yp - 1
    # dropped particles (slot ``total``) fall outside the interior
    valid = ((iz >= 0) & (iz < nz) & (iy >= 0) & (iy < ny)
             & (cx >= 0) & (cx < nx))
    cid = torch.where(valid, (iz * ny + iy) * nx + cx, 0)
    cc = tables["cell_cluster"][cid].long()
    cp = tables["cell_pos"][cid].long()
    flat = torch.where(valid, cc * (csize * m_c) + cp * m_c + r, 0)
    lead = ds.shape[:-1]
    out = [torch.where(valid, torch.gather(plane.reshape(*lead, -1), -1, flat),
                       0.0)
           for plane in (fx, fy, fz, pot)]
    return torch.stack(out[:3], dim=-1), out[3]
