"""Halo-exchange primitives: Z-slab partition and the ghost-plane exchange
(port of ``repro.dist.halo``).

The paper's (nz, ny, nx) cell grid is split into Z-slabs, one per shard.
Each shard bins its own particles into the slab's padded planes and fills
its two ghost Z-planes from the neighbouring shards: the ghost ring of the
paper's layout, crossing shards instead of staying in one system's planes.

  ``partition_by_shard``    per-shard gather under a static ``cap`` (the
                            shard-capacity counterpart of M_C: an overloaded
                            shard is detectable, never silently wrong),
                            with no host sync,
  ``exchange_halo``         the ghost-plane exchange of shards stacked on
                            one device (a leading shard axis); periodic Z
                            wraps around the shard ring with the
                            minimum-image shift, open Z boundaries get empty
                            planes,
  ``exchange_halo_ranks``   the same exchange of one slab per rank of a
                            ``torch.distributed`` process group,
  ``shard_loads`` / ``suggest_shard_cap`` / ``suggest_shard_max_active``
                            the occupancy probes behind the plan layer's
                            overflow/replan contract (they wait for the
                            device).

The executor that strings them together lives in ``repro_torch.dist.engine``;
``plan(..., backend="halo")`` is the front door.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.binning import (EMPTY_POS, cell_counts, shard_pencil_active,
                            shard_slab_counts)
from ..core.domain import Domain

# anything beyond this is sentinel padding, far outside every real box
VALID_MAX = 1.0e7


# --------------------------------------------------------------------------
# shard assignment and load probes
# --------------------------------------------------------------------------

def shard_ids(domain: Domain, positions: torch.Tensor,
              n_shards: int) -> torch.Tensor:
    """(..., N) Z-slab shard index per particle (periodic-aware cell
    coordinates)."""
    if domain.nz % n_shards:
        raise ValueError(
            f"nz={domain.nz} not divisible by n_shards={n_shards}")
    zc = domain.cell_coords(positions)[..., 2]
    return zc // (domain.nz // n_shards)


def shard_loads(domain: Domain, positions: torch.Tensor, n_shards: int,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_shards,) particles per Z-slab shard. Pass precomputed per-cell
    ``counts`` (``binning.cell_counts``) to skip the binning pass."""
    if counts is None:
        counts = cell_counts(domain, positions)
    return shard_slab_counts(domain, counts, n_shards)


def suggest_shard_cap(domain: Domain, positions: torch.Tensor,
                      n_shards: int, slack: float = 1.3,
                      align: int = 8) -> int:
    """Static per-shard particle capacity: the busiest shard's load with
    slack, rounded up to ``align`` (the ``suggest_m_c`` contract).
    Particles drift between slabs as they move; an exceeded cap is caught
    by ``InteractionPlan.check_overflow``."""
    mx = int(shard_loads(domain, positions, n_shards).max())
    cap = max(1, int(mx * slack + 0.999))
    return -(-cap // align) * align


def suggest_shard_max_active(domain: Domain, positions: torch.Tensor,
                             n_shards: int, slack: float = 1.25,
                             align: int = 8,
                             counts: Optional[torch.Tensor] = None) -> int:
    """Static per-shard active-pencil bound for the compacted halo path:
    the busiest shard's active (z, y) pencil count with slack, aligned,
    clipped to the slab's pencil count."""
    if counts is None:
        counts = cell_counts(domain, positions)
    mx = int(shard_pencil_active(domain, counts, n_shards).max())
    bound = max(1, int(mx * slack + 0.999))
    bound = -(-bound // align) * align
    return min(bound, (domain.nz // n_shards) * domain.ny)


# --------------------------------------------------------------------------
# partition and scatter-back
# --------------------------------------------------------------------------

def partition_by_shard(domain: Domain, positions: torch.Tensor,
                       fields: Optional[Dict[str, torch.Tensor]],
                       n_shards: int, cap: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Dict[str, torch.Tensor]]:
    """Group particles by Z-slab under a static per-shard ``cap``.

    Returns ``(gather_idx (..., n_shards * cap), pos_part (..., n_shards *
    cap, 3), fields_part)``: shard ``s`` owns rows ``[s * cap, (s + 1) *
    cap)``, its particles first in ascending particle index (the order of
    JAX's ``nonzero``), then pad rows that index ``N`` and read the
    ``EMPTY_POS`` sentinel (0 for a field). Leading axes of ``positions``
    are independent systems.

    No host sync: one stable sort by shard id orders the rows, and a row's
    rank within its shard (its sorted place less the shard's start) gives
    its slot. Rows past ``cap`` are dropped, which the plan layer detects
    (``shard_loads`` against the cap) and replans, as it does an
    overflowing ``m_c``. Rows whose ``valid`` is False are dropped too."""
    lead, n = positions.shape[:-2], positions.shape[-2]
    dev = positions.device
    n_sys = math.prod(lead)
    shard = shard_ids(domain, positions, n_shards).reshape(n_sys, n).long()
    if valid is not None:
        # padding sorts past every shard and is never placed
        shard = torch.where(valid.reshape(n_sys, n), shard, n_shards)
    sorted_shard, order = torch.sort(shard, dim=-1, stable=True)
    loads = torch.zeros((n_sys, n_shards + 1), dtype=torch.long, device=dev)
    loads.scatter_add_(1, shard, torch.ones_like(shard))
    start = torch.cumsum(loads, -1) - loads
    rank = (torch.arange(n, device=dev)
            - torch.gather(start, 1, sorted_shard))
    keep = (rank < cap) & (sorted_shard < n_shards)
    width = n_shards * cap
    # each system's block has one dump slot past its rows, cut off below
    base = torch.arange(n_sys, device=dev)[:, None] * (width + 1)
    dest = base + torch.where(keep, sorted_shard * cap + rank, width)
    gather = torch.full((n_sys * (width + 1),), n, dtype=torch.long,
                        device=dev)
    gather[dest.reshape(-1)] = order.reshape(-1)
    gather_idx = gather.view(n_sys, width + 1)[:, :width]

    def take(values: torch.Tensor, fill) -> torch.Tensor:
        flat = values.reshape(n_sys, n, -1)
        pad = torch.full((n_sys, 1, flat.shape[-1]), fill,
                         dtype=values.dtype, device=dev)
        src = torch.cat([flat, pad], dim=1)
        out = torch.gather(src, 1, gather_idx[..., None].expand(
            -1, -1, flat.shape[-1]))
        return out.reshape(*lead, width, *values.shape[len(lead) + 1:])

    pos_part = take(positions, EMPTY_POS)
    fields_part = {k: take(v, 0.0) for k, v in (fields or {}).items()}
    return (gather_idx.to(torch.int32).reshape(*lead, width), pos_part,
            fields_part)


def scatter_from_shards(gather_idx: torch.Tensor, n: int,
                        values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`partition_by_shard` for per-row shard outputs
    ``(..., n_shards * cap, *rest)``: rows land back at their particle
    index, pad rows (index ``n``) are dropped, and particles no shard held
    read 0."""
    lead = gather_idx.shape[:-1]
    n_sys = math.prod(lead)
    width = gather_idx.shape[-1]
    rest = values.shape[len(lead) + 1:]
    base = torch.arange(n_sys, device=values.device)[:, None] * (n + 1)
    dest = (gather_idx.reshape(n_sys, width).long() + base).reshape(-1)
    out = values.new_zeros((n_sys * (n + 1), *rest))
    out[dest] = values.reshape(n_sys * width, *rest)
    return out.view(n_sys, n + 1, *rest)[:, :n].reshape(*lead, n, *rest)


# --------------------------------------------------------------------------
# the ghost-plane exchange
# --------------------------------------------------------------------------

def _shifted(from_below: torch.Tensor, from_above: torch.Tensor,
             coord_shift: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The received planes in this shard's frame: the minimum-image shift
    on the whole plane, sentinels included (JAX's arithmetic)."""
    if not coord_shift:
        return from_below, from_above
    return from_below - coord_shift, from_above + coord_shift


def exchange_halo(plane: torch.Tensor, *, n_shards: int, nz_loc: int,
                  periodic_z: bool, fill, coord_shift: float = 0.0
                  ) -> torch.Tensor:
    """Fill the two ghost Z-planes of stacked shards from their neighbours,
    in place; returns ``plane``.

    ``plane`` is ``(*lead, n_shards, nz_loc + 2, A, W)``: any per-slot plane
    of the slab layout (``A, W`` = ``ny + 2`` and the row's slots, or the
    packed row's cell offsets, or 1 for its row counts) for ``n_shards``
    shards in order, ``lead`` independent systems. Shard ``s`` receives
    shard ``s - 1``'s last interior plane below and shard ``s + 1``'s first
    interior plane above (JAX's two ``ppermute`` rings); periodic Z wraps
    around the ring with ``coord_shift`` (the slab height for the ``"z"``
    plane, else 0) taking neighbour coordinates into this shard's frame.
    At open Z boundaries the bottom shard's below-ghost and the top shard's
    above-ghost are ``fill`` (the empty sentinel), so they contribute no
    ghost particle. Both boundary planes are read into new tensors before
    any ghost plane is written: with ``nz_loc == 1`` they are one plane."""
    if plane.shape[-4] != n_shards or plane.shape[-3] != nz_loc + 2:
        raise ValueError(f"exchange_halo: plane of shape {tuple(plane.shape)}"
                         f" is not (..., {n_shards}, {nz_loc + 2}, A, W)")
    top = plane[..., nz_loc, :, :]              # last interior plane
    bot = plane[..., 1, :, :]                   # first interior plane
    from_below, from_above = _shifted(          # new tensors: no aliasing
        torch.roll(top, 1, dims=-3), torch.roll(bot, -1, dims=-3),
        coord_shift)
    if not periodic_z:                          # open Z: border ghosts empty
        from_below[..., 0, :, :] = fill
        from_above[..., n_shards - 1, :, :] = fill
    plane[..., 0, :, :] = from_below
    plane[..., nz_loc + 1, :, :] = from_above
    return plane


def exchange_halo_ranks(plane: torch.Tensor, *, group, shard_index: int,
                        n_shards: int, nz_loc: int, periodic_z: bool, fill,
                        coord_shift: float = 0.0) -> torch.Tensor:
    """:func:`exchange_halo` for one slab per rank: ``plane`` is this rank's
    ``(*lead, nz_loc + 2, A, W)`` (``lead`` independent systems), and the
    boundary planes travel to ranks ``r + 1`` and ``r - 1`` of ``group``
    (``shard_index`` = ``r``) by ``torch.distributed.batch_isend_irecv``.
    Fills the ghost planes in place and returns ``plane``. With two shards
    both neighbours are one rank: its two messages arrive in the order it
    sent them, the upward plane first."""
    import torch.distributed as dist

    up = dist.get_global_rank(group, (shard_index + 1) % n_shards)
    down = dist.get_global_rank(group, (shard_index - 1) % n_shards)
    top = plane[..., nz_loc, :, :].contiguous()
    bot = plane[..., 1, :, :].contiguous()
    from_below = torch.empty_like(top)
    from_above = torch.empty_like(bot)
    ops = [dist.P2POp(dist.isend, top, up, group),
           dist.P2POp(dist.isend, bot, down, group),
           dist.P2POp(dist.irecv, from_below, down, group),
           dist.P2POp(dist.irecv, from_above, up, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    from_below, from_above = _shifted(from_below, from_above, coord_shift)
    if not periodic_z:                          # open Z: border ghosts empty
        if shard_index == 0:
            from_below.fill_(fill)
        if shard_index == n_shards - 1:
            from_above.fill_(fill)
    plane[..., 0, :, :] = from_below
    plane[..., nz_loc + 1, :, :] = from_above
    return plane
