"""Entry points of the CUDA kernels at the port's level of abstraction.

``xpencil_interactions`` (kernel B), ``xpencil_sparse_interactions``
(kernel C), ``xpencil_packed_interactions`` (kernel D),
``allin_interactions`` (kernel E) and ``cell_sfc_interactions`` (kernel F)
run a force kernel and scatter its result back to particle order;
``prefix_sum`` is the paper's §6 scan; ``window_attention`` (kernel G) is
the sliding-window attention of the LM's local layers. Each wrapper runs
its plain PyTorch version on CPU tensors. The particle entry points take
stacked layout data (a leading system axis, ``InteractionPlan.
execute_batch``) as they take one system's, in the same launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.binning import (CellBins, PackedRows, SfcClusters,
                            dense_to_particles, packed_to_particles,
                            pencil_occupancy, scatter_rows,
                            sfc_device_slot_tables, sfc_to_particles)
from ..core.domain import Domain
from ..core.interactions import PairKernel
from .allin import allin_forces
from .prefix_sum import prefix_sum
from .sfc import cell_sfc_forces
from .window_attn import window_attention as _window_attention
from .xpencil import (xpencil_forces, xpencil_packed_forces,
                      xpencil_sparse_forces)

__all__ = ["allin_interactions", "cell_sfc_interactions", "prefix_sum",
           "window_attention", "xpencil_interactions",
           "xpencil_packed_interactions", "xpencil_sparse_interactions"]


def xpencil_interactions(domain: Domain, bins: CellBins, kernel: PairKernel
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X-pencil kernel -> per-particle (forces (N,3), potential (N,))."""
    fx, fy, fz, pot = xpencil_forces(
        bins.planes, bins.slot_id, nx=domain.nx, m_c=bins.m_c, kernel=kernel,
        cutoff2=float(domain.cutoff) ** 2)
    return dense_to_particles(domain, bins, fx, fy, fz, pot)


def xpencil_sparse_interactions(domain: Domain, bins: CellBins,
                                kernel: PairKernel, max_active: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compacted X-pencil kernel -> per-particle (forces, potential).

    Builds the pencil occupancy from the bin counts (no host sync), runs
    kernel C over the ``max_active``-bounded active list and scatters the
    compact rows back into dense planes. Pencils past ``max_active`` are
    dropped: ``InteractionPlan.check_overflow`` detects that and
    ``replan`` grows the bound.
    """
    nx, ny, nz = domain.ncells
    occ = pencil_occupancy(domain, bins.counts, max_active)
    rows = xpencil_sparse_forces(
        bins.planes, bins.slot_id, occ.active, nx=nx, ny=ny, m_c=bins.m_c,
        kernel=kernel, cutoff2=float(domain.cutoff) ** 2)
    idx = occ.scatter_indices()
    fx, fy, fz, pot = (scatter_rows(r, idx, nz * ny).view(*idx.shape[:-1],
                                                          nz, ny, -1)
                       for r in rows)
    return dense_to_particles(domain, bins, fx, fy, fz, pot)


def xpencil_packed_interactions(domain: Domain, packed: PackedRows,
                                kernel: PairKernel,
                                max_active: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-row X-pencil kernel -> per-particle (forces, potential).

    Runs kernel D over every pencil row when ``max_active`` is None, or over
    the ``max_active``-bounded active list otherwise; compact rows scatter
    back into packed ``(nz * ny, row_cap)`` planes, then unpack to particle
    order.
    """
    nx, ny, nz = domain.ncells
    occ = (None if max_active is None
           else pencil_occupancy(domain, packed.counts, max_active))
    rows = xpencil_packed_forces(
        packed.planes, packed.slot_id, packed.slot_cell, packed.cell_offsets,
        None if occ is None else occ.active, nx=nx, ny=ny, m_c=packed.m_c,
        kernel=kernel, cutoff2=float(domain.cutoff) ** 2)
    if occ is not None:
        idx = occ.scatter_indices()
        rows = tuple(scatter_rows(r, idx, nz * ny) for r in rows)
    return packed_to_particles(domain, packed, *rows)


def allin_interactions(domain: Domain, bins: CellBins, kernel: PairKernel,
                       box: Tuple[int, int, int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-in-SM kernel over sub-boxes ``box`` (dividing the grid) ->
    per-particle (forces (N,3), potential (N,))."""
    fx, fy, fz, pot = allin_forces(
        bins.planes, bins.slot_id, box=box, m_c=bins.m_c, kernel=kernel,
        cutoff2=float(domain.cutoff) ** 2)
    return dense_to_particles(domain, bins, fx, fy, fz, pot)


def cell_sfc_interactions(domain: Domain, sfc: SfcClusters,
                          kernel: PairKernel
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SFC cluster-pair kernel over the compressed pair list -> per-particle
    (forces (N,3), potential (N,)). The slot-base tables come from the
    per-device cache; clusters with no kept pair come back as zeros."""
    bins = sfc.bins
    tgt_base, src_base = sfc_device_slot_tables(
        domain, bins.m_c, sfc.csize, sfc.curve, bins.slot_id.device)
    fx, fy, fz, pot = cell_sfc_forces(
        bins.planes, bins.slot_id, sfc.codes, tgt_base, src_base,
        m_c=bins.m_c, kernel=kernel, cutoff2=float(domain.cutoff) ** 2)
    return sfc_to_particles(domain, sfc, fx, fy, fz, pot)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, blk: int = 128,
                     softcap: float = 0.0) -> torch.Tensor:
    """Pencil-pattern sliding-window attention (kernel G, see
    ``window_attn.py``)."""
    return _window_attention(q, k, v, window=window, blk=blk,
                             softcap=softcap)
