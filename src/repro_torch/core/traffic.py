"""Analytical staging-traffic model (port of ``repro.core.traffic``): the
paper's Fig. 7 argument as arithmetic.

Per strategy it gives the global-memory bytes moved per interaction, the
reuse factor of each staged byte, the masked-slot waste and the number of
work units, from the grid, ``m_c`` and the mean particles per cell. The
byte, reuse, waste and unit counts are the JAX package's formulas, so the
two packages rank schedules alike at the same sub-box;
``hbm_bytes_per_interaction`` is the only field a decision reads
(``core.api.choose_strategy``, the autotuner's pruning).

``staged_bytes_per_step`` is the shared memory the port's kernel for that
schedule stages per block, read from the kernel modules' own sizing
functions (where the JAX package models a TPU's VMEM footprint):

* ``xpencil``: kernel B's block at its chunk width,
  ``kernels/xpencil.py::pencil_smem_bytes(chunk_cells(nx, m_c), m_c)``;
* ``allin``: kernel E's halo block, ``kernels/allin.py::halo_bytes``;
* packed ``xpencil``: kernel D's block at its tile of pencils,
  ``kernels/xpencil.py::packed_smem_bytes``;
* sfc ``cell_dense``: kernel F's warp, ``kernels/sfc.py::
  sfc_warp_smem_bytes``.

Where the port has no kernel (``par_part``, dense ``cell_dense``), the
JAX package's formula stays. When no sub-box is given, the ``allin``
report sizes one with the port's ``strategies.subbox_dims``, from a
block's shared memory.

All formulas assume the dense slot layout (m_c slots/cell, 4 fields of 4
bytes: x, y, z, slot_id) and a full 27-neighbourhood (border effects
ignored, as in the paper's "aside from the border cells" argument).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .domain import Domain

FIELD_BYTES = 4 * 4  # x, y, z, slot_id as f32/i32

# The kernel modules import ``core``; their sizing functions are imported
# where they are called, so importing ``core`` does not import them.


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    strategy: str
    hbm_bytes_per_interaction: float   # global-memory traffic / interactions
    staged_bytes_per_step: int         # shared memory of one kernel block
    reuse_factor: float                # interactions per staged byte-load
    padded_work_fraction: float        # masked-slot waste (idle threads)
    grid_steps: int                    # number of work units


def model(domain: Domain, m_c: int, avg_ppc: float,
          subbox: Optional[Tuple[int, int, int]] = None
          ) -> Dict[str, TrafficReport]:
    """Traffic model for each strategy at a given fill ratio.

    ``avg_ppc``: average particles per cell (paper: 1, 10, 100).
    Interactions per cell ~= avg_ppc * 27 * avg_ppc (cutoff filtering is the
    same for all strategies, so it cancels in comparisons).
    """
    from ..kernels.allin import halo_bytes
    from ..kernels.xpencil import chunk_cells, pencil_smem_bytes
    nx, ny, nz = domain.ncells
    n_cells = domain.n_cells
    n_parts = n_cells * avg_ppc
    inter_per_cell = 27.0 * avg_ppc * avg_ppc
    total_inter = n_cells * inter_per_cell
    pad2 = (m_c / max(avg_ppc, 1e-9)) ** 2          # slot-padding waste, pairs
    cell_bytes = m_c * FIELD_BYTES

    out: Dict[str, TrafficReport] = {}

    # Par-Part: each particle loads its 27 neighbor cells; zero reuse across
    # particles (caches aside — the paper's point).
    loads = n_parts * 27 * cell_bytes + n_parts * FIELD_BYTES
    out["par_part"] = TrafficReport(
        "par_part", loads / total_inter, 0, 1.0 / max(avg_ppc, 1e-9),
        1.0 - 1.0 / pad2, int(n_parts))

    # Par-Cell(-SM): each cell stages its 27 neighbors once; every staged
    # byte is reused by the cell's m_c targets.
    loads = n_cells * (27 + 1) * cell_bytes
    out["cell_dense"] = TrafficReport(
        "cell_dense", loads / total_inter, 2 * cell_bytes,
        float(avg_ppc), 1.0 - 1.0 / pad2, n_cells)

    # X-pencil: per (z, y) pencil, the target row + 9 neighbor rows of
    # (nx + 2) cells each are staged; reuse = 3 cells' worth of targets per
    # staged cell (the X window).
    row_bytes = (nx + 2) * cell_bytes
    loads = (nz * ny) * (9 + 1) * row_bytes
    out["xpencil"] = TrafficReport(
        "xpencil", loads / total_inter,
        pencil_smem_bytes(chunk_cells(nx, m_c), m_c),
        3.0 * avg_ppc, 1.0 - 1.0 / pad2, nz * ny)

    # All-in-SM: per sub-box, the (b+2)^3 halo block is staged once; interior
    # cells reuse 27x, the halo ring less (paper: between 9 and 1).
    if subbox is None:
        from .strategies import subbox_dims
        subbox = subbox_dims(domain, m_c)
    bx, by, bz = subbox
    halo_cells = (bx + 2) * (by + 2) * (bz + 2)
    n_boxes = -(-nx // bx) * (-(-ny // by)) * (-(-nz // bz))
    loads = n_boxes * halo_cells * cell_bytes
    inter_per_box = bx * by * bz * inter_per_cell
    reuse = inter_per_box / max(halo_cells * avg_ppc, 1e-9)
    out["allin"] = TrafficReport(
        "allin", loads / max(total_inter, 1e-9),
        halo_bytes((bx, by, bz), m_c), reuse, 1.0 - 1.0 / pad2, n_boxes)

    return out


def compact_report(report: TrafficReport, fill: float) -> TrafficReport:
    """Fill-fraction-aware cost of the occupancy-compacted variant.

    Compaction changes *which* work units run, not what each one costs:
    staged bytes per block and per-unit reuse are unchanged, but only the
    ``fill`` fraction of work units (and their HBM loads) happen at all.
    The interaction count is identical — empty units contribute none — so
    bytes-per-interaction scales linearly with the fill fraction. The
    masked-slot waste *within* active units stays: the compacted path
    removes empty pencils, not empty slots.
    """
    fill = min(max(float(fill), 0.0), 1.0)
    return dataclasses.replace(
        report,
        strategy=f"{report.strategy}_compact",
        hbm_bytes_per_interaction=report.hbm_bytes_per_interaction * fill,
        grid_steps=max(1, int(round(report.grid_steps * fill))),
    )


def model_row_cap(domain: Domain, avg_ppc: float, slack: float = 1.25,
                  align: int = 8) -> int:
    """The packed-row bound of the model's uniform scene: ``avg_ppc`` in
    each cell of a padded pencil row (``nx``, plus the two ghost cells of
    a periodic X axis), with ``suggest_row_cap``'s slack and alignment."""
    cells = domain.nx + (2 if domain.periodic_axes[0] else 0)
    cap = max(1, int(max(avg_ppc, 1e-3) * cells * slack + 0.999))
    return -(-cap // align) * align


def packed_report(report: TrafficReport, m_c: int, avg_ppc: float,
                  domain: Domain, row_cap: Optional[int] = None
                  ) -> TrafficReport:
    """Packed-row (CSR) layout cost of a pencil schedule.

    The dense layout moves ``m_c * FIELD_BYTES`` per cell whatever the
    cell holds; the packed layout moves bytes proportional to the
    *particles*: per cell, ``ppc`` slots of the four fields plus the
    packed slot-cell index, plus one int32 prefix-sum offset. Work units,
    reuse and slot waste are unchanged — packing moves fewer bytes per
    unit, it does not change which units run (compose with
    :func:`compact_report` for that).

    The staged bytes are kernel D's block at ``row_cap`` (default
    :func:`model_row_cap`) and the tile of pencils it takes over the
    grid's ``nz * ny`` rows (``kernels/xpencil.py::packed_tile_rows``).
    ``domain`` and ``row_cap`` are the port's: the JAX package scales its
    VMEM footprint instead.
    """
    from ..kernels.xpencil import packed_smem_bytes, packed_tile_rows
    ppc = max(avg_ppc, 1e-3)
    dense_cell = m_c * FIELD_BYTES
    packed_cell = ppc * (FIELD_BYTES + 4) + 4
    factor = min(1.0, packed_cell / dense_cell)
    if row_cap is None:
        row_cap = model_row_cap(domain, avg_ppc)
    tile = packed_tile_rows(row_cap, domain.nz * domain.ny)
    return dataclasses.replace(
        report,
        strategy=f"{report.strategy}_packed",
        hbm_bytes_per_interaction=report.hbm_bytes_per_interaction * factor,
        staged_bytes_per_step=packed_smem_bytes(tile, row_cap),
    )


def sfc_report(domain: Domain, m_c: int, avg_ppc: float,
               csize: Optional[int] = None, fill: float = 1.0
               ) -> TrafficReport:
    """SFC cluster layout cost of the Par-Cell schedule.

    The SFC layout replaces the dense 27-stencil sweep with the compressed
    cluster-pair list: only the *kept* pairs (``fill`` fraction of the
    ``27 * n_clusters`` stencil slots) run, so empty stencil work
    disappears from both the unit count and the HBM loads, paid for by one
    int32 pair code per kept pair. Per kept pair the kernel stages the
    ``csize`` source cells (the target tile stays resident across the
    cluster's pairs); each staged source byte is reused by the cluster's
    ``csize * m_c`` targets. The staged bytes are kernel F's warp
    (``kernels/sfc.py::sfc_warp_smem_bytes``).
    """
    from ..kernels.sfc import sfc_warp_smem_bytes
    if csize is None:
        from .binning import DEFAULT_CSIZE
        csize = DEFAULT_CSIZE
    fill = min(max(float(fill), 1e-3), 1.0)
    ppc = max(avg_ppc, 1e-3)
    n_cells = domain.n_cells
    n_clusters = -(-n_cells // csize)
    total_inter = n_cells * 27.0 * ppc * ppc
    pad2 = (m_c / ppc) ** 2
    cell_bytes = m_c * FIELD_BYTES
    kept_pairs = 27.0 * fill                      # kept pairs per cluster
    # target tile once per cluster + (sources + pair code) per kept pair
    loads = n_clusters * (csize * cell_bytes
                          + kept_pairs * (csize * cell_bytes + 4))
    return TrafficReport(
        "cell_dense_sfc", loads / max(total_inter, 1e-9),
        sfc_warp_smem_bytes(csize, m_c), csize * ppc, 1.0 - 1.0 / pad2,
        max(1, int(round(n_clusters * kept_pairs))))


def candidate_cost(domain: Domain, m_c: int, avg_ppc: float, strategy: str,
                   subbox: Optional[Tuple[int, int, int]] = None,
                   compact: bool = False, fill: float = 1.0,
                   layout: str = "dense") -> float:
    """Pruning hook for the measured autotuner (``core.autotune``).

    Scores one candidate configuration by its modelled HBM bytes per
    interaction — the quantity ``strategy="auto"`` minimizes outright. The
    autotuner only uses it to *rank* candidates before timing the top-k, so
    the model must keep the true winner in the field, not name it.
    ``naive_n2`` has no staging and is modelled as one full pass over all
    pairs.

    ``compact=True`` scores the occupancy-compacted variant at the given
    active-work-unit ``fill`` fraction (see :func:`compact_report`);
    ``layout="packed"`` scores the packed-row layout (see
    :func:`packed_report`); the two axes compose multiplicatively.
    ``layout="sfc"`` scores the compressed cluster-pair list (see
    :func:`sfc_report`) — there ``fill`` is intrinsic to the pair list, and
    ``compact`` is a no-op, exactly as in the execution path.
    """
    if strategy == "naive_n2":
        n = domain.n_cells * max(avg_ppc, 1e-3)
        total_inter = domain.n_cells * 27.0 * max(avg_ppc, 1e-3) ** 2
        return n * n * FIELD_BYTES / max(total_inter, 1e-9)
    if layout == "sfc":
        return sfc_report(domain, m_c, max(avg_ppc, 1e-3),
                          fill=fill).hbm_bytes_per_interaction
    reports = model(domain, m_c, max(avg_ppc, 1e-3), subbox=subbox)
    report = reports[strategy]
    if layout == "packed":
        report = packed_report(report, m_c, avg_ppc, domain)
    if compact:
        report = compact_report(report, fill)
    return report.hbm_bytes_per_interaction
