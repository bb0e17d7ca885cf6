"""Model-vs-measured traffic audit (port of ``repro.obs.audit``; the
"model drift" metric).

``core/traffic.py`` models HBM bytes per interaction from *uniform*
assumptions — every cell holds ``avg_ppc`` particles, so interactions per
cell are ``27 * avg_ppc**2``. The autotuner prunes candidates by that
model, so a mis-modelled regime (a blob the uniform model cannot see, a
packed row whose occupancy the per-cell average hides) could prune the
true winner unseen. This module computes the **measured** counterpart from
the port's occupancy probes (``core.binning.cell_counts`` /
``subbox_counts`` / ``sfc_pair_count``) and reports the relative error:

* measured interactions: candidate pair slots
  ``sum_c n_c * sum_{c' in 27-neighborhood(c)} n_c'`` from the real
  per-cell counts, the exact quantity ``n_cells * 27 * avg_ppc**2``
  approximates under uniformity;
* measured bytes: the model's staging structure per strategy, fed by
  measured occupancy — active pencils/sub-boxes instead of a fill guess,
  real packed-row populations instead of ``avg_ppc`` per cell;
* drift: ``measured_bpi / modelled_bpi - 1`` (0 = perfect model,
  positive = the model undersells the real traffic).

:func:`audit_candidate` records the drift as the
``repro_torch_traffic_model_drift{strategy,layout}`` gauge (plus a
cumulative histogram) in the port's registry — the autotuner calls it for
**every pruned candidate**, so a wrong prune is visible in the registry
instead of lost. The arithmetic is numpy on host copies of the counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.domain import Domain
from ..core.traffic import FIELD_BYTES, candidate_cost
from . import metrics as _metrics
from .trace import event as _trace_event

__all__ = ["MeasuredTraffic", "measured_traffic", "neighbor_pair_count",
           "model_drift", "audit_candidate", "DRIFT_GAUGE"]

DRIFT_GAUGE = "repro_torch_traffic_model_drift"
DRIFT_HIST = "repro_torch_traffic_model_drift_abs"


@dataclasses.dataclass(frozen=True)
class MeasuredTraffic:
    """Measured interactions / bytes for one (strategy, layout) dispatch."""

    strategy: str
    layout: str
    compact: bool
    interactions: float        # candidate pair slots from real cell counts
    hbm_bytes: float           # staged bytes from measured occupancy
    bytes_per_interaction: float


def _host(counts) -> np.ndarray:
    if isinstance(counts, torch.Tensor):
        return counts.cpu().numpy()
    return np.asarray(counts)


def _counts_grid(domain: Domain, counts) -> np.ndarray:
    return _host(counts).astype(np.float64).reshape(
        domain.nz, domain.ny, domain.nx)


def _shift(grid: np.ndarray, d: Tuple[int, int, int],
           periodic: Tuple[bool, bool, bool]) -> np.ndarray:
    """Shift the (z, y, x) counts grid by (dz, dy, dx): roll on periodic
    axes, zero-fill on open ones (border cells see fewer neighbors)."""
    out = grid
    # grid axis 0/1/2 = z/y/x; Domain.periodic_axes is (x, y, z)
    for axis, (dd, per) in enumerate(zip(d, (periodic[2], periodic[1],
                                             periodic[0]))):
        if dd == 0:
            continue
        out = np.roll(out, dd, axis=axis)
        if not per:
            sl = [slice(None)] * 3
            sl[axis] = slice(0, dd) if dd > 0 else slice(dd, None)
            out = out.copy()
            out[tuple(sl)] = 0.0
    return out


def neighbor_pair_count(domain: Domain, counts) -> float:
    """Measured candidate pair slots: ``sum_c n_c * W_c`` where ``W_c``
    sums the 27-neighborhood (self included) of real per-cell counts —
    what ``n_cells * 27 * avg_ppc**2`` approximates under uniformity."""
    grid = _counts_grid(domain, counts)
    w = np.zeros_like(grid)
    per = domain.periodic_axes
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                w += _shift(grid, (dz, dy, dx), per)
    return float((grid * w).sum())


def measured_traffic(domain: Domain, positions=None, *, strategy: str,
                     m_c: int, layout: str = "dense", compact: bool = False,
                     subbox: Optional[Tuple[int, int, int]] = None,
                     counts=None, valid=None) -> MeasuredTraffic:
    """Measured interactions / bytes estimate for one dispatch shape.

    Mirrors ``core.traffic.model``'s staging structure per strategy, but
    feeds it the *measured* occupancy instead of uniform assumptions:
    pass either representative ``positions`` (one binning pass) or
    precomputed per-cell ``counts`` (the probe every bound check already
    ran — the autotuner reuses its own)."""
    if counts is None:
        if positions is None:
            raise ValueError("measured_traffic needs positions or counts")
        from ..core.binning import cell_counts
        counts = cell_counts(domain, positions, valid)
    grid = _counts_grid(domain, counts)
    n = float(grid.sum())
    nx, ny, nz = domain.ncells
    cell_bytes = m_c * FIELD_BYTES
    inter = neighbor_pair_count(domain, counts)

    if strategy == "naive_n2":
        hbm = n * n * FIELD_BYTES
    elif strategy == "par_part":
        hbm = n * 27 * cell_bytes + n * FIELD_BYTES
    elif strategy == "cell_dense":
        if layout == "sfc":
            # measured pair list: the exact kept-pair count the replan
            # probe uses, plus one target tile per cluster that holds any
            # particle (a cluster with no particles has no kept pairs)
            from ..core.binning import (DEFAULT_CSIZE, DEFAULT_CURVE,
                                        sfc_cluster_tables, sfc_pair_count)
            csize = DEFAULT_CSIZE
            tables = sfc_cluster_tables(domain, csize, DEFAULT_CURVE)
            pairs = float(sfc_pair_count(domain, counts=counts))
            occ_cells = (_host(counts).astype(np.float64).reshape(-1)
                         > 0).astype(np.float64)
            kept_clusters = float((np.bincount(
                np.asarray(tables.cell_cluster), weights=occ_cells,
                minlength=tables.n_clusters) > 0).sum())
            hbm = (kept_clusters * csize * cell_bytes
                   + pairs * (csize * cell_bytes + 4))
        else:
            units = float((grid > 0).sum()) if compact else float(grid.size)
            hbm = units * (27 + 1) * cell_bytes
    elif strategy == "xpencil":
        per_row = grid.sum(axis=2)                     # (nz, ny)
        active = per_row > 0
        n_rows = float(active.sum()) if compact else float(per_row.size)
        if layout == "packed":
            # measured packed rows: particles (+ periodic-X ghost copies)
            # and the (nx + 3) int32 prefix offsets, 10 staged windows per
            # pencil — bytes follow the real row populations, not avg_ppc
            padded = per_row.copy()
            if domain.periodic_axes[0]:
                padded += grid[..., 0] + grid[..., -1]
            if compact:
                padded = np.where(active, padded, 0.0)
            hbm = 10.0 * (padded.sum() * (FIELD_BYTES + 4)
                          + n_rows * (nx + 3) * 4)
        else:
            hbm = n_rows * 10.0 * (nx + 2) * cell_bytes
    elif strategy == "allin":
        if subbox is None:
            from ..core.strategies import subbox_dims
            subbox = subbox_dims(domain, m_c)
        bx, by, bz = subbox
        halo_cells = (bx + 2) * (by + 2) * (bz + 2)
        if compact:
            from ..core.binning import subbox_counts
            boxes = _host(subbox_counts(
                domain, torch.as_tensor(_host(counts)), subbox))
            units = float((boxes > 0).sum())
        else:
            units = float(-(-nx // bx) * (-(-ny // by)) * (-(-nz // bz)))
        hbm = units * halo_cells * cell_bytes
    else:
        raise ValueError(f"no measured-traffic estimate for {strategy!r}")

    return MeasuredTraffic(
        strategy=strategy, layout=layout, compact=compact,
        interactions=inter, hbm_bytes=float(hbm),
        bytes_per_interaction=float(hbm) / max(inter, 1e-9))


def model_drift(modelled_bpi: float, measured_bpi: float) -> float:
    """Relative model error: ``measured / modelled - 1`` (0 = perfect,
    NaN when either side is non-finite or the model predicts nothing)."""
    if (not math.isfinite(modelled_bpi) or not math.isfinite(measured_bpi)
            or modelled_bpi <= 0.0):
        return math.nan
    return measured_bpi / modelled_bpi - 1.0


def audit_candidate(domain: Domain, positions=None, *, strategy: str,
                    m_c: int, layout: str = "dense", compact: bool = False,
                    subbox: Optional[Tuple[int, int, int]] = None,
                    fill: float = 1.0, counts=None, valid=None,
                    modelled: Optional[float] = None) -> Dict[str, float]:
    """One model-vs-measured comparison, recorded in the registry.

    ``modelled`` defaults to ``traffic.candidate_cost`` at the given
    ``fill`` (pass the autotuner's own score to audit exactly what pruned
    the candidate). Returns ``{"modelled_bpi", "measured_bpi", "drift",
    "interactions"}`` and records the drift as the
    ``repro_torch_traffic_model_drift{strategy,layout}`` gauge plus an
    ``|drift|`` histogram per (strategy, layout)."""
    if modelled is None:
        modelled = candidate_cost(domain, m_c,
                                  _avg_ppc(domain, positions, counts),
                                  strategy, subbox=subbox, compact=compact,
                                  fill=fill, layout=layout)
    meas = measured_traffic(domain, positions, strategy=strategy, m_c=m_c,
                            layout=layout, compact=compact, subbox=subbox,
                            counts=counts, valid=valid)
    drift = model_drift(float(modelled), meas.bytes_per_interaction)
    labels = dict(strategy=meas.strategy + ("_compact" if compact else ""),
                  layout=layout)
    _metrics.registry.gauge(DRIFT_GAUGE, **labels).set(
        0.0 if math.isnan(drift) else drift)
    if not math.isnan(drift):
        _metrics.registry.histogram(DRIFT_HIST, **labels).observe(
            abs(drift))
    _trace_event("traffic.audit", modelled_bpi=float(modelled),
                 measured_bpi=meas.bytes_per_interaction, drift=drift,
                 **labels)
    return {"modelled_bpi": float(modelled),
            "measured_bpi": meas.bytes_per_interaction,
            "drift": drift, "interactions": meas.interactions}


def _avg_ppc(domain: Domain, positions, counts) -> float:
    if counts is not None:
        return float(_host(counts).sum()) / domain.n_cells
    return positions.shape[0] / domain.n_cells
