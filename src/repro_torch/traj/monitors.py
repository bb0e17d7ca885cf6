"""Invariant monitors of the trajectory engine (port of
``repro.traj.monitors``).

Everything the host needs to know about the health of a segment rides in a
handful of 0-d tensors on the device, folded in step by step and read on
the host once per *segment*, which then decides whether the segment commits
or rolls back (see ``repro_torch.traj.engine``).

Monitor glossary
----------------
nonfinite_steps / nonfinite_elems
    Steps on which any position / velocity / force / potential entry of a
    valid particle was NaN or Inf, and the total count of such entries.
    Any increase across a segment is a breach.
skin_steps
    Steps whose *single-step* max displacement exceeded ``skin / 2``. Pair
    coverage stays exact (the rebin predicate fires on the same step), but
    the skin no longer matches the dynamics. 0 when ``skin == 0``
    (always-rebin mode); a breach otherwise.
max_drift
    Running max of the relative total-energy drift
    ``|E - E0| / max(|E0|, 1)`` against the energy at trajectory start. A
    breach only past the caller's ``energy_budget``.
max_cell_count / max_row_count / max_active_units
    Running maxima of what the static bounds ``m_c`` / ``row_cap`` /
    ``max_active`` must cover. A rebin inside a segment cannot replan, so
    overflow is *recorded* here and the host grows the bounds and replays
    the segment.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class MonitorState:
    """Cumulative invariant counters, 0-d tensors on the device (or host
    numbers once read back with :func:`to_host`)."""

    e0: torch.Tensor                # float32 reference total energy
    nonfinite_steps: torch.Tensor   # int32
    nonfinite_elems: torch.Tensor   # int32
    skin_steps: torch.Tensor        # int32
    max_drift: torch.Tensor         # float32 relative energy drift
    max_cell_count: torch.Tensor    # int32 max particles in any cell seen
    max_row_count: torch.Tensor     # int32 max padded-row load (packed)
    max_active_units: torch.Tensor  # int32 max active work units (compact)


_FLOAT_FIELDS = ("e0", "max_drift")


def init_monitors(e0: torch.Tensor) -> MonitorState:
    e0 = torch.as_tensor(e0).to(torch.float32)

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=e0.device)

    return MonitorState(
        e0=e0, nonfinite_steps=zero(torch.int32),
        nonfinite_elems=zero(torch.int32), skin_steps=zero(torch.int32),
        max_drift=zero(torch.float32), max_cell_count=zero(torch.int32),
        max_row_count=zero(torch.int32), max_active_units=zero(torch.int32))


def to_host(mon: MonitorState) -> MonitorState:
    """The monitors as Python numbers, read in one transfer."""
    names = [f.name for f in dataclasses.fields(MonitorState)]
    vals = torch.stack([getattr(mon, n).to(torch.float64)
                        for n in names]).tolist()
    return MonitorState(**{n: (v if n in _FLOAT_FIELDS else int(v))
                           for n, v in zip(names, vals)})


def count_nonfinite(positions: torch.Tensor, velocities: torch.Tensor,
                    forces: torch.Tensor, potential: torch.Tensor,
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Non-finite entries across the MD state, padding rows masked out."""
    def bad(a, mask):
        b = ~torch.isfinite(a)
        if mask is not None:
            b = b & mask
        return b.sum(dtype=torch.int32)

    m3 = None if valid is None else valid[:, None]
    return (bad(positions, m3) + bad(velocities, m3)
            + bad(forces, m3) + bad(potential, valid))


def update(mon: MonitorState, *, positions: torch.Tensor,
           velocities: torch.Tensor, forces: torch.Tensor,
           potential: torch.Tensor, valid: Optional[torch.Tensor],
           kinetic: torch.Tensor, potential_energy: torch.Tensor,
           step_disp: torch.Tensor, eff_skin: float,
           cell_max: torch.Tensor, row_max: torch.Tensor,
           units: torch.Tensor) -> MonitorState:
    """Fold one step's observations in, on the device, without a branch.

    ``potential_energy`` is the already-halved total PE (pairs counted
    twice), the quantity that seeds ``e0`` and fills the traces' ``total``,
    so drift compares like with like."""
    bad = count_nonfinite(positions, velocities, forces, potential, valid)
    energy = (kinetic + potential_energy).to(torch.float32)
    drift = torch.abs(energy - mon.e0) / torch.clamp(torch.abs(mon.e0),
                                                     min=1.0)
    skin_hit = ((step_disp > eff_skin * 0.5).to(torch.int32)
                * (1 if eff_skin > 0 else 0))
    return MonitorState(
        e0=mon.e0,
        nonfinite_steps=mon.nonfinite_steps + (bad > 0).to(torch.int32),
        nonfinite_elems=mon.nonfinite_elems + bad,
        skin_steps=mon.skin_steps + skin_hit,
        # the drift of a non-finite energy is meaningless; keep NaN out of
        # the running max (the nonfinite counter flags the step)
        max_drift=torch.where(torch.isfinite(drift),
                              torch.maximum(mon.max_drift, drift),
                              mon.max_drift),
        max_cell_count=torch.maximum(mon.max_cell_count,
                                     cell_max.to(torch.int32)),
        max_row_count=torch.maximum(mon.max_row_count,
                                    row_max.to(torch.int32)),
        max_active_units=torch.maximum(mon.max_active_units,
                                       units.to(torch.int32)))


def classify_breach(prev: MonitorState, cur: MonitorState,
                    energy_budget: Optional[float]) -> Optional[str]:
    """Host-side segment verdict: the first breached invariant between the
    monitors before and after a segment, or None when it is healthy.
    Non-finite values invalidate everything else, and an energy breach on
    a NaN segment is a symptom, not the cause."""
    if int(cur.nonfinite_steps) > int(prev.nonfinite_steps):
        return "nonfinite"
    if int(cur.skin_steps) > int(prev.skin_steps):
        return "skin"
    if (energy_budget is not None
            and float(cur.max_drift) > float(energy_budget)):
        return "energy"
    return None
