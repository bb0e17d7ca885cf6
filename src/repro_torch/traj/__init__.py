"""Fault-tolerant trajectory engine (port of ``repro.traj``).

Front door: ``InteractionPlan.trajectory(state, n_steps, dt, ...)``; see
:mod:`repro_torch.traj.engine` for the Verlet-skin / checkpoint / rollback
contract and :mod:`repro_torch.traj.monitors` for the invariant glossary.
"""

from .engine import (DEFAULT_SKIN_FRACTION, INTEGRATORS, REBIN_TOTAL,
                     TRAJ_STRATEGIES, TrajCarry, TrajectoryResult,
                     reference_step, run_trajectory, trajectory_plan)
from .monitors import MonitorState, classify_breach, init_monitors

__all__ = [
    "DEFAULT_SKIN_FRACTION", "INTEGRATORS", "REBIN_TOTAL", "TRAJ_STRATEGIES",
    "TrajCarry", "TrajectoryResult", "MonitorState", "classify_breach",
    "init_monitors", "reference_step", "run_trajectory", "trajectory_plan",
]
