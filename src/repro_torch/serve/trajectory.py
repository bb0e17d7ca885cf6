"""Trajectory serving (port of ``repro.serve.trajectory``): multi-step
simulation requests without per-dispatch re-binning.

A simulation request served as ``n_steps`` point requests would pay a full
binning pass and a queue round trip a step. :class:`TrajectoryService`
gives such requests their own class: one submission runs the whole
trajectory (``repro_torch.traj``) under a *cached pair of plans* per
:class:`~repro_torch.serve.bucketing.ShapeClass`:

* the **base plan** (cutoff grid) answers the force contract;
* the **skin plan** (coarsened grid, Verlet-skin reuse) is what runs,
  built once per class and reused, so a warm class builds no executor
  across requests (``api.recompile_count``).

Requests are padded onto the class cap like point requests (``pad_state``:
masked rows bin to nothing, and the real rows get the bits of an unpadded
run), so any N in a class shares the cached plans. When a trajectory
replans mid-run, the *grown* plan of its
:class:`~repro_torch.traj.engine.TrajectoryResult` replaces the cached one.
With a ``checkpoint_root``, each request checkpoints in its own directory
keyed by a caller-stable ``job_id`` and resumes on resubmission.

Nothing is caught: a real exception raised while a trajectory runs (a
CUDA error, a failed nvcc build) propagates out of :meth:`submit`, as it
does out of ``plan.trajectory``.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional, Tuple, Union

import torch

from ..core._device import resolve_device
from ..core.api import InteractionPlan, ParticleState, plan as make_plan
from ..core.domain import Domain
from ..core.interactions import PairKernel
from ..physics.integrators import MDState
from ..traj.engine import (DEFAULT_SKIN_FRACTION, TrajectoryResult,
                           run_trajectory, trajectory_plan)
from .bucketing import ShapeClass, classify, pad_state

__all__ = ["TrajectoryRequest", "TrajectoryResponse", "TrajectoryService"]


@dataclasses.dataclass
class TrajectoryRequest:
    """One multi-step simulation job. ``job_id`` keys the per-request
    checkpoint directory (stable across resubmissions = resumable)."""
    job_id: str
    domain: Domain
    kernel: PairKernel
    state: ParticleState
    n_steps: int
    dt: float
    velocities: Optional[torch.Tensor] = None
    integrator: str = "velocity_verlet"
    opts: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrajectoryResponse:
    """Terminal outcome. ``state`` is trimmed back to the request's true
    N; ``result`` keeps the engine's bookkeeping (status, faults, rebins,
    rollbacks, resumed_from, ...)."""
    job_id: str
    status: str
    state: Optional[MDState]
    result: Optional[TrajectoryResult]
    shape_class: str
    n: int


class TrajectoryService:
    """Shape-class-cached front door for trajectory jobs.

    Args:
      skin: Verlet skin of the class's skin plan (default
        ``DEFAULT_SKIN_FRACTION * cutoff`` per domain).
      checkpoint_root: when given, request ``job_id`` J checkpoints under
        ``<root>/J`` and resubmitting J resumes from its latest step.
      device: where the plans run; None means the CUDA card (raises
        without one), ``"cpu"`` the plain versions. A request's tensors
        move there.
      plan_opts: forwarded to ``plan()`` when a class builds its base plan
        (e.g. ``strategy=``, ``layout=``).
    """

    def __init__(self, skin: Optional[float] = None,
                 checkpoint_root: Optional[Union[str, pathlib.Path]] = None,
                 device=None, **plan_opts):
        self.skin = skin
        self.checkpoint_root = (pathlib.Path(checkpoint_root)
                                if checkpoint_root is not None else None)
        self.device = resolve_device(device)
        self.plan_opts = plan_opts
        # (class, integrator) -> (base plan, skin plan); the skin plan is
        # replaced by result.plan after a mid-run replan (growth sticks)
        self._plans: Dict[Tuple[ShapeClass, str],
                          Tuple[InteractionPlan, InteractionPlan]] = {}
        self.jobs_served = 0
        self.replans_absorbed = 0

    def _class_plans(self, sc: ShapeClass, integrator: str,
                     kernel: PairKernel, raw: ParticleState,
                     padded: ParticleState
                     ) -> Tuple[InteractionPlan, InteractionPlan]:
        key = (sc, integrator)
        if key not in self._plans:
            # bounds are measured on the real rows; the masked zero rows
            # never occupy slots
            base = make_plan(sc.domain, kernel, positions=raw.positions,
                             device=self.device, **self.plan_opts)
            skin = (self.skin if self.skin is not None
                    else DEFAULT_SKIN_FRACTION * sc.domain.cutoff)
            traj = trajectory_plan(base, skin, padded.positions,
                                   padded.valid)
            self._plans[key] = (base, traj)
        return self._plans[key]

    def submit(self, req: TrajectoryRequest) -> TrajectoryResponse:
        n = req.state.positions.shape[0]
        sc = classify(req.domain, req.kernel, n, tuple(req.state.fields))
        padded = pad_state(req.state, sc.n_cap)
        padded = ParticleState(
            padded.positions.to(self.device),
            {k: v.to(self.device) for k, v in padded.fields.items()},
            padded.valid.to(self.device))
        vel = (req.velocities.to(self.device) if req.velocities is not None
               else torch.zeros_like(padded.positions[:n]))
        vel = torch.nn.functional.pad(vel, (0, 0, 0, sc.n_cap - n))

        base, traj = self._class_plans(sc, req.integrator, req.kernel,
                                       req.state, padded)
        opts = dict(req.opts)
        if self.checkpoint_root is not None:
            opts.setdefault("checkpoint_dir",
                            self.checkpoint_root / req.job_id)
        res = run_trajectory(base, padded, req.n_steps, req.dt,
                             integrator=req.integrator, velocities=vel,
                             traj_plan=traj, **opts)
        self.jobs_served += 1
        if res.plan is not traj:      # a mid-run replan grew the bounds
            self._plans[(sc, req.integrator)] = (base, res.plan)
            self.replans_absorbed += 1

        state = None
        if res.state is not None:
            md = res.state
            state = MDState(md.positions[:n], md.velocities[:n],
                            md.forces[:n], md.potential[:n], md.step)
        return TrajectoryResponse(job_id=req.job_id, status=res.status,
                                  state=state, result=res,
                                  shape_class=sc.label(), n=n)
