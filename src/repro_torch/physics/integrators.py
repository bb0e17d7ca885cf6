"""Time integrators driving the interaction engine (port of
``repro.physics.integrators``).

``run`` with an :class:`~repro_torch.core.api.InteractionPlan` on a cell
schedule forwards to ``plan.trajectory`` (``repro_torch.traj``): Verlet-skin
neighbor reuse, invariant monitors, checkpoint/resume. The per-step loop is
kept for the ``CellListEngine`` shim and the non-cell schedules; it
recomputes forces from scratch every step, as ``velocity_verlet`` and
``leapfrog`` (single-step factories) do.

The step arithmetic (``coefficients``, ``integ_drift``, ``integ_kick``) is
the trajectory engine's too, so the single-step factories and the
trajectory round alike: scalar factors folded on the host in float32 as
JAX folds them on the device, products and adds in separate eager
operations (no ``addcmul``, no ``add(..., alpha=)``).

Where JAX scans, this is a Python loop: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.api import InteractionPlan, ParticleState
from ..core.domain import Domain
from ..core.engine import CellListEngine

Engine = Union[InteractionPlan, CellListEngine]


def _forces_fn(engine: Engine
               ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    if isinstance(engine, InteractionPlan):
        return lambda pos: engine.execute(ParticleState(pos))
    return engine.compute


@dataclasses.dataclass
class MDState:
    """One committed MD state; every tensor on the plan's device."""

    positions: torch.Tensor   # (N, 3)
    velocities: torch.Tensor  # (N, 3)
    forces: torch.Tensor      # (N, 3)
    potential: torch.Tensor   # (N,)
    step: int = 0


def init_state(engine: Engine, positions: torch.Tensor,
               velocities: torch.Tensor | None = None) -> MDState:
    if velocities is None:
        velocities = torch.zeros_like(positions)
    forces, pot = _forces_fn(engine)(positions)
    return MDState(positions, velocities, forces, pot, 0)


def wrap(domain: Domain, positions: torch.Tensor) -> torch.Tensor:
    """Periodic axes wrapped into [0, L) with a floor-mod (JAX's
    ``jnp.mod``); open axes untouched."""
    if not domain.any_periodic:
        return positions
    box, per, _ = domain.box_tensors(positions.device, positions.dtype)
    return torch.where(per, torch.remainder(positions, box), positions)


class Coeffs(NamedTuple):
    """An integrator's scalar factors, folded on the host in float32 as
    JAX folds them on the device (a Python float times a float32 scalar,
    rounded to float32): each is exact in float32, so multiplying a
    float32 tensor by it rounds as JAX's product does."""

    dt: float        # dt
    kick: float      # (0.5 / m) * dt: velocity-Verlet and BAOAB half kicks
    lf_kick: float   # dt * (1 / m): leapfrog's kick
    half_dt: float   # 0.5 * dt: BAOAB's half drifts
    c1: float        # exp(-gamma dt)
    c2: float        # sqrt(kT / m * (1 - c1^2))


def coefficients(dt: float, mass: float, gamma: float, kT: float
                 ) -> Coeffs:
    f32 = np.float32
    dt32 = f32(dt)
    half, inv_m = 0.5 / mass, 1.0 / mass
    c1 = np.exp(-f32(gamma) * dt32)
    c2 = np.sqrt(max(f32(kT) * f32(inv_m), f32(0.0))
                 * max(f32(1.0) - c1 * c1, f32(0.0)))
    return Coeffs(dt=float(dt32), kick=float(f32(half) * dt32),
                  lf_kick=float(dt32 * f32(inv_m)),
                  half_dt=float(f32(0.5) * dt32), c1=float(f32(c1)),
                  c2=float(f32(c2)))


def integ_drift(integrator: str, dom: Domain, co: Coeffs, md: MDState,
                gen: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First half of a step: new positions + staged velocity."""
    if integrator == "velocity_verlet":
        v_half = md.velocities + co.kick * md.forces
        return wrap(dom, md.positions + co.dt * v_half), v_half
    if integrator == "leapfrog":
        vel = md.velocities + co.lf_kick * md.forces
        return wrap(dom, md.positions + co.dt * vel), vel
    # langevin (BAOAB): B(dt/2) A(dt/2) O(dt) A(dt/2); the trailing B(dt/2)
    # happens in integ_kick. gamma=0 reduces to velocity-Verlet drift.
    v1 = md.velocities + co.kick * md.forces
    x1 = md.positions + co.half_dt * v1
    noise = torch.randn(md.velocities.shape, generator=gen,
                        dtype=md.velocities.dtype,
                        device=md.velocities.device)
    v2 = co.c1 * v1 + co.c2 * noise
    return wrap(dom, x1 + co.half_dt * v2), v2


def integ_kick(integrator: str, co: Coeffs, v_staged: torch.Tensor,
               forces: torch.Tensor) -> torch.Tensor:
    if integrator == "leapfrog":
        return v_staged
    return v_staged + co.kick * forces


def make_step(engine: Engine, integrator: str, co: Coeffs,
              gen: Optional[torch.Generator] = None
              ) -> Callable[[MDState], MDState]:
    """One step of ``integrator`` with a fresh force evaluation; ``gen``
    draws langevin's noise."""
    compute = _forces_fn(engine)

    def step(state: MDState) -> MDState:
        pos, v_staged = integ_drift(integrator, engine.domain, co, state,
                                    gen)
        forces, pot = compute(pos)
        vel = integ_kick(integrator, co, v_staged, forces)
        return MDState(pos, vel, forces, pot, state.step + 1)

    return step


def velocity_verlet(engine: Engine, dt: float, mass: float = 1.0
                    ) -> Callable[[MDState], MDState]:
    """Symplectic velocity-Verlet step, one force evaluation a step. For
    runs, prefer ``plan.trajectory`` / :func:`run` (neighbor reuse)."""
    return make_step(engine, "velocity_verlet",
                     coefficients(dt, mass, 0.0, 0.0))


def leapfrog(engine: Engine, dt: float, mass: float = 1.0
             ) -> Callable[[MDState], MDState]:
    """Leapfrog (kick-drift) step; same note as :func:`velocity_verlet`."""
    return make_step(engine, "leapfrog", coefficients(dt, mass, 0.0, 0.0))


def run(engine: Engine, state: MDState, n_steps: int, dt: float,
        mass: float = 1.0, integrator: str = "velocity_verlet",
        **traj_opts) -> Tuple[MDState, Dict[str, torch.Tensor]]:
    """Run ``n_steps``; returns ``(final_state, traces)``, each trace an
    (n_steps,) tensor of the kinetic, potential and total energy.

    An :class:`InteractionPlan` on a cell schedule runs on the trajectory
    engine (``skin=``, ``checkpoint_dir=``, ``energy_budget=``, ...; see
    :func:`repro_torch.traj.engine.run_trajectory`). Everything else (the
    ``CellListEngine`` shim, ``par_part`` / ``naive_n2`` plans) runs the
    per-step loop, which recomputes forces from scratch each step."""
    from ..traj.engine import TRAJ_STRATEGIES

    if (isinstance(engine, InteractionPlan)
            and engine.strategy in TRAJ_STRATEGIES):
        res = engine.trajectory(state, n_steps, dt, integrator=integrator,
                                mass=mass, **traj_opts)
        traces = {k: torch.as_tensor(res.traces[k])
                  for k in ("kinetic", "potential", "total")}
        return res.state, traces
    if traj_opts:
        raise ValueError(
            f"trajectory options {sorted(traj_opts)} need an "
            "InteractionPlan on a cell schedule; this engine runs the "
            "legacy per-step scan")
    if integrator not in ("velocity_verlet", "leapfrog"):
        raise ValueError(
            f"integrator {integrator!r} needs an InteractionPlan on a "
            "cell schedule (the trajectory path); the legacy per-step "
            "scan only supports 'velocity_verlet' and 'leapfrog'")
    step = (velocity_verlet if integrator == "velocity_verlet"
            else leapfrog)(engine, dt, mass)
    rows = []
    for _ in range(n_steps):
        state = step(state)
        ke = 0.5 * mass * torch.sum(state.velocities ** 2)
        pe = 0.5 * torch.sum(state.potential)
        rows.append(torch.stack([ke, pe, ke + pe]))
    table = (torch.stack(rows) if rows else
             torch.zeros((0, 3), dtype=state.positions.dtype,
                         device=state.positions.device))
    return state, {"kinetic": table[:, 0], "potential": table[:, 1],
                   "total": table[:, 2]}
