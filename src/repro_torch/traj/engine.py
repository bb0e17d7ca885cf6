"""Fault-tolerant trajectory engine (port of ``repro.traj.engine``).

A per-step ``plan.execute`` loop pays a full binning (and pack) pass every
timestep; this engine runs bin -> force -> integrate step after step and
amortizes the binning with a Verlet-skin contract:

* the trajectory runs on a *skin-padded* grid (``domain.skin_domain``: cell
  width >= cutoff + skin, same cutoff, so pair masks are unchanged and
  results stay pair-complete for the true cutoff),
* bins are built once and their slot assignment reused; each step only
  *refreshes* slot contents (``binning.refresh_bins``),
* the rebin predicate (``binning.max_displacement`` against the measured
  ``skin / 2``) re-bins only when drift has eaten the margin.

Where JAX runs a segment as one jitted ``lax.scan`` with a ``lax.cond``
rebin, this runs a Python loop over the steps of a segment and reads the
predicate on the host: one scalar sync a step. Every kernel the plan's
``execute()`` launches runs on every step (on the card: kernel B dense,
C compacted, D and the pack kernel packed, E All-in-SM), and kernel A on
every rebin. The bins stay stacked as one system for the whole run, the
layout data every backend takes. The monitors and the energy traces stay
on the device until the segment ends.

``skin = 0`` is the always-rebin limit: the grid is the plan's own and a
rebin fires whenever anything moved, so the trajectory is *bit-identical*
to the per-step ``plan.execute`` loop (``reference_step`` shares the
integrator arithmetic). The integrators multiply and add in separate
eager operations, folding their scalar factors in float32 on the host as
JAX folds them on the device, and never fuse a product into the next add
(no ``addcmul``, no ``add(..., alpha=)``), so the two paths round alike on
the CPU and on the card.

Robustness: the run is cut into *segments* on a fixed absolute grid. At
each segment boundary the host

1. classifies breaches (non-finite state, skin thrash, energy drift past
   budget, ``monitors.classify_breach``) and **rolls back** to the last
   committed anchor with a forced rebin, stepping the plan's degradation
   ladder through the circuit breaker (``api.plan_health``) on repeated
   failure;
2. grows the static bounds when a rebin overflowed ``m_c`` / ``row_cap`` /
   ``max_active`` (recorded by the monitors), then replays the segment
   from the anchor;
3. checkpoints the whole carry ``(MDState, bins, ref, rng, monitors)``
   through ``repro_torch.ckpt`` (atomic step-dir publish), so a killed run
   resumes **bit-identically**: the segment grid is absolute and the
   langevin generator's state rides in the carry.

Fault points (``repro_torch.testing.chaos``): ``traj.step`` (delay, then
error before a segment, nonfinite on its committed positions),
``traj.checkpoint`` (error: a failed save must never kill the run),
``traj.rebin`` (overflow: forces the replan path), and ``ckpt.save``
inside the checkpoint writer.

What differs from JAX: nothing is caught. An injected fault is asked for
(``chaos.injected_fault``) and takes the branch JAX's ``except`` takes,
with the same fault text; a real exception (a CUDA error, a failed nvcc
build, an ``OSError`` while checkpointing) propagates. On the card the
ladder has no ``"reference"`` rung (``api.degradation_ladder``): every
segment runs on the kernels, and a breach past the last rung ends the run
``"failed"`` at its anchor. The langevin noise comes from a
``torch.Generator`` on the plan's device seeded with ``seed``, another
stream than JAX's.

Restrictions: trajectories need a cell schedule whose force inputs are
bins (``cell_dense`` / ``xpencil`` / ``allin``); ``par_part`` reads raw
positions (stale bins would silently drop its interactions) and
``naive_n2`` bypasses binning; both raise up front.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ckpt import checkpoint as _ckpt
from ..core import api
from ..core.api import InteractionPlan, ParticleState
from ..core.binning import (CellBins, bin_particles, image_positions,
                            max_displacement, padded_row_counts,
                            pencil_counts, refresh_bins, subbox_counts)
from ..core.domain import Domain, effective_skin, skin_domain
from ..obs import metrics as _obs_metrics
from ..obs.trace import event as _obs_event, trace as _obs_trace
from ..physics.integrators import (Coeffs, MDState, coefficients,
                                   integ_drift, integ_kick, make_step)
from ..testing import chaos
from . import monitors as M

# skin-contract + fault-recovery rebins, in the port's obs registry
REBIN_TOTAL = "repro_rebin_total"

# Schedules whose backends consume bins (dense or packed): the only ones
# whose force evaluation can reuse a stale-but-covering bin structure.
TRAJ_STRATEGIES = ("cell_dense", "xpencil", "allin")

INTEGRATORS = ("velocity_verlet", "leapfrog", "langevin")

# Default skin: a quarter cutoff, the JAX package's.
DEFAULT_SKIN_FRACTION = 0.25

_ALIGN = 8

TRACE_KEYS = ("kinetic", "potential", "total")


def _round_up(n: int, align: int = _ALIGN) -> int:
    return -(-int(n) // align) * align


@dataclasses.dataclass
class TrajCarry:
    """Everything a step needs from the one before, and so everything a
    checkpoint must capture for bit-identical resume."""

    md: MDState               # positions/velocities/forces/potential/step
    bins: CellBins            # stacked bins (one system) on the skin grid
    ref: torch.Tensor         # (N, 3) positions the bins were built at
    rng: torch.Tensor         # langevin generator state (get_state())
    rebins: int               # skin-contract rebins so far
    mon: M.MonitorState


@dataclasses.dataclass
class TrajectoryResult:
    """What a trajectory run produced and what it took to produce it.
    ``traces`` holds JAX's per-step ``kinetic``, ``potential`` and
    ``total`` energies and two more: ``rebinned`` (1 on a step that
    re-binned) and ``displacement`` (the rebin predicate's max drift from
    the binned positions)."""

    state: MDState                     # final committed MD state
    traces: Dict[str, np.ndarray]      # per-step, since resume
    plan: InteractionPlan              # traj plan with any grown bounds
    status: str = "ok"                 # ok | degraded | failed
    steps: int = 0                     # committed steps
    rebins: int = 0                    # skin-contract rebins
    forced_rebins: int = 0             # host-forced rebins (rollback/replan)
    replans: int = 0                   # bound-growth events
    rollbacks: int = 0                 # breach-triggered rollbacks
    retries: int = 0                   # segment re-executions after faults
    checkpoints: int = 0               # committed checkpoint dirs
    resumed_from: Optional[int] = None  # checkpoint step resumed from
    faults: List[str] = dataclasses.field(default_factory=list)
    ladder_level: int = 0              # rung that produced the final state
    eff_skin: float = 0.0              # measured skin margin of the grid


# --------------------------------------------------------------------------
# plan derivation: the skin-padded twin + observed-bound growth
# --------------------------------------------------------------------------


def _check_supported(p: InteractionPlan) -> None:
    if p.strategy not in TRAJ_STRATEGIES:
        raise ValueError(
            f"plan.trajectory needs a cell schedule {TRAJ_STRATEGIES}, got "
            f"{p.strategy!r}: par_part reads raw positions (stale bins "
            "would silently drop its interactions) and naive_n2 bypasses "
            "binning, so neither can reuse a Verlet-skin bin structure")
    if p._multi_shard:
        raise ValueError(
            "plan.trajectory does not run on multi-shard halo plans yet: "
            "the per-call Z-slab re-partition is exactly the cost the "
            "skin contract amortizes away (single-shard halo plans fall "
            "back to their inner backend and work fine)")


def trajectory_plan(base: InteractionPlan, skin: float,
                    positions: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None
                    ) -> InteractionPlan:
    """The skin-padded twin of ``base``: same kernel / backend / layout on
    the coarsened ``skin_domain`` grid, with static bounds re-measured for
    it. Without positions, bounds are scaled by the cell-volume ratio;
    with positions, the replan contract takes over."""
    _check_supported(base)
    dom = skin_domain(base.domain, skin)
    if dom == base.domain:
        return base
    grown = dataclasses.replace(
        base, domain=dom, box=None,
        m_c=_volume_scaled(base.m_c, base.domain, dom),
        row_cap=(None if base.row_cap is None
                 else _volume_scaled(base.row_cap, base.domain, dom)),
        max_active=(None if base.max_active is None
                    else min(base.max_active,
                             api.n_units(dom, base.strategy))))
    if positions is not None:
        state = ParticleState(positions, valid=valid)
        while grown.check_overflow(state):
            grown = grown.replan(state)
    return grown


def _volume_scaled(bound: int, old: Domain, new: Domain) -> int:
    ratio = (float(np.prod(np.asarray(new.cell_width)))
             / max(float(np.prod(np.asarray(old.cell_width))), 1e-30))
    return _round_up(max(1, int(np.ceil(bound * max(ratio, 1.0)))))


def _grow_bounds(p: InteractionPlan, cell_max: int, row_max: int,
                 units: int) -> InteractionPlan:
    """Observed-maxima flavor of the replan contract: grow only the bound
    the monitors saw exceeded, with slack, aligned, strictly past the old
    value. Used between segments."""
    q = p
    if cell_max > p.m_c:
        measured = _round_up(max(1, int(cell_max * 1.5 + 0.999)))
        q = dataclasses.replace(q, m_c=max(measured, _round_up(p.m_c + 1)),
                                box=None)
    if p.layout == "packed" and row_max > (p.row_cap or 0):
        measured = _round_up(max(1, int(row_max * 1.25 + 0.999)))
        q = dataclasses.replace(
            q, row_cap=max(measured, _round_up((p.row_cap or 0) + 1)))
    if p.compact and units > (p.max_active or 0):
        total = api.n_units(p.domain, p.strategy, box=q.box)
        measured = _round_up(max(1, int(units * 1.25 + 0.999)))
        grown = max(measured, _round_up((p.max_active or 0) + 1))
        q = dataclasses.replace(q, max_active=min(grown, total))
    return q


# --------------------------------------------------------------------------
# one step: forces against given bins, integrators, monitors
# --------------------------------------------------------------------------


def _stacked(positions: torch.Tensor, fields: Dict[str, torch.Tensor],
             valid: Optional[torch.Tensor]) -> ParticleState:
    """One system as the stacked state the backends and binning take."""
    return ParticleState(positions[None],
                         {k: v[None] for k, v in fields.items()},
                         None if valid is None else valid[None])


def _bin(p: InteractionPlan, positions, fields, valid) -> CellBins:
    st = _stacked(positions, fields, valid)
    return bin_particles(p.domain, st.positions, st.fields, m_c=p.m_c,
                         valid=st.valid)


def _forces(p: InteractionPlan, bins: CellBins, positions: torch.Tensor,
            fields: Dict[str, torch.Tensor], valid: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend dispatch against *given* (stacked) bins: the one divergence
    from ``execute``, which always re-bins from the positions. It runs the
    plan's cached executor (``api._executor``), so a run builds one per
    plan and rung, counted by ``api.recompile_count``, and a warm plan
    builds none."""
    states = _stacked(positions, fields, valid)
    f, u = api._executor(p, tuple(sorted(fields))).forces(bins, states)
    return f[0], u[0]


def _bound_probes(p: InteractionPlan, bins: CellBins, zero: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """0-d maxima the static bounds must cover (monitor inputs)."""
    cell_max = bins.counts.max()
    row_max = (padded_row_counts(p.domain, bins.counts).max()
               if p.layout == "packed" else zero)
    if p.compact:
        uc = (subbox_counts(p.domain, bins.counts,
                            api._unit_box(p.domain, p.box))
              if p.strategy == "allin"
              else pencil_counts(p.domain, bins.counts))
        units = (uc > 0).sum(dtype=torch.int32)
    else:
        units = zero
    return cell_max, row_max, units


def _masked_energies(vel: torch.Tensor, pot: torch.Tensor,
                     valid: Optional[torch.Tensor], mass: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if valid is None:
        ke = 0.5 * mass * torch.sum(vel ** 2)
        pe = 0.5 * torch.sum(pot)             # pairs counted twice
    else:
        ke = 0.5 * mass * torch.sum(
            torch.where(valid[:, None], vel, torch.zeros_like(vel)) ** 2)
        pe = 0.5 * torch.sum(torch.where(valid, pot, torch.zeros_like(pot)))
    return ke, pe


def _step(p: InteractionPlan, integrator: str, co: Coeffs,
          eff_skin: float, mass: float, carry: TrajCarry,
          gen: torch.Generator, fields: Dict[str, torch.Tensor],
          valid: Optional[torch.Tensor], zero: torch.Tensor):
    """One step of the segment loop. -> (carry, (kinetic, potential,
    displacement) as 0-d tensors, rebinned as a bool)."""
    dom = p.domain
    md = carry.md
    pos, v_staged = integ_drift(integrator, dom, co, md, gen)
    disp = max_displacement(dom, pos, carry.ref, valid)
    step_disp = max_displacement(dom, pos, md.positions, valid)
    rebin = bool(disp > eff_skin * 0.5)            # the step's host sync
    if rebin:
        bins, ref, img = _bin(p, pos, fields, valid), pos, pos
    else:
        # the positions as the stale bins see them: the image nearest the
        # binned reference
        img = image_positions(dom, pos, carry.ref)
        st = _stacked(img, fields, valid)
        bins = refresh_bins(dom, carry.bins, st.positions, st.fields,
                            st.valid)
        ref = carry.ref
    forces, pot = _forces(p, bins, img, fields, valid)
    vel = integ_kick(integrator, co, v_staged, forces)
    ke, pe = _masked_energies(vel, pot, valid, mass)
    cell_max, row_max, units = _bound_probes(p, bins, zero)
    mon = M.update(carry.mon, positions=pos, velocities=vel, forces=forces,
                   potential=pot, valid=valid, kinetic=ke,
                   potential_energy=pe, step_disp=step_disp,
                   eff_skin=eff_skin, cell_max=cell_max, row_max=row_max,
                   units=units)
    out = TrajCarry(md=MDState(pos, vel, forces, pot, md.step + 1),
                    bins=bins, ref=ref, rng=carry.rng,
                    rebins=carry.rebins + int(rebin), mon=mon)
    return out, (ke, pe, disp), rebin


def _segment(p: InteractionPlan, integrator: str, n: int, co: Coeffs,
             eff_skin: float, mass: float, carry: TrajCarry,
             fields: Dict[str, torch.Tensor], valid: Optional[torch.Tensor]
             ) -> Tuple[TrajCarry, Dict[str, np.ndarray]]:
    """``n`` steps from ``carry``; the traces come to the host once, at
    the end. The generator restarts from the carry's state, so a replayed
    segment draws the same noise."""
    dev = carry.md.positions.device
    gen = torch.Generator(device=dev)
    gen.set_state(carry.rng)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rows, flags = [], []
    for _ in range(n):
        carry, row, rebin = _step(p, integrator, co, eff_skin, mass, carry,
                                  gen, fields, valid, zero)
        rows.append(torch.stack(row))
        flags.append(rebin)
    carry = dataclasses.replace(carry, rng=gen.get_state())
    table = torch.stack(rows).to(torch.float32).cpu().numpy()
    return carry, {"kinetic": table[:, 0], "potential": table[:, 1],
                   "total": table[:, 0] + table[:, 1],
                   "rebinned": np.asarray(flags, np.int32),
                   "displacement": table[:, 2]}


def _init_carry(p: InteractionPlan, mass: float, positions, velocities,
                step0: int, fields, valid, rng: torch.Tensor, forces0,
                pot0) -> TrajCarry:
    """Cold start: bin, evaluate (or adopt) forces, seed the monitors. An
    MDState input's committed forces are adopted, not recomputed."""
    bins = _bin(p, positions, fields, valid)
    if forces0 is None:
        forces0, pot0 = _forces(p, bins, positions, fields, valid)
    ke, pe = _masked_energies(velocities, pot0, valid, mass)
    return TrajCarry(md=MDState(positions, velocities, forces0, pot0, step0),
                     bins=bins, ref=positions, rng=rng, rebins=0,
                     mon=M.init_monitors(ke + pe))


def _rebin(p: InteractionPlan, carry: TrajCarry, fields, valid
           ) -> TrajCarry:
    """Forced rebin: fresh bins + reference at the carried positions; the
    committed MD state and monitors are untouched, and so is
    ``carry.rebins``, which counts skin-contract rebins only."""
    return dataclasses.replace(
        carry, bins=_bin(p, carry.md.positions, fields, valid),
        ref=carry.md.positions)


def reference_step(p: InteractionPlan, integrator: str = "velocity_verlet",
                   mass: float = 1.0):
    """One per-step ``plan.execute`` baseline step, arithmetic-identical to
    the trajectory's step: with ``skin=0`` the trajectory must match a loop
    of it bit for bit. Langevin runs at gamma = kT = 0 here."""
    gen = torch.Generator(device=p.device)

    def step(md: MDState, dt: float) -> MDState:
        return make_step(p, integrator, coefficients(dt, mass, 0.0, 0.0),
                         gen)(md)
    return step


# --------------------------------------------------------------------------
# the host loop: segments, breaches, rollback, replan, checkpoint, resume
# --------------------------------------------------------------------------


def _normalize_state(state, velocities):
    """Accept MDState / ParticleState / raw (N, 3) positions. An MDState
    also contributes its committed (forces, potential), which the cold
    start adopts instead of recomputing."""
    if isinstance(state, MDState):
        return (state.positions, state.velocities, {}, None,
                int(state.step), state.forces, state.potential)
    if isinstance(state, ParticleState):
        pos = state.positions
        vel = (velocities if velocities is not None
               else torch.zeros_like(pos))
        return pos, vel, dict(state.fields), state.valid, 0, None, None
    pos = state
    vel = velocities if velocities is not None else torch.zeros_like(pos)
    return pos, vel, {}, None, 0, None, None


def _empty_traces() -> Dict[str, np.ndarray]:
    out = {k: np.zeros((0,), np.float32) for k in TRACE_KEYS}
    out["rebinned"] = np.zeros((0,), np.int32)
    out["displacement"] = np.zeros((0,), np.float32)
    return out


def run_trajectory(base: InteractionPlan, state, n_steps: int, dt: float, *,
                   integrator: str = "velocity_verlet",
                   skin: Optional[float] = None,
                   mass: float = 1.0, gamma: float = 0.1, kT: float = 0.0,
                   velocities: Optional[torch.Tensor] = None, seed: int = 0,
                   checkpoint_dir: Optional[Union[str, pathlib.Path]] = None,
                   checkpoint_every: Optional[int] = None,
                   resume: bool = True,
                   segment_len: int = 32,
                   energy_budget: Optional[float] = None,
                   max_rollbacks: int = 4, max_replans: int = 4,
                   max_retries: Optional[int] = None,
                   traj_plan: Optional[InteractionPlan] = None,
                   sleep=None) -> TrajectoryResult:
    """Run ``n_steps`` of guarded simulation; ``InteractionPlan.trajectory``
    is the front door and the module docstring the contract. Injected
    faults and breaches degrade or roll back, and the worst case is
    ``status="failed"`` with the last committed state; a real exception
    propagates."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}; have "
                         f"{INTEGRATORS}")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    _check_supported(base)

    positions, vels, fields, valid, step0, forces0, pot0 = _normalize_state(
        state, velocities)
    field_state = ParticleState(positions, fields, valid)
    base._check_state(field_state, batched=False)

    # -- the skin plan ------------------------------------------------------
    if traj_plan is not None:
        _check_supported(traj_plan)
        p = traj_plan
    else:
        if skin is None:
            skin = DEFAULT_SKIN_FRACTION * base.domain.cutoff
        p = trajectory_plan(base, skin, positions, valid)
    eff_skin = 0.0 if (skin == 0 and traj_plan is None) else \
        effective_skin(p.domain)
    # initial bounds must cover the initial positions
    replans = 0
    while p.check_overflow(field_state) and replans < max_replans:
        p = p.replan(field_state)
        replans += 1

    co = coefficients(dt, mass, gamma, kT)
    gen = torch.Generator(device=p.device)
    gen.manual_seed(seed)
    rng0 = gen.get_state()

    seg = max(1, int(segment_len))
    ck_every = None
    if checkpoint_dir is not None:
        ck_every = _round_up(checkpoint_every or 4 * seg, seg)
        checkpoint_dir = pathlib.Path(checkpoint_dir)

    result = TrajectoryResult(state=None, traces={}, plan=p,
                              replans=replans, eff_skin=float(eff_skin))

    # -- resume or cold start ----------------------------------------------
    steps_done = 0
    carry = None
    if checkpoint_dir is not None and resume:
        last = _ckpt.latest_step(checkpoint_dir)
        if last is not None:
            extra = _ckpt.read_extra(checkpoint_dir, last)
            if (tuple(extra.get("ncells", ())) != p.domain.ncells
                    or extra.get("integrator") != integrator):
                raise ValueError(
                    f"checkpoint {checkpoint_dir}/step_{last:08d} was "
                    f"written by a different trajectory configuration "
                    f"({extra.get('ncells')}, {extra.get('integrator')}); "
                    "refusing to resume onto it")
            # bounds may have been grown before the checkpoint: the
            # template must match the saved static shapes
            p = dataclasses.replace(
                p, m_c=int(extra["m_c"]), box=None,
                row_cap=(int(extra["row_cap"]) if extra.get("row_cap")
                         else p.row_cap),
                max_active=(int(extra["max_active"])
                            if extra.get("max_active") else p.max_active))
            template = _init_carry(p, mass, positions, vels, step0, fields,
                                   valid, rng0, forces0, pot0)
            with _obs_trace("traj.checkpoint.load", step=last,
                            dir=str(checkpoint_dir)):
                carry, _ = _ckpt.restore(checkpoint_dir, template, step=last)
            steps_done = int(extra["steps_done"])
            result.resumed_from = last
            result.plan = p

    if carry is None:
        carry = _init_carry(p, mass, positions, vels, step0, fields, valid,
                            rng0, forces0, pot0)
    # registry baseline: carry.rebins is cumulative across resumes, the
    # counter counts only the rebins this call performs
    rebins0 = carry.rebins

    if n_steps == 0 or steps_done >= n_steps:
        result.state = carry.md
        result.steps = steps_done
        result.rebins = carry.rebins
        result.traces = _empty_traces()
        return result

    # -- the guarded segment loop ------------------------------------------
    rungs = api.degradation_ladder(p)
    health = api.plan_health(p)
    level = min(health.level, len(rungs) - 1)
    if max_retries is None:
        max_retries = api._FAILURE_THRESHOLD * len(rungs)

    segments: List[Dict[str, np.ndarray]] = []
    anchor = (carry, steps_done, 0)          # (carry, steps_done, n_segments)
    attempts = rollbacks = 0
    mon_prev = M.to_host(carry.mon)
    failed = False

    def rebin_at(q, c):
        result.forced_rebins += 1
        with _obs_trace("traj.rebin", kind="forced", m_c=q.m_c,
                        strategy=q.strategy):
            return _rebin(q, c, fields, valid)

    while steps_done < n_steps:
        boundary = (steps_done // seg + 1) * seg
        this_len = min(boundary, n_steps) - steps_done
        rung = rungs[min(level, len(rungs) - 1)]
        st = chaos.state()
        fires_before = (st.fire_count("traj.step", "nonfinite")
                        if st is not None else 0)
        if sleep is None:
            chaos.maybe_delay("traj.step")
        else:
            chaos.maybe_delay("traj.step", sleep=sleep)
        fault = chaos.injected_fault("traj.step")
        if fault is not None:
            # JAX's except branch: the segment never ran; retry it
            result.faults.append(f"{type(fault).__name__}: {fault}")
            attempts += 1
            result.retries += 1
            if health.note_failure(len(rungs)):
                level = health.level
            if attempts > max_retries:
                failed = True
                break
            continue
        with _obs_trace("traj.segment", steps=this_len, start=steps_done,
                        backend=rung.backend, strategy=rung.strategy,
                        level=level):
            carry2, ys = _segment(rung, integrator, this_len, co,
                                  float(eff_skin), mass, carry, fields,
                                  valid)
        # host-boundary corruption point
        pos2 = chaos.corrupt("traj.step", carry2.md.positions)
        injected_nan = (st is not None and st.fire_count(
            "traj.step", "nonfinite") > fires_before)
        if injected_nan:
            carry2 = dataclasses.replace(
                carry2, md=dataclasses.replace(carry2.md, positions=pos2))
        mon_cur = M.to_host(carry2.mon)

        # ---- overflow? grow bounds, roll back, replay --------------------
        forced = chaos.forced_overflow("traj.rebin")
        grown = _grow_bounds(p, mon_cur.max_cell_count,
                             mon_cur.max_row_count, mon_cur.max_active_units)
        if grown != p or forced:
            if grown == p:
                # injected verdict with nothing to grow: record, move on
                result.faults.append("overflow:injected")
            elif result.replans >= max_replans:
                result.faults.append("overflow:replan-budget-exhausted")
                failed = True
                break
            else:
                result.replans += 1
                api._count_replan(p)
                _obs_event("traj.replan", m_c=grown.m_c, m_c_was=p.m_c,
                           row_cap=grown.row_cap,
                           max_active=grown.max_active)
                p = grown
                result.plan = p
                rungs, health = api.degradation_ladder(p), api.plan_health(p)
                level = min(health.level, len(rungs) - 1)
                # anchor bins were built under the old m_c: rebuild them
                carry, steps_done, nseg = anchor
                carry = rebin_at(rungs[min(level, len(rungs) - 1)], carry)
                del segments[nseg:]
                anchor = (carry, steps_done, nseg)
                mon_prev = M.to_host(carry.mon)
                continue

        # ---- invariant breach? roll back + forced rebin ------------------
        breach = ("nonfinite" if injected_nan else
                  M.classify_breach(mon_prev, mon_cur, energy_budget))
        if breach is not None:
            result.faults.append(f"breach:{breach}@{steps_done}")
            rollbacks += 1
            result.rollbacks = rollbacks
            _obs_event("traj.rollback", breach=breach, step=steps_done,
                       anchor_step=anchor[1])
            if health.note_failure(len(rungs)):
                level = health.level
            if rollbacks > max_rollbacks:
                failed = True
                break
            carry, steps_done, nseg = anchor
            carry = rebin_at(rungs[min(level, len(rungs) - 1)], carry)
            del segments[nseg:]
            anchor = (carry, steps_done, nseg)
            mon_prev = M.to_host(carry.mon)
            continue

        # ---- commit ------------------------------------------------------
        health.note_success()
        attempts = 0
        carry = carry2
        mon_prev = mon_cur
        steps_done += this_len
        segments.append(ys)

        at_ck = ck_every is not None and steps_done % ck_every == 0
        if at_ck or steps_done >= n_steps or ck_every is None:
            if at_ck and checkpoint_dir is not None:
                # a failed checkpoint must never kill the run; the
                # in-memory anchor still advances
                fault = chaos.injected_fault("traj.checkpoint")
                if fault is None:
                    with _obs_trace("traj.checkpoint.save", step=steps_done,
                                    dir=str(checkpoint_dir)):
                        _, fault = _ckpt._save(
                            checkpoint_dir, steps_done, carry,
                            extra={"steps_done": steps_done,
                                   "ncells": list(p.domain.ncells),
                                   "integrator": integrator,
                                   "m_c": p.m_c, "row_cap": p.row_cap,
                                   "max_active": p.max_active,
                                   "segment_len": seg})
                if fault is None:
                    result.checkpoints += 1
                elif isinstance(fault, chaos.TransientBackendError):
                    result.faults.append(
                        f"checkpoint:{type(fault).__name__}")
                else:
                    raise fault     # JAX's branch lets this one through
            anchor = (carry, steps_done, len(segments))

    # -- finalize ----------------------------------------------------------
    if failed:
        # the anchor is the last committed healthy state
        carry, steps_done, nseg = anchor
        del segments[nseg:]
        result.status = "failed"
    else:
        result.status = "ok" if level == 0 else "degraded"
    result.state = carry.md
    result.steps = steps_done
    result.rebins = carry.rebins
    result.ladder_level = level
    _obs_metrics.registry.counter(
        REBIN_TOTAL, backend=p.backend, strategy=p.strategy,
        layout=p.layout).inc(max(0, result.rebins - rebins0)
                             + result.forced_rebins)
    result.traces = (
        {k: np.concatenate([s[k] for s in segments]) for k in segments[0]}
        if segments else _empty_traces())
    return result
