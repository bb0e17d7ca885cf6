"""Trajectory traffic: consecutive ``plan.trajectory`` calls of a fixed
length, each carrying the last call's state and plan over (as
``serve/trajectory.py`` does), for ``ctx.seconds``.

Cell parameters: ``steps_per_call``, ``warm_steps`` (set-up calls of this
length until one grows no bound), ``trace_steps`` (the profiled call),
``jitter`` (the start lattice's), ``plan`` (extra ``plan()`` options).

Correctness: once the window has closed, the program runs one step more
through the same entry from the window's last state and one from the
start, and the float64 reference judges (a) the window's last forces at
its positions, where the bins are as stale as the skin allowed, (b) that
step's forces, potential and velocities against a reference step from the
same state, (c) the same from the start. Langevin's check steps run at
kT = 0 (deterministic; the noise's draw has no reference).
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import plan as make_plan
from repro_torch.physics.integrators import MDState

from .. import reference as R
from . import system


def _seed(ctx, k: int) -> int:
    return (ctx.seed * 1_000_003 + k) % (2 ** 63)


def _opts(cfg: dict, kT=None) -> dict:
    if cfg["integrator"] == "langevin":
        return {"integrator": "langevin", "gamma": cfg["gamma"],
                "kT": cfg["kT"] if kT is None else kT, "mass": cfg["mass"]}
    return {"integrator": cfg["integrator"], "mass": cfg["mass"]}


def run(ctx) -> None:
    cfg, cell = ctx.config, ctx.cell
    dt = cfg["dt"]
    x0, v0 = system.start(cfg, ctx.seed, ctx.device, cell["jitter"])
    n = x0.shape[0]
    p = make_plan(system.cutoff_domain(cfg), system.kernel(cfg),
                  positions=x0, device=ctx.device, **cell.get("plan", {}))
    ctx.log(f"N = {n}, plan: strategy {p.strategy}, layout {p.layout}, "
            f"m_c {p.m_c}, grid {p.domain.ncells}")
    opts = _opts(cfg)
    calls = 0

    def call(state, steps, tp, **over):
        nonlocal calls
        calls += 1
        o = {**opts, **over}
        return p.trajectory(state, steps, dt, skin=cfg["skin"],
                            traj_plan=tp, seed=_seed(ctx, calls), **o)

    res = call(x0, cell["warm_steps"], None, velocities=v0)
    while res.replans:
        res = call(res.state, cell["warm_steps"], res.plan)
    tp = res.plan
    ctx.log(f"trajectory plan: strategy {tp.strategy}, layout {tp.layout}, "
            f"m_c {tp.m_c}, grid {tp.domain.ncells}, skin "
            f"{res.eff_skin:.4f}")
    state = res.state
    ctx.window_started()
    t0 = time.perf_counter()
    steps = rebins = replans = n_calls = bad = 0
    marks = []
    while True:
        r = call(state, cell["steps_per_call"], tp)
        marks.append(time.perf_counter() - t0)
        state, tp = r.state, r.plan
        steps += r.steps
        rebins += r.rebins
        replans += r.replans
        n_calls += 1
        bad += r.status != "ok"
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    ctx.attempted, ctx.failed = n_calls, bad
    ctx.obs.update({"window_s": window, "units": steps, "traj.steps": steps,
                    "traj.rebins": rebins, "n_atoms": n,
                    "pair_flops": p.kernel.flops})
    ctx.log(f"window {window:.3f} s: {n_calls} calls, {steps} steps, "
            f"{rebins} rebins, {replans} replans, {bad} not ok; seconds "
            f"a call (the host's view): "
            f"{[round(b - a, 3) for a, b in zip([0.0] + marks, marks)]}")
    if ctx.trace:
        ts = cell["trace_steps"]
        ctx.profile(lambda: call(state, ts, tp), ts)
    ctx.read_peak()
    # the program's outputs to judge: the window's last state, a step from
    # it and a step from the start, each through the same entry
    kt0 = {"kT": 0.0} if cfg["integrator"] == "langevin" else {}
    last = _host(state)
    step_last = _host(call(state, 1, tp, **kt0).state)
    step_start = _host(call(x0, 1, tp, velocities=v0, **kt0).state)
    start = (x0, v0)
    del p, tp, state, res, r
    ctx.free()
    judge(ctx, last, step_last, step_start, start)
    if ctx.control:
        judge(ctx, *control_outputs(ctx, last, start), start,
              record=ctx.control_check)


def control_outputs(ctx, last, start):
    """What the bfloat16 control, put in the program's place, gives for
    the three judged outputs: its forces at ``last``, its step from
    ``last`` and its step from ``start``."""
    cfg = ctx.config
    side = system.box(cfg)
    bf16 = torch.bfloat16

    def force(x):
        return R.lj_forces(x, side, cfg["cutoff"], dtype=bf16,
                           **system.reference_kwargs(cfg))

    def step(x, v):
        if cfg["integrator"] == "langevin":
            out = R.baoab_step(force, x, v, cfg["dt"], side, cfg["gamma"],
                               cfg["mass"], dtype=bf16)
        else:
            out = R.verlet_step(force, x, v, cfg["dt"], side, cfg["mass"],
                                dtype=bf16)
        return dict(zip("xvfu", out))

    f, u, _ = force(last["x"])
    return ({**last, "f": f, "u": u}, step(last["x"], last["v"]),
            step(*start))


def _host(md: MDState) -> dict:
    return {"x": md.positions.detach().clone(),
            "v": md.velocities.detach().clone(),
            "f": md.forces.detach().clone(),
            "u": md.potential.detach().clone()}


def judge(ctx, last, step_last, step_start, start, record=None) -> None:
    """The compared numbers: (a) ``last``'s forces and potential at its
    positions; (b) ``step_last``, a step from ``last``: its forces and
    potential at its own positions, and its velocities against a reference
    step from ``last`` (which also holds its positions: a drift left out
    changes the forces the velocities take); (c) the same for
    ``step_start``, a step from ``start``."""
    record = record or ctx.check
    cfg = ctx.config
    side = system.box(cfg)
    kw = system.reference_kwargs(cfg)

    def ref_force(x):
        return R.lj_forces(x, side, cfg["cutoff"], **kw)

    t0 = time.perf_counter()
    f_a, u_a, pairs = ref_force(last["x"].double())
    f_err = [R.rel_l2(last["f"], f_a)]
    u_err = [R.rel_l2(last["u"], u_a)]
    v_err = []
    for before, after in (((last["x"], last["v"]), step_last),
                          (start, step_start)):
        x_b, v_b = before
        if cfg["integrator"] == "langevin":
            _, v1, _, _ = R.baoab_step(ref_force, x_b.double(), v_b,
                                       cfg["dt"], side, cfg["gamma"],
                                       cfg["mass"])
        else:
            _, v1, _, _ = R.verlet_step(ref_force, x_b.double(), v_b,
                                        cfg["dt"], side, cfg["mass"])
        f1, u1, _ = ref_force(after["x"].double())
        f_err.append(R.rel_l2(after["f"], f1))
        u_err.append(R.rel_l2(after["u"], u1))
        v_err.append(R.rel_l2(after["v"], v1))
    n = last["x"].shape[0]
    ctx.obs["window_work"] = {"pairs": ctx.obs["units"] * pairs}
    if ctx.trace:
        ts = ctx.cell["trace_steps"]
        ctx.obs["profile_work"] = {"particles": ts * n, "pairs": ts * pairs}
    ctx.log(f"reference: {time.perf_counter() - t0:.1f} s; pairs within "
            f"the cutoff at the window's end: {pairs}; relative L2 "
            f"(window's end, step from it, step from the start): forces "
            f"{f_err}, potential {u_err}, velocities [-] + {v_err}")
    record("force_rel_l2", max(f_err))
    record("potential_rel_l2", max(u_err))
    record("velocity_rel_l2", max(v_err))
