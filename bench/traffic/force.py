"""Force-evaluation traffic: a closed loop of ``InteractionPlan.execute``
calls back to back over a pool of seeded snapshots, one synchronize at the
window's end. Every call bins from scratch (the plan's cutoff grid).

Cell parameters: ``snapshots`` (the pool), ``jitter`` (each snapshot is
the configuration's lattice moved by a normal of this deviation),
``check_snapshots`` (how many of the window's last answers, one a
snapshot, the reference judges, drawn from the seed), ``trace_calls``
(the profiled slice), ``plan`` (``plan()`` options).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import ParticleState
from repro_torch.core import plan as make_plan

from .. import gen
from .. import reference as R
from . import system


def make_snapshots(ctx):
    cfg, cell = ctx.config, ctx.cell
    g = gen.generator(ctx.seed, ctx.device)
    return gen.fcc_lattice(cfg["unit_cells"], cfg["lattice_constant"],
                           cell["jitter"], g, ctx.device, gaussian=True,
                           batch=cell["snapshots"]).contiguous()


def run(ctx) -> None:
    cfg, cell = ctx.config, ctx.cell
    snaps = make_snapshots(ctx)
    states = [ParticleState(s) for s in snaps]
    p = make_plan(system.cutoff_domain(cfg), system.kernel(cfg),
                  positions=snaps[0], device=ctx.device,
                  **cell.get("plan", {}))
    for st in states:
        while p.check_overflow(st):
            p = p.replan(st)
    ctx.log(f"N = {snaps.shape[1]}, plan: strategy {p.strategy}, layout "
            f"{p.layout}, m_c {p.m_c}, grid {p.domain.ncells}")
    for st in states:
        p.execute(st)
    ctx.window_started()
    t0 = time.perf_counter()
    calls, last = 0, {}
    while True:
        k = calls % len(states)
        last[k] = p.execute(states[k])
        calls += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    ctx.attempted = calls
    ctx.obs.update({"window_s": window, "units": calls,
                    "force.calls": calls,
                    "pair_flops": p.kernel.flops})
    ctx.log(f"window {window:.3f} s: {calls} calls")
    if ctx.trace:
        tc = cell["trace_calls"]
        ctx.profile(lambda: [p.execute(states[i % len(states)])
                             for i in range(tc)], tc)
    ctx.read_peak()
    rng = np.random.default_rng(ctx.seed)
    pick = sorted(rng.choice(sorted(last), size=min(cell["check_snapshots"],
                                                     len(last)),
                             replace=False).tolist())
    outputs = {k: last[k] for k in pick}
    del p, last, states
    ctx.free()
    judge(ctx, snaps, outputs)
    if ctx.control:
        judge(ctx, snaps, control_outputs(ctx, snaps, outputs),
              record=ctx.control_check)


def control_outputs(ctx, snaps, outputs):
    """The bfloat16 control's answers on the same snapshots."""
    cfg = ctx.config
    out = {}
    for k in outputs:
        f, u, _ = R.lj_forces(snaps[k], system.box(cfg), cfg["cutoff"],
                              dtype=torch.bfloat16,
                              **system.reference_kwargs(cfg))
        out[k] = (f, u)
    return out


def judge(ctx, snaps, outputs, record=None) -> None:
    """Each kept answer against the float64 reference on its snapshot."""
    record = record or ctx.check
    cfg = ctx.config
    kw = system.reference_kwargs(cfg)
    f_err, u_err, pairs = [], [], []
    for k, (f_got, u_got) in outputs.items():
        f, u, npairs = R.lj_forces(snaps[k].double(), system.box(cfg),
                                   cfg["cutoff"], **kw)
        f_err.append(R.rel_l2(f_got, f))
        u_err.append(R.rel_l2(u_got, u))
        pairs.append(npairs)
    mean_pairs = float(np.mean(pairs))
    n = snaps.shape[1]
    ctx.obs["window_work"] = {"pairs": ctx.obs["units"] * mean_pairs}
    if ctx.trace:
        tc = ctx.cell["trace_calls"]
        ctx.obs["profile_work"] = {"particles": tc * n,
                                   "pairs": tc * mean_pairs}
    ctx.log(f"pairs within the cutoff a snapshot: {mean_pairs:.1f}")
    record("force_rel_l2", max(f_err))
    record("potential_rel_l2", max(u_err))
