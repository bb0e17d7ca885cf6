"""Serving traffic: an open loop of Poisson arrivals at a fixed rate into
``ServingEngine`` (``submit``/``poll``, one ``execute_batch`` a dispatch),
on a real monotonic clock. The rate is fixed in the cell, far above the
engine's capacity, so the engine is never short of work and the requests
it answers ``"ok"`` in the window, over the window, are its throughput.
The engine's ``submit`` dispatches a bucket that fills, so while it runs,
requests that fall due wait on the client's side; at the window's close
the client stops, and what it had not handed over is never sent.

Cell parameters: ``rate_per_s``; ``request_unit_cells`` (each request is
the configuration's lattice at this many fcc cells a side); ``pool`` (the
seeded configurations made in set-up, in host memory as a client's
request would arrive); ``jitter``; ``max_batch``, ``max_wait_s``,
``max_queue``; ``grace_s`` (how long past the close an answer is waited
for, 60 s by default); ``torch_threads`` (the process's intra-op threads,
as a serving deployment pins them: with the default, one per core, the
host's stacking and overflow checks contend with the loop);
``keep_share`` (the share of requests, drawn from the seed, whose answers
are kept) and ``check_requests`` (how many of the kept ``"ok"`` answers,
drawn from the seed, the reference judges); ``trace_seconds`` (the
profiled slice, an open loop of its own at the same rate); ``plan``
(``plan()`` options).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core import Domain, ParticleState
from repro_torch.serve import ServingEngine

from .. import gen, harness
from .. import reference as R
from . import system


def request_domain(cfg: dict, cell: dict) -> Domain:
    side = cell["request_unit_cells"] * cfg["lattice_constant"]
    nc = int(side / cfg["cutoff"] + 1e-9)
    return Domain(box=(side,) * 3, ncells=(nc,) * 3, cutoff=cfg["cutoff"],
                  periodic=True)


def make_pool(ctx):
    cfg, cell = ctx.config, ctx.cell
    g = gen.generator(ctx.seed, ctx.device)
    pool = gen.fcc_lattice(cell["request_unit_cells"],
                           cfg["lattice_constant"], cell["jitter"], g,
                           ctx.device, batch=cell["pool"])
    return pool.cpu()


def make_engine(ctx, dom, first):
    cell = ctx.cell
    engine = ServingEngine(
        system.kernel(ctx.config), max_batch=cell["max_batch"],
        max_queue=cell["max_queue"], max_wait=cell["max_wait_s"],
        clock=time.perf_counter, device=ctx.device,
        plan_opts=cell.get("plan", {}))
    sc = engine.prewarm(dom, first)
    return engine, sc


class Loop:
    """What an open loop saw: ``sent`` requests handed to the engine (the
    first ``sent`` of the schedule), and for each the status of its answer
    (None: never answered), its latency from its scheduled arrival and its
    answer time from the start (s, inf unless ``"ok"``), how late it was
    handed over (s); the kept ``"ok"`` answers {i: (forces, potential)}
    and the seconds from the start to the last answer."""

    def __init__(self, n: int):
        self.sent = 0
        self.status = [None] * n
        self.latency = [math.inf] * n
        self.done = [math.inf] * n
        self.late = [0.0] * n
        self.kept = {}
        self.span = 0.0

    @property
    def ok(self) -> int:
        return sum(1 for s in self.status[:self.sent] if s == "ok")


def open_loop(engine, dom, states, arrivals, which, keep=None,
              stop_s: float = math.inf, grace_s: float = 60.0) -> Loop:
    """Drive ``engine`` with request ``i`` (state ``states[which[i]]``)
    due at ``arrivals[i]`` seconds after the start; at most a batch is
    handed over between two polls. From ``stop_s`` on nothing more is
    handed over. Waits for the answers to what was handed over until
    ``grace_s`` past the earlier of ``stop_s`` and the last arrival.
    Keeps the ``"ok"`` answers of the requests ``i`` with ``keep[i]``."""
    n = len(arrivals)
    out = Loop(n)
    sub = [0.0] * n
    ids = {}
    answered = 0
    t_start = time.perf_counter()
    t_last = t_start
    end = min(stop_s, float(arrivals[-1]) if n else 0.0)
    give_up = t_start + end + grace_s
    while True:
        el = time.perf_counter() - t_start
        handed = 0
        while (out.sent < n and handed < engine.max_batch and el < stop_s
               and arrivals[out.sent] <= el):
            i = out.sent
            sub[i] = time.perf_counter()
            out.late[i] = sub[i] - (t_start + arrivals[i])
            ids[engine.submit(dom, states[which[i]])] = i
            out.sent += 1
            handed += 1
            el = time.perf_counter() - t_start
        engine.poll()
        for resp in engine.take_responses():
            k = ids.pop(resp.req_id)
            answered += 1
            out.status[k] = resp.status
            if resp.status == "ok":
                t_done = sub[k] + resp.total_latency
                out.latency[k] = t_done - (t_start + arrivals[k])
                out.done[k] = t_done - t_start
                t_last = max(t_last, t_done)
                if keep is not None and keep[k]:
                    out.kept[k] = (resp.forces.clone(),
                                   resp.potential.clone())
            else:
                t_last = max(t_last, time.perf_counter())
        if answered == out.sent and (out.sent == n or el >= stop_s):
            break
        if time.perf_counter() > give_up:
            break
    out.span = t_last - t_start
    return out


def run(ctx) -> None:
    cfg, cell = ctx.config, ctx.cell
    if "torch_threads" in cell:
        torch.set_num_threads(cell["torch_threads"])
    dom = request_domain(cfg, cell)
    pool = make_pool(ctx)
    states = [ParticleState(pool[k]) for k in range(pool.shape[0])]
    engine, sc = make_engine(ctx, dom, states[0])
    cp = engine.class_plan(sc)
    ctx.log(f"requests of {pool.shape[1]} particles, class {sc.label()}, "
            f"plan: strategy {cp.strategy}, layout {cp.layout}, m_c "
            f"{cp.m_c}, grid {cp.domain.ncells}")
    rng = np.random.default_rng(ctx.seed)
    rate = cell["rate_per_s"]
    arrivals = gen.poisson_arrivals(rate, ctx.seconds, rng)
    which = rng.integers(len(states), size=len(arrivals))
    keep = rng.random(len(arrivals)) < cell["keep_share"]
    b0 = engine.metrics.batches
    ctx.window_started()
    loop = open_loop(engine, dom, states, arrivals, which, keep,
                     stop_s=ctx.seconds, grace_s=cell.get("grace_s", 60.0))
    ctx.sync()
    sent = loop.sent
    lat = loop.latency[:sent]
    in_window = sum(1 for x in loop.done[:sent] if x <= ctx.seconds)
    m = engine.metrics
    ctx.attempted, ctx.failed = sent, sent - loop.ok
    ctx.obs.update({
        "window_s": ctx.seconds, "units": m.batches - b0,
        "serve.latencies_s": lat, "serve.served_in_window": in_window,
        "serve.dispatch_s": list(m.dispatch_latency.samples),
        "serve.batch_fill": list(m.batch_fill.samples),
        "pair_flops": system.kernel(cfg).flops})
    tenth = ctx.seconds / 10
    slices = [0] * 10
    for x in loop.done[:sent]:
        if x <= ctx.seconds:
            slices[min(int(x / tenth), 9)] += 1
    p50, p95 = (1e3 * harness.quantile_p(lat, q) for q in (50, 95))
    ctx.log(f"window {ctx.seconds:.3f} s: {len(arrivals)} requests due at "
            f"{rate}/s, {sent} handed over, {loop.ok} answered ok, "
            f"{in_window} of them in the window, the last at "
            f"{loop.span:.3f} s, by {m.batches - b0} dispatches; latency "
            f"p50 {p50:.1f} ms, p95 {p95:.1f} ms; hand-over lateness p95 "
            f"{1e3 * np.percentile(loop.late[:sent] or [0.0], 95):.3f} ms; "
            f"snapshot {_brief(m.snapshot())}; answered a second by tenth "
            f"of the window: {[round(c / tenth, 1) for c in slices]}")
    if ctx.trace:
        t_arr = gen.poisson_arrivals(rate, cell["trace_seconds"], rng)
        t_which = rng.integers(len(states), size=len(t_arr))
        b1 = engine.metrics.batches
        traced = []
        ctx.profile(lambda: traced.append(open_loop(
            engine, dom, states, t_arr, t_which,
            stop_s=cell["trace_seconds"])), 0)
        if "profile" in ctx.obs:
            ctx.obs["profile"]["units"] = engine.metrics.batches - b1
        ctx.obs["profile.requests"] = traced[0].ok
    ctx.read_peak()
    del engine, cp
    ctx.free()
    kept = sorted(loop.kept)
    pick = rng.choice(kept, size=min(cell["check_requests"], len(kept)),
                      replace=False).tolist() if kept else []
    outputs = {k: loop.kept[k] for k in sorted(pick)}
    judge(ctx, pool, which, outputs, ctx.failed)
    if ctx.control:
        judge(ctx, pool, which, control_outputs(ctx, pool, which, outputs),
              0, record=ctx.control_check)


def control_outputs(ctx, pool, which, outputs):
    """The bfloat16 control's answers to the same sampled requests."""
    cfg, cell = ctx.config, ctx.cell
    side = cell["request_unit_cells"] * cfg["lattice_constant"]
    out = {}
    for k in outputs:
        f, u, _ = R.lj_forces(pool[which[k]].to(ctx.device), side,
                              cfg["cutoff"], dtype=torch.bfloat16,
                              **system.reference_kwargs(cfg))
        out[k] = (f, u)
    return out


def _brief(snap: dict) -> dict:
    keys = ("submitted", "served", "rejected", "shed", "batches",
            "recompiles", "replans", "failed", "faults", "batch_fill")
    return {k: snap[k] for k in keys}


def judge(ctx, pool, which, outputs, not_ok: int, record=None) -> None:
    """The sampled ``"ok"`` answers against the float64 reference on the
    same request. ``not_ok`` counts the requests handed over whose answer
    was not ``"ok"`` or never came: a failed, refused, shed or expired
    request is a wrong answer. With no answer to judge, each relative L2
    reads 1 (an answer of zeros)."""
    record = record or ctx.check
    cfg, cell = ctx.config, ctx.cell
    side = cell["request_unit_cells"] * cfg["lattice_constant"]
    kw = system.reference_kwargs(cfg)
    f_err, u_err, pairs = [], [], []
    for k, got in outputs.items():
        x = pool[which[k]].to(ctx.device)
        f, u, npairs = R.lj_forces(x.double(), side, cfg["cutoff"], **kw)
        pairs.append(npairs)
        f_err.append(R.rel_l2(got[0], f))
        u_err.append(R.rel_l2(got[1], u))
    n = pool.shape[1]
    mean_pairs = float(np.mean(pairs)) if pairs else 0.0
    served = ctx.obs.get("serve.served_in_window", 0)
    ctx.obs["window_work"] = {"pairs": served * mean_pairs}
    if "profile.requests" in ctx.obs:
        r = ctx.obs["profile.requests"]
        ctx.obs["profile_work"] = {"particles": r * n,
                                   "pairs": r * mean_pairs}
    ctx.log(f"{len(outputs)} answers judged; pairs within the cutoff a "
            f"request: {mean_pairs:.1f}")
    record("force_rel_l2", max(f_err, default=1.0))
    record("potential_rel_l2", max(u_err, default=1.0))
    record("not_ok", not_ok)
