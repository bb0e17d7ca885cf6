"""Measured autotuning and batched execution on the PyTorch/CUDA port,
through the plan/execute API.

    PYTHONPATH=src python examples/torch_autotune_batch.py [--device cpu]

The port of ``autotune_batch.py``.

Part 1 -- autotune: instead of trusting the analytical traffic model
(``strategy="auto"``), ``tune`` enumerates candidate (strategy, backend,
batch_size, m_c, sub-box) configurations, prunes them with the model,
*times* the survivors on the device and returns the fastest plan. The
winner is cached on disk (under ``$REPRO_TORCH_AUTOTUNE_CACHE`` when set),
so ``plan(strategy="autotune", backend="all")`` on the same regime is
served from the cache with zero timing runs.

Part 2 -- batched execution: ``execute_batch`` runs one plan over B
independent stacked systems (the paper's few-particles-per-cell regime) in
one dispatch instead of B, bit-equal to the loop.

It runs on the CUDA card, where the tuner times the ``"cuda"`` kernels
beside the reference schedules, and raises without one unless ``--device
cpu`` is given (the reference schedules alone are then tuned). The
particles come from ``torch.Generator``s seeded 0 and 1, so they differ
from the JAX script's (threefry) draw.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import (Domain, ParticleState, dispatch_count,
                              make_lennard_jones, plan, tune)
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.core.autotune import timing_run_count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--division", type=int, default=4)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--systems", type=int, default=8)
    ap.add_argument("--n-per-system", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    domain = Domain.cubic(division=args.division, cutoff=1.0)
    kernel = make_lennard_jones(sigma=0.2)
    positions = domain.sample_uniform(
        args.n, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)

    # -- part 1: measured autotuning -------------------------------------
    result = tune(domain, kernel, positions)
    print(f"timed {len(result.timings)} candidates "
          f"({len(result.pruned)} pruned by the traffic model):")
    for cand, secs in sorted(result.timings.items(), key=lambda kv: kv[1]):
        mark = "  <- winner" if cand == result.candidate else ""
        print(f"  {cand.strategy:11s} {cand.backend:9s} "
              f"bs={cand.batch_size:<4d} m_c={cand.m_c:<4d} "
              f"{secs * 1e6:9.1f} us{mark}")

    # same regime through the front door: backend="all" defers to the same
    # platform-default backend set tune() used, so this is served from the
    # on-disk cache -- zero timing runs this time
    runs = timing_run_count()
    p = plan(domain, kernel, positions=positions, strategy="autotune",
             backend="all", device=dev)
    assert p == result.plan
    cached_runs = timing_run_count() - runs
    assert cached_runs == 0
    print(f'plan(strategy="autotune") -> "{p.strategy}" '
          f"(cached in {result.cache_file}, {cached_runs} timing runs)")

    # -- part 2: batched execution ---------------------------------------
    b, n = args.systems, args.n_per_system
    gen = torch.Generator(device=dev).manual_seed(1)
    stacked = torch.stack([domain.sample_uniform(n, generator=gen,
                                                 device=dev)
                           for _ in range(b)])
    pbatch = plan(domain, kernel, positions=stacked[0], strategy="xpencil",
                  device=dev)

    before = dispatch_count()
    forces, pot = pbatch.execute_batch(ParticleState(stacked))
    batched_dispatches = dispatch_count() - before

    before = dispatch_count()
    loop = [pbatch.execute(ParticleState(stacked[i])) for i in range(b)]
    loop_dispatches = dispatch_count() - before
    f_loop = torch.stack([f for f, _ in loop])
    assert batched_dispatches == 1 and loop_dispatches == b
    assert torch.equal(forces, f_loop)
    print(f"execute_batch: {b} systems x {n} particles in "
          f"{batched_dispatches} dispatch (loop: {loop_dispatches}), "
          f"bit-identical.")
    return {"device": str(dev), "winner": result.candidate.strategy,
            "timed": len(result.timings), "cache_file": result.cache_file,
            "cached_timing_runs": cached_runs,
            "batch_dispatches": batched_dispatches,
            "loop_dispatches": loop_dispatches, "batch_equals_loop": True}


if __name__ == "__main__":
    main()
