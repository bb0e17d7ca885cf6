"""The serving tier of the PyTorch/CUDA port end to end: the
continuous-batching front door.

    PYTHONPATH=src python examples/torch_serve_engine.py [--requests 40]
        [--device cpu]

The port of ``serve_engine.py``. Feeds a ``ServingEngine`` a stream of
interaction requests of varying size and scene (drawn from the scenario
family), lets the engine bucket them into shape classes and dispatch
batched executions, then prints the per-class routing and the
latency/throughput snapshot. The stream runs twice: the first pass builds
plans and executors (and grows bounds for the clustered scenes), the
second shows the steady state -- the recompile counter (executor builds,
``core.recompile_count``) stays at zero. It runs on the CUDA card, and
raises without one unless ``--device cpu`` is given (the kernels' plain
versions then run). Request i draws from a ``torch.Generator`` seeded
1000 + i, so the particles differ from the JAX script's (threefry) draw;
the sizes and scenes come from numpy's generator seeded 0, as there.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.core import Domain, ParticleState, recompile_count, scenarios
from repro_torch.core._device import describe_device, resolve_device
from repro_torch.serve import ServeMetrics, ServingEngine

SCENES = ["uniform", "gaussian_blob", "two_phase"]
SIZES = [50, 60, 100, 200]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--division", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(describe_device(dev))

    dom = Domain.cubic(args.division, cutoff=1.0)
    eng = ServingEngine(max_batch=args.max_batch, max_wait=0.0, device=dev)

    rng = np.random.default_rng(0)
    stream = []
    for i in range(args.requests):
        n = SIZES[rng.integers(len(SIZES))]
        scene = SCENES[rng.integers(len(SCENES))]
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        pos = scenarios.sample(scene, dom, n, generator=gen, device=dev)
        stream.append(ParticleState(pos))

    def run_stream():
        for state in stream:
            eng.submit(dom, state)
        eng.flush()
        return eng.take_responses()

    run_stream()                              # warmup: plans, executors
    for state in stream:
        eng.prewarm(dom, state)               # cover part-full batch shapes
    rc_warm = recompile_count()
    eng.metrics = ServeMetrics()              # report the steady state only
    responses = run_stream()

    by_class = {}
    for r in responses:
        by_class.setdefault(r.shape_class, []).append(r)
    print(f"{args.requests} requests -> {len(by_class)} shape classes:")
    for label, rs in sorted(by_class.items()):
        print(f"  {label}: {len(rs)} served")
    snap = eng.metrics.snapshot()
    print(f"batches={snap['batches']} "
          f"batch_fill={snap['batch_fill']:.2f} "
          f"replans={snap['replans']}")
    print(f"p50={snap['total_latency']['p50_s'] * 1e3:.2f}ms "
          f"p99={snap['total_latency']['p99_s'] * 1e3:.2f}ms "
          f"rps={snap['rps']:.1f}")
    steady = recompile_count() - rc_warm
    print(f"recompiles in steady state: {steady}")
    return {"device": str(dev), "requests": args.requests,
            "ok": sum(r.status == "ok" for r in responses),
            "shape_classes": len(by_class), "batches": snap["batches"],
            "steady_state_recompiles": steady}


if __name__ == "__main__":
    main()
