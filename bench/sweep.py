"""Find the knee of a serving cell once, on the card: the open loop of the
cell at each of several rates in one process, with the latency of the
first and the last tenth of the arrivals, whose gap shows a queue that
grows through the run.

    python bench/sweep.py --workload lj-melt.serve --rates 300,600 \
        --seconds 20

The cell's ``rate_per_s`` is then set, by hand, to about four fifths of the
highest rate whose queue does not grow.
"""

import json
import pathlib
import sys
import time

T0 = time.perf_counter()
_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:1] = [str(_ROOT / "src"), str(_ROOT)]

import argparse  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import gen, harness  # noqa: E402
from bench.traffic import serve  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="lj-melt.serve")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell, config = harness.load_cell(args.workload)
    ctx = harness.Context(args.workload, cell, config, args.seed,
                          args.seconds, False, torch.device("cuda", 0), T0)
    if "torch_threads" in cell:
        torch.set_num_threads(cell["torch_threads"])
    dom = serve.request_domain(config, cell)
    pool = serve.make_pool(ctx)
    states = [serve.ParticleState(pool[k]) for k in range(pool.shape[0])]
    engine, _ = serve.make_engine(ctx, dom, states[0])
    rng = np.random.default_rng(args.seed)
    print("card:", harness.card_state(), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        arr = gen.poisson_arrivals(rate, args.seconds, rng)
        which = rng.integers(len(states), size=len(arr))
        b0 = engine.metrics.batches
        loop = serve.open_loop(engine, dom, states, arr, which)
        lat = loop.latency[:loop.sent]
        tenth = max(1, len(lat) // 10)

        def med(xs):
            xs = [x for x in xs if math.isfinite(x)]
            return 1e3 * float(np.median(xs)) if xs else math.inf

        print(json.dumps({
            "rate": rate, "requests": len(arr), "sent": loop.sent,
            "ok": loop.ok, "ok_per_s": loop.ok / loop.span,
            "answered_in_window_per_s":
                sum(1 for x in loop.done if x <= args.seconds)
                / args.seconds,
            "dispatches": engine.metrics.batches - b0,
            "p50_ms": 1e3 * harness.quantile_p(lat, 50),
            "p95_ms": 1e3 * harness.quantile_p(lat, 95),
            "first_tenth_median_ms": med(lat[:tenth]),
            "last_tenth_median_ms": med(lat[-tenth:]),
            "drain_s": loop.span - float(arr[-1]),
            "hand_over_late_p95_ms":
                1e3 * float(np.percentile(loop.late, 95))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
