"""Read a cell's compared numbers for the program and for its bfloat16
control on many seeds, in one process, on the card:

    python bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

Each seed is a run of the cell with a short window whose outputs are
judged twice: the program's, and the reference's computed in bfloat16 put
in the program's place (the step a faster kernel would be tempted to
take). The lower reading of a number is the largest the program gives,
its upper reading the smallest the control gives; a cell's limits lie
between. The benchmark's own runs never run the control.
"""

import json
import pathlib
import sys
import time

T0 = time.perf_counter()
_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:1] = [str(_ROOT / "src"), str(_ROOT)]

import argparse  # noqa: E402

import torch  # noqa: E402

from bench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import api
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    dev = torch.device("cuda", 0)
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False, dev,
                             T0, spec, control=True)
        prog = {k: v["value"] for k, v in r["checks"].items()}
        ctrl = {k: v["value"] for k, v in r["control_checks"].items()}
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "attempted": r["attempted"], "failed": r["failed"],
                          "metrics": r["metrics"]}), flush=True)
        for k, v in prog.items():
            low[k] = max(low.get(k, v), v)
        for k, v in ctrl.items():
            high[k] = min(high.get(k, v), v)
        api.clear_executor_cache()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": low,
                      "upper": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
