"""Run one cell of the benchmark of ``repro_torch`` on one H100.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and the compared numbers on standard error and, as the
last line of standard output, the result object. Exits non-zero, with no
result, without a CUDA device or the program (``src/repro_torch``).
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:1] = [str(_ROOT / "src"), str(_ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
