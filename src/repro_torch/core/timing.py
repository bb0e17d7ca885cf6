"""Stopwatch of the measured autotuner (port of ``repro.core.timing``).

Timing convention (paper §7.1): a warm-up call first, so one-time work
(building a kernel with nvcc, loading it, allocating) is excluded, then
``reps`` timed calls, report the mean. ``reps`` adapts to the call's cost
(big cases get few reps, small get many) and is returned, so every record
says how it was taken.

The ``reps`` calls run back to back and are timed as one stretch: on
the card that is the "queued" time of ``chip_smoke.py``'s
``cuda_ms_queued``, which lets the host enqueue a call while the card
runs the one before. The card is synchronized before the clock starts and
after the last call of each stretch; on the CPU the stopwatch is a wall
clock.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _leaves(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _leaves(o)


def _wait(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    for dev in {t.device for t in _leaves(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, reps: int | None = None,
            budget_s: float = 3.0) -> Tuple[float, int]:
    """-> (mean_seconds, reps). The first call is a warm-up (excluded)."""
    out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    out = fn(*args)
    _wait(out)
    once = time.perf_counter() - t0
    if reps is None:
        reps = max(2, min(50, int(budget_s / max(once, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / reps, reps
