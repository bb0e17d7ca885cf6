"""Fault tolerance: straggler detection, restart driver, elastic restore
(port of ``repro.dist.fault``).

The contract (``ckpt/checkpoint.py`` provides the atomic-commit half): a
loop that checkpoints every K steps can be killed at any point, by a
straggler watchdog or a real failure, and the driver restarts it from the
latest committed checkpoint, possibly on other devices (elastic restore:
each leaf comes back on the device of its template leaf).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

from ..ckpt import checkpoint as C

Tree = Any


class StragglerDetected(RuntimeError):
    """A step exceeded the deadline: treat the worker as failed."""


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    step_deadline_s: float = 300.0   # watchdog deadline per step
    max_restarts: int = 10
    backoff_s: float = 0.0           # base sleep between restarts (0 in
                                     # tests); doubles per restart ...
    backoff_cap_s: float = 60.0      # ... up to this cap


class StragglerWatchdog:
    """Per-step deadline monitor: one slow participant stalls every
    collective, so fail fast and let the restart driver take over.
    ``history`` keeps the newest ``history_len`` step times in a bounded
    deque, so a long run does not grow the watchdog's state."""

    def __init__(self, deadline_s: float, history_len: int = 1024):
        self.deadline_s = float(deadline_s)
        self.history: "collections.deque[float]" = collections.deque(
            maxlen=int(history_len))

    def observe(self, step_seconds: float) -> None:
        self.history.append(float(step_seconds))
        if step_seconds > self.deadline_s:
            raise StragglerDetected(
                f"step took {step_seconds:.3f}s > deadline "
                f"{self.deadline_s:.3f}s")


def run_with_restarts(train_loop: Callable[[int], Any], cfg: FaultConfig,
                      sleep: Callable[[float], None] = time.sleep) -> Any:
    """Drive ``train_loop(start_step)`` to completion with restarts.

    On any ``RuntimeError`` (``StragglerDetected``, a lost shard
    (``testing.chaos.ShardLost``), a corrupt checkpoint
    (``ckpt.checkpoint.CheckpointCorrupt``), a transient backend error) the
    loop is restarted from the latest committed intact checkpoint step; the
    loop itself restores its state from ``cfg.ckpt_dir``. Restarts sleep
    ``cfg.backoff_s * 2**(k-1)`` seconds (capped at ``cfg.backoff_cap_s``);
    ``sleep`` is injectable for tests. After ``cfg.max_restarts`` restarts
    the last error propagates."""
    restarts = 0
    while True:
        start = C.latest_step(cfg.ckpt_dir) or 0
        try:
            return train_loop(start)
        except RuntimeError as e:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            print(f"[fault] restart {restarts}/{cfg.max_restarts} "
                  f"from step {C.latest_step(cfg.ckpt_dir) or 0}: {e}")
            if cfg.backoff_s:
                sleep(min(cfg.backoff_s * 2.0 ** (restarts - 1),
                          cfg.backoff_cap_s))


def elastic_restore(ckpt_dir, tree_like: Tree,
                    shardings_fn: Callable[[], Optional[Tree]],
                    step: Optional[int] = None) -> Tuple[Tree, dict]:
    """Restore a checkpoint onto the surviving devices (elastic restart).

    The port's ``ckpt.restore`` puts each leaf on the device of its template
    leaf, so ``shardings_fn`` is called once the surviving devices are
    known and returns a template tree whose tensors lie on them (JAX's
    returns a tree of shardings to ``device_put`` against); None restores
    onto ``tree_like``'s own devices. -> ``(tree, extra)``."""
    template = shardings_fn()
    return C.restore(ckpt_dir, tree_like if template is None else template,
                     step=step)
