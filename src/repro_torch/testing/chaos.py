"""Seeded, deterministic fault injection (port of ``repro.testing.chaos``).

Production code declares **fault points**: named sites threaded through
binning (``core.binning``), the trajectory engine's segment boundaries
(``traj.step``: error/delay/nonfinite between committed segments,
``traj.rebin``: forced static-bound overflow at the rebin check) and its
checkpoints (``traj.checkpoint``, and ``ckpt.save``, a crash *before* the
atomic rename, so the kill-mid-save contract is testable). With no active
injection context every point is one ``is None`` check. Inside an
:func:`inject` context, registered :class:`FaultSpec`\\ s fire
deterministically: each spec draws from its own numpy PRNG stream seeded from
``(seed, site, kind, index)``, so the same seed replays the same fault
schedule whatever runs in between, and the same specs and seed give the JAX
package's schedule draw for draw.

Fault kinds:

============== ==========================================================
``error``      a transient backend exception (:class:`TransientBackendError`)
``nonfinite``  poison the outputs with a non-finite value (NaN by default)
``delay``      artificial latency, an emulated straggler (``param`` seconds)
``overflow``   force the overflow verdict, an emulated static-bound breach
``shard_loss`` a lost shard (:class:`ShardLost`)
============== ==========================================================

The port catches nothing, so a caller that must go on after an injected
exception asks for it with :func:`injected_fault`, which returns the
exception :func:`maybe_raise` would raise, in the same order; a real
exception is never caught and always propagates.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS", "FaultSpec", "TransientBackendError", "ShardLost",
    "ChaosState", "inject", "active", "fire", "injected_fault",
    "maybe_raise", "maybe_delay", "corrupt", "forced_overflow", "state",
    "snapshot",
]

FAULT_KINDS = ("error", "nonfinite", "delay", "overflow", "shard_loss")


class TransientBackendError(RuntimeError):
    """An injected (or real) transient executor failure, retryable."""


class ShardLost(RuntimeError):
    """A shard of a multi-device plan is gone (emulated)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault: *where* (``site``), *what* (``kind``), and a
    deterministic firing schedule.

    A visit to a matching fault point fires the spec when (a) at least
    ``after`` earlier visits have been skipped, (b) fewer than
    ``max_fires`` firings have happened, and (c) a draw from the spec's
    seeded PRNG stream lands under ``p``. ``param`` is kind-specific:
    delay seconds for ``delay``, the poison value for ``nonfinite`` (NaN
    when left at the default), ignored otherwise."""

    site: str
    kind: str
    p: float = 1.0                     # per-visit firing probability
    after: int = 0                     # skip the first ``after`` visits
    max_fires: Optional[int] = None    # stop firing after this many
    param: float = math.nan            # kind-specific knob

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")


class ChaosState:
    """The live registry of an :func:`inject` context: specs, per-spec
    PRNG streams, visit/fire counters, and the firing log."""

    def __init__(self, specs: Tuple[FaultSpec, ...], seed: int):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rngs = [
            np.random.default_rng(
                zlib.crc32(f"{seed}:{s.site}:{s.kind}:{i}".encode()))
            for i, s in enumerate(self.specs)]
        self._visits: List[int] = [0] * len(self.specs)
        self._fires: List[int] = [0] * len(self.specs)
        self.log: List[Tuple[str, str, int]] = []   # (site, kind, visit)

    def fire(self, site: str, kind: str) -> Optional[FaultSpec]:
        """Visit the ``(site, kind)`` fault point; the first spec whose
        schedule fires wins (and is logged). None = no fault."""
        hit = None
        for i, s in enumerate(self.specs):
            if s.site != site or s.kind != kind:
                continue
            self._visits[i] += 1
            if hit is not None:
                continue                       # a spec already fired
            if self._visits[i] <= s.after:
                continue
            if s.max_fires is not None and self._fires[i] >= s.max_fires:
                continue
            if s.p < 1.0 and self._rngs[i].random() >= s.p:
                continue
            self._fires[i] += 1
            self.log.append((site, kind, self._visits[i]))
            hit = s
        return hit

    def fire_count(self, site: Optional[str] = None,
                   kind: Optional[str] = None) -> int:
        return sum(n for s, n in zip(self.specs, self._fires)
                   if (site is None or s.site == site)
                   and (kind is None or s.kind == kind))

    def snapshot(self) -> Dict[str, object]:
        """JSON-able fault-counter record."""
        per_point: Dict[str, int] = {}
        for s, n in zip(self.specs, self._fires):
            key = f"{s.site}/{s.kind}"
            per_point[key] = per_point.get(key, 0) + n
        return {"seed": self.seed, "fires": per_point,
                "total_fires": sum(self._fires),
                "total_visits": sum(self._visits)}


# The active context. Module-global on purpose: fault points are called
# from deep inside the engine where no injection handle exists, and the
# no-fault fast path is one ``is None`` check.
_ACTIVE: Optional[ChaosState] = None


class inject:
    """Activate a fault schedule for the dynamic extent of a ``with``
    block, which gets the live :class:`ChaosState` (counters + firing
    log). Contexts nest; the previous schedule is restored on exit, also
    when the block raises."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self._state = ChaosState(specs, seed)
        self._prev: Optional[ChaosState] = None

    def __enter__(self) -> ChaosState:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self._state
        return self._state

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def active() -> bool:
    """True inside an :func:`inject` context."""
    return _ACTIVE is not None


def state() -> Optional[ChaosState]:
    """The live ChaosState, or None outside any injection context."""
    return _ACTIVE


def snapshot() -> Dict[str, object]:
    """The active context's fault counters (empty record when inactive)."""
    if _ACTIVE is None:
        return {"seed": None, "fires": {}, "total_fires": 0,
                "total_visits": 0}
    return _ACTIVE.snapshot()


def fire(site: str, kind: str) -> Optional[FaultSpec]:
    """Visit a fault point: the firing spec, or None (always None when no
    context is active)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire(site, kind)


def injected_fault(site: str) -> Optional[RuntimeError]:
    """The exception-kind fault point, visited as :func:`maybe_raise`
    visits it (``shard_loss``, then ``error``): the :class:`ShardLost` or
    :class:`TransientBackendError` it would raise, returned instead, or
    None when no spec fires."""
    if _ACTIVE is None:
        return None
    if _ACTIVE.fire(site, "shard_loss") is not None:
        return ShardLost(f"injected shard loss at {site!r}")
    if _ACTIVE.fire(site, "error") is not None:
        return TransientBackendError(f"injected transient error at {site!r}")
    return None


def maybe_raise(site: str) -> None:
    """Raise :class:`TransientBackendError` (kind ``error``) or
    :class:`ShardLost` (kind ``shard_loss``) when a matching spec fires."""
    fault = injected_fault(site)
    if fault is not None:
        raise fault


def maybe_delay(site: str, sleep=_time.sleep) -> float:
    """The straggler fault point: sleeps ``spec.param`` seconds (via the
    injectable ``sleep``) and returns the delay (0.0 = no fault)."""
    if _ACTIVE is None:
        return 0.0
    spec = _ACTIVE.fire(site, "delay")
    if spec is None:
        return 0.0
    dt = 0.0 if math.isnan(spec.param) else float(spec.param)
    if dt > 0.0:
        sleep(dt)
    return dt


def corrupt(site: str, *tensors):
    """The non-finite fault point: when a ``nonfinite`` spec fires, the
    first tensor comes back as a copy with its first element poisoned
    (NaN, or ``spec.param`` when set); the inputs are never written."""
    if _ACTIVE is None:
        return tensors if len(tensors) != 1 else tensors[0]
    spec = _ACTIVE.fire(site, "nonfinite")
    if spec is not None and tensors and tensors[0].numel():
        first = tensors[0].clone()
        first.view(-1)[0] = spec.param          # NaN by default
        tensors = (first,) + tuple(tensors[1:])
    return tensors if len(tensors) != 1 else tensors[0]


def forced_overflow(site: str) -> bool:
    """The overflow fault point: True when an ``overflow`` spec fires; the
    caller must behave exactly as if a static bound had been measured as
    exceeded."""
    if _ACTIVE is None:
        return False
    return _ACTIVE.fire(site, "overflow") is not None
