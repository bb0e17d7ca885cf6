"""What the metric readers in ``bench/metrics/`` share. Each helper takes
the run's ``obs`` and the traffic kind the metric belongs to, and returns
None where the run has nothing to read (another kind, no profile)."""

from __future__ import annotations

from typing import Optional

from . import counts
from .harness import (FORCE_KERNELS, PACK_KERNELS, SCAN_KERNELS,
                      kernel_seconds)


def _profile(obs: dict, kind: str) -> Optional[dict]:
    if obs.get("kind") != kind:
        return None
    return obs.get("profile")


def launch_calls_per_unit(obs: dict, kind: str) -> Optional[float]:
    prof = _profile(obs, kind)
    if prof is None or not prof["units"]:
        return None
    return prof["launch_calls"] / prof["units"]


def other_kernels_ms_per_unit(obs: dict, kind: str) -> Optional[float]:
    """Device ms a unit of every kernel outside the force, scan and pack
    kernels: the eager PyTorch operations of binning, refresh, scatter and
    integration."""
    prof = _profile(obs, kind)
    if prof is None or not prof["units"]:
        return None
    total = sum(prof["kernels"].values())
    ours = kernel_seconds(prof, FORCE_KERNELS + SCAN_KERNELS + PACK_KERNELS)
    return 1e3 * (total - ours) / prof["units"]


def force_kernel_roofline(obs: dict, kind: str) -> Optional[float]:
    """Percent: the least time the H100 needs for the profiled slice's
    pairs and particles over the force kernels' device time there."""
    prof = _profile(obs, kind)
    work = obs.get("profile_work")
    if prof is None or work is None:
        return None
    t = kernel_seconds(prof, FORCE_KERNELS)
    if t <= 0:
        return None
    least, _ = counts.bound_s(work["particles"], work["pairs"],
                              obs["pair_flops"])
    return 100.0 * least / t


def device_idle_share(obs: dict, kind: str) -> Optional[float]:
    prof = _profile(obs, kind)
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(obs: dict, kind: str) -> Optional[float]:
    """Percent of the float32 peak: the pair FLOP within the cutoff of the
    whole window over the window's wall time."""
    if obs.get("kind") != kind or "window_work" not in obs:
        return None
    return counts.pair_flops_per_s_share(obs["window_work"]["pairs"],
                                         obs["pair_flops"], obs["window_s"])

