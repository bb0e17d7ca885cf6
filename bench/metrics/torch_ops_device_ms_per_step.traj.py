"""Device ms a step of the eager operations (binning, refresh, integration)."""

from bench.readers import other_kernels_ms_per_unit


def read(obs):
    return other_kernels_ms_per_unit(obs, "traj")
