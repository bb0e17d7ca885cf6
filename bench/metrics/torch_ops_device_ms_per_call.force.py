"""Device ms a call of the eager operations (binning, scatter-back)."""

from bench.readers import other_kernels_ms_per_unit


def read(obs):
    return other_kernels_ms_per_unit(obs, "force")
