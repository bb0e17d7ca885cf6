"""The host's launch calls a step in the profiled call."""

from bench.readers import launch_calls_per_unit


def read(obs):
    return launch_calls_per_unit(obs, "traj")
