"""The host's launch calls a dispatch in the profiled slice."""

from bench.readers import launch_calls_per_unit


def read(obs):
    return launch_calls_per_unit(obs, "serve")
