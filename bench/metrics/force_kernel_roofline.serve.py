"""Percent of the force kernel's roofline in the profiled slice."""

from bench.readers import force_kernel_roofline


def read(obs):
    return force_kernel_roofline(obs, "serve")
