"""Percent of the force kernel's roofline in the profiled call."""

from bench.readers import force_kernel_roofline


def read(obs):
    return force_kernel_roofline(obs, "traj")
