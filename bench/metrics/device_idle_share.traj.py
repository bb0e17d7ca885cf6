"""Percent of the profiled call in which no operation ran on the card."""

from bench.readers import device_idle_share


def read(obs):
    return device_idle_share(obs, "traj")
