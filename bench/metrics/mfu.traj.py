"""The whole step's share of the float32 peak: pair FLOP within the
cutoff over the window."""

from bench.readers import mfu


def read(obs):
    return mfu(obs, "traj")
