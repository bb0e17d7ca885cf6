"""Set-up seconds: process start to the window's start."""


def read(obs):
    return obs.get("setup_s")
