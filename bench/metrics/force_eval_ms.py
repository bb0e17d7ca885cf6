"""Milliseconds a force evaluation: the window's wall time over its
calls."""


def read(obs):
    if obs.get("kind") != "force" or not obs.get("force.calls"):
        return None
    return 1e3 * obs["window_s"] / obs["force.calls"]
