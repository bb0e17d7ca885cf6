"""Million atom-steps a second: atoms times every step completed in the
window, over the window's wall time (synchronized at its end)."""


def read(obs):
    if obs.get("kind") != "traj" or not obs.get("window_s"):
        return None
    return obs["n_atoms"] * obs["traj.steps"] / obs["window_s"] / 1e6
