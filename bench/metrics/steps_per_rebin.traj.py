"""Committed steps over skin-contract rebins in the window
(``TrajectoryResult.steps`` / ``rebins``)."""


def read(obs):
    if obs.get("kind") != "traj" or not obs.get("traj.rebins"):
        return None
    return obs["traj.steps"] / obs["traj.rebins"]
