"""Requests answered within the window, over the window: the serving
engine's throughput under a load above its capacity."""


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("window_s"):
        return None
    return obs["serve.served_in_window"] / obs["window_s"]
