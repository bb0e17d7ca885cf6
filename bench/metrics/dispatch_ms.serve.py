"""Mean milliseconds of a dispatch (the engine's stack, copy,
``execute_batch`` and output check, on a real clock) over the window."""


def read(obs):
    xs = obs.get("serve.dispatch_s") if obs.get("kind") == "serve" else None
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)
