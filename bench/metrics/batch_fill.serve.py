"""Percent of a dispatch's padded batch slots that real requests fill,
the mean over the window's dispatches."""


def read(obs):
    fill = obs.get("serve.batch_fill") if obs.get("kind") == "serve" else None
    if not fill:
        return None
    return 100.0 * sum(fill) / len(fill)
