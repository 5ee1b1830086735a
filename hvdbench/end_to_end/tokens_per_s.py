"""Tokens trained by all ranks in the window over its wall time. The
window counts whole steps and ends at a synchronize after the last."""


def read(ctx):
    if ctx["item"] != "token":
        return None
    return ctx["items_per_step"] * ctx["steps"] / ctx["window_s"]
