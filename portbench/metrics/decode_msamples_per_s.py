"""Archive decode rate: every sample of every batch finished in the window,
over the window's seconds (host clock around the whole window)."""


def read(ctx):
    w = ctx.window
    return w["batches"] * w["samples_per_batch"] / w["seconds"] / 1e6
