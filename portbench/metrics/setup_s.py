"""Seconds from the start of the process to the open of the window: imports,
the card's start, making the captures, host shaping, the copy to the card,
two warm-up batches (and the kernel build, in a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
