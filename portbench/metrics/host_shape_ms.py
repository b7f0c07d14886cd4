"""Host clock around the set-up's one call of the program's
``parallel/batch.py:host_shape_batch`` on the whole batch."""


def read(ctx):
    return ctx.host_shape_s * 1e3
