"""Device milliseconds a batch in kernels that PyTorch launched: ATen's own
and the cuBLAS and CUTLASS products its operators call (the plain-torch
stages of the program). A kernel counts when the runtime call that launched
it lies inside an ``aten::`` operator (``trace.Trace.launched_by_torch``),
so a hand-written kernel the program launches itself never counts."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return t.kernel_us(t.launched_by_torch) / 1e3 / t.batches
