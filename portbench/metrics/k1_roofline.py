"""K1's share of its roofline: ``ops/kernels.py:psk_project_decide_batch``
-> ``csrc/decide.cu`` (the kernel ``decide_kernel``).

Least time: the sample rows read once plus the two uint8 decision lanes
(one decision a symbol, 128 symbols a row) written once, over the card's
published memory bandwidth; the kernel's device time a batch from the trace.
"""

from portbench.peaks import peak

KERNEL = "decide_kernel"


def least_ms(captures: int, rows: int, row: int, itemsize: int, bytes_per_s: float) -> float:
    read = captures * rows * row * itemsize
    written = 2 * captures * rows * 128
    return (read + written) / bytes_per_s * 1e3


def read(ctx):
    t, p = ctx.trace, peak(ctx.device_kind)
    if t is None or p is None or ctx.cfg["family"] != "psk":
        return None
    us = t.kernel_us(lambda e: KERNEL in e["name"])
    if us <= 0:
        return None
    b, r, row = ctx.rows_shape
    return 100.0 * least_ms(b, r, row, ctx.rows_itemsize, p["bytes_per_s"]) / (us / 1e3 / t.batches)
