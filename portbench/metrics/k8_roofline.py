"""K8's share of its roofline: ``ops/kernels.py:fsk_disc_sums_batch`` ->
``csrc/fsk_disc.cu`` (the kernel ``fsk_disc_kernel``).

Least time: the larger of the bytes over the card's published memory
bandwidth and the operations over its published float32 rate, counted as
``chip_smoke.py:phase_fsk_timing`` counts them. Operations: 4 x 129 for
every analytic output (two 129-tap multiply-adds), 6 for every phasor, 4
for every nonzero boxcar tap of the capture's winning offset in every bit
row (two streams). Bytes: the rows read once and the two float32 sums of
every bit written once. The winning offsets are the plain reference's on
the compared captures; the batch's boxcar taps are their mean times the
captures. The kernel's device time a call comes from the trace.
"""

import numpy as np

from portbench.peaks import peak
from portbench.reference import fsk_disc

KERNEL = "fsk_disc_kernel"
TAPS = 129


def least_ms(captures: int, fir_rows: int, bit_rows: int, bits_a_row: int, taps_nonzero: float,
             rows_bytes: int, ops_per_s: float, bytes_per_s: float) -> float:
    """``taps_nonzero``: the nonzero boxcar taps of the winning offsets a bit
    row, summed over the captures."""
    outputs = captures * fir_rows * 128
    ops = outputs * 4 * TAPS + outputs * 6 + bit_rows * taps_nonzero * 4
    n_bytes = rows_bytes + 2 * 4 * captures * bit_rows * bits_a_row
    return max(ops / ops_per_s, n_bytes / bytes_per_s) * 1e3


def read(ctx):
    t, p = ctx.trace, peak(ctx.device_kind)
    if t is None or p is None or ctx.cfg["family"] != "fsk_disc":
        return None
    us = t.kernel_us(lambda e: KERNEL in e["name"])
    if us <= 0:
        return None
    g = fsk_disc.geometry(ctx.mix["samples"], ctx.cfg)
    wb = fsk_disc.boxcars(g["spb"], g["dec"], g["row2"], g["ov2"], g["spr2"])
    nonzero = np.count_nonzero(wb.reshape(wb.shape[0], -1), axis=1)
    b = ctx.rows_shape[0]
    taps = float(nonzero[ctx.ref["best"]].mean()) * b
    rows_bytes = int(np.prod(ctx.rows_shape)) * ctx.rows_itemsize
    least = least_ms(b, g["rows"], g["bit_rows"], g["spr2"], taps, rows_bytes, p["fp32_ops_per_s"],
                     p["bytes_per_s"])
    return 100.0 * least / (us / 1e3 / t.batches)
