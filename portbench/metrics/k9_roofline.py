"""K9's share of its roofline: ``ops/kernels.py:fsk_quad_margin_batch``
-> ``csrc/fsk_quad.cu`` (the kernel ``fsk_quad_kernel``).

Least time: operations over the card's published float32 rate, counted as
``chip_smoke.py:phase_fsk_timing`` counts them: 4 x 129 for every analytic
output (two 129-tap multiply-adds), 4 for every nonzero quadrature tap of
the capture's winning offset in every bit row (two streams), 11 for every
margin. The winning offsets are the plain reference's on the compared
captures; the batch's quadrature taps are their mean times the captures.
"""

import numpy as np

from portbench.peaks import peak
from portbench.reference import fsk

KERNEL = "fsk_quad_kernel"
TAPS = 129


def least_ms(captures: int, fir_rows: int, bit_rows: int, bits_a_row: int, taps_nonzero: int,
             ops_per_s: float) -> float:
    """``taps_nonzero``: the nonzero quadrature taps of the winning offsets,
    summed over the captures (the bit rows a capture times each capture's)."""
    ops = (captures * fir_rows * 128 * 4 * TAPS + bit_rows * taps_nonzero * 4
           + captures * bit_rows * bits_a_row * 11)
    return ops / ops_per_s * 1e3


def read(ctx):
    t, p = ctx.trace, peak(ctx.device_kind)
    if t is None or p is None or ctx.cfg["family"] != "fsk":
        return None
    us = t.kernel_us(lambda e: KERNEL in e["name"])
    if us <= 0:
        return None
    g = fsk.geometry(ctx.mix["samples"], ctx.cfg)
    wq = fsk.quadratures(g["spb"], g["mark"], g["space"], g["sr"], g["spr2"], g["row2"], g["ov2"])
    nonzero = np.count_nonzero(wq.reshape(wq.shape[0], -1), axis=1)
    taps = float(nonzero[ctx.ref["best"]].mean()) * ctx.rows_shape[0]
    least = least_ms(ctx.rows_shape[0], g["rows"], g["bit_rows"], g["spr2"], taps, p["fp32_ops_per_s"])
    return 100.0 * least / (us / 1e3 / t.batches)
