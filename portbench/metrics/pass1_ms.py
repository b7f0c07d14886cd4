"""Device milliseconds a call in pass 1: the program's ``amr.pass1`` spans
(``ops/psk.py:_batch_pass1``; FSK ``ops/fsk.py`` ``fsk_quad_pass1``,
``fsk_disc_pass1``, ``_dual_pass1``), timed by CUDA events on the card's
clock, idle time inside them included."""

from portbench import spans


def read(ctx):
    return spans.mean_device_ms("amr.pass1")
