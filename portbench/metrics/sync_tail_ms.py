"""Device milliseconds a call in the sync tail: the program's
``amr.sync_tail`` spans (``parallel/batch.py``'s kernel sync tails with
their tiers and reads; FSK's ``find_bit_pattern`` and ``pack_bits_from``),
timed by CUDA events on the card's clock, the idle time after each host
read included."""

from portbench import spans


def read(ctx):
    return spans.mean_device_ms("amr.sync_tail")
