"""Device milliseconds a call in the close-tone decision after K8: the
program's ``amr.disc_decide`` spans (``ops/fsk.py:disc_decide``: atan2 to
Hz, the calibrated 9-tap equalizer, the nearer tone; plain torch, inside
``amr.decide``), timed by CUDA events on the card's clock. None where the
program records no such span (a program before it, or another path)."""

from portbench import spans

SPAN = "amr.disc_decide"


def read(ctx):
    cs = spans.calls()
    if cs is None or not any(r["name"] == SPAN for _, stages in cs for r in stages):
        return None
    return spans.mean_device_ms(SPAN)
