"""95th percentile of every batch's latency in the window: from the call
until its bytes, n_valid and found are on the host, timed by CUDA events on
the card's clock (an event recorded before the call, one after the copies)."""

import numpy as np


def read(ctx):
    lat = ctx.window["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
