"""Prefix tiers a call of the sync tail's magic search
(``parallel/batch.py:_scan_tiered``): the program's counter ``sync_tiers``,
as each call's record holds it."""

from portbench import spans


def read(ctx):
    return spans.mean_count("sync_tiers")
