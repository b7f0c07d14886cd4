"""The program's own spans and counters over the traced window.

The port records spans (``audio_modem_radio_tpu_torch.observability.span``)
only while ``torch.profiler`` records, so after a run with ``--trace 1``
its store holds the calls of the traced window alone. Each call is an
``amr.demod_pack_batch`` record with the counts it made; its stages are
its descendants (records of the same ``call``).

A reader returns None where there is nothing to read: a program without
the recorder, a window with no call, or spans without device times (not
on a CUDA card).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

CALL = "amr.demod_pack_batch"


def calls(snapshot: dict = None) -> Optional[List[Tuple[dict, List[dict]]]]:
    """[(a call's record, its descendants' records)] of ``snapshot`` (by
    default the program's ``trace_snapshot()``), or None where there is
    nothing to read."""
    if snapshot is None:
        try:
            from audio_modem_radio_tpu_torch.observability import trace_snapshot
        except ImportError:
            return None
        snapshot = trace_snapshot()
    recs = snapshot["records"]
    roots = [r for r in recs if r["name"] == CALL and r["parent"] is None]
    if not roots or any(r["device_ms"] is None for r in roots):
        return None
    by_call = defaultdict(list)
    for r in recs:
        if r["name"] != CALL:
            by_call[r["call"]].append(r)
    return [(root, by_call[root["call"]]) for root in roots]


def mean_device_ms(name: str, snapshot: dict = None) -> Optional[float]:
    """Device ms a call in the spans named ``name`` (None where one of them
    has no device times)."""
    cs = calls(snapshot)
    if cs is None:
        return None
    ms = [r["device_ms"] for _, stages in cs for r in stages if r["name"] == name]
    return None if None in ms else sum(ms) / len(cs)


def mean_count(name: str, snapshot: dict = None) -> Optional[float]:
    """The counter ``name`` a call (0 in a call that did not count it)."""
    cs = calls(snapshot)
    if cs is None:
        return None
    return sum(root["counts"].get(name, 0) for root, _ in cs) / len(cs)
