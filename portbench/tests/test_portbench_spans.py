"""The readers of the program's spans and counters (``spans.py`` and the
metrics ``pass1_ms``, ``sync_tail_ms``, ``sync_tiers``, ``host_reads``,
``host_dispatch_ms``) on hand-made snapshots of the program's recorder."""

import pytest

from portbench import harness

NAMES = ("pass1_ms", "sync_tail_ms", "sync_tiers", "host_reads", "host_dispatch_ms")


def _rec(index, name, parent, call, host_ms, device_ms, counts=None):
    r = {"index": index, "name": name, "attrs": {}, "parent": parent, "call": call, "thread": "MainThread",
         "host_start_ns": index, "host_ms": host_ms, "device_ms": device_ms}
    if counts is not None:
        r["counts"] = counts
    return r


def _snapshot(device: bool):
    d = (lambda ms: ms) if device else (lambda ms: None)
    recs = [
        _rec(0, "amr.demod_pack_batch", None, 1, 20.0, d(21.0), {"sync_tiers": 3, "host_reads": 2}),
        _rec(1, "amr.pass1", 0, 1, 2.0, d(12.0)),
        _rec(2, "amr.decide", 0, 1, 0.1, d(4.0)),
        _rec(3, "amr.sync_tail", 0, 1, 17.0, d(2.0)),
        _rec(4, "amr.sync_tier", 3, 1, 6.0, d(0.5)),
        _rec(5, "amr.host_read", 4, 1, 0.5, d(0.4)),
        _rec(6, "amr.sync_tier", 3, 1, 6.0, d(0.5)),
        _rec(7, "amr.host_read", 6, 1, 0.25, d(0.2)),
        _rec(8, "amr.demod_pack_batch", None, 2, 22.0, d(20.0), {"sync_tiers": 1, "host_reads": 1}),
        _rec(9, "amr.pass1", 8, 2, 2.0, d(11.5)),
        _rec(10, "amr.sync_tail", 8, 2, 19.0, d(1.0)),
        _rec(11, "amr.host_read", 10, 2, 1.0, d(0.9)),
    ]
    return {"records": recs, "counters": {"sync_tiers": 4, "host_reads": 3}, "dropped": 0, "launches": {}}


def _read(monkeypatch, snapshot):
    from audio_modem_radio_tpu_torch import observability

    monkeypatch.setattr(observability, "trace_snapshot", lambda: snapshot)
    return {name: harness.load_reader(name).read(None) for name in NAMES}


def test_readers_on_a_card_snapshot(monkeypatch):
    got = _read(monkeypatch, _snapshot(device=True))
    assert got == pytest.approx({"pass1_ms": 11.75, "sync_tail_ms": 1.5, "sync_tiers": 2.0, "host_reads": 1.5,
                                 "host_dispatch_ms": ((20.0 - 0.75) + (22.0 - 1.0)) / 2})


@pytest.mark.parametrize("snapshot", ["cpu", "empty"])
def test_readers_return_none_without_device_times_or_calls(monkeypatch, snapshot):
    snap = _snapshot(device=False) if snapshot == "cpu" else {"records": [], "counters": {}, "dropped": 0,
                                                              "launches": {}}
    assert _read(monkeypatch, snap) == dict.fromkeys(NAMES)


def test_readers_return_none_on_a_program_without_the_recorder(monkeypatch):
    """The parent commit's program has no ``trace_snapshot``."""
    from audio_modem_radio_tpu_torch import observability

    monkeypatch.delattr(observability, "trace_snapshot")
    assert {name: harness.load_reader(name).read(None) for name in NAMES} == dict.fromkeys(NAMES)
