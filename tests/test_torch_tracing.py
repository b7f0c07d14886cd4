"""The port's spans and counters (``observability.span``, ``count``,
``host_read``, ``trace_snapshot``, ``trace_reset``) on the batched decode
path, on the CPU: off without a profiler (one flag check a span, the
counters still counting), the span tree and the per-call counts under one,
the Chrome trace's intervals, the store's bound, the thread-local trees,
and ``profile_slice``'s idle table."""

import contextlib
import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_modem_radio_tpu_torch import modulate, observability as ob
from audio_modem_radio_tpu_torch import profile_slice
from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1
from audio_modem_radio_tpu_torch.parallel import batch as tb

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

# 2304 rows of 1280 samples: the tail's tiers are 256 rows, 512 rows (an
# eighth, rounded up to the matcher's block) and the full scan.
_QPSK_ROWS = 2304
# (sync_tiers, host_reads) a call: a clean batch is taken at the first tier
# (one read); a noise-only capture escalates through both prefix tiers
# (two reads) to the full scan.
_EXPECT = {"clean": (1, 1), "noise": (3, 2)}


def _framed(seed: int, n: int = 3000) -> bytes:
    p = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    return pack_frame("t.bin", p, 0, 1, len(p), crc32(p))


@pytest.fixture(scope="module")
def qpsk_rows():
    """{"clean": two signal captures, "noise": a signal and a noise-only
    capture}, as host_shape_batch's blocked (2, 2304, 1280) rows."""
    n = _QPSK_ROWS * 1280 - 4000
    wave = modulate("QPSK", _framed(1), 9600)
    x = np.zeros((2, n), np.float32)
    x[0, 100 : 100 + len(wave)] = wave
    x[1, 7 : 7 + len(wave)] = wave
    noisy = x.copy()
    noisy[1] = np.random.default_rng(2).normal(0, 0.3, n)
    return {k: torch.from_numpy(tb.host_shape_batch(v, "QPSK", 9600, device="cpu"))
            for k, v in (("clean", x), ("noise", noisy))}


@pytest.fixture
def fresh():
    ob.trace_reset()
    yield
    ob.trace_reset()


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["index"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("scenario", ["clean", "noise"])
def test_qpsk_batch_spans_and_counts(qpsk_rows, fresh, monkeypatch, scenario, traced):
    """Without a profiler a span is one flag check and nothing else (no
    record, no ``record_function``) while the counters count; under one,
    one call is the tree root -> pass 1, decide, sync tail -> tiers (each
    prefix tier with its read), and the call's record holds its counts."""
    tiers, reads = _EXPECT[scenario]
    if not traced:
        checks = []

        def flag():
            checks.append(1)
            return False

        def no_record_function(name):
            raise AssertionError(f"record_function({name!r}) with tracing off")

        monkeypatch.setattr(ob, "_profiler_enabled", flag)
        monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
        packed, n_valid, found = tb.demod_pack_batch(qpsk_rows[scenario], "QPSK", 9600)
        snap = ob.trace_snapshot()
        assert snap["records"] == []
        # root, pass 1, decide, sync tail, and each tier and read
        assert len(checks) == 4 + tiers + reads
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            packed, n_valid, found = tb.demod_pack_batch(qpsk_rows[scenario], "QPSK", 9600)
        snap = ob.trace_snapshot()
        recs = snap["records"]
        (root,) = [r for r in recs if r["parent"] is None]
        assert root["name"] == ob.CALL_SPAN and root["attrs"] == {"kind": "psk4", "captures": 2}
        assert {r["call"] for r in recs} == {root["call"]}
        assert [r["name"] for r in _children(recs, root)] == ["amr.pass1", "amr.decide", "amr.sync_tail"]
        assert _children(recs, root)[1]["attrs"] == {"kernel": "K1"}
        tail = _children(recs, root)[2]
        tier_recs = _children(recs, tail)
        assert [r["name"] for r in tier_recs] == ["amr.sync_tier"] * tiers
        assert [r["attrs"]["rows"] for r in tier_recs] == [256, 512, _QPSK_ROWS][:tiers - 1] + [
            256 if tiers == 1 else _QPSK_ROWS]
        assert [[c["name"] for c in _children(recs, t)] for t in tier_recs] == (
            [["amr.host_read"]] * reads + [[]] * (tiers - reads))
        assert root["counts"] == {"sync_tiers": tiers, "host_reads": reads}
        for r in recs:
            assert r["device_ms"] is None and r["device_self_ms"] is None
            kids = _children(recs, r)
            assert r["host_self_ms"] == pytest.approx(r["host_ms"] - sum(k["host_ms"] for k in kids))
            assert all(r["host_start_ns"] <= k["host_start_ns"] for k in kids)
    assert snap["counters"] == {"sync_tiers": tiers, "host_reads": reads}
    assert snap["dropped"] == 0 and "psk_project_decide_batch" in snap["launches"]
    assert found.tolist() == [True, scenario == "clean"]


def test_fsk19200_fused_windows_read_once_and_take_no_tier(fresh):
    """FSK19200's fused FIR windows: pass 1, K9 and the plain-torch tail,
    whose one host read is ``pack_bits_from``'s."""
    wave = modulate("FSK19200", _framed(3), 19200)
    x = np.zeros((2, 1 << 18), np.float32)
    x[0, 100 : 100 + len(wave)] = wave
    x[1, 7 : 7 + len(wave)] = wave
    rows = torch.from_numpy(tb.host_shape_batch(x, "FSK19200", 19200, device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        _packed, _n_valid, found = tb.demod_pack_batch(rows, "FSK19200", 19200)
    snap = ob.trace_snapshot()
    recs = snap["records"]
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["attrs"] == {"kind": "fsk", "captures": 2}
    assert [(r["name"], r["attrs"]) for r in _children(recs, root)] == [
        ("amr.pass1", {}), ("amr.decide", {"kernel": "K9"}), ("amr.sync_tail", {})]
    assert [r["name"] for r in _children(recs, _children(recs, root)[2])] == ["amr.host_read"]
    assert root["counts"] == {"host_reads": 1} and snap["counters"] == {"host_reads": 1}
    assert found.tolist() == [True, True]


def test_fsk9600_decide_holds_the_equalizer_span(fresh):
    """FSK9600's fused FIR windows: pass 1, ``amr.decide`` (K8) whose one
    child is ``amr.disc_decide`` (atan2, the equalizer, the tone decision),
    then the sync tail."""
    wave = modulate("FSK9600", _framed(4), 9600)
    x = np.zeros((2, 1 << 18), np.float32)
    x[0, 100 : 100 + len(wave)] = wave
    x[1, 7 : 7 + len(wave)] = wave
    rows = torch.from_numpy(tb.host_shape_batch(x, "FSK9600", 9600, device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        _packed, _n_valid, found = tb.demod_pack_batch(rows, "FSK9600", 9600)
    recs = ob.trace_snapshot()["records"]
    (root,) = [r for r in recs if r["parent"] is None]
    stages = _children(recs, root)
    assert [(r["name"], r["attrs"]) for r in stages] == [
        ("amr.pass1", {}), ("amr.decide", {"kernel": "K8"}), ("amr.sync_tail", {})]
    assert [(r["name"], r["attrs"]) for r in _children(recs, stages[1])] == [("amr.disc_decide", {})]
    assert _children(recs, _children(recs, stages[1])[0]) == []
    assert found.tolist() == [True, True]


def _aten_names(events, a=float("-inf"), b=float("inf")):
    return [e["name"] for e in sorted(events, key=lambda e: e["ts"])
            if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
            and a <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= b]


def _chrome(prof, tmp_path, name):
    path = tmp_path / name
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_chrome_trace_holds_pass1_ops_inside_its_annotation(qpsk_rows, fresh, tmp_path):
    """Every ``aten::`` op that pass 1 runs (the ops of ``_batch_pass1``
    profiled alone, in order) lies inside the ``amr.pass1``
    ``user_annotation`` of a whole call, and nothing else does."""
    rows = qpsk_rows["clean"]
    b, r, _ = rows.shape
    with profile(activities=[ProfilerActivity.CPU]) as alone:
        _batch_pass1(None, rows, b, r * 128, 10, 3000.0, 96000, 8, r, 4)
    expect = _aten_names(_chrome(alone, tmp_path, "alone.json"))
    ob.trace_reset()
    with profile(activities=[ProfilerActivity.CPU]) as whole:
        tb.demod_pack_batch(rows, "QPSK", 9600)
    events = _chrome(whole, tmp_path, "whole.json")
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    p1 = ann["amr.pass1"]
    a, b_ = float(p1["ts"]), float(p1["ts"]) + float(p1["dur"])
    assert "aten::matmul" in expect and _aten_names(events, a, b_) == expect
    root = ann[ob.CALL_SPAN]
    assert float(root["ts"]) <= a and b_ <= float(root["ts"]) + float(root["dur"])
    rec = next(x for x in ob.trace_snapshot()["records"] if x["name"] == "amr.pass1")
    assert rec["host_ms"] == pytest.approx(float(p1["dur"]) / 1e3, rel=0.05)


def test_reset_and_the_bound_with_its_drop_count(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(ob.SPAN_LIMIT + 10):
            with ob.span("amr.test"):
                pass
    ob.count("t", 3)
    snap = ob.trace_snapshot()
    assert len(snap["records"]) == ob.SPAN_LIMIT and snap["dropped"] == 10
    assert snap["counters"] == {"t": 3}
    ob.trace_reset()
    snap = ob.trace_snapshot()
    assert snap["records"] == [] and snap["dropped"] == 0 and snap["counters"] == {}


def test_threads_keep_their_own_trees_and_lose_no_count(fresh, monkeypatch):
    """More threads than cores, a short switch interval: each thread's spans
    nest within that thread, and the shared counter loses no update."""
    monkeypatch.setattr(ob, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    n_threads, n = 16, 300

    def work():
        for _ in range(n):
            with ob.span(ob.CALL_SPAN):
                with ob.span("amr.inner"):
                    ob.count("t")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"w{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = ob.trace_snapshot()
    recs = snap["records"]
    assert snap["counters"] == {"t": n_threads * n} and len(recs) == 2 * n_threads * n
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) == n_threads * n and len({r["call"] for r in roots}) == len(roots)
    assert all(r["counts"] == {"t": 1} for r in roots)
    for r in recs:
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["thread"] == r["thread"] and p["call"] == r["call"] and p["name"] == ob.CALL_SPAN


def test_profile_slice_names_each_idle_gap_by_its_innermost_span():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, a, b, device=cpu, thread=1):
        return SimpleNamespace(name=name, device_type=device, thread=thread,
                               time_range=SimpleNamespace(start=a, end=b))

    events = [ev(ob.CALL_SPAN, 0, 100), ev("amr.sync_tail", 50, 100), ev("amr.host_read", 60, 70),
              ev("amr.host_read", 0, 100, thread=2), ev("amr.decide", 10, 20, device=cuda),
              ev("aten::slice", 2, 8), ev("cudaLaunchKernel", 40, 60, thread=2)]
    busy = profile_slice._merge([(10, 20), (15, 30), (70, 90)])
    assert busy == [[10, 30], [70, 90]]
    idle = {k: (ms, bare) for k, ms, bare in profile_slice._idle_by_span(events, (0, 120, 1), busy)}
    # gaps: 0-10 (the call, an operator at its middle), 30-70 (mid 50: the
    # tail; the runtime call is another thread's), 90-120 (mid 105: none)
    assert idle == pytest.approx({ob.CALL_SPAN: (0.010, 0.0), "amr.sync_tail": (0.040, 0.040),
                                  "no amr.* span": (0.030, 0.030)})
    assert profile_slice._span_event(events[4]) and not profile_slice._span_event(ev("decide_kernel", 0, 1))
