"""The ``fsk_disc`` family (``fsk-9600``): its plain reference against the
port and its TF32 control on the small mix at the configuration's 40 dB, K8's
roofline count against PERF.md's bound, ``disc_decide_ms`` on hand-made
snapshots, a run with the timed path broken coming out not correct, and on
the card a traced small run that reads both new metrics."""

import json

import pytest
import torch

from portbench import compare, generator, harness

from .conftest import ROOT, SMALL
from .test_portbench_faults import _byte_altered, _half_left_out
from .test_portbench_spans import _rec

CELL = "fsk-9600.small-line"
LINE = dict(SMALL, snr_db=40.0)  # the small mix on the configuration's line-level link


@pytest.fixture
def line_root(small_root):
    """(root, bench) of ``small_root`` with the small mix at 40 dB and its
    ``fsk-9600`` cell, which reads the configuration's metrics."""
    root, bench = small_root
    (root / "traffic" / "small-line.json").write_text(json.dumps(LINE))
    bench["workloads"].append({"name": CELL, "config": "fsk-9600", "traffic": "small-line", "chips": 1,
                               "why": "small captures at 40 dB"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fsk-9600.line" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return root, bench


def _cfg():
    return json.loads((ROOT / "configs" / "fsk-9600.json").read_text())


def test_reference_agrees_and_control_fails(int16_rows):
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch, host_shape_batch

    cfg = _cfg()
    traffic = generator.build(cfg, LINE, 2**31 + 5, "cpu")
    ref_mod = harness.reference(cfg)
    ref = ref_mod.receive(traffic.captures, cfg, "cpu", "float32")
    ref_frames = compare.frames(ref["packed"], ref["n_valid"])
    assert all(len(f) >= 1 for f, noise in zip(ref_frames, traffic.noise_only) if not noise)
    assert all(len(f) == 0 for f, noise in zip(ref_frames, traffic.noise_only) if noise)
    rows = host_shape_batch(traffic.captures, cfg["mode"], cfg["symbol_rate"], device="cpu")
    assert rows.dtype.name == "int16"
    p, n, f = demod_pack_batch(torch.from_numpy(rows), cfg["mode"], cfg["symbol_rate"])
    got = compare.compare({"packed": p.numpy(), "n_valid": n.numpy(), "found": f.numpy()}, ref, traffic.sent,
                          ref_frames)
    assert got == {"bytes_differ_share": 0.0, "frames_missed": 0, "frames_invented": 0}
    for control in ("tf32", "cublas_tf32"):
        ctl = ref_mod.receive(traffic.captures, cfg, "cpu", control)
        share = compare.compare(ctl, ref, traffic.sent, ref_frames)["bytes_differ_share"]
        # cuBLAS's switch changes nothing on a CPU; the hand-rounded form fails.
        assert (share > cfg["limits"]["bytes_differ_share"]) if control == "tf32" else share == 0.0


def test_k8_bound_at_the_bench_shape():
    from portbench.reference import fsk_disc

    g = fsk_disc.geometry(1 << 24, _cfg())
    assert (g["dec"], g["rows"], g["bit_rows"], g["spr2"], g["band"]) == (4, 33280, 6656, 256, (10.0, 11800.0))
    wb = fsk_disc.boxcars(g["spb"], g["dec"], g["row2"], g["ov2"], g["spr2"])
    nonzero = [int((wb[i] != 0).sum()) for i in range(wb.shape[0])]
    assert nonzero == [768, 896, 768, 896, 896, 768, 896, 768]  # 3 taps a bit, or 3.5 at odd offsets
    # chip_smoke.py phase 6's bench batch: 64 captures of one wave from lead 0, int16 rows of 640
    reader = harness.load_reader("k8_roofline")
    ms = reader.least_ms(64, g["rows"], g["bit_rows"], g["spr2"], 64 * nonzero[0], 64 * g["rows"] * 640 * 2,
                         67e12, 3.35e12)
    assert ms == pytest.approx(2.1436, abs=5e-5)


def test_disc_decide_ms_reads_the_span_alone(monkeypatch):
    from audio_modem_radio_tpu_torch import observability

    recs = [_rec(0, "amr.demod_pack_batch", None, 1, 30.0, 31.0), _rec(1, "amr.pass1", 0, 1, 1.0, 2.0),
            _rec(2, "amr.decide", 0, 1, 1.0, 25.0), _rec(3, "amr.disc_decide", 2, 1, 0.5, 9.0),
            _rec(4, "amr.demod_pack_batch", None, 2, 30.0, 30.0), _rec(5, "amr.decide", 4, 2, 1.0, 24.0),
            _rec(6, "amr.disc_decide", 5, 2, 0.5, 8.0)]
    snap = {"records": recs, "counters": {}, "dropped": 0, "launches": {}}
    reader = harness.load_reader("disc_decide_ms")
    monkeypatch.setattr(observability, "trace_snapshot", lambda: snap)
    assert reader.read(None) == pytest.approx(8.5)
    without = dict(snap, records=[r for r in recs if r["name"] != "amr.disc_decide"])
    monkeypatch.setattr(observability, "trace_snapshot", lambda: without)
    assert reader.read(None) is None  # a program without the span: the metric is left out
    monkeypatch.delattr(observability, "trace_snapshot")
    assert reader.read(None) is None


@pytest.mark.parametrize("fault", [None, _half_left_out, _byte_altered])
def test_broken_timed_path_is_not_correct(fault, line_root, int16_rows, monkeypatch):
    from audio_modem_radio_tpu_torch.parallel import batch

    if fault is not None:
        monkeypatch.setattr(batch, "demod_pack_batch", fault(batch.demod_pack_batch))
    root, bench = line_root
    result = harness.run(CELL, 2**31 + 77, 0.1, False, "cpu", bench=bench, root=root)
    assert result["correct"] is (fault is None), result["checks"]
    assert set(result["metrics"]) == {"decode_msamples_per_s", "batch_p95_ms", "setup_s"}


@pytest.mark.cuda
def test_traced_small_run_on_the_card(line_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    root, bench = line_root
    result = harness.run(CELL, 2**31 + 99, 0.5, True, torch.device("cuda"), bench=bench, root=root)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert {"device_idle_share", "torch_ops_ms", "host_shape_ms", "k8_roofline", "disc_decide_ms"} <= set(m)
    assert 0 < m["k8_roofline"]["value"] <= 105 and m["disc_decide_ms"]["value"] > 0
