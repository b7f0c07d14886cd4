"""The rooflines' counts reproduce the bounds PERF.md keeps for K1 and K9, so
neither can drift into a reading over 100%."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from portbench.reference import fsk

METRICS = Path(fsk.__file__).resolve().parent.parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1_bound_at_the_bench_shape():
    # 64 captures x 13,312 rows x 1280 int16 samples (2^24 samples at 9600 Bd)
    assert _reader("k1_roofline").least_ms(64, 13312, 1280, 2, 3.35e12) == pytest.approx(0.7162, abs=5e-5)


def test_k9_bound_at_the_bench_shape():
    cfg = {"sample_rate": 96000, "symbol_rate": 19200, "mark_hz": 8000.0, "space_hz": 16000.0}
    g = fsk.geometry(1 << 24, cfg)
    assert (g["rows"], g["bit_rows"], g["spr2"]) == (131200, 26240, 128)
    wq = fsk.quadratures(g["spb"], g["mark"], g["space"], g["sr"], g["spr2"], g["row2"], g["ov2"])
    nonzero = np.count_nonzero(wq.reshape(wq.shape[0], -1), axis=1)
    assert list(nonzero) == [2558, 2558] + [2560] * 6  # sin(0) = 0 at offsets 0 and 1
    # the bench batch: one wave tiled 64 times from lead 0, so one offset for all
    ms = _reader("k9_roofline").least_ms(64, g["rows"], g["bit_rows"], g["spr2"], 64 * int(nonzero[0]), 67e12)
    assert ms == pytest.approx(8.5692, abs=5e-5)
