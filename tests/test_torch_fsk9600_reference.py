"""The port's FSK9600 batch (fused FIR windows -> pass 1 -> K8 ->
``fsk_disc_decide_batch`` -> the sync tail) against the benchmark's plain reference of
the close-tone discriminator (``portbench/reference/fsk_disc.py``), on small
captures from the benchmark's generator at the ``fsk-9600`` configuration's
40 dB, on the CPU: the same bits, frames recovered, and the TF32 control
judged not correct by the configuration's limit."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu_torch.config import CONFIG
from audio_modem_radio_tpu_torch.ops.fsk import fsk_disc_pass1
from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch, host_shape_batch
from portbench import compare, generator
from portbench.reference import fsk_disc

# Parallel test workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG = json.loads((REPO / "portbench" / "configs" / "fsk-9600.json").read_text())
# Three captures of 2^21 samples: one at +100 Hz, the last noise only.
MIX = {"captures": 3, "samples": 1 << 21, "lead_samples": [0, 1280], "noise_every": 3, "offset_hz": {"1": 100},
       "snr_db": 40.0, "part_bytes": 16384}


@pytest.fixture(scope="module")
def answers():
    """(traffic, the reference's answer, the port's answer with its pass-1 offsets)."""
    traffic = generator.build(CFG, MIX, 2**31 + 5, "cpu")
    ref = fsk_disc.receive(traffic.captures, CFG, "cpu", "float32")
    old = CONFIG.get("tpu.int16_rows")
    CONFIG.set("tpu.int16_rows", True)  # the rows the port lays out for the card
    try:
        rows = host_shape_batch(traffic.captures, CFG["mode"], CFG["symbol_rate"], device="cpu")
    finally:
        CONFIG.set("tpu.int16_rows", old)
    assert rows.dtype == np.int16
    x = torch.from_numpy(rows)
    best = fsk_disc_pass1(x, float(CFG["symbol_rate"]), CFG["mark_hz"], CFG["space_hz"], CFG["sample_rate"])[0]
    packed, n_valid, found = demod_pack_batch(x, CFG["mode"], CFG["symbol_rate"])
    got = {"packed": packed.numpy(), "n_valid": n_valid.numpy(), "found": found.numpy(), "best": best.numpy()}
    return traffic, ref, got


def test_port_and_reference_agree_bitwise(answers):
    _traffic, ref, got = answers
    for key in ("packed", "n_valid", "found", "best"):
        assert np.array_equal(got[key], ref[key].astype(got[key].dtype)), key
    assert ref["found"].all()


def test_every_signal_capture_yields_a_frame(answers):
    traffic, ref, got = answers
    frames = compare.frames(got["packed"], got["n_valid"])
    assert traffic.noise_only == [False, False, True]
    for f, sent, noise in zip(frames, traffic.sent, traffic.noise_only):
        assert (len(f) >= 1 and f <= set(sent)) if not noise else not f
    assert compare.compare(got, ref, traffic.sent) == {"bytes_differ_share": 0.0, "frames_missed": 0,
                                                       "frames_invented": 0}


def test_tf32_control_exceeds_the_limit(answers):
    traffic, ref, _got = answers
    control = fsk_disc.receive(traffic.captures, CFG, "cpu", "tf32")
    assert compare.compare(control, ref, traffic.sent)["bytes_differ_share"] > CFG["limits"]["bytes_differ_share"]


def test_reference_imports_nothing_forbidden():
    code = ("import sys; from portbench.reference import fsk_disc; from portbench.transmit import fsk_disc as t; "
            "from portbench import harness; print(harness.forbidden_modules(sys.modules)); "
            "print(sorted(m for m in sys.modules if m.startswith('audio_modem_radio_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines() == ["[]", "[]"]  # nothing of JAX, the JAX package or the port
