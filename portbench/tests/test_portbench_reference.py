"""The plain reference and the port agree on small captures on the host, and
the control (the reference with TF32 products) fails the comparison."""

import json

import pytest
import torch

from portbench import compare, generator, harness

from .conftest import ROOT, SMALL


def _program(traffic, cfg):
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch, host_shape_batch

    rows = host_shape_batch(traffic.captures, cfg["mode"], cfg["symbol_rate"], device="cpu")
    assert rows.dtype.name == "int16"
    p, n, f = demod_pack_batch(torch.from_numpy(rows), cfg["mode"], cfg["symbol_rate"])
    return {"packed": p.numpy(), "n_valid": n.numpy(), "found": f.numpy()}


@pytest.mark.parametrize("name", ["qpsk-9600", "fsk-19200"])
def test_reference_agrees_and_control_fails(name, int16_rows):
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    traffic = generator.build(cfg, SMALL, 2**31 + 5, "cpu")
    ref_mod = harness.reference(cfg)
    ref = ref_mod.receive(traffic.captures, cfg, "cpu", "float32")
    ref_frames = compare.frames(ref["packed"], ref["n_valid"])
    assert all(len(f) >= 1 for f, noise in zip(ref_frames, traffic.noise_only) if not noise)
    assert all(len(f) == 0 for f, noise in zip(ref_frames, traffic.noise_only) if noise)
    got = compare.compare(_program(traffic, cfg), ref, traffic.sent, ref_frames)
    assert got == {"bytes_differ_share": 0.0, "frames_missed": 0, "frames_invented": 0}
    control = ref_mod.receive(traffic.captures, cfg, "cpu", "tf32")
    assert compare.compare(control, ref, traffic.sent, ref_frames)["bytes_differ_share"] > \
        cfg["limits"]["bytes_differ_share"]


def test_control_precisions():
    from portbench.channel import mm

    a, b = torch.randn(3, 40, generator=torch.Generator().manual_seed(1)), torch.randn(40, 5)
    assert torch.equal(mm(a, b, "cublas_tf32"), mm(a, b, "float32"))  # no TF32 on a CPU
    assert not torch.equal(mm(a, b, "tf32"), mm(a, b, "float32"))
    with pytest.raises(ValueError):
        mm(a, b, "bfloat16")
