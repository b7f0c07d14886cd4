"""On the card: a traced run of each configuration's small cell is correct and
reads every per-layer metric it names. Skips without a CUDA card."""

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["qpsk-9600", "fsk-19200"])
def test_traced_small_run_on_the_card(config, card, small_root):
    root, bench = small_root
    result = harness.run(f"{config}.small", 2**31 + 99, 0.5, True, card, bench=bench, root=root)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["device"]["platform"] == "gpu"
    roofline = "k1_roofline" if config == "qpsk-9600" else "k9_roofline"
    assert {"device_idle_share", "torch_ops_ms", "host_shape_ms", roofline} <= set(result["metrics"])
    assert 0 < result["metrics"][roofline]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["qpsk-9600", "fsk-19200"])
def test_control_is_not_correct_on_the_card(config, card, small_root):
    """The run's own check, with the reference in TF32 put in the program's
    place, reports not correct."""
    root, bench = small_root
    cell = harness.find_cell(bench, f"{config}.small", root)
    v = harness.check(cell, 2**31 + 98, card, [], control="tf32")
    assert v.failed == 1, v.checks
