"""The harness finds what a cell names by name, and a new configuration, mix
or metric is taken by adding files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent


def test_benchmark_names_files_that_exist():
    bench = harness.load_bench()
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    for c in bench["configs"]:
        assert (harness.REPO / c["file"]) == ROOT / "configs" / f"{c['name']}.json"
        assert json.loads((harness.REPO / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.cfg["name"] == w["config"] and cell.mix["captures"] > 0
        assert cell.end_to_end and cell.per_layer, w["name"]
        assert (ROOT / "transmit" / f"{cell.cfg['family']}.py").is_file()
        assert (ROOT / "reference" / f"{cell.cfg['family']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read), m["name"]


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        harness.find_cell(harness.load_bench(), "no-such-cell")


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / d, tmp_path / d)
    cfg = json.loads((ROOT / "configs" / "qpsk-9600.json").read_text())
    cfg.update(name="qpsk-4800", symbol_rate=4800)
    (tmp_path / "configs" / "qpsk-4800.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "short.json").write_text(json.dumps(
        {"captures": 2, "samples": 1 << 18, "lead_samples": [0, 10], "noise_every": 2, "snr_db": 20.0,
         "part_bytes": 1024}))
    (tmp_path / "metrics" / "batches.py").write_text("def read(ctx):\n    return ctx.window['batches']\n")
    bench = harness.load_bench()
    bench["workloads"].append({"name": "qpsk-4800.short", "config": "qpsk-4800", "traffic": "short", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "batches", "unit": "1", "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "decode_msamples_per_s",
                               "workloads": ["qpsk-4800.short"]})
    cell = harness.find_cell(bench, "qpsk-4800.short", root=tmp_path)
    assert cell.cfg["symbol_rate"] == 4800 and cell.mix["samples"] == 1 << 18
    assert [m["name"] for m in cell.per_layer][-1] == "batches"
    ctx = harness.Context(cell.cfg, cell.mix, {"batches": 7}, 0.0, 0.0, (), 2, {}, "cpu")
    assert harness.load_reader("batches", root=tmp_path).read(ctx) == 7


def test_import_check_compares_top_level_names_whole():
    names = ["jax", "jaxlib.xla_client", "flax.linen", "audio_modem_radio_tpu", "audio_modem_radio_tpu.ops.psk",
             "audio_modem_radio_tpu_torch", "audio_modem_radio_tpu_torch.ops.psk", "jaxtyping", "flaxen",
             "portbench.harness", "torch"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jaxlib.xla_client", "flax.linen", "audio_modem_radio_tpu", "audio_modem_radio_tpu.ops.psk"])


def test_the_benchmark_and_the_port_load_no_jax():
    """What a run loads (the port's batch layer, the benchmark's modules and
    every metric's reader), in a fresh interpreter."""
    code = ("import sys; from audio_modem_radio_tpu_torch.parallel import batch; "
            "from portbench import calibrate, harness; "
            "from portbench.reference import fsk, psk; "
            "[harness.load_reader(m['name']) for k in ('end_to_end', 'per_layer') "
            "for m in harness.load_bench()[k]]; "
            "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_and_generator_import_nothing_of_the_program():
    for path in list((ROOT / "reference").glob("*.py")) + list((ROOT / "transmit").glob("*.py")) + [
            ROOT / "generator.py", ROOT / "frames.py", ROOT / "channel.py", ROOT / "compare.py"]:
        text = path.read_text()
        assert "audio_modem_radio_tpu" not in text and "import jax" not in text, path


def test_compared_captures_hold_every_noise_and_offset_capture():
    mix = {"captures": 512, "noise_every": 64, "offset_hz": {"1": 100, "2": -100}}
    idx = harness.compared(mix, 2**31 + 5)
    assert len(idx) == harness.COMPARED and list(idx) == sorted(set(idx.tolist()))
    assert {1, 2} | set(range(63, 512, 64)) <= set(idx.tolist())
    assert list(harness.compared(mix, 2**31 + 5)) == list(idx)
    assert list(harness.compared(mix, 2**31 + 6)) != list(idx)
    assert list(harness.compared(dict(mix, captures=40, noise_every=8), 3)) == list(range(40))
    assert len(harness.compared(dict(mix, compared=12), 3)) == 12  # the 8 noise-only, 2 offset and 2 drawn
    assert harness.chunk({"samples": 1 << 24}) == 16 and harness.chunk({"samples": 1 << 30}) == 1
