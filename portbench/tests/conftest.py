"""Fixtures of the benchmark's own tests: a checkout-like root with a small
mix (an archive of four captures decoded in two calls), and the program's
int16 row layout on the host."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"captures": 4, "batch": 2, "samples": 1 << 21, "lead_samples": [0, 1280], "noise_every": 4,
         "offset_hz": {"1": 100, "2": -100}, "snr_db": 20.0, "part_bytes": 16384}


@pytest.fixture
def int16_rows():
    """The rows the program lays out for the card (int16), here on the host."""
    from audio_modem_radio_tpu_torch.config import CONFIG

    old = CONFIG.get("tpu.int16_rows")
    CONFIG.set("tpu.int16_rows", True)
    yield
    CONFIG.set("tpu.int16_rows", old)


@pytest.fixture
def small_root(tmp_path):
    """(root, bench): the benchmark's files plus the mix ``small`` and a cell
    of it for every configuration, which reads its configuration's metrics."""
    from portbench import harness

    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / d, tmp_path / d)
    (tmp_path / "traffic" / "small.json").write_text(json.dumps(SMALL))
    bench = harness.load_bench()
    config_of = {w["name"]: w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        bench["workloads"].append({"name": f"{c['name']}.small", "config": c["name"], "traffic": "small",
                                   "chips": 1, "why": "small captures"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:  # a metric of some cells is read in their configuration's small cell too
            m["workloads"] += sorted({f"{config_of[w]}.small" for w in m["workloads"]})
    return tmp_path, bench
