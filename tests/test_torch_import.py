"""The PyTorch port never imports JAX, directly or indirectly."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "audio_modem_radio_tpu_torch"

_ROUND_TRIP = """
import sys
import numpy as np
import audio_modem_radio_tpu_torch as amt
from audio_modem_radio_tpu_torch.framing import crc32
from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

data = b"no jax here " * 40
wave = amt.modulate("QPSK", amt.pack_frame("j.bin", data, 0, 1, len(data), crc32(data)), 9600)
batch = np.zeros((1, 1 << 16), np.float32)
batch[0, : len(wave)] = wave
raw = decode_sample_batch(batch, "QPSK", 9600, device="cpu")[0]
assert [f.data for f in amt.parse_frames(raw)] == [data]

# The command line, in a scratch directory (it writes its analytics file
# there), and the other front ends and host modules imported.
import os, tempfile
from audio_modem_radio_tpu_torch import app, audio_io, cli, diagrams, gui, intelligence, observability, ptt, tui
from audio_modem_radio_tpu_torch.utils.wavio import write_wav
scratch = tempfile.TemporaryDirectory()
os.chdir(scratch.name)
write_wav("j.wav", wave)
assert cli.main(["decode-wav", "j.wav", "--device", "cpu", "--recv-dir", "r"]) == 0
assert [open(os.path.join("r", f), "rb").read() for f in os.listdir("r") if f.startswith("recv_")] == [data]
# Scale-out and training: the mesh, the sequence path, multi-host, the
# learned modem and the entry points, imported and run on the CPU.
from audio_modem_radio_tpu_torch import entry
from audio_modem_radio_tpu_torch.models import neural_modem, train_neural
from audio_modem_radio_tpu_torch.parallel import mesh, multihost, sequence
raw = sequence.decode_capture_sharded(wave, "QPSK", 9600, mesh.get_mesh(devices=["cpu"] * 2))
assert [f.data for f in amt.parse_frames(raw)] == [data]
leaked = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "__graft_entry__")
                or m.startswith(("jax.", "jaxlib", "flax.", "optax.", "audio_modem_radio_tpu.")))
print("LEAKED", leaked)
"""


def test_port_round_trip_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _ROUND_TRIP], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")] + ["chip_smoke.py"]
))
def test_source_has_no_jax_import(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import\s+(jax|flax|optax|__graft_entry__)|from\s+(jax|flax|optax|__graft_entry__)\b)",
                         text, re.M)
    assert not re.search(r"^\s*(import|from)\s+audio_modem_radio_tpu\b(?!_torch)", text, re.M)
    # Nor the repository's tools/ modules (the port keeps its own copies).
    assert not re.search(r"^\s*(import|from)\s+(tools|build_dist|build_standalone)\b", text, re.M)


_TOOLS = """
import pathlib, sys
import audio_modem_radio_tpu_torch.tools.build_dist
import audio_modem_radio_tpu_torch.tools.build_standalone
repo_tools = pathlib.Path(sys.argv[1]).resolve()
leaked = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "tools", "build_dist", "build_standalone")
                or m.startswith(("jax.", "jaxlib", "tools.", "audio_modem_radio_tpu.")))
leaked += sorted(m for m, mod in list(sys.modules.items())
                 if getattr(mod, "__file__", None) and repo_tools in pathlib.Path(mod.__file__).resolve().parents)
print("LEAKED", leaked)
"""


def test_port_tools_import_neither_jax_nor_the_repos_tools():
    """``audio_modem_radio_tpu_torch.tools.*`` import torch's side only:
    no JAX, no module of the JAX package and none of ``tools/``."""
    out = subprocess.run([sys.executable, "-c", _TOOLS, str(REPO / "tools")], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout
