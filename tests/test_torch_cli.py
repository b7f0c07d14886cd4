"""The port's command line (``audio_modem_radio_tpu_torch/cli.py``) against
the JAX package's, on the CPU: the same seeded files through both
``cli.main``s, the port's decodes with ``--device cpu``.

Each package runs in a directory of its own, so the relative paths that
both print (``cache/...``) compare as text and neither sees the other's
analytics file, playlist or log. What is compared:

* ``encode-file``: the same stdout, and WAVs as ``tests/test_torch_encoder.py``
  compares them (the same header, 16-bit samples at most one step apart);
* ``decode-wav`` (single, ``--retry``, ``--batch`` of 2, ``--stream-fec``)
  and ``decode-stream --wav``: exit 0 and the source's bytes saved by both;
  a noise WAV: exit 1 in both;
* ``modes``, ``modes --all`` and ``modes --diagram`` of every mode: the
  same stdout; ``stats`` and ``recommend``: the same JSON, the timestamp
  aside;
* the parsers: every JAX sub-command with the same arguments, the port's
  decoding commands with ``--device`` besides;
* no fallback: without a card and without ``--device``, a decode exits 2
  with ``resolve_device``'s message and saves nothing.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import cli as jcli
from audio_modem_radio_tpu.modem import MODES as JMODES
from audio_modem_radio_tpu.utils.wavio import write_wav

from audio_modem_radio_tpu_torch import cli as tcli
from audio_modem_radio_tpu_torch.modem import MODES as TMODES

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

RATE = "4800"
_QPSK = ["--mode", "QPSK", "--symbol-rate", RATE]


def _run(main, workdir, argv, capsys):
    """``main(argv)`` inside ``workdir``: (exit code, stdout)."""
    old = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    try:
        rc = main(argv)
    finally:
        os.chdir(old)
    return rc, capsys.readouterr().out


def _saved(workdir, out):
    """The bytes of every file a decode printed as saved."""
    paths = [ln.split(": ", 1)[-1] for ln in out.splitlines() if "recv_" in ln]
    return [open(os.path.join(workdir, p), "rb").read() for p in paths]


def _wav_samples_close(a: str, b: str) -> None:
    ta, tb = open(a, "rb").read(), open(b, "rb").read()
    assert ta[:44] == tb[:44] and len(ta) == len(tb)
    diff = np.frombuffer(ta[44:], np.int16).astype(np.int32) - np.frombuffer(tb[44:], np.int16)
    assert int(np.max(np.abs(diff))) <= 1


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One seeded source file encoded by each CLI, plain and with stream
    FEC; {"dir": ..., "src": bytes, "out": {...}, "wav": {...}} keyed by
    (package, fec)."""
    root = tmp_path_factory.mktemp("cli")
    data = np.random.default_rng(17).integers(0, 256, 300, dtype=np.uint8).tobytes()
    out, wav = {}, {}
    for tag in ("j", "t"):
        d = root / tag
        d.mkdir()
        (d / "src.bin").write_bytes(data)
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        for fec in (None, "stream"):
            argv = ["encode-file", "src.bin", *_QPSK, "--cache-dir", f"cache_{fec}"]
            if fec:
                argv += ["--fec", "--fec-type", fec]
            buf = io.StringIO()
            old = os.getcwd()
            os.chdir(root / tag)
            try:
                with contextlib.redirect_stdout(buf):
                    rc = main(argv)
            finally:
                os.chdir(old)
            assert rc == 0
            out[tag, fec] = buf.getvalue()
            wav[tag, fec] = str(root / tag / out[tag, fec].splitlines()[-1])
    return {"dir": root, "src": data, "out": out, "wav": wav}


@pytest.mark.parametrize("fec", [None, "stream"])
def test_encode_file_equals_jax(encoded, fec):
    """The same lines on stdout and the same WAV."""
    assert encoded["out"]["t", fec] == encoded["out"]["j", fec]
    _wav_samples_close(encoded["wav"]["t", fec], encoded["wav"]["j", fec])


@pytest.mark.parametrize("extra", [[], ["--retry"]], ids=["single", "retry"])
def test_decode_wav_saves_the_source_in_both(encoded, tmp_path, capsys, extra):
    wav = encoded["wav"]["t", None]
    rc_j, out_j = _run(jcli.main, tmp_path / "j", ["decode-wav", wav, *_QPSK, *extra], capsys)
    rc_t, out_t = _run(tcli.main, tmp_path / "t", ["decode-wav", wav, *_QPSK, *extra, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert _saved(tmp_path / "j", out_j) == _saved(tmp_path / "t", out_t) == [encoded["src"]]
    assert out_t.splitlines()[0] == out_j.splitlines()[0] == f"{wav}: 1 file(s)"


def test_decode_wav_batch_of_two(encoded, tmp_path, capsys):
    wavs = [encoded["wav"]["t", None], encoded["wav"]["j", None]]
    argv = ["decode-wav", *wavs, *_QPSK, "--batch"]
    rc_j, out_j = _run(jcli.main, tmp_path / "j", argv, capsys)
    rc_t, out_t = _run(tcli.main, tmp_path / "t", argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert out_t.splitlines()[:2] == out_j.splitlines()[:2] == [f"{w}: 1 file(s)" for w in wavs]
    assert _saved(tmp_path / "j", out_j) == _saved(tmp_path / "t", out_t) == [encoded["src"]] * 2


def test_decode_wav_stream_fec(encoded, tmp_path, capsys):
    wav = encoded["wav"]["t", "stream"]
    argv = ["decode-wav", wav, *_QPSK, "--stream-fec"]
    rc_j, out_j = _run(jcli.main, tmp_path / "j", argv, capsys)
    rc_t, out_t = _run(tcli.main, tmp_path / "t", argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert _saved(tmp_path / "j", out_j) == _saved(tmp_path / "t", out_t) == [encoded["src"]]


def test_decode_stream_wav(encoded, tmp_path, capsys):
    wav = encoded["wav"]["t", None]
    argv = ["decode-stream", "--wav", wav, *_QPSK, "--window", "65536"]
    rc_j, out_j = _run(jcli.main, tmp_path / "j", argv, capsys)
    rc_t, out_t = _run(tcli.main, tmp_path / "t", argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_t == 0
    assert [ln.split(": ")[0] for ln in out_t.splitlines()] == [ln.split(": ")[0] for ln in out_j.splitlines()]
    assert _saved(tmp_path / "j", out_j) == _saved(tmp_path / "t", out_t) == [encoded["src"]]


def test_noise_exits_1_in_both(tmp_path, capsys):
    noise = str(tmp_path / "noise.wav")
    write_wav(noise, np.random.default_rng(5).normal(0, 0.2, 48000).astype(np.float32))
    rc_j, out_j = _run(jcli.main, tmp_path / "j", ["decode-wav", noise], capsys)
    rc_t, out_t = _run(tcli.main, tmp_path / "t", ["decode-wav", noise, "--device", "cpu"], capsys)
    assert rc_j == rc_t == 1
    assert out_t == out_j == f"{noise}: 0 file(s)\n"


def test_no_card_no_device_fails_and_saves_nothing(encoded, tmp_path, capsys, monkeypatch):
    """Without a card a decode given no ``--device`` exits 2 with the
    reason and saves nothing: it never decodes on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wavs = [encoded["wav"]["t", None], encoded["wav"]["j", None]]
    for argv in (["decode-wav", wavs[0], *_QPSK], ["decode-wav", *wavs, *_QPSK, "--batch"],
                 ["decode-wav", wavs[0], *_QPSK, "--retry"], ["decode-stream", "--wav", wavs[0], *_QPSK]):
        rc, out = _run(tcli.main, tmp_path, argv, capsys)
        assert rc == 2 and out == ""
        assert not os.path.exists(tmp_path / "recv")
        assert not os.path.exists(tmp_path / "audio_modem_analytics.json")
    tcli.main(["decode-wav", wavs[0]])
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["modes"], ["modes", "--all"]], ids=["modes", "all"])
def test_modes_listing_equals_jax(capsys, argv):
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv) == 0
    assert capsys.readouterr().out == want
    assert "LORA" in want or argv == ["modes"]


@pytest.mark.parametrize("mode", list(JMODES))
def test_mode_diagram_equals_jax(capsys, mode):
    assert list(TMODES) == list(JMODES)
    assert jcli.main(["modes", "--diagram", mode]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["modes", "--diagram", mode]) == 0
    assert capsys.readouterr().out == want
    assert "unavailable" not in want


@pytest.mark.parametrize("mode,rate", [("QPSK", "9600"), ("FSK1200", "1200"), ("NEURAL", "3000"),
                                       ("HELLSCHREIBER", "9600")])
def test_stats_json_equals_jax(tmp_path, capsys, mode, rate):
    src = tmp_path / "s.bin"
    src.write_bytes(b"stats payload " * 700 + bytes(range(256)))
    argv = ["stats", str(src), "--mode", mode, "--symbol-rate", rate]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(argv) == 0
    assert json.loads(capsys.readouterr().out) == want


@pytest.mark.parametrize("priority", ["robustness", "speed", "balanced"])
def test_recommend_json_equals_jax(encoded, capsys, priority):
    for extra in ([], ["--wav", encoded["wav"]["j", None]]):
        argv = ["recommend", "--priority", priority, *extra]
        assert jcli.main(argv) == 0
        want = json.loads(capsys.readouterr().out)
        assert tcli.main(argv) == 0
        got = json.loads(capsys.readouterr().out)
        assert got["conditions"].pop("timestamp") > 0 and want["conditions"].pop("timestamp") > 0
        assert got == want


def _arguments(parser):
    """{sub-command: {dest: (option strings, default, type, choices, nargs, help)}}."""
    subs = next(a for a in parser._actions if a.dest == "command").choices
    return {
        name: {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.help)
               for a in sp._actions if a.dest not in ("help", "fn")}
        for name, sp in subs.items()
    }


def test_subcommands_take_the_jax_arguments():
    ours, theirs = _arguments(tcli.build_parser()), _arguments(jcli.build_parser())
    assert list(ours) == list(theirs)
    for name, args in theirs.items():
        extra = {"device"} if name in ("decode-wav", "decode-stream") else set()
        assert set(ours[name]) == set(args) | extra, name
        assert {k: v for k, v in ours[name].items() if k not in extra} == args, name
    assert tcli.build_parser().prog == "audio_modem_radio_tpu_torch"


@pytest.mark.parametrize("sub", ["encode-file", "modes", "stats", "recommend"])
def test_help_text_equals_jax_but_the_prog_name(capsys, sub):
    """The sub-commands without ``--device``: the same help."""
    helps = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main([sub, "--help"])
        assert e.value.code == 0
        helps.append(capsys.readouterr().out)
    # The longer name re-wraps the usage lines: compare the words.
    assert helps[1].replace("audio_modem_radio_tpu_torch", "audio_modem_radio_tpu").split() == helps[0].split()
