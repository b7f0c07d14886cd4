"""The port's console surfaces (``tui``, ``gui``, ``app``, ``diagrams``,
``audio_io.ReceiveSession``) against the JAX package's, on the CPU.

* ``tui.render_screen``: the same lines for the same ``AppState``, every
  tab;
* ``gui.mode_diagram_primitives``: for every mode the same primitives in
  the same order, kinds, colours and texts equal and coordinates within
  1e-3 pixel (the QPSK-family waveforms agree to 1e-6, not bitwise; see
  ``tests/test_torch_psk.py``);
* ``ConsoleApp`` (scripted ``input``), ``GuiViewModel`` (encode, then
  decode, on worker threads) and ``ReceiveSession`` over a 48 kHz
  ``FileRecorder``: the port's on ``device="cpu"`` saves the same bytes as
  the JAX package's;
* no fallback: without a card and with no device named, the console app's
  decode raises, the GUI's decode, record and monitor workers each emit an
  ``"error"`` event, and nothing is saved; ``app.main`` and ``gui.main``
  take ``--device``, and the GUI's fallback to the console app (no
  display) keeps it.

Each package works in a directory of its own: both write
``audio_modem_analytics.json``, ``playlist.json`` and
``audio_modem_system.log`` in the working directory.
"""

import logging
import os
import queue
import time

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import app as japp
from audio_modem_radio_tpu import gui as jgui
from audio_modem_radio_tpu import tui as jtui
from audio_modem_radio_tpu.audio_io import FileRecorder as JFileRecorder, ReceiveSession as JSession
from audio_modem_radio_tpu.modem import MODES as JMODES
from audio_modem_radio_tpu.utils.wavio import read_wav, resample, write_wav

from audio_modem_radio_tpu_torch import app as tapp
from audio_modem_radio_tpu_torch import gui as tgui
from audio_modem_radio_tpu_torch import tui as ttui
from audio_modem_radio_tpu_torch.audio_io import FileRecorder as TFileRecorder, ReceiveSession as TSession
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.encoder import encode_file

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

_PAYLOAD = np.random.default_rng(29).integers(0, 256, 300, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def _close_app_logs():
    """The apps attach file handlers to each package's logger; close them."""
    yield
    for name in ("audio_modem_radio_tpu", "audio_modem_radio_tpu_torch"):
        logger = logging.getLogger(name)
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """A QPSK@4800 WAV of the seeded payload, written by the port."""
    d = tmp_path_factory.mktemp("console")
    (d / "p.bin").write_bytes(_PAYLOAD)
    return encode_file(str(d / "p.bin"), "QPSK", True, 4800, cache_dir=str(d / "cache"))


def _states():
    st = [jtui.AppState(), ttui.AppState()]
    yield st
    for s in st:
        s.tab, s.mode, s.symbol_rate, s.use_fec, s.compress = 1, "FSK9600", 9600, True, False
        s.recording, s.volume, s.busy = True, 0.37, "decoding x.wav"
        s.stats = {"files_received": 3, "avg_quality": 0.91}
        s.assemblies = [{"filename": "big.bin", "received": 2, "total": 5}]
        s.log = [f"[12:00:0{i}] line {i}" for i in range(9)]
    yield st
    for s in st:
        s.tab, s.playlist, s.played, s.playing, s.sel, s.ptt_port = 2, ["a.wav", "b.wav", "c.wav"], {"b.wav"}, \
            "a.wav", 2, "/dev/ttyUSB0"
    yield st
    for s in st:
        s.tab, s.playlist, s.host = 3, [], {"cpu_percent": 12.5, "ram_percent": 40.0}
        s.channel = {"snr_db": 17.25, "recommended": "QPSK"}
    yield st


def test_render_screen_equals_jax():
    n = 0
    for j, t in _states():
        for width, log_height in ((80, 8), (120, 5), (40, 12)):
            assert ttui.render_screen(t, width, log_height) == jtui.render_screen(j, width, log_height)
        assert ttui.render_volume_bar(t.volume) == jtui.render_volume_bar(j.volume)
        n += 1
    assert n == 4 and ttui.TABS == jtui.TABS


def _prims_close(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and len(g) == len(w)
        if g[0] == "polyline":
            assert g[2] == w[2] and len(g[1]) == len(w[1])
            assert np.max(np.abs(np.asarray(g[1]) - np.asarray(w[1])), initial=0.0) <= 1e-3
        elif g[0] == "text":
            assert g[3:] == w[3:] and np.allclose(g[1:3], w[1:3], rtol=0, atol=1e-3)
        else:
            assert g[5] == w[5] and np.allclose(g[1:5], w[1:5], rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", list(JMODES) + ["NOPE"])
def test_mode_diagram_primitives_equal_jax(mode):
    for rate, size in ((9600, (360, 180)), (2400, (500, 240))):
        want = jgui.mode_diagram_primitives(mode, rate, *size)
        got = tgui.mode_diagram_primitives(mode, rate, *size)
        _prims_close(got, want)
        assert not any(p[0] == "text" and "unavailable" in p[3] for p in got)


def _in(path, fn):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(old)


def _console_run(mod, workdir, inputs, monkeypatch, capsys, **kw):
    it = iter(inputs)
    monkeypatch.setattr("builtins.input", lambda *_: next(it))
    _in(workdir, lambda: mod.ConsoleApp(**kw).run())
    return capsys.readouterr().out


def test_console_app_encode_decode_equals_jax(tmp_path, monkeypatch, capsys):
    """encode -> decode through each package's app, and each app decoding
    the WAV the other wrote: the source's bytes, the same lines printed
    (saved paths aside)."""
    outs, wavs = {}, {}
    for tag, mod, kw in (("j", japp, {}), ("t", tapp, {"device": "cpu"})):
        d = tmp_path / tag
        d.mkdir()
        (d / "c.bin").write_bytes(_PAYLOAD)
        out = _console_run(mod, d, ["encode", "c.bin", "QPSK", "4800", "n", "quit"], monkeypatch, capsys, **kw)
        wavs[tag] = str(d / next(ln.split("wrote ", 1)[1] for ln in out.splitlines() if ln.startswith("wrote ")))
        outs[tag] = out
    assert outs["t"] == outs["j"]
    for tag, mod, kw in (("j", japp, {}), ("t", tapp, {"device": "cpu"})):
        for src in ("j", "t"):
            out = _console_run(mod, tmp_path / tag, ["decode", wavs[src], "QPSK", "4800", "quit"], monkeypatch,
                               capsys, **kw)
            lines = out.splitlines()
            assert "1 file(s) recovered" in lines, out
            saved = lines[lines.index("1 file(s) recovered") + 1].strip()
            assert open(os.path.join(tmp_path / tag, saved), "rb").read() == _PAYLOAD


def _drain(vm, timeout=120.0):
    """Events until a terminal one (encoded, decoded or error)."""
    events, deadline = [], time.time() + timeout
    while time.time() < deadline:
        try:
            event = vm.events.get(timeout=0.5)
        except queue.Empty:
            continue
        events.append(event)
        if event[0] in ("encoded", "decoded", "error"):
            return events
    raise AssertionError(f"no terminal event; saw {events}")


def test_gui_view_model_round_trip_equals_jax(tmp_path):
    """start_encode, then start_decode of the WAV, on worker threads."""
    got = {}
    for tag, mod, kw in (("j", jgui, {}), ("t", tgui, {"device": "cpu"})):
        d = tmp_path / tag
        d.mkdir()
        (d / "g.bin").write_bytes(_PAYLOAD)

        def run(mod=mod, kw=kw, d=d):
            vm = mod.GuiViewModel(playlist_path=str(d / "playlist.json"), **kw)
            vm.mode, vm.symbol_rate = "QPSK", 4800
            vm.start_encode("g.bin").join(timeout=120)
            enc = _drain(vm)
            vm.start_decode(enc[-1][1][0]).join(timeout=120)
            dec = _drain(vm)
            return enc, dec, vm.playlist

        enc, dec, playlist = _in(d, run)
        assert enc[-1][0] == "encoded" and dec[-1][0] == "decoded", (enc, dec)
        assert not [e for e in enc + dec if e[0] == "error"]
        got[tag] = ([e[0] for e in enc], [e[0] for e in dec], playlist,
                    [open(os.path.join(d, p), "rb").read() for p in dec[-1][1]])
    assert got["t"] == got["j"]
    assert got["t"][3] == [_PAYLOAD]


def test_receive_session_48k_equals_jax(wav, tmp_path):
    """The WAV resampled to 48 kHz, 'recorded' by a FileRecorder: the
    session resamples back to 96 kHz and both save the payload."""
    x, sr = read_wav(wav)
    mic = str(tmp_path / "mic48k.wav")
    write_wav(mic, resample(x, sr, 48000), 48000)
    j = JSession("QPSK", 4800, JFileRecorder(mic), recv_dir=str(tmp_path / "j")).run(5.0)
    t = TSession("QPSK", 4800, TFileRecorder(mic), registry=TRegistry(journal_dir=""), recv_dir=str(tmp_path / "t"),
                 device="cpu").run(5.0)
    assert [open(p, "rb").read() for p in t] == [open(p, "rb").read() for p in j] == [_PAYLOAD]


def test_no_card_no_device_console_and_gui_fail(wav, tmp_path, monkeypatch, capsys):
    """Without a card and with no device named: the console app's decode
    raises with resolve_device's message; the GUI's decode, record and
    monitor workers each end in an ``("error", name, msg)`` event; nothing
    is saved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _console_run(tapp, tmp_path / "app", ["decode", wav, "QPSK", "4800", "quit"], monkeypatch, capsys)

    def gui():
        vm = tgui.GuiViewModel(playlist_path=str(tmp_path / "gui" / "playlist.json"))
        vm.mode, vm.symbol_rate = "QPSK", 4800
        out = []
        for start in (lambda: vm.start_decode(wav), lambda: vm.start_record(1.0, recorder=TFileRecorder(wav)),
                      lambda: vm.start_monitor(recorder=TFileRecorder(wav), poll_s=0.05)):
            start().join(timeout=60)
            out.append(_drain(vm, timeout=30))
        return out

    runs = _in(tmp_path / "gui", gui)
    for events, name in zip(runs, ("decode", "record", "monitor")):
        assert events[-1][:2] == ("error", name) and "is_available" in events[-1][2], events
        assert not [e for e in events if e[0] == "decoded"]
    for d in ("app", "gui"):
        assert not os.path.exists(tmp_path / d / "recv")


def test_main_device_option_reaches_the_console_app(tmp_path, monkeypatch, capsys):
    """``app.main`` and ``gui.main`` take ``--device``; without a display
    the GUI falls back to the console app on the same device."""
    monkeypatch.chdir(tmp_path)
    seen = []
    monkeypatch.setattr(tapp.ConsoleApp, "run", lambda self: seen.append(self.device))

    def no_display(*a, **k):
        raise RuntimeError("no display")

    monkeypatch.setattr(tgui, "FileBeepWindow", no_display)
    assert tapp.main(["--device", "cpu"]) == 0
    assert tgui.main(["--device", "cpu"]) == 0
    assert tgui.main([]) == 0
    assert seen == ["cpu", "cpu", None]
    assert "falling back to the console app" in capsys.readouterr().out
