"""The port's host modules (``ptt``, ``observability``, ``intelligence``,
``audio_io``) against the JAX package's, on the CPU, and the port's one
logger name.

* ``intelligence``: the profile tables equal; ``estimate_snr`` on seeded
  captures equal to 1e-12 relative; ``recommend_mode`` and
  ``intelligent_encode_setup`` equal over an SNR grid x the three
  priorities, with and without CONFIG ``intelligence.compat_profiles``;
* ``ptt``: the ``SimulatedPort`` transition sequences equal (timestamps
  aside), the null ports no-ops in both;
* ``observability``: ``AnalyticsStore`` files round-trip between the
  packages; ``PerformanceMonitor`` lists the CUDA cards torch sees and,
  with none, no device;
* ``audio_io``: ``FileRecorder`` reads the same samples; ``ReceiveSession``
  raises without a card when no device is named;
* logging: ``setup_logging``'s file receives the assembly's warning and
  the decoder's messages, and every port module logs under one name.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import intelligence as jint
from audio_modem_radio_tpu import observability as jobs
from audio_modem_radio_tpu import ptt as jptt
from audio_modem_radio_tpu.config import CONFIG as JCONFIG

from audio_modem_radio_tpu_torch import intelligence as tint
from audio_modem_radio_tpu_torch import observability as tobs
from audio_modem_radio_tpu_torch import ptt as tptt
from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


def _captures():
    """Seeded captures: noise, tones in noise, a modulated burst at several
    SNRs, silence, a DC offset and one too short to estimate."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate

    rng = np.random.default_rng(23)
    p = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    wave = modulate("QPSK", pack_frame("s.bin", p, 0, 1, len(p), crc32(p)), 9600)
    t = np.arange(40000) / 96000
    out = {"noise": rng.normal(0, 0.3, 30000), "silence": np.zeros(5000), "dc": np.full(4000, 0.25),
           "short": rng.normal(0, 1, 999), "tone": np.sin(2 * np.pi * 1500 * t) + rng.normal(0, 0.05, len(t))}
    for snr in (-5, 5, 15, 30):
        sigma = np.sqrt(np.mean(wave.astype(np.float64) ** 2) / 10 ** (snr / 10))
        out[f"qpsk{snr}"] = (wave + rng.normal(0, sigma, len(wave))).astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["REFERENCE_MODE_PROFILES", "MEASURED_MIN_SNR", "_DESIGN_BPS", "MODE_PROFILES",
                                  "_MODE_CONFIGS"])
def test_intelligence_tables_equal_jax(name):
    assert getattr(tint, name) == getattr(jint, name)


def test_estimate_snr_equals_jax():
    for name, x in _captures().items():
        got, want = tint.ChannelAnalyzer.estimate_snr(x), jint.ChannelAnalyzer.estimate_snr(x)
        assert abs(got - want) <= 1e-12 * abs(want), name
    assert tint.ChannelAnalyzer.estimate_snr(None) == jint.ChannelAnalyzer.estimate_snr(None) == 25.0
    cond_t, cond_j = tint.analyze_channel(_captures()["qpsk5"]), jint.analyze_channel(_captures()["qpsk5"])
    cond_t.pop("timestamp"), cond_j.pop("timestamp")
    assert cond_t == cond_j


@pytest.mark.parametrize("compat", [False, True])
def test_recommend_mode_equals_jax(compat):
    old_t, old_j = TCONFIG.get("intelligence.compat_profiles"), JCONFIG.get("intelligence.compat_profiles")
    TCONFIG.set("intelligence.compat_profiles", compat)
    JCONFIG.set("intelligence.compat_profiles", compat)
    try:
        picked = set()
        for snr in np.arange(-15.0, 45.0, 0.5):
            for priority in ("robustness", "speed", "balanced"):
                cond = {"snr_db": float(snr)}
                got = tint.get_recommended_mode(cond, priority)
                assert got == jint.get_recommended_mode(cond, priority), (snr, priority)
                assert tint.intelligent_encode_setup(0, priority, cond) == jint.intelligent_encode_setup(
                    0, priority, cond)
                picked.add(got)
        assert len(picked) >= (2 if compat else 4)
        assert tint.get_recommended_mode({}) == jint.get_recommended_mode({})
    finally:
        TCONFIG.set("intelligence.compat_profiles", old_t)
        JCONFIG.set("intelligence.compat_profiles", old_j)


def _ptt_run(mod, method: str, port: str):
    """Key and un-key through PTTContext on a recording SimulatedPort:
    the (rts, dtr) transitions, the keyed flag inside and after."""
    mgr = mod.PTTManager(pre_tx_delay=0.0)
    sims = []

    def opened():
        sims.append(mod.SimulatedPort())
        return sims[-1]

    mgr._open = opened
    with mod.PTTContext(port, method, controller=mgr):
        keyed = mgr.is_keyed
    return [(r, d) for _, r, d in (sims[0].events if sims else [])], keyed, mgr.is_keyed, [s.is_open for s in sims]


@pytest.mark.parametrize("port", ["SIM", "/dev/ttyUSB9", None, "", "Nenhuma", "None", "none"])
@pytest.mark.parametrize("method", ["RTS", "DTR"])
def test_ptt_transitions_equal_jax(method, port):
    got, want = _ptt_run(tptt, method, port), _ptt_run(jptt, method, port)
    assert got == want
    if port in ("SIM", "/dev/ttyUSB9"):
        assert got[0] and got[1] and not got[2]


def test_ptt_constants_and_ports_equal_jax():
    assert tptt._NULL_PORTS == jptt._NULL_PORTS and tptt.PRE_TX_DELAY_S == jptt.PRE_TX_DELAY_S
    assert tptt.SERIAL_AVAILABLE == jptt.SERIAL_AVAILABLE
    assert tptt.PTTManager.get_available_ports() == jptt.PTTManager.get_available_ports()
    sim_t, sim_j = tptt.SimulatedPort("X"), jptt.SimulatedPort("X")
    for s in (sim_t, sim_j):
        s.rts = True
        s.dtr = True
        s.rts = False
        s.close()
    assert [e[1:] for e in sim_t.events] == [e[1:] for e in sim_j.events]
    assert sim_t.is_open == sim_j.is_open is False


def test_analytics_store_round_trips_between_packages(tmp_path):
    t = tobs.AnalyticsStore(str(tmp_path / "t.json"))
    j = jobs.AnalyticsStore(str(tmp_path / "j.json"))
    for s in (t, j):
        s.record_encode("QPSK", 1000)
        s.record_decode("QPSK", 900)
        s.record_decode("FSK1200", 0, ok=False)
        s.record_encode("OFDM8", 0, ok=False)
        s.record_metric("demod_msps", 4700.0)
        s.save()
    ft, fj = json.load(open(tmp_path / "t.json")), json.load(open(tmp_path / "j.json"))
    assert ft.pop("session_start") > 0 and fj.pop("session_start") > 0
    assert ft == fj
    # Each package reads the other's file.
    a, b = jobs.AnalyticsStore(str(tmp_path / "t.json")), tobs.AnalyticsStore(str(tmp_path / "j.json"))
    a.data.pop("session_start"), b.data.pop("session_start")
    assert a.data == b.data == ft


def test_log_manager_rotates_like_jax(tmp_path):
    for tag, mod in (("t", tobs), ("j", jobs)):
        path = tmp_path / f"{tag}.log"
        path.write_text("x" * 200)
        lm = mod.LogManager(str(path), max_bytes=100)
        assert lm.should_rotate()
        rotated = lm.rotate()
        assert rotated and os.path.exists(rotated) and not path.exists()
        assert mod.LogManager(str(path), max_bytes=100).rotate() is None


def test_performance_monitor_lists_the_cards_not_the_host(monkeypatch):
    info, ref = tobs.PerformanceMonitor().sample(), jobs.PerformanceMonitor().sample()
    assert set(ref) - {"devices"} <= set(info)
    want = [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    assert info["devices"] == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tobs.PerformanceMonitor().sample()["devices"] == []


def test_file_recorder_and_receive_session_device(tmp_path, monkeypatch):
    from audio_modem_radio_tpu.audio_io import FileRecorder as JRec
    from audio_modem_radio_tpu.utils.wavio import write_wav

    from audio_modem_radio_tpu_torch.audio_io import FileRecorder as TRec, ReceiveSession

    x = np.random.default_rng(3).normal(0, 0.2, 48000).astype(np.float32)
    write_wav(str(tmp_path / "r.wav"), x, 48000)
    t, j = TRec(str(tmp_path / "r.wav")), JRec(str(tmp_path / "r.wav"))
    assert t.sample_rate == j.sample_rate == 48000
    assert np.array_equal(t.record(0.5), j.record(0.5))
    assert np.array_equal(t.drain(), j.drain()) and len(t.drain()) == len(j.drain()) == 0
    assert ReceiveSession("QPSK", 9600, t, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ReceiveSession("QPSK", 9600, t)


def test_one_logger_name_reaches_the_log_file(tmp_path, monkeypatch):
    """``setup_logging``'s file receives the assembly's warning and the
    decoder's messages, as the JAX package's does; framing, assembly,
    decoder, encoder, FEC, streaming, batch and the host modules all log
    under ``LOGGER_NAME``."""
    monkeypatch.chdir(tmp_path)
    from audio_modem_radio_tpu_torch import assembly, audio_io, decoder, encoder, fec, framing, native, streaming
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.framing import Frame
    from audio_modem_radio_tpu_torch.parallel import batch

    assert tobs.LOGGER_NAME == "audio_modem_radio_tpu_torch"
    named = logging.getLogger(tobs.LOGGER_NAME)
    for mod in (assembly, audio_io, decoder, encoder, fec, framing, native, streaming, batch, tptt):
        assert mod.logger is named, mod.__name__
    log_file = str(tmp_path / "amr.log")
    logger = tobs.setup_logging(log_file=log_file, console=False)
    try:
        AssemblyRegistry(journal_dir="").offer(Frame("bad.bin", b"x", 0, 0, 1, 0))
        x = np.random.default_rng(1).normal(0, 0.2, 20000).astype(np.float32)
        assert decoder.decode_from_buffer(x, "QPSK", 9600, recv_dir=str(tmp_path / "r"),
                                          registry=AssemblyRegistry(journal_dir=""), device="cpu") == []
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()
    text = open(log_file, encoding="utf-8").read()
    assert "logging initialized" in text
    assert "WARNING - rejecting frame bad.bin with absurd total_parts=0" in text
    assert "INFO - demodulated " in text
