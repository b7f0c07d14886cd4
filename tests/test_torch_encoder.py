"""The port's encoder (``encoder.py``) and streaming decoder
(``streaming.py``) vs the JAX package's, on the CPU: WAVs written by
``encode_file``, ``encode_file_paths`` and ``encode_file_parts`` for QPSK,
BPSK, FSK9600 and NEURAL under no FEC, ``reed_solomon``, ``convolutional``
and ``stream``; OFDM, DSSS and the Hellschreiber modes; the fallback ladder;
the throughput model; and ``StreamingDecoder``.

The modulated float waveforms are compared as the modulator tests compare
them: bit for bit for BPSK and NEURAL, within 1e-6 for QPSK and FSK9600
(``tests/test_torch_psk.py``, ``tests/test_torch_fsk.py``). The WAV files
then hold the same 16-bit samples, or samples at most one step apart where
a float difference under 1e-6 crosses a rounding boundary.
"""

import os

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import encoder as jenc
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu import streaming as jstream
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import crc32, pack_frame

from audio_modem_radio_tpu_torch import encoder as tenc
from audio_modem_radio_tpu_torch import streaming as tstream
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

_MODES = {"QPSK": 9600, "BPSK": 9600, "FSK9600": 9600, "NEURAL": 9600}
_BITWISE = {"BPSK", "NEURAL"}
_FECS = [None, "reed_solomon", "convolutional", "stream"]


@pytest.fixture
def waves(monkeypatch):
    """The float waveform each package's encoder hands to ``wav_from_array``,
    in call order: {"j": [...], "t": [...]}."""
    got = {"j": [], "t": []}
    for tag, mod in (("j", jenc), ("t", tenc)):
        real = mod.wav_from_array

        def record(arr, sr, _real=real, _tag=tag):
            got[_tag].append(np.asarray(arr, np.float32).copy())
            return _real(arr, sr)

        monkeypatch.setattr(mod, "wav_from_array", record)
    return got


def _compare(jpaths, tpaths, waves, mode):
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    assert len(waves["t"]) == len(waves["j"]) == len(jpaths)
    for a, b in zip(waves["t"], waves["j"]):
        assert a.shape == b.shape
        if mode in _BITWISE:
            assert np.array_equal(a, b)
        else:
            assert float(np.max(np.abs(a - b))) <= 1e-6
    for tp, jp in zip(tpaths, jpaths):
        t, j = open(tp, "rb").read(), open(jp, "rb").read()
        if mode in _BITWISE:
            assert t == j
        else:
            assert t[:44] == j[:44] and len(t) == len(j)
            diff = np.frombuffer(t[44:], np.int16).astype(np.int32) - np.frombuffer(j[44:], np.int16)
            assert int(np.max(np.abs(diff))) <= 1


def _file(tmp_path, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    # Half random, half repetitive: compression has something to do.
    data = rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes() + b"encoder test " * (n // 26)
    path = tmp_path / "src.bin"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("fec", _FECS)
@pytest.mark.parametrize("mode", list(_MODES))
def test_encode_file_equals_jax(tmp_path, waves, mode, fec):
    """One file, one WAV: compress, optional container or stream FEC,
    frame, modulate; the same WAV as the JAX encoder's."""
    src = _file(tmp_path, 600, len(mode))
    kw = dict(use_fec=fec is not None, fec_type=fec)
    jp = jenc.encode_file(src, mode, True, _MODES[mode], cache_dir=str(tmp_path / "j"), **kw)
    tp = tenc.encode_file(src, mode, True, _MODES[mode], cache_dir=str(tmp_path / "t"), **kw)
    _compare([jp], [tp], waves, mode)


@pytest.mark.parametrize("fec", ["stream", "convolutional"])
@pytest.mark.parametrize("mode", ["QPSK", "NEURAL"])
def test_encode_file_paths_and_parts_equal_jax(tmp_path, waves, mode, fec):
    """The multi-part paths: ``encode_file_paths`` with a target duration of
    0 minutes (a part a byte: two parts, each too short for the 0.1 s
    check, so the BPSK fallback) and ``encode_file_parts`` over the parts of
    ``split_file_for_transmission`` at 1 s on air; the same parts and the
    same WAVs, with progress reported the same."""
    src = _file(tmp_path, 5, 3)
    kw = dict(use_fec=True, fec_type=fec)
    progress = {"j": [], "t": []}
    jp = jenc.encode_file_paths(src, mode, True, 9600, True, 0, lambda i, n: progress["j"].append((i, n)),
                                cache_dir=str(tmp_path / "j"), **kw)
    tp = tenc.encode_file_paths(src, mode, True, 9600, True, 0, lambda i, n: progress["t"].append((i, n)),
                                cache_dir=str(tmp_path / "t"), **kw)
    assert len(tp) == len(jp) == 2 and progress["t"] == progress["j"] == [(1, 2), (2, 2)]
    _compare(jp, tp, waves, mode)
    src = _file(tmp_path, 9000, 4)
    parts = tenc.split_file_for_transmission(src, mode, 9600, 1)
    assert parts == jenc.split_file_for_transmission(src, mode, 9600, 1) and len(parts) > 1
    waves["j"].clear()
    waves["t"].clear()
    jp = jenc.encode_file_parts(parts, mode, True, 9600, cache_dir=str(tmp_path / "jp"), **kw)
    tp = tenc.encode_file_parts(parts, mode, True, 9600, cache_dir=str(tmp_path / "tp"), **kw)
    _compare(jp, tp, waves, mode)


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


@pytest.mark.parametrize("mode,rate,size", [("OFDM4", 1200, 700), ("OFDM8", 1200, 1300), ("DSSS", 9600, 100),
                                            ("HELLSCHREIBER", 9600, 30), ("SLOW_HELL", 9600, 16)])
def test_unported_modes_raise_and_are_never_encoded_as_another(tmp_path, waves, mode, rate, size):
    """The modes the port once refused (ROADMAP.md queue 1, items 4-6) now
    encode as the JAX package's, on the single-file and the multi-part
    path (a file of two or three parts at 1 s on air), each as itself (never as
    QPSK or BPSK: the same WAVs within the QPSK tolerance);
    ``encode_hellschreiber_text`` writes the JAX package's WAV. (The name
    dates from when they raised NotImplementedError.)"""
    src = _file(tmp_path, size, 5)
    jp = jenc.encode_file(src, mode, True, rate, cache_dir=str(tmp_path / "j"))
    tp = tenc.encode_file(src, mode, True, rate, cache_dir=str(tmp_path / "t"))
    _compare([jp], [tp], waves, mode)
    parts = tenc.split_file_for_transmission(src, mode, rate, 1)
    assert parts == jenc.split_file_for_transmission(src, mode, rate, 1) and len(parts) > 1
    waves["j"].clear()
    waves["t"].clear()
    jp = jenc.encode_file_parts(parts, mode, True, rate, cache_dir=str(tmp_path / "jp"))
    tp = tenc.encode_file_parts(parts, mode, True, rate, cache_dir=str(tmp_path / "tp"))
    _compare(jp, tp, waves, mode)
    waves["j"].clear()
    waves["t"].clear()
    jh = jenc.encode_hellschreiber_text("CQ", cache_dir=str(tmp_path / "jh"))
    th = tenc.encode_hellschreiber_text("CQ", cache_dir=str(tmp_path / "th"))
    _compare([jh], [th], waves, "HELLSCHREIBER")


@pytest.mark.parametrize("mode,key", [("OFDM4", "ofdm_compat_alias"), ("DSSS", "dsss_compat_alias")])
def test_alias_modes_encode_like_jax(tmp_path, waves, configs, mode, key):
    """Under their compatibility aliases DSSS (DBPSK) and OFDM4 (DQPSK at
    12 kHz) encode, with the JAX registry's throughput for the split."""
    configs("modem", key, True)
    src = _file(tmp_path, 400, 6)
    assert tenc.calculate_transmission_stats(4000, mode, 9600) == jenc.calculate_transmission_stats(4000, mode, 9600)
    jp = jenc.encode_file(src, mode, True, 9600, cache_dir=str(tmp_path / "j"))
    tp = tenc.encode_file(src, mode, True, 9600, cache_dir=str(tmp_path / "t"))
    _compare([jp], [tp], waves, "BPSK" if mode == "DSSS" else "QPSK")


@pytest.mark.parametrize("failure", ["invalid", "raises", "bpsk too", "unknown mode"])
def test_fallback_ladder_equals_jax(tmp_path, waves, monkeypatch, failure):
    """The fallback ladder with a modulator that returns silence or raises
    (BPSK at min(rate, 4800) on 3 kHz), with BPSK silenced too (the 1 kHz
    test tone), and an unknown mode name (encoded as QPSK): the same WAVs
    as the JAX encoder's."""
    for mod in (jenc, tenc):
        if failure in ("invalid", "bpsk too"):
            monkeypatch.setattr(mod, "modulate", lambda m, f, r: np.zeros(4000, np.float32))
        elif failure == "raises":
            def boom(m, f, r):
                raise RuntimeError("modulator failure")

            monkeypatch.setattr(mod, "modulate", boom)
        if failure == "bpsk too":
            monkeypatch.setattr(mod, "bpsk_modulate", lambda *a, **k: np.zeros(10, np.float32))
    mode = "NO_SUCH_MODE" if failure == "unknown mode" else "QPSK"
    src = _file(tmp_path, 300, 7)
    jp = jenc.encode_file(src, mode, True, 9600, cache_dir=str(tmp_path / "j"))
    tp = tenc.encode_file(src, mode, True, 9600, cache_dir=str(tmp_path / "t"))
    _compare([jp], [tp], waves, "QPSK" if failure == "unknown mode" else "BPSK")


def test_throughput_model_and_helpers_equal_jax(tmp_path):
    """``calculate_transmission_stats`` for every mode name of the JAX
    registry (and an unknown one), ``get_encoding_stats``,
    ``split_file_for_transmission``, ``verify_audio_output`` and the
    signature cache."""
    for mode in list(jmodem.MODES) + ["NO_SUCH_MODE"]:
        for rate in (1200, 9600):
            assert tenc.calculate_transmission_stats(12345, mode, rate, True) == \
                jenc.calculate_transmission_stats(12345, mode, rate, True), mode
    src = _file(tmp_path, 3000, 8)
    assert tenc.get_encoding_stats(src, "FSK1200", True, 1200) == jenc.get_encoding_stats(src, "FSK1200", True, 1200)
    assert tenc.split_file_for_transmission(src, "FT8", 50, 30) == jenc.split_file_for_transmission(src, "FT8", 50, 30)
    for arr in (None, np.zeros(0), np.zeros(9600), np.full(9600, 0.5), np.full(9600, 2.0),
                np.sin(np.arange(20000) / 7.0), np.sin(np.arange(500) / 7.0)):
        assert tenc.verify_audio_output(arr) == jenc.verify_audio_output(arr)
    assert tenc.get_file_signature(src, "QPSK", True, 9600) == jenc.get_file_signature(src, "QPSK", True, 9600)
    tenc.cancel_encoding()
    with pytest.raises(RuntimeError, match="cancelled"):
        tenc.encode_file_parts(tenc.split_file_for_transmission(src, "QPSK", 9600), "QPSK", True, 9600,
                               cache_dir=str(tmp_path / "c"))
    tenc.reset_encoding_cancel()
    tenc.clear_encoding_cache()


def test_streaming_decoder_saves_what_jax_saves(tmp_path):
    """Two frames fed in uneven chunks through 2^16-sample windows with half
    overlap, one frame straddling a window boundary: the same files saved,
    each once, as the JAX ``StreamingDecoder``."""
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, 400, dtype=np.uint8).tobytes() for _ in range(2)]
    x = np.zeros(150000, np.float32)
    for i, (p, lead) in enumerate(zip(payloads, (5000, 60000))):
        w = np.asarray(jmodem.modulate("QPSK", pack_frame(f"s{i}.bin", p, 0, 1, len(p), crc32(p)), 9600))
        x[lead : lead + len(w)] = w
    saved = {}
    for tag, cls, reg, kw in (("j", jstream.StreamingDecoder, JRegistry(journal_dir=""), {}),
                              ("t", tstream.StreamingDecoder, TRegistry(journal_dir=""), {"device": "cpu"})):
        dec = cls("QPSK", 9600, window=1 << 16, recv_dir=str(tmp_path / tag), registry=reg, **kw)
        out = []
        for a, b in ((0, 30000), (30000, 101000), (101000, 150000)):
            out += dec.feed(x[a:b])
        out += dec.flush()
        assert out == dec.saved_files and dec.pending == 0
        saved[tag] = sorted(open(p, "rb").read() for p in out)
    assert saved["t"] == saved["j"] == sorted(payloads)
