"""The port's single-capture PSK receive vs the JAX package's, on the CPU:
``psk_demod_streams`` / ``psk_symbol_streams``, ``modem.demodulate`` with
the coherent escalation and the 8PSK alias probe, the no-sync rescue
streams, ``decode_from_buffer`` / ``decode_wav_file`` / ``decode_with_retry``
through the recovery ladder, and the batched escape (short captures, rates
under 3000 Bd, PSK31), the staged D8PSK path under CONFIG
``tpu.demod_backend = "xla"`` and ``decode_wav_batch``'s escalations.

Captures are made with numpy from seeds, 2^16 samples each (PSK31: one
short frame), built once per module and handed to both packages as numpy
arrays. Float streams agree within 1e-5 of their RMS (summation order);
byte streams are equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames
from audio_modem_radio_tpu.ops import psk as jpsk
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.utils.compression import intelligent_compress

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N = 1 << 16
_CARRIER = {"QPSK": 3000.0, "BPSK": 3000.0, "8PSK": 12000.0, "APSK16": 12000.0, "SSTV": 3000.0}
_MODULATE = {"QPSK": jpsk.qpsk_modulate, "BPSK": jpsk.bpsk_modulate, "8PSK": jpsk.psk8_real_modulate}
# AWGN SNR (dB over the wave's power) and seed at which differential
# detection loses the frame and the tracked escalation runs.
_NOISY = {"QPSK": (8.5, 0), "BPSK": (3.5, 1), "8PSK": (10.5, 0)}


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


def _framed(seed: int, n_bytes: int = 600, name: str = "s.bin") -> tuple:
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return p, pack_frame(name, p, 0, 1, len(p), crc32(p))


def _place(wave, n: int = N, lead: int = 211) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = np.asarray(wave, np.float32)[: n - lead]
    return x


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    sig = x[np.abs(x) > 0]
    sigma = np.sqrt(np.mean(sig ** 2) / 10 ** (snr_db / 10))
    return (x + np.random.default_rng(seed).normal(0, sigma, len(x))).astype(np.float32)


@pytest.fixture(scope="module")
def captures():
    """name -> (capture, payload or None)."""
    out = {}
    for i, mode in enumerate(("BPSK", "QPSK", "8PSK", "APSK16", "SSTV")):
        p, fr = _framed(10 + i)
        out[f"{mode} clean"] = (_place(jmodem.modulate(mode, fr, 9600)), p)
        if mode in _MODULATE:
            out[f"{mode} +60Hz"] = (_place(_MODULATE[mode](fr, 9600, _CARRIER[mode] + 60.0)), p)
            snr, seed = _NOISY[mode]
            out[f"{mode} noisy"] = (_awgn(out[f"{mode} clean"][0], snr, seed), p)
            out[f"{mode} noise"] = (np.random.default_rng(20 + i).normal(0, 0.3, N).astype(np.float32), None)
    p, fr = _framed(30)
    out["8PSK alias"] = (_place(jpsk.qpsk_modulate(fr, 9600, 12000.0)), p)
    p, fr = _framed(31, 4, "p.txt")
    wave = jmodem.modulate("PSK31", fr, 31)
    out["PSK31 clean"] = (_place(wave, len(wave) + 5000, 1500), p)
    return out


def _frames(raw: bytes):
    return [(f.name, f.part_number, f.data) for f in parse_frames(raw)]


# --- the front end -------------------------------------------------------------

@pytest.mark.parametrize("baud", [9600, 3000, 1200, 31.25])
def test_demod_and_symbol_streams_match_jax(baud):
    """psk_demod_streams (K11's path at spsym 10 and 32, the template pair
    at 80 and 3072) and psk_symbol_streams: equal length, within 1e-5 of the
    stream's RMS, and the same winning score."""
    p, fr = _framed(40, 300 if baud > 100 else 2)
    wave = jpsk.bpsk_modulate(fr, baud, 3000.0)
    x = _place(wave, N if baud > 100 else len(wave) + 4000, 77)
    for fn in ("psk_demod_streams", "psk_symbol_streams"):
        ref = [np.asarray(a) for a in getattr(jpsk, fn)(jnp.asarray(x), float(baud), 3000.0, SR)]
        got = [a.numpy() for a in getattr(tpsk, fn)(torch.from_numpy(x), float(baud), 3000.0, SR)]
        assert got[0].shape == ref[0].shape == got[1].shape, fn
        rms = np.sqrt(np.mean(ref[0] ** 2 + ref[1] ** 2))
        assert max(np.max(np.abs(g - r)) for g, r in zip(got[:2], ref[:2])) <= 1e-5 * rms, fn
        assert abs(float(got[2]) - float(ref[2])) <= 1e-5 * abs(float(ref[2])), fn


# --- modem.demodulate ----------------------------------------------------------

@pytest.mark.parametrize("name", ["BPSK clean", "QPSK clean", "8PSK clean", "APSK16 clean", "SSTV clean",
                                  "PSK31 clean", "BPSK +60Hz", "QPSK +60Hz", "8PSK +60Hz",
                                  "BPSK noise", "QPSK noise", "8PSK noise"])
def test_demodulate_byte_equal(captures, name):
    mode = name.split()[0]
    x, payload = captures[name]
    rate = 31 if mode == "PSK31" else 9600
    ref = jmodem.demodulate(mode, x, rate)
    got = tmodem.demodulate(mode, x, rate, device="cpu")
    assert got == ref
    assert [f[2] for f in _frames(got)] == ([payload] if payload is not None else [])


@pytest.mark.parametrize("mode", ["BPSK", "QPSK", "8PSK"])
def test_noisy_capture_escalates_to_the_tracked_receiver(captures, mode, monkeypatch):
    """Differential detection loses the frame; the tracked receiver runs in
    both packages and recovers it. Streams may differ only where a decision
    sits within rounding of a boundary; the parsed frames are equal."""
    x, payload = captures[f"{mode} noisy"]
    calls = []
    name = {"BPSK": "bpsk_tracked_demodulate", "QPSK": "qpsk_tracked_demodulate",
            "8PSK": "psk8_tracked_demodulate"}[mode]
    real = getattr(tmodem, name)
    monkeypatch.setattr(tmodem, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    ref = jmodem.demodulate(mode, x, 9600)
    got = tmodem.demodulate(mode, x, 9600, device="cpu")
    assert calls == [1]
    assert _frames(got) == _frames(ref) and [f[2] for f in _frames(got)] == [payload]
    direct = {"BPSK": tpsk.bpsk_demodulate, "QPSK": tpsk.qpsk_demodulate,
              "8PSK": tpsk.psk8_real_demodulate}[mode](x, 9600, _CARRIER[mode], device="cpu")
    assert _frames(direct) == []


def test_8psk_alias_flag_and_probe_match_jax(captures, configs):
    """An alias-format capture decodes through the alias probe with the flag
    off, and directly with CONFIG modem.psk8_compat_alias on."""
    x, payload = captures["8PSK alias"]
    for flag in (False, True):
        configs("modem", "psk8_compat_alias", flag)
        got = tmodem.demodulate("8PSK", x, 9600, device="cpu")
        assert got == jmodem.demodulate("8PSK", x, 9600)
        assert [f[2] for f in _frames(got)] == [payload]


def test_demodulate_unknown_and_unported_modes():
    """Unknown modes fall back to QPSK; OFDM4, DSSS and HELLSCHREIBER (once
    refused, ROADMAP.md queue 1 items 4-6) and FSK1200 demodulate a silent
    capture as the JAX package does."""
    x = np.zeros(N, np.float32)
    assert tmodem.demodulate("NOPE", x, 9600, device="cpu") == tmodem.demodulate("QPSK", x, 9600, device="cpu")
    for mode in ("OFDM4", "DSSS", "HELLSCHREIBER"):
        assert tmodem.demodulate(mode, x, 9600, device="cpu") == jmodem.demodulate(mode, x, 9600), mode
    assert tmodem.demodulate("FSK1200", x, 1200, device="cpu") == jmodem.demodulate("FSK1200", x, 1200)


@pytest.mark.parametrize("name", ["BPSK noisy", "QPSK +60Hz", "8PSK +60Hz"])
def test_nosync_streams_match_jax(captures, name):
    """The no-sync rescue fronts: every stream byte-equal. (DBPSK's im
    stream carries signal only off the real axis, so it is compared on the
    noisy capture, where noise sets its signs.)"""
    mode = name.split()[0]
    x, _ = captures[name]
    if mode == "8PSK":
        ref = jpsk.psk8_nosync_streams(x, 9600, _CARRIER[mode], SR)
        got = tpsk.psk8_nosync_streams(x, 9600, _CARRIER[mode], SR, device="cpu")
        assert len(got) == 8
    else:
        n_psk = 2 if mode == "BPSK" else 4
        ref = jpsk.psk_nosync_streams(x, 9600, _CARRIER[mode], SR, n_psk)
        got = tpsk.psk_nosync_streams(x, 9600, _CARRIER[mode], SR, n_psk, device="cpu")
        assert len(got) == (2 if mode == "BPSK" else 1)
    if mode == "BPSK":  # the im stream: decisions within rounding of 0 may flip
        g, r = (np.unpackbits(np.frombuffer(s, np.uint8)) for s in (got[1], ref[1]))
        assert len(g) == len(r) and np.sum(g != r) <= 2
        got, ref = got[:1], ref[:1]
    assert got == ref


# --- the decoder -----------------------------------------------------------------

def _read_all(paths):
    return sorted(open(p, "rb").read() for p in paths)


def _compressed_frame(data: bytes, name: str, flip_magic_bit: int = -1) -> bytes:
    blob = intelligent_compress(data)
    fr = bytearray(pack_frame(name, blob, 0, 1, len(data), crc32(data)))
    if flip_magic_bit >= 0:
        fr[flip_magic_bit // 8] ^= 0x80 >> (flip_magic_bit % 8)
    return bytes(fr)


@pytest.mark.parametrize("mode,flip", [("QPSK", -1), ("8PSK", -1), ("QPSK", 21), ("BPSK", 5)])
def test_decode_from_buffer_and_wav_file_save_the_same(tmp_path, mode, flip):
    """Strict parse (flip -1) and the header-tolerant rung: one flipped bit in
    the magic's validation half (21) or its sync half (5, where the
    demodulator packs from offset 0 and the bit-shift sweep finds it)."""
    data = bytes(f"single {mode} {flip} ".encode()) * 20
    x = _place(jmodem.modulate(mode, _compressed_frame(data, "f.bin", flip), 9600), N, 95)
    ref = jdec.decode_from_buffer(x, mode, 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    got = tdec.decode_from_buffer(x, mode, 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                  device="cpu")
    assert _read_all(got) == _read_all(ref) == [data]
    wav = str(tmp_path / "c.wav")
    write_wav(wav, x)
    got = tdec.decode_wav_file(wav, mode, 9600, recv_dir=str(tmp_path / "tw"), registry=TRegistry(),
                               device="cpu")
    assert _read_all(got) == [data]


def test_decode_from_buffer_noise_saves_nothing(tmp_path, captures):
    x, _ = captures["QPSK noise"]
    assert jdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry()) == []
    assert tdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                   device="cpu") == []


def _drift(samples: np.ndarray, factor: float) -> np.ndarray:
    """A TX clock fast by ``factor``: the waveform read at stride ``factor``."""
    n = len(samples)
    dst = np.arange(int(n / factor), dtype=np.float64) * factor
    return np.interp(dst, np.arange(n, dtype=np.float64), samples).astype(np.float32)


def test_decode_with_retry_recovers_clock_drift(tmp_path):
    data = b"drifted clock " * 30
    x = _drift(_place(jmodem.modulate("QPSK", _compressed_frame(data, "d.bin"), 4800), N, 50), 1.05)
    assert tdec.decode_from_buffer(x, "QPSK", 4800, recv_dir=str(tmp_path / "n"), registry=TRegistry(),
                                   device="cpu") == []
    ref = jdec.decode_with_retry(x, "QPSK", 4800, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    got = tdec.decode_with_retry(x, "QPSK", 4800, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                 device="cpu")
    assert _read_all(got) == _read_all(ref) == [data]
    assert sorted(f for f in os.listdir(tmp_path / "t") if f.startswith("demodulated_attempt_")) == [
        "demodulated_attempt_1.bin", "demodulated_attempt_2.bin", "demodulated_attempt_3.bin"]


@pytest.mark.parametrize("mode,n", [("QPSK", 0), ("QPSK", 1), ("QPSK", 50), ("QPSK", 5000), ("BPSK", 0),
                                    ("BPSK", 1), ("8PSK", 0), ("8PSK", 1), ("NEURAL", 0), ("NEURAL", 1)])
def test_decode_with_retry_degenerate_captures_save_nothing(tmp_path, mode, n):
    """Captures too short to batch (the drift dispatch raises on them) fall
    back to one single-capture decode per hypothesis and save nothing, in
    both packages."""
    x = np.zeros(n, np.float32)
    assert jdec.decode_with_retry(x, mode, 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry()) == []
    assert tdec.decode_with_retry(x, mode, 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                  device="cpu") == []


def test_decode_with_retry_fallback_keeps_not_implemented(tmp_path):
    """One-sample DSSS and FSK9600 captures, too short for every attempt,
    save nothing in both packages. (The name dates from when the port
    re-raised its refusal of DSSS, ROADMAP.md queue 1 item 5.)"""
    x = np.zeros(1, np.float32)
    for mode in ("DSSS", "FSK9600"):
        assert jdec.decode_with_retry(x, mode, 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry()) == []
        assert tdec.decode_with_retry(x, mode, 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                      device="cpu") == []


def test_save_decoded_files_damaged_fec_frames_left_unsaved(tmp_path):
    """Damaged frames are attempted through FEC exactly where their payload
    carries an FEC container, as in the JAX package: a damaged ``FECV``
    container whose payload took bit errors decodes and saves, a damaged
    ``FECP`` container saves its parity decode, and a damaged frame without
    a container is left unsaved; the saved files and the registry stats
    (``fec_recovery_attempts``, ``success_rate``) equal the JAX
    package's. (The name dates from when the port left every FEC-tagged
    frame unsaved; only the damaged frame without a container is now.)"""
    from audio_modem_radio_tpu.fec import wrap_fec
    from audio_modem_radio_tpu.framing import Frame as JFrame
    from audio_modem_radio_tpu_torch.framing import Frame

    good = (b"good", intelligent_compress(b"good"))
    fecv = bytearray(wrap_fec(intelligent_compress(b"viterbi " * 30), "convolutional"))
    for i in (90, 300, 777):
        fecv[i // 8] ^= 0x80 >> (i % 8)
    fecp = wrap_fec(intelligent_compress(b"parity " * 20), "reed_solomon")
    damaged = [("x.bin", bytes(fecv)), ("p.bin", fecp), ("y.bin", b"\x01" * 20)]
    saved = {}
    for tag, frame_cls, save, reg, kw in (
        ("j", JFrame, jdec.save_decoded_files, JRegistry(journal_dir=""), {}),
        ("t", Frame, tdec.save_decoded_files, TRegistry(journal_dir=""), {"device": "cpu"}),
    ):
        out = save([frame_cls("g.bin", good[1], 0, 1, 4, crc32(b"good"))], str(tmp_path / tag), reg,
                   damaged=[frame_cls(n, d, 0, 1, len(d), 0) for n, d in damaged], **kw)
        saved[tag] = (_read_all(out), {k: v for k, v in reg.stats.items() if k != "last_reception"})
    assert saved["t"] == saved["j"]
    assert saved["t"][0] == sorted([b"good", b"viterbi " * 30, b"parity " * 20])
    assert saved["t"][1]["fec_recovery_attempts"] == 2 and saved["t"][1]["success_rate"] == 100.0


def test_ladder_refuses_unported_rungs(tmp_path):
    """The rungs that raised before FEC was ported now run as in the JAX
    package: ``run_recovery_ladder(stream_fec=True)`` on an empty stream
    and ``decode_from_buffer(denoise=True)`` on a silent capture return
    what the JAX package's return (nothing), and raise nothing. (The name
    dates from when the port refused these rungs.)"""
    x = np.zeros(10, np.float32)
    got = tdec.run_recovery_ladder(b"", x, "QPSK", 9600, stream_fec=True, device="cpu")
    assert got == jdec.run_recovery_ladder(b"", x, "QPSK", 9600, stream_fec=True) == ([], [], True, (0, 0, 0))
    x = np.zeros(N, np.float32)
    assert tdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                   denoise=True, device="cpu") == []
    assert jdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry(),
                                   denoise=True) == []


# --- the batched escape, the xla backend and decode_wav_batch ---------------------

def _short_batch(mode: str, rate: int, n: int, seed: int):
    rows, payloads = [], []
    for i in range(2):
        p, fr = _framed(seed + i, 20 if rate < 100 else 40 + 30 * i, f"b{i}.bin")
        wave = jmodem.modulate(mode, fr, rate)
        rows.append(_place(wave, n, 300 + 7 * i))
        payloads.append(p)
    return np.stack(rows), payloads


@pytest.mark.parametrize("mode,rate,n", [("QPSK", 9600, 2000), ("BPSK", 9600, 2400), ("QPSK", 1200, N),
                                          ("BPSK", 2400, N), ("PSK31", 31, None)])
def test_decode_sample_batch_escape_matches_jax(mode, rate, n):
    """Captures under 256 symbols, rates under 3000 Bd (spsym over 32) and
    PSK31 have no blocked path: per capture the single-capture receiver
    (K11 or the template pair), the 3-window rotation and the decision, then
    the per-capture sync tails. Bytes equal within n_valid."""
    if mode == "PSK31":
        p, fr = _framed(50, 2, "q.txt")
        wave = jmodem.modulate("PSK31", fr, 31)
        batch = np.stack([_place(wave, len(wave) + 3100, 10), np.zeros(len(wave) + 3100, np.float32)])
        payloads = [p, None]
    elif n < 5000:  # one frame does not fit: a shortened frame, or noise
        batch = np.stack([_place(jmodem.modulate(mode, _framed(51, 1, "t")[1], rate), n, 3),
                          np.random.default_rng(52).normal(0, 0.3, n).astype(np.float32)])
        payloads = [None, None]
    else:
        batch, payloads = _short_batch(mode, rate, n, 53)
    got = tb.decode_sample_batch(batch, mode, rate, device="cpu")
    ref = jb.decode_sample_batch(batch, mode, rate)
    assert got == ref
    if n is None or n >= 5000:
        assert [[f[2] for f in _frames(r)] for r in got] == [[p] if p else [] for p in payloads]


def test_psk_decision_streams_escape_matches_jax():
    batch = np.stack([_place(jmodem.modulate("QPSK", _framed(54, 1, "t")[1], 9600), 2000, 3)] * 2)
    hi_j, lo_j = jpsk.psk_decision_streams_batch(jnp.asarray(batch), 9600.0, 3000.0, SR)
    hi_t, lo_t = tpsk.psk_decision_streams_batch(torch.from_numpy(batch), 9600.0, 3000.0, SR)
    assert np.array_equal(hi_t.numpy(), np.asarray(hi_j)) and np.array_equal(lo_t.numpy(), np.asarray(lo_j))


@pytest.mark.parametrize("cfo_retry", [True, False])
def test_psk8_xla_backend_matches_jax_demod_pack(cfo_retry, configs):
    """CONFIG tpu.demod_backend = "xla": the staged D8PSK path (K12's plain
    version here, the rotation, the sectors) and the per-capture sync tail,
    equal to the JAX package's CPU demod_pack_batch, which runs that same
    path; a capture 60 Hz off its carrier and a noise capture included."""
    configs("tpu", "demod_backend", "xla")
    rows, payloads = [], []
    for i, df in enumerate((0.0, 60.0)):
        p, fr = _framed(60 + i, 500, f"x{i}.bin")
        rows.append(_place(jpsk.psk8_real_modulate(fr, 9600, 12000.0 + df), N, 13 * i))
        payloads.append(p)
    batch = np.stack(rows + [np.random.default_rng(62).normal(0, 0.3, N).astype(np.float32)])
    ref = [np.asarray(a) for a in jb.demod_pack_batch(jnp.asarray(batch), "8PSK", 9600, cfo_retry=cfo_retry)]
    got = [a.numpy() for a in tb.demod_pack_batch(torch.from_numpy(batch), "8PSK", 9600, cfo_retry=cfo_retry)]
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    for i in range(3):
        assert np.array_equal(got[0][i, : got[1][i]], ref[0][i, : ref[1][i]])
    raws = [got[0][i, : got[1][i]].tobytes() for i in range(3)]
    assert [f[2] for f in _frames(raws[0])] == [payloads[0]] and _frames(raws[2]) == []
    assert bool(got[2][0]) and not bool(got[2][2])


def test_fsk_refused_under_xla_backend(configs):
    """Under CONFIG tpu.demod_backend = "xla" flat FSK1200 captures take the
    single-capture receiver per capture, as the JAX package's XLA body
    does, and pack the same bytes."""
    configs("tpu", "demod_backend", "xla")
    data = b"xla fsk " * 4
    wave = np.asarray(jmodem.modulate("FSK1200", pack_frame("x.bin", data, 0, 1, len(data), crc32(data)), 1200))
    batch = np.stack([_place(wave, N, 0), _place(wave, N, 333)]).astype(np.float32)
    got = [a.numpy() for a in tb.demod_pack_batch(torch.from_numpy(batch), "FSK1200", 1200)]
    ref = [np.asarray(a) for a in jb.demod_pack_batch(jnp.asarray(batch), "FSK1200", 1200)]
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    for i in range(2):
        assert np.array_equal(got[0][i, : got[1][i]], ref[0][i, : ref[1][i]])
        assert [f[2] for f in _frames(got[0][i, : got[1][i]].tobytes())] == [data]


def test_decode_wav_batch_rescues_lost_captures(tmp_path, captures):
    """A clean capture, a noisy one that only the coherent escalation
    recovers and a 1.05x clock-drifted one that only the drift retry
    recovers: both packages save the same files."""
    data = b"batch drift " * 40
    drifted = _drift(_place(jmodem.modulate("QPSK", _compressed_frame(data, "w.bin"), 9600), N, 40), 1.05)
    paths = []
    for name, x in (("clean", captures["QPSK clean"][0]), ("noisy", captures["QPSK noisy"][0]),
                    ("drift", drifted)):
        paths.append(str(tmp_path / f"{name}.wav"))
        write_wav(paths[-1], x)
    ref = jb.decode_wav_batch(paths, "QPSK", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    got = tb.decode_wav_batch(paths, "QPSK", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                              device="cpu")
    assert [len(g) for g in got] == [len(r) for r in ref] == [1, 1, 1]
    assert [_read_all(g) for g in got] == [_read_all(r) for r in ref]
    assert _read_all(got[2]) == [data]
