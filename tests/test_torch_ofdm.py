"""The port's OFDM (``ops/ofdm.py`` and its modem, batch and decoder
branches) vs the JAX package's, on the CPU.

Captures are made with numpy from seeds, at most 2^18 samples, and handed
to both packages as numpy arrays: OFDM4 and OFDM8 at 9600 Bd with leads
that are not multiples of the symbol length S (32 and 64 samples), one at
+40 Hz, one with AWGN, and one of noise. Pass 1 takes the first maximum of
a float score over the S offsets, so each comparison first asserts that
both packages chose the same offset (the JAX one read from its argmax).
Tolerances: the modulated waves within 1e-6; the float differentials
(dr, di) and the soft bits within 1e-4 of their largest magnitude; the Gray
decisions bitwise over the (n_sym - 1)*K dibits; byte streams, parsed frames
and saved files equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.ops import ofdm as jofdm
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.utils.compression import intelligent_compress

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import parse_frames
from audio_modem_radio_tpu_torch.ops import ofdm as tofdm
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N = 1 << 16
_K = {"OFDM4": 4, "OFDM8": 8}


def _framed(seed: int, n_bytes: int = 600):
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return p, pack_frame(f"o{seed}.bin", p, 0, 1, len(p), crc32(p))


def _place(wave, lead: int, n: int = N) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = wave
    return x


@pytest.fixture(scope="module")
def captures():
    """name -> (mode, capture, payload or None)."""
    out = {}
    for name, mode, lead, seed in (("OFDM4 lead 13", "OFDM4", 13, 1), ("OFDM4 lead 0", "OFDM4", 0, 2),
                                   ("OFDM8 lead 37", "OFDM8", 37, 3)):
        p, framed = _framed(seed)
        out[name] = (mode, _place(np.asarray(jofdm.ofdm_modulate(framed, 9600, 12000.0, _K[mode])), lead), p)
    p, framed = _framed(4)
    out["OFDM4 +40Hz"] = ("OFDM4", _place(tofdm.ofdm_modulate(framed, 9600, 12040.0, 4), 101), p)
    rng = np.random.default_rng(5)
    p, framed = _framed(6)
    clean = _place(tofdm.ofdm_modulate(framed, 9600, 12000.0, 4), 211)
    sigma = np.sqrt(np.mean(clean[211 : 211 + 20000] ** 2) / 10 ** (6.0 / 10))
    out["OFDM4 awgn"] = ("OFDM4", (clean + rng.normal(0, sigma, N)).astype(np.float32), p)
    out["noise"] = ("OFDM8", rng.normal(0, 0.3, N).astype(np.float32), None)
    return out


_REAL_ARGMAX = jnp.argmax
_OFFSET_FNS = {}


def _jax_offset(monkeypatch, x, n_sub: int) -> int:
    """The timing offset the JAX package's pass 1 chooses: its argmax,
    recorded while ``_ofdm_decision_streams`` is traced and returned as the
    traced function's output (one compiled function per subcarrier count,
    traced under the recording argmax)."""
    if n_sub not in _OFFSET_FNS:
        picks = []

        def record(a, *args, **kw):
            out = _REAL_ARGMAX(a, *args, **kw)
            picks.append(out)
            return out

        def best(y):
            picks.clear()
            jofdm._ofdm_decision_streams(y, 9600.0, 12000.0, n_sub, SR)
            return picks[0]

        _OFFSET_FNS[n_sub] = (jax.jit(best), record)
    fn, record = _OFFSET_FNS[n_sub]
    with monkeypatch.context() as m:
        m.setattr(jofdm.jnp, "argmax", record)
        return int(fn(jnp.asarray(x)))


@pytest.mark.parametrize("mode,baud", [("OFDM4", 9600), ("OFDM8", 9600), ("OFDM4", 4800), ("OFDM8", 1200)])
def test_ofdm_modulate_matches_jax(mode, baud):
    _p, framed = _framed(baud + _K[mode])
    ref = np.asarray(jmodem.modulate(mode, framed, baud), np.float32)
    got = tmodem.modulate(mode, framed, baud)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) <= 1e-6
    assert np.array_equal(tofdm._ofdm_dual_templates(32, 12000.0, 4, SR, 32),
                          jofdm._ofdm_dual_templates(32, 12000.0, 4, SR, 32))
    assert np.array_equal(tofdm._ofdm_blocked_dual(64, 12000.0, 8, SR, 16),
                          jofdm._ofdm_blocked_dual(64, 12000.0, 8, SR, 16))


@pytest.mark.parametrize("name", ["OFDM4 lead 13", "OFDM8 lead 37", "OFDM4 +40Hz", "OFDM4 awgn"])
def test_ofdm_demod_bits_matches_jax(captures, monkeypatch, name):
    """The chosen offset equal, then the gains within 1e-4 relative, the
    differentials within 1e-4 of their largest magnitude and the Gray bits
    bitwise."""
    mode, x, _p = captures[name]
    K = _K[mode]
    front = tofdm._ofdm_front(torch.from_numpy(x)[None], 9600.0, 12000.0, K, SR)
    assert int(front["best"][0]) == _jax_offset(monkeypatch, x, K)
    bits_j, score_j, gains_j = (np.asarray(a) for a in jofdm.ofdm_demod_bits(jnp.asarray(x), 9600.0, 12000.0, K, SR))
    bits_t, score_t, gains_t = tofdm.ofdm_demod_bits(x, 9600.0, 12000.0, K, SR, device="cpu")
    assert abs(float(score_t) - float(score_j)) <= 1e-4 * abs(float(score_j))
    assert np.max(np.abs(gains_t.numpy() - gains_j)) <= 1e-4 * np.max(gains_j)
    dr_j, di_j = (np.asarray(a) for a in jofdm._ofdm_soft_streams(jnp.asarray(x), 9600.0, 12000.0, K, SR))
    dr_t, di_t, _g = tofdm._ofdm_differentials(front)
    scale = max(np.max(np.abs(dr_j)), np.max(np.abs(di_j)))
    assert dr_t.shape[1] == len(dr_j) == (front["n_sym"] - 1) * K
    assert np.max(np.abs(dr_t[0].numpy() - dr_j)) <= 1e-4 * scale
    assert np.max(np.abs(di_t[0].numpy() - di_j)) <= 1e-4 * scale
    if name != "OFDM4 awgn":  # clean: no decision sits on a boundary
        assert np.array_equal(bits_t.numpy(), bits_j)


@pytest.mark.parametrize("name", ["OFDM4 lead 13", "OFDM8 lead 37", "OFDM4 +40Hz", "OFDM4 awgn", "noise"])
def test_ofdm_demodulate_tracked_and_soft_match_jax(captures, name):
    """``ofdm_demodulate`` and the tracked receiver byte-equal, the clean
    captures' frames recovered by both; the soft bits within 1e-4."""
    mode, x, p = captures[name]
    K = _K[mode]
    raw = tofdm.ofdm_demodulate(x, 9600, 12000.0, K, device="cpu")
    assert raw == jofdm.ofdm_demodulate(x, 9600, 12000.0, K)
    tracked = tofdm.ofdm_tracked_demodulate(x, 9600, 12000.0, K, device="cpu")
    assert tracked == jofdm.ofdm_tracked_demodulate(x, 9600, 12000.0, K)
    if p is not None and name != "OFDM4 awgn":
        assert [f.data for f in parse_frames(raw)] == [p]
        assert [f.data for f in parse_frames(tracked)] == [p]
    if p is None:
        assert parse_frames(raw) == [] and parse_frames(tracked) == []
    soft_j = jofdm.ofdm_soft_bits(x, 9600, 12000.0, K, SR)
    soft_t = tofdm.ofdm_soft_bits(x, 9600, 12000.0, K, SR, device="cpu")
    assert soft_t.shape == soft_j.shape and float(np.max(np.abs(soft_t - soft_j))) <= 1e-4
    gains = tofdm.estimate_subcarrier_gains(x, 9600, 12000.0, K, device="cpu")
    assert np.max(np.abs(gains - np.asarray(jofdm.estimate_subcarrier_gains(x, 9600, 12000.0, K)))) <= 1e-4 * np.max(gains)


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


@pytest.mark.parametrize("name", ["OFDM4 lead 13", "OFDM8 lead 37", "OFDM4 awgn", "noise", "alias capture",
                                  "no escalation"])
def test_modem_demodulate_matches_jax(captures, configs, name):
    """``modem.demodulate``: real OFDM captures, the AWGN one (the coherent
    escalation runs), noise (the DQPSK alias probe misses, then the
    escalation), a capture of the alias wire format with the alias flag
    off (the probe hits and the alias receiver answers), and a capture
    with CONFIG ``modem.psk_coherent_escalation`` off."""
    if name == "alias capture":
        p, framed = _framed(7)
        mode, x = "OFDM8", _place(tmodem.ofdm_modulate_simple(framed, 9600, 12000.0, 8), 300)
    elif name == "no escalation":
        configs("modem", "psk_coherent_escalation", False)
        mode, x, p = captures["OFDM4 awgn"]
    else:
        mode, x, p = captures[name]
    got = tmodem.demodulate(mode, x, 9600, device="cpu")
    assert got == jmodem.demodulate(mode, x, 9600)
    if name in ("OFDM4 lead 13", "OFDM8 lead 37", "alias capture"):
        assert [f.data for f in parse_frames(got)] == [p]


def test_short_captures_raise_and_save_nothing(tmp_path):
    """Under three symbols both packages raise ValueError (the ceil rule:
    65 samples at S = 32 are three symbols); ``decode_with_retry`` and
    ``decode_from_buffer`` save nothing on such captures."""
    x = np.random.default_rng(8).normal(0, 0.3, 64).astype(np.float32)
    for fn in (lambda y: tofdm.ofdm_demod_bits(y, 9600.0, 12000.0, 4, SR, device="cpu"),
               lambda y: jofdm.ofdm_demod_bits(jnp.asarray(y), 9600.0, 12000.0, 4, SR)):
        with pytest.raises(ValueError, match="three OFDM symbols"):
            fn(x)
    y = np.random.default_rng(8).normal(0, 0.3, 65).astype(np.float32)
    assert np.array_equal(tofdm.ofdm_demod_bits(y, 9600.0, 12000.0, 4, SR, device="cpu")[0].numpy(),
                          np.asarray(jofdm.ofdm_demod_bits(jnp.asarray(y), 9600.0, 12000.0, 4, SR)[0]))
    assert tofdm.ofdm_blocked_row_shape(64, 9600, 4, SR) is None is jofdm.ofdm_blocked_row_shape(64, 9600, 4, SR)
    for tag, fn, reg, kw in (("j", jdec.decode_with_retry, JRegistry(journal_dir=""), {}),
                             ("t", tdec.decode_with_retry, TRegistry(journal_dir=""), {"device": "cpu"})):
        # The nominal attempt and one drift hypothesis (batched, then the
        # single-capture fallback).
        assert fn(x, "OFDM4", 9600, max_retries=2, recv_dir=str(tmp_path / tag), registry=reg, **kw) == []


def test_decision_streams_batch_matches_jax_flat_and_rows(captures):
    """``ofdm_decision_streams_batch`` on flat captures and on the host's
    overlapped rows (equal to the JAX package's), OFDM4: bitwise."""
    xs = np.stack([captures[n][1] for n in ("OFDM4 lead 13", "OFDM4 lead 0", "OFDM4 +40Hz")])
    shaped = tb.host_shape_batch(xs, "OFDM4", 9600, device="cpu")
    assert shaped.dtype == np.float32 and shaped.shape == (3, 64, 1056)
    assert np.array_equal(shaped, jb.host_shape_batch(xs, "OFDM4", 9600))
    for x in (xs, shaped):
        hi_j, lo_j = (np.asarray(a) for a in jofdm.ofdm_decision_streams_batch(jnp.asarray(x), 9600.0, 12000.0, 4, SR))
        hi_t, lo_t = tofdm.ofdm_decision_streams_batch(torch.from_numpy(x), 9600.0, 12000.0, 4, SR)
        assert np.array_equal(hi_t.numpy(), hi_j) and np.array_equal(lo_t.numpy(), lo_j)


@pytest.mark.parametrize("mode,cfo_retry", [("OFDM4", True), ("OFDM8", True), ("OFDM4", False)])
def test_demod_pack_batch_and_kernel_tail(captures, mode, cfo_retry):
    """``demod_pack_batch`` on the CPU takes the per-capture tails: found,
    n_valid and the packed bytes equal to the JAX package's. The card's
    tail, K2 + K3 on the streams zero-padded to 128*256 dibits (their plain
    versions here), finds the same captures and parses the same frames."""
    names = {"OFDM4": ("OFDM4 lead 13", "OFDM4 +40Hz", "OFDM4 lead 0"),
             "OFDM8": ("OFDM8 lead 37", "noise")}[mode]
    xs = np.stack([captures[n][1] for n in names])
    ref = [np.asarray(a) for a in jb.demod_pack_batch(jnp.asarray(xs), mode, 9600, cfo_retry=cfo_retry)]
    got = [a.numpy() for a in tb.demod_pack_batch(torch.from_numpy(xs), mode, 9600, cfo_retry=cfo_retry)]
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    for i in range(len(names)):
        assert np.array_equal(got[0][i, : got[1][i]], ref[0][i, : ref[1][i]]), names[i]
    hi, lo = tofdm.ofdm_decision_streams_batch(torch.from_numpy(xs), 9600.0, 12000.0, _K[mode], SR, cfo=cfo_retry)
    pad = -hi.shape[1] % (128 * 256)
    packed, n_valid, found = tb.psk4_kernel_sync_tail(torch.nn.functional.pad(hi, (0, pad)),
                                                      torch.nn.functional.pad(lo, (0, pad)), cfo_retry)
    assert np.array_equal(found.numpy(), ref[2])
    for i in range(len(names)):
        kern = parse_frames(packed[i, : n_valid[i]].numpy().tobytes())
        assert [f.data for f in kern] == [f.data for f in parse_frames(got[0][i, : got[1][i]].tobytes())]


def test_decode_sample_batch_matches_jax(captures):
    names = ("OFDM8 lead 37", "noise")
    xs = np.stack([captures[n][1] for n in names])
    got = tb.decode_sample_batch(xs, "OFDM8", 9600, device="cpu")
    assert got == jb.decode_sample_batch(xs, "OFDM8", 9600)
    assert [f.data for f in parse_frames(got[0])] == [captures[names[0]][2]] and parse_frames(got[1]) == []


def _read_all(paths):
    return sorted(open(p, "rb").read() for p in paths)


def test_decode_wav_batch_and_file_match_jax(tmp_path, captures):
    """Three OFDM4 WAVs (a compressed file, the AWGN capture, noise) through
    ``decode_wav_batch`` (the tracked escalation runs on the lost ones) and
    each through ``decode_wav_file``: the same saved files as the JAX
    package's."""
    data = b"ofdm wav file " * 40
    framed = pack_frame("w.bin", intelligent_compress(data), 0, 1, len(data), crc32(data))
    paths = []
    for i, x in enumerate((_place(tofdm.ofdm_modulate(framed, 9600, 12000.0, 4), 77),
                           captures["OFDM4 awgn"][1], captures["noise"][1])):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], x)
    got = tb.decode_wav_batch(paths, "OFDM4", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(journal_dir=""),
                              device="cpu")
    ref = jb.decode_wav_batch(paths, "OFDM4", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry(journal_dir=""))
    assert [len(g) for g in got] == [len(r) for r in ref]
    assert [_read_all(g) for g in got] == [_read_all(r) for r in ref]
    assert _read_all(got[0]) == [data]
    for i, path in enumerate(paths[:2]):
        t = tdec.decode_wav_file(path, "OFDM4", 9600, recv_dir=str(tmp_path / f"tf{i}"),
                                 registry=TRegistry(journal_dir=""), device="cpu")
        j = jdec.decode_wav_file(path, "OFDM4", 9600, recv_dir=str(tmp_path / f"jf{i}"),
                                 registry=JRegistry(journal_dir=""))
        assert _read_all(t) == _read_all(j)
    assert os.listdir(tmp_path / "tf0")


def test_soft_bit_stream_matches_jax(captures):
    """The decoder's OFDM soft stream (stream FEC, soft payload FEC): the
    four rotation hypotheses within 1e-4."""
    _mode, x, _p = captures["OFDM4 lead 13"]
    got, n_psk = tdec._soft_bit_stream(x, "OFDM4", 9600, device="cpu")
    ref, n_ref = jdec._soft_bit_stream(x, "OFDM4", 9600)
    assert n_psk == n_ref == 4 and len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape and float(np.max(np.abs(g - r))) <= 1e-4
