"""The JAX package's FSK front ends and helpers in the port, against the
JAX package on the CPU: ``ops.common`` ``analytic_bandpass``,
``analytic_bandpass_fir`` and ``frame_signal``,
``fsk_demod_bits(frontend="fft"|"fir")``, and ``ops.psk``
``estimate_cfo``, ``psk_demod_bits``, ``psk8_relabel_pack_batch`` and
``quarter_turn``.

Inputs are made with numpy from seeds and handed to both packages as numpy
arrays. Tolerances: the front ends' complex outputs within 1e-4 of their
largest magnitude (float32 FFTs summed in another order); bits equal over
the signal; the CFO estimate within 1 Hz; the rest bitwise (packed bytes
within ``n_valid``).
"""

import numpy as np
import pytest
import torch
from scipy.signal import hilbert

import jax.numpy as jnp

from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.framing import MAGIC_BIT_PATTERN, crc32, pack_frame, parse_frames
from audio_modem_radio_tpu.ops import common as jcommon
from audio_modem_radio_tpu.ops import fsk as jfsk
from audio_modem_radio_tpu.ops import psk as jpsk

from audio_modem_radio_tpu_torch.ops import common as tcommon
from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.ops.common import bit_sync_and_pack

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000


def _framed(seed: int, n_bytes: int) -> bytes:
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return pack_frame(f"v{seed}.bin", p, 0, 1, len(p), crc32(p))


def _place(wave, n: int, lead: int = 0) -> np.ndarray:
    x = np.zeros(n, np.float32)
    w = np.asarray(wave, np.float32)[: n - lead]
    x[lead : lead + len(w)] = w
    return x


# --- the FSK front ends ------------------------------------------------------------------

_FSK = {"FSK9600": (9600.0, 1200.0, 2200.0, 400), "FSK19200": (19200.0, 8000.0, 16000.0, 900)}


def _fsk_capture(name: str, n: int = 1 << 16, lead: int = 211):
    baud, mark, space, n_bytes = _FSK[name]
    wave = np.asarray(jfsk.fsk_modulate(_framed(80, n_bytes), baud, mark, space, SR), np.float32)
    return _place(wave, n, lead), (baud, mark, space), (lead + len(wave)) // int(round(SR / baud))


@pytest.mark.parametrize("decimate", [1, 4])
def test_analytic_bandpass_equals_jax(decimate):
    x, _cfg, _ = _fsk_capture("FSK9600", 100_000)
    ref = np.asarray(jcommon.analytic_bandpass(jnp.asarray(x), 200.0, 11800.0, SR, decimate=decimate))
    got = tcommon.analytic_bandpass(torch.from_numpy(x), 200.0, 11800.0, SR, decimate=decimate).numpy()
    assert got.dtype == ref.dtype == np.complex64 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(ValueError, match="aliases"):
        tcommon.analytic_bandpass(torch.from_numpy(x), 200.0, 30000.0, SR, decimate=4)


@pytest.mark.parametrize("n", [100_000, 300_000])  # one block, and several of 2^17
def test_analytic_bandpass_fir_equals_jax(n):
    x, _cfg, _ = _fsk_capture("FSK9600", n)
    ref = np.asarray(jcommon.analytic_bandpass_fir(jnp.asarray(x), 200.0, 11800.0, SR, taps=1025))
    got = tcommon.analytic_bandpass_fir(torch.from_numpy(x), 200.0, 11800.0, SR, taps=1025).numpy()
    assert got.dtype == ref.dtype == np.complex64 and got.shape == ref.shape == (n,)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("frontend", ["fft", "fir"])
@pytest.mark.parametrize("name", ["FSK9600", "FSK19200"])
def test_fsk_frontends_bits_equal_jax(name, frontend):
    """fsk_demod_bits(frontend=) without MLSE: bits equal to the JAX
    package's over the signal, and the frame decoded as by "matmul"."""
    x, cfg, n_sig = _fsk_capture(name)
    ref, _ = jfsk.fsk_demod_bits(jnp.asarray(x), *cfg, SR, mlse=False, frontend=frontend)
    got, _ = tfsk.fsk_demod_bits(torch.from_numpy(x), *cfg, SR, mlse=False, frontend=frontend)
    assert np.array_equal(got.numpy()[:n_sig], np.asarray(ref)[:n_sig])
    frames = []
    for fe in (frontend, "matmul"):
        bits, _ = tfsk.fsk_demod_bits(torch.from_numpy(x), *cfg, SR, mlse=False, frontend=fe)
        packed, n_valid, _ = bit_sync_and_pack(bits, MAGIC_BIT_PATTERN)
        frames.append([f.data for f in parse_frames(packed.numpy()[: int(n_valid)].tobytes())])
    assert frames[0] == frames[1] and len(frames[0]) == 1


# --- the helpers ------------------------------------------------------------------------

def _shift(w: np.ndarray, df: float) -> np.ndarray:
    z = hilbert(np.asarray(w, np.float64))
    return np.real(z * np.exp(2j * np.pi * df * np.arange(len(w)) / SR)).astype(np.float32)


@pytest.mark.parametrize("df", [0.0, 100.0, -100.0])
def test_estimate_cfo_equals_jax(df):
    """Within 1 Hz of the JAX package's estimate and of the injected offset
    (mod baud/4), as tests/test_cfo.py checks the JAX package."""
    wave = jpsk.qpsk_modulate(_framed(90, 600), 2400, 6000.0)
    x = _shift(wave, df)
    ref = jpsk.estimate_cfo(x, 2400.0, 6000.0, SR)
    got = tpsk.estimate_cfo(torch.from_numpy(x), 2400.0, 6000.0, SR)
    assert got == tpsk.estimate_cfo(x, 2400.0, 6000.0, SR, device="cpu")
    assert isinstance(got, float) and abs(got - ref) < 1.0
    assert abs(got - ((df + 300) % 600 - 300)) < 1.0


@pytest.mark.parametrize("n_psk", [2, 4])
def test_psk_demod_bits_equals_jax(n_psk):
    wave = np.asarray(jmodem.modulate("QPSK" if n_psk == 4 else "BPSK", _framed(91, 400), 4800), np.float32)
    x = _place(wave, 1 << 16, 33)
    ref_bits, ref_score = jpsk.psk_demod_bits(jnp.asarray(x), 4800.0, 3000.0, SR, n_psk)
    bits, score = tpsk.psk_demod_bits(torch.from_numpy(x), 4800.0, 3000.0, SR, n_psk)
    n_sig = (len(wave) // 20 - 2) * (n_psk // 2)
    assert bits.dtype == torch.uint8 and bits.shape == ref_bits.shape
    assert np.array_equal(bits.numpy()[:n_sig], np.asarray(ref_bits)[:n_sig])
    assert abs(float(score) - float(ref_score)) <= 1e-5 * abs(float(ref_score))


def test_psk8_relabel_pack_batch_equals_jax():
    rng = np.random.default_rng(92)
    sec = rng.integers(0, 8, (3, 256 * 128), dtype=np.uint8)
    ksel = np.array([0, 5, 7], np.int32)
    idx = np.array([0, 13, 1001], np.int32)
    ref_p, ref_v = jpsk.psk8_relabel_pack_batch(*(jnp.asarray(a) for a in (sec, ksel, idx)))
    got_p, got_v = tpsk.psk8_relabel_pack_batch(*(torch.from_numpy(a) for a in (sec, ksel, idx)))
    assert np.array_equal(got_v.numpy(), np.asarray(ref_v))
    for i in range(3):
        assert np.array_equal(got_p.numpy()[i, : int(got_v[i])], np.asarray(ref_p)[i, : int(ref_v[i])])


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, -1])
def test_quarter_turn_equals_jax(k):
    rng = np.random.default_rng(93)
    re, im = rng.normal(size=(2, 50)).astype(np.float32)
    ref = jpsk.quarter_turn(jnp.asarray(re), jnp.asarray(im), k)
    got = tpsk.quarter_turn(torch.from_numpy(re), torch.from_numpy(im), k)
    assert all(np.array_equal(g.numpy(), np.asarray(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("frame_len,hop,n_frames", [(256, 128, 40), (100, 30, 17), (64, 32, 200)])
def test_frame_signal_equals_jax(frame_len, hop, n_frames):
    x = np.random.default_rng(94).normal(size=3000).astype(np.float32)
    ref = np.asarray(jcommon.frame_signal(jnp.asarray(x), frame_len, hop, n_frames))
    got = tcommon.frame_signal(torch.from_numpy(x), frame_len, hop, n_frames).numpy()
    assert got.shape == ref.shape == (n_frames, frame_len) and np.array_equal(got, ref)
