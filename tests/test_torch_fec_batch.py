"""The port's FEC-aware decode under noise and in batches, and its denoiser,
vs the JAX package's, on the CPU: the soft stream-FEC escalation at -2 dB
full-band SNR, ``decode_wav_batch`` with stream FEC and with the denoiser,
``decode_from_buffer`` with the denoiser, and ``spectral_gate`` itself.

Captures are made with numpy from seeds and handed to both packages; saved
files are compared byte for byte, with their names less the
``recv_<time>_`` prefix. Under noise the outcomes are compared, not soft
values.
"""

import os
import re

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.encoder import encode_file as j_encode_file
from audio_modem_radio_tpu.fec import stream_fec_encode, wrap_fec
from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.utils import denoise as jdenoise
from audio_modem_radio_tpu.utils.compression import intelligent_compress
from audio_modem_radio_tpu.utils.wavio import read_wav

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils import denoise as tdenoise
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _place(wave, n: int, lead: int) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = np.asarray(wave, np.float32)[: n - lead]
    return x


def _framed(data: bytes, name: str, fec: str) -> bytes:
    """The JAX encoder's single-file framing: compress, optional payload
    container, frame, optional stream FEC."""
    blob = intelligent_compress(data)
    if fec in ("convolutional", "reed_solomon"):
        blob = wrap_fec(blob, fec)
    framed = pack_frame(name, blob, 0, 1, len(data), crc32(data))
    return stream_fec_encode(framed) if fec == "stream" else framed


def _saved(paths):
    """Sorted (name less its recv_<time>_ prefix, contents)."""
    return sorted((re.sub(r"^recv_\d+_", "", os.path.basename(p)), open(p, "rb").read()) for p in paths)


def _stats(reg) -> dict:
    return {k: v for k, v in reg.stats.items() if k != "last_reception"}


def _both(fn_j, fn_t, tmp_path):
    """Run a JAX and a port decode into their own directories and
    registries; returns (saved_j, saved_t, registry_j, registry_t)."""
    rj, rt = JRegistry(journal_dir=""), TRegistry(journal_dir="")
    got_j = fn_j(str(tmp_path / "j"), rj)
    got_t = fn_t(str(tmp_path / "t"), rt)
    return got_j, got_t, rj, rt


@pytest.mark.parametrize("seed", [26, 0])
def test_soft_stream_fec_escalation_at_minus_2_db(tmp_path, seed, monkeypatch):
    """A 1,200-byte file sent with stream FEC at QPSK@4800 under AWGN at -2
    dB full-band SNR, on a noise draw (26) where the JAX package's hard
    decode loses the stream head and its soft escalation recovers the file,
    and on one (0) where the hard decode keeps the head but the frame fails:
    the port saves the same files as the JAX decoder."""
    monkeypatch.chdir(tmp_path)
    data = _payload(41, 1200)
    (tmp_path / "s.bin").write_bytes(data)
    s, sr = read_wav(j_encode_file("s.bin", mode="QPSK", symbol_rate=4800, use_fec=True, fec_type="stream",
                                   cache_dir="c"))
    p = float(np.mean(s.astype(np.float64) ** 2))
    noisy = (s + np.random.default_rng(seed).normal(0, np.sqrt(p / 10 ** -0.2), len(s))).astype(np.float32)
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_from_buffer(noisy, "QPSK", 4800, recv_dir=d, registry=r, sample_rate=sr,
                                             stream_fec=True),
        lambda d, r: tdec.decode_from_buffer(noisy, "QPSK", 4800, recv_dir=d, registry=r, sample_rate=sr,
                                             stream_fec=True, device="cpu"),
        tmp_path)
    assert _saved(got_t) == _saved(got_j) == ([("s.bin", data)] if seed == 26 else [])


def test_decode_wav_batch_stream_fec_and_denoise_equal_jax(tmp_path):
    """``decode_wav_batch`` of two stream-FEC WAVs with ``stream_fec``, and
    of a clean plain WAV with ``denoise`` (the native loader, then the
    spectral gate per capture): the same files as the JAX batch."""
    paths, want = [], []
    for i in range(2):
        data = _payload(20 + i, 700)
        paths.append(str(tmp_path / f"s{i}.wav"))
        write_wav(paths[-1], _place(jmodem.modulate("QPSK", _framed(data, f"s{i}.bin", "stream"), 9600),
                                    1 << 17, 100 + 50 * i))
        want.append([(f"s{i}.bin", data)])
    got_j, got_t, rj, rt = _both(
        lambda d, r: jb.decode_wav_batch(paths, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True),
        lambda d, r: tb.decode_wav_batch(paths, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True,
                                         device="cpu"),
        tmp_path / "fec")
    assert [_saved(g) for g in got_t] == [_saved(g) for g in got_j] == want
    data = _payload(22, 600)
    wav = str(tmp_path / "dn.wav")
    write_wav(wav, _place(jmodem.modulate("QPSK", _framed(data, "dn.bin", "none"), 9600), 1 << 17, 10))
    got_j, got_t, rj, rt = _both(
        lambda d, r: jb.decode_wav_batch([wav], "QPSK", 9600, recv_dir=d, registry=r, denoise=True),
        lambda d, r: tb.decode_wav_batch([wav], "QPSK", 9600, recv_dir=d, registry=r, denoise=True,
                                         device="cpu"),
        tmp_path / "dn")
    assert [_saved(g) for g in got_t] == [_saved(g) for g in got_j] == [[("dn.bin", data)]]


def test_decode_from_buffer_denoise_equals_jax(tmp_path):
    """``denoise=True`` on a single capture (AWGN at 10 dB) saves what the
    JAX decoder saves."""
    data = _payload(23, 800)
    x = _place(jmodem.modulate("QPSK", _framed(data, "n.bin", "none"), 9600), 1 << 17, 5)
    x = (x + np.random.default_rng(24).normal(0, 0.1, len(x))).astype(np.float32)
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r, denoise=True),
        lambda d, r: tdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r, denoise=True, device="cpu"),
        tmp_path)
    assert _saved(got_t) == _saved(got_j) == [("n.bin", data)]


@pytest.mark.parametrize("n", [(1 << 17) - 1024 - 300, (1 << 17) - 300, 9000])
def test_spectral_gate_equals_jax(n):
    """``spectral_gate`` on a tone in noise: an even frame count (128: the
    per-bin median the mean of the two middle values), an odd one (129: the
    middle value) and a short capture (10 frames); within 1e-5 of the
    capture's peak (measured: 1.5e-7 on 2^17 samples, float32 FFT
    rounding)."""
    t = np.arange(n) / 96000
    x = (0.3 * np.sin(2 * np.pi * 3000 * t) + np.random.default_rng(n).normal(0, 0.2, n)).astype(np.float32)
    n_frames = (n + (-n) % 1024 + 2048) // 1024 - 1
    assert n_frames == {(1 << 17) - 1024 - 300: 128, (1 << 17) - 300: 129, 9000: 10}[n]
    got = tdenoise.spectral_gate(x, device="cpu")
    ref = jdenoise.spectral_gate(x)
    assert got.dtype == np.float32 and got.shape == ref.shape == (n,)
    assert float(np.max(np.abs(got - ref))) <= 1e-5 * float(np.max(np.abs(x)))
    short = x[:8000]
    assert np.array_equal(tdenoise.spectral_gate(short, device="cpu"), short)
