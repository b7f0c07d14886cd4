"""Host-side WAV serialization and resampling.

Equivalent surface to the reference's ``wav_from_array`` int16 PCM writer
(reference modem.py:360-368) and the read-mono-resample front end of
``decode_wav_file`` (reference decoder.py:380-388), without requiring the
soundfile/pygame stack: the ``wave`` stdlib module handles 16-bit PCM, and
resampling is polyphase (scipy) which is both higher quality and faster than
the reference's FFT ``signal.resample`` for rational rate changes.
"""

from __future__ import annotations

import io
import wave
from fractions import Fraction
from typing import Tuple

import numpy as np

SAMPLE_RATE = 96000


def wav_from_array(arr: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """float array in [-1, 1] -> mono 16-bit PCM WAV bytes."""
    arr = np.asarray(arr, dtype=np.float32)
    pcm = np.clip(arr * 32767.0, -32768, 32767).astype(np.int16)
    bio = io.BytesIO()
    with wave.open(bio, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())
    return bio.getvalue()


def write_wav(path: str, arr: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    with open(path, "wb") as f:
        f.write(wav_from_array(arr, sample_rate))


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 array in [-1, 1], sample_rate).

    Supports 8/16/32-bit integer PCM and 32-bit float WAVs; multi-channel
    input keeps channel 0 (the reference also mono-izes, decoder.py:382).
    """
    with wave.open(path, "rb") as wf:
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        sample_rate = wf.getframerate()
        raw = wf.readframes(wf.getnframes())

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        as_int = np.frombuffer(raw, dtype=np.int32)
        as_float = as_int.view(np.float32)
        # Heuristic: IEEE-float WAVs read as int32 look astronomically large.
        if np.all(np.abs(as_float) <= 4.0):
            data = as_float.astype(np.float32)
        else:
            data = as_int.astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)[:, 0]
    return np.ascontiguousarray(data), sample_rate


def resample(data: np.ndarray, sr_in: int, sr_out: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resample ``data`` from ``sr_in`` to ``sr_out``."""
    if sr_in == sr_out:
        return data
    from scipy.signal import resample_poly

    frac = Fraction(sr_out, sr_in).limit_denominator(1 << 16)
    out = resample_poly(data.astype(np.float64), frac.numerator, frac.denominator)
    return out.astype(np.float32)
