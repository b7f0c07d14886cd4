"""Bit utilities, the FSK sync tail and the analytic FIR tables of the port.

Counterpart of ``audio_modem_radio_tpu/ops/common.py``:

* ``bytes_to_bits`` / ``bits_to_bytes`` (host, numpy), :38-47;
* :func:`find_bit_pattern` and :func:`pack_bits_from`, :52-73 and :150-162,
  batched over a (B, n) uint8 tensor in plain PyTorch (plain XLA in the JAX
  package): the FSK slices' sync tail;
* the numpy builders of the analytic band-pass FIR, :419-462, copied so the
  two packages hold bitwise-equal templates.

The PSK sync tails run on their own kernels (``ops/kernels.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def bytes_to_bits(data: bytes) -> np.ndarray:
    """bytes -> uint8 bit array, MSB first (matches the reference bit order)."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8/int bit array (MSB first) -> bytes; truncates trailing partial byte."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n]).tobytes()


# --- the FSK sync tail ------------------------------------------------------------

def find_bit_pattern(bits: torch.Tensor, pattern: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """First index of the literal bit ``pattern`` in each row of the (B, n)
    uint8 ``bits``. Returns ``(start (B,) int32, found (B,) bool)``; start is
    0 where the pattern is absent (the caller then packs from offset 0, as
    the reference does) and for rows shorter than the pattern."""
    b, n = bits.shape
    length = n - len(pattern) + 1
    if length <= 0:
        return (torch.zeros(b, dtype=torch.int32, device=bits.device),
                torch.zeros(b, dtype=torch.bool, device=bits.device))
    match = torch.ones((b, length), dtype=torch.bool, device=bits.device)
    for t, c in enumerate(pattern):
        match &= bits[:, t : t + length] == (1 if c == "1" else 0)
    first = torch.argmax(match.to(torch.uint8), dim=1)  # first True, 0 if none
    found = torch.gather(match, 1, first[:, None])[:, 0]
    return torch.where(found, first, 0).to(torch.int32), found


def pack_bits_from(bits: torch.Tensor, start: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack ``bits[b, start[b]:]`` MSB first into bytes, for every row.

    Returns ``(packed (B, ceil(n/1024)*128) uint8, n_valid (B,) int32)`` with
    ``n_valid = (n - start) // 8``; bytes past n_valid hold the zero fill.
    The per-row shift is a slice of each row (one host read of ``start``)."""
    b, n = bits.shape
    n_out = -(-n // 1024) * 128
    padded = F.pad(bits, (0, 8 * n_out))
    shifted = torch.stack([padded[i, s : s + 8 * n_out] for i, s in enumerate(start.tolist())])
    shifted = shifted.reshape(b, n_out, 8)
    packed = torch.zeros((b, n_out), dtype=torch.uint8, device=bits.device)
    for i in range(8):
        packed |= shifted[:, :, i] << (7 - i)
    return packed, ((n - start) // 8).to(torch.int32)


# --- analytic band-pass FIR tables (numpy) ---------------------------------------

@functools.lru_cache(maxsize=32)
def _analytic_fir_taps(low_hz: float, high_hz: float, sample_rate: int, taps: int) -> np.ndarray:
    """Complex analytic band-pass FIR: a Blackman-windowed sinc low-pass
    modulated to the band center, linear phase (group delay ``(taps-1)/2``),
    gain exactly 2 at the band center (positive frequencies doubled)."""
    assert taps % 2 == 1, "taps must be odd (integer group delay)"
    c = (taps - 1) // 2
    k = np.arange(taps, dtype=np.float64) - c
    fc = (low_hz + high_hz) / 2.0
    bw = high_hz - low_hz
    lp = (bw / sample_rate) * np.sinc(bw / sample_rate * k) * np.blackman(taps)
    lp *= 2.0 / lp.sum()
    h = lp * np.exp(2j * np.pi * fc / sample_rate * k)
    return h.astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _fir_dec_template(
    low_hz: float, high_hz: float, sample_rate: int, taps: int, dec: int, out_lanes: int
) -> np.ndarray:
    """(L*dec + taps - dec, 2L) matrix of the decimating analytic FIR: column
    m (< L) holds Re(h) reversed from row ``dec*m``, column L+m holds Im(h),
    so one row-block product gives L decimated analytic samples."""
    h = _analytic_fir_taps(low_hz, high_hz, sample_rate, taps)
    L = out_lanes
    R = L * dec + taps - dec
    W = np.zeros((R, 2 * L), dtype=np.float32)
    rev_re, rev_im = h.real[::-1].astype(np.float32), h.imag[::-1].astype(np.float32)
    for m in range(L):
        W[m * dec : m * dec + taps, m] = rev_re
        W[m * dec : m * dec + taps, L + m] = rev_im
    return W
