"""Bit utilities, the FSK sync tail and the analytic FIR tables of the port.

Counterpart of ``audio_modem_radio_tpu/ops/common.py``:

* ``bytes_to_bits`` / ``bits_to_bytes`` (host, numpy), :38-47;
* :func:`find_bit_pattern` and :func:`pack_bits_from`, :52-73 and :150-162,
  batched over a (B, n) uint8 tensor in plain PyTorch (plain XLA in the JAX
  package): the FSK slices' sync tail on the CPU and under
  ``tpu.demod_backend = "xla"``, and the plain version of
  ``ops.kernels.fsk_sync_pack_batch``, which runs it on the card;
* the single-capture PSK sync tails, :76-351, on 1-D streams in plain
  PyTorch: :func:`find_bit_pattern_validated`, :func:`dibit_sync_and_pack`,
  :func:`dibit_sync_and_pack_rotations`, :func:`relabel_shift_pack`,
  :func:`bit_sync_and_pack_rotations`;
* :func:`bit_sync_and_pack`, :354, the single-capture FSK sync tail;
* the numpy builders of the analytic band-pass FIR, :419-462, copied so the
  two packages hold bitwise-equal templates, and the decimating analytic
  FIR front end of the single-capture FSK receiver,
  :func:`analytic_bandpass_fir_dec` :468 and :func:`analytic_fir_dec_rows`
  :533: one float32 ``torch.matmul`` of overlapped rows against
  :func:`_fir_dec_template`;
* the FFT front ends behind ``ops.fsk.fsk_demod_bits(frontend="fft"|"fir")``,
  in plain ``torch.fft`` as the JAX package runs them in XLA:
  :func:`analytic_bandpass` :370 (rfft, the band mask, the inverse FFT,
  exact decimation) and :func:`analytic_bandpass_fir` :567 (overlap-save
  FFT blocks of the complex FIR);
* :func:`frame_signal` :611, overlapping frames of a 1-D signal.

The batched PSK sync tails run on their own kernels (``ops/kernels.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..observability import host_read


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
    The per-row shift is a slice of each row (one host read of ``start``,
    counted and spanned by ``observability.host_read``)."""
    b, n = bits.shape
    n_out = -(-n // 1024) * 128
    padded = F.pad(bits, (0, 8 * n_out))
    starts = host_read(start, torch.Tensor.tolist)
    shifted = torch.stack([padded[i, s : s + 8 * n_out] for i, s in enumerate(starts)])
    shifted = shifted.reshape(b, n_out, 8)
    packed = torch.zeros((b, n_out), dtype=torch.uint8, device=bits.device)
    for i in range(8):
        packed |= shifted[:, :, i] << (7 - i)
    return packed, ((n - start) // 8).to(torch.int32)


# --- the PSK sync tails of one capture ------------------------------------------
#
# The JAX package's single-capture tails (ops/common.py:76-351 there), in
# plain PyTorch on 1-D uint8 streams: the single-capture receiver and the
# batch's per-capture tails run them. The batched FSK tail above serves as
# their pack (the interleaved stream shifted by ``s`` bits, zero-filled,
# MSB first: the length and ``n_valid`` of the JAX pack matmuls).


def first_true(match: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(index, found)`` of the first True of a 1-D bool tensor; index 0
    where there is none (``jnp.argmax`` on booleans; ``torch.argmax`` takes
    no bool)."""
    idx = torch.argmax(match.to(torch.uint8))
    return idx, match[idx]


def find_bit_pattern_validated(
    bits: torch.Tensor, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First position of ``pattern`` in the 1-D ``bits`` whose following
    bits also agree with ``pattern2`` within ``tol`` misses; a stream too
    short for all of ``pattern2`` validates against the prefix that fits,
    with ``tol`` scaled (ceil, at least 1). Returns 0-d ``(start int32,
    found)``, start 0 where not found."""
    if not pattern2:
        start, found = find_bit_pattern(bits[None], pattern)
        return start[0], found[0]
    n1 = len(pattern)
    L = bits.shape[0] - n1 - len(pattern2) + 1
    if L <= 0:
        k2 = min(int(bits.shape[0]) - n1, len(pattern2))
        if k2 <= 0:
            return find_bit_pattern_validated(bits, pattern)
        scaled = max(1, -(-tol * k2 // len(pattern2)))
        return find_bit_pattern_validated(bits, pattern, pattern2[:k2], scaled)
    match = torch.ones(L, dtype=torch.bool, device=bits.device)
    for t, c in enumerate(pattern):
        match &= bits[t : t + L] == int(c)
    miss = torch.zeros(L, dtype=torch.int32, device=bits.device)
    for j, c in enumerate(pattern2):
        miss = miss + (bits[n1 + j : n1 + j + L] != int(c))
    match &= miss <= tol
    first, found = first_true(match)
    return torch.where(found, first, 0).to(torch.int32), found


def _pack_from(bits: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stream's bits packed from bit ``s``: ``(packed, n_valid)``."""
    packed, n_valid = pack_bits_from(bits[None], s.reshape(1))
    return packed[0], n_valid[0]


def _interleave(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) dibit lanes -> the bit stream hi0, lo0, hi1, lo1, ..."""
    return torch.stack([hi, lo], dim=1).reshape(-1)


def _dibit_match(hi, lo, pat_str: str, n1_dibits: int, tol: int, validated: bool):
    """First even/odd-alignment match of ``pat_str`` in the (hi, lo) lanes:
    the first ``n1_dibits`` dibits exactly, the rest within ``tol`` bit
    misses when ``validated``. Returns 0-d ``(start_bit, found)``."""
    m = hi.shape[0]
    pat = [int(c) for c in pat_str]
    n_all = len(pat) // 2
    L = m - (n_all + 1)
    dev = hi.device
    match_e = torch.ones(L, dtype=torch.bool, device=dev)
    match_o = torch.ones(L, dtype=torch.bool, device=dev)
    miss_e = torch.zeros(L, dtype=torch.int32, device=dev)
    miss_o = torch.zeros(L, dtype=torch.int32, device=dev)
    for t in range(n_all):
        # Even alignment: hi carries pattern[0::2], lo [1::2]; odd: lo
        # carries pattern[0::2] at t, hi pattern[1::2] at t+1.
        he, le = hi[t : t + L] == pat[2 * t], lo[t : t + L] == pat[2 * t + 1]
        lo_o, ho = lo[t : t + L] == pat[2 * t], hi[t + 1 : t + 1 + L] == pat[2 * t + 1]
        if t < n1_dibits:
            match_e &= he & le
            match_o &= lo_o & ho
        else:
            miss_e = miss_e + (~he).to(torch.int32) + (~le).to(torch.int32)
            miss_o = miss_o + (~lo_o).to(torch.int32) + (~ho).to(torch.int32)
    if validated:
        match_e &= miss_e <= tol
        match_o &= miss_o <= tol
    ie, fe = first_true(match_e)
    io, fo = first_true(match_o)
    se, so = 2 * ie, 2 * io + 1
    s = torch.where(fe & (~fo | (se <= so)), se, torch.where(fo, so, 0))
    return s, fe | fo


def dibit_sync_and_pack(
    hi: torch.Tensor, lo: torch.Tensor, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sync + byte-pack a dibit stream given as (hi, lo) lanes: the first
    parity-aligned match (validated by ``pattern2`` when given), packed from
    there. Returns ``(packed, n_valid, found)``."""
    s, found = _dibit_match(hi, lo, pattern + pattern2, len(pattern) // 2, tol, bool(pattern2))
    return (*_pack_from(_interleave(hi, lo), s), found)


_GRAY_HI = (0, 0, 1, 1)  # sector -> hi bit (sectors 0..3 = 0, π/2, π, 3π/2)
_GRAY_LO = (0, 1, 1, 0)  # sector -> lo bit


def _rotate_dibit_pattern(pattern: str, k: int) -> str:
    """The pattern as it appears when every differential sector is shifted
    by +k quarter turns."""
    out = []
    for t in range(0, len(pattern) - 1, 2):
        p_hi, p_lo = int(pattern[t]), int(pattern[t + 1])
        s2 = (2 * p_hi + (p_hi ^ p_lo) + k) % 4
        out.append(f"{_GRAY_HI[s2]}{_GRAY_LO[s2]}")
    return "".join(out)


def relabel_shift_pack(
    hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor, ksel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel the dibit stream by rotation ``ksel`` (sector -> sector - k),
    shift to bit ``s`` and byte-pack: ``(packed, n_valid)``."""
    h, l = hi.to(torch.int32), lo.to(torch.int32)
    s2 = (2 * h + (h ^ l) + (4 - ksel)) & 3
    return _pack_from(_interleave((s2 >= 2).to(torch.uint8), ((s2 == 1) | (s2 == 2)).to(torch.uint8)), s)


def dibit_sync_and_pack_rotations(
    hi: torch.Tensor, lo: torch.Tensor, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sync + pack a dibit stream under the 4 quarter-turn hypotheses: the
    rotated patterns match in turn, the first found rotation (k order) wins
    and the stream relabels and packs once. ``(packed, n_valid, found)``."""
    res = [_dibit_match(hi, lo, _rotate_dibit_pattern(pattern + pattern2, k), len(pattern) // 2, tol,
                        bool(pattern2)) for k in range(4)]
    found4 = torch.stack([f for _, f in res])
    ksel, found = first_true(found4)
    s = torch.stack([s for s, _ in res])[ksel]
    return (*relabel_shift_pack(hi, lo, s, ksel), found)


def bit_sync_and_pack(bits: torch.Tensor, pattern: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align the 1-D bit stream on the first exact ``pattern`` (offset 0
    where it is absent, as the reference does) and pack it to bytes.
    Returns ``(packed, n_valid, found)``."""
    start, found = find_bit_pattern(bits[None], pattern)
    packed, n_valid = pack_bits_from(bits[None], start)
    return packed[0], n_valid[0], found[0]


def bit_sync_and_pack_rotations(
    bits_re: torch.Tensor, bits_im: torch.Tensor, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DBPSK analog: hypotheses re + pattern, im + pattern, re +
    inverted, im + inverted, first found wins; the winner's stream
    (complemented for the inverted ones) packs once."""
    inv = lambda p: "".join("1" if c == "0" else "0" for c in p)  # noqa: E731
    cands = [find_bit_pattern_validated(bits, pat, pat2, tol) for bits, pat, pat2 in (
        (bits_re, pattern, pattern2), (bits_im, pattern, pattern2),
        (bits_re, inv(pattern), inv(pattern2)), (bits_im, inv(pattern), inv(pattern2)))]
    ksel, found = first_true(torch.stack([f for _, f in cands]))
    s = torch.stack([s for s, _ in cands])[ksel]
    use_im = (ksel == 1) | (ksel == 3)
    bits = torch.where(use_im, bits_im, bits_re) ^ (ksel >= 2).to(torch.uint8)
    return (*_pack_from(bits, s), found)


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


@functools.lru_cache(maxsize=16)
def _fir_dec_matrix(low_hz: float, high_hz: float, sample_rate: int, taps: int, dec: int,
                    device: torch.device) -> torch.Tensor:
    """:func:`_fir_dec_template` at 128 output lanes as a tensor on ``device``."""
    return torch.from_numpy(_fir_dec_template(low_hz, high_hz, sample_rate, taps, dec, 128)).to(device)


def analytic_bandpass_fir_dec(
    samples: torch.Tensor, low_hz: float, high_hz: float, sample_rate: int, decimate: int, taps: int = 513,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decimated band-limited analytic signal of a 1-D capture as one matrix
    product: ``z[m] = sum_k h[k] * x[m*decimate + (taps-1)//2 - k]`` with
    the complex band-pass FIR of :func:`_analytic_fir_taps`, blocked as
    overlapped rows of ``128*decimate + taps - decimate`` samples times
    :func:`_fir_dec_template` (128 outputs a row: re lanes | im lanes).
    Returns ``(z_re, z_im)`` of length ``ceil(n / decimate)``."""
    n = samples.shape[-1]
    D, T, L = decimate, taps, 128
    if T - D > L * D:
        raise ValueError("taps - decimate must be <= 128*decimate (row overlap)")
    c = (T - 1) // 2
    nd_out = -(-n // D)
    r = -(-nd_out // L)
    ov = T - D
    xpad = F.pad(samples.to(torch.float32), (c, r * L * D + ov - c - n))
    main = xpad[: r * L * D].reshape(r, L * D)
    nxt = torch.cat([main[1:, :ov], xpad[r * L * D : r * L * D + ov][None, :]], dim=0)
    z2 = torch.cat([main, nxt], dim=1) @ _fir_dec_matrix(
        float(low_hz), float(high_hz), int(sample_rate), T, D, samples.device)
    return z2[:, :L].reshape(r * L)[:nd_out], z2[:, L:].reshape(r * L)[:nd_out]


def analytic_fir_dec_rows(
    rows: torch.Tensor, low_hz: float, high_hz: float, sample_rate: int, decimate: int, taps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`analytic_bandpass_fir_dec` on host-built (r, 128*decimate +
    taps - decimate) windows of ``[zeros((taps-1)//2), x]``, the same
    windows the flat form builds, so the outputs are equal. Returns flat
    ``(z_re, z_im)`` of length ``r*128``."""
    D, T, L = decimate, taps, 128
    if rows.shape[-1] != L * D + T - D:
        raise ValueError("rows must be (r, 128*decimate + taps - decimate)")
    z2 = rows.to(torch.float32) @ _fir_dec_matrix(float(low_hz), float(high_hz), int(sample_rate), T, D,
                                                 rows.device)
    r = rows.shape[0]
    return z2[:, :L].reshape(r * L), z2[:, L:].reshape(r * L)


# --- the FFT front ends and framing ---------------------------------------------

def analytic_bandpass(
    samples: torch.Tensor, low_hz: float, high_hz: float, sample_rate: int, decimate: int = 1,
) -> torch.Tensor:
    """Band-limited analytic signal (complex64) by one FFT round trip: the
    positive frequencies in ``[low_hz, high_hz]`` kept and doubled (DC kept
    once when the band reaches it), over the last axis zero-padded to a
    power of two. ``decimate=D > 1`` returns ``z[::D]`` exactly: the masked
    spectrum lies in bins ``[0, n_fft/D)``, so the inverse FFT of those bins
    at 1/D length is the decimated signal; it needs ``high_hz <
    sample_rate/D`` and D dividing the padded length."""
    n = samples.shape[-1]
    n_fft = 1 << (n - 1).bit_length()
    x = samples.to(torch.float32)
    if n_fft != n:
        x = F.pad(x, (0, n_fft - n))
    dev = x.device
    # np.fft.fftfreq's values: the bin numbers times 1 / (n_fft / rate), in float64.
    k = torch.arange(n_fft, dtype=torch.float64, device=dev)
    k[(n_fft + 1) // 2 :] -= n_fft
    freqs = k * (1.0 / (n_fft * (1.0 / sample_rate)))
    band = ((freqs >= max(low_hz, 0.0)) & (freqs <= high_hz)).to(torch.float32) * 2.0
    if low_hz <= 0.0:
        band[0] = 1.0
    if decimate == 1:
        z = torch.fft.ifft(torch.fft.fft(x) * band)
        return z[..., :n] if n_fft != n else z
    if high_hz >= sample_rate / decimate:
        raise ValueError(f"band edge {high_hz} aliases at decimation {decimate}")
    if n_fft % decimate:
        raise ValueError("decimate must be a power of two (divides the padded FFT)")
    nd = n_fft // decimate
    spec = torch.fft.rfft(x)[..., :nd] * band[:nd]
    z = torch.fft.ifft(spec) / float(decimate)
    return z[..., : -(-n // decimate)]


_OLS_BLOCK = 1 << 17  # overlap-save FFT block (power of 2)


def analytic_bandpass_fir(
    samples: torch.Tensor, low_hz: float, high_hz: float, sample_rate: int, taps: int = 1025,
    block: int = _OLS_BLOCK,
) -> torch.Tensor:
    """Band-limited analytic signal (complex64) by exact linear convolution
    with :func:`_analytic_fir_taps`, delay-centred so the output lines up
    with the input, as overlap-save FFT blocks of ``block`` samples (one
    block of the smallest power of two, at least 256, for a short capture)
    over the last axis."""
    n = samples.shape[-1]
    T = taps
    V = T - 1
    c = V // 2
    if n + V > block:
        blk = block
    else:
        blk = max(256, 1 << int(np.ceil(np.log2(n + V))))
    step = blk - V
    nb = -(-(n + c) // step)
    x = samples.to(torch.float32)
    lead = x.shape[:-1]
    # xp[m] = x[m - V] over [0, (nb+1)*step): the left V zeros give each block
    # its overlap context, the right zeros square off the reshape.
    xp = F.pad(x, (V, (nb + 1) * step - V - n))
    main = xp[..., : nb * step].reshape(*lead, nb, step)
    tail = xp[..., step : (nb + 1) * step].reshape(*lead, nb, step)[..., :V]
    segs = torch.cat([main, tail], dim=-1)  # (..., nb, blk)
    h = _analytic_fir_taps(float(low_hz), float(high_hz), int(sample_rate), taps)
    H = torch.from_numpy(np.fft.fft(np.pad(h, (0, blk - T))).astype(np.complex64)).to(x.device)
    y = torch.fft.ifft(torch.fft.fft(segs) * H)[..., V:]  # (..., nb, step)
    return y.reshape(*lead, nb * step)[..., c : c + n]


def frame_signal(x: torch.Tensor, frame_len: int, hop: int, n_frames: int) -> torch.Tensor:
    """Overlapping frames ``x[k*hop : k*hop+frame_len]`` of a 1-D signal as
    an (n_frames, frame_len) matrix, zeros past its end: two reshapes and a
    concatenation when ``frame_len == 2*hop``, a gather otherwise."""
    n = x.shape[-1]
    if frame_len == 2 * hop:
        need = (n_frames + 1) * hop
        xp = F.pad(x, (0, max(0, need - n)))
        a = xp[: n_frames * hop].reshape(n_frames, hop)
        b = xp[hop : hop + n_frames * hop].reshape(n_frames, hop)
        return torch.cat([a, b], dim=1)
    idx = torch.arange(n_frames, device=x.device)[:, None] * hop + torch.arange(frame_len, device=x.device)[None, :]
    xp = F.pad(x, (0, max(0, int(idx.max()) + 1 - n)))
    return xp[idx]
