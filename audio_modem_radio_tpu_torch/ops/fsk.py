"""Continuous-phase FSK on PyTorch: modulation and the batched receive.

Counterpart of ``audio_modem_radio_tpu/ops/fsk.py`` for the batched FSK
slices. The wire format is the same: a ``0xAA AA AA AA`` byte preamble,
MSB-first bits, one sine tone per bit (mark = 1, space = 0) with a running
phase accumulator, output scaled by 0.9, and a one-byte ``0xAA`` postamble.

Receive picks one of three detectors from the tone separation in cycles per
bit, as the JAX package does, each in two passes with the batch dimension
written out:

* dual tone (separation >= 0.8: FSK1200, MSK, FT8), over host-overlapped
  (B, r, row+ov) rows: pass 1 scores the timing offsets on three row
  windows (one float32 ``torch.matmul``), then kernel K7
  (``ops.kernels.fsk_tile_bits_batch``) projects every bit onto the
  {mark, space} x {sin, cos} dual basis at the winning offset and decides
  E_mark > E_space. :func:`fsk_demod_bits_batch` does the same on flat
  (B, N) captures through K13 (``fsk_project_bits_batch``);
* discriminator (separation < 0.4: FSK9600), over the FIR input windows of
  :func:`fsk_disc_row_shape`: pass 1 scores offsets on three windows, then
  kernel K8 (``fsk_disc_sums_batch``) runs the decimating analytic FIR, the
  phasor z[n+1]·conj z[n] and the fractional per-bit boxcar; atan2, the
  calibrated 9-tap equalizer and the tone decision follow in plain torch;
* quadrature (0.4 <= separation < 0.8: FSK19200), over the windows of
  :func:`fsk_quad_row_shape`: pass 1, then kernel K9
  (``fsk_quad_margin_batch``): the analytic FIR at full rate, the per-bit
  tone quadratures and the noncoherent margin E_mark - E_space.

The single-capture receiver :func:`fsk_demod_bits` takes one capture,
flat or in host-shaped rows, through the same three detectors: the dual
tone as a batch of one through pass 1 and K7, the quadrature and
discriminator paths in plain torch (the JAX package runs them as plain
XLA) behind the decimating analytic FIR of
``ops.common.analytic_bandpass_fir_dec``. On the
discriminator path :func:`_mlse_refine` then runs a maximum-likelihood
sequence detector over the CPFSK phase trellis on the raw samples' local
tone quadratures; its Viterbi (two ``lax.scan``s in the JAX package, one
device-side loop each) is the hand-written kernel
``ops.kernels.mlse_viterbi_blocks`` (``csrc/mlse_viterbi.cu``).
:func:`fsk_demodulate` wraps it with the sync tail and the equalizer-only
fallback.

The tables are numpy, built with the JAX package's formulas (the equalizer
calibration included), so both packages hold bitwise-equal tables.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..framing import MAGIC_BIT_PATTERN, parse_frames
from ..utils.torchenv import DeviceLike
from .common import (
    _analytic_fir_taps,
    _fir_dec_template,
    analytic_bandpass_fir_dec,
    analytic_fir_dec_rows,
    bit_sync_and_pack,
    bytes_to_bits,
)
from .kernels import (
    disc_phasor_rows,
    fsk_disc_sums_batch,
    fsk_project_bits_batch,
    fsk_quad_margin_batch,
    fsk_tile_bits_batch,
    mlse_viterbi_blocks,
    quad_analytic_rows,
    quad_margins,
)
from .psk import _to_device

FSK_PREAMBLE = b"\xAA\xAA\xAA\xAA"

# Block-parallel MLSE geometry: Viterbi blocks of CORE bits with OVERLAP-bit
# warm-up and cool-down on each side (survivor paths merge within a few
# hundred bits).
_MLSE_BLOCK_CORE = 1 << 13
_MLSE_BLOCK_OVERLAP = 1 << 10


def _mm_taps(dec: int) -> int:
    """Taps of the decimating matmul FIR front end: at most 129, and the
    window overlap ``taps - dec`` stays within ``128*dec``."""
    return min(129, 128 * dec + 1)


def _samples_per_bit(sample_rate: int, baud: float) -> int:
    # round(), matching the reference.
    return int(round(sample_rate / baud))


@functools.lru_cache(maxsize=64)
def _tone_basis(spb: int, mark: float, space: float, sample_rate: int) -> np.ndarray:
    """(4, spb): rows = sin/cos of the mark tone, sin/cos of the space tone."""
    t = np.arange(spb, dtype=np.float64) / sample_rate
    wm, ws = 2 * np.pi * mark * t, 2 * np.pi * space * t
    return np.stack([np.sin(wm), np.cos(wm), np.sin(ws), np.cos(ws)]).astype(np.float32)


def fsk_modulate(
    data_bytes: bytes,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
) -> np.ndarray:
    """CPFSK with exact continuous phase across bit boundaries, plus a
    one-byte ``0xAA`` postamble that keeps the receive front end's edge
    transient off the last payload bit (parsers ignore it).

    Each bit's starting phase is accumulated in exact integer units of
    ``1/samp_rate`` cycles; the waveform is one ``(n_bits, 4) @ (4, spb)``
    product of (cos φ, sin φ) routed to the bit's tone against the tones'
    (sin, cos) basis rows."""
    spb = _samples_per_bit(samp_rate, baud)
    bits = bytes_to_bits(FSK_PREAMBLE + data_bytes + b"\xAA").astype(np.int64)
    inc_mark = int(round(mark_freq * spb)) % samp_rate
    inc_space = int(round(space_freq * spb)) % samp_rate
    incs = np.where(bits == 1, inc_mark, inc_space)
    phase_units = np.concatenate([[0], np.cumsum(incs[:-1])]) % samp_rate
    phi = 2 * np.pi * phase_units / samp_rate
    cphi, sphi = np.cos(phi), np.sin(phi)
    is_mark = bits == 1
    coeff = np.stack(
        [cphi * is_mark, sphi * is_mark, cphi * ~is_mark, sphi * ~is_mark], axis=1
    ).astype(np.float32)
    basis = torch.from_numpy(_tone_basis(spb, float(mark_freq), float(space_freq), int(samp_rate)))
    out = (torch.from_numpy(coeff) @ basis).reshape(-1) * torch.tensor(0.9, dtype=torch.float32)
    return out.numpy()


def fsk_high_speed_modulate(data_bytes: bytes, baud: float = 19200, samp_rate: int = 96000) -> np.ndarray:
    """High-rate FSK: 8/16 kHz tones at 19200 baud."""
    return fsk_modulate(data_bytes, baud, 8000.0, 16000.0, samp_rate)


# --- receive geometry and tables (numpy, the JAX package's formulas) ------------

def _separation_cycles(baud: float, mark: float, space: float, sample_rate: int) -> float:
    return abs(mark - space) * _samples_per_bit(sample_rate, baud) / sample_rate


def _fsk_geometry(spb: int) -> Tuple[int, int, int]:
    """(symbols_per_row, row, overlap) of the dual-tone blocked layout: the
    row ``spr*spb`` is a multiple of 128 near 1024 samples, the overlap
    covers a bit window shifted by up to one bit into the next row."""
    unit = 128 // math.gcd(spb, 128)
    spr = unit * max(1, -(-1024 // (unit * spb)))
    row = spr * spb
    ov = 128 * (-(-spb // 128))
    return spr, row, ov


@functools.lru_cache(maxsize=64)
def _fsk_blocked_templates(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) block-diagonal least-squares dual basis of
    the joint {mark, space} x {sin, cos} subspace per bit: columns
    [mark_sin x spr | mark_cos x spr | space_sin x spr | space_cos x spr];
    bit s at offset i occupies rows [s*spb + o, s*spb + o + spb),
    o = i*spb // n_offsets (row-relative time)."""
    spr, row, ov = _fsk_geometry(spb)
    t = np.arange(row + ov, dtype=np.float64) / sample_rate
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            B = np.stack(
                [
                    np.sin(2 * np.pi * mark * t[sl]),
                    np.cos(2 * np.pi * mark * t[sl]),
                    np.sin(2 * np.pi * space * t[sl]),
                    np.cos(2 * np.pi * space * t[sl]),
                ],
                axis=1,
            )
            G = B.T @ B + 1e-6 * np.eye(4)
            D = B @ np.linalg.inv(G)
            W[i, sl, s] = D[:, 0]
            W[i, sl, spr + s] = D[:, 1]
            W[i, sl, 2 * spr + s] = D[:, 2]
            W[i, sl, 3 * spr + s] = D[:, 3]
    return W


def fsk_blocked_row_shape(
    n_samples: int, baud: float, mark: float, space: float, sample_rate: int
):
    """Host helper: (r, row, ov) of the dual-tone overlapped rows, or None for
    close tones (separation < 0.8) and captures under two bits."""
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        return None
    spb = _samples_per_bit(sample_rate, baud)
    n_bits = n_samples // spb
    if n_bits < 2:
        return None
    spr, row, ov = _fsk_geometry(spb)
    return -(-n_bits // spr), row, ov


def fsk_dual_rows_batch_plan(spb: int, r: int) -> Optional[int]:
    """The JAX package's TPU layout rule: 256-row blocks when spr divides 128
    (and spr >= 8) and r is a multiple of 256, else None (unpadded rows).
    Host shaping keeps this rule; the port's K7 itself takes any spr and r."""
    spr, _row, _ov = _fsk_geometry(spb)
    if spr < 8 or 128 % spr:
        return None
    blk = 256
    return blk if r % blk == 0 else None


def _discriminator_decimation(spb: int, band_hi: float, sample_rate: int) -> int:
    """Largest power-of-2 decimation (at most 8) that keeps the band under
    the decimated Nyquist rate and at least 2 decimated samples per bit."""
    d = 1
    while 2 * d <= 8 and band_hi < sample_rate / (2 * d) and 2 * (2 * d) <= spb:
        d *= 2
    return d


def _fsk_geometry_dec(spb: int, dec: int) -> Tuple[int, int, int]:
    """(symbols_per_row, row, overlap) on the decimated grid; ``dec=1``
    reproduces :func:`_fsk_geometry`."""
    g = math.gcd(spb, 128 * dec)
    unit = (128 * dec) // g
    lanes_per_bit = spb / dec
    spr = unit * max(1, math.ceil(1024 / (unit * lanes_per_bit)))
    row = spr * spb // dec
    ov = 128 * max(1, math.ceil(2 * lanes_per_bit / 128))
    return spr, row, ov


# Discriminator per-bit averaging window as (lo, hi) fractions of the bit.
_CORE_FRAC = (0.0, 1.0)


def _core_bounds(spb: int) -> Tuple[int, int]:
    lo = int(spb * _CORE_FRAC[0])
    hi = max(lo + 2, int(np.ceil(spb * _CORE_FRAC[1])))
    return lo, hi


def _fsk_boxcar_templates_geom(
    spb: int, n_offsets: int, dec: int, spr: int, row: int, ov: int
) -> np.ndarray:
    """(n_offsets, row+ov, spr) per-bit boxcars on the decimated grid: a tap
    covering full-rate samples [n*dec, (n+1)*dec) weighs its overlap with
    the bit window [s*spb + o + core_lo, s*spb + o + core_hi), over dec."""
    core_lo, core_hi = _core_bounds(spb)
    W = np.zeros((n_offsets, row + ov, spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            lo = s * spb + o + core_lo
            hi = s * spb + o + core_hi
            a = lo // dec
            b = min(-(-hi // dec), row + ov)
            if b <= a:
                a, b = min(a, row + ov - 1), min(a, row + ov - 1) + 1
            for n in range(a, b):
                ovl = min(hi, (n + 1) * dec) - max(lo, n * dec)
                W[i, n, s] = max(ovl, 0) / dec
            if W[i, a:b, s].sum() == 0:
                W[i, a, s] = 1.0  # degenerate window: keep one tap
    return W


@functools.lru_cache(maxsize=64)
def _fsk_boxcar_templates_dec(spb: int, n_offsets: int, dec: int) -> np.ndarray:
    """:func:`_fsk_boxcar_templates_geom` on :func:`_fsk_geometry_dec`'s rows."""
    spr, row, ov = _fsk_geometry_dec(spb, dec)
    return _fsk_boxcar_templates_geom(spb, n_offsets, dec, spr, row, ov)


def _fir_frontend_plan(baud: float, mark: float, space: float, sample_rate: int) -> Tuple[float, float, int, int]:
    """(band_lo, band_hi, dec, taps) of the FIR front end for a close- or
    mid-separation configuration."""
    spb = _samples_per_bit(sample_rate, baud)
    sep = _separation_cycles(baud, mark, space, sample_rate)
    lo_f, hi_f = min(mark, space), max(mark, space)
    band_lo = max(lo_f - baud, 10.0)
    band_hi = min(hi_f + baud, sample_rate / 2 - 10.0)
    if sep >= 0.4:  # mid separation: analytic image suppression only, dec=1
        return band_lo, band_hi, 1, 129
    dec = _discriminator_decimation(spb, band_hi, sample_rate)
    return band_lo, band_hi, dec, _mm_taps(dec)


def fsk_fir_row_shape(n_samples: int, baud: float, mark: float, space: float, sample_rate: int):
    """Host helper: (r, row=128*dec, ov=taps-dec, lead=(taps-1)//2) of the
    unpadded FIR windows, or None for dual-tone configs and short captures."""
    if _separation_cycles(baud, mark, space, sample_rate) >= 0.8:
        return None
    spb = _samples_per_bit(sample_rate, baud)
    if n_samples // spb < 2:
        return None
    _lo, _hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    nd_out = -(-n_samples // dec)
    r = -(-nd_out // 128)
    return r, 128 * dec, taps - dec, (taps - 1) // 2


def _fsk_disc_kernel_plan(spb: int, dec: int, taps: int) -> Optional[dict]:
    """Geometry of the fused FIR-window layout, or None when it does not map:
    ``row2`` is the smallest 128-multiple holding whole bits (row2*dec %
    spb == 0), boxcar rows come in blocks of nrow2 = 128, FB = nrow2*row2/128
    FIR rows, and the FIR window is ``c = 128*dec + taps - dec`` samples,
    padded to c_pad."""
    if spb > 64 * dec:
        return None
    g = math.gcd(spb, dec)
    base = spb // g
    row2 = base * 128 // math.gcd(base, 128)
    if row2 > 2560:
        return None
    nrow2 = 128
    fb = nrow2 * row2 // 128
    c = 128 * dec + taps - dec
    return {
        "dec": dec,
        "taps": taps,
        "c": c,
        "c_pad": -(-c // 128) * 128,
        "row2": row2,
        "spr2": row2 * dec // spb,
        "ov2": 128,
        "nrow2": nrow2,
        "fb": fb,
    }


def _fused_row_shape(n_samples: int, plan: dict):
    """(r, row=128*dec, ov=c_pad-row, lead=(taps-1)//2) of the fused layouts:
    r = 128-sample rows of decimated output, rounded up to FB."""
    nd_out = -(-n_samples // plan["dec"])
    r = -(-nd_out // 128)
    r = -(-r // plan["fb"]) * plan["fb"]
    row = 128 * plan["dec"]
    return r, row, plan["c_pad"] - row, (plan["taps"] - 1) // 2


def fsk_disc_row_shape(n_samples: int, baud: float, mark: float, space: float, sample_rate: int):
    """Host helper: (r, row, ov, lead) of the discriminator's padded FIR
    windows (rows ``[zeros(lead), x][i*row : i*row + row + ov]``), or None
    when the config is no discriminator config or the plan does not map."""
    if _separation_cycles(baud, mark, space, sample_rate) >= 0.4:
        return None
    spb = _samples_per_bit(sample_rate, baud)
    if n_samples // spb < 2:
        return None
    _lo, _hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    plan = _fsk_disc_kernel_plan(spb, dec, taps)
    if plan is None:
        return None
    return _fused_row_shape(n_samples, plan)


def _fir_padded_template(
    band_lo: float, band_hi: float, sample_rate: int, taps: int, dec: int, plan: dict
) -> np.ndarray:
    """(c_pad, 256) decimating analytic-FIR matrix, zero rows to c_pad."""
    wf = _fir_dec_template(band_lo, band_hi, sample_rate, taps, dec, 128)
    wf_pad = np.zeros((plan["c_pad"], 256), np.float32)
    wf_pad[: wf.shape[0]] = wf
    return wf_pad


_EQ_TAPS = 9  # calibrated discriminator equalizer length (per-bit taps)


def _np_vector_bit_freqs(
    wave: np.ndarray, band_lo: float, band_hi: float, sr: int, spb: int,
    core_lo: int, core_hi: int, n_bits: int, fir_taps: int = 0, dec: int = 1,
) -> np.ndarray:
    """Host reference of the discriminator front end, for calibration: per
    bit, the angle of the fractional-weight vector sum of z[n+1]·conj z[n]
    over the bit window, as a frequency. ``fir_taps`` > 0 uses the FIR front
    end, 0 a brick-wall FFT band mask."""
    n = len(wave)
    if fir_taps:
        h = _analytic_fir_taps(band_lo, band_hi, sr, fir_taps)
        c = (fir_taps - 1) // 2
        m = 1 << int(np.ceil(np.log2(n + fir_taps)))
        z = np.fft.ifft(np.fft.fft(wave.astype(np.float64), m) * np.fft.fft(h, m))
        z = z[c : c + n]
    else:
        spec = np.fft.fft(wave.astype(np.float64))
        freqs = np.fft.fftfreq(len(wave), d=1.0 / sr)
        spec *= 2.0 * ((freqs >= band_lo) & (freqs <= band_hi))
        z = np.fft.ifft(spec)
    if dec > 1:
        z = z[::dec]
    p = z[1:] * np.conj(z[:-1])
    out = np.empty(n_bits)
    for k in range(n_bits):
        lo = k * spb + core_lo
        hi = k * spb + core_hi
        a = lo // dec
        b = min(-(-hi // dec), len(p))
        if b <= a:
            out[k] = 0.0
            continue
        taps = p[a:b]
        n_idx = np.arange(a, b)
        wgt = (np.minimum(hi, (n_idx + 1) * dec) - np.maximum(lo, n_idx * dec)).clip(0) / dec
        acc = (taps * wgt).sum()
        out[k] = np.angle(acc) * sr / dec / (2 * np.pi) if abs(acc) > 0 else 0.0
    return out


@functools.lru_cache(maxsize=64)
def _discriminator_calibration(
    spb: int, baud: float, mark: float, space: float, sample_rate: int,
    band_lo: float, band_hi: float, fir_taps: int = 0, dec: int = 1,
) -> np.ndarray:
    """Least-squares fit of a ``_EQ_TAPS``-tap per-bit equalizer plus bias
    mapping the measured bit frequencies of a known pseudo-random CPFSK
    sequence (seed 0xFB9C) through the exact front end to the true tones.
    Returns (taps..., bias) as float32."""
    rng = np.random.default_rng(0xFB9C)
    train = rng.integers(0, 256, 3200, dtype=np.uint8).tobytes()
    bits = bytes_to_bits(FSK_PREAMBLE + train).astype(np.float64)
    inc = np.where(
        bits == 1, int(round(mark * spb)) % sample_rate, int(round(space * spb)) % sample_rate
    )
    phase0 = np.concatenate([[0], np.cumsum(inc[:-1])]) % sample_rate
    t = np.arange(spb, dtype=np.float64) / sample_rate
    tones = np.where(bits[:, None] == 1, mark, space)
    wave = 0.9 * np.sin(2 * np.pi * (tones * t[None, :] + phase0[:, None] / sample_rate)).reshape(-1)
    f_true = np.where(bits == 1, mark, space)
    core_lo, core_hi = _core_bounds(spb)
    means = _np_vector_bit_freqs(
        wave, band_lo, band_hi, sample_rate, spb, core_lo, core_hi, len(bits),
        fir_taps=fir_taps, dec=dec,
    )
    pad = _EQ_TAPS // 2
    fm = np.pad(means, pad, mode="edge")
    A = np.stack([fm[j : j + len(bits)] for j in range(_EQ_TAPS)] + [np.ones(len(bits))], axis=1)
    coef, *_ = np.linalg.lstsq(A, f_true, rcond=None)
    return coef.astype(np.float32)


def _disc_templates(spb: int, baud: float, mark: float, space: float, sample_rate: int, n_offsets: int):
    """(plan, W_fir (c_pad, 256), W_box (n_offsets, row2+ov2, spr2), band_lo, band_hi)."""
    band_lo, band_hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    plan = _fsk_disc_kernel_plan(spb, dec, taps)
    wf_pad = _fir_padded_template(band_lo, band_hi, sample_rate, taps, dec, plan)
    wb = _fsk_boxcar_templates_geom(spb, n_offsets, dec, plan["spr2"], plan["row2"], plan["ov2"])
    return plan, wf_pad, wb, band_lo, band_hi


def _fsk_quadrature_templates_geom(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int,
    spr: int, row: int, ov: int,
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) tone quadratures [cos_m | sin_m | cos_s |
    sin_s] per bit on an explicit geometry (row-relative time)."""
    t = np.arange(row + ov, dtype=np.float64) / sample_rate
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            W[i, sl, s] = np.cos(2 * np.pi * mark * t[sl])
            W[i, sl, spr + s] = np.sin(2 * np.pi * mark * t[sl])
            W[i, sl, 2 * spr + s] = np.cos(2 * np.pi * space * t[sl])
            W[i, sl, 3 * spr + s] = np.sin(2 * np.pi * space * t[sl])
    return W


def fsk_quad_row_shape(n_samples: int, baud: float, mark: float, space: float, sample_rate: int):
    """Host helper: (r, row=128, ov, lead) of the quadrature path's padded
    FIR windows (0.4 <= separation < 0.8), or None when it does not map
    (spr2 must be a multiple of 128, as in the JAX package)."""
    sep = _separation_cycles(baud, mark, space, sample_rate)
    if not (0.4 <= sep < 0.8):
        return None
    spb = _samples_per_bit(sample_rate, baud)
    if n_samples // spb < 2:
        return None
    _lo, _hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    plan = _fsk_disc_kernel_plan(spb, dec, taps)
    if plan is None or plan["spr2"] % 128:
        return None
    return _fused_row_shape(n_samples, plan)


def _quad_templates(spb: int, baud: float, mark: float, space: float, sample_rate: int, n_offsets: int):
    """(plan, W_fir (c_pad, 256), W_quad (n_offsets, row2+ov2, 4*spr2))."""
    band_lo, band_hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    plan = _fsk_disc_kernel_plan(spb, dec, taps)
    wf_pad = _fir_padded_template(band_lo, band_hi, sample_rate, taps, dec, plan)
    wq = _fsk_quadrature_templates_geom(
        spb, mark, space, sample_rate, n_offsets, plan["spr2"], plan["row2"], plan["ov2"]
    )
    return plan, wf_pad, wq


@functools.lru_cache(maxsize=64)
def _device_tables(kind: str, spb: int, baud: float, mark: float, space: float,
                   sample_rate: int, n_offsets: int, device: torch.device):
    """The path's tables as float32 tensors on ``device``: ("dual", W),
    ("disc", plan, W_fir, W_box, coef) or ("quad", plan, W_fir, W_quad) for
    the batch; for the single-capture receiver ("quad1", W_quad) and
    ("local", W_local) on the dual-tone geometry, and ("disc1", W_box,
    coef) on the decimated one."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if kind == "dual":
        return dev(_fsk_blocked_templates(spb, mark, space, sample_rate, n_offsets)),
    if kind == "quad1":
        return dev(_fsk_quadrature_templates(spb, mark, space, sample_rate, n_offsets)),
    if kind == "local":
        return dev(_fsk_local_quadrature_templates(spb, mark, space, sample_rate, n_offsets)),
    if kind == "disc1":
        blo, bhi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
        coef = _discriminator_calibration(spb, baud, mark, space, sample_rate, float(blo), float(bhi),
                                          fir_taps=taps, dec=dec)
        return dev(_fsk_boxcar_templates_dec(spb, n_offsets, dec)), coef
    if kind == "disc":
        plan, wf, wb, blo, bhi = _disc_templates(spb, baud, mark, space, sample_rate, n_offsets)
        coef = _discriminator_calibration(spb, baud, mark, space, sample_rate, float(blo), float(bhi),
                                          fir_taps=plan["taps"], dec=plan["dec"])
        return plan, dev(wf), dev(wb), coef
    plan, wf, wq = _quad_templates(spb, baud, mark, space, sample_rate, n_offsets)
    return plan, dev(wf), dev(wq)


def _window_starts(r: int) -> Tuple[int, list]:
    """Pass 1's row windows: (wr, starts) of up to 3 windows of 32 rows."""
    wr = min(32, r)
    return wr, sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)})


# --- dual tone: K7 on host-overlapped rows, K13 on flat captures -------------------

def _dual_scores(wins: torch.Tensor, W: torch.Tensor, spr: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, nw, row+ov) float32 windows -> (best (B,) int32 offset, score
    (B, n_offsets)): the sum of |E_mark - E_space| over every window bit,
    per offset."""
    b = wins.shape[0]
    n_offsets, c, _ = W.shape
    W_all = W.permute(1, 0, 2).reshape(c, -1)
    pj = (wins @ W_all).reshape(b, -1, n_offsets, 4, spr)
    em = pj[..., 0, :] ** 2 + pj[..., 1, :] ** 2
    es = pj[..., 2, :] ** 2 + pj[..., 3, :] ** 2
    score = torch.sum(torch.abs(em - es), dim=(1, 3))
    return torch.argmax(score, dim=1).to(torch.int32), score


def _dual_pass1(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int, n_offsets: int,
):
    """:func:`fsk_dual_pass1` that also returns the per-offset scores:
    ``(best, score (B, n_offsets), W, spr)``."""
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        raise ValueError("fsk_dual_bits_rows_batch requires a dual-tone config")
    spr, row, ov = _fsk_geometry(spb)
    b, r, c = x3d.shape
    if c != row + ov:
        raise ValueError("pre-shaped dual-tone rows must have row+ov columns")
    (W,) = _device_tables("dual", spb, float(baud), float(mark), float(space), sample_rate,
                          n_offsets, x3d.device)
    wr, starts = _window_starts(r)
    wins = torch.cat([x3d[:, s : s + wr] for s in starts], dim=1).to(torch.float32)
    best, score = _dual_scores(wins, W, spr)
    return best, score, W, spr


def fsk_dual_pass1(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
):
    """Pass 1 over host-overlapped (B, r, row+ov) rows: the offsets scored on
    three 32-row windows. Returns ``(best (B,) int32, W, spr)``."""
    best, _score, W, spr = _dual_pass1(x3d, baud, mark, space, sample_rate, n_offsets)
    return best, W, spr


def fsk_dual_bits_rows_batch(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Dual-tone FSK over host-overlapped (B, r, row+ov) rows (float32 or
    int16): pass 1, then K7. Returns uint8 bits (B, r*spr); entries past
    each capture's signal are pad garbage."""
    best, W, spr = fsk_dual_pass1(x3d, baud, mark, space, sample_rate, n_offsets)
    return fsk_tile_bits_batch(x3d, W, best, rows_per_capture=x3d.shape[1], spr=spr)


def fsk_demod_bits_batch(
    samples: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Dual-tone FSK over flat (B, N) captures: rows of ``row`` samples
    (r rounded up to 256), pass 1 on three windows with their next-row
    overlaps, then K13, whose overlap is the next row's head. Returns uint8
    bits (B, N // spb)."""
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        raise ValueError("fsk_demod_bits_batch requires a dual-tone config")
    spr, row, ov = _fsk_geometry(spb)
    b, n = samples.shape
    n_bits = n // spb
    if n_bits < 2 * spr:
        raise ValueError("signal shorter than two rows of bits")
    blk = 256
    r0 = -(-n_bits // spr)
    r = max(blk, -(-r0 // blk) * blk)
    x = samples.to(torch.float32)[:, : n_bits * spb]
    x3d = torch.nn.functional.pad(x, (0, r * row - n_bits * spb)).reshape(b, r, row)
    (W,) = _device_tables("dual", spb, float(baud), float(mark), float(space), sample_rate,
                          n_offsets, samples.device)
    wr, starts = _window_starts(r0)
    wins = torch.cat(
        [torch.cat([x3d[:, s : s + wr], x3d[:, min(s + 1, r - wr) : min(s + 1, r - wr) + wr, :ov]], dim=2)
         for s in starts],
        dim=1,
    )
    best, _score = _dual_scores(wins, W, spr)
    bits = fsk_project_bits_batch(x3d, W, best, rows_per_capture=r, spr=spr)
    return bits[:, :n_bits]


# --- close and mid separation: K8 and K9 on FIR windows ----------------------------

def _fir_windows(x3d: torch.Tensor, r2: int, rows_pb: int) -> Tuple[torch.Tensor, int]:
    """Pass 1's FIR windows: up to 3 groups of ``w2*rows_pb + 2`` FIR rows
    (the +2 feed the phasor's lookahead), folded into the batch axis so no
    stream crosses a window boundary. Returns (windows, w2)."""
    b, r, c = x3d.shape
    w2 = min(4, r2)
    nf_win = w2 * rows_pb + 2
    s2_max = max(0, (r - nf_win) // rows_pb)
    starts2 = sorted({0, min(max(0, r2 // 2 - w2 // 2), s2_max), min(max(0, r2 - w2), s2_max)})
    wins = torch.cat([x3d[:, s * rows_pb : s * rows_pb + nf_win] for s in starts2], dim=1)
    return wins.reshape(b * len(starts2), nf_win, c), w2


def _check_fused_rows(x3d: torch.Tensor, plan: dict, name: str) -> Tuple[int, int, int]:
    b, r, c = x3d.shape
    if c != plan["c_pad"] or r % plan["fb"]:
        raise ValueError(f"rows do not match {name} for this config")
    return b, r, r * 128 // plan["row2"]


def fsk_disc_pass1(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
):
    """Pass 1 over :func:`fsk_disc_row_shape` windows: the energy-weighted,
    deviation-clamped frequency score of every offset on three windows.
    Returns ``(best (B,) int32, plan, W_fir, W_box, coef)``."""
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) >= 0.4:
        raise ValueError("fsk_disc_bits_rows_batch requires a discriminator config")
    plan, Wf, Wb, coef = _device_tables("disc", spb, float(baud), float(mark), float(space),
                                        sample_rate, n_offsets, x3d.device)
    row2, spr2, ov2 = plan["row2"], plan["spr2"], plan["ov2"]
    b, r, r2 = _check_fused_rows(x3d, plan, "fsk_disc_row_shape")
    mid = (mark + space) / 2.0
    dev = abs(space - mark) / 2.0
    wins, w2 = _fir_windows(x3d, r2, row2 // 128)
    pr_w, pi_w = disc_phasor_rows(wins, Wf, w2, row2, ov2)
    Wb_all = Wb.permute(1, 0, 2).reshape(row2 + ov2, -1)
    wins_r = pr_w.reshape(b, -1, row2 + ov2) @ Wb_all
    wins_i = pi_w.reshape(b, -1, row2 + ov2) @ Wb_all
    f_win = torch.atan2(wins_i, wins_r) * _disc_scale(sample_rate, plan)
    mag_w = torch.sqrt(wins_r**2 + wins_i**2)
    score = torch.sum(
        (mag_w * torch.clamp(torch.abs(f_win - mid), max=dev)).reshape(b, -1, n_offsets, spr2),
        dim=(1, 3),
    )
    return torch.argmax(score, dim=1).to(torch.int32), plan, Wf, Wb, coef


def _disc_scale(sample_rate: int, plan: dict) -> float:
    """Hz per radian of the decimated phasor."""
    return sample_rate / plan["dec"] / (2 * math.pi)


def fsk_disc_bits_rows_batch(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Close-tone FSK discriminator over :func:`fsk_disc_row_shape` windows
    (float32 or int16): pass 1, K8's per-bit vector sums, then atan2, the
    calibrated equalizer and the tone decision. Returns uint8 bits
    (B, r2*spr2)."""
    best, plan, Wf, Wb, coef = fsk_disc_pass1(x3d, baud, mark, space, sample_rate, n_offsets)
    sr_sum, si_sum = fsk_disc_sums_batch(
        x3d, Wf, Wb, best, rows_per_capture=x3d.shape[1], nrow2=plan["nrow2"], row2=plan["row2"],
        ov2=plan["ov2"], spr2=plan["spr2"],
    )
    return disc_decide(sr_sum, si_sum, plan, coef, sample_rate, mark, space)


def disc_decide(sr_sum: torch.Tensor, si_sum: torch.Tensor, plan: dict, coef: np.ndarray,
                sample_rate: int, mark: float, space: float) -> torch.Tensor:
    """K8's per-bit vector sums -> bits: atan2 to a frequency, the calibrated
    ``_EQ_TAPS``-tap equalizer (edges repeated), the nearer tone."""
    f = torch.atan2(si_sum, sr_sum) * _disc_scale(sample_rate, plan)
    pad = _EQ_TAPS // 2
    n = f.shape[1]
    fm = torch.cat([f[:, :1].expand(-1, pad), f, f[:, -1:].expand(-1, pad)], dim=1)
    eq = torch.full_like(f, float(coef[-1]))
    for j in range(_EQ_TAPS):
        eq = eq + float(coef[j]) * fm[:, j : j + n]
    return (torch.abs(eq - mark) < torch.abs(eq - space)).to(torch.uint8)


def fsk_quad_pass1(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
):
    """Pass 1 over :func:`fsk_quad_row_shape` windows: sum |margin| of every
    offset on three windows. Returns ``(best (B,) int32, plan, W_fir, W_quad)``."""
    spb = _samples_per_bit(sample_rate, baud)
    sep = _separation_cycles(baud, mark, space, sample_rate)
    if not (0.4 <= sep < 0.8):
        raise ValueError("fsk_quad_bits_rows_batch requires a mid-separation config")
    plan, Wf, Wq = _device_tables("quad", spb, float(baud), float(mark), float(space),
                                  sample_rate, n_offsets, x3d.device)
    row2, spr2, ov2 = plan["row2"], plan["spr2"], plan["ov2"]
    b, r, r2 = _check_fused_rows(x3d, plan, "fsk_quad_row_shape")
    if spr2 % 128:
        raise ValueError("rows do not match fsk_quad_row_shape for this config")
    wins, w2 = _fir_windows(x3d, r2, row2 // 128)
    rz_w, ri_w = quad_analytic_rows(wins, Wf, w2, row2, ov2)
    Wq_all = Wq.permute(1, 0, 2).reshape(row2 + ov2, -1)
    M = (rz_w.reshape(b, -1, row2 + ov2) @ Wq_all).reshape(b, -1, n_offsets, 4, spr2)
    N = (ri_w.reshape(b, -1, row2 + ov2) @ Wq_all).reshape(b, -1, n_offsets, 4, spr2)
    score = torch.sum(torch.abs(quad_margins(M, N)), dim=(1, 3))
    return torch.argmax(score, dim=1).to(torch.int32), plan, Wf, Wq


def fsk_quad_bits_rows_batch(
    x3d: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Mid-separation FSK matched filter over :func:`fsk_quad_row_shape`
    windows (float32 or int16): pass 1, then K9's per-bit margins, bit =
    margin > 0. Returns uint8 bits (B, r2*spr2)."""
    best, plan, Wf, Wq = fsk_quad_pass1(x3d, baud, mark, space, sample_rate, n_offsets)
    margin = fsk_quad_margin_batch(
        x3d, Wf, Wq, best, rows_per_capture=x3d.shape[1], nrow2=plan["nrow2"], row2=plan["row2"],
        ov2=plan["ov2"], spr2=plan["spr2"],
    )
    return (margin > 0).to(torch.uint8)


# --- the single-capture receiver ----------------------------------------------------

@functools.lru_cache(maxsize=64)
def _fsk_quadrature_templates(spb: int, mark: float, space: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) plain tone quadratures [cos_m | sin_m |
    cos_s | sin_s] on the dual-tone geometry, for matched filtering of the
    analytic signal."""
    return _fsk_quadrature_templates_geom(spb, mark, space, sample_rate, n_offsets, *_fsk_geometry(spb))


@functools.lru_cache(maxsize=64)
def _fsk_local_quadrature_templates(
    spb: int, mark: float, space: float, sample_rate: int, n_offsets: int
) -> np.ndarray:
    """(n_offsets, row+ov, 4*spr) tone quadratures [cos_m | sin_m | cos_s |
    sin_s] in each bit's LOCAL time (the arguments restart at every bit
    window, as the modulator's per-bit phase does), for MLSE."""
    spr, row, ov = _fsk_geometry(spb)
    tl = np.arange(spb, dtype=np.float64) / sample_rate
    W = np.zeros((n_offsets, row + ov, 4 * spr), dtype=np.float32)
    for i in range(n_offsets):
        o = i * spb // n_offsets
        for s in range(spr):
            sl = slice(s * spb + o, s * spb + o + spb)
            W[i, sl, s] = np.cos(2 * np.pi * mark * tl)
            W[i, sl, spr + s] = np.sin(2 * np.pi * mark * tl)
            W[i, sl, 2 * spr + s] = np.cos(2 * np.pi * space * tl)
            W[i, sl, 3 * spr + s] = np.sin(2 * np.pi * space * tl)
    return W


def _cpfsk_trellis(spb: int, mark: float, space: float, sample_rate: int):
    """(n_states, adv_mark, adv_space) of the CPFSK phase trellis, or None
    beyond 96 states: the per-bit phase advances in integer 1/sample_rate
    cycle units on their common grid."""
    inc_m = int(round(mark * spb)) % sample_rate
    inc_s = int(round(space * spb)) % sample_rate
    g = math.gcd(math.gcd(inc_m, inc_s), sample_rate)
    n_states = sample_rate // g
    if n_states > 96 or n_states < 2:
        return None
    return n_states, (inc_m // g) % n_states, (inc_s // g) % n_states


def _rows_with_overlap(x: torch.Tensor, n_used: int, r: int, row: int, ov: int) -> torch.Tensor:
    """1-D samples -> (r, row+ov) overlapped rows, zero-padded."""
    x_pad = F.pad(x[:n_used], (0, r * row + ov - n_used))
    xr = x_pad[: r * row].reshape(r, row)
    nxt = torch.cat([xr[1:, :ov], x_pad[r * row : r * row + ov][None, :]], dim=0)
    return torch.cat([xr, nxt], dim=1)


def _mlse_tables(
    s_corr: torch.Tensor, c_corr: torch.Tensor, eq_bits: torch.Tensor, n_states: int, spb: int,
    mark: float, space: float, sample_rate: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The host part of :func:`_mlse_refine` for one capture: ``(x4 (4,
    n_bits), aec (2, S), cos_t, sin_t)``, the θ-corrected correlations
    [S_m, C_m, S_s, C_s], the hypothesis energies times â/2 and the state
    phases."""
    dev = s_corr.device
    n_bits = s_corr.shape[1]

    def t32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    phases_np = 2 * np.pi * np.arange(n_states) / n_states
    sin_t, cos_t = t32(np.sin(phases_np)), t32(np.cos(phases_np))
    tl = np.arange(spb) / sample_rate
    kc = t32([np.cos(4 * np.pi * f * tl).sum() for f in (mark, space)])
    ks = t32([np.sin(4 * np.pi * f * tl).sum() for f in (mark, space)])
    d_consts = [np.exp(-4j * np.pi * f * tl).sum() for f in (mark, space)]
    a_const = spb / 2.0
    b_re = t32([d.real / 2 for d in d_consts])[:, None]
    b_im = t32([d.imag / 2 for d in d_consts])[:, None]
    denom = t32([a_const**2 - abs(d / 2) ** 2 for d in d_consts])[:, None]
    v_re = (a_const * s_corr + b_re * s_corr + b_im * c_corr) / denom
    v_im = (a_const * c_corr + b_im * s_corr - b_re * c_corr) / denom

    is_mark = eq_bits[:n_bits] == 1
    u_re = torch.where(is_mark, v_re[0], v_re[1])
    u_im = torch.where(is_mark, v_im[0], v_im[1])
    psi = torch.atan2(u_im, u_re)
    mag = torch.sqrt(u_re**2 + u_im**2)
    theta = torch.atan2(torch.sum(mag * torch.sin(n_states * psi)),
                        torch.sum(mag * torch.cos(n_states * psi))) / n_states
    ct, st = torch.cos(theta), torch.sin(theta)
    sp = s_corr * ct + c_corr * st  # Re(u e^{-jθ})
    cp = c_corr * ct - s_corr * st  # Im(u e^{-jθ})
    a_half = torch.clamp(torch.sum(mag * mag) / torch.clamp(torch.sum(mag), min=1e-9), min=2e-6) / 2
    ang2 = 2 * (t32(phases_np)[None, :] + theta)
    ec = spb / 2 - (torch.cos(ang2) * kc[:, None] - torch.sin(ang2) * ks[:, None]) / 2  # (2, S)
    x4 = torch.stack([sp[0], cp[0], sp[1], cp[1]])
    return x4, a_half * ec, cos_t, sin_t


def _mlse_viterbi(
    x4: torch.Tensor, aec: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor, adv_mark: int,
    adv_space: int,
) -> torch.Tensor:
    """The Viterbi of :func:`_mlse_refine` for B captures of one length in
    one :func:`ops.kernels.mlse_viterbi_blocks` call: ``x4`` (B, 4, n_bits),
    ``aec`` (B, 2, S) -> (B, n_bits) uint8 bits. Blocks of
    ``_MLSE_BLOCK_CORE`` bits with ``_MLSE_BLOCK_OVERLAP`` bits of overlap
    each side, the cores kept; one pass when a capture fits one block."""
    b, _, n_bits = x4.shape
    core, ov = _MLSE_BLOCK_CORE, _MLSE_BLOCK_OVERLAP
    if n_bits <= core + 2 * ov:
        return mlse_viterbi_blocks(x4.contiguous(), cos_t, sin_t, aec.contiguous(), adv_mark, adv_space)
    n_blocks = -(-n_bits // core)
    padded = F.pad(x4, (ov, n_blocks * core - n_bits + ov))
    blocks = padded.unfold(2, core + 2 * ov, core).permute(0, 2, 1, 3).reshape(b * n_blocks, 4, -1)
    aec_b = aec.repeat_interleave(n_blocks, dim=0)
    bits = mlse_viterbi_blocks(blocks.contiguous(), cos_t, sin_t, aec_b.contiguous(), adv_mark, adv_space)
    return bits[:, ov : ov + core].reshape(b, -1)[:, :n_bits]


def _mlse_refine(
    s_corr: torch.Tensor, c_corr: torch.Tensor, eq_bits: torch.Tensor, n_states: int, adv_mark: int,
    adv_space: int, spb: int, mark: float, space: float, sample_rate: int,
) -> torch.Tensor:
    """Maximum-likelihood sequence detection over the CPFSK phase trellis.

    ``s_corr``/``c_corr`` (2, n_bits) are each bit's local-time sums x·sin
    and x·cos per tone, rows [mark, space], of the RAW samples: on a clean
    or white-noise channel a bit is the hypothesis ``a·sin(2π f_b t +
    φ_s)``, so the branch metric is ``m(s, b) - (a/2)·||h_{s,b}||²`` with
    ``m = S_b cos φ_s + C_b sin φ_s``. ``eq_bits`` seed the channel phase
    θ and amplitude a: each bit's quadrature ellipse is inverted to
    ``v = a·e^{jψ}``, θ is the angle of Σ|v|·e^{j·n_states·ψ} over
    n_states (true phases lie on the state grid, so the power erases them
    and seed errors cannot rotate the estimate), â the energy-weighted
    Σ|v|²/Σ|v| (robust to a long quiet lead), and the hypothesis energies
    follow the θ-shifted grid (:func:`_mlse_tables`). The Viterbi runs on
    θ-corrected correlations (:func:`_mlse_viterbi`). Returns the refined
    (n_bits,) uint8 bits."""
    x4, aec, cos_t, sin_t = _mlse_tables(s_corr, c_corr, eq_bits, n_states, spb, mark, space, sample_rate)
    return _mlse_viterbi(x4[None], aec[None], cos_t, sin_t, adv_mark, adv_space)[0]


def fsk_demod_bits(
    samples: torch.Tensor,
    baud: float,
    mark: float,
    space: float,
    sample_rate: int,
    n_offsets: int = 8,
    mlse: bool = True,
    frontend: str = "matmul",
    want_soft: bool = False,
):
    """Demodulate one CPFSK capture to bits: ``(bits (n_bits,) uint8,
    best-offset score)``, or with ``want_soft`` ``(bits, score, margin)``,
    the per-bit signed statistic (positive = mark = bit 1).

    ``samples`` is a flat float capture, or host-shaped rows: (r, row+ov)
    overlapped rows for dual tones (:func:`fsk_blocked_row_shape`), the
    FIR windows of :func:`fsk_fir_row_shape` for close and mid tones
    (without MLSE, which correlates the raw samples). The detector follows
    the tone separation in cycles per bit:

    * >= 0.8 (FSK1200, MSK, FT8): the least-squares dual basis of the
      {mark, space} x {sin, cos} subspace on the raw samples; pass 1 scores
      the timing offsets on three row windows, pass 2 (K7) takes
      E_mark > E_space at the best offset;
    * 0.4 - 0.8 (FSK19200): the decimating analytic FIR at dec 1 (129 taps),
      then plain tone quadratures of the analytic signal;
    * < 0.4 (FSK9600): the decimated analytic signal, the phasor
      z[n+1]·conj z[n], per-bit fractional boxcars, the energy-weighted
      deviation-clamped offset score, atan2, the calibrated 9-tap equalizer
      and the nearer tone; then, with ``mlse``, :func:`_mlse_refine` on the
      raw samples' local quadratures. Its soft margin carries the
      (refined) decisions' signs and the equalizer's magnitudes.

    ``frontend`` is "matmul" only: the JAX package's "fft" and "fir" front
    ends are A/B switches and are not ported."""
    bits, score, margin, mlse_in = _fsk_detect(samples, baud, mark, space, sample_rate, n_offsets, mlse,
                                               frontend, want_soft)
    if mlse_in is not None:
        bits = _mlse_refine(*mlse_in[:2], bits, *mlse_in[2:], _samples_per_bit(sample_rate, baud), float(mark),
                            float(space), sample_rate)
        if want_soft:
            margin = torch.where(bits > 0, torch.abs(margin), -torch.abs(margin))
    return (bits, score, margin) if want_soft else (bits, score)


def fsk_demod_bits_each(
    samples: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int,
    n_offsets: int = 8, mlse: bool = True,
) -> torch.Tensor:
    """:func:`fsk_demod_bits` over each capture of a batch (flat (B, N), or
    (B, r, cols) rows of the single-capture layouts), with the MLSE Viterbi
    of every capture in one kernel launch. Returns uint8 bits (B, n_bits)."""
    outs = [_fsk_detect(x, baud, mark, space, sample_rate, n_offsets, mlse, "matmul", False) for x in samples]
    if outs[0][3] is None:
        return torch.stack([o[0] for o in outs])
    n_states, adv_m, adv_s = outs[0][3][2:]
    spb = _samples_per_bit(sample_rate, baud)
    tables = [_mlse_tables(s_corr, c_corr, bits, n_states, spb, float(mark), float(space), sample_rate)
              for bits, _score, _margin, (s_corr, c_corr, *_trellis) in outs]
    x4 = torch.stack([t[0] for t in tables])
    aec = torch.stack([t[1] for t in tables])
    return _mlse_viterbi(x4, aec, tables[0][2], tables[0][3], adv_m, adv_s)


def _fsk_detect(
    samples: torch.Tensor, baud: float, mark: float, space: float, sample_rate: int, n_offsets: int,
    mlse: bool, frontend: str, want_soft: bool,
):
    """:func:`fsk_demod_bits` up to its Viterbi: ``(bits, score, margin,
    mlse_in)``. ``margin`` is the family's signed statistic (None for dual
    tones without ``want_soft``); ``mlse_in`` is None, or with ``mlse`` on
    the discriminator path ``(s_corr, c_corr, n_states, adv_mark,
    adv_space)``, the arguments of :func:`_mlse_refine` besides ``bits``,
    which are then the equalizer's seed."""
    if frontend not in ("matmul", "fft", "fir"):
        raise ValueError(f"unknown frontend {frontend!r}")
    if frontend != "matmul":
        raise NotImplementedError(
            f"frontend={frontend!r} is one of the JAX package's A/B-only front ends (whole-capture FFT, "
            "full-rate overlap-save FIR) and is not ported; the production front end is 'matmul'")
    spb = _samples_per_bit(sample_rate, baud)
    spr, row, ov = _fsk_geometry(spb)
    sep = _separation_cycles(baud, mark, space, sample_rate)
    dev = samples.device
    pre_shaped = samples.ndim == 2
    fir_rows = None
    if pre_shaped and sep >= 0.8:
        if samples.shape[1] != row + ov:
            raise ValueError("pre-shaped dual-tone rows must have row+ov columns")
        r = samples.shape[0]
        n_bits = r * spr
        xov = samples.to(torch.float32)
    elif pre_shaped:
        if mlse:
            raise ValueError(
                "pre-shaped FIR rows are incompatible with MLSE refinement "
                "(it correlates the raw samples); pass flat samples"
            )
        _plo, _phi, dec_p, taps_p = _fir_frontend_plan(baud, mark, space, sample_rate)
        if samples.shape[1] != 128 * dec_p + taps_p - dec_p:
            raise ValueError("pre-shaped FIR rows have the wrong column count")
        fir_rows = samples.to(torch.float32)
        n_bits = (fir_rows.shape[0] * 128 * dec_p) // spb
        r = -(-n_bits // spr)
    else:
        n_bits = samples.shape[-1] // spb
        if n_bits < 2:
            raise ValueError("signal shorter than two bit periods")
        r = -(-n_bits // spr)
        x = samples.to(torch.float32)
    keep = max(n_bits, 1)

    if sep >= 0.8:
        if not pre_shaped:
            xov = _rows_with_overlap(x, n_bits * spb, r, row, ov)
        best, score, W, spr = _dual_pass1(xov[None], baud, mark, space, sample_rate, n_offsets)
        bits = fsk_tile_bits_batch(xov[None], W, best, rows_per_capture=r, spr=spr)[0, :keep]
        margin = None
        if want_soft:
            pj = (xov @ W[best[0].long()]).reshape(r, 4, spr)
            margin = ((pj[:, 0] ** 2 + pj[:, 1] ** 2) - (pj[:, 2] ** 2 + pj[:, 3] ** 2)).reshape(-1)[:keep]
        return bits, score[0, best[0]], margin, None

    band_lo, band_hi, dec, taps = _fir_frontend_plan(baud, mark, space, sample_rate)
    if fir_rows is not None:
        zr, zi = analytic_fir_dec_rows(fir_rows, band_lo, band_hi, sample_rate, dec, taps)
    else:
        zr, zi = analytic_bandpass_fir_dec(x, band_lo, band_hi, sample_rate, dec, taps=taps)

    if sep >= 0.4:
        (W,) = _device_tables("quad1", spb, float(baud), float(mark), float(space), sample_rate, n_offsets, dev)
        rr = _rows_with_overlap(zr, n_bits * spb, r, row, ov)
        ri = _rows_with_overlap(zi, n_bits * spb, r, row, ov)
        wr, starts = _window_starts(r)
        W_all = W.permute(1, 0, 2).reshape(row + ov, -1)
        m = (torch.cat([rr[s : s + wr] for s in starts], dim=0) @ W_all).reshape(-1, n_offsets, 4, spr)
        n_ = (torch.cat([ri[s : s + wr] for s in starts], dim=0) @ W_all).reshape(-1, n_offsets, 4, spr)
        score = torch.sum(torch.abs(quad_margins(m, n_)), dim=(0, 2))
        best = torch.argmax(score)
        margin = quad_margins((rr @ W[best]).reshape(r, 4, spr), (ri @ W[best]).reshape(r, 4, spr))
        bits = (margin > 0).to(torch.uint8).reshape(-1)[:keep]
        return bits, score[best], margin.reshape(-1)[:keep], None

    # Discriminator on the decimated analytic signal.
    lo_f, hi_f = min(mark, space), max(mark, space)
    spr_d, row_d, ov_d = _fsk_geometry_dec(spb, dec)
    r_d = -(-n_bits // spr_d)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    p_re = torch.cat([zr[1:] * zr[:-1] + zi[1:] * zi[:-1], zero])
    p_im = torch.cat([zi[1:] * zr[:-1] - zr[1:] * zi[:-1], zero])
    Wb, coef = _device_tables("disc1", spb, float(baud), float(mark), float(space), sample_rate, n_offsets, dev)
    n_used_d = min(int(p_re.shape[-1]), -(-(n_bits * spb) // dec))
    pr = _rows_with_overlap(p_re, n_used_d, r_d, row_d, ov_d)
    pi = _rows_with_overlap(p_im, n_used_d, r_d, row_d, ov_d)
    wr, starts = _window_starts(r_d)
    mid = (mark + space) / 2.0
    scale = sample_rate / dec / (2 * math.pi)
    Wb_all = Wb.permute(1, 0, 2).reshape(row_d + ov_d, -1)
    wins_r = torch.cat([pr[s : s + wr] for s in starts], dim=0) @ Wb_all
    wins_i = torch.cat([pi[s : s + wr] for s in starts], dim=0) @ Wb_all
    f_win = torch.atan2(wins_i, wins_r) * scale
    mag_w = torch.sqrt(wins_r**2 + wins_i**2)
    score = torch.sum((mag_w * torch.clamp(torch.abs(f_win - mid), max=(hi_f - lo_f) / 2.0)).reshape(
        -1, n_offsets, spr_d), dim=(0, 2))
    best = torch.argmax(score)
    f = (torch.atan2(pi @ Wb[best], pr @ Wb[best]) * scale).reshape(-1)
    pad = _EQ_TAPS // 2
    fm = torch.cat([f[:1].expand(pad), f, f[-1:].expand(pad)])
    eq = torch.full_like(f, float(coef[-1]))
    for j in range(_EQ_TAPS):
        eq = eq + float(coef[j]) * fm[j : j + f.shape[0]]
    bits = (torch.abs(eq - mark) < torch.abs(eq - space)).to(torch.uint8)[:keep]
    margin_d = (torch.abs(eq - space) - torch.abs(eq - mark))[:keep]
    trellis = _cpfsk_trellis(spb, float(mark), float(space), sample_rate) if mlse else None
    if trellis is None:
        return bits, score[best], margin_d, None
    n_states, adv_m, adv_s = trellis
    (Wl,) = _device_tables("local", spb, float(baud), float(mark), float(space), sample_rate, n_offsets, dev)
    pj = (_rows_with_overlap(x, n_bits * spb, r, row, ov) @ Wl[best]).reshape(r, 4, spr)  # [C_m, S_m, C_s, S_s]
    s_corr = torch.stack([pj[:, 1].reshape(-1)[:n_bits], pj[:, 3].reshape(-1)[:n_bits]])
    c_corr = torch.stack([pj[:, 0].reshape(-1)[:n_bits], pj[:, 2].reshape(-1)[:n_bits]])
    return bits, score[best], margin_d, (s_corr, c_corr, n_states, adv_m, adv_s)


def fsk_demodulate(
    samples,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
    device: DeviceLike = None,
) -> bytes:
    """CPFSK receive chain on ``device`` (default: the card): bits, the
    first exact magic, magic-aligned bytes. Close tones run the
    MLSE-refined stream first; if it parses no valid frame, the
    equalizer-only stream is returned when that one does."""
    x = _to_device(samples, device)

    def _run(use_mlse: bool) -> bytes:
        bits, _ = fsk_demod_bits(x, float(baud), float(mark_freq), float(space_freq), int(samp_rate),
                                 mlse=use_mlse)
        packed, n_valid, _found = bit_sync_and_pack(bits, MAGIC_BIT_PATTERN)
        return packed.cpu().numpy()[: int(n_valid)].tobytes()

    raw = _run(True)
    if _separation_cycles(baud, mark_freq, space_freq, samp_rate) < 0.4 and not parse_frames(raw):
        eq_raw = _run(False)
        if parse_frames(eq_raw):
            return eq_raw
    return raw


def fsk_soft_bits(samples, baud: float, mark: float, space: float, samp_rate: int,
                  device: DeviceLike = None) -> np.ndarray:
    """Soft bits in [0, 1] from the family's signed margins (MLSE signs with
    equalizer magnitudes on the close-tone path), scaled by twice their
    mean magnitude around 0.5, as ``ops.psk.psk_soft_bits`` scales."""
    _bits, _score, margin = fsk_demod_bits(
        _to_device(samples, device), float(baud), float(mark), float(space), int(samp_rate),
        mlse=True, want_soft=True,
    )
    margin = margin.cpu().numpy()
    scale = 2.0 * np.mean(np.abs(margin)) + 1e-9
    return np.clip(0.5 + margin / scale, 0.0, 1.0).astype(np.float32)


def fsk_high_speed_demodulate(samples, baud: float = 19200, samp_rate: int = 96000,
                              device: DeviceLike = None) -> bytes:
    """High-rate FSK receive: 8/16 kHz tones."""
    return fsk_demodulate(samples, baud, 8000.0, 16000.0, samp_rate, device=device)
