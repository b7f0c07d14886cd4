"""Differential PSK on PyTorch: modulation and the batched receive front half.

Counterpart of ``audio_modem_radio_tpu/ops/psk.py`` for the batched DBPSK,
DQPSK and D8PSK slices. The wire formats are the same: MSB-first bits, a
sine carrier restarted every symbol with a 10% linear ramp envelope, and
per mode

* DBPSK: the ``[1,0]*40`` preamble, a half turn for every 1 bit;
* DQPSK: the ``[0,0]*30 + [1,1]*10`` preamble, Gray-coded quarter-turn
  phase deltas;
* D8PSK: the ``[0,0,0]*30 + [1,1,0]*10`` preamble, Gray-coded eighth-turn
  phase deltas, 3 bits per symbol.

Receive is the JAX package's two-pass design, with the batch dimension
written out:

* pass 1 (``_batch_pass1``): three windows of blocked sample rows are
  projected onto every timing offset's template at once (one float32
  ``torch.matmul``), scored by the energy-weighted phase coherence at the
  power that cancels the data (the 4th for DBPSK and DQPSK, the 8th for
  D8PSK), and the winning offset's differentials give each capture's
  blind common-rotation estimate θ;
* pass 2 (``psk_decision_streams_batch``, ``psk8_sector_rows_batch``):
  kernel K1 (``ops.kernels.psk_project_decide_batch``) projects every
  symbol at the winning offset, forms the differential, derotates by θ and
  emits uint8 decisions: Gray (hi, lo) lanes for DQPSK, the sign bits of
  (re, im) for DBPSK, one π/4 sector lane for D8PSK.

The tables are numpy, built from the same formulas as the JAX package's, so
both packages hold bitwise-equal templates.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import bytes_to_bits
from .kernels import psk_project_decide_batch

# Exact unit-circle table for quarter-turn phases: cos/sin of k*pi/2.
_QT_COS = np.array([1.0, 0.0, -1.0, 0.0], dtype=np.float64)
_QT_SIN = np.array([0.0, 1.0, 0.0, -1.0], dtype=np.float64)

BPSK_PREAMBLE_BITS = [1, 0] * 40
QPSK_PREAMBLE_BITS = [0, 0] * 30 + [1, 1] * 10

# Symbols per row of the blocked layout (row width = 128 * spsym samples).
_BLOCK_SYM = 128
# The blocked path applies when spsym <= this.
_BLOCK_MAX_SPSYM = 32
# Row granularity of the pass-2 and sync-tail kernels.
_BLOCK_ROWS = 256


def _samples_per_symbol(sample_rate: int, baud: float) -> int:
    # int() truncation, matching the reference so symbol boundaries line up
    # sample-exactly across implementations.
    return int(sample_rate / baud)


def _envelope(spsym: int) -> np.ndarray:
    """The per-symbol amplitude envelope: 10% linear ramps at both ends."""
    env = np.ones(spsym)
    ramp = int(spsym * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    return env


@functools.lru_cache(maxsize=64)
def _carrier_basis(spsym: int, carrier: float, sample_rate: int) -> np.ndarray:
    """(2, spsym) rows = (sin, cos) of the carrier over one symbol, ramped."""
    t = np.arange(spsym, dtype=np.float64) / sample_rate
    env = _envelope(spsym)
    w = 2 * np.pi * carrier * t
    return np.stack([np.sin(w) * env, np.cos(w) * env]).astype(np.float32)


def _synthesize(
    phase: np.ndarray, spsym: int, carrier: float, sample_rate: int,
    cos: np.ndarray = _QT_COS, sin: np.ndarray = _QT_SIN,
) -> torch.Tensor:
    """Phase indices (n_sym,) into the unit-circle table (``cos``, ``sin``)
    -> waveform (n_sym*spsym,).

    sin(w + φ) = sin(w)cos(φ) + cos(w)sin(φ): a (n_sym, 2) @ (2, spsym)
    product. For quarter turns one of cos φ, sin φ is exactly 0 for every
    symbol, so each sample is exactly ± one basis value, whatever the
    summation order; eighth turns sum two products.
    """
    basis = torch.from_numpy(_carrier_basis(spsym, carrier, sample_rate))
    cs = torch.from_numpy(np.stack([cos[phase], sin[phase]], axis=1).astype(np.float32))
    return (cs @ basis).reshape(-1)


def bpsk_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DBPSK: 1 = invert phase, 0 = keep phase; ``[1,0]*40`` preamble."""
    bits = np.concatenate(
        [np.asarray(BPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    ).astype(np.int64)
    # The phase after bit k is (number of ones so far) half turns.
    phase_qt = 2 * (np.cumsum(bits) % 2)
    spsym = _samples_per_symbol(samp_rate, baud)
    return _synthesize(phase_qt, spsym, float(carrier), int(samp_rate)).numpy()


def qpsk_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DQPSK with Gray-coded phase deltas and the reference preamble."""
    bits = np.concatenate([np.asarray(QPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)])
    if len(bits) % 2:
        bits = np.concatenate([bits, np.zeros(1, np.uint8)])
    hi, lo = bits[0::2].astype(np.int64), bits[1::2].astype(np.int64)
    # Gray map as arithmetic on (hi, lo): 00->0, 01->1, 11->2, 10->3 quarter turns.
    deltas = hi * 3 + lo * (1 - 2 * hi)
    phase_qt = np.cumsum(deltas) % 4
    spsym = _samples_per_symbol(samp_rate, baud)
    return _synthesize(phase_qt, spsym, float(carrier), int(samp_rate)).numpy()


_ET_SQ = float(np.sqrt(0.5))
# cos/sin of k·π/4: the 8PSK constellation directions.
_ET_COS = np.array([1, _ET_SQ, 0, -_ET_SQ, -1, -_ET_SQ, 0, _ET_SQ], np.float64)
_ET_SIN = np.array([0, _ET_SQ, 1, _ET_SQ, 0, -_ET_SQ, -1, -_ET_SQ], np.float64)
# 3-bit reflected Gray code: sector k carries tribit value _GRAY8[k]
# (adjacent sectors differ in one bit); the inverse maps tribit -> phase delta.
_GRAY8 = np.array([0, 1, 3, 2, 6, 7, 5, 4], np.uint8)
_GRAY8_INV = np.argsort(_GRAY8).astype(np.uint8)

# 30 zero deltas then 10 half turns, in tribits. 120 bits ≡ 0 mod 3, so the
# frame magic always lands tribit-aligned.
PSK8_PREAMBLE_BITS = [0, 0, 0] * 30 + [1, 1, 0] * 10


def psk8_real_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """D8PSK: Gray-coded tribit phase deltas, 3 bits/symbol."""
    bits = np.concatenate(
        [np.asarray(PSK8_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    )
    if len(bits) % 3:
        bits = np.concatenate([bits, np.zeros(3 - len(bits) % 3, np.uint8)])
    tri = bits[0::3].astype(np.int64) * 4 + bits[1::3] * 2 + bits[2::3]
    phase_et = np.cumsum(_GRAY8_INV[tri].astype(np.int64)) % 8
    spsym = _samples_per_symbol(samp_rate, baud)
    return _synthesize(
        phase_et, spsym, float(carrier), int(samp_rate), _ET_COS, _ET_SIN
    ).numpy()


# --- receive tables (numpy, the JAX package's formulas) ------------------------

def _offset_bases(spsym: int, carrier: float, sample_rate: int, n_offsets: int):
    """(o, B) per timing offset: the window start ``i*spsym//n_offsets`` in
    a 2-symbol frame and the (spsym, 2) ramped (sin, cos) symbol basis
    there."""
    t = np.arange(2 * spsym, dtype=np.float64)
    w = 2 * np.pi * carrier * t / sample_rate
    env = _envelope(spsym)
    for i in range(n_offsets):
        o = i * spsym // n_offsets
        yield o, np.stack([np.sin(w[o : o + spsym]) * env, np.cos(w[o : o + spsym]) * env], axis=1)


@functools.lru_cache(maxsize=64)
def _offset_templates(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(2*spsym, 2*n_offsets) per-offset dual basis of the symbol subspace.

    Columns ``2i`` / ``2i+1`` hold ``G⁻¹·[b1 b2]ᵀ`` for the window starting
    ``i*spsym//n_offsets`` samples into a 2-symbol frame; the least-squares
    projection onto them recovers (cos φ, sin φ) exactly at any
    carrier/baud ratio.
    """
    T = np.zeros((2 * spsym, 2 * n_offsets), dtype=np.float64)
    for i, (o, B) in enumerate(_offset_bases(spsym, carrier, sample_rate, n_offsets)):
        G = B.T @ B + 1e-9 * np.eye(2)
        T[o : o + spsym, 2 * i : 2 * i + 2] = B @ np.linalg.inv(G)
    return T.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _blocked_templates(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, ROW+OV, 2*_BLOCK_SYM) block-diagonal projection matrices.

    Symbol s's 2-symbol window occupies rows [s*spsym, s*spsym+2*spsym);
    output columns are [re x 128 | im x 128]. The OV overlap rows come from
    the next row chunk.
    """
    T = _offset_templates(spsym, carrier, sample_rate, n_offsets)
    row = _BLOCK_SYM * spsym
    ov = 128 * int(np.ceil(2 * spsym / 128))
    W = np.zeros((n_offsets, row + ov, 2 * _BLOCK_SYM), dtype=np.float32)
    for i in range(n_offsets):
        for s in range(_BLOCK_SYM):
            W[i, s * spsym : s * spsym + 2 * spsym, s] = T[:, 2 * i]
            W[i, s * spsym : s * spsym + 2 * spsym, _BLOCK_SYM + s] = T[:, 2 * i + 1]
    return W


@functools.lru_cache(maxsize=64)
def _offset_grams(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, 3) per-offset Gram entries (gxx, gxy, gyy) of the raw
    symbol basis, for converting dual-basis phasors to matched energy."""
    G = np.zeros((n_offsets, 3), dtype=np.float32)
    for i, (_o, B) in enumerate(_offset_bases(spsym, carrier, sample_rate, n_offsets)):
        g = B.T @ B
        G[i] = (g[0, 0], g[0, 1], g[1, 1])
    return G


@functools.lru_cache(maxsize=32)
def _device_tables(
    spsym: int, carrier: float, sample_rate: int, n_offsets: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W8, W_all, grams) on ``device``: the blocked templates, the same
    templates side by side as one (ROW+OV, n_offsets*256) pass-1 matrix,
    and the Gram entries."""
    W8 = torch.from_numpy(_blocked_templates(spsym, carrier, sample_rate, n_offsets)).to(device)
    W_all = torch.cat([W8[i] for i in range(n_offsets)], dim=1).contiguous()
    grams = torch.from_numpy(_offset_grams(spsym, carrier, sample_rate, n_offsets)).to(device)
    return W8, W_all, grams


# --- pass-1 scoring ------------------------------------------------------------

def _fourth_power(d_re: torch.Tensor, d_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy-normalized 4th power: |z|² e^{j4θ} as (re, im), no transcendentals."""
    a = d_re * d_re
    b = d_im * d_im
    u = a - b
    v = 2 * d_re * d_im
    w = a + b + 1e-20
    return (u * u - v * v) / w, (2 * u * v) / w


def _eighth_power(d_re: torch.Tensor, d_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy-normalized 8th power: |z|² e^{j8θ} as (re, im). Squares the
    4th-power phasor and renormalizes by its magnitude (= |z|²); D8PSK data
    sits on k·π/4, which only the 8th power cancels."""
    r4, i4 = _fourth_power(d_re, d_im)
    w = torch.sqrt(r4 * r4 + i4 * i4) + 1e-20
    return (r4 * r4 - i4 * i4) / w, (2 * r4 * i4) / w


def _coherence_score(d_re: torch.Tensor, d_im: torch.Tensor, dim, n_psk: int = 4) -> torch.Tensor:
    """Energy-weighted phase coherence |Σ |z|² e^{jpθ}| at the power p that
    cancels the data (8 for D8PSK, 4 otherwise); the magnitude is
    rotation-invariant, so timing selection survives CFO."""
    re_p, im_p = (_eighth_power if n_psk == 8 else _fourth_power)(d_re, d_im)
    return torch.hypot(torch.sum(re_p, dim=dim), torch.sum(im_p, dim=dim))


def _gram_scale(
    re: torch.Tensor, im: torch.Tensor, grams: torch.Tensor, offset_axis: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale dual-basis phasors by the scalar ‖G·z‖/‖z‖ per offset: angles
    are kept and ‖z'‖² becomes the raw matched energy, the valid weight for
    comparing offsets."""
    shape = [1] * re.ndim
    shape[offset_axis] = grams.shape[0]
    gxx = grams[:, 0].reshape(shape)
    gxy = grams[:, 1].reshape(shape)
    gyy = grams[:, 2].reshape(shape)
    a = gxx * re + gxy * im
    c = gxy * re + gyy * im
    s = torch.sqrt((a * a + c * c) / (re * re + im * im + 1e-20))
    return re * s, im * s


def estimate_common_rotation(d_re: torch.Tensor, d_im: torch.Tensor) -> torch.Tensor:
    """Blind CFO estimate θ̂ = arg(Σ |z|²e^{j4θ})/4 over the last axis,
    resolved mod π/2 (the sync stage's rotation hypotheses take the rest)."""
    re4, im4 = _fourth_power(d_re, d_im)
    return torch.atan2(torch.sum(im4, dim=-1), torch.sum(re4, dim=-1)) / 4


def estimate_common_rotation8(d_re: torch.Tensor, d_im: torch.Tensor) -> torch.Tensor:
    """Blind CFO estimate for D8PSK: θ̂ = arg(Σ |z|²e^{j8θ})/8 over the last
    axis, resolved mod π/4 (the sector matcher's 8 hypotheses take the rest)."""
    re8, im8 = _eighth_power(d_re, d_im)
    return torch.atan2(torch.sum(im8, dim=-1), torch.sum(re8, dim=-1)) / 8


def _batch_pass1(samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r_pre,
                 n_psk=4):
    """Batched pass 1: build the blocked rows (flat input), score every timing
    offset on up to 3 row windows, and estimate each capture's common
    differential rotation from the winning offset's window differentials.
    ``n_psk=8`` scores and estimates at the 8th power, anything else at the
    4th (DBPSK and DQPSK both).

    Returns ``(x3d, r, best, theta)`` with best (B,) int32 and theta (B,).
    """
    device = (samples if x3d is None else x3d).device
    W8, W_all, grams = _device_tables(spsym, float(carrier), sample_rate, n_offsets, device)
    row = _BLOCK_SYM * spsym
    c = W8.shape[1]
    ov = c - row
    blk = _BLOCK_ROWS
    if x3d is None:
        # Ceil the row count and keep every input sample: flooring dropped
        # the trailing partial block and corrupted the frame's last dibits.
        r0 = -(-n_frames // _BLOCK_SYM)
        r = max(blk, -(-r0 // blk) * blk)
        x = samples.to(torch.float32)
        x3d = F.pad(x, (0, r * row - x.shape[1])).reshape(b, r, row)
    else:
        r = r0 = r_pre
        if r % blk:
            raise ValueError(f"pre-shaped rows {r} must be a multiple of {blk}")

    # Slice the windows first, then build their overlap tails.
    wr = min(64, r0) if r0 >= 1 else 1
    starts = sorted({0, max(0, r0 // 2 - wr // 2), max(0, r0 - wr)})
    n_rows = x3d.shape[1]
    wins = []
    for s in starts:
        # Next-row heads; the start clamps at the array edge like JAX's
        # dynamic_slice (the last window shifts by one row there).
        n0 = min(max(min(s + 1, r0 - wr + 1 if r0 >= wr else 0), 0), n_rows - wr)
        wins.append(torch.cat([x3d[:, s : s + wr], x3d[:, n0 : n0 + wr, :ov]], dim=2))
    wins = torch.cat(wins, dim=1).to(torch.float32)  # (B, nw, row+ov); int rows cast here
    # Normalize per capture: the 4th-power estimate raises phasors (~scale²)
    # to the 4th, so int16-scaled input (x32768) would overflow float32.
    wscale = torch.clamp_min(torch.amax(torch.abs(wins), dim=(1, 2), keepdim=True), 1e-12)
    wins = wins / wscale
    proj = torch.matmul(wins.reshape(b, -1, c), W_all)  # (B, nw, K*256)
    proj = proj.reshape(b, -1, n_offsets, 2, _BLOCK_SYM)
    re, im = proj[:, :, :, 0], proj[:, :, :, 1]  # (B, nw, K, 128)
    re, im = _gram_scale(re, im, grams, offset_axis=2)
    # In-row differentials (127 per row) are plenty for scoring.
    dr = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    di = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    score = _coherence_score(dr, di, (1, 3), n_psk)  # (B, K)
    best = torch.argmax(score, dim=1).to(torch.int32)

    idx = best.long()[:, None, None, None].expand(-1, dr.shape[1], 1, dr.shape[3])
    dr_b = torch.gather(dr, 2, idx)[:, :, 0]  # (B, nw, 127)
    di_b = torch.gather(di, 2, idx)[:, :, 0]
    est = estimate_common_rotation8 if n_psk == 8 else estimate_common_rotation
    theta = est(dr_b.reshape(b, -1), di_b.reshape(b, -1))
    return x3d, r, best, theta


def _batch_block_setup(samples: torch.Tensor, spsym: int):
    """``(b, n_frames, x3d, r)`` for the blocked batch receiver, or None when
    the configuration has no blocked path (symbol too large or capture too
    short). Pre-shaped ``(B, r, 128*spsym)`` rows pass through, integer rows
    kept integer for K1; flat ``(B, N)`` captures give ``x3d=None``."""
    if samples.ndim == 3:
        b, r, row = samples.shape
        if row != _BLOCK_SYM * spsym:
            raise ValueError(f"row width {row} != 128*spsym ({_BLOCK_SYM * spsym})")
        x3d = samples if not samples.dtype.is_floating_point else samples.to(torch.float32)
        return b, r * _BLOCK_SYM, x3d, r
    b, n = samples.shape
    n_frames = -(-n // spsym)  # ceil: keep the trailing partial symbol
    if spsym > _BLOCK_MAX_SPSYM or n_frames < 2 * _BLOCK_SYM:
        return None
    return b, n_frames, None, 0


def blocked_row_shape(n_samples: int, baud: float, sample_rate: int) -> Optional[Tuple[int, int]]:
    """Host helper: (rows, row_width) for pre-shaping a capture of
    ``n_samples``, or None when the configuration has no blocked path."""
    spsym = _samples_per_symbol(sample_rate, baud)
    if spsym > _BLOCK_MAX_SPSYM:
        return None
    # Ceil everywhere (symbols, then rows): flooring dropped the trailing
    # partial symbol/block and corrupted the frame's final dibits.
    n_frames = -(-n_samples // spsym)
    if n_frames < 2 * _BLOCK_SYM:
        return None
    row = _BLOCK_SYM * spsym
    rows = -(-n_frames // _BLOCK_SYM)
    r = max(_BLOCK_ROWS, -(-rows // _BLOCK_ROWS) * _BLOCK_ROWS)
    return r, row


def _decide_inputs(samples, baud, carrier, sample_rate, cfo, n_offsets, pass1_psk):
    """Pass 1 and K1's operands: ``(x3d, W8, best, rot, b, r)``. Raises
    NotImplementedError where the configuration has no blocked path."""
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        raise NotImplementedError(
            f"spsym={spsym}, {samples.shape[-1]} samples: no blocked path; the "
            "single-capture receiver is not ported (ROADMAP.md queue 1: recovery ladder)"
        )
    b, n_frames, x3d, r = setup
    x3d, r, best, theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r, pass1_psk
    )
    W8, _, _ = _device_tables(spsym, float(carrier), sample_rate, n_offsets, x3d.device)
    if cfo:
        rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    else:
        rot = torch.zeros((b, 2), dtype=torch.float32, device=x3d.device)
        rot[:, 0] = 1.0
    return x3d, W8, best, rot, b, r


def psk_decision_streams_batch(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_psk: int = 4,
    cfo: bool = True,
    n_offsets: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched decision streams of shape (B, r*128), uint8, on the input's
    device: Gray ``(hi, lo)`` dibit lanes for ``n_psk=4``, the sign bits of
    the (re, im) differential for ``n_psk=2``.

    Pass 1 (4th power for both) picks each capture's timing offset and
    rotation θ; kernel K1 projects, differentiates, derotates by θ
    (``cfo=True``; identity otherwise) and decides. Entries past each
    capture's modulated span are garbage, which the sync tail and the frame
    parser ignore.
    """
    if n_psk not in (2, 4):
        raise NotImplementedError(
            f"n_psk={n_psk}: decision streams exist for DBPSK (2) and DQPSK (4); "
            "D8PSK is psk8_sector_rows_batch"
        )
    x3d, W8, best, rot, b, r = _decide_inputs(
        samples, baud, carrier, sample_rate, cfo, n_offsets, pass1_psk=4
    )
    hi, lo = psk_project_decide_batch(x3d, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
    return hi.reshape(b, -1), lo.reshape(b, -1)


def psk8_sector_rows_batch(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    cfo: bool = True,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Batched D8PSK receive front half: uint8 π/4 sectors (0..7) of shape
    (B, r*128), on the input's device. Pass 1 at the 8th power, then K1 with
    ``n_psk=8`` (projection, differential, derotation by θ, sector
    decision)."""
    x3d, W8, best, rot, b, r = _decide_inputs(
        samples, baud, carrier, sample_rate, cfo, n_offsets, pass1_psk=8
    )
    sec = psk_project_decide_batch(x3d, W8, best, rot, rows_per_capture=r, n_psk=8)
    return sec.reshape(b, -1)
