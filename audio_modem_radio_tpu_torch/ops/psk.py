"""Differential PSK on PyTorch: modulation, the batched receive front half
and the single-capture receiver.

Counterpart of ``audio_modem_radio_tpu/ops/psk.py`` for DBPSK, DQPSK and
D8PSK. The wire formats are the same: MSB-first bits, a
sine carrier restarted every symbol with a 10% linear ramp envelope, and
per mode

* DBPSK: the ``[1,0]*40`` preamble, a half turn for every 1 bit;
* DQPSK: the ``[0,0]*30 + [1,1]*10`` preamble, Gray-coded quarter-turn
  phase deltas;
* D8PSK: the ``[0,0,0]*30 + [1,1,0]*10`` preamble, Gray-coded eighth-turn
  phase deltas, 3 bits per symbol.

Receive is the JAX package's two-pass design, with the batch dimension
written out:

* pass 1 (``_batch_pass1``, ``ops.kernels.psk_pass1_batch``): three
  windows of blocked sample rows are projected onto every timing offset's
  template (on the CPU one float32 ``torch.matmul`` with the templates
  side by side; on the card ``csrc/psk_pass1.cu`` over each offset's
  2*spsym taps), scored by the energy-weighted phase coherence at the
  power that cancels the data (the 4th for DBPSK and DQPSK, the 8th for
  D8PSK), and the winning offset's differentials give each capture's
  blind common-rotation estimate θ;
* pass 2 (``psk_decision_streams_batch``, ``psk8_sector_rows_batch``):
  kernel K1 (``ops.kernels.psk_project_decide_batch``) projects every
  symbol at the winning offset, forms the differential, derotates by θ and
  emits uint8 decisions: Gray (hi, lo) lanes for DQPSK, the sign bits of
  (re, im) for DBPSK, one π/4 sector lane for D8PSK.

The single-capture receiver (``psk_demod_streams`` and what stands on it:
the byte ladders of ``bpsk_demodulate``, ``qpsk_demodulate`` and
``psk8_real_demodulate``, the no-sync rescue fronts and the
Viterbi&Viterbi-tracked receivers) runs its own pass 1 on 8192-symbol
windows and kernel K11 (``ops.kernels.psk_project_diff``) for pass 2;
``psk_demod_streams_batch`` gives float differential streams for a batch
through K12. Captures without a blocked path take the single-capture
receiver in the batched functions too.

The tables are numpy, built from the same formulas as the JAX package's, so
both packages hold bitwise-equal templates.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from ..observability import host_read, span
from ..utils.torchenv import DeviceLike, resolve_device
from .common import (
    bit_sync_and_pack_rotations,
    bytes_to_bits,
    dibit_sync_and_pack,
    dibit_sync_and_pack_rotations,
    find_bit_pattern,
    find_bit_pattern_validated,
    first_true,
    pack_bits_from,
    relabel_shift_pack,
)
from .kernels import (
    _decide,
    psk8_relabel_pack_rows_plain,
    psk8_sector_stream,
    psk_pass1_batch,
    psk_project_decide_batch,
    psk_project_diff,
    psk_project_diff_batch,
)

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
# K1's body, as the JAX package names it: "roll", or "succ" (the successor-
# column templates). Both run csrc/decide.cu with the same decisions.
DECIDE_KERNEL_VARIANT = "roll"


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
def _blocked_templates_succ(spsym: int, carrier: float, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(n_offsets, ROW+OV, 4*_BLOCK_SYM) templates with successor columns
    [re x128 | im x128 | re_succ x128 | im_succ x128]: the first 256 columns
    are :func:`_blocked_templates`, and the successor column of symbol s
    holds symbol s+1's window (symbol 128's lies in the OV tail). The JAX
    package's "succ" decide body reads the differential off one product
    with them; K1 here reads their dual basis, as it does the "roll"
    templates'."""
    T = _offset_templates(spsym, float(carrier), sample_rate, n_offsets)
    row = _BLOCK_SYM * spsym
    ov = 128 * int(np.ceil(2 * spsym / 128))
    W = np.zeros((n_offsets, row + ov, 4 * _BLOCK_SYM), dtype=np.float32)
    W[:, :, : 2 * _BLOCK_SYM] = _blocked_templates(spsym, carrier, sample_rate, n_offsets)
    for i in range(n_offsets):
        for s in range(_BLOCK_SYM):
            w0 = (s + 1) * spsym
            W[i, w0 : w0 + 2 * spsym, 2 * _BLOCK_SYM + s] = T[:, 2 * i]
            W[i, w0 : w0 + 2 * spsym, 3 * _BLOCK_SYM + s] = T[:, 2 * i + 1]
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


def _coherence_parts_pow(d_re: torch.Tensor, d_im: torch.Tensor, dim, n_psk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed complex parts (Σ re, Σ im) of :func:`_coherence_score`
    at the data-cancelling power (8 for D8PSK, 4 otherwise). Sequence-
    parallel callers sum the parts over the shards before the magnitude:
    summing the shards' magnitudes would over-count a shard whose phasors
    are incoherent with the rest."""
    re_p, im_p = (_eighth_power if n_psk == 8 else _fourth_power)(d_re, d_im)
    return torch.sum(re_p, dim=dim), torch.sum(im_p, dim=dim)


def _coherence_parts(d_re: torch.Tensor, d_im: torch.Tensor, dim) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_coherence_parts_pow` at the 4th power."""
    return _coherence_parts_pow(d_re, d_im, dim, 4)


def _coherence_score(d_re: torch.Tensor, d_im: torch.Tensor, dim, n_psk: int = 4) -> torch.Tensor:
    """Energy-weighted phase coherence |Σ |z|² e^{jpθ}| at the power p that
    cancels the data (8 for D8PSK, 4 otherwise); the magnitude is
    rotation-invariant, so timing selection survives CFO."""
    return torch.hypot(*_coherence_parts_pow(d_re, d_im, dim, n_psk))


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
    differential rotation from the winning offset's window differentials
    (``ops.kernels.psk_pass1_batch``: ``csrc/psk_pass1.cu`` on the card, the
    plain chain on the CPU). ``n_psk=8`` scores and estimates at the 8th
    power, anything else at the 4th (DBPSK and DQPSK both).

    Returns ``(x3d, r, best, theta)`` with best (B,) int32 and theta (B,).
    The span ``amr.pass1``.
    """
    device = (samples if x3d is None else x3d).device
    with span("amr.pass1", device):
        _, W_all, grams = _device_tables(spsym, float(carrier), sample_rate, n_offsets, device)
        row = _BLOCK_SYM * spsym
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
        best, theta = psk_pass1_batch(x3d, r0, W_all, grams, n_psk)
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


def _decide_inputs(samples, setup, spsym, carrier, sample_rate, cfo, n_offsets, pass1_psk):
    """Pass 1 and K1's operands: ``(x3d, W8, best, rot, b, r)``, for the
    ``setup`` of :func:`_batch_block_setup`."""
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
    kernel_variant: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched decision streams of shape (B, r*128), uint8, on the input's
    device: Gray ``(hi, lo)`` dibit lanes for ``n_psk=4``, the sign bits of
    the (re, im) differential for ``n_psk=2``.

    Pass 1 (4th power for both) picks each capture's timing offset and
    rotation θ; kernel K1 projects, differentiates, derotates by θ
    (``cfo=True``; identity otherwise) and decides. Entries past each
    capture's modulated span are garbage, which the sync tail and the frame
    parser ignore. ``kernel_variant`` is K1's body (default
    ``DECIDE_KERNEL_VARIANT``, "roll"); "succ" gives the same decisions, as
    in the JAX package, and runs the same kernel on the same templates here
    (K1 reads only their dual basis).

    Where there is no blocked path (a symbol over 32 samples, PSK31 among
    them, or a capture under 256 symbols) each capture runs the
    single-capture :func:`psk_demod_streams` (K11), the 3-window rotation
    estimate and the decision: shape (B, n_out) with the single-capture
    stream length.
    """
    if n_psk not in (2, 4):
        raise NotImplementedError(
            f"n_psk={n_psk}: decision streams exist for DBPSK (2) and DQPSK (4); "
            "D8PSK is psk8_sector_rows_batch"
        )
    variant = kernel_variant or DECIDE_KERNEL_VARIANT
    if variant not in ("roll", "succ"):
        raise ValueError(f"kernel_variant={kernel_variant!r}: K1's body is 'roll' or 'succ'")
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        d_re, d_im = psk_demod_streams_batch(samples, baud, carrier, sample_rate, n_offsets)
        if cfo:
            d_re, d_im = derotate(d_re, d_im, estimate_common_rotation_windows(d_re, d_im))
        return _decide(d_re, d_im, n_psk)
    x3d, W8, best, rot, b, r = _decide_inputs(
        samples, setup, spsym, carrier, sample_rate, cfo, n_offsets, pass1_psk=4
    )
    with span("amr.decide", x3d.device, kernel="K1"):
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
    decision). Without a blocked path it is :func:`psk8_sector_staged`."""
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        return psk8_sector_staged(samples, baud, carrier, sample_rate, cfo, n_offsets)
    x3d, W8, best, rot, b, r = _decide_inputs(
        samples, setup, spsym, carrier, sample_rate, cfo, n_offsets, pass1_psk=8
    )
    with span("amr.decide", x3d.device, kernel="K1"):
        sec = psk_project_decide_batch(x3d, W8, best, rot, rows_per_capture=r, n_psk=8)
    return sec.reshape(b, -1)


def psk8_sector_staged(
    samples: torch.Tensor, baud: float, carrier: float, sample_rate: int, cfo: bool = True,
    n_offsets: int = 8,
) -> torch.Tensor:
    """The staged D8PSK front half, the JAX package's float path: the
    differential streams of :func:`psk_demod_streams_batch` (K12, or K11 per
    capture), the 3-window 8th-power rotation estimate and derotation
    (``cfo``), then the sector decision. uint8 sectors (B, n_out)."""
    d_re, d_im = psk_demod_streams_batch(samples, baud, carrier, sample_rate, n_offsets, n_psk=8)
    if cfo:
        d_re, d_im = derotate(d_re, d_im, estimate_common_rotation_windows(d_re, d_im, n_psk=8))
    return psk8_sector_stream(d_re, d_im)


# --- the single-capture receiver ------------------------------------------------
#
# The JAX package's ``psk_demod_streams`` family (ops/psk.py:247-416 there):
# one capture, a 1-D tensor on any device. Pass 1 scores 8192-symbol windows
# reshaped to (w, spsym); pass 2 runs K11 for symbols of at most 32 samples
# and the (n_frames, spsym) template pair above that.


@functools.lru_cache(maxsize=32)
def _device_offset_tables(
    spsym: int, carrier: float, sample_rate: int, n_offsets: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, grams) on ``device``: the (2*spsym, 2*n_offsets) offset templates
    and the Gram entries, without the blocked templates (which would take
    gigabytes at PSK31's 3072-sample symbol)."""
    return (torch.from_numpy(_offset_templates(spsym, carrier, sample_rate, n_offsets)).to(device),
            torch.from_numpy(_offset_grams(spsym, carrier, sample_rate, n_offsets)).to(device))


def _psk_frame_setup(samples: torch.Tensor, spsym: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad a capture to a whole symbol count (ceil, keeping every
    sample): ``(x_flat float32, n_frames)``."""
    n = samples.shape[-1]
    n_frames = -(-n // spsym)
    if n_frames < 2:
        raise ValueError("signal shorter than two symbols")
    x_flat = samples.to(torch.float32)
    if n_frames * spsym > n:
        x_flat = F.pad(x_flat, (0, n_frames * spsym - n))
    return x_flat, n_frames


def _psk_pass1(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk):
    """Single-capture pass 1: timing-offset scores on up to three
    ``min(n_frames, 8192)``-symbol windows reshaped to (w, spsym), projected
    on every offset's template pair, Gram-scaled and scored by the
    energy-weighted coherence at the 4th (8th for ``n_psk=8``) power.
    Returns ``(best, score (n_offsets,))``; ties go to the first offset."""
    T, grams = _device_offset_tables(spsym, float(carrier), sample_rate, n_offsets, x_flat.device)
    w = min(n_frames, 1 << 13)
    starts = sorted({0, max(0, n_frames // 2 - w // 2), max(0, n_frames - w)})
    sub = torch.cat([x_flat[s * spsym : (s + w) * spsym].reshape(w, spsym) for s in starts])
    top = torch.matmul(T[:spsym].T, sub.T)  # (2K, nw)
    bot = torch.matmul(T[spsym:].T, sub.T)
    proj = top + F.pad(bot[:, 1:], (0, 1))
    re, im = _gram_scale(proj[0::2], proj[1::2], grams, offset_axis=0)
    s_re = re[:, 1:] * re[:, :-1] + im[:, 1:] * im[:, :-1]
    s_im = im[:, 1:] * re[:, :-1] - re[:, 1:] * im[:, :-1]
    score = _coherence_score(s_re, s_im, 1, n_psk)
    return torch.argmax(score), score


def _psk_project_xla(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best):
    """Pass 2 without a kernel: raw per-symbol phasors ``(re_f, im_f)`` at
    the winning offset. The blocked layout (one dense product per 128-symbol
    row) for symbols of at most 32 samples, of length ceil(n_frames/128)*128;
    the (n_frames, spsym) template pair above, of length n_frames."""
    if spsym <= _BLOCK_MAX_SPSYM:
        W8, _, _ = _device_tables(spsym, float(carrier), sample_rate, n_offsets, x_flat.device)
        row = _BLOCK_SYM * spsym
        ov = W8.shape[1] - row
        r = -(-n_frames // _BLOCK_SYM)
        x_pad = F.pad(x_flat[: n_frames * spsym], (0, r * row + ov - n_frames * spsym))
        xr = x_pad[: r * row].reshape(r, row)
        xn = torch.cat([xr[1:, :ov], x_pad[r * row : r * row + ov][None]])
        out = torch.cat([xr, xn], dim=1) @ W8[best]  # (r, 256)
        return out[:, :_BLOCK_SYM].reshape(-1), out[:, _BLOCK_SYM:].reshape(-1)
    T, _ = _device_offset_tables(spsym, float(carrier), sample_rate, n_offsets, x_flat.device)
    T_best = T.index_select(1, 2 * best + torch.arange(2, device=T.device))  # (2*spsym, 2)
    x = x_flat[: n_frames * spsym].reshape(n_frames, spsym)
    top = torch.matmul(T_best[:spsym].T, x.T)
    bot = torch.matmul(T_best[spsym:].T, x.T)
    pj = top + F.pad(bot[:, 1:], (0, 1))
    return pj[0], pj[1]


def _differential(re_f: torch.Tensor, im_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z[t+1]·conj z[t] along the last axis: one entry fewer."""
    return (re_f[..., 1:] * re_f[..., :-1] + im_f[..., 1:] * im_f[..., :-1],
            im_f[..., 1:] * re_f[..., :-1] - re_f[..., 1:] * im_f[..., :-1])


def psk_demod_streams(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One capture's differential phasor streams ``(d_re, d_im,
    best_score)``, on the capture's device.

    Pass 1 (:func:`_psk_pass1`) picks the timing offset; for symbols of at
    most 32 samples kernel K11 (``ops.kernels.psk_project_diff``) projects
    the capture's 64-row-padded blocked rows and forms the differential, and
    its output is trimmed to the length of the JAX package's XLA path,
    ceil(n_frames/128)*128 - 1, on every device (the TPU kernel's padded
    tail would otherwise reach the byte stream). Larger symbols take
    :func:`_psk_project_xla` and have n_frames - 1 entries.
    """
    spsym = _samples_per_symbol(sample_rate, baud)
    x_flat, n_frames = _psk_frame_setup(samples, spsym)
    best, score = _psk_pass1(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk)
    if spsym <= _BLOCK_MAX_SPSYM:
        W8, _, _ = _device_tables(spsym, float(carrier), sample_rate, n_offsets, x_flat.device)
        row = _BLOCK_SYM * spsym
        blk = 64  # the Pallas kernel's tile rows
        r = -(-n_frames // _BLOCK_SYM)
        r_pad = -(-r // blk) * blk
        x2d = F.pad(x_flat, (0, r_pad * row - n_frames * spsym)).reshape(r_pad, row)
        d_re, d_im = psk_project_diff(x2d, W8[best], block_rows=blk)
        n_out = r * _BLOCK_SYM - 1
        return d_re.reshape(-1)[:n_out], d_im.reshape(-1)[:n_out], score[best]
    re_f, im_f = _psk_project_xla(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best)
    d_re, d_im = _differential(re_f, im_f)
    return d_re, d_im, score[best]


def psk_symbol_streams(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw (pre-differential) per-symbol phasors ``(re_f, im_f,
    best_score)`` of one capture: pass 1 and :func:`_psk_project_xla`."""
    spsym = _samples_per_symbol(sample_rate, baud)
    x_flat, n_frames = _psk_frame_setup(samples, spsym)
    best, score = _psk_pass1(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, n_psk)
    re_f, im_f = _psk_project_xla(x_flat, n_frames, spsym, carrier, sample_rate, n_offsets, best)
    return re_f, im_f, score[best]


def estimate_common_rotation_windows(
    d_re: torch.Tensor, d_im: torch.Tensor, win: int = 1 << 15, n_psk: int = 4
) -> torch.Tensor:
    """The blind rotation estimate (4th power, 8th for ``n_psk=8``) from
    three ``win``-entry windows of the last axis (start, middle, end), or
    from all of it when it is at most 3*win long."""
    est = estimate_common_rotation8 if n_psk == 8 else estimate_common_rotation
    n = d_re.shape[-1]
    if n <= 3 * win:
        return est(d_re, d_im)
    starts = (0, (n - win) // 2, n - win)
    sl_re = torch.cat([d_re[..., s : s + win] for s in starts], dim=-1)
    sl_im = torch.cat([d_im[..., s : s + win] for s in starts], dim=-1)
    return est(sl_re, sl_im)


def derotate(d_re: torch.Tensor, d_im: torch.Tensor, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate differential phasors by −θ (θ broadcasts over leading axes)."""
    c, s = torch.cos(theta), torch.sin(theta)
    if d_re.ndim > theta.ndim:
        c, s = c[..., None], s[..., None]
    return d_re * c + d_im * s, d_im * c - d_re * s


def quarter_turn(d_re: torch.Tensor, d_im: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate by −k·π/2 exactly (sign and swap only): the CFO ambiguity retry."""
    k %= 4
    if k == 0:
        return d_re, d_im
    if k == 1:
        return d_im, -d_re
    if k == 2:
        return -d_re, -d_im
    return -d_im, d_re


def estimate_cfo(samples, baud: float, carrier: float, sample_rate: int, device: DeviceLike = None) -> float:
    """Carrier-frequency-offset estimate in Hz, resolved mod ``baud/4``.

    The modulator restarts the carrier every symbol, so an offset δ shows
    only as a constant rotation 2π·δ/baud of every differential phasor, and
    the blind 4th-power rotation estimate θ̂ of :func:`psk_demod_streams`'
    streams is that measurement: δ̂ = baud·θ̂/2π. ``samples`` is a numpy
    capture (on ``device``, default the card) or a tensor (on its own
    device unless ``device`` is named)."""
    if isinstance(samples, torch.Tensor) and device is None:
        x = samples.to(torch.float32)
    else:
        x = _to_device(samples, device)
    d_re, d_im, _ = psk_demod_streams(x, float(baud), float(carrier), int(sample_rate))
    theta = float(estimate_common_rotation(d_re, d_im))
    return theta * float(baud) / (2 * np.pi)


def qpsk_gray_streams(d_re: torch.Tensor, d_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differential phasor -> (hi, lo) Gray dibit streams, sign/compare only
    (sector boundaries at ±45° and ±135°)."""
    return _decide(d_re, d_im, 4)


def psk_demod_bits(
    samples: torch.Tensor, baud: float, carrier: float, sample_rate: int, n_psk: int, n_offsets: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capture to an interleaved bit stream ``(bits, best_score)``, on
    the capture's device: the sign of d_re for DBPSK (``n_psk=2``), the Gray
    (hi, lo) dibits interleaved for DQPSK. No blind derotation: without a
    frame sync to try the quarter-turn relabelings, derotating could turn a
    decodable static phase offset into an undecodable one."""
    d_re, d_im, best_score = psk_demod_streams(samples, baud, carrier, sample_rate, n_offsets)
    if n_psk == 2:
        return (d_re < 0).to(torch.uint8), best_score
    hi, lo = qpsk_gray_streams(d_re, d_im)
    return torch.stack([hi, lo], dim=1).reshape(-1), best_score


def psk_demod_streams_batch(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched float differential streams ``(d_re, d_im)``, each (B, n_out).

    With a blocked path (flat or pre-shaped rows): the batched pass 1, then
    kernel K12 (``ops.kernels.psk_project_diff_batch``) over every capture
    in one launch, trimmed to the XLA path's r*128 - 1 entries per capture.
    Without one (symbols over 32 samples, captures under 256 symbols):
    :func:`psk_demod_streams` per capture, as the JAX package's vmap."""
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        streams = [psk_demod_streams(s, baud, carrier, sample_rate, n_offsets, n_psk) for s in samples]
        return torch.stack([s[0] for s in streams]), torch.stack([s[1] for s in streams])
    b, n_frames, x3d, r = setup
    x3d, r, best, _theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r, n_psk
    )
    W8, _, _ = _device_tables(spsym, float(carrier), sample_rate, n_offsets, x3d.device)
    d_re, d_im = psk_project_diff_batch(x3d, W8, best, rows_per_capture=r)
    n_out = r * _BLOCK_SYM - 1
    return d_re.reshape(b, -1)[:, :n_out], d_im.reshape(b, -1)[:, :n_out]


def _blocked_project_xla(x3d: torch.Tensor, W8: torch.Tensor, best: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 without a kernel, for a batch: the overlapped rows (each
    row's successor's first ``ov`` samples appended, zeros after the last)
    times each capture's winning-offset template, one ``torch.bmm``. Raw
    per-symbol phasors ``(re_f, im_f)``, each (B, r*128)."""
    b = x3d.shape[0]
    ov = W8.shape[1] - x3d.shape[2]
    x3d = x3d.to(torch.float32)
    x_next = F.pad(x3d[:, 1:, :ov], (0, 0, 0, 1))
    out = torch.bmm(torch.cat([x3d, x_next], dim=2), W8[best.long()])  # (B, r, 256)
    return out[:, :, :_BLOCK_SYM].reshape(b, -1), out[:, :, _BLOCK_SYM:].reshape(b, -1)


def psk_raw_streams_batch(
    samples: torch.Tensor,
    baud: float,
    carrier: float,
    sample_rate: int,
    n_offsets: int = 8,
    n_psk: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched raw (pre-differential) per-symbol phasors ``(re_f, im_f)``,
    each (B, n_out), on the input's device: the DSSS despreader's front end,
    which sums chips before any differential, so K12 (which folds the
    differential in) cannot serve. The batched pass 1, then
    :func:`_blocked_project_xla`, on flat (B, N) captures or pre-shaped
    (B, r, 128*spsym) rows; without a blocked path :func:`psk_symbol_streams`
    per capture. Entries past each capture's signal are zero-pad garbage."""
    spsym = _samples_per_symbol(sample_rate, baud)
    setup = _batch_block_setup(samples, spsym)
    if setup is None:
        streams = [psk_symbol_streams(s, baud, carrier, sample_rate, n_offsets, n_psk) for s in samples]
        return torch.stack([s[0] for s in streams]), torch.stack([s[1] for s in streams])
    b, n_frames, x3d, r = setup
    x3d, r, best, _theta = _batch_pass1(
        samples, x3d, b, n_frames, spsym, carrier, sample_rate, n_offsets, r, n_psk
    )
    W8, _, _ = _device_tables(spsym, float(carrier), sample_rate, n_offsets, x3d.device)
    return _blocked_project_xla(x3d, W8, best)


# --- D8PSK sync + pack on one sector stream -----------------------------------------

def _psk8_expected_sectors(pattern: str, k: int) -> list:
    """The bit pattern as the received sector sequence under a channel
    rotation of k·π/4 (full tribits only)."""
    out = []
    for t in range(0, len(pattern) - 2, 3):
        tri = int(pattern[t]) * 4 + int(pattern[t + 1]) * 2 + int(pattern[t + 2])
        out.append((int(_GRAY8_INV[tri]) + k) % 8)
    return out


def _psk8_gray_bits(sec: torch.Tensor) -> torch.Tensor:
    """Sector stream (m,) -> interleaved Gray bit stream (3m,) uint8."""
    g = sec ^ (sec >> 1)
    return torch.stack([(g >> 2) & 1, (g >> 1) & 1, g & 1], dim=1).reshape(-1)


def psk8_sync_and_pack_rotations(
    sec: torch.Tensor, pattern: str, pattern2: str = "", tol: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sync + byte-pack one D8PSK sector stream under the 8 π/4-rotation
    hypotheses: full tribits of ``pattern`` match as sector equality (the
    straddling symbol's leading bits exactly), the ``pattern2`` region
    within ``tol`` Gray-bit misses; the first found rotation (k order) wins
    and the stream relabels and packs once from its match. Returns
    ``(packed, n_valid, found)``."""
    m = sec.shape[0]
    both = pattern + pattern2
    n_sym_pat = len(both) // 3
    n_exact_sym = len(pattern) // 3
    L = m - n_sym_pat + 1
    s32 = sec.to(torch.int32)
    g_rx = s32 ^ (s32 >> 1)
    starts, founds = [], []
    for k in range(8):
        match = torch.ones(L, dtype=torch.bool, device=sec.device)
        miss = torch.zeros(L, dtype=torch.int32, device=sec.device)
        for j, e in enumerate(_psk8_expected_sectors(both, k)):
            if j < n_exact_sym:
                match &= s32[j : j + L] == e
            else:
                x = g_rx[j : j + L] ^ (e ^ (e >> 1))
                if j == n_exact_sym and len(pattern) % 3:
                    lead_mask = (0, 0b100, 0b110)[len(pattern) % 3]
                    match &= (x & lead_mask) == 0
                miss = miss + (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1)
        if pattern2:
            match &= miss <= tol
        idx, found = first_true(match)
        founds.append(found)
        starts.append(torch.where(found, idx, 0))
    ksel, _ = first_true(torch.stack(founds))
    idx = torch.stack(starts)[ksel]
    found = torch.stack(founds)[ksel]
    st = ((s32 + (8 - ksel)) % 8).to(torch.uint8)  # relabel: true = rx - k
    packed, n_valid = pack_bits_from(_psk8_gray_bits(st)[None], (3 * idx).reshape(1))
    return packed[0], n_valid[0], found


def psk8_relabel_pack_batch(
    sec: torch.Tensor, ksel: torch.Tensor, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel + byte-pack (B, m) D8PSK sector streams (m % 128 == 0) on the
    winning hypothesis, in plain torch (the JAX package's XLA reference of
    K6): true sector = received − ``ksel`` (mod 8), the stream shifted by
    ``idx mod 8`` symbols only, so the magic sits at byte 3·(idx // 8).
    Returns ``(packed (B, m // 128 * 48) uint8, n_valid (B,) int32)``."""
    b, m = sec.shape
    r8 = (idx.to(torch.int32) % 8)
    packed = psk8_relabel_pack_rows_plain(sec.reshape(b, m // 128, 128), ksel.to(torch.int32), r8)
    return packed, ((3 * (m - r8)) // 8).to(torch.int32)


# --- the byte ladders ---------------------------------------------------------------

def _to_device(samples, device: DeviceLike) -> torch.Tensor:
    """A capture (numpy or tensor) as float32 on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(samples, torch.Tensor):
        return samples.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(samples, dtype=np.float32)).to(dev)


def _found(res) -> bool:
    """Read a rung's ``found`` flag to the host: the ``jax.lax.cond`` of the
    JAX ladders becomes this read and a Python branch (counted under
    ``host_reads`` by ``observability.host_read``)."""
    return host_read(res[2])


def _stream_bytes(packed: torch.Tensor, n_valid: torch.Tensor) -> bytes:
    return packed.cpu().numpy()[: int(n_valid)].tobytes()


def _sign_bits(v: torch.Tensor) -> torch.Tensor:
    return (v < 0).to(torch.uint8)


def _psk_bytes_cfo(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int, n_psk: int,
                   pattern: str, pattern2: str = ""):
    """CFO-robust DBPSK/DQPSK demod to bytes, the JAX ladder in order:
    validated rotation sync on the blindly derotated stream, then on the
    underotated stream, then the plain sync (parity only for DQPSK, the
    re stream for DBPSK) underotated. Returns ``(packed, n_valid, found)``."""
    d_re0, d_im0, _ = psk_demod_streams(samples, baud, carrier, sample_rate)
    d_re, d_im = derotate(d_re0, d_im0, estimate_common_rotation(d_re0, d_im0))
    if n_psk == 2:
        res1 = bit_sync_and_pack_rotations(_sign_bits(d_re), _sign_bits(d_im), pattern, pattern2)
        if _found(res1):
            return res1
        b0_re = _sign_bits(d_re0)
        res2 = bit_sync_and_pack_rotations(b0_re, _sign_bits(d_im0), pattern, pattern2)
        if _found(res2):
            return res2
        start, found = find_bit_pattern(b0_re[None], pattern)
        packed, n_valid = pack_bits_from(b0_re[None], start)
        return packed[0], n_valid[0], found[0]
    res1 = dibit_sync_and_pack_rotations(*qpsk_gray_streams(d_re, d_im), pattern, pattern2)
    if _found(res1):
        return res1
    hi0, lo0 = qpsk_gray_streams(d_re0, d_im0)
    res2 = dibit_sync_and_pack_rotations(hi0, lo0, pattern, pattern2)
    if _found(res2):
        return res2
    return dibit_sync_and_pack(hi0, lo0, pattern)


def _demod_to_bytes(samples, baud, carrier, samp_rate, n_psk, pattern, device: DeviceLike = None) -> bytes:
    packed, n_valid, _found_flag = _psk_bytes_cfo(
        _to_device(samples, device), float(baud), float(carrier), int(samp_rate), n_psk,
        pattern or MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2 if not pattern else "",
    )
    return _stream_bytes(packed, n_valid)


def bpsk_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                    device: DeviceLike = None) -> bytes:
    """DBPSK receive chain: bits -> magic-aligned bytes, on ``device``."""
    return _demod_to_bytes(samples, baud, carrier, samp_rate, 2, None, device)


def qpsk_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                    device: DeviceLike = None) -> bytes:
    """DQPSK receive chain: dibits -> magic-aligned bytes, on ``device``."""
    return _demod_to_bytes(samples, baud, carrier, samp_rate, 4, None, device)


def _psk8_bytes_cfo(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int,
                    pattern: str, pattern2: str = ""):
    """CFO-robust D8PSK demod to bytes: validated rotation sync on the
    8th-power-derotated sector stream, then underotated, then a plain k=0
    pack from offset 0."""
    d_re0, d_im0, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re0, d_im0, estimate_common_rotation8(d_re0, d_im0))
    res1 = psk8_sync_and_pack_rotations(psk8_sector_stream(d_re, d_im), pattern, pattern2)
    if _found(res1):
        return res1
    sec0 = psk8_sector_stream(d_re0, d_im0)
    res2 = psk8_sync_and_pack_rotations(sec0, pattern, pattern2)
    if _found(res2):
        return res2
    zero = torch.zeros(1, dtype=torch.int32, device=sec0.device)
    packed, n_valid = pack_bits_from(_psk8_gray_bits(sec0)[None], zero)
    return packed[0], n_valid[0], torch.zeros((), dtype=torch.bool, device=sec0.device)


def psk8_real_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                         device: DeviceLike = None) -> bytes:
    """D8PSK receive chain: tribits -> magic-aligned bytes, on ``device``."""
    packed, n_valid, _found_flag = _psk8_bytes_cfo(
        _to_device(samples, device), float(baud), float(carrier), int(samp_rate),
        MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2,
    )
    return _stream_bytes(packed, n_valid)


# --- the no-sync rescue fronts ------------------------------------------------------

def _psk_bytes_nosync(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int, n_psk: int):
    """Demod to bytes with no magic sync: derotate blind, pack from offset 0.
    A list of (packed, n_valid): the (re, im) sign streams for DBPSK, one
    dibit stream for DQPSK."""
    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation(d_re, d_im))
    zero = torch.zeros(1, dtype=torch.int32, device=d_re.device)
    if n_psk == 2:
        return [tuple(x[0] for x in pack_bits_from(_sign_bits(c)[None], zero)) for c in (d_re, d_im)]
    hi, lo = qpsk_gray_streams(d_re, d_im)
    return [relabel_shift_pack(hi, lo, zero[0], zero[0])]


def psk_nosync_streams(samples, baud: float, carrier: float, samp_rate: int, n_psk: int,
                       device: DeviceLike = None) -> list:
    """Host wrapper for :func:`_psk_bytes_nosync`: list of full byte streams."""
    pairs = _psk_bytes_nosync(_to_device(samples, device), float(baud), float(carrier), int(samp_rate),
                              int(n_psk))
    return [_stream_bytes(p, n) for p, n in pairs]


def _psk8_bytes_nosync(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int):
    """D8PSK no-sync rescue front: the derotated sector stream packed from
    offset 0 under all 8 rotation relabelings."""
    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation8(d_re, d_im))
    sec = psk8_sector_stream(d_re, d_im).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=sec.device)
    out = []
    for k in range(8):
        st = ((sec + (8 - k)) % 8).to(torch.uint8)
        out.append(tuple(x[0] for x in pack_bits_from(_psk8_gray_bits(st)[None], zero)))
    return out


def psk8_nosync_streams(samples, baud: float, carrier: float, samp_rate: int,
                        device: DeviceLike = None) -> list:
    """Host wrapper for :func:`_psk8_bytes_nosync`: 8 full byte streams."""
    pairs = _psk8_bytes_nosync(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    return [_stream_bytes(p, n) for p, n in pairs]


# --- soft bits for the soft-decision FEC decoders ----------------------------------

def psk_soft_bits(samples, baud: float, carrier: float, samp_rate: int, n_psk: int,
                  device: DeviceLike = None) -> np.ndarray:
    """Soft bit stream in [0, 1] (P(bit=1)-ish) from capture start, on
    ``device`` (K11 on the card), as numpy float32.

    For DQPSK the diagonal rotation makes both Gray bits independent signs:
    with diff phasor (u, v), hi = sign(-(u+v)) and lo = sign(v-u), so each
    bit's soft value is a linear scaling of its own component. DBPSK uses
    -d_re. The blind CFO derotation applies as in the hard path; the k·π/2
    ambiguity is left to the caller (``decoder._soft_rotation_variants``).
    """
    d_re, d_im, _ = psk_demod_streams(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation(d_re, d_im))
    d_re, d_im = d_re.cpu().numpy(), d_im.cpu().numpy()
    scale = np.mean(np.abs(d_re) + np.abs(d_im)) + 1e-9
    if n_psk == 2:
        return np.clip(0.5 - d_re / scale, 0.0, 1.0).astype(np.float32)
    a = d_re + d_im  # hi = 1 when a < 0
    b = d_im - d_re  # lo = 1 when b > 0
    soft = np.empty(2 * len(a), np.float32)
    soft[0::2] = np.clip(0.5 - a / scale, 0.0, 1.0)
    soft[1::2] = np.clip(0.5 + b / scale, 0.0, 1.0)
    return soft


def _psk8_soft_core(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int) -> torch.Tensor:
    """Derotated D8PSK differential phasors -> per-sector scores (n, 8)."""
    d_re, d_im, _ = psk_demod_streams(samples, baud, carrier, sample_rate, n_psk=8)
    d_re, d_im = derotate(d_re, d_im, estimate_common_rotation8(d_re, d_im))
    dirs = torch.tensor(np.stack([_ET_COS, _ET_SIN]), dtype=torch.float32, device=d_re.device)  # (2, 8)
    return torch.stack([d_re, d_im], dim=1) @ dirs  # (n, 8)


def psk8_soft_bits_rotations(samples, baud: float, carrier: float, samp_rate: int,
                             device: DeviceLike = None) -> list:
    """D8PSK soft Gray tribit streams under all 8 π/4-rotation hypotheses,
    on ``device``, as numpy float32.

    Per symbol, the per-sector score is the projection of the differential
    phasor onto each k·π/4 direction; each Gray bit's soft value is the
    max-log LLR (max score over sectors labeling the bit 1 minus max over
    sectors labeling it 0) mapped to [0,1]. A channel rotation of k·π/4 is a
    column permutation of the score matrix, so all 8 hypotheses come from
    one device pass. Element 0 is the k=0 stream.
    """
    scores = _psk8_soft_core(_to_device(samples, device), float(baud), float(carrier),
                             int(samp_rate)).cpu().numpy()  # (n, 8): column t = transmitted sector t under k=0
    n = scores.shape[0]
    g = _GRAY8.astype(np.int64)
    bit_is_one = np.stack([(g >> 2) & 1, (g >> 1) & 1, g & 1]).astype(bool)  # (3, 8)
    out = []
    for k in range(8):
        # Under hypothesis k, transmitted sector t was received as (t+k)%8.
        s_k = scores[:, (np.arange(8) + k) % 8]  # (n, 8) indexed by t
        scale = np.mean(np.abs(s_k)) * 2.0 + 1e-9
        soft = np.empty(3 * n, np.float32)
        for j in range(3):
            llr = np.max(s_k[:, bit_is_one[j]], axis=1) - np.max(s_k[:, ~bit_is_one[j]], axis=1)
            soft[j::3] = np.clip(0.5 + llr / scale, 0.0, 1.0)
        out.append(soft)
    return out


# --- the carrier-tracked (coherent) receivers ------------------------------------

def _jmod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` for a positive divisor: the truncated remainder, moved
    into [0, y)."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def _box_same(v: torch.Tensor, window: int) -> torch.Tensor:
    """``np.convolve(v, ones(window), "same")``: the full convolution sliced
    from (window-1)//2, i.e. entry i sums v[i - window + 1 + (window-1)//2 ..
    i + (window-1)//2]."""
    right = (window - 1) // 2
    vp = F.pad(v[None, None], (window - 1 - right, right))
    return F.conv1d(vp, v.new_ones((1, 1, window)))[0, 0]


def _tracked_phase(re_f: torch.Tensor, im_f: torch.Tensor, n_psk: int, window: int) -> torch.Tensor:
    """Viterbi&Viterbi carrier phase track θ̂(n) of raw symbol phasors at
    the data-cancelling power P (2, 4 or 8): the mean angular rate of the
    P-th-power phasors removed by a two-level wrapped ramp, a centred box
    average over ``window`` symbols, the ×P phase unwrapped, then /P."""
    if n_psk == 8:
        ur, ui = _eighth_power(re_f, im_f)
    elif n_psk == 4:
        ur, ui = _fourth_power(re_f, im_f)
    else:
        ur = re_f * re_f - im_f * im_f
        ui = 2.0 * re_f * im_f
    cr = ur[1:] * ur[:-1] + ui[1:] * ui[:-1]
    ci = ui[1:] * ur[:-1] - ur[1:] * ui[:-1]
    om = torch.atan2(torch.sum(ci), torch.sum(cr))  # rad/symbol in the xP domain
    n = re_f.shape[0]
    # The ramp om*n grows without bound; split the index as q*4096 + r and
    # wrap every intermediate mod 2π·P (whole turns, so θ̂ moves by 2π only).
    wrap = 2.0 * np.pi * float(n_psk)
    idx = torch.arange(n, dtype=torch.int32, device=re_f.device)
    om_hi = _jmod(om * 4096.0, wrap)
    ph = _jmod(_jmod(om_hi * (idx // 4096).to(torch.float32), wrap)
               + om * (idx % 4096).to(torch.float32), wrap)
    c, s = torch.cos(ph), torch.sin(ph)
    vr = ur * c + ui * s
    vi = ui * c - ur * s
    window = max(1, min(int(window), int(n)))
    thp = torch.atan2(_box_same(vi, window), _box_same(vr, window))
    d = _jmod(thp[1:] - thp[:-1] + np.pi, 2 * np.pi) - np.pi
    thu = torch.cat([thp[:1], thp[0] + torch.cumsum(d, dim=0)])
    return (thu + ph) / float(n_psk)


def _tracked_derotate(re_f, im_f, n_psk: int, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symbol phasors rotated by −θ̂(n) from :func:`_tracked_phase`."""
    th = _tracked_phase(re_f, im_f, n_psk, window)
    c, s = torch.cos(th), torch.sin(th)
    return re_f * c + im_f * s, im_f * c - re_f * s


def psk8_tracked_sectors(re_f: torch.Tensor, im_f: torch.Tensor, window: int = 128) -> torch.Tensor:
    """Coherent D8PSK sector deltas (n-1,) uint8: absolute π/4 sectors
    against the tracked reference, differenced mod 8."""
    k_abs = psk8_sector_stream(*_tracked_derotate(re_f, im_f, 8, window)).to(torch.int32)
    return ((k_abs[1:] - k_abs[:-1]) % 8).to(torch.uint8)


def qpsk_tracked_gray_streams(re_f: torch.Tensor, im_f: torch.Tensor, window: int = 128):
    """Coherent DQPSK Gray dibit streams: absolute quarter-turn sectors
    against the tracked reference, their delta mod 4, Gray relabelled."""
    wr, wi = _tracked_derotate(re_f, im_f, 4, window)
    k_abs = torch.where(torch.abs(wr) >= torch.abs(wi),
                        torch.where(wr >= 0, 0, 2), torch.where(wi >= 0, 1, 3)).to(torch.int32)
    d = (k_abs[1:] - k_abs[:-1]) % 4
    g = d ^ (d >> 1)
    return ((g >> 1) & 1).to(torch.uint8), (g & 1).to(torch.uint8)


def bpsk_tracked_bits(re_f: torch.Tensor, im_f: torch.Tensor, window: int = 128) -> torch.Tensor:
    """Coherent DBPSK bits (n-1,) uint8: the sign of the z²-tracked real
    part, XOR-differenced (the tracker's antipodal ambiguity cancels)."""
    wr, _ = _tracked_derotate(re_f, im_f, 2, window)
    k_abs = _sign_bits(wr)
    return k_abs[1:] ^ k_abs[:-1]


def _psk8_bytes_tracked(samples, baud, carrier, sample_rate, pattern, pattern2="", window=128):
    re_f, im_f, _ = psk_symbol_streams(samples, baud, carrier, sample_rate, n_psk=8)
    return psk8_sync_and_pack_rotations(psk8_tracked_sectors(re_f, im_f, window), pattern, pattern2)


def _psk_bytes_tracked(samples, baud, carrier, sample_rate, n_psk, pattern, pattern2="", window=128):
    """Coherent-tracked DBPSK/DQPSK demod to bytes: DBPSK needs one
    validated pattern find, DQPSK the 4-hypothesis dibit sync."""
    re_f, im_f, _ = psk_symbol_streams(samples, baud, carrier, sample_rate, n_psk=4)
    if n_psk == 2:
        bits = bpsk_tracked_bits(re_f, im_f, window)
        start, found = find_bit_pattern_validated(bits, pattern, pattern2)
        packed, n_valid = pack_bits_from(bits[None], start.reshape(1))
        return packed[0], n_valid[0], found
    return dibit_sync_and_pack_rotations(*qpsk_tracked_gray_streams(re_f, im_f, window), pattern, pattern2)


def psk8_tracked_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                            window: int = 128, device: DeviceLike = None) -> bytes:
    """Coherent-tracked D8PSK receive, the mode ladder's escalation."""
    packed, n_valid, _f = _psk8_bytes_tracked(
        _to_device(samples, device), float(baud), float(carrier), int(samp_rate),
        MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return _stream_bytes(packed, n_valid)


def qpsk_tracked_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                            window: int = 128, device: DeviceLike = None) -> bytes:
    """Coherent-tracked DQPSK receive, the mode ladder's escalation."""
    packed, n_valid, _f = _psk_bytes_tracked(
        _to_device(samples, device), float(baud), float(carrier), int(samp_rate), 4,
        MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return _stream_bytes(packed, n_valid)


def bpsk_tracked_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                            window: int = 128, device: DeviceLike = None) -> bytes:
    """Coherent-tracked DBPSK receive, the mode ladder's escalation."""
    packed, n_valid, _f = _psk_bytes_tracked(
        _to_device(samples, device), float(baud), float(carrier), int(samp_rate), 2,
        MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, int(window),
    )
    return _stream_bytes(packed, n_valid)
