"""Multicarrier DQPSK (OFDM4, OFDM8) on PyTorch: modulation and receive.

Counterpart of ``audio_modem_radio_tpu/ops/ofdm.py``. The wire format is
the same: K subcarriers spaced ``sample_rate/S`` apart around the carrier,
each carrying Gray-coded DQPSK differentially encoded per subcarrier across
time, the preamble and MSB-first data dibits split round-robin over the
subcarriers of each S-sample symbol. The bases and templates are numpy,
built by the JAX package's formulas, so both packages hold bitwise-equal
tables.

Receive (:func:`_ofdm_front`, written for a batch, the single capture being
a batch of one):

* pass 1: every sample offset within a symbol scored on up to three windows
  of at most 256 symbols (two float32 matmuls against the per-offset dual
  templates), per-subcarrier gain equalisation, the 4-fold coherence
  score, the first maximum;
* pass 2: each capture's S-overlapped rows (host-built, or built here from
  a flat capture) times its offset's row-shifted blocked dual, one
  ``torch.bmm`` for the batch against the tables of
  :func:`_ofdm_shift_tables`, kept per device;
* the K-lane differentials weighted by 1/g², the blind common rotation,
  and the Gray decisions (``ops.kernels._decide``), or, on escalation, the
  per-subcarrier Viterbi&Viterbi-tracked decisions.

The batched receive feeds the (hi, lo) dibit streams to the DQPSK sync
tails: kernels K2 and K3 on the card (``parallel.batch``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from ..utils.torchenv import DeviceLike
from .common import bytes_to_bits, dibit_sync_and_pack_rotations
from .kernels import _decide
from .psk import (
    QPSK_PREAMBLE_BITS,
    _stream_bytes,
    _to_device,
    _tracked_phase,
    derotate,
    estimate_common_rotation,
)

SAMPLE_RATE = 96000


def _symbol_samples(sample_rate: int, symbol_rate: int, n_sub: int) -> int:
    """OFDM symbol length in samples: a symbol every 2/symbol_rate seconds,
    at least 4 samples per basis dimension."""
    return max(2 * sample_rate // max(symbol_rate, 1), 8 * n_sub)


def _ramp(S: int) -> np.ndarray:
    env = np.ones(S)
    ramp = max(1, int(S * 0.1))
    env[:ramp] = np.linspace(0, 1, ramp)
    env[-ramp:] = np.linspace(1, 0, ramp)
    return env


@functools.lru_cache(maxsize=64)
def _ofdm_basis(S: int, carrier: float, n_sub: int, sample_rate: int) -> np.ndarray:
    """(2*n_sub, S) basis rows: (sin, cos) per subcarrier, ramp-windowed."""
    t = np.arange(S, dtype=np.float64) / sample_rate
    spacing = sample_rate / S
    env = _ramp(S)
    rows = []
    for c in range(n_sub):
        w = 2 * np.pi * (carrier + (c - (n_sub - 1) / 2) * spacing) * t
        rows.append(np.sin(w) * env)
        rows.append(np.cos(w) * env)
    return np.stack(rows).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ofdm_dual_templates(S: int, carrier: float, n_sub: int, sample_rate: int, n_offsets: int) -> np.ndarray:
    """(2S, n_offsets*2*n_sub) per-offset Gram-inverse dual bases: column
    block i holds the duals of the subcarrier basis shifted ``i*S//n_offsets``
    samples into a 2-symbol frame."""
    t2 = np.arange(2 * S, dtype=np.float64) / sample_rate
    spacing = sample_rate / S
    env = _ramp(S)
    K2 = 2 * n_sub
    T = np.zeros((2 * S, n_offsets * K2), dtype=np.float64)
    for i in range(n_offsets):
        o = i * S // n_offsets
        Bo = np.zeros((K2, S))
        for c in range(n_sub):
            w = 2 * np.pi * (carrier + (c - (n_sub - 1) / 2) * spacing) * t2[o : o + S]
            Bo[2 * c] = np.sin(w) * env
            Bo[2 * c + 1] = np.cos(w) * env
        G = Bo @ Bo.T + 1e-9 * np.eye(K2)
        T[o : o + S, i * K2 : (i + 1) * K2] = np.linalg.solve(G, Bo).T
    return T.astype(np.float32)


def ofdm_modulate(
    data_bytes: bytes,
    baud: float = 9600,
    carrier: float = 12000.0,
    num_subcarriers: int = 4,
    samp_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Multicarrier DQPSK synthesis: per-subcarrier (cos, sin) coefficients
    of the accumulated quarter turns times the basis, one float32 product,
    normalised to 0.9 peak."""
    K = num_subcarriers
    S = _symbol_samples(samp_rate, int(baud), K)
    bits = np.concatenate([np.asarray(QPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)])
    if len(bits) % 2:
        bits = np.concatenate([bits, np.zeros(1, np.uint8)])
    hi, lo = bits[0::2].astype(np.int64), bits[1::2].astype(np.int64)
    deltas = hi * 3 + lo * (1 - 2 * hi)  # Gray dibit -> quarter turns
    n_sym = -(-len(deltas) // K)
    grid = np.pad(deltas, (0, n_sym * K - len(deltas))).reshape(n_sym, K)
    phase_qt = np.cumsum(grid, axis=0) % 4  # differential per subcarrier across time
    coeff = np.empty((n_sym, 2 * K), np.float32)
    coeff[:, 0::2] = np.array([1.0, 0.0, -1.0, 0.0])[phase_qt]
    coeff[:, 1::2] = np.array([0.0, 1.0, 0.0, -1.0])[phase_qt]
    basis = torch.from_numpy(_ofdm_basis(S, float(carrier), K, samp_rate))
    wave = (torch.from_numpy(coeff) @ basis).reshape(-1).numpy()
    peak = np.max(np.abs(wave))
    return (wave / peak * 0.9).astype(np.float32) if peak > 0 else wave.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ofdm_blocked_dual(S: int, carrier: float, n_sub: int, sample_rate: int, L: int) -> np.ndarray:
    """(L*S, 2*L*K) block-diagonal offset-0 dual template: row block l
    projects symbol l, column ``l*K + k`` holding subcarrier k's
    sin-coefficient dual and ``L*K + l*K + k`` its cos-coefficient dual, so
    the output is [re lanes | im lanes], symbol-major, subcarrier-minor."""
    B = _ofdm_basis(S, carrier, n_sub, sample_rate).astype(np.float64)
    D = np.linalg.solve(B @ B.T + 1e-9 * np.eye(2 * n_sub), B)  # (2K, S)
    K = n_sub
    W = np.zeros((L * S, 2 * L * K), dtype=np.float32)
    for l in range(L):
        for k in range(K):
            W[l * S : (l + 1) * S, l * K + k] = D[2 * k]
            W[l * S : (l + 1) * S, L * K + l * K + k] = D[2 * k + 1]
    return W


def _ofdm_rows_per_block(S: int) -> int:
    """Symbols per row: a row of about 1024 samples."""
    return max(1, 1024 // S)


def ofdm_blocked_row_shape(n_samples: int, baud: float, n_sub: int, sample_rate: int) -> Optional[Tuple[int, int, int]]:
    """(r, row=L*S, overlap=S) of the host-built overlapped rows
    (``parallel.batch.host_shape_batch``), or None for a capture under
    three symbols."""
    S = _symbol_samples(sample_rate, int(baud), int(n_sub))
    L = _ofdm_rows_per_block(S)
    n_sym = int(n_samples) // S
    if n_sym < 3:
        return None
    return -(-n_sym // L), L * S, S


@functools.lru_cache(maxsize=4)
def _ofdm_shift_tables(S: int, carrier: float, n_sub: int, sample_rate: int, L: int,
                       device: torch.device) -> torch.Tensor:
    """(S, L*S+S, 2*L*K) row-shifted blocked duals on ``device``, one per
    timing offset: ``T[o][j] = W[j-o]`` for ``o <= j < o+L*S``, else zero,
    so row i of the o-shifted stream projects as the overlapped row
    ``flat[i*L*S : (i+1)*L*S + S] @ T[o]``. Built once per geometry and
    device (34.6 MB for OFDM4@9600, 71.3 MB for OFDM8@9600)."""
    W = torch.from_numpy(_ofdm_blocked_dual(S, carrier, n_sub, sample_rate, L)).to(device)
    LS, C = W.shape
    z = F.pad(W, (0, 0, S, S))
    return torch.stack([z[S - o : S - o + LS + S] for o in range(S)])


@functools.lru_cache(maxsize=8)
def _device_dual_templates(S: int, carrier: float, n_sub: int, sample_rate: int, n_offsets: int,
                           device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ofdm_dual_templates(S, carrier, n_sub, sample_rate, n_offsets)).to(device)


def _ofdm_front(samples: torch.Tensor, baud: float, carrier: float, n_sub: int, sample_rate: int,
                n_offsets: int = 0) -> dict:
    """Passes 1 and 2 for (B, N) flat captures or (B, r, L*S+S) overlapped
    rows: ``{"re", "im"}`` the (B, r*L*K) raw subcarrier phasors at each
    capture's offset (symbol-major, subcarrier-minor), ``"best"`` and
    ``"score"`` (B,) the offset index and its score, and the geometry
    ``"K"``, ``"L"``, ``"r"``, ``"n_sym"``.

    Flat captures count ceil(N/S) symbols: with a lead that is not a
    multiple of S, the last symbol's tail falls in the partial one. Trailing
    zero symbols add only zero projections. Fewer than three symbols raise
    ValueError."""
    K = n_sub
    S = _symbol_samples(sample_rate, int(baud), K)
    L = _ofdm_rows_per_block(S)
    LS = L * S
    if n_offsets <= 0:
        n_offsets = S
    pre = samples.ndim == 3
    if pre:
        rows_ov = samples.to(torch.float32)
        b, r, cols = rows_ov.shape
        if cols != LS + S:
            raise ValueError("pre-shaped OFDM rows must be (r, L*S+S)")
        n_sym = r * L
    else:
        b, n = samples.shape
        n_sym = -(-n // S)
    if n_sym < 3:
        raise ValueError("signal shorter than three OFDM symbols")
    if not pre:
        xf = F.pad(samples.to(torch.float32), (0, n_sym * S - n))
    dev = samples.device
    T = _device_dual_templates(S, float(carrier), K, sample_rate, n_offsets, dev)

    # Pass 1: every offset on up to three windows of at most 256 symbols.
    wsyms = min(n_sym - 1, 256)
    starts = sorted({0, max(0, n_sym // 2 - wsyms // 2), max(0, n_sym - 1 - wsyms)})
    if pre:
        # A window starts at its row boundary; its rows plus the last row's
        # overlap hold its (wsyms+1)*S contiguous samples.
        wrows = -(-(wsyms + 1) // L)
        wins = []
        for s in starts:
            r0 = min(s // L, r - wrows)
            w = rows_ov[:, r0 : r0 + wrows]
            flat_w = torch.cat([w[:, :, :LS].reshape(b, -1), w[:, -1, LS:]], dim=1)
            wins.append(flat_w[:, : (wsyms + 1) * S])
    else:
        wins = [xf[:, s * S : (s + wsyms + 1) * S] for s in starts]
    xw = torch.cat([w[:, : wsyms * S].reshape(b, wsyms, S) for w in wins], dim=1)
    xw_next = torch.cat([w[:, S:].reshape(b, wsyms, S) for w in wins], dim=1)
    projw = (xw @ T[:S] + xw_next @ T[S:]).reshape(b, -1, n_offsets, K, 2)
    rew, imw = projw[..., 0], projw[..., 1]  # (B, nw, n_off, K)
    # Per-subcarrier gain equalisation per offset, over the windows.
    gains_w = torch.sqrt(torch.mean(rew * rew + imw * imw, dim=1)) + 1e-9
    rew = rew / gains_w[:, None]
    imw = imw / gains_w[:, None]
    d_re = rew[:, 1:] * rew[:, :-1] + imw[:, 1:] * imw[:, :-1]
    d_im = imw[:, 1:] * rew[:, :-1] - rew[:, 1:] * imw[:, :-1]
    a, c = d_re * d_re, d_im * d_im
    score = torch.sum(((a - c) * (a - c) - 4 * a * c) / (a + c + 1e-20), dim=(1, 3))  # (B, n_off)
    best = torch.argmax(score, dim=1)  # the first maximum

    # Pass 2: each capture's overlapped rows times its offset's table.
    if not pre:
        r = -(-n_sym // L)
        xpad = F.pad(xf, (0, (r + 1) * LS - n_sym * S))
        main = xpad[:, : r * LS].reshape(b, r, LS)
        nxt = xpad[:, LS:].reshape(b, r, LS)[:, :, :S]
        rows_ov = torch.cat([main, nxt], dim=2)
    tables = _ofdm_shift_tables(S, float(carrier), K, sample_rate, L, dev)
    proj = torch.bmm(rows_ov, tables[best * S // n_offsets])  # (B, r, 2LK): [re | im]
    LK = L * K
    return {"re": proj[:, :, :LK].reshape(b, -1), "im": proj[:, :, LK:].reshape(b, -1),
            "best": best, "score": torch.gather(score, 1, best[:, None])[:, 0],
            "K": K, "L": L, "r": r, "n_sym": n_sym}


def _ofdm_differentials(front: dict, cfo: bool = True):
    """``(dr, di, gains)``: the K-lane differentials (B, (n_sym-1)*K),
    weighted by each subcarrier's 1/g² and, with ``cfo``, derotated by the
    blind common rotation; the subcarrier gains (B, K)."""
    re, im, K, L, r, n_sym = (front[k] for k in ("re", "im", "K", "L", "r", "n_sym"))
    b, LK = re.shape[0], L * K
    p2 = (re * re + im * im).reshape(b, r, LK)
    gains = torch.sqrt(p2.sum(dim=1).reshape(b, L, K).sum(dim=1) / n_sym) + 1e-9
    re_n, im_n = F.pad(re[:, K:], (0, K)), F.pad(im[:, K:], (0, K))
    dr = re_n * re + im_n * im
    di = im_n * re - re_n * im
    pattern = (1.0 / (gains * gains)).repeat(1, L)[:, None, :]  # lane j is subcarrier j % K
    n_d = (n_sym - 1) * K
    dr = (dr.reshape(b, r, LK) * pattern).reshape(b, -1)[:, :n_d]
    di = (di.reshape(b, r, LK) * pattern).reshape(b, -1)[:, :n_d]
    if cfo:
        dr, di = derotate(dr, di, estimate_common_rotation(dr, di))
    return dr, di, gains


def _ofdm_tracked_dibits(re: torch.Tensor, im: torch.Tensor, K: int, n_sym: int, window: int):
    """One capture's per-subcarrier Viterbi&Viterbi-tracked Gray dibit
    streams in wire order: each subcarrier's z⁴ track, absolute quarter-turn
    decisions against it, their deltas across time Gray relabelled. Streams
    of ``(n_sym-1)*K`` dibits."""
    reK, imK = re.reshape(-1, K).T, im.reshape(-1, K).T  # (K, n_tot)
    th = torch.stack([_tracked_phase(reK[k], imK[k], 4, window) for k in range(K)])
    c, s = torch.cos(th), torch.sin(th)
    wr = reK * c + imK * s
    wi = imK * c - reK * s
    k_abs = torch.where(torch.abs(wr) >= torch.abs(wi), torch.where(wr >= 0, 0, 2),
                        torch.where(wi >= 0, 1, 3)).to(torch.int32)
    d = (k_abs[:, 1:] - k_abs[:, :-1]) % 4
    g = d ^ (d >> 1)
    n_d = (n_sym - 1) * K
    hi = ((g >> 1) & 1).to(torch.uint8).T.reshape(-1)[:n_d]
    lo = (g & 1).to(torch.uint8).T.reshape(-1)[:n_d]
    return hi, lo


def ofdm_decision_streams_batch(
    samples: torch.Tensor, baud: float, carrier: float, n_sub: int, sample_rate: int, cfo: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched captures -> Gray (hi, lo) dibit streams, each (B, n_dibits)
    uint8 on the input's device: (B, N) flat captures or the host-built
    (B, r, L*S+S) overlapped rows."""
    dr, di, _gains = _ofdm_differentials(_ofdm_front(samples, baud, carrier, n_sub, sample_rate), cfo)
    return _decide(dr, di, 4)


def ofdm_demod_bits(
    samples, baud: float, carrier: float, n_sub: int, sample_rate: int, n_offsets: int = 0,
    n_pilot: int = 16, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One capture, on ``device`` (default: the card): the interleaved Gray
    bits, the winning offset's score and the subcarrier gains."""
    del n_pilot
    x = _to_device(samples, device)[None]
    front = _ofdm_front(x, baud, carrier, n_sub, sample_rate, n_offsets)
    dr, di, gains = _ofdm_differentials(front)
    hi, lo = _decide(dr[0], di[0], 4)
    return torch.stack([hi, lo], dim=1).reshape(-1), front["score"][0], gains[0]


def ofdm_demodulate(samples, baud: float = 9600, carrier: float = 12000.0, num_subcarriers: int = 4,
                    samp_rate: int = SAMPLE_RATE, device: DeviceLike = None) -> bytes:
    """OFDM receive chain: dibits -> the 4-rotation magic sync -> bytes."""
    bits, _score, _gains = ofdm_demod_bits(samples, float(baud), float(carrier), int(num_subcarriers),
                                           int(samp_rate), device=device)
    packed, n_valid, _found = dibit_sync_and_pack_rotations(bits[0::2], bits[1::2], MAGIC_BIT_PATTERN,
                                                            MAGIC_BIT_PATTERN2)
    return _stream_bytes(packed, n_valid)


def ofdm_tracked_demodulate(samples, baud: float = 9600, carrier: float = 12000.0, num_subcarriers: int = 4,
                            samp_rate: int = SAMPLE_RATE, window: int = 64, device: DeviceLike = None) -> bytes:
    """Coherent-tracked OFDM receive, the mode ladder's escalation: the
    shared projection front end, per-subcarrier tracked dibits, the
    4-hypothesis rotation sync (the tracks' k·π/2 ambiguities cancel in the
    deltas)."""
    x = _to_device(samples, device)[None]
    front = _ofdm_front(x, float(baud), float(carrier), int(num_subcarriers), int(samp_rate))
    hi, lo = _ofdm_tracked_dibits(front["re"][0], front["im"][0], front["K"], front["n_sym"], int(window))
    packed, n_valid, _found = dibit_sync_and_pack_rotations(hi, lo, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    return _stream_bytes(packed, n_valid)


def ofdm_soft_bits(samples, baud: float, carrier: float, n_sub: int, sample_rate: int,
                   device: DeviceLike = None) -> np.ndarray:
    """Soft dibit stream in [0, 1] for the soft-decision FEC escalations:
    the DQPSK diagonal mapping (hi = 1 iff dr+di < 0, lo = 1 iff di-dr > 0),
    each bit a linear scaling of its own rotated component."""
    x = _to_device(samples, device)[None]
    dr, di, _gains = _ofdm_differentials(_ofdm_front(x, float(baud), float(carrier), int(n_sub),
                                                     int(sample_rate)))
    dr, di = dr[0].cpu().numpy(), di[0].cpu().numpy()
    scale = np.mean(np.abs(dr) + np.abs(di)) + 1e-9
    a = dr + di
    b = di - dr
    soft = np.empty(2 * len(a), np.float32)
    soft[0::2] = np.clip(0.5 - a / scale, 0.0, 1.0)
    soft[1::2] = np.clip(0.5 + b / scale, 0.0, 1.0)
    return soft


def estimate_subcarrier_gains(samples, baud: float = 9600, carrier: float = 12000.0, num_subcarriers: int = 4,
                              samp_rate: int = SAMPLE_RATE, device: DeviceLike = None) -> np.ndarray:
    """The per-subcarrier channel magnitudes (diagnostics)."""
    _bits, _score, gains = ofdm_demod_bits(samples, float(baud), float(carrier), int(num_subcarriers),
                                           int(samp_rate), device=device)
    return gains.cpu().numpy()
