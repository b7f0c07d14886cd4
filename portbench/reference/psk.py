"""Plain reference receive of the ``psk`` family (DQPSK), in plain PyTorch.

It works out from the benchmark's float captures everything the program
derives, and decides the same bytes by the same rules, written here from
the receive's description and not taken from the program:

1. 16-bit PCM samples in blocked rows of 128 symbols (``rows``), zero rows
   up to a multiple of 256.
2. Pass 1 (timing and rotation): three windows of 64 rows (first, middle,
   last; each row's next-row overlap taken from the next row, except in the
   last window, which the array's edge shifts by one row). Each window is
   scaled by its capture's largest sample and projected on the least-squares
   dual basis of the ramped carrier at 8 timing offsets; the phasors are
   scaled to matched energy, and each offset scores |sum |d|^2 e^{j4 arg d}|
   over the in-row differentials d. The best offset's differentials give
   the common rotation theta = arg(sum |d|^2 e^{j4 arg d}) / 4.
3. Decisions: every symbol projected at the best offset, the differential
   z[j+1] conj(z[j]) (zero past the capture), derotated by theta, decided
   to Gray dibits (hi = the sign of the larger axis, lo = hi xor "imaginary
   axis larger").
4. Sync: the first position of the 32-bit magic ("FB" exact, "PC" within 3
   bit errors) in the dibit stream relabelled by each quarter-turn
   rotation k, at even and odd bit parity; positions up to 17 dibits before
   the stream's end. The first rotation (in k order) that matched anywhere
   wins, at its earlier parity.
5. Pack: the relabelled stream from bit s & 7, MSB first; n_valid =
   (2 * dibits - (s & 7)) // 8.

``precision`` "float32" is the reference; "tf32" rounds the operands of
its products to TF32 and "cublas_tf32" lets cuBLAS take TF32 where it
will (``channel.mm``): the two forms of the control that has to fail the
comparison.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..channel import ieee_float32, mm, pcm16
from ..frames import MAGIC_BITS, MAGIC_BITS2

N_OFFSETS = 8
ROW_SYMBOLS = 128
ROW_BLOCK = 256
PASS1_ROWS = 64
SYNC_TOLERANCE = 3
_BIG = 1 << 40


def _sps(cfg: dict) -> int:
    return int(cfg["sample_rate"] / cfg["symbol_rate"])


def rows(n_samples: int, cfg: dict) -> int:
    n_symbols = -(-n_samples // _sps(cfg))
    r = -(-n_symbols // ROW_SYMBOLS)
    return max(ROW_BLOCK, -(-r // ROW_BLOCK) * ROW_BLOCK)


@functools.lru_cache(maxsize=8)
def _tables(sps: int, carrier: float, sr: int):
    """(T (2sps, 2K) dual bases, grams (K, 3), W_all (row+ov, K*256) blocked pass-1 matrix)."""
    env = np.ones(sps)
    ramp = int(sps * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    w = 2 * np.pi * carrier * np.arange(2 * sps, dtype=np.float64) / sr
    T = np.zeros((2 * sps, 2 * N_OFFSETS))
    grams = np.zeros((N_OFFSETS, 3))
    for i in range(N_OFFSETS):
        o = i * sps // N_OFFSETS
        B = np.stack([np.sin(w[o : o + sps]) * env, np.cos(w[o : o + sps]) * env], axis=1)
        g = B.T @ B
        T[o : o + sps, 2 * i : 2 * i + 2] = B @ np.linalg.inv(g + 1e-9 * np.eye(2))
        grams[i] = g[0, 0], g[0, 1], g[1, 1]
    T = T.astype(np.float32)
    row = ROW_SYMBOLS * sps
    ov = 128 * -(-2 * sps // 128)
    W = np.zeros((row + ov, N_OFFSETS * 2 * ROW_SYMBOLS), np.float32)
    for i in range(N_OFFSETS):
        for s in range(ROW_SYMBOLS):
            col = i * 2 * ROW_SYMBOLS + s
            W[s * sps : s * sps + 2 * sps, col] = T[:, 2 * i]
            W[s * sps : s * sps + 2 * sps, col + ROW_SYMBOLS] = T[:, 2 * i + 1]
    return T, grams.astype(np.float32), W


def _fourth_power(dr: torch.Tensor, di: torch.Tensor):
    a, b = dr * dr, di * di
    u, v, w = a - b, 2 * dr * di, a + b + 1e-20
    return (u * u - v * v) / w, (2 * u * v) / w


def _pass1(x3d: torch.Tensor, W: torch.Tensor, grams: torch.Tensor, precision: str):
    """(best (b,) int64, theta (b,) float32) of (b, r, row) PCM rows."""
    b, r, row = x3d.shape
    ov = W.shape[0] - row
    wr = min(PASS1_ROWS, r)
    wins = []
    for s in sorted({0, max(0, r // 2 - wr // 2), max(0, r - wr)}):
        n0 = min(max(min(s + 1, r - wr + 1), 0), r - wr)
        wins.append(torch.cat([x3d[:, s : s + wr], x3d[:, n0 : n0 + wr, :ov]], dim=2))
    wins = torch.cat(wins, dim=1)
    wins = wins / torch.clamp_min(torch.amax(torch.abs(wins), dim=(1, 2), keepdim=True), 1e-12)
    proj = mm(wins, W, precision).reshape(b, -1, N_OFFSETS, 2, ROW_SYMBOLS)
    re, im = proj[:, :, :, 0], proj[:, :, :, 1]
    g = [grams[:, j].reshape(1, 1, N_OFFSETS, 1) for j in range(3)]
    a, c = g[0] * re + g[1] * im, g[1] * re + g[2] * im
    scale = torch.sqrt((a * a + c * c) / (re * re + im * im + 1e-20))
    re, im = re * scale, im * scale
    dr = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    di = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    r4, i4 = _fourth_power(dr, di)
    best = torch.argmax(torch.hypot(r4.sum(dim=(1, 3)), i4.sum(dim=(1, 3))), dim=1)
    pick = best[:, None, None, None].expand(-1, dr.shape[1], 1, dr.shape[3])
    r4b, i4b = _fourth_power(torch.gather(dr, 2, pick).reshape(b, -1), torch.gather(di, 2, pick).reshape(b, -1))
    theta = torch.atan2(i4b.sum(dim=1), r4b.sum(dim=1)) / 4
    return best, theta


def _decide(x3d: torch.Tensor, T: torch.Tensor, best: torch.Tensor, theta: torch.Tensor, sps: int,
            precision: str):
    """Gray (hi, lo) uint8 decisions, (b, r*128) each."""
    b, r, row = x3d.shape
    flat = F.pad(x3d.reshape(b, r * row), (0, 2 * sps))
    win = flat.unfold(1, 2 * sps, sps)[:, : r * ROW_SYMBOLS]  # symbol j: samples [j*sps, j*sps + 2*sps)
    basis = T.reshape(2 * sps, N_OFFSETS, 2)[:, best].permute(1, 0, 2)  # (b, 2sps, 2)
    z = mm(win, basis, precision)
    re, im = z[..., 0], z[..., 1]
    re1 = F.pad(re[:, 1:], (0, 1))
    im1 = F.pad(im[:, 1:], (0, 1))
    d_re, d_im = re1 * re + im1 * im, im1 * re - re1 * im
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    dr, di = d_re * c + d_im * s, d_im * c - d_re * s
    swap = torch.abs(di) > torch.abs(dr)
    neg = torch.where(swap, di, dr) < 0
    return neg.to(torch.uint8), (neg ^ swap).to(torch.uint8)


def _rotated_bits(gray: torch.Tensor, k) -> torch.Tensor:
    """The dibit stream rotated back by k quarter turns, as (b, 2n) bits."""
    g = (gray - k) % 4
    return torch.stack([g >= 2, (g == 1) | (g == 2)], dim=2).reshape(gray.shape[0], -1).to(torch.uint8)


def _words16(bits: torch.Tensor, n_pos: int) -> torch.Tensor:
    acc = torch.zeros((bits.shape[0], n_pos), dtype=torch.int32, device=bits.device)
    for i in range(16):
        acc = acc * 2 + bits[:, i : i + n_pos]
    return acc


def _sync(gray: torch.Tensor):
    """(s (b,) bit position, ksel (b,), found (b,)) of the magic search."""
    b, n_dib = gray.shape
    dev = gray.device
    n_pos = 2 * (n_dib - 17)  # bit positions 2t and 2t+1 for t < n_dib - 17
    pat1 = int(MAGIC_BITS, 2)
    pat2 = torch.tensor([int(c) for c in MAGIC_BITS2], dtype=torch.uint8, device=dev)
    first = torch.full((b, 4, 2), _BIG, dtype=torch.int64, device=dev)  # (capture, k, parity): dibit t
    for k in range(4):
        bits = _rotated_bits(gray, k)
        cap, pos = torch.nonzero(_words16(bits, n_pos) == pat1, as_tuple=True)
        tail = bits[cap[:, None], pos[:, None] + 16 + torch.arange(16, device=dev)]
        ok = (tail != pat2).sum(dim=1) <= SYNC_TOLERANCE
        cap, pos = cap[ok], pos[ok]
        flat = first[:, k].reshape(-1)
        flat.scatter_reduce_(0, cap * 2 + pos % 2, pos // 2, reduce="amin")
        first[:, k] = flat.reshape(b, 2)
    found_p = first < _BIG
    fe, fo = found_p[..., 0], found_p[..., 1]
    se, so = 2 * first[..., 0], 2 * first[..., 1] + 1
    s_k = torch.where(fe & (~fo | (se <= so)), se, torch.where(fo, so, torch.zeros_like(se)))
    found_k = fe | fo
    ksel = torch.argmax(found_k.to(torch.uint8), dim=1)
    s = torch.gather(s_k, 1, ksel[:, None])[:, 0]
    found = torch.gather(found_k, 1, ksel[:, None])[:, 0]
    return s, ksel, found


def _pack(gray: torch.Tensor, s: torch.Tensor, ksel: torch.Tensor) -> torch.Tensor:
    b, n_dib = gray.shape
    bits = _rotated_bits(gray, ksel[:, None])
    sh = s & 7
    idx = sh[:, None] + torch.arange(2 * n_dib, device=gray.device)
    bits = torch.gather(F.pad(bits, (0, 8)), 1, idx).reshape(b, -1, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=gray.device)
    return (bits * weights).sum(dim=2).to(torch.uint8)


def receive(captures: np.ndarray, cfg: dict, device, precision: str = "float32", block: int = 8) -> dict:
    """(B, N) float captures -> packed (B, r*32) uint8, n_valid, found, best,
    theta, s and ksel, as numpy arrays; ``block`` captures at a time."""
    n_cap, n = captures.shape
    sps = _sps(cfg)
    r, row = rows(n, cfg), ROW_SYMBOLS * sps
    T, grams, W = (torch.from_numpy(a).to(device) for a in _tables(sps, float(cfg["carrier_hz"]),
                                                                      int(cfg["sample_rate"])))
    out = {k: [] for k in ("packed", "n_valid", "found", "best", "theta", "s", "ksel")}
    with torch.no_grad(), ieee_float32():
        for i0 in range(0, n_cap, block):
            x = pcm16(torch.from_numpy(captures[i0 : i0 + block]).to(device))
            x3d = F.pad(x, (0, r * row - n)).reshape(x.shape[0], r, row)
            best, theta = _pass1(x3d, W, grams, precision)
            hi, lo = _decide(x3d, T, best, theta, sps, precision)
            del x, x3d
            gray = 2 * hi + (hi ^ lo)
            s, ksel, found = _sync(gray)
            packed = _pack(gray, s, ksel)
            n_valid = (2 * gray.shape[1] - (s & 7)) // 8
            for k, v in zip(out, (packed, n_valid, found, best, theta, s, ksel)):
                out[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
