"""Plain reference receive of the ``fsk`` family, mid tone separation
(0.4 to 0.8 cycles a bit, as FSK19200), in plain PyTorch.

It works out from the benchmark's float captures everything the program
derives, written here from the receive's description:

1. 16-bit PCM samples.
2. The analytic band-pass signal z[n] = sum_k h[k] x[n + 64 - k]: a
   129-tap Blackman-windowed sinc over [min tone - baud, max tone + baud],
   shifted to the band's center, gain 2 there. Computed as rows of 256
   samples (128 outputs each) against the filter's dense matrix.
3. Bit rows of 640 analytic samples (128 bits) plus a 128-sample overlap;
   for each of 8 timing offsets o = i*spb//8, bit s of a row correlates
   samples [5s + o, 5s + o + 5) with cos and sin of each tone (time counted
   from the row's start). The noncoherent margin is
   |z . mark|^2 - |z . space|^2 and a bit is 1 where it is positive.
4. Pass 1: the offset with the largest sum of |margin| over three windows
   of 4 bit rows (first, middle, last FIR window that fits).
5. Sync: the first position of the 16-bit magic "FB", exact; 0 where absent.
6. Pack: the bits from that position, MSB first, zeros past the end;
   n_valid = (bits - start) // 8.

``precision`` "tf32" or "cublas_tf32" is the control, as in ``reference.psk``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..channel import ieee_float32, mm, pcm16
from ..frames import MAGIC_BITS

N_OFFSETS = 8
TAPS = 129
LANES = 128
PASS1_ROWS = 4


def geometry(n_samples: int, cfg: dict) -> dict:
    sr, baud = int(cfg["sample_rate"]), float(cfg["symbol_rate"])
    mark, space = float(cfg["mark_hz"]), float(cfg["space_hz"])
    spb = int(round(sr / baud))
    sep = abs(mark - space) * spb / sr
    if not 0.4 <= sep < 0.8:
        raise ValueError(f"tone separation {sep:.3f} cycles a bit: this reference covers 0.4 to 0.8")
    row2 = spb * LANES // math.gcd(spb, LANES)  # analytic samples a bit row: whole bits, 128-aligned
    spr2 = row2 // spb
    if spr2 % LANES:
        raise ValueError(f"{spr2} bits a row: this reference takes a multiple of 128")
    fb = row2  # FIR rows come in blocks of 128 bit rows
    r = -(-n_samples // LANES)  # one FIR row a 128 analytic samples
    r = -(-r // fb) * fb
    return {"sr": sr, "spb": spb, "mark": mark, "space": space, "row2": row2, "spr2": spr2, "ov2": LANES,
            "rows": r, "bit_rows": r * LANES // row2,
            "band": (max(min(mark, space) - baud, 10.0), min(max(mark, space) + baud, sr / 2 - 10.0))}


@functools.lru_cache(maxsize=8)
def fir_matrix(lo_hz: float, hi_hz: float, sr: int) -> np.ndarray:
    """(256, 256): column m < 128 holds Re(h) reversed from row m, column 128+m Im(h)."""
    c = (TAPS - 1) // 2
    k = np.arange(TAPS, dtype=np.float64) - c
    bw = hi_hz - lo_hz
    lp = (bw / sr) * np.sinc(bw / sr * k) * np.blackman(TAPS)
    lp *= 2.0 / lp.sum()
    h = (lp * np.exp(2j * np.pi * (lo_hz + hi_hz) / 2.0 / sr * k)).astype(np.complex64)
    W = np.zeros((LANES + TAPS - 1, 2 * LANES), np.float32)
    for m in range(LANES):
        W[m : m + TAPS, m] = h.real[::-1]
        W[m : m + TAPS, LANES + m] = h.imag[::-1]
    return W


@functools.lru_cache(maxsize=8)
def quadratures(spb: int, mark: float, space: float, sr: int, spr2: int, row2: int, ov2: int) -> np.ndarray:
    """(N_OFFSETS, row2+ov2, 4*spr2): [cos mark | sin mark | cos space | sin space] per bit."""
    t = np.arange(row2 + ov2, dtype=np.float64) / sr
    W = np.zeros((N_OFFSETS, row2 + ov2, 4 * spr2), np.float32)
    for i in range(N_OFFSETS):
        o = i * spb // N_OFFSETS
        for s in range(spr2):
            sl = slice(s * spb + o, s * spb + o + spb)
            for q, fn in enumerate((np.cos, np.sin)):
                W[i, sl, q * spr2 + s] = fn(2 * np.pi * mark * t[sl])
                W[i, sl, (2 + q) * spr2 + s] = fn(2 * np.pi * space * t[sl])
    return W


def _margins(M: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """Margins from (..., 4, spr2) products of the analytic re (M) and im (N) rows."""
    u_m, v_m = M[..., 0, :] + N[..., 1, :], N[..., 0, :] - M[..., 1, :]
    u_s, v_s = M[..., 2, :] + N[..., 3, :], N[..., 2, :] - M[..., 3, :]
    return u_m * u_m + v_m * v_m - u_s * u_s - v_s * v_s


def _bit_rows(v: torch.Tensor, g: dict) -> torch.Tensor:
    """Flat (b, rows*128) analytic stream -> (b, bit_rows, row2+ov2), zeros past the end."""
    b, row2, m2 = v.shape[0], g["row2"], g["bit_rows"]
    v = F.pad(v, (0, row2))
    return torch.cat([v[:, : m2 * row2].reshape(b, m2, row2),
                      v[:, row2 : (m2 + 1) * row2].reshape(b, m2, row2)[:, :, : g["ov2"]]], dim=2)


def _pass1_rows(g: dict) -> list:
    """The bit rows pass 1 scores: 4 from each of three FIR windows."""
    r, m2, per = g["rows"], g["bit_rows"], g["row2"] // LANES
    w2 = min(PASS1_ROWS, m2)
    last = max(0, (r - (w2 * per + 2)) // per)
    starts = sorted({0, min(max(0, m2 // 2 - w2 // 2), last), min(max(0, m2 - w2), last)})
    return [s + j for s in starts for j in range(w2)]


def _bits(x: torch.Tensor, g: dict, Wf: torch.Tensor, Wq: torch.Tensor, precision: str):
    """(bits (b, bit_rows*spr2) uint8, best (b,)) of (b, N) PCM captures."""
    b, n = x.shape
    r = g["rows"]
    xpad = F.pad(x, ((TAPS - 1) // 2, r * LANES + LANES - (TAPS - 1) // 2 - n))
    fir_rows = xpad.unfold(1, 2 * LANES, LANES)[:, :r]  # row i: padded samples [128i, 128i + 256)
    z = mm(fir_rows, Wf, precision)
    zr, zi = _bit_rows(z[..., :LANES].reshape(b, -1), g), _bit_rows(z[..., LANES:].reshape(b, -1), g)
    del z
    spr2 = g["spr2"]
    sel = torch.tensor(_pass1_rows(g), device=x.device)
    Wq_all = Wq.permute(1, 0, 2).reshape(Wq.shape[1], -1)
    M = mm(zr[:, sel], Wq_all, precision).reshape(b, -1, N_OFFSETS, 4, spr2)
    N = mm(zi[:, sel], Wq_all, precision).reshape(b, -1, N_OFFSETS, 4, spr2)
    best = torch.argmax(torch.abs(_margins(M, N)).sum(dim=(1, 3)), dim=1)
    wq = Wq[best]
    M = mm(zr, wq, precision).reshape(b, -1, 4, spr2)
    N = mm(zi, wq, precision).reshape(b, -1, 4, spr2)
    return (_margins(M, N) > 0).reshape(b, -1).to(torch.uint8), best


def _sync_pack(bits: torch.Tensor):
    b, n = bits.shape
    length = n - len(MAGIC_BITS) + 1
    match = torch.ones((b, length), dtype=torch.bool, device=bits.device)
    for t, c in enumerate(MAGIC_BITS):
        match &= bits[:, t : t + length] == int(c)
    found = match.any(dim=1)
    start = torch.where(found, torch.argmax(match.to(torch.uint8), dim=1), 0)
    n_out = -(-n // 1024) * 128
    idx = start[:, None] + torch.arange(8 * n_out, device=bits.device)
    shifted = torch.gather(F.pad(bits, (0, 8 * n_out)), 1, idx).reshape(b, n_out, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    return (shifted * weights).sum(dim=2).to(torch.uint8), (n - start) // 8, found, start


def receive(captures: np.ndarray, cfg: dict, device, precision: str = "float32", block: int = 4) -> dict:
    """(B, N) float captures -> packed, n_valid, found, best and start, as numpy arrays."""
    n_cap, n = captures.shape
    g = geometry(n, cfg)
    Wf = torch.from_numpy(fir_matrix(*g["band"], g["sr"])).to(device)
    Wq = torch.from_numpy(quadratures(g["spb"], g["mark"], g["space"], g["sr"], g["spr2"], g["row2"],
                                      g["ov2"])).to(device)
    out = {k: [] for k in ("packed", "n_valid", "found", "best", "start")}
    with torch.no_grad(), ieee_float32():
        for i0 in range(0, n_cap, block):
            x = pcm16(torch.from_numpy(captures[i0 : i0 + block]).to(device))
            bits, best = _bits(x, g, Wf, Wq, precision)
            del x
            packed, n_valid, found, start = _sync_pack(bits)
            for k, v in zip(out, (packed, n_valid, found, best, start)):
                out[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
