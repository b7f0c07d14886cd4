"""Plain reference receive of the ``fsk_disc`` family, close tone separation
(under 0.4 cycles a bit, as FSK9600: 1 kHz apart at 10 samples a bit), in
plain PyTorch: a frequency discriminator with a calibrated equalizer.

It works out from the benchmark's float captures everything the program
derives, written here from the receive's description:

1. 16-bit PCM samples.
2. The analytic band-pass signal: a 129-tap Blackman-windowed sinc over
   [max(lo - baud, 10), min(hi + baud, sr/2 - 10)] Hz, shifted to the
   band's center, gain 2 there.
3. Decimation by ``dec``, the largest power of two up to 8 that keeps the
   band under the decimated sample rate and at least 2 decimated samples a
   bit: z[m] = sum_k h[k] x[dec*m + 64 - k], samples outside the capture 0.
   Computed as rows of 128*dec + 128 samples (128 outputs each) against
   the filter's dense matrix.
4. The phasor p[n] = z[n+1] conj z[n] on the decimated grid.
5. For each of 8 timing offsets o = i*spb//8, bit k's sums (sr, si) weigh
   p[n] by the share of full-rate samples [dec*n, dec*n + dec) that lie in
   the bit's window [k*spb + o, k*spb + o + spb): 2 to 4 taps a bit.
6. Pass 1: the offset with the largest sum, over the bits of three windows
   of 4 bit rows, of |s| * min(|f - mid|, dev), with s = sr + i si, f its
   angle in Hz, mid the tones' mean and dev half their distance.
7. The angle of each bit's sum, in Hz: atan2(si, sr) * sr / dec / 2 pi.
8. A 9-tap equalizer plus a bias over the bits' frequencies (the stream's
   first and last frequency repeated past its ends), fitted by least
   squares to the tones of a known training sequence sent through steps 2
   to 7: seed 0xFB9C, 3200 bytes after the 0xAA x 4 preamble, offset 0.
9. The nearer tone: 1 where the equalized frequency is nearer the mark.
10. Sync and pack, as ``reference.fsk``: the first position of the 16-bit
    magic "FB", exact, 0 where absent; the bits from there, MSB first.

Departures, each the program's layout taken as the definition:

- The bit stream is as long as the program's: the decimated stream is
  rounded up to whole blocks of 128 bit rows, each bit row 640 decimated
  samples (a whole number of bits, a multiple of 128); z and p past it are
  0, so the bits past the capture are decided from zeros and the
  equalizer's repeated edge, and belong to the packed bytes.
- Pass 1's windows are the program's: bit rows s .. s+3 for s in
  {0, the middle, the last window whose FIR rows (plus the two the phasor
  reads ahead) fit the capture}.
- The training fit runs in float64 on the unquantized training wave, over a
  stream of ceil(n/dec) decimated samples (the last bit's window loses the
  tap past it), and its taps and bias are rounded to float32: the captures
  run in float32 with TF32 off.

``precision`` "tf32" or "cublas_tf32" is the control, as in ``reference.psk``:
the FIR's and the boxcars' products in TF32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..channel import ieee_float32, mm, pcm16
from .fsk import _bit_rows, _pass1_rows, _sync_pack

N_OFFSETS = 8
TAPS = 129
LANES = 128
EQ_TAPS = 9
PREAMBLE = b"\xAA\xAA\xAA\xAA"
TRAIN_SEED, TRAIN_BYTES = 0xFB9C, 3200
BIT_ROW_BLOCK = 128  # bit rows come in blocks of 128


def decimation(spb: int, band_hi: float, sr: int) -> int:
    d = 1
    while 2 * d <= 8 and band_hi < sr / (2 * d) and 2 * (2 * d) <= spb:
        d *= 2
    return d


def geometry(n_samples: int, cfg: dict) -> dict:
    sr, baud = int(cfg["sample_rate"]), float(cfg["symbol_rate"])
    mark, space = float(cfg["mark_hz"]), float(cfg["space_hz"])
    spb = int(round(sr / baud))
    sep = abs(mark - space) * spb / sr
    if sep >= 0.4:
        raise ValueError(f"tone separation {sep:.3f} cycles a bit: this reference covers under 0.4")
    band = (max(min(mark, space) - baud, 10.0), min(max(mark, space) + baud, sr / 2 - 10.0))
    dec = decimation(spb, band[1], sr)
    base = spb // math.gcd(spb, dec)
    row2 = base * LANES // math.gcd(base, LANES)  # decimated samples a bit row: whole bits, 128-aligned
    spr2 = row2 * dec // spb
    block = BIT_ROW_BLOCK * row2  # decimated samples a block of bit rows
    m = -(-(-(-n_samples // dec)) // block) * block
    return {"sr": sr, "spb": spb, "dec": dec, "mark": mark, "space": space, "band": band, "row2": row2,
            "spr2": spr2, "ov2": LANES, "rows": m // LANES, "bit_rows": m // row2}


@functools.lru_cache(maxsize=8)
def fir_taps(lo_hz: float, hi_hz: float, sr: int) -> np.ndarray:
    """(129,) complex64 taps h[k], k = 0 .. 128, center tap 64."""
    c = (TAPS - 1) // 2
    k = np.arange(TAPS, dtype=np.float64) - c
    bw = hi_hz - lo_hz
    lp = (bw / sr) * np.sinc(bw / sr * k) * np.blackman(TAPS)
    lp *= 2.0 / lp.sum()
    return (lp * np.exp(2j * np.pi * (lo_hz + hi_hz) / 2.0 / sr * k)).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def fir_matrix(lo_hz: float, hi_hz: float, sr: int, dec: int) -> np.ndarray:
    """(128*dec + 128, 256): column m < 128 holds Re(h) reversed from row
    dec*m, column 128+m Im(h)."""
    h = fir_taps(lo_hz, hi_hz, sr)
    W = np.zeros((LANES * dec + LANES, 2 * LANES), np.float32)
    for m in range(LANES):
        W[dec * m : dec * m + TAPS, m] = h.real[::-1]
        W[dec * m : dec * m + TAPS, LANES + m] = h.imag[::-1]
    return W


def boxcar_taps(spb: int, dec: int, o: int, n0: int, n1: int):
    """(bit k, decimated sample n, weight) for bits n0 .. n1-1 at offset
    ``o``: the weight is the share of [dec*n, dec*n + dec) that lies in the
    bit's window [k*spb + o, k*spb + o + spb)."""
    for k in range(n0, n1):
        lo, hi = k * spb + o, k * spb + o + spb
        for n in range(lo // dec, -(-hi // dec)):
            w = (min(hi, (n + 1) * dec) - max(lo, n * dec)) / dec
            if w > 0:
                yield k, n, w


@functools.lru_cache(maxsize=8)
def boxcars(spb: int, dec: int, row2: int, ov2: int, spr2: int) -> np.ndarray:
    """(N_OFFSETS, row2+ov2, spr2): bit s of a bit row, at offset i, weighs
    the row's decimated sample n (time counted from the row's start)."""
    W = np.zeros((N_OFFSETS, row2 + ov2, spr2), np.float32)
    for i in range(N_OFFSETS):
        for s, n, w in boxcar_taps(spb, dec, i * spb // N_OFFSETS, 0, spr2):
            W[i, n, s] = w
    return W


def _phasor(zr: torch.Tensor, zi: torch.Tensor):
    """p[n] = z[n+1] conj z[n] along the last axis, z past the end 0."""
    z1r, z1i = F.pad(zr[..., 1:], (0, 1)), F.pad(zi[..., 1:], (0, 1))
    return z1r * zr + z1i * zi, z1i * zr - z1r * zi


def _hz(sr_sum: torch.Tensor, si_sum: torch.Tensor, g: dict) -> torch.Tensor:
    return torch.atan2(si_sum, sr_sum) * (g["sr"] / g["dec"] / (2 * math.pi))


@functools.lru_cache(maxsize=8)
def equalizer(spb: int, sr: int, mark: float, space: float, lo_hz: float, hi_hz: float, dec: int) -> np.ndarray:
    """(EQ_TAPS + 1,) float32: the taps, then the bias, fitted on the training sequence."""
    rng = np.random.default_rng(TRAIN_SEED)
    data = PREAMBLE + rng.integers(0, 256, TRAIN_BYTES, dtype=np.uint8).tobytes()
    bits = np.unpackbits(np.frombuffer(data, np.uint8)).astype(np.int64)
    tone = np.where(bits == 1, mark, space)
    inc = np.where(bits == 1, int(round(mark * spb)) % sr, int(round(space * spb)) % sr)
    phase0 = (np.cumsum(inc) - inc) % sr
    t = np.arange(spb, dtype=np.float64)
    wave = (0.9 * np.sin(2 * np.pi * (tone[:, None] * t[None, :] + phase0[:, None]) / sr)).reshape(-1)
    n, n_bits = len(wave), len(bits)
    # Steps 2-4 in float64: z[m] = sum_k h[k] x[dec*m + 64 - k] for m < ceil(n/dec).
    h = fir_taps(lo_hz, hi_hz, sr).astype(np.complex128)
    m = -(-n // dec)
    xpad = np.zeros(dec * m + 2 * TAPS)
    xpad[TAPS - 1 : TAPS - 1 + n] = wave  # xpad[j] = x[j - 128]
    idx = dec * np.arange(m)[:, None] + (TAPS - 1) // 2 + (TAPS - 1) - np.arange(TAPS)[None, :]
    z = (xpad[idx] * h[None, :]).sum(axis=1)
    p = np.concatenate([z[1:], [0]]) * np.conj(z)
    sums = np.zeros(n_bits, np.complex128)
    for k, j, w in boxcar_taps(spb, dec, 0, 0, n_bits):
        if j < m:
            sums[k] += w * p[j]
    f = np.angle(sums) * sr / dec / (2 * np.pi)
    fm = np.pad(f, EQ_TAPS // 2, mode="edge")
    A = np.stack([fm[j : j + n_bits] for j in range(EQ_TAPS)] + [np.ones(n_bits)], axis=1)
    coef, *_ = np.linalg.lstsq(A, tone.astype(np.float64), rcond=None)
    return coef.astype(np.float32)


def _decide(f: torch.Tensor, coef: np.ndarray, mark: float, space: float) -> torch.Tensor:
    pad = EQ_TAPS // 2
    n = f.shape[1]
    fm = torch.cat([f[:, :1].expand(-1, pad), f, f[:, -1:].expand(-1, pad)], dim=1)
    eq = torch.full_like(f, float(coef[-1]))
    for j in range(EQ_TAPS):
        eq = eq + float(coef[j]) * fm[:, j : j + n]
    return (torch.abs(eq - mark) < torch.abs(eq - space)).to(torch.uint8)


def _bits(x: torch.Tensor, g: dict, Wf: torch.Tensor, Wb: torch.Tensor, coef: np.ndarray, precision: str):
    """(bits (b, bit_rows*spr2) uint8, best (b,)) of (b, N) PCM captures."""
    b, n = x.shape
    dec, r = g["dec"], g["rows"]
    c = (TAPS - 1) // 2
    xpad = F.pad(x, (c, r * LANES * dec + LANES - c - n))
    fir_rows = xpad.unfold(1, LANES * dec + LANES, LANES * dec)[:, :r]  # row i: [128*dec*i, +128*dec+128)
    z = mm(fir_rows, Wf, precision)
    pr, pi = _phasor(z[..., :LANES].reshape(b, -1), z[..., LANES:].reshape(b, -1))
    del z, fir_rows
    pr, pi = _bit_rows(pr, g), _bit_rows(pi, g)
    spr2 = g["spr2"]
    sel = torch.tensor(_pass1_rows(g), device=x.device)
    Wb_all = Wb.permute(1, 0, 2).reshape(Wb.shape[1], -1)
    wr, wi = mm(pr[:, sel], Wb_all, precision), mm(pi[:, sel], Wb_all, precision)
    f_win = _hz(wr, wi, g)
    mid, dev = (g["mark"] + g["space"]) / 2.0, abs(g["space"] - g["mark"]) / 2.0
    score = torch.sqrt(wr * wr + wi * wi) * torch.clamp(torch.abs(f_win - mid), max=dev)
    best = torch.argmax(score.reshape(b, -1, N_OFFSETS, spr2).sum(dim=(1, 3)), dim=1)
    wb = Wb[best]
    f = _hz(mm(pr, wb, precision).reshape(b, -1), mm(pi, wb, precision).reshape(b, -1), g)
    return _decide(f, coef, g["mark"], g["space"]), best


def receive(captures: np.ndarray, cfg: dict, device, precision: str = "float32", block: int = 4) -> dict:
    """(B, N) float captures -> packed, n_valid, found, best and start, as numpy arrays."""
    n_cap, n = captures.shape
    g = geometry(n, cfg)
    lo, hi = g["band"]
    Wf = torch.from_numpy(fir_matrix(lo, hi, g["sr"], g["dec"])).to(device)
    Wb = torch.from_numpy(boxcars(g["spb"], g["dec"], g["row2"], g["ov2"], g["spr2"])).to(device)
    coef = equalizer(g["spb"], g["sr"], g["mark"], g["space"], lo, hi, g["dec"])
    out = {k: [] for k in ("packed", "n_valid", "found", "best", "start")}
    with torch.no_grad(), ieee_float32():
        for i0 in range(0, n_cap, block):
            x = pcm16(torch.from_numpy(captures[i0 : i0 + block]).to(device))
            bits, best = _bits(x, g, Wf, Wb, coef, precision)
            del x
            packed, n_valid, found, start = _sync_pack(bits)
            for k, v in zip(out, (packed, n_valid, found, best, start)):
                out[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}
