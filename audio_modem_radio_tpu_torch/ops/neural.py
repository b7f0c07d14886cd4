"""NEURAL mode of the PyTorch port: learned-codebook modulation and receive.

Counterpart of ``audio_modem_radio_tpu/ops/neural.py``. The committed
codebook (the port's own copy, ``data/neural_codebook.npz``) maps each byte
to a 16-dimensional unit-power codeword of 8 complex baseband chips, which
ride a 24 kHz (fs/4) carrier. Wire format: [32-symbol preamble | framed
bytes, 1 byte = 1 symbol]. Detection is maximum-likelihood
nearest-codeword: all codewords have equal norm, so the correlation argmax
is the Euclidean argmin.

Transmit (``neural_mode_modulate``) is host numpy, as in the JAX package.
Receive, on the samples' device:

* batched (:func:`demod_td_batch`, chip lengths 2 and 4): fs/4
  downconversion by sign masks, the preamble matched filter as one blocked
  matmul over the first 1/8 of the lags, escalated to every lag for the
  whole batch when any capture's normalized peak falls below
  ``TD_PREFIX_RHO`` (one read to the host); then at chip length 2 (NEURAL at
  9600 Bd) K10 (``ops.kernels.neural_extract_batch``) on the unrotated
  symbol grid and a roll per capture, at chip length 4 the plain-torch
  extraction :func:`_td_extract`, one capture at a time;
* single capture (:func:`neural_mode_demodulate`): the same sync over every
  lag and :func:`_td_extract` (no kernel, as in the JAX package), or, for
  chip lengths the time-domain tables do not cover (NEURAL at 1200 Bd), the
  FFT matched filter :func:`_demod`.

The matched filter searches lags in chunks of captures (``_SYNC_LAGS``
lags at a time), so the full search over a 64 x 2^24 batch stays within a
few GB of device memory.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import agree_all
from ..utils.torchenv import DeviceLike, resolve_device
from .kernels import neural_extract_batch

SAMPLE_RATE = 96000
CARRIER = 24000.0  # fs/4: the double-frequency image alternates sign per
# sample, so box integration over an even-length chip cancels it exactly.
CHIPS_PER_SYMBOL = 8
PREAMBLE_LEN = 32

_CODEBOOK_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "neural_codebook.npz"
)


@functools.lru_cache(maxsize=1)
def _codebook() -> np.ndarray:
    """(256, 16) float32 learned codebook: [I(0..7) | Q(0..7)] per symbol."""
    if os.path.exists(_CODEBOOK_PATH):
        with np.load(_CODEBOOK_PATH) as z:
            cb = np.asarray(z["codebook"], np.float32)
    else:
        # Zip-safe load (zipapp / wheel-in-zip): read via importlib.resources.
        import io
        from importlib import resources

        blob = (
            resources.files("audio_modem_radio_tpu_torch")
            .joinpath("data/neural_codebook.npz")
            .read_bytes()
        )
        with np.load(io.BytesIO(blob)) as z:
            cb = np.asarray(z["codebook"], np.float32)
    if cb.shape != (256, 2 * CHIPS_PER_SYMBOL):
        raise ValueError(f"NEURAL codebook of shape {cb.shape}, want (256, {2 * CHIPS_PER_SYMBOL})")
    return np.ascontiguousarray(cb)  # the file stores it column-major


@functools.lru_cache(maxsize=1)
def _preamble_symbols() -> np.ndarray:
    """Fixed pseudo-random preamble symbols (part of the wire format)."""
    return np.random.default_rng(0xFBFC).integers(0, 256, PREAMBLE_LEN, dtype=np.uint8)


def _chip_len(symbol_rate: int) -> int:
    """Samples per chip; even so the fs/2 image cancels under box integration."""
    raw = max(2, round(SAMPLE_RATE / (symbol_rate * CHIPS_PER_SYMBOL)))
    return raw + (raw % 2)


def _check_rate(samp_rate: int) -> None:
    if samp_rate != SAMPLE_RATE:
        raise ValueError(f"NEURAL mode is defined at {SAMPLE_RATE} Hz, not {samp_rate}")


def _bucket(n: int) -> int:
    b = 256
    while b < n:
        b <<= 1
    return b


# --- transmit (host numpy) -----------------------------------------------------

def _synth(symbols, codebook, chip_len: int) -> np.ndarray:
    """(n_sym,) byte symbols -> real waveform (n_sym * 8 * chip_len,)."""
    cw = np.asarray(codebook)[np.asarray(symbols)]  # (n, 16)
    i_chips = cw[:, :CHIPS_PER_SYMBOL].reshape(-1)
    q_chips = cw[:, CHIPS_PER_SYMBOL:].reshape(-1)
    i_t = np.repeat(i_chips, chip_len)
    q_t = np.repeat(q_chips, chip_len)
    n = np.arange(i_t.shape[0], dtype=np.float64)
    w = 2 * np.pi * (CARRIER / SAMPLE_RATE) * n
    return (i_t * np.cos(w) - q_t * np.sin(w)).astype(np.float32)


def neural_mode_modulate(
    framed: bytes, symbol_rate: int = 1200, samp_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """framed bytes -> NEURAL waveform (float32, peak 0.9)."""
    _check_rate(samp_rate)
    chip_len = _chip_len(symbol_rate)
    symbols = np.concatenate(
        [_preamble_symbols(), np.frombuffer(framed, np.uint8)]
    ).astype(np.int32)
    n_sym = len(symbols)
    padded = np.pad(symbols, (0, _bucket(n_sym) - n_sym))
    wave = _synth(padded, _codebook(), chip_len)
    wave = wave[: n_sym * CHIPS_PER_SYMBOL * chip_len]
    peak = float(np.max(np.abs(wave))) or 1.0
    return (wave * (0.9 / peak)).astype(np.float32)


# --- tables (host numpy, cached; on a device once per device) ---------------------

@functools.lru_cache(maxsize=8)
def _preamble_baseband(chip_len: int) -> np.ndarray:
    """Complex baseband template of the preamble (chips zero-order-held)."""
    cw = _codebook()[_preamble_symbols()]
    chips = (cw[:, :CHIPS_PER_SYMBOL] + 1j * cw[:, CHIPS_PER_SYMBOL:]).reshape(-1)
    return np.repeat(chips, chip_len).astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _preamble_spectra(chip_len: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """rfft spectra of the preamble baseband's (re, im) parts."""
    pre = _preamble_baseband(chip_len)
    return (
        np.fft.rfft(pre.real, n_fft).astype(np.complex64),
        np.fft.rfft(pre.imag, n_fft).astype(np.complex64),
    )


@functools.lru_cache(maxsize=8)
def _corr_table(chip_len: int) -> np.ndarray:
    """(128+P, 256) time-domain correlation weights, P = preamble samples:
    column l < 128 holds the preamble's real part at lag l, column 128+l
    its imaginary part, so one ``(rows, 128+P) @ (128+P, 256)`` matmul gives
    128 correlation lags per row for both components."""
    pre = _preamble_baseband(chip_len)
    P = len(pre)
    T = np.zeros((128 + P, 256), np.float32)
    for l in range(128):
        T[l : l + P, l] = pre.real
        T[l : l + P, 128 + l] = pre.imag
    return T


@functools.lru_cache(maxsize=8)
def _codebook_blocked(chip_len: int) -> np.ndarray:
    """(256//chip_len, (16//chip_len)*256) block-diagonal codebook scorer: a
    chip row [re chips | im chips] of 128 samples times it scores symbol
    slot m against codeword w in column ``m*256 + w``."""
    cb = _codebook()
    cpr = 128 // chip_len  # chips per row per component
    spr = cpr // CHIPS_PER_SYMBOL  # symbols per row
    W = np.zeros((2 * cpr, spr * 256), np.float32)
    for m in range(spr):
        for c in range(CHIPS_PER_SYMBOL):
            W[m * CHIPS_PER_SYMBOL + c, m * 256 : (m + 1) * 256] = cb[:, c]
            W[cpr + m * CHIPS_PER_SYMBOL + c, m * 256 : (m + 1) * 256] = cb[:, CHIPS_PER_SYMBOL + c]
    return W


@functools.lru_cache(maxsize=4)
def _chip_shift_table(chip_len: int) -> np.ndarray:
    """(128, 512, 256//chip_len) per-offset chip-averaging projections:
    entry s maps a 256-sample row pair [zr | zi] (512 lanes) to [re chips |
    im chips] at sample offset s, chip c the box average of lanes
    ``[s + c*chip_len, s + (c+1)*chip_len)``. 33.5 MB at chip length 2."""
    cpr = 128 // chip_len
    s = np.arange(128)[:, None, None]
    j = np.arange(256)[None, :, None]
    c = np.arange(cpr)[None, None, :]
    T = ((j >= s + c * chip_len) & (j < s + (c + 1) * chip_len)).astype(np.float32) * np.float32(1.0 / chip_len)
    out = np.zeros((128, 512, 2 * cpr), np.float32)
    out[:, :256, :cpr] = T
    out[:, 256:, cpr:] = T
    return out


def _td_supported(chip_len: int) -> bool:
    """Gate for the time-domain path (table sizes stay sane)."""
    return 128 % (CHIPS_PER_SYMBOL * chip_len) == 0 and chip_len <= 4


@functools.lru_cache(maxsize=8)
def _energy_table(P: int) -> np.ndarray:
    """(128+P, 128) banded ones: sliding window energy at every in-row lag
    as one matmul on the correlation row layout."""
    T = np.zeros((128 + P, 128), np.float32)
    for l in range(128):
        T[l : l + P, l] = 1.0
    return T


@functools.lru_cache(maxsize=8)
def _preamble_energy(chip_len: int) -> float:
    pre = _preamble_baseband(chip_len)
    return float(np.sum(np.abs(pre) ** 2))


# Prefix-sync accept threshold on the normalized correlation peak
# rho = |corr|^2 / (E_pre * E_window). Cauchy-Schwarz bounds rho <= 1; a
# clean capture measures about 0.5 (the conjugate-image term of real-passband
# downconversion without low-pass halves the matched energy) and pure noise
# about 1/P. 0.12 escalates below roughly -5 dB SNR.
TD_PREFIX_RHO = 0.12

# Lags of the matched filter per chunk of captures: its working set is
# about 100 bytes a lag, so a chunk stays near 6.7 GB on the card.
_SYNC_LAGS = 1 << 26


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@functools.lru_cache(maxsize=2)
def _device_spectra(chip_len: int, n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_preamble_spectra` on ``device``, uploaded once per batch
    shape rather than once per capture."""
    return tuple(torch.from_numpy(a).to(device) for a in _preamble_spectra(chip_len, n_fft))


@functools.lru_cache(maxsize=16)
def _device_tables(chip_len: int, device: torch.device) -> dict:
    """The sync and scoring tables of ``chip_len`` on ``device``: ``cb``
    (256, 16), ``cb_b`` (the blocked scorer), ``corr`` (the correlation
    table) and ``energy`` (the window-energy table)."""
    corr = _corr_table(chip_len)
    return {
        "cb": _tensor(_codebook(), device),
        "cb_b": _tensor(_codebook_blocked(chip_len), device),
        "corr": _tensor(corr, device),
        "energy": _tensor(_energy_table(corr.shape[0] - 128), device),
    }


@functools.lru_cache(maxsize=4)
def _device_chip_table(chip_len: int, device: torch.device) -> torch.Tensor:
    """:func:`_chip_shift_table` on ``device``, built once per (chip length,
    device); only :func:`_td_extract` reads it."""
    return _tensor(_chip_shift_table(chip_len), device)


# --- sync ------------------------------------------------------------------------

def _td_prep(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n) samples (integers cast unscaled) -> fs/4 downconversion by
    sign masks (zr, zi), float32, zero-padded to the 128-sample row."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % 128
    if pad:
        x = F.pad(x, (0, pad))
    reps = x.shape[-1] // 4
    mr = torch.tensor([1.0, 0.0, -1.0, 0.0], device=x.device).repeat(reps)
    mi = torch.tensor([0.0, -1.0, 0.0, 1.0], device=x.device).repeat(reps)
    return x * mr, x * mi


def _td_corr_rows(z: torch.Tensor, rows: int, nb: int) -> torch.Tensor:
    """(..., n) -> (..., rows, 128*(nb+1)) overlapped correlation rows for
    lags [0, rows*128): lag l needs samples l .. l+P, zeros past the end."""
    need = (rows + nb + 1) * 128
    if need > z.shape[-1]:
        z = F.pad(z, (0, need - z.shape[-1]))
    z2 = z[..., :need].reshape(*z.shape[:-1], rows + nb + 1, 128)
    return torch.cat([z2[..., t : rows + t, :] for t in range(nb + 1)], dim=-1)


def _td_corr(
    zr: torch.Tensor, zi: torch.Tensor, corr_table: torch.Tensor, rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preamble matched filter over lags [0, rows*128): one blocked matmul
    (``torch.matmul``, full float32). Returns (corr_re, corr_im), each
    (..., rows*128)."""
    nb = (corr_table.shape[0] - 128) // 128
    rr = torch.cat([_td_corr_rows(zr, rows, nb), _td_corr_rows(zi, rows, nb)], dim=-2)
    UV = rr @ corr_table  # (..., 2*rows, 256)
    U, V = UV[..., :rows, :], UV[..., rows:, :]
    lead = zr.shape[:-1]
    corr_re = (U[..., :128] + V[..., 128:]).reshape(*lead, -1)
    corr_im = (V[..., :128] - U[..., 128:]).reshape(*lead, -1)
    return corr_re, corr_im


def _td_peak(corr_re: torch.Tensor, corr_im: torch.Tensor):
    """First argmax lag k0 along the last axis, the unit channel phasor
    there and the peak |corr|^2."""
    mag2 = corr_re * corr_re + corr_im * corr_im
    k0 = torch.argmax(mag2, dim=-1, keepdim=True)
    pk = mag2.gather(-1, k0)
    norm = torch.sqrt(pk) + 1e-12
    return (k0[..., 0], (corr_re.gather(-1, k0) / norm)[..., 0],
            (corr_im.gather(-1, k0) / norm)[..., 0], pk[..., 0])


def _peaks(x: torch.Tensor, chip_len: int, rows: int, with_rho: bool):
    """Per capture of (B, n) samples, the matched filter over lags
    [0, rows*128): ``(k0, ph_re, ph_im, rho)``, rho the normalized peak
    (None unless ``with_rho``). Runs in chunks of ``_SYNC_LAGS`` lags."""
    tabs = _device_tables(chip_len, x.device)
    corr_t, e_tab = tabs["corr"], tabs["energy"]
    nb = (corr_t.shape[0] - 128) // 128
    e_pre = _preamble_energy(chip_len)
    step = max(1, _SYNC_LAGS // (rows * 128))
    outs = []
    for i in range(0, x.shape[0], step):
        zr, zi = _td_prep(x[i : i + step])
        k0, pr, pi, pk = _td_peak(*_td_corr(zr, zi, corr_t, rows))
        rho = None
        if with_rho:
            e2 = _td_corr_rows(zr * zr + zi * zi, rows, nb) @ e_tab  # (b, rows, 128)
            ew = e2.reshape(e2.shape[0], -1).gather(1, k0[:, None])[:, 0]
            rho = pk / (e_pre * ew + 1e-12)
        outs.append((k0, pr, pi, rho))
    k0, pr, pi, rho = zip(*outs)
    return torch.cat(k0), torch.cat(pr), torch.cat(pi), (torch.cat(rho) if with_rho else None)


def td_sync_batch(samples: torch.Tensor, chip_len: int):
    """Batched preamble sync of (B, N) samples (float32, or integers cast
    unscaled): ``(k0 (B,) int64, ph_re (B,), ph_im (B,))``.

    The preamble opens every transmission, so the matched filter first
    searches only the lags of the first 1/8 of the rows and accepts when
    every capture's normalized peak clears ``TD_PREFIX_RHO``; one read of
    that test to the host replaces the JAX package's ``lax.cond``. Otherwise
    the whole batch escalates to the full-lag search, as the cond outside
    the JAX package's capture vmap does. Captures too short for a prefix
    take the full search directly. Under a data-parallel mesh the test is
    one for every shard's captures (``parallel.mesh.agree_all``)."""
    r3 = -(-samples.shape[1] // 128)
    r_pre = max(1, r3 // 8)
    nb = PREAMBLE_LEN * CHIPS_PER_SYMBOL * chip_len // 128
    if 2 * r_pre <= r3:
        span = min(r3 * 128, (r_pre + nb + 1) * 128)  # the samples the prefix lags read
        k0, pr, pi, rho = _peaks(samples[:, :span], chip_len, r_pre, True)
        if agree_all(bool(torch.all(rho >= TD_PREFIX_RHO))):  # the global batch under a mesh
            return k0, pr, pi
    k0, pr, pi, _ = _peaks(samples, chip_len, r3, False)
    return k0, pr, pi


# --- extraction --------------------------------------------------------------------

def _td_extract(
    zr: torch.Tensor,
    zi: torch.Tensor,
    k0: torch.Tensor,
    ph_re: torch.Tensor,
    ph_im: torch.Tensor,
    codebook_blocked: torch.Tensor,
    chip_table: torch.Tensor,
) -> torch.Tensor:
    """One capture's symbols: chips at k0 from the circular row pairs
    (row (k0//128 + j) mod r3 and its successor) times the offset table
    ``chip_table[k0 % 128]``, unrotation by the phasor, block-diagonal
    codebook scores, first-max argmax. Returns (r3 * spr,) uint8."""
    r3 = zr.shape[0] // 128
    q, s = k0 // 128, k0 % 128
    tiles = torch.cat([zr.reshape(r3, 128), zi.reshape(r3, 128)], dim=1)
    t = tiles.index_select(0, (q + torch.arange(r3 + 1, device=zr.device)) % r3)
    rows = torch.cat([t[:-1, :128], t[1:, :128], t[:-1, 128:], t[1:, 128:]], dim=1)
    chips = rows @ chip_table.index_select(0, s.reshape(1))[0]  # (r3, 2*cpr): [re | im]
    cpr = chips.shape[1] // 2
    cr, ci = chips[:, :cpr], chips[:, cpr:]
    # z * conj(phase), applied on chip tiles (commutes with the box mean).
    cr, ci = cr * ph_re + ci * ph_im, ci * ph_re - cr * ph_im
    scores = torch.cat([cr, ci], dim=1) @ codebook_blocked
    spr = scores.shape[1] // 256
    return torch.argmax(scores.reshape(r3 * spr, 256), dim=-1).to(torch.uint8)


def demod_td_batch(samples: torch.Tensor, chip_len: int) -> torch.Tensor:
    """(B, N) samples -> (B, ceil(N/128) * spr) uint8 symbols, symbol 0 at
    each capture's preamble (the stream wraps circularly past the end).

    Sync by :func:`td_sync_batch`. At chip length 2 the symbols come from
    K10 (``neural_extract_batch``; its plain version for CPU tensors) on the
    unrotated grid, every row's successor the capture's next row circularly,
    and roll left by ``(k0 // 128) * spr``: the JAX package's XLA extraction
    symbol for symbol. The JAX gate ``r3 % 512 == 0`` is a TPU tiling rule
    and does not apply. At chip length 4 :func:`_td_extract` runs one
    capture at a time (its scores take 537 MB a capture at 2^24 samples)."""
    b, n = samples.shape
    dev = samples.device
    r3 = -(-n // 128)
    spr = 128 // chip_len // CHIPS_PER_SYMBOL
    k0, pr, pi = td_sync_batch(samples, chip_len)
    tabs = _device_tables(chip_len, dev)
    if chip_len == 2:
        xp = F.pad(samples, (0, r3 * 128 - n)) if r3 * 128 != n else samples
        syms = neural_extract_batch(
            xp.contiguous().reshape(b * r3, 128), tabs["cb"], torch.stack([pr, pi], dim=1).contiguous(),
            (k0 % 128).to(torch.int32), rows_per_capture=r3,
        )
        n_sym = r3 * spr
        idx = (torch.arange(n_sym, device=dev)[None, :] + ((k0 // 128) * spr)[:, None]) % n_sym
        return torch.gather(syms, 1, idx)
    chip_tab = _device_chip_table(chip_len, dev)
    out = []
    for i in range(b):
        zr, zi = _td_prep(samples[i])
        out.append(_td_extract(zr, zi, k0[i], pr[i], pi[i], tabs["cb_b"], chip_tab))
    return torch.stack(out)


# --- single capture ----------------------------------------------------------------

def _demod_td(x: torch.Tensor, chip_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One padded capture -> (symbols, k0): the matched filter over every
    lag, then :func:`_td_extract` (the JAX package's ``_demod_td`` through
    its ``_demod_td_jit`` entry)."""
    tabs = _device_tables(chip_len, x.device)
    zr, zi = _td_prep(x)
    r3 = zr.shape[0] // 128
    k0, ph_re, ph_im, _pk = _td_peak(*_td_corr(zr, zi, tabs["corr"], r3))
    sym = _td_extract(zr, zi, k0, ph_re, ph_im, tabs["cb_b"], _device_chip_table(chip_len, x.device))
    return sym, k0


def _demod(x: torch.Tensor, chip_len: int, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One padded capture -> (symbols per position, k0) by the FFT matched
    filter, all-real streams: Re C = xc(zr, pr) + xc(zi, pi), Im C =
    xc(zi, pr) - xc(zr, pi) with xc(a, b) = irfft(rfft(a) * conj(rfft b)),
    alignment by a circular roll to k0, the explicit 2x2 unrotation, chip
    box means, one codebook matmul and the first-max argmax."""
    dev = x.device
    pre_fr, pre_fi = _device_spectra(chip_len, n_fft, dev)
    n = x.shape[0]
    reps = -(-n // 4)
    zr = x * torch.tensor([1.0, 0.0, -1.0, 0.0], device=dev).repeat(reps)[:n]
    zi = x * torch.tensor([0.0, -1.0, 0.0, 1.0], device=dev).repeat(reps)[:n]
    fr = torch.fft.rfft(zr, n_fft)
    fi = torch.fft.rfft(zi, n_fft)
    corr_re = torch.fft.irfft(fr * torch.conj(pre_fr) + fi * torch.conj(pre_fi), n_fft)[:n]
    corr_im = torch.fft.irfft(fi * torch.conj(pre_fr) - fr * torch.conj(pre_fi), n_fft)[:n]
    k0, ph_re, ph_im, _pk = _td_peak(corr_re, corr_im)
    idx = (torch.arange(n, device=dev) + k0) % n
    zr, zi = zr[idx], zi[idx]
    zr, zi = zr * ph_re + zi * ph_im, zi * ph_re - zr * ph_im
    spsym = CHIPS_PER_SYMBOL * chip_len
    max_sym = n // spsym
    chips_r = zr[: max_sym * spsym].reshape(max_sym, CHIPS_PER_SYMBOL, chip_len).mean(-1)
    chips_i = zi[: max_sym * spsym].reshape(max_sym, CHIPS_PER_SYMBOL, chip_len).mean(-1)
    rx = torch.cat([chips_r, chips_i], dim=-1)  # (max_sym, 16)
    scores = rx @ _device_tables(chip_len, dev)["cb"].T
    return torch.argmax(scores, dim=-1).to(torch.uint8), k0


def _fft_len(n: int, chip_len: int) -> int:
    """The FFT matched filter's transform length for ``n`` samples."""
    return 1 << int(np.ceil(np.log2(n + PREAMBLE_LEN * CHIPS_PER_SYMBOL * chip_len)))


def neural_mode_demodulate(
    samples: np.ndarray, symbol_rate: int = 1200, samp_rate: int = SAMPLE_RATE,
    device: DeviceLike = None,
) -> bytes:
    """NEURAL waveform -> byte stream (preamble stripped; the parser finds
    FBPC), on ``device`` (default: the card). The capture is zero-padded to
    a power of two (at least 256 samples); the time-domain path where
    :func:`_td_supported`, else the FFT matched filter."""
    _check_rate(samp_rate)
    dev = resolve_device(device)
    chip_len = _chip_len(symbol_rate)
    spsym = CHIPS_PER_SYMBOL * chip_len
    x = np.asarray(samples, np.float32)
    if len(x) < (PREAMBLE_LEN + 1) * spsym:
        return b""
    n_pad = _bucket(len(x))
    xt = torch.from_numpy(np.pad(x, (0, n_pad - len(x)))).to(dev)
    if _td_supported(chip_len):
        symbols, _k0 = _demod_td(xt, chip_len)
    else:
        symbols, _k0 = _demod(xt, chip_len, _fft_len(n_pad, chip_len))
    return bytes(symbols[PREAMBLE_LEN:].cpu().numpy())
