"""Batched demodulation of many captures on one device — the throughput layer.

Counterpart of ``audio_modem_radio_tpu/parallel/batch.py`` for every mode
of the registry: DBPSK (kind ``psk2``), DQPSK (``psk4``), D8PSK (``psk8``),
FSK (``fsk``: FSK1200, FSK9600, FSK19200, MSK, FT8), OFDM4 and OFDM8
(``ofdm``), DSSS (``dsss``), NEURAL (``neural``) and the Hellschreiber text
modes (``hell``). The pipeline:

  host:   read WAVs, pad to one bucket length, shape each capture into
          rows: blocked (r, 128*spsym) sample rows for PSK (float32 for
          DSSS), overlapped (r, row+ov) rows for dual-tone FSK and OFDM
          (float32), padded FIR windows for the FSK discriminator and
          quadrature paths, pixel windows for the text modes (int16 for a
          CUDA device where the kernels or the text path take it);
          NEURAL captures stay flat float32
  device: PSK: pass 1 (timing offset + blind rotation, plain torch), kernel
          K1 (projection + differential + derotation + decision), then the
          kind's sync tail over tiered prefixes:
          psk4: K2 (rotation x parity magic match), fold, K3 (relabel +
                mod-8 alignment + byte pack);
          psk2: K2 (stream x inversion match), fold, K4 (stream select +
                complement + mod-8 alignment + byte pack);
          psk8: K5 (8-rotation sector match), earliest-position fold, K6
                (relabel + Gray + mod-8-symbol alignment + byte pack).
          OFDM: pass 1 over every sample offset, the row-shifted blocked
          duals (one ``torch.bmm``), the K-lane differentials, rotation and
          Gray decisions (plain torch), then the psk4 tail (K2, K3) on the
          card and the per-capture tails elsewhere.
          DSSS: the PSK pass 1 and the raw chip phasors (one ``torch.bmm``),
          the banded despread, then the DBPSK sync tail per capture on the
          bit-rate stream (plain torch, as the JAX package's).
          HELL: pixel energies, the glyph match as one product and argmax
          (plain torch): the "bytes" are the decoded text.
          FSK: pass 1 (timing offset, plain torch), then K7 (dual tone), K8
          (discriminator, followed by atan2 + equalizer + decision) or K9
          (quadrature margin); K13 for flat dual-tone input; the
          single-capture receiver per capture for every other input (flat
          close and mid tones, FIR-window rows, CONFIG ``modem.batch_mlse``,
          whose MLSE Viterbi is a kernel of its own, one launch for every
          capture's blocks); then the plain-torch
          sync tail: first exact magic, shift, byte pack.
          PSK captures without a blocked path (PSK31, symbols over 32
          samples, captures under 256 symbols) run the single-capture
          receiver per capture (K11, rotation, decision) and the
          per-capture plain-torch sync tails; CONFIG
          ``tpu.demod_backend = "xla"`` selects the staged D8PSK path (K12)
          and the per-capture tails for every PSK kind and OFDM.
          NEURAL: the preamble matched filter (one blocked matmul, prefix
          lags first, the full search for the whole batch when a capture
          fails the prefix test), then K10 (chips + unrotation + codebook
          argmax) at 9600 Bd, the plain-torch extraction at chip length 4,
          or the FFT matched filter per capture at other rates
  host:   the recovery ladder per capture (strict FBPC parse,
          header-tolerant recovery, no-sync rescue), the MLSE, coherent
          and clock-drift escalations of lost captures, decompression,
          assembly, save; the text modes save their text

``jit`` and ``vmap`` have no counterpart here: the batch dimension is
written out and each tier of the prefix scan is one scalar read to the host
followed by a Python branch.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..assembly import AssemblyRegistry
from ..config import CONFIG
from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from ..modem import SAMPLE_RATE
from ..ops.common import (
    bit_sync_and_pack_rotations,
    dibit_sync_and_pack,
    dibit_sync_and_pack_rotations,
    find_bit_pattern,
    find_bit_pattern_validated,
    pack_bits_from,
)
from ..ops.dsss import dsss_bits_cfo_batch
from ..ops.fsk import (
    _fir_frontend_plan,
    _fsk_disc_kernel_plan,
    _fsk_geometry,
    _samples_per_bit,
    _separation_cycles,
    fsk_blocked_row_shape,
    fsk_demod_bits_batch,
    fsk_demod_bits_each,
    fsk_disc_bits_rows_batch,
    fsk_disc_row_shape,
    fsk_dual_bits_rows_batch,
    fsk_dual_rows_batch_plan,
    fsk_fir_row_shape,
    fsk_quad_bits_rows_batch,
    fsk_quad_row_shape,
)
from ..ops.kernels import (
    bit_select_pack_batch,
    psk8_relabel_pack_rows,
    relabel_pack_batch,
    rotation_match_batch,
    sector_match_batch,
)
from ..ops.hell import hell_demod_text_batch
from ..ops.neural import PREAMBLE_LEN, _chip_len, _demod, _fft_len, _td_supported, demod_td_batch
from ..ops.ofdm import ofdm_blocked_row_shape, ofdm_decision_streams_batch
from ..ops.psk import (
    blocked_row_shape,
    psk8_sector_rows_batch,
    psk8_sector_staged,
    psk8_sync_and_pack_rotations,
    psk_decision_streams_batch,
)
from ..utils.torchenv import DeviceLike, resolve_device
from ..utils.wavio import read_wav, resample
from .mesh import DATA_AXIS, Mesh, agree_all, get_mesh, pad_batch, run_shards

logger = logging.getLogger("audio_modem_radio_tpu_torch")

# --- per-mode demodulator plan -------------------------------------------------

def resolve_demod_plan(mode: str, symbol_rate: int) -> Tuple[str, tuple]:
    """Mode name -> ('psk2'|'psk4'|'psk8'|'fsk'|'ofdm'|'dsss'|'neural'|'hell',
    params) for the batched path, the JAX package's full table. Unknown modes
    fall back to QPSK, like the reference decoder."""
    r = symbol_rate
    table = {
        "FSK1200": ("fsk", (1200.0, 1200.0, 2200.0)),
        "FSK9600": ("fsk", (9600.0, 1200.0, 2200.0)),
        "FSK19200": ("fsk", (19200.0, 8000.0, 16000.0)),
        "BPSK": ("psk2", (float(r), 3000.0)),
        "QPSK": ("psk4", (float(r), 3000.0)),
        "8PSK": ("psk8", (float(r), 12000.0)),
        "OFDM4": ("ofdm", (float(r), 12000.0, 4)),
        "OFDM8": ("ofdm", (float(r), 12000.0, 8)),
        "APSK16": ("psk4", (float(r), 12000.0)),
        "SSTV": ("psk4", (float(r), 3000.0)),
        "DSSS": ("dsss", (float(r), 3000.0)),
        "MSK": ("fsk", (float(r), 6000.0, 6000.0 + r)),
        "FT8": ("fsk", (50.0, 3000.0, 3050.0)),
        "PSK31": ("psk2", (31.25, 3000.0)),
        "NEURAL": ("neural", (float(r),)),
        "HELLSCHREIBER": ("hell", (122.5,)),
        "FELD_HELL": ("hell", (122.5,)),
        "SLOW_HELL": ("hell", (61.25,)),
    }
    if mode not in table:
        return table["QPSK"]
    return table[mode]


def _receive_kind(mode: str, symbol_rate: int) -> Tuple[str, tuple]:
    """:func:`resolve_demod_plan` with the compatibility aliases applied:
    under CONFIG ``modem.ofdm_compat_alias`` the OFDM wire format is DQPSK
    at the same carrier and under ``modem.psk8_compat_alias`` the 8PSK one
    (kind psk4), under ``modem.dsss_compat_alias`` the DSSS wire format is
    plain DBPSK (kind psk2)."""
    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "ofdm" and CONFIG.get("modem.ofdm_compat_alias", False):
        kind, params = "psk4", params[:2]
    if kind == "psk8" and CONFIG.get("modem.psk8_compat_alias", False):
        kind = "psk4"
    if kind == "dsss" and CONFIG.get("modem.dsss_compat_alias", False):
        kind = "psk2"
    return kind, params


# --- device-side batched demod -------------------------------------------------

# Row granularity of the magic matchers; prefix tiers are multiples of it.
_MATCH_BLOCK_ROWS = 256
_BIG = 1 << 30


def _scan_tiered(r: int, match, fold, accept):
    """Tiered prefix scan of an r-row stream: a genuine capture's magic sits
    near the stream start, so scan one matcher block first, then ~1/8 of
    the rows, then everything. ``match(rows) -> (first, found)``; a tier is
    taken when ``accept(found)`` holds for every capture (one scalar read to
    the host; under a data-parallel mesh, every capture of every shard), and
    its ``fold(first, found) -> (s, ksel, found)`` returned."""
    r_pre = -(-r // 8 // _MATCH_BLOCK_ROWS) * _MATCH_BLOCK_ROWS
    tiers = [p for p in sorted({_MATCH_BLOCK_ROWS, r_pre}) if 2 * p <= r]
    for p in tiers:
        first_p, found_p = match(p)
        # Under a data-parallel mesh the tier is taken for the global batch.
        if agree_all(bool(torch.all(accept(found_p)))):
            return fold(first_p, found_p)
    return fold(*match(r))


def psk4_kernel_sync_tail(
    hi: torch.Tensor, lo: torch.Tensor, cfo_retry: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DQPSK sync tail: K2 matcher over tiered prefixes + K3 pack.

    ``hi``/``lo`` are (B, n_dib) uint8 Gray lanes, n_dib a multiple of
    128*256. Returns ``(packed (B, n_dib/4) uint8, n_valid (B,) int32,
    found (B,) bool)``. The stream is aligned only mod 8 bits: the frame
    starts at byte s//8, which the parser's magic scan absorbs. With
    ``cfo_retry`` off only the k=0 hypothesis is accepted, so a rotated
    stream does not decode.
    """
    n_dib = hi.shape[1]
    r_dib = n_dib // 128
    hi3 = hi.reshape(-1, r_dib, 128)
    lo3 = lo.reshape(-1, r_dib, 128)

    def fold(first, found8):
        fe, fo = found8[:, :4].clone(), found8[:, 4:].clone()
        se, so = 2 * first[:, :4], 2 * first[:, 4:] + 1
        if not cfo_retry:
            fe[:, 1:] = False
            fo[:, 1:] = False
        zero = torch.zeros_like(se)
        s_k = torch.where(fe & (~fo | (se <= so)), se, torch.where(fo, so, zero))
        found_k = fe | fo
        # First True hypothesis (k order), 0 when none: argmax over 0/1.
        ksel = torch.argmax(found_k.to(torch.uint8), dim=1, keepdim=True)
        s = torch.gather(s_k, 1, ksel)[:, 0]
        found = torch.gather(found_k, 1, ksel)[:, 0]
        return s.to(torch.int32), ksel[:, 0].to(torch.int32), found

    def match(rows):
        return rotation_match_batch(
            hi3, lo3, MAGIC_BIT_PATTERN, r_dib,
            pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows,
        )

    # A tier is accepted iff EVERY capture matched hypothesis k=0 (either
    # parity) inside it; the fold over the prefix then equals the full
    # scan's (a prefix k=0 match is the global first for its parity, and
    # ksel = 0 on both views).
    s, ksel, found = _scan_tiered(r_dib, match, fold, lambda f: f[:, 0] | f[:, 4])
    packed = relabel_pack_batch(hi3, lo3, s, ksel, rows_per_capture=r_dib, variant="weights")
    n_valid = (2 * n_dib - (s & 7)) // 8
    return packed, n_valid.to(torch.int32), found


def psk2_kernel_sync_tail(
    hi: torch.Tensor, lo: torch.Tensor, cfo_retry: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DBPSK sync tail: K2 with the 4 DBPSK hypotheses (re/im x
    inverted) over tiered prefixes, then K4 (select + complement + pack).

    ``hi``/``lo`` are the (B, n_bits) uint8 sign-bit streams of the (re, im)
    differential, n_bits a multiple of 128*256. Returns ``(packed (B,
    n_bits/8) uint8, n_valid (B,) int32, found (B,) bool)``; the frame
    starts at byte s//8. With ``cfo_retry`` off only hypothesis 0 (re,
    uninverted) is accepted.
    """
    n_bits = hi.shape[1]
    r_bit = n_bits // 128
    hi3 = hi.reshape(-1, r_bit, 128)
    lo3 = lo.reshape(-1, r_bit, 128)

    def fold(first, found4):
        if not cfo_retry:
            found4 = found4.clone()
            found4[:, 1:] = False
        ksel = torch.argmax(found4.to(torch.uint8), dim=1, keepdim=True)
        s = torch.gather(first, 1, ksel)[:, 0]
        found = torch.gather(found4, 1, ksel)[:, 0]
        return torch.where(found, s, 0).to(torch.int32), ksel[:, 0].to(torch.int32), found

    def match(rows):
        return rotation_match_batch(
            hi3, lo3, MAGIC_BIT_PATTERN, r_bit, family="bpsk",
            pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows,
        )

    # Accepted iff every capture matched hypothesis 0 inside the tier: then
    # ksel = 0 on both views and the prefix's first[:, 0] is the global first.
    s, ksel, found = _scan_tiered(r_bit, match, fold, lambda f: f[:, 0])
    packed = bit_select_pack_batch(hi3, lo3, s, ksel, rows_per_capture=r_bit, variant="weights")
    n_valid = (n_bits - (s & 7)) // 8
    return packed, n_valid.to(torch.int32), found


def psk8_kernel_sync_tail(
    sec: torch.Tensor, cfo_retry: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The D8PSK sync tail: K5 (8 π/4-rotation sector match) over tiered
    prefixes, the earliest-position fold, then K6 (relabel + Gray + pack).

    ``sec`` is (B, m) uint8 received sectors, m a multiple of 128*256.
    Returns ``(packed (B, 3m/8) uint8, n_valid (B,) int32, found (B,)
    bool)``; the stream is aligned only mod 8 symbols, so the frame starts
    at byte 3*(s//8). With ``cfo_retry`` off only hypothesis k=0 is accepted.
    """
    b, m = sec.shape
    r_sym = m // 128
    sec3 = sec.reshape(b, r_sym, 128)
    k_order = torch.arange(8, dtype=torch.int32, device=sec.device)

    def fold(first, found8):
        # Earliest position, k order breaking ties: the true rotation is the
        # one whose validated magic starts the frame. It also makes the
        # any-hypothesis tier acceptance below sound.
        if not cfo_retry:
            found8 = found8.clone()
            found8[:, 1:] = False
        score = torch.where(found8, first * 8 + k_order, _BIG)
        ksel = torch.argmin(score, dim=1, keepdim=True)
        s = torch.gather(first, 1, ksel)[:, 0]
        found = torch.gather(found8, 1, ksel)[:, 0]
        return torch.where(found, s, 0).to(torch.int32), ksel[:, 0].to(torch.int32), found

    def match(rows):
        return sector_match_batch(
            sec3, MAGIC_BIT_PATTERN, r_sym, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows,
        )

    # Accepted iff every capture matched any hypothesis inside the tier
    # (hypothesis 0 with cfo_retry off): positions past the prefix are
    # larger, so the earliest match over all hypotheses lies in it.
    s, ksel, found = _scan_tiered(
        r_sym, match, fold, (lambda f: f.any(dim=1)) if cfo_retry else (lambda f: f[:, 0])
    )
    r8 = (s % 8).to(torch.int32)
    packed = psk8_relabel_pack_rows(sec3, ksel, r8, rows_per_capture=r_sym)
    n_valid = (3 * (m - r8)) // 8
    return packed, n_valid.to(torch.int32), found


def _fsk_bits(samples: torch.Tensor, baud: float, mark: float, space: float, mlse: bool,
              xla: bool) -> torch.Tensor:
    """FSK bits (B, n_bits) uint8, dispatched on the input's layout as the
    JAX package dispatches it: host-overlapped dual-tone rows to pass 1 and
    K7 (under ``xla`` too, on the unpadded float32 rows), the fused FIR-window
    layouts to K8 or K9, flat dual-tone captures long enough for two rows
    to K13 (not under ``xla``), and everything else (flat close and mid
    tones, the FIR windows of ``fsk_fir_row_shape``, shorter captures) to
    the single-capture receiver per capture, with MLSE when ``mlse`` (one
    Viterbi launch for the batch)."""
    sep = _separation_cycles(baud, mark, space, SAMPLE_RATE)
    spb = _samples_per_bit(SAMPLE_RATE, baud)
    if samples.ndim == 3 and sep >= 0.8:
        _spr, row, ov = _fsk_geometry(spb)
        if samples.shape[2] != row + ov:
            raise ValueError("pre-shaped dual-tone rows have the wrong column count")
        return fsk_dual_bits_rows_batch(samples, baud, mark, space, SAMPLE_RATE)
    if samples.ndim == 3:
        _lo, _hi, dec, taps = _fir_frontend_plan(baud, mark, space, SAMPLE_RATE)
        plan = _fsk_disc_kernel_plan(spb, dec, taps)
        if plan is not None and sep >= 0.4 and plan["spr2"] % 128:
            plan = None  # K9 takes 128-aligned spr2 only
        if (plan is not None and samples.shape[2] == plan["c_pad"]
                and samples.shape[1] % plan["fb"] == 0):
            fn = fsk_disc_bits_rows_batch if sep < 0.4 else fsk_quad_bits_rows_batch
            return fn(samples, baud, mark, space, SAMPLE_RATE)
    elif not xla and sep >= 0.8 and samples.shape[1] // spb >= 2 * _fsk_geometry(spb)[0]:
        return fsk_demod_bits_batch(samples, baud, mark, space, SAMPLE_RATE)
    return fsk_demod_bits_each(samples, baud, mark, space, SAMPLE_RATE, mlse=mlse)


def demod_pack_batch(
    samples: torch.Tensor,
    mode: str,
    symbol_rate: int,
    cfo_retry: bool = True,
    fsk_mlse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N) samples or host-shaped (B, r, cols) rows -> (packed bytes
    (B, max_bytes), n_valid (B,), found (B,)), on the input's device.

    Demod + magic sync + byte pack for the whole batch, every kind of
    :func:`resolve_demod_plan` after the compatibility aliases: 'psk4'
    (QPSK, APSK16, SSTV, and 8PSK and OFDM4/8 under their aliases), 'psk2'
    (BPSK, PSK31, and DSSS under its alias), 'psk8' (8PSK), 'ofdm' (OFDM4,
    OFDM8), 'dsss' (DSSS; float rows or flat input), 'fsk' (FSK1200,
    FSK9600, FSK19200, MSK, FT8; any layout :func:`host_shape_batch`
    builds, and flat input), 'neural' (flat input; the bytes after the
    preamble, n_valid their count, found all true) and 'hell' (the decoded
    text's character codes, n_valid their count, found the sync gate). The
    PSK kinds take the kernel sync tails (K2 + K3/K4, K5 + K6) on blocked
    streams and the per-capture plain-torch tails on the single-capture
    streams of captures without a blocked path, as the JAX package picks
    them by stream length; D8PSK zero-pads to the kernels' grain and keeps
    K5 + K6 there, and so does OFDM with K2 + K3 on a CUDA device. Under
    CONFIG ``tpu.demod_backend = "xla"`` D8PSK runs the staged float path
    (K12, rotation, sectors), every PSK kind and OFDM the per-capture tails
    and dual-tone FSK K7 on the unpadded float32 rows. ``fsk_mlse`` refines
    close-tone FSK captures that arrive flat by MLSE.
    """
    kind, params = _receive_kind(mode, symbol_rate)
    if kind == "neural":
        return _neural_pack(samples, int(params[0]))
    if kind == "hell":
        return hell_demod_text_batch(samples, int(round(SAMPLE_RATE / params[0])))
    if kind == "dsss":
        return dsss_bits_cfo_batch(samples, *params, SAMPLE_RATE, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    xla = CONFIG.get("tpu.demod_backend", "auto") == "xla"
    if kind == "fsk":
        # The JAX package's sync tail as it is: the first exact magic (no
        # validation pattern, no rotations), unvalidated, then the pack.
        bits = _fsk_bits(samples, *params, mlse=fsk_mlse, xla=xla)
        start, found = find_bit_pattern(bits, MAGIC_BIT_PATTERN)
        packed, n_valid = pack_bits_from(bits, start)
        return packed, n_valid, found
    if kind == "ofdm":
        baud, carrier, n_sub = params
        hi, lo = ofdm_decision_streams_batch(samples, baud, carrier, int(n_sub), SAMPLE_RATE, cfo=cfo_retry)
        if not xla and samples.device.type == "cuda":
            # The DQPSK tail on the kernels: zero dibits up to the 128*256
            # grain decode to a tail the frame parser ignores.
            grain = 128 * _MATCH_BLOCK_ROWS
            pad = -hi.shape[1] % grain
            return psk4_kernel_sync_tail(F.pad(hi, (0, pad)), F.pad(lo, (0, pad)), cfo_retry)
        return _per_capture(_psk_capture_tail("psk4", cfo_retry), hi, lo)
    baud, carrier = params
    if kind == "psk8":
        if xla:
            sec = psk8_sector_staged(samples, baud, carrier, SAMPLE_RATE, cfo=cfo_retry)
            return _per_capture(lambda s: psk8_sync_and_pack_rotations(
                s, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2), sec)
        sec = psk8_sector_rows_batch(samples, baud, carrier, SAMPLE_RATE, cfo=cfo_retry)
        # Zero-pad to the matcher's row grain: zero sectors cannot match the
        # exact part of the magic (its tribits hit 5 distinct sectors under
        # any rotation), and packed bytes past n_valid are ignored. Blocked
        # rows already sit on the grain, and F.pad would copy them anyway.
        grain = 128 * _MATCH_BLOCK_ROWS
        if sec.shape[1] % grain:
            sec = F.pad(sec, (0, -(-sec.shape[1] // grain) * grain - sec.shape[1]))
        return psk8_kernel_sync_tail(sec, cfo_retry)
    n_psk = 4 if kind == "psk4" else 2
    hi, lo = psk_decision_streams_batch(
        samples, baud, carrier, SAMPLE_RATE, n_psk=n_psk, cfo=cfo_retry
    )
    if not xla and hi.shape[1] % (128 * _MATCH_BLOCK_ROWS) == 0:
        tail = psk4_kernel_sync_tail if kind == "psk4" else psk2_kernel_sync_tail
        return tail(hi, lo, cfo_retry)
    return _per_capture(_psk_capture_tail(kind, cfo_retry), hi, lo)


def _neural_pack(samples: torch.Tensor, symbol_rate: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NEURAL: the symbols are the bytes, so there is no bit-level sync or
    pack stage. Chip lengths 2 and 4 take the time-domain batch
    (``demod_td_batch``: K10 at chip length 2), others the FFT matched
    filter per capture. Returns the stream after the preamble, its full
    length as n_valid and found all true, as the JAX package does."""
    chip_len = _chip_len(symbol_rate)
    if _td_supported(chip_len):
        syms = demod_td_batch(samples, chip_len)
    else:
        n_fft = _fft_len(samples.shape[-1], chip_len)
        syms = torch.stack([_demod(x.to(torch.float32), chip_len, n_fft)[0] for x in samples])
    payload = syms[:, PREAMBLE_LEN:]
    b, dev = payload.shape[0], payload.device
    return (payload, torch.full((b,), payload.shape[1], dtype=torch.int32, device=dev),
            torch.ones((b,), dtype=torch.bool, device=dev))


def _psk_capture_tail(kind: str, cfo_retry: bool):
    """The JAX package's per-capture DQPSK/DBPSK tail for one (hi, lo)
    capture: the validated rotation sync, or with ``cfo_retry`` off the
    validated k=0 sync (the parity-aligned dibit match, or the re stream's
    pattern find)."""
    pat, pat2 = MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    if kind == "psk4":
        sync = dibit_sync_and_pack_rotations if cfo_retry else dibit_sync_and_pack
        return lambda h, l: sync(h, l, pat, pat2)
    if cfo_retry:
        return lambda br, bi: bit_sync_and_pack_rotations(br, bi, pat, pat2)

    def sync_pack_one(br, _bi):
        start, found = find_bit_pattern_validated(br, pat, pat2)
        packed, n_valid = pack_bits_from(br[None], start.reshape(1))
        return packed[0], n_valid, found

    return sync_pack_one


def _per_capture(tail, *streams) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a single-capture sync tail on every row of the (B, n) streams and
    stack ``(packed (B, max_bytes), n_valid (B,), found (B,))``."""
    out = [tail(*rows) for rows in zip(*streams)]
    return tuple(torch.stack([o[j] for o in out]) for j in range(3))


# --- host orchestration --------------------------------------------------------

def _bucket_length(lengths: Sequence[int]) -> int:
    from ..decoder import pad_to_bucket

    probe = np.zeros(max(lengths), dtype=np.float32)
    return len(pad_to_bucket(probe))


def _int16_rows(device: DeviceLike) -> bool:
    """int16 rows on a CUDA device, float32 otherwise; CONFIG
    ``tpu.int16_rows`` overrides the choice."""
    i16 = CONFIG.get("tpu.int16_rows", None)
    if i16 is None:
        i16 = resolve_device(device).type == "cuda"
    return bool(i16)


def _fsk_host_shape(batch: np.ndarray, params: tuple, device: DeviceLike, mlse: bool) -> np.ndarray:
    """FSK rows in the layout of the JAX package's TPU path, on every device:
    dual tones as overlapped rows, padded to 256-row blocks (int16 on CUDA)
    where ``fsk_dual_rows_batch_plan`` maps, else unpadded float32 rows;
    close and mid tones as the fused FIR windows (int16 on CUDA), else as
    the float32 FIR windows of ``fsk_fir_row_shape``, else flat. With
    ``mlse`` close and mid tones stay flat (MLSE correlates the raw
    samples). Under CONFIG ``tpu.demod_backend = "xla"`` the layouts are
    the JAX package's XLA ones: unpadded float32 dual-tone rows and the
    FIR windows. ``tpu.int8_rows`` does not apply to FSK."""
    baud, mark, space = params
    n = batch.shape[1]
    xla = CONFIG.get("tpu.demod_backend", "auto") == "xla"
    dtype = np.int16 if _int16_rows(device) else np.float32
    shape = fsk_blocked_row_shape(n, baud, mark, space, SAMPLE_RATE)
    if shape is not None:
        r, row, ov = shape
        r_pad = -(-r // 256) * 256
        if not xla and fsk_dual_rows_batch_plan(_samples_per_bit(SAMPLE_RATE, baud), r_pad) is not None:
            return _overlap_rows(batch, r_pad, row, ov, dtype=dtype)
        return _overlap_rows(batch, r, row, ov)
    if mlse:
        return batch
    dshape = None if xla else (fsk_disc_row_shape(n, baud, mark, space, SAMPLE_RATE)
                               or fsk_quad_row_shape(n, baud, mark, space, SAMPLE_RATE))
    if dshape is not None:
        r, row, ov, lead = dshape
        return _overlap_rows(batch, r, row, ov, lead=lead, dtype=dtype)
    fshape = fsk_fir_row_shape(n, baud, mark, space, SAMPLE_RATE)
    if fshape is not None:
        r, row, ov, lead = fshape
        return _overlap_rows(batch, r, row, ov, lead=lead)
    return batch


def _overlap_rows(
    batch: np.ndarray, r: int, row: int, ov: int, lead: int = 0, dtype=np.float32,
) -> np.ndarray:
    """(B, N) -> (B, r, row+ov) overlapped rows from two strided views, with
    ``lead`` zero samples logically prepended (the FIR's center-tap
    alignment); ``dtype=np.int16`` quantizes at scale 32768."""
    if ov > row:
        raise ValueError("overlap must not exceed the row length")
    b = batch.shape[0]
    keep = min(batch.shape[1], r * row + ov - lead)
    src = batch[:, :keep]
    if np.dtype(dtype) == np.int16:
        src = np.clip(np.round(src * 32768.0), -32768, 32767).astype(np.int16)
    flat = np.zeros((b, (r + 1) * row), dtype=dtype)
    flat[:, lead : lead + keep] = src
    shaped = np.empty((b, r, row + ov), dtype=dtype)
    shaped[:, :, :row] = flat[:, : r * row].reshape(b, r, row)
    shaped[:, :, row:] = flat[:, row : (r + 1) * row].reshape(b, r, row)[:, :, :ov]
    return shaped


def host_shape_batch(
    batch: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None,
    fsk_mlse: Optional[bool] = None,
) -> np.ndarray:
    """Pre-shape (B, N) captures into the layout ``demod_pack_batch`` takes
    on ``device`` (default: the card), the JAX package's layouts after the
    compatibility aliases: PSK captures (kinds psk2, psk4, psk8, dsss) into
    blocked (B, r, 128*spsym) rows, FSK captures as :func:`_fsk_host_shape`
    says, OFDM captures into float32 (B, r, L*S+S) overlapped rows (one
    S-sample symbol of overlap), text-mode captures into (B, n_pix, spp)
    pixel windows; NEURAL captures, and captures too short for a layout,
    pass through unchanged as float32.

    PSK rows and pixel windows are int16 at scale 32768 when the target
    device is CUDA (half the host-to-device copy and half the kernels'
    read; exact for int16-PCM sources, which read_wav divides by 32768),
    float32 otherwise. CONFIG ``tpu.int16_rows`` overrides that choice;
    CONFIG ``tpu.int8_rows`` (off by default) ships PSK rows as int8 at
    scale 128 instead, a quarter of the float32 read at about -50 dB of
    quantization noise. DSSS rows are always float32: its chip front end
    is a float product, not K1. ``fsk_mlse`` (None: CONFIG
    ``modem.batch_mlse``) keeps close- and mid-tone FSK captures flat for
    the MLSE path.
    """
    batch = np.asarray(batch, dtype=np.float32)
    b = batch.shape[0]
    kind, params = _receive_kind(mode, symbol_rate)
    if kind == "fsk":
        return _fsk_host_shape(batch, params, device, _batch_mlse(fsk_mlse))
    if kind == "ofdm":
        shape = ofdm_blocked_row_shape(batch.shape[1], params[0], int(params[2]), SAMPLE_RATE)
        return batch if shape is None else _overlap_rows(batch, *shape)
    if kind == "hell":
        spp = int(round(SAMPLE_RATE / params[0]))
        n_pix = batch.shape[1] // spp
        if n_pix < 1:
            return batch
        view = batch[:, : n_pix * spp].reshape(b, n_pix, spp)
        if _int16_rows(device):
            return np.clip(np.round(view * 32768.0), -32768, 32767).astype(np.int16)
        return view
    if kind not in ("psk2", "psk4", "psk8", "dsss"):
        return batch
    shape = blocked_row_shape(batch.shape[1], params[0], SAMPLE_RATE)
    if shape is None:
        return batch
    r, row = shape
    keep = min(batch.shape[1], r * row)
    if kind == "dsss":
        shaped = np.zeros((b, r * row), dtype=np.float32)
        shaped[:, :keep] = batch[:, :keep]
    elif CONFIG.get("tpu.int8_rows", False):
        shaped = np.zeros((b, r * row), dtype=np.int8)
        shaped[:, :keep] = np.clip(
            np.round(batch[:, :keep] * 128.0), -128, 127
        ).astype(np.int8)
    elif _int16_rows(device):
        shaped = np.zeros((b, r * row), dtype=np.int16)
        shaped[:, :keep] = np.clip(
            np.round(batch[:, :keep] * 32768.0), -32768, 32767
        ).astype(np.int16)
    else:
        shaped = np.zeros((b, r * row), dtype=np.float32)
        shaped[:, :keep] = batch[:, :keep]
    return shaped.reshape(b, r, row)


def _batch_mlse(fsk_mlse: Optional[bool]) -> bool:
    return bool(CONFIG.get("modem.batch_mlse", False)) if fsk_mlse is None else bool(fsk_mlse)


def decode_sample_batch(
    batch: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None,
    fsk_mlse: Optional[bool] = None, mesh: Optional[Mesh] = None,
) -> List[bytes]:
    """Demodulate a (B, N) batch to per-capture raw byte streams on
    ``device`` (default: the card; the CPU only when named). ``fsk_mlse``
    overrides CONFIG ``modem.batch_mlse`` (the MLSE escalation of
    :func:`decode_wav_batch` sets it); None defers to CONFIG.

    With a ``mesh`` (in place of ``device``; by default, when no device is
    named and more than one card is visible, all of them) the batch axis is
    sharded over the mesh's data axis: the host-shaped batch is zero-padded
    to a multiple of the mesh's size, each shard's rows run
    :func:`demod_pack_batch` on its own device and thread, and the result is
    cut back to B. The batch-wide decisions (the sync tails' tiers, NEURAL's
    prefix or full search) are taken once for the global batch, so the
    bytes equal the unsharded call's."""
    if mesh is None and device is None and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        mesh = get_mesh()
    if mesh is None:
        devs, size = [resolve_device(device)], 1
    else:
        n_data = mesh.shape[DATA_AXIS]
        devs, size = list(mesh.devices.reshape(n_data, -1)[:, 0]), mesh.size  # the model axis would replicate
    mlse = _batch_mlse(fsk_mlse)
    cfo_retry = bool(CONFIG.get("modem.cfo_retry", True))
    padded = pad_batch(host_shape_batch(batch, mode, symbol_rate, device=devs[0], fsk_mlse=mlse), size)
    per = padded.shape[0] // len(devs)

    def shard(i: int, dev: torch.device) -> List[bytes]:
        x = torch.from_numpy(np.ascontiguousarray(padded[i * per : (i + 1) * per])).to(dev)
        packed, n_valid, _found = demod_pack_batch(x, mode, int(symbol_rate), cfo_retry=cfo_retry, fsk_mlse=mlse)
        packed, n_valid = packed.cpu().numpy(), n_valid.cpu().numpy()
        return [packed[j, : int(n_valid[j])].tobytes() for j in range(packed.shape[0])]

    return [raw for part in run_shards(shard, devs) for raw in part][: batch.shape[0]]


def _read_wav_row(path: str) -> np.ndarray:
    """Read one WAV for the batch, resampled to 96 kHz; a corrupt file
    yields an EMPTY row instead of raising, so one bad file does not lose
    the rest of the batch."""
    try:
        data, sr = read_wav(path)
        if sr != SAMPLE_RATE:
            data = resample(data, sr, SAMPLE_RATE)
        return data.astype(np.float32)
    except Exception:
        logger.exception("unreadable WAV in batch: %s", path)
        return np.zeros(0, np.float32)


def decode_wav_batch(
    paths: Sequence[str],
    mode: str,
    symbol_rate: int,
    recv_dir: str = "recv",
    registry: Optional[AssemblyRegistry] = None,
    device: DeviceLike = None,
    stream_fec: bool = False,
    denoise: Optional[bool] = None,
    drift_retry: bool = True,
    mesh: Optional[Mesh] = None,
) -> List[List[str]]:
    """Decode many WAV files in one device batch.

    Returns, per input WAV, the list of file paths recovered from it.
    Frames from all captures feed one assembly registry, so a multi-part
    transfer spread across several captures reassembles here. The text
    modes save each capture's decoded text (``decoder.save_decoded_text``)
    and skip the ladder and the escalations. WAVs load
    through the native multi-threaded loader where it built (files at other
    rates than 96 kHz, and unreadable ones, through ``utils.wavio``); with
    ``denoise`` (None defers to CONFIG ``modem.noise_reduction``) each
    capture runs the spectral gate on the device. Every capture runs
    ``decoder.run_recovery_ladder`` (with ``stream_fec``, the stream FEC
    decode and its soft escalation first; strict parse, header-tolerant
    recovery, the no-sync rescue on total loss, soft payload FEC); then the
    captures that yielded nothing go through the MLSE escalation (close-
    and mid-tone FSK without CONFIG ``modem.batch_mlse``: the lost captures
    again as one batch through the MLSE-refined path), the coherent
    escalation (the carrier-tracked single-capture receiver; psk2, psk4,
    psk8, OFDM and DSSS outside the compatibility aliases) and, with
    ``drift_retry``, the
    ±5% clock-drift hypotheses as one extra batched dispatch. With a
    ``mesh`` every batched dispatch is sharded over it
    (:func:`decode_sample_batch`), and the per-capture rungs run on its
    first device unless ``device`` names another.
    """
    import os

    from ..decoder import (
        RETRY_FACTORS,
        default_registry,
        drift_rows,
        run_recovery_ladder,
        save_decoded_files,
        save_decoded_text,
    )
    from ..native import NATIVE_AVAILABLE, load_wav_batch
    from ..ops.dsss import dsss_tracked_demodulate
    from ..ops.ofdm import ofdm_tracked_demodulate
    from ..ops.psk import bpsk_tracked_demodulate, psk8_tracked_demodulate, qpsk_tracked_demodulate
    from ..utils.denoise import spectral_gate

    if mesh is not None and device is None:
        device = mesh.flat[0]
    if NATIVE_AVAILABLE:
        # The native loader reads headers and samples in parallel; a probe
        # over file sizes picks the bucket.
        est_len = max((os.path.getsize(p) // 2 for p in paths if os.path.exists(p)), default=1)
        samples, rates, counts = load_wav_batch(
            list(paths), _bucket_length([est_len]), max_threads=int(CONFIG.get("performance.max_workers", 0)),
        )
        arrays = [samples[i, : counts[i]] if rates[i] == SAMPLE_RATE else _read_wav_row(p)
                  for i, p in enumerate(paths)]
    else:
        arrays = [_read_wav_row(p) for p in paths]
    if denoise is None:
        denoise = bool(CONFIG.get("modem.noise_reduction", False))
    if denoise:
        arrays = [spectral_gate(a, device=device) for a in arrays]
    n = _bucket_length([max(len(a), 1) for a in arrays])
    batch = np.zeros((len(arrays), n), dtype=np.float32)
    for i, a in enumerate(arrays):
        batch[i, : min(len(a), n)] = a[:n]

    raws = decode_sample_batch(batch, mode, symbol_rate, device=device, mesh=mesh)
    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "hell":
        # The text modes' "bytes" are the decoded text, empty where the sync
        # gate rejected the capture: saved as recv_<ts>_<stem>.txt.
        texts = []
        for path, raw in zip(paths, raws):
            text = raw.decode("ascii", "replace")
            stem = os.path.splitext(os.path.basename(path))[0]
            texts.append([save_decoded_text(text, recv_dir, stem)] if text.strip() else [])
        return texts
    reg = registry or default_registry

    def ladder(raw: bytes, samples_i: np.ndarray, rescue: bool):
        frames, damaged, _loss, _counts = run_recovery_ladder(
            raw, samples_i, mode, symbol_rate, stats=reg.stats, rescue=rescue, stream_fec=stream_fec,
            device=device)
        return frames, damaged

    out: List[List[str]] = []
    lost: List[int] = []
    for i, raw in enumerate(raws):
        frames, damaged = ladder(raw, arrays[i], rescue=True)
        out.append(save_decoded_files(frames, recv_dir, registry, damaged=damaged or None, device=device))
        # Lost: nothing saved and no CRC-valid frame (a valid part banked in
        # the assembly is progress).
        if not out[-1] and not frames:
            lost.append(i)

    if (lost and kind == "fsk" and not CONFIG.get("modem.batch_mlse", False)
            and _separation_cycles(*params, SAMPLE_RATE) < 0.8):
        # The batch skips the MLSE refinement by default; re-dispatch only
        # the captures that parsed nothing through the MLSE-refined path,
        # so the batch never decodes worse than the single-capture receiver.
        esc = np.zeros((len(lost), n), dtype=np.float32)
        for j, i in enumerate(lost):
            esc[j, : min(len(arrays[i]), n)] = arrays[i][:n]
        esc_raws = decode_sample_batch(esc, mode, symbol_rate, device=device, fsk_mlse=True, mesh=mesh)
        still_lost = []
        for j, i in enumerate(lost):
            frames, damaged = ladder(esc_raws[j], arrays[i], rescue=True)
            saved = save_decoded_files(frames, recv_dir, registry, damaged=damaged or None, device=device)
            if saved:
                out[i] = saved
            elif not frames:
                still_lost.append(i)
        lost = still_lost
    if (
        lost
        and kind in ("psk2", "psk4", "psk8", "ofdm", "dsss")
        and CONFIG.get("modem.psk_coherent_escalation", True)
        and _receive_kind(mode, symbol_rate)[0] == kind  # not under a compatibility alias
    ):
        tfn = {"psk2": bpsk_tracked_demodulate, "psk4": qpsk_tracked_demodulate,
               "psk8": psk8_tracked_demodulate, "dsss": dsss_tracked_demodulate,
               "ofdm": lambda x, b, c, sr, device: ofdm_tracked_demodulate(x, b, c, int(params[2]), sr,
                                                                            device=device)}[kind]
        still_lost = []
        for i in lost:
            if len(arrays[i]) < 2 * int(SAMPLE_RATE // params[0]):
                still_lost.append(i)
                continue
            try:
                traw = tfn(arrays[i], params[0], params[1], SAMPLE_RATE, device=device)
            except ValueError:  # a degenerate capture stays lost
                still_lost.append(i)
                continue
            frames, damaged = ladder(traw, arrays[i], rescue=False)
            saved = save_decoded_files(frames, recv_dir, registry, damaged=damaged or None, device=device)
            if saved:
                out[i] = saved
            elif not frames:
                still_lost.append(i)
        lost = still_lost

    if drift_retry and lost:
        drift = [f for f in RETRY_FACTORS if f != 1.0]
        m = _bucket_length([int(np.ceil(n * max(drift)))])
        retry = np.zeros((len(lost) * len(drift), m), dtype=np.float32)
        for j, i in enumerate(lost):
            if len(arrays[i]) >= 2:  # an unreadable WAV keeps empty rows
                retry[j * len(drift) : (j + 1) * len(drift)] = drift_rows(arrays[i], drift, m)
        retry_raws = decode_sample_batch(retry, mode, symbol_rate, device=device, mesh=mesh)
        for j, i in enumerate(lost):
            for k in range(len(drift)):
                row = j * len(drift) + k
                frames, damaged = ladder(retry_raws[row], retry[row], rescue=False)
                if not frames and not damaged:
                    continue
                saved = save_decoded_files(frames, recv_dir, registry, damaged=damaged or None, device=device)
                if saved or frames:  # a spurious damaged parse must not end the sweep
                    out[i] = saved
                    break
    return out
