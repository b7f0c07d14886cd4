"""Batched demodulation of many captures on one device — the throughput layer.

Counterpart of ``audio_modem_radio_tpu/parallel/batch.py`` for the DQPSK
slice. The pipeline:

  host:   read WAVs, pad to one bucket length, shape each capture into
          blocked (r, 128*spsym) sample rows (int16 for a CUDA device)
  device: pass 1 (timing offset + blind rotation, plain torch), kernel K1
          (projection + differential + derotation + Gray decision), kernel
          K2 over tiered prefixes (rotation x parity magic match), the fold
          rule, kernel K3 (relabel + mod-8 alignment + byte pack)
  host:   strict FBPC frame parse, decompression, assembly, save

``jit`` and ``vmap`` have no counterpart here: the batch dimension is
written out and each tier of the prefix scan is one scalar read to the host
followed by a Python branch.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..assembly import AssemblyRegistry
from ..config import CONFIG
from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, parse_frames
from ..modem import SAMPLE_RATE
from ..ops.kernels import relabel_pack_batch, rotation_match_batch
from ..ops.psk import blocked_row_shape, psk_decision_streams_batch
from ..utils.torchenv import DeviceLike, resolve_device
from ..utils.wavio import read_wav, resample

logger = logging.getLogger("audio_modem_radio_tpu_torch")

# --- per-mode demodulator plan -------------------------------------------------

# Demodulator kind -> the ROADMAP.md queue-1 item that will port it.
_UNPORTED_KINDS = {
    "psk2": "BPSK",
    "psk8": "8PSK",
    "ofdm": "OFDM",
    "fsk": "FSK",
    "dsss": "DSSS",
    "hell": "HELL",
    "neural": "NEURAL",
}


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


# --- device-side batched demod -------------------------------------------------

# Row granularity of the rotation matcher; prefix tiers are multiples of it.
_MATCH_BLOCK_ROWS = 256


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

    # Tiered prefix scan: a genuine capture's magic sits near the stream
    # start, so scan one matcher block first, then ~1/8 of the rows, then
    # everything. A tier is accepted iff EVERY capture matched hypothesis
    # k=0 (either parity) inside it; the fold over the prefix then equals
    # the full scan's (a prefix k=0 match is the global first for its
    # parity, and ksel = 0 on both views).
    r_pre = -(-r_dib // 8 // _MATCH_BLOCK_ROWS) * _MATCH_BLOCK_ROWS
    tiers = sorted({_MATCH_BLOCK_ROWS, r_pre})
    tiers = [p for p in tiers if 2 * p <= r_dib]
    for p in tiers:
        first_p, found_p = match(p)
        if bool(torch.all(found_p[:, 0] | found_p[:, 4])):  # one scalar read
            s, ksel, found = fold(first_p, found_p)
            break
    else:
        s, ksel, found = fold(*match(r_dib))

    packed = relabel_pack_batch(hi3, lo3, s, ksel, rows_per_capture=r_dib, variant="weights")
    n_valid = (2 * n_dib - (s & 7)) // 8
    return packed, n_valid.to(torch.int32), found


def demod_pack_batch(
    samples: torch.Tensor,
    mode: str,
    symbol_rate: int,
    cfo_retry: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N) samples or (B, r, 128*spsym) blocked rows -> (packed bytes
    (B, max_bytes), n_valid (B,), found (B,)), on the input's device.

    Demod + magic sync + byte pack for the whole batch. Only the DQPSK
    family ('psk4') is ported; other kinds raise NotImplementedError naming
    the ROADMAP.md item that will port them (the compatibility aliases of
    OFDM, 8PSK and DSSS come with those items).
    """
    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind != "psk4":
        raise NotImplementedError(
            f"mode {mode!r} (demodulator kind {kind!r}) is not ported to PyTorch yet: "
            f"ROADMAP.md queue 1, {_UNPORTED_KINDS[kind]}"
        )
    baud, carrier = params
    hi, lo = psk_decision_streams_batch(
        samples, baud, carrier, SAMPLE_RATE, n_psk=4, cfo=cfo_retry
    )
    return psk4_kernel_sync_tail(hi, lo, cfo_retry)


# --- host orchestration --------------------------------------------------------

def _bucket_length(lengths: Sequence[int]) -> int:
    from ..decoder import pad_to_bucket

    probe = np.zeros(max(lengths), dtype=np.float32)
    return len(pad_to_bucket(probe))


def host_shape_batch(
    batch: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None
) -> np.ndarray:
    """Pre-shape (B, N) DQPSK captures into blocked (B, r, 128*spsym) rows
    for ``demod_pack_batch``; other mode families, not ported yet, pass
    through unchanged.

    Rows are int16 at scale 32768 when the target device is CUDA (half the
    host-to-device copy and half K1's read; exact for int16-PCM sources,
    which read_wav divides by 32768), float32 otherwise. CONFIG
    ``tpu.int16_rows`` overrides that choice.
    """
    batch = np.asarray(batch, dtype=np.float32)
    b = batch.shape[0]
    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind != "psk4":
        return batch
    shape = blocked_row_shape(batch.shape[1], params[0], SAMPLE_RATE)
    if shape is None:
        return batch
    r, row = shape
    keep = min(batch.shape[1], r * row)
    i16 = CONFIG.get("tpu.int16_rows", None)
    if i16 is None:
        i16 = resolve_device(device).type == "cuda"
    if i16:
        shaped = np.zeros((b, r * row), dtype=np.int16)
        shaped[:, :keep] = np.clip(
            np.round(batch[:, :keep] * 32768.0), -32768, 32767
        ).astype(np.int16)
    else:
        shaped = np.zeros((b, r * row), dtype=np.float32)
        shaped[:, :keep] = batch[:, :keep]
    return shaped.reshape(b, r, row)


def decode_sample_batch(
    batch: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None
) -> List[bytes]:
    """Demodulate a (B, N) batch to per-capture raw byte streams on
    ``device`` (default: the card when present, else the CPU)."""
    dev = resolve_device(device)
    shaped = host_shape_batch(batch, mode, symbol_rate, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(shaped)).to(dev)
    packed, n_valid, _found = demod_pack_batch(
        x, mode, int(symbol_rate), cfo_retry=bool(CONFIG.get("modem.cfo_retry", True))
    )
    packed = packed.cpu().numpy()
    n_valid = n_valid.cpu().numpy()
    return [packed[i, : int(n_valid[i])].tobytes() for i in range(packed.shape[0])]


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
) -> List[List[str]]:
    """Decode many WAV files in one device batch.

    Returns, per input WAV, the list of file paths recovered from it.
    Frames from all captures feed one assembly registry, so a multi-part
    transfer spread across several captures reassembles here. Each capture
    gets the strict parse only; the recovery ladder is not ported yet.
    """
    from ..decoder import save_decoded_files

    arrays = [_read_wav_row(p) for p in paths]
    n = _bucket_length([max(len(a), 1) for a in arrays])
    batch = np.zeros((len(arrays), n), dtype=np.float32)
    for i, a in enumerate(arrays):
        batch[i, : min(len(a), n)] = a[:n]

    raws = decode_sample_batch(batch, mode, symbol_rate, device=device)
    return [save_decoded_files(parse_frames(raw), recv_dir, registry) for raw in raws]
