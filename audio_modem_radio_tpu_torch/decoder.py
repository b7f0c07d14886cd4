"""Decode pipeline of the PyTorch port: samples -> demodulate -> recovery ladder -> save.

Counterpart of ``audio_modem_radio_tpu/decoder.py``:

* ``decode_wav_file`` / ``decode_from_buffer``: read (any rate, mono-ized,
  resampled to 96 kHz), bucket-pad, ``modem.demodulate`` on the card (or
  the CPU when named), the recovery ladder, save;
* ``decode_with_retry``: the nominal decode, then the ±5% clock-drift
  hypotheses as one batched dispatch (``parallel.batch``);
* ``run_recovery_ladder``: strict parse, header-tolerant recovery
  (``recover_header_damaged``), and the no-sync rescue on total loss;
* ``save_decoded_files``: single parts directly, multi-part files through
  the assembly registry.

The FEC decoder (``fec.py``) is not ported (ROADMAP.md queue 1, item 2): a
frame whose payload carries an ``FECP``/``FECV`` container is logged and
left unsaved, the header-tolerant rung proves candidates by their as-read
payload CRC only (proofs 2-4 of the JAX package need FEC), the soft
payload-FEC rung logs damaged ``FECV`` frames and leaves them, and stream
FEC and the spectral-gate denoiser raise NotImplementedError. On every
transmission without FEC containers the results equal the JAX package's.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .assembly import AssemblyRegistry, registry as default_registry
from .config import CONFIG
from .framing import Frame, crc32, parse_frames, parse_frames_detailed, scan_frame_candidates
from .modem import SAMPLE_RATE, demodulate
from .utils.compression import intelligent_decompress
from .utils.torchenv import DeviceLike
from .utils.wavio import read_wav, resample

logger = logging.getLogger("audio_modem_radio_tpu_torch")

RECV_DIR = "recv"
_FEC_TAGS = (b"FECP", b"FECV")
_FEC_ITEM = "ROADMAP.md queue 1, item 2 (FEC)"


def pad_to_bucket(samples: np.ndarray) -> np.ndarray:
    """Zero-pad to the next configured bucket length, so batches of similar
    captures share one shape."""
    buckets: Sequence[int] = CONFIG.get("tpu.batch_bucket_sizes") or []
    n = len(samples)
    for b in sorted(buckets):
        if n <= b:
            if n == b:
                return samples
            return np.concatenate([samples, np.zeros(b - n, dtype=samples.dtype)])
    return samples  # beyond the largest bucket: use the exact length


def parse_fbp_stream_enhanced(raw: bytes) -> List[Frame]:
    """The reference decoder's parser name; returns full Frame objects."""
    return parse_frames(raw)


def smart_decompress(compressed_data: bytes) -> bytes:
    """The reference decoder's name for the tagged-container decompression
    of ``utils.compression.intelligent_decompress``."""
    return intelligent_decompress(compressed_data)


def find_frame_start(data: bytes, start_pos: int = 0) -> int:
    """Offset of an 0xAA preamble followed by the FBPC magic, or -1 (the
    parser itself scans every magic offset and does not call this)."""
    return data.find(b"\xAA\xAA\xAA\xAAFBPC", start_pos)


def _safe_name(name: str) -> str:
    return "".join(c for c in name if c.isalnum() or c in (" ", "-", "_", "."))


def recover_header_damaged(raw: bytes, already: List[Frame], stats: Optional[dict] = None) -> List[Frame]:
    """Recover frames whose header carries bit errors, the strict parser's
    blind spot: ``framing.scan_frame_candidates`` proposes candidates
    (fuzzy magic, tag anchors, CRC-recovered lengths) and one is promoted
    only when its as-read payload CRC matches (the JAX package's proof 1: the
    header alone was corrupt). Candidates with an FEC container wait for
    the FEC item and are skipped.

    ``already`` is the strict parser's valid frames; their (name, part)
    keys are never re-emitted, nor a frame equal to one already emitted
    (related names, same part, same payload or whole-file CRC). When the
    stream yields nothing at all, every bit shift under every quarter-turn
    relabeling (and the complemented stream, DBPSK's inversion) is scanned
    too: a corrupt magic defeats the demodulator's sync, which then packs
    from offset 0.
    """
    seen = {(f.name, f.part_number) for f in already}
    out: List[Frame] = []

    def emit(frame: Frame, how: str) -> None:
        if (frame.name, frame.part_number) in seen:
            return
        for f in list(already) + out:
            names_related = f.name.endswith(frame.name) or frame.name.endswith(f.name)
            if names_related and f.part_number == frame.part_number and (
                f.data == frame.data or (frame.file_crc and f.file_crc == frame.file_crc)
            ):
                return
        seen.add((frame.name, frame.part_number))
        out.append(frame)
        if stats is not None:
            stats["header_recoveries"] = stats.get("header_recoveries", 0) + 1
        logger.info("header-tolerant recovery (%s): %s part %d/%d",
                    how, frame.name, frame.part_number + 1, frame.total_parts)

    def scan_one(stream: bytes) -> None:
        # Plausible names first: a garbage-prefixed variant of the same
        # frame validates too, and the first emitted wins.
        cands = sorted(
            scan_frame_candidates(stream),
            key=lambda c: not all(32 <= ord(ch) < 127 for ch in c.frame.name),
        )
        validated_spans: List[Tuple[int, int]] = []
        for cand in cands:
            f = cand.frame
            payload = f.data
            if (f.name, f.part_number) in seen:
                continue
            if cand.payload_off >= 0 and any(
                cand.payload_off < e and s < cand.payload_off + len(payload) for s, e in validated_spans
            ):
                continue
            if crc32(payload) == cand.pcrc:
                emit(f, "pcrc")
                if cand.payload_off >= 0:
                    validated_spans.append((cand.payload_off, cand.payload_off + len(payload)))
            elif payload[:4] in _FEC_TAGS:
                logger.info("header-recovery candidate %s part %d carries an FEC container; its "
                            "proofs wait for %s", f.name, f.part_number, _FEC_ITEM)

    scan_one(raw)
    if not out and not already and len(raw) > 8:
        bits = np.unpackbits(np.frombuffer(raw, np.uint8))
        for k in range(4):
            for shift in range(8):
                if k == 0 and shift == 0:
                    continue  # the as-is stream, scanned above
                sh = bits[shift:]
                if k:
                    m = len(sh) // 2
                    hi, lo = sh[0 : 2 * m : 2], sh[1 : 2 * m : 2]
                    s2 = (2 * hi + (hi ^ lo) - k) % 4  # inverse Gray, rotated back
                    pair = np.empty((m, 2), np.uint8)
                    pair[:, 0] = s2 >= 2
                    pair[:, 1] = (s2 == 1) | (s2 == 2)
                    sh = pair.reshape(-1)
                scan_one(np.packbits(sh[: len(sh) & ~7]).tobytes())
                if out:
                    return out
        for shift in range(8):  # DBPSK k=2: the complemented bit stream
            sh = 1 - bits[shift:]
            scan_one(np.packbits(sh[: len(sh) & ~7]).tobytes())
            if out:
                return out
    return out


def save_decoded_files(
    frames: List[Frame],
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
    damaged: Optional[List[Frame]] = None,
) -> List[str]:
    """Persist parsed frames: single-part directly, multi-part via assembly.

    Completed multi-part files decompress-then-save just like single parts;
    expired assemblies are purged on every call. ``damaged`` frames (header
    intact, payload CRC failed) that carry an FEC container join the list,
    as in the JAX package, and like every FEC-tagged frame are logged and
    left unsaved until the FEC item lands.
    """
    reg = registry or default_registry
    os.makedirs(recv_dir, exist_ok=True)
    saved: List[str] = []
    frames = list(frames) + [f for f in damaged or [] if f.data[:4] in _FEC_TAGS]

    for frame in frames:
        if frame.data[:4] in _FEC_TAGS:
            logger.warning(
                "frame %s carries an FEC container, which the PyTorch port does not "
                "decode yet; left unsaved", frame.name,
            )
            continue
        try:
            if frame.is_multipart:
                # Parts are compressed one by one at encode time, so each is
                # decompressed before it joins the assembly.
                part_data = intelligent_decompress(frame.data)
                complete = reg.offer(
                    Frame(
                        frame.name,
                        part_data,
                        frame.part_number,
                        frame.total_parts,
                        frame.file_size,
                        frame.file_crc,
                    )
                )
                if complete is None:
                    continue
                final = complete
                base = frame.name.rsplit(".part", 1)[0]
            else:
                final = intelligent_decompress(frame.data)
                base = frame.name
                reg.stats["total_files"] += 1
                reg.stats["total_bytes"] += len(final)
                reg.stats["last_reception"] = time.time()
            path = os.path.join(recv_dir, f"recv_{int(time.time())}_{_safe_name(base)}")
            k = 1
            while os.path.exists(path):  # same name in the same second
                path = os.path.join(recv_dir, f"recv_{int(time.time())}_{k}_{_safe_name(base)}")
                k += 1
            with open(path, "wb") as f:
                f.write(final)
            saved.append(path)
        except Exception:
            logger.exception("failed to save decoded file %s", frame.name)

    reg.purge_expired()
    if frames:
        reg.stats["success_rate"] = (len(saved) / len(frames)) * 100
    return saved


def _nosync_streams(samples: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None) -> List[bytes]:
    """Full no-sync byte streams for the header-tolerant rescue (PSK
    family; DSSS waits for its item and gives none)."""
    from .ops.psk import psk8_nosync_streams, psk_nosync_streams
    from .parallel.batch import resolve_demod_plan

    try:
        kind, params = resolve_demod_plan(mode, symbol_rate)
        if kind not in ("psk2", "psk4", "psk8"):
            if kind == "dsss":
                logger.info("no-sync rescue of DSSS waits for ROADMAP.md queue 1, item 5 (DSSS)")
            return []
        baud, carrier = params
        if kind == "psk8":
            return psk8_nosync_streams(pad_to_bucket(samples), baud, carrier, SAMPLE_RATE, device=device)
        return psk_nosync_streams(pad_to_bucket(samples), baud, carrier, SAMPLE_RATE,
                                  2 if kind == "psk2" else 4, device=device)
    except Exception:
        logger.exception("no-sync rescue demod failed")
        return []


def run_recovery_ladder(
    raw: bytes,
    samples: np.ndarray,
    mode: str,
    symbol_rate: int,
    stats: Optional[dict] = None,
    rescue: bool = True,
    stream_fec: bool = False,
    device: DeviceLike = None,
) -> Tuple[List[Frame], List[Frame], bool, Tuple[int, int, int]]:
    """The post-demod recovery policy, shared by :func:`decode_from_buffer`
    and ``parallel.batch.decode_wav_batch``:

    1. stream FEC (``stream_fec``): raises NotImplementedError (FEC item);
    2. strict parse (``framing.parse_frames_detailed``; damaged frames are
       the header-intact, payload-CRC-failed ones);
    3. header-tolerant recovery (:func:`recover_header_damaged`); a
       validated recovery supersedes a damaged frame of the same (name,
       part);
    4. the no-sync rescue when nothing above found anything and ``rescue``
       is set: re-pack with no sync and sweep bit shifts x rotations;
    5. soft payload FEC: damaged ``FECV`` frames are logged and left (FEC
       item).

    Returns ``(frames_to_save, remaining_damaged, total_loss, counts)`` with
    ``counts = (n_valid, n_header_recovered, n_soft_recovered)``.
    """
    if stream_fec:
        raise NotImplementedError(f"stream FEC decoding is not ported: {_FEC_ITEM}")
    frames, damaged = parse_frames_detailed(raw)
    recovered = recover_header_damaged(raw, frames, stats=stats)
    total_loss = not frames and not damaged and not recovered
    if total_loss and rescue:
        for raw2 in _nosync_streams(samples, mode, symbol_rate, device=device):
            recovered = recover_header_damaged(raw2, [], stats=stats)
            if recovered:
                total_loss = False
                break
    rec_keys = {(f.name, f.part_number) for f in recovered}
    damaged = [d for d in damaged if (d.name, d.part_number) not in rec_keys]
    for d in damaged:
        if d.data[:4] == b"FECV":
            logger.info("damaged FECV frame %s part %d: the soft payload-FEC rung waits for %s",
                        d.name, d.part_number, _FEC_ITEM)
    return list(frames) + recovered, damaged, total_loss, (len(frames), len(recovered), 0)


def _prepare(data: np.ndarray, sample_rate: int, denoise: Optional[bool]) -> np.ndarray:
    samples = np.asarray(data, dtype=np.float32)
    if samples.ndim > 1:
        samples = samples[:, 0]
    if sample_rate != SAMPLE_RATE:
        samples = resample(samples, sample_rate, SAMPLE_RATE)
    if denoise is None:
        denoise = bool(CONFIG.get("modem.noise_reduction", False))
    if denoise:
        raise NotImplementedError(f"the spectral-gate denoiser (utils/denoise.py) is not ported: {_FEC_ITEM}")
    return samples


def decode_from_buffer(
    data: np.ndarray,
    mode: str,
    symbol_rate: int,
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
    sample_rate: int = SAMPLE_RATE,
    stream_fec: bool = False,
    denoise: Optional[bool] = None,
    device: DeviceLike = None,
) -> List[str]:
    """Demodulate a sample buffer on ``device`` (default: the card) and save
    every recovered file: mono-ize, resample to 96 kHz, bucket-pad,
    ``modem.demodulate``, :func:`run_recovery_ladder`, save. A failure in
    demodulation is logged and saves nothing, as in the JAX package."""
    samples = _prepare(data, sample_rate, denoise)
    if stream_fec:
        raise NotImplementedError(f"stream FEC decoding is not ported: {_FEC_ITEM}")
    try:
        raw = demodulate(mode, pad_to_bucket(samples), symbol_rate, device=device)
        reg = registry or default_registry
        frames, damaged, _total_loss, counts = run_recovery_ladder(
            raw, samples, mode, symbol_rate, stats=reg.stats, rescue=True, device=device,
        )
        logger.info(
            "demodulated %d bytes -> %d valid / %d damaged / %d header-recovered"
            " / %d soft-FEC-recovered frames",
            len(raw), counts[0], len(damaged), counts[1], counts[2],
        )
        return save_decoded_files(frames, recv_dir, registry, damaged=damaged)
    except NotImplementedError:
        raise
    except Exception:
        logger.exception("demodulation failed")
        return []


def decode_wav_file(
    path: str,
    mode: str,
    symbol_rate: int,
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
    stream_fec: bool = False,
    denoise: Optional[bool] = None,
    device: DeviceLike = None,
) -> List[str]:
    """Read a WAV file (any rate, any width) and decode it on ``device``."""
    data, sr = read_wav(path)
    return decode_from_buffer(
        data, mode, symbol_rate, recv_dir, registry, sample_rate=sr,
        stream_fec=stream_fec, denoise=denoise, device=device,
    )


RETRY_FACTORS = (1.0, 0.95, 1.05)


def drift_rows(samples: np.ndarray, factors: Sequence[float], m: int) -> np.ndarray:
    """(len(factors), m) rows, row i the capture resampled by stretch
    1/factors[i] (read at stride factors[i]): the exact inverse of a TX clock
    off by that factor, zero-padded to m."""
    n = len(samples)
    rows = np.zeros((max(len(factors), 1), m), dtype=np.float32)
    src = np.arange(n, dtype=np.float64)
    for i, f in enumerate(factors):
        s = 1.0 / f
        dst = np.arange(int(n / s), dtype=np.float64) * s
        row = np.interp(dst, src, samples).astype(np.float32)
        rows[i, : min(len(row), m)] = row[:m]
    return rows


def decode_with_retry(
    data: np.ndarray,
    mode: str,
    symbol_rate: int,
    max_retries: int = 3,
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
    dump_attempts: bool = True,
    stream_fec: bool = False,
    device: DeviceLike = None,
) -> List[str]:
    """Decode with up to 3 clock-drift hypotheses (1.0, 0.95, 1.05): the
    nominal hypothesis through the full single-capture receiver (with the
    no-sync rescue on total loss), then the others as rows of one
    ``decode_sample_batch`` dispatch, each capture resampled by the exact
    inverse of its drift. Each attempt's raw bytes are dumped to
    ``<recv_dir>/demodulated_attempt_N.bin``."""
    from .parallel.batch import decode_sample_batch

    if stream_fec:
        raise NotImplementedError(f"stream FEC decoding is not ported: {_FEC_ITEM}")
    samples = np.asarray(data, dtype=np.float32)
    factors = RETRY_FACTORS[:max_retries]
    reg = registry or default_registry

    def _dump(attempt: int, blob: bytes) -> None:
        if not dump_attempts:
            return
        try:
            os.makedirs(recv_dir, exist_ok=True)
            with open(os.path.join(recv_dir, f"demodulated_attempt_{attempt}.bin"), "wb") as f:
                f.write(blob)
        except OSError:
            pass

    def _parse_and_save(raw_bytes: bytes):
        """Strict parse + header-tolerant recovery, then save: ``(saved,
        total_loss)``, total loss meaning nothing parsed, damaged or
        recovered."""
        frames, damaged = parse_frames_detailed(raw_bytes)
        recovered = recover_header_damaged(raw_bytes, frames, stats=reg.stats)
        rec_keys = {(f.name, f.part_number) for f in recovered}
        damaged = [d for d in damaged if (d.name, d.part_number) not in rec_keys]
        if not frames and not damaged and not recovered:
            return [], True
        return save_decoded_files(frames + recovered, recv_dir, registry, damaged=damaged or None), False

    try:
        raw0 = demodulate(mode, pad_to_bucket(samples), symbol_rate, device=device)
        _dump(1, raw0)
        saved, total_loss = _parse_and_save(raw0)
        if saved:
            return saved
        if total_loss:
            for raw2 in _nosync_streams(samples, mode, symbol_rate, device=device):
                recovered = recover_header_damaged(raw2, [], stats=reg.stats)
                if recovered:
                    saved = save_decoded_files(recovered, recv_dir, registry)
                    if saved:
                        return saved
    except NotImplementedError:
        raise
    except Exception:
        logger.exception("nominal decode attempt failed; trying drift hypotheses")

    drift = [f for f in factors if f != 1.0]
    raws = []
    try:
        if drift:
            m = int(np.ceil(len(samples) * max(drift)))
            raws = decode_sample_batch(drift_rows(samples, drift, m), mode, symbol_rate, device=device)
    except NotImplementedError:
        raise
    except Exception:
        # Captures too short to batch (0 or 1 samples, under two symbols):
        # one single-capture decode per hypothesis at the scaled symbol rate.
        logger.exception("batched retry failed; falling back to sequential attempts")
        raws = []
        for factor in drift:
            rate = max(1, int(symbol_rate * factor))
            try:
                raws.append(demodulate(mode, pad_to_bucket(samples), rate, device=device))
            except NotImplementedError:
                raise
            except Exception:
                raws.append(b"")
    for i, raw in enumerate(raws):
        attempt = i + 2  # attempt 1 was the nominal full decode above
        _dump(attempt, raw)
        saved, _loss = _parse_and_save(raw)
        if saved:
            logger.info("retry hypothesis %d (clock factor %.2f) succeeded", attempt, drift[i])
            return saved
    logger.warning("all %d decode hypotheses failed", len(raws) + 1)
    return []


# --- observability -------------------------------------------------------------

def get_reception_stats(registry: Optional[AssemblyRegistry] = None) -> dict:
    return (registry or default_registry).get_stats()


def clear_reception_stats(registry: Optional[AssemblyRegistry] = None) -> None:
    (registry or default_registry).clear_stats()


def get_assembly_status(registry: Optional[AssemblyRegistry] = None) -> List[dict]:
    return (registry or default_registry).get_status()


def calculate_global_average_quality(registry: Optional[AssemblyRegistry] = None) -> float:
    return (registry or default_registry).average_quality()


def debug_demodulation(samples: np.ndarray, mode: str, symbol_rate: int) -> dict:
    """Sample statistics of a capture, logged and returned, for troubleshooting."""
    s = np.asarray(samples)
    info = {
        "mode": mode,
        "symbol_rate": symbol_rate,
        "n_samples": int(len(s)),
        "mean": float(np.mean(s)) if len(s) else 0.0,
        "std": float(np.std(s)) if len(s) else 0.0,
        "min": float(np.min(s)) if len(s) else 0.0,
        "max": float(np.max(s)) if len(s) else 0.0,
    }
    logger.info("debug_demodulation: %s", info)
    return info
