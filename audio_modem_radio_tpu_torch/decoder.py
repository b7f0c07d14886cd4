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
  the assembly registry; ``save_decoded_text`` for the text modes
  (``TEXT_MODES``, whose receive is the batched glyph match).

Payload FEC containers (``FECP``/``FECV``) unwrap on save, damaged ones
included; the header-tolerant rung proves candidates by their payload CRC,
by re-encoding a Viterbi decode, by the parity container's CRC trailer or by
the whole-file CRC of a self-terminating decompress; damaged ``FECV``
frames take the soft-decision Viterbi (``recover_payload_fec_soft``);
``stream_fec=True`` Viterbi-decodes the demodulated stream (with the soft
escalation) and ``denoise=True`` runs the spectral gate first. The Viterbi
runs on the card (``fec.viterbi_decode_bits``) or, for long containers, in
the native C++ sweep where that library built.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .assembly import AssemblyRegistry, registry as default_registry
from .config import CONFIG
from .fec import unwrap_fec
from .framing import Frame, crc32, parse_frames, parse_frames_detailed, scan_frame_candidates
from .modem import SAMPLE_RATE, demodulate
from .utils.compression import intelligent_decompress
from .utils.torchenv import DeviceLike, resolve_device
from .utils.wavio import read_wav, resample

logger = logging.getLogger("audio_modem_radio_tpu_torch")

RECV_DIR = "recv"


def _ensure_recv_dir(recv_dir: str = RECV_DIR) -> str:
    os.makedirs(recv_dir, exist_ok=True)
    return recv_dir


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


def _defec(payload: bytes, device: DeviceLike = None) -> bytes:
    """Transparently unwrap a tagged FEC container, if present."""
    decoded = unwrap_fec(payload, device=device)
    return payload if decoded is None else decoded


def recover_header_damaged(
    raw: bytes, already: List[Frame], stats: Optional[dict] = None, device: DeviceLike = None
) -> List[Frame]:
    """Recover frames whose header carries bit errors, the strict parser's
    blind spot: ``framing.scan_frame_candidates`` proposes candidates (fuzzy
    magic, FEC-tag anchors, CRC-recovered lengths) and one is promoted only
    on an exact integrity proof:

    1. the as-read payload CRC matches (only the header was corrupt);
    2. a Viterbi decode re-ENCODES to exactly the header's payload CRC;
    3. the parity container's CRC trailer verifies; or
    4. single-part frames: a self-terminating decompress of the FEC output
       matches the header's whole-file CRC (rescues a corrupt ``pcrc``).

    Validation work is bounded: a span cap on FEC decodes (4 MB where the
    native Viterbi sweep built, else 512 KB, which goes to the card's block
    decoder) and a budget of 4 decodes a call. ``already`` is the strict
    parser's valid frames; their (name, part) keys are never re-emitted, nor
    a frame equal to one already emitted (related names, same part, same
    payload or whole-file CRC). When the stream yields nothing at all, every
    bit shift under every quarter-turn relabeling (and the complemented
    stream, DBPSK's inversion) is scanned too: a corrupt magic defeats the
    demodulator's sync, which then packs from offset 0. Viterbi decodes run
    on ``device`` (default: the card).
    """
    from . import native as _native
    from .fec import TAG_PARITY, TAG_VITERBI, ConvolutionalEncoder, ReedSolomonFEC, ViterbiDecoder
    from .utils.compression import TAG_RAW, decompress_prefix

    seen = {(f.name, f.part_number) for f in already}
    out: List[Frame] = []
    max_fec_validate = (1 << 22) if _native.viterbi_available() else (1 << 19)
    budget = [4]

    def emit(frame: Frame, how: str) -> None:
        if (frame.name, frame.part_number) in seen:
            return
        # One frame, many anchor geometries: the first (longest-name,
        # strongest-proof) variant wins; names related as suffixes with the
        # same part and payload or whole-file CRC are the same frame.
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

        def validated(cand, payload) -> None:
            if cand.payload_off >= 0:
                validated_spans.append((cand.payload_off, cand.payload_off + len(payload)))

        for cand in cands:
            f = cand.frame
            payload = f.data
            # Cheap rejections first: a key already valid, or a span already
            # validated in this scan (anchor variants of one frame).
            if (f.name, f.part_number) in seen:
                continue
            if cand.payload_off >= 0 and any(
                cand.payload_off < e and s < cand.payload_off + len(payload) for s, e in validated_spans
            ):
                continue
            try:
                if crc32(payload) == cand.pcrc:  # 1.
                    emit(f, "pcrc")
                    validated(cand, payload)
                    continue
                if payload[:4] not in (TAG_VITERBI, TAG_PARITY):
                    continue  # no FEC container: nothing left to prove with
                if len(payload) > max_fec_validate:
                    logger.info("header-recovery candidate %s part %d skipped: %d-byte span exceeds the "
                                "FEC-validation cap (%d)", f.name, f.part_number, len(payload), max_fec_validate)
                    continue
                if budget[0] <= 0:
                    logger.info("header-recovery FEC-validation budget exhausted")
                    continue
                # Only candidates that reach a decoder consume the budget.
                budget[0] -= 1
                if payload[:4] == TAG_VITERBI:
                    decoded = ViterbiDecoder(device=device).decode(payload[4:])
                    if not decoded:
                        continue
                    rewrap = TAG_VITERBI + ConvolutionalEncoder().encode(decoded)
                    if crc32(rewrap) == cand.pcrc:  # 2.
                        emit(Frame(f.name, rewrap, f.part_number, f.total_parts, f.file_size, f.file_crc),
                             "fec-reencode")
                        validated(cand, payload)
                        continue
                else:
                    rs = ReedSolomonFEC()
                    decoded = rs.decode(payload[4:])
                    if getattr(rs, "last_crc_ok", False):  # 3.
                        emit(Frame(f.name, TAG_PARITY + rs.encode(decoded), f.part_number, f.total_parts,
                                   f.file_size, f.file_crc), "fec-crc")
                        validated(cand, payload)
                        continue
                # 4. pcrc corrupt too: the FEC output's self-terminating
                #    decompress against the whole-file CRC.
                if f.is_multipart or not f.file_crc:
                    continue
                final = decompress_prefix(decoded, f.file_size)
                if final is not None and crc32(final) == f.file_crc:
                    emit(Frame(f.name, TAG_RAW + final, f.part_number, f.total_parts, f.file_size, f.file_crc),
                         "fcrc")
                    validated(cand, payload)
            except Exception:
                logger.debug("candidate validation failed", exc_info=True)

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


# The glyph-fax modes decode to text, not an FBPC byte stream: both receive
# paths (decode_from_buffer and parallel.batch.decode_wav_batch) take the
# batched glyph match and save the text.
TEXT_MODES = ("HELLSCHREIBER", "FELD_HELL", "SLOW_HELL")


def save_decoded_text(text: str, recv_dir: str = RECV_DIR, stem: str = "hell") -> str:
    """Persist a decoded text-mode transmission as recv_<ts>_<stem>.txt."""
    out_dir = _ensure_recv_dir(recv_dir)
    path = os.path.join(out_dir, f"recv_{int(time.time())}_{_safe_name(stem)}.txt")
    k = 0
    while os.path.exists(path):
        k += 1
        path = os.path.join(out_dir, f"recv_{int(time.time())}_{k}_{_safe_name(stem)}.txt")
    with open(path, "w", encoding="ascii") as f:
        f.write(text)
    return path


def save_decoded_files(
    frames: List[Frame],
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
    damaged: Optional[List[Frame]] = None,
    device: DeviceLike = None,
) -> List[str]:
    """Persist parsed frames: single-part directly, multi-part via assembly.

    Completed multi-part files decompress-then-save just like single parts;
    expired assemblies are purged on every call. Payloads in an FEC
    container unwrap first (a ``FECV`` container's Viterbi on ``device``,
    default the card). ``damaged`` frames (header intact, payload CRC
    failed) join the list when their payload carries an FEC container tag,
    each counted in the registry's ``fec_recovery_attempts``.
    """
    reg = registry or default_registry
    os.makedirs(recv_dir, exist_ok=True)
    saved: List[str] = []

    frames = list(frames)
    for frame in damaged or []:
        if frame.data[:4] in (b"FECP", b"FECV"):
            logger.info("attempting FEC recovery of damaged frame %s", frame.name)
            frames.append(frame)
            reg.stats.setdefault("fec_recovery_attempts", 0)
            reg.stats["fec_recovery_attempts"] += 1

    for frame in frames:
        try:
            if frame.is_multipart:
                # Parts are compressed one by one at encode time, so each is
                # decompressed before it joins the assembly.
                part_data = intelligent_decompress(_defec(frame.data, device))
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
                final = intelligent_decompress(_defec(frame.data, device))
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
    """Full no-sync byte streams for the header-tolerant rescue (the PSK
    family and DSSS)."""
    from .ops.dsss import dsss_nosync_streams
    from .ops.psk import psk8_nosync_streams, psk_nosync_streams
    from .parallel.batch import resolve_demod_plan

    try:
        kind, params = resolve_demod_plan(mode, symbol_rate)
        if kind not in ("psk2", "psk4", "psk8", "dsss"):
            return []
        baud, carrier = params
        if kind == "dsss":
            return dsss_nosync_streams(pad_to_bucket(samples), baud, carrier, SAMPLE_RATE, device=device)
        if kind == "psk8":
            return psk8_nosync_streams(pad_to_bucket(samples), baud, carrier, SAMPLE_RATE, device=device)
        return psk_nosync_streams(pad_to_bucket(samples), baud, carrier, SAMPLE_RATE,
                                  2 if kind == "psk2" else 4, device=device)
    except Exception:
        logger.exception("no-sync rescue demod failed")
        return []


def recover_payload_fec_soft(
    raw: bytes,
    samples: np.ndarray,
    mode: str,
    symbol_rate: int,
    damaged: List[Frame],
    stats: Optional[dict] = None,
    device: DeviceLike = None,
) -> List[Frame]:
    """Soft-decision recovery of damaged FECV payloads (every carried
    non-text family), on ``device`` (default: the card).

    The damaged frame's header parsed intact, so its exact header bytes are
    located in ``raw`` (for the true pcrc field), then re-found in the soft
    stream's thresholded bits at each bit shift and residual-rotation
    hypothesis. The payload's coded soft pairs run through the soft Viterbi,
    and a candidate is accepted ONLY on an exact proof: re-encoding the
    decode must reproduce a container whose CRC32 equals the header's
    payload CRC. Returns repaired (now CRC-valid) frames; callers drop the
    matching damaged entries.
    """
    from .fec import TAG_VITERBI, ConvolutionalEncoder, ViterbiDecoder
    from .framing import MAGIC, _META

    def _fecv_like(blob: bytes) -> bool:
        # The container tag rides the same noisy channel as the payload: a
        # <=8-of-32-bit Hamming gate admits it (random 4 bytes pass with
        # p~3e-3), and the exact re-encode CRC proof rules out the rest.
        if len(blob) < 4:
            return False
        dist = int(np.unpackbits(np.frombuffer(blob[:4], np.uint8) ^ np.frombuffer(TAG_VITERBI, np.uint8)).sum())
        return dist <= 8

    todo = [d for d in damaged if _fecv_like(d.data)]
    if not todo:
        return []
    try:
        got = _soft_bit_stream(np.asarray(samples, np.float32), mode, symbol_rate, device)
        if got is None:
            return []
        rotations, _n_psk = got
    except Exception:
        logger.exception("soft payload-FEC demod failed")
        return []

    out: List[Frame] = []
    for frame in todo:
        # The header bytes, verbatim from the hard stream (incl. true pcrc).
        nb = frame.name.encode("utf-8", "ignore")
        probe = MAGIC + bytes([len(nb)]) + nb
        h_start = raw.find(probe)
        header = None
        while h_start != -1:
            meta_start = h_start + len(probe)
            if meta_start + _META.size <= len(raw):
                part, total, fsize, fcrc, dlen, pcrc = _META.unpack(raw[meta_start : meta_start + _META.size])
                if (part, total, dlen) == (frame.part_number, frame.total_parts, len(frame.data)):
                    header = raw[h_start : meta_start + _META.size]
                    break
            h_start = raw.find(probe, h_start + 1)
        if header is None:
            continue
        n_data = max(0, (dlen - 4 - 2) // 2)
        n_coded_bits = 16 * n_data + 12
        if n_data == 0 or 4 * 8 + n_coded_bits > dlen * 8:
            continue
        done = False
        for s_k in rotations:
            if done:
                break
            hard = (s_k > 0.5).astype(np.uint8)
            for shift in range(8):
                usable = (len(hard) - shift) // 8 * 8
                packed = np.packbits(hard[shift : shift + usable]).tobytes()
                idx = packed.find(header)
                if idx == -1:
                    continue
                pos = shift + (idx + len(header)) * 8 + 4 * 8  # skip the FECV tag
                n_full = (n_coded_bits // 8) * 8
                rem = n_coded_bits - n_full
                if pos + n_full + 8 > len(s_k):
                    continue
                # Reference-style packing: the trailing partial byte keeps its
                # bits in the LOW positions -> wire offset (8 - rem) into the byte.
                coded = np.concatenate(
                    [s_k[pos : pos + n_full], s_k[pos + n_full + (8 - rem) : pos + n_full + 8]]
                )
                bits = ViterbiDecoder(device=device).decode_pairs(coded.reshape(-1, 2))
                data = np.packbits(bits[: n_data * 8]).tobytes()
                rebuilt = TAG_VITERBI + ConvolutionalEncoder().encode(data)
                if len(rebuilt) == dlen and crc32(rebuilt) == pcrc:
                    out.append(Frame(frame.name, rebuilt, frame.part_number, frame.total_parts,
                                     frame.file_size, frame.file_crc))
                    if stats is not None:
                        stats["soft_fec_recoveries"] = stats.get("soft_fec_recoveries", 0) + 1
                    logger.info("soft payload-FEC recovery: %s part %d/%d",
                                frame.name, frame.part_number + 1, frame.total_parts)
                    done = True
                    break
    return out


def _soft_rotation_variants(soft: np.ndarray, n_psk: int) -> List[np.ndarray]:
    """Expand one soft stream into its residual-rotation hypotheses.

    The blind CFO derotation leaves a k·π/2 (DQPSK) or inversion (DBPSK)
    ambiguity; on soft values a quarter turn is exactly ``(hi, lo) ->
    (1-lo, hi)`` and an inversion is ``1-x``. Element 0 is the as-produced
    (k=0) stream."""
    rotations = [soft]
    s_k = soft
    for _k in range(3 if n_psk == 4 else (1 if n_psk == 2 else 0)):
        if n_psk == 4:
            hi, lo = s_k[0::2], s_k[1::2]
            nxt = np.empty_like(s_k)
            nxt[0::2], nxt[1::2] = 1.0 - lo, hi
            s_k = nxt
        else:
            s_k = 1.0 - s_k
        rotations.append(s_k)
    return rotations


def _soft_bit_stream(samples: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None):
    """Soft bit streams of every non-text family on ``device``, else None.

    Returns ``(rotations, n_psk)``: a list of [0,1] soft streams, one per
    residual-rotation hypothesis of the family (element 0 = k=0), and the
    family's constellation order (1 for FSK: no ambiguity). OFDM dibits take
    the DQPSK diagonal mapping and DSSS bits the DBPSK one; D8PSK enumerates
    its 8 π/4 hypotheses at the producer. The compatibility aliases map to
    the wire format they transmit. NEURAL and HELL have no soft stream
    (None), as in the JAX package."""
    from .ops.dsss import dsss_soft_bits
    from .ops.fsk import fsk_soft_bits
    from .ops.ofdm import ofdm_soft_bits
    from .ops.psk import psk8_soft_bits_rotations, psk_soft_bits
    from .parallel.batch import _receive_kind

    kind, params = _receive_kind(mode, symbol_rate)
    x = pad_to_bucket(samples)
    if kind in ("psk2", "psk4"):
        n_psk = 2 if kind == "psk2" else 4
        return _soft_rotation_variants(psk_soft_bits(x, *params, SAMPLE_RATE, n_psk, device=device), n_psk), n_psk
    if kind == "ofdm":
        baud, carrier, n_sub = params
        return _soft_rotation_variants(ofdm_soft_bits(x, baud, carrier, int(n_sub), SAMPLE_RATE, device=device), 4), 4
    if kind == "dsss":
        return _soft_rotation_variants(dsss_soft_bits(x, *params, SAMPLE_RATE, device=device), 2), 2
    if kind == "psk8":
        return psk8_soft_bits_rotations(x, *params, SAMPLE_RATE, device=device), 8
    if kind == "fsk":
        return [fsk_soft_bits(x, *params, SAMPLE_RATE, device=device)], 1
    return None


def _stream_fec_soft(samples: np.ndarray, mode: str, symbol_rate: int, device: DeviceLike = None):
    """Soft-decision stream-FEC decode for any carried non-text family, else None."""
    from .fec import stream_fec_decode_soft

    try:
        got = _soft_bit_stream(samples, mode, symbol_rate, device)
        if got is None:
            return None
        rotations, _n_psk = got
        # Rotation gate: the coded stream leads with a plaintext sync magic;
        # a residual rotation scrambles it, so only the hypothesis whose
        # thresholded bits contain the magic is worth a full Viterbi pass
        # (k=0 when none does: the decoder still self-aligns on its own scan).
        magic = np.unpackbits(np.frombuffer(b"FBPC", np.uint8))
        pick = rotations[0]
        for soft in rotations:
            hard = (soft > 0.5).astype(np.uint8)
            if len(hard) > len(magic):
                win = np.lib.stride_tricks.sliding_window_view(hard, len(magic))
                if (win == magic).all(axis=1).any():
                    pick = soft
                    break
        return stream_fec_decode_soft(pick, device=device)
    except Exception:
        logger.exception("soft stream-FEC decode failed")
        return None


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

    1. stream-FEC decode (when ``stream_fec``), and the soft-decision
       Viterbi escalation when the hard decode yields no leading magic;
    2. strict parse: the native scanner when it built (the same contract as
       ``framing.parse_frames_detailed``; damaged frames are the
       header-intact, payload-CRC-failed ones);
    3. header-tolerant recovery (:func:`recover_header_damaged`); a
       validated recovery supersedes a damaged frame of the same (name,
       part);
    4. the no-sync rescue when nothing above found anything and ``rescue``
       is set: re-pack with no sync and sweep bit shifts x rotations
       (skipped under ``stream_fec``: those streams are pre-FEC wire bytes);
    5. soft payload FEC for damaged ``FECV`` frames
       (:func:`recover_payload_fec_soft`).

    Every Viterbi and soft demodulation runs on ``device`` (default: the
    card). Returns ``(frames_to_save, remaining_damaged, total_loss,
    counts)`` with ``counts = (n_valid, n_header_recovered,
    n_soft_recovered)``.
    """
    from .native import NATIVE_AVAILABLE, scan_frames

    if stream_fec:
        from .fec import stream_fec_decode

        raw = stream_fec_decode(raw, device=device)
        if not raw.startswith(b"FBPC"):
            soft_raw = _stream_fec_soft(samples, mode, symbol_rate, device)
            if soft_raw is not None and soft_raw.startswith(b"FBPC"):
                raw = soft_raw
    if NATIVE_AVAILABLE:
        frames, damaged = scan_frames(raw)
        frames, damaged = list(frames), list(damaged)
    else:
        frames, damaged = parse_frames_detailed(raw)
    recovered = recover_header_damaged(raw, frames, stats=stats, device=device)
    total_loss = not frames and not damaged and not recovered
    if total_loss and rescue and not stream_fec:
        for raw2 in _nosync_streams(samples, mode, symbol_rate, device=device):
            recovered = recover_header_damaged(raw2, [], stats=stats, device=device)
            if recovered:
                total_loss = False
                break
    rec_keys = {(f.name, f.part_number) for f in recovered}
    damaged = [d for d in damaged if (d.name, d.part_number) not in rec_keys]
    soft_rec = recover_payload_fec_soft(raw, samples, mode, symbol_rate, damaged, stats=stats, device=device)
    soft_keys = {(f.name, f.part_number) for f in soft_rec}
    damaged = [d for d in damaged if (d.name, d.part_number) not in soft_keys]
    counts = (len(frames), len(recovered), len(soft_rec))
    return list(frames) + recovered + soft_rec, damaged, total_loss, counts


def _prepare(data: np.ndarray, sample_rate: int, denoise: Optional[bool], device: DeviceLike) -> np.ndarray:
    """Mono-ize, resample to 96 kHz and, with ``denoise`` (None: CONFIG
    ``modem.noise_reduction``), run the spectral gate on ``device``."""
    from .utils.denoise import spectral_gate

    samples = np.asarray(data, dtype=np.float32)
    if samples.ndim > 1:
        samples = samples[:, 0]
    if sample_rate != SAMPLE_RATE:
        samples = resample(samples, sample_rate, SAMPLE_RATE)
    if denoise is None:
        denoise = bool(CONFIG.get("modem.noise_reduction", False))
    if denoise:
        samples = spectral_gate(samples, device=device)
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
    every recovered file: mono-ize, resample to 96 kHz, with ``denoise`` the
    spectral gate (None defers to CONFIG ``modem.noise_reduction``),
    bucket-pad, ``modem.demodulate``, :func:`run_recovery_ladder` (with
    ``stream_fec``, the stream Viterbi-decoded first: transmissions made
    with ``fec_type="stream"``), save. A failure in demodulation is logged
    and saves nothing, as in the JAX package; a missing card is not such a
    failure and raises (``utils.torchenv.resolve_device``). The text modes take the
    batched glyph match (its sync gate and first-all-on-row stop rule on
    the bucket-padded capture) and save the text, when there is any."""
    device = resolve_device(device)  # no card: raise here, never decode on the CPU
    samples = _prepare(data, sample_rate, denoise, device)
    if mode in TEXT_MODES:
        from .ops.hell import hellschreiber_demodulate_batch

        baud = 61.25 if mode == "SLOW_HELL" else 122.5
        text = hellschreiber_demodulate_batch(pad_to_bucket(samples)[None, :], baud, device=device)[0]
        if not text.strip():
            return []
        return [save_decoded_text(text, recv_dir, mode.lower())]
    try:
        raw = demodulate(mode, pad_to_bucket(samples), symbol_rate, device=device)
        reg = registry or default_registry
        frames, damaged, _total_loss, counts = run_recovery_ladder(
            raw, samples, mode, symbol_rate, stats=reg.stats, rescue=True, stream_fec=stream_fec, device=device,
        )
        logger.info(
            "demodulated %d bytes -> %d valid / %d damaged / %d header-recovered"
            " / %d soft-FEC-recovered frames",
            len(raw), counts[0], len(damaged), counts[1], counts[2],
        )
        return save_decoded_files(frames, recv_dir, registry, damaged=damaged, device=device)
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
    no-sync rescue on total loss, except under ``stream_fec``), then the
    others as rows of one ``decode_sample_batch`` dispatch, each capture
    resampled by the exact inverse of its drift. With ``stream_fec`` each
    attempt's stream is Viterbi-decoded before parsing. Each attempt's raw
    bytes (before that decode) are dumped to
    ``<recv_dir>/demodulated_attempt_N.bin``."""
    from .parallel.batch import decode_sample_batch

    from .fec import stream_fec_decode

    device = resolve_device(device)  # no card: raise here, never decode on the CPU
    samples = np.asarray(data, dtype=np.float32)
    factors = RETRY_FACTORS[:max_retries]
    reg = registry or default_registry

    def _post(raw_bytes: bytes) -> bytes:
        return stream_fec_decode(raw_bytes, device=device) if stream_fec else raw_bytes

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
        recovered = recover_header_damaged(raw_bytes, frames, stats=reg.stats, device=device)
        rec_keys = {(f.name, f.part_number) for f in recovered}
        damaged = [d for d in damaged if (d.name, d.part_number) not in rec_keys]
        if not frames and not damaged and not recovered:
            return [], True
        return save_decoded_files(frames + recovered, recv_dir, registry, damaged=damaged or None,
                                  device=device), False

    try:
        raw0 = demodulate(mode, pad_to_bucket(samples), symbol_rate, device=device)
        _dump(1, raw0)
        saved, total_loss = _parse_and_save(_post(raw0))
        if saved:
            return saved
        if total_loss and not stream_fec:
            for raw2 in _nosync_streams(samples, mode, symbol_rate, device=device):
                recovered = recover_header_damaged(raw2, [], stats=reg.stats, device=device)
                if recovered:
                    saved = save_decoded_files(recovered, recv_dir, registry, device=device)
                    if saved:
                        return saved
    except Exception:
        logger.exception("nominal decode attempt failed; trying drift hypotheses")

    drift = [f for f in factors if f != 1.0]
    raws = []
    try:
        if drift:
            m = int(np.ceil(len(samples) * max(drift)))
            raws = decode_sample_batch(drift_rows(samples, drift, m), mode, symbol_rate, device=device)
    except Exception:
        # Captures too short to batch (0 or 1 samples, under two symbols):
        # one single-capture decode per hypothesis at the scaled symbol rate.
        logger.exception("batched retry failed; falling back to sequential attempts")
        raws = []
        for factor in drift:
            rate = max(1, int(symbol_rate * factor))
            try:
                raws.append(demodulate(mode, pad_to_bucket(samples), rate, device=device))
            except Exception:
                raws.append(b"")
    for i, raw in enumerate(raws):
        attempt = i + 2  # attempt 1 was the nominal full decode above
        _dump(attempt, raw)
        saved, _loss = _parse_and_save(_post(raw))
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
