"""FBPC wire-frame format: pack and parse.

This module defines the byte-level frame layout shared with the reference
implementation so that WAVs produced by either side decode on the other:

    b'FBPC' | u8 name_len | name (<=255 B utf-8) | LE u32 part_number
    | LE u32 total_parts | LE u32 file_size | LE u32 file_crc
    | LE u32 data_len | LE u32 part_crc | payload[data_len]

Layout and semantics follow the reference encoder's ``_frame_data``
(reference encoder.py:94-114) and the scan-all-magic-offsets parser with a
50 MB payload sanity bound and per-part CRC32 verification
(reference decoder.py:142-208). Unlike the reference parser — which drops
the part/total/file_size metadata on the floor and returns only
``{name, data, final_crc}``, breaking multi-part reassembly
(decoder.py:197-201 vs 249) — ``parse_frames`` returns the complete header so
the assembly layer actually works.
"""

from __future__ import annotations

import binascii
import logging
import struct
from dataclasses import dataclass
from typing import List, Set, Tuple

import numpy as np

logger = logging.getLogger("audio_modem_radio_tpu_torch")

MAGIC = b"FBPC"
# First 16 bits of the magic, used by the demodulators for bit alignment
# (same pattern the reference searches for, reference modem.py:116-118).
MAGIC_BIT_PATTERN = "0100011001000010"
# The NEXT 16 magic bits ("PC"): sync validation — a candidate position
# only counts when these also roughly follow (tolerant Hamming match), which
# keeps random-data false sync fires from relabeling whole captures.
MAGIC_BIT_PATTERN2 = "0101000001000011"
MAX_PAYLOAD = 50_000_000  # parser sanity bound (reference decoder.py:184)
# Parts sanity bound: a single corrupt bit in the header's ``total`` field
# (e.g. 1 -> 0x40000001) must not drive an ~8 GB ``[None] * total`` assembly
# allocation. 16384 parts x 50 MB payloads is far past any real transfer.
MAX_PARTS = 16384
_META = struct.Struct("<IIIIII")  # part, total, fsize, fcrc, dlen, pcrc


def crc32(data: bytes) -> int:
    return binascii.crc32(data) & 0xFFFFFFFF


@dataclass(frozen=True)
class Frame:
    """A parsed FBPC frame with its full header."""

    name: str
    data: bytes
    part_number: int
    total_parts: int
    file_size: int
    file_crc: int

    @property
    def is_multipart(self) -> bool:
        return self.total_parts > 1

    # Reference-parser-compatible accessor (decoder.py:197-201 keys the whole-
    # file CRC as 'final_crc').
    @property
    def final_crc(self) -> int:
        return self.file_crc


def pack_frame(
    name: str,
    data: bytes,
    part_number: int = 0,
    total_parts: int = 1,
    file_size: int = 0,
    file_crc: int = 0,
) -> bytes:
    """Serialize one frame. ``data`` is the (possibly compressed) payload."""
    name_b = name.encode("utf-8")[:255]
    part_crc = crc32(data)
    return b"".join(
        (
            MAGIC,
            bytes([len(name_b)]),
            name_b,
            _META.pack(part_number, total_parts, file_size, file_crc, len(data), part_crc),
            data,
        )
    )


def parse_frames(raw: bytes) -> List[Frame]:
    """Scan ``raw`` for every FBPC frame candidate and return CRC-valid frames.

    Searches every magic offset (overlapping offsets included), applies the
    header sanity checks, and keeps only frames whose payload CRC32 verifies —
    the same accept/reject policy as the reference parser, but returning the
    full header needed for multi-part reassembly.
    """
    return parse_frames_detailed(raw)[0]


def parse_frames_detailed(raw: bytes) -> tuple:
    """Like :func:`parse_frames` but also returns header-sane frames whose
    payload CRC failed — candidates for FEC recovery. Returns
    ``(valid_frames, damaged_frames)``."""
    frames: List[Frame] = []
    damaged: List[Frame] = []
    n = len(raw)
    offset = 0
    while True:
        start = raw.find(MAGIC, offset)
        if start == -1:
            break
        offset = start + 1

        # Minimum frame: magic(4) + name_len(1) + name(>=1) + meta(24)
        if start + 30 > n:
            continue
        name_len = raw[start + 4]
        if name_len == 0:
            continue
        name_start = start + 5
        meta_start = name_start + name_len
        if meta_start + _META.size > n:
            continue
        name = raw[name_start:meta_start].decode("utf-8", "ignore")
        part, total, fsize, fcrc, dlen, pcrc = _META.unpack(
            raw[meta_start : meta_start + _META.size]
        )
        if dlen == 0 or dlen > MAX_PAYLOAD:
            continue
        payload_start = meta_start + _META.size
        if payload_start + dlen > n:
            continue
        payload = raw[payload_start : payload_start + dlen]
        if total == 0 or total > MAX_PARTS or part >= total:
            # Inconsistent/absurd part indices; reject rather than corrupt
            # (or unboundedly allocate) an assembly slot.
            continue
        frame = Frame(name, payload, part, total, fsize, fcrc)
        if crc32(payload) == pcrc:
            frames.append(frame)
        else:
            damaged.append(frame)
    return frames, damaged


# --- header-tolerant recovery scan --------------------------------------------
#
# The strict parser above requires an EXACT magic and a sane, as-read header.
# At low SNR that is the weak link of payload FEC: the convolutional container
# can heal a payload riddled with bit errors, but a single flipped bit in the
# ~30 plaintext header bytes (magic, name_len, dlen...) makes the frame
# invisible to the parser and the FEC never runs. (The reference has no
# recovery story at all — its parser needs byte-perfect headers AND payloads,
# reference decoder.py:142-208.) The scan below finds frame CANDIDATES
# under header corruption; the decoder validates each candidate by actually
# running the FEC and checking an exact integrity proof (fec re-encode CRC /
# container CRC / whole-file CRC), so false candidates cost microseconds and
# never produce output files.

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)
_FEC_TAGS = (b"FECP", b"FECV")


def fuzzy_magic_positions(raw: bytes, max_bit_errors: int = 2) -> np.ndarray:
    """Offsets whose 4-byte window is within ``max_bit_errors`` bits of FBPC.

    Vectorized: XOR every window with the magic and popcount via table
    lookup — one pass over the stream, no Python loop.
    """
    n = len(raw)
    if n < len(MAGIC):
        return np.empty(0, np.int64)
    arr = np.frombuffer(raw, np.uint8)
    magic = np.frombuffer(MAGIC, np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(arr, len(MAGIC))
    dist = _POPCOUNT[win ^ magic].sum(axis=1, dtype=np.uint8)  # max 32 < 256
    return np.nonzero(dist <= max_bit_errors)[0]


@dataclass(frozen=True)
class FrameCandidate:
    """A header-damaged frame candidate awaiting FEC validation.

    ``pcrc`` is the as-read payload CRC field (itself possibly corrupt);
    ``exact_magic`` records whether the magic matched byte-exact.
    ``payload_off`` is the payload's byte offset in the scanned stream —
    overlapping anchor geometries describe the same frame region, and the
    validator uses the offsets to skip re-decoding a span it already
    validated (a multi-MB Viterbi sweep per variant otherwise multiplies
    the recovery cost by the variant count).
    """

    frame: Frame
    pcrc: int
    exact_magic: bool
    payload_off: int = -1


_CRC_SCAN_CAP = 4 << 20  # bound the per-candidate prefix-CRC scan


def _find_dlen_by_crc(raw: bytes, payload_start: int, pcrc: int, span: int) -> int:
    """Recover a corrupt ``dlen`` from an intact ``pcrc``: the payload is the
    unique prefix of the span whose CRC32 equals the header's payload CRC.
    One incremental pass (CRC32 is a running update); returns 0 if no prefix
    matches within the (capped) span. The native runtime does the scan at
    zlib speed (~100x the Python loop) when available."""
    end = payload_start + min(span, _CRC_SCAN_CAP)
    try:
        from .native import crc32_prefix_find

        n = crc32_prefix_find(bytes(raw[payload_start:end]), pcrc)
        if n is not None:
            return n
    except Exception:  # pragma: no cover - native layer optional
        pass
    view = memoryview(raw)
    crc = 0
    for i in range(payload_start, end):
        crc = binascii.crc32(view[i : i + 1], crc)
        if crc == pcrc:
            return i + 1 - payload_start
    return 0


def _sane_geometry(raw: bytes, start: int, name_len: int, dlen: int) -> bool:
    n = len(raw)
    if name_len == 0 or dlen == 0 or dlen > MAX_PAYLOAD:
        return False
    payload_start = start + 5 + name_len + _META.size
    return payload_start + dlen <= n


def scan_frame_candidates(
    raw: bytes, max_bit_errors: int = 2, limit: int = 256
) -> List[FrameCandidate]:
    """Scan for frames whose header may carry bit errors.

    Two independent anchors locate each candidate:

    1. **Fuzzy magic** — any 4-byte window within ``max_bit_errors`` of FBPC.
    2. **FEC-container tag** — when the payload is FEC-wrapped, its first 4
       bytes are the known plaintext ``FECP``/``FECV``. An exact tag at
       offset ``p`` pins the header geometry (``meta`` ends at ``p``), which
       rescues candidates whose ``name_len`` byte is corrupt: the implied
       ``name_len`` is recomputed from the tag position instead of trusted
       from the wire.

    For each anchor the payload length is tried as (a) the as-read ``dlen``
    when sane, and (b) the span to the next candidate magic / end of stream
    (rescues a corrupt ``dlen``). Candidates that the strict parser already
    emits (exact magic + sane as-read geometry) are skipped. Inconsistent
    part indices are healed to single-part rather than rejected — validation
    downstream is cryptographic, not heuristic. At most ``limit`` candidates
    are returned (a garbage stream can otherwise explode combinatorially).
    """
    n = len(raw)
    out: List[FrameCandidate] = []
    seen: Set[Tuple[int, int, int]] = set()
    mpos = fuzzy_magic_positions(raw, max_bit_errors)
    mpos_list = [int(p) for p in mpos]
    exact_set = {p for p in mpos_list if raw[p : p + 4] == MAGIC}

    # FEC-tag anchors: implied (start, name_len) for every tag position and
    # plausible name length such that a fuzzy magic sits at the implied start.
    # When NO fuzzy magic exists at the implied start — the 16 sync bits died
    # outright, the exact case the no-sync re-pack sweep hands here — the tag
    # anchors STANDALONE, gated on a printable implied name (filenames are
    # ASCII in practice; this bounds junk candidates on garbage streams, and
    # promotion downstream stays cryptographic either way).
    tag_anchor: dict = {}  # start -> implied name_len (fuzzy magic at start)
    tag_alone: dict = {}  # start -> implied name_len (tag-only anchor)
    mpos_set = set(mpos_list)
    # Work bound: each tag occurrence costs up to 255 name-slice printability
    # scans (~32 KB of byte checks). Natural streams carry a handful of tag
    # occurrences (p ~ n/2^32 for random bytes), but a tag-DENSE stream
    # (adversarial RF, or a pathological capture of repeated tag bytes) must
    # not stall the decode — the recovery ladder promises bounded work. Caps
    # chosen far above any legitimate multi-frame capture.
    _MAX_TAG_HITS = 512
    _MAX_TAG_ALONE = 4 * limit
    tag_hits = 0
    for tag in _FEC_TAGS:
        t = raw.find(tag)
        while t != -1 and tag_hits < _MAX_TAG_HITS:
            tag_hits += 1
            for nl in range(1, 256):
                s = t - _META.size - nl - 5
                if s < 0:
                    break
                if s in mpos_set:
                    tag_anchor.setdefault(s, nl)
                elif len(tag_alone) < _MAX_TAG_ALONE:
                    name = raw[s + 5 : s + 5 + nl]
                    if name and all(32 <= c < 127 for c in name):
                        tag_alone.setdefault(s, nl)
            t = raw.find(tag, t + 1)

    def add(start: int, name_len: int, dlen: int) -> None:
        if len(out) >= limit or not _sane_geometry(raw, start, name_len, dlen):
            return
        key = (start, name_len, dlen)
        if key in seen:
            return
        seen.add(key)
        name_start = start + 5
        meta_start = name_start + name_len
        name = raw[name_start:meta_start].decode("utf-8", "ignore")
        part, total, fsize, fcrc, _dlen_raw, pcrc = _META.unpack(
            raw[meta_start : meta_start + _META.size]
        )
        if total == 0 or total > MAX_PARTS or part >= total:
            part, total = 0, 1  # heal — downstream validation is exact
        payload = raw[meta_start + _META.size : meta_start + _META.size + dlen]
        out.append(
            FrameCandidate(
                Frame(name, payload, part, total, fsize, fcrc),
                pcrc,
                start in exact_set,
                meta_start + _META.size,
            )
        )

    # Prefix-CRC scans are a per-byte Python loop (~0.3 us/byte); bound the
    # TOTAL bytes scanned per call so damaged frames with long noise tails
    # can't stall a decode (the scan only pays off when the dlen FIELD is
    # corrupt but the payload+pcrc survived — a narrow case).
    crc_budget = _CRC_SCAN_CAP
    # Standalone tag anchors run AFTER every fuzzy-magic anchor so that, under
    # ``limit``, the likelier candidates keep priority.
    for start in mpos_list + sorted(set(tag_alone) - mpos_set):
        if len(out) >= limit:
            break
        if start + 5 + _META.size >= n:
            continue
        exact = start in exact_set
        nl_read = raw[start + 4]
        nl_implied = tag_anchor.get(start, tag_alone.get(start))
        for nl in {nl_read, nl_implied} - {None, 0}:
            meta_start = start + 5 + nl
            if meta_start + _META.size > n:
                continue
            dlen_read = _META.unpack(raw[meta_start : meta_start + _META.size])[4]
            # As-read geometry; the strict parser already handled the
            # exact-magic + as-read-name_len variant of it.
            if not (exact and nl == nl_read):
                add(start, nl, dlen_read)
            # Corrupt-dlen rescue. The payload can only extend to the next
            # frame start (back-to-back multi-part streams) or end of stream.
            payload_start = meta_start + _META.size
            nxt = [p for p in mpos_list if p > payload_start]
            boundary = nxt[0] if nxt else n
            dlen_span = boundary - payload_start
            if dlen_span <= 0:
                continue
            # When the pcrc field survived, the true dlen is recoverable
            # EXACTLY: the payload is the unique span prefix whose CRC32
            # matches it (one incremental pass).
            pcrc = _META.unpack(raw[meta_start : meta_start + _META.size])[5]
            if crc_budget > 0 and not (
                0 < dlen_read <= dlen_span
                and crc32(raw[payload_start : payload_start + dlen_read]) == pcrc
            ):
                span_scan = min(dlen_span, crc_budget)
                crc_budget -= span_scan
                dlen_crc = _find_dlen_by_crc(raw, payload_start, pcrc, span_scan)
                if dlen_crc and dlen_crc != dlen_read:
                    add(start, nl, dlen_crc)
            # Last resort (pcrc corrupt too): hand the whole span to the
            # decoder's self-terminating validation ladder. For frames the
            # strict parser already sees (exact magic, sane as-read
            # geometry — the damaged-frame FEC path owns those), only try a
            # span COMPARABLE to the read dlen: a slightly-corrupt length
            # field stays rescuable, while a capture-long noise tail (span
            # >> dlen) no longer feeds ~100 s of Viterbi per decode.
            strict_saw_it = (
                exact and nl == nl_read and _sane_geometry(raw, start, nl, dlen_read)
            )
            span_ok = not strict_saw_it or dlen_span <= max(2 * dlen_read, 1 << 16)
            if dlen_span != dlen_read:
                if span_ok:
                    add(start, nl, dlen_span)
                else:
                    logger.debug(
                        "span candidate at %d suppressed (strict-seen frame, "
                        "span %d >> dlen %d)", start, dlen_span, dlen_read,
                    )
    return out
