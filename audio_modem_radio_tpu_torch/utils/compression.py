"""Tagged compression container: RAW / ZLIB / LZMA / DLZM (+ delta codec).

Wire-compatible with the reference container format and policies
(reference utils/compression.py): a 4-byte ASCII tag followed by the
payload, entropy/pattern-driven algorithm selection, the ``super_compress``
zlib-vs-lzma tournament, byte-wise modular delta coding, and the SSTV-style
image payload preparation. Decompression auto-falls back to plain zlib and then
to raw bytes on unknown tags (compression.py:103-123).

The delta codec is vectorized with numpy (the reference loops per byte,
compression.py:243-273) — on multi-MB payloads this is the difference between
microseconds and seconds. zlib/lzma themselves are already native (C) code.
"""

from __future__ import annotations

import lzma
import math
import os
import zlib
from collections import Counter
from io import BytesIO
from typing import Any, Dict

import numpy as np

from ..config import CONFIG

TAG_RAW = b"RAW"  # note: 3-byte tag, matching the reference (b'RAW' + data)
TAG_ZLIB = b"ZLIB"
TAG_LZMA = b"LZMA"
TAG_DLZM = b"DLZM"

try:  # Optional, host-side only; used for SSTV-style image prep.
    from PIL import Image

    PIL_AVAILABLE = True
except ImportError:  # pragma: no cover
    PIL_AVAILABLE = False


# --- delta codec (vectorized) -------------------------------------------------

def delta_compress(data: bytes) -> bytes:
    """Byte-wise modular differencing: out[0]=in[0], out[i]=in[i]-in[i-1] mod 256."""
    if len(data) <= 1:
        return data
    arr = np.frombuffer(data, dtype=np.uint8)
    out = np.empty_like(arr)
    out[0] = arr[0]
    np.subtract(arr[1:], arr[:-1], out=out[1:])  # uint8 arithmetic wraps mod 256
    return out.tobytes()


def delta_decompress(compressed: bytes) -> bytes:
    """Inverse of :func:`delta_compress` (running modular sum)."""
    if not compressed:
        return b""
    arr = np.frombuffer(compressed, dtype=np.uint8)
    return np.cumsum(arr, dtype=np.uint8).tobytes()


# --- data analysis ------------------------------------------------------------

class IntelligentCompressor:
    """Chooses a compression algorithm from byte statistics.

    Mirrors the reference's selection policy (compression.py:17-69): Shannon
    entropy of the byte histogram, a repeated-fixed-stride-pattern scan, and a
    printable-ratio text heuristic.
    """

    def __init__(self) -> None:
        self.compression_stats: Dict[str, Any] = {}
        self.enabled = CONFIG.get("compression.enabled", True)

    def analyze_data_pattern(self, data: bytes) -> Dict[str, Any]:
        if len(data) < 100:
            return {"recommended": "none", "ratio": 1.0}

        arr = np.frombuffer(data, dtype=np.uint8)
        counts = np.bincount(arr, minlength=256)
        p = counts[counts > 0] / len(arr)
        entropy = float(-(p * np.log2(p)).sum())

        if entropy < 2.0 or self._detect_repeated_patterns(data):
            return {"recommended": "lzma", "ratio": 0.3, "entropy": entropy}
        if self._is_likely_text(data):
            return {"recommended": "zlib", "ratio": 0.5, "entropy": entropy}
        return {"recommended": "delta+lzma", "ratio": 0.4, "entropy": entropy}

    @staticmethod
    def _detect_repeated_patterns(data: bytes, min_pattern: int = 4, max_pattern: int = 32) -> bool:
        if len(data) < min_pattern * 10:
            return False
        # Cap the scan window so analysis stays O(1) on huge payloads.
        sample = data[: 1 << 16]
        for pattern_len in range(min_pattern, min(max_pattern, len(sample) // 10)):
            chunks = Counter(
                sample[i : i + pattern_len]
                for i in range(0, len(sample) - pattern_len, pattern_len)
            )
            if chunks and chunks.most_common(1)[0][1] > 3:
                return True
        return False

    @staticmethod
    def _is_likely_text(data: bytes) -> bool:
        if not data:
            return False
        head = np.frombuffer(data[:1000], dtype=np.uint8)
        printable = ((head >= 32) & (head <= 126)) | (head == 9) | (head == 10) | (head == 13)
        return float(printable.mean()) > 0.8


# --- tagged container API -----------------------------------------------------

def intelligent_compress(data: bytes, mode: str = "auto") -> bytes:
    """Compress with the best algorithm for the data; returns a tagged container.

    Policy parity with the reference (compression.py:72-100): payloads under
    200 B or with compression disabled ship RAW; otherwise the analyzer picks
    lzma / delta+lzma / zlib, each gated by its CONFIG flag, with a RAW
    fallback on any compression error.
    """
    if not CONFIG.get("compression.enabled", True) or len(data) < 200:
        return TAG_RAW + data

    if mode == "auto":
        mode = IntelligentCompressor().analyze_data_pattern(data)["recommended"]

    try:
        if mode == "lzma" and CONFIG.get("compression.lzma_enabled", True):
            return TAG_LZMA + lzma.compress(data, preset=9)
        if mode == "delta+lzma" and CONFIG.get("compression.delta_compression", True):
            return TAG_DLZM + lzma.compress(delta_compress(data), preset=9)
        return TAG_ZLIB + zlib.compress(data, 9)
    except Exception:
        return TAG_RAW + data


def intelligent_decompress(blob: bytes) -> bytes:
    """Decompress a tagged container; unknown tags fall back to zlib, then raw."""
    try:
        if blob.startswith(TAG_LZMA):
            return lzma.decompress(blob[4:])
        if blob.startswith(TAG_DLZM):
            return delta_decompress(lzma.decompress(blob[4:]))
        if blob.startswith(TAG_ZLIB):
            return zlib.decompress(blob[4:])
        if blob.startswith(TAG_RAW):
            return blob[3:]
        try:
            return zlib.decompress(blob)
        except zlib.error:
            return blob
    except Exception:
        return blob


def decompress_prefix(blob: bytes, file_size: int = 0):
    """Decompress a tagged container that may carry TRAILING GARBAGE.

    Used by header-tolerant frame recovery (framing.scan_frame_candidates):
    when the frame's ``dlen`` field is corrupt, the payload span is a guess
    that usually overshoots into trailing channel noise. LZMA and zlib
    streams are self-terminating, so a streaming decompressor recovers the
    original bytes exactly and ignores the junk tail; RAW payloads are
    bounded by the header's ``file_size``. Returns None when no
    self-terminating decode succeeds (unlike :func:`intelligent_decompress`,
    which falls back to returning the blob — wrong for a guessed span).
    """
    try:
        if blob.startswith(TAG_LZMA):
            return lzma.LZMADecompressor().decompress(blob[4:])
        if blob.startswith(TAG_DLZM):
            return delta_decompress(lzma.LZMADecompressor().decompress(blob[4:]))
        if blob.startswith(TAG_ZLIB):
            return zlib.decompressobj().decompress(blob[4:])
        if blob.startswith(TAG_RAW):
            body = blob[3:]
            return body[:file_size] if 0 < file_size <= len(body) else body
        return zlib.decompressobj().decompress(blob)
    except Exception:
        return None


def super_compress_enhanced(data: bytes) -> bytes:
    """Analysis-driven tagged compression (reference compression.py:127-137)."""
    rec = IntelligentCompressor().analyze_data_pattern(data)["recommended"]
    if rec == "lzma":
        return TAG_LZMA + lzma.compress(data, preset=9)
    if rec == "delta+lzma":
        return TAG_DLZM + lzma.compress(delta_compress(data), preset=9)
    return TAG_ZLIB + zlib.compress(data, 9)


def compress_data(data: bytes, level: int = 9) -> bytes:
    """Plain zlib compression; very small payloads pass through untouched."""
    if len(data) < 100:
        return data
    return zlib.compress(data, level)


def decompress_data(blob: bytes) -> bytes:
    """Plain zlib decompression with raw fallback."""
    try:
        return zlib.decompress(blob)
    except zlib.error:
        return blob


def super_compress(data: bytes) -> bytes:
    """Try zlib-9 and lzma-9; keep lzma only when it is >=20% smaller.

    Tournament policy per the reference (compression.py:201-226).
    """
    if len(data) < 500:
        return TAG_RAW + data
    try:
        zl = zlib.compress(data, 9)
        if len(data) > 1000:
            lz = lzma.compress(data, preset=9)
            if len(lz) < len(zl) * 0.8:
                return TAG_LZMA + lz
        return TAG_ZLIB + zl
    except Exception:
        return TAG_RAW + data


def super_decompress(blob: bytes) -> bytes:
    if blob.startswith(TAG_LZMA):
        return lzma.decompress(blob[4:])
    if blob.startswith(TAG_ZLIB):
        return zlib.decompress(blob[4:])
    if blob.startswith(TAG_RAW):
        return blob[3:]
    return decompress_data(blob)


def adaptive_compress(data: bytes, mode: str) -> bytes:
    """Per-transmission-mode compression (high-speed modes compress harder)."""
    if len(data) < 200:
        return data
    if mode in ("8PSK", "FSK19200", "OFDM4", "OFDM8"):
        return super_compress(data)
    return compress_data(data)


def prepare_sstv_like(path: str, jpeg_quality: int = 30, max_size=(400, 300)) -> bytes:
    """Prepare an SSTV-style payload: thumbnail -> low-quality JPEG -> zlib.

    Non-image files (or a missing PIL) fall back to plain zlib of the file
    bytes, matching the reference (compression.py:168-196).
    """
    image_exts = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tiff"}

    def _raw() -> bytes:
        with open(path, "rb") as f:
            return zlib.compress(f.read(), 6)

    if not PIL_AVAILABLE or os.path.splitext(path)[1].lower() not in image_exts:
        return _raw()
    try:
        img = Image.open(path)
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.thumbnail(max_size, Image.Resampling.LANCZOS)
        buf = BytesIO()
        img.save(buf, format="JPEG", quality=jpeg_quality, optimize=True)
        return zlib.compress(buf.getvalue(), 6)
    except Exception:
        return _raw()
