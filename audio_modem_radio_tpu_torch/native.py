"""ctypes bindings for the port's native (C++) host runtime.

Counterpart of ``audio_modem_radio_tpu/native.py``. The port keeps its own
copy of the C++ source, ``native/amr_native.cpp`` in this package, and
compiles it with g++ at first use into ``build/audio_modem_radio_tpu_torch/``
beside the package, named by a hash of the source and the flags (as
``ops/_build.py`` names the CUDA library); it never loads or rebuilds the
JAX package's ``native/libamr_native.so``. Every entry point has a
pure-Python fallback, used where no compiler or zlib is at hand; these are
host code and hide no device.

API:
  * :func:`scan_frames`: native-or-fallback equivalent of
    ``framing.parse_frames_detailed``.
  * :func:`crc32_prefix_find`: the shortest prefix with a given CRC32.
  * :func:`viterbi_decode_pairs`: the exact full-length Viterbi sweep of
    the K=7 code (``fec.ViterbiDecoder`` sends long inputs here).
  * :func:`load_wav_batch`: N WAV files -> (B, row_len) float32 matrix +
    per-file sample rates, parallel across files.
  * ``NATIVE_AVAILABLE``: whether the shared library built and loaded,
    decided at the first read (importing this module builds nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("audio_modem_radio_tpu_torch")

_PKG_DIR = Path(__file__).resolve().parent
_SRC = _PKG_DIR / "native" / "amr_native.cpp"
BUILD_DIR = _PKG_DIR.parent / "build" / _PKG_DIR.name
_BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# -march=native roughly doubles the Viterbi sweep (vectorized metric adds);
# the portable flags are the fallback where it is refused.
_FLAG_SETS = (_BASE_FLAGS + ("-march=native",), _BASE_FLAGS)

_lib = None
_lib_lock = threading.Lock()


class _FrameDesc(ctypes.Structure):
    _fields_ = [
        ("name_off", ctypes.c_uint64),
        ("name_len", ctypes.c_uint32),
        ("payload_off", ctypes.c_uint64),
        ("payload_len", ctypes.c_uint32),
        ("part_number", ctypes.c_uint32),
        ("total_parts", ctypes.c_uint32),
        ("file_size", ctypes.c_uint32),
        ("file_crc", ctypes.c_uint32),
        ("crc_ok", ctypes.c_uint32),
    ]


def library_path() -> Path:
    """The built library's path: a hash of the source and both flag sets."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(repr(_FLAG_SETS).encode())
    return BUILD_DIR / f"libamr_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the source into ``out`` (through a temporary file, so
    concurrent builders never load a half-written library)."""
    if not _SRC.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, out.name)
        for flags in _FLAG_SETS:
            try:
                subprocess.run(["g++", *flags, str(_SRC), "-o", tmp, "-lz"],
                               check=True, capture_output=True, timeout=120)
            except FileNotFoundError as e:
                logger.info("native build unavailable (%s); using Python fallbacks", e)
                return False
            except subprocess.SubprocessError:
                continue
            os.replace(tmp, out)
            return True
    logger.info("native build failed; using Python fallbacks")
    return False


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file() and not _build(path):
            _lib = False
            return False
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _lib = False
            return False
        lib.amr_scan_frames.restype = ctypes.c_int64
        lib.amr_scan_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(_FrameDesc),
            ctypes.c_int64,
        ]
        lib.amr_crc32_prefix_find.restype = ctypes.c_int64
        lib.amr_crc32_prefix_find.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
        ]
        lib.amr_load_wav_batch.restype = None
        lib.amr_load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        lib.amr_viterbi_decode.restype = ctypes.c_int64
        lib.amr_viterbi_decode.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return lib


def available() -> bool:
    return bool(_load())


def __getattr__(name: str):
    # NATIVE_AVAILABLE is decided at its first read, not at import.
    if name == "NATIVE_AVAILABLE":
        return available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def scan_frames(raw: bytes, max_frames: int = 4096):
    """Native FBPC scan -> (valid_frames, damaged_frames); falls back to
    the Python parser when the library is unavailable."""
    from .framing import Frame, parse_frames_detailed

    lib = _load()
    if not lib:
        return parse_frames_detailed(raw)
    out = (_FrameDesc * max_frames)()
    n = lib.amr_scan_frames(raw, len(raw), out, max_frames)
    valid: List[Frame] = []
    damaged: List[Frame] = []
    for i in range(n):
        d = out[i]
        name = raw[d.name_off : d.name_off + d.name_len].decode("utf-8", "ignore")
        payload = raw[d.payload_off : d.payload_off + d.payload_len]
        frame = Frame(name, payload, d.part_number, d.total_parts, d.file_size, d.file_crc)
        (valid if d.crc_ok else damaged).append(frame)
    return valid, damaged


def crc32_prefix_find(buf: bytes, target: int) -> Optional[int]:
    """Length of the shortest prefix of ``buf`` whose CRC32 equals
    ``target`` (0 = none), or None when the native library is unavailable
    (the caller falls back to the Python scan)."""
    lib = _load()
    if not lib:
        return None
    return int(lib.amr_crc32_prefix_find(buf, len(buf), target & 0xFFFFFFFF))


def viterbi_available() -> bool:
    """Whether the native full-length Viterbi sweep is loadable (gates the
    header-recovery span cap in ``decoder.recover_header_damaged``)."""
    lib = _load()
    return bool(lib) and hasattr(lib, "amr_viterbi_decode")


def viterbi_decode_pairs(pairs: np.ndarray, known_boundaries: bool = True) -> Optional[np.ndarray]:
    """Native K=7 rate-1/2 Viterbi: (T, 2) hard/soft pairs -> (T,) bits.

    One exact full-length sweep (no blocks) with the semantics of one block
    of ``fec.viterbi_decode_bits``: L1 branch metric, ties keep the
    ``s >> 1`` predecessor, traceback from state 0 when ``known_boundaries``
    else from the best end state; metrics in double. Returns None when the
    library is unavailable (the caller decodes on the card instead).
    """
    lib = _load()
    if not lib or not hasattr(lib, "amr_viterbi_decode"):
        return None
    p = np.ascontiguousarray(pairs, dtype=np.float32)
    T = int(p.shape[0])
    out = np.empty(T, dtype=np.uint8)
    rc = lib.amr_viterbi_decode(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        1 if known_boundaries else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def load_wav_batch(
    paths: Sequence[str], row_len: int, max_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load WAVs into a zero-padded (B, row_len) float32 matrix, in parallel.

    Returns ``(samples, rates, n_samples)``; ``rates[i] == 0`` marks a file
    that failed to parse. The Python fallback reads sequentially via
    ``utils.wavio``.
    """
    lib = _load()
    b = len(paths)
    out = np.zeros((b, row_len), dtype=np.float32)
    rates = np.zeros(b, dtype=np.int32)
    counts = np.zeros(b, dtype=np.int64)
    if not lib:
        from .utils.wavio import read_wav

        for i, p in enumerate(paths):
            try:
                data, sr = read_wav(p)
            except Exception:
                continue
            n = min(len(data), row_len)
            out[i, :n] = data[:n]
            rates[i] = sr
            counts[i] = n
        return out, rates, counts

    c_paths = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    lib.amr_load_wav_batch(
        c_paths,
        b,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        row_len,
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_threads,
    )
    return out, rates, counts
