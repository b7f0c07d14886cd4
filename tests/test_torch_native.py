"""The port's native host runtime (``native.py`` and its own copy of
``amr_native.cpp``) vs the JAX package's, on the CPU: where the library
lands, that its source is the JAX package's code, and that the frame
scanner, the CRC prefix search, the WAV batch loader and the Viterbi sweep
give the JAX package's results, with the library and through the Python
fallbacks.
"""

import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import native as jnative
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames_detailed

from audio_modem_radio_tpu_torch import native as tnative
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


# How long a case waits for the JAX package's native library (a build takes
# about a second; several test workers may be building it at once).
_JAX_NATIVE_DEADLINE_S = 60.0


def _jax_native_loaded(monkeypatch) -> None:
    """Make sure the JAX package's native library is built and loaded in this
    process before a case reads it; fail the case, with the reason, if it
    never loads.

    That package builds the library in place (``g++ -o
    native/libamr_native.so``) when its module is first imported, and keeps
    a failed load for the life of the process. Under parallel test workers,
    one worker can ``CDLL`` the file while another worker's linker is
    rewriting it (``file too short``), and then holds no library. So where
    none is held, this waits until the file reads the same twice a quarter
    second apart (no linker is writing it) and loads it afresh through the
    package's own loader, which builds it where it is missing."""
    path = pathlib.Path(jnative._LIB)
    deadline = time.monotonic() + _JAX_NATIVE_DEADLINE_S
    last = seen = None
    while not jnative._lib:
        try:
            st = path.stat()
            seen = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            seen = None
        if seen == last:
            monkeypatch.setattr(jnative, "_lib", None)  # forget the failed load
            if jnative._load():
                break
        if time.monotonic() > deadline:
            pytest.fail(f"the JAX package's native library {path} did not load within "
                        f"{_JAX_NATIVE_DEADLINE_S:.0f} s (size and mtime: {seen})")
        last = seen
        time.sleep(0.25)
    assert jnative.viterbi_available(), f"{path} loaded without amr_viterbi_decode"


REPO = pathlib.Path(__file__).resolve().parent.parent


def _code(path: pathlib.Path) -> str:
    """A C++ source without its comments and blank lines."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return "\n".join(line.rstrip() for line in text.splitlines() if line.strip())


def test_library_builds_under_the_ports_build_directory():
    assert tnative.available() and tnative.NATIVE_AVAILABLE
    path = tnative.library_path()
    assert path.parent == REPO / "build" / "audio_modem_radio_tpu_torch" and path.is_file()
    assert path.name.startswith("libamr_native_") and path != REPO / "native" / "libamr_native.so"
    assert _code(REPO / "audio_modem_radio_tpu_torch" / "native" / "amr_native.cpp") == _code(
        REPO / "native" / "amr_native.cpp")


def _stream(seed: int) -> bytes:
    """Frames, a damaged one (payload CRC wrong) and garbage between."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(4):
        p = rng.integers(0, 256, 200 + 50 * i, dtype=np.uint8).tobytes()
        fr = bytearray(pack_frame(f"n{i}.bin", p, i, 4, 999, 1234))
        if i == 2:
            fr[-3] ^= 0x01
        parts.append(rng.integers(0, 256, 17, dtype=np.uint8).tobytes() + bytes(fr))
    return b"".join(parts) + b"FBPC\x00junk"


def _keys(frames):
    return [(f.name, f.data, f.part_number, f.total_parts, f.file_size, f.file_crc) for f in frames]


@pytest.mark.parametrize("native", [True, False])
def test_scan_and_crc_prefix_equal_jax(native, monkeypatch):
    """``scan_frames`` (valid and damaged frames) and ``crc32_prefix_find``
    with the library, and through the Python fallbacks (the library made
    unavailable): the JAX package's native results."""
    _jax_native_loaded(monkeypatch)
    if not native:
        monkeypatch.setattr(tnative, "_lib", False)
    raw = _stream(1)
    got, ref = tnative.scan_frames(raw), jnative.scan_frames(raw)
    assert [_keys(g) for g in got] == [_keys(r) for r in ref] == [_keys(x) for x in parse_frames_detailed(raw)]
    assert len(got[0]) == 3 and len(got[1]) == 1
    buf = raw[100:3000]
    for n in (1, 57, 900):
        want = jnative.crc32_prefix_find(buf, crc32(buf[:n]))
        assert want == n
        assert tnative.crc32_prefix_find(buf, crc32(buf[:n])) == (want if native else None)


@pytest.mark.parametrize("native", [True, False])
def test_load_wav_batch_equals_jax(tmp_path, native, monkeypatch):
    """Three 96 kHz WAVs of different lengths (one longer than the row), a
    48 kHz one and a corrupt file: samples, rates and counts equal the JAX
    package's native loader's, with the library and through the fallback."""
    _jax_native_loaded(monkeypatch)
    if not native:
        monkeypatch.setattr(tnative, "_lib", False)
    rng = np.random.default_rng(2)
    paths = []
    for i, n in enumerate((1000, 4096, 6000)):
        paths.append(str(tmp_path / f"w{i}.wav"))
        write_wav(paths[-1], rng.uniform(-0.9, 0.9, n).astype(np.float32))
    paths.append(str(tmp_path / "r48.wav"))
    write_wav(paths[-1], rng.uniform(-0.5, 0.5, 800).astype(np.float32), 48000)
    paths.append(str(tmp_path / "bad.wav"))
    (tmp_path / "bad.wav").write_bytes(b"RIFF junk")
    got = tnative.load_wav_batch(paths, 5000)
    ref = jnative.load_wav_batch(paths, 5000)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert list(got[1]) == [96000, 96000, 96000, 48000, 0]


@pytest.mark.parametrize("known_boundaries", [True, False])
def test_viterbi_decode_pairs_equals_jax(known_boundaries, monkeypatch):
    """The full-length sweep on 30,000 soft pairs, both boundaries; None
    without the library."""
    _jax_native_loaded(monkeypatch)
    p = np.random.default_rng(3).random((30000, 2)).astype(np.float32)
    got = tnative.viterbi_decode_pairs(p, known_boundaries)
    assert got.dtype == np.uint8 and np.array_equal(got, jnative.viterbi_decode_pairs(p, known_boundaries))
    monkeypatch.setattr(tnative, "_lib", False)
    assert tnative.viterbi_decode_pairs(p, known_boundaries) is None and not tnative.viterbi_available()


def test_jax_native_helper_waits_out_a_rewrite(tmp_path, monkeypatch):
    """``_jax_native_loaded`` in the state a test worker is left in when its
    load read the file while another worker's linker was writing it: the
    JAX package's load of the empty file fails (and would be kept), the
    helper waits until the whole file is in place, then loads it."""
    _jax_native_loaded(monkeypatch)
    whole = pathlib.Path(jnative._LIB).read_bytes()
    lib = tmp_path / "libamr_native.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(jnative, "_LIB", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative._load() is False and jnative._lib is False
    writer = threading.Timer(1.0, lib.write_bytes, (whole,))
    writer.start()
    try:
        _jax_native_loaded(monkeypatch)
    finally:
        writer.join()
    assert jnative._lib._name == str(lib) and lib.stat().st_size == len(whole)
    p = np.random.default_rng(4).random((500, 2)).astype(np.float32)
    assert np.array_equal(jnative.viterbi_decode_pairs(p), tnative.viterbi_decode_pairs(p))
