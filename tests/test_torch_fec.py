"""The port's FEC (``fec.py``) vs the JAX package's, on the CPU: the Viterbi
decoder bit for bit (the port's through its plain version, the JAX
package's through its ``lax.scan``), ``ViterbiDecoder.decode`` on the
native and the block route, the parity-triplet code, the convolutional
encoder, the containers and stream FEC, byte for byte.

Inputs are made with numpy from seeds and handed to both packages.
"""

import pathlib
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import fec as jfec
from audio_modem_radio_tpu import native as jnative
from audio_modem_radio_tpu.framing import crc32, pack_frame

from audio_modem_radio_tpu_torch import fec as tfec
from audio_modem_radio_tpu_torch import native as tnative
from audio_modem_radio_tpu_torch.ops import kernels as tk

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


def _pairs(kind: str, T: int, seed: int) -> np.ndarray:
    """(T, 2) float32: ``hard`` a coded random stream with 3% of its bits
    flipped; ``soft`` that stream as soft values with Gaussian noise,
    clipped to [0, 1]; ``half`` all 0.5 (every candidate ties)."""
    rng = np.random.default_rng(seed)
    if kind == "half":
        return np.full((T, 2), 0.5, np.float32)
    coded = tfec.ConvolutionalEncoder().encode_bits(rng.integers(0, 2, max(T - 6, 1)).astype(np.uint8))[:T]
    if kind == "hard":
        return (coded ^ (rng.random(coded.shape) < 0.03)).astype(np.float32)
    return np.clip(coded + rng.normal(0, 0.35, coded.shape), 0, 1).astype(np.float32)


def _jax_bits(pairs: np.ndarray, known_boundaries: bool) -> np.ndarray:
    return np.asarray(jfec.viterbi_decode_bits(jnp.asarray(pairs), known_boundaries=known_boundaries))


@pytest.mark.parametrize("kind", ["hard", "soft", "half"])
@pytest.mark.parametrize("T,known_boundaries", [(1, True), (700, True), (700, False), (9216, False),
                                                (9217, True), (20000, True)])
def test_viterbi_decode_bits_equals_jax(kind, T, known_boundaries):
    """Short inputs (one block, both boundaries), the geometry's edge (9216
    pairs: one block; 9217: two blocks of the block-parallel path) and a
    three-block input, whose blocks take zero metrics and the best end state
    whatever ``known_boundaries`` says: bits equal to the JAX package's, one
    kernel call each."""
    p = _pairs(kind, T, T)
    calls = []
    real = tfec.fec_viterbi_blocks
    tfec.fec_viterbi_blocks = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        got = tfec.viterbi_decode_bits(p, known_boundaries, device="cpu")
    finally:
        tfec.fec_viterbi_blocks = real
    assert got.dtype == np.uint8 and np.array_equal(got, _jax_bits(p, known_boundaries))
    n_blocks = 1 if T <= 9216 else -(-T // 8192)
    assert calls == [(n_blocks, T if T <= 9216 else 9216, 2)]


def test_viterbi_decode_bits_empty_input_launches_nothing():
    before = tk.fec_viterbi_blocks.launches
    out = tfec.viterbi_decode_bits(np.zeros((0, 2), np.float32), device="cpu")
    assert out.shape == (0,) and out.dtype == np.uint8
    assert tk.fec_viterbi_blocks.launches == before


def test_trellis_tables_equal_jax():
    for got, ref in zip(tfec._trellis_tables(), jfec._trellis_tables()):
        assert np.array_equal(got, ref)
    p0, p1, code0, code1 = (t.numpy() for t in tk._fec_tables(torch.device("cpu")))
    _, _, exp0, exp1 = jfec._trellis_tables()
    assert np.array_equal(p0, np.arange(64) >> 1) and np.array_equal(p1, (np.arange(64) >> 1) | 32)
    assert np.array_equal(code0, 2 * exp0[:, 0] + exp0[:, 1]) and np.array_equal(code1, 2 * exp1[:, 0] + exp1[:, 1])


def _fecv_payload(n_bytes: int, flips: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    blob = bytearray(jfec.ConvolutionalEncoder().encode(rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()))
    for i in rng.choice(len(blob) * 8, flips, replace=False):
        blob[i // 8] ^= 0x80 >> (i % 8)
    return bytes(blob)


@pytest.mark.parametrize("route", ["native", "blocks"])
@pytest.mark.parametrize("n_bytes,flips", [(300, 20), (1500, 100)])
def test_viterbi_decoder_decode_equals_jax(route, n_bytes, flips, monkeypatch):
    """``ViterbiDecoder.decode`` of a damaged container, 300 bytes (4,806
    pairs: one block on the card) and 1,500 (24,006 pairs: the native sweep
    where it built, else the block-parallel decoder): byte-equal to the JAX
    package's on both routes, the block route forced by making the native
    sweep unavailable in both packages."""
    if route == "blocks":
        monkeypatch.setattr(jnative, "viterbi_decode_pairs", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "viterbi_decode_pairs", lambda *a, **k: None)
    else:
        _jax_native_loaded(monkeypatch)
        assert tnative.viterbi_available()
    blob = _fecv_payload(n_bytes, flips, n_bytes)
    got = tfec.ViterbiDecoder(device="cpu").decode(blob)
    assert got == jfec.ViterbiDecoder().decode(blob)
    assert len(got) == n_bytes


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 100, 101])
def test_codes_and_containers_equal_jax(n):
    """The parity-triplet code (odd lengths pad with 0xFF without parity),
    the convolutional encoder (16n+12 bits: the trailing partial byte keeps
    its bits low) and ``wrap_fec``/``unwrap_fec`` of both types, byte-equal,
    clean and with a corrupted triplet."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tfec.ReedSolomonFEC().encode(data) == jfec.ReedSolomonFEC().encode(data)
    assert tfec.ConvolutionalEncoder().encode(data) == jfec.ConvolutionalEncoder().encode(data)
    bits = np.random.default_rng(n + 1).integers(0, 2, 8 * n + 5).astype(np.uint8)
    assert tfec._pack_bits_ref_style(bits) == jfec._pack_bits_ref_style(bits)
    assert np.array_equal(tfec._unpack_bits_ref_style(tfec._pack_bits_ref_style(bits), len(bits)), bits)
    for ftype in ("reed_solomon", "convolutional"):
        blob = tfec.wrap_fec(data, ftype)
        assert blob == jfec.wrap_fec(data, ftype)
        assert tfec.unwrap_fec(blob, device="cpu") == jfec.unwrap_fec(blob) == data
    parity = bytearray(tfec.wrap_fec(data, "reed_solomon"))
    if n >= 2:
        parity[5] ^= 0x10  # a corrupted triplet: detected, '?' substituted
    rs_t, rs_j = tfec.ReedSolomonFEC(), jfec.ReedSolomonFEC()
    assert rs_t.decode(bytes(parity[4:])) == rs_j.decode(bytes(parity[4:]))
    assert rs_t.last_crc_ok == rs_j.last_crc_ok
    assert tfec.unwrap_fec(b"RAW0" + data, device="cpu") is None


def _framed(seed: int, n_bytes: int, name: str) -> bytes:
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return pack_frame(name, p, 0, 1, len(p), crc32(p))


def _flip(blob: bytes, rate: float, seed: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(blob, np.uint8))
    bits ^= (np.random.default_rng(seed).random(len(bits)) < rate).astype(np.uint8)
    return np.packbits(bits).tobytes()


@pytest.mark.parametrize("case", ["one", "two segments", "garbage lead", "no marker", "noisy", "odd shift"])
def test_stream_fec_decode_equals_jax(case):
    """``stream_fec_encode`` byte-equal; ``stream_fec_decode`` of one
    segment, of two back-to-back transmissions, after leading garbage, of a
    stream without its sync marker (both pair phases), with 1% of the coded
    bits flipped, and one bit out of pair phase: byte-equal."""
    a, b = _framed(1, 400, "a.bin"), _framed(2, 300, "b.bin")
    ea, eb = tfec.stream_fec_encode(a), tfec.stream_fec_encode(b)
    assert ea == jfec.stream_fec_encode(a) and eb == jfec.stream_fec_encode(b)
    raw = {
        "one": ea,
        "two segments": ea + eb,
        "garbage lead": np.random.default_rng(3).integers(0, 256, 37, dtype=np.uint8).tobytes() + ea,
        "no marker": ea[4:],
        "noisy": ea[:4] + _flip(ea[4:], 0.01, 4),
        "odd shift": np.packbits(np.concatenate([[1], np.unpackbits(np.frombuffer(ea[4:], np.uint8))])[:-1]).tobytes(),
    }[case]
    got = tfec.stream_fec_decode(raw, device="cpu")
    assert got == jfec.stream_fec_decode(raw)
    if case != "odd shift":
        assert got.startswith(a)
    if case == "two segments":
        assert b in got


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_stream_fec_decode_soft_equals_jax(noise):
    """The soft decode: the plaintext sync located on thresholded bits after
    a garbage lead, the soft values from there through the Viterbi."""
    framed = _framed(5, 500, "s.bin")
    coded = np.unpackbits(np.frombuffer(tfec.stream_fec_encode(framed), np.uint8)).astype(np.float32)
    rng = np.random.default_rng(6)
    soft = np.concatenate([rng.random(53).astype(np.float32), coded])
    soft = np.clip(soft + rng.normal(0, noise, len(soft)), 0, 1).astype(np.float32) if noise else soft
    got = tfec.stream_fec_decode_soft(soft, device="cpu")
    assert got == jfec.stream_fec_decode_soft(soft)
    assert got.startswith(framed)


def test_sass_chain_goes_through_shared_memory():
    """``sass_stats.chain_cycles`` on a SASS listing whose step passes its
    normalised metrics through shared memory between two REDUX.MIN (the
    exchange on the chain, as a Viterbi step that normalises before its
    exchange has it): the chain a step is REDUX, the uniform move (no
    cost), FADD, STS and the LDS that waits for it; a serial traceback's
    SHFL anchors its own chain."""
    from audio_modem_radio_tpu_torch import sass_stats

    step = ("REDUX.MIN.S32 UR4, R0 ;", "IMAD.U32 R1, RZ, RZ, UR4 ;", "FADD R2, R1, R3 ;", "STS [R5], R2 ;",
            "LDS R0, [R6] ;", "SHFL.IDX PT, R7, R8, R9, 0x1f ;", "SEL R8, R7, R8, P0 ;")
    lines = [f"        /*{16 * i:04x}*/                   {ins}" for i, ins in enumerate(step * 3)]
    sass = "Function : _ZN16fec_viterbi_kernelE\n" + "\n".join(lines) + "\n"
    lat = {"REDUX": 44.0, "FADD": 4.0, "LDS": 23.0, "LOP3": 3.75, "SHFL": 26.0, "SEL": 4.0}
    fwd, fwd_path, back, back_path = sass_stats.chain_cycles(sass, lat, "fec_viterbi_kernel", forward="REDUX.MIN",
                                                             back="SHFL")
    assert fwd == pytest.approx(44.0 + 4.0 + 3.75 + 23.0)
    assert fwd_path == ["FADD", "STS", "LDS", "REDUX.MIN.S32"]
    assert back == pytest.approx(26.0 + 4.0) and back_path == ["SEL", "SHFL.IDX"]


def test_sass_chain_of_a_step_normalised_at_the_receiver():
    """``sass_stats.chain_cycles`` on a listing shaped like
    ``fec_viterbi.cu``'s step with the chip's anchors (``chip_smoke.py``
    phase 6): the raw metrics go through shared memory beside the REDUX,
    so the chain a step is REDUX.MIN, the uniform move (no cost), FADD
    (pm_raw - mn), FADD (+ bm), FMNMX, FMNMX; phase A's bit stores
    (STG.U8) anchor the traceback step, SHF and LOP3."""
    from audio_modem_radio_tpu_torch import sass_stats

    step = ("REDUX.MIN.S32 UR4, R0 ;", "IMAD.U32 R1, RZ, RZ, UR4 ;", "FADD R2, R10, -R1 ;", "FADD R3, R2, R11 ;",
            "FMNMX R4, R3, R12, PT ;", "STS.64 [R5], R4 ;", "FMNMX R0, R4, R13, PT ;", "LDS R10, [R6] ;")
    walk = ("STG.E.U8 desc[UR6][R20.64], R21 ;", "SHF.R.U32.HI R22, RZ, R21, R30 ;",
            "LOP3.LUT R21, R22, 0x1, RZ, 0xc0, !PT ;")
    lines = [f"        /*{16 * i:04x}*/                   {ins}" for i, ins in enumerate(step * 3 + ("BRA 0x10 ;",)
                                                                                    + walk * 3)]
    sass = "Function : _ZN16fec_viterbi_kernelE\n" + "\n".join(lines) + "\n"
    lat = {"REDUX": 44.0, "FADD": 4.0, "FMNMX": 4.0, "LDS": 23.0, "LOP3": 3.75, "SHF": 4.25}
    fwd, fwd_path, back, back_path = sass_stats.chain_cycles(sass, lat, "fec_viterbi_kernel", forward="REDUX.MIN")
    assert fwd == pytest.approx(44.0 + 4 * 4.0)
    assert fwd_path == ["FADD", "FADD", "FMNMX", "FMNMX", "REDUX.MIN.S32"]
    assert back == pytest.approx(4.25 + 3.75) and back_path == ["SHF.R.U32.HI", "LOP3.LUT", "STG.E.U8"]
