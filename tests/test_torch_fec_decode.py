"""The port's FEC-aware decode vs the JAX package's, on the CPU:
``decode_wav_file`` / ``decode_from_buffer`` / ``decode_with_retry`` with
stream FEC (QPSK, and FSK9600 with MLSE) and with ``FECV``/``FECP`` payload
containers, the header-tolerant FEC proofs and the soft payload-FEC rung
(the noisy and batched cases are in ``test_torch_fec_batch.py``).

Clean captures of 2^17-2^18 samples are made with numpy from seeds (the
transmissions by the JAX package's encoder) and handed to both packages;
saved files are compared byte for byte, with their names less the
``recv_<time>_`` prefix.
"""

import os
import re

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.fec import stream_fec_encode, wrap_fec
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames_detailed
from audio_modem_radio_tpu.utils.compression import intelligent_compress

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _place(wave, n: int, lead: int) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = np.asarray(wave, np.float32)[: n - lead]
    return x


def _framed(data: bytes, name: str, fec: str) -> bytes:
    """The JAX encoder's single-file framing: compress, optional payload
    container, frame, optional stream FEC."""
    blob = intelligent_compress(data)
    if fec in ("convolutional", "reed_solomon"):
        blob = wrap_fec(blob, fec)
    framed = pack_frame(name, blob, 0, 1, len(data), crc32(data))
    return stream_fec_encode(framed) if fec == "stream" else framed


def _saved(paths):
    """Sorted (name less its recv_<time>_ prefix, contents)."""
    return sorted((re.sub(r"^recv_\d+_", "", os.path.basename(p)), open(p, "rb").read()) for p in paths)


def _stats(reg) -> dict:
    return {k: v for k, v in reg.stats.items() if k != "last_reception"}


def _both(fn_j, fn_t, tmp_path):
    """Run a JAX and a port decode into their own directories and
    registries; returns (saved_j, saved_t, registry_j, registry_t)."""
    rj, rt = JRegistry(journal_dir=""), TRegistry(journal_dir="")
    got_j = fn_j(str(tmp_path / "j"), rj)
    got_t = fn_t(str(tmp_path / "t"), rt)
    return got_j, got_t, rj, rt


_CASES = {  # label -> (mode, symbol rate, container, capture length, file bytes)
    "QPSK stream": ("QPSK", 9600, "stream", 1 << 17, 900),
    "FSK9600 stream": ("FSK9600", 9600, "stream", 1 << 18, 900),
    "QPSK FECV": ("QPSK", 9600, "convolutional", 1 << 17, 900),
    "8PSK FECP": ("8PSK", 9600, "reed_solomon", 1 << 17, 900),
    "BPSK stream": ("BPSK", 4800, "stream", 1 << 18, 500),
}


@pytest.mark.parametrize("label", list(_CASES))
def test_decode_wav_file_equals_jax(tmp_path, label):
    """Clean captures with stream FEC (the port's Viterbi through its plain
    version; FSK9600 after its MLSE) or a payload container (``FECV``:
    the Viterbi; ``FECP``: the parity code): the same files under the same
    names and the same registry stats as the JAX decoder."""
    mode, rate, fec, n, n_bytes = _CASES[label]
    data = _payload(len(label), n_bytes)
    wav = str(tmp_path / "c.wav")
    write_wav(wav, _place(jmodem.modulate(mode, _framed(data, "f.bin", fec), rate), n, 331))
    sf = fec == "stream"
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_wav_file(wav, mode, rate, recv_dir=d, registry=r, stream_fec=sf),
        lambda d, r: tdec.decode_wav_file(wav, mode, rate, recv_dir=d, registry=r, stream_fec=sf, device="cpu"),
        tmp_path)
    assert _saved(got_t) == _saved(got_j) == [("f.bin", data)]
    assert _stats(rt) == _stats(rj)


def test_decode_from_buffer_and_retry_stream_fec_equal_jax(tmp_path):
    """``decode_from_buffer`` and ``decode_with_retry`` with ``stream_fec``
    on a multi-part stream-FEC transmission (two parts, each its own coded
    segment): the same files as the JAX decoder; ``decode_with_retry``'s
    nominal attempt already saves."""
    data = _payload(7, 1400)
    framed = b"".join(
        stream_fec_encode(pack_frame(f"m.bin.part{i + 1}", intelligent_compress(data[700 * i : 700 * (i + 1)]),
                                     i, 2, len(data), crc32(data)))
        for i in range(2)
    )
    x = _place(jmodem.modulate("QPSK", framed, 9600), 1 << 17, 77)
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True),
        lambda d, r: tdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True,
                                             device="cpu"),
        tmp_path / "buffer")
    assert _saved(got_t) == _saved(got_j) == [("m.bin", data)]
    assert _stats(rt) == _stats(rj)
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_with_retry(x, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True),
        lambda d, r: tdec.decode_with_retry(x, "QPSK", 9600, recv_dir=d, registry=r, stream_fec=True,
                                            device="cpu"),
        tmp_path / "retry")
    assert _saved(got_t) == _saved(got_j) == [("m.bin", data)]
    assert sorted(re.sub(r"^recv_\d+_", "", f) for f in os.listdir(tmp_path / "retry" / "t")) == sorted(
        re.sub(r"^recv_\d+_", "", f) for f in os.listdir(tmp_path / "retry" / "j"))


def _flip_bits(blob: bytes, positions) -> bytes:
    out = bytearray(blob)
    for i in positions:
        out[i // 8] ^= 0x80 >> (i % 8)
    return bytes(out)


@pytest.mark.parametrize("damage", ["header+payload", "payload"])
def test_damaged_fecv_frame_recovered_like_jax(tmp_path, damage):
    """A ``FECV`` frame whose payload took 12 bit errors (its CRC fails)
    and, in the first case, whose magic took one (the strict parser misses
    it): header-tolerant proof 2 (the Viterbi decode re-encodes to the
    header's payload CRC) recovers it in both packages, with the same
    stats."""
    data = _payload(11, 500)
    framed = _framed(data, "d.bin", "convolutional")
    head = 4 + 1 + len("d.bin") + 24
    rng = np.random.default_rng(12)
    flips = list(head * 8 + 40 + rng.choice((len(framed) - head - 6) * 8, 12, replace=False))
    if damage == "header+payload":
        flips.append(21)  # the magic's validation half
    x = _place(jmodem.modulate("QPSK", _flip_bits(framed, flips), 9600), 1 << 16, 95)
    got_j, got_t, rj, rt = _both(
        lambda d, r: jdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r),
        lambda d, r: tdec.decode_from_buffer(x, "QPSK", 9600, recv_dir=d, registry=r, device="cpu"),
        tmp_path)
    assert _saved(got_t) == _saved(got_j) == [("d.bin", data)]
    assert _stats(rt) == _stats(rj) and rt.stats.get("header_recoveries") == 1


def test_recover_payload_fec_soft_equals_jax():
    """The soft payload-FEC rung on a noisy FSK9600 capture whose damaged
    ``FECV`` frame defeats the hard Viterbi (the JAX package's measured
    seed): both packages return the repaired frame."""
    data = _payload(0, 400)
    container = wrap_fec(data, "convolutional")
    wave = np.asarray(jmodem.modulate("FSK9600", pack_frame("s.bin", container, 0, 1, len(data), crc32(data)),
                                      9600), np.float32)
    noisy = wave + np.random.default_rng(1001).normal(0, 0.10, len(wave)).astype(np.float32)
    raw = jmodem.demodulate("FSK9600", jdec.pad_to_bucket(noisy), 9600)
    frames, damaged = parse_frames_detailed(raw)
    assert not frames and damaged
    ref = jdec.recover_payload_fec_soft(raw, noisy, "FSK9600", 9600, list(damaged))
    got = tdec.recover_payload_fec_soft(raw, noisy, "FSK9600", 9600, list(damaged), device="cpu")
    assert [(f.name, f.data) for f in got] == [(f.name, f.data) for f in ref]
    assert len(got) == 1
