"""The PyTorch port's batched DQPSK receive vs the JAX package's, on the CPU:
the sync tail, the sample-batch decode, the WAV-batch decode with saving,
and cross decodes in both directions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.encoder import encode_file, encode_file_parts, split_file_for_transmission
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames as j_parse
from audio_modem_radio_tpu.modem import modulate as j_modulate
from audio_modem_radio_tpu.parallel.batch import (
    decode_sample_batch as j_decode_sample_batch,
    decode_wav_batch as j_decode_wav_batch,
    psk4_kernel_sync_tail as j_sync_tail,
)

from audio_modem_radio_tpu_torch import modulate as t_modulate
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import parse_frames as t_parse
from audio_modem_radio_tpu_torch.ops.psk import psk_decision_streams_batch, qpsk_modulate
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _frames(raw_list, parse):
    return [[(f.name, f.part_number, f.total_parts, f.data) for f in parse(raw)] for raw in raw_list]


def _signal_batch(seed: int, n: int = 1 << 17, leads=(0, 311), carriers=(3000.0, 3080.0)):
    rng = np.random.default_rng(seed)
    payloads, batch = [], np.zeros((len(leads), n), np.float32)
    for i, (lead, carrier) in enumerate(zip(leads, carriers)):
        p = rng.integers(0, 256, 1024 + 200 * i, dtype=np.uint8).tobytes()
        framed = pack_frame(f"c{i}.bin", p, 0, 1, len(p), crc32(p))
        wave = qpsk_modulate(framed, 9600, carrier)
        batch[i, lead : lead + len(wave)] = wave
        payloads.append(p)
    return batch, payloads


def _rotated_streams(rng, r, k, start_bit):
    """Raw Gray lanes (r*128,) x2 of random data with the magic + validation
    pattern at flat bit ``start_bit`` after relabel by rotation k."""
    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    bits = rng.integers(0, 2, 2 * r * 128, dtype=np.uint8)
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    bits[start_bit : start_bit + len(pat)] = pat
    h, l = bits[0::2], bits[1::2]
    raw = _QT_TO_DIBIT[(2 * h + (h ^ l) + k) & 3]
    return raw[:, 0], raw[:, 1]


def _compare_tails(hi, lo, cfo_retry):
    packed_j, n_valid_j, found_j = j_sync_tail(
        jnp.asarray(hi), jnp.asarray(lo), cfo_retry, interpret=True
    )
    packed_t, n_valid_t, found_t = tb.psk4_kernel_sync_tail(
        torch.from_numpy(hi), torch.from_numpy(lo), cfo_retry
    )
    assert np.array_equal(found_t.numpy(), np.asarray(found_j))
    assert np.array_equal(n_valid_t.numpy(), np.asarray(n_valid_j))
    assert np.array_equal(packed_t.numpy()[:, :-1], np.asarray(packed_j)[:, :-1])
    return packed_t.numpy(), n_valid_t.numpy(), found_t.numpy()


@pytest.mark.parametrize("cfo_retry", [True, False])
def test_sync_tail_matches_jax_on_signal(cfo_retry):
    batch, payloads = _signal_batch(1)
    hi, lo = psk_decision_streams_batch(torch.from_numpy(batch), 9600.0, 3000.0, 96000, cfo=cfo_retry)
    packed, n_valid, found = _compare_tails(hi.numpy(), lo.numpy(), cfo_retry)
    assert found.all()
    for i, p in enumerate(payloads):
        frames = t_parse(packed[i, : n_valid[i]].tobytes())
        assert frames and frames[0].data == p


@pytest.mark.parametrize("cfo_retry", [True, False])
@pytest.mark.parametrize("scenario", ["prefix_hit", "escalate"])
def test_sync_tail_matches_jax_tiers(cfo_retry, scenario):
    """512-row captures, so the 256-row prefix tier exists: either every
    capture matches k=0 inside it (accepted there) or one capture's magic
    lies past it or under another rotation (escalation to the full scan)."""
    rng = np.random.default_rng(7)
    r = 512
    if scenario == "prefix_hit":
        caps = [(0, 2001), (0, 5000)]
    else:
        caps = [(0, 2001), (0, 40_001 * 2), (1, 777), (3, 90_000)]
    streams = [_rotated_streams(rng, r, k, bit) for k, bit in caps]
    hi = np.stack([s[0] for s in streams])
    lo = np.stack([s[1] for s in streams])
    _, n_valid, found = _compare_tails(hi, lo, cfo_retry)
    expect = [k == 0 or cfo_retry for k, _ in caps]
    assert list(found) == expect


@pytest.mark.parametrize("rate", [9600, 4800])
def test_decode_sample_batch_matches_jax(rate):
    batch = np.zeros((2, 1 << 17), np.float32)
    payloads = []
    for i in range(2):
        data = bytes(f"capture {i} at {rate} ".encode() * 40)
        framed = pack_frame(f"f{i}.bin", data, 0, 1, len(data), crc32(data))
        wave = np.asarray(j_modulate("QPSK", framed, rate), np.float32)
        batch[i, 97 * i : 97 * i + len(wave)] = wave
        payloads.append(data)
    got = _frames(tb.decode_sample_batch(batch, "QPSK", rate, device="cpu"), t_parse)
    ref = _frames(j_decode_sample_batch(batch, "QPSK", rate), j_parse)
    assert got == ref
    assert [g[0][3] for g in got] == payloads


def test_decode_sample_batch_int16_rows_and_noise(monkeypatch):
    """int16 rows (the CUDA default) decode the same frames; a noise-only
    capture yields no frame."""
    from audio_modem_radio_tpu_torch.config import CONFIG

    batch, payloads = _signal_batch(2, leads=(0, 5), carriers=(3000.0, 3000.0))
    noise = np.random.default_rng(3).normal(0, 0.3, (1, batch.shape[1])).astype(np.float32)
    batch = np.concatenate([batch, noise])
    monkeypatch.setitem(CONFIG._config["tpu"], "int16_rows", True)
    shaped = tb.host_shape_batch(batch, "QPSK", 9600, device="cpu")
    assert shaped.dtype == np.int16 and shaped.ndim == 3
    raws = tb.decode_sample_batch(batch, "QPSK", 9600, device="cpu")
    assert [f.data for f in t_parse(raws[0])] == [payloads[0]]
    assert [f.data for f in t_parse(raws[1])] == [payloads[1]]
    assert t_parse(raws[2]) == []


def test_host_shape_rule_and_unported_kinds():
    batch = np.zeros((1, 1 << 16), np.float32)
    assert tb.host_shape_batch(batch, "QPSK", 9600, device="cpu").dtype == np.float32
    assert tb.host_shape_batch(batch, "FSK1200", 1200, device="cpu") is not None
    assert tb.resolve_demod_plan("NOPE", 9600) == tb.resolve_demod_plan("QPSK", 9600)
    for mode in ("BPSK", "8PSK", "FSK1200", "OFDM4", "DSSS", "NEURAL", "HELLSCHREIBER"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tb.demod_pack_batch(torch.zeros((1, 1 << 16)), mode, 9600)


def test_decode_wav_batch_matches_jax(workdir):
    contents, wavs = [], []
    for i in range(3):
        data = bytes(f"wav batch file {i} ".encode() * (30 + 10 * i))
        p = workdir / f"src{i}.bin"
        p.write_bytes(data)
        wavs.append(encode_file(str(p), mode="QPSK", symbol_rate=9600))
        contents.append(data)
    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    (workdir / "big.bin").write_bytes(big)
    parts = split_file_for_transmission(str(workdir / "big.bin"), "QPSK", 9600, 2)
    assert len(parts) > 1
    wavs += encode_file_parts(parts, "QPSK", True, 9600)

    ref = j_decode_wav_batch(wavs, "QPSK", 9600, recv_dir="recv_jax", registry=JRegistry())
    got = tb.decode_wav_batch(wavs, "QPSK", 9600, recv_dir="recv_torch", registry=TRegistry(), device="cpu")
    assert [len(g) for g in got] == [len(r) for r in ref]
    read = lambda paths: sorted(open(p, "rb").read() for r in paths for p in r)  # noqa: E731
    assert read(got) == read(ref) == sorted(contents + [big])


def test_port_tx_jax_rx(workdir):
    data = bytes(range(256)) * 5
    framed = pack_frame("tx.bin", data, 0, 1, len(data), crc32(data))
    wave = t_modulate("QPSK", framed, 9600)
    batch = np.zeros((1, 1 << 17), np.float32)
    batch[0, : len(wave)] = wave
    frames = j_parse(j_decode_sample_batch(batch, "QPSK", 9600)[0])
    assert [f.data for f in frames] == [data]


def test_jax_tx_port_rx(workdir):
    data = bytes(range(255, -1, -1)) * 5
    p = workdir / "rx.bin"
    p.write_bytes(data)
    wav = encode_file(str(p), mode="QPSK", symbol_rate=9600)
    saved = tb.decode_wav_batch([wav], "QPSK", 9600, registry=TRegistry(), device="cpu")
    assert len(saved[0]) == 1 and open(saved[0][0], "rb").read() == data


def test_port_wav_roundtrip_and_corrupt_file(workdir):
    """Port TX -> WAV -> port RX; an unreadable WAV decodes to nothing and
    does not lose the other captures."""
    data = b"port round trip " * 50
    framed = pack_frame("rt.bin", data, 0, 1, len(data), crc32(data))
    write_wav("rt.wav", t_modulate("QPSK", framed, 9600))
    with open("bad.wav", "wb") as f:
        f.write(b"RIFFgarbage")
    saved = tb.decode_wav_batch(["rt.wav", "bad.wav"], "QPSK", 9600, registry=TRegistry(), device="cpu")
    assert saved[1] == [] and open(saved[0][0], "rb").read() == data


def test_fec_tagged_frame_left_unsaved(workdir):
    from audio_modem_radio_tpu_torch.decoder import save_decoded_files
    from audio_modem_radio_tpu_torch.framing import Frame

    frame = Frame("x.bin", b"FECV" + b"\x00" * 20, 0, 1, 24, 0)
    assert save_decoded_files([frame], "recv", TRegistry()) == []
