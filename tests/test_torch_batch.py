"""The PyTorch port's batched PSK receive (DQPSK, DBPSK, D8PSK) vs the JAX
package's, on the CPU: the sync tails, the sample-batch decode, the
WAV-batch decode with saving, the compatibility aliases, int8 rows, and
cross decodes in both directions."""

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
    demod_pack_batch as j_demod_pack_batch,
    host_shape_batch as j_host_shape_batch,
    psk2_kernel_sync_tail as j_psk2_tail,
    psk4_kernel_sync_tail as j_sync_tail,
    psk8_kernel_sync_tail as j_psk8_tail,
)

from audio_modem_radio_tpu_torch import modulate as t_modulate
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import parse_frames as t_parse
from audio_modem_radio_tpu_torch.ops.psk import (
    bpsk_modulate,
    psk8_real_modulate,
    psk8_sector_rows_batch,
    psk_decision_streams_batch,
    qpsk_modulate,
)
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

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
    # The kinds once refused (ROADMAP.md queue 1 items 4-6) demodulate a
    # silent capture as the JAX package's do.
    for mode in ("OFDM4", "DSSS", "HELLSCHREIBER"):
        ref = [np.asarray(a) for a in j_demod_pack_batch(jnp.zeros((1, 1 << 16)), mode, 9600)]
        got = [a.numpy() for a in tb.demod_pack_batch(torch.zeros((1, 1 << 16)), mode, 9600)]
        assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2]), mode
        assert np.array_equal(got[0][0, : got[1][0]], ref[0][0, : ref[1][0]]), mode
    # PSK31 has no blocked path and flat close-tone FSK no fused layout: the
    # single-capture receiver per capture (flat dual-tone FSK runs K13's
    # path, tests/test_torch_fsk.py), equal to the JAX package's on a
    # silent capture.
    for mode, rate in (("PSK31", 31), ("FSK9600", 9600)):
        ref = [np.asarray(a) for a in j_demod_pack_batch(jnp.zeros((1, 1 << 16)), mode, rate)]
        got = [a.numpy() for a in tb.demod_pack_batch(torch.zeros((1, 1 << 16)), mode, rate)]
        assert all(np.array_equal(g, r) for g, r in zip(got, ref)), mode


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
    """A CRC-valid frame whose payload is an FEC container unwraps and
    saves, as the JAX package's ``save_decoded_files`` does: ``FECV``
    through the Viterbi (on the CPU here), ``FECP`` through the parity
    code. (The name dates from when the port left such frames unsaved.)"""
    from audio_modem_radio_tpu.decoder import save_decoded_files as j_save
    from audio_modem_radio_tpu.fec import wrap_fec
    from audio_modem_radio_tpu.framing import Frame as JFrame
    from audio_modem_radio_tpu.utils.compression import intelligent_compress
    from audio_modem_radio_tpu_torch.decoder import save_decoded_files
    from audio_modem_radio_tpu_torch.framing import Frame

    data = b"fec tagged " * 25
    for i, ftype in enumerate(("convolutional", "reed_solomon")):
        blob = wrap_fec(intelligent_compress(data), ftype)
        got = save_decoded_files([Frame(f"x{i}.bin", blob, 0, 1, len(data), crc32(data))], "recv_t",
                                 TRegistry(), device="cpu")
        ref = j_save([JFrame(f"x{i}.bin", blob, 0, 1, len(data), crc32(data))], "recv_j", JRegistry())
        assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in ref] == [data]


# --- DBPSK and D8PSK -------------------------------------------------------------

_MODULATORS = {"BPSK": (bpsk_modulate, 3000.0), "8PSK": (psk8_real_modulate, 12000.0)}


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


def _mode_batch(mode: str, seed: int, n: int = 1 << 17, leads=(0, 311), offsets=(0.0, 60.0),
                noise: bool = False):
    """Captures of framed ``mode`` waves (payloads of 300-1500 B) at the
    given leads and carrier offsets, plus one noise capture on request."""
    rng = np.random.default_rng(seed)
    modulate, carrier = _MODULATORS[mode]
    payloads, rows = [], []
    for i, (lead, df) in enumerate(zip(leads, offsets)):
        p = rng.integers(0, 256, 300 + 600 * i, dtype=np.uint8).tobytes()
        wave = modulate(pack_frame(f"{mode}{i}.bin", p, 0, 1, len(p), crc32(p)), 9600, carrier + df)
        row = np.zeros(n, np.float32)
        row[lead : lead + len(wave)] = wave
        rows.append(row)
        payloads.append(p)
    if noise:
        rows.append(rng.normal(0, 0.3, n).astype(np.float32))
        payloads.append(None)
    return np.stack(rows), payloads


def _compare_tail(kind, streams, cfo_retry):
    """Port tail vs JAX tail (interpret mode): found and n_valid exactly,
    packed bytes on [0, n_valid) (K4) or [0, n_valid - 1) (K6)."""
    if kind == "psk2":
        ref = j_psk2_tail(*(jnp.asarray(x) for x in streams), cfo_retry, interpret=True)
        got = tb.psk2_kernel_sync_tail(*(torch.from_numpy(x) for x in streams), cfo_retry)
        end = 0
    else:
        ref = j_psk8_tail(jnp.asarray(streams[0]), cfo_retry, interpret=True)
        got = tb.psk8_kernel_sync_tail(torch.from_numpy(streams[0]), cfo_retry)
        end = 1
    packed_j, n_valid_j, found_j = (np.asarray(x) for x in ref)
    packed_t, n_valid_t, found_t = (x.numpy() for x in got)
    assert np.array_equal(found_t, found_j) and np.array_equal(n_valid_t, n_valid_j)
    for i in range(len(found_t)):
        k = n_valid_t[i] - end
        assert np.array_equal(packed_t[i, :k], packed_j[i, :k]), i
    return packed_t, n_valid_t, found_t


@pytest.mark.parametrize("cfo_retry", [True, False])
@pytest.mark.parametrize("mode", ["BPSK", "8PSK"])
def test_psk2_psk8_sync_tails_match_jax_on_signal(mode, cfo_retry):
    """Decisions of a real batch (one capture 60 Hz off its carrier) with a
    noise capture; at 256 rows the tail has no prefix tier, so this is the
    full scan (the tier tests below escalate)."""
    batch, payloads = _mode_batch(mode, 11, noise=True)
    x = torch.from_numpy(batch)
    if mode == "BPSK":
        kind, streams = "psk2", psk_decision_streams_batch(x, 9600.0, 3000.0, 96000, n_psk=2, cfo=cfo_retry)
    else:
        kind, streams = "psk8", (psk8_sector_rows_batch(x, 9600.0, 12000.0, 96000, cfo=cfo_retry),)
    packed, n_valid, found = _compare_tail(kind, [s.numpy() for s in streams], cfo_retry)
    for i, p in enumerate(payloads):
        frames = t_parse(packed[i, : n_valid[i]].tobytes())
        if p is None:
            assert frames == []
        else:
            assert found[i] and [f.data for f in frames] == [p]


def _magic_pattern() -> np.ndarray:
    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    return np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)


def _bpsk_lanes(rng, r, h, start):
    """Random re/im sign-bit lanes with the magic + validation pattern at
    bit ``start`` of stream h & 1, complemented for h >= 2."""
    re = rng.integers(0, 2, r * 128, dtype=np.uint8)
    im = rng.integers(0, 2, r * 128, dtype=np.uint8)
    pat = _magic_pattern() ^ np.uint8(h >= 2)
    (im if h & 1 else re)[start : start + len(pat)] = pat
    return re, im


@pytest.mark.parametrize("cfo_retry", [True, False])
@pytest.mark.parametrize("scenario", ["prefix_hit", "escalate"])
def test_psk2_sync_tail_matches_jax_tiers(cfo_retry, scenario):
    """512-row captures: every capture matches hypothesis 0 inside the
    256-row tier, or one does not (past the tier, another hypothesis, or a
    noise capture) and the scan escalates."""
    rng = np.random.default_rng(12)
    r = 512
    caps = [(0, 2001), (0, 9000)] if scenario == "prefix_hit" else [(0, 2001), (0, 50_001), (1, 777), (3, 90)]
    lanes = [_bpsk_lanes(rng, r, h, bit) for h, bit in caps]
    if scenario == "escalate":
        lanes.append((rng.integers(0, 2, r * 128, dtype=np.uint8), rng.integers(0, 2, r * 128, dtype=np.uint8)))
    hi, lo = np.stack([x[0] for x in lanes]), np.stack([x[1] for x in lanes])
    _, _, found = _compare_tail("psk2", (hi, lo), cfo_retry)
    assert list(found[: len(caps)]) == [h == 0 or cfo_retry for h, _ in caps]


def _psk8_lanes(rng, r, k, lead):
    """Random received sectors whose tribits, read as rotation-k sectors,
    hold the magic + validation pattern at symbol ``lead``."""
    from audio_modem_radio_tpu_torch.ops.psk import _GRAY8_INV

    bits = rng.integers(0, 2, 3 * r * 128, dtype=np.uint8)
    pat = _magic_pattern()
    bits[3 * lead : 3 * lead + len(pat)] = pat
    tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
    return ((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8)


@pytest.mark.parametrize("cfo_retry", [True, False])
@pytest.mark.parametrize("scenario", ["prefix_hit", "escalate"])
def test_psk8_sync_tail_matches_jax_tiers(cfo_retry, scenario):
    """The earliest-position fold and the any-hypothesis tier acceptance
    (hypothesis 0 with cfo_retry off); with cfo_retry off a rotated capture
    is not found."""
    rng = np.random.default_rng(13)
    r = 512
    if scenario == "prefix_hit":
        caps = [(0, 300), (5, 9000)]
    else:
        caps = [(0, 300), (3, 50_001), (7, 20)]
    sec = [_psk8_lanes(rng, r, k, lead) for k, lead in caps]
    if scenario == "escalate":
        sec.append(rng.integers(0, 8, r * 128, dtype=np.uint8))
    _, _, found = _compare_tail("psk8", (np.stack(sec),), cfo_retry)
    assert list(found[: len(caps)]) == [k == 0 or cfo_retry for k, _ in caps]


@pytest.mark.parametrize("mode", ["BPSK", "8PSK"])
def test_decode_sample_batch_matches_jax_psk2_psk8(mode):
    batch, payloads = _mode_batch(mode, 14, leads=(0, 97), offsets=(0.0, 0.0), noise=True)
    got = _frames(tb.decode_sample_batch(batch, mode, 9600, device="cpu"), t_parse)
    ref = _frames(j_decode_sample_batch(batch, mode, 9600), j_parse)
    assert got == ref
    assert [[f[3] for f in g] for g in got] == [[payloads[0]], [payloads[1]], []]


@pytest.mark.parametrize("mode", ["BPSK", "8PSK"])
def test_cross_decode_both_ways_psk2_psk8(mode):
    data = bytes(range(256)) * 3
    framed = pack_frame(f"x_{mode}.bin", data, 0, 1, len(data), crc32(data))
    for tx, rx, parse in ((t_modulate, j_decode_sample_batch, j_parse),
                          (j_modulate, tb.decode_sample_batch, t_parse)):
        wave = np.asarray(tx(mode, framed, 9600), np.float32)
        batch = np.zeros((1, 1 << 17), np.float32)
        batch[0, 50 : 50 + len(wave)] = wave
        raws = rx(batch, mode, 9600) if rx is j_decode_sample_batch else rx(batch, mode, 9600, device="cpu")
        assert [f.data for f in parse(raws[0])] == [data]


def test_decode_wav_batch_8psk_matches_jax(workdir):
    contents, wavs = [], []
    for i in range(2):
        data = bytes(f"8psk wav {i} ".encode() * (40 + 20 * i))
        p = workdir / f"e{i}.bin"
        p.write_bytes(data)
        wavs.append(encode_file(str(p), mode="8PSK", symbol_rate=9600))
        contents.append(data)
    ref = j_decode_wav_batch(wavs, "8PSK", 9600, recv_dir="recv_jax", registry=JRegistry())
    got = tb.decode_wav_batch(wavs, "8PSK", 9600, recv_dir="recv_torch", registry=TRegistry(), device="cpu")
    read = lambda paths: sorted(open(p, "rb").read() for r in paths for p in r)  # noqa: E731
    assert [len(g) for g in got] == [1, 1]
    assert read(got) == read(ref) == sorted(contents)


@pytest.mark.parametrize("mode,key", [("8PSK", "psk8_compat_alias"), ("DSSS", "dsss_compat_alias")])
def test_compat_alias_captures_decode(mode, key, configs):
    """Under the alias flag the 8PSK wire format is DQPSK at 12 kHz and the
    DSSS one plain DBPSK at 3 kHz; both packages shape the rows alike."""
    configs("modem", key, True)
    data = b"alias capture " * 30
    wave = np.asarray(j_modulate(mode, pack_frame("al.bin", data, 0, 1, len(data), crc32(data)), 9600),
                      np.float32)
    batch = np.zeros((2, 1 << 17), np.float32)
    batch[0, 5 : 5 + len(wave)] = wave
    shaped = tb.host_shape_batch(batch, mode, 9600, device="cpu")
    assert shaped.ndim == 3 and np.array_equal(shaped, np.asarray(j_host_shape_batch(batch, mode, 9600)))
    raws = tb.decode_sample_batch(batch, mode, 9600, device="cpu")
    assert [f.data for f in t_parse(raws[0])] == [data] and t_parse(raws[1]) == []


@pytest.mark.parametrize("mode", ["QPSK", "8PSK"])
def test_int8_rows_match_jax_and_decode(mode, configs):
    """CONFIG tpu.int8_rows: int8 rows at scale 128, bitwise equal to the
    JAX package's host shaping, and the payloads still decode."""
    configs("tpu", "int8_rows", True)
    rng = np.random.default_rng(15)
    carrier = 12000.0 if mode == "8PSK" else 3000.0
    modulate = psk8_real_modulate if mode == "8PSK" else qpsk_modulate
    batch, payloads = np.zeros((2, 1 << 17), np.float32), []
    for i in range(2):
        p = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
        wave = modulate(pack_frame(f"i8_{i}.bin", p, 0, 1, len(p), crc32(p)), 9600, carrier)
        batch[i, 13 * i : 13 * i + len(wave)] = 1.3 * wave  # past full scale: clipped
        payloads.append(p)
    shaped = tb.host_shape_batch(batch, mode, 9600, device="cpu")
    assert shaped.dtype == np.int8
    assert np.array_equal(shaped, np.asarray(j_host_shape_batch(batch, mode, 9600)))
    raws = tb.decode_sample_batch(batch, mode, 9600, device="cpu")
    assert [[f.data for f in t_parse(r)] for r in raws] == [[p] for p in payloads]
