"""The port's DSSS (``ops/dsss.py``, ``ops/psk.py`` ``psk_raw_streams_batch``
and the modem, batch and decoder branches) vs the JAX package's, on the CPU.

Captures are made with numpy from seeds, at most 2^18 samples (DSSS
carries 75 bytes a second at 9600 chips a second), and handed to both
packages as numpy arrays: clean ones at odd leads, one at +30 Hz, one
with AWGN at -3 dB (the despread sum's processing gain keeps it
decodable), and noise. Tolerances: the modulated wave within 1e-6; the raw
chip phasors within 1e-4 of their largest magnitude; the soft bits within
1e-4; byte streams, parsed frames and saved files equal. On a clean capture
the despread differential is real after derotation, so the sign of its
imaginary part is rounding noise: the im no-sync stream is compared on the
noisy capture only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, crc32, pack_frame
from audio_modem_radio_tpu.ops import dsss as jdsss
from audio_modem_radio_tpu.ops import psk as jpsk
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.utils.compression import intelligent_compress

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import parse_frames
from audio_modem_radio_tpu_torch.ops import dsss as tdsss
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N = 1 << 18
_PAT = (MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)


def _framed(seed: int, n_bytes: int = 60):
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return p, pack_frame(f"d{seed}.bin", p, 0, 1, len(p), crc32(p))


def _place(wave, lead: int, n: int = N) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = wave
    return x


@pytest.fixture(scope="module")
def captures():
    """name -> (capture, payload or None)."""
    out = {}
    p, framed = _framed(1)
    out["clean"] = (_place(np.asarray(jdsss.dsss_real_modulate(framed, 9600, 3000.0)), 123), p)
    p, framed = _framed(2)
    out["+30Hz"] = (_place(tdsss.dsss_real_modulate(framed, 9600, 3030.0), 4567), p)
    rng = np.random.default_rng(3)
    p, framed = _framed(4)
    clean = _place(tdsss.dsss_real_modulate(framed, 9600, 3000.0), 999)
    sigma = np.sqrt(np.mean(clean[999 : 999 + 100000] ** 2) / 10 ** (-3.0 / 10))
    out["awgn"] = ((clean + rng.normal(0, sigma, N)).astype(np.float32), p)
    out["noise"] = (rng.normal(0, 0.3, N).astype(np.float32), None)
    return out


@pytest.mark.parametrize("baud", [9600, 4800])
def test_dsss_modulate_matches_jax(baud):
    _p, framed = _framed(baud)
    ref = np.asarray(jmodem.modulate("DSSS", framed, baud), np.float32)
    got = tmodem.modulate("DSSS", framed, baud)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) <= 1e-6
    assert np.array_equal(tdsss._despread_band(), jdsss._despread_band())


@pytest.mark.parametrize("layout", ["flat", "rows", "short"])
def test_psk_raw_streams_batch_matches_jax(captures, layout):
    """The batched raw chip phasors on flat captures, on the host's float32
    blocked rows (equal to the JAX package's; never int16 for DSSS) and on
    captures too short for the blocked path (the single-capture front end
    per capture): within 1e-4 of their largest magnitude."""
    xs = np.stack([captures[n][0] for n in ("clean", "+30Hz", "awgn")])
    if layout == "rows":
        shaped = tb.host_shape_batch(xs, "DSSS", 9600, device="cpu")
        assert shaped.dtype == np.float32 and shaped.ndim == 3
        assert np.array_equal(shaped, jb.host_shape_batch(xs, "DSSS", 9600))
        xs = shaped
    elif layout == "short":
        xs = xs[:, :2000]
    re_j, im_j = (np.asarray(a) for a in jpsk.psk_raw_streams_batch(jnp.asarray(xs), 9600.0, 3000.0, SR))
    re_t, im_t = tpsk.psk_raw_streams_batch(torch.from_numpy(xs), 9600.0, 3000.0, SR)
    scale = max(np.max(np.abs(re_j)), np.max(np.abs(im_j)))
    assert re_t.shape == re_j.shape and im_t.shape == im_j.shape
    assert np.max(np.abs(re_t.numpy() - re_j)) <= 1e-4 * scale
    assert np.max(np.abs(im_t.numpy() - im_j)) <= 1e-4 * scale


@pytest.mark.parametrize("name", ["clean", "+30Hz", "awgn", "noise"])
def test_single_capture_receivers_match_jax(captures, name):
    """``dsss_real_demodulate``, the tracked receiver and the no-sync
    streams byte-equal; the soft bits within 1e-4; the signal captures'
    frames recovered."""
    x, p = captures[name]
    raw = tdsss.dsss_real_demodulate(x, 9600, 3000.0, device="cpu")
    assert raw == jdsss.dsss_real_demodulate(x, 9600, 3000.0)
    tracked = tdsss.dsss_tracked_demodulate(x, 9600, 3000.0, device="cpu")
    assert tracked == jdsss.dsss_tracked_demodulate(x, 9600, 3000.0)
    if p is not None:
        assert [f.data for f in parse_frames(raw)] == [p]
        assert [f.data for f in parse_frames(tracked)] == [p]
    else:
        assert parse_frames(raw) == [] and parse_frames(tracked) == []
    ns_t = tdsss.dsss_nosync_streams(x, 9600, 3000.0, SR, device="cpu")
    ns_j = jdsss.dsss_nosync_streams(x, 9600, 3000.0, SR)
    assert ns_t[0] == ns_j[0] and len(ns_t[1]) == len(ns_j[1])
    if name in ("awgn", "noise"):
        assert ns_t[1] == ns_j[1]
    soft_t = tdsss.dsss_soft_bits(x, 9600, 3000.0, SR, device="cpu")
    soft_j = jdsss.dsss_soft_bits(x, 9600, 3000.0, SR)
    assert soft_t.shape == soft_j.shape and float(np.max(np.abs(soft_t - soft_j))) <= 1e-4


@pytest.mark.parametrize("n", [N, 100, 170])
def test_bits_cfo_batch_matches_jax(captures, n):
    """``dsss_bits_cfo_batch``: found, n_valid and the packed bytes within
    n_valid equal, on full captures and on captures of 10 and 17 chips (no
    despreadable bit, and one)."""
    xs = np.stack([captures[k][0][:n] for k in ("clean", "+30Hz", "noise")])
    ref = [np.asarray(a) for a in jdsss.dsss_bits_cfo_batch(jnp.asarray(xs), 9600.0, 3000.0, SR, *_PAT)]
    got = [a.numpy() for a in tdsss.dsss_bits_cfo_batch(torch.from_numpy(xs), 9600.0, 3000.0, SR, *_PAT)]
    assert np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])
    for i in range(3):
        assert np.array_equal(got[0][i, : got[1][i]], ref[0][i, : ref[1][i]])
    if n == N:
        assert list(got[2]) == [True, True, False]
    b_t = tdsss._despread_all_batch(torch.from_numpy(xs[:, :n]))
    b_j = np.asarray(jdsss._despread_all_batch(jnp.asarray(xs[:, :n])))
    assert b_t.shape == b_j.shape and np.allclose(b_t.numpy(), b_j, atol=1e-5)


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


@pytest.mark.parametrize("name", ["clean", "awgn", "noise", "alias capture"])
def test_modem_demodulate_matches_jax(captures, name):
    """``modem.demodulate``: the spread captures, noise (the DBPSK alias
    probe misses, then the tracked escalation runs) and a capture of the
    alias wire format with the alias flag off (the probe hits)."""
    if name == "alias capture":
        p, framed = _framed(5, 200)
        x = _place(tmodem.dsss_modulate(framed, 9600, 3000.0), 700, 1 << 16)
    else:
        x, p = captures[name]
    got = tmodem.demodulate("DSSS", x, 9600, device="cpu")
    assert got == jmodem.demodulate("DSSS", x, 9600)
    if p is not None:
        assert [f.data for f in parse_frames(got)] == [p]


def test_decode_sample_batch_matches_jax(captures):
    xs = np.stack([captures[k][0] for k in ("clean", "awgn", "noise")])
    got = tb.decode_sample_batch(xs, "DSSS", 9600, device="cpu")
    assert got == jb.decode_sample_batch(xs, "DSSS", 9600)
    assert [f.data for f in parse_frames(got[0])] == [captures["clean"][1]] and parse_frames(got[2]) == []


def _read_all(paths):
    return sorted(open(p, "rb").read() for p in paths)


def test_decode_wav_batch_file_and_retry_match_jax(tmp_path, captures):
    """Three DSSS WAVs (a compressed file, the +30 Hz capture, noise) through
    ``decode_wav_batch`` (the lost capture takes the tracked escalation and
    the drift retry), and the first through ``decode_wav_file``: the same
    saved files as the JAX package's. A one-sample capture saves nothing
    through ``decode_with_retry`` in both packages."""
    data = b"dsss wav file " * 20
    framed = pack_frame("w.bin", intelligent_compress(data), 0, 1, len(data), crc32(data))
    paths = []
    for i, x in enumerate((_place(tdsss.dsss_real_modulate(framed, 9600, 3000.0), 55), captures["+30Hz"][0],
                           captures["noise"][0])):
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], x)
    got = tb.decode_wav_batch(paths, "DSSS", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(journal_dir=""),
                              device="cpu")
    ref = jb.decode_wav_batch(paths, "DSSS", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry(journal_dir=""))
    assert [_read_all(g) for g in got] == [_read_all(r) for r in ref]
    assert _read_all(got[0]) == [data] and got[2] == []
    t = tdec.decode_wav_file(paths[0], "DSSS", 9600, recv_dir=str(tmp_path / "tf"),
                             registry=TRegistry(journal_dir=""), device="cpu")
    j = jdec.decode_wav_file(paths[0], "DSSS", 9600, recv_dir=str(tmp_path / "jf"), registry=JRegistry(journal_dir=""))
    assert _read_all(t) == _read_all(j) == [data]
    x = np.zeros(1, np.float32)
    assert tdec.decode_with_retry(x, "DSSS", 9600, recv_dir=str(tmp_path / "tr"), registry=TRegistry(journal_dir=""),
                                  device="cpu") == []
    assert jdec.decode_with_retry(x, "DSSS", 9600, recv_dir=str(tmp_path / "jr"),
                                  registry=JRegistry(journal_dir="")) == []


@pytest.mark.parametrize("name", ["clean", "awgn"])
def test_decoder_nosync_and_soft_streams_match_jax(captures, name):
    """The decoder's DSSS no-sync rescue streams and soft stream (both
    inversion hypotheses) equal the JAX package's."""
    x, _p = captures[name]
    nt, nj = tdec._nosync_streams(x, "DSSS", 9600, device="cpu"), jdec._nosync_streams(x, "DSSS", 9600)
    assert len(nt) == len(nj) == 2 and nt[0] == nj[0]
    got, n_psk = tdec._soft_bit_stream(x, "DSSS", 9600, device="cpu")
    ref, n_ref = jdec._soft_bit_stream(x, "DSSS", 9600)
    assert n_psk == n_ref == 2 and len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape and float(np.max(np.abs(g - r))) <= 1e-4
