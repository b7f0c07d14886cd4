"""The port's single-capture FSK receive chain vs the JAX package's, on the
CPU: ``modem.demodulate`` and the ``fsk_demodulate`` family,
``decode_wav_file``, ``decode_with_retry``'s nominal MLSE attempt, the empty
no-sync rescue, the batch's single-capture fallbacks (CONFIG
``modem.batch_mlse`` and ``tpu.demod_backend = "xla"``) and
``decode_wav_batch``'s MLSE escalation. ``fsk_demod_bits`` itself is
``tests/test_torch_fsk_single.py``, on the same captures.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames
from audio_modem_radio_tpu.ops import fsk as jfsk
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.parallel.mesh import get_mesh

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
# Capture -> (mode, symbol rate, baud, mark, space, payload bytes, samples, lead).
# Lengths are bucket sizes, so the decoders' bucket padding keeps them.
CAPS = {
    "FSK1200": ("FSK1200", 1200, 1200.0, 1200.0, 2200.0, 200, 1 << 18, 311),
    "FSK9600": ("FSK9600", 9600, 9600.0, 1200.0, 2200.0, 300, 1 << 16, 211),
    "FSK19200": ("FSK19200", 19200, 19200.0, 8000.0, 16000.0, 1200, 1 << 16, 55),
    "MSK@9600": ("MSK", 9600, 9600.0, 6000.0, 15600.0, 500, 1 << 16, 13),
    "FT8": ("FT8", 50, 50.0, 3000.0, 3050.0, 12, 1 << 18, 0),
}
_MODES = list(CAPS)
# The marginal FSK9600 capture of tests/test_batch_ladder.py: the
# equalizer-only receiver loses it, MLSE recovers it.
_MARGINAL = (300, 5, 0.08, 2001)


def _payload(name: str) -> bytes:
    return np.random.default_rng(sum(map(ord, name))).integers(0, 256, CAPS[name][5], dtype=np.uint8).tobytes()


def _wave(name: str) -> np.ndarray:
    """The capture's wave: a framed payload through the JAX modulator (FT8:
    the bare payload, as no frame fits 2^18 samples at 50 Bd)."""
    _mode, _rate, baud, mark, space, _nb, _n, _lead = CAPS[name]
    data = _payload(name)
    framed = data if name == "FT8" else pack_frame(f"{name}.bin", data, 0, 1, len(data), crc32(data))
    return np.asarray(jfsk.fsk_modulate(framed, baud, mark, space, SR), np.float32)


@pytest.fixture(scope="module")
def caps():
    out = {}
    for name, (_mode, _rate, _b, _m, _s, _nb, n, lead) in CAPS.items():
        w = _wave(name)
        assert lead + len(w) <= n, name
        x = np.zeros(n, np.float32)
        x[lead : lead + len(w)] = w
        out[name] = x
    return out


@pytest.fixture(scope="module")
def marginal():
    n_bytes, seed, sigma, noise_seed = _MARGINAL
    data = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    wave = np.asarray(jmodem.modulate("FSK9600", pack_frame("m.bin", data, 0, 1, len(data), crc32(data)), 9600),
                      np.float32)
    return data, (wave + np.random.default_rng(noise_seed).normal(0, sigma, len(wave))).astype(np.float32)


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


def _frames(raw: bytes):
    return [(f.name, f.part_number, f.data) for f in parse_frames(raw)]


# --- the receive chain ----------------------------------------------------------------

@pytest.mark.parametrize("name", _MODES)
def test_modem_demodulate_bytes_equal(caps, name):
    """``modem.demodulate`` (and the ``fsk_demodulate`` family under it)
    gives the JAX package's bytes; every framed capture parses its payload."""
    mode, rate = CAPS[name][:2]
    x = caps[name]
    got = tmodem.demodulate(mode, x, rate, device="cpu")
    assert got == jmodem.demodulate(mode, x, rate)
    if name != "FT8":
        assert [f[2] for f in _frames(got)] == [_payload(name)]
    direct = {
        "FSK9600": lambda: tfsk.fsk_demodulate(x, 9600, device="cpu"),
        "FSK19200": lambda: tmodem.fsk_high_speed_demodulate(x, 19200, device="cpu"),
        "MSK@9600": lambda: tmodem.msk_demodulate(x, 9600, 6000.0, device="cpu"),
        "FT8": lambda: tmodem.ft8_demodulate(x, 50, 3000.0, device="cpu"),
    }.get(name)
    if direct is not None:
        assert direct() == got


@pytest.mark.parametrize("name", _MODES)
def test_decode_wav_file_saves_equal_files(caps, tmp_path, name):
    """``decode_wav_file`` of a WAV written by the port: the same saved
    files in both packages (FT8's capture holds no whole frame: none)."""
    mode, rate = CAPS[name][:2]
    path = str(tmp_path / "c.wav")
    write_wav(path, caps[name])
    got = tdec.decode_wav_file(path, mode, rate, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                               device="cpu")
    ref = jdec.decode_wav_file(path, mode, rate, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    read = lambda paths: [open(p, "rb").read() for p in paths]  # noqa: E731
    assert read(got) == read(ref)
    assert read(got) == ([] if name == "FT8" else [_payload(name)])


@pytest.mark.parametrize("mode", ["FSK1200", "FSK9600", "FSK19200", "MSK", "FT8"])
def test_nosync_streams_empty_for_fsk(mode):
    """The no-sync rescue has no FSK streams, in either package."""
    x = np.random.default_rng(3).normal(0, 0.2, 4096).astype(np.float32)
    assert tdec._nosync_streams(x, mode, 9600, device="cpu") == jdec._nosync_streams(x, mode, 9600) == []


def test_decode_with_retry_nominal_runs_mlse(marginal, tmp_path):
    """The nominal attempt of ``decode_with_retry`` is the MLSE-refined
    receiver: the marginal capture, which the equalizer-only receiver
    loses, saves its file in both packages."""
    data, x = marginal
    got = tdec.decode_with_retry(x, "FSK9600", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                 device="cpu")
    ref = jdec.decode_with_retry(x, "FSK9600", 9600, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in ref] == [data]


# --- the batch ------------------------------------------------------------------------

@pytest.mark.parametrize("name,setting", [("FSK9600", "mlse"), ("FSK1200", "xla"), ("FSK9600", "xla"),
                                          ("FSK19200", "xla")])
def test_decode_sample_batch_mlse_and_xla_match_jax(caps, configs, name, setting):
    """``decode_sample_batch`` under CONFIG ``modem.batch_mlse`` (flat
    captures, the MLSE-refined receiver per capture) and under
    ``tpu.demod_backend = "xla"`` (the JAX package's XLA layouts: unpadded
    dual-tone rows, FIR windows): the same byte streams as the JAX
    package's on two captures, one shifted by 7 samples."""
    if setting == "mlse":
        configs("modem", "batch_mlse", True)
    else:
        configs("tpu", "demod_backend", "xla")
    mode, rate = CAPS[name][:2]
    batch = np.stack([caps[name], np.roll(caps[name], 7)])
    got = tb.decode_sample_batch(batch, mode, rate, device="cpu")
    assert got == jb.decode_sample_batch(batch, mode, rate, mesh=get_mesh(1))
    assert [[f[2] for f in _frames(r)] for r in got] == [[_payload(name)]] * 2


def test_batch_fsk_mlse_escalation(marginal, tmp_path, monkeypatch):
    """The JAX package's test of ``decode_wav_batch``'s MLSE escalation,
    through the port: the single-capture receiver saves the marginal
    capture, the equalizer-only batch parses nothing, and the batch of a
    healthy and the marginal capture saves both, re-dispatching only the
    lost one. The MLSE batch's stream equals the JAX package's single-capture
    MLSE stream, whose bits differ from the port's on at most 1e-4 of them."""
    data, x = marginal
    single = tdec.decode_from_buffer(x, "FSK9600", 9600, recv_dir=str(tmp_path / "single"), registry=TRegistry(),
                                     device="cpu")
    assert single and open(single[0], "rb").read() == data
    assert not parse_frames(tb.decode_sample_batch(x[None], "FSK9600", 9600, device="cpu", fsk_mlse=False)[0])
    got = tb.decode_sample_batch(x[None], "FSK9600", 9600, device="cpu", fsk_mlse=True)
    assert got[0] == jfsk.fsk_demodulate(x, 9600) and _frames(got[0]) == [("m.bin", 0, data)]
    bits_t = tfsk.fsk_demod_bits(torch.from_numpy(x), 9600.0, 1200.0, 2200.0, SR)[0].numpy()
    bits_j = np.asarray(jfsk.fsk_demod_bits(jnp.asarray(x), 9600.0, 1200.0, 2200.0, SR)[0])
    assert float(np.mean(bits_t != bits_j)) <= 1e-4

    healthy_data = b"healthy capture " * 30
    healthy = tmodem.modulate("FSK9600", pack_frame("ok.bin", healthy_data, 0, 1, len(healthy_data),
                                                    crc32(healthy_data)), 9600)
    paths = [str(tmp_path / "ok.wav"), str(tmp_path / "marginal.wav")]
    write_wav(paths[0], healthy)
    write_wav(paths[1], x)
    calls = []
    dispatch = tb.decode_sample_batch

    def counted(batch, *a, **kw):
        calls.append((batch.shape[0], kw.get("fsk_mlse")))
        return dispatch(batch, *a, **kw)

    monkeypatch.setattr(tb, "decode_sample_batch", counted)
    results = tb.decode_wav_batch(paths, "FSK9600", 9600, recv_dir=str(tmp_path / "batch"), registry=TRegistry(),
                                  device="cpu")
    assert [[open(p, "rb").read() for p in r] for r in results] == [[healthy_data], [data]]
    assert calls == [(2, None), (1, True)]
