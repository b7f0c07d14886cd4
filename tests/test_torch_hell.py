"""The port's Hellschreiber text modes (``ops/hell.py`` and the modem,
encoder, batch and decoder branches) vs the JAX package's, on the CPU:
HELLSCHREIBER, FELD_HELL (122.5 pixels/s) and SLOW_HELL (61.25).

Captures are made with numpy from seeds, at most 2^18 samples: a
transmission of two characters (one at SLOW_HELL) from sample 0 or after
a whole number of silent rows, noise, and edge cases of the batched stop
and sync rules. The modulated waves compare within 1e-6, decoded texts and
saved files exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import encoder as jenc
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.ops import hell as jhell
from audio_modem_radio_tpu.parallel import batch as jb

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import encoder as tenc
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.ops import hell as thell
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N = 1 << 18
_BAUD = {"HELLSCHREIBER": 122.5, "FELD_HELL": 122.5, "SLOW_HELL": 61.25}
_TEXT = {"HELLSCHREIBER": "CQ", "FELD_HELL": "K9", "SLOW_HELL": "Z"}


def _place(wave, lead: int = 0, n: int = N) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = wave[: n - lead]
    return x


def _spp(mode: str) -> int:
    return int(round(SR / _BAUD[mode]))


@pytest.mark.parametrize("mode", list(_BAUD))
def test_modulate_matches_jax(mode):
    framed = _TEXT[mode].encode() + b"\xff"  # a byte utf-8 drops
    ref = np.asarray(jmodem.modulate(mode, framed, 9600), np.float32)
    got = tmodem.modulate(mode, framed, 9600)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) <= 1e-6
    assert np.array_equal(thell._glyph_pixel_templates(), jhell._glyph_pixel_templates())
    assert thell.char_map() == jhell.char_map()
    text = "Hello, ~{}|é"  # the last character is outside the font
    assert np.array_equal(thell.text_to_pixels(text), jhell.text_to_pixels(text))


@pytest.mark.parametrize("mode", list(_BAUD))
def test_single_capture_decoders_match_jax(mode):
    """``detect_pixels`` and ``hellschreiber_demodulate`` (the block and the
    naive decoder) through ``modem.demodulate`` and directly: equal text,
    for a transmission from sample 0 and one after two silent rows (which
    the block decoder, expecting the sync run first, reads as glyphs); the
    block decoder runs on into the silence after the closing rows, as in
    the JAX package."""
    wave = thell.hellschreiber_modulate(_TEXT[mode], _BAUD[mode])
    baud = _BAUD[mode]
    for lead in (0, 14 * _spp(mode)):
        x = _place(wave, lead)
        assert np.array_equal(thell.detect_pixels(x, baud, device="cpu"), jhell.detect_pixels(x, baud))
        got = tmodem.demodulate(mode, x, 9600, device="cpu")
        assert got == jmodem.demodulate(mode, x, 9600)
        assert got.decode().startswith(_TEXT[mode]) == (lead == 0)
        for naive in (False, True):
            assert thell.hellschreiber_demodulate(x, baud, naive=naive, device="cpu") == \
                jhell.hellschreiber_demodulate(x, baud, naive=naive)


def _batch(mode: str) -> np.ndarray:
    """A transmission from sample 0, the same after two silent rows (the
    sync gate rejects it: the run must open the capture), noise, silence,
    and all-on tone (no row ends the sync run)."""
    wave = thell.hellschreiber_modulate(_TEXT[mode], _BAUD[mode])
    spp = _spp(mode)
    rng = np.random.default_rng(len(mode))
    tone = np.sin(2 * np.pi * 1000.0 * np.arange(N) / SR).astype(np.float32)
    return np.stack([_place(wave), _place(wave, 14 * spp), rng.normal(0, 0.2, N).astype(np.float32),
                     np.zeros(N, np.float32), 0.8 * tone])


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["HELLSCHREIBER", "SLOW_HELL"])
def test_hell_demod_text_batch_matches_jax(mode, dtype, monkeypatch):
    """``hell_demod_text_batch`` on flat captures and on the host's pixel
    windows (float32, or int16 under CONFIG ``tpu.int16_rows``, equal to the
    JAX package's): chars, n_chars and found equal (found: the boolean
    first-index rules, cast before the argmax)."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    for cfg in (JCONFIG, TCONFIG):
        monkeypatch.setitem(cfg._config["tpu"], "int16_rows", dtype == "int16")
    xs = _batch(mode)
    shaped = tb.host_shape_batch(xs, mode, 9600, device="cpu")
    assert shaped.dtype == np.dtype(dtype) and shaped.shape == (5, N // _spp(mode), _spp(mode))
    assert np.array_equal(shaped, jb.host_shape_batch(xs, mode, 9600))
    for x in (xs, shaped):
        ref = [np.asarray(a) for a in jhell.hell_demod_text_batch(jnp.asarray(x), _spp(mode))]
        got = [a.numpy() for a in thell.hell_demod_text_batch(torch.from_numpy(x), _spp(mode))]
        assert all(np.array_equal(g, r) for g, r in zip(got, ref))
        assert list(got[2]) == [True, False, False, False, True]
        assert bytes(got[0][0, : got[1][0]]).decode() == _TEXT[mode] and list(got[1][1:]) == [0, 0, 0, 0]
    assert thell.hellschreiber_demodulate_batch(xs, _BAUD[mode], device="cpu") == \
        jhell.hellschreiber_demodulate_batch(xs, _BAUD[mode])


@pytest.mark.parametrize("mode", list(_BAUD))
def test_decode_sample_and_wav_batch_match_jax(tmp_path, mode):
    """``decode_sample_batch`` gives the text bytes; ``decode_wav_batch``
    saves one text file per capture that decoded (none for the rejected
    ones) with the JAX package's names and contents."""
    xs = _batch(mode)
    got = tb.decode_sample_batch(xs, mode, 9600, device="cpu")
    assert got == jb.decode_sample_batch(xs, mode, 9600)
    assert got[0] == _TEXT[mode].encode()
    paths = []
    for i, x in enumerate(xs[:3]):
        paths.append(str(tmp_path / f"h{i}.wav"))
        write_wav(paths[-1], x)
    out = {}
    for tag, fn, kw in (("t", tb.decode_wav_batch, {"device": "cpu"}), ("j", jb.decode_wav_batch, {})):
        saved = fn(paths, mode, 9600, recv_dir=str(tmp_path / tag), **kw)
        out[tag] = [[(os.path.basename(p).split("_", 2)[2], open(p).read()) for p in s] for s in saved]
    assert out["t"] == out["j"] == [[("h0.txt", _TEXT[mode])], [], []]


@pytest.mark.parametrize("mode", list(_BAUD))
def test_decode_wav_file_and_encoder_match_jax(tmp_path, mode):
    """``encode_hellschreiber_text`` writes the JAX package's WAV (name and
    bytes); ``decode_wav_file`` of it saves the same text file, and of a
    noise WAV saves nothing, in both packages."""
    baud = _BAUD[mode]
    tw = tenc.encode_hellschreiber_text(_TEXT[mode], cache_dir=str(tmp_path / "tc"), baud=baud)
    jw = jenc.encode_hellschreiber_text(_TEXT[mode], cache_dir=str(tmp_path / "jc"), baud=baud)
    assert os.path.basename(tw) == os.path.basename(jw)
    t_bytes, j_bytes = open(tw, "rb").read(), open(jw, "rb").read()
    assert t_bytes[:44] == j_bytes[:44] and len(t_bytes) == len(j_bytes)
    diff = np.frombuffer(t_bytes[44:], np.int16).astype(np.int32) - np.frombuffer(j_bytes[44:], np.int16)
    assert int(np.max(np.abs(diff))) <= 1
    noise = str(tmp_path / "noise.wav")
    write_wav(noise, np.random.default_rng(3).normal(0, 0.2, N).astype(np.float32))
    for path, want in ((tw, _TEXT[mode]), (noise, None)):
        t = tdec.decode_wav_file(path, mode, 9600, recv_dir=str(tmp_path / "t"), device="cpu")
        j = jdec.decode_wav_file(path, mode, 9600, recv_dir=str(tmp_path / "j"))
        assert [os.path.basename(p).split("_", 2)[2] for p in t] == [os.path.basename(p).split("_", 2)[2] for p in j]
        assert [open(p).read() for p in t] == [open(p).read() for p in j] == ([want] if want else [])
