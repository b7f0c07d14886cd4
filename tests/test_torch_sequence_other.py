"""The port's sequence-parallel dual-tone FSK, OFDM, NEURAL and HELL
(``parallel/sequence.py``) vs the JAX package's, on the CPU.

One capture per family through both packages' ``decode_capture_sharded``:
the port on a mesh repeating the CPU, the JAX package on its virtual CPU
mesh, 4 shards (FSK1200 on 5). FSK1200, OFDM4 and NEURAL transmit after
more than a shard of silence; the HELL text opens its capture. Each case
first asserts that both packages took the same consensus (the FSK bit
offset and OFDM sample offset from summed float32 scores, NEURAL's winning
shard and global lag), then the demodulator's bits, dibits, symbols or
pixels equal over the whole stream, and the decoded bytes equal, parsing
to the payload (HELL: the text). Close-tone FSK (FSK9600) raises in both.
"""

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu.parallel import mesh as jm
from audio_modem_radio_tpu.parallel import sequence as js

from audio_modem_radio_tpu_torch.framing import parse_frames
from audio_modem_radio_tpu_torch.ops.fsk import fsk_demodulate
from audio_modem_radio_tpu_torch.parallel import mesh as tm
from audio_modem_radio_tpu_torch.parallel import sequence as ts

from torch_sequence_ref import HELL_TEXT, PAYLOAD, capture, jax_decode, pick

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

# family -> (mode, rate, kind, shards)
FAMILIES = {
    "FSK1200": ("FSK1200", 1200, "fsk", 5),
    "OFDM4": ("OFDM4", 4800, "ofdm", 4),
    "NEURAL": ("NEURAL", 1200, "neural", 4),
    "HELL": ("HELLSCHREIBER", 1200, "hell", 4),
}


def _mesh(k: int) -> tm.Mesh:
    return tm.get_mesh(devices=["cpu"] * k)


@pytest.fixture(scope="module")
def cases():
    """family -> (capture, the JAX reference), one JAX decode each."""
    out = {}
    for fam, (mode, rate, kind, shards) in FAMILIES.items():
        x = capture(mode, rate)
        out[fam] = (x, jax_decode(x, mode, rate, kind, shards))
    return out


def test_fsk_bits_match_jax(cases):
    x, ref = cases["FSK1200"]
    bits, best = ts._fsk_shards(x, 1200.0, 1200.0, 2200.0, _mesh(5), 96000, 8)
    assert best == pick(ref, (8,))
    assert np.array_equal(torch.cat(bits).numpy(), ref["streams"][0])


def test_ofdm_dibits_match_jax(cases):
    x, ref = cases["OFDM4"]
    his, los, off = ts._ofdm_shards(x, 4800.0, 12000.0, 4, _mesh(4), 96000)
    S = 2 * 96000 // 4800
    assert off == pick(ref, (S,))
    assert np.array_equal(torch.cat(his).numpy(), ref["streams"][0])
    assert np.array_equal(torch.cat(los).numpy(), ref["streams"][1])


def test_neural_symbols_match_jax(cases):
    x, ref = cases["NEURAL"]
    syms, k0, win = ts._neural_shards(x, 1200, _mesh(4))
    assert win == pick(ref, (4,))
    assert k0 == int(ref["streams"][1]) and k0 > len(x) // 4  # found past the silent first shard
    assert np.array_equal(torch.cat(syms).numpy(), ref["streams"][0])


def test_hell_pixels_match_jax(cases):
    x, ref = cases["HELL"]
    pixels = ts.demod_hell_capture_sharded(x, 122.5, _mesh(4))
    assert np.array_equal(pixels.numpy(), ref["streams"][0])


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_decode_capture_sharded_bytes_match_jax(cases, fam):
    mode, rate, _kind, shards = FAMILIES[fam]
    x, ref = cases[fam]
    got = ts.decode_capture_sharded(x, mode, rate, _mesh(shards))
    assert got == ref["bytes"]
    if fam == "HELL":
        assert got.decode("utf-8") == HELL_TEXT
    else:
        frames = parse_frames(got)
        assert frames and frames[0].data == PAYLOAD


def test_fsk_sharded_matches_single_device(cases):
    x, _ref = cases["FSK1200"]
    sharded = parse_frames(ts.decode_capture_sharded(x, "FSK1200", 1200, _mesh(4)))
    single = parse_frames(fsk_demodulate(x, 1200, 1200.0, 2200.0, 96000, device="cpu"))
    assert sharded and single and sharded[0].data == single[0].data == PAYLOAD


def test_close_tone_fsk_raises_in_both():
    x = np.zeros(96000, np.float32)
    with pytest.raises(ValueError, match="dual-tone"):
        js.demod_fsk_capture_sharded(x, 9600.0, 1200.0, 2200.0, jm.get_mesh(4))
    with pytest.raises(ValueError, match="dual-tone"):
        ts.demod_fsk_capture_sharded(x, 9600.0, 1200.0, 2200.0, _mesh(4))
    with pytest.raises(ValueError, match="dual-tone"):
        ts.decode_capture_sharded(x, "FSK9600", 9600, _mesh(4))


def test_ofdm_shard_too_short_raises_in_both():
    """At 300 Bd a symbol is 640 samples and a row holds one: a shard of
    one row has fewer than three symbols for the timing search."""
    x = np.zeros(1000, np.float32)
    with pytest.raises(ValueError, match="too short"):
        js.demod_ofdm_capture_sharded(x, 300.0, 12000.0, 4, jm.get_mesh(8))
    with pytest.raises(ValueError, match="too short"):
        ts.demod_ofdm_capture_sharded(x, 300.0, 12000.0, 4, _mesh(8))
