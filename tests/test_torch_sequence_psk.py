"""The port's sequence-parallel PSK family (``parallel/sequence.py``: QPSK,
BPSK, 8PSK, DSSS) vs the JAX package's, on the CPU.

One capture per family, its transmission after more than a shard of
silence, through both packages' ``decode_capture_sharded``: the port on a
mesh repeating the CPU, the JAX package on its virtual CPU mesh, 4 shards
(BPSK on 5). The timing consensus takes the first maximum of float32
scores summed over the shards, which need not add in XLA's order, so each
case first asserts that both chose the same offset. Then the demodulator's
float streams within 1e-4 of their RMS, the decisions (Gray dibits, sign
bits, D8PSK sectors after the rotation estimate, DSSS's despread bits)
equal over the whole stream, and the decoded bytes equal, parsing to the
payload.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.ops import dsss as jdsss
from audio_modem_radio_tpu.ops import psk as jpsk

from audio_modem_radio_tpu_torch.framing import parse_frames
from audio_modem_radio_tpu_torch.ops import dsss as tdsss
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.ops.kernels import psk8_sector_stream
from audio_modem_radio_tpu_torch.parallel import mesh as tm
from audio_modem_radio_tpu_torch.parallel import sequence as ts

from torch_sequence_ref import PAYLOAD, assert_close_rms, capture, jax_decode, pick

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

# family -> (mode, rate, carrier, n_psk, shards, payload)
FAMILIES = {
    "QPSK": ("QPSK", 9600, 3000.0, 4, 4, PAYLOAD),
    "BPSK": ("BPSK", 9600, 3000.0, 2, 5, PAYLOAD),
    "8PSK": ("8PSK", 9600, 12000.0, 8, 4, PAYLOAD),
    "DSSS": ("DSSS", 9600, 3000.0, 2, 4, PAYLOAD[:256]),
}
_KIND = {"QPSK": "psk4", "BPSK": "psk2", "8PSK": "psk8", "DSSS": "dsss"}


@pytest.fixture(scope="module")
def cases():
    """family -> (capture, the JAX reference), one JAX decode each."""
    out = {}
    for fam, (mode, rate, _c, _n, shards, data) in FAMILIES.items():
        x = capture(mode, rate, data)
        out[fam] = (x, jax_decode(x, mode, rate, _KIND[fam], shards))
    return out


def _decisions_t(fam, dr, di):
    if fam == "QPSK":
        return tpsk.qpsk_gray_streams(dr, di)
    if fam == "BPSK":
        return ((dr < 0).to(torch.uint8),)
    dr, di = tpsk.derotate(dr, di, tpsk.estimate_common_rotation_windows(dr, di, n_psk=8))
    return (psk8_sector_stream(dr, di),)


def _decisions_j(fam, dr, di):
    dr, di = jnp.asarray(dr), jnp.asarray(di)
    if fam == "QPSK":
        return jpsk.qpsk_gray_streams(dr, di)
    if fam == "BPSK":
        return ((dr < 0).astype(jnp.uint8),)
    dr, di = jpsk.derotate(dr, di, jpsk.estimate_common_rotation_windows(dr, di, n_psk=8))
    return (jpsk.psk8_sector_stream(dr, di),)


@pytest.mark.parametrize("fam", ["QPSK", "BPSK", "8PSK"])
def test_psk_streams_match_jax(cases, fam):
    mode, rate, carrier, n_psk, shards, _data = FAMILIES[fam]
    x, ref = cases[fam]
    outs, best = ts._psk_shards(x, rate, carrier, tm.get_mesh(devices=["cpu"] * shards), n_psk, 96000, 8, False)
    assert best == pick(ref, (8,))
    dr = torch.cat([o[0] for o in outs])
    di = torch.cat([o[1] for o in outs])
    assert_close_rms(dr.numpy(), ref["streams"][0], f"{fam} d_re")
    assert_close_rms(di.numpy(), ref["streams"][1], f"{fam} d_im")
    for got, want in zip(_decisions_t(fam, dr, di), _decisions_j(fam, *ref["streams"])):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_dsss_chip_streams_match_jax(cases):
    _mode, rate, carrier, _n, shards, _data = FAMILIES["DSSS"]
    x, ref = cases["DSSS"]
    outs, best = ts._psk_shards(x, rate, carrier, tm.get_mesh(devices=["cpu"] * shards), 2, 96000, 8, True)
    assert best == pick(ref, (8,))
    re_f = torch.cat([o[0] for o in outs])
    im_f = torch.cat([o[1] for o in outs])
    assert_close_rms(re_f.numpy(), ref["streams"][0], "DSSS re")
    assert_close_rms(im_f.numpy(), ref["streams"][1], "DSSS im")

    def despread_bits(b_re, b_im, score, argmax):
        d_re = b_re[:, 1:] * b_re[:, :-1] + b_im[:, 1:] * b_im[:, :-1]
        d_im = b_im[:, 1:] * b_re[:, :-1] - b_re[:, 1:] * b_im[:, :-1]
        a = int(argmax(score(d_re, d_im)))
        return a, np.asarray(d_re[a]) < 0, np.asarray(d_im[a]) < 0

    t = despread_bits(tdsss._despread_all_batch(re_f[None])[0], tdsss._despread_all_batch(im_f[None])[0],
                      lambda r, i: tpsk._coherence_score(r, i, 1), torch.argmax)
    jr, ji = (jnp.asarray(s)[None] for s in ref["streams"])
    j = despread_bits(jdsss._despread_all_batch(jr)[0], jdsss._despread_all_batch(ji)[0],
                      lambda r, i: jpsk._coherence_score(r, i, axis=1), jnp.argmax)
    assert t[0] == j[0]
    assert np.array_equal(t[1], j[1])


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_decode_capture_sharded_bytes_match_jax(cases, fam):
    mode, rate, _c, _n, shards, data = FAMILIES[fam]
    x, ref = cases[fam]
    got = ts.decode_capture_sharded(x, mode, rate, tm.get_mesh(devices=["cpu"] * shards))
    assert got == ref["bytes"]
    frames = parse_frames(got)
    assert frames and frames[0].data == data


def test_qpsk_sharded_matches_single_device(cases):
    """The 4-shard decode equals the port's single-device demodulator over
    their common prefix (the padded tails differ in length)."""
    x, _ref = cases["QPSK"]
    sharded = ts.decode_capture_sharded(x, "QPSK", 9600, tm.get_mesh(devices=["cpu"] * 4))
    single = tpsk.qpsk_demodulate(x, 9600, 3000.0, 96000, device="cpu")
    n = min(len(sharded), len(single))
    assert n > len(PAYLOAD) and sharded[:n] == single[:n]
