"""The compatibility aliases of DSSS and OFDM against the JAX package's, on
the CPU: DSSS under CONFIG ``modem.dsss_compat_alias`` (plain DBPSK, 3 kHz)
and OFDM4/OFDM8 under ``modem.ofdm_compat_alias`` (plain DQPSK, 12 kHz),
through ``modulate``, ``demodulate``, ``demod_pack_batch`` and
``decode_sample_batch``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.parallel.batch import (
    decode_sample_batch as j_decode_sample_batch,
    demod_pack_batch as j_demod_pack_batch,
)

from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.framing import crc32, pack_frame, parse_frames
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.parallel import batch as tb

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

_ALIAS_FLAG = {"DSSS": "dsss_compat_alias", "OFDM4": "ofdm_compat_alias", "OFDM8": "ofdm_compat_alias"}
N = 1 << 16


@pytest.fixture
def alias_on(monkeypatch):
    """Turn ``mode``'s compatibility alias on in both packages' CONFIG for
    one test; monkeypatch restores both. The JAX ``demod_pack_batch`` reads
    the flag while it traces, and its trace cache is keyed by mode, rate
    and shape only, so the cache is cleared when the flag turns on (a trace
    of the same call without the alias, left by an earlier test in the
    process, would answer instead) and again at teardown (so the alias's
    traces do not answer later tests)."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def turn_on(mode):
        for cfg in (JCONFIG, TCONFIG):
            monkeypatch.setitem(cfg._config["modem"], _ALIAS_FLAG[mode], True)
        j_demod_pack_batch.clear_cache()

    yield turn_on
    j_demod_pack_batch.clear_cache()


def _framed(seed: int):
    """A 240-byte payload framed for the 9600 Bd captures."""
    p = np.random.default_rng(seed).integers(0, 256, 240, dtype=np.uint8).tobytes()
    return p, pack_frame("alias.bin", p, 0, 1, len(p), crc32(p))


def _capture(wave, lead: int = 211) -> np.ndarray:
    x = np.zeros(N, np.float32)
    x[lead : lead + len(wave)] = wave
    return x


@pytest.mark.parametrize("mode", ["DSSS", "OFDM4", "OFDM8"])
def test_alias_modulate_matches_jax(alias_on, mode):
    """Within 1e-6, the tolerance of the QPSK modulate test (the two
    packages' float32 phase accumulations round apart); and exactly the
    port's own plain DBPSK or DQPSK at the alias's carrier."""
    alias_on(mode)
    _, framed = _framed(1)
    ref = np.asarray(jmodem.modulate(mode, framed, 9600), np.float32)
    got = tmodem.modulate(mode, framed, 9600)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-6
    plain = tpsk.bpsk_modulate(framed, 9600, 3000.0) if mode == "DSSS" else tpsk.qpsk_modulate(framed, 9600, 12000.0)
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("mode", ["DSSS", "OFDM4"])
def test_alias_demodulate_byte_equal_jax(alias_on, mode):
    """On the JAX package's capture: the port's stream equals the JAX
    package's byte for byte and carries the payload."""
    alias_on(mode)
    payload, framed = _framed(2)
    x = _capture(np.asarray(jmodem.modulate(mode, framed, 9600), np.float32))
    ref = jmodem.demodulate(mode, x, 9600)
    got = tmodem.demodulate(mode, x, 9600, device="cpu")
    assert got == ref
    assert [f.data for f in parse_frames(got)] == [payload]


def test_ofdm_alias_demodulate_skips_the_coherent_escalation(alias_on, monkeypatch):
    """The OFDM alias is the plain DQPSK receiver, as in the JAX package:
    a capture with no frame runs no tracked pass."""
    alias_on("OFDM4")
    monkeypatch.setattr(tmodem, "qpsk_tracked_demodulate", lambda *a, **k: pytest.fail("tracked pass ran"))
    x = np.random.default_rng(3).normal(0, 0.3, N).astype(np.float32)
    assert tmodem.demodulate("OFDM4", x, 9600, device="cpu") == tpsk.qpsk_demodulate(x, 9600, 12000.0, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_ofdm_alias_demod_pack_batch_flat_matches_jax(alias_on, monkeypatch, backend):
    """Flat (B, N) OFDM4 captures under the alias run kind psk4 at 12 kHz in
    both packages. On the CPU the JAX package takes its per-capture tails;
    so does the port under CONFIG ``tpu.demod_backend = "xla"``, and there
    found, n_valid and the packed bytes within n_valid equal the JAX
    package's. Otherwise the port takes its blocked kernel path (the
    frame at byte s // 8), whose outputs equal those of APSK16, the
    carried mode on the same wire format; found equals the JAX package's
    and every capture parses to its payload on both backends."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    alias_on("OFDM4")
    for cfg in (JCONFIG, TCONFIG):
        monkeypatch.setitem(cfg._config["tpu"], "demod_backend", backend)
    batch, payloads = np.zeros((2, N), np.float32), []
    for i, lead in enumerate((0, 311)):
        p, framed = _framed(10 + i)
        wave = np.asarray(jmodem.modulate("OFDM4", framed, 9600), np.float32)
        batch[i, lead : lead + len(wave)] = wave
        payloads.append(p)
    packed_j, n_valid_j, found_j = (np.asarray(a) for a in j_demod_pack_batch(jnp.asarray(batch), "OFDM4", 9600))
    got = tb.demod_pack_batch(torch.from_numpy(batch), "OFDM4", 9600)
    packed_t, n_valid_t, found_t = (a.numpy() for a in got)
    assert np.array_equal(found_t, found_j) and found_t.all()
    if backend == "xla":
        assert np.array_equal(n_valid_t, n_valid_j)
        for i in range(2):
            assert np.array_equal(packed_t[i, : n_valid_t[i]], packed_j[i, : n_valid_t[i]]), i
    else:
        same = tb.demod_pack_batch(torch.from_numpy(batch), "APSK16", 9600)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
    for i in range(2):
        assert [f.data for f in parse_frames(packed_t[i, : n_valid_t[i]].tobytes())] == [payloads[i]]


def test_ofdm_alias_decode_sample_batch_differs_from_jax(alias_on):
    """The one difference the alias leaves (ROADMAP.md queue 3, traps of
    the reference): the JAX package's host shaping builds OFDM rows that
    its psk4 rewrite then refuses, while the port's host shaping applies
    the rewrite too, as both packages do for the 8PSK and DSSS aliases: the
    alias captures get psk4 blocked rows (those of APSK16, the carried mode
    on the same wire format) and decode."""
    alias_on("OFDM4")
    payload, framed = _framed(4)
    batch = _capture(np.asarray(jmodem.modulate("OFDM4", framed, 9600), np.float32))[None]
    with pytest.raises(ValueError, match="row width"):
        j_decode_sample_batch(batch, "OFDM4", 9600)
    shaped = tb.host_shape_batch(batch, "OFDM4", 9600, device="cpu")
    assert shaped.shape == (1, 256, 1280) and shaped.dtype == np.float32
    assert np.array_equal(shaped, tb.host_shape_batch(batch, "APSK16", 9600, device="cpu"))
    raws = tb.decode_sample_batch(batch, "OFDM4", 9600, device="cpu")
    assert [f.data for f in parse_frames(raws[0])] == [payload]
