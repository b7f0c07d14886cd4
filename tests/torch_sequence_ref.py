"""Shared by ``test_torch_sequence_psk.py`` and ``test_torch_sequence_other.py``:
one capture per family, and the JAX package's sequence-parallel decode of it
with the demodulator's streams and its consensus picks recorded.

The JAX consensus (``jnp.argmax`` of the summed offset scores, of the
gathered NEURAL peaks) runs inside ``shard_map``; while the demodulator is
traced, ``jnp.argmax`` is wrapped so that every scalar pick reports
``(shape of its input, value)`` through ``jax.debug.callback``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.modem import modulate
from audio_modem_radio_tpu.ops.hell import hellschreiber_modulate
from audio_modem_radio_tpu.parallel import mesh as jm
from audio_modem_radio_tpu.parallel import sequence as js

PAYLOAD = bytes(b"sequence parallel decode across the mesh " * 24)
HELL_TEXT = "SEQUENCE PARALLEL HELL 123"

_DEMOD = {"fsk": "demod_fsk_capture_sharded", "ofdm": "demod_ofdm_capture_sharded",
          "neural": "demod_neural_capture_sharded", "hell": "demod_hell_capture_sharded"}


def capture(mode: str, rate: int, data: bytes = PAYLOAD, lead: int = 3333) -> np.ndarray:
    """One transmission after ``len(wave) + lead`` samples of silence (the
    first shards hold no signal); the HELL text opens its capture (its sync
    run is searched from sample 0)."""
    if mode == "HELLSCHREIBER":
        return np.asarray(hellschreiber_modulate(HELL_TEXT), np.float32)
    framed = pack_frame("sp.bin", data, 0, 1, len(data), crc32(data))
    wave = np.asarray(modulate(mode, framed, rate), np.float32)
    return np.concatenate([np.zeros(len(wave) + lead, np.float32), wave])


def jax_decode(x: np.ndarray, mode: str, rate: int, kind: str, n_shards: int) -> dict:
    """``{"bytes", "streams", "picks"}``: the JAX ``decode_capture_sharded``
    on ``get_mesh(n_shards)``, its demodulator's outputs as numpy arrays and
    the scalar argmax picks made while that demodulator ran."""
    name = _DEMOD.get(kind, "demod_capture_sharded")
    real_demod, real_argmax = getattr(js, name), jnp.argmax
    picks, out = [], {}

    def record(a, *args, **kwargs):
        res = real_argmax(a, *args, **kwargs)
        if res.ndim == 0:
            shape = tuple(a.shape)
            jax.debug.callback(lambda v: picks.append((shape, int(v))), res)
        return res

    def demod(*args, **kwargs):
        jnp.argmax = record
        try:
            res = real_demod(*args, **kwargs)
            jax.block_until_ready(res)
        finally:
            jnp.argmax = real_argmax
        out["streams"] = [np.asarray(r) for r in (res if isinstance(res, tuple) else (res,))]
        return res

    setattr(js, name, demod)
    try:
        out["bytes"] = js.decode_capture_sharded(x, mode, rate, jm.get_mesh(n_shards))
    finally:
        setattr(js, name, real_demod)
    out["picks"] = picks
    return out


def pick(ref: dict, shape: tuple) -> int:
    """The JAX consensus pick over an input of ``shape`` (every shard's is
    the same)."""
    vals = {v for s, v in ref["picks"] if s == shape}
    assert len(vals) == 1, ref["picks"]
    return vals.pop()


def assert_close_rms(got, ref, what: str) -> None:
    """Float streams within 1e-4 of the reference's RMS, same length."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    rms = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    assert float(np.max(np.abs(got - ref))) <= 1e-4 * rms, what
