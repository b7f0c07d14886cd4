"""PyTorch port vs JAX package: DBPSK, DQPSK and D8PSK transmit, tables,
pass 1 and K1's plain version, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both implementations
as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.framing import crc32 as jcrc32, pack_frame as jpack_frame
from audio_modem_radio_tpu.ops import psk as jpsk
from audio_modem_radio_tpu.ops.pallas_kernels import (
    _shifted_pack_weights_qpsk,
    psk_project_decide_batch as j_decide,
)

from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.ops.tables import tables_from_reference

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N_OFF = 8


def _framed(seed: int, n_bytes: int = 1200) -> bytes:
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return jpack_frame("k.bin", payload, 0, 1, len(payload), jcrc32(payload))


def _batch(seed: int, baud: int = 9600, n: int = 1 << 17, shift: int = 7):
    """Two captures of one framed QPSK wave; the second is shifted so the
    winning timing offsets differ."""
    wave = np.asarray(jmodem.modulate("QPSK", _framed(seed), baud), np.float32)
    batch = np.zeros((2, n), np.float32)
    batch[0, : len(wave)] = wave
    batch[1, shift : shift + len(wave)] = wave
    return batch, len(wave)


def _rows(batch: np.ndarray, baud: int, int16: bool) -> np.ndarray:
    r, row = tpsk.blocked_row_shape(batch.shape[1], baud, SR)
    flat = np.zeros((batch.shape[0], r * row), np.float32)
    flat[:, : batch.shape[1]] = batch
    if int16:
        flat = np.clip(np.round(flat * 32768.0), -32768, 32767).astype(np.int16)
    return flat.reshape(batch.shape[0], r, row)


@pytest.mark.parametrize("baud", [9600, 4800, 1200])
def test_qpsk_modulate_matches_jax(baud):
    framed = _framed(baud)
    ref = np.asarray(jmodem.modulate("QPSK", framed, baud), np.float32)
    got = tmodem.modulate("QPSK", framed, baud)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-6


def test_modulate_unknown_mode_raises():
    with pytest.raises(ValueError):
        tmodem.modulate("NO_SUCH_MODE", b"x", 1200)


@pytest.mark.parametrize("baud", [9600, 1200])
def test_bpsk_modulate_matches_jax_bitwise(baud):
    framed = _framed(10 + baud)
    ref = np.asarray(jmodem.modulate("BPSK", framed, baud), np.float32)
    got = tmodem.modulate("BPSK", framed, baud)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(tpsk.bpsk_modulate(framed, baud), np.asarray(jpsk.bpsk_modulate(framed, baud)))


@pytest.mark.parametrize("baud,carrier", [(9600, 12000.0), (1200, 3000.0)])
def test_psk8_real_modulate_matches_jax(baud, carrier):
    framed = _framed(20 + baud, 1001)  # 1001 bytes: the tribit pad is exercised
    ref = np.asarray(jpsk.psk8_real_modulate(framed, baud, carrier), np.float32)
    got = tpsk.psk8_real_modulate(framed, baud, carrier)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-6


@pytest.mark.parametrize("alias", [False, True])
def test_8psk_mode_and_alias_match_jax(alias, monkeypatch):
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    monkeypatch.setitem(JCONFIG._config["modem"], "psk8_compat_alias", alias)
    monkeypatch.setitem(TCONFIG._config["modem"], "psk8_compat_alias", alias)
    framed = _framed(30)
    ref = np.asarray(jmodem.modulate("8PSK", framed, 9600), np.float32)
    got = tmodem.modulate("8PSK", framed, 9600)
    assert got.shape == ref.shape and np.max(np.abs(got - ref)) <= 1e-6
    if alias:
        assert np.array_equal(got, tpsk.qpsk_modulate(framed, 9600, 12000.0))


@pytest.mark.parametrize("mode", ["APSK16", "SSTV"])
def test_dqpsk_alias_modes_match_jax(mode):
    framed = _framed(40)
    ref = np.asarray(jmodem.modulate(mode, framed, 4800), np.float32)
    assert np.array_equal(tmodem.modulate(mode, framed, 4800), ref)


def test_psk8_tables_equal_jax():
    for name in ("_GRAY8", "_GRAY8_INV", "_ET_COS", "_ET_SIN"):
        ref, got = getattr(jpsk, name), getattr(tpsk, name)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    assert tpsk.PSK8_PREAMBLE_BITS == jpsk.PSK8_PREAMBLE_BITS
    assert tpsk.BPSK_PREAMBLE_BITS == jpsk.BPSK_PREAMBLE_BITS


@pytest.mark.parametrize("baud,carrier", [(9600, 3000.0), (4800, 3000.0), (9600, 12000.0)])
def test_tables_bitwise_equal(baud, carrier):
    spsym = 96000 // baud
    for name in ("_offset_templates", "_blocked_templates", "_offset_grams"):
        ref = getattr(jpsk, name)(spsym, carrier, SR, N_OFF)
        got = getattr(tpsk, name)(spsym, carrier, SR, N_OFF)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name


def test_tables_from_reference():
    spsym = 10
    arrays = {
        "_blocked_templates": jpsk._blocked_templates(spsym, 3000.0, SR, N_OFF),
        "_offset_templates": jpsk._offset_templates(spsym, 3000.0, SR, N_OFF),
        "_offset_grams": jpsk._offset_grams(spsym, 3000.0, SR, N_OFF),
        "_shifted_pack_weights_qpsk": _shifted_pack_weights_qpsk(),
    }
    got = tables_from_reference(arrays, "cpu")
    for name, a in arrays.items():
        ref = np.stack(a) if isinstance(a, tuple) else a
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), ref), name
    with pytest.raises(KeyError):
        tables_from_reference({"nope": arrays["_offset_grams"]})


@pytest.mark.parametrize("int16", [False, True])
def test_batch_pass1_matches_jax(int16):
    """best equal and theta within 1e-5 rad, on f32 rows and on int16 rows
    at scale 32768 (which overflows float32 in the 4th-power estimate
    unless the scoring windows normalize themselves)."""
    baud, spsym = 9600, 10
    batch, _ = _batch(1, baud)
    x3d = _rows(batch, baud, int16)
    b, r, _ = x3d.shape
    _, _, best_j, theta_j = jpsk._batch_pass1(
        None, jnp.asarray(x3d), b, r * 128, spsym, 3000.0, SR, N_OFF, r
    )
    _, _, best_t, theta_t = tpsk._batch_pass1(
        None, torch.from_numpy(x3d), b, r * 128, spsym, 3000.0, SR, N_OFF, r
    )
    assert np.array_equal(best_t.numpy(), np.asarray(best_j))
    assert len(set(best_t.tolist())) == 2  # the shift moved the offset
    assert np.all(np.isfinite(theta_t.numpy()))
    assert np.max(np.abs(theta_t.numpy() - np.asarray(theta_j))) <= 1e-5


def test_batch_pass1_flat_input_matches_jax():
    baud, spsym = 9600, 10
    batch, _ = _batch(2, baud)
    b, n = batch.shape
    n_frames = -(-n // spsym)
    x3d_j, r_j, best_j, theta_j = jpsk._batch_pass1(
        jnp.asarray(batch), None, b, n_frames, spsym, 3000.0, SR, N_OFF, 0
    )
    x3d_t, r_t, best_t, theta_t = tpsk._batch_pass1(
        torch.from_numpy(batch), None, b, n_frames, spsym, 3000.0, SR, N_OFF, 0
    )
    assert r_t == r_j and np.array_equal(x3d_t.numpy(), np.asarray(x3d_j))
    assert np.array_equal(best_t.numpy(), np.asarray(best_j))
    assert np.max(np.abs(theta_t.numpy() - np.asarray(theta_j))) <= 1e-5


@pytest.mark.parametrize("int16,cfo", [(False, True), (True, True), (False, False)])
def test_decide_plain_matches_pallas_interpret(int16, cfo):
    """K1's plain version == the Pallas decide kernel (interpret mode),
    bitwise over the modulated span, on identical (x3d, W8, best, rot)."""
    baud, spsym = 9600, 10
    batch, n_wave = _batch(3, baud)
    x3d = _rows(batch, baud, int16)
    b, r, _ = x3d.shape
    _, _, best, theta = jpsk._batch_pass1(
        None, jnp.asarray(x3d), b, r * 128, spsym, 3000.0, SR, N_OFF, r
    )
    best = np.array(best, np.int32)
    theta = np.asarray(theta, np.float32)
    rot = np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    if not cfo:
        rot = np.tile(np.asarray([[1.0, 0.0]], np.float32), (b, 1))
    W8 = jpsk._blocked_templates(spsym, 3000.0, SR, N_OFF)

    hi_j, lo_j = j_decide(
        jnp.asarray(x3d), jnp.asarray(W8), jnp.asarray(best), jnp.asarray(rot),
        rows_per_capture=r, n_psk=4, interpret=True,
    )
    hi_t, lo_t = tk.psk_project_decide_batch(
        torch.from_numpy(x3d), torch.from_numpy(W8), torch.from_numpy(best),
        torch.from_numpy(rot), rows_per_capture=r,
    )
    assert hi_t.dtype == torch.uint8 and tuple(hi_t.shape) == (b, r, 128)
    n_sig = n_wave // spsym - 2
    hi_j = np.asarray(hi_j).reshape(b, -1)[:, :n_sig]
    lo_j = np.asarray(lo_j).reshape(b, -1)[:, :n_sig]
    assert np.array_equal(hi_t.numpy().reshape(b, -1)[:, :n_sig], hi_j)
    assert np.array_equal(lo_t.numpy().reshape(b, -1)[:, :n_sig], lo_j)


def test_decision_streams_shape_and_unported_configs():
    batch, _ = _batch(4)
    hi, lo = tpsk.psk_decision_streams_batch(torch.from_numpy(batch), 9600.0, 3000.0, SR)
    r, _ = tpsk.blocked_row_shape(batch.shape[1], 9600, SR)
    assert hi.shape == lo.shape == (2, r * 128) and hi.dtype == torch.uint8
    with pytest.raises(NotImplementedError):
        tpsk.psk_decision_streams_batch(torch.from_numpy(batch), 9600.0, 3000.0, SR, n_psk=3)
    # Too short for the blocked path: the single-capture receiver per
    # capture, equal to the JAX package's.
    short = np.ascontiguousarray(batch[:, :2000])
    ref = jpsk.psk_decision_streams_batch(jnp.asarray(short), 9600.0, 3000.0, SR)
    got = tpsk.psk_decision_streams_batch(torch.from_numpy(short), 9600.0, 3000.0, SR)
    assert all(np.array_equal(g.numpy(), np.asarray(j)) for g, j in zip(got, ref))


@pytest.mark.parametrize("n,baud", [(1 << 17, 9600), (100_001, 4800), (2000, 9600), (5000, 1200)])
def test_blocked_row_shape_matches_jax(n, baud):
    assert tpsk.blocked_row_shape(n, baud, SR) == jpsk.blocked_row_shape(n, baud, SR)


def _batch8(seed: int, n: int = 1 << 17, shift: int = 3):
    """Two captures of one framed real 8PSK@9600 wave on the 12 kHz
    carrier; the second is shifted so the winning timing offsets differ."""
    wave = np.asarray(jpsk.psk8_real_modulate(_framed(seed), 9600, 12000.0), np.float32)
    batch = np.zeros((2, n), np.float32)
    batch[0, : len(wave)] = wave
    batch[1, shift : shift + len(wave)] = wave
    return batch, len(wave)


@pytest.mark.parametrize("int16", [False, True])
def test_batch_pass1_psk8_matches_jax(int16):
    """8th-power scoring and θ: best equal, θ within 1e-5 rad, on a real
    8PSK@9600 capture at 12 kHz, f32 and int16 rows."""
    batch, _ = _batch8(5)
    x3d = _rows(batch, 9600, int16)
    b, r, _ = x3d.shape
    _, _, best_j, theta_j = jpsk._batch_pass1(
        None, jnp.asarray(x3d), b, r * 128, 10, 12000.0, SR, N_OFF, r, n_psk=8
    )
    _, _, best_t, theta_t = tpsk._batch_pass1(
        None, torch.from_numpy(x3d), b, r * 128, 10, 12000.0, SR, N_OFF, r, n_psk=8
    )
    assert np.array_equal(best_t.numpy(), np.asarray(best_j))
    assert np.all(np.isfinite(theta_t.numpy()))
    assert np.max(np.abs(theta_t.numpy() - np.asarray(theta_j))) <= 1e-5


@pytest.mark.parametrize("n_psk", [2, 8])
@pytest.mark.parametrize("int16,rot_case", [(False, "cfo"), (True, "cfo"), (False, "off"), (True, "pi/4")])
def test_decide_plain_matches_pallas_interpret_psk2_psk8(n_psk, int16, rot_case):
    """K1's plain version at 2 and 8 phases == the Pallas decide kernel
    (interpret mode), bitwise over the modulated span: with pass 1's θ
    (cfo on), the identity (cfo off) and a π/4 test rotation.

    The one exception is DBPSK's lo stream (the sign of the imaginary part)
    under θ or the identity: a clean DBPSK differential is real, so its
    imaginary part is zero up to rounding and its sign depends on how the
    products are summed (XLA fuses them into FMAs, PyTorch does not). It is
    compared under the π/4 rotation, where it carries the signal."""
    if n_psk == 8:
        batch, n_wave = _batch8(6)
        carrier = 12000.0
    else:
        framed = _framed(7)
        wave = np.asarray(jpsk.bpsk_modulate(framed, 9600, 3000.0), np.float32)
        batch = np.zeros((2, 1 << 17), np.float32)
        batch[0, : len(wave)] = wave
        batch[1, 7 : 7 + len(wave)] = wave
        n_wave, carrier = len(wave), 3000.0
    x3d = _rows(batch, 9600, int16)
    b, r, _ = x3d.shape
    _, _, best, theta = jpsk._batch_pass1(
        None, jnp.asarray(x3d), b, r * 128, 10, carrier, SR, N_OFF, r,
        n_psk=8 if n_psk == 8 else 4,
    )
    best = np.array(best, np.int32)
    theta = {"cfo": np.asarray(theta, np.float32), "off": np.zeros(b, np.float32),
             "pi/4": np.full(b, np.pi / 4, np.float32)}[rot_case]
    rot = np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    if rot_case == "off":
        rot = np.tile(np.asarray([[1.0, 0.0]], np.float32), (b, 1))
    W8 = jpsk._blocked_templates(10, carrier, SR, N_OFF)
    args = (torch.from_numpy(x3d), torch.from_numpy(W8), torch.from_numpy(best), torch.from_numpy(rot))
    ref = j_decide(*(jnp.asarray(a.numpy()) for a in args), rows_per_capture=r, n_psk=n_psk,
                   interpret=True)
    got = tk.psk_project_decide_batch(*args, rows_per_capture=r, n_psk=n_psk)
    if n_psk == 8:
        ref, got = [ref], [got]
    elif rot_case != "pi/4":
        ref, got = ref[:1], got[:1]
    n_sig = n_wave // 10 - 2
    for g, j in zip(got, ref):
        assert g.dtype == torch.uint8 and tuple(g.shape) == (b, r, 128)
        assert np.array_equal(g.numpy().reshape(b, -1)[:, :n_sig], np.asarray(j).reshape(b, -1)[:, :n_sig])


def test_psk8_sector_rows_shape():
    batch, _ = _batch8(8)
    sec = tpsk.psk8_sector_rows_batch(torch.from_numpy(batch), 9600.0, 12000.0, SR)
    r, _ = tpsk.blocked_row_shape(batch.shape[1], 9600, SR)
    assert sec.shape == (2, r * 128) and sec.dtype == torch.uint8 and int(sec.max()) <= 7
    # Too short for the blocked path: the staged single-capture path, equal
    # to the JAX package's.
    short = np.ascontiguousarray(batch[:, :2400])
    ref = np.asarray(jpsk.psk8_sector_rows_batch(jnp.asarray(short), 9600.0, 12000.0, SR))
    got = tpsk.psk8_sector_rows_batch(torch.from_numpy(short), 9600.0, 12000.0, SR)
    assert got.shape == ref.shape and np.array_equal(got.numpy(), ref)
