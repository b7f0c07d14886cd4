"""The PyTorch port's batched FSK receive vs the JAX package's, on the CPU:
geometry, plans and tables (bitwise), transmit, the sync tail, host shaping,
the slice through ``decode_sample_batch`` and ``decode_wav_batch``, the
inputs that take the single-capture receiver per capture, the device rule
and the tables carried across."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import MAGIC_BIT_PATTERN, crc32, pack_frame, parse_frames as j_parse
from audio_modem_radio_tpu.modem import modulate as j_modulate
from audio_modem_radio_tpu.ops import common as jcommon
from audio_modem_radio_tpu.ops import fsk as jfsk
from audio_modem_radio_tpu.parallel.batch import (
    _overlap_rows as j_overlap_rows,
    decode_sample_batch as j_decode_sample_batch,
    decode_wav_batch as j_decode_wav_batch,
    demod_pack_batch as j_demod_pack_batch,
)

from audio_modem_radio_tpu_torch import modulate as t_modulate
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import parse_frames as t_parse
from audio_modem_radio_tpu_torch.ops import common as tcommon
from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops.tables import tables_from_reference
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
# Configuration -> (mode, symbol rate, baud, mark, space).
CONFIGS = {
    "FSK1200": ("FSK1200", 1200, 1200.0, 1200.0, 2200.0),
    "FSK9600": ("FSK9600", 9600, 9600.0, 1200.0, 2200.0),
    "FSK19200": ("FSK19200", 19200, 19200.0, 8000.0, 16000.0),
    "MSK@1000": ("MSK", 1000, 1000.0, 6000.0, 7000.0),
    "MSK@1200": ("MSK", 1200, 1200.0, 6000.0, 7200.0),
    "MSK@9600": ("MSK", 9600, 9600.0, 6000.0, 15600.0),
    "FT8": ("FT8", 50, 50.0, 3000.0, 3050.0),
}
_GEOM = ["FSK1200", "FSK9600", "FSK19200", "MSK@1000", "MSK@9600", "FT8"]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def configs(monkeypatch):
    """Set a CONFIG key in both packages for one test."""
    from audio_modem_radio_tpu.config import CONFIG as JCONFIG
    from audio_modem_radio_tpu_torch.config import CONFIG as TCONFIG

    def set_both(section, key, value):
        monkeypatch.setitem(JCONFIG._config[section], key, value)
        monkeypatch.setitem(TCONFIG._config[section], key, value)

    return set_both


def _frames(raw_list, parse):
    return [[(f.name, f.part_number, f.total_parts, f.data) for f in parse(raw)] for raw in raw_list]


# --- geometry, plans and tables: bitwise -----------------------------------------

@pytest.mark.parametrize("cfg", _GEOM)
def test_geometry_and_plans_equal_jax(cfg):
    _, _, baud, mark, space = CONFIGS[cfg]
    spb = tfsk._samples_per_bit(SR, baud)
    assert spb == jfsk._samples_per_bit(SR, baud)
    assert tfsk._separation_cycles(baud, mark, space, SR) == jfsk._separation_cycles(baud, mark, space, SR)
    assert tfsk._fsk_geometry(spb) == jfsk._fsk_geometry(spb)
    assert tfsk._core_bounds(spb) == jfsk._core_bounds(spb)
    for dec in (1, 2, 4):
        assert tfsk._fsk_geometry_dec(spb, dec) == jfsk._fsk_geometry_dec(spb, dec)
    for r in (100, 256, 13108, 13312):
        assert tfsk.fsk_dual_rows_batch_plan(spb, r) == jfsk.fsk_dual_rows_batch_plan(spb, r)
    plan = tfsk._fir_frontend_plan(baud, mark, space, SR)
    assert plan == jfsk._fir_frontend_plan(baud, mark, space, SR)
    assert tfsk._discriminator_decimation(spb, plan[1], SR) == jfsk._discriminator_decimation(spb, plan[1], SR)
    assert tfsk._fsk_disc_kernel_plan(spb, plan[2], plan[3]) == jfsk._fsk_disc_kernel_plan(spb, plan[2], plan[3])
    for n in (1 << 16, 1 << 18, 1 << 24, 3 * spb + 1):
        for name in ("fsk_blocked_row_shape", "fsk_fir_row_shape", "fsk_disc_row_shape",
                     "fsk_quad_row_shape"):
            assert getattr(tfsk, name)(n, baud, mark, space, SR) == getattr(jfsk, name)(
                n, baud, mark, space, SR), (name, n)


def _assert_same(got, ref, name):
    assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref), name


@pytest.mark.parametrize("cfg", _GEOM)
def test_tables_equal_jax(cfg):
    _, _, baud, mark, space = CONFIGS[cfg]
    spb = tfsk._samples_per_bit(SR, baud)
    _assert_same(tfsk._tone_basis(spb, mark, space, SR), jfsk._tone_basis(spb, mark, space, SR), "tones")
    if tfsk._separation_cycles(baud, mark, space, SR) >= 0.8:
        _assert_same(tfsk._fsk_blocked_templates(spb, mark, space, SR, 8),
                     jfsk._fsk_blocked_templates(spb, mark, space, SR, 8), "_fsk_blocked_templates")
        return
    blo, bhi, dec, taps = tfsk._fir_frontend_plan(baud, mark, space, SR)
    plan = tfsk._fsk_disc_kernel_plan(spb, dec, taps)
    _assert_same(tcommon._analytic_fir_taps(blo, bhi, SR, taps),
                 jcommon._analytic_fir_taps(blo, bhi, SR, taps), "_analytic_fir_taps")
    _assert_same(tcommon._fir_dec_template(blo, bhi, SR, taps, dec, 128),
                 jcommon._fir_dec_template(blo, bhi, SR, taps, dec, 128), "_fir_dec_template")
    _assert_same(tfsk._fir_padded_template(blo, bhi, SR, taps, dec, plan),
                 jfsk._fir_padded_template(blo, bhi, SR, taps, dec, plan), "_fir_padded_template")
    geom = (plan["spr2"], plan["row2"], plan["ov2"])
    _assert_same(tfsk._fsk_boxcar_templates_geom(spb, 8, dec, *geom),
                 jfsk._fsk_boxcar_templates_geom(spb, 8, dec, *geom), "_fsk_boxcar_templates_geom")
    _assert_same(tfsk._fsk_boxcar_templates_dec(spb, 8, dec),
                 jfsk._fsk_boxcar_templates_dec(spb, 8, dec), "_fsk_boxcar_templates_dec")
    _assert_same(tfsk._fsk_quadrature_templates_geom(spb, mark, space, SR, 8, *geom),
                 jfsk._fsk_quadrature_templates_geom(spb, mark, space, SR, 8, *geom),
                 "_fsk_quadrature_templates_geom")


def test_discriminator_calibration_equals_jax():
    _, _, baud, mark, space = CONFIGS["FSK9600"]
    spb = tfsk._samples_per_bit(SR, baud)
    blo, bhi, dec, taps = tfsk._fir_frontend_plan(baud, mark, space, SR)
    args = (spb, baud, mark, space, SR, float(blo), float(bhi))
    _assert_same(tfsk._discriminator_calibration(*args, fir_taps=taps, dec=dec),
                 jfsk._discriminator_calibration(*args, fir_taps=taps, dec=dec), "calibration")


# --- transmit --------------------------------------------------------------------

@pytest.mark.parametrize("mode,rate", [("FSK1200", 1200), ("FSK9600", 9600), ("FSK19200", 19200),
                                       ("MSK", 1200), ("FT8", 50)])
def test_fsk_modulate_matches_jax(mode, rate):
    data = bytes(range(256))[: 60 if mode == "FT8" else 256]
    framed = pack_frame("tx.bin", data, 0, 1, len(data), crc32(data))
    got = t_modulate(mode, framed, rate)
    ref = np.asarray(j_modulate(mode, framed, rate))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-6


# --- the sync tail: exact ------------------------------------------------------------

def _planted(rng, n, pos):
    bits = rng.integers(0, 2, n, dtype=np.uint8)
    if pos is not None:
        bits[pos : pos + len(MAGIC_BIT_PATTERN)] = [int(c) for c in MAGIC_BIT_PATTERN]
    return bits


@pytest.mark.parametrize("n,positions", [(4096, (17, 3001)), (1000, (None, 5)), (10, (None, None))])
def test_find_and_pack_equal_jax(n, positions):
    """A planted magic, random bits (which may hold the magic by chance), and a
    stream shorter than the pattern: (start, found), n_valid and the bytes
    within n_valid equal the JAX package's."""
    rng = np.random.default_rng(n)
    bits = np.stack([_planted(rng, n, p) for p in positions])
    start_t, found_t = tcommon.find_bit_pattern(torch.from_numpy(bits), MAGIC_BIT_PATTERN)
    packed_t, n_valid_t = tcommon.pack_bits_from(torch.from_numpy(bits), start_t)
    for i in range(len(positions)):
        start_j, found_j = jcommon.find_bit_pattern(jnp.asarray(bits[i]), MAGIC_BIT_PATTERN)
        packed_j, n_valid_j = jcommon.pack_bits_from(jnp.asarray(bits[i]), start_j)
        assert int(start_t[i]) == int(start_j) and bool(found_t[i]) == bool(found_j)
        assert int(n_valid_t[i]) == int(n_valid_j) and packed_t.shape[1] == np.asarray(packed_j).shape[0]
        k = int(n_valid_j)
        assert np.array_equal(packed_t[i, :k].numpy(), np.asarray(packed_j)[:k])
        if positions[i] is not None and n >= 16:
            assert bool(found_t[i]) and int(start_t[i]) <= positions[i]


# --- host shaping: bitwise ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_overlap_rows_equal_jax(dtype):
    rng = np.random.default_rng(3)
    batch = (0.5 * rng.normal(size=(2, 50_000))).astype(np.float32)
    for r, row, ov, lead in ((40, 1280, 128, 0), (80, 512, 128, 64), (400, 128, 128, 64)):
        got = tb._overlap_rows(batch, r, row, ov, lead=lead, dtype=dtype)
        ref = j_overlap_rows(batch, r, row, ov, lead=lead, dtype=dtype)
        _assert_same(got, ref, (r, row, ov, lead))


@pytest.mark.parametrize("cfg,dtype", [("FSK1200", np.int16), ("FSK1200", np.float32),
                                       ("MSK@1000", np.float32), ("FSK9600", np.int16),
                                       ("FSK19200", np.float32)])
def test_host_shape_batch_layouts(cfg, dtype, configs):
    """The JAX package's TPU-path layouts on every device, built here with its
    own _overlap_rows and row-shape helpers: padded 256-row dual-tone rows
    where the plan maps, unpadded float32 rows where it does not (MSK at
    1000 Bd), the fused FIR windows for FSK9600 and FSK19200."""
    mode, rate, baud, mark, space = CONFIGS[cfg]
    configs("tpu", "int16_rows", dtype == np.int16)
    batch = (0.5 * np.random.default_rng(4).normal(size=(2, 1 << 17))).astype(np.float32)
    got = tb.host_shape_batch(batch, mode, rate, device="cpu")
    n = batch.shape[1]
    shape = jfsk.fsk_blocked_row_shape(n, baud, mark, space, SR)
    if shape is not None:
        r, row, ov = shape
        r_pad = -(-r // 256) * 256
        if jfsk.fsk_dual_rows_batch_plan(jfsk._samples_per_bit(SR, baud), r_pad) is not None:
            ref = j_overlap_rows(batch, r_pad, row, ov, dtype=dtype)
        else:
            ref = j_overlap_rows(batch, r, row, ov)
    else:
        r, row, ov, lead = (jfsk.fsk_disc_row_shape(n, baud, mark, space, SR)
                            or jfsk.fsk_quad_row_shape(n, baud, mark, space, SR))
        ref = j_overlap_rows(batch, r, row, ov, lead=lead, dtype=dtype)
    _assert_same(got, ref, cfg)


# --- the slice ------------------------------------------------------------------------

def _capture_batch(cfg, seed, leads=(0, 97), noise=True):
    mode, rate, _baud, _m, _s = CONFIGS[cfg]
    rng = np.random.default_rng(seed)
    payloads, waves = [], []
    for i in range(len(leads)):
        p = rng.integers(0, 256, 150 + 100 * i, dtype=np.uint8).tobytes()
        waves.append(np.asarray(t_modulate(mode, pack_frame(f"{cfg}{i}.bin", p, 0, 1, len(p), crc32(p)), rate)))
        payloads.append(p)
    n = 1 << int(np.ceil(np.log2(max(len(w) + lead for w, lead in zip(waves, leads)) + 1)))
    batch = np.zeros((len(leads) + noise, n), np.float32)
    for i, (w, lead) in enumerate(zip(waves, leads)):
        batch[i, lead : lead + len(w)] = w
    if noise:
        batch[-1] = rng.normal(0, 0.3, n)
        payloads.append(None)
    return batch, payloads


@pytest.mark.parametrize("cfg", ["FSK1200", "FSK9600", "FSK19200", "MSK@1200", "MSK@1000"])
def test_decode_sample_batch_matches_jax(cfg):
    mode, rate = CONFIGS[cfg][:2]
    batch, payloads = _capture_batch(cfg, 20)
    got = _frames(tb.decode_sample_batch(batch, mode, rate, device="cpu"), t_parse)
    ref = _frames(j_decode_sample_batch(batch, mode, rate), j_parse)
    assert got == ref
    assert [[f[3] for f in g] for g in got] == [[p] if p else [] for p in payloads]


def test_decode_wav_batch_fsk1200_matches_jax(workdir):
    paths, contents = [], []
    for i in range(2):
        data = bytes(f"fsk wav {i} ".encode() * (20 + 10 * i))
        framed = pack_frame(f"w{i}.bin", data, 0, 1, len(data), crc32(data))
        path = str(workdir / f"w{i}.wav")
        write_wav(path, t_modulate("FSK1200", framed, 1200))
        paths.append(path)
        contents.append(data)
    ref = j_decode_wav_batch(paths, "FSK1200", 1200, recv_dir="recv_jax", registry=JRegistry())
    got = tb.decode_wav_batch(paths, "FSK1200", 1200, recv_dir="recv_torch", registry=TRegistry(), device="cpu")
    read = lambda saved: sorted(open(p, "rb").read() for r in saved for p in r)  # noqa: E731
    assert [len(g) for g in got] == [len(r) for r in ref] == [1, 1]
    assert read(got) == read(ref) == sorted(contents)


def _assert_pack_equal(got, ref):
    """demod_pack_batch outputs: n_valid and found equal, packed bytes equal
    within n_valid."""
    packed_t, n_valid_t, found_t = (a.numpy() for a in got)
    packed_j, n_valid_j, found_j = (np.asarray(a) for a in ref)
    assert np.array_equal(n_valid_t, n_valid_j) and np.array_equal(found_t, found_j)
    for i in range(len(n_valid_j)):
        assert np.array_equal(packed_t[i, : n_valid_j[i]], packed_j[i, : n_valid_j[i]])


def test_flat_dual_tone_input_runs_k13_path():
    """Flat (B, N) dual-tone captures go through fsk_demod_bits_batch (K13's
    path) and decode the same frames as the row path; flat close-tone input
    takes the single-capture receiver per capture, as the JAX package's
    vmapped ``fsk_demod_bits``, and packs the same bytes."""
    batch, payloads = _capture_batch("FSK1200", 21)
    packed, n_valid, found = tb.demod_pack_batch(torch.from_numpy(batch), "FSK1200", 1200)
    raws = [packed[i, : int(n_valid[i])].numpy().tobytes() for i in range(len(batch))]
    assert [[f.data for f in t_parse(r)] for r in raws] == [[p] if p else [] for p in payloads]
    assert bool(found[0]) and bool(found[1])
    batch, payloads = _capture_batch("FSK9600", 23, noise=False)
    got = tb.demod_pack_batch(torch.from_numpy(batch), "FSK9600", 9600)
    _assert_pack_equal(got, j_demod_pack_batch(jnp.asarray(batch), "FSK9600", 9600))
    raws = [got[0][i, : int(got[1][i])].numpy().tobytes() for i in range(len(batch))]
    assert [[f.data for f in t_parse(r)] for r in raws] == [[p] for p in payloads]


def test_batch_mlse_refused(configs):
    """CONFIG modem.batch_mlse: close-tone captures stay flat and run the
    MLSE-refined single-capture receiver per capture (the same byte stream
    as the JAX package's), dual tones keep their rows (the same frames).
    The PSK kinds ignore the FSK-only knob."""
    configs("modem", "batch_mlse", True)
    for cfg in ("FSK9600", "FSK1200"):
        mode, rate = CONFIGS[cfg][:2]
        batch, payloads = _capture_batch(cfg, 24, leads=(0,), noise=False)
        got = tb.decode_sample_batch(batch, mode, rate, device="cpu")
        ref = j_decode_sample_batch(batch, mode, rate)
        assert _frames(got, t_parse) == _frames(ref, j_parse)
        if cfg == "FSK9600":  # the same receiver on the same flat capture: the same stream
            assert got == ref
        assert [[f.data for f in t_parse(r)] for r in got] == [[p] for p in payloads]
    assert tb.host_shape_batch(batch, "FSK9600", 9600, device="cpu").shape == batch.shape
    assert len(tb.decode_sample_batch(np.zeros((1, 1 << 16), np.float32), "QPSK", 9600, device="cpu")) == 1


def test_default_device_is_the_card():
    """No silent CPU fallback: ``device=None`` means CUDA, and without a card
    the entry points raise instead of running on the CPU."""
    from audio_modem_radio_tpu_torch.utils.torchenv import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.decode_sample_batch(np.zeros((1, 1 << 16), np.float32), "FSK1200", 1200)
    assert resolve_device("cpu").type == "cpu"


def test_tables_from_reference_fsk():
    """The JAX package's FSK tables, carried across, drive the port's plain
    kernels to the same outputs as the port's own tables."""
    _, _, baud, mark, space = CONFIGS["FSK9600"]
    spb = jfsk._samples_per_bit(SR, baud)
    blo, bhi, dec, taps = jfsk._fir_frontend_plan(baud, mark, space, SR)
    plan = jfsk._fsk_disc_kernel_plan(spb, dec, taps)
    geom = (plan["spr2"], plan["row2"], plan["ov2"])
    s12 = jfsk._samples_per_bit(SR, 1200.0)
    arrays = {
        "_fsk_blocked_templates": jfsk._fsk_blocked_templates(s12, 1200.0, 2200.0, SR, 8),
        "_fir_padded_template": jfsk._fir_padded_template(blo, bhi, SR, taps, dec, plan),
        "_fsk_boxcar_templates_geom": jfsk._fsk_boxcar_templates_geom(spb, 8, dec, *geom),
        "_fsk_quadrature_templates_geom": jfsk._fsk_quadrature_templates_geom(
            spb, mark, space, SR, 8, *geom),
        "_discriminator_calibration": jfsk._discriminator_calibration(
            spb, baud, mark, space, SR, float(blo), float(bhi), fir_taps=taps, dec=dec),
    }
    got = tables_from_reference(arrays, "cpu")
    for name, a in arrays.items():
        assert got[name].dtype == torch.float32 and np.array_equal(got[name].numpy(), a), name
    batch, _ = _capture_batch("FSK9600", 22, leads=(0,), noise=False)
    x = torch.from_numpy(tb.host_shape_batch(batch, "FSK9600", 9600, device="cpu"))
    best, plan_t, Wf, Wb, _coef = tfsk.fsk_disc_pass1(x, baud, mark, space, SR)
    kw = dict(rows_per_capture=x.shape[1], nrow2=plan_t["nrow2"], row2=plan_t["row2"], ov2=plan_t["ov2"],
              spr2=plan_t["spr2"])
    ours = tk.fsk_disc_sums_batch(x, Wf, Wb, best, **kw)
    theirs = tk.fsk_disc_sums_batch(x, got["_fir_padded_template"], got["_fsk_boxcar_templates_geom"], best, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    with pytest.raises(KeyError):
        tables_from_reference({"_fsk_templates": arrays["_fir_padded_template"]})
    with pytest.raises(ValueError):
        tables_from_reference({"_fir_padded_template": arrays["_fsk_boxcar_templates_geom"]}, "cpu")


def test_unported_fsk_shapes_refused():
    """FIR-window rows (``fsk_fir_row_shape``: 637 columns for FSK9600) and
    captures too short for any row layout take the single-capture receiver
    per capture, as in the JAX package: ten FIR rows of a real capture pack
    the same bytes, and a 100-sample FSK1200 capture (one bit) raises the
    same ValueError."""
    batch, _ = _capture_batch("FSK9600", 25, leads=(0,), noise=False)
    r, row, ov, lead = jfsk.fsk_fir_row_shape(batch.shape[1], 9600.0, 1200.0, 2200.0, SR)
    assert row + ov == 637
    rows = j_overlap_rows(batch, r, row, ov, lead=lead)[:, :10]
    got = tb.demod_pack_batch(torch.from_numpy(rows), "FSK9600", 9600)
    _assert_pack_equal(got, j_demod_pack_batch(jnp.asarray(rows), "FSK9600", 9600))
    with pytest.raises(ValueError, match="shorter than two bit periods"):
        j_demod_pack_batch(jnp.zeros((1, 100)), "FSK1200", 1200)
    with pytest.raises(ValueError, match="shorter than two bit periods"):
        tb.demod_pack_batch(torch.zeros((1, 100)), "FSK1200", 1200)
