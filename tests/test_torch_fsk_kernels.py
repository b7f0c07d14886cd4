"""K7, K13, K8 and K9 of the PyTorch port: the plain versions vs the Pallas
kernels in interpret mode and the JAX package's XLA paths, the CUDA
kernels' arithmetic mirrored in numpy, and the wrappers' checks, on the CPU.

The CUDA kernels cannot run here. What they compute beyond the plain
versions (the band tables they read instead of the dense templates, K13's
flat indexing, the FIR's taps and decimation recovered from its matrix, the
FIR staging, the chunk walk and the analytic ring of K8 and K9) is mirrored in numpy and held against the plain
versions, which are in turn held against the JAX package.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.ops import fsk as jfsk
from audio_modem_radio_tpu.ops.pallas_kernels import (
    fsk_disc_sums_batch as j_disc_sums,
    fsk_project_bits_batch as j_project_bits,
    fsk_quad_margin_batch as j_quad_margin,
    fsk_tile_bits_batch as j_tile_bits,
)
from audio_modem_radio_tpu.parallel.batch import _overlap_rows as j_overlap_rows

from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
MARK, SPACE = 1200.0, 2200.0


def _wave(baud, mark, space, seed, payload_len):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, payload_len, dtype=np.uint8).tobytes()
    framed = pack_frame("k.bin", p, 0, 1, len(p), crc32(p))
    return np.asarray(jfsk.fsk_modulate(framed, baud, mark, space, SR), np.float32)


def _batch(baud, mark, space, n, leads, snr_db=None, seed=0, payload_len=600):
    """One clean capture per lead (different timing offsets), plus one
    capture with AWGN at ``snr_db`` when given."""
    rows = []
    for i, lead in enumerate(list(leads) + ([leads[0]] if snr_db is not None else [])):
        w = _wave(baud, mark, space, seed + i, payload_len)[: n - lead]
        row = np.zeros(n, np.float32)
        row[lead : lead + len(w)] = w
        rows.append(row)
    batch = np.stack(rows)
    if snr_db is not None:
        rng = np.random.default_rng(seed + 99)
        sig = batch[-1]
        batch[-1] = sig + rng.normal(0, np.sqrt(np.mean(sig**2) / 10 ** (snr_db / 10)), n)
    return batch


def _n_sig(n, baud):
    return n // jfsk._samples_per_bit(SR, baud) - 2


def _check_bits(got, ref, n_sig, noisy_last):
    """Bits equal on [0, n_sig) for clean captures; at most 1e-4 of them
    different on the AWGN capture (summation order differs)."""
    got, ref = np.asarray(got)[:, :n_sig], np.asarray(ref)[:, :n_sig]
    clean = slice(0, len(got) - 1) if noisy_last else slice(None)
    assert np.array_equal(got[clean], ref[clean])
    if noisy_last:
        assert np.mean(got[-1] != ref[-1]) <= 1e-4


# --- K7 and K13 ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("baud", [1200.0, 750.0])  # spr 16 (FSK1200) and 8 (spb 128)
def test_tile_plain_equals_pallas_and_xla(baud, dtype):
    spb = jfsk._samples_per_bit(SR, baud)
    spr, row, ov = jfsk._fsk_geometry(spb)
    n = 256 * row
    batch = _batch(baud, MARK, SPACE, n, (0, spb // 3 + 1), snr_db=6.0, payload_len=250)
    rows = j_overlap_rows(batch, 256, row, ov, dtype=dtype)
    x = torch.from_numpy(rows)
    best, W, spr_t = tfsk.fsk_dual_pass1(x, baud, MARK, SPACE, SR)
    assert spr_t == spr
    got = tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=256, spr=spr)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 256 * spr)
    ref = j_tile_bits(jnp.asarray(rows), jnp.asarray(W.numpy()), jnp.asarray(best.numpy()),
                      rows_per_capture=256, spr=spr, interpret=True)
    _check_bits(got.numpy(), ref, _n_sig(n, baud), True)
    for kernel in (True, False):
        jbits = jfsk.fsk_dual_bits_rows_batch(jnp.asarray(rows), baud, MARK, SPACE, SR, kernel=kernel)
        _check_bits(tfsk.fsk_dual_bits_rows_batch(x, baud, MARK, SPACE, SR, kernel=kernel).numpy(), jbits,
                    _n_sig(n, baud), True)


def test_project_plain_equals_pallas_and_xla():
    baud = 1200.0
    spb = jfsk._samples_per_bit(SR, baud)
    spr, row, _ov = jfsk._fsk_geometry(spb)
    n = 256 * row
    batch = _batch(baud, MARK, SPACE, n, (0, 29), snr_db=6.0, payload_len=250)
    W = jfsk._fsk_blocked_templates(spb, MARK, SPACE, SR, 8)
    best = np.array([0, 3, 5], np.int32)
    x3d = batch.reshape(3, 256, row)
    got = tk.fsk_project_bits_batch(torch.from_numpy(x3d), torch.from_numpy(W), torch.from_numpy(best),
                                    rows_per_capture=256, spr=spr)
    ref = j_project_bits(jnp.asarray(x3d), jnp.asarray(W), jnp.asarray(best), rows_per_capture=256,
                         spr=spr, interpret=True)
    # The Pallas kernel reads the next capture at a capture's last row; the
    # port reads zeros, so compare the rows before it.
    _check_bits(got.numpy(), ref, (256 - 1) * spr, False)
    got_b = tfsk.fsk_demod_bits_batch(torch.from_numpy(batch), baud, MARK, SPACE, SR)
    ref_b = jfsk.fsk_demod_bits_batch(jnp.asarray(batch), baud, MARK, SPACE, SR)
    _check_bits(got_b.numpy(), ref_b, _n_sig(n, baud), True)


# --- K8 and K9 ------------------------------------------------------------------------

def _fused(kind, dtype, n):
    baud, mark, space = (9600.0, MARK, SPACE) if kind == "disc" else (19200.0, 8000.0, 16000.0)
    batch = _batch(baud, mark, space, n, (0, 7), snr_db=15.0, payload_len=500)
    shape = (jfsk.fsk_disc_row_shape if kind == "disc" else jfsk.fsk_quad_row_shape)(n, baud, mark, space, SR)
    r, row, ov, lead = shape
    rows = j_overlap_rows(batch, r, row, ov, lead=lead, dtype=dtype)
    return rows, (baud, mark, space), _n_sig(n, baud)


def _relative_close(got, ref, n_sig):
    for g, p in zip(got, np.asarray(ref)):
        g, p = np.asarray(g)[:n_sig], p[:n_sig]
        assert np.abs(g - p).max() <= 1e-4 * np.abs(p).max()


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_disc_plain_equals_pallas_and_xla(dtype):
    rows, cfg, n_sig = _fused("disc", dtype, 1 << 18)
    x = torch.from_numpy(rows)
    best, plan, Wf, Wb, _ = tfsk.fsk_disc_pass1(x, *cfg, SR)
    kw = dict(rows_per_capture=rows.shape[1], nrow2=plan["nrow2"], row2=plan["row2"], ov2=plan["ov2"],
              spr2=plan["spr2"])
    sr, si = tk.fsk_disc_sums_batch(x, Wf, Wb, best, **kw)
    sr_j, si_j = j_disc_sums(jnp.asarray(rows), jnp.asarray(Wf.numpy()), jnp.asarray(Wb.numpy()),
                             jnp.asarray(best.numpy()), interpret=True, **kw)
    _relative_close(sr.numpy(), sr_j, n_sig)
    _relative_close(si.numpy(), si_j, n_sig)
    for kernel in (True, False) if dtype == np.float32 else (False,):
        bits = tfsk.fsk_disc_bits_rows_batch(x, *cfg, SR, kernel=kernel).numpy()
        _check_bits(bits, jfsk.fsk_disc_bits_rows_batch(jnp.asarray(rows), *cfg, SR, kernel=kernel),
                    n_sig, True)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_quad_plain_equals_pallas_and_xla(dtype):
    rows, cfg, n_sig = _fused("quad", dtype, 1 << 17)
    x = torch.from_numpy(rows)
    best, plan, Wf, Wq = tfsk.fsk_quad_pass1(x, *cfg, SR)
    kw = dict(rows_per_capture=rows.shape[1], nrow2=plan["nrow2"], row2=plan["row2"], ov2=plan["ov2"],
              spr2=plan["spr2"])
    margin = tk.fsk_quad_margin_batch(x, Wf, Wq, best, **kw)
    margin_j = j_quad_margin(jnp.asarray(rows), jnp.asarray(Wf.numpy()), jnp.asarray(Wq.numpy()),
                             jnp.asarray(best.numpy()), interpret=True, **kw)
    _relative_close(margin.numpy(), margin_j, n_sig)
    for kernel in (True, False) if dtype == np.float32 else (False,):
        bits = tfsk.fsk_quad_bits_rows_batch(x, *cfg, SR, kernel=kernel).numpy()
        _check_bits(bits, jfsk.fsk_quad_bits_rows_batch(jnp.asarray(rows), *cfg, SR, kernel=kernel),
                    n_sig, True)


# --- the CUDA kernels' arithmetic, mirrored in numpy ----------------------------------

def _tile_numpy(x3d, first, tab, span, best, flat):
    """csrc/fsk_tile.cu: one bit at a time from the band tables; FLAT reads
    the capture's flat stream (zeros past its end)."""
    b, r, cols = x3d.shape
    spr = first.shape[1]
    out = np.zeros((b, r * spr), np.uint8)
    for i in range(b):
        k = best[i]
        stream = np.concatenate([x3d[i].reshape(-1).astype(np.float32), np.zeros(2 * cols, np.float32)])
        for g in range(r * spr):
            j, s = divmod(g, spr)
            p = j * cols + first[k, s]
            v = stream[p : p + span] if flat else x3d[i, j, first[k, s] : first[k, s] + span].astype(np.float32)
            a = tab[k, :, :, s] @ v.astype(np.float64)
            out[i, g] = (a[0] ** 2 + a[1] ** 2) - (a[2] ** 2 + a[3] ** 2) > 0
    return out


@pytest.mark.parametrize("flat", [False, True])
def test_tile_kernel_arithmetic_mirrored(flat):
    baud = 1000.0  # spr 12: no Pallas geometry, the port's kernel takes it
    spb = jfsk._samples_per_bit(SR, baud)
    spr, row, ov = jfsk._fsk_geometry(spb)
    r = 6
    batch = _batch(baud, 6000.0, 7000.0, r * row, (0, 41), payload_len=60)
    W = torch.from_numpy(jfsk._fsk_blocked_templates(spb, 6000.0, 7000.0, SR, 8))
    first, tab, span = tk._band_tables(W, 4)
    assert span == spb
    best = np.array([2, 6], np.int32)
    x3d = batch.reshape(2, r, row) if flat else j_overlap_rows(batch, r, row, ov)
    plain = (tk.fsk_project_bits_batch_plain if flat else tk.fsk_tile_bits_batch_plain)(
        torch.from_numpy(x3d), W, torch.from_numpy(best), spr).numpy()
    mirror = _tile_numpy(x3d, first.numpy(), tab.numpy(), span, best, flat)
    assert np.array_equal(mirror, plain)


# csrc/fsk_tile.cu's K7 constants: rows a thread sums for one bit, rows a
# tile buffer holds at most, threads a block, the block's shared memory.
_K7_ROWS_PER_ITEM, _K7_TILE_ROWS, _K7_SMEM = 4, 32, 220 * 1024
_K7_THREADS = 16 * _K7_TILE_ROWS // _K7_ROWS_PER_ITEM


def _k7_numpy(x3d, first, tab, span, best, per_sm=1, sms=132):
    """csrc/fsk_tile.cu fsk_tile_kernel, block by block, for a 16-byte
    aligned tensor: the one-wave grid's tile walk, each row's chunks of the
    capture's band staged (the same chunks for every row, since rows start
    on 16-byte boundaries) at an odd chunk stride, then each item (g, s),
    bit s of rows g, g+G, .. read from it. Asserts that every staged word a
    (bit, t) reads is sample first + t of its own row, that each bit is
    written once, and that where a quarter-warp's 8 items share a bit they
    read 8 different 16-byte bank groups. The sums are float64. Returns the
    bits (B, R*spr)."""
    b, r, cols = x3d.shape
    spr = first.shape[1]
    per_chunk = 16 // x3d.dtype.itemsize
    assert cols % per_chunk == 0
    rs_max = (cols // per_chunk) | 1
    fit = (_K7_SMEM - 16 * spr * span) // (2 * 16 * rs_max)
    tile_rows = max(1, min(_K7_TILE_ROWS, fit))
    n_tiles = -(-r // tile_rows)
    per_capture = min(n_tiles, max(1, per_sm * sms // b))
    out = np.full((b, r * spr), 255, np.uint8)
    t = np.arange(span)
    shared_s = 0
    for i in range(b):
        k = best[i]
        lo, hi = int(first[k].min()), int(first[k].max()) + span
        c_lo = lo // per_chunk
        phase = lo - c_lo * per_chunk
        cpr = -(-hi // per_chunk) - c_lo
        rs = cpr | 1
        assert rs <= rs_max and (c_lo + cpr) * per_chunk <= cols
        tiles = [tl for bx in range(per_capture) for tl in range(bx, n_tiles, per_capture)]
        assert sorted(tiles) == list(range(n_tiles))
        for tile in tiles:
            j0 = tile * tile_rows
            n_rows = min(tile_rows, r - j0)
            buf = np.full(tile_rows * rs_max * per_chunk, np.nan)  # words no item may read stay NaN
            for jj in range(n_rows):
                src = x3d[i, j0 + jj, c_lo * per_chunk : (c_lo + cpr) * per_chunk].astype(np.float64)
                buf[jj * rs * per_chunk : jj * rs * per_chunk + len(src)] = src
            G = -(-n_rows // _K7_ROWS_PER_ITEM)
            items = np.arange(G * spr)
            g, s = items % G, items // G
            e = phase + first[k, s] - lo  # (items,)
            jj = g[:, None] + G * np.arange(_K7_ROWS_PER_ITEM)  # (items, rows)
            ok = jj < n_rows
            jj = np.where(ok, jj, g[:, None])
            word = (jj * rs * per_chunk + e[:, None])[:, :, None] + t  # (items, rows, span)
            want = x3d[i, (j0 + jj)[:, :, None], (first[k, s][:, None, None] + t)].astype(np.float64)
            assert np.array_equal(buf[word], want)
            # A quarter-warp: 8 consecutive items of one pass over the tile.
            for q0 in range(0, len(items) - 7, 8):
                if (s[q0 : q0 + 8] == s[q0]).all():
                    shared_s += 1
                    chunk = (word[q0 : q0 + 8, :, ::per_chunk] // per_chunk) % 8
                    assert (np.sort(chunk, axis=0) == np.arange(8)[:, None, None]).all()  # no bank conflict
            a = np.einsum("irt,gti->irg", buf[word], tab[k][:, :, s])
            dec = ((a[..., 0] ** 2 + a[..., 1] ** 2) - (a[..., 2] ** 2 + a[..., 3] ** 2) > 0).astype(np.uint8)
            bit = (j0 + jj) * spr + s[:, None]
            assert (out[i, bit[ok]] == 255).all()  # each bit once
            out[i, bit[ok]] = dec[ok]
    assert (out != 255).all()
    return out, shared_s


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("geom", ["FSK1200", "MSK@1000", "FT8", "FSK1200 one block per capture"])
def test_tile_kernel_staging_mirrored(geom, dtype):
    """K7's new schedule in numpy against the plain version: FSK1200 (spr
    16), MSK@1000 (spr 12) and FT8 (spr 1) overlapped rows, 101 rows (the
    last tile ragged for every geometry), 2 captures at different timing
    offsets; once with one multiprocessor, so each block walks a whole
    capture. On int16 rows (the main path) a tile holds 32 rows, so every
    quarter-warp reads one bit of 8 rows; float32 rows, twice the bytes,
    fit 18 and share banks."""
    baud, mark, space = {"MSK@1000": (1000.0, 6000.0, 7000.0), "FT8": (50.0, 3000.0, 3050.0)}.get(
        geom, (1200.0, MARK, SPACE))
    spb = jfsk._samples_per_bit(SR, baud)
    spr, row, ov = jfsk._fsk_geometry(spb)
    r = 3 * _K7_TILE_ROWS + 5
    batch = _batch(baud, mark, space, r * row, (0, spb // 8 * 3 + 1), payload_len=30 if geom == "FT8" else 200)
    x3d = np.ascontiguousarray(j_overlap_rows(batch, r, row, ov, dtype=dtype))
    assert x3d.dtype == dtype
    W = torch.from_numpy(jfsk._fsk_blocked_templates(spb, mark, space, SR, 8))
    best = np.array([0, 3], np.int32)
    first, tab, span = tk._band_tables(W, 4)
    plain = tk.fsk_tile_bits_batch_plain(torch.from_numpy(x3d), W, torch.from_numpy(best), spr).numpy()
    sms = 1 if "one block" in geom else 132
    mirror, shared_s = _k7_numpy(x3d, first.numpy(), tab.numpy(), span, best, sms=sms)
    assert np.array_equal(mirror, plain)
    assert 0.2 < plain[:, : _n_sig(r * row, baud)].mean() < 0.8
    if geom != "FT8" and dtype == np.int16:  # float32 rows fit tiles of under 29 rows: G < 8
        assert shared_s > 0


# csrc/fsk_tile.cu's K13 constants: threads a block, rows a tile buffer, the
# shared memory a block may take, the multiprocessors of an H100.
_FLAT_THREADS, _FLAT_TILE_ROWS, _FLAT_SMEM, _SMS = 128, 8, 112 * 1024, 132


def _flat_numpy(x3d, first, tab, span, best, tab_rows):
    """csrc/fsk_tile.cu fsk_flat_kernel, block by block, for a 16-byte
    aligned tensor: the tile walk, each staged row (float32: the 16-byte
    chunks holding its band, so the band keeps its offset in a chunk, zeros
    past the capture; int16: converted samples from offset 0) at a stride of
    an odd number of chunks, then each (row, bit) item read from it. Asserts
    that every staged word a (bit, t) reads is the flat sample j*row + first
    + t (or a zero past the capture), that each bit is written once, and
    that the 8 rows a quarter-warp reads at once lie in 8 different chunks
    of banks. Returns the bits."""
    b, r, row = x3d.shape
    spr = first.shape[1]
    row_floats = 4 * (((tab_rows + 6) >> 2) | 1)
    fit = (_FLAT_SMEM - 16 * spr * span) // (2 * 4 * row_floats)
    tile_rows = max(1, min(_FLAT_TILE_ROWS, fit))
    n_tiles = -(-r // tile_rows)
    per_capture = min(n_tiles, max(1, 2 * _SMS // b))
    n_cap = r * row
    flat_all = x3d.reshape(-1).astype(np.float32)
    out = np.full((b, r * spr), 255, np.uint8)
    t = np.arange(span)
    for i in range(b):
        k = best[i]
        lo, hi = int(first[k].min()), int(first[k].max()) + span
        ls = hi - lo
        rs = 4 * (((ls + 6) >> 2) | 1)
        assert rs <= row_floats
        tiles = [tl for bx in range(per_capture) for tl in range(bx, n_tiles, per_capture)]
        assert sorted(tiles) == list(range(n_tiles))
        for tile in tiles:
            j0 = tile * tile_rows
            n_rows = min(tile_rows, r - j0)
            xs = np.full(n_rows * rs, np.nan, np.float32)  # words no item may read stay NaN
            phase = np.zeros(n_rows, np.int64)
            for jj in range(n_rows):
                p0 = (j0 + jj) * row + lo
                if x3d.dtype == np.float32:
                    phase[jj] = (i * n_cap + p0) & 3
                    chunks = (phase[jj] + ls + 3) >> 2
                    p = p0 - phase[jj] + np.arange(4 * chunks)
                    assert 4 * chunks <= rs and i * n_cap + p[0] >= 0
                    vals = np.where(p < n_cap, flat_all[np.minimum(i * n_cap + p, flat_all.size - 1)], 0.0)
                else:
                    p = p0 + np.arange(ls)
                    vals = np.where(p < n_cap, flat_all[np.minimum(i * n_cap + p, flat_all.size - 1)], 0.0)
                xs[jj * rs : jj * rs + len(vals)] = vals
            items = np.arange(n_rows * spr)
            jj, s = items % n_rows, items // n_rows
            e0 = jj * rs + phase[jj] + (first[k, s] - lo)
            word = e0[:, None] + t  # (items, span)
            p = (j0 + jj)[:, None] * row + first[k, s][:, None] + t
            want = np.where(p < n_cap, flat_all[np.minimum(i * n_cap + p, flat_all.size - 1)], 0.0)
            assert np.array_equal(xs[word], want)
            if n_rows == 8:
                quarter = (word[:, ::4] >> 2).reshape(-1, 8, (span + 3) // 4) % 8
                assert (np.sort(quarter, axis=1) == np.arange(8)[None, :, None]).all()  # no bank conflict
            a = np.einsum("it,gti->ig", xs[word].astype(np.float64), tab[k][:, :, s])
            dec = ((a[:, 0] ** 2 + a[:, 1] ** 2) - (a[:, 2] ** 2 + a[:, 3] ** 2) > 0).astype(np.uint8)
            g = (j0 + jj) * spr + s
            assert (out[i, g] == 255).all()  # each bit once
            out[i, g] = dec
    assert (out != 255).all()
    return out


@pytest.fixture(scope="module")
def flat_case():
    """FSK1200 (spr 16, spb 80) and MSK@1000 (spr 12, spb 96) flat rows of
    85 rows (10 full tiles and a ragged one): 8 captures of a tiled wave,
    capture k led by offset k's step so that every offset decides crisp
    bits."""
    cases = {}
    for baud, mark, space in ((1200.0, MARK, SPACE), (1000.0, 6000.0, 7000.0)):
        spb = jfsk._samples_per_bit(SR, baud)
        spr, row, _ov = jfsk._fsk_geometry(spb)
        W = torch.from_numpy(jfsk._fsk_blocked_templates(spb, mark, space, SR, 8))
        wave = _wave(baud, mark, space, 3, 300)
        n = 85 * row
        x = np.stack([np.tile(wave, -(-(n + 100) // len(wave)))[100 - spb // 8 * k : 100 - spb // 8 * k + n]
                      for k in range(8)]).reshape(8, 85, row)
        cases[baud] = (W, x, spr)
    return cases


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("baud", [1200.0, 1000.0])
def test_flat_kernel_staging_mirrored(flat_case, baud, dtype):
    W, x, spr = flat_case[baud]
    if dtype == np.int16:
        x = np.round(x * 10000).astype(np.int16)
    first, tab, span = tk._band_tables(W, 4)
    best = np.arange(8, dtype=np.int32)
    if baud == 1200.0:
        assert int((first[:, -1] + span).max()) > x.shape[2]  # offset 7's band runs into the zero tail
    plain = tk.fsk_project_bits_batch_plain(torch.from_numpy(x), W, torch.from_numpy(best), spr).numpy()
    mirror = _flat_numpy(x, first.numpy(), tab.numpy(), span, best, W.shape[1])
    assert np.array_equal(mirror, plain)


# csrc/fsk_fir.cuh's constants. A block walks 512 FIR rows there; the mirror
# walks 48 (3 passes), so that these short captures span several blocks.
_Q, _THREADS, _STAGE_ROWS = 8, 256, 8
_PASS_ROWS = _THREADS * _Q // 128
_SPP = _PASS_ROWS // _STAGE_ROWS
_STAGES = _SPP  # the raw ring holds one pass
_PASS_OUT = _PASS_ROWS * 128
_CHUNK_ROWS = 48


def _fir_stream_numpy(xc, row0, n_rows, h, dec):
    """csrc/fsk_fir.cuh FirStream: one block's passes over FIR rows [row0,
    row0 + n_rows) of the capture ``xc`` (r, c_pad), yielding each pass's
    2048 analytic outputs ``(p, zr, zi)`` as the block stages and computes
    them. Each row's run x[g, 128:c_pad) is fetched once into a ring of two
    8-row stages (stage s in slot s % 2), a pass's first row adds its head
    x[g, 0:128), both fetched for pass p+1 once pass p is converted; rows
    past the walk or the capture are not fetched; a pass of 16 rows is
    converted into one buffer in stream
    order with 4 pad words after every 8*dec samples; thread t reads its
    window from word (8*dec + 4)*t on, and rows past the capture give zeros.
    What was never fetched is NaN here, so a read of it that reached an
    output would show."""
    rows_cap = xc.shape[0]
    run, group = 128 * dec, _Q * dec
    stride = group + 4
    assert xc.shape[1] == run + 128
    n_chunks = (dec * (_Q - 1) + 129 + 3) // 4
    pass_samples = _PASS_ROWS * run + 128
    ring = np.full((_STAGES, _STAGE_ROWS, run), np.nan)
    head = np.full(128, np.nan)
    fetched = np.zeros(xc.shape[0], int)

    def issue(s):
        r0 = s * _STAGE_ROWS
        for i in range(_STAGE_ROWS):
            if r0 + i < n_rows and row0 + r0 + i < rows_cap:
                ring[s % _STAGES, i] = xc[row0 + r0 + i, 128:]
                fetched[row0 + r0 + i] += 1
        if s % _SPP == 0 and r0 < n_rows and row0 + r0 < rows_cap:
            head[:] = xc[row0 + r0, :128]

    o = np.arange(4 * n_chunks)
    window = o // group * stride + o % group  # a thread's compile-time offsets
    L = np.arange(pass_samples)
    for s in range(_STAGES):
        issue(s)
    for p in range(-(-n_rows // _PASS_ROWS)):
        stream = np.concatenate([head] + [ring[(p * _SPP + j) % _STAGES].reshape(-1) for j in range(_SPP)])
        xf = np.full(pass_samples // group * stride, np.nan)
        xf[L // group * stride + L % group] = stream
        for s in range(_SPP):
            issue(_STAGES + p * _SPP + s)
        z = np.zeros((_PASS_OUT, 2))
        for t in range(_THREADS):
            row = p * _PASS_ROWS + t // (128 // _Q)
            if row < n_rows and row0 + row < rows_cap:
                w = xf[t * stride + window]
                for q in range(_Q):
                    z[_Q * t + q] = h @ w[dec * q : dec * q + 129]
        yield p, z[:, 0], z[:, 1]
    assert fetched.max() <= 1  # each run fetched once


@pytest.mark.parametrize("kind", ["disc", "quad"])
def test_fir_kernels_arithmetic_mirrored(kind):
    """K8 and K9 as the CUDA kernels compute them: taps and dec recovered
    from the dense FIR matrix; blocks that each walk a chunk of a capture's
    FIR rows in full passes (every sample fetched once from consecutive
    windows, zeros past the capture), keep a pass of the analytic stream
    and the row before it in a ring and, after each pass, sum the bits
    whose windows it completed, from the band tables of the boxcar / quadrature templates.
    Every bit is written by exactly one block, once."""
    _mirror_fir_kernel(kind, np.float32, False)


@pytest.mark.parametrize("dtype,ragged", [(np.float32, True), (np.int16, False), (np.int16, True)])
@pytest.mark.parametrize("kind", ["disc", "quad"])
def test_fir_kernels_staging_mirrored(kind, dtype, ragged):
    """The same on int16 rows and, ``ragged``, on a FIR row count that is no
    multiple of a pass or a chunk, so that the last block of each capture is
    cut short and reads past the capture's last FIR row."""
    _mirror_fir_kernel(kind, dtype, ragged)


def _mirror_fir_kernel(kind, dtype, ragged):
    n = 1 << 15
    rows, cfg, n_sig = _fused(kind, dtype, n)
    x = torch.from_numpy(rows)
    pass1 = tfsk.fsk_disc_pass1 if kind == "disc" else tfsk.fsk_quad_pass1
    best, plan, Wf, W2 = pass1(x, *cfg, SR)[:4]
    h, dec = tk._fir_taps(Wf)
    assert dec == plan["dec"] and h.shape == (2, 129)
    row2, ov2, spr2, nrow2 = plan["row2"], plan["ov2"], plan["spr2"], plan["nrow2"]
    if ragged:
        nrow2 = 1
        rows = np.ascontiguousarray(rows[:, : row2 // 128 * 19])  # 95 FIR rows: 2 chunks and 3 rows
        x = torch.from_numpy(rows)
    first, tab, span = tk._band_tables(W2, 1 if kind == "disc" else 4)
    first, tab = first.numpy(), tab.numpy().astype(np.float64)
    b, r, _ = rows.shape
    r2 = r * 128 // row2
    window = span + (kind == "disc")  # analytic samples a bit reads
    extra = -(-window // 128)
    chunk_step = _CHUNK_ROWS - extra
    chunks_per_capture = -(-(r + ov2 // 128) // chunk_step)
    assert chunks_per_capture >= 2
    out = np.zeros((2 if kind == "disc" else 1, b, r2 * spr2))
    written = np.zeros((b, r2 * spr2), int)
    for cap in range(b):
        k = int(best[cap])
        for c in range(chunks_per_capture):
            row0 = c * chunk_step
            own_lo, own_hi = row0 * 128, (row0 + chunk_step) * 128
            n_rows = min(_CHUNK_ROWS, -(-(min(own_hi, r * 128 + ov2) - own_lo + window) // 128))
            ring = _PASS_OUT + extra * 128  # a pass and the rows before it that a window can reach
            zr, zi = np.full(ring, np.nan), np.full(ring, np.nan)
            zbase = 0  # where the ring holds this pass's first output
            for p, zr_p, zi_p in _fir_stream_numpy(rows[cap].astype(np.float64), row0, n_rows,
                                                   h.astype(np.float64), dec):
                at = (zbase + np.arange(_PASS_OUT)) % ring
                zr[at], zi[at] = zr_p, zi_p
                prev, lim = own_lo + p * _PASS_OUT, own_lo + (p + 1) * _PASS_OUT
                lo = prev + 1 - window - (row2 + ov2 - 1)
                i_lo = 0 if lo <= 0 else -(-lo // row2)
                i_hi = min(r2 - 1, int((lim - window) / row2))
                for i in range(i_lo, i_hi + 1):
                    for s in range(spr2):
                        n0 = i * row2 + int(first[k, s])
                        if n0 < own_lo or n0 >= own_hi or n0 + window <= prev or n0 + window > lim:
                            continue
                        n = zbase + n0 - prev
                        n += ring if n < 0 else -ring if n >= ring else 0
                        assert 0 <= n < ring
                        at = (n + np.arange(span + 1)) % ring
                        vr, vi = zr[at], zi[at]
                        if kind == "disc":
                            pr = vr[1:] * vr[:-1] + vi[1:] * vi[:-1]
                            pi = vi[1:] * vr[:-1] - vr[1:] * vi[:-1]
                            val = pr @ tab[k, 0, :, s], pi @ tab[k, 0, :, s]
                        else:
                            M, N = tab[k, :, :, s] @ vr[:-1], tab[k, :, :, s] @ vi[:-1]
                            u_m, v_m, u_s, v_s = M[0] + N[1], N[0] - M[1], M[2] + N[3], N[2] - M[3]
                            val = (u_m**2 + v_m**2 - u_s**2 - v_s**2,)
                        out[:, cap, i * spr2 + s] = val
                        written[cap, i * spr2 + s] += 1
                zbase = (zbase + _PASS_OUT) % ring
    assert (written == 1).all() and not np.isnan(out).any()
    kw = dict(rows_per_capture=r, nrow2=nrow2, row2=row2, ov2=ov2, spr2=spr2)
    if kind == "disc":
        plain = [p.numpy() for p in tk.fsk_disc_sums_batch(x, Wf, W2, best, **kw)]
    else:
        plain = [tk.fsk_quad_margin_batch(x, Wf, W2, best, **kw).numpy()]
    for got, ref in zip(out, plain):
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


# --- the wrappers' checks --------------------------------------------------------------

def test_band_tables_rebuild_the_dense_templates():
    W = torch.from_numpy(jfsk._fsk_quadrature_templates_geom(5, 8000.0, 16000.0, SR, 8, 128, 640, 128))
    first, tab, span = tk._band_tables(W, 4)
    assert span == 5 and tuple(tab.shape) == (8, 4, 5, 128)
    dense = torch.zeros_like(W).reshape(8, 768, 4, 128)
    for t in range(span):
        rows = first + t  # (8, 128)
        for g in range(4):
            dense[torch.arange(8)[:, None], rows, g, torch.arange(128)[None, :]] = tab[:, g, t, :]
    assert torch.equal(dense.reshape(W.shape), W)


def _t(a):
    # A copy: the writes below must not reach a table the builders cache.
    return torch.from_numpy(np.array(a, np.float32))


def _fir_entries(plan_wf_w2, groups):
    """K8's or K9's derived tables: the band tables of the boxcar or
    quadrature template, the taps of the FIR matrix."""
    _plan, wf, w2 = plan_wf_w2[:3]  # _disc_templates adds the band edges
    return [(_t(w2), ("band_tables", groups), lambda w: tk._band_tables(w, groups)),
            (_t(wf), "fir_taps", tk._fir_taps)]


# Each case: the templates a wrapper derives tables from, each with the tag
# and the builder the wrapper hands the cache.
_KEPT_CASES = {
    "k1_dual_basis": lambda: [(_t(tpsk._blocked_templates(10, 3000.0, SR, 8)), ("dual_basis", 10),
                               lambda w: tk._dual_basis(w, 10))],
    "k7_band_tables": lambda: [(_t(tfsk._fsk_blocked_templates(80, MARK, SPACE, SR, 8)), ("band_tables", 4),
                                lambda w: tk._band_tables(w, 4))],
    "k13_flat_band_tables": lambda: [(_t(tfsk._fsk_blocked_templates(80, MARK, SPACE, SR, 8)),
                                      "flat_band_tables", tk._flat_band_tables)],
    "k8_fsk9600": lambda: _fir_entries(tfsk._disc_templates(10, 9600.0, MARK, SPACE, SR, 8), 1),
    "k9_fsk19200": lambda: _fir_entries(tfsk._quad_templates(5, 19200.0, 8000.0, 16000.0, SR, 8), 4),
}


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _refused():
    raise AssertionError("rebuilt a kept entry")


def _check_kept(w, tag, build):
    """One template's entry: built once, reused for the same tensor, built
    anew for a clone and after a write, equal to a fresh build."""
    got = tk._kept(w, tag, lambda: build(w))
    assert _same(got, build(w))
    assert tk._kept(w, tag, _refused) is got
    c = w.clone()
    other = tk._kept(c, tag, lambda: build(c))
    assert other is not got and _same(other, got)
    w.mul_(2.0)
    again = tk._kept(w, tag, lambda: build(w))
    assert again is not got and _same(again, build(w)) and not _same(again, got)
    assert tk._kept(w, tag, _refused) is again
    return weakref.ref(w)


@pytest.mark.parametrize("case", sorted(_KEPT_CASES))
def test_kept_tables_per_template_until_it_changes(case):
    """The wrappers' derived kernel tables (K1/K12's dual basis, K7's and
    K13's band tables, K8's and K9's band tables and FIR taps) are built once
    per template: the same tensor again reuses the entry, a clone or a write
    to the template builds anew, every entry equals a fresh build, and the
    cache keeps no template alive."""
    entries = _KEPT_CASES[case]()
    refs = [_check_kept(*entry) for entry in entries]
    if case == "k13_flat_band_tables":  # K13's table is K7's laid out (n_off, spr, span, 4)
        first, tab, span = tk._band_tables(entries[0][0], 4)
        f13, t13, s13 = tk._kept(entries[0][0], "flat_band_tables", _refused)
        assert s13 == span and torch.equal(f13, first) and torch.equal(t13, tab.permute(0, 3, 2, 1))
    del entries
    gc.collect()
    assert all(r() is None for r in refs)


def test_fir_taps_recovered_and_foreign_matrix_refused():
    for baud, mark, space in ((9600.0, MARK, SPACE), (19200.0, 8000.0, 16000.0)):
        spb = jfsk._samples_per_bit(SR, baud)
        blo, bhi, dec, taps = jfsk._fir_frontend_plan(baud, mark, space, SR)
        plan = jfsk._fsk_disc_kernel_plan(spb, dec, taps)
        Wf = torch.from_numpy(jfsk._fir_padded_template(blo, bhi, SR, taps, dec, plan))
        h, got_dec = tk._fir_taps(Wf)
        taps_c = jfsk._analytic_fir_taps(blo, bhi, SR, taps)
        assert got_dec == dec
        assert np.array_equal(h[0], taps_c.real[::-1].astype(np.float32))
        assert np.array_equal(h[1], taps_c.imag[::-1].astype(np.float32))
    with pytest.raises(ValueError, match="decimating FIR"):
        tk._fir_taps(torch.ones((640, 256)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 256, 1408), dtype=torch.float64)
    W = torch.zeros((8, 1408, 64))
    best = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=256, spr=16)
    with pytest.raises(ValueError, match="rows_per_capture"):
        tk.fsk_tile_bits_batch(x.float(), W, best, rows_per_capture=128, spr=16)
    with pytest.raises(ValueError, match="best"):
        tk.fsk_tile_bits_batch(x.float(), W, best.long(), rows_per_capture=256, spr=16)
    with pytest.raises(ValueError, match="template rows"):
        tk.fsk_tile_bits_batch(x.float()[:, :, :1280], W, best, rows_per_capture=256, spr=16)
    fir = torch.zeros((2, 640, 640), dtype=torch.int16)
    kw = dict(rows_per_capture=640, nrow2=128, row2=640, ov2=128, spr2=256)
    with pytest.raises(ValueError, match="w_fir"):
        tk.fsk_disc_sums_batch(fir, torch.zeros((637, 256)), torch.zeros((8, 768, 256)), best, **kw)
    with pytest.raises(ValueError, match="FB"):
        tk.fsk_disc_sums_batch(fir[:, :600], torch.zeros((640, 256)), torch.zeros((8, 768, 256)), best,
                               **dict(kw, rows_per_capture=600))
    with pytest.raises(ValueError, match="template"):
        tk.fsk_quad_margin_batch(fir, torch.zeros((640, 256)), torch.zeros((8, 768, 256)), best, **kw)
