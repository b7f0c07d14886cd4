"""K2 to K6 (the magic matchers and the packs) of the PyTorch port vs the
Pallas kernels in interpret mode, the arithmetic of the CUDA kernels
mirrored in numpy, and the wrappers' checks, on the CPU.

The CUDA kernels cannot run here. Their formulations (K1's direct window
correlation, K2's and K5's mask/popcount hypotheses, the packs' register
windows) are mirrored in numpy and held against the plain versions, which
are in turn held against the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from audio_modem_radio_tpu.ops.pallas_kernels import (
    bit_select_pack_batch as j_bit_select_pack,
    bpsk_match_conditions as j_bpsk_conditions,
    psk8_match_conditions as j_psk8_conditions,
    psk8_relabel_pack_rows as j_psk8_pack,
    relabel_pack_batch as j_relabel_pack,
    rotation_match_batch as j_rotation_match,
    rotation_match_conditions as j_conditions,
    sector_match_batch as j_sector_match,
)

from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
_PATTERN = MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2


def _magic_streams(rng, r: int, k: int, parity: int, start_dib: int):
    """Random raw Gray lanes (r, 128) x2 whose relabel by rotation k holds
    the 32-bit magic + validation pattern at flat bit 2*start_dib + parity."""
    bits = rng.integers(0, 2, 2 * r * 128, dtype=np.uint8)
    pat = np.array([int(c) for c in _PATTERN], np.uint8)
    pos = 2 * start_dib + parity
    bits[pos : pos + len(pat)] = pat
    h, l = bits[0::2], bits[1::2]
    raw = _QT_TO_DIBIT[(2 * h + (h ^ l) + k) & 3]
    return raw[:, 0].reshape(r, 128), raw[:, 1].reshape(r, 128)


def _noise_streams(rng, r: int):
    return (rng.integers(0, 2, (r, 128), dtype=np.uint8),
            rng.integers(0, 2, (r, 128), dtype=np.uint8))


def _both_match(hi, lo, r, rows_scanned=None, family="qpsk"):
    p = r if rows_scanned is None else rows_scanned
    first_j, found_j = j_rotation_match(
        jnp.asarray(hi[:, :p]), jnp.asarray(lo[:, :p]), MAGIC_BIT_PATTERN, p,
        pattern2=MAGIC_BIT_PATTERN2, interpret=True, family=family,
    )
    first_t, found_t = tk.rotation_match_batch(
        torch.from_numpy(hi), torch.from_numpy(lo), MAGIC_BIT_PATTERN, r,
        pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned, family=family,
    )
    return (np.asarray(first_j), np.asarray(found_j)), (first_t.numpy(), found_t.numpy())


def test_conditions_ported_verbatim():
    for pattern in (_PATTERN, MAGIC_BIT_PATTERN, "0110" * 4):
        assert tk.rotation_match_conditions(pattern) == j_conditions(pattern)


def test_bpsk_and_psk8_conditions_ported_verbatim():
    for pattern in (_PATTERN, MAGIC_BIT_PATTERN, "0110" * 4):
        assert tk.bpsk_match_conditions(pattern) == j_bpsk_conditions(pattern)
    for pattern, pattern2 in ((MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2), ("0110" * 4, ""),
                              (MAGIC_BIT_PATTERN, "101")):
        assert tk.psk8_match_conditions(pattern, pattern2) == j_psk8_conditions(pattern, pattern2)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rotation_match_plain_equals_pallas(k, parity):
    rng = np.random.default_rng(10 * k + parity)
    r = 256
    start = 1000 + 37 * k
    h0, l0 = _magic_streams(rng, r, k, parity, start)
    h1, l1 = _noise_streams(rng, r)
    hi, lo = np.stack([h0, h1]), np.stack([l0, l1])
    (first_j, found_j), (first_t, found_t) = _both_match(hi, lo, r)
    assert first_t.dtype == np.int32 and found_t.dtype == np.bool_
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    h = 4 * parity + k
    assert found_t[0, h] and first_t[0, h] == start


def test_rotation_match_noise_finds_nothing():
    rng = np.random.default_rng(99)
    r = 512
    hi, lo = (np.stack(s) for s in zip(*[_noise_streams(rng, r) for _ in range(2)]))
    (first_j, found_j), (first_t, found_t) = _both_match(hi, lo, r)
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert not found_t.any()


@pytest.mark.parametrize("start", [500, 32768 - 40, 40000])
def test_rotation_match_prefix_of_longer_capture(start):
    """A 256-row prefix of a 512-row capture: the port scans it in place;
    the JAX call gets the sliced prefix. Matches straddling or past the
    prefix's end must not be reported."""
    rng = np.random.default_rng(start)
    r = 512
    h0, l0 = _magic_streams(rng, r, 0, 1, start)
    h1, l1 = _magic_streams(rng, r, 2, 0, 300)
    hi, lo = np.stack([h0, h1]), np.stack([l0, l1])
    (first_j, found_j), (first_t, found_t) = _both_match(hi, lo, r, rows_scanned=256)
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert found_t[0, 4] == (start < 256 * 128 - 17)
    assert found_t[1, 2] and first_t[1, 2] == 300


def _kernel_rotmatch_numpy(hi, lo, pattern, n_exact, tol, rows_scanned, family="qpsk"):
    """The CUDA kernel's formulation: hi and lo interleaved into one bit
    stream (hi[j] at bit 2j, lo[j] at 2j + 1), each position's window as
    the two 32-bit words W0 (offsets 0..15) and W1 (16..31), zeros past the
    scanned prefix, the exact part one (mask, value) pair over W0 and the
    tolerant part popcounts over W0 and W1 (``_rotation_mask_table``), and
    only positions below the scan limit evaluated."""
    build = tk.rotation_match_conditions if family == "qpsk" else tk.bpsk_match_conditions
    conds, n_pat = build(pattern)
    masks = tk._rotation_mask_table(family, pattern[:n_exact], pattern[n_exact:]).view(np.uint32).astype(np.int64)
    b = hi.shape[0]
    n_pos = rows_scanned * 128 - (n_pat + 1)
    w = 1 << np.arange(32, dtype=np.int64)
    first = np.full((b, len(conds)), 1 << 30, np.int64)
    for i in range(b):
        h = np.pad(hi[i, :rows_scanned].reshape(-1).astype(np.int64) & 1, (0, 32))
        l = np.pad(lo[i, :rows_scanned].reshape(-1).astype(np.int64) & 1, (0, 32))
        bits = np.stack([h, l], 1).reshape(-1)
        win = np.lib.stride_tricks.sliding_window_view(bits, 64)[0 : 2 * n_pos : 2]
        w0, w1 = win[:, :32] @ w, win[:, 32:] @ w
        for k, m in enumerate(masks):
            exact = (w0 & m[0]) == m[1]
            loose = np.bitwise_count((w0 ^ m[3]) & m[2]) + np.bitwise_count((w1 ^ m[5]) & m[4])
            hit = np.nonzero(exact & (loose <= tol))[0]
            if len(hit):
                first[i, k] = hit[0]
    found = first < (1 << 30)
    return np.where(found, first, 0), found


@pytest.mark.parametrize("rows_scanned", [256, 512])
def test_rotation_match_kernel_formulation(rows_scanned):
    rng = np.random.default_rng(rows_scanned)
    r = 512
    caps = [_magic_streams(rng, r, k, k % 2, 200 + 9000 * k) for k in range(4)]
    caps.append(_noise_streams(rng, r))
    hi, lo = np.stack([c[0] for c in caps]), np.stack([c[1] for c in caps])
    first_n, found_n = _kernel_rotmatch_numpy(hi, lo, _PATTERN, 16, 3, rows_scanned)
    first_t, found_t = tk.rotation_match_batch(
        torch.from_numpy(hi), torch.from_numpy(lo), MAGIC_BIT_PATTERN, r,
        pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned,
    )
    assert np.array_equal(found_t.numpy(), found_n)
    assert np.array_equal(first_t.numpy(), first_n)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_relabel_pack_plain_equals_pallas(k):
    """Every s8 in 0..7 (one capture each) under rotation k; the last byte
    of each capture is garbage by contract and excluded."""
    rng = np.random.default_rng(k)
    b, r = 8, 256
    hi = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    lo = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 500, b) + np.arange(b)).astype(np.int32)
    ksel = np.full(b, k, np.int32)
    ref = np.asarray(j_relabel_pack(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(s), jnp.asarray(ksel),
        rows_per_capture=r, interpret=True, variant="weights",
    ))
    got = tk.relabel_pack_batch(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(s),
        torch.from_numpy(ksel), rows_per_capture=r,
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, r * 32)
    assert np.array_equal(got.numpy()[:, :-1], ref[:, :-1])


def _kernel_relabel_pack_numpy(hi, lo, s, ksel):
    """The CUDA kernel's formulation: per output byte, relabel the 5
    dibits its 8 bits can touch into a 10-bit window and shift it out;
    bits past the capture's end are zero."""
    b = hi.shape[0]
    n_dib = hi.shape[1] * 128
    h = np.pad(hi.reshape(b, -1).astype(np.int64), ((0, 0), (0, 5)))
    l = np.pad(lo.reshape(b, -1).astype(np.int64), ((0, 0), (0, 5)))
    n_bytes = hi.shape[1] * 32
    out = np.empty((b, n_bytes), np.uint8)
    c = np.arange(n_bytes)
    for i in range(b):
        p = 8 * c + (int(s[i]) & 7)
        t = p >> 1
        v = np.zeros(n_bytes, np.int64)
        for q in range(5):
            hh, ll = h[i, t + q], l[i, t + q]
            s2 = (2 * hh + (hh ^ ll) + 4 - int(ksel[i])) & 3
            inside = t + q < n_dib
            rh, rl = (s2 >= 2) & inside, ((s2 == 1) | (s2 == 2)) & inside
            v = (v << 2) | (rh << 1) | rl
        out[i] = (v >> (2 - (p & 1))) & 0xFF
    return out


def test_relabel_pack_kernel_formulation():
    rng = np.random.default_rng(5)
    b, r = 8, 256
    hi = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    lo = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 500, b) + np.arange(b)).astype(np.int32)
    ksel = (np.arange(b) % 4).astype(np.int32)
    got = tk.relabel_pack_batch(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(s),
        torch.from_numpy(ksel), rows_per_capture=r,
    ).numpy()
    assert np.array_equal(got, _kernel_relabel_pack_numpy(hi, lo, s, ksel))


_U32 = np.uint64(0xFFFFFFFF)


def _byte_perm(x, y, sel: int):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint64 arrays of 32-bit words:
    result byte n is byte ``(sel >> 4n) & 7`` of the 8 bytes {y, x}."""
    src = [(x >> np.uint64(8 * n)) & np.uint64(0xFF) for n in range(4)]
    src += [(y >> np.uint64(8 * n)) & np.uint64(0xFF) for n in range(4)]
    return sum(src[(sel >> 4 * n) & 7] << np.uint64(8 * n) for n in range(4))


def _words(lane, n_runs: int, per_run: int):
    """(r, 128) uint8 lane -> (n_runs, per_run) little-endian 32-bit words
    as uint64: each run's 16-byte loads as words."""
    return np.ascontiguousarray(lane).reshape(n_runs, per_run * 4).view("<u4").astype(np.uint64)


def _shift_pack_runs(w, heads, s8: int):
    """The shared epilogue of K3's and K4's CUDA kernels: w (n_runs, kw)
    big-endian stream words of each run; the next run's first word, from
    the next lane's w[:, 0] or, for a warp's last lane (run % 32 == 31),
    ``heads`` (its own load); zero past the capture's end; the funnel shift
    by s8 and the byte swap of each stored word."""
    n_runs, kw = w.shape
    last_lane = np.arange(n_runs - 1) % 32 == 31
    nxt = np.concatenate([np.where(last_lane, heads[1:], w[1:, 0]), [np.uint64(0)]])
    ext = np.concatenate([w, nxt[:, None]], axis=1)
    out = ((((ext[:, :-1] << np.uint64(32)) | ext[:, 1:]) << np.uint64(s8)) >> np.uint64(32)) & _U32
    return out.astype(">u4").view(np.uint8).reshape(-1)


def _relabel_pack_runs_numpy(hi, lo, s, ksel, run: int = 32):
    """csrc/relabel_pack.cu in numpy: per capture the plane swap (rh from lo
    where ksel is odd) and the XOR mask of the relabel table; per run of
    ``run`` dibits (the kernel's 32), each word of 4 dibits compacted by the multiply
    0x40100401 to 8 MSB-first stream bits, three byte permutes a 16-dibit
    stream word; the next run's head (a warp's last lane: its first 4 bytes
    of each lane, top 8 bits), the funnel shift and the byte swap."""
    b, r, _ = hi.shape
    n_runs, kw = r * 128 // run, run // 16
    out = np.empty((b, r * 32), np.uint8)

    def dibits4(h, l):
        m = np.uint64(0x01010101)
        return ((((h & m) << np.uint64(1)) | (l & m)) * np.uint64(0x40100401)) & _U32

    for i in range(b):
        k = int(ksel[i]) & 3
        rh, rl = (lo[i], hi[i]) if k & 1 else (hi[i], lo[i])
        flip = np.uint64((0xAAAAAAAA if k in (1, 2) else 0) | (0x55555555 if k >= 2 else 0))
        h = _words(rh, n_runs, 4 * kw).reshape(n_runs, kw, 4)
        l = _words(rl, n_runs, 4 * kw).reshape(n_runs, kw, 4)
        d = [dibits4(h[:, :, e], l[:, :, e]) for e in range(4)]
        w = _byte_perm(_byte_perm(d[0], d[1], 0x3700), _byte_perm(d[2], d[3], 0x3700), 0x3276) ^ flip
        heads = (d[0][:, 0] & np.uint64(0xFF000000)) ^ (flip & np.uint64(0xFF000000))
        assert np.array_equal(heads >> np.uint64(24), w[:, 0] >> np.uint64(24))
        out[i] = _shift_pack_runs(w, heads, int(s[i]) & 7)
    return out


def test_relabel_plane_swap_table():
    """K3's relabel as bit-plane algebra: (rh, rl) = (H, L), (~L, H),
    (~H, ~L), (L, ~H) for k = 0..3, on every dibit, as the plain version
    relabels."""
    h, l = np.array([0, 0, 1, 1], np.uint8), np.array([0, 1, 0, 1], np.uint8)
    table = {0: (h, l), 1: (1 - l, h), 2: (1 - h, 1 - l), 3: (l, 1 - h)}
    for k in range(4):
        bits = tk.relabel_pack_batch_plain(
            torch.from_numpy(np.tile(h, 32).reshape(1, 1, 128)), torch.from_numpy(np.tile(l, 32).reshape(1, 1, 128)),
            torch.zeros(1, dtype=torch.int32), torch.full((1,), k, dtype=torch.int32))
        want = np.stack(table[k], axis=1).reshape(-1)  # rh[t], rl[t] flat, 8 bits a byte
        assert np.array_equal(np.unpackbits(bits.numpy()[0])[:8], want), k


@pytest.mark.parametrize("r", [96, 13, 300])
def test_relabel_pack_run_formulation(r):
    """K3's CUDA formulation at every (ksel, s8), one capture each: equal
    to the plain version everywhere and, where the Pallas kernel takes the
    rows (multiples of its 32-row blocks), to the Pallas kernel on
    [0, n_valid - 1). At 13 rows a capture's last warp is partial; at 96
    and 300 its last block."""
    rng = np.random.default_rng(90 + r)
    b = 32
    hi = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    lo = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 40, b) + np.arange(b) % 8).astype(np.int32)
    ksel = (np.arange(b) // 8).astype(np.int32)
    got = _relabel_pack_runs_numpy(hi, lo, s, ksel)
    plain = tk.relabel_pack_batch(torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(s),
                                  torch.from_numpy(ksel), rows_per_capture=r, block_rows=1).numpy()
    assert np.array_equal(got, plain)
    if r % 32 == 0:
        ref = np.asarray(j_relabel_pack(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(s), jnp.asarray(ksel),
                                        rows_per_capture=r, block_rows=32, interpret=True, variant="weights"))
        n_valid = (2 * r * 128 - (s & 7)) // 8
        for i in range(b):
            assert np.array_equal(got[i, : n_valid[i] - 1], ref[i, : n_valid[i] - 1]), i


def test_decide_kernel_formulation():
    """K1's CUDA formulation: each symbol's 2*spsym-sample window against
    the winning offset's two template columns (taken from the blocked
    templates as the wrapper takes them), then differential, derotation and
    decision, equals the dense plain version over the signal."""
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame

    rng = np.random.default_rng(8)
    payload = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    wave = modulate("QPSK", pack_frame("d.bin", payload, 0, 1, len(payload), crc32(payload)), 9600)
    spsym, n = 10, 1 << 17
    r, row = tpsk.blocked_row_shape(n, 9600, 96000)
    x = np.zeros((2, r * row), np.float32)
    x[0, : len(wave)] = wave
    x[1, 3 : 3 + len(wave)] = wave
    W8 = torch.from_numpy(tpsk._blocked_templates(spsym, 3000.0, 96000, 8).copy())
    best = torch.tensor([0, 3], dtype=torch.int32)
    theta = np.array([0.1, -0.2])
    rot = torch.tensor(np.stack([np.cos(theta), np.sin(theta)], 1), dtype=torch.float32)
    hi_p, lo_p = tk.psk_project_decide_batch(
        torch.from_numpy(x.reshape(2, r, row)), W8, best, rot, rows_per_capture=r
    )
    n_sig = len(wave) // spsym - 2
    for i in range(2):
        tmpl = torch.stack([W8[best[i], : 2 * spsym, 0], W8[best[i], : 2 * spsym, 128]], -1)
        win = np.lib.stride_tricks.sliding_window_view(x[i], 2 * spsym)[::spsym][: n_sig + 1]
        z = win.astype(np.float64) @ tmpl.numpy().astype(np.float64)
        d_re = z[1:, 0] * z[:-1, 0] + z[1:, 1] * z[:-1, 1]
        d_im = z[1:, 1] * z[:-1, 0] - z[1:, 0] * z[:-1, 1]
        c, s = float(rot[i, 0]), float(rot[i, 1])
        dr, di = d_re * c + d_im * s, d_im * c - d_re * s
        swap = np.abs(di) > np.abs(dr)
        neg = np.where(swap, di, dr) < 0
        assert np.array_equal(hi_p[i].reshape(-1)[:n_sig].numpy(), neg.astype(np.uint8))
        assert np.array_equal(lo_p[i].reshape(-1)[:n_sig].numpy(), (neg ^ swap).astype(np.uint8))


# csrc/decide.cu's constants: threads a block, the spsym values compiled as
# constants (the rest take the generic path), the multiprocessors of an H100.
_DECIDE_THREADS, _DECIDE_FIXED, _SMS = 256, (8, 10), 132


def _decide_numpy(x3d, tmpl, best, rot, n_psk, per_sm, sms=_SMS):
    """csrc/psk_tile.cuh walk_tiles, block by block, for a 16-byte aligned
    tensor, with decide.cu's emit (``n_psk`` 2, 4, 8: K1) or
    project_diff.cu's (``n_psk`` 0: K12, and K11 with one capture): the
    one-wave grid's tile walk (``per_sm`` blocks a multiprocessor, split
    over the captures), each tile's 16-byte chunks staged at their place in
    the buffer (a pad chunk after every spsym/2 where that is even, for the
    compiled spsym), zeros past the capture, and each thread's window read
    from it: 16-byte reads of (K+2)*spsym samples for a compiled spsym,
    scalar reads otherwise. Asserts that every staged word a (symbol, j)
    reads is the capture's sample (or a zero past its end), that the 8
    threads of a quarter-warp read 8 different 16-byte bank groups, and that
    each output is written once. The projection is float64. Returns hi (and
    lo) as (B, R*128) uint8, or (d_re, d_im) as (B, R*128) float64."""
    b, r, row = x3d.shape
    spsym, item = row // 128, x3d.dtype.itemsize
    k_sym = 8 // item
    tile = _DECIDE_THREADS * k_sym
    sym = r * 128
    n_tiles = -(-sym // tile)
    n_chunks = -(-((tile + 2) * spsym * item) // 16)
    fixed = spsym in _DECIDE_FIXED
    q = spsym // 2
    pad = fixed and q % 2 == 0
    place = (lambda c: c + c // q) if pad else (lambda c: c)
    buf_chunks = place(n_chunks - 1) + 1
    per_capture = min(n_tiles, max(1, per_sm * sms // b))
    n_bytes = sym * spsym * item
    raw = np.ascontiguousarray(x3d).reshape(b, -1).view(np.uint8)
    flat = x3d.reshape(b, -1).astype(np.float64)
    if n_psk == 0:
        outs = [np.full((b, sym), np.nan) for _ in range(2)]
    else:
        outs = [np.full((b, sym), 255, np.uint8) for _ in range(1 if n_psk == 8 else 2)]
    th = np.arange(_DECIDE_THREADS)
    n_s = (k_sym + 2) * spsym
    for i in range(b):
        tiles = [t for blk in range(per_capture) for t in range(blk, n_tiles, per_capture)]
        assert sorted(tiles) == list(range(n_tiles))
        tb = tmpl[best[i]].astype(np.float64)  # (2*spsym, 2)
        for t in tiles:
            g = t * tile * spsym * item + 16 * np.arange(n_chunks)
            chunks = np.zeros((n_chunks, 16), np.uint8)
            valid = g < n_bytes
            chunks[valid] = raw[i, g[valid][:, None] + np.arange(16)]
            buf = np.full((buf_chunks, 16), 0xA5, np.uint8)  # chunks no thread may read keep the marker
            written = np.zeros(buf_chunks, bool)
            dst = place(np.arange(n_chunks))
            assert not written[dst].any() and len(set(dst.tolist())) == n_chunks
            buf[dst], written[dst] = chunks, True
            if fixed:
                kc = -(-(n_s * item) // 16)
                j = np.arange(kc)
                idx = th[:, None] * (q | 1) + j + (j // q if pad else 0)
                assert written[idx].all()
                banks = np.sort(idx.reshape(-1, 8, kc) % 8, axis=1)
                assert (banks == np.arange(8)[None, :, None]).all()  # no bank conflict
                wbytes = buf[idx].reshape(_DECIDE_THREADS, -1)[:, : n_s * item]
            else:
                byte = (th * k_sym * spsym * item)[:, None] + np.arange(n_s * item)
                assert written[byte // 16].all()
                wbytes = buf.reshape(-1)[byte]
            samples = np.ascontiguousarray(wbytes).view(x3d.dtype).astype(np.float64)
            pos = t * tile * spsym + th[:, None] * k_sym * spsym + np.arange(n_s)
            want = np.where(pos < sym * spsym, flat[i, np.minimum(pos, sym * spsym - 1)], 0.0)
            assert np.array_equal(samples, want)
            win = np.stack([samples[:, u * spsym : u * spsym + 2 * spsym] for u in range(k_sym + 1)], 1)
            z = win @ tb  # (threads, K+1, 2)
            r0, i0, r1, i1 = z[:, :-1, 0], z[:, :-1, 1], z[:, 1:, 0], z[:, 1:, 1]
            d_re, d_im = r1 * r0 + i1 * i0, i1 * r0 - r1 * i0
            if n_psk == 0:
                dec = [d_re, d_im]
            else:
                c, s = float(rot[i, 0]), float(rot[i, 1])
                dr, di = d_re * c + d_im * s, d_im * c - d_re * s
                if n_psk == 4:
                    swap = np.abs(di) > np.abs(dr)
                    neg = np.where(swap, di, dr) < 0
                    dec = [neg, neg ^ swap]
                elif n_psk == 2:
                    dec = [dr < 0, di < 0]
                else:
                    dec = [tk.psk8_sector_stream(torch.from_numpy(dr), torch.from_numpy(di)).numpy()]
            at = t * tile + th[:, None] * k_sym + np.arange(k_sym)
            keep = at < sym
            for o, d in zip(outs, dec):
                assert (np.isnan(o[i, at[keep]]) if n_psk == 0 else o[i, at[keep]] == 255).all()  # each once
                o[i, at[keep]] = np.asarray(d, o.dtype)[keep]
    assert all(not np.isnan(o).any() if n_psk == 0 else (o != 255).all() for o in outs)
    return outs


@pytest.mark.parametrize("spsym,n_psk,dtype,b,sms", [
    (10, 4, np.int16, 2, _SMS), (10, 2, np.int8, 2, _SMS), (10, 8, np.float32, 1, _SMS),
    (8, 4, np.int16, 3, 1), (8, 8, np.int8, 2, _SMS), (8, 2, np.float32, 2, _SMS),
    (3, 4, np.int16, 2, _SMS), (3, 8, np.int8, 3, 1), (32, 2, np.int16, 1, _SMS),
    (10, 0, np.int16, 2, _SMS), (10, 0, np.float32, 1, _SMS), (8, 0, np.int16, 3, 1),
    (8, 0, np.float32, 1, _SMS), (3, 0, np.float32, 3, 1), (32, 0, np.int16, 1, _SMS),
])
def test_decide_kernel_tile_walk_mirrored(spsym, n_psk, dtype, b, sms):
    """The shared tile walk in numpy against the plain versions on clean
    captures of 258 rows (every sample type's last tile ragged), at the
    compiled spsym (10, 8: the pad layout) and the generic ones (3, 32),
    with one capture, and with more captures than blocks (``sms`` 1): K1's
    decisions (``n_psk`` 2, 4, 8) equal; K12's float streams (``n_psk`` 0,
    8PSK rows; with one capture, the launch K11 makes) within 1e-6 of their
    RMS, the float64 mirror against the float32 plain version."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate

    mode, carrier = {0: ("8PSK", 12000.0), 2: ("BPSK", 3000.0), 4: ("QPSK", 3000.0), 8: ("8PSK", 12000.0)}[n_psk]
    baud = 96000 // spsym
    r, row = 258, 128 * spsym
    rng = np.random.default_rng(spsym * 10 + n_psk)
    x = np.zeros((b, r * row), np.float32)
    n_sig = r * 128
    for i in range(b):
        p = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
        wave = np.tile(modulate(mode, pack_frame("d.bin", p, 0, 1, len(p), crc32(p)), baud), 40)
        x[i, 7 * i :] = wave[: r * row - 7 * i]
        n_sig = min(n_sig, (r * row - 7 * i) // spsym - 2)
    if dtype != np.float32:
        scale = 32767.0 if dtype == np.int16 else 127.0
        x = np.round(x * scale / np.abs(x).max()).astype(dtype)
    x3d = x.reshape(b, r, row)
    xt = torch.from_numpy(x3d)
    W8 = torch.from_numpy(tpsk._blocked_templates(spsym, carrier, 96000, 8).copy())
    _, _, best, theta = tpsk._batch_pass1(None, xt[:, :256].contiguous(), b, 256 * 128, spsym, carrier,
                                          96000, 8, 256, n_psk=8 if n_psk in (0, 8) else 4)
    if n_psk == 0:
        mirror = _decide_numpy(x3d, tk._dual_basis(W8, spsym).numpy(), best.numpy(), None, 0, 2, sms)
        got = tk.psk_project_diff_batch(xt, W8, best, rows_per_capture=r, block_rows=2)
        rms = np.sqrt(np.mean(mirror[0] ** 2 + mirror[1] ** 2))
        assert rms > 0
        for m, g in zip(mirror, got):
            assert np.max(np.abs(m - g.reshape(b, -1).double().numpy())) <= 1e-6 * rms
        return
    rots = [(theta, 1), (theta + np.pi / 4, 2)] if n_psk == 2 else [(theta, 2)]
    for th, n_streams in rots:
        rot = torch.stack([torch.cos(th), torch.sin(th)], 1)
        plain = tk.psk_project_decide_batch(xt, W8, best, rot, rows_per_capture=r, n_psk=n_psk, block_rows=2)
        plain = [plain] if n_psk == 8 else list(plain)
        mirror = _decide_numpy(x3d, tk._dual_basis(W8, spsym).numpy(), best.numpy(), rot.numpy(), n_psk, 2, sms)
        for m, p in list(zip(mirror, plain))[:n_streams]:
            assert np.array_equal(m[:, :n_sig], p.reshape(b, -1)[:, :n_sig].numpy())


def _small_inputs():
    r = 256
    hi = torch.zeros((2, r, 128), dtype=torch.uint8)
    lo = torch.zeros_like(hi)
    s = torch.zeros(2, dtype=torch.int32)
    k = torch.zeros(2, dtype=torch.int32)
    x3d = torch.zeros((2, r, 1280), dtype=torch.int16)
    W8 = torch.from_numpy(tpsk._blocked_templates(10, 3000.0, 96000, 8).copy())
    best = torch.zeros(2, dtype=torch.int32)
    rot = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    return r, hi, lo, s, k, x3d, W8, best, rot


def test_wrappers_take_plain_path_on_cpu_without_counting():
    r, hi, lo, s, k, x3d, W8, best, rot = _small_inputs()
    tk.reset_launch_counts()
    for n_psk in (2, 4, 8):
        tk.psk_project_decide_batch(x3d, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
    for family in ("qpsk", "bpsk"):
        tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, family=family)
    tk.relabel_pack_batch(hi, lo, s, k, rows_per_capture=r)
    tk.bit_select_pack_batch(hi, lo, s, k, rows_per_capture=r)
    tk.sector_match_batch(hi, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2)
    tk.psk8_relabel_pack_rows(hi, k, s, rows_per_capture=r)
    W = torch.zeros((8, 256, 64))
    tk.fsk_tile_bits_batch(torch.zeros((2, 4, 256)), W, best, rows_per_capture=4, spr=16)
    tk.fsk_project_bits_batch(torch.zeros((2, 4, 128)), W, best, rows_per_capture=4, spr=16)
    fir = torch.zeros((2, 640, 640), dtype=torch.int16)
    kw = dict(rows_per_capture=640, nrow2=128, row2=640, ov2=128)
    tk.fsk_disc_sums_batch(fir, torch.zeros((640, 256)), torch.zeros((8, 768, 256)), best, spr2=256, **kw)
    tk.fsk_quad_margin_batch(fir, torch.zeros((640, 256)), torch.zeros((8, 768, 512)), best, spr2=128, **kw)
    tk.psk_project_diff_batch(x3d, W8, best, rows_per_capture=r)
    tk.psk_project_diff(x3d[0], W8[0])
    tk.neural_extract_batch(torch.zeros((2 * r, 128)), torch.zeros((256, 16)), rot, s, rows_per_capture=r)
    tk.mlse_viterbi_blocks(torch.zeros((2, 4, 9)), torch.ones(8), torch.zeros(8), torch.zeros((2, 2, 8)), 1, 2)
    tk.fec_viterbi_blocks(torch.full((2, 9, 2), 0.5), False)
    tk.fsk_sync_pack_batch(torch.zeros((2, 100), dtype=torch.uint8), MAGIC_BIT_PATTERN)
    plan, _wf, _wb, coef = tfsk._device_tables("disc", 10, 9600.0, 1200.0, 2200.0, 96000, 8, torch.device("cpu"))
    tk.fsk_disc_decide_batch(torch.zeros((2, 64)), torch.ones((2, 64)), plan, coef, 96000, 1200.0, 2200.0)
    _, w_all, grams = tpsk._device_tables(10, 3000.0, 96000, 8, torch.device("cpu"))
    tk.psk_pass1_batch(x3d, r, w_all, grams)
    assert tk.launch_counts() == {
        "psk_project_decide_batch": 0, "rotation_match_batch": 0, "relabel_pack_batch": 0,
        "bit_select_pack_batch": 0, "sector_match_batch": 0, "psk8_relabel_pack_rows": 0,
        "fsk_tile_bits_batch": 0, "fsk_project_bits_batch": 0, "fsk_disc_sums_batch": 0,
        "fsk_quad_margin_batch": 0, "psk_project_diff": 0, "psk_project_diff_batch": 0,
        "neural_extract_batch": 0, "mlse_viterbi_blocks": 0, "fec_viterbi_blocks": 0,
        "fsk_sync_pack_batch": 0, "fsk_disc_decide_batch": 0, "psk_pass1_batch": 0,
    }


@pytest.mark.parametrize("case", [
    "k1_dtype", "k1_rows", "k1_best_dtype", "k1_w_dtype", "k1_psk8", "k1_variant", "k1_succ_width",
    "k2_dtype", "k2_rows", "k2_prefix", "k2_family",
    "k3_dtype", "k3_shape", "k3_s_dtype", "k3_variant", "device_mix",
    "k4_dtype", "k4_ksel_dtype", "k4_variant", "k5_shape", "k5_prefix",
    "k6_rows", "k6_r8_shape",
    "fsk_sync_dtype", "fsk_sync_ndim", "fsk_sync_strided", "fsk_sync_long_pattern", "fsk_sync_pattern_chars",
    "fsk_eq_dtype", "fsk_eq_ndim", "fsk_eq_shape", "fsk_eq_strided", "fsk_eq_device_mix", "fsk_eq_coef",
])
def test_wrappers_raise_on_bad_input(case):
    r, hi, lo, s, k, x3d, W8, best, rot = _small_inputs()
    plan, _wf, _wb, coef = tfsk._device_tables("disc", 10, 9600.0, 1200.0, 2200.0, 96000, 8, torch.device("cpu"))
    sums = torch.zeros((2, 64))
    tones = (96000, 1200.0, 2200.0)
    calls = {
        "k1_dtype": lambda: tk.psk_project_decide_batch(x3d.double(), W8, best, rot, r),
        "k1_rows": lambda: tk.psk_project_decide_batch(x3d[:, :128], W8, best, rot, 128),
        "k1_best_dtype": lambda: tk.psk_project_decide_batch(x3d, W8, best.long(), rot, r),
        "k1_w_dtype": lambda: tk.psk_project_decide_batch(x3d, W8.double(), best, rot, r),
        "k1_psk8": lambda: tk.psk_project_decide_batch(x3d, W8, best, rot, r, n_psk=3),
        "k1_variant": lambda: tk.psk_project_decide_batch(x3d, W8, best, rot, r, variant="nope"),
        "k1_succ_width": lambda: tk.psk_project_decide_batch(x3d, W8, best, rot, r, variant="succ"),
        "k2_dtype": lambda: tk.rotation_match_batch(hi.int(), lo, MAGIC_BIT_PATTERN, r),
        "k2_rows": lambda: tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, 2 * r),
        "k2_prefix": lambda: tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r, rows_scanned=100),
        "k2_family": lambda: tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r, family="qam"),
        "k3_dtype": lambda: tk.relabel_pack_batch(hi.bool(), lo, s, k, r),
        "k3_shape": lambda: tk.relabel_pack_batch(hi[:, :, :64], lo[:, :, :64], s, k, r),
        "k3_s_dtype": lambda: tk.relabel_pack_batch(hi, lo, s.long(), k, r),
        "k3_variant": lambda: tk.relabel_pack_batch(hi, lo, s, k, r, variant="nope"),
        "device_mix": lambda: tk.relabel_pack_batch(hi, lo.to("meta"), s, k, r),
        "k4_dtype": lambda: tk.bit_select_pack_batch(hi, lo.int(), s, k, r),
        "k4_ksel_dtype": lambda: tk.bit_select_pack_batch(hi, lo, s, k.long(), r),
        "k4_variant": lambda: tk.bit_select_pack_batch(hi, lo, s, k, r, variant="nope"),
        "k5_shape": lambda: tk.sector_match_batch(hi[:, :, :64], MAGIC_BIT_PATTERN, r),
        "k5_prefix": lambda: tk.sector_match_batch(hi, MAGIC_BIT_PATTERN, r, rows_scanned=2 * r),
        "k6_rows": lambda: tk.psk8_relabel_pack_rows(hi, k, s, 2 * r),
        "k6_r8_shape": lambda: tk.psk8_relabel_pack_rows(hi, k, s[:1], r),
        "fsk_sync_dtype": lambda: tk.fsk_sync_pack_batch(hi[0].bool(), MAGIC_BIT_PATTERN),
        "fsk_sync_ndim": lambda: tk.fsk_sync_pack_batch(hi, MAGIC_BIT_PATTERN),
        "fsk_sync_strided": lambda: tk.fsk_sync_pack_batch(hi[:, :, 0], MAGIC_BIT_PATTERN),
        "fsk_sync_long_pattern": lambda: tk.fsk_sync_pack_batch(hi[0], "01" * 17),
        "fsk_sync_pattern_chars": lambda: tk.fsk_sync_pack_batch(hi[0], "0120"),
        "fsk_eq_dtype": lambda: tk.fsk_disc_decide_batch(sums.double(), sums.double(), plan, coef, *tones),
        "fsk_eq_ndim": lambda: tk.fsk_disc_decide_batch(sums[0], sums[0], plan, coef, *tones),
        "fsk_eq_shape": lambda: tk.fsk_disc_decide_batch(sums, sums[:, :32], plan, coef, *tones),
        "fsk_eq_strided": lambda: tk.fsk_disc_decide_batch(sums[:, ::2], sums[:, ::2], plan, coef, *tones),
        "fsk_eq_device_mix": lambda: tk.fsk_disc_decide_batch(sums, sums.to("meta"), plan, coef, *tones),
        "fsk_eq_coef": lambda: tk.fsk_disc_decide_batch(sums, sums, plan, coef[:-1], *tones),
    }
    with pytest.raises((ValueError, NotImplementedError)):
        calls[case]()


# --- DBPSK: K2 family "bpsk" and K4 ---------------------------------------------

def _bpsk_streams(rng, r: int, h: int, start: int):
    """Random re/im sign-bit lanes (r, 128) x2 with the 32-bit magic +
    validation pattern at bit ``start`` of stream h & 1 (0 re, 1 im),
    complemented for h >= 2."""
    re = rng.integers(0, 2, r * 128, dtype=np.uint8)
    im = rng.integers(0, 2, r * 128, dtype=np.uint8)
    pat = np.array([int(c) for c in _PATTERN], np.uint8) ^ np.uint8(h >= 2)
    (im if h & 1 else re)[start : start + len(pat)] = pat
    return re.reshape(r, 128), im.reshape(r, 128)


@pytest.mark.parametrize("h", [0, 1, 2, 3])
def test_rotation_match_bpsk_plain_equals_pallas(h):
    rng = np.random.default_rng(50 + h)
    r = 256
    start = 777 + 1001 * h
    c0 = _bpsk_streams(rng, r, h, start)
    c1 = _noise_streams(rng, r)
    hi, lo = np.stack([c0[0], c1[0]]), np.stack([c0[1], c1[1]])
    (first_j, found_j), (first_t, found_t) = _both_match(hi, lo, r, family="bpsk")
    assert first_t.shape == (2, 4) and first_t.dtype == np.int32
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert found_t[0, h] and first_t[0, h] == start


@pytest.mark.parametrize("start", [500, 32768 - 40, 40000])
def test_rotation_match_bpsk_prefix_of_longer_capture(start):
    """A 256-row prefix of a 512-row capture; a match straddling or past the
    prefix's end is not reported."""
    rng = np.random.default_rng(start + 1)
    r = 512
    c0 = _bpsk_streams(rng, r, 0, start)
    c1 = _bpsk_streams(rng, r, 3, 300)
    hi, lo = np.stack([c0[0], c1[0]]), np.stack([c0[1], c1[1]])
    (first_j, found_j), (first_t, found_t) = _both_match(hi, lo, r, rows_scanned=256, family="bpsk")
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert found_t[0, 0] == (start < 256 * 128 - 33)
    assert found_t[1, 3] and first_t[1, 3] == 300


@pytest.mark.parametrize("rows_scanned", [256, 512])
def test_rotation_match_bpsk_kernel_formulation(rows_scanned):
    rng = np.random.default_rng(rows_scanned + 3)
    r = 512
    caps = [_bpsk_streams(rng, r, h, 100 + 15000 * h) for h in range(4)]
    caps.append(_noise_streams(rng, r))
    hi, lo = np.stack([c[0] for c in caps]), np.stack([c[1] for c in caps])
    first_n, found_n = _kernel_rotmatch_numpy(hi, lo, _PATTERN, 16, 3, rows_scanned, family="bpsk")
    first_t, found_t = tk.rotation_match_batch(
        torch.from_numpy(hi), torch.from_numpy(lo), MAGIC_BIT_PATTERN, r, family="bpsk",
        pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned,
    )
    assert np.array_equal(found_t.numpy(), found_n)
    assert np.array_equal(first_t.numpy(), first_n)


# csrc/rotmatch.cu's constants: threads a block, positions a thread, the
# 16-byte chunks of hi and lo a thread reads (the fast pass the first 2),
# blocks a multiprocessor at its occupancy.
_K2_THREADS, _K2_POS, _K2_FAST, _K2_WORDS, _K2_PER_SM = 256, 16, 2, 3, 8


def _interleave16(h, lo):
    """csrc/rotmatch.cu interleave16 on (..., 4) uint32 words of 16 hi and
    16 lo bytes: one 2-bit field a byte, the multiply by 0x01041040 moving
    field a to bits 24 + 2a, the four top bytes into one word."""
    x = ((h & np.uint32(0x01010101)) | ((lo & np.uint32(0x01010101)) << np.uint32(1))).astype(np.uint64)
    top = ((x * np.uint64(0x01041040)) & np.uint64(0xFFFFFFFF)) >> np.uint64(24)
    return (top[..., 0] | top[..., 1] << np.uint64(8) | top[..., 2] << np.uint64(16)
            | top[..., 3] << np.uint64(24))


def _rotation_match_numpy(hi, lo, table, tol, n_pat, rows_scanned, sms, rng):
    """csrc/rotmatch.cu in numpy, block by block in a shuffled order: the
    one-wave grid split over the captures, each thread's 16-byte chunks of
    hi and lo (zeros past the scanned prefix) interleaved by the multiply,
    each position's W0 by a funnel shift of the fast pass's two words and W1
    from the third, the fast pass over the exact parts, the warp vote, the
    slow pass with the tolerant popcounts and the limit, the block's shared
    minima, its scratch row and ticket, and the last block's reduction and
    ticket reset (match_first.cuh). Asserts that the slow pass only ever
    finds positions the fast pass flagged, and that every ticket is back at
    0. Returns (first, found) as the kernel writes them."""
    b, r, _ = hi.shape
    n_hyp = table.shape[0]
    big = 1 << 30
    m = table.view(np.uint32).astype(np.uint64)
    n_pos = rows_scanned * 128 - (n_pat + 1)
    span = _K2_THREADS * _K2_POS
    n_iters = -(-n_pos // span) if n_pos > 0 else 0
    per_capture = max(1, min(_K2_PER_SM * sms // b, n_iters, 65535 // b))
    scratch = np.full((b * per_capture, 8), -1, np.int64)
    ticket = np.zeros(b, np.int64)
    first = np.full((b, n_hyp), -1, np.int64)
    found = np.zeros((b, n_hyp), bool)
    hflat, lflat = (np.ascontiguousarray(x).reshape(b, -1) for x in (hi, lo))
    th = np.arange(_K2_THREADS)
    mask32 = np.uint64(0xFFFFFFFF)
    for blk_id in rng.permutation(b * per_capture):
        cap, blk = divmod(int(blk_id), per_capture)
        s_first = np.full(8, big, np.int64)
        for it in range(blk, n_iters, per_capture):
            p0 = (it * _K2_THREADS + th) * _K2_POS
            g = []
            for c in range(_K2_WORDS):
                at = p0[:, None] + 16 * c + np.arange(16)
                inside = at < rows_scanned * 128
                hb, lb = (np.ascontiguousarray(np.where(inside, f[cap, np.minimum(at, r * 128 - 1)], 0)
                                               .astype(np.uint8)).view("<u4").astype(np.uint32)
                          for f in (hflat, lflat))
                g.append(_interleave16(hb, lb))
            q0 = g[0] | (g[1] << np.uint64(32))
            q1 = g[1] | (g[2] << np.uint64(32))
            i2 = np.uint64(2) * np.arange(_K2_POS, dtype=np.uint64)
            w0 = (q0[:, None] >> i2) & mask32  # the fast pass's funnel shifts of words 0 and 1
            w1 = (q1[:, None] >> i2) & mask32
            exact = (w0[:, :, None] & m[:, 0]) == m[:, 1]  # (threads, P, n_hyp)
            vote = exact.reshape(_K2_THREADS // 32, -1).any(axis=1)  # one a warp
            loose = (np.bitwise_count((w0[:, :, None] ^ m[:, 3]) & m[:, 2])
                     + np.bitwise_count((w1[:, :, None] ^ m[:, 5]) & m[:, 4])) <= tol
            pos = p0[:, None] + np.arange(_K2_POS)
            hit = exact & loose & (pos < n_pos)[:, :, None] & np.repeat(vote, 32)[:, None, None]
            assert not (exact & loose & (pos < n_pos)[:, :, None] & ~hit).any()  # no hit outside a vote
            for h in range(n_hyp):
                if hit[:, :, h].any():
                    s_first[h] = min(s_first[h], int(pos[hit[:, :, h]].min()))
        scratch[cap * per_capture + blk] = s_first
        ticket[cap] += 1
        if ticket[cap] == per_capture:
            mins = scratch[cap * per_capture : (cap + 1) * per_capture].min(axis=0)[:n_hyp]
            assert (first[cap] == -1).all()  # one last block a capture
            found[cap] = mins < big
            first[cap] = np.where(found[cap], mins, 0)
            ticket[cap] = 0
    assert (ticket == 0).all() and (first >= 0).all()
    return first, found


@pytest.mark.parametrize("rows_scanned", [256, 512, 768])
@pytest.mark.parametrize("sms", [_SMS, 1])
@pytest.mark.parametrize("family", ["qpsk", "bpsk"])
def test_rotation_match_kernel_walk_mirrored(family, sms, rows_scanned):
    """K2's new position walk in numpy against the plain version at 256,
    512 and all 768 rows, for both families, with a block per capture or
    several: matches planted at a thread run's first and last position (16
    a thread), at a block's first and last (4096 positions a block), at the
    256-row scan's last valid position n_pos - 1 and at n_pos itself
    (rejected there, found on the longer scans), and one capture of noise."""
    rng = np.random.default_rng(rows_scanned + sms + (family == "bpsk"))
    r = 768
    n_hyp, n_pat = (8, 16) if family == "qpsk" else (4, 32)
    n_pos_256 = 256 * 128 - (n_pat + 1)
    leads = [160, 175, 4096, 8191, n_pos_256 - 1, n_pos_256, 3 * 4096 - 1, 70001]
    if family == "qpsk":
        caps = [_magic_streams(rng, r, i % 4, i // 4, lead) for i, lead in enumerate(leads)]
    else:
        caps = [_bpsk_streams(rng, r, i % 4, lead) for i, lead in enumerate(leads)]
    caps.append(_noise_streams(rng, r))
    hi, lo = np.stack([c[0] for c in caps]), np.stack([c[1] for c in caps])
    table = tk._rotation_mask_table(family, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    first_m, found_m = _rotation_match_numpy(hi, lo, table, 3, n_pat, rows_scanned, sms, rng)
    first_t, found_t = tk.rotation_match_batch(torch.from_numpy(hi), torch.from_numpy(lo), MAGIC_BIT_PATTERN, r,
                                               family=family, pattern2=MAGIC_BIT_PATTERN2,
                                               rows_scanned=rows_scanned)
    assert first_m.shape == (len(caps), n_hyp)
    assert np.array_equal(found_m, found_t.numpy()) and np.array_equal(first_m, first_t.numpy())
    n_pos = rows_scanned * 128 - (n_pat + 1)
    for i, lead in enumerate(leads):
        h = i % n_hyp
        assert found_m[i, h] == (lead < n_pos) and first_m[i, h] == (lead if lead < n_pos else 0)


@pytest.mark.parametrize("ksel", [0, 1, 2, 3])
def test_bit_select_pack_plain_equals_pallas(ksel):
    """Every s & 7 (one capture each) under hypothesis ksel, on bytes
    [0, n_valid): past n_valid the JAX kernel reads the next capture."""
    rng = np.random.default_rng(60 + ksel)
    b, r = 8, 256
    re = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    im = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 500, b) + np.arange(b)).astype(np.int32)
    k = np.full(b, ksel, np.int32)
    ref = np.asarray(j_bit_select_pack(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(s), jnp.asarray(k),
        rows_per_capture=r, interpret=True, variant="weights",
    ))
    got = tk.bit_select_pack_batch(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(s), torch.from_numpy(k),
        rows_per_capture=r,
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, r * 16)
    n_valid = (r * 128 - (s & 7)) // 8
    for i in range(b):
        assert np.array_equal(got.numpy()[i, : n_valid[i]], ref[i, : n_valid[i]]), i


def test_bit_select_pack_kernel_formulation():
    """K4's CUDA formulation: per output byte, the 8 stream bytes from bit
    8c + s8 on, complemented by the hypothesis, zero past the end."""
    rng = np.random.default_rng(61)
    b, r = 8, 256
    re = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    im = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 500, b) + np.arange(b)).astype(np.int32)
    k = (np.arange(b) % 4).astype(np.int32)
    got = tk.bit_select_pack_batch(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(s), torch.from_numpy(k),
        rows_per_capture=r,
    ).numpy()
    n_bits = r * 128
    for i in range(b):
        v = (im if k[i] & 1 else re)[i].reshape(-1).astype(np.int64)
        p = 8 * np.arange(r * 16)[:, None] + (s[i] & 7) + np.arange(8)
        bits = np.where(p < n_bits, (v[np.minimum(p, n_bits - 1)] ^ (k[i] >= 2)) & 1, 0)
        assert np.array_equal(got[i], (bits << (7 - np.arange(8))).sum(1).astype(np.uint8))


def _bit_select_pack_runs_numpy(re, im, s, ksel, run: int = 64):
    """csrc/bit_select_pack.cu in numpy: per capture the selected lane (im
    where ksel is odd) and the complement mask (~0 where ksel >= 2); per run
    of ``run`` bits (the kernel's 64), each word of 4 bytes compacted by the multiply
    0x80402010 to 4 MSB-first stream bits, two words a byte, three byte
    permutes a 32-bit stream word; the next run's head (a warp's last lane:
    its first 8 bytes, top 8 bits), the funnel shift and the byte swap."""
    b, r, _ = re.shape
    n_runs, kw = r * 128 // run, run // 32
    out = np.empty((b, r * 16), np.uint8)

    def bits8(x0, x1):
        def bits4(x):
            return ((x & np.uint64(0x01010101)) * np.uint64(0x80402010)) & _U32
        return (bits4(x0) & np.uint64(0xF0000000)) | ((bits4(x1) >> np.uint64(4)) & np.uint64(0x0F000000))

    for i in range(b):
        k = int(ksel[i])
        flip = np.uint64(0xFFFFFFFF if k >= 2 else 0)
        x = _words(im[i] if k & 1 else re[i], n_runs, 8 * kw).reshape(n_runs, kw, 8)
        p = [bits8(x[:, :, 2 * e], x[:, :, 2 * e + 1]) for e in range(4)]
        w = _byte_perm(_byte_perm(p[0], p[1], 0x3700), _byte_perm(p[2], p[3], 0x3700), 0x3276) ^ flip
        heads = (p[0][:, 0] ^ flip) & np.uint64(0xFF000000)
        assert np.array_equal(heads >> np.uint64(24), w[:, 0] >> np.uint64(24))
        out[i] = _shift_pack_runs(w, heads, int(s[i]) & 7)
    return out


@pytest.mark.parametrize("r", [96, 13, 300])
def test_bit_select_pack_run_formulation(r):
    """K4's CUDA formulation at every (ksel, s8), one capture each: equal
    to the plain version everywhere and, where the Pallas kernel takes the
    rows, to the Pallas kernel on [0, n_valid). At 13 rows a capture's
    last warp is partial; at 96 and 300 its last block."""
    rng = np.random.default_rng(120 + r)
    b = 32
    re = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    im = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = (8 * rng.integers(0, 40, b) + np.arange(b) % 8).astype(np.int32)
    ksel = (np.arange(b) // 8).astype(np.int32)
    got = _bit_select_pack_runs_numpy(re, im, s, ksel)
    plain = tk.bit_select_pack_batch(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(s),
                                     torch.from_numpy(ksel), rows_per_capture=r, block_rows=1).numpy()
    assert np.array_equal(got, plain)
    if r % 32 == 0:
        ref = np.asarray(j_bit_select_pack(jnp.asarray(re), jnp.asarray(im), jnp.asarray(s), jnp.asarray(ksel),
                                           rows_per_capture=r, block_rows=32, interpret=True, variant="weights"))
        n_valid = (r * 128 - (s & 7)) // 8
        for i in range(b):
            assert np.array_equal(got[i, : n_valid[i]], ref[i, : n_valid[i]]), i


# --- D8PSK: K5 and K6 --------------------------------------------------------------

def _psk8_stream(rng, r: int, k: int, lead: int):
    """Random received sectors (r, 128) whose tribits, read as rotation-k
    sectors, hold the 32-bit magic + validation pattern at symbol ``lead``."""
    from audio_modem_radio_tpu_torch.ops.psk import _GRAY8_INV

    bits = rng.integers(0, 2, 3 * r * 128, dtype=np.uint8)
    pat = np.array([int(c) for c in _PATTERN], np.uint8)
    bits[3 * lead : 3 * lead + len(pat)] = pat
    tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
    return ((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8).reshape(r, 128)


def _both_sector_match(sec, r, rows_scanned=None):
    p = r if rows_scanned is None else rows_scanned
    first_j, found_j = j_sector_match(
        jnp.asarray(sec[:, :p]), MAGIC_BIT_PATTERN, p, pattern2=MAGIC_BIT_PATTERN2, interpret=True,
    )
    first_t, found_t = tk.sector_match_batch(
        torch.from_numpy(sec), MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2,
        rows_scanned=rows_scanned,
    )
    return (np.asarray(first_j), np.asarray(found_j)), (first_t.numpy(), found_t.numpy())


@pytest.mark.parametrize("k", [0, 1, 3, 5, 7])
def test_sector_match_plain_equals_pallas(k):
    rng = np.random.default_rng(70 + k)
    r = 256
    lead = 37 + 911 * k
    sec = np.stack([_psk8_stream(rng, r, k, lead), rng.integers(0, 8, (r, 128), dtype=np.uint8)])
    (first_j, found_j), (first_t, found_t) = _both_sector_match(sec, r)
    assert first_t.shape == (2, 8) and first_t.dtype == np.int32
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert found_t[0, k] and first_t[0, k] == lead


@pytest.mark.parametrize("lead", [500, 32768 - 12, 40000])
def test_sector_match_prefix_of_longer_capture(lead):
    rng = np.random.default_rng(lead + 2)
    r = 512
    sec = np.stack([_psk8_stream(rng, r, 2, lead), _psk8_stream(rng, r, 6, 300)])
    (first_j, found_j), (first_t, found_t) = _both_sector_match(sec, r, rows_scanned=256)
    assert np.array_equal(first_t, first_j) and np.array_equal(found_t, found_j)
    assert found_t[0, 2] == (lead < 256 * 128 - 11)
    assert found_t[1, 6] and first_t[1, 6] == 300


@pytest.mark.parametrize("rows_scanned", [256, 512])
def test_sector_match_kernel_formulation(rows_scanned):
    """K5's CUDA formulation: the Gray planes of 10 window symbols packed as
    bit 3j + q of one word, two (mask, value) pairs per hypothesis,
    popcounts, and only positions below the scan limit evaluated."""
    rng = np.random.default_rng(rows_scanned + 4)
    r = 512
    sec = np.stack([_psk8_stream(rng, r, k, 100 + 7000 * k) for k in range(8)]
                   + [rng.integers(0, 8, (r, 128), dtype=np.uint8)])
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    masks = tk._sector_mask_table(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2).astype(np.int64)
    n_pos = rows_scanned * 128 - (n_sym + 1)
    first_n = np.full((sec.shape[0], 8), 1 << 30, np.int64)
    for i in range(sec.shape[0]):
        x = sec[i, :rows_scanned].reshape(-1).astype(np.int64)
        b2, b1, b0 = (x >> 2) & 1, (x >> 1) & 1, x & 1
        g = b2 | ((b2 ^ b1) << 1) | ((b1 ^ b0) << 2)
        w = np.lib.stride_tricks.sliding_window_view(g, n_sym)[:n_pos] @ (1 << (3 * np.arange(n_sym)))
        for h, m in enumerate(masks):
            hit = np.nonzero((np.bitwise_count((w ^ m[1]) & m[0]) == 0)
                             & (np.bitwise_count((w ^ m[3]) & m[2]) <= 3))[0]
            if len(hit):
                first_n[i, h] = hit[0]
    found_n = first_n < (1 << 30)
    first_t, found_t = tk.sector_match_batch(
        torch.from_numpy(sec), MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2,
        rows_scanned=rows_scanned,
    )
    assert np.array_equal(found_t.numpy(), found_n)
    assert np.array_equal(first_t.numpy(), np.where(found_n, first_n, 0))
    assert all(found_n[k, k] for k in range(8) if 100 + 7000 * k < n_pos)


# csrc/sector_match.cu's constants: threads a block, positions a thread,
# 16-byte chunks a thread reads, blocks a multiprocessor at its occupancy.
_K5_THREADS, _K5_POS, _K5_CHUNKS, _K5_PER_SM = 256, 16, 2, 8


def _gray4(x):
    x = x & np.uint32(0x07070707)
    y = x ^ ((x >> np.uint32(1)) & np.uint32(0x03030303))
    return (((y >> np.uint32(2)) & np.uint32(0x01010101)) | (y & np.uint32(0x02020202))
            | ((y & np.uint32(0x01010101)) << np.uint32(2)))


def _pack12(g):
    g = (g | (g >> np.uint32(5))) & np.uint32(0x003F003F)
    return (g | (g >> np.uint32(10))) & np.uint32(0xFFF)


def _sector_match_numpy(sec, table, tol, n_sym, rows_scanned, sms, rng):
    """csrc/sector_match.cu in numpy, block by block in a shuffled order:
    the one-wave grid split over the captures, each thread's 16-byte chunks
    (zeros past the scanned prefix), Gray planes 4 sectors a word, the
    12-bit groups packed into a bit stream, each position's window by a
    funnel shift (the slow pass's, by 64-bit shifts, equal to it); the fast
    pass over the exact parts, the warp vote, the slow pass with the loose
    popcount and the limit, the block's shared
    minima, its scratch row and ticket, and the last block's reduction and
    ticket reset. Asserts that the slow pass only ever finds positions the
    fast pass flagged, and that every ticket is back at 0. Returns (first,
    found) as the kernel writes them."""
    b, r, _ = sec.shape
    n_hyp = table.shape[0]
    big = 1 << 30
    masks = np.zeros((8, 4), np.uint32)
    masks[:] = table.view(np.uint32)[[h if h < n_hyp else 0 for h in range(8)]]
    n_pos = rows_scanned * 128 - (n_sym + 1)
    span = _K5_THREADS * _K5_POS
    n_iters = -(-n_pos // span) if n_pos > 0 else 0
    per_capture = max(1, min(_K5_PER_SM * sms // b, n_iters, 65535 // b))
    scratch = np.full((b * per_capture, 8), -1, np.int64)
    ticket = np.zeros(b, np.int64)
    first = np.full((b, n_hyp), -1, np.int64)
    found = np.zeros((b, n_hyp), bool)
    flat = np.ascontiguousarray(sec).reshape(b, -1)
    th = np.arange(_K5_THREADS)
    for blk_id in rng.permutation(b * per_capture):
        cap, blk = divmod(int(blk_id), per_capture)
        s_first = np.full(8, big, np.int64)
        for it in range(blk, n_iters, per_capture):
            p0 = (it * _K5_THREADS + th) * _K5_POS
            at = p0[:, None] + np.arange(16 * _K5_CHUNKS)
            raw = np.where(at < rows_scanned * 128, flat[cap, np.minimum(at, r * 128 - 1)], 0).astype(np.uint8)
            words = np.ascontiguousarray(raw).view("<u4").astype(np.uint32)  # (threads, 4 * chunks)
            g = np.zeros((_K5_THREADS, (12 * 4 * _K5_CHUNKS + 31) // 32), np.uint64)
            for e in range(words.shape[1]):
                o = 12 * e
                v = _pack12(_gray4(words[:, e])).astype(np.uint64)
                g[:, o // 32] |= (v << np.uint64(o % 32)) & np.uint64(0xFFFFFFFF)
                if o % 32 > 20:
                    g[:, o // 32 + 1] |= v >> np.uint64(32 - o % 32)
            w = np.stack([((g[:, 3 * i // 32] | (g[:, 3 * i // 32 + 1] << np.uint64(32))) >> np.uint64(3 * i % 32))
                          & np.uint64(0xFFFFFFFF) for i in range(_K5_POS)], 1).astype(np.uint32)  # (threads, P)
            # The slow pass takes the same words by shifting one of two 64-bit words.
            lo, hi = g[:, 0] | (g[:, 1] << np.uint64(32)), g[:, 1] | (g[:, 2] << np.uint64(32))
            w_slow = np.stack([(lo >> np.uint64(3 * i) if 3 * i < 32 else hi >> np.uint64(3 * i - 32))
                               & np.uint64(0xFFFFFFFF) for i in range(_K5_POS)], 1).astype(np.uint32)
            assert np.array_equal(w_slow, w)
            exact = ((w[:, :, None] ^ masks[:, 1]) & masks[:, 0]) == 0  # (threads, P, 8)
            vote = exact.reshape(_K5_THREADS // 32, -1).any(axis=1)  # one a warp
            loose = np.bitwise_count((w[:, :, None] ^ masks[:, 3]) & masks[:, 2]) <= tol
            pos = p0[:, None] + np.arange(_K5_POS)
            hit = exact & loose & (pos < n_pos)[:, :, None] & np.repeat(vote, 32)[:, None, None]
            assert not (exact & loose & (pos < n_pos)[:, :, None] & ~hit).any()  # no hit outside a vote
            for h in range(n_hyp):
                if hit[:, :, h].any():
                    s_first[h] = min(s_first[h], int(pos[hit[:, :, h]].min()))
        scratch[cap * per_capture + blk] = s_first
        ticket[cap] += 1
        if ticket[cap] == per_capture:
            m = scratch[cap * per_capture : (cap + 1) * per_capture].min(axis=0)[:n_hyp]
            assert (first[cap] == -1).all()  # one last block a capture
            found[cap] = m < big
            first[cap] = np.where(found[cap], m, 0)
            ticket[cap] = 0
    assert (ticket == 0).all() and (first >= 0).all()
    return first, found


@pytest.mark.parametrize("rows_scanned", [256, 512, 768])
@pytest.mark.parametrize("sms", [_SMS, 1])
def test_sector_match_kernel_walk_mirrored(rows_scanned, sms):
    """K5's new position walk in numpy against the plain version at 256,
    512 and all 768 rows, with a block per capture or several: matches
    planted at a thread range's first and last position, at a block's first
    and last (4096 positions a block), at the 256-row scan's last valid
    position n_pos - 1 and at n_pos itself (rejected there, found on the
    longer scans), and one capture of noise."""
    rng = np.random.default_rng(rows_scanned + sms)
    r = 768
    n_pos_256 = 256 * 128 - 11
    leads = [160, 175, 4096, 8191, n_pos_256 - 1, n_pos_256, 3 * 4096 - 16 + 15, 70001]
    sec = np.stack([_psk8_stream(rng, r, k, lead) for k, lead in enumerate(leads)]
                   + [rng.integers(0, 8, (r, 128), dtype=np.uint8)])
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    first_m, found_m = _sector_match_numpy(sec, tk._sector_mask_table(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2),
                                           3, n_sym, rows_scanned, sms, rng)
    first_t, found_t = tk.sector_match_batch(torch.from_numpy(sec), MAGIC_BIT_PATTERN, r,
                                             pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned)
    assert np.array_equal(found_m, found_t.numpy()) and np.array_equal(first_m, first_t.numpy())
    n_pos = rows_scanned * 128 - (n_sym + 1)
    for k, lead in enumerate(leads):
        assert found_m[k, k] == (lead < n_pos) and first_m[k, k] == (lead if lead < n_pos else 0)


def test_match_conditions_built_once_per_key():
    """The matchers' condition sets and K5's and K2's host mask tables are
    cached per key: a second call returns the very same objects, equal to a
    fresh build."""
    pattern, pattern2 = MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    for build, args in ((tk.psk8_match_conditions, (pattern, pattern2)),
                        (tk.rotation_match_conditions, (pattern + pattern2,)),
                        (tk.bpsk_match_conditions, (pattern + pattern2,)),
                        (tk._sector_mask_table, (pattern, pattern2)),
                        (tk._rotation_mask_table, ("qpsk", pattern, pattern2)),
                        (tk._rotation_mask_table, ("bpsk", pattern, pattern2))):
        got = build(*args)
        assert build(*args) is got
        fresh = build.__wrapped__(*args)
        if isinstance(got, np.ndarray):
            assert np.array_equal(got, fresh) and not got.flags.writeable
        else:
            assert got == fresh
    assert tk.psk8_match_conditions(pattern, "") != tk.psk8_match_conditions(pattern, pattern2)
    assert not np.array_equal(tk._rotation_mask_table("qpsk", pattern, pattern2),
                              tk._rotation_mask_table("qpsk", pattern2, pattern))


@pytest.mark.parametrize("pairs", [((0, 0), (3, 5)), ((6, 1), (7, 7)), ((1, 2), (2, 4))])
def test_psk8_relabel_pack_plain_equals_pallas(pairs):
    """(ksel, r8) per capture; bytes [0, n_valid - 1) as the JAX package's
    own test compares them."""
    rng = np.random.default_rng(sum(sum(p) for p in pairs))
    b, r = 2, 256
    sec = rng.integers(0, 8, (b, r, 128), dtype=np.uint8)
    ksel = np.array([p[0] for p in pairs], np.int32)
    r8 = np.array([p[1] for p in pairs], np.int32)
    ref = np.asarray(j_psk8_pack(
        jnp.asarray(sec), jnp.asarray(ksel), jnp.asarray(r8), rows_per_capture=r, interpret=True,
    ))
    got = tk.psk8_relabel_pack_rows(
        torch.from_numpy(sec), torch.from_numpy(ksel), torch.from_numpy(r8), rows_per_capture=r,
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, r * 48)
    n_valid = 3 * (r * 128 - r8) // 8
    for i in range(b):
        assert np.array_equal(got.numpy()[i, : n_valid[i] - 1], ref[i, : n_valid[i] - 1]), i


def _psk8_pack_numpy(sec, ksel, r8):
    """csrc/psk8_pack.cu in numpy: a run of 32 symbols a thread (its two
    16-byte loads as 8 little-endian words), the SWAR relabel
    ((x & 7) + 8 - k) & 7 per byte, the Gray code, the byte reversal and the
    12-bit pack, the 96-bit big-endian stream of a run, the next run's first
    word (from the next lane's stream, or for a warp's last lane from an
    8-byte load; zero past the capture's end), the funnel shifts by 3*r8 and
    the byte swap of each stored word."""
    b, r, _ = sec.shape
    runs = 4 * r
    u = np.uint64
    x = np.ascontiguousarray(sec).reshape(b, runs, 32).view("<u4").astype(np.uint64)  # (b, runs, 8)
    add = ((8 - ksel.astype(np.uint64)) * u(0x01010101))[:, None, None]

    def gray12(x):
        x = ((x & u(0x07070707)) + add) & u(0x07070707)
        x ^= (x >> u(1)) & u(0x03030303)
        x = ((x & u(0xFF)) << u(24)) | ((x & u(0xFF00)) << u(8)) | ((x >> u(8)) & u(0xFF00)) | (x >> u(24))
        x = (x | (x >> u(5))) & u(0x003F003F)
        return (x | (x >> u(10))) & u(0xFFF)

    v = gray12(x)
    w = np.zeros((b, runs, 4), np.uint64)
    for e in range(8):
        o = 12 * e
        if o % 32 <= 20:
            w[:, :, o // 32] |= v[:, :, e] << u(20 - o % 32)
        else:
            w[:, :, o // 32] |= v[:, :, e] >> u(o % 32 - 20)
            w[:, :, o // 32 + 1] |= (v[:, :, e] << u(52 - o % 32)) & u(0xFFFFFFFF)
    head24 = (v[:, :, 0] << u(20)) | (v[:, :, 1] << u(8))  # the last lane's load, from the next run's 8 bytes
    assert np.array_equal(head24 >> u(8), w[:, :, 0] >> u(8))
    last_lane = (np.arange(runs) % 32 == 31)[None, :]
    nxt = np.where(last_lane[:, :-1], head24[:, 1:], w[:, 1:, 0])
    w[:, :, 3] = np.concatenate([nxt, np.zeros((b, 1), np.uint64)], axis=1)
    s = (3 * r8.astype(np.uint64))[:, None]
    out = np.zeros((b, runs, 3), np.uint64)
    for j in range(3):
        out[:, :, j] = (((w[:, :, j] << u(32)) | w[:, :, j + 1]) << s >> u(32)) & u(0xFFFFFFFF)
    return out.astype(">u4").view(np.uint8).reshape(b, runs * 12)


@pytest.mark.parametrize("r", [256, 13])
def test_psk8_relabel_pack_kernel_formulation(r):
    """K6's CUDA formulation (``_psk8_pack_numpy``) against the plain
    version at every (ksel, r8), one capture each; at 13 rows a capture
    holds 52 runs, so its last warp is partial and its last run's neighbour
    lies past the capture's end."""
    rng = np.random.default_rng(80 + r)
    b = 64
    sec = rng.integers(0, 8, (b, r, 128), dtype=np.uint8)
    ksel = (np.arange(b) % 8).astype(np.int32)
    r8 = (np.arange(b) // 8).astype(np.int32)
    got = tk.psk8_relabel_pack_rows(
        torch.from_numpy(sec), torch.from_numpy(ksel), torch.from_numpy(r8), rows_per_capture=r, block_rows=1,
    ).numpy()
    assert np.array_equal(_psk8_pack_numpy(sec, ksel, r8), got)


@pytest.mark.parametrize("argv", [
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "fsk_flat", "--variant", "d=csrc/fsk_tile.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "decide", "--dtype", "int8",
     "--variant", "d=csrc/decide.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "fsk_tile", "--variant", "d=csrc/fsk_tile.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "project_diff", "--single",
     "--variant", "d=csrc/project_diff.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "sector_match", "--rows-scanned", "full",
     "--noise-last", "--variant", "d=csrc/sector_match.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "rotation_match", "--family", "bpsk",
     "--rows-scanned", "1792", "--noise-last", "--variant", "d=csrc/rotmatch.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "psk8_pack", "--variant", "d=csrc/psk8_pack.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "relabel_pack", "--variant",
     "d=csrc/relabel_pack.cu"],
    ["-m", "audio_modem_radio_tpu_torch.kernel_variants", "--kernel", "bit_select_pack", "--variant",
     "d=csrc/bit_select_pack.cu"],
    ["-m", "audio_modem_radio_tpu_torch.profile_slice", "--mode", "FSK1200", "--flat"],
    ["-m", "audio_modem_radio_tpu_torch.profile_slice", "--mode", "8PSK", "--noise-last", "--xla"],
])
def test_card_tools_fail_without_a_card(argv):
    """The timing tools measure only on a card: without one they print FAIL
    and exit 2 (no CPU fallback), before building anything."""
    import pathlib
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would measure")
    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, *argv], cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "FAIL" in out.stdout, out.stdout + out.stderr
