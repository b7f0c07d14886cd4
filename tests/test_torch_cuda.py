"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (a CUDA kernel has no CPU mode). This file imports no JAX, so on a
machine without JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, crc32, pack_frame
from audio_modem_radio_tpu_torch.modem import modulate
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.ops.psk import _GRAY8_INV, _batch_pass1, _device_tables, blocked_row_shape

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_SCALE = {"float32": None, "int16": 32768.0, "int8": 128.0}


_CARRIER = {"QPSK": 3000.0, "BPSK": 3000.0, "8PSK": 12000.0}


def _rows(n_cap: int, n: int, dtype: str, mode: str = "QPSK"):
    """Blocked rows of ``n_cap`` shifted captures and the number of symbols
    that every capture's modulated span covers."""
    rng = np.random.default_rng(0)
    r, row = blocked_row_shape(n, 9600, 96000)
    x = np.zeros((n_cap, r * row), np.float32)
    for i in range(n_cap):
        p = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        wave = modulate(mode, pack_frame("c.bin", p, 0, 1, len(p), crc32(p)), 9600)
        x[i, 5 * i : 5 * i + len(wave)] = wave
    n_sig = len(wave) // 10 - 2
    scale = _SCALE[dtype]
    if scale is not None:
        x = np.clip(np.round(x * scale), -scale, scale - 1).astype(dtype)
    return x.reshape(n_cap, r, row), n_sig


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
def test_decide_kernel_equals_plain(cuda, dtype):
    x, n_sig = _rows(3, 1 << 19, dtype)
    x = torch.from_numpy(x).to(cuda)
    b, r, _ = x.shape
    _, _, best, theta = _batch_pass1(None, x, b, r * 128, 10, 3000.0, 96000, 8, r)
    W8, _, _ = _device_tables(10, 3000.0, 96000, 8, x.device)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], 1)
    before = tk.psk_project_decide_batch.launches
    hi_k, lo_k = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r)
    hi_p, lo_p = tk.psk_project_decide_batch_plain(x, W8, best, rot)
    torch.cuda.synchronize()
    assert tk.psk_project_decide_batch.launches == before + 1
    assert torch.equal(hi_k.reshape(b, -1)[:, :n_sig], hi_p.reshape(b, -1)[:, :n_sig])
    assert torch.equal(lo_k.reshape(b, -1)[:, :n_sig], lo_p.reshape(b, -1)[:, :n_sig])


@pytest.mark.parametrize("n_psk", [2, 8])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_decide_kernel_equals_plain_psk2_psk8(cuda, n_psk, dtype):
    """Bitwise over the span, except DBPSK's lo stream under pass 1's θ: a
    clean DBPSK differential is real, so the sign of its imaginary part is
    rounding noise; it is compared under a π/4 test rotation instead."""
    mode = "BPSK" if n_psk == 2 else "8PSK"
    x, n_sig = _rows(3, 1 << 19, dtype, mode)
    x = torch.from_numpy(x).to(cuda)
    b, r, _ = x.shape
    carrier = _CARRIER[mode]
    _, _, best, theta = _batch_pass1(None, x, b, r * 128, 10, carrier, 96000, 8, r,
                                     n_psk=8 if n_psk == 8 else 4)
    W8, _, _ = _device_tables(10, carrier, 96000, 8, x.device)
    quarter = torch.full_like(theta, np.pi / 4)
    for th, streams in ((theta, 1), (quarter, 2)):
        rot = torch.stack([torch.cos(th), torch.sin(th)], 1)
        before = tk.psk_project_decide_batch.launches
        got = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
        ref = tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)
        torch.cuda.synchronize()
        assert tk.psk_project_decide_batch.launches == before + 1
        if n_psk == 8:
            got, ref, streams = [got], [ref], 1
        for g, p in list(zip(got, ref))[:streams]:
            assert torch.equal(g.reshape(b, -1)[:, :n_sig], p.reshape(b, -1)[:, :n_sig])


def _decide64(x, tmpl, best, rot, n_psk):
    """K1's decisions in float64 and each symbol's distance from a decision
    boundary (relative to the largest product the differential sums), so a
    comparison can set aside the near-ties where float32 summation order
    decides. Returns (list of decision streams, relative margin), (B, n)."""
    b, r, row = x.shape
    spsym = row // 128
    flat = torch.nn.functional.pad(x.reshape(b, -1).double(), (0, 2 * spsym))
    win = flat.unfold(1, 2 * spsym, spsym)[:, : r * 128 + 1]  # (B, n+1, 2*spsym)
    t = tmpl[best.long()].double()  # (B, 2*spsym, 2)
    z = torch.einsum("bnj,bjc->bnc", win, t)
    mag = torch.einsum("bnj,bjc->bnc", win.abs(), t.abs()).amax(dim=2)
    r0, i0, r1, i1 = z[:, :-1, 0], z[:, :-1, 1], z[:, 1:, 0], z[:, 1:, 1]
    d_re, d_im = r1 * r0 + i1 * i0, i1 * r0 - r1 * i0
    c, s = rot[:, 0:1].double(), rot[:, 1:2].double()
    dr, di = d_re * c + d_im * s, d_im * c - d_re * s
    scale = 2 * mag[:, :-1] * mag[:, 1:] + 1e-30
    ax, bx = dr.abs(), di.abs()
    if n_psk == 2:
        margin, out = torch.minimum(ax, bx), [dr < 0, di < 0]
    elif n_psk == 4:  # the larger component's sign and which one is larger
        swap = bx > ax
        neg = torch.where(swap, di, dr) < 0
        margin, out = torch.minimum((ax - bx).abs(), torch.maximum(ax, bx)), [neg, neg ^ swap]
    else:  # the diagonal test, then both signs (diagonal) or as for 4 phases (axis)
        tq = 0.41421356
        diag = (bx > tq * ax) & (ax > tq * bx)
        margin = torch.minimum((bx - tq * ax).abs(), (ax - tq * bx).abs())
        margin = torch.minimum(margin, torch.where(diag, torch.minimum(ax, bx),
                                                   torch.minimum((ax - bx).abs(), torch.maximum(ax, bx))))
        out = [tk.psk8_sector_stream(dr.float(), di.float())]
    return [o.to(torch.uint8) for o in out], margin / scale


@pytest.mark.parametrize("n_psk", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
@pytest.mark.parametrize("spsym", [3, 8, 10, 32])
def test_decide_kernel_any_spsym_ragged_tile(cuda, spsym, dtype, n_psk):
    """K1 at the specialised spsym (8, 10) and the generic ones (3, 32), on
    258 rows (a last tile the rows do not fill for every sample type) of 3
    random captures: the kernel equals the plain version on every symbol
    whose float64 differential lies more than 1e-5 (relative) from a
    decision boundary, where only the summation order could flip it; the
    kernel writes only inside the capture (a canary after it)."""
    g = torch.Generator(device=cuda).manual_seed(spsym * 31 + n_psk)
    b, r = 3, 258
    x = torch.randn((b, r, 128 * spsym), generator=g, device=cuda) * 0.3
    if dtype != "float32":
        scale = 32767.0 if dtype == "int16" else 127.0
        x = (x.clamp(-1, 1) * scale).round().to(getattr(torch, dtype))
    W8 = torch.from_numpy(tpsk._blocked_templates(spsym, 3000.0, 96000, 8).copy()).to(cuda)
    best = torch.tensor([0, 3, 7], dtype=torch.int32, device=cuda)
    theta = torch.tensor([0.1, -0.7, 2.0], device=cuda)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], 1)
    got = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk, block_rows=2)
    ref = tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)
    got, ref = (list(got), list(ref)) if n_psk != 8 else ([got], [ref])
    want, rel = _decide64(x, tk._dual_basis(W8, spsym), best, rot, n_psk)
    clear = rel > 1e-5
    torch.cuda.synchronize()
    assert float(clear.float().mean()) > 0.99
    for k, p, w in zip(got, ref, want):
        k, p = k.reshape(b, -1), p.reshape(b, -1)
        assert torch.equal(k[clear], p[clear])
        assert torch.equal(k[clear], w[clear])


def test_decide_kernel_more_captures_than_blocks(cuda):
    """8 tiled QPSK captures of 512 rows cut into 2,048 captures of 2 rows
    (one 256-symbol tile each), more than one wave of blocks: each block
    then walks one capture. Equal to the plain version on every symbol off
    a decision boundary, the last of each capture included (its window
    reads zeros past the capture's 2 rows, as the plain version's does)."""
    p = np.random.default_rng(5).integers(0, 256, 1500, dtype=np.uint8).tobytes()
    wave = modulate("QPSK", pack_frame("c.bin", p, 0, 1, len(p), crc32(p)), 9600)
    b, r, row = 8, 512, 1280
    wave = np.tile(wave, -(-(r * row + 5 * b) // len(wave)))
    x = np.stack([wave[5 * i : 5 * i + r * row] for i in range(b)]) * (32767.0 / np.abs(wave).max())
    x = torch.from_numpy(np.round(x).astype(np.int16).reshape(b, r, row)).to(cuda)
    _, _, best, theta = _batch_pass1(None, x, b, r * 128, 10, 3000.0, 96000, 8, r)
    W8, _, _ = _device_tables(10, 3000.0, 96000, 8, x.device)
    xs = x.reshape(-1, 2, row)
    idx = torch.arange(xs.shape[0], device=cuda) // (r // 2)
    bs = best[idx].contiguous()
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], 1)[idx].contiguous()
    got = tk.psk_project_decide_batch(xs, W8, bs, rot, rows_per_capture=2, block_rows=2)
    ref = tk.psk_project_decide_batch_plain(xs, W8, bs, rot)
    want, rel = _decide64(xs, tk._dual_basis(W8, 10), bs, rot, 4)
    clear = rel > 1e-5
    torch.cuda.synchronize()
    assert xs.shape[0] == 2048 and float(clear.float().mean()) > 0.99
    for k, p, w in zip(got, ref, want):
        k, p = k.reshape(xs.shape[0], -1), p.reshape(xs.shape[0], -1)
        assert torch.equal(k[clear], p[clear]) and torch.equal(k[clear], w[clear])


def test_decide_kernel_rejects_a_misaligned_view(cuda):
    """The kernel stages 16-byte chunks: a view that starts 2 bytes past a
    16-byte boundary is refused by the wrapper, never launched."""
    r = 256
    flat = torch.zeros(3 * r * 1280 + 1, dtype=torch.int16, device=cuda)
    x = flat[1:].view(3, r, 1280)
    W8, _, _ = _device_tables(10, 3000.0, 96000, 8, cuda)
    best = torch.zeros(3, dtype=torch.int32, device=cuda)
    rot = torch.tensor([[1.0, 0.0]] * 3, device=cuda)
    before = tk.psk_project_decide_batch.launches
    with pytest.raises(ValueError, match="16-byte"):
        tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r)
    assert tk.psk_project_decide_batch.launches == before


@pytest.mark.parametrize("rows_scanned", [256, 512, 768])
def test_rotation_match_kernel_equals_plain(cuda, rows_scanned):
    g = torch.Generator(device=cuda).manual_seed(rows_scanned)
    r = 768
    hi = torch.randint(0, 2, (5, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    lo = torch.randint(0, 2, (5, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    conds, _ = tk.rotation_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    # Plant exact k=0, even-parity patterns in captures 0..3.
    for i, pos in enumerate((10, 33_000, 70_000, 98_300 - 20)):
        for idx, (is_hi, off, bit) in enumerate(conds[0]):
            (hi if is_hi else lo).view(5, -1)[i, pos + off] = bit
    first_k, found_k = tk.rotation_match_batch(
        hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned)
    first_p = tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, rows_scanned)
    limit = rows_scanned * 128 - 17
    found_p = (first_p < (1 << 30)) & (first_p < limit)
    torch.cuda.synchronize()
    assert torch.equal(found_k, found_p)
    assert torch.equal(first_k, torch.where(found_p, first_p, torch.zeros_like(first_p)))
    assert bool(found_k[0, 0])


@pytest.mark.parametrize("rows_scanned", [256, 768])
def test_rotation_match_bpsk_kernel_equals_plain(cuda, rows_scanned):
    g = torch.Generator(device=cuda).manual_seed(rows_scanned + 1)
    r = 768
    re = torch.randint(0, 2, (5, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    im = torch.randint(0, 2, (5, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    conds, _ = tk.bpsk_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    for h, pos in enumerate((10, 33_000, 70_000, 98_300 - 40)):  # one per hypothesis
        for is_hi, off, bit in conds[h]:
            (re if is_hi else im).view(5, -1)[h, pos + off] = bit
    first_k, found_k = tk.rotation_match_batch(
        re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2,
        rows_scanned=rows_scanned)
    first_p = tk.rotation_match_batch_plain(re, im, conds, 16, 3, rows_scanned)
    limit = rows_scanned * 128 - 33
    found_p = (first_p < (1 << 30)) & (first_p < limit)
    torch.cuda.synchronize()
    assert torch.equal(found_k, found_p)
    assert torch.equal(first_k, torch.where(found_p, first_p, torch.zeros_like(first_p)))
    assert bool(found_k[0, 0])


def _rotation_planted(cuda, family: str, r: int, leads, seed: int):
    """Random (hi, lo) lanes (len(leads) + 1, r, 128) on the card: capture i
    holds hypothesis i % n_hyp's conditions at position leads[i]; the last
    capture is noise."""
    build = tk.rotation_match_conditions if family == "qpsk" else tk.bpsk_match_conditions
    conds, _ = build(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2, (len(leads) + 1, r * 128), dtype=np.uint8)
    lo = rng.integers(0, 2, (len(leads) + 1, r * 128), dtype=np.uint8)
    for i, lead in enumerate(leads):
        for is_hi, off, bit in conds[i % len(conds)]:
            (hi if is_hi else lo)[i, lead + off] = bit
    return (torch.from_numpy(x.reshape(-1, r, 128)).to(cuda) for x in (hi, lo)), conds


@pytest.mark.parametrize("family", ["qpsk", "bpsk"])
def test_rotation_match_kernel_boundaries_and_alternating_tiers(cuda, family):
    """K2 with hypotheses planted on their own captures at a thread run's
    first and last position (16 a thread), a block's first and last (4096 a
    block), the 256-row scan's last valid position and the one after it,
    plus a noise capture; called again and again with the tier and the
    number of captures changing between calls (each call's last block
    resets its ticket; the one-wave grid splits anew): (first, found) equal
    plain's after its epilogue every time, one launch a call."""
    r = 768
    n_pat = 16 if family == "qpsk" else 32
    n_pos_256 = 256 * 128 - (n_pat + 1)
    leads = [160, 175, 4096, 8191, n_pos_256 - 1, n_pos_256, 3 * 4096 - 1, 70001]
    (hi, lo), conds = _rotation_planted(cuda, family, r, leads, 12)
    for p, nb in ((256, 9), (768, 9), (256, 3), (512, 9), (768, 1), (256, 9), (512, 5), (256, 9)):
        before = tk.rotation_match_batch.launches
        first_k, found_k = tk.rotation_match_batch(hi[:nb], lo[:nb], MAGIC_BIT_PATTERN, r, family=family,
                                                   pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)
        first_p = tk.rotation_match_batch_plain(hi[:nb], lo[:nb], conds, 16, 3, p)
        n_pos = p * 128 - (n_pat + 1)
        found_p = (first_p < (1 << 30)) & (first_p < n_pos)
        torch.cuda.synchronize()
        assert tk.rotation_match_batch.launches == before + 1
        assert found_k.dtype == torch.bool and first_k.dtype == torch.int32
        assert tuple(found_k.shape) == (nb, len(conds))
        assert torch.equal(found_k, found_p), (p, nb)
        assert torch.equal(first_k, torch.where(found_p, first_p, torch.zeros_like(first_p))), (p, nb)
        for i, lead in enumerate(leads[:nb]):
            h = i % len(conds)
            assert bool(found_k[i, h]) == (lead < n_pos) and int(first_k[i, h]) == (lead if lead < n_pos else 0)


def test_rotation_match_kernel_rejects_a_misaligned_view(cuda):
    flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.uint8, device=cuda)
    good = torch.zeros(2, 256, 128, dtype=torch.uint8, device=cuda)
    bad = flat[1:].view(2, 256, 128)
    before = tk.rotation_match_batch.launches
    for hi, lo in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, 256, pattern2=MAGIC_BIT_PATTERN2)
    assert tk.rotation_match_batch.launches == before


@pytest.mark.parametrize("rows_scanned", [256, 768])
def test_sector_match_kernel_equals_plain(cuda, rows_scanned):
    rng = np.random.default_rng(rows_scanned)
    r = 768
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    sec = []
    for k, lead in enumerate((10, 11_000, 23_000, 33_000, 50_000, 70_000, 90_000, 98_300 - 20)):
        bits = rng.integers(0, 2, 3 * r * 128, dtype=np.uint8)
        bits[3 * lead : 3 * lead + len(pat)] = pat
        tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
        sec.append(((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8))
    sec.append(rng.integers(0, 8, r * 128, dtype=np.uint8))
    sec = torch.from_numpy(np.stack(sec).reshape(-1, r, 128)).to(cuda)
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    first_k, found_k = tk.sector_match_batch(
        sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=rows_scanned)
    first_p = tk.sector_match_batch_plain(sec, conds, 3, rows_scanned)
    found_p = (first_p < (1 << 30)) & (first_p < rows_scanned * 128 - (n_sym + 1))
    torch.cuda.synchronize()
    assert torch.equal(found_k, found_p)
    assert torch.equal(first_k, torch.where(found_p, first_p, torch.zeros_like(first_p)))
    assert bool(found_k[0, 0])


def _psk8_planted(rng, r: int, leads):
    """Random received sectors (len(leads) + 1, r, 128): capture k holds the
    magic + validation pattern as rotation-k sectors at symbol leads[k]; the
    last capture is noise."""
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    sec = []
    for k, lead in enumerate(leads):
        bits = rng.integers(0, 2, 3 * r * 128, dtype=np.uint8)
        bits[3 * lead : 3 * lead + len(pat)] = pat
        tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
        sec.append(((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8))
    sec.append(rng.integers(0, 8, r * 128, dtype=np.uint8))
    return np.stack(sec).reshape(-1, r, 128)


def test_sector_match_kernel_boundaries_and_alternating_tiers(cuda):
    """K5 with each hypothesis planted on its own capture at a thread
    range's first and last position (16 a thread), a block's first and last
    (4096 a block), the 256-row scan's last valid position and the one
    after it, plus a noise capture; called again and again with the tier
    changing between calls (each call's last block resets its ticket):
    (first, found) equal plain's after its epilogue every time."""
    r = 768
    n_pos_256 = 256 * 128 - 11
    leads = [160, 175, 4096, 8191, n_pos_256 - 1, n_pos_256, 3 * 4096 - 1, 70001]
    sec = torch.from_numpy(_psk8_planted(np.random.default_rng(11), r, leads)).to(cuda)
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    for p in (256, 768, 256, 512, 768, 256, 512, 256):
        before = tk.sector_match_batch.launches
        first_k, found_k = tk.sector_match_batch(
            sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)
        first_p = tk.sector_match_batch_plain(sec, conds, 3, p)
        n_pos = p * 128 - (n_sym + 1)
        found_p = (first_p < (1 << 30)) & (first_p < n_pos)
        torch.cuda.synchronize()
        assert tk.sector_match_batch.launches == before + 1
        assert found_k.dtype == torch.bool and first_k.dtype == torch.int32
        assert torch.equal(found_k, found_p), p
        assert torch.equal(first_k, torch.where(found_p, first_p, torch.zeros_like(first_p))), p
        for k, lead in enumerate(leads):
            assert bool(found_k[k, k]) == (lead < n_pos) and int(first_k[k, k]) == (lead if lead < n_pos else 0)


def test_sector_match_kernel_rejects_a_misaligned_view(cuda):
    flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.uint8, device=cuda)
    sec = flat[1:].view(2, 256, 128)
    before = tk.sector_match_batch.launches
    with pytest.raises(ValueError, match="16-byte"):
        tk.sector_match_batch(sec, MAGIC_BIT_PATTERN, 256, pattern2=MAGIC_BIT_PATTERN2)
    assert tk.sector_match_batch.launches == before


def _every_pair(cuda, b: int = 32):
    """Per-capture (s, ksel) with every (ksel, s & 7) pair once."""
    i = torch.arange(b, device=cuda)
    return (8 * 37 * i + i % 8).to(torch.int32), (i // 8).to(torch.int32)


def test_relabel_pack_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    b, r = 32, 512
    hi = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    lo = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    s, ksel = _every_pair(cuda, b)
    got = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)
    ref = tk.relabel_pack_batch_plain(hi, lo, s, ksel)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_bit_select_pack_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    b, r = 32, 512
    re = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    im = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    s, ksel = _every_pair(cuda, b)
    got = tk.bit_select_pack_batch(re, im, s, ksel, rows_per_capture=r)
    ref = tk.bit_select_pack_batch_plain(re, im, s, ksel)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("r", [13, 300])
def test_relabel_and_bit_select_pack_kernels_every_pair_ragged_grid(cuda, r):
    """K3 and K4 at every (ksel, s8), one capture each, on row counts whose
    runs leave the last warp (13 rows) or the last block (300) of a capture
    partial; each capture's last run has no neighbour: bytes equal plain's."""
    g = torch.Generator(device=cuda).manual_seed(40 + r)
    b = 32
    hi = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    lo = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    s, ksel = _every_pair(cuda, b)
    got3 = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r, block_rows=1)
    got4 = tk.bit_select_pack_batch(hi, lo, s, ksel, rows_per_capture=r, block_rows=1)
    torch.cuda.synchronize()
    assert torch.equal(got3, tk.relabel_pack_batch_plain(hi, lo, s, ksel))
    assert torch.equal(got4, tk.bit_select_pack_batch_plain(hi, lo, s, ksel))


@pytest.mark.parametrize("which", [0, 1])
def test_relabel_and_bit_select_pack_kernels_reject_a_misaligned_view(cuda, which):
    flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.uint8, device=cuda)
    bad = flat[1:].view(2, 256, 128)
    good = torch.zeros(2, 256, 128, dtype=torch.uint8, device=cuda)
    lanes = (bad, good) if which == 0 else (good, bad)
    zero = torch.zeros(2, dtype=torch.int32, device=cuda)
    for fn in (tk.relabel_pack_batch, tk.bit_select_pack_batch):
        before = fn.launches
        with pytest.raises(ValueError, match="16-byte"):
            fn(*lanes, zero, zero, rows_per_capture=256)
        assert fn.launches == before


@pytest.mark.parametrize("r", [13, 300])
def test_psk8_pack_kernel_every_shift_ragged_grid(cuda, r):
    """K6 at every (ksel, r8), one capture each, on row counts whose runs
    (4 a row) leave the last warp and the last block of a capture partial;
    each capture's last run has no neighbour: bytes equal plain's."""
    g = torch.Generator(device=cuda).manual_seed(r)
    b = 64
    sec = torch.randint(0, 8, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    i = torch.arange(b, device=cuda)
    ksel, r8 = (i % 8).to(torch.int32), (i // 8).to(torch.int32)
    got = tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r, block_rows=1)
    ref = tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_psk8_pack_kernel_rejects_a_misaligned_view(cuda):
    flat = torch.zeros(2 * 256 * 128 + 1, dtype=torch.uint8, device=cuda)
    sec = flat[1:].view(2, 256, 128)
    zero = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = tk.psk8_relabel_pack_rows.launches
    with pytest.raises(ValueError, match="16-byte"):
        tk.psk8_relabel_pack_rows(sec, zero, zero, rows_per_capture=256)
    assert tk.psk8_relabel_pack_rows.launches == before


def test_psk8_pack_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    b, r = 16, 512
    sec = torch.randint(0, 8, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    ksel = (torch.arange(b, device=cuda) % 8).to(torch.int32)
    r8 = ((3 * torch.arange(b, device=cuda)) % 8).to(torch.int32)
    got = tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r)
    ref = tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


_SLICE_KERNELS = {
    "QPSK": ("psk_project_decide_batch", "rotation_match_batch", "relabel_pack_batch"),
    "BPSK": ("psk_project_decide_batch", "rotation_match_batch", "bit_select_pack_batch"),
    "8PSK": ("psk_project_decide_batch", "sector_match_batch", "psk8_relabel_pack_rows"),
}


def _decode_on_card(cuda, mode):
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    rng = np.random.default_rng(1)
    payloads, batch = [], np.zeros((3, 1 << 18), np.float32)
    for i in range(3):
        p = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        wave = modulate(mode, pack_frame(f"g{i}.bin", p, 0, 1, len(p), crc32(p)), 9600)
        batch[i, 100 * i : 100 * i + len(wave)] = wave
        payloads.append(p)
    tk.reset_launch_counts()
    raws = decode_sample_batch(batch, mode, 9600, device=cuda)
    counts = tk.launch_counts()
    assert {k for k, v in counts.items() if v > 0} == set(_SLICE_KERNELS[mode])
    for raw, p in zip(raws, payloads):
        assert [f.data for f in parse_frames(raw)] == [p]


def test_decode_sample_batch_on_card(cuda):
    _decode_on_card(cuda, "QPSK")


@pytest.mark.parametrize("mode", ["BPSK", "8PSK"])
def test_decode_sample_batch_on_card_psk2_psk8(cuda, mode):
    _decode_on_card(cuda, mode)


def test_wrapper_rejects_non_contiguous(cuda):
    hi = torch.zeros((2, 256, 256), dtype=torch.uint8, device=cuda)[:, :, ::2]
    s = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tk.relabel_pack_batch(hi, hi, s, s, rows_per_capture=256)


# --- FSK: K7, K13, K8, K9 --------------------------------------------------------

# mode -> (symbol rate, baud, mark, space) as parallel.batch.resolve_demod_plan gives them.
_FSK = {
    "FSK1200": (1200, 1200.0, 1200.0, 2200.0),
    "MSK@1000": (1000, 1000.0, 6000.0, 7000.0),
    "MSK@9600": (9600, 9600.0, 6000.0, 15600.0),
    "FT8": (50, 50.0, 3000.0, 3050.0),
    "FSK9600": (9600, 9600.0, 1200.0, 2200.0),
    "FSK19200": (19200, 19200.0, 8000.0, 16000.0),
}


def _fsk_batch(mode: str, n_cap: int = 3, seed: int = 0):
    """``n_cap`` captures of framed FSK waves at different leads, sized to
    hold them; returns (batch, n_sig) with n_sig the bits every capture's
    signal covers."""
    from audio_modem_radio_tpu_torch.ops.fsk import _samples_per_bit

    rate, baud = _FSK[mode][:2]
    name = mode.split("@")[0]
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, 40 if name == "FT8" else 700, dtype=np.uint8).tobytes()
    wave = modulate(name, pack_frame("f.bin", p, 0, 1, len(p), crc32(p)), rate)
    n = 1 << int(np.ceil(np.log2(len(wave) + 64 * n_cap)))
    batch = np.zeros((n_cap, n), np.float32)
    for i in range(n_cap):
        batch[i, 17 * i : 17 * i + len(wave)] = wave
    return batch, len(wave) // _samples_per_bit(96000, baud) - 2


def _fsk_rows(cuda, mode: str, dtype: str, n_cap: int = 3):
    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel.batch import host_shape_batch

    rate = _FSK[mode][0]
    batch, n_sig = _fsk_batch(mode, n_cap)
    old = CONFIG.get("tpu.int16_rows")
    CONFIG.set("tpu.int16_rows", dtype == "int16")
    try:
        shaped = host_shape_batch(batch, mode.split("@")[0], rate, device=cuda)
    finally:
        CONFIG.set("tpu.int16_rows", old)
    return torch.from_numpy(shaped).to(cuda), batch, n_sig


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["FSK1200", "MSK@1000", "MSK@9600", "FT8"])
def test_fsk_tile_kernel_equals_plain(cuda, mode, dtype):
    from audio_modem_radio_tpu_torch.ops.fsk import fsk_dual_pass1

    x, _, n_sig = _fsk_rows(cuda, mode, dtype)
    best, W, spr = fsk_dual_pass1(x, *_FSK[mode][1:], 96000)
    before = tk.fsk_tile_bits_batch.launches
    got = tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=x.shape[1], spr=spr)
    ref = tk.fsk_tile_bits_batch_plain(x, W, best, spr)
    torch.cuda.synchronize()
    assert tk.fsk_tile_bits_batch.launches == before + 1
    assert torch.equal(got[:, :n_sig], ref[:, :n_sig])


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["FSK1200", "MSK@1000", "FT8"])
def test_fsk_tile_kernel_ragged_tile_all_offsets(cuda, mode, dtype):
    """K7 at spr 16, 12 and 1 on overlapped rows cut from a tiled wave, one
    capture per offset k led by k's step, on a row count that leaves the
    last tile ragged (3 full 32-row tiles and 5 rows; FT8's wider rows
    take tiles of fewer rows): bits equal to the plain version's and to
    K13's on the same samples, and not all one value."""
    from audio_modem_radio_tpu_torch.ops.fsk import _device_tables, _fsk_geometry, _samples_per_bit

    rate, baud, mark, space = _FSK[mode]
    spb = _samples_per_bit(96000, baud)
    spr, row, ov = _fsk_geometry(spb)
    (W,) = _device_tables("dual", spb, baud, mark, space, 96000, 8, cuda)
    r = 3 * 32 + 5
    p = np.random.default_rng(23).integers(0, 256, 40 if mode == "FT8" else 900, dtype=np.uint8).tobytes()
    wave = modulate(mode.split("@")[0], pack_frame("f.bin", p, 0, 1, len(p), crc32(p)), rate)
    n = r * row + ov
    wave = np.tile(wave, -(-(n + spb) // len(wave)))
    flat = np.stack([wave[spb - spb // 8 * k : spb - spb // 8 * k + n] for k in range(8)])
    if dtype == "int16":
        flat = np.round(flat * 10000).astype(np.int16)
    over = np.stack([flat[:, j * row : j * row + row + ov] for j in range(r)], axis=1)
    x = torch.from_numpy(np.ascontiguousarray(over)).to(cuda)
    best = torch.arange(8, dtype=torch.int32, device=cuda)
    before = tk.fsk_tile_bits_batch.launches
    got = tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=r, spr=spr)
    ref = tk.fsk_tile_bits_batch_plain(x, W, best, spr)
    rows = torch.from_numpy(np.ascontiguousarray(flat[:, : r * row])).to(cuda).reshape(8, r, row)
    torch.cuda.synchronize()
    assert tk.fsk_tile_bits_batch.launches == before + 1
    assert torch.equal(got, ref)
    assert 0.2 < got.float().mean() < 0.8
    # K13 reads row j's overlap from row j+1 and zeros after the last row:
    # equal to K7 wherever the overlapped rows hold the same samples.
    flat_bits = tk.fsk_project_bits_batch(rows, W, best, rows_per_capture=r, spr=spr)
    over_zero = x.clone()
    over_zero[:, -1, row:] = 0
    tile_zero = tk.fsk_tile_bits_batch(over_zero, W, best, rows_per_capture=r, spr=spr)
    torch.cuda.synchronize()
    assert torch.equal(flat_bits, tile_zero)


def test_fsk_tile_kernel_rejects_a_misaligned_view(cuda):
    """K7 stages 16-byte chunks of each row: a view that starts 2 bytes past
    a 16-byte boundary is refused by the wrapper, never launched."""
    from audio_modem_radio_tpu_torch.ops.fsk import _device_tables

    (W,) = _device_tables("dual", 80, 1200.0, 1200.0, 2200.0, 96000, 8, cuda)
    flat = torch.zeros(2 * 40 * 1408 + 1, dtype=torch.int16, device=cuda)
    x = flat[1:].view(2, 40, 1408)
    best = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = tk.fsk_tile_bits_batch.launches
    with pytest.raises(ValueError, match="16-byte"):
        tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=40, spr=16)
    assert tk.fsk_tile_bits_batch.launches == before


def test_fsk_project_kernel_equals_plain_and_tile(cuda):
    from audio_modem_radio_tpu_torch.ops.fsk import fsk_demod_bits_batch, fsk_dual_pass1

    x, batch, n_sig = _fsk_rows(cuda, "FSK1200", "float32")
    flat = torch.from_numpy(batch).to(cuda)
    before = tk.fsk_project_bits_batch.launches
    bits_flat = fsk_demod_bits_batch(flat, 1200.0, 1200.0, 2200.0, 96000)
    assert tk.fsk_project_bits_batch.launches == before + 1
    assert bits_flat.shape == (3, batch.shape[1] // 80)
    best, W, spr = fsk_dual_pass1(x, 1200.0, 1200.0, 2200.0, 96000)
    rows = torch.nn.functional.pad(flat, (0, x.shape[1] * 1280 - flat.shape[1])).reshape(3, -1, 1280)
    got = tk.fsk_project_bits_batch(rows, W, best, rows_per_capture=rows.shape[1], spr=spr)
    ref = tk.fsk_project_bits_batch_plain(rows, W, best, spr)
    tile = tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=x.shape[1], spr=spr)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :n_sig], ref[:, :n_sig])
    assert torch.equal(got[:, :n_sig], tile[:, :n_sig])


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_fsk_project_kernel_ragged_tile_and_zero_tail(cuda, dtype):
    """K13 on flat FSK1200 rows at all 8 offsets: 16 * 20 + 5 rows (the
    last block stages 5), a tiled wave up to the capture's end with
    capture k led by offset k's step, so offsets 1-7, whose bands run
    past the last row, read the zeros there. Bits equal to the plain
    version's and to K7's on the same samples overlapped with a zero tail."""
    from audio_modem_radio_tpu_torch.ops.fsk import _device_tables

    spb, spr, row = 80, 16, 1280
    (W,) = _device_tables("dual", spb, 1200.0, 1200.0, 2200.0, 96000, 8, cuda)
    first, _, span = tk._band_tables(W, 4)
    assert int((first[:, -1] + span).max()) > row  # a band that reaches into the next row
    r = 16 * 20 + 5
    p = np.random.default_rng(17).integers(0, 256, 900, dtype=np.uint8).tobytes()
    wave = np.tile(modulate("FSK1200", pack_frame("f.bin", p, 0, 1, len(p), crc32(p)), 1200), 4)
    x = np.stack([wave[100 - 10 * k : 100 - 10 * k + r * row] for k in range(8)]).reshape(8, r, row)
    if dtype == "int16":
        x = np.round(x * 10000).astype(np.int16)
    rows = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    best = torch.arange(8, dtype=torch.int32, device=cuda)
    got = tk.fsk_project_bits_batch(rows, W, best, rows_per_capture=r, spr=spr)
    ref = tk.fsk_project_bits_batch_plain(rows, W, best, spr)
    ov = W.shape[1] - row
    nxt = torch.cat([rows[:, 1:, :ov], torch.zeros_like(rows[:, :1, :ov])], dim=1)
    tile = tk.fsk_tile_bits_batch(torch.cat([rows, nxt], dim=2).contiguous(), W, best, rows_per_capture=r, spr=spr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, tile)
    assert 0.3 < got.float().mean() < 0.7


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["FSK9600", "FSK19200"])
def test_fsk_fir_kernels_equal_plain(cuda, mode, dtype):
    """K8's sums and K9's margins within 1e-4 of the largest plain value,
    and the same bits, over the span every capture's signal covers."""
    from audio_modem_radio_tpu_torch.ops import fsk as tf

    x, _, n_sig = _fsk_rows(cuda, mode, dtype)
    args = (*_FSK[mode][1:], 96000)
    if mode == "FSK9600":
        best, plan, Wf, Wb, _ = tf.fsk_disc_pass1(x, *args)
        kernel, plain, W2 = tk.fsk_disc_sums_batch, tk.fsk_disc_sums_batch_plain, Wb
    else:
        best, plan, Wf, Wq = tf.fsk_quad_pass1(x, *args)
        kernel, plain, W2 = tk.fsk_quad_margin_batch, tk.fsk_quad_margin_batch_plain, Wq
    before = kernel.launches
    got = kernel(x, Wf, W2, best, rows_per_capture=x.shape[1], nrow2=plan["nrow2"], row2=plan["row2"],
                 ov2=plan["ov2"], spr2=plan["spr2"])
    extra = () if mode == "FSK9600" else (plan["spr2"],)
    ref = plain(x, Wf, W2, best, plan["row2"], plan["ov2"], *extra)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got, ref = (got, ref) if mode == "FSK9600" else ((got,), (ref,))
    for g, p in zip(got, ref):
        g, p = g[:, :n_sig], p[:, :n_sig]
        assert float((g - p).abs().max()) <= 1e-4 * float(p.abs().max())
    bits = (tf.fsk_disc_bits_rows_batch if mode == "FSK9600" else tf.fsk_quad_bits_rows_batch)(x, *args)
    assert bits.shape[1] >= n_sig


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("dec", [1, 4])
@pytest.mark.parametrize("kernel", ["fsk_disc_sums_batch", "fsk_quad_margin_batch"])
def test_fsk_fir_kernels_ragged_last_tile(cuda, kernel, dec, dtype):
    """K8 and K9 on 53 boxcar rows (265 FIR rows: 16 passes of 16 and one of 9,
    which reads past the capture's last row) and on 3 (less than one pass), at both
    decimations (each kernel's own templates over the FIR of the mode with
    that decimation) and both input types: within 1e-4 of the largest plain
    value, no NaN."""
    from audio_modem_radio_tpu_torch.ops import fsk as tf

    def tables(kind, mode):
        baud, mark, space = _FSK[mode][1:]
        return tf._device_tables(kind, tf._samples_per_bit(96000, baud), float(baud), float(mark), float(space),
                                 96000, 8, cuda)

    disc, quad = tables("disc", "FSK9600"), tables("quad", "FSK19200")
    plan, W2 = (disc[0], disc[2]) if kernel == "fsk_disc_sums_batch" else (quad[0], quad[2])
    Wf = {d[0]["dec"]: d[1] for d in (disc, quad)}[dec]
    assert disc[0]["row2"] == quad[0]["row2"] and disc[0]["ov2"] == quad[0]["ov2"]
    row2, ov2, spr2 = plan["row2"], plan["ov2"], plan["spr2"]
    best = torch.tensor([0, 3, 7], dtype=torch.int32, device=cuda)
    for r2 in (53, 3):
        r, run = r2 * row2 // 128, 128 * dec
        g = torch.Generator(device=cuda).manual_seed(r2)
        flat = torch.randint(-20000, 20000, (3, r * run + 128), generator=g, device=cuda, dtype=torch.int32)
        flat = flat.to(torch.int16) if dtype == "int16" else flat.float() / 20000.0
        x = flat.as_strided((3, r, run + 128), (flat.stride(0), run, 1)).contiguous()
        kw = dict(rows_per_capture=r, nrow2=1, row2=row2, ov2=ov2, spr2=spr2)
        if kernel == "fsk_disc_sums_batch":
            got = tk.fsk_disc_sums_batch(x, Wf, W2, best, **kw)
            ref = tk.fsk_disc_sums_batch_plain(x, Wf, W2, best, row2, ov2)
        else:
            got = (tk.fsk_quad_margin_batch(x, Wf, W2, best, **kw),)
            ref = (tk.fsk_quad_margin_batch_plain(x, Wf, W2, best, row2, ov2, spr2),)
        torch.cuda.synchronize()
        for gt, p in zip(got, ref):
            assert gt.shape == p.shape == (3, r2 * spr2) and not bool(torch.isnan(gt).any())
            assert float((gt - p).abs().max()) <= 1e-4 * float(p.abs().max())


@pytest.mark.parametrize("mode", ["FSK1200", "FSK9600", "FSK19200", "MSK", "FT8"])
def test_fsk_decode_sample_batch_on_card(cuda, mode):
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    key = {"MSK": "MSK@9600"}.get(mode, mode)
    rate = _FSK[key][0]
    rng = np.random.default_rng(2)
    p = rng.integers(0, 256, 30 if mode == "FT8" else 900, dtype=np.uint8).tobytes()
    wave = modulate(mode, pack_frame("d.bin", p, 0, 1, len(p), crc32(p)), rate)
    n = 1 << int(np.ceil(np.log2(len(wave) + 300)))
    batch = np.zeros((3, n), np.float32)
    batch[0, : len(wave)] = wave
    batch[1, 211 : 211 + len(wave)] = wave
    batch[2] = rng.normal(0, 0.3, n)
    want = {"FSK1200": "fsk_tile_bits_batch", "MSK": "fsk_tile_bits_batch", "FT8": "fsk_tile_bits_batch",
            "FSK9600": "fsk_disc_sums_batch", "FSK19200": "fsk_quad_margin_batch"}[mode]
    tk.reset_launch_counts()
    raws = decode_sample_batch(batch, mode, rate, device=cuda)
    counts = tk.launch_counts()
    assert {k for k, v in counts.items() if v > 0} == {want}
    assert [[f.data for f in parse_frames(r)] for r in raws] == [[p], [p], []]


# --- K11 and K12: projection + differential ---------------------------------------

def _diff_close(got, ref, n_sig):
    """Max abs difference over each capture's first ``n_sig`` entries, against
    1e-5 of the plain stream's RMS there (the projection's summation order
    differs; nothing else does)."""
    got, ref = [g.reshape(g.shape[0], -1)[:, :n_sig] for g in got], [p.reshape(p.shape[0], -1)[:, :n_sig] for p in ref]
    rms = torch.sqrt(torch.mean(ref[0] ** 2 + ref[1] ** 2))
    err = max(float((g - p).abs().max()) for g, p in zip(got, ref))
    return err, float(rms)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["QPSK", "8PSK"])
def test_project_diff_batch_kernel_equals_plain(cuda, mode, dtype):
    x, n_sig = _rows(3, 1 << 19, dtype, mode)
    x = torch.from_numpy(x).to(cuda)
    b, r, _ = x.shape
    carrier = _CARRIER[mode]
    _, _, best, _theta = _batch_pass1(None, x, b, r * 128, 10, carrier, 96000, 8, r,
                                      n_psk=8 if mode == "8PSK" else 4)
    W8, _, _ = _device_tables(10, carrier, 96000, 8, x.device)
    before = tk.psk_project_diff_batch.launches
    got = tk.psk_project_diff_batch(x, W8, best, rows_per_capture=r)
    ref = tk.psk_project_diff_batch_plain(x, W8, best)
    torch.cuda.synchronize()
    assert tk.psk_project_diff_batch.launches == before + 1
    assert got[0].shape == (b, r, 128) and got[0].dtype == torch.float32
    err, rms = _diff_close(got, ref, n_sig)
    assert err <= 1e-5 * rms, (err, rms)
    # Clean decisions (Gray dibits, or π/4 sectors) from either stream are equal.
    decide = tk.psk8_sector_stream if mode == "8PSK" else (lambda a, c: torch.stack(tk._decide(a, c, 4)))
    assert torch.equal(decide(*[g.reshape(b, -1)[:, :n_sig] for g in got]),
                       decide(*[p[:, :n_sig] for p in ref]))


def test_project_diff_kernel_equals_plain(cuda):
    x, n_sig = _rows(1, 1 << 19, "float32")
    x2d = torch.from_numpy(x[0]).to(cuda)
    r = x2d.shape[0]
    W8, _, _ = _device_tables(10, 3000.0, 96000, 8, cuda)
    before = tk.psk_project_diff.launches
    got = tk.psk_project_diff(x2d, W8[3], block_rows=64)
    ref = tk.psk_project_diff_plain(x2d, W8[3])
    torch.cuda.synchronize()
    assert tk.psk_project_diff.launches == before + 1
    assert got[0].shape == (r, 128)
    err, rms = _diff_close([g[None] for g in got], [p[None] for p in ref], n_sig)
    assert err <= 1e-5 * rms, (err, rms)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("spsym", [3, 8, 10, 32])
def test_project_diff_kernel_any_spsym_ragged_tile(cuda, spsym, dtype):
    """K12 at the specialised spsym (8, 10) and the generic ones (3, 32) on
    258 rows of 3 random captures (a last tile the rows do not fill for
    either sample type), and K11 on one capture's first 256 rows: within
    1e-5 of the plain stream's RMS over every entry, the last of each
    capture 0; the kernel writes only inside its outputs."""
    g = torch.Generator(device=cuda).manual_seed(spsym * 13)
    b, r = 3, 258
    x = torch.randn((b, r, 128 * spsym), generator=g, device=cuda) * 0.3
    if dtype == "int16":
        x = (x.clamp(-1, 1) * 32767.0).round().to(torch.int16)
    W8 = torch.from_numpy(tpsk._blocked_templates(spsym, 12000.0, 96000, 8).copy()).to(cuda)
    best = torch.tensor([0, 3, 7], dtype=torch.int32, device=cuda)
    got = tk.psk_project_diff_batch(x, W8, best, rows_per_capture=r, block_rows=2)
    ref = tk.psk_project_diff_batch_plain(x, W8, best)
    torch.cuda.synchronize()
    err, rms = _diff_close(got, ref, r * 128)
    assert err <= 1e-5 * rms, (err, rms)
    assert all(float(d[i, -1, -1]) == 0.0 for d in got for i in range(b))
    got1 = tk.psk_project_diff(x[1, :256], W8[3], block_rows=8)
    ref1 = tk.psk_project_diff_plain(x[1, :256], W8[3])
    torch.cuda.synchronize()
    err, rms = _diff_close([d[None] for d in got1], [d[None] for d in ref1], 256 * 128)
    assert err <= 1e-5 * rms, (err, rms)


def test_project_diff_kernel_alternating_shared_memory_sizes(cuda):
    """K12's generic walk at spsym 32 (about 131 KB of shared memory a
    block), then 3 (a few KB), then 32 and 3 again: the kernel's shared
    memory limit, a property of the function, must still fit each launch
    after a smaller one; each call within 1e-5 of the plain stream's RMS."""
    g = torch.Generator(device=cuda).manual_seed(17)
    best = torch.tensor([1, 6], dtype=torch.int32, device=cuda)
    for spsym in (32, 3, 32, 3):
        x = (torch.randn((2, 4, 128 * spsym), generator=g, device=cuda).clamp(-1, 1) * 32767).round().to(torch.int16)
        W8 = torch.from_numpy(tpsk._blocked_templates(spsym, 12000.0, 96000, 8).copy()).to(cuda)
        got = tk.psk_project_diff_batch(x, W8, best, rows_per_capture=4, block_rows=2)
        ref = tk.psk_project_diff_batch_plain(x, W8, best)
        torch.cuda.synchronize()
        err, rms = _diff_close(got, ref, 4 * 128)
        assert err <= 1e-5 * rms, (spsym, err, rms)


def test_project_diff_kernel_more_captures_than_blocks(cuda):
    """K12 on 2,048 captures of 2 rows (one tile each, more than one wave of
    blocks): within 1e-5 of the plain stream's RMS, each capture's last
    entry 0."""
    x, n_sig = _rows(8, 1 << 19, "int16", "8PSK")
    x = torch.from_numpy(x).to(cuda)
    b, r, row = x.shape
    _, _, best, _ = _batch_pass1(None, x, b, r * 128, 10, 12000.0, 96000, 8, r, n_psk=8)
    W8, _, _ = _device_tables(10, 12000.0, 96000, 8, x.device)
    xs = x.reshape(-1, 2, row)
    bs = best[torch.arange(xs.shape[0], device=cuda) // (r // 2)].contiguous()
    got = tk.psk_project_diff_batch(xs, W8, bs, rows_per_capture=2, block_rows=2)
    ref = tk.psk_project_diff_batch_plain(xs, W8, bs)
    torch.cuda.synchronize()
    assert xs.shape[0] == 2048
    err, rms = _diff_close(got, ref, 256)
    assert err <= 1e-5 * rms, (err, rms)
    assert bool((got[0][:, -1, -1] == 0).all())


def test_project_diff_kernels_reject_a_misaligned_view(cuda):
    r = 256
    flat = torch.zeros(3 * r * 1280 + 1, dtype=torch.int16, device=cuda)
    W8, _, _ = _device_tables(10, 12000.0, 96000, 8, cuda)
    best = torch.zeros(3, dtype=torch.int32, device=cuda)
    before = (tk.psk_project_diff_batch.launches, tk.psk_project_diff.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tk.psk_project_diff_batch(flat[1:].view(3, r, 1280), W8, best, rows_per_capture=r)
    with pytest.raises(ValueError, match="16-byte"):
        tk.psk_project_diff(flat[1 : 1 + r * 1280].view(r, 1280), W8[0])
    assert (tk.psk_project_diff_batch.launches, tk.psk_project_diff.launches) == before


def test_single_capture_decode_on_card(cuda):
    """modem.demodulate on the card: K11 launches once per clean capture and
    the frame decodes."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.modem import demodulate

    p = bytes(range(256)) * 4
    wave = modulate("QPSK", pack_frame("s.bin", p, 0, 1, len(p), crc32(p)), 9600)
    x = np.zeros(1 << 17, np.float32)
    x[33 : 33 + len(wave)] = wave
    tk.reset_launch_counts()
    raw = demodulate("QPSK", x, 9600, device="cuda")
    counts = tk.launch_counts()
    assert counts["psk_project_diff"] == 1 and sum(counts.values()) == 1
    assert [f.data for f in parse_frames(raw)] == [p]


# --- K10: NEURAL chip extraction + codebook argmax ---------------------------------

def _neural_rows(n_cap: int, n: int, dtype: str):
    """(n_cap * r3, 128) rows of NEURAL@9600 captures at different leads
    (the last one all zeros), float32 or int16 at scale 32768."""
    from audio_modem_radio_tpu_torch.ops.neural import neural_mode_modulate

    rng = np.random.default_rng(9)
    x = np.zeros((n_cap, n), np.float32)
    for i in range(n_cap - 1):
        p = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        wave = neural_mode_modulate(pack_frame("n.bin", p, 0, 1, len(p), crc32(p)), 9600)
        x[i, 37 * i : 37 * i + len(wave)] = wave[: n - 37 * i]
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return x.reshape(-1, 128)


@pytest.mark.parametrize("rows", [512, 300])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_neural_extract_kernel_equals_plain(cuda, dtype, rows):
    """Every symbol equal to the plain version at several offsets s (one
    taken mod 128) and phasors, 512 rows and a row count that is not a
    multiple of 512; the all-zero capture decodes to 0."""
    from audio_modem_radio_tpu_torch.ops.neural import _codebook

    x = torch.from_numpy(_neural_rows(4, rows * 128, dtype)).to(cuda)
    cb = torch.from_numpy(_codebook()).to(cuda)
    ang = torch.tensor([0.0, 2.1, -0.7, 3.0], device=cuda)
    ph = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    s = torch.tensor([0, 37, 74 + 128, 127], dtype=torch.int32, device=cuda)
    before = tk.neural_extract_batch.launches
    got = tk.neural_extract_batch(x, cb, ph, s, rows_per_capture=rows)
    ref = tk.neural_extract_batch_plain(x, cb, ph, s, rows)
    torch.cuda.synchronize()
    assert tk.neural_extract_batch.launches == before + 1
    assert got.shape == (4, rows * 8) and got.dtype == torch.uint8
    assert torch.equal(got, ref)
    assert not got[3].any()


def test_neural_extract_kernel_follows_a_codebook_change(cuda):
    """Three calls back to back with codebooks A, B, A (B is A with its
    codewords reversed and one column negated): each equals the plain
    version on its own codebook, so no call reads an earlier codebook."""
    from audio_modem_radio_tpu_torch.ops.neural import _codebook

    rows = 300
    x = torch.from_numpy(_neural_rows(4, rows * 128, "float32")).to(cuda)
    cb_a = torch.from_numpy(_codebook()).to(cuda)
    cb_b = cb_a.flip(0).contiguous()
    cb_b[:, 5] = -cb_b[:, 5]
    ph = torch.tensor([[1.0, 0.0], [0.6, 0.8], [-0.8, 0.6], [0.0, 1.0]], device=cuda)
    s = torch.tensor([0, 19, 64, 127], dtype=torch.int32, device=cuda)
    outs = [tk.neural_extract_batch(x, cb, ph, s, rows_per_capture=rows) for cb in (cb_a, cb_b, cb_a)]
    refs = [tk.neural_extract_batch_plain(x, cb, ph, s, rows) for cb in (cb_a, cb_b, cb_a)]
    torch.cuda.synchronize()
    for got, ref in zip(outs, refs):
        assert torch.equal(got, ref)
    assert not torch.equal(outs[0][:3], outs[1][:3])


def test_neural_extract_kernel_first_maximum_wins_a_tie(cuda):
    """A codebook in which codewords 9, 77 and 200 repeat codeword 3 and
    codeword 250 repeats codeword 40: every symbol sent as 3, 9, 77 or 200
    decodes to 3, as 40 or 250 to 40, in every slot of a 257-row capture,
    with the plain version agreeing."""
    from audio_modem_radio_tpu_torch.ops import neural as tn

    cb = tn._codebook()
    tied = cb.copy()
    tied[[9, 77, 200]] = cb[3]
    tied[250] = cb[40]
    rows = 257
    rng = np.random.default_rng(21)
    sent = rng.choice([3, 9, 77, 200, 40, 250], rows * 8)
    xt = torch.from_numpy(tn._synth(sent, tied, 2).reshape(rows, 128)).to(cuda)
    cbt = torch.from_numpy(tied).to(cuda)
    ph = torch.tensor([[1.0, 0.0]], device=cuda)
    s = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = tk.neural_extract_batch(xt, cbt, ph, s, rows_per_capture=rows)
    ref = tk.neural_extract_batch_plain(xt, cbt, ph, s, rows)
    torch.cuda.synchronize()
    want = np.where(np.isin(sent, [3, 9, 77, 200]), 3, 40)
    assert np.array_equal(got.cpu().numpy()[0], want)
    assert torch.equal(got, ref)


def test_neural_decode_sample_batch_on_card(cuda):
    """NEURAL@9600 round trip on the card: K10 launches once and nothing
    else; NEURAL@3000 (chip length 4) launches no kernel."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    rng = np.random.default_rng(3)
    for rate, want in ((9600, {"neural_extract_batch"}), (3000, set())):
        p = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        wave = modulate("NEURAL", pack_frame("n.bin", p, 0, 1, len(p), crc32(p)), rate)
        batch = np.zeros((3, 1 << 18), np.float32)
        batch[0, : len(wave)] = wave
        batch[1, 555 : 555 + len(wave)] = -wave
        batch[2] = rng.normal(0, 0.3, 1 << 18)
        tk.reset_launch_counts()
        raws = decode_sample_batch(batch, "NEURAL", rate, device=cuda)
        counts = tk.launch_counts()
        assert {k for k, v in counts.items() if v > 0} == want and sum(counts.values()) == len(want)
        assert [[f.data for f in parse_frames(r)] for r in raws] == [[p], [p], []]


# --- the MLSE Viterbi of the single-capture FSK receiver ------------------------------

def _viterbi_inputs(cuda, n_states: int, nb: int, L: int, seed: int):
    """Correlations of a real capture's scale, noisy, and the trellis tables
    of ``n_states`` states, on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.0, 3.0, (nb, 4, L)).astype(np.float32)).to(cuda)
    ph = 2 * np.pi * np.arange(n_states) / n_states
    cos_t = torch.from_numpy(np.cos(ph).astype(np.float32)).to(cuda)
    sin_t = torch.from_numpy(np.sin(ph).astype(np.float32)).to(cuda)
    aec = torch.from_numpy(rng.uniform(1.0, 3.0, (nb, 2, n_states)).astype(np.float32)).to(cuda)
    return x, cos_t, sin_t, aec


@pytest.mark.parametrize("n_states,adv", [(8, (1, 2)), (48, (6, 11)), (96, (11, 22))])
@pytest.mark.parametrize("nb,L", [(1, 37), (3, 10240), (5, 1000)])
def test_mlse_viterbi_kernel_equals_plain(cuda, n_states, adv, nb, L):
    """The Viterbi kernel's bits equal the plain version's bit for bit at 8,
    48 and 96 states (one warp lane holding one, two or three states), on
    a ragged short block, full-length blocks and a traceback stage that
    ends inside a block; one launch a call."""
    x, cos_t, sin_t, aec = _viterbi_inputs(cuda, n_states, nb, L, n_states + L)
    before = tk.mlse_viterbi_blocks.launches
    got = tk.mlse_viterbi_blocks(x, cos_t, sin_t, aec, *adv)
    ref = tk.mlse_viterbi_blocks_plain(x, cos_t, sin_t, aec, *adv)
    torch.cuda.synchronize()
    assert tk.mlse_viterbi_blocks.launches == before + 1
    assert got.dtype == torch.uint8 and torch.equal(got, ref)


def _viterbi_case(cuda, kind: str, n_states: int, nb: int, L: int, seed: int):
    """Inputs where the kernel's maximum, normalisation and selection meet
    exact ties and exact zeros: ``zero`` all-zero correlations (the
    zero-padded overlap of a capture's first and last block); ``zero_edges``
    the first block's first third and the last block's last third zero;
    ``equal_rows`` equal ``aec`` rows and equal mark and space correlations;
    ``tie`` zero correlations and one energy for every state and row, so
    every cand1 == cand0 and every normalised metric is 0 at every step;
    ``integer`` correlations and tables in {-1, 0, 1} and energies in {0,
    1}, so sums tie and zeros (and -0 products) occur all through."""
    x, cos_t, sin_t, aec = (t.cpu().numpy() for t in _viterbi_inputs("cpu", n_states, nb, L, seed))
    rng = np.random.default_rng(seed + 1)
    if kind == "zero":
        x[:] = 0
    elif kind == "zero_edges":
        x[0, :, : L // 3] = 0
        x[-1, :, -(L // 3) :] = 0
    elif kind == "equal_rows":
        aec[:, 1] = aec[:, 0]
        x[:, 2:] = x[:, :2]
    elif kind == "tie":
        x[:] = 0
        aec[:] = 1.5
    elif kind == "integer":
        x = rng.integers(-1, 2, x.shape).astype(np.float32)
        cos_t = rng.integers(-1, 2, n_states).astype(np.float32)
        sin_t = rng.integers(-1, 2, n_states).astype(np.float32)
        aec = rng.integers(0, 2, aec.shape).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (x, cos_t, sin_t, aec))


_VITERBI_ADV = {8: (1, 2), 48: (6, 11), 96: (11, 22)}


@pytest.mark.parametrize("kind", ["zero", "zero_edges", "equal_rows", "tie", "integer"])
@pytest.mark.parametrize("n_states", [8, 48, 96])
def test_mlse_viterbi_kernel_ties_and_zeros(cuda, n_states, kind):
    """Bitwise equal to the plain version where the REDUX maximum, the
    normalisation at the receiver and fmaxf's selection meet exact ties and
    zeros, on full-length blocks and a ragged last stage."""
    for nb, L in ((3, 10240), (2, 1000)):
        args = _viterbi_case(cuda, kind, n_states, nb, L, n_states + L)
        got = tk.mlse_viterbi_blocks(*args, *_VITERBI_ADV[n_states])
        ref = tk.mlse_viterbi_blocks_plain(*args, *_VITERBI_ADV[n_states])
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (nb, L, int((got != ref).sum()))


@pytest.mark.parametrize("kind", ["noise", "zero_edges"])
@pytest.mark.parametrize("n_states", [8, 48, 96])
def test_mlse_viterbi_kernel_large_launch(cuda, n_states, kind):
    """One launch of 1,640 blocks (a batch of eight 2^24-sample captures
    under CONFIG ``modem.batch_mlse``: three and four warps a scheduler),
    bitwise equal to the plain version; short blocks keep the plain loop
    quick."""
    args = _viterbi_case(cuda, kind, n_states, 1640, 300, n_states) if kind != "noise" else \
        _viterbi_inputs(cuda, n_states, 1640, 300, n_states)
    before = tk.mlse_viterbi_blocks.launches
    got = tk.mlse_viterbi_blocks(*args, *_VITERBI_ADV[n_states])
    ref = tk.mlse_viterbi_blocks_plain(*args, *_VITERBI_ADV[n_states])
    torch.cuda.synchronize()
    assert tk.mlse_viterbi_blocks.launches == before + 1
    assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("n_states,adv", [
    (2, (0, 1)), (32, (31, 0)), (33, (1, 32)), (35, (4, 9)), (64, (3, 60)), (65, (64, 2)), (75, (5, 11)),
    (80, (7, 13)), (96, (10, 33)),
])
@pytest.mark.parametrize("kind", ["noise", "integer"])
def test_mlse_viterbi_kernel_state_layouts(cuda, n_states, adv, kind):
    """Every lane layout of the kernel: K = 1, 2 or 3 states a lane (lane l
    holding states l + 32 j), every slot live (32, 64, 96) or lanes whose
    last slot is dead and must never win the maximum nor set a bit (2, 33,
    35, 65, 75, 80), with advances that wrap across the slots; bitwise
    equal to the plain version."""
    args = _viterbi_case(cuda, kind, n_states, 3, 2000, 7) if kind != "noise" else \
        _viterbi_inputs(cuda, n_states, 3, 2000, 7)
    got = tk.mlse_viterbi_blocks(*args, *adv)
    ref = tk.mlse_viterbi_blocks_plain(*args, *adv)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("L", [1, 31, 32, 33, 64, 95, 1023, 1024, 1025, 10257])
@pytest.mark.parametrize("n_states", [8, 48, 96])
def test_mlse_viterbi_kernel_traceback_segments(cuda, n_states, L):
    """The traceback's paths: one stage of 32 steps (lane 31 alone, from the
    true final state), fewer stages than lanes (empty segments), a ragged
    last stage, and many stages a lane, where phase B walks each segment
    until it meets the guessed path; bitwise equal to the plain version."""
    args = _viterbi_inputs(cuda, n_states, 2, L, L)
    got = tk.mlse_viterbi_blocks(*args, *_VITERBI_ADV[n_states])
    ref = tk.mlse_viterbi_blocks_plain(*args, *_VITERBI_ADV[n_states])
    torch.cuda.synchronize()
    assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("mark,space",[(1200.0, 2200.0), (1100.0, 2200.0), (1200.0, 2400.0)])
def test_fsk_demod_bits_mlse_on_card_equals_cpu(cuda, mark, space):
    """``fsk_demod_bits`` with MLSE on the card (the kernel, 48, 96 and 8
    states) against the same capture on the CPU (the plain Viterbi): the
    bits over the signal are equal."""
    from audio_modem_radio_tpu_torch.ops import fsk as tfsk

    rng = np.random.default_rng(7)
    wave = tfsk.fsk_modulate(rng.integers(0, 256, 2600, dtype=np.uint8).tobytes(), 9600, mark, space)
    x = np.zeros(1 << 18, np.float32)
    x[97 : 97 + len(wave)] = wave
    n_sig = (97 + len(wave)) // 10
    tk.reset_launch_counts()
    got = tfsk.fsk_demod_bits(torch.from_numpy(x).to(cuda), 9600.0, mark, space, 96000)[0].cpu().numpy()
    assert tk.launch_counts()["mlse_viterbi_blocks"] == 1
    ref = tfsk.fsk_demod_bits(torch.from_numpy(x), 9600.0, mark, space, 96000)[0].numpy()
    assert np.array_equal(got[:n_sig], ref[:n_sig])


def _decode_batch_on(device, batch, mode, rate, **config):
    """``decode_sample_batch`` on ``device`` under the CONFIG values in
    ``config`` (dotted keys with ``__`` for ``.``), restored after."""
    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    keys = {k.replace("__", "."): v for k, v in config.items()}
    old = {k: CONFIG.get(k) for k in keys}
    try:
        for k, v in keys.items():
            CONFIG.set(k, v)
        return decode_sample_batch(batch, mode, rate, device=device)
    finally:
        for k, v in old.items():
            CONFIG.set(k, v)


@pytest.mark.parametrize("mode", ["FSK1200", "MSK@9600"])
def test_fsk_dual_rows_under_xla_launch_k7(cuda, mode):
    """Under CONFIG ``tpu.demod_backend = "xla"`` dual-tone captures arrive
    as unpadded float32 rows and still go through K7, once for the batch;
    the bytes equal the CPU's."""
    from audio_modem_radio_tpu_torch.framing import parse_frames

    batch, _ = _fsk_batch(mode)
    name, rate = mode.split("@")[0], _FSK[mode][0]
    tk.reset_launch_counts()
    got = _decode_batch_on(cuda, batch, name, rate, tpu__demod_backend="xla")
    counts = tk.launch_counts()
    assert counts["fsk_tile_bits_batch"] == 1 and sum(counts.values()) == 1, counts
    ref = _decode_batch_on("cpu", batch, name, rate, tpu__demod_backend="xla")
    assert got == ref and all(parse_frames(r) for r in got)


def test_batch_mlse_one_viterbi_launch(cuda):
    """Under CONFIG ``modem.batch_mlse`` every FSK9600 capture's MLSE blocks
    share one Viterbi launch (per-capture energy rows), and the bytes equal
    the CPU's plain Viterbi."""
    from audio_modem_radio_tpu_torch.framing import parse_frames

    batch, _ = _fsk_batch("FSK9600")
    batch = np.pad(batch, ((0, 0), (0, (1 << 18) - batch.shape[1])))  # 26,214 bits: 4 blocks a capture
    tk.reset_launch_counts()
    got = _decode_batch_on(cuda, batch, "FSK9600", 9600, modem__batch_mlse=True)
    counts = tk.launch_counts()
    assert counts["mlse_viterbi_blocks"] == 1 and sum(counts.values()) == 1, counts
    ref = _decode_batch_on("cpu", batch, "FSK9600", 9600, modem__batch_mlse=True)
    assert got == ref and all(parse_frames(r) for r in got)


# --- the convolutional code's Viterbi decoder (fec_viterbi.cu) -------------------

def _fec_pairs(kind: str, nb: int, L: int, seed: int) -> np.ndarray:
    """(nb, L, 2) float32 pairs: ``hard`` random bits; ``coded`` a
    convolutionally coded random stream with 2% of its bits flipped;
    ``soft`` uniform in [0, 1]; ``half`` all 0.5 (every branch metric 1, so
    every candidate ties at every step); ``quarter`` soft values k/4 (sums
    tie often); ``integer`` values in {-1, 0, 1, 2} (integer metrics, ties
    and zeros at almost every step)."""
    from audio_modem_radio_tpu_torch.fec import ConvolutionalEncoder

    rng = np.random.default_rng(seed)
    if kind == "hard":
        return rng.integers(0, 2, (nb, L, 2)).astype(np.float32)
    if kind == "coded":
        pairs = ConvolutionalEncoder().encode_bits(rng.integers(0, 2, max(nb * L - 6, 1)).astype(np.uint8))
        pairs = pairs[: nb * L] ^ (rng.random((nb * L, 2)) < 0.02).astype(np.uint8)
        return pairs.reshape(nb, L, 2).astype(np.float32)
    if kind == "soft":
        return rng.random((nb, L, 2)).astype(np.float32)
    if kind == "half":
        return np.full((nb, L, 2), 0.5, np.float32)
    if kind == "quarter":
        return (rng.integers(0, 5, (nb, L, 2)) / 4).astype(np.float32)
    return rng.integers(-1, 3, (nb, L, 2)).astype(np.float32)


def _fec_check(cuda, pairs: np.ndarray, known_boundaries: bool) -> None:
    x = torch.from_numpy(pairs).to(cuda)
    before = tk.fec_viterbi_blocks.launches
    got = tk.fec_viterbi_blocks(x, known_boundaries)
    ref = tk.fec_viterbi_blocks_plain(x, known_boundaries)
    torch.cuda.synchronize()
    assert tk.fec_viterbi_blocks.launches == before + 1
    assert got.dtype == torch.uint8 and torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("kind", ["hard", "coded", "soft", "half", "quarter", "integer"])
@pytest.mark.parametrize("known_boundaries", [True, False])
@pytest.mark.parametrize("L", [1, 31, 33, 700, 9216])
def test_fec_viterbi_kernel_short_blocks(cuda, kind, known_boundaries, L):
    """One block, as the short path of ``fec.viterbi_decode_bits`` gives it
    (known boundaries: state 0 at both ends; free: zero metrics and the
    first minimum at the end); lengths covering a single step, ragged last
    stages, fewer stages than lanes and the longest short input: bits equal
    to the plain version's."""
    _fec_check(cuda, _fec_pairs(kind, 1, L, L), known_boundaries)


@pytest.mark.parametrize("kind", ["coded", "soft", "half", "integer"])
def test_fec_viterbi_kernel_stream_blocks(cuda, kind):
    """205 blocks of 9,216 steps, the block-parallel call of a stream-FEC
    decode of one 2^24-sample QPSK@9600 capture (zero start, best end)."""
    _fec_check(cuda, _fec_pairs(kind, 205, 9216, 205), False)


@pytest.mark.parametrize("kind", ["half", "integer", "soft"])
def test_fec_viterbi_kernel_stream_blocks_known_boundaries(cuda, kind):
    """205 blocks of 9,216 steps with known boundaries. All 0.5 ties every
    candidate at every step; integer and uniform soft pairs keep the
    traceback's guessed paths apart from the true one for whole stages, so
    its second phase walks many of them."""
    _fec_check(cuda, _fec_pairs(kind, 205, 9216, 206), True)


@pytest.mark.parametrize("kind", ["coded", "soft", "half", "integer"])
@pytest.mark.parametrize("known_boundaries", [True, False])
@pytest.mark.parametrize("L", [5, 200, 993, 1024, 1056, 2017])
def test_fec_viterbi_kernel_segment_layouts(cuda, kind, known_boundaries, L):
    """37 blocks whose stages split over the 32 lanes of the traceback in
    every way: fewer stages than lanes (1 and 7: most lanes hold none), 32
    (one each; 993: the last of one step), 33 (32 x 33 steps: lane 31 holds
    two) and 64 with a ragged last."""
    _fec_check(cuda, _fec_pairs(kind, 37, L, L + 1), known_boundaries)


@pytest.mark.parametrize("kind", ["coded", "soft", "half", "quarter", "integer"])
@pytest.mark.parametrize("nb,L", [(1, 5000), (2000, 200)])
def test_fec_viterbi_kernel_block_counts(cuda, kind, nb, L):
    """One block alone and 2,000 blocks in one launch (several warps a
    scheduler), both boundaries."""
    _fec_check(cuda, _fec_pairs(kind, nb, L, nb), False)
    _fec_check(cuda, _fec_pairs(kind, nb, L, nb + 1), True)


def test_fec_viterbi_decode_bits_on_the_card(cuda):
    """``fec.viterbi_decode_bits`` on the card equals its CPU run (the plain
    version) on short, edge and multi-block inputs, both boundaries; the
    stream-FEC round trip decodes on the card with one launch a phase."""
    from audio_modem_radio_tpu_torch import fec

    rng = np.random.default_rng(3)
    for T in (100, 9216, 9217, 30000):
        p = rng.random((T, 2)).astype(np.float32)
        for kb in (True, False):
            assert np.array_equal(fec.viterbi_decode_bits(p, kb, device=cuda),
                                  fec.viterbi_decode_bits(p, kb, device="cpu")), (T, kb)
    framed = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    before = tk.fec_viterbi_blocks.launches
    assert fec.stream_fec_decode(fec.stream_fec_encode(framed), device=cuda)[: len(framed)] == framed
    assert tk.fec_viterbi_blocks.launches in (before + 1, before + 2)


# --- OFDM, DSSS and Hellschreiber: K2 and K3 on OFDM streams, the batch paths' launches ---

def _ofdm_streams(cuda, mode: str, noise_last: bool = True):
    """The Gray dibit lanes (B, r, 128) of 3 OFDM captures of 2^19 samples at
    odd leads (the last one noise), zero-padded to the 128*256 grain as
    ``demod_pack_batch`` pads them on the card."""
    from audio_modem_radio_tpu_torch.ops.ofdm import ofdm_decision_streams_batch

    rng = np.random.default_rng(11)
    n = 1 << 19
    x = np.zeros((3, n), np.float32)
    for i in range(2):
        p = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        wave = modulate(mode, pack_frame(f"o{i}.bin", p, 0, 1, len(p), crc32(p)), 9600)
        x[i, 13 + 97 * i : 13 + 97 * i + len(wave)] = wave
    x[2] = rng.normal(0, 0.3, n)
    hi, lo = ofdm_decision_streams_batch(torch.from_numpy(x).to(cuda), 9600.0, 12000.0, int(mode[-1]), 96000)
    pad = -hi.shape[1] % (128 * 256)
    pad3 = lambda t: torch.nn.functional.pad(t, (0, pad)).reshape(3, -1, 128)  # noqa: E731
    return pad3(hi), pad3(lo)


@pytest.mark.parametrize("mode", ["OFDM4", "OFDM8"])
def test_rotation_match_and_relabel_pack_kernels_on_ofdm_streams(cuda, mode):
    """K2 (qpsk family) at every tier and K3 at every (ksel, s8) pair on
    OFDM dibit streams: equal to their plain versions."""
    hi, lo = _ofdm_streams(cuda, mode)
    b, r, _ = hi.shape
    conds, _ = tk.rotation_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    for rows in sorted({256, r}):
        first, found = tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2,
                                               rows_scanned=rows)
        ref = tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, rows)
        found_p = ref < min(1 << 30, rows * 128 - 17)
        assert torch.equal(found, found_p)
        assert torch.equal(first, torch.where(found_p, ref, torch.zeros_like(ref)))
    assert bool(found[:2, 0].all())
    i = torch.arange(b, device=cuda)
    for j in range(8):
        s = (2 * first[:, 0] - (2 * first[:, 0]) % 8 + (i + j) % 8).to(torch.int32)
        ksel = ((i + j) % 4).to(torch.int32)
        assert torch.equal(tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r),
                           tk.relabel_pack_batch_plain(hi, lo, s, ksel))


@pytest.mark.parametrize("mode", ["OFDM4", "OFDM8", "DSSS", "HELLSCHREIBER"])
def test_new_batch_paths_launch_only_their_kernels(cuda, mode):
    """``decode_sample_batch`` on the card: OFDM launches K2 and K3 and no
    other hand-written kernel, DSSS and the text mode none; every signal
    capture decodes and noise yields nothing."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.ops.hell import hellschreiber_modulate
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    rng = np.random.default_rng(12)
    n = 1 << 19
    batch = np.zeros((3, n), np.float32)
    batch[2] = rng.normal(0, 0.3, n)
    if mode == "HELLSCHREIBER":
        wave = hellschreiber_modulate("CQ")
        batch[0, : len(wave)] = batch[1, : len(wave)] = wave
        want = [b"CQ", b"CQ", b""]
    else:
        p = rng.integers(0, 256, 300 if mode == "DSSS" else 3000, dtype=np.uint8).tobytes()
        wave = modulate(mode, pack_frame("n.bin", p, 0, 1, len(p), crc32(p)), 9600)
        batch[0, 7 : 7 + len(wave)] = wave
        batch[1, 1000 : 1000 + len(wave)] = wave
    tk.reset_launch_counts()
    raws = decode_sample_batch(batch, mode, 9600, device=cuda)
    launched = {k for k, v in tk.launch_counts().items() if v > 0}
    assert launched == ({"rotation_match_batch", "relabel_pack_batch"} if mode.startswith("OFDM") else set())
    if mode == "HELLSCHREIBER":
        assert raws == want
    else:
        assert [[f.data for f in parse_frames(r)] for r in raws] == [[p], [p], []]


# --- scale-out and training on a virtual mesh of the card --------------------------

def _qpsk_batch_late(n: int):
    """3 QPSK captures of 2^20 samples (1024 host-shaped rows of 1280); the
    last one's frame starts past the 256-row tier, inside pass 1's middle
    window (rows 480-543), so the batch needs the full scan."""
    rng = np.random.default_rng(31)
    batch = np.zeros((3, n), np.float32)
    payloads = []
    for i, lead in enumerate((5, 900, 482 * 1280)):
        p = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        wave = modulate("QPSK", pack_frame(f"m{i}.bin", p, 0, 1, len(p), crc32(p)), 9600)
        batch[i, lead : lead + len(wave)] = wave
        payloads.append(p)
    return batch, payloads


@pytest.mark.parametrize("shards", [2, 3])
def test_mesh_batch_on_the_card_equals_unsharded(cuda, shards):
    """``decode_sample_batch(mesh=)`` over shards of the one card: the
    unsharded call's bytes, K1 and K3 once a shard, K2 at the unsharded
    call's tiers on every shard."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch
    from audio_modem_radio_tpu_torch.parallel.mesh import get_mesh

    batch, payloads = _qpsk_batch_late(1 << 20)
    tk.reset_launch_counts()
    ref = decode_sample_batch(batch, "QPSK", 9600, device=cuda)
    c_ref = tk.launch_counts()
    tk.reset_launch_counts()
    got = decode_sample_batch(batch, "QPSK", 9600, mesh=get_mesh(devices=[cuda] * shards))
    c = tk.launch_counts()
    assert got == ref
    assert [[f.data for f in parse_frames(r)] for r in got] == [[p] for p in payloads]
    assert c_ref["rotation_match_batch"] == 2
    assert c["psk_project_decide_batch"] == c["relabel_pack_batch"] == shards
    assert c["rotation_match_batch"] == shards * c_ref["rotation_match_batch"]


def test_sequence_decode_on_the_card_equals_the_cpu(cuda):
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.parallel.mesh import get_mesh
    from audio_modem_radio_tpu_torch.parallel.sequence import decode_capture_sharded

    p = np.random.default_rng(32).integers(0, 256, 2000, dtype=np.uint8).tobytes()
    for mode, rate in (("QPSK", 9600), ("FSK1200", 1200), ("OFDM4", 4800), ("NEURAL", 1200)):
        wave = modulate(mode, pack_frame("s.bin", p, 0, 1, len(p), crc32(p)), rate)
        x = np.concatenate([np.zeros(len(wave) + 777, np.float32), wave])
        on_card = decode_capture_sharded(x, mode, rate, get_mesh(devices=[cuda] * 4))
        assert [f.data for f in parse_frames(on_card)] == [p]
        assert on_card == decode_capture_sharded(x, mode, rate, get_mesh(devices=["cpu"] * 4))


def test_sharded_training_step_on_the_card(cuda):
    from audio_modem_radio_tpu_torch.models.neural_modem import create_train_state, make_train_step
    from audio_modem_radio_tpu_torch.parallel.mesh import get_2d_mesh

    models = [create_train_state(0, bits_per_symbol=4, hidden=64, device=cuda) for _ in range(2)]
    steps = [make_train_step(*models[0]), make_train_step(*models[1], mesh=get_2d_mesh(2, 2, [cuda] * 4))]
    sym = torch.randint(0, 16, (256,), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    res = [s(sym, 0.1, torch.Generator(device=cuda).manual_seed(4)) for s in steps]
    assert abs(float(res[0][0]) - float(res[1][0])) <= 1e-5 * abs(float(res[0][0]))
    for pa, pb in zip(models[0][0].parameters(), models[1][0].parameters()):
        assert float((pa.grad - pb.grad).abs().max()) <= 1e-5 * float(pa.grad.abs().max())


def test_entry_points_on_the_card(cuda, capsys):
    from audio_modem_radio_tpu_torch.entry import dryrun_multichip, entry

    fn, (x,) = entry()
    assert x.device.type == "cuda"
    packed, n_valid, found = fn(x)
    assert packed.shape[0] == 4 and not bool(found.any())
    dryrun_multichip(2)
    assert "dryrun_multichip OK on 2 devices" in capsys.readouterr().out
