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


def test_relabel_pack_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    b, r = 16, 512
    hi = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    lo = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    s = (8 * torch.arange(b, device=cuda) * 37 + torch.arange(b, device=cuda) % 8).to(torch.int32)
    ksel = (torch.arange(b, device=cuda) % 4).to(torch.int32)
    got = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)
    ref = tk.relabel_pack_batch_plain(hi, lo, s, ksel)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_bit_select_pack_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    b, r = 16, 512
    re = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    im = torch.randint(0, 2, (b, r, 128), generator=g, device=cuda, dtype=torch.uint8)
    s = (8 * torch.arange(b, device=cuda) * 41 + torch.arange(b, device=cuda) % 8).to(torch.int32)
    ksel = (torch.arange(b, device=cuda) % 4).to(torch.int32)
    got = tk.bit_select_pack_batch(re, im, s, ksel, rows_per_capture=r)
    ref = tk.bit_select_pack_batch_plain(re, im, s, ksel)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


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
