"""The batched PSK pass 1's wrapper on the CPU (``ops.kernels.psk_pass1_batch``,
``csrc/psk_pass1.cu`` on the card): the window rule that the plain chain
and the kernel share, the wrapper's refusals, and its routing to the plain
chain, whose ``best`` and θ equal the chain ``ops/psk.py`` ran inline
before the wrapper existed. The kernel against the plain chain is
``tests/test_torch_cuda.py -k pass1``."""

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu_torch import modulate
from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

_ROWS = 2304  # test_torch_tracing.py's QPSK rows


def _windows_before(r0: int, n_rows: int):
    """The index arithmetic ``_batch_pass1`` ran inline before the rule was
    one helper: (wr, [(start, head), ...])."""
    wr = min(64, r0) if r0 >= 1 else 1
    starts = sorted({0, max(0, r0 // 2 - wr // 2), max(0, r0 - wr)})
    out = []
    for s in starts:
        n0 = min(max(min(s + 1, r0 - wr + 1 if r0 >= wr else 0), 0), n_rows - wr)
        out.append((s, n0))
    return wr, out


def _pass1_before(x3d, r0, spsym, carrier, n_psk):
    """``_batch_pass1``'s projection and scoring as ``ops/psk.py`` ran them
    inline, line for line: (best, theta)."""
    b = x3d.shape[0]
    W8, W_all, grams = tpsk._device_tables(spsym, float(carrier), 96000, 8, x3d.device)
    row = 128 * spsym
    c = W8.shape[1]
    ov = c - row
    wr = min(64, r0) if r0 >= 1 else 1
    starts = sorted({0, max(0, r0 // 2 - wr // 2), max(0, r0 - wr)})
    n_rows = x3d.shape[1]
    wins = []
    for s in starts:
        n0 = min(max(min(s + 1, r0 - wr + 1 if r0 >= wr else 0), 0), n_rows - wr)
        wins.append(torch.cat([x3d[:, s : s + wr], x3d[:, n0 : n0 + wr, :ov]], dim=2))
    wins = torch.cat(wins, dim=1).to(torch.float32)
    wscale = torch.clamp_min(torch.amax(torch.abs(wins), dim=(1, 2), keepdim=True), 1e-12)
    wins = wins / wscale
    proj = torch.matmul(wins.reshape(b, -1, c), W_all)
    proj = proj.reshape(b, -1, 8, 2, 128)
    re, im = proj[:, :, :, 0], proj[:, :, :, 1]
    re, im = tpsk._gram_scale(re, im, grams, offset_axis=2)
    dr = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    di = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    score = tpsk._coherence_score(dr, di, (1, 3), n_psk)
    best = torch.argmax(score, dim=1).to(torch.int32)
    idx = best.long()[:, None, None, None].expand(-1, dr.shape[1], 1, dr.shape[3])
    dr_b = torch.gather(dr, 2, idx)[:, :, 0]
    di_b = torch.gather(di, 2, idx)[:, :, 0]
    est = tpsk.estimate_common_rotation8 if n_psk == 8 else tpsk.estimate_common_rotation
    return best, est(dr_b.reshape(b, -1), di_b.reshape(b, -1))


@pytest.mark.parametrize("r0", [1, 2, 63, 64, 65, 66, 127, 128, 129, 191, 192, 193, 255, 256, 2303, 2304])
def test_pass1_windows_equal_the_index_arithmetic_they_replace(r0):
    """The rule at r0 = 1, 63, 64, 65 (the windows dedupe while r0 < 128
    or so), odd r0, and r0 equal to the stored rows (the head clamp) or
    under them (flat captures padded to whole blocks): the same windows as
    the arithmetic it replaces, each inside the array."""
    for n_rows in sorted({r0, -(-r0 // 256) * 256, max(256, r0)}):
        wr, windows = tk.pass1_windows(r0, n_rows)
        assert (wr, list(windows)) == _windows_before(r0, n_rows)
        starts = [s for s, _ in windows]
        assert wr == min(64, r0) and starts == sorted(set(starts)) and 1 <= len(windows) <= 3
        for s, head in windows:
            assert 0 <= s and s + wr <= r0 and 0 <= head and head + wr <= n_rows
            assert head == s + 1 or head + wr == n_rows
        if r0 <= 64:
            assert windows == ((0, min(1, n_rows - wr)),)


def test_pass1_windows_clamp_the_last_window_at_the_edge():
    """At r0 == n_rows the last window's heads shift back onto its own rows,
    as JAX's dynamic_slice clamps the start; one padded row lets them move on."""
    assert tk.pass1_windows(256, 256) == (64, ((0, 1), (96, 97), (192, 192)))
    assert tk.pass1_windows(256, 257) == (64, ((0, 1), (96, 97), (192, 193)))
    assert tk.pass1_windows(65, 256) == (64, ((0, 1), (1, 2)))


def _small():
    spsym = 10
    x3d = torch.zeros((2, 256, 128 * spsym), dtype=torch.int16)
    _, w_all, grams = tpsk._device_tables(spsym, 3000.0, 96000, 8, torch.device("cpu"))
    return x3d, w_all, grams


@pytest.mark.parametrize("case", [
    "rank", "dtype", "row_width", "spsym_over_32", "r0_zero", "r0_past_rows", "w_dtype", "w_rank",
    "w_short", "w_columns", "grams_shape", "grams_dtype", "device_mix",
])
def test_pass1_wrapper_refuses_what_neither_version_takes(case):
    x3d, w_all, grams = _small()
    wide = torch.zeros((2, 256, 128 * 33), dtype=torch.int16)
    calls = {
        "rank": lambda: tk.psk_pass1_batch(x3d[0], 256, w_all, grams),
        "dtype": lambda: tk.psk_pass1_batch(x3d.double(), 256, w_all, grams),
        "row_width": lambda: tk.psk_pass1_batch(x3d[:, :, :1000], 256, w_all, grams),
        "spsym_over_32": lambda: tk.psk_pass1_batch(wide, 256, torch.zeros((128 * 33 + 128, 2048)), grams),
        "r0_zero": lambda: tk.psk_pass1_batch(x3d, 0, w_all, grams),
        "r0_past_rows": lambda: tk.psk_pass1_batch(x3d, 257, w_all, grams),
        "w_dtype": lambda: tk.psk_pass1_batch(x3d, 256, w_all.double(), grams),
        "w_rank": lambda: tk.psk_pass1_batch(x3d, 256, w_all[None], grams),
        "w_short": lambda: tk.psk_pass1_batch(x3d, 256, w_all[:1290], grams),
        "w_columns": lambda: tk.psk_pass1_batch(x3d, 256, w_all[:, :1000], grams),
        "grams_shape": lambda: tk.psk_pass1_batch(x3d, 256, w_all, grams[:7]),
        "grams_dtype": lambda: tk.psk_pass1_batch(x3d, 256, w_all, grams.double()),
        "device_mix": lambda: tk.psk_pass1_batch(x3d, 256, w_all, grams.to("meta")),
    }
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.parametrize("case", ["misaligned", "offsets_over_16", "ov_not_16", "captures_over_grid"])
def test_pass1_card_path_refuses_before_it_launches(monkeypatch, case):
    """The checks only the kernel needs (a 16-byte aligned start, at most 16
    offsets, OV in whole 16-sample chunks, a capture grid of 65535), made on
    the card path before the kernel library is touched: the device check is
    stood in for, and a launch would fail the test."""
    x3d, w_all, grams = _small()
    monkeypatch.setattr(tk, "_same_device", lambda *ts: torch.device("cuda", 0))

    def no_launch(*args, **kwargs):
        raise AssertionError("the kernel was launched")

    monkeypatch.setattr(tk, "_launch", no_launch)
    monkeypatch.setattr(tk, "_kept", no_launch)
    base = torch.zeros(2 * 256 * 1280 + 8, dtype=torch.int16)
    calls = {
        "misaligned": lambda: tk.psk_pass1_batch(base[1 : 1 + x3d.numel()].view(2, 256, 1280), 256, w_all, grams),
        "offsets_over_16": lambda: tk.psk_pass1_batch(x3d, 256, torch.zeros((1408, 17 * 256)), torch.zeros((17, 3))),
        "ov_not_16": lambda: tk.psk_pass1_batch(x3d, 256, w_all[:1300], grams),
        "captures_over_grid": lambda: tk.psk_pass1_batch(x3d[:1].expand(65536, -1, -1), 256, w_all, grams),
    }
    with pytest.raises(ValueError):
        calls[case]()


def _framed(seed: int, n: int = 3000) -> bytes:
    p = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()
    return pack_frame("t.bin", p, 0, 1, len(p), crc32(p))


@pytest.fixture(scope="module")
def rows():
    """test_torch_tracing.py's fixtures ({"clean", "noise"}: blocked
    (2, 2304, 1280) int16 rows of two QPSK captures, or of one and noise)
    and an 8PSK pair at 12 kHz, capture 1 at +100 Hz."""
    n = _ROWS * 1280 - 4000
    wave = modulate("QPSK", _framed(1), 9600)
    x = np.zeros((2, n), np.float32)
    x[0, 100 : 100 + len(wave)] = wave
    x[1, 7 : 7 + len(wave)] = wave
    noisy = x.copy()
    noisy[1] = np.random.default_rng(2).normal(0, 0.3, n)
    out = {k: torch.from_numpy(tb.host_shape_batch(v, "QPSK", 9600, device="cpu"))
           for k, v in (("clean", x), ("noise", noisy))}
    w8 = tpsk.psk8_real_modulate(_framed(5), 9600, 12000.0 + 100.0)
    x8 = np.zeros((2, 256 * 1280), np.float32)
    x8[0, 40 : 40 + len(w8)] = tpsk.psk8_real_modulate(_framed(5), 9600, 12000.0)
    x8[1, 3 : 3 + len(w8)] = w8
    out["8psk"] = torch.from_numpy(x8.reshape(2, 256, 1280))
    return out


@pytest.mark.parametrize("case", ["clean", "noise", "clean int16", "clean int8", "8psk", "flat"])
def test_pass1_on_the_cpu_is_the_plain_chain_as_it_was(rows, monkeypatch, case):
    """On CPU tensors the wrapper runs the plain chain, counts no launch and
    touches no kernel library; ``_batch_pass1`` gives the ``best`` and θ of
    the chain as it ran inline, bit for bit, on pre-shaped float32 rows
    (``host_shape_batch``'s on the CPU), int16 and int8 rows, at the 8th
    power, and on a flat capture padded to whole blocks (r0 under the
    stored rows)."""
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(tk, "_launch", no_launch)
    carrier, n_psk = (12000.0, 8) if case == "8psk" else (3000.0, 4)
    x = rows["8psk" if case == "8psk" else case.split()[0] if case != "flat" else "clean"]
    if case.endswith("int16") or case.endswith("int8"):
        scale = 32768.0 if case.endswith("int16") else 128.0
        x = torch.clamp(torch.round(x * scale), -scale, scale - 1).to(getattr(torch, case.split()[1]))
    before = tk.psk_pass1_batch.launches
    if case == "flat":
        flat = x.reshape(2, -1)[:, : 300 * 1280].to(torch.float32)
        x3d, r, best, theta = tpsk._batch_pass1(flat, None, 2, 300 * 128, 10, carrier, 96000, 8, 0, n_psk)
        assert r == 512 and x3d.shape == (2, 512, 1280)
        r0 = 300
    else:
        b, r, _ = x.shape
        x3d, r_out, best, theta = tpsk._batch_pass1(None, x, b, r * 128, 10, carrier, 96000, 8, r, n_psk)
        assert x3d is x and r_out == r
        r0 = r
    want_best, want_theta = _pass1_before(x3d, r0, 10, carrier, n_psk)
    assert tk.psk_pass1_batch.launches == before
    assert best.dtype == torch.int32 and theta.dtype == torch.float32
    assert torch.equal(best, want_best) and torch.equal(theta, want_theta)
    if case != "noise":  # a signal capture's offset and rotation are the signal's
        assert abs(float(theta[0])) < 0.05
