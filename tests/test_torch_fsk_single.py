"""The port's single-capture FSK receiver vs the JAX package's, on the CPU:
``fsk_demod_bits`` on every detector family (dual tone: FSK1200, MSK, FT8;
quadrature: FSK19200; discriminator with MLSE: FSK9600 and the 8- and
96-state trellises), the soft margins, ``_mlse_refine`` on the same
correlations, host-shaped rows against flat input, the argument checks,
and the FSK9600 genie-bound property through the port. The receive chain
above it is ``tests/test_torch_fsk_single_chain.py``.

Captures are made with numpy from seeds, at most 2^18 samples, and handed to
both packages as numpy arrays. Bits are equal on clean captures over the
signal: past its end the capture is silence, where every MLSE branch
metric is the energy term alone and which of two near-equal paths wins
turns on the last bit of θ's float32 sum, whose order differs between the
packages (the sync tail never reads there). Soft margins agree within
1e-4 of their largest magnitude (summation order). On the CPU the Viterbi
runs its plain version; the kernel is held against it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.ops import fsk as jfsk

from audio_modem_radio_tpu_torch.ops import fsk as tfsk
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.parallel import batch as tb

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
# Capture -> (mode, symbol rate, baud, mark, space, payload bytes, samples, lead).
# Lengths are bucket sizes, so the decoders' bucket padding keeps them.
CAPS = {
    "FSK1200": ("FSK1200", 1200, 1200.0, 1200.0, 2200.0, 200, 1 << 18, 311),
    "FSK9600": ("FSK9600", 9600, 9600.0, 1200.0, 2200.0, 300, 1 << 16, 211),
    "FSK9600 blocks": ("FSK9600", 9600, 9600.0, 1200.0, 2200.0, 2600, 1 << 18, 97),
    "FSK19200": ("FSK19200", 19200, 19200.0, 8000.0, 16000.0, 1200, 1 << 16, 55),
    "MSK@9600": ("MSK", 9600, 9600.0, 6000.0, 15600.0, 500, 1 << 16, 13),
    "FT8": ("FT8", 50, 50.0, 3000.0, 3050.0, 12, 1 << 18, 0),
    "8 states": (None, 9600, 9600.0, 1200.0, 2400.0, 300, 1 << 16, 211),
    "96 states": (None, 9600, 9600.0, 1100.0, 2200.0, 300, 1 << 16, 211),
}


def _payload(name: str) -> bytes:
    return np.random.default_rng(sum(map(ord, name))).integers(0, 256, CAPS[name][5], dtype=np.uint8).tobytes()


def _wave(name: str) -> np.ndarray:
    """The capture's wave: a framed payload through the JAX modulator (FT8:
    the bare payload, as no frame fits 2^18 samples at 50 Bd)."""
    _mode, _rate, baud, mark, space, _nb, _n, _lead = CAPS[name]
    data = _payload(name)
    framed = data if name == "FT8" else pack_frame(f"{name}.bin", data, 0, 1, len(data), crc32(data))
    return np.asarray(jfsk.fsk_modulate(framed, baud, mark, space, SR), np.float32)


@pytest.fixture(scope="module")
def caps():
    out = {}
    for name, (_mode, _rate, _b, _m, _s, _nb, n, lead) in CAPS.items():
        w = _wave(name)
        assert lead + len(w) <= n, name
        x = np.zeros(n, np.float32)
        x[lead : lead + len(w)] = w
        out[name] = x
    return out


def _args(name):
    return CAPS[name][2:5] + (SR,)


def _signal_bits(name) -> int:
    """The bits of the capture that hold signal (lead and wave)."""
    return (CAPS[name][7] + len(_wave(name))) // tfsk._samples_per_bit(SR, CAPS[name][2])


def _both_bits(x, name, **kw):
    """(port, JAX) outputs of fsk_demod_bits as numpy."""
    got = tfsk.fsk_demod_bits(torch.from_numpy(x), *_args(name), **kw)
    ref = jfsk.fsk_demod_bits(jnp.asarray(x), *_args(name), **kw)
    return [a.numpy() for a in got], [np.asarray(a) for a in ref]


# --- fsk_demod_bits -----------------------------------------------------------------

@pytest.mark.parametrize("name,mlse", [(n, True) for n in CAPS] + [("FSK9600", False)])
def test_fsk_demod_bits_clean_bitwise(caps, name, mlse):
    """Bits equal over the signal of clean captures, for every family; the
    best-offset score within 1e-4. "FSK9600" is one Viterbi pass, "FSK9600
    blocks" four blocks; the 8- and 96-state trellises are 1200/2400 and
    1100/2200 Hz at 9600 Bd."""
    _b, _m, _s = _args(name)[:3]
    got, ref = _both_bits(caps[name], name, mlse=mlse)
    n_sig = _signal_bits(name)
    assert got[0].dtype == np.uint8 and got[0].shape == ref[0].shape
    assert np.array_equal(got[0][:n_sig], ref[0][:n_sig])
    assert abs(float(got[1]) - float(ref[1])) <= 1e-4 * abs(float(ref[1]))
    trellis = tfsk._cpfsk_trellis(tfsk._samples_per_bit(SR, _b), _m, _s, SR)
    assert trellis == jfsk._cpfsk_trellis(jfsk._samples_per_bit(SR, _b), _m, _s, SR)
    if name == "8 states":
        assert trellis[0] == 8
    if name == "96 states":
        assert trellis[0] == 96
    if name == "FSK9600 blocks":
        assert len(got[0]) > 3 * tfsk._MLSE_BLOCK_CORE


@pytest.mark.parametrize("name", ["FSK1200", "FSK19200", "FSK9600"])
def test_want_soft_margins(caps, name):
    """The signed soft margins (on FSK9600 the MLSE signs with the
    equalizer's magnitudes) within 1e-4 of their largest magnitude over the
    signal, bits equal there; ``fsk_soft_bits`` within 1e-4."""
    got, ref = _both_bits(caps[name], name, mlse=True, want_soft=True)  # fsk_soft_bits's call
    n_sig = _signal_bits(name)
    assert np.array_equal(got[0][:n_sig], ref[0][:n_sig])
    assert got[2].shape == ref[2].shape
    assert float(np.abs(got[2][:n_sig] - ref[2][:n_sig]).max()) <= 1e-4 * float(np.abs(ref[2]).max())
    soft_t = tfsk.fsk_soft_bits(caps[name], *_args(name), device="cpu")
    soft_j = jfsk.fsk_soft_bits(caps[name], *_args(name))
    assert soft_t.dtype == np.float32 and float(np.abs(soft_t[:n_sig] - soft_j[:n_sig]).max()) <= 1e-4


def _local_correlations(x, baud, mark, space, n_bits):
    """(s_corr, c_corr) (2, n_bits) of a capture whose bits start at sample
    0: each bit's local-time sums x·sin and x·cos per tone, in float64
    rounded to float32 (one input for both packages)."""
    spb = tfsk._samples_per_bit(SR, baud)
    rows = x[: n_bits * spb].astype(np.float64).reshape(n_bits, spb)
    tl = np.arange(spb) / SR
    s = np.stack([rows @ np.sin(2 * np.pi * f * tl) for f in (mark, space)])
    c = np.stack([rows @ np.cos(2 * np.pi * f * tl) for f in (mark, space)])
    return s.astype(np.float32), c.astype(np.float32)


@pytest.mark.parametrize("case", ["48 states, noisy, blocks", "96 states"])
def test_mlse_refine_same_correlations(case):
    """``_mlse_refine`` of both packages on the same correlations and seed
    bits: equal bits. The seed is the transmitted stream with every 37th bit
    flipped (the equalizer's errors); the noisy case (FSK9600's trellis,
    four blocks) adds AWGN at 12 dB, the clean one must give the
    transmitted stream."""
    mark, space = {"8 states": (1200.0, 2400.0), "96 states": (1100.0, 2200.0)}.get(case, (1200.0, 2200.0))
    rng = np.random.default_rng(len(case))
    n_bytes = 2600 if "blocks" in case else 300
    tx = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    x = np.asarray(jfsk.fsk_modulate(tx, 9600.0, mark, space, SR), np.float32)
    if "noisy" in case:
        x = x + rng.normal(0, float(np.sqrt(np.mean(x**2) / 10 ** 1.2)), len(x)).astype(np.float32)
    n_bits = len(x) // 10
    truth = np.unpackbits(np.frombuffer(jfsk.FSK_PREAMBLE + tx + b"\xAA", np.uint8))[:n_bits]
    seed = truth.copy()
    seed[::37] ^= 1
    s_corr, c_corr = _local_correlations(x, 9600.0, mark, space, n_bits)
    trellis = tfsk._cpfsk_trellis(10, mark, space, SR)
    args = (*trellis, 10, mark, space, SR)
    got = tfsk._mlse_refine(torch.from_numpy(s_corr), torch.from_numpy(c_corr), torch.from_numpy(seed), *args)
    ref = np.asarray(jfsk._mlse_refine(jnp.asarray(s_corr), jnp.asarray(c_corr), jnp.asarray(seed), *args))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)
    if "noisy" not in case:
        assert np.array_equal(got.numpy(), truth)
    if "blocks" in case:
        assert n_bits > tfsk._MLSE_BLOCK_CORE + 2 * tfsk._MLSE_BLOCK_OVERLAP


@pytest.mark.parametrize("name", ["FSK1200", "FSK9600", "FSK19200"])
def test_preshaped_rows_match_flat(caps, name):
    """Host-shaped rows (dual tone: ``fsk_blocked_row_shape``; close and mid
    tones: the FIR windows of ``fsk_fir_row_shape``, equalizer only) give
    the flat capture's bits; FIR rows with MLSE or the wrong width raise."""
    x = caps[name]
    baud, mark, space, _sr = _args(name)
    flat = tfsk.fsk_demod_bits(torch.from_numpy(x), *_args(name), mlse=False)[0].numpy()
    if name == "FSK1200":
        r, row, ov = tfsk.fsk_blocked_row_shape(len(x), baud, mark, space, SR)
        rows = tb._overlap_rows(x[None], r, row, ov)[0]
    else:
        r, row, ov, lead = tfsk.fsk_fir_row_shape(len(x), baud, mark, space, SR)
        rows = tb._overlap_rows(x[None], r, row, ov, lead=lead)[0]
        for pkg, arr in ((tfsk, torch.from_numpy(rows)), (jfsk, jnp.asarray(rows))):
            with pytest.raises(ValueError, match="incompatible with MLSE"):
                pkg.fsk_demod_bits(arr, *_args(name), mlse=True)
        with pytest.raises(ValueError, match="wrong column count"):
            tfsk.fsk_demod_bits(torch.from_numpy(rows[:, 1:]), *_args(name), mlse=False)
    shaped = tfsk.fsk_demod_bits(torch.from_numpy(rows), *_args(name), mlse=False)[0].numpy()
    assert len(shaped) >= len(flat) and np.array_equal(shaped[: len(flat)], flat)


def test_frontends_and_short_captures_checked():
    """The A/B-only front ends raise NotImplementedError and say so; an
    unknown front end and a capture under two bits raise ValueError, as in
    the JAX package."""
    x = np.zeros(1 << 12, np.float32)
    for frontend in ("fft", "fir"):
        with pytest.raises(NotImplementedError, match="A/B-only"):
            tfsk.fsk_demod_bits(torch.from_numpy(x), 9600.0, 1200.0, 2200.0, SR, frontend=frontend)
    for pkg, arr in ((tfsk, torch.from_numpy(x)), (jfsk, jnp.asarray(x))):
        with pytest.raises(ValueError, match="unknown frontend"):
            pkg.fsk_demod_bits(arr, 9600.0, 1200.0, 2200.0, SR, frontend="nope")
    for pkg, arr in ((tfsk, torch.zeros(100)), (jfsk, jnp.zeros(100))):
        with pytest.raises(ValueError, match="shorter than two bit periods"):
            pkg.fsk_demod_bits(arr, 1200.0, 1200.0, 2200.0, SR)


def test_mlse_viterbi_wrapper_checks():
    """The wrapper refuses what the kernel does not take, and on the CPU runs
    the plain version without counting a launch."""
    S = 8
    cos_t, sin_t, aec = torch.ones(S), torch.zeros(S), torch.zeros(2, 2, S)
    x = torch.zeros((2, 4, 5))
    before = tk.mlse_viterbi_blocks.launches
    out = tk.mlse_viterbi_blocks(x, cos_t, sin_t, aec, 1, 2)
    assert out.shape == (2, 5) and out.dtype == torch.uint8 and tk.mlse_viterbi_blocks.launches == before
    assert "mlse_viterbi_blocks" in tk.launch_counts()
    with pytest.raises(ValueError, match="states"):
        tk.mlse_viterbi_blocks(x, torch.ones(97), torch.zeros(97), torch.zeros(2, 2, 97), 1, 2)
    with pytest.raises(ValueError, match="tables"):
        tk.mlse_viterbi_blocks(x, cos_t, sin_t, torch.zeros(2, S), 1, 2)
    with pytest.raises(ValueError, match="x"):
        tk.mlse_viterbi_blocks(torch.zeros((2, 3, 5)), cos_t, sin_t, aec, 1, 2)
    with pytest.raises(ValueError, match="advances"):
        tk.mlse_viterbi_blocks(x, cos_t, sin_t, aec, 8, 2)
    with pytest.raises(ValueError, match="float32"):
        tk.mlse_viterbi_blocks(x.double(), cos_t, sin_t, aec, 1, 2)


def test_demod_bits_each_shares_one_viterbi_call(caps, monkeypatch):
    """``fsk_demod_bits_each`` (the batch's per-capture fallback) on the
    four-block FSK9600 capture and a shifted copy at half amplitude: one
    Viterbi call takes both captures' blocks, each capture's with its own
    energy rows, and each capture gets the bits ``fsk_demod_bits`` gives it
    alone."""
    x = caps["FSK9600 blocks"]
    batch = torch.from_numpy(np.stack([x, 0.5 * np.roll(x, 37)]))
    calls, real = [], tfsk.mlse_viterbi_blocks

    def record(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(tfsk, "mlse_viterbi_blocks", record)
    got = tfsk.fsk_demod_bits_each(batch, *_args("FSK9600 blocks"))
    assert len(calls) == 1 and calls[0][0].shape[0] == 8 and calls[0][3].shape[:2] == (8, 2)
    aec = calls[0][3]
    assert torch.equal(aec[0], aec[3]) and not torch.equal(aec[0], aec[4])
    for i in range(2):
        assert torch.equal(got[i], tfsk.fsk_demod_bits(batch[i], *_args("FSK9600 blocks"))[0])


def test_fsk9600_genie_bound_through_port():
    """``tests/test_fsk9600_bound.py`` through the port: at 15 dB the MLSE
    receiver's BER stays within 2x of the genie exact-ML bound (1.81e-3),
    and the equalizer-only receiver's is more than 5x the MLSE one's."""
    rng = np.random.default_rng(11000)
    payload = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    framed = pack_frame("f.bin", payload, 0, 1, 2000, crc32(payload))
    wave = tfsk.fsk_modulate(framed, 9600.0, 1200.0, 2200.0, SR)
    sigma = float(np.sqrt(np.mean(wave**2) / 10 ** (15.0 / 10.0)))
    noisy = (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)
    args = (9600.0, 1200.0, 2200.0, SR)
    n_bits = len(wave) // 10
    truth = tfsk.fsk_demod_bits(torch.from_numpy(wave), *args, mlse=False)[0].numpy()[:n_bits]
    ber = float(np.mean(tfsk.fsk_demod_bits(torch.from_numpy(noisy), *args)[0].numpy()[:n_bits] != truth))
    assert ber < 2.0 * 1.81e-3, f"production BER {ber:.2e} drifted off the genie bound"
    ber_eq = float(np.mean(tfsk.fsk_demod_bits(torch.from_numpy(noisy), *args, mlse=False)[0].numpy()[:n_bits]
                           != truth))
    assert ber_eq > 5.0 * ber, f"eq rung {ber_eq:.2e} vs prod {ber:.2e}"
