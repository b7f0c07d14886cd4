"""Shared by ``test_torch_fsk_eq_bits.py`` (CPU) and ``test_torch_cuda.py``
(card): hand-made K8 sums for the close-tone FSK decision after K8
(``ops.kernels.fsk_disc_decide_batch``), FSK9600's equalizer, and sums whose
equalized frequency is exactly the mid-tone.

The sizes straddle ``csrc/fsk_eq_bits.cu``'s grains: 4096 row positions a
block, 16 a thread, 4 positions of halo on each side; rows whose n is a
multiple of 16 take its 16-byte loads and stores.
"""


import numpy as np
import torch

from audio_modem_radio_tpu_torch.ops import fsk as tf

SAMPLE_RATE = 96000
BAUD, MARK, SPACE = 9600.0, 1200.0, 2200.0

# name -> (B, n); every case's sums are float32 and the same on every call.
CASES = {
    "zeros": (3, 4096),
    "signed_zeros": (3, 5000),
    "denormals": (2, 4100),
    "huge": (2, 4097),
    "tones": (4, 2 * 4096),
    "tie_bias": (2, 333),
    **{f"n{n}": (5, n) for n in range(1, 10)},
    "n_off_grain": (3, 2 * 4096 + 37),
    "n_16_not_tile": (3, 4096 + 48),
    "tiles_exact": (2, 3 * 4096),
    "b1": (1, 3 * 4096 + 5),
    "b256": (256, 1040),
}


def plan_coef():
    """FSK9600's (plan, coef) as the batched receive builds them."""
    spb = tf._samples_per_bit(SAMPLE_RATE, BAUD)
    plan, _wf, _wb, coef = tf._device_tables("disc", spb, BAUD, MARK, SPACE, SAMPLE_RATE, 8, torch.device("cpu"))
    return plan, coef


def case_coef(name: str) -> np.ndarray:
    """The equalizer a case runs: FSK9600's, but for ``tie_bias``, whose taps
    are zero and whose bias is the mid-tone, so every bit ties."""
    _plan, coef = plan_coef()
    if name == "tie_bias":
        return np.array([0.0] * (len(coef) - 1) + [(MARK + SPACE) / 2], np.float32)
    return coef


def case_sums(name: str):
    """(sr, si) float32 numpy (B, n) of case ``name``."""
    b, n = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    scale = tf._disc_scale(SAMPLE_RATE, plan_coef()[0])
    if name == "zeros":
        return np.zeros((b, n), np.float32), np.zeros((b, n), np.float32)
    if name == "signed_zeros":
        sign = rng.integers(0, 2, (2, b, n)) * 2 - 1
        z = (sign * 0.0).astype(np.float32)
        return z[0], z[1]
    if name == "denormals":
        tiny = np.float32(2.0**-126)
        m = rng.uniform(-1, 1, (2, b, n)).astype(np.float32) * tiny
        m[:, :, ::7] = 0.0
        m[:, :, ::11] *= np.float32(2.0**100)  # some normal beside them
        return m[0], m[1]
    if name == "huge":
        m = rng.uniform(-1, 1, (2, b, n)) * np.finfo(np.float32).max
        m = m.astype(np.float32)
        m[0, :, ::13] = np.inf
        m[1, :, ::17] = -np.inf
        return m[0], m[1]
    if name == "tones":
        # The tones' angles with noise, in runs of random length, so that
        # the equalizer's taps see mark and space side by side.
        theta = np.where(rng.integers(0, 2, (b, n)) == 1, MARK, SPACE) / scale
        theta = theta + rng.normal(0, 0.05, (b, n))
        mag = rng.uniform(0.1, 100.0, (b, n))
        return (mag * np.cos(theta)).astype(np.float32), (mag * np.sin(theta)).astype(np.float32)
    m = rng.normal(0, 1, (2, b, n)) * rng.uniform(1e-3, 1e3, (2, b, 1))
    return m[0].astype(np.float32), m[1].astype(np.float32)


def tie_sums(device, side: int = 64):
    """Two-bit rows of sums (sr, si) on ``device`` and the mask of their bits
    whose equalized frequency under FSK9600's equalizer is exactly the
    mid-tone there, as the plain chain on ``device`` computes it: the two
    bits' angles swept over a grid of ``side`` x ``side`` float32 steps of
    the frequency across the crossing (bit 0's taps read 5 of the first and
    4 of the second, bit 1's 4 and 5), the rows with a tie kept."""
    plan, coef = plan_coef()
    scale = tf._disc_scale(SAMPLE_RATE, plan)
    mid = (MARK + SPACE) / 2
    f_star = (mid - float(coef[-1])) / float(np.sum(coef[:-1], dtype=np.float64))
    steps = (np.arange(side) - side // 2) * float(np.spacing(np.float32(f_star)))
    theta = (f_star + np.stack(np.meshgrid(steps, steps, indexing="ij"), axis=-1).reshape(-1, 2)) / scale
    sr = torch.from_numpy(np.cos(theta).astype(np.float32)).to(device)
    si = torch.from_numpy(np.sin(theta).astype(np.float32)).to(device)
    # The plain chain's equalized frequency (``fsk_disc_decide_batch_plain``
    # before its compare), operator for operator, each row's edges repeated.
    f = torch.atan2(si, sr) * scale
    fm = torch.cat([f[:, :1].expand(-1, 4), f, f[:, -1:].expand(-1, 4)], dim=1)
    eq = torch.full_like(f, float(coef[-1]))
    for j in range(len(coef) - 1):
        eq = eq + float(coef[j]) * fm[:, j : j + 2]
    tie = eq == mid
    keep = tie.any(dim=1)
    return sr[keep].contiguous(), si[keep].contiguous(), tie[keep]

