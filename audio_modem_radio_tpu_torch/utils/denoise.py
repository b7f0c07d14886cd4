"""Spectral-gate noise reduction for received captures, in PyTorch.

Counterpart of ``audio_modem_radio_tpu/utils/denoise.py``: an opt-in
preprocessing stage (``decode... denoise=True``, or CONFIG
``modem.noise_reduction``). A spectral gate estimates the per-bin level
from the median over time and attenuates bins near the wideband floor.
Off by default: the demodulators are matched-filter-optimal under AWGN,
where any spectral shaping can only lose information; gating helps when the
interference is structured (hum, carriers, coloured hiss).

One framed FFT over the capture, an elementwise gain, the inverse FFT and
overlap-add, all plain torch on ``device`` (the card unless the caller
names the CPU). Two points where torch's defaults differ from JAX's:
``jnp.hanning`` is the symmetric window (``torch.hann_window(...,
periodic=False)``), and ``jnp.median`` averages the two middle values of an
even count as ``(lo + hi) * 0.5`` (``torch.median`` would return the lower
one, and ``torch.quantile``'s midpoint rounds as a lerp and refuses inputs
of over 2^24 elements, which a 2^24-sample capture's spectrogram is).
"""

from __future__ import annotations

import numpy as np
import torch

from .torchenv import DeviceLike, resolve_device

_FRAME = 2048
_HOP = _FRAME // 2


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over dim 0: the middle value of the sorted values, or
    ``(lo + hi) * 0.5`` of the two middle ones of an even count."""
    v = torch.sort(x, dim=0).values
    m = x.shape[0]
    return (v[(m - 1) // 2] + v[m // 2]) * 0.5


def _gate(x: torch.Tensor, reduction_db: float = 12.0) -> torch.Tensor:
    """Frequency-selective gate over a 1-D capture (length multiple of _HOP).

    Per-BIN gating, not per-frame: a modem transmission is a continuous
    narrowband signal, so quiet-frame floor estimates would call the signal
    itself noise. The per-bin median over time is compared against the
    wideband floor (the median across bins): persistent signal bands pass at
    unity, broadband hiss is attenuated by ``reduction_db``.
    """
    n = x.shape[0]
    n_frames = n // _HOP - 1
    # sqrt-Hann analysis AND synthesis: their product is Hann, which at 50%
    # hop sums to exactly 1.0, so unity-gain bands come back sample-exact.
    win = torch.sqrt(torch.hann_window(_FRAME, periodic=False, dtype=torch.float32, device=x.device))
    frames = x.unfold(0, _FRAME, _HOP)[:n_frames] * win
    spec = torch.fft.rfft(frames, dim=-1)
    mag = spec.abs()

    bin_med = _median(mag)  # persistent level per frequency bin
    floor = _median(bin_med) + 1e-12  # wideband noise floor estimate
    gain_min = 10.0 ** (-reduction_db / 20.0)
    gain = torch.clamp(bin_med / (3.0 * floor) - 1.0, 0.0, 1.0) * (1.0 - gain_min) + gain_min
    out_frames = torch.fft.irfft(spec * gain[None, :], _FRAME, dim=-1) * win

    # Overlap-add: every sample gets at most two terms (its frame's first
    # and second halves), so the order of the sums does not matter.
    halves = out_frames.reshape(n_frames, 2, _HOP)
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    out[: n_frames * _HOP] += halves[:, 0].reshape(-1)
    out[_HOP : (n_frames + 1) * _HOP] += halves[:, 1].reshape(-1)
    return out


def spectral_gate(samples, reduction_db: float = 12.0, device: DeviceLike = None) -> np.ndarray:
    """Denoise a capture on ``device`` (default: the card); returns float32
    numpy of the same length. Captures under 4 frames come back as they
    are."""
    x = np.asarray(samples, np.float32)
    n = len(x)
    if n < 4 * _FRAME:
        return x
    pad = (-n) % _HOP + _FRAME
    xp = torch.from_numpy(np.pad(x, (0, pad))).to(resolve_device(device))
    out = _gate(xp, float(reduction_db)).cpu().numpy()
    return out[:n].astype(np.float32)
