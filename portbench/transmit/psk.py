"""DQPSK transmitter of the ``psk`` family, written out plainly.

The upstream wire format (szumanski/Audio-Modem-Radio ``modem.py:138-266``):
``int(sample_rate / baud)`` samples a symbol, a sine carrier restarted at
every symbol under a 10% linear ramp, the ``[0,0]*30 + [1,1]*10`` preamble,
then the bytes MSB first as Gray-coded quarter-turn phase steps
(00 -> 0, 01 -> +1, 11 -> +2, 10 -> +3 quarter turns).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..channel import cfo_phase

PREAMBLE_BITS = [0, 0] * 30 + [1, 1] * 10


def samples_per_symbol(cfg: dict) -> int:
    return int(cfg["sample_rate"] / cfg["symbol_rate"])


def envelope(sps: int) -> np.ndarray:
    """The per-symbol amplitude: linear ramps over 10% of the symbol at both ends."""
    env = np.ones(sps)
    ramp = int(sps * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    return env


def nominal_power(cfg: dict) -> float:
    """Mean square of the transmitted carrier: the envelope's mean square / 2."""
    return float(np.mean(envelope(samples_per_symbol(cfg)) ** 2) / 2)


def payload_bits(n_samples: int, cfg: dict) -> int:
    """Payload bits a transmission of ``n_samples`` samples carries."""
    return 2 * -(-n_samples // samples_per_symbol(cfg)) - len(PREAMBLE_BITS)


def modulate(bits: torch.Tensor, n_out: int, lead: int, offset_hz: int, cfg: dict) -> torch.Tensor:
    """(n_out,) float32 capture: zeros for ``lead`` samples, then the
    preamble and ``bits`` (uint8 0/1 on the device, at least
    :func:`payload_bits` of them) until the capture ends, the passband
    shifted by ``offset_hz``."""
    dev = bits.device
    sps, sr = samples_per_symbol(cfg), int(cfg["sample_rate"])
    n_tx = n_out - lead
    n_sym = -(-n_tx // sps)
    pre = torch.tensor(PREAMBLE_BITS, dtype=torch.int64, device=dev)
    stream = torch.cat([pre, bits[: 2 * n_sym - len(PREAMBLE_BITS)].to(torch.int64)])
    hi, lo = stream[0::2], stream[1::2]
    quarter_turns = torch.cumsum(hi * 3 + lo * (1 - 2 * hi), 0) % 4
    k = torch.arange(sps, dtype=torch.float64, device=dev)
    w = 2 * math.pi * float(cfg["carrier_hz"]) * k / sr
    env = torch.from_numpy(envelope(sps)).to(dev)
    arg = w[None, :] + (math.pi / 2) * quarter_turns.to(torch.float64)[:, None]
    arg = arg.reshape(-1)[:n_tx] + cfo_phase(lead, n_tx, offset_hz, sr, dev)
    x = torch.sin(arg) * env.repeat(n_sym)[:n_tx]
    out = torch.zeros(n_out, dtype=torch.float32, device=dev)
    out[lead:] = x.to(torch.float32)
    return out
