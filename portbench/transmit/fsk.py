"""CPFSK transmitter of the ``fsk`` family, written out plainly.

The upstream ``fsk_high_speed`` wire format (szumanski/Audio-Modem-Radio
``modem.py:351-356``): ``round(sample_rate / baud)`` samples a bit, a 1 on
the mark tone and a 0 on the space tone, the phase continuous across bits
(each bit starts where the last one ended, in whole units of 1/sample_rate
cycles), amplitude 0.9, a ``0xAA`` x 4 preamble, then the bytes MSB first.
"""

from __future__ import annotations

import math

import torch

from ..channel import cfo_phase

PREAMBLE = b"\xAA\xAA\xAA\xAA"
AMPLITUDE = 0.9


def samples_per_bit(cfg: dict) -> int:
    return int(round(cfg["sample_rate"] / cfg["symbol_rate"]))


def nominal_power(cfg: dict) -> float:
    return AMPLITUDE * AMPLITUDE / 2


def payload_bits(n_samples: int, cfg: dict) -> int:
    return -(-n_samples // samples_per_bit(cfg)) - 8 * len(PREAMBLE)


def modulate(bits: torch.Tensor, n_out: int, lead: int, offset_hz: int, cfg: dict) -> torch.Tensor:
    """As ``transmit.psk.modulate``: (n_out,) float32, zeros for ``lead``
    samples, then the preamble and ``bits`` until the capture ends, shifted
    by ``offset_hz``."""
    dev = bits.device
    spb, sr = samples_per_bit(cfg), int(cfg["sample_rate"])
    n_tx = n_out - lead
    n_bits = -(-n_tx // spb)
    pre = torch.tensor(list(PREAMBLE), dtype=torch.uint8, device=dev)
    pre_bits = ((pre[:, None] >> torch.arange(7, -1, -1, device=dev)) & 1).reshape(-1)
    stream = torch.cat([pre_bits, bits[: n_bits - len(pre_bits)]]).to(torch.int64)
    inc_mark = int(round(cfg["mark_hz"] * spb)) % sr
    inc_space = int(round(cfg["space_hz"] * spb)) % sr
    incs = torch.where(stream == 1, inc_mark, inc_space)
    start_units = (torch.cumsum(incs, 0) - incs) % sr  # each bit's starting phase
    freq = torch.where(stream == 1, float(cfg["mark_hz"]), float(cfg["space_hz"])).to(torch.float64)
    k = torch.arange(spb, dtype=torch.float64, device=dev)
    arg = 2 * math.pi * (freq[:, None] * k[None, :] + start_units.to(torch.float64)[:, None]) / sr
    arg = arg.reshape(-1)[:n_tx] + cfo_phase(lead, n_tx, offset_hz, sr, dev)
    out = torch.zeros(n_out, dtype=torch.float32, device=dev)
    out[lead:] = (AMPLITUDE * torch.sin(arg)).to(torch.float32)
    return out
