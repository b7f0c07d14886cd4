"""Mode registry and modulation dispatch of the PyTorch port.

Counterpart of ``audio_modem_radio_tpu/modem.py:427-650`` for the modes the
port carries so far: FSK1200 (1200/2200 Hz tones at 1200 Bd), FSK9600 (the
same tones at 9600 Bd), FSK19200 (8/16 kHz at 19200 Bd), MSK (FSK with mark
6 kHz, space 6 kHz + the rate), FT8 (50 Bd FSK, 3000/3050 Hz), BPSK (DBPSK
on a 3 kHz carrier), QPSK (DQPSK, 3 kHz), 8PSK (real D8PSK on 12 kHz, or
under CONFIG ``modem.psk8_compat_alias`` the reference's DQPSK alias),
APSK16 (DQPSK, 12 kHz) and SSTV (DQPSK, 3 kHz).
The other modes of the JAX registry arrive with their slices (ROADMAP.md,
queue 1). Receive runs batched through ``parallel.batch``; the
single-capture ``demodulate`` ladder is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from .config import CONFIG
from .ops.fsk import fsk_high_speed_modulate, fsk_modulate
from .ops.psk import bpsk_modulate, psk8_real_modulate, qpsk_modulate
from .utils.wavio import SAMPLE_RATE  # noqa: F401  (re-export)


@dataclass(frozen=True)
class ModeSpec:
    """One transmission mode: ``modulate(framed_bytes, symbol_rate) -> waveform``."""

    name: str
    modulate: Callable[[bytes, int], np.ndarray]


def _psk8_mode_modulate(d, b, c, s=96000):
    """8PSK transmit: real D8PSK (3 Gray bits/symbol) unless CONFIG
    ``modem.psk8_compat_alias`` selects the reference-interoperable alias
    wire format, DQPSK."""
    if CONFIG.get("modem.psk8_compat_alias", False):
        return qpsk_modulate(d, b, c, s)
    return psk8_real_modulate(d, b, c, s)


def msk_modulate(d, b, c, s=96000):
    """MSK alias: FSK with mark = carrier, space = carrier + baud."""
    return fsk_modulate(d, b, c, c + b, s)


def ft8_modulate(d, b, c, s=96000):
    """FT8 alias: 50-baud FSK, mark = carrier, space = carrier + 50."""
    del b
    return fsk_modulate(d, 50, c, c + 50, s)


MODES: Dict[str, ModeSpec] = {
    "FSK1200": ModeSpec("FSK1200", lambda d, r: fsk_modulate(d, 1200, 1200.0, 2200.0)),
    "FSK9600": ModeSpec("FSK9600", lambda d, r: fsk_modulate(d, 9600)),
    "FSK19200": ModeSpec("FSK19200", lambda d, r: fsk_high_speed_modulate(d, 19200)),
    "BPSK": ModeSpec("BPSK", lambda d, r: bpsk_modulate(d, r, 3000.0)),
    "QPSK": ModeSpec("QPSK", lambda d, r: qpsk_modulate(d, r, 3000.0)),
    "8PSK": ModeSpec("8PSK", lambda d, r: _psk8_mode_modulate(d, r, 12000.0)),
    "APSK16": ModeSpec("APSK16", lambda d, r: qpsk_modulate(d, r, 12000.0)),
    # The reference GUI lists SSTV but ships no SSTV modulator; payloads ride
    # a DQPSK carrier.
    "SSTV": ModeSpec("SSTV", lambda d, r: qpsk_modulate(d, r, 3000.0)),
    "MSK": ModeSpec("MSK", lambda d, r: msk_modulate(d, r, 6000.0)),
    "FT8": ModeSpec("FT8", lambda d, r: ft8_modulate(d, r, 3000.0)),
}


def modulate(mode: str, framed: bytes, symbol_rate: int) -> np.ndarray:
    """Dispatch modulation by mode name; unknown or unported modes raise
    ValueError."""
    spec = MODES.get(mode)
    if spec is None:
        raise ValueError(f"Unknown mode: {mode} (the PyTorch port carries {sorted(MODES)})")
    return spec.modulate(framed, symbol_rate)
