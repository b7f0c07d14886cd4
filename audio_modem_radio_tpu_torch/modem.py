"""Mode registry and modulation dispatch of the PyTorch port.

Counterpart of ``audio_modem_radio_tpu/modem.py:490-650`` for the modes the
port carries so far: BPSK (DBPSK on a 3 kHz carrier), QPSK (DQPSK, 3 kHz),
8PSK (real D8PSK on 12 kHz, or under CONFIG ``modem.psk8_compat_alias`` the
reference's DQPSK alias), APSK16 (DQPSK, 12 kHz) and SSTV (DQPSK, 3 kHz).
The other modes of the JAX registry arrive with their slices (ROADMAP.md,
queue 1). Receive runs batched through ``parallel.batch``; the
single-capture ``demodulate`` ladder is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from .config import CONFIG
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


MODES: Dict[str, ModeSpec] = {
    "BPSK": ModeSpec("BPSK", lambda d, r: bpsk_modulate(d, r, 3000.0)),
    "QPSK": ModeSpec("QPSK", lambda d, r: qpsk_modulate(d, r, 3000.0)),
    "8PSK": ModeSpec("8PSK", lambda d, r: _psk8_mode_modulate(d, r, 12000.0)),
    "APSK16": ModeSpec("APSK16", lambda d, r: qpsk_modulate(d, r, 12000.0)),
    # The reference GUI lists SSTV but ships no SSTV modulator; payloads ride
    # a DQPSK carrier.
    "SSTV": ModeSpec("SSTV", lambda d, r: qpsk_modulate(d, r, 3000.0)),
}


def modulate(mode: str, framed: bytes, symbol_rate: int) -> np.ndarray:
    """Dispatch modulation by mode name; unknown or unported modes raise
    ValueError."""
    spec = MODES.get(mode)
    if spec is None:
        raise ValueError(f"Unknown mode: {mode} (the PyTorch port carries {sorted(MODES)})")
    return spec.modulate(framed, symbol_rate)
