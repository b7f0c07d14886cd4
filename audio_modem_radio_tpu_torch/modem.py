"""Mode registry and modulation dispatch of the PyTorch port.

Counterpart of ``audio_modem_radio_tpu/modem.py:490-650`` for the modes the
port carries so far: QPSK (differential QPSK on a 3 kHz carrier). The other
modes of the JAX registry arrive with their slices (ROADMAP.md, queue 1).
Receive runs batched through ``parallel.batch``; the single-capture
``demodulate`` ladder is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from .ops.psk import qpsk_modulate
from .utils.wavio import SAMPLE_RATE  # noqa: F401  (re-export)


@dataclass(frozen=True)
class ModeSpec:
    """One transmission mode: ``modulate(framed_bytes, symbol_rate) -> waveform``."""

    name: str
    modulate: Callable[[bytes, int], np.ndarray]


MODES: Dict[str, ModeSpec] = {
    "QPSK": ModeSpec("QPSK", lambda d, r: qpsk_modulate(d, r, 3000.0)),
}


def modulate(mode: str, framed: bytes, symbol_rate: int) -> np.ndarray:
    """Dispatch modulation by mode name; unknown or unported modes raise
    ValueError."""
    spec = MODES.get(mode)
    if spec is None:
        raise ValueError(f"Unknown mode: {mode} (the PyTorch port carries {sorted(MODES)})")
    return spec.modulate(framed, symbol_rate)
