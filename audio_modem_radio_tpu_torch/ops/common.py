"""Host-side bit utilities shared by the port's modulators.

Counterpart of ``audio_modem_radio_tpu/ops/common.py:38-47``. The JAX
module's device-side sync and pack fallbacks are not carried over: the
port's CPU path is the plain PyTorch version of each sync-tail kernel
(``ops/kernels.py``).
"""

from __future__ import annotations

import numpy as np


def bytes_to_bits(data: bytes) -> np.ndarray:
    """bytes -> uint8 bit array, MSB first (matches the reference bit order)."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8/int bit array (MSB first) -> bytes; truncates trailing partial byte."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = (len(bits) // 8) * 8
    return np.packbits(bits[:n]).tobytes()
