"""Device selection for the PyTorch port.

Counterpart of ``audio_modem_radio_tpu/utils/jaxenv.py``: where the JAX
package steers JAX's platform choice, the port names its device explicitly
on every entry point. Importing this module pins float32 matrix products
and convolutions to full IEEE float32: TF32 keeps ~10 mantissa bits, enough
to move differential phasors across a Gray sector boundary, and the
receive path's decisions are held bitwise against the reference.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The requested device; ``None`` means the card when one is present,
    else the CPU. Raises if a CUDA device is requested and none exists."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is false")
    return dev
