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
    """The requested device; ``None`` means the card. The CPU is used only
    when the caller names it. Raises if a CUDA device is meant and none
    exists: there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
