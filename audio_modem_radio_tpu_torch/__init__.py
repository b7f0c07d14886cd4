"""audio_modem_radio_tpu_torch — the PyTorch and CUDA port of audio_modem_radio_tpu.

It sits beside the JAX package, which stays the reference, and imports
``torch`` and numpy, never JAX. It carries batched DQPSK, DBPSK and D8PSK
receive end to end: host shaping into blocked sample rows, the pass-1
timing and rotation estimate, and six hand-written CUDA kernels for the
NVIDIA H100 (``csrc/``): the decide stage and, per mode, a magic matcher
and a pack. On tensors that lie on the CPU each kernel's wrapper runs its
plain PyTorch version instead.
"""

from .utils import torchenv  # noqa: F401  (pins float32 products to IEEE float32)
from .config import CONFIG, ConfigManager
from .framing import Frame, pack_frame, parse_frames
from .modem import MODES, SAMPLE_RATE, modulate

__version__ = "0.1.0"

__all__ = [
    "CONFIG",
    "ConfigManager",
    "Frame",
    "pack_frame",
    "parse_frames",
    "MODES",
    "SAMPLE_RATE",
    "modulate",
    "__version__",
]
