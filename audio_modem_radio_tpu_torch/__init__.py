"""audio_modem_radio_tpu_torch — the PyTorch and CUDA port of audio_modem_radio_tpu.

It sits beside the JAX package, which stays the reference, and imports
``torch`` and numpy, never JAX. It carries the transmit pipeline
(``encoder.encode_file``: file -> compress -> optional payload FEC
container -> frame -> optional stream FEC -> modulate -> WAV) and the
receive of every mode of the JAX registry, batched and single capture:
DQPSK, DBPSK, D8PSK, FSK (FSK1200, FSK9600, FSK19200, MSK, FT8), OFDM4 and
OFDM8, DSSS, NEURAL and the Hellschreiber text modes. Batched: host shaping
into sample rows, overlapped rows, FIR or pixel windows, the pass-1 timing
(and, for PSK and OFDM, rotation) estimate, the PSK decide stage with a
magic matcher and a pack per PSK mode (OFDM's dibits take the DQPSK ones),
the FSK dual-tone, discriminator and quadrature detectors, DSSS's despread,
NEURAL's sync and codebook scoring and the glyph match. Single capture:
``decoder.decode_wav_file`` -> ``modem.demodulate`` -> the recovery ladder
with its FEC rungs, ``stream_fec=`` and ``denoise=``, with FSK9600's MLSE
and the coherent escalations. Thirteen hand-written CUDA kernels for the
NVIDIA H100 (``csrc/``), one for each Pallas kernel of the JAX package, and
two more for the MLSE's Viterbi and the convolutional code's Viterbi
decoder (``lax.scan``s in the JAX package) do the work on the card; the
native C++ host runtime (``native.py``) scans frames, loads WAV batches and
sweeps long Viterbi inputs. Entry points run on the card unless the caller
passes ``device="cpu"``; on tensors that lie on the CPU each kernel's
wrapper runs its plain PyTorch version.

The front ends are the JAX package's, carried over: the command line
(``cli.py``, ``amr-torch``), the console app (``app.py``,
``amr-torch-app``), the curses TUI (``tui.py``, ``amr-torch-tui``) and
the tkinter GUI (``gui.py``, ``amr-torch-gui``), with their host modules
``audio_io`` (playback, capture, ``ReceiveSession``), ``ptt``,
``observability``, ``intelligence`` and ``diagrams``. Their decodes take
``--device`` (``device=``): the card unless ``cpu`` is named.
"""

from .utils import torchenv  # noqa: F401  (pins float32 products to IEEE float32)
from .config import CONFIG, ConfigManager, get_quality_threshold, set_quality_threshold
from .framing import Frame, pack_frame, parse_frames
from .modem import MODES, SAMPLE_RATE, demodulate, modulate, wav_from_array

__version__ = "0.1.0"

__all__ = [
    "CONFIG",
    "ConfigManager",
    "get_quality_threshold",
    "set_quality_threshold",
    "Frame",
    "pack_frame",
    "parse_frames",
    "MODES",
    "SAMPLE_RATE",
    "demodulate",
    "modulate",
    "wav_from_array",
    "__version__",
]
