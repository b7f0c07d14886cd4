"""Host audio I/O: playback, capture, and live receive sessions.

Capability parity with the reference's hardware layer:

* :class:`AudioPlayer` — playlist playback on pygame.mixer with play/pause/
  resume/stop and played-state tracking (reference
  filebeep_advanced_v2.py:1379-1432 + playlist coloring 1159-1203).
* :class:`Recorder` — microphone capture. Backend is sounddevice when
  installed (like the reference's WorkerRecord, filebeep_advanced_v2.py:282-331);
  :class:`FileRecorder` is a deterministic fake backend that "records" from a
  WAV file — the test strategy's point that WAV arrays are a complete fake
  audio backend (SURVEY.md §4).
* :func:`transmit` — play a modulated WAV inside a PTT context; unlike the
  reference (which un-keys as soon as playback *starts*,
  filebeep_advanced_v2.py:1241-1280), the radio stays keyed until playback
  actually finishes.
* :class:`ReceiveSession` — record for a duration, resample to 96 kHz (the
  reference feeds 48 kHz mic audio to 96 kHz demodulators unresampled — its
  documented capture defect), and decode on the card (or on ``device``).

All hardware imports are optional; everything degrades to explicit errors or
fake backends so the full pipeline is testable headless.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from .decoder import decode_from_buffer
from .ptt import PTTContext
from .utils.torchenv import DeviceLike, resolve_device
from .utils.wavio import SAMPLE_RATE, read_wav

logger = logging.getLogger("audio_modem_radio_tpu_torch")

try:
    import pygame

    PYGAME_AVAILABLE = True
except ImportError:  # pragma: no cover
    PYGAME_AVAILABLE = False

try:
    import sounddevice as sd

    SOUNDDEVICE_AVAILABLE = True
except ImportError:
    sd = None
    SOUNDDEVICE_AVAILABLE = False


class AudioPlayer:
    """Playlist playback on pygame.mixer."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        self.playlist: List[str] = []
        self.current: Optional[str] = None
        self.played: set = set()
        self.is_paused = False
        self._ready = False
        self.sample_rate = sample_rate

    def _ensure_mixer(self):
        if not PYGAME_AVAILABLE:
            raise RuntimeError("pygame not available for playback")
        if not self._ready:
            pygame.mixer.init(frequency=self.sample_rate)
            self._ready = True

    def add(self, path: str) -> None:
        if path not in self.playlist:
            self.playlist.append(path)

    def clear(self) -> None:
        self.playlist.clear()
        self.played.clear()
        self.current = None

    def load_file(self, path: str) -> None:
        self._ensure_mixer()
        pygame.mixer.music.load(path)
        self.current = path

    def play(self, path: Optional[str] = None) -> None:
        if path:
            self.load_file(path)
        self._ensure_mixer()
        pygame.mixer.music.play()
        self.is_paused = False
        if self.current:
            self.played.add(self.current)

    def pause(self) -> None:
        self._ensure_mixer()
        if self.is_paused:
            pygame.mixer.music.unpause()
        else:
            pygame.mixer.music.pause()
        self.is_paused = not self.is_paused

    def stop(self) -> None:
        if self._ready:
            pygame.mixer.music.stop()
        self.is_paused = False

    def is_busy(self) -> bool:
        return self._ready and pygame.mixer.music.get_busy()

    def state_of(self, path: str) -> str:
        """'playing' | 'played' | 'pending' — the playlist coloring states."""
        if path == self.current and self.is_busy():
            return "playing"
        return "played" if path in self.played else "pending"


class Recorder:
    """Microphone capture via sounddevice (when available)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 1):
        self.sample_rate = sample_rate
        self.channels = channels
        self._blocks: List[np.ndarray] = []
        self._stream = None
        self._lock = threading.Lock()
        self.volume_callback: Optional[Callable[[float], None]] = None

    def _callback(self, indata, frames, time_info, status):  # pragma: no cover
        with self._lock:
            self._blocks.append(indata.copy())
        if self.volume_callback:
            rms = float(np.sqrt(np.mean(indata**2)))
            # x15 scaling like the reference's level meter (:309-310).
            self.volume_callback(min(1.0, rms * 15))

    def start(self) -> None:
        if not SOUNDDEVICE_AVAILABLE:
            raise RuntimeError("sounddevice not available for capture")
        self._blocks = []
        self._stream = sd.InputStream(
            samplerate=self.sample_rate, channels=self.channels, callback=self._callback
        )
        self._stream.start()

    def drain(self) -> np.ndarray:
        """Take the samples captured so far WITHOUT stopping the stream.

        The continuous-capture primitive: a decode loop that alternates
        stop()/start() drops every sample that arrives between the two calls,
        so a frame straddling the gap is lost (the reference's 30 s one-shot
        capture sidesteps this by never looping). drain() just swaps the
        block list under the lock; capture never pauses.
        """
        with self._lock:
            if not self._blocks:
                return np.zeros(0, np.float32)
            blocks, self._blocks = self._blocks, []
        return np.concatenate(blocks)[:, 0].astype(np.float32)

    def stop(self) -> np.ndarray:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None
        with self._lock:
            if not self._blocks:
                return np.zeros(0, np.float32)
            data = np.concatenate(self._blocks)[:, 0].astype(np.float32)
            self._blocks = []
        return data

    def record(self, seconds: float) -> np.ndarray:
        self.start()
        time.sleep(seconds)
        return self.stop()


class FileRecorder(Recorder):
    """Fake capture backend: 'records' the contents of a WAV file."""

    def __init__(self, path: str):
        data, sr = read_wav(path)
        super().__init__(sample_rate=sr)
        self._data = data
        self._drained = False

    def start(self) -> None:
        pass

    def drain(self) -> np.ndarray:
        if self._drained:
            return np.zeros(0, np.float32)
        self._drained = True
        return self._data

    def stop(self) -> np.ndarray:
        return self._data

    def record(self, seconds: float) -> np.ndarray:
        n = int(seconds * self.sample_rate)
        return self._data[:n] if n < len(self._data) else self._data


def transmit(
    wav_path: str,
    ptt_port: Optional[str] = None,
    ptt_method: str = "RTS",
    player: Optional[AudioPlayer] = None,
    poll_interval: float = 0.1,
) -> None:
    """Play a WAV with the radio keyed for the whole duration.

    The reference's PTTContext exits as soon as playback *starts* and relies
    on a GUI poll timer to un-key at track end (filebeep_advanced_v2.py:
    1197-1199, 1241-1280); here the context spans actual playback.
    """
    player = player or AudioPlayer()
    with PTTContext(ptt_port, ptt_method):
        player.play(wav_path)
        while player.is_busy():
            time.sleep(poll_interval)


class ReceiveSession:
    """Record -> resample -> decode, the live-reception workflow.

    The decode runs on ``device`` (default: the card); without a card and
    without ``device="cpu"`` the session raises here, before recording.
    """

    def __init__(self, mode: str, symbol_rate: int, recorder: Optional[Recorder] = None,
                 registry=None, recv_dir: str = "recv", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.mode = mode
        self.symbol_rate = symbol_rate
        self.recorder = recorder or Recorder()
        self.registry = registry
        self.recv_dir = recv_dir

    def run(self, seconds: float = 30.0) -> List[str]:
        """Capture ``seconds`` of audio and decode it (reference records 30 s,
        filebeep_advanced_v2.py:1084). Resamples to 96 kHz — fixing the
        reference's unresampled 48 kHz mic-capture defect."""
        audio = self.recorder.record(seconds)
        if len(audio) == 0:
            return []
        return decode_from_buffer(
            audio,
            self.mode,
            self.symbol_rate,
            recv_dir=self.recv_dir,
            registry=self.registry,
            sample_rate=self.recorder.sample_rate,
            device=self.device,
        )
