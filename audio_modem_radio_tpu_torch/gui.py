"""Graphical desktop application (tkinter) — the reference GUI, rebuilt.

The reference ships a PyQt5 four-tab desktop window (`ModernMainWindow`,
reference filebeep_advanced_v2.py:404-1373): Encode / Decode / Player /
Analysis tabs, a mode-diagram widget (:148-242), a live volume meter
(:309-310), a colored playlist (:1159-1203), PTT controls (:806-854), a log
pane with save/clear (:927-948) and a CPU/RAM/disk status bar (:245-276).
PyQt5 is not in this environment; tkinter (stdlib) is, so this module
provides the same four-tab graphical surface on tkinter/ttk, launchable
with::

    python -m audio_modem_radio_tpu_torch.gui [--device cpu]

Decodes, recordings and the live monitor run on the CUDA card unless
``--device`` (or ``device=``) names another torch device; without a card
the worker's device error arrives as an ``("error", name, msg)`` event and
nothing is decoded on the CPU.

Architecture: everything testable lives OUTSIDE tk —

* :class:`GuiViewModel` — all state and actions. Long operations (encode,
  decode, record) run on daemon worker threads (the reference uses QThreads,
  :282-375) and report through a thread-safe ``queue.Queue`` of events that
  the tk layer drains on an ``after()`` timer. Fully drivable headless.
* :func:`mode_diagram_primitives` — the mode-diagram widget's drawing list
  (lines/rects/ovals/text in widget coordinates), derived from the REAL
  modulators exactly like :mod:`.diagrams`, so the cartoon can't drift from
  the wire format. The tk layer merely replays primitives onto a Canvas.
* :class:`FileBeepWindow` — the thin tk shell: widget construction, event
  pump, and the reference's three poll timers (player 500 ms, stats 2 s,
  assemblies 5 s; filebeep_advanced_v2.py:950-964).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import CONFIG
from .observability import AnalyticsStore, LogManager, PerformanceMonitor, setup_logging
from .utils.torchenv import DeviceLike

__all__ = ["GuiViewModel", "mode_diagram_primitives", "FileBeepWindow", "main"]


# --- mode diagram primitives (headless-testable) --------------------------------

Primitive = Tuple  # ("polyline", [(x, y), ...], color) | ("rect", x0, y0, x1, y1, fill)
#                  | ("oval", x0, y0, x1, y1, fill) | ("text", x, y, s, color)


def _wave_polyline(wave: np.ndarray, width: int, height: int, y0: int = 0) -> Primitive:
    """Scale a waveform into a polyline across the full width."""
    wave = np.asarray(wave, np.float64)
    peak = float(np.max(np.abs(wave))) or 1.0
    n = len(wave)
    xs = np.linspace(2, width - 3, min(n, 2 * width))
    idx = np.linspace(0, n - 1, len(xs)).astype(int)
    mid = y0 + height / 2
    ys = mid - (wave[idx] / peak) * (height / 2 - 2)
    return ("polyline", list(zip(xs.tolist(), ys.tolist())), "#3daee9")


def _spectrum_rects(
    wave: np.ndarray, width: int, height: int, y0: int, sample_rate: int = 96000
) -> List[Primitive]:
    """Log-spectrum bars 0..24 kHz as filled rects (diagrams._spectrum_bars)."""
    n = min(len(wave), 1 << 15)
    if n == 0:
        return []
    spec = np.abs(np.fft.rfft(np.asarray(wave[:n], np.float64) * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1 / sample_rate)
    keep = freqs <= 24000
    spec = spec[keep]
    bars = max(16, width // 6)
    edges = np.linspace(0, len(spec), bars + 1).astype(int)
    cols = np.array(
        [spec[edges[i] : max(edges[i] + 1, edges[i + 1])].max() for i in range(bars)]
    )
    cols = cols / (cols.max() or 1.0)
    out: List[Primitive] = []
    bw = (width - 4) / bars
    for i, v in enumerate(cols):
        h = float(v) * (height - 4)
        if h >= 0.5:
            x = 2 + i * bw
            out.append(("rect", x, y0 + height - 2 - h, x + bw * 0.85, y0 + height - 2, "#27ae60"))
    return out


def mode_diagram_primitives(
    mode: str, symbol_rate: int = 9600, width: int = 360, height: int = 180
) -> List[Primitive]:
    """Drawing list for a mode's diagram panel, from its real modulator.

    The reference paints static cartoons (ModeDiagramWidget,
    filebeep_advanced_v2.py:148-242: FSK square wave, PSK flips, QPSK
    constellation, OFDM humps); here every picture is synthesized from the
    actual wire waveform. Returns primitives in widget coordinates.
    """
    from .modem import MODES, modulate

    mode = mode.upper()
    prims: List[Primitive] = [("text", width / 2, 10, mode, "#eeeeee")]
    if mode not in MODES:
        prims.append(("text", width / 2, height / 2, f"unknown mode {mode}", "#e74c3c"))
        return prims
    try:
        if mode in ("HELLSCHREIBER", "FELD_HELL", "SLOW_HELL"):
            from .ops.hell import _glyph_pixel_templates

            tmpl = _glyph_pixel_templates()
            px = min((width - 20) / (4 * 9), (height - 40) / 7)
            for k, ch in enumerate("HELL"):
                glyph = np.asarray(tmpl[ord(ch) - 32]).reshape(7, 7)
                gx = 10 + k * 9 * px
                for r in range(7):
                    for c in range(7):
                        # LSB-first wire order (reference hellschreiber.py).
                        if glyph[r][6 - c]:
                            x, y = gx + c * px, 25 + r * px
                            prims.append(("rect", x, y, x + px - 1, y + px - 1, "#f1c40f"))
            return prims

        if mode == "NEURAL":
            from .ops.neural import _codebook

            cb = np.asarray(_codebook())
            pts = np.stack([cb[:24, 0], cb[:24, 8]], axis=1)
            pts = pts / (np.max(np.abs(pts)) or 1.0)
            cx, cy, rr = width / 2, 20 + (height - 30) / 2, (min(width, height) - 40) / 2
            prims.append(("polyline", [(cx - rr, cy), (cx + rr, cy)], "#555555"))
            prims.append(("polyline", [(cx, cy - rr), (cx, cy + rr)], "#555555"))
            for x, y in pts:
                px, py = cx + x * rr, cy - y * rr
                prims.append(("oval", px - 3, py - 3, px + 3, py + 3, "#9b59b6"))
            return prims

        demo = bytes([0x5A, 0xC3])
        wave = np.asarray(modulate(mode, demo, symbol_rate), np.float64)

        if mode.startswith("OFDM"):
            prims.append(("text", width / 2, 25, "subcarrier spectrum", "#aaaaaa"))
            prims.extend(_spectrum_rects(wave, width, height - 40, 35))
            return prims
        if mode.startswith("FSK") or mode in ("MSK", "FT8"):
            spsym = int(96000 / MODES[mode].fixed_baud) if MODES[mode].fixed_baud else 40
            half = (height - 30) // 2
            prims.append(_wave_polyline(wave[: 6 * max(spsym, 16)], width, half, 20))
            prims.extend(_spectrum_rects(wave, width, half - 5, 25 + half))
            return prims

        # PSK family: waveform + Gray differential constellation.
        spsym = max(int(96000 / symbol_rate), 4)
        half = (height - 30) // 2
        prims.append(_wave_polyline(wave[: 6 * spsym], width, half, 20))
        cy, rr = 25 + half + (half - 10) / 2, (half - 14) / 2
        cx = width / 2
        prims.append(("polyline", [(cx - rr - 8, cy), (cx + rr + 8, cy)], "#555555"))
        prims.append(("polyline", [(cx, cy - rr - 4), (cx, cy + rr + 4)], "#555555"))
        labels = ["0", "", "1", ""] if mode in ("BPSK", "PSK31", "DSSS") else ["00", "01", "11", "10"]
        for (dx, dy), lab in zip([(1, 0), (0, 1), (-1, 0), (0, -1)], labels):
            px, py = cx + dx * rr, cy - dy * rr
            prims.append(("oval", px - 4, py - 4, px + 4, py + 4, "#e67e22"))
            if lab:
                prims.append(("text", px + 14, py - 8, lab, "#eeeeee"))
        return prims
    except Exception as exc:  # diagrams must never crash a workflow
        prims.append(("text", width / 2, height / 2, f"(unavailable: {exc})", "#e74c3c"))
        return prims


# --- view model ------------------------------------------------------------------


class GuiViewModel:
    """All GUI state and actions; emits events on a thread-safe queue.

    Event tuples (first element is the kind):
      ("log", msg)                 — log-pane line
      ("progress", i, n)           — encode part progress (EncodeWorker :363)
      ("encoded", [wav_paths])     — encode finished
      ("decoded", [saved_paths])   — decode / record-decode finished
      ("error", context, msg)      — any worker failure
      ("level", float)             — live input level 0..1 (meter, :309-310)
    """

    def __init__(self, playlist_path: str = "playlist.json", device: DeviceLike = None):
        self.device = device  # of every decode; None: the card
        self.logger = setup_logging(
            console=False, to_file=bool(CONFIG.get("ui.auto_save_logs", True))
        )
        self.log_manager = LogManager()
        self.analytics = AnalyticsStore()
        self.monitor = PerformanceMonitor()
        self.events: "queue.Queue[tuple]" = queue.Queue()

        self.mode = "QPSK"
        self.symbol_rate = 9600
        self.compress = True
        self.use_fec = bool(CONFIG.get("modem.fec_enabled", False))
        self.split = False
        self.part_minutes = 1

        self.playlist_path = playlist_path
        from .app import load_playlist_file

        loaded, self.restored_played = load_playlist_file(playlist_path)
        self.playlist: List[str] = loaded or []

        self.ptt_port: Optional[str] = None
        self.ptt_method = "RTS"
        self._player = None
        self._busy = threading.Event()
        self._monitor_stop = threading.Event()
        self._worker_name: Optional[str] = None

    # -- infrastructure ----------------------------------------------------

    @property
    def player(self):
        if self._player is None:
            from .audio_io import AudioPlayer

            self._player = AudioPlayer()
        return self._player

    def _emit(self, *event) -> None:
        self.events.put(event)

    def log(self, msg: str) -> None:
        self.logger.info(msg)
        self._emit("log", msg)

    def _spawn(self, name: str, fn: Callable[[], None]) -> threading.Thread:
        """One worker at a time, like the reference's single EncodeWorker."""
        if self._busy.is_set():
            self._emit("error", name, "another operation is running")
            return threading.Thread()  # dummy, not started

        def run():
            try:
                fn()
            except Exception as e:  # worker errors surface as events
                self.logger.exception("%s failed", name)
                self._emit("error", name, str(e))
            finally:
                self._worker_name = None
                self._busy.clear()

        self._busy.set()
        self._worker_name = name
        t = threading.Thread(target=run, name=f"amr-gui-{name}", daemon=True)
        t.start()
        return t

    @property
    def busy(self) -> bool:
        return self._busy.is_set()

    # -- encode tab ----------------------------------------------------------

    def transmission_preview(self, path: str) -> str:
        from .encoder import calculate_transmission_stats

        if not path or not os.path.exists(path):
            return ""
        stats = calculate_transmission_stats(
            os.path.getsize(path), self.mode, self.symbol_rate, self.compress
        )
        return (
            f"~{stats['duration_sec']:.1f}s on air at {stats['bytes_per_sec']:.0f} B/s "
            f"(compression ratio {stats['compression_ratio']})"
        )

    def start_encode(self, path: str) -> threading.Thread:
        """Encode on a worker thread (reference EncodeWorker, :334-375)."""

        def work():
            from .encoder import encode_file_paths

            self.log(f"encoding {path} as {self.mode}@{self.symbol_rate}")
            paths = encode_file_paths(
                path,
                mode=self.mode,
                compress=self.compress,
                symbol_rate=self.symbol_rate,
                split_large_files=self.split,
                target_duration_min=self.part_minutes,
                use_fec=self.use_fec,
                progress_callback=lambda i, n: self._emit("progress", i, n),
            )
            self.analytics.record_encode(self.mode, os.path.getsize(path))
            self.analytics.save()
            for p in paths:
                self.add_to_playlist(p)
            self.log(f"encoded -> {', '.join(paths)}")
            self._emit("encoded", paths)

        return self._spawn("encode", work)

    def cancel_encode(self) -> None:
        from .encoder import cancel_encoding

        cancel_encoding()
        self.log("encode cancellation requested")

    # -- decode tab ----------------------------------------------------------

    def start_decode(self, path: str) -> threading.Thread:
        def work():
            from .decoder import decode_wav_file

            self.log(f"decoding {path} as {self.mode}@{self.symbol_rate}")
            saved = decode_wav_file(path, self.mode, self.symbol_rate, device=self.device)
            self.analytics.record_decode(
                self.mode, sum(os.path.getsize(p) for p in saved), ok=bool(saved)
            )
            self.analytics.save()
            self.log(f"recovered {len(saved)} file(s)")
            self._emit("decoded", saved)

        return self._spawn("decode", work)

    def start_record(self, seconds: float = 30.0, recorder=None) -> threading.Thread:
        """Live capture -> decode (reference WorkerRecord, :282-331), with the
        input level streamed as ("level", v) events and the capture correctly
        resampled (the reference feeds 48 kHz mic audio to 96 kHz
        demodulators unresampled — its documented defect)."""

        def work():
            from .audio_io import ReceiveSession, Recorder, SOUNDDEVICE_AVAILABLE

            rec = recorder
            if rec is None:
                if not SOUNDDEVICE_AVAILABLE:
                    raise RuntimeError("sounddevice not installed; live capture unavailable")
                rec = Recorder()
            rec.volume_callback = lambda level: self._emit("level", level)
            self.log(f"recording {seconds:.0f}s...")
            saved = ReceiveSession(self.mode, self.symbol_rate, rec, device=self.device).run(seconds)
            self.log(f"recovered {len(saved)} file(s) from capture")
            self._emit("decoded", saved)

        return self._spawn("record", work)

    def start_monitor(self, recorder=None, poll_s: float = 1.0) -> threading.Thread:
        """Continuous receive: drain the mic into a StreamingDecoder so files
        surface AS FRAMES COMPLETE (the reference can only record a fixed
        30 s window and decode at the end, filebeep_advanced_v2.py:282-331).
        Runs until :meth:`stop_monitor`; each newly saved file arrives as a
        ("decoded", [paths]) event."""

        def work():
            from .audio_io import Recorder, SOUNDDEVICE_AVAILABLE
            from .streaming import StreamingDecoder
            from .utils.torchenv import resolve_device

            device = resolve_device(self.device)  # no card: fail before capturing
            rec = recorder
            if rec is None:
                if not SOUNDDEVICE_AVAILABLE:
                    raise RuntimeError("sounddevice not installed; live capture unavailable")
                rec = Recorder()
            rec.volume_callback = lambda level: self._emit("level", level)
            dec = StreamingDecoder(
                self.mode, self.symbol_rate, sample_rate=rec.sample_rate, device=device
            )
            self._monitor_stop.clear()
            rec.start()
            self.log(f"monitoring ({self.mode}@{self.symbol_rate}); files surface live")
            quiet = 0
            try:
                while not self._monitor_stop.wait(poll_s):
                    chunk = rec.drain()
                    if len(chunk):
                        quiet = 0
                        saved = dec.feed(chunk)
                        if saved:
                            self._emit("decoded", saved)
                    else:
                        # A live mic always produces samples (silence
                        # included); empty drains mean the stream paused or
                        # ended — decode what's pending instead of sitting
                        # on a partial window.
                        quiet += 1
                        if quiet == 2 and dec.pending:
                            saved = dec.flush()
                            if saved:
                                self._emit("decoded", saved)
            finally:
                tail = rec.stop()
                saved = (dec.feed(tail) if len(tail) else []) + dec.flush()
                if saved:
                    self._emit("decoded", saved)
                self.log("monitor stopped")

        return self._spawn("monitor", work)

    def stop_monitor(self) -> None:
        self._monitor_stop.set()

    @property
    def monitoring(self) -> bool:
        return self.busy and self._worker_name == "monitor"

    def reception_stats(self) -> dict:
        from .decoder import get_reception_stats

        return get_reception_stats()

    def assembly_status(self) -> List[dict]:
        from .decoder import get_assembly_status

        return get_assembly_status()

    # -- player tab ----------------------------------------------------------

    def add_to_playlist(self, path: str) -> None:
        if path not in self.playlist:
            self.playlist.append(path)
        self.save_playlist()

    def clear_playlist(self) -> None:
        self.playlist.clear()
        self.restored_played.clear()
        self.player.clear()
        self.save_playlist()

    def save_playlist(self) -> None:
        from .app import save_playlist_file

        played = (self._player.played if self._player else set()) | self.restored_played
        save_playlist_file(self.playlist_path, self.playlist, played)

    def playlist_states(self) -> List[Tuple[str, str]]:
        """(path, 'playing'|'played'|'pending') rows — the coloring states
        (reference playlist coloring, filebeep_advanced_v2.py:1159-1203)."""
        rows = []
        for p in self.playlist:
            state = self.player.state_of(p)
            if state == "pending" and p in self.restored_played:
                state = "played"
            rows.append((p, state))
        return rows

    def play(self, index: int) -> None:
        self.player.play(self.playlist[index])
        self.save_playlist()
        self.log(f"playing {self.playlist[index]}")

    def pause(self) -> None:
        self.player.pause()

    def stop(self) -> None:
        self.player.stop()

    def ptt_ports(self) -> List[str]:
        from .ptt import PTTManager

        return PTTManager.get_available_ports()

    def ptt_test(self) -> None:
        """Key the radio for half a second (reference PTT test button :840)."""
        from .ptt import PTTContext

        with PTTContext(self.ptt_port, self.ptt_method):
            time.sleep(0.5)
        self.log(f"PTT test on {self.ptt_port or 'SIM'} via {self.ptt_method}")

    def transmit(self, index: int) -> threading.Thread:
        """Play with the radio keyed for the WHOLE playback (the reference
        un-keys as soon as playback starts; audio_io.transmit fixes that)."""
        path = self.playlist[index]

        def work():
            from .audio_io import transmit

            self.log(f"transmitting {path} (PTT {self.ptt_port or 'none'})")
            transmit(path, self.ptt_port, self.ptt_method, self.player)
            self.save_playlist()
            self._emit("log", f"transmission of {path} complete")

        return self._spawn("transmit", work)

    # -- analysis tab ----------------------------------------------------------

    def analyze(self, wav_path: Optional[str] = None) -> str:
        from .intelligence import analyze_channel, get_recommended_mode

        samples = None
        if wav_path and os.path.exists(wav_path):
            from .utils.wavio import read_wav

            samples, _ = read_wav(wav_path)
        conditions = analyze_channel(samples)
        return (
            f"SNR {conditions['snr_db']:.1f} dB -> recommended mode "
            f"{get_recommended_mode(conditions)}"
        )

    def host_status(self) -> str:
        info = self.monitor.sample()
        parts = []
        for key, label in (
            ("cpu_percent", "CPU"),
            ("ram_percent", "RAM"),
            ("disk_percent", "disk"),
        ):
            if key in info:
                parts.append(f"{label} {info[key]:.0f}%")
        if info.get("devices"):
            parts.append(", ".join(info["devices"][:2]))
        return " | ".join(parts) or "status unavailable"

    # -- log pane ----------------------------------------------------------

    def log_tail(self, lines: int = 200) -> List[str]:
        if os.path.exists(self.log_manager.log_file):
            with open(self.log_manager.log_file, encoding="utf-8") as f:
                return [line.rstrip() for line in f.readlines()[-lines:]]
        return []

    def save_log_to(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.log_tail(10_000)) + "\n")


# --- tkinter shell ------------------------------------------------------------------

_BG, _FG, _ACCENT = "#232629", "#eeeeee", "#3daee9"


class FileBeepWindow:
    """The tk shell. Construct only when a display is available."""

    def __init__(self, root=None, vm: Optional[GuiViewModel] = None, device: DeviceLike = None):
        import tkinter as tk
        from tkinter import ttk

        self.tk, self.ttk = tk, ttk
        self.vm = vm or GuiViewModel(device=device)
        self.root = root or tk.Tk()
        self.root.title("Audio Modem Radio (CUDA) — FileBeep rebuild")
        self.root.configure(bg=_BG)
        self.root.geometry("900x680")

        style = ttk.Style(self.root)
        try:
            style.theme_use("clam")
        except tk.TclError:
            pass
        style.configure(".", background=_BG, foreground=_FG, fieldbackground="#31363b")
        style.configure("TNotebook.Tab", padding=(12, 6))
        style.map("TNotebook.Tab", background=[("selected", _ACCENT)])

        self.notebook = ttk.Notebook(self.root)
        self.notebook.pack(fill="both", expand=True, padx=6, pady=6)
        self._build_encode_tab()
        self._build_decode_tab()
        self._build_player_tab()
        self._build_analysis_tab()
        self._build_log_pane()
        self._build_status_bar()

        # Reference poll cadence: player 500 ms, metrics 2 s, assemblies 5 s
        # (filebeep_advanced_v2.py:950-964); plus a fast event-queue pump.
        self.root.after(100, self._pump_events)
        self.root.after(500, self._refresh_player)
        self.root.after(2000, self._refresh_stats)
        self.root.after(5000, self._refresh_assemblies)
        self.root.protocol("WM_DELETE_WINDOW", self._on_close)
        self.vm.log("application started")

    # -- tab builders -------------------------------------------------------

    def _labeled(self, parent, text):
        frame = self.ttk.Frame(parent)
        frame.pack(fill="x", padx=8, pady=3)
        self.ttk.Label(frame, text=text, width=16).pack(side="left")
        return frame

    def _build_encode_tab(self):
        from .modem import MODES

        tab = self.ttk.Frame(self.notebook)
        self.notebook.add(tab, text="Encode")

        f = self._labeled(tab, "File")
        self.encode_path = self.tk.StringVar()
        self.ttk.Entry(f, textvariable=self.encode_path, width=52).pack(side="left", padx=4)
        self.ttk.Button(f, text="Browse…", command=self._pick_encode_file).pack(side="left")

        f = self._labeled(tab, "Mode")
        self.mode_var = self.tk.StringVar(value=self.vm.mode)
        combo = self.ttk.Combobox(f, textvariable=self.mode_var, values=list(MODES), width=16)
        combo.pack(side="left", padx=4)
        combo.bind("<<ComboboxSelected>>", lambda e: self._mode_changed())

        f = self._labeled(tab, "Symbol rate")
        self.rate_var = self.tk.IntVar(value=self.vm.symbol_rate)
        # Reference spin range 100..19200, default 9600 (:669-671).
        self.tk.Spinbox(
            f, from_=100, to=19200, textvariable=self.rate_var, width=8, increment=100
        ).pack(side="left", padx=4)
        self.compress_var = self.tk.BooleanVar(value=self.vm.compress)
        self.ttk.Checkbutton(f, text="compression", variable=self.compress_var).pack(
            side="left", padx=10
        )
        self.fec_var = self.tk.BooleanVar(value=self.vm.use_fec)
        self.ttk.Checkbutton(f, text="FEC", variable=self.fec_var).pack(side="left")

        f = self._labeled(tab, "Multi-part")
        self.split_var = self.tk.BooleanVar(value=False)
        self.ttk.Checkbutton(f, text="split, minutes/part:", variable=self.split_var).pack(
            side="left"
        )
        self.part_min_var = self.tk.IntVar(value=1)
        self.tk.Spinbox(f, from_=1, to=60, textvariable=self.part_min_var, width=4).pack(
            side="left", padx=4
        )

        self.preview_label = self.ttk.Label(tab, text="")
        self.preview_label.pack(fill="x", padx=12, pady=2)

        f = self.ttk.Frame(tab)
        f.pack(fill="x", padx=8, pady=6)
        self.encode_button = self.ttk.Button(f, text="🚀 Start encode", command=self._start_encode)
        self.encode_button.pack(side="left")
        self.ttk.Button(f, text="Cancel", command=self.vm.cancel_encode).pack(side="left", padx=6)
        self.progress = self.ttk.Progressbar(tab, maximum=100)
        self.progress.pack(fill="x", padx=12, pady=4)

        # Mode diagram canvas (reference ModeDiagramWidget :148-242).
        self.diagram = self.tk.Canvas(tab, width=360, height=180, bg="#1b1e20", highlightthickness=0)
        self.diagram.pack(padx=12, pady=8, anchor="w")
        self._draw_diagram()

    def _build_decode_tab(self):
        tab = self.ttk.Frame(self.notebook)
        self.notebook.add(tab, text="Decode")

        f = self._labeled(tab, "Capture")
        self.record_button = self.ttk.Button(f, text="🔴 Record 30 s", command=self._start_record)
        self.record_button.pack(side="left")
        self.monitor_button = self.ttk.Button(f, text="📡 Monitor", command=self._toggle_monitor)
        self.monitor_button.pack(side="left", padx=4)
        self.ttk.Label(f, text="level:").pack(side="left", padx=(14, 4))
        self.meter = self.tk.Canvas(f, width=200, height=14, bg="#1b1e20", highlightthickness=0)
        self.meter.pack(side="left")

        f = self._labeled(tab, "WAV file")
        self.decode_path = self.tk.StringVar()
        self.ttk.Entry(f, textvariable=self.decode_path, width=52).pack(side="left", padx=4)
        self.ttk.Button(f, text="Browse…", command=self._pick_decode_file).pack(side="left")
        self.ttk.Button(f, text="📁 Decode", command=self._start_decode).pack(side="left", padx=6)

        self.stats_text = self._report_pane(tab, "Reception stats (2 s refresh)")
        self.assembly_text = self._report_pane(tab, "Assemblies in flight (5 s refresh)")

    def _report_pane(self, parent, title):
        self.ttk.Label(parent, text=title).pack(anchor="w", padx=10, pady=(8, 0))
        text = self.tk.Text(parent, height=6, bg="#1b1e20", fg=_FG, state="disabled")
        text.pack(fill="both", expand=True, padx=10, pady=2)
        return text

    def _build_player_tab(self):
        tab = self.ttk.Frame(self.notebook)
        self.notebook.add(tab, text="Player")

        self.playlist_box = self.tk.Listbox(
            tab, bg="#1b1e20", fg=_FG, selectbackground=_ACCENT, height=12
        )
        self.playlist_box.pack(fill="both", expand=True, padx=10, pady=6)

        f = self.ttk.Frame(tab)
        f.pack(fill="x", padx=8, pady=4)
        for label, cmd in (
            ("▶ Play", self._play_selected),
            ("⏸ Pause", self.vm.pause),
            ("⏹ Stop", self.vm.stop),
            ("📻 TX (PTT)", self._tx_selected),
            ("Clear", self._clear_playlist),
        ):
            self.ttk.Button(f, text=label, command=cmd).pack(side="left", padx=3)

        # PTT group (reference :806-854).
        f = self._labeled(tab, "PTT port")
        self.ptt_port_var = self.tk.StringVar()
        self.ttk.Combobox(
            f, textvariable=self.ptt_port_var, values=self.vm.ptt_ports(), width=18
        ).pack(side="left", padx=4)
        self.ptt_method_var = self.tk.StringVar(value="RTS")
        for m in ("RTS", "DTR"):
            self.ttk.Radiobutton(f, text=m, value=m, variable=self.ptt_method_var).pack(
                side="left", padx=2
            )
        self.ttk.Button(f, text="Test PTT", command=self._ptt_test).pack(side="left", padx=8)

    def _build_analysis_tab(self):
        tab = self.ttk.Frame(self.notebook)
        self.notebook.add(tab, text="Analysis")
        f = self._labeled(tab, "Channel WAV")
        self.analysis_path = self.tk.StringVar()
        self.ttk.Entry(f, textvariable=self.analysis_path, width=52).pack(side="left", padx=4)
        self.ttk.Button(f, text="Analyze", command=self._analyze).pack(side="left", padx=6)
        self.analysis_text = self._report_pane(tab, "Channel analysis / recommendations")

    def _build_log_pane(self):
        frame = self.ttk.Frame(self.root)
        frame.pack(fill="both", padx=6, pady=(0, 2))
        bar = self.ttk.Frame(frame)
        bar.pack(fill="x")
        self.ttk.Label(bar, text="Log").pack(side="left")
        self.ttk.Button(bar, text="Clear", command=self._clear_log).pack(side="right", padx=2)
        self.ttk.Button(bar, text="Save…", command=self._save_log).pack(side="right", padx=2)
        self.log_text = self.tk.Text(frame, height=7, bg="#1b1e20", fg="#aaffaa", state="disabled")
        self.log_text.pack(fill="both", expand=True)

    def _build_status_bar(self):
        self.status_var = self.tk.StringVar(value="ready")
        self.ttk.Label(self.root, textvariable=self.status_var, anchor="w").pack(
            fill="x", padx=8, pady=(0, 4)
        )

    # -- actions -------------------------------------------------------------

    def _sync_vm(self):
        self.vm.mode = self.mode_var.get().upper()
        self.vm.symbol_rate = int(self.rate_var.get())
        self.vm.compress = bool(self.compress_var.get())
        self.vm.use_fec = bool(self.fec_var.get())
        self.vm.split = bool(self.split_var.get())
        self.vm.part_minutes = int(self.part_min_var.get())
        self.vm.ptt_port = self.ptt_port_var.get() or None
        self.vm.ptt_method = self.ptt_method_var.get()

    def _mode_changed(self):
        self._sync_vm()
        self._draw_diagram()
        path = self.encode_path.get()
        if path:
            self.preview_label.configure(text=self.vm.transmission_preview(path))

    def _draw_diagram(self):
        self.diagram.delete("all")
        for prim in mode_diagram_primitives(self.mode_var.get(), int(self.rate_var.get())):
            kind = prim[0]
            if kind == "polyline":
                pts = [c for xy in prim[1] for c in xy]
                if len(pts) >= 4:
                    self.diagram.create_line(*pts, fill=prim[2])
            elif kind == "rect":
                self.diagram.create_rectangle(*prim[1:5], fill=prim[5], outline="")
            elif kind == "oval":
                self.diagram.create_oval(*prim[1:5], fill=prim[5], outline="")
            elif kind == "text":
                self.diagram.create_text(prim[1], prim[2], text=prim[3], fill=prim[4])

    def _pick_encode_file(self):
        from tkinter import filedialog

        path = filedialog.askopenfilename(title="File to encode")
        if path:
            self.encode_path.set(path)
            self._mode_changed()

    def _pick_decode_file(self):
        from tkinter import filedialog

        path = filedialog.askopenfilename(
            title="WAV to decode", filetypes=[("WAV", "*.wav"), ("all", "*.*")]
        )
        if path:
            self.decode_path.set(path)

    def _start_encode(self):
        self._sync_vm()
        path = self.encode_path.get()
        if path:
            self.progress.configure(value=0)
            self.vm.start_encode(path)

    def _start_decode(self):
        self._sync_vm()
        path = self.decode_path.get()
        if path:
            self.vm.start_decode(path)

    def _start_record(self):
        self._sync_vm()
        self.vm.start_record(30.0)

    def _toggle_monitor(self):
        if self.vm.monitoring:
            self.vm.stop_monitor()
            self.monitor_button.configure(text="📡 Monitor")
        else:
            self._sync_vm()
            self.vm.start_monitor()
            self.monitor_button.configure(text="⏹ Stop monitor")

    def _play_selected(self):
        sel = self.playlist_box.curselection()
        if sel:
            self.vm.play(sel[0])

    def _tx_selected(self):
        self._sync_vm()
        sel = self.playlist_box.curselection()
        if sel:
            self.vm.transmit(sel[0])

    def _clear_playlist(self):
        self.vm.clear_playlist()
        self._refresh_playlist_box()

    def _ptt_test(self):
        self._sync_vm()
        try:
            self.vm.ptt_test()
        except Exception as e:
            self._append_log(f"PTT test failed: {e}")

    def _analyze(self):
        try:
            report = self.vm.analyze(self.analysis_path.get() or None)
        except Exception as e:
            report = f"analysis failed: {e}"
        self._set_text(self.analysis_text, report)

    def _clear_log(self):
        self.log_text.configure(state="normal")
        self.log_text.delete("1.0", "end")
        self.log_text.configure(state="disabled")

    def _save_log(self):
        from tkinter import filedialog

        path = filedialog.asksaveasfilename(defaultextension=".txt", title="Save log")
        if path:
            self.vm.save_log_to(path)

    # -- pollers -------------------------------------------------------------

    def _append_log(self, msg: str):
        self.log_text.configure(state="normal")
        self.log_text.insert("end", time.strftime("[%H:%M:%S] ") + msg + "\n")
        self.log_text.see("end")
        self.log_text.configure(state="disabled")

    def _set_text(self, widget, content: str):
        widget.configure(state="normal")
        widget.delete("1.0", "end")
        widget.insert("1.0", content)
        widget.configure(state="disabled")

    def _draw_meter(self, level: float):
        self.meter.delete("all")
        color = "#27ae60" if level < 0.7 else ("#f1c40f" if level < 0.9 else "#e74c3c")
        self.meter.create_rectangle(0, 0, 200 * min(level, 1.0), 14, fill=color, outline="")

    def _pump_events(self):
        try:
            while True:
                event = self.vm.events.get_nowait()
                kind = event[0]
                if kind == "log":
                    self._append_log(event[1])
                elif kind == "progress":
                    i, n = event[1], event[2]
                    self.progress.configure(value=100 * i / max(n, 1))
                elif kind == "encoded":
                    self.progress.configure(value=100)
                    self._refresh_playlist_box()
                elif kind == "decoded":
                    self._append_log(f"recovered: {', '.join(event[1]) or '(nothing)'}")
                elif kind == "level":
                    self._draw_meter(event[1])
                elif kind == "error":
                    self._append_log(f"ERROR in {event[1]}: {event[2]}")
        except queue.Empty:
            pass
        self.root.after(100, self._pump_events)

    def _refresh_playlist_box(self):
        colors = {"playing": "#f1c40f", "played": "#27ae60", "pending": "#eeeeee"}
        self.playlist_box.delete(0, "end")
        for i, (path, state) in enumerate(self.vm.playlist_states()):
            self.playlist_box.insert("end", os.path.basename(path))
            self.playlist_box.itemconfigure(i, foreground=colors[state])

    def _refresh_player(self):
        self._refresh_playlist_box()
        self.root.after(500, self._refresh_player)

    def _refresh_stats(self):
        stats = self.vm.reception_stats()
        self._set_text(
            self.stats_text, "\n".join(f"{k}: {v}" for k, v in stats.items())
        )
        self.status_var.set(self.vm.host_status())
        self.root.after(2000, self._refresh_stats)

    def _refresh_assemblies(self):
        rows = self.vm.assembly_status()
        content = "\n".join(
            f"{a['filename']}: {a['received']}/{a['total']} parts" for a in rows
        ) or "(none)"
        self._set_text(self.assembly_text, content)
        self.root.after(5000, self._refresh_assemblies)

    def _on_close(self):
        self.vm.stop_monitor()
        self.vm.stop()
        self.vm.save_playlist()
        self.vm.analytics.save()
        self.root.destroy()

    def run(self):
        self.root.mainloop()


def main(argv: Optional[List[str]] = None) -> int:
    from .app import build_parser

    device = build_parser("audio_modem_radio_tpu_torch.gui", __doc__).parse_args(argv).device
    try:
        window = FileBeepWindow(device=device)
    except Exception as e:
        # A fallback of the window, not of the device: the console app
        # decodes on the same device.
        print(f"cannot open display ({e}); falling back to the console app")
        from .app import ConsoleApp

        ConsoleApp(device=device).run()
        return 0
    window.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
