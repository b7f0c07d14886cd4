"""Logging, log rotation, performance monitoring, analytics, and the
decode path's spans and counters.

Capability parity with the reference's observability surface:

* :func:`setup_logging` — dual file+console handlers on one named logger
  (reference filebeep_advanced_v2.py:41-71).
* :class:`LogManager` — size-capped log rotation (10 MB default, reference
  :1435-1461).
* :class:`PerformanceMonitor` — psutil CPU/RAM/disk poller
  (reference :378-398), plus the CUDA cards torch sees.
* :class:`AnalyticsStore` — persists the analytics schema the reference
  *declares* but never writes (files_sent/received, bytes, error counts,
  modes_used, performance_metrics — reference filebeep_analytics.json);
  here encode/decode events actually update it.

The port's own tracing (no counterpart upstream):

* :func:`span` — a named stage of the decode path. Recorded only while a
  ``torch.profiler`` session records on the calling thread: then it is a
  ``record_function`` range (a ``user_annotation`` on the trace's clock,
  with a ``gpu_user_annotation`` over the kernels it launched), a record in
  memory with its host interval, and, on a CUDA device, a pair of CUDA
  events that give its device milliseconds on the card's clock. Otherwise
  it costs one check of ``torch.autograd._profiler_enabled()``.
* :func:`count` — a running counter (always on), also added to the
  ``amr.demod_pack_batch`` record of the call that made it.
* :func:`host_read` — a device-to-host read, counted and spanned.
* :func:`trace_snapshot` and :func:`trace_reset`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

try:
    import psutil

    PSUTIL_AVAILABLE = True
except ImportError:  # pragma: no cover
    PSUTIL_AVAILABLE = False

# Every module of the port logs under this one name, so a configured log
# file receives the framing, assembly, decoder and front-end messages alike.
LOGGER_NAME = "audio_modem_radio_tpu_torch"


def setup_logging(
    log_file: str = "audio_modem_system.log",
    level: int = logging.INFO,
    console: bool = True,
    to_file: bool = True,
) -> logging.Logger:
    """Configure the package logger with optional file + console handlers.

    ``to_file=False`` skips the file handler — the apps pass CONFIG
    ``ui.auto_save_logs`` here (the reference declares the key unread).
    """
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if to_file:
        fh = logging.FileHandler(log_file, encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    logger.info("logging initialized -> %s", log_file if to_file else "(console only)")
    return logger


class LogManager:
    """Rotates a log file when it exceeds ``max_bytes`` (default 10 MB)."""

    def __init__(self, log_file: str = "audio_modem_system.log", max_bytes: int = 10 * 1024 * 1024):
        self.log_file = log_file
        self.max_bytes = max_bytes

    def should_rotate(self) -> bool:
        return os.path.exists(self.log_file) and os.path.getsize(self.log_file) > self.max_bytes

    def rotate(self) -> Optional[str]:
        if not self.should_rotate():
            return None
        rotated = f"{self.log_file}.{int(time.time())}"
        os.replace(self.log_file, rotated)
        return rotated


class PerformanceMonitor:
    """Polls host CPU/RAM/disk and the CUDA cards torch sees."""

    def __init__(self, interval_s: float = 2.0):
        self.interval_s = interval_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.latest: Dict[str, Any] = {}

    def sample(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"timestamp": time.time()}
        if PSUTIL_AVAILABLE:
            info["cpu_percent"] = psutil.cpu_percent(interval=None)
            info["ram_percent"] = psutil.virtual_memory().percent
            try:
                info["disk_percent"] = psutil.disk_usage(os.getcwd()).percent
            except OSError:
                pass
        try:
            import torch

            # The cards only: with none, the list is empty (the host is not
            # a device here).
            if torch.cuda.is_available():
                info["devices"] = [
                    f"cuda:{i} {torch.cuda.get_device_name(i)}"
                    for i in range(torch.cuda.device_count())
                ]
            else:
                info["devices"] = []
        except Exception:
            pass
        self.latest = info
        return info

    def start(self, callback=None) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                info = self.sample()
                if callback:
                    callback(info)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval_s * 2)
            self._thread = None


class AnalyticsStore:
    """Thread-safe usage analytics with JSON persistence.

    Implements the schema shipped (but never populated) by the reference's
    ``filebeep_analytics.json``.
    """

    def __init__(self, path: str = "audio_modem_analytics.json"):
        self.path = path
        self._lock = threading.Lock()
        self.data: Dict[str, Any] = {
            "files_sent": 0,
            "files_received": 0,
            "bytes_sent": 0,
            "bytes_received": 0,
            "encode_errors": 0,
            "decode_errors": 0,
            "modes_used": {},
            "performance_metrics": {},
            "session_start": time.time(),
        }
        self.load()

    def load(self) -> None:
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    stored = json.load(f)
                with self._lock:
                    for k, v in stored.items():
                        if k in self.data and k != "session_start":
                            self.data[k] = v
            except (json.JSONDecodeError, OSError):
                pass

    def save(self) -> None:
        with self._lock:
            snapshot = dict(self.data)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot, f, indent=2)
        os.replace(tmp, self.path)

    def record_encode(self, mode: str, n_bytes: int, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.data["files_sent"] += 1
                self.data["bytes_sent"] += n_bytes
            else:
                self.data["encode_errors"] += 1
            self.data["modes_used"][mode] = self.data["modes_used"].get(mode, 0) + 1

    def record_decode(self, mode: str, n_bytes: int, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.data["files_received"] += 1
                self.data["bytes_received"] += n_bytes
            else:
                self.data["decode_errors"] += 1
            self.data["modes_used"][mode] = self.data["modes_used"].get(mode, 0) + 1

    def record_metric(self, name: str, value: float) -> None:
        with self._lock:
            self.data["performance_metrics"][name] = value


analytics = AnalyticsStore()


# --- spans and counters of the decode path ---------------------------------------

CALL_SPAN = "amr.demod_pack_batch"  # the root: one batched decode call
SPAN_LIMIT = 65536  # records kept until trace_reset(); later ones are counted as dropped

_OFF = contextlib.nullcontext()
_tls = threading.local()
_lock = threading.Lock()
_stores: List[list] = []  # every thread's record list, registered at its first span
_streams: Dict[tuple, "torch.cuda.Stream"] = {}  # (device index, raw stream) -> its Stream object
_counters: Dict[str, int] = {}
_dropped = 0
_issued = itertools.count()  # record slots handed out since the last reset
_calls = itertools.count(1)


class _ThreadState:
    __slots__ = ("records", "stack", "name")

    def __init__(self):
        self.records: list = []  # only this thread appends here: no lock
        self.stack: list = []  # its open spans
        self.name = threading.current_thread().name
        with _lock:
            _stores.append(self.records)


def _event(device: torch.device) -> "torch.cuda.Event":
    """A timing event recorded now on ``device``'s current stream. The
    Stream object is cached by its raw handle: building one costs more
    than the record."""
    raw = torch._C._cuda_getCurrentRawStream(device.index)
    stream = _streams.get((device.index, raw))
    if stream is None:
        stream = _streams[(device.index, raw)] = torch.cuda.current_stream(device)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    """One span: its record in the store and its ``record_function`` range."""

    __slots__ = ("name", "attrs", "parent", "call", "thread", "device", "stack", "rf", "t0", "t1", "ev0",
                 "ev1", "counts")

    def __init__(self, name: str, device: Optional[torch.device], attrs: dict):
        global _dropped
        st = getattr(_tls, "state", None)
        if st is None:
            st = _tls.state = _ThreadState()
        self.name, self.attrs, self.thread, self.stack = name, attrs, st.name, st.stack
        self.parent = st.stack[-1] if st.stack else None
        self.call = next(_calls) if name == CALL_SPAN else (self.parent.call if self.parent else None)
        self.device = device if device is not None and device.type == "cuda" else None
        self.t0 = self.t1 = self.ev0 = self.ev1 = None
        self.counts: Dict[str, int] = {}
        if next(_issued) < SPAN_LIMIT:
            st.records.append(self)
        else:
            with _lock:
                _dropped += 1

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.device is not None:
            self.ev0 = _event(self.device)
        self.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        if self.device is not None:
            self.ev1 = _event(self.device)
        self.t1 = t1
        self.rf.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context manager around one stage of the decode path, named ``name``
    with ``attrs``; ``device`` is the device of the tensors its work runs on
    (a CUDA device: events are recorded on its current stream; None: host
    times only). Recorded only while a ``torch.profiler`` session records
    on this thread."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on); while spans record,
    also to the counts of the enclosing ``amr.demod_pack_batch`` call."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    st = getattr(_tls, "state", None)
    if st is not None:
        for rec in reversed(st.stack):
            if rec.name == CALL_SPAN:
                rec.counts[name] = rec.counts.get(name, 0) + n
                break


def host_read(t: torch.Tensor, read: Callable[[torch.Tensor], Any] = bool):
    """``read(t)``, a read of ``t`` to the host, counted under ``host_reads``
    and spanned as ``amr.host_read`` with host times only: what it measures
    is how long the host waited, and events recorded after the read would
    cost the card's time (its queue is empty then)."""
    count("host_reads")
    with span("amr.host_read"):
        return read(t)


def trace_reset() -> None:
    """Empty the span store and zero the counters and the drop count (the
    kernels' launch counts are reset by ``ops.kernels.reset_launch_counts``)."""
    global _issued, _dropped
    with _lock:
        for records in _stores:
            records.clear()
        _counters.clear()
        _issued, _dropped = itertools.count(), 0


def trace_snapshot() -> Dict[str, Any]:
    """What was recorded since the last :func:`trace_reset`: ``records``,
    ``counters``, ``dropped`` (records past ``SPAN_LIMIT``) and ``launches``
    (``ops.kernels.launch_counts()``). Synchronizes once each device the
    spans ran on; clears nothing; spans still open are left out.

    A record: ``index``, ``name``, ``attrs``, ``parent`` (its index, None at
    a root), ``call`` (the id of its ``amr.demod_pack_batch`` call),
    ``thread``, ``host_start_ns``, ``host_ms``, ``device_ms`` (CUDA events on
    the card's clock; None for a span without a CUDA device) and their self
    times ``host_self_ms``, ``device_self_ms`` (the span less what its
    children cover; a child without device times covers nothing on the
    card's clock); a call's record also has ``counts``, the counts its call
    made."""
    from .ops.kernels import launch_counts

    with _lock:
        recs = [r for records in _stores for r in list(records) if r.t1 is not None]
        counters, dropped = dict(_counters), _dropped
    for dev in {r.device for r in recs if r.device is not None}:
        torch.cuda.synchronize(dev)
    index = {id(r): i for i, r in enumerate(recs)}
    out = []
    for i, r in enumerate(recs):
        o = {"index": i, "name": r.name, "attrs": dict(r.attrs), "parent": index.get(id(r.parent)),
             "call": r.call, "thread": r.thread, "host_start_ns": r.t0, "host_ms": (r.t1 - r.t0) / 1e6,
             "device_ms": r.ev0.elapsed_time(r.ev1) if r.ev1 is not None else None}
        if r.name == CALL_SPAN:
            o["counts"] = dict(r.counts)
        out.append(o)
    host_kids, dev_kids = [0.0] * len(out), [0.0] * len(out)
    for o in out:
        p = o["parent"]
        if p is not None:
            host_kids[p] += o["host_ms"]
            dev_kids[p] += o["device_ms"] or 0.0
    for o, h, d in zip(out, host_kids, dev_kids):
        o["host_self_ms"] = o["host_ms"] - h
        o["device_self_ms"] = None if o["device_ms"] is None else o["device_ms"] - d
    return {"records": out, "counters": counters, "dropped": dropped, "launches": launch_counts()}
