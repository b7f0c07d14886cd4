"""The traced window: ``torch.profiler`` over a run of batches, read back
from its Chrome trace.

The window is the benchmark's own span ``portbench.window``; every batch in
it is a ``portbench.batch`` span. What is read from the trace:

- the device's busy time: the union of kernel, copy and fill intervals;
- each kernel's time, and whether PyTorch launched it: a kernel counts as
  PyTorch's own when the runtime call that launched it (matched by the
  trace's correlation id) lies inside an ``aten::`` operator on the same
  host thread. ATen's kernels and the cuBLAS and CUTLASS products it calls
  are launched so; a kernel that the program launches through its own
  library is not, whatever its name;
- the idle gaps inside the window, each named by the innermost host
  operator or runtime call on the batch's thread at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

WINDOW = "portbench.window"
BATCH = "portbench.batch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A parsed trace of ``batches`` batches; times in microseconds."""

    def __init__(self, events: List[dict], batches: int):
        self.batches = batches
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        w = win[0]
        self.t0, self.t1, self.tid = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w.get("tid")
        self.device = [e for e in events if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"
                       and self.t0 <= float(e["ts"]) <= self.t1]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self._launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
                        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
        aten = defaultdict(list)
        self._host = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or not self.t0 <= float(e["ts"]) <= self.t1:
                continue
            span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
                aten[e.get("tid")].append(span)
            if e.get("cat") in ("cpu_op",) + _LAUNCH_CATS and e["name"] not in (WINDOW, BATCH):
                self._host[e.get("tid")].append((span[0], span[1], e["name"]))
        self._aten = {tid: _merge(v) for tid, v in aten.items()}
        self._busy = _merge([(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                             for e in self.device])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self._busy)

    def kernel_us(self, select: Callable[[dict], bool]) -> float:
        return sum(float(e["dur"]) for e in self.kernels if select(e))

    def launched_by_torch(self, kernel: dict) -> bool:
        corr = kernel.get("args", {}).get("correlation")
        if corr not in self._launch:
            return False
        ts, tid = self._launch[corr]
        spans = self._aten.get(tid, [])
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def top_device_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device:
            by[e["name"]] += float(e["dur"]) * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time inside the window by what the batch's thread was doing."""
        edges = [self.t0] + [x for ab in self._busy for x in ab] + [self.t1]
        host = sorted(self._host.get(self.tid, []))
        by = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(host, (mid, float("inf"), "")) - 1
            while i >= 0 and host[i][1] < mid:  # the latest-starting span that holds mid is the innermost
                i -= 1
            label = host[i][2] if i >= 0 else "host, no operator"
            by[label[:160]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def record(step: Callable[[], object], min_seconds: float, min_batches: int) -> Trace:
    """Run ``step`` under the profiler for at least ``min_seconds`` and
    ``min_batches`` batches; return the parsed trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0, n = time.perf_counter(), 0
            while n < min_batches or time.perf_counter() - t0 < min_seconds:
                with record_function(BATCH):
                    step()
                n += 1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, n)

