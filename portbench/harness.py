"""One run of one cell of the port's benchmark.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the family's transmitter and reference
(``transmit/<family>.py``, ``reference/<family>.py``) and one reader a
metric (``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or
None). Adding a cell, a configuration, a mix or a metric adds files; this
one stays as it is.

A run:

1. set-up: make the mix's ``captures`` from the seed on the device
   (``generator``) in chunks of about ``CHUNK_SAMPLES``, lay each chunk out with the
   program's ``host_shape_batch`` as ``decode_sample_batch`` does
   (``SHAPE_THREADS`` chunks at once, so host memory stays bounded), copy
   the rows into one archive resident on the card, warm up one pass over
   it;
2. the window: ``demod_pack_batch`` on the archive's calls of the mix's
   ``batch`` captures in turn, in a closed loop, one call in flight, each
   call's packed bytes, n_valid and found copied to the host (into pinned
   buffers that every call reuses: a copy to pageable memory runs at 12 or
   at 2.2 GB/s on the same host by turns, which would set the pace), for
   ``seconds``; with ``trace``, a further traced window;
3. after it: the device's peak memory, then the program's state freed; the
   captures of a sample drawn from the seed (every noise-only and offset
   capture among them) are made again and run through the plain reference,
   and the answers of the first pass over the archive, of the last call and
   of a call drawn from the seed are compared with it on that sample
   (``check``);
4. the metrics of the cell (end-to-end without ``trace``, per-layer with).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import itertools
import json
import resource
import subprocess
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from . import compare, generator
from . import trace as tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_modem_radio_tpu")
WARMUP_BATCHES = 2  # and at least one pass over the archive
TRACE_SECONDS = 1.0
TRACE_MIN_BATCHES = 8
DRAWN_AMONG = 64
CHUNK_SAMPLES = 1 << 28  # samples made and host-shaped at a time in set-up (1 GiB of float32)
SHAPE_THREADS = 4  # host_shape_batch calls at once in set-up
COMPARED = 128  # captures of the archive that the check compares, unless the mix says ``compared``


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names) -> List[str]:
    """Module names whose top-level package (the part before the first dot,
    compared whole) is JAX, its libraries or the JAX package."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    name: str
    workload: dict
    cfg: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_bench(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = json.loads((root / "configs" / f"{wl['config']}.json").read_text())
    mix = json.loads((root / "traffic" / f"{wl['traffic']}.json").read_text())

    def mine(specs):
        return [m for m in specs if name in m.get("workloads", [name])]

    return Cell(name, wl, cfg, mix, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def load_reader(metric: str, root: Path = ROOT):
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict):
    return importlib.import_module(f"{__package__}.reference.{cfg['family']}")


@dataclass
class Context:
    """What a metric's reader reads."""

    cfg: dict
    mix: dict
    window: dict  # batches, seconds, latencies_ms, samples_per_batch (a batch: one call)
    setup_s: float
    host_shape_s: float
    rows_shape: tuple  # one call's rows
    rows_itemsize: int
    ref: dict
    device_kind: str
    trace: Optional[tracing.Trace] = None


def _answer(out, idx: np.ndarray, per: int) -> dict:
    """A call's answer on the compared captures it decoded, with their indices."""
    k, packed, n_valid, found = out
    mine = idx[(idx >= k * per) & (idx < (k + 1) * per)]
    local = mine - k * per
    return {"captures": mine, "packed": packed.numpy()[local], "n_valid": n_valid.numpy()[local],
            "found": found.numpy()[local]}


def compared(mix: dict, seed: int) -> np.ndarray:
    """The captures the check compares: every noise-only capture and every
    capture with a carrier offset, and captures drawn from the seed up to
    the mix's ``compared`` (default ``COMPARED``; all of a smaller archive),
    in index order."""
    n_cap, every = int(mix["captures"]), int(mix["noise_every"])
    must = {i for i in range(n_cap) if i % every == every - 1} | {int(k) for k in mix.get("offset_hz", {})}
    rest = np.array(sorted(set(range(n_cap)) - must), dtype=np.int64)
    rng = np.random.default_rng([int(seed), 1])
    size = int(mix.get("compared", COMPARED)) - len(must)
    drawn = rng.choice(rest, size=max(0, min(len(rest), size)), replace=False)
    return np.array(sorted(must | {int(i) for i in drawn}), dtype=np.int64)


def chunk(mix: dict) -> int:
    """Captures a chunk of set-up and of the check: about ``CHUNK_SAMPLES`` samples."""
    return max(1, CHUNK_SAMPLES // int(mix["samples"]))


def stage(cell: Cell, seed: int, dev: torch.device, program):
    """Set-up's batch: (rows on the card, seconds in host_shape_batch summed
    over the chunks). The captures are made on ``dev`` ``chunk(mix)`` at a time
    and laid out by the program's ``host_shape_batch``, ``SHAPE_THREADS``
    chunks at once, each chunk's rows copied into the one resident batch."""
    cfg, mix = cell.cfg, cell.mix
    mode, rate, n_cap = cfg["mode"], int(cfg["symbol_rate"]), int(mix["captures"])

    def shape(captures):
        t = time.perf_counter()
        rows = program.host_shape_batch(captures, mode, rate, device=dev)
        return rows, time.perf_counter() - t

    x, shape_s, pending = None, 0.0, deque()
    with ThreadPoolExecutor(SHAPE_THREADS) as pool:
        step = chunk(mix)
        for i0 in range(0, n_cap, step):
            captures = generator.build(cfg, mix, seed, dev, range(i0, min(i0 + step, n_cap))).captures
            pending.append((i0, pool.submit(shape, captures)))
            while pending and (len(pending) > SHAPE_THREADS or i0 + step >= n_cap):
                j0, fut = pending.popleft()
                rows, dt = fut.result()
                shape_s += dt
                src = torch.from_numpy(rows)
                if x is None:
                    x = torch.empty((n_cap,) + tuple(src.shape[1:]), dtype=src.dtype, device=dev)
                x[j0 : j0 + src.shape[0]].copy_(src)
    return x, shape_s


def remake(cell: Cell, seed: int, dev: torch.device, idx: np.ndarray, precision: str = "float32",
           block: int = None):
    """The plain reference's answer for the captures ``idx``, made again from
    the seed, in ``precision`` ("float32", or a control's), and the frames
    each capture carries: (answer, sent)."""
    ref_mod = reference(cell.cfg)
    block = block or chunk(cell.mix)
    parts, sent = [], []
    for i0 in range(0, len(idx), block):
        traffic = generator.build(cell.cfg, cell.mix, seed, dev, idx[i0 : i0 + block])
        parts.append(ref_mod.receive(traffic.captures, cell.cfg, dev, precision))
        sent += traffic.sent
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}, sent


@dataclass
class Verdict:
    failed: int  # answers with a number over its limit
    checks: dict  # each number's worst reading beside its limit (compare.judge)
    readings: List[dict]
    answers: List[dict]  # what was judged
    ref: dict  # the reference's answer on the compared captures
    idx: np.ndarray  # the compared captures


def check(cell: Cell, seed: int, dev: torch.device, answers: List[dict], control: str = None) -> Verdict:
    """Judge ``answers`` (each a call's packed, n_valid and found on the
    captures ``captures``, all of them among ``compared(mix, seed)``)
    against the plain reference. With ``control`` (a precision of
    ``channel.mm``), the answer judged is the reference's own in that
    precision, put in the program's place."""
    idx = compared(cell.mix, seed)
    ref, sent = remake(cell, seed, dev, idx)
    if control is not None:
        answers = [dict(remake(cell, seed, dev, idx, control)[0], captures=idx)]
    ref_frames = compare.frames(ref["packed"], ref["n_valid"])
    readings = []
    for a in (a for a in answers if len(a["captures"])):
        pos = np.searchsorted(idx, a["captures"])
        readings.append(compare.compare(a, {k: v[pos] for k, v in ref.items()}, [sent[p] for p in pos],
                                        [ref_frames[p] for p in pos]))
    limits = cell.cfg["limits"]
    failed = sum(any(r[k] > limits[k] for k in compare.NUMBERS) for r in readings)
    log(f"check of {len(answers)} answers on {len(idx)} captures: reference frames {sum(map(len, ref_frames))} "
        f"of {sum(map(len, sent))} sent (last part of each capture cut)")
    return Verdict(failed, compare.judge(readings, limits), readings, answers, ref, idx)


def _window(step: Callable, seconds: float, seed: int, cuda: bool, idx: np.ndarray, per: int, n_calls: int):
    """The closed loop: (window dict, the answers kept for the comparison,
    on the captures ``idx``: those of the first pass over the archive, of
    the last call and of a call among the first ``DRAWN_AMONG`` drawn from
    the seed)."""
    drawn_at = int(np.random.default_rng(seed).integers(n_calls, max(DRAWN_AMONG, n_calls + 1)))
    events, lat, kept = [], [], {}
    n, out = 0, None
    t0 = time.perf_counter()
    while True:
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            h0 = time.perf_counter()
        out = step()
        if cuda:
            e1.record()
            events.append((e0, e1))
        else:
            lat.append((time.perf_counter() - h0) * 1e3)
        if n < n_calls or n == drawn_at:
            kept[n] = _answer(out, idx, per)
        n += 1
        if time.perf_counter() - t0 >= seconds and n >= n_calls:
            break
    window_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        lat = [a.elapsed_time(b) for a, b in events]
    kept[n - 1] = _answer(out, idx, per)
    return {"batches": n, "seconds": window_s, "latencies_ms": lat}, list(kept.values())


def _power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return p.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", bench: dict = None,
        root: Path = ROOT, t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(bench or load_bench(), workload, root)
    cfg, mix = cell.cfg, cell.mix
    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel import batch as program

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mode, rate = cfg["mode"], int(cfg["symbol_rate"])
    t = time.perf_counter()
    x, host_shape_s = stage(cell, seed, dev, program)
    per = int(mix.get("batch", mix["captures"]))
    n_calls = int(mix["captures"]) // per
    if n_calls * per != int(mix["captures"]):
        raise ValueError(f"{mix['captures']} captures do not make whole calls of {per}")
    calls = [x[k * per : (k + 1) * per] for k in range(n_calls)]
    rows_shape, itemsize = tuple(calls[0].shape), x.element_size()
    log(f"{workload}: {tuple(x.shape)} {x.dtype} rows of {mix['captures']} x {mix['samples']} samples on the "
        f"device in {time.perf_counter() - t:.3f} s, {n_calls} calls of {per}; host_shape_batch "
        f"{host_shape_s:.3f} s over the chunks")
    cfo_retry = bool(CONFIG.get("modem.cfo_retry", True))
    mlse = bool(CONFIG.get("modem.batch_mlse", False))
    turn = itertools.count()
    host = []  # on a card, pinned host buffers that every call's answer is copied into

    def step():
        k = next(turn) % n_calls
        out = program.demod_pack_batch(calls[k], mode, rate, cfo_retry=cfo_retry, fsk_mlse=mlse)
        if not cuda:
            return (k,) + tuple(out)
        if not host:
            host.extend(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
        for h, t in zip(host, out):
            h.copy_(t)
        return (k,) + tuple(host)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    for _ in range(max(WARMUP_BATCHES, n_calls)):
        step()
    setup_s = time.perf_counter() - t_start
    log(f"warm-up {time.perf_counter() - t:.3f} s; setup_s {setup_s:.3f}")

    idx = compared(mix, seed)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    window, kept = _window(step, seconds, seed, cuda, idx, per, n_calls)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    window["samples_per_batch"] = per * int(mix["samples"])
    tr = tracing.record(step, TRACE_SECONDS, TRACE_MIN_BATCHES) if trace else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    q = np.percentile(window["latencies_ms"], [5, 50, 95, 100])
    log(f"window {window['batches']} batches in {window['seconds']:.3f} s, latency ms p5 {q[0]:.3f} "
        f"p50 {q[1]:.3f} p95 {q[2]:.3f} max {q[3]:.3f}; a batch: {(ru1.ru_minflt - ru0.ru_minflt) / window['batches']:.1f} "
        f"page faults, {(ru1.ru_nivcsw - ru0.ru_nivcsw) / window['batches']:.2f} involuntary switches; peak {peak} bytes; "
        f"host peak RSS {ru1.ru_maxrss / 2**20:.2f} GiB; "
        f"{_power_limit() if cuda else 'cpu'}")
    del x, calls, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdict = check(cell, seed, dev, kept)
    log(f"check {time.perf_counter() - t:.3f} s")

    ctx = Context(cfg, mix, window, setup_s, host_shape_s, rows_shape, itemsize, verdict.ref,
                  torch.cuda.get_device_name(dev) if cuda else "cpu", tr)
    metrics = {}
    for spec in cell.per_layer if trace else cell.end_to_end:
        value = load_reader(spec["name"], root).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    info = {"platform": "gpu" if cuda else "cpu", "kind": ctx.device_kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.failed == 0, "attempted": window["batches"], "failed": verdict.failed,
              "metrics": metrics, "device": info}
    if tr is not None:
        info["busy_s"], info["window_s"] = tr.busy_us * 1e-6, tr.window_us * 1e-6
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = verdict.checks

    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        raise SystemExit(3)
    return result
