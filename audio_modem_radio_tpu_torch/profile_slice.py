"""Where the device time of ``demod_pack_batch`` goes, on one CUDA card.

    python3 -m audio_modem_radio_tpu_torch.profile_slice \
        [--mode QPSK|BPSK|8PSK|FSK1200|FSK9600|FSK19200|NEURAL] [--flat] [--noise-last] [--xla] [--out FILE]

The workload is ``chip_smoke.py``'s timing batch for the mode (default
QPSK): one 16 KiB-payload capture (PSK and NEURAL at 9600 Bd, FSK at its
own rate) tiled to 2^24 samples, shaped as ``host_shape_batch`` ships it
to the card (int16 rows; NEURAL flat float32), shipped once and copied 64
times on the card. ``--flat`` (FSK1200) ships the flat float32 captures
instead, the path of K13. ``--noise-last`` replaces the last capture by
seeded noise (8PSK: no magic there, so K5 scans all three tiers; NEURAL:
the full search); ``--xla`` runs the mode under CONFIG
``tpu.demod_backend = "xla"`` (8PSK: K12, then the per-capture tails). The
script prints:

- ``demod_pack_batch`` (PSK: with ``cfo_retry`` on and off) and pass 1
  alone (NEURAL: the preamble sync, ``td_sync_batch``): median of 9 by
  CUDA events after one warm-up;
- for each run, 5 reps under ``torch.profiler``: the host-clock time per
  rep (profiler on), the summed device-kernel time per rep, the device's
  idle share (1 - the union of kernel, copy and fill intervals over the
  profiled window), and the kernels by device time;
- the same window's idle time by the innermost ``amr.*`` span
  (``observability.span``) on the host thread at each idle gap's middle,
  beside the part of it where no host operator or runtime call held the
  gap's middle (what a trace named by operators alone calls "host, no
  operator");
- each span's host and device ms a rep (``observability.trace_snapshot``);
- the profiler's ``key_averages()`` table.

Each line carries the card's name and power limit. ``--out`` also writes
the whole report to FILE.
"""

from __future__ import annotations

import argparse
import bisect
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from .framing import crc32, pack_frame
from .modem import modulate
from .observability import trace_reset, trace_snapshot
from .ops import fsk
from .ops.neural import td_sync_batch
from .ops.psk import _batch_pass1
from .parallel.batch import demod_pack_batch, host_shape_batch, resolve_demod_plan

SR, BAUD = 96000, 9600
N, B, PAYLOAD = 1 << 24, 64, 16384
CARRIERS = {"QPSK": 3000.0, "BPSK": 3000.0, "8PSK": 12000.0}
# FSK mode -> (symbol rate, its pass 1).
FSK_MODES = {
    "FSK1200": (1200, fsk.fsk_dual_pass1),
    "FSK9600": (9600, fsk.fsk_disc_pass1),
    "FSK19200": (19200, fsk.fsk_quad_pass1),
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip() if out.returncode == 0 else "nvidia-smi failed"


def _bench_rows(mode: str, rate: int, device: torch.device, flat: bool = False) -> torch.Tensor:
    payload = np.random.default_rng(0).integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes()
    wave = modulate(mode, pack_frame("bench.bin", payload, 0, 1, len(payload), crc32(payload)), rate)
    one = np.tile(wave, -(-N // len(wave)))[None, :N].astype(np.float32)
    rows = torch.from_numpy(one if flat else host_shape_batch(one, mode, rate, device=device)).to(device)
    return rows.expand(B, *rows.shape[1:]).contiguous()


def _median_ms(fn, reps: int = 9) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


_WINDOW = "profile_slice.window"


def _span_event(e) -> bool:
    """An ``amr.*`` span of ``observability.span`` (on the host, or its range
    over the kernels it launched), not work of the device."""
    return e.name.startswith("amr.") or e.name == _WINDOW or getattr(e, "is_user_annotation", False)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(intervals, t: float):
    """The latest-starting of the sorted ``(start, end, name)`` intervals
    that holds ``t`` (the innermost, for nested ones), or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    while i >= 0 and intervals[i][1] < t:
        i -= 1
    return intervals[i][2] if i >= 0 else None


def _idle_by_span(events, window, busy):
    """Idle ms inside ``window`` (start, end, thread) between the merged
    ``busy`` intervals, by the innermost ``amr.*`` span on the window's host
    thread at each gap's middle: [(span, idle ms, of which no host operator
    or runtime call held the middle either)], the share that a trace which
    names gaps by operators alone calls "host, no operator"."""
    w0, w1, tid = window
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.thread == tid]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if e.name.startswith("amr."))
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu if not _span_event(e))
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    by = defaultdict(lambda: [0.0, 0.0])
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        row = by[_innermost(spans, mid) or "no amr.* span"]
        row[0] += (b - a) / 1e3
        if _innermost(ops, mid) is None:
            row[1] += (b - a) / 1e3
    return sorted(((k, ms, bare) for k, (ms, bare) in by.items()), key=lambda r: -r[1])


def _span_table(records, reps: int):
    """[(name, calls/rep, host ms/rep, device ms/rep or None)] of the spans."""
    by = defaultdict(lambda: [0, 0.0, 0.0, True])
    for r in records:
        row = by[r["name"]]
        row[0] += 1
        row[1] += r["host_ms"]
        if r["device_ms"] is None:
            row[3] = False
        else:
            row[2] += r["device_ms"]
    return [(name, n / reps, h / reps, d / reps if ok else None) for name, (n, h, d, ok) in by.items()]


def _profile(fn, reps: int = 5):
    """(wall ms/rep, kernel ms/rep, idle share, [(ms/rep, launches/rep, name)],
    [(span, idle ms/rep)], span table, key_averages table). The idle share
    is 1 - the union of kernel, copy and fill intervals over the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    trace_reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
    spans = _span_table(trace_snapshot()["records"], reps)
    events = prof.events()
    win = next(e for e in events if e.name == _WINDOW and e.device_type == torch.autograd.DeviceType.CPU)
    w0, w1 = win.time_range.start, win.time_range.end
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not _span_event(e)]
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device
                   if e.time_range.end > w0 and e.time_range.start < w1])
    idle_share = 1 - sum(b - a for a, b in busy) / (w1 - w0)
    idle = [(name, ms / reps, bare / reps) for name, ms, bare in _idle_by_span(events, (w0, w1, win.thread), busy)]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / reps
        by_name[e.name][1] += 1
    kernels = sorted(((ms, n // reps, name) for name, (ms, n) in by_name.items()), reverse=True)
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15)
    return wall, sum(k[0] for k in kernels), idle_share, kernels, idle, spans, table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(CARRIERS) + sorted(FSK_MODES) + ["NEURAL"], default="QPSK")
    ap.add_argument("--flat", action="store_true", help="FSK1200: flat (B, N) float32 captures (K13)")
    ap.add_argument("--noise-last", action="store_true", help="the last capture seeded noise")
    ap.add_argument("--xla", action="store_true", help="under CONFIG tpu.demod_backend = 'xla'")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    if args.flat and args.mode != "FSK1200":
        ap.error("--flat takes --mode FSK1200")
    if args.xla:
        from .config import CONFIG

        CONFIG.set("tpu.demod_backend", "xla")
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this profile needs a card")
        return 2
    device = torch.device("cuda")
    card = _card()
    mode = args.mode
    what = "".join(f" {k}" for k, on in (("flat", args.flat), ("last capture noise", args.noise_last),
                                          ("xla", args.xla)) if on)
    lines = [f"card: {card}", f"mode: {mode}{what}"]

    def say(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    rate = FSK_MODES[mode][0] if mode in FSK_MODES else BAUD
    x = _bench_rows(mode, rate, device, args.flat)
    b = x.shape[0]
    if args.noise_last:
        g = torch.Generator(device=device).manual_seed(31)
        noise = torch.randn(x.shape[1:], generator=g, device=device) * 0.3
        x[-1] = noise if x.dtype == torch.float32 else (noise * 32767).round().clamp(-32768, 32767).to(x.dtype)
    cfos = (True, False) if mode in CARRIERS else (True,)
    for cfo in cfos:
        ms = _median_ms(lambda: demod_pack_batch(x, mode, rate, cfo_retry=cfo))
        say(f"{mode}{what} demod_pack_batch cfo={cfo}: median {ms:.4f} ms of 9 = "
            f"{b * N / (ms * 1e-3) / 1e6:.2f} Msamples/s | {card}")
    if mode == "NEURAL":
        ms = _median_ms(lambda: td_sync_batch(x, 2))
        say(f"{mode} td_sync_batch (the preamble sync) alone: median {ms:.4f} ms | {card}")
    elif mode in FSK_MODES:
        if not args.flat:  # the flat path's pass 1 runs on windows it cuts itself
            params = resolve_demod_plan(mode, rate)[1]
            ms = _median_ms(lambda: FSK_MODES[mode][1](x, *params, SR))
            say(f"{mode} pass 1 ({FSK_MODES[mode][1].__name__}) alone: median {ms:.4f} ms | {card}")
    else:
        n_psk = 8 if mode == "8PSK" else 4
        spsym = SR // BAUD
        r = x.shape[1]
        ms = _median_ms(lambda: _batch_pass1(None, x, b, r * 128, spsym, CARRIERS[mode], SR, 8, r, n_psk))
        say(f"{mode} _batch_pass1 alone: median {ms:.4f} ms | {card}")
    for cfo in cfos:
        wall, busy, idle_share, kernels, idle, spans, table = _profile(
            lambda: demod_pack_batch(x, mode, rate, cfo_retry=cfo))
        say(f"--- {mode}{what} profile cfo={cfo}: wall {wall:.4f} ms/rep (profiler on), device kernel sum "
            f"{busy:.4f} ms/rep, idle share {idle_share:.4f} | {card}")
        for k_ms, n, name in kernels:
            say(f"  {k_ms:9.4f} ms  x{n:<3d} {name[:110]}")
        total = sum(ms for _, ms, _ in idle)
        say(f"  idle {total:.4f} ms/rep by the innermost amr.* span at each gap's middle "
            f"(ms, share, ms with no host operator there):")
        for name, ms, bare in idle:
            say(f"  {ms:9.4f} ms  {100 * ms / total if total else 0.0:5.1f}%  {bare:9.4f} ms  {name}")
        say("  spans: calls/rep, host ms/rep, device ms/rep:")
        for name, n, host, dev in spans:
            say(f"  {name:22s} {n:5.1f} {host:9.4f} {'not measured' if dev is None else f'{dev:9.4f}'}")
        say(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
