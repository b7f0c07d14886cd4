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
  idle share (1 - kernel / wall), and the kernels by device time;
- the profiler's ``key_averages()`` table.

Each line carries the card's name and power limit. ``--out`` also writes
the whole report to FILE.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from .framing import crc32, pack_frame
from .modem import modulate
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


def _profile(fn, reps: int = 5):
    """(wall ms/rep, kernel ms/rep, [(ms/rep, launches/rep, name)], table)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / reps
            by_name[e.name][1] += 1
    kernels = sorted(((ms, n // reps, name) for name, (ms, n) in by_name.items()), reverse=True)
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15)
    return wall, sum(k[0] for k in kernels), kernels, table


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
        wall, busy, kernels, table = _profile(lambda: demod_pack_batch(x, mode, rate, cfo_retry=cfo))
        say(f"--- {mode}{what} profile cfo={cfo}: wall {wall:.4f} ms/rep (profiler on), device kernel sum "
            f"{busy:.4f} ms/rep, idle share {1 - busy / wall:.3f} | {card}")
        for k_ms, n, name in kernels:
            say(f"  {k_ms:9.4f} ms  x{n:<3d} {name[:110]}")
        say(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
