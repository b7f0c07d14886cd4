"""Time compile-time variants of one kernel source on one CUDA card.

    python3 -m audio_modem_radio_tpu_torch.kernel_variants --kernel neural_extract \\
        --variant parent=/path/to/parent/audio_modem_radio_tpu_torch/csrc/neural_extract.cu \\
        --variant new=csrc/neural_extract.cu [--reps 5] [--out FILE]

``--kernel`` is ``neural_extract`` (K10) or ``fsk_flat`` (K13). Each
``--variant NAME=SOURCE[:FLAGS]`` compiles SOURCE alone (a path relative to
the package, or absolute, such as another checkout's copy of the same file)
with the build's nvcc flags plus FLAGS (space-separated ``-D`` options) into
its own library under ``build/``; all variants compile at once. Each is then
called through the port's own wrapper (``ops/kernels.py``), so it must keep
the C signature of the source it replaces, on the inputs of
``chip_smoke.py``'s phase 6 (64 x 2^24 samples): K10 on the NEURAL@9600
bench batch's float32 rows synced by ``td_sync_batch``, K13 on the FSK1200
bench capture's flat float32 rows at pass 1's offset. The report gives each
variant's time (median of ``--reps`` CUDA-event timings after one warm-up),
the kernel's own device time per call under ``torch.profiler`` (the
wrapper's table work left out), the number of outputs that differ from
the first variant's, the card's SM clock and power draw while the variant
runs back to back for two seconds (``nvidia-smi``), ``nvcc``'s register
and spill line, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from .framing import crc32, pack_frame
from .modem import modulate
from .ops import _build
from .ops import kernels as tk
from .profile_slice import _card, _median_ms

SR, N, B, PAYLOAD = 96000, 1 << 24, 64, 16384
_ENTRY = {"neural_extract": "amr_neural_extract", "fsk_flat": "amr_fsk_tile"}
_KERNEL = {"neural_extract": "neural_extract_kernel", "fsk_flat": "fsk_flat_kernel"}


def _kernel_ms(call, name: str, reps: int) -> float:
    """Device time per call of the kernels whose name holds ``name``, under
    ``torch.profiler`` over ``reps`` calls (the wrapper's other work left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
    return us / 1e3 / reps


def _clocks(call, seconds: float = 2.0) -> str:
    """The card's median SM clock and power draw while ``call`` runs back to
    back for about ``seconds``, from ``nvidia-smi`` every quarter second."""
    import statistics
    import threading
    import time

    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout.split(",")
            if len(out) == 2:
                samples.append((float(out[0]), float(out[1])))
            time.sleep(0.25)

    th = threading.Thread(target=poll)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        call()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    if not samples:
        return "clocks not read"
    return (f"SM clock {statistics.median(c for c, _ in samples):.0f} MHz, power "
            f"{statistics.median(p for _, p in samples):.1f} W (median of {len(samples)} reads)")


def _build_variants(variants):
    """{name: (library path, ptxas lines)}, every source compiled at once."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, src, flags in variants:
        path = Path(src) if Path(src).is_absolute() else _build._PKG_DIR / src
        lib = out_dir / f"lib_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(path)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{err}")
        built[name] = (lib, [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln])
    return built


@contextlib.contextmanager
def _bound_to(lib_path: Path, entry: str):
    """The port's wrappers call ``entry`` of ``lib_path`` inside the block."""
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    old = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = old


def _wave(mode: str, rate: int) -> np.ndarray:
    payload = np.random.default_rng(0).integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes()
    wave = modulate(mode, pack_frame("bench.bin", payload, 0, 1, len(payload), crc32(payload)), rate)
    return np.tile(wave, -(-N // len(wave)))[:N].astype(np.float32)


def _neural_call(device):
    from .ops.neural import _codebook, td_sync_batch

    x = torch.from_numpy(_wave("NEURAL", 9600)[None]).to(device).expand(B, -1).contiguous()
    k0, pr, pi = td_sync_batch(x, 2)
    r3 = N // 128
    x2d = x.reshape(B * r3, 128)
    cb = torch.from_numpy(_codebook()).to(device)
    ph = torch.stack([pr, pi], dim=1).contiguous()
    s = (k0 % 128).to(torch.int32)
    return lambda: tk.neural_extract_batch(x2d, cb, ph, s, rows_per_capture=r3)


def _flat_call(device):
    from .ops import fsk as tf
    from .parallel.batch import host_shape_batch, resolve_demod_plan

    wave = _wave("FSK1200", 1200)
    baud, mark, space = resolve_demod_plan("FSK1200", 1200)[1]
    rows = torch.from_numpy(host_shape_batch(wave[None], "FSK1200", 1200, device=device)).to(device)
    best, W, spr = tf.fsk_dual_pass1(rows, baud, mark, space, SR)
    r, row = rows.shape[1], W.shape[2] // 4 * tf._samples_per_bit(SR, baud)
    flat = torch.nn.functional.pad(torch.from_numpy(wave).to(device), (0, r * row - N))
    flat = flat.expand(B, -1).contiguous().reshape(B, r, row)
    best = best.expand(B).contiguous()
    return lambda: tk.fsk_project_bits_batch(flat, W, best, rows_per_capture=r, spr=spr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(_ENTRY), required=True)
    ap.add_argument("--variant", action="append", required=True, help="NAME=SOURCE[:FLAGS]")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this needs a card")
        return 2
    variants = []
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        src, _, flags = rest.partition(":")
        variants.append((name, src, flags.split()))
    built = _build_variants(variants)
    device = torch.device("cuda")
    card = _card()
    call = (_neural_call if args.kernel == "neural_extract" else _flat_call)(device)
    lines = [f"card: {card}", f"kernel: {args.kernel}"]
    ref = None
    for name, src, flags in variants:
        lib, ptxas = built[name]
        with _bound_to(lib, _ENTRY[args.kernel]):
            got = call()
            torch.cuda.synchronize()
            ms = _median_ms(call, args.reps)
            kms = _kernel_ms(call, _KERNEL[args.kernel], args.reps)
            clk = _clocks(call)
        ref = got if ref is None else ref
        n_diff = int((got != ref).sum())
        lines.append(f"{name} ({src} {' '.join(flags)}): wrapper {ms:.4f} ms, kernel alone {kms:.4f} ms; {n_diff} of "
                     f"{got.numel()} outputs differ from {variants[0][0]}; {clk} | {card}")
        lines += [f"  {ln}" for ln in ptxas]
        print("\n".join(lines[-1 - len(ptxas):]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
