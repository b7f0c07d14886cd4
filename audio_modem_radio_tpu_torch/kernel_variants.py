"""Time compile-time variants of one kernel source on one CUDA card.

    python3 -m audio_modem_radio_tpu_torch.kernel_variants --kernel neural_extract \\
        --variant parent=/path/to/parent/audio_modem_radio_tpu_torch/csrc/neural_extract.cu \\
        --variant new=csrc/neural_extract.cu [--reps 5] [--out FILE]

``--kernel`` is ``decide`` (K1), ``fsk_tile`` (K7), ``neural_extract`` (K10)
or ``fsk_flat`` (K13). Each ``--variant NAME=SOURCE[:FLAGS]`` compiles
SOURCE alone (a path relative to the package, or absolute, such as another
checkout's copy of the same file) with the build's nvcc flags plus FLAGS
(space-separated ``-D`` options) into its own library under ``build/``; all
variants compile at once. Each is then
called through the port's own wrapper (``ops/kernels.py``), so it must keep
the C signature of the source it replaces, on the inputs of
``chip_smoke.py``'s phase 6 (64 x 2^24 samples): K1 on the bench batch's
rows (``--dtype`` int16, int8 or float32) at pass 1's offsets and rotations,
of QPSK (``--n-psk 4``), BPSK (2) or 8PSK (8); K7 on the FSK1200 bench
batch's int16 overlapped rows at pass 1's offset; K10 on the NEURAL@9600
bench batch's float32 rows synced by ``td_sync_batch``; K13 on the FSK1200
bench capture's flat float32 rows at pass 1's offset. The report gives each
variant's time (median of ``--reps`` CUDA-event timings after one warm-up),
the kernel's own device time per call under ``torch.profiler`` (the
wrapper's table work left out), the number of outputs that differ from
the first variant's, the card's SM clock and power draw while the variant
runs back to back for two seconds (``nvidia-smi``), ``nvcc``'s register
and spill lines of the kernel's instantiations, and the card's name and
power limit.
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
_ENTRY = {"decide": "amr_decide", "fsk_tile": "amr_fsk_tile", "neural_extract": "amr_neural_extract",
          "fsk_flat": "amr_fsk_tile"}
_KERNEL = {"decide": "decide_kernel", "fsk_tile": "fsk_tile_kernel", "neural_extract": "neural_extract_kernel",
           "fsk_flat": "fsk_flat_kernel"}
_PSK = {2: ("BPSK", 3000.0), 4: ("QPSK", 3000.0), 8: ("8PSK", 12000.0)}
_MANGLED = {"int16": "s", "int8": "a", "float32": "f"}  # a C++ type's code in a mangled name


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
    """{name: (library path, nvcc's stderr)}, every source compiled at once."""
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
        built[name] = (lib, err)
    return built


def _ptxas_lines(log: str, kernel: str):
    """nvcc's register and spill lines of the functions whose name holds
    ``kernel``, each led by its (mangled) name."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif ("registers" in ln or "spill" in ln) and name and kernel in name:
            out.append(f"{name[-40:]}: {ln.split(':', 1)[-1].strip()}")
    return out


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


def _psk_rows(mode: str, dtype: str, device):
    """The bench batch of ``mode`` as (64, R, 1280) rows of ``dtype`` through
    the port's host shaping: one capture shipped, tiled on the card."""
    from .config import CONFIG
    from .parallel.batch import host_shape_batch

    old = CONFIG.get("tpu.int16_rows"), CONFIG.get("tpu.int8_rows")
    CONFIG.set("tpu.int16_rows", dtype == "int16")
    CONFIG.set("tpu.int8_rows", dtype == "int8")
    try:
        one = host_shape_batch(_wave(mode, 9600)[None], mode, 9600, device=device)
    finally:
        CONFIG.set("tpu.int16_rows", old[0])
        CONFIG.set("tpu.int8_rows", old[1])
    return torch.from_numpy(one).to(device).expand(B, -1, -1).contiguous()


def _decide_call(device, dtype: str, n_psk: int):
    from .ops.psk import _batch_pass1, _device_tables

    mode, carrier = _PSK[n_psk]
    x = _psk_rows(mode, dtype, device)
    b, r, row = x.shape
    spsym = row // 128
    _, _, best, theta = _batch_pass1(None, x, b, r * 128, spsym, carrier, SR, 8, r,
                                     n_psk=8 if n_psk == 8 else 4)
    W8, _, _ = _device_tables(spsym, carrier, SR, 8, device)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    return lambda: tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)


def _tile_call(device):
    from .ops import fsk as tf
    from .parallel.batch import host_shape_batch, resolve_demod_plan

    baud, mark, space = resolve_demod_plan("FSK1200", 1200)[1]
    one = host_shape_batch(_wave("FSK1200", 1200)[None], "FSK1200", 1200, device=device)
    x = torch.from_numpy(one).to(device).expand(B, -1, -1).contiguous()
    best, W, spr = tf.fsk_dual_pass1(x, baud, mark, space, SR)
    return lambda: tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=x.shape[1], spr=spr)


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
    ap.add_argument("--dtype", choices=("int16", "int8", "float32"), default="int16", help="K1's rows")
    ap.add_argument("--n-psk", type=int, choices=sorted(_PSK), default=4, help="K1's decision")
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
    if args.kernel == "decide":
        call = _decide_call(device, args.dtype, args.n_psk)
    else:
        call = {"fsk_tile": _tile_call, "neural_extract": _neural_call, "fsk_flat": _flat_call}[args.kernel](device)
    what = f" ({args.dtype} rows, n_psk {args.n_psk})" if args.kernel == "decide" else ""
    # The timed instantiation's mangled template arguments: K1's sample type,
    # n_psk and spsym 10; K7's and K13's sample type.
    instance = {"decide": f"I{_MANGLED[args.dtype]}Li{args.n_psk}ELi10E", "fsk_tile": "Is", "fsk_flat": "If"}.get(
        args.kernel, "")
    lines = [f"card: {card}", f"kernel: {args.kernel}{what}"]
    ref = None
    for name, src, flags in variants:
        lib, log = built[name]
        ptxas = _ptxas_lines(log, _KERNEL[args.kernel] + instance)
        with _bound_to(lib, _ENTRY[args.kernel]):
            got = call()
            torch.cuda.synchronize()
            ms = _median_ms(call, args.reps)
            kms = _kernel_ms(call, _KERNEL[args.kernel], args.reps)
            clk = _clocks(call)
        got = got if isinstance(got, tuple) else (got,)  # K1's (hi, lo) at n_psk 2 and 4
        ref = got if ref is None else ref
        n_diff = sum(int((g != f).sum()) for g, f in zip(got, ref))
        n_out = sum(g.numel() for g in got)
        lines += [f"  {ln}" for ln in ptxas]
        lines.append(f"{name} ({src} {' '.join(flags)}): wrapper {ms:.4f} ms, kernel alone {kms:.4f} ms; {n_diff} of "
                     f"{n_out} outputs differ from {variants[0][0]}; {clk} | {card}")
        print("\n".join(lines[-1 - len(ptxas):]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
