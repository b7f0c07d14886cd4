"""Time compile-time variants of one kernel source on one CUDA card.

    python3 -m audio_modem_radio_tpu_torch.kernel_variants --kernel neural_extract \\
        --variant parent=/path/to/parent/audio_modem_radio_tpu_torch/csrc/neural_extract.cu \\
        --variant new=csrc/neural_extract.cu [--reps 5] [--out FILE]

``--kernel`` is ``decide`` (K1), ``fsk_tile`` (K7), ``neural_extract`` (K10),
``fsk_flat`` (K13), ``project_diff`` (K12, or K11 with ``--single``),
``sector_match`` (K5), ``rotation_match`` (K2), ``psk8_pack`` (K6),
``relabel_pack`` (K3), ``bit_select_pack`` (K4), ``mlse_viterbi`` (the
single-capture FSK receiver's MLSE Viterbi) or ``fec_viterbi`` (the
convolutional code's Viterbi). Each
``--variant NAME=SOURCE[:FLAGS]`` compiles
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
bench batch's float32 rows synced by ``td_sync_batch`` (``--bf16``, ``--argmax
dot``: its switches, ``--bf16`` the tensor-core kernel of
``neural_extract_tc.cuh``, its register lines and differing symbols also
counted against the near-tie margin of ``ops/kernels.py``
``neural_bf16_mismatches``); K13 on the FSK1200
bench capture's flat float32 rows at pass 1's offset; K12 on the 8PSK bench
batch's rows (``--dtype`` int16 or float32) at pass 1's offsets, K11
(``--single``) on one float32 capture in the single-capture layout (13,120
rows); K5 on K1's 8PSK sectors of the bench batch, K2 on K1's QPSK
(``--family qpsk``) or BPSK (``--family bpsk``) decision lanes of it
(``--noise-last``: the batch's last capture noise) over the first
``--rows-scanned`` rows (256, 1792 or full); K6 on K1's 8PSK sectors with
capture i at ksel i % 8 and r8 (i // 8) % 8, every pair once; K3 on K1's
QPSK lanes and K4 on K1's BPSK lanes of the bench batch, capture i at ksel
i % 4 and s8 (i // 4) % 8, every pair twice; the Viterbi on the 205
48-state blocks that ``fsk_demod_bits`` gives it for ``chip_smoke.py``
phase 3e's clean 2^24-sample capture (random bytes at 9600 Bd, 1200/2200
Hz) or, with ``--batch``, on the 1,640 blocks of one launch for 8 FSK9600
captures of one continuous transmission (phase 5l's ``modem.batch_mlse``
batch, through ``fsk_demod_bits_each``), with cycles a step at the SM clock
read; the FEC Viterbi on the 205 blocks of 9,216 steps that the stream-FEC
decode of one 2^24-sample QPSK@9600 capture gives it (a random 208,915-byte
file, framed, stream-FEC coded, modulated and demodulated on the card: zero
start, best end) or, with ``--container``, on one block of 9,216 steps with known
boundaries (a coded random stream, 2% of its bits flipped), with cycles a
step. The report gives each variant's time (median of ``--reps`` CUDA-event timings after one warm-up),
the kernel's own device time per call under ``torch.profiler`` (the
wrapper's table work left out),
the host time per call (50 calls back to back, before the synchronize),
the number of outputs that differ from the first variant's (K2, K3, K4, K6: and
from the plain version's on the same inputs), the card's SM
clock and power draw while the variant runs back to back for two seconds
(``nvidia-smi``), ``nvcc``'s register and spill lines of the kernel's
instantiations, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import time
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
          "fsk_flat": "amr_fsk_tile", "project_diff": "amr_project_diff_batch", "sector_match": "amr_sector_first",
          "rotation_match": "amr_rotation_first", "psk8_pack": "amr_psk8_pack",
          "relabel_pack": "amr_relabel_pack", "bit_select_pack": "amr_bit_select_pack",
          "mlse_viterbi": "amr_mlse_viterbi", "fec_viterbi": "amr_fec_viterbi"}
# The names of each kernel's device functions (the profiler's "alone" time
# sums them; the first also picks nvcc's register lines).
_KERNEL = {"decide": ("decide_kernel",), "fsk_tile": ("fsk_tile_kernel",),
           "neural_extract": ("neural_extract_kernel", "neural_extract_tc_kernel"), "fsk_flat": ("fsk_flat_kernel",),
           "project_diff": ("project_diff_kernel",), "sector_match": ("sector_match_kernel",),
           "rotation_match": ("rotmatch_kernel",), "psk8_pack": ("psk8_pack_kernel",),
           "relabel_pack": ("relabel_pack_kernel",), "bit_select_pack": ("bit_select_pack_kernel",),
           "mlse_viterbi": ("mlse_viterbi_kernel",), "fec_viterbi": ("fec_viterbi_kernel",)}
_PSK = {2: ("BPSK", 3000.0), 4: ("QPSK", 3000.0), 8: ("8PSK", 12000.0)}
_N_PSK = {mode: n for n, (mode, _c) in _PSK.items()}
_MANGLED = {"int16": "s", "int8": "a", "float32": "f"}  # a C++ type's code in a mangled name


def _kernel_ms(call, names, reps: int, tries: int = 3) -> float:
    """Device time per call of the kernels whose name holds one of ``names``,
    under ``torch.profiler`` over ``reps`` calls (the wrapper's other work
    left out). A profile that caught fewer of the kernels' launches than
    ``reps`` is taken again, up to ``tries`` times in all; 0 if none caught
    them all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        hits = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names)]
        if len(hits) >= reps:
            return sum(e.time_range.elapsed_us() for e in hits) / 1e3 / reps
    return 0.0


def _host_us(call, n: int = 50) -> float:
    """Host time per call in us: ``n`` calls back to back by the host clock,
    before the synchronize (the wrapper's checks, allocations and launch)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def clock_samples(call, seconds: float = 2.0):
    """(median SM clock in MHz, median power draw in W, number of reads) of
    ``nvidia-smi`` every quarter second while ``call`` runs back to back for
    about ``seconds``; (nan, nan, 0) if none was read."""
    import statistics
    import threading

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
        return float("nan"), float("nan"), 0
    return statistics.median(c for c, _ in samples), statistics.median(p for _, p in samples), len(samples)


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


def _neural_args(device):
    from .ops.neural import _codebook, td_sync_batch

    x = torch.from_numpy(_wave("NEURAL", 9600)[None]).to(device).expand(B, -1).contiguous()
    k0, pr, pi = td_sync_batch(x, 2)
    r3 = N // 128
    x2d = x.reshape(B * r3, 128)
    cb = torch.from_numpy(_codebook()).to(device)
    ph = torch.stack([pr, pi], dim=1).contiguous()
    s = (k0 % 128).to(torch.int32)
    return x2d, cb, ph, s, r3


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
    x, W8, best, theta = _pass1_rows(_PSK[n_psk][0], device, dtype)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    return lambda: tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=x.shape[1], n_psk=n_psk)


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


def _pass1_rows(mode: str, device, dtype: str, noise_last: bool = False):
    """The PSK bench batch's rows, pass 1's offsets and rotations, and the
    templates; with ``noise_last`` the last capture's samples are seeded
    noise."""
    from .ops.psk import _batch_pass1, _device_tables

    n_psk = _N_PSK[mode]
    carrier = _PSK[n_psk][1]
    x = _psk_rows(mode, dtype, device)
    if noise_last:
        g = torch.Generator(device=device).manual_seed(9)
        noise = torch.randn(x.shape[1:], generator=g, device=device) * 0.3
        x[-1] = (noise * 32767.0).round().clamp(-32768, 32767).to(x.dtype) if dtype == "int16" else noise
    b, r, row = x.shape
    spsym = row // 128
    _, _, best, theta = _batch_pass1(None, x, b, r * 128, spsym, carrier, SR, 8, r,
                                     n_psk=8 if n_psk == 8 else 4)
    W8, _, _ = _device_tables(spsym, carrier, SR, 8, device)
    return x, W8, best, theta


def _decisions(mode: str, device, noise_last: bool = False):
    """K1's decisions of the PSK bench batch (int16 rows): (hi, lo) for QPSK
    and BPSK, the sectors for 8PSK."""
    x, W8, best, theta = _pass1_rows(mode, device, "int16", noise_last)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    return tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=x.shape[1], n_psk=_N_PSK[mode])


def _project_diff_call(device, dtype: str, single: bool):
    """K12 on the 8PSK bench batch, or K11 on its capture in the
    single-capture receiver's layout (rows padded to a multiple of 64)."""
    x, W8, best, _ = _pass1_rows("8PSK", device, "float32" if single else dtype)
    if not single:
        return lambda: tk.psk_project_diff_batch(x, W8, best, rows_per_capture=x.shape[1])
    row = x.shape[2]
    del x
    r = -(-(-(-N // (row // 128)) // 128) // 64) * 64
    wave = torch.from_numpy(_wave("8PSK", 9600)).to(device)
    x2d = torch.nn.functional.pad(wave, (0, r * row - N)).reshape(r, row)
    w = W8[best[0]]
    return lambda: tk.psk_project_diff(x2d, w, block_rows=64)


def _sector_call(device, rows_scanned: str, noise_last: bool):
    """K5 on K1's sectors of the 8PSK bench batch, through the wrapper."""
    from .framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    sec = _decisions("8PSK", device, noise_last)
    r = sec.shape[1]
    p = r if rows_scanned == "full" else int(rows_scanned)
    return lambda: tk.sector_match_batch(sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)


def _rotation_call(device, family: str, rows_scanned: str, noise_last: bool):
    """(call, plain): K2 on K1's QPSK or BPSK decision lanes of the bench
    batch, through the wrapper, and the plain version's (first, found) on
    the same lanes."""
    from .framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    hi, lo = _decisions("QPSK" if family == "qpsk" else "BPSK", device, noise_last)
    r = hi.shape[1]
    p = r if rows_scanned == "full" else int(rows_scanned)

    def call():
        return tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r, family=family,
                                       pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)

    def plain():
        conds, n_pat = tk._MATCH_FAMILIES[family](MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
        first = tk.rotation_match_batch_plain(hi, lo, conds, len(MAGIC_BIT_PATTERN), 3, p)
        found = (first < (1 << 30)) & (first < p * 128 - (n_pat + 1))
        return torch.where(found, first, 0), found
    return call, plain


def _psk8_pack_call(device):
    """(call, plain): K6 on K1's sectors of the 8PSK bench batch, capture i
    at ksel i % 8 and r8 (i // 8) % 8, and its plain version."""
    sec = _decisions("8PSK", device)
    i = torch.arange(sec.shape[0], device=device)
    ksel, r8 = (i % 8).to(torch.int32), (i // 8 % 8).to(torch.int32)
    return (lambda: tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=sec.shape[1]),
            lambda: tk.psk8_relabel_pack_rows_plain(sec, ksel, r8))


def _pack_call(device, kernel: str):
    """(call, plain): K3 on K1's QPSK lanes or K4 on K1's BPSK lanes of the
    bench batch, capture i at ksel i % 4 and s8 (i // 4) % 8, and its plain
    version."""
    wrapper, plain, mode = {"relabel_pack": (tk.relabel_pack_batch, tk.relabel_pack_batch_plain, "QPSK"),
                            "bit_select_pack": (tk.bit_select_pack_batch, tk.bit_select_pack_batch_plain,
                                                "BPSK")}[kernel]
    a, b = _decisions(mode, device)
    i = torch.arange(a.shape[0], device=device)
    s, ksel = (i // 4 % 8).to(torch.int32), (i % 4).to(torch.int32)
    return (lambda: wrapper(a, b, s, ksel, rows_per_capture=a.shape[1]),
            lambda: plain(a, b, s, ksel))


def viterbi_args(device, batch: bool):
    """The arguments of the ``mlse_viterbi_blocks`` call ``fsk_demod_bits``
    makes for ``chip_smoke.py`` phase 3e's clean 48-state capture, or with
    ``batch`` the one ``fsk_demod_bits_each`` makes for 8 FSK9600 captures
    of one continuous transmission of 16 KiB frames at leads 13 i."""
    from .ops import fsk as tf

    calls, real = [], tf.mlse_viterbi_blocks

    def record(*args):
        calls.append(args)
        return real(*args)

    tf.mlse_viterbi_blocks = record
    try:
        if not batch:
            payload = np.random.default_rng(500).integers(0, 256, 200_000, dtype=np.uint8).tobytes()
            wave = tf.fsk_modulate(payload, 9600, 1200.0, 2200.0, SR)
            x = np.zeros(N, np.float32)
            x[211:] = np.tile(wave, -(-(N - 211) // len(wave)))[: N - 211]
            tf.fsk_demod_bits(torch.from_numpy(x).to(device), 9600.0, 1200.0, 2200.0, SR)
        else:
            payload = np.random.default_rng(61).integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes()
            frame = pack_frame("mlse0.bin", payload, 0, 1, len(payload), crc32(payload))
            n_frames = (N - 8 * 13) // len(modulate("FSK9600", frame, 9600))
            wave = modulate("FSK9600", b"".join(pack_frame(f"mlse{j}.bin", payload, 0, 1, len(payload), crc32(payload))
                                                for j in range(n_frames)), 9600)
            x = np.zeros((8, N), np.float32)
            for i in range(8):
                x[i, 13 * i : 13 * i + len(wave)] = wave
            tf.fsk_demod_bits_each(torch.from_numpy(x).to(device), 9600.0, 1200.0, 2200.0, SR)
    finally:
        tf.mlse_viterbi_blocks = real
    return calls[0]


def fec_viterbi_args(device, container: bool, n: int = N):
    """The arguments of the ``fec_viterbi_blocks`` call that the port's
    stream-FEC decode makes for one ``n``-sample QPSK@9600 capture of a
    random file of n / 80 - 800 bytes (80 samples a byte; at 2^24 samples
    205 blocks of 9,216 steps, free boundaries), or with ``container`` one
    block of 9,216 coded pairs of random bits, 2% flipped, with known
    boundaries."""
    from . import fec as tfec
    from .modem import demodulate
    from .utils.compression import intelligent_compress

    rng = np.random.default_rng(83)
    if container:
        pairs = tfec.ConvolutionalEncoder().encode_bits(rng.integers(0, 2, 9216 - 6).astype(np.uint8))
        pairs = pairs ^ (rng.random(pairs.shape) < 0.02).astype(np.uint8)
        return torch.from_numpy(pairs.astype(np.float32)[None]).to(device), True
    data = rng.integers(0, 256, n // 80 - 800, dtype=np.uint8).tobytes()
    framed = pack_frame("fecv.bin", intelligent_compress(data), 0, 1, len(data), crc32(data))
    wave = modulate("QPSK", tfec.stream_fec_encode(framed), 9600)
    x = np.zeros(n, np.float32)
    x[: len(wave)] = wave[:n]
    raw = demodulate("QPSK", x, 9600, device=device)
    calls, real = [], tfec.fec_viterbi_blocks

    def record(*args):
        calls.append(args)
        return real(*args)

    tfec.fec_viterbi_blocks = record
    try:
        out = tfec.stream_fec_decode(raw, device=device)
    finally:
        tfec.fec_viterbi_blocks = real
    if out[: len(framed)] != framed:
        raise RuntimeError("the stream-FEC capture did not decode to its frame")
    return calls[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(_ENTRY), required=True)
    ap.add_argument("--variant", action="append", required=True, help="NAME=SOURCE[:FLAGS]")
    ap.add_argument("--dtype", choices=("int16", "int8", "float32"), default="int16", help="K1's and K12's rows")
    ap.add_argument("--n-psk", type=int, choices=sorted(_PSK), default=4, help="K1's decision")
    ap.add_argument("--single", action="store_true", help="project_diff: K11 on one float32 capture")
    ap.add_argument("--rows-scanned", choices=("256", "1792", "full"), default="256", help="K5's and K2's scanned rows")
    ap.add_argument("--noise-last", action="store_true", help="K5, K2: the bench batch's last capture noise")
    ap.add_argument("--family", choices=("qpsk", "bpsk"), default="qpsk", help="K2's hypotheses")
    ap.add_argument("--batch", action="store_true", help="mlse_viterbi: the 8-capture batch's 1,640 blocks")
    ap.add_argument("--container", action="store_true",
                    help="fec_viterbi: one 9,216-step block with known boundaries")
    ap.add_argument("--bf16", action="store_true", help="neural_extract: the bfloat16 operands")
    ap.add_argument("--argmax", choices=("loop", "dot"), default="loop", help="neural_extract: the argmax rule")
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
    entry, what, plain = _ENTRY[args.kernel], "", None
    if args.kernel == "decide":
        call = _decide_call(device, args.dtype, args.n_psk)
        what = f" ({args.dtype} rows, n_psk {args.n_psk})"
    elif args.kernel == "project_diff":
        call = _project_diff_call(device, args.dtype, args.single)
        what = " (K11, one float32 capture)" if args.single else f" ({args.dtype} rows)"
        entry = "amr_project_diff" if args.single else entry
    elif args.kernel == "sector_match":
        call = _sector_call(device, args.rows_scanned, args.noise_last)
        what = f" (rows_scanned {args.rows_scanned}{', last capture noise' if args.noise_last else ''})"
    elif args.kernel == "rotation_match":
        call, plain = _rotation_call(device, args.family, args.rows_scanned, args.noise_last)
        what = (f" (family {args.family}, rows_scanned {args.rows_scanned}"
                f"{', last capture noise' if args.noise_last else ''})")
    elif args.kernel == "psk8_pack":
        call, plain = _psk8_pack_call(device)
        what = " (every ksel x r8)"
    elif args.kernel in ("relabel_pack", "bit_select_pack"):
        call, plain = _pack_call(device, args.kernel)
        what = " (every ksel x s8)"
    elif args.kernel == "mlse_viterbi":
        vargs = viterbi_args(device, args.batch)
        call, plain = (lambda: tk.mlse_viterbi_blocks(*vargs)), (lambda: tk.mlse_viterbi_blocks_plain(*vargs))
        steps = vargs[0].shape[2]
        what = f" ({vargs[0].shape[0]} blocks x {steps} steps, {vargs[1].shape[0]} states)"
    elif args.kernel == "fec_viterbi":
        fargs = fec_viterbi_args(device, args.container)
        call, plain = (lambda: tk.fec_viterbi_blocks(*fargs)), (lambda: tk.fec_viterbi_blocks_plain(*fargs))
        steps = fargs[0].shape[1]
        what = f" ({fargs[0].shape[0]} blocks x {steps} steps, known boundaries {fargs[1]})"
    elif args.kernel == "neural_extract":
        nargs = _neural_args(device)
        call = (lambda: tk.neural_extract_batch(*nargs[:4], rows_per_capture=nargs[4], bf16=args.bf16,
                                                argmax=args.argmax))
        what = f" (bf16 {args.bf16}, argmax {args.argmax})"
    else:
        call = {"fsk_tile": _tile_call, "fsk_flat": _flat_call}[args.kernel](device)
    # The timed instantiation's mangled template arguments: K1's sample type,
    # n_psk and spsym 10; K12's sample type and spsym 10; K7's and K13's
    # sample type.
    k12_type = "f" if args.single else _MANGLED[args.dtype]
    instance = {"decide": f"I{_MANGLED[args.dtype]}Li{args.n_psk}ELi10E", "fsk_tile": "Is", "fsk_flat": "If",
                "project_diff": f"I{k12_type}Li10E"}.get(args.kernel, "")
    # K10's bf16 operands run its tensor-core kernel, its float32 ones the CUDA-core kernel.
    named = _KERNEL[args.kernel][1 if args.kernel == "neural_extract" and args.bf16 else 0]
    lines = [f"card: {card}", f"kernel: {args.kernel}{what}"]
    ref = None
    ref_plain = plain() if plain is not None else None
    ref_plain = ref_plain if ref_plain is None or isinstance(ref_plain, tuple) else (ref_plain,)
    for name, src, flags in variants:
        lib, log = built[name]
        ptxas = _ptxas_lines(log, named + instance)
        with _bound_to(lib, entry):
            got = call()
            torch.cuda.synchronize()
            ms = _median_ms(call, args.reps)
            kms = _kernel_ms(call, _KERNEL[args.kernel], args.reps)
            host = _host_us(call)
            mhz, watts, n_reads = clock_samples(call)
            clk = (f"SM clock {mhz:.0f} MHz, power {watts:.1f} W (median of {n_reads} reads)" if n_reads
                   else "clocks not read")
            if args.kernel in ("mlse_viterbi", "fec_viterbi") and n_reads:
                clk += f"; {kms * 1e-3 * mhz * 1e6 / steps:.1f} cycles a step (kernel alone)"
        got = got if isinstance(got, tuple) else (got,)  # K1's (hi, lo) at n_psk 2 and 4
        ref = got if ref is None else ref
        n_diff = sum(int((g != f).sum()) for g, f in zip(got, ref))
        diff = f"{n_diff} of {sum(g.numel() for g in got)} outputs differ from {variants[0][0]}"
        if args.kernel == "neural_extract" and args.bf16 and n_diff:
            outside = tk.neural_bf16_mismatches(*nargs[:4], nargs[4], got[0], ref[0], argmax=args.argmax)[1]
            diff += f" ({outside} of them not near ties)"
        if ref_plain is not None:
            diff += f", {sum(int((g != f).sum()) for g, f in zip(got, ref_plain))} from the plain version's"
        lines += [f"  {ln}" for ln in ptxas]
        lines.append(f"{name} ({src} {' '.join(flags)}): wrapper {ms:.4f} ms, kernel alone {kms:.4f} ms, host "
                     f"{host:.1f} us a call; {diff}; {clk} | {card}")
        print("\n".join(lines[-1 - len(ptxas):]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
