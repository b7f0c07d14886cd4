#!/usr/bin/env python3
"""Drive the PyTorch port's batched DQPSK receive once on one NVIDIA GPU.

    python3 chip_smoke.py    # one card, full size, about 2-4 minutes

It runs only on a CUDA card; the CPU checks of the same code are the tests
``tests/test_torch_*.py``. On a host with several cards it uses the first
visible one and hides the others.

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compiles ``audio_modem_radio_tpu_torch/csrc/*.cu`` with nvcc;
3. K1 vs plain: a real QPSK@9600 batch of 8 x 2^24 samples through the
   port's pass 1, in float32 and int16 rows: decisions bitwise equal on
   clean captures, at most 1e-4 of them different on a capture with AWGN
   at 6 dB SNR;
4. K2 and K3 vs plain at the main path's row count: streams relabelled
   under every rotation and parity plus a noise capture; (first, found)
   equal on the 256-row prefix and on the full scan, packed bytes equal
   for every s8 except each capture's last byte;
5. the slice at real size: 64 captures x 2^24 samples (one seeded 16 KiB
   payload each, random leads, two captures at 3000 +- 100 Hz, one pure
   noise) through ``decode_sample_batch`` and ``parse_frames``, with the
   launch counts of K1, K2 and K3; then ``decode_wav_batch`` on 4 WAVs;
6. timing with CUDA events (one warm-up, median of 5): ``demod_pack_batch``
   on the 64 x 2^24 int16 batch staged on the card, cfo_retry on and off,
   and each kernel beside its plain version.

The line before the last is one JSON object with the kernels' names,
sources, launch counts, errors and times; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 96000
BAUD = 9600
SPSYM = SR // BAUD
CARRIER = 3000.0
_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
_SOURCES = {
    "psk_project_decide_batch": ("audio_modem_radio_tpu_torch/csrc/decide.cu",
                                 "audio_modem_radio_tpu/ops/pallas_kernels.py:359"),
    "rotation_match_batch": ("audio_modem_radio_tpu_torch/csrc/rotmatch.cu",
                             "audio_modem_radio_tpu/ops/pallas_kernels.py:1724"),
    "relabel_pack_batch": ("audio_modem_radio_tpu_torch/csrc/relabel_pack.cu",
                           "audio_modem_radio_tpu/ops/pallas_kernels.py:1325"),
}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# --- inputs -----------------------------------------------------------------------

def _payload(seed: int, n_bytes: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()


def _wave(payload: bytes, name: str, carrier: float = CARRIER) -> np.ndarray:
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops.psk import qpsk_modulate

    framed = pack_frame(name, payload, 0, 1, len(payload), crc32(payload))
    if carrier == CARRIER:
        return modulate("QPSK", framed, BAUD)
    return qpsk_modulate(framed, BAUD, carrier)


def _tiled(wave: np.ndarray, n: int, lead: int = 0) -> np.ndarray:
    out = np.zeros(n, np.float32)
    reps = -(-(n - lead) // len(wave))
    out[lead:] = np.tile(wave, reps)[: n - lead]
    return out


def _rows(batch: np.ndarray, int16: bool, device):
    """Blocked rows through the port's own host shaping, on ``device``."""
    import torch

    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel.batch import host_shape_batch

    old = CONFIG.get("tpu.int16_rows")
    CONFIG.set("tpu.int16_rows", int16)
    try:
        shaped = host_shape_batch(batch, "QPSK", BAUD, device=device)
    finally:
        CONFIG.set("tpu.int16_rows", old)
    return torch.from_numpy(shaped).to(device)


def _magic_streams(rng, r: int, k: int, parity: int, start_dib: int):
    """Random raw Gray lanes whose relabel by rotation k holds the magic +
    validation pattern at flat bit 2*start_dib + parity."""
    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    bits = rng.integers(0, 2, 2 * r * 128, dtype=np.uint8)
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    pos = 2 * start_dib + parity
    bits[pos : pos + len(pat)] = pat
    h, l = bits[0::2], bits[1::2]
    raw = _QT_TO_DIBIT[(2 * h + (h ^ l) + k) & 3]
    return raw[:, 0].reshape(r, 128), raw[:, 1].reshape(r, 128)


# --- timing -----------------------------------------------------------------------

def _time_ms(fn, reps: int = 5) -> float:
    """Median time of ``fn()`` in ms by CUDA events: one warm-up, then
    ``reps`` timed calls, each ending in a synchronize."""
    import torch

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


# --- phases -----------------------------------------------------------------------

def phase_environment():
    import torch

    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[1 env] device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    check(torch.cuda.device_count() == 1, "more than one card is visible")
    return torch.device("cuda"), card


def phase_build():
    from audio_modem_radio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.compile_library()
    _build.load_library()
    say(f"[2 build] {path.name} by {_build.find_nvcc()} in {time.perf_counter() - t0:.3f} s")
    kernel = None
    for line in log.splitlines():  # ptxas -v: one usage line per kernel
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "registers" in line and kernel:
            say(f"[2 build] {kernel[:60]}: {line.split(':', 1)[1].strip()}")


def phase_decide(device, n_cap: int, n: int, payload_bytes: int, card: str) -> float:
    """K1 vs plain on real captures; returns the max abs decision error on
    the clean captures."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables

    batch = np.stack([_tiled(_wave(_payload(100 + i, payload_bytes), f"k1_{i}.bin"), n, lead=3 * i)
                      for i in range(n_cap)])
    n_sig = n // SPSYM - 2
    gen = torch.Generator(device=device).manual_seed(1234)
    p_sig = float(np.mean(batch[0] ** 2))
    sigma = (p_sig / 10 ** (6.0 / 10)) ** 0.5
    noisy = batch[:1] + (torch.randn((1, n), generator=gen, device=device) * sigma).cpu().numpy()
    noisy = np.clip(noisy, -1.0, 1.0).astype(np.float32)
    worst = 0
    for int16 in (False, True):
        for label, data in (("clean", batch), ("awgn6dB", noisy)):
            x = _rows(data, int16, device)
            b, r, _ = x.shape
            _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, CARRIER, SR, 8, r)
            W8, _, _ = _device_tables(SPSYM, CARRIER, SR, 8, x.device)
            rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
            hi_k, lo_k = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r)
            hi_p, lo_p = tk.psk_project_decide_batch_plain(x, W8, best, rot)
            torch.cuda.synchronize()
            diff = torch.cat([
                (hi_k.reshape(b, -1)[:, :n_sig] != hi_p.reshape(b, -1)[:, :n_sig]),
                (lo_k.reshape(b, -1)[:, :n_sig] != lo_p.reshape(b, -1)[:, :n_sig]),
            ], dim=1)
            n_bad = int(diff.sum())
            frac = n_bad / diff.numel()
            dtype = "int16" if int16 else "f32"
            say(f"[3 K1] {label} {dtype} rows B={b} R={r}: best={best.tolist()} "
                f"mismatches={n_bad} of {diff.numel()} ({frac:.3e}) | {card}")
            if label == "clean":
                check(n_bad == 0, f"K1 differs from plain on clean {dtype} captures")
                worst = max(worst, int(n_bad > 0))
            else:
                check(frac <= 1e-4, f"K1 mismatch fraction {frac} > 1e-4 at 6 dB SNR")
    return float(worst)


def phase_match_pack(device, r: int, card: str):
    """K2 and K3 vs plain; returns their max abs errors."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    rng = np.random.default_rng(7)
    caps, starts = [], []
    for parity in (0, 1):
        for k in range(4):
            start = 500 + 3001 * (4 * parity + k)
            caps.append(_magic_streams(rng, r, k, parity, start))
            starts.append(start)
    caps.append((rng.integers(0, 2, (r, 128), dtype=np.uint8),
                 rng.integers(0, 2, (r, 128), dtype=np.uint8)))
    hi = torch.from_numpy(np.stack([c[0] for c in caps])).to(device)
    lo = torch.from_numpy(np.stack([c[1] for c in caps])).to(device)
    b = hi.shape[0]
    conds, _ = tk.rotation_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    k2_err = 0
    for p in (256, r):
        first_k, found_k = tk.rotation_match_batch(
            hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)
        first_raw = tk.rotation_match_batch_plain(hi, lo, conds, len(MAGIC_BIT_PATTERN), 3, p)
        limit = p * 128 - 17
        found_p = (first_raw < (1 << 30)) & (first_raw < limit)
        first_p = torch.where(found_p, first_raw, torch.zeros_like(first_raw))
        k2_err = max(k2_err, int((first_k - first_p).abs().max()))
        check(torch.equal(found_k, found_p) and torch.equal(first_k, first_p),
              f"K2 differs from plain on the {p}-row scan")
        for h in range(8):
            check(bool(found_k[h, h]) and int(first_k[h, h]) == starts[h],
                  f"K2 missed hypothesis {h} at {starts[h]}")
        if p == 256:
            check(not bool(found_k[-1].any()), "K2 matched the noise capture in the 256-row prefix")
        say(f"[4 K2] rows_scanned={p} of R={r}, B={b}: first/found equal; "
            f"noise-capture hypotheses found={int(found_k[-1].sum())} | {card}")
    k3_err = 0
    s8 = torch.arange(b, device=device, dtype=torch.int32) % 8
    for j in range(4):
        s = (8 * torch.randint(0, 5000, (b,), device=device, dtype=torch.int32) + s8).to(torch.int32)
        ksel = ((torch.arange(b, device=device) + j) % 4).to(torch.int32)
        got = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)
        ref = tk.relabel_pack_batch_plain(hi, lo, s, ksel)
        err = int((got[:, :-1].int() - ref[:, :-1].int()).abs().max())
        k3_err = max(k3_err, err)
        check(err == 0, f"K3 differs from plain (rotation offset {j})")
    say(f"[4 K3] R={r}, B={b}, every s8 in 0..7 x every k: bytes equal except each "
        f"capture's last | {card}")
    return float(k2_err), float(k3_err)


def phase_slice(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """The main path at real size; returns the launch counts of its run."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    rng = np.random.default_rng(2024)
    t0 = time.perf_counter()
    batch = np.empty((n_cap, n), np.float32)
    payloads, min_frames = [], []
    noise_i = n_cap - 1
    for i in range(n_cap):
        if i == noise_i:
            batch[i] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
            payloads.append(None)
            min_frames.append(0)
            continue
        carrier = {1: CARRIER + 100.0, 2: CARRIER - 100.0}.get(i, CARRIER)
        p = _payload(5000 + i, payload_bytes)
        wave = _wave(p, f"cap{i}.bin", carrier)
        batch[i] = _tiled(wave, n, lead=int(rng.integers(0, 1281)))
        payloads.append(p)
        min_frames.append(n // len(wave) - 1)
    say(f"[5 slice] built {n_cap} x {n} captures in {time.perf_counter() - t0:.1f} s")

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, "QPSK", BAUD, device=device)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    say(f"[5 slice] decode_sample_batch wall {wall:.3f} s (host shaping, copy, device, "
        f"copy back) launches={counts} | {card}")
    for name, c in counts.items():
        check(c > 0, f"{name} was not launched on the main path")

    n_frames = []
    for i, raw in enumerate(raws):
        frames = parse_frames(raw)
        n_frames.append(len(frames))
        if payloads[i] is None:
            check(not frames, f"noise capture {i} yielded {len(frames)} frames")
            continue
        check(all(f.data == payloads[i] for f in frames), f"capture {i} decoded a foreign payload")
        check(len(frames) >= min_frames[i],
              f"capture {i}: {len(frames)} frames < {min_frames[i]}")
    say(f"[5 slice] frames per capture min={min(n_frames[:noise_i])} max={max(n_frames)} "
        f"(need >= {min(min_frames[:noise_i])}); noise capture frames={n_frames[noise_i]}")
    del batch, raws

    _wav_roundtrip(device, payload_bytes)
    return counts


def _wav_roundtrip(device, payload_bytes: int) -> None:
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.parallel.batch import decode_wav_batch
    from audio_modem_radio_tpu_torch.utils.compression import intelligent_compress
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    try:
        sources, wavs = [], []
        for i in range(4):
            data = (f"wav file {i} ".encode() * 100) + _payload(900 + i, payload_bytes // 4)
            blob = intelligent_compress(data)
            framed = pack_frame(f"src{i}.bin", blob, 0, 1, len(data), crc32(data))
            path = os.path.join(work, f"src{i}.wav")
            write_wav(path, modulate("QPSK", framed, BAUD))
            sources.append(data)
            wavs.append(path)
        saved = decode_wav_batch(wavs, "QPSK", BAUD, recv_dir=os.path.join(work, "recv"),
                                 registry=AssemblyRegistry(journal_dir=""), device=device)
        for i, paths in enumerate(saved):
            check(len(paths) == 1, f"WAV {i}: {len(paths)} files saved")
            with open(paths[0], "rb") as f:
                check(f.read() == sources[i], f"WAV {i}: saved file differs from its source")
        say("[5 slice] decode_wav_batch: 4 WAVs written by the port, 4 saved files byte-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_timing(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """Times on the bench workload; returns {kernel: (ms, plain_ms)}."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch, psk4_kernel_sync_tail

    one = _rows(_tiled(_wave(_payload(0, payload_bytes), "bench.bin"), n)[None], True, device)
    x = one.expand(n_cap, -1, -1).contiguous()  # ship once, tile on the card
    del one
    b, r, row = x.shape
    msps = {}
    for cfo in (True, False):
        ms = _time_ms(lambda: demod_pack_batch(x, "QPSK", BAUD, cfo_retry=cfo))
        msps[cfo] = b * n / (ms * 1e-3) / 1e6
        say(f"[6 time] demod_pack_batch {b} x {n} int16 rows cfo_retry={'on' if cfo else 'off'}: "
            f"{ms:.3f} ms = {msps[cfo]:.2f} Msamples/s | {card}")

    _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, CARRIER, SR, 8, r)
    W8, _, _ = _device_tables(SPSYM, CARRIER, SR, 8, x.device)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    hi, lo = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r)
    _, _, found = psk4_kernel_sync_tail(hi.reshape(b, -1), lo.reshape(b, -1), True)
    check(bool(found.all()), "bench batch: a capture found no magic")
    conds, _ = tk.rotation_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    first, found8 = tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r,
                                            pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
    s = (2 * first[:, 0]).to(torch.int32)
    ksel = torch.zeros(b, dtype=torch.int32, device=x.device)

    t = {}
    t["psk_project_decide_batch"] = (
        _time_ms(lambda: tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r)),
        _time_ms(lambda: tk.psk_project_decide_batch_plain(x, W8, best, rot)),
    )
    for p in (256, r):
        t[f"rotation_match_batch@{p}"] = (
            _time_ms(lambda: tk.rotation_match_batch(
                hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)),
            _time_ms(lambda: tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, p)),
        )
    t["relabel_pack_batch"] = (
        _time_ms(lambda: tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)),
        _time_ms(lambda: tk.relabel_pack_batch_plain(hi, lo, s, ksel)),
    )
    for name, (ms, plain) in t.items():
        say(f"[6 time] {name} B={b} R={r}: kernel {ms:.4f} ms, plain {plain:.4f} ms | {card}")
    return t, msps


def main() -> int:
    n, n_k1, n_slice, payload_bytes = 1 << 24, 8, 64, 16384
    # One card: the first visible one (set before torch initialises CUDA).
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false: this smoke needs a card")
        return 2
    sys.path.insert(0, HERE)
    try:
        import audio_modem_radio_tpu_torch  # noqa: F401
        from audio_modem_radio_tpu_torch.ops.psk import blocked_row_shape
    except ImportError as e:
        say(f"FAIL: the port's package is not beside this script ({e})")
        return 2

    t_start = time.perf_counter()
    phase = "1 env"
    try:
        device, card = phase_environment()
        phase = "2 build"
        phase_build()
        phase = "3 K1"
        k1_err = phase_decide(device, n_k1, n, payload_bytes, card)
        phase = "4 K2/K3"
        r = blocked_row_shape(n, BAUD, SR)[0]
        k2_err, k3_err = phase_match_pack(device, r, card)
        phase = "5 slice"
        counts = phase_slice(device, n_slice, n, payload_bytes, card)
        phase = "6 timing"
        times, _ = phase_timing(device, n_slice, n, payload_bytes, card)
    except Exception as e:  # any failure: report the phase, print no result
        import traceback

        traceback.print_exc()
        say(f"FAIL in phase {phase}: {type(e).__name__}: {e}")
        return 1

    errs = {"psk_project_decide_batch": k1_err, "rotation_match_batch": k2_err,
            "relabel_pack_batch": k3_err}
    timed = {"psk_project_decide_batch": times["psk_project_decide_batch"],
             "rotation_match_batch": times["rotation_match_batch@256"],
             "relabel_pack_batch": times["relabel_pack_batch"]}
    kernels = [
        {"name": name, "route": "cuda", "source": _SOURCES[name][0],
         "replaces": _SOURCES[name][1], "launches": counts[name],
         "max_abs_err": errs[name], "ms": timed[name][0], "plain_ms": timed[name][1]}
        for name in _SOURCES
    ]
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s | {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
