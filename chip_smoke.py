#!/usr/bin/env python3
"""Drive the PyTorch port's batched PSK receive (DQPSK, DBPSK, D8PSK) once
on one NVIDIA GPU.

    python3 chip_smoke.py    # one card, full size, about 5-8 minutes

It runs only on a CUDA card; the CPU checks of the same code are the tests
``tests/test_torch_*.py``. On a host with several cards it uses the first
visible one and hides the others. Every phase prints its seconds.

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compiles ``audio_modem_radio_tpu_torch/csrc/*.cu``, one nvcc per
   source, all at once;
3. K1 vs plain: real QPSK@9600 (3 kHz), BPSK@9600 (3 kHz) and
   8PSK@9600 (12 kHz) batches of 8 x 2^24 samples through the port's host
   shaping and pass 1, in float32 and int16 rows (and int8 rows for QPSK):
   decisions bitwise equal on clean captures, at most 1e-4 of them
   different on a capture with AWGN at 6 dB SNR. DBPSK's lo stream (the
   sign of the imaginary part, rounding noise on a clean derotated
   capture) is compared under a further π/4 rotation, where it carries
   the signal;
4. the matchers and packs vs plain at the main path's row count: K2 (qpsk
   and bpsk families), K5 on streams built under every hypothesis plus a
   noise capture, (first, found) equal on the 256-row prefix and on the
   full scan; K3, K4 and K6 packed bytes equal on every byte, for every
   shift;
5. the slices at real size, 5 QPSK, 5b BPSK, 5c 8PSK: 64 captures x 2^24
   samples each (one seeded 16 KiB payload per capture, 0-2 bytes shorter
   for 8PSK so that the tiled frames stay byte-aligned, random leads, two
   captures at the carrier +- 100 Hz, one pure noise) through
   ``decode_sample_batch`` and ``parse_frames``; each slice must launch its
   own three kernels and none of the others' (launch counts reset before
   each); then ``decode_wav_batch`` on 4 WAVs written by the port (QPSK
   and 8PSK);
6. timing with CUDA events (one warm-up, median of 5): ``demod_pack_batch``
   of each mode on its 64 x 2^24 int16 batch staged on the card, cfo_retry
   on and off, and each kernel and variant beside its plain version (K1@4
   also on int8 rows).

The line before the last is one JSON object with the kernels' names,
sources, launch counts, errors and times (one entry per kernel and
variant); the last line is ``{"ok": true, "device": {...}}``. It imports
nothing of JAX.
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
_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
_PALLAS = "audio_modem_radio_tpu/ops/pallas_kernels.py"
_CSRC = "audio_modem_radio_tpu_torch/csrc"
# Each slice: carrier, the decision's n_psk, the kernels its main path must
# launch, and whether phase 5 also decodes WAVs written by the port.
_SLICES = {
    "QPSK": dict(carrier=3000.0, n_psk=4, wav=True, kernels=(
        "psk_project_decide_batch", "rotation_match_batch", "relabel_pack_batch")),
    "BPSK": dict(carrier=3000.0, n_psk=2, wav=False, kernels=(
        "psk_project_decide_batch", "rotation_match_batch", "bit_select_pack_batch")),
    "8PSK": dict(carrier=12000.0, n_psk=8, wav=True, kernels=(
        "psk_project_decide_batch", "sector_match_batch", "psk8_relabel_pack_rows")),
}
# The kernels line: entry -> (wrapper, the slice whose run gives its
# launches, source, the TPU kernel it replaces).
_ENTRIES = {
    "psk_project_decide_batch@4": ("psk_project_decide_batch", "QPSK", "decide.cu", 359),
    "psk_project_decide_batch@2": ("psk_project_decide_batch", "BPSK", "decide.cu", 359),
    "psk_project_decide_batch@8": ("psk_project_decide_batch", "8PSK", "decide.cu", 359),
    "rotation_match_batch:qpsk": ("rotation_match_batch", "QPSK", "rotmatch.cu", 1724),
    "rotation_match_batch:bpsk": ("rotation_match_batch", "BPSK", "rotmatch.cu", 1724),
    "relabel_pack_batch": ("relabel_pack_batch", "QPSK", "relabel_pack.cu", 1325),
    "bit_select_pack_batch": ("bit_select_pack_batch", "BPSK", "bit_select_pack.cu", 1510),
    "sector_match_batch": ("sector_match_batch", "8PSK", "sector_match.cu", 1900),
    "psk8_relabel_pack_rows": ("psk8_relabel_pack_rows", "8PSK", "psk8_pack.cu", 2021),
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


def _wave(payload: bytes, name: str, mode: str = "QPSK", offset_hz: float = 0.0) -> np.ndarray:
    """A framed ``mode`` wave through the port's ``modulate``, or through its
    modulator on the mode's carrier + ``offset_hz``."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops.psk import bpsk_modulate, psk8_real_modulate, qpsk_modulate

    framed = pack_frame(name, payload, 0, 1, len(payload), crc32(payload))
    if offset_hz == 0.0:
        return modulate(mode, framed, BAUD)
    fn = {"QPSK": qpsk_modulate, "BPSK": bpsk_modulate, "8PSK": psk8_real_modulate}[mode]
    return fn(framed, BAUD, _SLICES[mode]["carrier"] + offset_hz)


def _tiled(wave: np.ndarray, n: int, lead: int = 0) -> np.ndarray:
    out = np.zeros(n, np.float32)
    reps = -(-(n - lead) // len(wave))
    out[lead:] = np.tile(wave, reps)[: n - lead]
    return out


def _rows(batch: np.ndarray, dtype: str, device, mode: str = "QPSK"):
    """Blocked rows ("f32", "int16" or "int8") through the port's own host
    shaping, on ``device``."""
    import torch

    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel.batch import host_shape_batch

    old = CONFIG.get("tpu.int16_rows"), CONFIG.get("tpu.int8_rows")
    CONFIG.set("tpu.int16_rows", dtype == "int16")
    CONFIG.set("tpu.int8_rows", dtype == "int8")
    try:
        shaped = host_shape_batch(batch, mode, BAUD, device=device)
    finally:
        CONFIG.set("tpu.int16_rows", old[0])
        CONFIG.set("tpu.int8_rows", old[1])
    return torch.from_numpy(shaped).to(device)


def _magic_bits(rng, n_bits: int, start: int) -> np.ndarray:
    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    bits = rng.integers(0, 2, n_bits, dtype=np.uint8)
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    bits[start : start + len(pat)] = pat
    return bits


def _magic_streams(rng, r: int, k: int, parity: int, start_dib: int):
    """Random raw Gray lanes whose relabel by rotation k holds the magic +
    validation pattern at flat bit 2*start_dib + parity."""
    bits = _magic_bits(rng, 2 * r * 128, 2 * start_dib + parity)
    h, l = bits[0::2], bits[1::2]
    raw = _QT_TO_DIBIT[(2 * h + (h ^ l) + k) & 3]
    return raw[:, 0].reshape(r, 128), raw[:, 1].reshape(r, 128)


def _bpsk_streams(rng, r: int, h: int, start: int):
    """Random re/im sign-bit lanes with the magic + validation pattern at bit
    ``start`` of stream h & 1 (0 re, 1 im), complemented for h >= 2."""
    pat = _magic_bits(rng, r * 128, start) ^ np.uint8(h >= 2)
    other = rng.integers(0, 2, r * 128, dtype=np.uint8)
    re, im = (other, pat) if h & 1 else (pat, other)
    return re.reshape(r, 128), im.reshape(r, 128)


def _psk8_stream(rng, r: int, k: int, lead: int):
    """Random received sectors whose tribits, read as rotation-k sectors,
    hold the magic + validation pattern at symbol ``lead``."""
    from audio_modem_radio_tpu_torch.ops.psk import _GRAY8_INV

    bits = _magic_bits(rng, 3 * r * 128, 3 * lead)
    tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
    return ((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8).reshape(r, 128)


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


def phase_decide(device, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """K1 vs plain on real captures of every slice's mode; returns the max
    abs decision error on the clean captures per kernels-line entry.

    Decisions are bitwise equal on clean captures and differ on at most 1e-4
    of them on a capture with AWGN at 6 dB SNR. One exception is stated: a
    clean DBPSK differential is real after derotation by θ, so the sign of
    its imaginary part (K1@2's lo stream) is rounding noise there; lo is
    compared under θ + π/4, where it carries the signal, and hi under both.
    """
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables

    errs = {}
    cases = [(mode, dtype) for mode in _SLICES for dtype in ("f32", "int16")] + [("QPSK", "int8")]
    batches = {}
    for mode, dtype in cases:
        t0 = time.perf_counter()
        spec = _SLICES[mode]
        n_psk, carrier = spec["n_psk"], spec["carrier"]
        if mode not in batches:
            clean = np.stack([_tiled(_wave(_payload(100 + i, payload_bytes), f"k1_{i}.bin", mode), n,
                                     lead=3 * i) for i in range(n_cap)])
            gen = torch.Generator(device=device).manual_seed(1234)
            sigma = (float(np.mean(clean[0] ** 2)) / 10 ** (6.0 / 10)) ** 0.5
            noisy = clean[:1] + (torch.randn((1, n), generator=gen, device=device) * sigma).cpu().numpy()
            batches[mode] = (clean, np.clip(noisy, -1.0, 1.0).astype(np.float32))
        n_sig = n // SPSYM - 2
        worst = 0
        for label, data in zip(("clean", "awgn6dB"), batches[mode]):
            x = _rows(data, dtype, device, mode)
            b, r, _ = x.shape
            _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r,
                                             n_psk=8 if n_psk == 8 else 4)
            W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, x.device)
            # (rotation, number of output streams compared) per comparison.
            rots = [(theta, 1), (theta + np.pi / 4, 2)] if n_psk == 2 else [(theta, 2)]
            n_bad = n_all = 0
            for th, n_streams in rots:
                rot = torch.stack([torch.cos(th), torch.sin(th)], dim=1)
                got = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
                ref = tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)
                if n_psk == 8:
                    got, ref = (got,), (ref,)
                torch.cuda.synchronize()
                for g, p in list(zip(got, ref))[:n_streams]:
                    g = g.reshape(b, -1)[:, :n_sig].int()
                    p = p.reshape(b, -1)[:, :n_sig].int()
                    n_bad += int((g != p).sum())
                    n_all += g.numel()
                    if label == "clean":
                        worst = max(worst, int((g - p).abs().max()))
            frac = n_bad / n_all
            say(f"[3 K1@{n_psk}] {mode} {label} {dtype} rows B={b} R={r}: best={best.tolist()} "
                f"mismatches={n_bad} of {n_all} ({frac:.3e}) | {card}")
            if label == "clean":
                check(n_bad == 0, f"K1@{n_psk} differs from plain on clean {mode} {dtype} captures")
            else:
                check(frac <= 1e-4, f"K1@{n_psk} mismatch fraction {frac} > 1e-4 at 6 dB SNR")
            del x
        key = f"psk_project_decide_batch@{n_psk}"
        errs[key] = float(max(errs.get(key, 0.0), worst))
        say(f"[3 K1@{n_psk}] {mode} {dtype}: {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def _check_match(name, got, ref_first, limit, expect, card, p, r, b):
    """(first, found) of a kernel vs its plain version's raw first positions
    after the limit epilogue; ``expect`` lists (capture, hypothesis, first)
    that must be found. Returns the max abs error of first."""
    import torch

    first_k, found_k = got
    found_p = (ref_first < (1 << 30)) & (ref_first < limit)
    first_p = torch.where(found_p, ref_first, torch.zeros_like(ref_first))
    check(torch.equal(found_k, found_p) and torch.equal(first_k, first_p),
          f"{name} differs from plain on the {p}-row scan")
    for i, h, pos in expect:
        if pos < limit:
            check(bool(found_k[i, h]) and int(first_k[i, h]) == pos,
                  f"{name} missed hypothesis {h} at {pos}")
    say(f"[4 {name}] rows_scanned={p} of R={r}, B={b}: first/found equal; "
        f"noise-capture hypotheses found={int(found_k[-1].sum())} | {card}")
    return int((first_k - first_p).abs().max())


def phase_match_pack(device, r: int, card: str) -> dict:
    """K2 (both families), K3, K4, K5 and K6 vs plain at the main path's row
    count; returns the max abs error per kernels-line entry."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    t0 = time.perf_counter()
    pattern = MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2
    rng = np.random.default_rng(7)
    errs = {}

    def lanes(caps):
        caps = caps + [tuple(rng.integers(0, 2, (r, 128), dtype=np.uint8) for _ in caps[0])]
        return [torch.from_numpy(np.stack([c[j] for c in caps])).to(device) for j in range(len(caps[0]))]

    # K2 family qpsk: every rotation x parity, plus a noise capture.
    starts = [500 + 3001 * h for h in range(8)]
    hi, lo = lanes([_magic_streams(rng, r, h % 4, h // 4, starts[h]) for h in range(8)])
    conds, _ = tk.rotation_match_conditions(pattern)
    errs["rotation_match_batch:qpsk"] = float(max(
        _check_match("K2 qpsk", tk.rotation_match_batch(
            hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, p), p * 128 - 17,
            [(h, h, starts[h]) for h in range(8)], card, p, r, hi.shape[0])
        for p in (256, r)))
    # K3 on the same lanes: every s8 in 0..7 x every k.
    b = hi.shape[0]
    k3 = 0
    for j in range(8):
        s = (8 * torch.randint(0, 5000, (b,), device=device, dtype=torch.int32)
             + (torch.arange(b, device=device) + j) % 8).to(torch.int32)
        ksel = ((torch.arange(b, device=device) + j) % 4).to(torch.int32)
        got = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)
        ref = tk.relabel_pack_batch_plain(hi, lo, s, ksel)
        k3 = max(k3, int((got.int() - ref.int()).abs().max()))
    check(k3 == 0, "K3 differs from plain")
    errs["relabel_pack_batch"] = float(k3)
    say(f"[4 K3] R={r}, B={b}, every s8 in 0..7 x every k: bytes equal | {card}")

    # K2 family bpsk: every stream x inversion, plus a noise capture; K4 on them.
    starts = [700 + 4001 * h for h in range(4)]
    re, im = lanes([_bpsk_streams(rng, r, h, starts[h]) for h in range(4)])
    conds, _ = tk.bpsk_match_conditions(pattern)
    errs["rotation_match_batch:bpsk"] = float(max(
        _check_match("K2 bpsk", tk.rotation_match_batch(
            re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.rotation_match_batch_plain(re, im, conds, 16, 3, p), p * 128 - 33,
            [(h, h, starts[h]) for h in range(4)], card, p, r, re.shape[0])
        for p in (256, r)))
    b = re.shape[0]
    k4 = 0
    for j in range(8):
        s = (8 * torch.randint(0, 5000, (b,), device=device, dtype=torch.int32)
             + (torch.arange(b, device=device) + j) % 8).to(torch.int32)
        ksel = ((torch.arange(b, device=device) + j) % 4).to(torch.int32)
        got = tk.bit_select_pack_batch(re, im, s, ksel, rows_per_capture=r)
        ref = tk.bit_select_pack_batch_plain(re, im, s, ksel)
        k4 = max(k4, int((got.int() - ref.int()).abs().max()))
    check(k4 == 0, "K4 differs from plain")
    errs["bit_select_pack_batch"] = float(k4)
    say(f"[4 K4] R={r}, B={b}, every s8 in 0..7 x every ksel: bytes equal | {card}")

    # K5: every rotation, plus a noise capture; K6 on them. Uniform random
    # sectors false-match some hypothesis about once per 32k symbols, so the
    # planted magic sits near the start.
    starts = [50 + 97 * k for k in range(8)]
    sec = [_psk8_stream(rng, r, k, starts[k]) for k in range(8)]
    sec = torch.from_numpy(np.stack(sec + [rng.integers(0, 8, (r, 128), dtype=np.uint8)])).to(device)
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    errs["sector_match_batch"] = float(max(
        _check_match("K5", tk.sector_match_batch(
            sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.sector_match_batch_plain(sec, conds, 3, p), p * 128 - (n_sym + 1),
            [(k, k, starts[k]) for k in range(8)], card, p, r, sec.shape[0])
        for p in (256, r)))
    b = sec.shape[0]
    k6 = 0
    for j in range(8):
        ksel = ((torch.arange(b, device=device) + j) % 8).to(torch.int32)
        r8 = ((3 * torch.arange(b, device=device) + j) % 8).to(torch.int32)
        got = tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r)
        ref = tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)
        k6 = max(k6, int((got.int() - ref.int()).abs().max()))
    check(k6 == 0, "K6 differs from plain")
    errs["psk8_relabel_pack_rows"] = float(k6)
    say(f"[4 K6] R={r}, B={b}, every r8 in 0..7 x every ksel: bytes equal | {card}")
    say(f"[4] {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def phase_slice(device, mode: str, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """One slice's main path at real size; returns the launch counts of its
    ``decode_sample_batch`` run."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    tag = {"QPSK": "5", "BPSK": "5b", "8PSK": "5c"}[mode]
    rng = np.random.default_rng(2024)
    t_phase = t0 = time.perf_counter()
    batch = np.empty((n_cap, n), np.float32)
    payloads, min_frames = [], []
    noise_i = n_cap - 1
    for i in range(n_cap):
        if i == noise_i:
            batch[i] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
            payloads.append(None)
            min_frames.append(0)
            continue
        p = _payload(5000 + i, payload_bytes)
        if mode == "8PSK":
            # The tail aligns a capture once, at its first magic; the later
            # copies of a tiled wave stay byte-aligned only when the framed
            # length is a whole number of 8-symbol (3-byte) groups, so trim
            # the payload by 0-2 bytes (the JAX package behaves the same).
            p = p[: len(p) - len(pack_frame(f"cap{i}.bin", p, 0, 1, len(p), crc32(p))) % 3]
        wave = _wave(p, f"cap{i}.bin", mode, {1: 100.0, 2: -100.0}.get(i, 0.0))
        batch[i] = _tiled(wave, n, lead=int(rng.integers(0, 1281)))
        payloads.append(p)
        min_frames.append(n // len(wave) - 1)
    carrier = _SLICES[mode]["carrier"]
    say(f"[{tag} {mode}] built {n_cap} x {n} captures ({carrier:g} Hz carrier, captures 1 and 2 "
        f"at +-100 Hz, capture {noise_i} noise) in {time.perf_counter() - t0:.1f} s | {card}")

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, mode, BAUD, device=device)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    say(f"[{tag} {mode}] decode_sample_batch wall {wall:.3f} s (host shaping, copy, device, "
        f"copy back) launches={counts} | {card}")
    for name, c in counts.items():
        if name in _SLICES[mode]["kernels"]:
            check(c > 0, f"{name} was not launched on the {mode} path")
        else:
            check(c == 0, f"{name} was launched on the {mode} path")

    n_frames = []
    for i, raw in enumerate(raws):
        frames = parse_frames(raw)
        n_frames.append(len(frames))
        if payloads[i] is None:
            check(not frames, f"{mode} noise capture {i} yielded {len(frames)} frames")
            continue
        check(all(f.data == payloads[i] for f in frames), f"{mode} capture {i} decoded a foreign payload")
        check(len(frames) >= min_frames[i],
              f"{mode} capture {i}: {len(frames)} frames < {min_frames[i]}")
    say(f"[{tag} {mode}] frames per capture min={min(n_frames[:noise_i])} max={max(n_frames)} "
        f"(need >= {min(min_frames[:noise_i])}); +100 Hz {n_frames[1]}, -100 Hz {n_frames[2]}; "
        f"noise capture frames={n_frames[noise_i]} | {card}")
    del batch, raws

    if _SLICES[mode]["wav"]:
        _wav_roundtrip(device, mode, payload_bytes, tag)
    say(f"[{tag} {mode}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def _wav_roundtrip(device, mode: str, payload_bytes: int, tag: str) -> None:
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
            data = (f"{mode} wav file {i} ".encode() * 100) + _payload(900 + i, payload_bytes // 4)
            blob = intelligent_compress(data)
            framed = pack_frame(f"src{i}.bin", blob, 0, 1, len(data), crc32(data))
            path = os.path.join(work, f"src{i}.wav")
            write_wav(path, modulate(mode, framed, BAUD))
            sources.append(data)
            wavs.append(path)
        saved = decode_wav_batch(wavs, mode, BAUD, recv_dir=os.path.join(work, "recv"),
                                 registry=AssemblyRegistry(journal_dir=""), device=device)
        for i, paths in enumerate(saved):
            check(len(paths) == 1, f"{mode} WAV {i}: {len(paths)} files saved")
            with open(paths[0], "rb") as f:
                check(f.read() == sources[i], f"{mode} WAV {i}: saved file differs from its source")
        say(f"[{tag} {mode}] decode_wav_batch: 4 WAVs written by the port, 4 saved files byte-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_timing(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """Times on the bench workload of every slice; returns ({entry: (ms,
    plain_ms)}, {mode: {cfo: Msamples/s}})."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    pattern = MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2
    t, msps = {}, {}
    for mode, spec in _SLICES.items():
        t0 = time.perf_counter()
        n_psk, carrier = spec["n_psk"], spec["carrier"]
        wave = _wave(_payload(0, payload_bytes), "bench.bin", mode)
        one = _rows(_tiled(wave, n)[None], "int16", device, mode)
        x = one.expand(n_cap, -1, -1).contiguous()  # ship once, tile on the card
        del one
        b, r, row = x.shape
        msps[mode] = {}
        for cfo in (True, False):
            ms = _time_ms(lambda: demod_pack_batch(x, mode, BAUD, cfo_retry=cfo))
            msps[mode][cfo] = b * n / (ms * 1e-3) / 1e6
            say(f"[6 time] demod_pack_batch {mode} {b} x {n} int16 rows cfo_retry="
                f"{'on' if cfo else 'off'}: {ms:.3f} ms = {msps[mode][cfo]:.2f} Msamples/s | {card}")
        _, _, found = demod_pack_batch(x, mode, BAUD, cfo_retry=True)
        check(bool(found.all()), f"{mode} bench batch: a capture found no magic")

        _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r,
                                         n_psk=8 if n_psk == 8 else 4)
        W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, x.device)
        rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
        key = f"psk_project_decide_batch@{n_psk}"
        t[key] = (
            _time_ms(lambda: tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)),
            _time_ms(lambda: tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)),
        )
        out = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
        zeros = torch.zeros(b, dtype=torch.int32, device=x.device)
        if mode == "QPSK":
            hi, lo = out
            conds, _ = tk.rotation_match_conditions(pattern)
            first, _ = tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r,
                                               pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            for p in (256, r):
                t[f"rotation_match_batch:qpsk@{p}"] = (
                    _time_ms(lambda: tk.rotation_match_batch(
                        hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)),
                    _time_ms(lambda: tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, p)),
                )
            s = (2 * first[:, 0]).to(torch.int32)
            t["relabel_pack_batch"] = (
                _time_ms(lambda: tk.relabel_pack_batch(hi, lo, s, zeros, rows_per_capture=r)),
                _time_ms(lambda: tk.relabel_pack_batch_plain(hi, lo, s, zeros)),
            )
            del x
            x8 = _rows(_tiled(wave, n)[None], "int8", device, mode).expand(n_cap, -1, -1).contiguous()
            t["psk_project_decide_batch@4 int8"] = (
                _time_ms(lambda: tk.psk_project_decide_batch(x8, W8, best, rot, rows_per_capture=r)),
                _time_ms(lambda: tk.psk_project_decide_batch_plain(x8, W8, best, rot)),
            )
            del x8
        elif mode == "BPSK":
            re, im = out
            conds, _ = tk.bpsk_match_conditions(pattern)
            first, _ = tk.rotation_match_batch(re, im, MAGIC_BIT_PATTERN, r, family="bpsk",
                                               pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            for p in (256, r):
                t[f"rotation_match_batch:bpsk@{p}"] = (
                    _time_ms(lambda: tk.rotation_match_batch(
                        re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2,
                        rows_scanned=p)),
                    _time_ms(lambda: tk.rotation_match_batch_plain(re, im, conds, 16, 3, p)),
                )
            s = first[:, 0].contiguous()
            t["bit_select_pack_batch"] = (
                _time_ms(lambda: tk.bit_select_pack_batch(re, im, s, zeros, rows_per_capture=r)),
                _time_ms(lambda: tk.bit_select_pack_batch_plain(re, im, s, zeros)),
            )
            del x
        else:
            sec = out
            conds, _ = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
            first, found8 = tk.sector_match_batch(sec, MAGIC_BIT_PATTERN, r,
                                                  pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            for p in (256, r):
                t[f"sector_match_batch@{p}"] = (
                    _time_ms(lambda: tk.sector_match_batch(
                        sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)),
                    _time_ms(lambda: tk.sector_match_batch_plain(sec, conds, 3, p)),
                )
            ksel = torch.argmax(found8.to(torch.uint8), dim=1).to(torch.int32)
            r8 = (torch.gather(first, 1, ksel[:, None].long())[:, 0] % 8).to(torch.int32)
            t["psk8_relabel_pack_rows"] = (
                _time_ms(lambda: tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r)),
                _time_ms(lambda: tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)),
            )
            del x
        del out
        torch.cuda.empty_cache()
        say(f"[6 time] {mode}: {time.perf_counter() - t0:.1f} s | {card}")
    for name, (ms, plain) in t.items():
        say(f"[6 time] {name} B={n_cap} R={r}: kernel {ms:.4f} ms, plain {plain:.4f} ms | {card}")
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
        errs = phase_decide(device, n_k1, n, payload_bytes, card)
        phase = "4 match/pack"
        r = blocked_row_shape(n, BAUD, SR)[0]
        errs.update(phase_match_pack(device, r, card))
        counts = {}
        for mode in _SLICES:
            phase = f"5 slice {mode}"
            counts[mode] = phase_slice(device, mode, n_slice, n, payload_bytes, card)
        phase = "6 timing"
        times, _ = phase_timing(device, n_slice, n, payload_bytes, card)
    except Exception as e:  # any failure: report the phase, print no result
        import traceback

        traceback.print_exc()
        say(f"FAIL in phase {phase}: {type(e).__name__}: {e}")
        return 1

    kernels = []
    for entry, (wrapper, mode, src, line) in _ENTRIES.items():
        timed = times.get(entry) or times[f"{entry}@256"]  # the matchers: the 256-row tier
        kernels.append({
            "name": entry, "route": "cuda", "source": f"{_CSRC}/{src}",
            "replaces": f"{_PALLAS}:{line}", "launches": counts[mode][wrapper],
            "max_abs_err": errs[entry], "ms": timed[0], "plain_ms": timed[1],
        })
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s | {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
