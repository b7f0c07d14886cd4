"""The receive slices' kernels: wrappers, plain PyTorch versions, launch counts.

Counterpart of ``audio_modem_radio_tpu/ops/pallas_kernels.py`` for all of
its thirteen kernels (the DBPSK, DQPSK, D8PSK, FSK and NEURAL receive),
with the JAX names and argument order:

* K1 :func:`psk_project_decide_batch` (``csrc/decide.cu``), ``n_psk`` 2, 4, 8,
* K11 :func:`psk_project_diff` and K12 :func:`psk_project_diff_batch`
  (``csrc/project_diff.cu``): the single-capture receiver's and the staged
  batch's float differential streams, float32 or int16 rows,
* K2 :func:`rotation_match_batch` (``csrc/rotmatch.cu``), families "qpsk"
  and "bpsk",
* K3 :func:`relabel_pack_batch` (``csrc/relabel_pack.cu``),
* K4 :func:`bit_select_pack_batch` (``csrc/bit_select_pack.cu``),
* K5 :func:`sector_match_batch` (``csrc/sector_match.cu``),
* K6 :func:`psk8_relabel_pack_rows` (``csrc/psk8_pack.cu``),
* K7 :func:`fsk_tile_bits_batch` and K13 :func:`fsk_project_bits_batch`
  (``csrc/fsk_tile.cu``), without the Pallas ``block_rows`` argument,
* K8 :func:`fsk_disc_sums_batch` (``csrc/fsk_disc.cu``),
* K9 :func:`fsk_quad_margin_batch` (``csrc/fsk_quad.cu``); K8 and K9 take
  the dense (c_pad, 256) FIR matrix only, not the Pallas banded form,
* K10 :func:`neural_extract_batch` (``csrc/neural_extract.cu``; with
  ``bf16`` the tensor-core kernel of ``csrc/neural_extract_tc.cuh``), which
  takes the (256, 16) codebook in place of the Pallas chip table and
  block-diagonal scorer;

and five kernels with no Pallas counterpart: :func:`mlse_viterbi_blocks`
(``csrc/mlse_viterbi.cu``), the Viterbi of the single-capture FSK
receiver's MLSE, which the JAX package runs as two ``lax.scan``s
(``ops/fsk.py:_mlse_refine``), :func:`fec_viterbi_blocks`
(``csrc/fec_viterbi.cu``), the Viterbi decoder of the convolutional code,
two ``lax.scan``s of ``fec.py:_viterbi_block`` there,
:func:`fsk_sync_pack_batch` (``csrc/fsk_sync.cu``), the batched FSK sync
tail, plain XLA there (``ops/common.py`` ``find_bit_pattern`` and
``pack_bits_from``), :func:`fsk_disc_decide_batch`
(``csrc/fsk_eq_bits.cu``), the close-tone FSK decision after K8 (atan2,
the calibrated equalizer, the tone), plain XLA there (``ops/fsk.py``
``fsk_disc_bits_rows_batch``), with its plain version
:func:`fsk_disc_decide_batch_plain`; and :func:`psk_pass1_batch`
(``csrc/psk_pass1.cu``), the batched PSK pass 1 (each capture's timing
offset and common rotation), plain XLA there (``ops/psk.py``
``_batch_pass1``), with its plain version :func:`psk_pass1_batch_plain`.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. For tensors on the CPU it runs the plain version
beside it; for CUDA tensors it launches the hand-written kernel on the
current stream (there is no fallback), checks the launch's error code and
adds one to its ``launches`` attribute, under one lock, so that the
shard threads of a data-parallel mesh count every launch.
"""

from __future__ import annotations

import collections
import functools
import math
import threading
import weakref
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .common import find_bit_pattern, pack_bits_from

_BLOCK_SYM = 128  # symbols per lane row (matches ops.psk)
_BIG = 1 << 30  # "no match" sentinel of the magic matchers
_DECIDE_DTYPES = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
_MATCH_SPAN = 32  # K2's widest window: offsets 0..31 (csrc/rotmatch.cu)
_BYTE_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


_COUNT_LOCK = threading.Lock()
_CACHE_LOCK = threading.Lock()


def _count(fn) -> None:
    """One launch of ``fn``'s kernel."""
    with _COUNT_LOCK:
        fn.launches += 1


# The kernel tables the wrappers derive from a template, by template and tag:
# room for K1/K12's and the four FSK kernels' tables of a process's configurations.
_KEPT: "collections.OrderedDict" = collections.OrderedDict()
_KEPT_SIZE = 16


def _kept(template: torch.Tensor, tag, build):
    """``build()``, computed once for ``template`` and ``tag`` and kept for
    the last 16 of them, so that a call with the template of an earlier one
    launches the kernel alone: the tables' small kernels and host reads run
    at a template's first call only. An entry holds a weak reference to its
    template (the cache never keeps one alive) and is used only while that
    very tensor is alive and its version counter shows no write since."""
    key = (template.data_ptr(), template._version, tuple(template.shape), template.device, tag)
    with _CACHE_LOCK:
        hit = _KEPT.get(key)
        if hit is not None and hit[0]() is template:
            _KEPT.move_to_end(key)
            return hit[1]
    value = build()
    with _CACHE_LOCK:
        _KEPT[key] = (weakref.ref(template), value)
        while len(_KEPT) > _KEPT_SIZE:
            _KEPT.popitem(last=False)
    return value


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _same_device(*ts: torch.Tensor) -> torch.device:
    # The messages are built only on failure: the wrappers' checks run on
    # every call, and the matchers' calls take tens of microseconds.
    dev = ts[0].device
    if not all(t.device == dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}")
    _require(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev


def _raw_stream(dev: torch.device) -> int:
    """``dev``'s current stream as a ``cudaStream_t`` integer (what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building
    a Stream object: the wrappers run this on every call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _launch(name: str, dev: torch.device, *args, stream: int = None) -> None:
    """Call C entry point ``name`` on ``dev``'s current stream (``stream``,
    where the caller has it already), with ``dev`` the current device; raise
    on a nonzero cudaError_t (a refused launch never runs and a later
    synchronize would not report it)."""
    lib = _build.load_library()
    stream = _raw_stream(dev) if stream is None else stream
    if torch.cuda.current_device() == dev.index:
        err = getattr(lib, name)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _require_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels that read 16-byte chunks take tensors that start on a
    16-byte boundary; a view that does not is refused."""
    _require(t.data_ptr() % 16 == 0,
             f"{name}: the kernel reads 16-byte chunks, so the tensor must start on a 16-byte boundary "
             f"(this view starts {t.data_ptr() % 16} bytes past one)")


def _ptr(t: torch.Tensor) -> int:
    _require(t.is_contiguous(), "kernel operands must be contiguous")
    return t.data_ptr()


def _check_lanes(name: str, lanes, rows_per_capture: int, block_rows: int) -> Tuple[int, int]:
    """(B, R) of equal-shaped (B, R, 128) uint8 lane tensors; raises on
    anything else."""
    shape = lanes[0].shape
    if not (lanes[0].ndim == 3 and all(t.shape == shape for t in lanes)):
        raise ValueError(f"{name}: lanes {[tuple(t.shape) for t in lanes]}")
    b, r, w = shape
    if not (w == _BLOCK_SYM and r == rows_per_capture and r % block_rows == 0):
        raise ValueError(f"{name}: bad shapes {tuple(shape)} for rows_per_capture={rows_per_capture}")
    if not all(t.dtype == torch.uint8 for t in lanes):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in lanes]}")
    _require(b <= 65535, f"{name}: {b} captures exceed the kernel grid")
    return b, r


def _check_per_capture(name: str, b: int, *ts: torch.Tensor) -> None:
    _require(all(t.dtype == torch.int32 and tuple(t.shape) == (b,) for t in ts),
             f"{name}: per-capture scalars {[(t.dtype, tuple(t.shape)) for t in ts]}, want int32 ({b},)")


def _pack_bits_from(bits: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(B, n) uint8 0/1 bits -> (B, n // 8) bytes: byte c is bits
    ``8c + shift .. 8c + shift + 7`` MSB first, zeros past the end."""
    b, n = bits.shape
    padded = F.pad(bits, (0, 32))  # shifts are below 24 (K6: 3 * 7)
    idx = shift.to(torch.int64)[:, None] + torch.arange(n // 8 * 8, device=bits.device)
    shifted = torch.gather(padded, 1, idx).reshape(b, -1, 8).to(torch.int32)
    weights = torch.tensor(_BYTE_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (shifted * weights).sum(dim=2).to(torch.uint8)


def _first_match_plain(planes, conds, tol: int, n: int) -> torch.Tensor:
    """The matchers' plain sweep. ``planes`` are (B, n + max_off) uint8 0/1
    streams (zeros past the scanned prefix); ``conds[h]`` is a tuple of
    (plane, offset, bit, exact). A position matches hypothesis h when every
    exact condition holds and at most ``tol`` others miss. Returns (B, n_hyp)
    int32 first positions, 2^30 where none matched."""
    b = planes[0].shape[0]
    dev = planes[0].device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    firsts = []
    for c in conds:
        acc1 = torch.zeros((b, n), dtype=torch.uint8, device=dev)
        acc2 = torch.zeros_like(acc1)
        for plane, off, bit, exact in c:
            miss = planes[plane][:, off : off + n] ^ bit
            if exact:
                acc1 += miss
            else:
                acc2 += miss
        good = (acc1 == 0) & (acc2 <= tol)
        firsts.append(torch.where(good, pos, _BIG).amin(dim=1))
    return torch.stack(firsts, dim=1).to(torch.int32)


# --- K1: projection + differential + derotation + decision --------------------

_TAN_PI_8 = math.tan(math.pi / 8)  # rounds to 0.41421356f, csrc/decide.cu's constant


def psk8_sector_stream(d_re: torch.Tensor, d_im: torch.Tensor) -> torch.Tensor:
    """Differential phasor -> nearest k·π/4 sector (uint8 0..7), compares
    only: an axis sector when one component dominates by more than
    tan(67.5°), a diagonal sector otherwise (``ops/psk.py`` of the JAX
    package, :1306)."""
    ax, bx = torch.abs(d_re), torch.abs(d_im)
    diag = (bx > _TAN_PI_8 * ax) & (ax > _TAN_PI_8 * bx)
    k_axis = torch.where(ax >= bx, torch.where(d_re >= 0, 0, 4), torch.where(d_im >= 0, 2, 6))
    k_diag = torch.where(d_im >= 0, torch.where(d_re >= 0, 1, 3), torch.where(d_re >= 0, 7, 5))
    return torch.where(diag, k_diag, k_axis).to(torch.uint8)


def _decide(dr: torch.Tensor, di: torch.Tensor, n_psk: int):
    """Derotated differential -> uint8 decisions: Gray (hi, lo) for 4, the
    sign bits of (re, im) for 2, the π/4 sector for 8."""
    if n_psk == 8:
        return psk8_sector_stream(dr, di)
    if n_psk == 2:
        return (dr < 0).to(torch.uint8), (di < 0).to(torch.uint8)
    swap = torch.abs(di) > torch.abs(dr)
    neg = torch.where(swap, di, dr) < 0
    return neg.to(torch.uint8), (neg ^ swap).to(torch.uint8)


def psk_project_diff_batch_plain(
    x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K12: the dense blocked projection of ``ops/psk.py
    _blocked_project_xla`` (the next-row overlap of each capture's last row
    is zero) and the differential with the successor symbol (zero past the
    capture's end). Returns (d_re, d_im), each (B, R*128) float32."""
    b, r, row = x3d.shape
    ov = w_all.shape[1] - row
    x = x3d.to(torch.float32)
    x_next = torch.cat([x[:, 1:, :ov], x.new_zeros((b, 1, ov))], dim=1)
    xov = torch.cat([x, x_next], dim=2)  # (B, r, row+ov)
    out = torch.bmm(xov, w_all[best.long()])  # (B, r, 256)
    re = out[:, :, :_BLOCK_SYM].reshape(b, -1)
    im = out[:, :, _BLOCK_SYM:].reshape(b, -1)
    re1 = torch.cat([re[:, 1:], re.new_zeros((b, 1))], dim=1)
    im1 = torch.cat([im[:, 1:], im.new_zeros((b, 1))], dim=1)
    return re1 * re + im1 * im, im1 * re - re1 * im


def psk_project_diff_plain(x2d: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K11: :func:`psk_project_diff_batch_plain` for one capture of
    (R, ROW) rows and its one (ROW+OV, 256) template. Returns (d_re, d_im),
    each (R, 128)."""
    zero = torch.zeros(1, dtype=torch.int32, device=x2d.device)
    d_re, d_im = psk_project_diff_batch_plain(x2d[None], w[None], zero)
    return d_re.reshape(-1, _BLOCK_SYM), d_im.reshape(-1, _BLOCK_SYM)


def psk_project_decide_batch_plain(
    x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor, rot: torch.Tensor,
    n_psk: int = 4,
):
    """Plain K1: plain K12's projection and differential, derotation by
    (cos θ, sin θ) and the decision."""
    b, r, _ = x3d.shape
    d_re, d_im = psk_project_diff_batch_plain(x3d, w_all, best)
    c, s = rot[:, 0:1], rot[:, 1:2]
    dr = d_re * c + d_im * s
    di = d_im * c - d_re * s
    out = _decide(dr, di, n_psk)
    if n_psk == 8:
        return out.reshape(b, r, _BLOCK_SYM)
    return tuple(o.reshape(b, r, _BLOCK_SYM) for o in out)


# K1's template width per body: the succ templates add successor columns.
_DECIDE_WIDTHS = {"roll": 2 * _BLOCK_SYM, "succ": 4 * _BLOCK_SYM}


def psk_project_decide_batch(
    x3d: torch.Tensor,
    w_all: torch.Tensor,
    best: torch.Tensor,
    rot: torch.Tensor,
    rows_per_capture: int,
    n_psk: int = 4,
    block_rows: int = 256,
    variant: str = "roll",
):
    """Whole-batch projection + differential + derotation + decision.

    Args:
      x3d: (B, R, 128*spsym) float32, int16 or int8 sample rows.
      w_all: (n_offsets, 128*spsym + OV, 256) float32 blocked templates
        (``ops.psk._blocked_templates``) for ``variant="roll"``, or the
        (n_offsets, 128*spsym + OV, 512) successor-column templates
        (``ops.psk._blocked_templates_succ``) for ``variant="succ"``, whose
        first 256 columns are the former. The kernel reads only the
        (2*spsym, 2) dual basis each offset's block-diagonal repeats.
      best: (B,) int32 winning timing offset per capture.
      rot: (B, 2) float32 per-capture (cos θ, sin θ).
      n_psk: 4 (Gray dibits), 2 (sign bits of re, im) or 8 (π/4 sectors).
      variant: the JAX package's two Pallas bodies, "roll" and "succ",
        whose decisions it documents as bitwise identical (``_project_diff_body_succ``,
        pallas_kernels.py:266-268); they differ only in TPU layout work, so
        both run the one kernel, ``csrc/decide.cu``, on the dual basis.
    Returns uint8 (hi, lo) of shape (B, R, 128) for ``n_psk`` 2 and 4, or one
    uint8 (B, R, 128) sector array for 8; entries past the modulated span
    are garbage by contract. On the card ``x3d`` must start on a 16-byte
    boundary (the kernel stages 16-byte chunks); a view that does not is
    refused.
    """
    _require(x3d.ndim == 3, f"x3d must be (B, R, row), got {tuple(x3d.shape)}")
    b, r, row = x3d.shape
    _require(r == rows_per_capture and r % block_rows == 0 and r % 2 == 0,
             f"rows {r} vs rows_per_capture={rows_per_capture}, block_rows={block_rows}")
    _require(n_psk in (2, 4, 8), f"n_psk={n_psk}: the decision exists for 2, 4 and 8 phases")
    _require(variant in _DECIDE_WIDTHS, f"variant={variant!r}: the decide body is one of {sorted(_DECIDE_WIDTHS)}")
    spsym = row // _BLOCK_SYM
    _require(row % _BLOCK_SYM == 0 and 1 <= spsym <= 32, f"row width {row}")
    _require(x3d.dtype in _DECIDE_DTYPES, f"x3d dtype {x3d.dtype}")
    _require(w_all.dtype == torch.float32 and w_all.ndim == 3 and w_all.shape[1] >= row + 2 * spsym,
             f"w_all {w_all.dtype} {tuple(w_all.shape)}")
    _require(w_all.shape[2] == _DECIDE_WIDTHS[variant],
             f"template width {w_all.shape[2]} does not match variant {variant!r}")
    _require(best.dtype == torch.int32 and tuple(best.shape) == (b,), f"best {best.dtype} {tuple(best.shape)}")
    _require(rot.dtype == torch.float32 and tuple(rot.shape) == (b, 2), f"rot {rot.dtype} {tuple(rot.shape)}")
    dev = _same_device(x3d, w_all, best, rot)
    if dev.type == "cpu":
        return psk_project_decide_batch_plain(x3d, w_all[:, :, : 2 * _BLOCK_SYM], best, rot, n_psk)

    _require_aligned("psk_project_decide_batch", x3d)
    tmpl = _kept(w_all, ("dual_basis", spsym), lambda: _dual_basis(w_all, spsym))
    hi = torch.empty((b, r, _BLOCK_SYM), dtype=torch.uint8, device=dev)
    lo = None if n_psk == 8 else torch.empty_like(hi)
    _launch("amr_decide", dev, _ptr(x3d), _DECIDE_DTYPES[x3d.dtype], n_psk, _ptr(tmpl),
            _ptr(best), _ptr(rot), _ptr(hi), None if lo is None else _ptr(lo), b, r, spsym)
    _count(psk_project_decide_batch)
    return hi if n_psk == 8 else (hi, lo)


# --- K11 and K12: projection + differential, float streams ---------------------

_DIFF_DTYPES = {torch.float32: 0, torch.int16: 1}


def _dual_basis(w_all: torch.Tensor, spsym: int) -> torch.Tensor:
    """(n_offsets, 2*spsym, 2) dual-basis columns that each block-diagonal
    (ROW+OV, 256) template repeats: symbol 0's re and im columns."""
    return torch.stack([w_all[:, : 2 * spsym, 0], w_all[:, : 2 * spsym, _BLOCK_SYM]], dim=-1).contiguous()


def _check_diff(name: str, x: torch.Tensor, w_all: torch.Tensor, block_rows: int) -> int:
    """spsym of (..., R, ROW) rows against (n, ROW+OV, 256) templates."""
    r, row = x.shape[-2:]
    spsym = row // _BLOCK_SYM
    _require(r % block_rows == 0 and r % 2 == 0, f"{name}: rows {r} vs block_rows={block_rows}")
    _require(row % _BLOCK_SYM == 0 and 1 <= spsym <= 32, f"{name}: row width {row}")
    _require(x.dtype in _DIFF_DTYPES, f"{name}: x dtype {x.dtype}")
    _require(w_all.dtype == torch.float32 and w_all.ndim == 3 and row >= w_all.shape[1] - row >= 2 * spsym
             and w_all.shape[2] == 2 * _BLOCK_SYM, f"{name}: template {w_all.dtype} {tuple(w_all.shape)}")
    return spsym


def psk_project_diff_batch(
    x3d: torch.Tensor,
    w_all: torch.Tensor,
    best: torch.Tensor,
    rows_per_capture: int,
    block_rows: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch projection + differential: float32 (d_re, d_im), each
    (B, R, 128).

    Args:
      x3d: (B, R, 128*spsym) float32 or int16 sample rows (integers cast
        unscaled), R a multiple of ``block_rows``.
      w_all: (n_offsets, 128*spsym + OV, 256) float32 blocked templates; the
        kernel reads the (2*spsym, 2) dual basis each one repeats.
      best: (B,) int32 winning timing offset per capture.
    Each capture's last entry is 0 (no successor); samples past a capture's
    end read as zero, where the Pallas kernel's lookahead reads the next
    capture's head (garbage by its contract). On the card ``x3d`` must
    start on a 16-byte boundary, and the dual basis is kept per template
    as K1's is (:func:`_kept`).
    """
    _require(x3d.ndim == 3 and x3d.shape[1] == rows_per_capture,
             f"x3d {tuple(x3d.shape)} vs rows_per_capture={rows_per_capture}")
    spsym = _check_diff("psk_project_diff_batch", x3d, w_all, block_rows)
    b, r, _ = x3d.shape
    _check_best("psk_project_diff_batch", best, b, w_all.shape[0])
    dev = _same_device(x3d, w_all, best)
    if dev.type == "cpu":
        d_re, d_im = psk_project_diff_batch_plain(x3d, w_all, best)
        return d_re.reshape(b, r, _BLOCK_SYM), d_im.reshape(b, r, _BLOCK_SYM)
    _require_aligned("psk_project_diff_batch", x3d)
    d_re = torch.empty((b, r, _BLOCK_SYM), dtype=torch.float32, device=dev)
    d_im = torch.empty_like(d_re)
    tmpl = _kept(w_all, ("dual_basis", spsym), lambda: _dual_basis(w_all, spsym))
    _launch("amr_project_diff_batch", dev, _ptr(x3d), _DIFF_DTYPES[x3d.dtype], _ptr(tmpl),
            _ptr(best), _ptr(d_re), _ptr(d_im), b, r, spsym)
    _count(psk_project_diff_batch)
    return d_re, d_im


def psk_project_diff(
    x2d: torch.Tensor, w: torch.Tensor, block_rows: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capture's projection + differential: (R, 128*spsym) float32 or
    int16 rows, R a multiple of ``block_rows``, and the winning offset's
    (128*spsym + OV, 256) template -> (d_re, d_im), each (R, 128) float32.
    Samples past the last row read as zero, as the Pallas kernel's appended
    zero rows; the last entry is 0 (no successor). On the card ``x2d``
    must start on a 16-byte boundary."""
    _require(x2d.ndim == 2 and w.ndim == 2, f"x2d {tuple(x2d.shape)}, w {tuple(w.shape)}")
    _require(block_rows % 8 == 0, f"block_rows={block_rows} must be a multiple of 8")
    spsym = _check_diff("psk_project_diff", x2d, w[None], block_rows)
    r = x2d.shape[0]
    dev = _same_device(x2d, w)
    if dev.type == "cpu":
        return psk_project_diff_plain(x2d, w)
    _require_aligned("psk_project_diff", x2d)
    d_re = torch.empty((r, _BLOCK_SYM), dtype=torch.float32, device=dev)
    d_im = torch.empty_like(d_re)
    _launch("amr_project_diff", dev, _ptr(x2d), _DIFF_DTYPES[x2d.dtype], _ptr(_dual_basis(w[None], spsym)),
            _ptr(d_re), _ptr(d_im), r, spsym)
    _count(psk_project_diff)
    return d_re, d_im


# --- PSK pass 1: timing offset and common rotation (no Pallas counterpart) ---------

_PASS1_MAX_OFFSETS = 16  # csrc/psk_pass1.cu's kMaxOffsets


def pass1_windows(r0: int, n_rows: int) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """Pass 1's scored rows of a capture with ``r0`` rows of signal stored as
    ``n_rows`` rows: ``(wr, ((start, head), ...))``, one to three windows of
    ``wr = min(64, r0)`` rows at the capture's start, middle and end (equal
    starts once). Window row j reads row ``start + j`` and the first OV
    samples of row ``head + j``: the next row, its start clamped at the
    array's edge as JAX's ``dynamic_slice`` clamps it (the last window's
    heads then shift by one row)."""
    wr = min(64, r0) if r0 >= 1 else 1
    starts = sorted({0, max(0, r0 // 2 - wr // 2), max(0, r0 - wr)})
    return wr, tuple(
        (s, min(max(min(s + 1, r0 - wr + 1 if r0 >= wr else 0), 0), n_rows - wr)) for s in starts)


def _pass1_basis(w_all: torch.Tensor, spsym: int) -> torch.Tensor:
    """(n_offsets, 2*spsym, 2) dual-basis columns that the side-by-side
    (ROW+OV, n_offsets*256) pass-1 matrix repeats: each offset's symbol 0
    re and im columns."""
    k = w_all.shape[1] // (2 * _BLOCK_SYM)
    cols = w_all[: 2 * spsym].reshape(2 * spsym, k, 2, _BLOCK_SYM)[:, :, :, 0]
    return cols.permute(1, 0, 2).contiguous()


def _check_pass1(name: str, x3d: torch.Tensor, r0: int, w_all: torch.Tensor, grams: torch.Tensor) -> int:
    """spsym of pass 1's operands; raises on what neither version takes."""
    _require(x3d.ndim == 3, f"{name}: x3d must be (B, R, row), got {tuple(x3d.shape)}")
    b, n_rows, row = x3d.shape
    spsym = row // _BLOCK_SYM
    _require(row % _BLOCK_SYM == 0 and 1 <= spsym <= 32, f"{name}: row width {row}")
    _require(x3d.dtype in _DECIDE_DTYPES, f"{name}: x3d dtype {x3d.dtype}")
    _require(1 <= r0 <= n_rows, f"{name}: r0={r0} of {n_rows} rows")
    _require(w_all.dtype == torch.float32 and w_all.ndim == 2 and w_all.shape[0] >= row + 2 * spsym
             and w_all.shape[1] % (2 * _BLOCK_SYM) == 0 and w_all.shape[1] > 0,
             f"{name}: w_all {w_all.dtype} {tuple(w_all.shape)}, want float32 (row+ov, n_offsets*256)")
    k = w_all.shape[1] // (2 * _BLOCK_SYM)
    _require(grams.dtype == torch.float32 and tuple(grams.shape) == (k, 3),
             f"{name}: grams {grams.dtype} {tuple(grams.shape)}, want float32 ({k}, 3)")
    return spsym


def psk_pass1_batch_plain(x3d: torch.Tensor, r0: int, w_all: torch.Tensor, grams: torch.Tensor,
                          n_psk: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass 1: :func:`pass1_windows`' rows cut and cast, scaled by the
    capture's largest |x|, one dense product with the side-by-side
    templates, the Gram scale, the in-row differentials, the coherence score
    at the power that cancels the data, its argmax and the rotation from the
    winning offset's differentials. Returns ``(best, theta)``, (B,) int32
    and (B,) float32."""
    # ops/psk.py imports this module, so its helpers are imported here.
    from .psk import _coherence_score, _gram_scale, estimate_common_rotation, estimate_common_rotation8

    b, n_rows, row = x3d.shape
    c = w_all.shape[0]
    ov = c - row
    n_offsets = w_all.shape[1] // (2 * _BLOCK_SYM)
    # Slice the windows first, then build their overlap tails.
    wr, windows = pass1_windows(r0, n_rows)
    wins = [torch.cat([x3d[:, s : s + wr], x3d[:, n0 : n0 + wr, :ov]], dim=2) for s, n0 in windows]
    wins = torch.cat(wins, dim=1).to(torch.float32)  # (B, nw, row+ov); int rows cast here
    # Normalize per capture: the 4th-power estimate raises phasors (~scale²)
    # to the 4th, so int16-scaled input (x32768) would overflow float32.
    wscale = torch.clamp_min(torch.amax(torch.abs(wins), dim=(1, 2), keepdim=True), 1e-12)
    wins = wins / wscale
    proj = torch.matmul(wins.reshape(b, -1, c), w_all)  # (B, nw, K*256)
    proj = proj.reshape(b, -1, n_offsets, 2, _BLOCK_SYM)
    re, im = proj[:, :, :, 0], proj[:, :, :, 1]  # (B, nw, K, 128)
    re, im = _gram_scale(re, im, grams, offset_axis=2)
    # In-row differentials (127 per row) are plenty for scoring.
    dr = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    di = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    score = _coherence_score(dr, di, (1, 3), n_psk)  # (B, K)
    best = torch.argmax(score, dim=1).to(torch.int32)

    idx = best.long()[:, None, None, None].expand(-1, dr.shape[1], 1, dr.shape[3])
    dr_b = torch.gather(dr, 2, idx)[:, :, 0]  # (B, nw, 127)
    di_b = torch.gather(di, 2, idx)[:, :, 0]
    est = estimate_common_rotation8 if n_psk == 8 else estimate_common_rotation
    theta = est(dr_b.reshape(b, -1), di_b.reshape(b, -1))
    return best, theta


def psk_pass1_batch(x3d: torch.Tensor, r0: int, w_all: torch.Tensor, grams: torch.Tensor,
                    n_psk: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched PSK pass 1: each capture's timing offset and common rotation.

    Args:
      x3d: (B, R, 128*spsym) float32, int16 or int8 sample rows.
      r0: the rows that hold signal (R for pre-shaped rows, fewer where
        flat captures were padded to whole blocks); :func:`pass1_windows`
        picks the scored rows from it.
      w_all: (128*spsym + OV, n_offsets*256) float32, the offsets'
        block-diagonal templates side by side (``ops.psk._device_tables``);
        the kernel reads the (2*spsym, 2) dual basis each one repeats.
      grams: (n_offsets, 3) float32 Gram entries (gxx, gxy, gyy).
      n_psk: 8 scores and estimates at the 8th power, anything else at the
        4th (DBPSK and DQPSK).
    Returns ``(best, theta)``: (B,) int32 winning offset and (B,) float32
    rotation, as :func:`psk_pass1_batch_plain` computes them; on the card
    ``csrc/psk_pass1.cu`` sums in another order, so a score or θ may differ
    in its last bits. On the CPU the plain chain. On the card ``x3d`` must
    start on a 16-byte boundary.
    """
    name = "psk_pass1_batch"
    spsym = _check_pass1(name, x3d, r0, w_all, grams)
    dev = _same_device(x3d, w_all, grams)
    if dev.type == "cpu":
        return psk_pass1_batch_plain(x3d, r0, w_all, grams, n_psk)
    b, n_rows, row = x3d.shape
    n_offsets = grams.shape[0]
    _require(1 <= b <= _MAX_CAPTURES and n_offsets <= _PASS1_MAX_OFFSETS,
             f"{name}: {b} captures, {n_offsets} offsets; the kernel takes 1 to {_MAX_CAPTURES} "
             f"and at most {_PASS1_MAX_OFFSETS}")
    _require(grams.is_contiguous(), f"{name}: grams must be contiguous")
    _require((w_all.shape[0] - row) % 16 == 0, f"{name}: the kernel reads the heads in 16-byte chunks, "
             f"so OV ({w_all.shape[0] - row} samples) must be a multiple of 16")
    _require_aligned(name, x3d)
    wr, windows = pass1_windows(r0, n_rows)
    nw = wr * len(windows)
    win = np.zeros(8, np.int32)
    win[:2] = wr, len(windows)
    win[2 : 2 + 2 * len(windows)] = np.asarray(windows, np.int32).reshape(-1)
    tmpl = _kept(w_all, ("pass1_basis", spsym), lambda: _pass1_basis(w_all, spsym))
    rowmax = torch.empty((b, nw), dtype=torch.float32, device=dev)
    part = torch.empty((b, nw, n_offsets, 2), dtype=torch.float32, device=dev)
    best = torch.empty(b, dtype=torch.int32, device=dev)
    theta = torch.empty(b, dtype=torch.float32, device=dev)
    _launch("amr_psk_pass1", dev, _ptr(x3d), _DECIDE_DTYPES[x3d.dtype], 8 if n_psk == 8 else 4, _ptr(tmpl),
            _ptr(grams), n_offsets, b, n_rows, spsym, w_all.shape[0] - row, win.ctypes.data, _ptr(rowmax),
            _ptr(part), _ptr(best), _ptr(theta))
    _count(psk_pass1_batch)
    return best, theta


# --- K2: rotation x parity (QPSK) or stream x inversion (BPSK) magic match -------

# The matchers' (K2's and K5's) launch state per (device, stream): a scratch
# row of 8 minima for each block and one ticket per capture, zero between
# calls (the kernel's last block of a capture resets its ticket). Sized for
# the most captures a call takes, so a call allocates nothing; calls on one
# stream run one after another, so K2 and K5 share it.
_MATCH_STATE: dict = {}
_MAX_CAPTURES = 65535


def _match_state(dev: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    with _CACHE_LOCK:
        state = _MATCH_STATE.get(key)
        if state is None:
            scratch = torch.empty((_MAX_CAPTURES, 8), dtype=torch.int32, device=dev)
            ticket = torch.zeros(_MAX_CAPTURES, dtype=torch.int32, device=dev)
            state = _MATCH_STATE[key] = (scratch, ticket)
    return state


@functools.lru_cache(maxsize=16)
def rotation_match_conditions(pattern: str):
    """All 8 (rotation x bit-parity) magic hypotheses as uniform conditions.

    Under a residual CFO rotation k·π/2 the received Gray dibit relabels as
    (hi', lo') = k=0:(hi,lo) k=1:(~lo,hi) k=2:(~hi,~lo) k=3:(lo,~hi); matching
    the pattern in the relabeled stream at even/odd bit offsets therefore
    reduces, for every hypothesis, to an AND of 16 conditions of the single
    form ``(hi|lo)[t+offset] == bit``. Returns ``cond[h] = tuple of
    (is_hi, offset, bitval)`` for h = 4*parity + k, plus the max offset.
    Built once per pattern (the tuples are immutable), so a matcher call
    pays one cache lookup.
    """
    p = [1 if c == "1" else 0 for c in pattern]
    n_dib = len(p) // 2
    # (hi'==b, lo'==b) translated to conditions on the raw streams, per k.
    def tr(k, is_hi_prime, b):
        if k == 0:
            return (is_hi_prime, b)
        if k == 1:  # hi' = ~lo, lo' = hi
            return (not is_hi_prime, 1 - b) if is_hi_prime else (True, b)
        if k == 2:  # hi' = ~hi, lo' = ~lo
            return (is_hi_prime, 1 - b)
        return (not is_hi_prime, b) if is_hi_prime else (True, 1 - b)  # k=3

    conds = []
    for parity in (0, 1):
        for k in range(4):
            c = []
            for t in range(n_dib):
                if parity == 0:  # even: (hi'_t, lo'_t) == (p_2t, p_2t+1)
                    sh, bh = tr(k, True, p[2 * t])
                    sl, bl = tr(k, False, p[2 * t + 1])
                    c.append((sh, t, bh))
                    c.append((sl, t, bl))
                else:  # odd: (lo'_t, hi'_{t+1}) == (p_2t, p_2t+1)
                    sl, bl = tr(k, False, p[2 * t])
                    sh, bh = tr(k, True, p[2 * t + 1])
                    c.append((sl, t, bl))
                    c.append((sh, t + 1, bh))
            conds.append(tuple(c))
    return tuple(conds), n_dib


@functools.lru_cache(maxsize=16)
def bpsk_match_conditions(pattern: str):
    """The 4 DBPSK magic hypotheses as uniform (is_hi, offset, bitval) conds.

    A k·π/2 differential rotation maps the BPSK decision streams as: k=0 the
    real-axis bits, k=2 their complement, k=1/3 the imag-axis bits and their
    complement. Matching order mirrors ops.common.bit_sync_and_pack_rotations:
    h = [re+pat, im+pat, re+inv, im+inv]; positions are BIT indices in the
    matched stream (``hi``/``lo`` here are the re/im bit streams).
    """
    p = [1 if c == "1" else 0 for c in pattern]
    conds = []
    for inv in (0, 1):
        for is_hi in (True, False):
            conds.append(tuple((is_hi, t, p[t] ^ inv) for t in range(len(p))))
    return tuple(conds), len(p)


_MATCH_FAMILIES = {"qpsk": rotation_match_conditions, "bpsk": bpsk_match_conditions}


@functools.lru_cache(maxsize=16)
def _rotation_mask_table(family: str, pattern: str, pattern2: str) -> np.ndarray:
    """(n_hyp, 6) int32 host table of K2's condition sets (uint32 bit
    patterns): per hypothesis [exact mask, exact value] over W0, then
    [tolerant mask, tolerant value] over W0 and over W1. The kernel
    interleaves hi and lo into one stream, hi[pos + off] at bit 2*off and
    lo[pos + off] at bit 2*off + 1, and W0, W1 are its 32-bit words over
    offsets 0..15 and 16..31. The exact part (the first ``len(pattern)``
    conditions) must lie in W0. Built once per key; K2 takes it as a
    kernel parameter."""
    conds, _ = _MATCH_FAMILIES[family](pattern + pattern2)
    rows = []
    for c in conds:
        m = [0] * 6
        _require(len({(is_hi, off) for is_hi, off, _b in c}) == len(c), "a condition set repeats a (stream, offset)")
        for idx, (is_hi, off, bit) in enumerate(c):
            _require(0 <= off < _MATCH_SPAN, f"condition offset {off} outside the {_MATCH_SPAN}-entry window")
            j = 2 * off + (0 if is_hi else 1)
            exact = idx < len(pattern)
            _require(not exact or j < 32, f"exact condition at offset {off} outside the first word")
            base = 0 if exact else (2 if j < 32 else 4)
            m[base] |= 1 << j % 32
            m[base + 1] |= bit << j % 32
        rows.append(m)
    table = np.array(rows, dtype=np.uint32).view(np.int32)
    table.flags.writeable = False
    return table


def rotation_match_batch_plain(
    hi: torch.Tensor, lo: torch.Tensor, conds, n_exact: int, tol: int, rows_scanned: int
) -> torch.Tensor:
    """Plain K2: the vectorised condition sweep over the first
    ``rows_scanned`` rows (zeros past them). Returns (B, n_hyp) int32 first
    positions, 2^30 where none matched (before the limit epilogue)."""
    b = hi.shape[0]
    n = rows_scanned * _BLOCK_SYM
    max_off = max(off for c in conds for (_s, off, _b) in c)
    planes = [F.pad(x[:, :rows_scanned].reshape(b, n), (0, max_off)) for x in (hi, lo)]
    conds4 = [tuple((0 if is_hi else 1, off, bit, idx < n_exact)
                    for idx, (is_hi, off, bit) in enumerate(c)) for c in conds]
    return _first_match_plain(planes, conds4, tol, n)


def rotation_match_batch(
    hi: torch.Tensor,
    lo: torch.Tensor,
    pattern: str,
    rows_per_capture: int,
    block_rows: int = 256,
    family: str = "qpsk",
    pattern2: str = "",
    tol: int = 3,
    rows_scanned: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R, 128) uint8 streams -> per-capture (first_pos, found) for every
    magic hypothesis: shape (B, 8) for ``family="qpsk"`` (rotation x parity,
    positions in dibits) or (B, 4) for ``family="bpsk"`` (re/im x inverted,
    positions in bits; ``hi``/``lo`` are the re/im bit streams).

    ``rows_scanned`` (default R) limits the scan to each capture's first
    rows without a copy; the end-of-scan limit follows it exactly as the JAX
    call with ``rows_per_capture=rows_scanned`` does. On the card a call is
    one launch that writes both outputs (no host read); ``hi`` and ``lo``
    must start on a 16-byte boundary.
    """
    if family not in _MATCH_FAMILIES:
        raise NotImplementedError(f"family={family!r}: the matcher has {sorted(_MATCH_FAMILIES)}")
    b, r = _check_lanes("rotation_match_batch", (hi, lo), rows_per_capture, block_rows)
    p = r if rows_scanned is None else int(rows_scanned)
    _require(0 < p <= r and p % block_rows == 0, f"rows_scanned={p} for R={r}")
    conds, n_pat = _MATCH_FAMILIES[family](pattern + pattern2)
    dev = _same_device(hi, lo)
    if dev.type == "cpu":
        first = rotation_match_batch_plain(hi, lo, conds, len(pattern), tol, p)
        # Windows starting in the last n_pat+1 entries of the scan can reach
        # past it; the matcher accepts only L = m - (n_pat+1) positions.
        found = (first < _BIG) & (first < p * _BLOCK_SYM - (n_pat + 1))
        return torch.where(found, first, 0), found
    _require_aligned("rotation_match_batch", hi)
    _require_aligned("rotation_match_batch", lo)
    table_ptr = _rotation_mask_table(family, pattern, pattern2).ctypes.data
    stream = _raw_stream(dev)
    scratch, ticket = _match_state(dev, stream)
    first = torch.empty((b, len(conds)), dtype=torch.int32, device=dev)
    found = torch.empty((b, len(conds)), dtype=torch.bool, device=dev)
    _launch("amr_rotation_first", dev, _ptr(hi), _ptr(lo), table_ptr, len(conds), tol, n_pat, _ptr(first),
            _ptr(found), _ptr(scratch), scratch.shape[0], _ptr(ticket), b, r, p, stream=stream)
    _count(rotation_match_batch)
    return first, found


# --- K3: inverse-Gray relabel + mod-8 alignment + byte pack ---------------------

# The sync tails' pack generation, the JAX package's default there; the pack
# functions' own default is "shift", as in the JAX package.
PACK_KERNEL_VARIANT = "weights"
_PACK_VARIANTS = ("shift", "weights")


def relabel_pack_batch_plain(
    hi3: torch.Tensor, lo3: torch.Tensor, s: torch.Tensor, ksel: torch.Tensor
) -> torch.Tensor:
    """Plain K3 in integer ops: relabel each dibit by ``ksel``, interleave
    (rh, rl) into the flat bit stream, shift it by ``s & 7`` bits (zeros
    past the capture's end) and pack MSB-first."""
    b = hi3.shape[0]
    h = hi3.reshape(b, -1).to(torch.int32)
    l = lo3.reshape(b, -1).to(torch.int32)
    s2 = (2 * h + (h ^ l) + 4 - ksel.to(torch.int32)[:, None]) & 3
    rh = s2 >= 2
    rl = (s2 == 1) | (s2 == 2)
    bits = torch.stack([rh, rl], dim=2).reshape(b, -1).to(torch.uint8)
    return _pack_bits_from(bits, s & 7)


def relabel_pack_batch(
    hi3: torch.Tensor,
    lo3: torch.Tensor,
    s: torch.Tensor,
    ksel: torch.Tensor,
    rows_per_capture: int,
    block_rows: int = 256,
    variant: str = "shift",
) -> torch.Tensor:
    """Whole-batch rotation relabel + byte pack: (B, R, 128) uint8 lanes ->
    (B, R*32) uint8. The stream is aligned only mod 8 bits: the frame starts
    at byte ``s // 8``, which the frame parser's magic scan absorbs. The last
    byte of each capture is garbage by contract. On the card ``hi3`` and
    ``lo3`` must start on a 16-byte boundary.

    ``variant`` names the JAX package's two Pallas generations, "shift"
    (its default here) and "weights" (``PACK_KERNEL_VARIANT``, the sync
    tails'), whose bytes it documents as bitwise equal
    (pallas_kernels.py:1313-1318). They differ only in TPU layout work:
    ``csrc/relabel_pack.cu`` shifts in registers, the "shift" generation's
    own idea, so both run it."""
    _require(variant in _PACK_VARIANTS, f"variant={variant!r}: the pack is one of {_PACK_VARIANTS}")
    b, r = _check_lanes("relabel_pack_batch", (hi3, lo3), rows_per_capture, block_rows)
    _check_per_capture("relabel_pack_batch", b, s, ksel)
    dev = _same_device(hi3, lo3, s, ksel)
    if dev.type == "cpu":
        return relabel_pack_batch_plain(hi3, lo3, s, ksel)
    _require_aligned("relabel_pack_batch", hi3)
    _require_aligned("relabel_pack_batch", lo3)
    out = torch.empty((b, r * 32), dtype=torch.uint8, device=dev)
    _launch("amr_relabel_pack", dev, _ptr(hi3), _ptr(lo3), _ptr(s), _ptr(ksel), _ptr(out), b, r)
    _count(relabel_pack_batch)
    return out


# --- K4: DBPSK stream select + complement + mod-8 alignment + byte pack ----------

def bit_select_pack_batch_plain(
    re3: torch.Tensor, im3: torch.Tensor, s: torch.Tensor, ksel: torch.Tensor
) -> torch.Tensor:
    """Plain K4 in integer ops: the im stream where ``ksel`` is odd, else
    re; complemented where ``ksel >= 2``; shifted by ``s & 7`` bits (zeros
    past the capture's end) and packed MSB-first."""
    b = re3.shape[0]
    use_im = (ksel & 1).bool()[:, None]
    inv = (ksel >= 2).to(torch.uint8)[:, None]
    v = torch.where(use_im, im3.reshape(b, -1), re3.reshape(b, -1))
    return _pack_bits_from((v ^ inv) & 1, s & 7)


def bit_select_pack_batch(
    re3: torch.Tensor,
    im3: torch.Tensor,
    s: torch.Tensor,
    ksel: torch.Tensor,
    rows_per_capture: int,
    block_rows: int = 256,
    variant: str = "shift",
) -> torch.Tensor:
    """Whole-batch DBPSK stream select + complement + byte pack: (B, R, 128)
    uint8 sign-bit lanes -> (B, R*16) uint8. ``ksel`` is the hypothesis in
    :func:`bpsk_match_conditions` order (0 re, 1 im, 2 re inverted, 3 im
    inverted). The frame starts at byte ``s // 8``; bytes at or past
    ``(R*128 - (s & 7)) // 8`` are garbage by contract. On the card ``re3``
    and ``im3`` must start on a 16-byte boundary. ``variant`` "shift" and
    "weights" both run ``csrc/bit_select_pack.cu``, as for
    :func:`relabel_pack_batch`."""
    _require(variant in _PACK_VARIANTS, f"variant={variant!r}: the pack is one of {_PACK_VARIANTS}")
    b, r = _check_lanes("bit_select_pack_batch", (re3, im3), rows_per_capture, block_rows)
    _check_per_capture("bit_select_pack_batch", b, s, ksel)
    dev = _same_device(re3, im3, s, ksel)
    if dev.type == "cpu":
        return bit_select_pack_batch_plain(re3, im3, s, ksel)
    _require_aligned("bit_select_pack_batch", re3)
    _require_aligned("bit_select_pack_batch", im3)
    out = torch.empty((b, r * 16), dtype=torch.uint8, device=dev)
    _launch("amr_bit_select_pack", dev, _ptr(re3), _ptr(im3), _ptr(s), _ptr(ksel), _ptr(out), b, r)
    _count(bit_select_pack_batch)
    return out


# --- K5: D8PSK 8-rotation magic match on Gray planes of sectors ------------------

@functools.lru_cache(maxsize=16)
def psk8_match_conditions(pattern: str, pattern2: str = ""):
    """The 8 D8PSK π/4-rotation magic hypotheses as uniform plane conditions.

    The received SECTOR under a channel rotation of k·π/4 is (true + k) % 8;
    matching the frame magic in rotation-k sector space reduces to per-bit
    conditions on the THREE Gray bit planes of the received sector: with raw
    sector planes (b2, b1, b0), the Gray bits are g2 = b2, g1 = b2^b1,
    g0 = b1^b0 — derived ONCE in the kernel so every condition is a
    single-plane lookup across all 8 hypotheses. Returns
    ``conds[k] = tuple of (gray_plane, symbol_offset, bitval, exact)`` where
    ``gray_plane`` indexes (g2, g1, g0); ``exact`` marks bits inside
    ``pattern`` (must all match), the rest count toward the tolerance like
    the dibit matcher's validation region. Trailing bits of a partial final
    tribit are dropped — sector granularity, exactly like
    ops.psk._psk8_expected_sectors. Built once per (pattern, pattern2).
    """
    from .psk import _GRAY8_INV

    both = pattern + pattern2
    n_sym = len(both) // 3
    n_exact_bits = len(pattern)
    conds = []
    for k in range(8):
        c = []
        for j in range(n_sym):
            tri = (
                int(both[3 * j]) * 4 + int(both[3 * j + 1]) * 2 + int(both[3 * j + 2])
            )
            e = (int(_GRAY8_INV[tri]) + k) % 8  # expected RECEIVED sector
            ge = e ^ (e >> 1)
            for t, gb in enumerate(((ge >> 2) & 1, (ge >> 1) & 1, ge & 1)):
                c.append((t, j, gb, (3 * j + t) < n_exact_bits))
        conds.append(tuple(c))
    return tuple(conds), n_sym


def _gray_planes(sec: torch.Tensor):
    """uint8 sectors -> their Gray planes (g2, g1, g0) as uint8 0/1."""
    b2, b1, b0 = (sec >> 2) & 1, (sec >> 1) & 1, sec & 1
    return b2, b2 ^ b1, b1 ^ b0


@functools.lru_cache(maxsize=16)
def _sector_mask_table(pattern: str, pattern2: str) -> np.ndarray:
    """(n_hyp, 4) int32 host table of :func:`psk8_match_conditions`: per
    hypothesis [exact mask, exact value, tolerant mask, tolerant value]
    over a window word holding Gray plane q of window symbol j at bit
    3j + q. Built once per key; K5 takes it as a kernel parameter."""
    conds, _ = psk8_match_conditions(pattern, pattern2)
    rows = []
    for c in conds:
        m = [0] * 4
        for plane, off, bit, exact in c:
            j = 3 * off + plane
            _require(0 <= j < 31, f"condition at symbol {off} outside the 10-symbol window")
            base = 0 if exact else 2
            m[base] |= 1 << j
            m[base + 1] |= bit << j
        rows.append(m)
    table = np.array(rows, dtype=np.int32)
    table.flags.writeable = False
    return table




def sector_match_batch_plain(sec3: torch.Tensor, conds, tol: int, rows_scanned: int) -> torch.Tensor:
    """Plain K5: the Gray planes of the first ``rows_scanned`` rows (zeros
    past them) swept by the condition sets. Returns (B, 8) int32 first
    symbol positions, 2^30 where none matched (before the limit epilogue)."""
    b = sec3.shape[0]
    n = rows_scanned * _BLOCK_SYM
    max_off = max(off for c in conds for (_p, off, _b, _e) in c)
    sec = F.pad(sec3[:, :rows_scanned].reshape(b, n), (0, max_off))
    return _first_match_plain(_gray_planes(sec), conds, tol, n)


def sector_match_batch(
    sec3: torch.Tensor,
    pattern: str,
    rows_per_capture: int,
    block_rows: int = 256,
    pattern2: str = "",
    tol: int = 3,
    rows_scanned: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R, 128) uint8 raw sector rows -> per-capture (first_pos, found),
    shape (B, 8), for the 8 D8PSK rotation hypotheses; positions in symbols.
    ``rows_scanned`` limits the scan to each capture's first rows as in
    :func:`rotation_match_batch`. On the card a call is one launch that
    writes both outputs (no host read); ``sec3`` must start on a 16-byte
    boundary."""
    b, r = _check_lanes("sector_match_batch", (sec3,), rows_per_capture, block_rows)
    p = r if rows_scanned is None else int(rows_scanned)
    _require(0 < p <= r and p % block_rows == 0, f"rows_scanned={p} for R={r}")
    conds, n_sym = psk8_match_conditions(pattern, pattern2)
    dev = _same_device(sec3)
    if dev.type == "cpu":
        first = sector_match_batch_plain(sec3, conds, tol, p)
        limit = p * _BLOCK_SYM - (n_sym + 1)
        found = (first < _BIG) & (first < limit)
        return torch.where(found, first, 0), found
    _require_aligned("sector_match_batch", sec3)
    table_ptr = _sector_mask_table(pattern, pattern2).ctypes.data
    stream = _raw_stream(dev)
    scratch, ticket = _match_state(dev, stream)
    first = torch.empty((b, len(conds)), dtype=torch.int32, device=dev)
    found = torch.empty((b, len(conds)), dtype=torch.bool, device=dev)
    _launch("amr_sector_first", dev, _ptr(sec3), table_ptr, len(conds), tol, n_sym, _ptr(first),
            _ptr(found), _ptr(scratch), scratch.shape[0], _ptr(ticket), b, r, p, stream=stream)
    _count(sector_match_batch)
    return first, found


# --- K6: D8PSK relabel + Gray + mod-8-symbol alignment + byte pack ---------------

def psk8_relabel_pack_rows_plain(
    sec3: torch.Tensor, ksel: torch.Tensor, r8: torch.Tensor
) -> torch.Tensor:
    """Plain K6 in integer ops: true sector (rx + 8 - ksel) & 7, its Gray
    planes interleaved MSB first into the flat bit stream, shifted by
    3 * r8 bits (zeros past the capture's end) and packed."""
    b = sec3.shape[0]
    t = (sec3.reshape(b, -1).to(torch.int32) + 8 - ksel.to(torch.int32)[:, None]) & 7
    bits = torch.stack(_gray_planes(t), dim=2).reshape(b, -1).to(torch.uint8)
    return _pack_bits_from(bits, 3 * r8)


def psk8_relabel_pack_rows(
    sec3: torch.Tensor,
    ksel: torch.Tensor,
    r8: torch.Tensor,
    rows_per_capture: int,
    block_rows: int = 256,
) -> torch.Tensor:
    """Whole-batch D8PSK relabel + byte pack: (B, R, 128) uint8 received
    sectors -> (B, R*48) uint8. ``ksel`` is the winning rotation and ``r8``
    the sync shift in symbols, already reduced mod 8: the frame starts at
    byte ``3 * (s // 8)``, which the parser's magic scan absorbs. On the
    card ``sec3`` must start on a 16-byte boundary."""
    b, r = _check_lanes("psk8_relabel_pack_rows", (sec3,), rows_per_capture, block_rows)
    _check_per_capture("psk8_relabel_pack_rows", b, ksel, r8)
    dev = _same_device(sec3, ksel, r8)
    if dev.type == "cpu":
        return psk8_relabel_pack_rows_plain(sec3, ksel, r8)
    _require_aligned("psk8_relabel_pack_rows", sec3)
    out = torch.empty((b, r * 48), dtype=torch.uint8, device=dev)
    _launch("amr_psk8_pack", dev, _ptr(sec3), _ptr(ksel), _ptr(r8), _ptr(out), b, r)
    _count(psk8_relabel_pack_rows)
    return out


# --- the FSK kernels' shared pieces --------------------------------------------------

_FSK_DTYPES = {torch.float32: 0, torch.int16: 1}
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on sm_90
_K7_SMEM = 220 * 1024  # csrc/fsk_tile.cu kK7Smem: a K7 block's shared memory at most


def _band_tables(w: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Compact a block-diagonal template ``w`` (n_off, n_rows, groups*n_out),
    whose output o reads the columns ``g*n_out + o``, to the rows where they
    are nonzero.

    Returns ``(first (n_off, n_out) int32, tab (n_off, groups, span, n_out)
    float32, span)``: every nonzero entry of output o's columns lies in rows
    [first, first + span), first is clamped so that first + span <= n_rows,
    and ``tab[i, g, t, o] = w[i, first[i, o] + t, g*n_out + o]``. The
    projection over those rows equals the dense one up to summation order.
    Reads ``span`` to the host: the wrappers keep the tables per template
    (:func:`_kept`), so that read is made at a template's first call."""
    n_off, n_rows, cols = w.shape
    n_out = cols // groups
    w4 = w.reshape(n_off, n_rows, groups, n_out)
    nz = (w4 != 0).any(dim=2)  # (n_off, n_rows, n_out)
    idx = torch.arange(n_rows, device=w.device)[None, :, None]
    first = torch.where(nz, idx, n_rows).amin(dim=1)
    last = torch.where(nz, idx, -1).amax(dim=1)
    span = max(1, int((last - first + 1).max()))
    first = first.clamp(max=n_rows - span)
    rows = first[:, None, :] + torch.arange(span, device=w.device)[None, :, None]
    tab = torch.gather(w4, 1, rows[:, :, None, :].expand(n_off, span, groups, n_out))
    return first.to(torch.int32), tab.permute(0, 2, 1, 3).contiguous(), span


def _flat_band_tables(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K13's ``_band_tables(w, 4)``, the table laid out (n_off, spr, span, 4)."""
    first, tab, span = _band_tables(w, 4)
    return first, tab.permute(0, 3, 2, 1).contiguous(), span


def _check_best(name: str, best: torch.Tensor, b: int, n_offsets: int) -> None:
    _require(best.dtype == torch.int32 and tuple(best.shape) == (b,),
             f"{name}: best {best.dtype} {tuple(best.shape)}, want int32 ({b},)")
    _require(b <= 65535 and n_offsets >= 1, f"{name}: {b} captures, {n_offsets} offsets")


# --- K7 and K13: dual-tone projection + energy decision ------------------------------

def fsk_tile_bits_batch_plain(x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor,
                              spr: int) -> torch.Tensor:
    """Plain K7: the dense projection of each overlapped row on the winning
    offset's template (``ops/fsk.py`` of the JAX package, :1258-1263), bit =
    E_mark - E_space > 0."""
    b, r, _ = x3d.shape
    pj = torch.bmm(x3d.to(torch.float32), w_all[best.long()]).reshape(b, r, 4, spr)
    margin = (pj[:, :, 0] ** 2 + pj[:, :, 1] ** 2) - (pj[:, :, 2] ** 2 + pj[:, :, 3] ** 2)
    return (margin > 0).to(torch.uint8).reshape(b, r * spr)


def fsk_project_bits_batch_plain(x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor,
                                 spr: int) -> torch.Tensor:
    """Plain K13: row j's overlap is the head of row j+1 of the same capture,
    zeros after the last row (the JAX package's :757-765)."""
    b, r, row = x3d.shape
    ov = w_all.shape[1] - row
    x = x3d.to(torch.float32)
    x_next = torch.cat([x[:, 1:, :ov], x.new_zeros((b, 1, ov))], dim=1)
    return fsk_tile_bits_batch_plain(torch.cat([x, x_next], dim=2), w_all, best, spr)


def _fsk_dual_launch(name: str, x3d, w_all, best, rows_per_capture: int, spr: int, flat: bool):
    _require(x3d.ndim == 3 and w_all.ndim == 3, f"{name}: x3d {tuple(x3d.shape)}, w_all {tuple(w_all.shape)}")
    b, r, c = x3d.shape
    n_off, n_rows, cols = w_all.shape
    _require(r == rows_per_capture and r >= 1, f"{name}: rows {r} vs rows_per_capture={rows_per_capture}")
    _require(x3d.dtype in _FSK_DTYPES, f"{name}: x3d dtype {x3d.dtype}")
    _require(w_all.dtype == torch.float32 and spr >= 1 and cols == 4 * spr,
             f"{name}: w_all {w_all.dtype} {tuple(w_all.shape)} for spr={spr}")
    _require(n_rows >= c if flat else n_rows == c,
             f"{name}: template rows {n_rows} vs row width {c}")
    _check_best(name, best, b, n_off)
    dev = _same_device(x3d, w_all, best)
    if dev.type == "cpu":
        plain = fsk_project_bits_batch_plain if flat else fsk_tile_bits_batch_plain
        return plain(x3d, w_all, best, spr)
    if flat:  # K13: the band table and two buffers of at least one row of samples
        first, tab, span = _kept(w_all, "flat_band_tables", lambda: _flat_band_tables(w_all))
        row_floats = 4 * (((n_rows + 6) >> 2) | 1)
        _require(16 * span * spr + 8 * row_floats <= _SMEM_LIMIT,
                 f"{name}: a {span} x {spr} band table and {n_rows}-sample rows exceed shared memory")
    else:  # K7: the (spr, span) float4 weights and two buffers of at least one row's 16-byte chunks
        first, tab, span = _kept(w_all, ("band_tables", 4), lambda: _band_tables(w_all, 4))
        per_chunk = 16 // x3d.element_size()
        _require(c % per_chunk == 0 and x3d.data_ptr() % 16 == 0,
                 f"{name}: the kernel stages 16-byte chunks of each row, so rows of {c} {x3d.dtype} samples "
                 f"must fill whole chunks and start on a 16-byte boundary (this view starts "
                 f"{x3d.data_ptr() % 16} bytes past one)")
        _require(16 * span * spr + 32 * ((c // per_chunk) | 1) <= _K7_SMEM,
                 f"{name}: a {span} x {spr} band table and {c}-sample rows exceed shared memory")
    bits = torch.empty((b, r * spr), dtype=torch.uint8, device=dev)
    _launch("amr_fsk_tile", dev, _ptr(x3d), _FSK_DTYPES[x3d.dtype], int(flat), _ptr(tab), _ptr(first),
            span, _ptr(best), _ptr(bits), b, r, c, spr, n_rows)
    return bits


def fsk_tile_bits_batch(
    x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor, rows_per_capture: int, spr: int,
) -> torch.Tensor:
    """Whole-batch dual-tone FSK over host-overlapped rows.

    Args:
      x3d: (B, R, row+ov) float32 or int16 rows (integers cast unscaled).
      w_all: (n_offsets, row+ov, 4*spr) float32 templates
        (``ops.fsk._fsk_blocked_templates``); the kernel reads each bit's band.
      best: (B,) int32 winning offset per capture.
    Returns uint8 bits (B, R*spr). Any spr and any R: the Pallas kernel's
    ``128 % spr`` and block-row conditions were its lane layout's. On the
    card each row must fill whole 16-byte chunks and start on a 16-byte
    boundary (row+ov is a multiple of 128); a view that does not is
    refused."""
    bits = _fsk_dual_launch("fsk_tile_bits_batch", x3d, w_all, best, rows_per_capture, spr, False)
    if x3d.is_cuda:
        _count(fsk_tile_bits_batch)
    return bits


def fsk_project_bits_batch(
    x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor, rows_per_capture: int, spr: int,
) -> torch.Tensor:
    """K7's function on flat (B, R, row) float32 or int16 rows: row j's
    overlap is the head of row j+1 of the same capture, zeros after the
    capture's last row. Returns uint8 bits (B, R*spr)."""
    bits = _fsk_dual_launch("fsk_project_bits_batch", x3d, w_all, best, rows_per_capture, spr, True)
    if x3d.is_cuda:
        _count(fsk_project_bits_batch)
    return bits


# --- K8 and K9: analytic FIR on FIR windows, then phasor boxcar or quadratures ------

def _fir_stream(fir_rows: torch.Tensor, w_fir: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, m, c_pad) FIR windows -> the flat analytic stream (re, im), each
    (B, m*128) float32."""
    z2 = torch.matmul(fir_rows.to(torch.float32), w_fir)
    bm = fir_rows.shape[0]
    return z2[..., :_BLOCK_SYM].reshape(bm, -1), z2[..., _BLOCK_SYM:].reshape(bm, -1)


def _boxcar_rows(v: torch.Tensor, m2: int, row2: int, ov2: int) -> torch.Tensor:
    """Flat (B, n) stream -> (B, m2, row2+ov2) rows: row j holds samples
    [j*row2, j*row2 + row2 + ov2), zeros past the stream's end."""
    bm, n = v.shape
    v = F.pad(v, (0, max(0, (m2 + 1) * row2 - n)))
    main = v[:, : m2 * row2].reshape(bm, m2, row2)
    tail = v[:, row2 : (m2 + 1) * row2].reshape(bm, m2, row2)[:, :, :ov2]
    return torch.cat([main, tail], dim=2)


def disc_phasor_rows(fir_rows: torch.Tensor, w_fir: torch.Tensor, m2: int, row2: int, ov2: int):
    """(B, m, c_pad) FIR windows -> the phasor p[n] = z[n+1]·conj z[n] as
    boxcar rows (re, im), each (B, m2, row2+ov2); z past the stream is 0
    (the JAX package's ``p_rows``)."""
    zr, zi = _fir_stream(fir_rows, w_fir)
    zeros = zr.new_zeros((zr.shape[0], 1))
    z1r = torch.cat([zr[:, 1:], zeros], dim=1)
    z1i = torch.cat([zi[:, 1:], zeros], dim=1)
    p_re = z1r * zr + z1i * zi
    p_im = z1i * zr - z1r * zi
    return _boxcar_rows(p_re, m2, row2, ov2), _boxcar_rows(p_im, m2, row2, ov2)


def quad_analytic_rows(fir_rows: torch.Tensor, w_fir: torch.Tensor, m2: int, row2: int, ov2: int):
    """(B, m, c_pad) FIR windows -> the analytic stream as boxcar rows (re,
    im), each (B, m2, row2+ov2) (the JAX package's ``z_rows``)."""
    zr, zi = _fir_stream(fir_rows, w_fir)
    return _boxcar_rows(zr, m2, row2, ov2), _boxcar_rows(zi, m2, row2, ov2)


def quad_margins(M: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """Noncoherent mark-space margin from (..., 4, spr2) projections of the
    analytic re (M) and im (N) streams on [cos_m, sin_m, cos_s, sin_s]."""
    u_m = M[..., 0, :] + N[..., 1, :]
    v_m = N[..., 0, :] - M[..., 1, :]
    u_s = M[..., 2, :] + N[..., 3, :]
    v_s = N[..., 2, :] - M[..., 3, :]
    return u_m**2 + v_m**2 - u_s**2 - v_s**2


def fsk_disc_sums_batch_plain(x3d, w_fir, w_box, best, row2: int, ov2: int):
    """Plain K8: ``disc_phasor_rows`` over the whole capture, then the
    boxcar of the winning offset (the JAX package's :998-1002)."""
    b, r, _ = x3d.shape
    pr, pi = disc_phasor_rows(x3d, w_fir, r * _BLOCK_SYM // row2, row2, ov2)
    wb = w_box[best.long()]
    return torch.bmm(pr, wb).reshape(b, -1), torch.bmm(pi, wb).reshape(b, -1)


def fsk_quad_margin_batch_plain(x3d, w_fir, w_quad, best, row2: int, ov2: int, spr2: int):
    """Plain K9: ``quad_analytic_rows`` over the whole capture, the winning
    offset's quadratures and the margin (the JAX package's :1181-1184)."""
    b, r, _ = x3d.shape
    r2 = r * _BLOCK_SYM // row2
    rz, ri = quad_analytic_rows(x3d, w_fir, r2, row2, ov2)
    wq = w_quad[best.long()]
    M = torch.bmm(rz, wq).reshape(b, r2, 4, spr2)
    N = torch.bmm(ri, wq).reshape(b, r2, 4, spr2)
    return quad_margins(M, N).reshape(b, -1)


_FIR_TAPS = 129  # csrc/fsk_fir.cuh's unrolled tap count (shorter filters pad with zeros)
_FIR_DECS = (1, 4)  # its instantiated decimations


def _fir_taps(w_fir: torch.Tensor) -> Tuple[np.ndarray, int]:
    """``(h (2, 129) float32 [Re; Im] reversed taps, dec)`` of a decimating
    FIR matrix: column m (< 128) holds Re(h) from row dec*m, column 128+m
    Im(h) (``ops.common._fir_dec_template``, zero rows to c_pad). Raises
    unless ``w_fir`` is exactly that matrix for an instantiated dec."""
    c = w_fir.shape[0]
    dev = w_fir.device
    m = torch.arange(_BLOCK_SYM, device=dev)[:, None]
    k = torch.arange(_FIR_TAPS, device=dev)[None, :]
    for dec in _FIR_DECS:
        if c < (_BLOCK_SYM - 1) * dec + _FIR_TAPS:
            continue  # the kernel's 129-tap window would read past the row
        h = w_fir[:_FIR_TAPS, [0, _BLOCK_SYM]].T.contiguous()  # (2, 129)
        rows = (dec * m + k).reshape(-1)
        cols = m.expand(-1, _FIR_TAPS).reshape(-1)
        rebuilt = torch.zeros_like(w_fir)
        rebuilt[rows, cols] = h[0].repeat(_BLOCK_SYM)
        rebuilt[rows, cols + _BLOCK_SYM] = h[1].repeat(_BLOCK_SYM)
        if torch.equal(rebuilt, w_fir):
            return h.cpu().numpy(), dec
    raise ValueError(f"w_fir {tuple(w_fir.shape)} is not a decimating FIR matrix with dec in {_FIR_DECS} "
                     f"and at most {_FIR_TAPS} taps")


def _check_fir_rows(name, x3d, w_fir, w2, best, rows_per_capture, nrow2, row2, ov2, cols2):
    _require(x3d.ndim == 3, f"{name}: x3d {tuple(x3d.shape)}")
    b, r, c = x3d.shape
    fb = nrow2 * row2 // _BLOCK_SYM
    _require(r == rows_per_capture and fb > 0 and r % fb == 0,
             f"{name}: rows {r} vs rows_per_capture={rows_per_capture}, FB={fb}")
    _require(c % _BLOCK_SYM == 0 and row2 % _BLOCK_SYM == 0 and ov2 % _BLOCK_SYM == 0 and 0 < ov2 <= row2,
             f"{name}: c_pad={c}, row2={row2}, ov2={ov2} must be 128-aligned, ov2 <= row2")
    _require(x3d.dtype in _FSK_DTYPES, f"{name}: x3d dtype {x3d.dtype}")
    _require(w_fir.dtype == torch.float32 and tuple(w_fir.shape) == (c, 2 * _BLOCK_SYM),
             f"{name}: w_fir {w_fir.dtype} {tuple(w_fir.shape)}, want the dense ({c}, 256) matrix")
    _require(w2.dtype == torch.float32 and w2.ndim == 3 and tuple(w2.shape[1:]) == (row2 + ov2, cols2),
             f"{name}: template {w2.dtype} {tuple(w2.shape)}")
    _check_best(name, best, b, w2.shape[0])
    return b, r, c, _same_device(x3d, w_fir, w2, best)


def _fir_launch(name: str, x3d, w_fir, w2, groups: int, best, outs, row2: int, ov2: int, spr2: int):
    """Launch K8 (``groups`` 1) or K9 (``groups`` 4) into ``outs``."""
    b, r, c = x3d.shape
    dev = x3d.device
    taps, dec = _kept(w_fir, "fir_taps", lambda: _fir_taps(w_fir))  # taps is held through the launch
    _require(c == _BLOCK_SYM * dec + _BLOCK_SYM,
             f"{name}: c_pad={c}, the kernel takes dec {dec} windows of {_BLOCK_SYM * dec + _BLOCK_SYM} samples")
    first, tab, span = _kept(w2, ("band_tables", groups), lambda: _band_tables(w2, groups))
    ptrs = [_ptr(o) for o in outs] + [None] * (2 - len(outs))
    _launch(name, dev, _ptr(x3d), _FSK_DTYPES[x3d.dtype], taps.ctypes.data, dec, _ptr(first), _ptr(tab),
            span, _ptr(best), ptrs[0], ptrs[1], b, r, c, row2, ov2, spr2)


def fsk_disc_sums_batch(
    x3d: torch.Tensor, w_fir: torch.Tensor, w_box: torch.Tensor, best: torch.Tensor,
    rows_per_capture: int, nrow2: int, row2: int, ov2: int, spr2: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch FSK discriminator front half: decimating analytic FIR,
    phasor z[n+1]·conj z[n], fractional per-bit boxcar.

    Args:
      x3d: (B, R, c_pad) float32 or int16 FIR windows (``fsk_disc_row_shape``),
        R a multiple of FB = nrow2*row2/128: row g is the capture's samples
        [g*128*dec, g*128*dec + c_pad), c_pad = 128*dec + 128, so its first
        128 samples repeat row g-1's last 128. The kernel relies on that
        overlap (it fetches each row's last 128*dec samples, and the first
        128 of every 16th row only); the plain version reads every window
        whole.
      w_fir: (c_pad, 256) dense decimating analytic-FIR matrix.
      w_box: (n_offsets, row2+ov2, spr2) boxcar templates.
      best: (B,) int32 winning offset per capture.
    Returns the per-bit vector sums (sr, si), each (B, R*128//row2 * spr2)
    float32. The phasor past a capture's last row is zero."""
    b, r, c, dev = _check_fir_rows("fsk_disc_sums_batch", x3d, w_fir, w_box, best,
                                   rows_per_capture, nrow2, row2, ov2, spr2)
    if dev.type == "cpu":
        return fsk_disc_sums_batch_plain(x3d, w_fir, w_box, best, row2, ov2)
    n = r * _BLOCK_SYM // row2 * spr2
    sr = torch.empty((b, n), dtype=torch.float32, device=dev)
    si = torch.empty_like(sr)
    _fir_launch("amr_fsk_disc", x3d, w_fir, w_box, 1, best, (sr, si), row2, ov2, spr2)
    _count(fsk_disc_sums_batch)
    return sr, si


def fsk_quad_margin_batch(
    x3d: torch.Tensor, w_fir: torch.Tensor, w_quad: torch.Tensor, best: torch.Tensor,
    rows_per_capture: int, nrow2: int, row2: int, ov2: int, spr2: int,
) -> torch.Tensor:
    """Whole-batch mid-separation FSK matched filter: analytic FIR (dec 1),
    per-bit tone quadratures of its re and im streams, noncoherent margin.

    Args as :func:`fsk_disc_sums_batch`, with ``w_quad`` (n_offsets,
    row2+ov2, 4*spr2) tone quadratures [cos_m | sin_m | cos_s | sin_s].
    Returns the margin E_mark - E_space, (B, R*128//row2 * spr2) float32."""
    b, r, c, dev = _check_fir_rows("fsk_quad_margin_batch", x3d, w_fir, w_quad, best,
                                   rows_per_capture, nrow2, row2, ov2, 4 * spr2)
    if dev.type == "cpu":
        return fsk_quad_margin_batch_plain(x3d, w_fir, w_quad, best, row2, ov2, spr2)
    margin = torch.empty((b, r * _BLOCK_SYM // row2 * spr2), dtype=torch.float32, device=dev)
    _fir_launch("amr_fsk_quad", x3d, w_fir, w_quad, 4, best, (margin,), row2, ov2, spr2)
    _count(fsk_quad_margin_batch)
    return margin


# --- after K8: atan2, the equalizer, the tone (no Pallas counterpart) ---------------

_EQ_TAPS = 9  # calibrated discriminator equalizer length (per-bit taps)


def _disc_scale(sample_rate: int, plan: dict) -> float:
    """Hz per radian of the decimated phasor."""
    return sample_rate / plan["dec"] / (2 * math.pi)


def fsk_disc_decide_batch_plain(sr_sum: torch.Tensor, si_sum: torch.Tensor, plan: dict, coef: np.ndarray,
                                sample_rate: int, mark: float, space: float) -> torch.Tensor:
    """K8's per-bit vector sums -> bits: atan2 to a frequency, the calibrated
    ``_EQ_TAPS``-tap equalizer (edges repeated), the nearer tone. The plain
    version of :func:`fsk_disc_decide_batch` (the JAX package's XLA chain
    after K8)."""
    f = torch.atan2(si_sum, sr_sum) * _disc_scale(sample_rate, plan)
    pad = _EQ_TAPS // 2
    n = f.shape[1]
    fm = torch.cat([f[:, :1].expand(-1, pad), f, f[:, -1:].expand(-1, pad)], dim=1)
    eq = torch.full_like(f, float(coef[-1]))
    for j in range(_EQ_TAPS):
        eq = eq + float(coef[j]) * fm[:, j : j + n]
    return (torch.abs(eq - mark) < torch.abs(eq - space)).to(torch.uint8)


def fsk_disc_decide_batch(sr_sum: torch.Tensor, si_sum: torch.Tensor, plan: dict, coef: np.ndarray,
                          sample_rate: int, mark: float, space: float) -> torch.Tensor:
    """K8's per-bit vector sums (each (B, n) float32) -> uint8 bits (B, n):
    atan2 to a frequency, the calibrated equalizer ``coef`` (taps, then the
    bias; each row's edge frequencies repeated), the nearer of ``mark`` and
    ``space``, as :func:`fsk_disc_decide_batch_plain` computes them, bit for
    bit. On the card ``csrc/fsk_eq_bits.cu``, one pass over the sums; on the
    CPU the plain chain. The sums must be contiguous, and on the card start
    on a 16-byte boundary."""
    name = "fsk_disc_decide_batch"
    _require(sr_sum.ndim == 2 and sr_sum.shape == si_sum.shape and sr_sum.dtype == si_sum.dtype == torch.float32,
             f"{name}: sums {sr_sum.dtype} {tuple(sr_sum.shape)}, {si_sum.dtype} {tuple(si_sum.shape)}, "
             "want two float32 (B, n)")
    _require(sr_sum.is_contiguous() and si_sum.is_contiguous(), f"{name}: the sums must be contiguous")
    coef = np.asarray(coef, np.float32)
    _require(coef.shape == (_EQ_TAPS + 1,), f"{name}: coef {coef.shape}, want {_EQ_TAPS} taps and the bias")
    dev = _same_device(sr_sum, si_sum)
    if dev.type == "cpu":
        return fsk_disc_decide_batch_plain(sr_sum, si_sum, plan, coef, sample_rate, mark, space)
    # csrc/fsk_eq_bits.cu fixes the taps at 9 (kTaps) and reads 13 parameters.
    _require(_EQ_TAPS == 9, f"{name}: the kernel takes 9 taps, the equalizer has {_EQ_TAPS}")
    b, n = sr_sum.shape
    _require(1 <= b <= _MAX_CAPTURES and n >= 1,
             f"{name}: {b} captures of {n} bits, want 1 to {_MAX_CAPTURES} of 1 or more")
    _require_aligned(name, sr_sum)
    _require_aligned(name, si_sum)
    # Each host scalar cast to float32 once, as ATen casts a Python number.
    params = np.array([_disc_scale(sample_rate, plan), *coef, mark, space], np.float32)
    bits = torch.empty((b, n), dtype=torch.uint8, device=dev)
    _launch("amr_fsk_eq_bits", dev, _ptr(sr_sum), _ptr(si_sum), b, n, params.ctypes.data, _ptr(bits))
    _count(fsk_disc_decide_batch)
    return bits


# --- K10: NEURAL chip extraction + codebook scores + argmax ---------------------------

_NEURAL_DTYPES = {torch.float32: 0, torch.int16: 1}
_NEURAL_SPR = 8  # symbols per 128-sample row at chip length 2
_MASK_RE = (1.0, 0.0, -1.0, 0.0)  # fs/4 downconversion by lane mod 4
_MASK_IM = (0.0, -1.0, 0.0, 1.0)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even) and back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _first_max_or_zero(scores: torch.Tensor) -> torch.Tensor:
    """``argmax="dot"``: the index of the maximum where exactly one entry of
    the last axis holds it, 0 where several do (the JAX kernel's count gate)."""
    top = scores.amax(dim=-1, keepdim=True)
    n_top = (scores == top).sum(dim=-1)
    return torch.where(n_top == 1, torch.argmax(scores, dim=-1), 0)


def _neural_chips(x2d: torch.Tensor, phasors: torch.Tensor, s: torch.Tensor, rows_per_capture: int,
                  bf16: bool) -> torch.Tensor:
    """The scored chips of every symbol, (B, r3, 8, 16) float32 ``[re 0..7 |
    im 0..7]`` of slot m of row j: each row and its circular successor (row
    j+1, row 0 after the last) as one 256-sample pair, fs/4 downconversion
    by sign masks, chip c the mean of lanes s+2c and s+2c+1 (s taken mod
    128), unrotation ``(a·re + b·im, a·im - b·re)``. ``bf16`` rounds the
    samples before the chip means and the unrotated chips to bfloat16."""
    r = rows_per_capture
    b = x2d.shape[0] // r
    dev = x2d.device
    x = x2d.reshape(b, r, 128).to(torch.float32)
    if bf16:
        x = _bf16(x)
    pair = torch.cat([x, torch.roll(x, -1, dims=1)], dim=2)  # (B, r, 256)
    lane = torch.arange(256, device=dev) % 4
    zr = pair * torch.tensor(_MASK_RE, device=dev)[lane]
    zi = pair * torch.tensor(_MASK_IM, device=dev)[lane]
    idx = (s.to(torch.int64) % 128)[:, None] + torch.arange(128, device=dev)
    idx = idx[:, None, :].expand(b, r, 128)
    cr = torch.gather(zr, 2, idx).reshape(b, r, 64, 2).sum(-1) * 0.5
    ci = torch.gather(zi, 2, idx).reshape(b, r, 64, 2).sum(-1) * 0.5
    a, c = phasors[:, 0, None, None], phasors[:, 1, None, None]
    ur, ui = cr * a + ci * c, ci * a - cr * c
    rx = torch.cat([ur.reshape(b, r, _NEURAL_SPR, 8), ui.reshape(b, r, _NEURAL_SPR, 8)], dim=3)
    return _bf16(rx) if bf16 else rx


def neural_extract_batch_plain(
    x2d: torch.Tensor, codebook: torch.Tensor, phasors: torch.Tensor, s: torch.Tensor,
    rows_per_capture: int, bf16: bool = False, argmax: str = "loop",
) -> torch.Tensor:
    """Plain K10: the chips of :func:`_neural_chips` times the codebook;
    the first-max argmax (``argmax="loop"``) or the count gate (``"dot"``:
    0 where several codewords share the maximum). ``bf16`` rounds the
    samples before the chip means, and the unrotated chips and the codebook
    before the scores, to bfloat16; the scores are a float32 product.
    Returns (B, r3 * 8) uint8."""
    r = rows_per_capture
    b = x2d.shape[0] // r
    rx = _neural_chips(x2d, phasors, s, r, bf16)
    scores = rx @ (_bf16(codebook) if bf16 else codebook).T
    sym = _first_max_or_zero(scores) if argmax == "dot" else torch.argmax(scores, dim=-1)
    return sym.to(torch.uint8).reshape(b, r * _NEURAL_SPR)


# The near-tie margin of K10's bf16 scores: 2 x 32 units of 2^-24 times the
# sum of the magnitudes of a score's 16 products. A float32 sum of 16 exact
# products, in any order, is within 15 x 2^-24 of that sum of its exact
# value; 32 covers a tensor core's truncated alignment, and the factor 2
# two such sums, one on either side.
_NEAR_TIE_UNITS = 2 * 32 * 2.0 ** -24
_NEAR_TIE_CHUNK = 1024  # symbols a float64 score block holds


def _exact_bf16_scores(rx: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, magnitudes), (n, 256) float64 each, of the n bf16 chip rows
    ``rx`` against the bf16-rounded codebook: the products of two bfloat16
    values are exact in float64 and so, to 2^-53 of its magnitude, is each
    sum of 16 of them; the magnitudes are the sums of the products'
    absolute values. In blocks of ``_NEAR_TIE_CHUNK`` rows."""
    cb = _bf16(codebook).to(torch.float64)
    scores, mags = [], []
    for lo in range(0, rx.shape[0], _NEAR_TIE_CHUNK):
        prod = rx[lo:lo + _NEAR_TIE_CHUNK].to(torch.float64)[:, None, :] * cb[None]
        scores.append(prod.sum(-1))
        mags.append(prod.abs().sum(-1))
    return torch.cat(scores), torch.cat(mags)


def _near_tie(scores: torch.Tensor, mags: torch.Tensor, *answers: torch.Tensor,
              count_gate: bool = False) -> torch.Tensor:
    """Per row of exact ``scores``: whether its top two are less than δ
    apart and each of ``answers`` (codeword indices) is within δ of the
    top, or is 0 under the count gate; δ = ``_NEAR_TIE_UNITS`` times the
    largest magnitude among the top two and the answers' codewords. An
    exact tie of zero magnitude (an all-zero row: δ = 0) is no near tie."""
    top = scores.topk(2, dim=-1)
    involved = torch.cat([top.indices, *(a[:, None] for a in answers)], dim=1)
    delta = _NEAR_TIE_UNITS * mags.gather(1, involved).amax(dim=1)
    near = top.values[:, 0] - top.values[:, 1] < delta
    for a in answers:
        close = top.values[:, 0] - scores.gather(1, a[:, None])[:, 0] <= delta
        near &= close | (count_gate & (a == 0))
    return near


def _neural_chips_at(x2d: torch.Tensor, phasors: torch.Tensor, s: torch.Tensor, rows_per_capture: int,
                     at: torch.Tensor) -> torch.Tensor:
    """The bf16 chips of :func:`_neural_chips` of the symbols at flat
    indices ``at`` of the (B, r3 * 8) output, (len(at), 16): each from its
    row and the row's circular successor alone, as a capture of two rows."""
    r = rows_per_capture
    cap, i = at // (r * _NEURAL_SPR), at % (r * _NEURAL_SPR)
    row = cap * r + i // _NEURAL_SPR
    succ = cap * r + (i // _NEURAL_SPR + 1) % r
    pairs = torch.stack([x2d[row], x2d[succ]], dim=1).reshape(-1, 128)
    rx = _neural_chips(pairs, phasors[cap], s[cap], 2, True)  # (n, 2, 8, 16)
    return rx[torch.arange(at.numel(), device=at.device), 0, i % _NEURAL_SPR]


def neural_near_ties(
    x2d: torch.Tensor, codebook: torch.Tensor, phasors: torch.Tensor, s: torch.Tensor,
    rows_per_capture: int,
) -> torch.Tensor:
    """(B, r3 * 8) bool: the symbols whose exact bf16 scores (the chips of
    :func:`_neural_chips` with ``bf16``, float64 products and sums) have
    their top two less than δ apart: the symbols where float32 sums of the
    same operands, in two orders, may pick two codewords."""
    r = rows_per_capture
    b = x2d.shape[0] // r
    rx = _neural_chips(x2d, phasors, s, r, True).reshape(-1, 16)
    scores, mags = _exact_bf16_scores(rx, codebook)
    return _near_tie(scores, mags).reshape(b, r * _NEURAL_SPR)


def neural_bf16_mismatches(
    x2d: torch.Tensor, codebook: torch.Tensor, phasors: torch.Tensor, s: torch.Tensor,
    rows_per_capture: int, got: torch.Tensor, ref: torch.Tensor, argmax: str = "loop",
) -> Tuple[int, int]:
    """(differing, outside): how many symbols of two bf16 K10 outputs
    ``got`` and ``ref`` (each (B, r3 * 8) uint8, on ``x2d``'s device)
    differ, and how many of those are not near ties. A differing symbol is
    a near tie where the exact top two of its bf16 scores (float64, as
    :func:`neural_near_ties`) are less than δ apart and each output's
    symbol is a codeword within δ of the top (or 0, under the count gate
    ``argmax="dot"``); δ = 2 x 32 x 2^-24 times the largest sum of product
    magnitudes among those codewords. The tensor cores sum a score's 16
    exact products in their own order and alignment, the plain version in
    float32 in another, so the two may part only there; a differing symbol
    outside δ is a fault of the kernel."""
    diff = (got != ref).reshape(-1).nonzero()[:, 0]
    if diff.numel() == 0:
        return 0, 0
    outside = 0
    for at in diff.split(_NEAR_TIE_CHUNK * 64):
        rx = _neural_chips_at(x2d, phasors, s, rows_per_capture, at)
        scores, mags = _exact_bf16_scores(rx, codebook)
        answers = [t.reshape(-1)[at].to(torch.int64) for t in (got, ref)]
        outside += int((~_near_tie(scores, mags, *answers, count_gate=argmax == "dot")).sum())
    return int(diff.numel()), outside


_NEURAL_ARGMAX = {"loop": 0, "dot": 1}
_NEURAL_COMPACTION = ("loop", "stack")


def neural_extract_batch(
    x2d: torch.Tensor,
    codebook: torch.Tensor,
    phasors: torch.Tensor,
    s: torch.Tensor,
    rows_per_capture: int,
    bf16: bool = False,
    compaction: str = "loop",
    argmax: str = "loop",
) -> torch.Tensor:
    """Whole-batch NEURAL symbol extraction at chip length 2 (8 symbols of
    16 samples per 128-sample row): downconversion, chips, unrotation,
    codebook scores and argmax in one launch, the uint8 symbols its only
    output.

    Args:
      x2d: (B*r3, 128) float32 or int16 capture rows (integers cast
        unscaled), any r3 >= 1.
      codebook: (256, 16) float32 codebook ``[I 0..7 | Q 0..7]`` (the JAX
        kernel takes its block-diagonal expansion and a chip table instead).
      phasors: (B, 2) float32 per-capture unit channel phasor (a, b).
      s: (B,) int32 in-row sample offset k0 % 128 (taken mod 128).
      bf16: the JAX kernel's bfloat16 operands: the samples are rounded to
        bfloat16 before the chip means, and the unrotated chips and the
        codebook before the scores; every product is then exact and the
        sums are float32 (the unrotation is float32 throughout). On the card
        a kernel of its own scores on the tensor cores, which sum a score's
        16 products in their own order: its symbols may part from the plain
        version's only where two codewords' exact scores lie within
        rounding of each other (:func:`neural_bf16_mismatches`).
      compaction: "loop" or "stack", the JAX kernel's two ways of packing
        the symbol lanes into output tiles, documented there as bit-exact
        to each other (pallas_kernels.py:1047); the byte output here needs
        neither, so both run the same kernel.
      argmax: "loop", the first maximum, or "dot", the JAX kernel's count
        gate: the index where exactly one codeword holds the maximum, 0
        where several do. The kernel keeps the second maximum beside its
        running maximum in the same pass over the scores; the maximum is
        unique where the two differ.
    Returns (B, r3 * 8) uint8 symbols on the UNROTATED grid, symbol 8j+m from
    row j's slot m; the caller rolls each capture left by (k0 // 128) * 8.

    Contract, pinned by the tests: the successor of each capture's last row
    is the capture's own row 0 (the circular wrap of the JAX package's
    ``_td_extract``; the Pallas kernel reads the next capture's head there,
    garbage by its contract). With ``argmax="loop"`` the rolled stream
    equals the JAX package's XLA extraction symbol for symbol, up to scores
    within rounding of a tie; ``"dot"`` differs from it only on an exact
    tie between distinct codewords (all-zero rows give 0 either way).
    """
    r = rows_per_capture
    _require(x2d.ndim == 2 and x2d.shape[1] == 128 and r >= 1 and x2d.shape[0] % r == 0,
             f"x2d {tuple(x2d.shape)} must be (B*r3, 128) for rows_per_capture={r}")
    _require(x2d.dtype in _NEURAL_DTYPES, f"x2d dtype {x2d.dtype}")
    _require(codebook.dtype == torch.float32 and tuple(codebook.shape) == (256, 16),
             f"codebook {codebook.dtype} {tuple(codebook.shape)}, want float32 (256, 16)")
    _require(argmax in _NEURAL_ARGMAX, f"argmax={argmax!r}: one of {sorted(_NEURAL_ARGMAX)}")
    _require(compaction in _NEURAL_COMPACTION, f"compaction={compaction!r}: one of {_NEURAL_COMPACTION}")
    b = x2d.shape[0] // r
    _require(phasors.dtype == torch.float32 and tuple(phasors.shape) == (b, 2),
             f"phasors {phasors.dtype} {tuple(phasors.shape)}, want float32 ({b}, 2)")
    _check_per_capture("neural_extract_batch", b, s)
    dev = _same_device(x2d, codebook, phasors, s)
    if dev.type == "cpu":
        return neural_extract_batch_plain(x2d, codebook, phasors, s, r, bf16=bf16, argmax=argmax)
    out = torch.empty((b, r * _NEURAL_SPR), dtype=torch.uint8, device=dev)
    _launch("amr_neural_extract", dev, _ptr(x2d), _NEURAL_DTYPES[x2d.dtype], _ptr(codebook), _ptr(phasors),
            _ptr(s), _ptr(out), b, r, int(bool(bf16)), _NEURAL_ARGMAX[argmax])
    _count(neural_extract_batch)
    return out


# --- the MLSE Viterbi of the single-capture FSK receiver ---------------------------

_MLSE_MAX_STATES = 96  # three states a lane of one warp


def _check_viterbi(x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor, aec: torch.Tensor,
                   adv_mark: int, adv_space: int) -> Tuple[int, int, int]:
    """(n_blocks, L, S) of a :func:`mlse_viterbi_blocks` call; raises on
    anything the kernel does not take."""
    _require(x.ndim == 3 and x.shape[1] == 4 and x.shape[2] >= 1, f"mlse_viterbi_blocks: x {tuple(x.shape)}")
    s = cos_t.shape[0] if cos_t.ndim == 1 else -1
    _require(2 <= s <= _MLSE_MAX_STATES, f"mlse_viterbi_blocks: {s} states (2..{_MLSE_MAX_STATES})")
    _require(tuple(sin_t.shape) == (s,) and tuple(aec.shape) == (x.shape[0], 2, s),
             f"mlse_viterbi_blocks: tables {tuple(cos_t.shape)}, {tuple(sin_t.shape)}, {tuple(aec.shape)}")
    _require(all(t.dtype == torch.float32 for t in (x, cos_t, sin_t, aec)), "mlse_viterbi_blocks: float32 only")
    _require(0 <= adv_mark < s and 0 <= adv_space < s, "mlse_viterbi_blocks: phase advances out of range")
    _require(x.shape[0] <= 65535, f"mlse_viterbi_blocks: {x.shape[0]} blocks exceed the kernel grid")
    return x.shape[0], x.shape[2], s


def mlse_viterbi_blocks_plain(
    x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor, aec: torch.Tensor, adv_mark: int, adv_space: int,
) -> torch.Tensor:
    """Plain Viterbi over the CPFSK phase trellis, batched over blocks, one
    Python step at a time (the JAX package's ``step`` and ``back`` scans).

    ``x`` (n_blocks, 4, L): each step's θ-corrected correlations [S_m, C_m,
    S_s, C_s]; ``cos_t``/``sin_t`` (S,) the state phases; ``aec``
    (n_blocks, 2, S) the hypothesis energies times â/2 of each block's
    capture, rows [mark, space]. From pm = 0,
    each step takes for state s the better of its predecessors
    p1 = s - adv_mark (bit 1) and p0 = s - adv_space (bit 0), mod S, with
    ``m = (S·cos_t + C·sin_t) - aec``, ``cand = pm[p] + m[p]``, bit 1
    only where cand1 > cand0, then subtracts the step's maximum. The
    traceback starts at the first maximum of the final metrics. Returns
    (n_blocks, L) uint8 bits."""
    nb, _, L = x.shape
    S = cos_t.shape[0]
    idx = torch.arange(S, device=x.device)
    p1, p0 = (idx - adv_mark) % S, (idx - adv_space) % S
    xt = x.permute(2, 0, 1)[..., None]  # (L, nb, 4, 1)
    m1 = (xt[:, :, 0] * cos_t + xt[:, :, 1] * sin_t - aec[:, 0])[..., p1]  # (L, nb, S) at each predecessor
    m0 = (xt[:, :, 2] * cos_t + xt[:, :, 3] * sin_t - aec[:, 1])[..., p0]
    pm = torch.zeros((nb, S), dtype=torch.float32, device=x.device)
    take = torch.empty((L, nb, S), dtype=torch.bool, device=x.device)
    for t in range(L):
        cand1 = pm[:, p1] + m1[t]
        cand0 = pm[:, p0] + m0[t]
        torch.gt(cand1, cand0, out=take[t])
        pm = torch.where(take[t], cand1, cand0)
        pm = pm - pm.max(dim=1, keepdim=True).values
    state = torch.argmax(pm, dim=1)
    rows = torch.arange(nb, device=x.device)
    bits = torch.empty((nb, L), dtype=torch.uint8, device=x.device)
    for t in range(L - 1, -1, -1):
        bit = take[t, rows, state]
        bits[:, t] = bit
        state = torch.where(bit, (state - adv_mark) % S, (state - adv_space) % S)
    return bits


def mlse_viterbi_blocks(
    x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor, aec: torch.Tensor, adv_mark: int, adv_space: int,
) -> torch.Tensor:
    """The Viterbi of :func:`mlse_viterbi_blocks_plain` for every block in
    one launch (one warp a block, ``csrc/mlse_viterbi.cu``; the blocks may
    come from several captures, each with its own ``aec`` rows): (n_blocks,
    4, L) float32 -> (n_blocks, L) uint8 bits, equal to the plain version's
    bit for bit. The survivors, one ballot word per 32 states a step, and
    the traceback's guessed states, one byte a step, live in a scratch of
    n_blocks * ceil(L/32) * (32 * ceil(S/32) + 8) * 4 bytes."""
    nb, L, S = _check_viterbi(x, cos_t, sin_t, aec, adv_mark, adv_space)
    dev = _same_device(x, cos_t, sin_t, aec)
    if dev.type == "cpu":
        return mlse_viterbi_blocks_plain(x, cos_t, sin_t, aec, adv_mark, adv_space)
    surv = torch.empty((nb, -(-L // 32) * (32 * -(-S // 32) + 8)), dtype=torch.int32, device=dev)
    out = torch.empty((nb, L), dtype=torch.uint8, device=dev)
    _launch("amr_mlse_viterbi", dev, _ptr(x), _ptr(cos_t), _ptr(sin_t), _ptr(aec), S, adv_mark, adv_space,
            _ptr(surv), _ptr(out), nb, L)
    _count(mlse_viterbi_blocks)
    return out


# --- the Viterbi decoder of the K = 7, rate-1/2 convolutional code ----------------

@functools.lru_cache(maxsize=None)
def _fec_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(p0, p1, code0, code1)`` on ``device``: new state s's predecessors
    s >> 1 and (s >> 1) | 32 (``fec._trellis_tables``), and the expected
    output pair of each transition as a code 2 e0 + e1."""
    from ..fec import _trellis_tables

    p0, p1, exp0, exp1 = _trellis_tables()
    codes = [(2 * e[:, 0] + e[:, 1]).astype(np.int64) for e in (exp0, exp1)]
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device) for a in (p0, p1, *codes))


def fec_viterbi_blocks_plain(pairs: torch.Tensor, known_boundaries: bool) -> torch.Tensor:
    """Plain Viterbi decoder of the K = 7, rate-1/2 code, batched over
    blocks, one Python step at a time (the JAX package's ``step`` and
    ``back`` scans of ``fec._viterbi_block``).

    ``pairs`` (n_blocks, L, 2) float32, hard bits or soft values. The branch
    metric of a transition is |r0 - e0| + |r1 - e1| against its expected
    output pair; each step takes ``cand = pm[p] + bm`` for the predecessors
    p0 = s >> 1 and p1 = (s >> 1) | 32 of new state s, keeps p1 only where
    cand1 < cand0, and subtracts the step's minimum. With
    ``known_boundaries`` (the encoder starts and ends in state 0) the
    metrics start at 0 for state 0 and 1e9 for the others and the traceback
    starts at state 0; without, the metrics start at 0 and the traceback
    starts at the first state holding the final minimum. Returns (n_blocks,
    L) uint8 bits."""
    nb, L, _ = pairs.shape
    dev = pairs.device
    p0, p1, code0, code1 = _fec_tables(dev)
    r0, r1 = pairs[..., 0], pairs[..., 1]
    # The four branch metrics a step, by code 2 e0 + e1, then each state's
    # two: (L, nb, 64) each.
    m4 = torch.stack([(r0 - e0).abs() + (r1 - e1).abs() for e0 in (0.0, 1.0) for e1 in (0.0, 1.0)], -1)
    m4 = m4.transpose(0, 1)
    bm0, bm1 = m4[..., code0].contiguous(), m4[..., code1].contiguous()
    pm = torch.zeros((nb, 64), dtype=torch.float32, device=dev)
    if known_boundaries:
        pm[:, 1:] = 1e9
    take = torch.empty((L, nb, 64), dtype=torch.bool, device=dev)
    for t in range(L):
        cand0 = torch.index_select(pm, 1, p0).add_(bm0[t])
        cand1 = torch.index_select(pm, 1, p1).add_(bm1[t])
        torch.lt(cand1, cand0, out=take[t])
        pm = torch.where(take[t], cand1, cand0)
        pm.sub_(pm.amin(dim=1, keepdim=True))
    if known_boundaries:
        state = torch.zeros(nb, dtype=torch.int64, device=dev)
    else:
        state = torch.argmin(pm, dim=1)  # the first minimum
    rows = torch.arange(nb, device=dev)
    states = torch.empty((L, nb), dtype=torch.int64, device=dev)
    for t in range(L - 1, -1, -1):
        states[t] = state
        state = torch.where(take[t, rows, state], (state >> 1) | 32, state >> 1)
    return (states & 1).to(torch.uint8).T.contiguous()  # each step's input bit


def fec_viterbi_blocks(pairs: torch.Tensor, known_boundaries: bool) -> torch.Tensor:
    """The decoder of :func:`fec_viterbi_blocks_plain` for every block in
    one launch (one warp a block, ``csrc/fec_viterbi.cu``): (n_blocks, L, 2)
    float32 finite pairs -> (n_blocks, L) uint8 bits, equal to the plain
    version's bit for bit. The survivors, two ballot words a step, and the
    traceback's guessed state at each 32-step stage live in a scratch of
    n_blocks * ceil(L/32) * 260 bytes."""
    _require(pairs.ndim == 3 and pairs.shape[2] == 2 and pairs.shape[1] >= 1,
             f"fec_viterbi_blocks: pairs {tuple(pairs.shape)}, want (n_blocks, L, 2)")
    _require(pairs.dtype == torch.float32, f"fec_viterbi_blocks: pairs {pairs.dtype}, want float32")
    nb, L, _ = pairs.shape
    dev = _same_device(pairs)
    if dev.type == "cpu":
        return fec_viterbi_blocks_plain(pairs, known_boundaries)
    _require(pairs.data_ptr() % 8 == 0, "fec_viterbi_blocks: the kernel reads 8-byte pairs; the tensor must "
             "start on an 8-byte boundary")
    surv = torch.empty((nb, -(-L // 32) * 65), dtype=torch.int32, device=dev)
    out = torch.empty((nb, L), dtype=torch.uint8, device=dev)
    _launch("amr_fec_viterbi", dev, _ptr(pairs), int(bool(known_boundaries)), _ptr(surv), _ptr(out), nb, L)
    _count(fec_viterbi_blocks)
    return out


# --- the batched FSK sync tail: first exact magic + pack (no Pallas counterpart) ----

def fsk_sync_pack_batch_plain(bits: torch.Tensor, pattern: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batched FSK sync tail as the JAX package runs it in XLA:
    :func:`ops.common.find_bit_pattern`, then :func:`ops.common.pack_bits_from`
    (one host read of the starts)."""
    start, found = find_bit_pattern(bits, pattern)
    packed, n_valid = pack_bits_from(bits, start)
    return packed, n_valid, found


def fsk_sync_pack_batch(bits: torch.Tensor, pattern: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, n) uint8 0/1 bits -> (packed (B, ceil(n/1024)*128) uint8, n_valid
    (B,) int32, found (B,) bool): each row packed MSB first from the first
    exact ``pattern`` (at most 32 bits), or from 0 where it is absent, as
    :func:`fsk_sync_pack_batch_plain` computes them, bit for bit. On the card
    ``csrc/fsk_sync.cu``: a scan that posts each row's first match to a
    device slot, then a pack that reads it there; no host read. ``bits``
    must be contiguous, and on the card start on a 16-byte boundary."""
    _require(bits.ndim == 2 and bits.dtype == torch.uint8,
             f"fsk_sync_pack_batch: bits {bits.dtype} {tuple(bits.shape)}, want uint8 (B, n)")
    _require(bits.is_contiguous(), "fsk_sync_pack_batch: bits must be contiguous")
    _require(0 < len(pattern) <= 32 and set(pattern) <= {"0", "1"},
             f"fsk_sync_pack_batch: pattern {pattern!r}, want 1 to 32 bits")
    dev = _same_device(bits)
    if dev.type == "cpu":
        return fsk_sync_pack_batch_plain(bits, pattern)
    b, n = bits.shape
    _require(1 <= b <= _MAX_CAPTURES, f"fsk_sync_pack_batch: {b} captures, want 1 to {_MAX_CAPTURES}")
    _require_aligned("fsk_sync_pack_batch", bits)
    stream = _raw_stream(dev)
    first = torch.full((b,), n - len(pattern) + 1, dtype=torch.int32, device=dev)
    packed = torch.empty((b, -(-n // 1024) * 128), dtype=torch.uint8, device=dev)
    n_valid = torch.empty(b, dtype=torch.int32, device=dev)
    found = torch.empty(b, dtype=torch.bool, device=dev)
    word = int(pattern[::-1], 2)  # bit t is pattern[t]
    _launch("amr_fsk_first", dev, _ptr(bits), b, n, word, len(pattern), _ptr(first), stream=stream)
    _launch("amr_fsk_pack", dev, _ptr(bits), b, n, len(pattern), _ptr(first), _ptr(packed), _ptr(n_valid),
            _ptr(found), stream=stream)
    _count(fsk_sync_pack_batch)
    return packed, n_valid, found


KERNELS = (
    psk_project_decide_batch, rotation_match_batch, relabel_pack_batch,
    bit_select_pack_batch, sector_match_batch, psk8_relabel_pack_rows,
    fsk_tile_bits_batch, fsk_project_bits_batch, fsk_disc_sums_batch, fsk_quad_margin_batch,
    psk_project_diff, psk_project_diff_batch, neural_extract_batch, mlse_viterbi_blocks,
    fec_viterbi_blocks, fsk_sync_pack_batch, fsk_disc_decide_batch, psk_pass1_batch,
)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
