"""The DQPSK slice's kernels: wrappers, plain PyTorch versions, launch counts.

Counterpart of ``audio_modem_radio_tpu/ops/pallas_kernels.py`` for the three
kernels the batched DQPSK receive runs, with the JAX names and argument
order:

* K1 :func:`psk_project_decide_batch` (``csrc/decide.cu``),
* K2 :func:`rotation_match_batch` (``csrc/rotmatch.cu``),
* K3 :func:`relabel_pack_batch` (``csrc/relabel_pack.cu``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. For tensors on the CPU it runs the plain version
beside it; for CUDA tensors it launches the hand-written kernel on the
current stream (there is no fallback), checks the launch's error code and
adds one to its ``launches`` attribute.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_BLOCK_SYM = 128  # symbols per lane row (matches ops.psk)
_BIG = 1 << 30  # "no match" sentinel of the rotation matcher
_DECIDE_DTYPES = {torch.float32: 0, torch.int16: 1, torch.int8: 2}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    _require(all(t.device == dev for t in ts), f"tensors on {[str(t.device) for t in ts]}")
    _require(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``dev``'s current stream; raise on a
    nonzero cudaError_t (a refused launch never runs and a later
    synchronize would not report it)."""
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _ptr(t: torch.Tensor) -> int:
    _require(t.is_contiguous(), "kernel operands must be contiguous")
    return t.data_ptr()


# --- K1: projection + differential + derotation + Gray decision ----------------

def psk_project_decide_batch_plain(
    x3d: torch.Tensor, w_all: torch.Tensor, best: torch.Tensor, rot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: the dense blocked projection of ``ops/psk.py
    _blocked_project_xla`` (the next-row overlap of each capture's last row
    is zero), the differential with the successor symbol (zero past the
    capture's end), derotation by (cos θ, sin θ) and the Gray decision."""
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
    d_re = re1 * re + im1 * im
    d_im = im1 * re - re1 * im
    c, s = rot[:, 0:1], rot[:, 1:2]
    dr = d_re * c + d_im * s
    di = d_im * c - d_re * s
    swap = torch.abs(di) > torch.abs(dr)
    neg = torch.where(swap, di, dr) < 0
    hi = neg.to(torch.uint8).reshape(b, r, _BLOCK_SYM)
    lo = (neg ^ swap).to(torch.uint8).reshape(b, r, _BLOCK_SYM)
    return hi, lo


def psk_project_decide_batch(
    x3d: torch.Tensor,
    w_all: torch.Tensor,
    best: torch.Tensor,
    rot: torch.Tensor,
    rows_per_capture: int,
    n_psk: int = 4,
    block_rows: int = 256,
    variant: str = "roll",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-batch projection + differential + derotation + decision.

    Args:
      x3d: (B, R, 128*spsym) float32, int16 or int8 sample rows.
      w_all: (n_offsets, 128*spsym + OV, 256) float32 blocked templates
        (``ops.psk._blocked_templates``). The kernel reads only the
        (2*spsym, 2) dual basis each offset's block-diagonal repeats.
      best: (B,) int32 winning timing offset per capture.
      rot: (B, 2) float32 per-capture (cos θ, sin θ).
    Returns uint8 (hi, lo) of shape (B, R, 128); entries past the modulated
    span are garbage by contract.
    """
    _require(x3d.ndim == 3, f"x3d must be (B, R, row), got {tuple(x3d.shape)}")
    b, r, row = x3d.shape
    _require(r == rows_per_capture and r % block_rows == 0 and r % 2 == 0,
             f"rows {r} vs rows_per_capture={rows_per_capture}, block_rows={block_rows}")
    if n_psk != 4 or variant != "roll":
        raise NotImplementedError(f"n_psk={n_psk}, variant={variant!r}: only DQPSK 'roll' is ported")
    spsym = row // _BLOCK_SYM
    _require(row % _BLOCK_SYM == 0 and 1 <= spsym <= 32, f"row width {row}")
    _require(x3d.dtype in _DECIDE_DTYPES, f"x3d dtype {x3d.dtype}")
    _require(w_all.dtype == torch.float32 and w_all.ndim == 3
             and w_all.shape[1] >= row + 2 * spsym and w_all.shape[2] == 2 * _BLOCK_SYM,
             f"w_all {w_all.dtype} {tuple(w_all.shape)}")
    _require(best.dtype == torch.int32 and tuple(best.shape) == (b,), f"best {best.dtype} {tuple(best.shape)}")
    _require(rot.dtype == torch.float32 and tuple(rot.shape) == (b, 2), f"rot {rot.dtype} {tuple(rot.shape)}")
    dev = _same_device(x3d, w_all, best, rot)
    if dev.type == "cpu":
        return psk_project_decide_batch_plain(x3d, w_all, best, rot)

    tmpl = torch.stack(
        [w_all[:, : 2 * spsym, 0], w_all[:, : 2 * spsym, _BLOCK_SYM]], dim=-1
    ).contiguous()  # (n_offsets, 2*spsym, 2)
    hi = torch.empty((b, r, _BLOCK_SYM), dtype=torch.uint8, device=dev)
    lo = torch.empty_like(hi)
    _launch("amr_decide_qpsk", dev, _ptr(x3d), _DECIDE_DTYPES[x3d.dtype], _ptr(tmpl),
            _ptr(best), _ptr(rot), _ptr(hi), _ptr(lo), b, r, spsym)
    psk_project_decide_batch.launches += 1
    return hi, lo


# --- K2: rotation x parity magic match ------------------------------------------

def rotation_match_conditions(pattern: str):
    """All 8 (rotation x bit-parity) magic hypotheses as uniform conditions.

    Under a residual CFO rotation k·π/2 the received Gray dibit relabels as
    (hi', lo') = k=0:(hi,lo) k=1:(~lo,hi) k=2:(~hi,~lo) k=3:(lo,~hi); matching
    the pattern in the relabeled stream at even/odd bit offsets therefore
    reduces, for every hypothesis, to an AND of 16 conditions of the single
    form ``(hi|lo)[t+offset] == bit``. Returns ``cond[h] = tuple of
    (is_hi, offset, bitval)`` for h = 4*parity + k, plus the max offset.
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


@functools.lru_cache(maxsize=8)
def _condition_masks(conds, n_exact: int, device: torch.device) -> torch.Tensor:
    """(n_hyp, 8) int32 device table: per hypothesis [hi mask, hi value, lo
    mask, lo value] of the exact part, then of the tolerant part, with bit j
    standing for window offset j. A hypothesis is then
    ``popc((window ^ value) & mask)`` per stream and part."""
    rows = []
    for c in conds:
        m = [0] * 8
        for idx, (is_hi, off, bit) in enumerate(c):
            base = (0 if idx < n_exact else 4) + (0 if is_hi else 2)
            _require(0 <= off <= 16, f"condition offset {off} outside the 17-dibit window")
            _require(not m[base] >> off & 1, "a condition set repeats a (stream, offset)")
            m[base] |= 1 << off
            m[base + 1] |= bit << off
        rows.append(m)
    return torch.tensor(rows, dtype=torch.int32, device=device)


def rotation_match_batch_plain(
    hi: torch.Tensor, lo: torch.Tensor, conds, n_exact: int, tol: int, rows_scanned: int
) -> torch.Tensor:
    """Plain K2: the vectorised condition sweep over the first
    ``rows_scanned`` rows (zeros past them). Returns (B, n_hyp) int32 first
    positions, 2^30 where none matched (before the limit epilogue)."""
    b = hi.shape[0]
    n = rows_scanned * _BLOCK_SYM
    max_off = max(off for c in conds for (_s, off, _b) in c)
    h = F.pad(hi[:, :rows_scanned].reshape(b, n), (0, max_off))
    l = F.pad(lo[:, :rows_scanned].reshape(b, n), (0, max_off))
    pos = torch.arange(n, dtype=torch.int32, device=hi.device)
    firsts = []
    for c in conds:
        acc1 = torch.zeros((b, n), dtype=torch.uint8, device=hi.device)
        acc2 = torch.zeros_like(acc1)
        for idx, (is_hi, off, bit) in enumerate(c):
            miss = (h if is_hi else l)[:, off : off + n] ^ bit
            if idx < n_exact:
                acc1 += miss
            else:
                acc2 += miss
        good = (acc1 == 0) & (acc2 <= tol)
        firsts.append(torch.where(good, pos, _BIG).amin(dim=1))
    return torch.stack(firsts, dim=1).to(torch.int32)


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
    """(B, R, 128) uint8 Gray lanes -> per-capture (first_pos, found), shape
    (B, 8), for every rotation x parity hypothesis (positions in dibits).

    ``rows_scanned`` (default R) limits the scan to each capture's first
    rows without a copy; the end-of-scan limit follows it exactly as the JAX
    call with ``rows_per_capture=rows_scanned`` does.
    """
    if family != "qpsk":
        raise NotImplementedError(f"family={family!r}: only 'qpsk' is ported (ROADMAP.md: BPSK)")
    _require(hi.ndim == 3 and hi.shape == lo.shape, f"hi {tuple(hi.shape)} lo {tuple(lo.shape)}")
    b, r, w = hi.shape
    _require(w == _BLOCK_SYM and r == rows_per_capture and r % block_rows == 0,
             f"bad shapes {tuple(hi.shape)} for rows_per_capture={rows_per_capture}")
    _require(hi.dtype == torch.uint8 and lo.dtype == torch.uint8, f"dtypes {hi.dtype} {lo.dtype}")
    p = r if rows_scanned is None else int(rows_scanned)
    _require(0 < p <= r and p % block_rows == 0, f"rows_scanned={p} for R={r}")
    _require(b <= 65535, f"{b} captures exceed the kernel grid")
    conds, n_pat = rotation_match_conditions(pattern + pattern2)
    n_exact = len(pattern)
    dev = _same_device(hi, lo)
    if dev.type == "cpu":
        first = rotation_match_batch_plain(hi, lo, conds, n_exact, tol, p)
    else:
        masks = _condition_masks(conds, n_exact, dev)
        first = torch.empty((b, len(conds)), dtype=torch.int32, device=dev)
        _launch("amr_rotation_match", dev, _ptr(hi), _ptr(lo), _ptr(masks), len(conds), tol,
                n_pat, _ptr(first), b, r, p)
        rotation_match_batch.launches += 1
    # Windows starting in the last n_pat+1 entries of the scan can reach
    # past it; the matcher accepts only L = m - (n_pat+1) positions.
    limit = p * _BLOCK_SYM - (n_pat + 1)
    found = (first < _BIG) & (first < limit)
    return torch.where(found, first, 0), found


# --- K3: inverse-Gray relabel + mod-8 alignment + byte pack ---------------------

def relabel_pack_batch_plain(
    hi3: torch.Tensor, lo3: torch.Tensor, s: torch.Tensor, ksel: torch.Tensor
) -> torch.Tensor:
    """Plain K3 in integer ops: relabel each dibit by ``ksel``, interleave
    (rh, rl) into the flat bit stream, shift it by ``s & 7`` bits (zeros
    past the capture's end) and pack MSB-first."""
    b, r, _ = hi3.shape
    h = hi3.reshape(b, -1).to(torch.int32)
    l = lo3.reshape(b, -1).to(torch.int32)
    s2 = (2 * h + (h ^ l) + 4 - ksel.to(torch.int32)[:, None]) & 3
    rh = s2 >= 2
    rl = (s2 == 1) | (s2 == 2)
    bits = torch.stack([rh, rl], dim=2).reshape(b, -1).to(torch.uint8)
    n_bits = bits.shape[1]
    bits = F.pad(bits, (0, 8))
    idx = (s.to(torch.int64) & 7)[:, None] + torch.arange(n_bits, device=bits.device)
    shifted = torch.gather(bits, 1, idx).reshape(b, -1, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    return (shifted * weights).sum(dim=2).to(torch.uint8)


def relabel_pack_batch(
    hi3: torch.Tensor,
    lo3: torch.Tensor,
    s: torch.Tensor,
    ksel: torch.Tensor,
    rows_per_capture: int,
    block_rows: int = 256,
    variant: str = "weights",
) -> torch.Tensor:
    """Whole-batch rotation relabel + byte pack: (B, R, 128) uint8 lanes ->
    (B, R*32) uint8. The stream is aligned only mod 8 bits: the frame starts
    at byte ``s // 8``, which the frame parser's magic scan absorbs. The last
    byte of each capture is garbage by contract."""
    if variant != "weights":
        raise NotImplementedError(f"variant={variant!r}: only 'weights' is ported")
    _require(hi3.ndim == 3 and hi3.shape == lo3.shape, f"hi3 {tuple(hi3.shape)} lo3 {tuple(lo3.shape)}")
    b, r, w = hi3.shape
    _require(w == _BLOCK_SYM and r == rows_per_capture and r % block_rows == 0,
             f"bad shapes {tuple(hi3.shape)} for rows_per_capture={rows_per_capture}")
    _require(hi3.dtype == torch.uint8 and lo3.dtype == torch.uint8, f"dtypes {hi3.dtype} {lo3.dtype}")
    _require(s.dtype == torch.int32 and ksel.dtype == torch.int32
             and tuple(s.shape) == (b,) and tuple(ksel.shape) == (b,),
             f"s {s.dtype} {tuple(s.shape)}, ksel {ksel.dtype} {tuple(ksel.shape)}")
    _require(b <= 65535, f"{b} captures exceed the kernel grid")
    dev = _same_device(hi3, lo3, s, ksel)
    if dev.type == "cpu":
        return relabel_pack_batch_plain(hi3, lo3, s, ksel)
    out = torch.empty((b, r * 32), dtype=torch.uint8, device=dev)
    _launch("amr_relabel_pack", dev, _ptr(hi3), _ptr(lo3), _ptr(s), _ptr(ksel), _ptr(out), b, r)
    relabel_pack_batch.launches += 1
    return out


KERNELS = (psk_project_decide_batch, rotation_match_batch, relabel_pack_batch)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
