"""Direct-sequence spread spectrum (DSSS) over DBPSK, on PyTorch.

Counterpart of ``audio_modem_radio_tpu/ops/dsss.py``. Each differentially
encoded data bit is spread over a 16-chip PN sequence at the mode's chip
rate; the receiver sums the chip phasors coherently per bit before the
differential (about 12 dB of processing gain).

* The chip front end is the DBPSK one at raw phasors: one capture through
  ``ops.psk.psk_symbol_streams``, a batch through
  ``ops.psk.psk_raw_streams_batch`` (pass 1, then one ``torch.bmm`` at each
  capture's winning offset). The JAX package runs no Pallas kernel here.
* Despreading: one (n_bits, 16) @ (16,) product per chip alignment for one
  capture, one overlapped-window product against the banded PN template
  for a batch; the alignment with the highest 4-fold coherence of the bit
  differentials wins (the first maximum).
* The byte tail is the DBPSK rotation sync (``ops.common``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
from ..utils.torchenv import DeviceLike
from .common import bit_sync_and_pack_rotations, bytes_to_bits, find_bit_pattern_validated, pack_bits_from
from .psk import (
    BPSK_PREAMBLE_BITS,
    _coherence_score,
    _differential,
    _samples_per_symbol,
    _sign_bits,
    _stream_bytes,
    _synthesize,
    _to_device,
    bpsk_tracked_bits,
    derotate,
    estimate_common_rotation,
    psk_raw_streams_batch,
    psk_symbol_streams,
)

# 16-chip PN sequence: the x^4 + x + 1 m-sequence (15 chips) with its last
# chip repeated. 0/1 chips; a 1 chip is phase π (sign -1).
SPREAD = 16
_PN_BITS = np.array([1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0], np.uint8)
_PN_SIGN = (1.0 - 2.0 * _PN_BITS).astype(np.float32)


def dsss_real_modulate(
    data_bytes: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """DSSS-DBPSK: differential data bits spread over the 16-chip PN.
    ``baud`` is the chip rate; chip phase = diff_bit XOR pn_chip, a half
    turn per 1."""
    bits = np.concatenate(
        [np.asarray(BPSK_PREAMBLE_BITS, np.uint8), bytes_to_bits(data_bytes)]
    ).astype(np.int64)
    diff = np.cumsum(bits) % 2
    chips = diff[:, None] ^ _PN_BITS[None, :].astype(np.int64)  # (n_bits, 16)
    phase_qt = (chips.reshape(-1) * 2).astype(np.int64)
    spchip = _samples_per_symbol(samp_rate, baud)
    return _synthesize(phase_qt, spchip, float(carrier), int(samp_rate)).numpy()


def _despread_all(re_f: torch.Tensor, im_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capture's chip phasors -> (16, n_bits) despread bit phasors, one
    row per chip alignment. The stream is zero-padded by 16 chips so every
    alignment despreads all of it (alignment a's last group holds pad)."""
    n_bits = re_f.shape[0] // SPREAD
    re_p, im_p = F.pad(re_f, (0, SPREAD)), F.pad(im_f, (0, SPREAD))
    pn = torch.from_numpy(_PN_SIGN).to(re_f.device)
    rows_re = [re_p[a : a + n_bits * SPREAD].reshape(n_bits, SPREAD) @ pn for a in range(SPREAD)]
    rows_im = [im_p[a : a + n_bits * SPREAD].reshape(n_bits, SPREAD) @ pn for a in range(SPREAD)]
    return torch.stack(rows_re), torch.stack(rows_im)


def _dsss_best_raw(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int):
    """``(b_re, b_im, a)``: the despread raw bit phasors at the chip
    alignment ``a`` whose bit differentials are the most 4-fold coherent."""
    re_f, im_f, _score = psk_symbol_streams(samples, baud, carrier, sample_rate, n_psk=2)
    b_re, b_im = _despread_all(re_f, im_f)
    a = torch.argmax(_coherence_score(*_differential(b_re, b_im), 1))
    return b_re[a], b_im[a], a


def _dsss_best_diff(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int):
    """The despread bit differentials ``(dr, di)`` at the best alignment,
    blind-derotated: the data rides the real axis (bit = dr < 0). Shared by
    the sync tail, the no-sync rescue and the soft bits."""
    br, bi, _a = _dsss_best_raw(samples, baud, carrier, sample_rate)
    dr, di = _differential(br, bi)
    return derotate(dr, di, estimate_common_rotation(dr, di))


def dsss_real_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                         device: DeviceLike = None) -> bytes:
    """DSSS receive chain on ``device``: chips -> despread bits -> the DBPSK
    rotation sync -> bytes."""
    dr, di = _dsss_best_diff(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    packed, n_valid, _found = bit_sync_and_pack_rotations(_sign_bits(dr), _sign_bits(di), MAGIC_BIT_PATTERN,
                                                          MAGIC_BIT_PATTERN2)
    return _stream_bytes(packed, n_valid)


def dsss_tracked_demodulate(samples, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000,
                            window: int = 128, device: DeviceLike = None) -> bytes:
    """Coherent-tracked DSSS receive, the mode ladder's escalation: the z²
    Viterbi&Viterbi track on the despread raw bit phasors, absolute
    antipodal decisions XOR-differenced, one validated pattern find."""
    br, bi, _a = _dsss_best_raw(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    bits = bpsk_tracked_bits(br, bi, int(window))
    start, _found = find_bit_pattern_validated(bits, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    packed, n_valid = pack_bits_from(bits[None], start.reshape(1))
    return _stream_bytes(packed[0], n_valid[0])


@functools.lru_cache(maxsize=1)
def _despread_band() -> np.ndarray:
    """(2*SPREAD-1, SPREAD) banded despread template: column a holds the PN
    signs shifted down by a, so the 31-chip window of bit j times it gives
    bit j's despread phasor at every alignment."""
    T = np.zeros((2 * SPREAD - 1, SPREAD), np.float32)
    for a in range(SPREAD):
        T[a : a + SPREAD, a] = _PN_SIGN
    return T


def _despread_all_batch(x: torch.Tensor) -> torch.Tensor:
    """(B, n) chip phasors -> (B, 16, n // 16) despread rows, one per chip
    alignment, by one overlapped-window product against the banded
    template; alignment a's group j sums chips [16j+a, 16j+a+16), chips past
    the capture reading zero, as :func:`_despread_all`. Fewer chips than
    one group give no bits."""
    b, n = x.shape
    nb = n // SPREAD
    if nb == 0:
        return x.new_zeros((b, SPREAD, 0))
    rows = x[:, : nb * SPREAD].reshape(b, nb, SPREAD)
    tail = F.pad(x[:, nb * SPREAD :], (0, SPREAD - 1 - (n - nb * SPREAD)))  # the remainder chips, then zeros
    nxt = torch.cat([rows[:, 1:, : SPREAD - 1], tail[:, None, :]], dim=1)
    wins = torch.cat([rows, nxt], dim=2)  # (B, nb, 31)
    out = wins @ torch.from_numpy(_despread_band()).to(x.device)  # (B, nb, 16)
    return out.transpose(1, 2)


def dsss_bits_cfo_batch(samples: torch.Tensor, baud: float, carrier: float, sample_rate: int,
                        pattern: str, pattern2: str = ""):
    """Batched DSSS receive: (B, N) captures or pre-shaped (B, r,
    128*spchip) float32 rows -> ``(packed (B, max_bytes), n_valid (B,),
    found (B,))`` on the input's device. The raw chip front end, the banded
    despread, the alignment select and derotation for the batch, then the
    DBPSK rotation sync per capture on the bit-rate stream."""
    re_f, im_f = psk_raw_streams_batch(samples, baud, carrier, sample_rate, n_psk=2)
    d_re, d_im = _differential(_despread_all_batch(re_f), _despread_all_batch(im_f))  # (B, 16, nb-1)
    a = torch.argmax(_coherence_score(d_re, d_im, 2), dim=1)  # (B,)
    idx = a[:, None, None].expand(-1, 1, d_re.shape[2])
    dr, di = torch.gather(d_re, 1, idx)[:, 0], torch.gather(d_im, 1, idx)[:, 0]
    dr, di = derotate(dr, di, estimate_common_rotation(dr, di))
    out = [bit_sync_and_pack_rotations(br, bi, pattern, pattern2) for br, bi in zip(_sign_bits(dr), _sign_bits(di))]
    return tuple(torch.stack([o[j] for o in out]) for j in range(3))


def dsss_nosync_streams(samples, baud: float, carrier: float, samp_rate: int, device: DeviceLike = None) -> list:
    """The no-sync rescue front: the best-alignment despread bit streams (re
    and im signs, derotated), each packed from offset 0, as byte streams."""
    dr, di = _dsss_best_diff(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    zero = torch.zeros(1, dtype=torch.int32, device=dr.device)
    out = []
    for comp in (dr, di):
        packed, n_valid = pack_bits_from(_sign_bits(comp)[None], zero)
        out.append(_stream_bytes(packed[0], n_valid[0]))
    return out


def dsss_soft_bits(samples, baud: float, carrier: float, samp_rate: int, device: DeviceLike = None) -> np.ndarray:
    """Soft bit stream in [0, 1] for the soft-decision FEC escalations: a
    linear scaling of the derotated despread differential's real part (the
    inversion ambiguity is the consumer's two-hypothesis sweep)."""
    dr, di = _dsss_best_diff(_to_device(samples, device), float(baud), float(carrier), int(samp_rate))
    dr, di = dr.cpu().numpy(), di.cpu().numpy()
    scale = np.mean(np.abs(dr) + np.abs(di)) + 1e-9
    return np.clip(0.5 - dr / scale, 0.0, 1.0).astype(np.float32)
