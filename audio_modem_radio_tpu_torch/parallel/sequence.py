"""Sequence parallelism: one long capture with its sample axis sharded.

Counterpart of ``audio_modem_radio_tpu/parallel/sequence.py``. Data
parallelism covers many captures; this module covers one capture too long
for one device. The capture is padded and split contiguously over the
mesh's devices, each shard demodulates its own samples, and the cross-shard
couplings are explicit collectives over the shards' tensors
(``parallel.mesh``):

* **halo exchange**: a shard's last row needs the head of the next shard
  (the projection window and the differential cross the boundary), so
  :func:`~.mesh.ppermute` moves each shard's head to its left neighbour,
  circularly (the last shard reads shard 0's head, as ``lax.ppermute``
  with ``(i, (i-1) % n)`` gives);
* **global timing consensus**: every shard scores the timing offsets on
  its own rows, :func:`~.mesh.psum` adds the scores and every shard
  projects at the one winning offset (a shard of leading silence must not
  pick its own).

The demodulators return the logically global streams: the shards' outputs
in order, on the mesh's first device, where the sync and pack tails run.
The sums of the consensus run in shard order, which need not be the JAX
package's, so two offsets whose float32 scores tie may resolve apart.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops.fsk import _fsk_blocked_templates, _fsk_geometry, _samples_per_bit, _separation_cycles
from ..ops.psk import (
    _BLOCK_SYM,
    _coherence_parts_pow,
    _device_tables,
    _gram_scale,
    _samples_per_symbol,
    qpsk_gray_streams,
)
from .mesh import DATA_AXIS, Mesh, all_gather, ppermute, psum  # noqa: F401  (DATA_AXIS: re-export)

SAMPLE_RATE = 96000


def _shards(x: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """The padded capture split into ``mesh.size`` equal contiguous shards,
    each on its device."""
    devs = mesh.flat
    t = torch.from_numpy(x)
    return [c.to(d) for c, d in zip(t.chunk(len(devs)), devs)]


def _gather(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' outputs in order, on the first shard's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def _padded(samples: np.ndarray, total: int) -> np.ndarray:
    x = np.zeros(total, dtype=np.float32)
    n = min(len(samples), total)
    x[:n] = np.asarray(samples, np.float32)[:n]
    return x


def _psk_shards(samples, baud, carrier, mesh, n_psk, sample_rate, n_offsets, raw):
    """:func:`demod_capture_sharded`'s per-shard streams and the chosen
    offset."""
    spsym = _samples_per_symbol(sample_rate, baud)
    n_dev = mesh.size
    row = _BLOCK_SYM * spsym
    # Pad so each shard holds a whole number of rows, at least 2, so that
    # the (row+ov)-sample halo head always fits within one shard.
    n = len(samples)
    r_total = max(2 * n_dev, -(-(-(-n // row)) // n_dev) * n_dev)
    r_local = r_total // n_dev
    xs = _shards(_padded(samples, r_total * row), mesh)
    tabs = [_device_tables(spsym, float(carrier), sample_rate, n_offsets, x.device) for x in xs]
    c = tabs[0][0].shape[1]
    ov = c - row

    halos = ppermute([x[: row + ov] for x in xs])
    xovs, parts = [], []
    for x, halo, (_w8, w_all, grams) in zip(xs, halos, tabs):
        xr = x.reshape(r_local, row)
        nxt = torch.cat([xr[1:, :ov], halo[None, :ov]], dim=0)
        xov = torch.cat([xr, nxt], dim=1)  # (r_local, row+ov)
        pa = (xov @ w_all).reshape(r_local, n_offsets, 2, _BLOCK_SYM)
        re_a, im_a = _gram_scale(pa[:, :, 0], pa[:, :, 1], grams, offset_axis=1)
        dr_a = re_a[..., 1:] * re_a[..., :-1] + im_a[..., 1:] * im_a[..., :-1]
        di_a = im_a[..., 1:] * re_a[..., :-1] - re_a[..., 1:] * im_a[..., :-1]
        parts.append(torch.stack(_coherence_parts_pow(dr_a, di_a, (0, 2), n_psk)))  # (2, K)
        xovs.append(xov)
    # psum the complex parts, then the magnitude.
    bests = [torch.argmax(torch.hypot(p[0], p[1])) for p in psum(parts)]

    outs = []
    for xov, halo, best, (w8, _w, _g) in zip(xovs, halos, bests, tabs):
        wb = w8.index_select(0, best.reshape(1))[0]
        out = xov @ wb  # (r_local, 256)
        re = out[:, :_BLOCK_SYM].reshape(-1)
        im = out[:, _BLOCK_SYM:].reshape(-1)
        if raw:
            outs.append((re, im))
            continue
        # The final differential needs the next shard's first symbol: the
        # halo window projected (only its symbol 0 is used).
        nb = halo[None, :] @ wb
        re_ext = torch.cat([re, nb[0, :1]])
        im_ext = torch.cat([im, nb[0, _BLOCK_SYM : _BLOCK_SYM + 1]])
        outs.append((re_ext[1:] * re_ext[:-1] + im_ext[1:] * im_ext[:-1],
                     im_ext[1:] * re_ext[:-1] - re_ext[1:] * im_ext[:-1]))
    return outs, int(bests[0])


def demod_capture_sharded(
    samples: np.ndarray,
    baud: float,
    carrier: float,
    mesh: Mesh,
    n_psk: int = 4,
    sample_rate: int = SAMPLE_RATE,
    n_offsets: int = 8,
    raw: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Demodulate ONE PSK capture with its sample axis sharded over
    ``mesh``: the global differential streams ``(d_re, d_im)``. The capture
    is padded so each shard holds a whole number of 128-symbol rows (at
    least 2). Timing consensus scores at the data-cancelling power for
    ``n_psk`` (8th for D8PSK, else 4th). ``raw=True`` returns the raw
    per-symbol projection phasors instead, the DSSS despreader's front end
    (chips sum coherently per data bit before any differential)."""
    outs, _best = _psk_shards(samples, baud, carrier, mesh, n_psk, sample_rate, n_offsets, raw)
    return _gather([o[0] for o in outs]), _gather([o[1] for o in outs])


def _fsk_shards(samples, baud, mark, space, mesh, sample_rate, n_offsets):
    spb = _samples_per_bit(sample_rate, baud)
    if _separation_cycles(baud, mark, space, sample_rate) < 0.8:
        raise ValueError(
            "sequence-parallel FSK covers dual-tone configs; close-tone "
            "discriminator configs decode via the batched or single paths"
        )
    spr, row, ov = _fsk_geometry(spb)
    n_dev = mesh.size
    w_np = _fsk_blocked_templates(spb, float(mark), float(space), sample_rate, n_offsets)
    c = row + ov
    n = len(samples)
    r_total = max(2 * n_dev, -(-(-(-n // row)) // n_dev) * n_dev)
    r_local = r_total // n_dev
    xs = _shards(_padded(samples, r_total * row), mesh)
    ws = [torch.from_numpy(w_np).to(x.device) for x in xs]

    halos = ppermute([x[:ov] for x in xs])  # the right neighbour's head completes the last row
    xovs, scores = [], []
    for x, halo, w in zip(xs, halos, ws):
        xr = x.reshape(r_local, row)
        xov = torch.cat([xr, torch.cat([xr[1:, :ov], halo[None]], dim=0)], dim=1)
        pj = (xov @ w.transpose(0, 1).reshape(c, -1)).reshape(r_local, n_offsets, 4, spr)
        em = pj[:, :, 0] ** 2 + pj[:, :, 1] ** 2
        es = pj[:, :, 2] ** 2 + pj[:, :, 3] ** 2
        scores.append(torch.sum(torch.abs(em - es), dim=(0, 2)))  # (n_offsets,)
        xovs.append(xov)
    bests = [torch.argmax(s) for s in psum(scores)]
    bits = []
    for xov, w, best in zip(xovs, ws, bests):
        pj2 = (xov @ w.index_select(0, best.reshape(1))[0]).reshape(r_local, 4, spr)
        margin = (pj2[:, 0] ** 2 + pj2[:, 1] ** 2) - (pj2[:, 2] ** 2 + pj2[:, 3] ** 2)
        bits.append((margin > 0).to(torch.uint8).reshape(-1))
    return bits, int(bests[0])


def demod_fsk_capture_sharded(
    samples: np.ndarray,
    baud: float,
    mark: float,
    space: float,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
    n_offsets: int = 8,
) -> torch.Tensor:
    """Dual-tone FSK demod of ONE capture, sample axis sharded over
    ``mesh``: the global bit array. The detector is per-bit noncoherent
    energy, so the only data that crosses shards is the row overlap (one
    :func:`~.mesh.ppermute` of the right neighbour's first ``ov`` samples)
    and the offset scores' :func:`~.mesh.psum`. Close-tone configurations
    (under 0.8 cycles of separation, such as FSK9600) raise ValueError."""
    bits, _best = _fsk_shards(samples, baud, mark, space, mesh, sample_rate, n_offsets)
    return _gather(bits)


def _ofdm_shards(samples, baud, carrier, n_sub, mesh, sample_rate):
    from ..ops.ofdm import _device_dual_templates, _ofdm_rows_per_block, _ofdm_shift_tables, _symbol_samples

    K = int(n_sub)
    S = _symbol_samples(sample_rate, int(baud), K)
    L = _ofdm_rows_per_block(S)
    LS, LK = L * S, L * K
    n_offsets = S
    n_dev = mesh.size
    n = len(samples)
    r_total = max(n_dev, -(-(-(-n // LS)) // n_dev) * n_dev)
    r_local = r_total // n_dev
    if r_local * L < 3:
        raise ValueError("capture too short per shard for OFDM timing search")
    xs = _shards(_padded(samples, r_total * LS), mesh)
    Ts = [_device_dual_templates(S, float(carrier), K, sample_rate, n_offsets, x.device) for x in xs]
    tables = [_ofdm_shift_tables(S, float(carrier), K, sample_rate, L, x.device) for x in xs]
    wsyms = min(r_local * L - 1, 256)
    wrows = -(-(wsyms + 1) // L)

    halos = ppermute([x[:S] for x in xs])
    rows, scores = [], []
    for x, halo, T in zip(xs, halos, Ts):
        xr = x.reshape(r_local, LS)
        rows_ov = torch.cat([xr, torch.cat([xr[1:, :S], halo[None]], dim=0)], dim=1)  # (r_local, LS+S)
        # Pass 1: this shard's leading window scores every offset (the gain
        # normalisation stays local, as the single-device core's).
        w = rows_ov[:wrows]
        flat_w = torch.cat([w[:, :LS].reshape(-1), w[-1, LS:]])
        xw = flat_w[: wsyms * S].reshape(wsyms, S)
        xw_next = flat_w[S : (wsyms + 1) * S].reshape(wsyms, S)
        projw = (xw @ T[:S] + xw_next @ T[S:]).reshape(wsyms, n_offsets, K, 2)
        rew, imw = projw[..., 0], projw[..., 1]
        gains_w = torch.sqrt(torch.mean(rew ** 2 + imw ** 2, dim=0)) + 1e-9
        rew, imw = rew / gains_w[None], imw / gains_w[None]
        d_re_w = rew[1:] * rew[:-1] + imw[1:] * imw[:-1]
        d_im_w = imw[1:] * rew[:-1] - rew[1:] * imw[:-1]
        a, b = d_re_w * d_re_w, d_im_w * d_im_w
        scores.append(torch.sum(((a - b) ** 2 - 4 * a * b) / (a + b + 1e-20), dim=(0, 2)))
        rows.append(rows_ov)
    offs = [torch.argmax(s) * S // n_offsets for s in psum(scores)]

    # Pass 2 and the differential across the shard boundary.
    res = []
    for rows_ov, tab, off in zip(rows, tables, offs):
        proj = rows_ov @ tab.index_select(0, off.reshape(1))[0]  # (r_local, 2*L*K)
        res.append((proj[:, :LK].reshape(-1), proj[:, LK:].reshape(-1)))
    firsts = ppermute([torch.cat([re[:K], im[:K]]) for re, im in res])  # first symbol -> left neighbour
    his, los = [], []
    for (re, im), nb in zip(res, firsts):
        re_n = torch.cat([re[K:], nb[:K]])
        im_n = torch.cat([im[K:], nb[K:]])
        dr = re_n * re + im_n * im
        di = im_n * re - re_n * im
        swap = torch.abs(di) > torch.abs(dr)
        neg = torch.where(swap, di < 0, dr < 0)
        his.append(neg.to(torch.uint8))
        los.append(torch.where(swap, ~neg, neg).to(torch.uint8))
    return his, los, int(offs[0])


def demod_ofdm_capture_sharded(
    samples: np.ndarray,
    baud: float,
    carrier: float,
    n_sub: int,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OFDM demod of ONE capture, sample axis sharded over ``mesh``: the
    global (hi, lo) dibit streams. Couplings: the S-sample row overlap (one
    :func:`~.mesh.ppermute`), the timing consensus (each shard scores a
    window of its own symbols, :func:`~.mesh.psum` combines them) and the
    per-subcarrier differential at the shard boundary (a second
    ppermute of the next shard's first symbol). The subcarrier gains are not
    equalised (a positive scale per subcarrier leaves the sign decisions),
    and the capture is taken as carrier-exact (no blind CFO derotation; the
    batched path is the CFO-robust one). A shard of fewer than three
    symbols raises ValueError."""
    his, los, _off = _ofdm_shards(samples, baud, carrier, n_sub, mesh, sample_rate)
    return _gather(his), _gather(los)


def demod_hell_capture_sharded(
    samples: np.ndarray,
    baud: float,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
    threshold: float = 0.1,
) -> torch.Tensor:
    """Hellschreiber pixel detection of ONE capture, sample axis sharded:
    the global per-pixel on/off stream. Shards hold whole pixel windows and
    the detection (a window's mean square) never looks across one, so
    nothing crosses shards; the glyph match runs on the host over the
    gathered pixels."""
    spp = int(round(sample_rate / baud))
    n_dev = mesh.size
    n = len(samples)
    pix_local = max(1, -(-(-(-n // spp)) // n_dev))
    xs = _shards(_padded(samples, n_dev * pix_local * spp), mesh)
    pixels = []
    for x in xs:
        w = x.reshape(pix_local, spp)
        pixels.append((torch.mean(w * w, dim=1) > threshold).to(torch.uint8))
    return _gather(pixels)


def _neural_shards(samples, symbol_rate, mesh):
    from ..ops.neural import CHIPS_PER_SYMBOL, _chip_len, _device_tables as _neural_tables, _td_corr, _td_peak

    chip_len = _chip_len(int(symbol_rate))
    spsym = CHIPS_PER_SYMBOL * chip_len
    n_dev = mesh.size
    # Shard length: a multiple of lcm(spsym, 128), 128 for the correlation
    # rows, spsym so that every shard starts on the same chip grid (spsym is
    # a multiple of 4, so the fs/4 mask pattern is aligned too).
    lcm = spsym * 128 // math.gcd(spsym, 128)
    n = len(samples)
    L = max(lcm, -(-(-(-n // lcm)) // n_dev) * lcm)
    ns = L // spsym
    xs = _shards(_padded(samples, n_dev * L), mesh)
    tabs = [_neural_tables(chip_len, x.device) for x in xs]
    p_pre = int(tabs[0]["corr"].shape[0] - 128)
    halo_len = -(-(p_pre + spsym) // 4) * 4  # keeps the mask pattern aligned

    zs = []
    for x in xs:
        # fs/4 downconversion by sign masks; shard starts are multiples of 4.
        reps = -(-L // 4)
        zs.append((x * torch.tensor([1.0, 0.0, -1.0, 0.0], device=x.device).repeat(reps)[:L],
                   x * torch.tensor([0.0, -1.0, 0.0, 1.0], device=x.device).repeat(reps)[:L]))
    halos = ppermute([torch.stack([zr[:halo_len], zi[:halo_len]]) for zr, zi in zs])
    ext, peaks = [], []
    for (zr, zi), halo, tab in zip(zs, halos, tabs):
        zre, zie = torch.cat([zr, halo[0]]), torch.cat([zi, halo[1]])
        # The matched filter over this shard's lags [0, L); the halo covers
        # the windows that reach past the shard.
        peaks.append(_td_peak(*_td_corr(zre, zie, tab["corr"], L // 128)))
        ext.append((zre, zie))
    pk_all = all_gather([pk for _k, _r, _i, pk in peaks])
    wins = [torch.argmax(p) for p in pk_all]
    mine = [(win == i) for i, win in enumerate(wins)]
    k0s = psum([torch.where(m, k + i * L, torch.zeros_like(k)) for i, ((k, _r, _i, _p), m)
                in enumerate(zip(peaks, mine))])
    prs = psum([r * m.to(r.dtype) for (_k, r, _i, _p), m in zip(peaks, mine)])
    pis = psum([im * m.to(im.dtype) for (_k, _r, im, _p), m in zip(peaks, mine)])

    syms = []
    for (zre, zie), k0, pr, pi, tab in zip(ext, k0s, prs, pis, tabs):
        # s0 = k0 mod spsym is the same on every shard (L is a multiple of
        # spsym), so each shard yields exactly ns symbols, gap-free.
        s0 = int(k0 % spsym)
        zr_s, zi_s = zre[s0 : s0 + L], zie[s0 : s0 + L]
        wr = zr_s * pr + zi_s * pi  # z * conj(phase)
        wi = zi_s * pr - zr_s * pi
        cr = wr.reshape(ns, CHIPS_PER_SYMBOL, chip_len).mean(-1)
        ci = wi.reshape(ns, CHIPS_PER_SYMBOL, chip_len).mean(-1)
        syms.append(torch.argmax(torch.cat([cr, ci], dim=-1) @ tab["cb"].T, dim=-1).to(torch.uint8))
    return syms, int(k0s[0]), int(wins[0])


def demod_neural_capture_sharded(
    samples: np.ndarray,
    symbol_rate: int,
    mesh: Mesh,
) -> Tuple[torch.Tensor, int]:
    """NEURAL demod of ONE capture, sample axis sharded over ``mesh``.

    * **Distributed matched filter**: every shard runs the preamble
      correlation (``ops.neural._td_corr``) over its own lag span, with a
      halo of preamble + symbol samples from the right neighbour (one
      :func:`~.mesh.ppermute`), so a preamble anywhere, across a shard
      boundary too, is found. An :func:`~.mesh.all_gather` of the shards'
      peaks picks the global winner (the first maximum); its lag and
      channel phasor reach every shard through a masked :func:`~.mesh.psum`.
    * **Chip-grid alignment**: the shard length is a multiple of the
      symbol span, so the extraction start ``k0 mod spsym`` is the same on
      every shard and the shards' symbol streams concatenate gap-free.

    Returns ``(symbols, k0)``: the global per-position byte symbols and the
    global sync lag. Symbol ``k0 // spsym + 32`` on is the framed stream;
    the frame parser's magic scan absorbs the lead, so callers may parse
    ``bytes(symbols)`` as it is."""
    syms, k0, _win = _neural_shards(samples, symbol_rate, mesh)
    return _gather(syms), k0


def decode_capture_sharded(
    samples: np.ndarray,
    mode: str,
    symbol_rate: int,
    mesh: Mesh,
    sample_rate: int = SAMPLE_RATE,
) -> bytes:
    """Full sequence-parallel receive: the sharded demod, then sync and pack
    on the global stream (on the mesh's first device). Covers the seven
    shardable families: PSK (D8PSK too), DSSS, dual-tone FSK, OFDM, NEURAL
    and the text modes (HELL returns the decoded text's bytes, as the
    batched text path does)."""
    from ..framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from ..ops.common import dibit_sync_and_pack, find_bit_pattern, pack_bits_from
    from .batch import resolve_demod_plan

    def stream_bytes(packed, n_valid) -> bytes:
        return bytes(packed.cpu().numpy()[: int(n_valid)])

    kind, params = resolve_demod_plan(mode, symbol_rate)
    if kind == "fsk":
        baud_f, mark, space = params
        bits = demod_fsk_capture_sharded(samples, baud_f, mark, space, mesh, sample_rate=sample_rate)
        start, _found = find_bit_pattern(bits[None], MAGIC_BIT_PATTERN)
        packed, n_valid = pack_bits_from(bits[None], start)
        return stream_bytes(packed[0], n_valid[0])
    if kind == "ofdm":
        baud_o, carrier_o, n_sub = params
        hi, lo = demod_ofdm_capture_sharded(samples, baud_o, carrier_o, int(n_sub), mesh, sample_rate=sample_rate)
        packed, n_valid, _found = dibit_sync_and_pack(hi, lo, MAGIC_BIT_PATTERN)
        return stream_bytes(packed, n_valid)
    if kind == "psk8":
        # The sharded front end at 8th-power timing consensus, then the
        # rotation estimate, the sector decisions and the 8-hypothesis sync
        # on the global differential streams (8x fewer than the samples).
        from ..ops.kernels import psk8_sector_stream
        from ..ops.psk import derotate, estimate_common_rotation_windows, psk8_sync_and_pack_rotations

        baud, carrier = params
        dr, di = demod_capture_sharded(samples, baud, carrier, mesh, n_psk=8, sample_rate=sample_rate)
        dr, di = derotate(dr, di, estimate_common_rotation_windows(dr, di, n_psk=8))
        packed, n_valid, _found = psk8_sync_and_pack_rotations(
            psk8_sector_stream(dr, di), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
        return stream_bytes(packed, n_valid)
    if kind == "dsss":
        # The sharded raw chip front end (chips sum coherently per data bit
        # before any differential); the despread, the alignment select and
        # the DBPSK rotation sync on the global chip stream.
        from ..ops.common import bit_sync_and_pack_rotations
        from ..ops.dsss import _despread_all_batch
        from ..ops.psk import _coherence_score, derotate, estimate_common_rotation

        baud, carrier = params
        re_f, im_f = demod_capture_sharded(samples, baud, carrier, mesh, n_psk=2, sample_rate=sample_rate,
                                           raw=True)
        b_re = _despread_all_batch(re_f[None])[0]  # (16, n_bits)
        b_im = _despread_all_batch(im_f[None])[0]
        d_re = b_re[:, 1:] * b_re[:, :-1] + b_im[:, 1:] * b_im[:, :-1]
        d_im = b_im[:, 1:] * b_re[:, :-1] - b_re[:, 1:] * b_im[:, :-1]
        a = torch.argmax(_coherence_score(d_re, d_im, 1))
        dr, di = d_re[a], d_im[a]
        dr, di = derotate(dr, di, estimate_common_rotation(dr, di))
        packed, n_valid, _found = bit_sync_and_pack_rotations(
            (dr < 0).to(torch.uint8), (di < 0).to(torch.uint8), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
        return stream_bytes(packed, n_valid)
    if kind == "hell":
        from ..ops.hell import _decode_blocks

        (baud_h,) = params
        pixels = demod_hell_capture_sharded(samples, baud_h, mesh, sample_rate=sample_rate)
        return _decode_blocks(pixels.cpu().numpy()).encode("utf-8", "replace")
    if kind == "neural":
        (rate_n,) = params
        syms, _k0 = demod_neural_capture_sharded(samples, int(rate_n), mesh)
        # The symbols are the bytes; the parser's magic scan absorbs the
        # lead before the preamble and the preamble itself.
        return bytes(syms.cpu().numpy())
    if kind not in ("psk2", "psk4"):
        raise ValueError(
            f"sequence-parallel decode supports PSK/8PSK/DSSS/FSK/OFDM/NEURAL/HELL modes, not {mode}"
        )
    baud, carrier = params
    d_re, d_im = demod_capture_sharded(samples, baud, carrier, mesh, n_psk=4 if kind == "psk4" else 2,
                                       sample_rate=sample_rate)
    if kind == "psk4":
        hi, lo = qpsk_gray_streams(d_re, d_im)
        packed, n_valid, _found = dibit_sync_and_pack(hi, lo, MAGIC_BIT_PATTERN)
        return stream_bytes(packed, n_valid)
    bits = (d_re < 0).to(torch.uint8)
    start, _found = find_bit_pattern(bits[None], MAGIC_BIT_PATTERN)
    packed, n_valid = pack_bits_from(bits[None], start)
    return stream_bytes(packed[0], n_valid[0])
