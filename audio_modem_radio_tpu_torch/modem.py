"""Mode registry, modulation and single-capture demodulation of the PyTorch port.

Counterpart of ``audio_modem_radio_tpu/modem.py``, with its 18 modes:
FSK1200 (1200/2200 Hz tones at 1200 Bd), FSK9600 (the same tones at 9600
Bd), FSK19200 (8/16 kHz at 19200 Bd), MSK (FSK with mark 6 kHz, space 6 kHz
+ the rate), FT8 (50 Bd FSK, 3000/3050 Hz), BPSK (DBPSK on a 3 kHz
carrier), QPSK (DQPSK, 3 kHz), 8PSK (real D8PSK on 12 kHz), OFDM4 and OFDM8
(multicarrier DQPSK on 4 and 8 subcarriers around 12 kHz), APSK16 (DQPSK,
12 kHz), DSSS (DBPSK spread over a 16-chip PN, 3 kHz), SSTV (DQPSK, 3
kHz), PSK31 (DBPSK at 31.25 Bd, 3 kHz), NEURAL (the learned codebook, 1
byte per symbol, 24 kHz) and the Hellschreiber text modes HELLSCHREIBER,
FELD_HELL (122.5 pixels/s) and SLOW_HELL (61.25).

8PSK, OFDM4/OFDM8 and DSSS honour their CONFIG compatibility aliases
(``modem.psk8_compat_alias``, ``modem.ofdm_compat_alias``,
``modem.dsss_compat_alias``): the reference's DQPSK or DBPSK wire format.

:func:`demodulate` is the single-capture receive of every mode: the FSK
modes through ``ops.fsk.fsk_demodulate`` (MLSE first on close tones, the
equalizer-only stream as its fallback), NEURAL, the text modes, and the PSK
family (OFDM and DSSS included) with the JAX package's coherent escalation
(the Viterbi&Viterbi-tracked receiver when differential detection leaves
the capture incomplete) and, for 8PSK, OFDM and DSSS, its probe-gated alias
fallback. It runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from .config import CONFIG
from .framing import MAGIC, pack_frame, parse_frames_detailed
from .ops.dsss import dsss_real_demodulate, dsss_real_modulate, dsss_tracked_demodulate
from .ops.fsk import fsk_demodulate, fsk_high_speed_demodulate, fsk_high_speed_modulate, fsk_modulate
from .ops.hell import hellschreiber_demodulate, hellschreiber_modulate
from .ops.neural import _chip_len as _neural_chip_len, neural_mode_demodulate, neural_mode_modulate
from .ops.ofdm import ofdm_demodulate, ofdm_modulate, ofdm_tracked_demodulate
from .ops.psk import (
    bpsk_demodulate,
    bpsk_modulate,
    bpsk_tracked_demodulate,
    psk8_real_demodulate,
    psk8_real_modulate,
    psk8_tracked_demodulate,
    qpsk_demodulate,
    qpsk_modulate,
    qpsk_tracked_demodulate,
)
from .utils.torchenv import DeviceLike
from .utils.wavio import SAMPLE_RATE, wav_from_array  # noqa: F401  (re-export)

__all__ = [
    "SAMPLE_RATE",
    "wav_from_array",
    "MODES",
    "ModeSpec",
    "modulate",
    "demodulate",
    "fsk_modulate",
    "fsk_demodulate",
    "bpsk_modulate",
    "bpsk_demodulate",
    "qpsk_modulate",
    "qpsk_demodulate",
    "psk8_modulate",
    "psk8_demodulate",
    "fsk_high_speed_modulate",
    "fsk_high_speed_demodulate",
    "ofdm_modulate_simple",
    "ofdm_demodulate_simple",
    "apsk16_modulate",
    "apsk16_demodulate",
    "dsss_modulate",
    "dsss_demodulate",
    "msk_modulate",
    "msk_demodulate",
    "ft8_modulate",
    "ft8_demodulate",
    "psk31_modulate",
    "psk31_demodulate",
    "feld_hell_modulate",
    "feld_hell_demodulate",
    "hellschreiber_modulate",
    "hellschreiber_demodulate",
]


@dataclass(frozen=True)
class ModeSpec:
    """One transmission mode: ``modulate(framed_bytes, symbol_rate) ->
    waveform`` and ``demodulate(samples, symbol_rate, device) -> bytes``.
    ``bytes_per_sec(symbol_rate)`` is the design-throughput estimate of the
    reference's efficiency map; ``fixed_baud`` is the mode's own rate where
    it ignores the caller's."""

    name: str
    modulate: Callable[[bytes, int], np.ndarray]
    demodulate: Callable[..., bytes]
    bytes_per_sec: Callable[[int], float]
    fixed_baud: Optional[float] = None


def adaptive_gain_control(data: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Normalize a waveform to ``peak``."""
    arr = np.asarray(data, dtype=np.float32)
    m = float(np.max(np.abs(arr))) if arr.size else 0.0
    return arr / m * peak if m > 0 else arr


class AdvancedModem:
    """API-parity shell around the mode registry."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        self.sample_rate = sample_rate

    def _adaptive_gain_control(self, data: np.ndarray) -> np.ndarray:
        return adaptive_gain_control(data)


def psk8_modulate(d, b=1200, c=3000.0, s=96000):
    """8PSK alias: DQPSK (the reference's wire format)."""
    return qpsk_modulate(d, b, c, s)


def psk8_demodulate(x, b=1200, c=3000.0, s_r=96000, device: DeviceLike = None):
    return qpsk_demodulate(x, b, c, s_r, device=device)


def _psk8_mode_modulate(d, b, c, s=96000):
    """8PSK transmit: real D8PSK (3 Gray bits/symbol) unless CONFIG
    ``modem.psk8_compat_alias`` selects the reference-interoperable alias
    wire format, DQPSK."""
    if CONFIG.get("modem.psk8_compat_alias", False):
        return psk8_modulate(d, b, c, s)
    return psk8_real_modulate(d, b, c, s)


def _alias_probe_hits(xs: np.ndarray, baud, carrier, samp_rate, probe_demod=None,
                      device: DeviceLike = None) -> bool:
    """True when a 2^16-sample alias-layer probe (DQPSK by default) finds
    the frame magic: at the first sample above 0.02, and at the first
    2^16-sample block with half the peak block energy and half a block
    later (captures led by noise)."""
    nz = np.flatnonzero(np.abs(xs) > 0.02)
    if nz.size == 0:
        return False
    P = 1 << 16
    blocks = len(xs) // P
    starts = [int(nz[0])]
    if blocks > 1:
        e = np.add.reduceat(xs * xs, np.arange(0, blocks * P, P))
        flb = int(np.argmax(e >= 0.5 * e.max()))
        for cand in (flb * P, flb * P + P // 2):
            if all(abs(cand - s) > P // 2 for s in starts):
                starts.append(cand)
    demod = probe_demod or qpsk_demodulate
    for s0 in starts:
        probe = np.zeros(P, np.float32)
        w = xs[s0 : s0 + P]
        probe[: len(w)] = w
        try:
            probed = demod(probe, baud, carrier, samp_rate, device=device)
        except Exception:
            return False
        if MAGIC in probed:
            return True
    return False


def _capture_complete(valid, damaged, raw) -> bool:
    """True when a parsed capture needs no rescue: no damaged frames, and
    either every file whose frames appear has all its parts CRC-valid, or
    the stream holds no more frame magics than valid frames (no evidence of
    a lost frame in this capture)."""
    if damaged:
        return False
    parts = {}
    for f in valid:
        parts.setdefault((f.name, f.file_crc, f.total_parts), set()).add(f.part_number)
    if all(len(got) >= total for (_, _, total), got in parts.items()):
        return True
    return raw.count(MAGIC) <= len(valid)


def _frame_key(f):
    return (f.name, f.file_crc, f.part_number, f.total_parts)


def _merge_valid(stream, v_have, v_other):
    """Append to ``stream`` the CRC-valid frames only the other stream
    carried, re-serialized byte-exact."""
    have = {_frame_key(f) for f in v_have}
    extra = [f for f in v_other if _frame_key(f) not in have]
    if not extra:
        return stream
    return stream + b"".join(
        pack_frame(f.name, f.data, f.part_number, f.total_parts, f.file_size, f.file_crc) for f in extra
    )


def _coherent_escalate(raw, tracked_fn):
    """The PSK coherent-escalation policy. A complete capture in ``raw``
    ships as is (no tracked pass); otherwise the tracked stream runs and
    the one with more CRC-valid frames ships (ties to ``raw``) with the
    other's extra valid frames appended; with no valid frame anywhere the
    tracked stream ships if it syncs at least as well; else None (the
    caller keeps ``raw``)."""
    v_raw, d_raw = parse_frames_detailed(raw)
    if v_raw and _capture_complete(v_raw, d_raw, raw):
        return raw
    tracked = tracked_fn()
    v_t, d_t = parse_frames_detailed(tracked)
    if v_raw or v_t:
        if len(v_t) > len(v_raw):
            return _merge_valid(tracked, v_t, v_raw)
        return _merge_valid(raw, v_raw, v_t)
    if (d_t or MAGIC in tracked) and ((len(d_t), MAGIC in tracked) >= (len(d_raw), MAGIC in raw)):
        return tracked
    return None


def _psk_mode_demodulate(x, b, c, sr=96000, n_psk=4, device: DeviceLike = None):
    """DBPSK/DQPSK mode receive with coherent escalation."""
    fn = qpsk_demodulate if n_psk == 4 else bpsk_demodulate
    raw = fn(x, b, c, sr, device=device)
    if CONFIG.get("modem.psk_coherent_escalation", True):
        tfn = qpsk_tracked_demodulate if n_psk == 4 else bpsk_tracked_demodulate
        out = _coherent_escalate(raw, lambda: tfn(x, b, c, sr, device=device))
        if out is not None:
            return out
    return raw


def _alias_gated_demodulate(flag: str, x, b, c, sr, real, alias, tracked, device: DeviceLike,
                            probe_demod=None):
    """Receive of a mode with a compatibility alias: ``alias()`` under
    CONFIG ``modem.<flag>``; otherwise ``real()``, then, when no magic
    decodes and a short alias-layer probe (DQPSK, or ``probe_demod``) finds
    one, ``alias()``, before the coherent escalation with ``tracked``."""
    if CONFIG.get(f"modem.{flag}", False):
        return alias()
    raw = real()
    if MAGIC not in raw and _alias_probe_hits(np.asarray(x, np.float32), b, c, sr, probe_demod, device=device):
        return alias()
    if CONFIG.get("modem.psk_coherent_escalation", True):
        out = _coherent_escalate(raw, tracked)
        if out is not None:
            return out
    return raw


def _psk8_mode_demodulate(x, b, c, sr=96000, device: DeviceLike = None):
    """Real-D8PSK receive with the probe-gated alias fallback and coherent
    escalation."""
    return _alias_gated_demodulate(
        "psk8_compat_alias", x, b, c, sr, lambda: psk8_real_demodulate(x, b, c, sr, device=device),
        lambda: psk8_demodulate(x, b, c, sr, device=device),
        lambda: psk8_tracked_demodulate(x, b, c, sr, device=device), device)


def ofdm_modulate_simple(d, baud, carrier, num_subcarriers, samp_rate=96000):
    """OFDM alias: DQPSK; the subcarrier count is accepted and ignored."""
    del num_subcarriers
    return qpsk_modulate(d, baud, carrier, samp_rate)


def ofdm_demodulate_simple(x, baud, carrier, num_subcarriers, samp_rate=96000, device: DeviceLike = None):
    del num_subcarriers
    return qpsk_demodulate(x, baud, carrier, samp_rate, device=device)


def _ofdm_mode_modulate(d, baud, carrier, num_subcarriers, samp_rate=96000):
    """OFDM transmit: multicarrier DQPSK unless CONFIG
    ``modem.ofdm_compat_alias`` selects the alias wire format, DQPSK."""
    if CONFIG.get("modem.ofdm_compat_alias", False):
        return ofdm_modulate_simple(d, baud, carrier, num_subcarriers, samp_rate)
    return ofdm_modulate(d, baud, carrier, num_subcarriers, samp_rate)


def _ofdm_mode_demodulate(x, baud, carrier, num_subcarriers, samp_rate=96000, device: DeviceLike = None):
    """Multicarrier receive with the probe-gated alias fallback and the
    per-subcarrier coherent escalation."""
    return _alias_gated_demodulate(
        "ofdm_compat_alias", x, baud, carrier, samp_rate,
        lambda: ofdm_demodulate(x, baud, carrier, num_subcarriers, samp_rate, device=device),
        lambda: ofdm_demodulate_simple(x, baud, carrier, num_subcarriers, samp_rate, device=device),
        lambda: ofdm_tracked_demodulate(x, baud, carrier, num_subcarriers, samp_rate, device=device), device)


def dsss_modulate(d, b, c, s=96000):
    """DSSS alias: DBPSK, no spreading."""
    return bpsk_modulate(d, b, c, s)


def dsss_demodulate(x, b, c, s=96000, device: DeviceLike = None):
    return bpsk_demodulate(x, b, c, s, device=device)


def _dsss_mode_modulate(d, b, c, s=96000):
    """DSSS transmit: the 16-chip spread spectrum unless CONFIG
    ``modem.dsss_compat_alias`` selects the alias wire format, DBPSK."""
    if CONFIG.get("modem.dsss_compat_alias", False):
        return dsss_modulate(d, b, c, s)
    return dsss_real_modulate(d, b, c, s)


def _dsss_mode_demodulate(x, b, c, sr=96000, device: DeviceLike = None):
    """Spread-spectrum receive with the probe-gated alias fallback (a DBPSK
    probe) and the coherent escalation on the despread bit stream."""
    return _alias_gated_demodulate(
        "dsss_compat_alias", x, b, c, sr, lambda: dsss_real_demodulate(x, b, c, sr, device=device),
        lambda: dsss_demodulate(x, b, c, sr, device=device),
        lambda: dsss_tracked_demodulate(x, b, c, sr, device=device), device, probe_demod=bpsk_demodulate)


def apsk16_modulate(d, b, c, s=96000):
    return qpsk_modulate(d, b, c, s)


def apsk16_demodulate(x, b, c, s=96000, device: DeviceLike = None):
    return qpsk_demodulate(x, b, c, s, device=device)


def msk_modulate(d, b, c, s=96000):
    """MSK alias: FSK with mark = carrier, space = carrier + baud."""
    return fsk_modulate(d, b, c, c + b, s)


def msk_demodulate(x, b, c, s=96000, device: DeviceLike = None):
    return fsk_demodulate(x, b, c, c + b, s, device=device)


def ft8_modulate(d, b, c, s=96000):
    """FT8 alias: 50-baud FSK, mark = carrier, space = carrier + 50."""
    del b
    return fsk_modulate(d, 50, c, c + 50, s)


def ft8_demodulate(x, b, c, sr=96000, device: DeviceLike = None):
    del b
    return fsk_demodulate(x, 50, c, c + 50, sr, device=device)


def psk31_modulate(d, b, c, s=96000):
    """PSK31 alias: DBPSK at 31.25 baud."""
    del b
    return bpsk_modulate(d, 31.25, c, s)


def psk31_demodulate(x, b, c, sr=96000, device: DeviceLike = None):
    del b
    return bpsk_demodulate(x, 31.25, c, sr, device=device)


def feld_hell_modulate(d: bytes, b=122.5, c=1000.0, s=96000):
    """Feld-Hell: frame bytes -> lossy utf-8 text -> Hellschreiber."""
    return hellschreiber_modulate(d.decode("utf-8", "ignore"), b, c, s)


def feld_hell_demodulate(x, b=122.5, c=1000.0, sr=96000, device: DeviceLike = None) -> bytes:
    return hellschreiber_demodulate(x, b, c, sr, device=device).encode("utf-8")


MODES: Dict[str, ModeSpec] = {
    "FSK1200": ModeSpec("FSK1200", lambda d, r: fsk_modulate(d, 1200, 1200.0, 2200.0),
                        lambda x, r, device=None: fsk_demodulate(x, 1200, 1200.0, 2200.0, device=device),
                        lambda r: 100, fixed_baud=1200),
    "FSK9600": ModeSpec("FSK9600", lambda d, r: fsk_modulate(d, 9600),
                        lambda x, r, device=None: fsk_demodulate(x, 9600, device=device),
                        lambda r: 800, fixed_baud=9600),
    "FSK19200": ModeSpec("FSK19200", lambda d, r: fsk_high_speed_modulate(d, 19200),
                         lambda x, r, device=None: fsk_high_speed_demodulate(x, 19200, device=device),
                         lambda r: 1600, fixed_baud=19200),
    "BPSK": ModeSpec("BPSK", lambda d, r: bpsk_modulate(d, r, 3000.0),
                     lambda x, r, device=None: _psk_mode_demodulate(x, r, 3000.0, n_psk=2, device=device),
                     lambda r: r // 8),
    "QPSK": ModeSpec("QPSK", lambda d, r: qpsk_modulate(d, r, 3000.0),
                     lambda x, r, device=None: _psk_mode_demodulate(x, r, 3000.0, n_psk=4, device=device),
                     lambda r: r // 4),
    "8PSK": ModeSpec("8PSK", lambda d, r: _psk8_mode_modulate(d, r, 12000.0),
                     lambda x, r, device=None: _psk8_mode_demodulate(x, r, 12000.0, device=device),
                     lambda r: (r * 3) // 8),
    "OFDM4": ModeSpec("OFDM4", lambda d, r: _ofdm_mode_modulate(d, r, 12000.0, 4),
                      lambda x, r, device=None: _ofdm_mode_demodulate(x, r, 12000.0, 4, device=device),
                      lambda r: r // 2),
    "OFDM8": ModeSpec("OFDM8", lambda d, r: _ofdm_mode_modulate(d, r, 12000.0, 8),
                      lambda x, r, device=None: _ofdm_mode_demodulate(x, r, 12000.0, 8, device=device),
                      lambda r: r),
    "APSK16": ModeSpec("APSK16", lambda d, r: apsk16_modulate(d, r, 12000.0),
                       lambda x, r, device=None: apsk16_demodulate(x, r, 12000.0, device=device),
                       lambda r: r // 2),
    # Spread spectrum: r chips/s / 16 chips a bit / 8 = r/128 B/s; the
    # alias (plain DBPSK) keeps the reference's r/16 estimate.
    "DSSS": ModeSpec("DSSS", lambda d, r: _dsss_mode_modulate(d, r, 3000.0),
                     lambda x, r, device=None: _dsss_mode_demodulate(x, r, 3000.0, device=device),
                     lambda r: (r // 16) if CONFIG.get("modem.dsss_compat_alias", False) else max(1, r // 128)),
    "MSK": ModeSpec("MSK", lambda d, r: msk_modulate(d, r, 6000.0),
                    lambda x, r, device=None: msk_demodulate(x, r, 6000.0, device=device), lambda r: r // 4),
    "FT8": ModeSpec("FT8", lambda d, r: ft8_modulate(d, r, 3000.0),
                    lambda x, r, device=None: ft8_demodulate(x, r, 3000.0, device=device),
                    lambda r: 6, fixed_baud=50),  # 50 baud / 8 bits
    "PSK31": ModeSpec("PSK31", lambda d, r: psk31_modulate(d, r, 3000.0),
                      lambda x, r, device=None: psk31_demodulate(x, r, 3000.0, device=device),
                      lambda r: 4, fixed_baud=31.25),  # 31.25 baud / 8 bits
    "HELLSCHREIBER": ModeSpec(
        "HELLSCHREIBER", lambda d, r: hellschreiber_modulate(d.decode("utf-8", "ignore")),
        lambda x, r, device=None: hellschreiber_demodulate(x, device=device).encode("utf-8"),
        lambda r: 15, fixed_baud=122.5),
    "FELD_HELL": ModeSpec("FELD_HELL", lambda d, r: feld_hell_modulate(d, 122.5, 1000.0),
                          lambda x, r, device=None: feld_hell_demodulate(x, 122.5, 1000.0, device=device),
                          lambda r: 15, fixed_baud=122.5),
    # Learned codebook, 1 byte per symbol on a 24 kHz carrier (ops/neural.py).
    "NEURAL": ModeSpec("NEURAL", lambda d, r: neural_mode_modulate(d, r),
                       lambda x, r, device=None: neural_mode_demodulate(x, r, device=device),
                       lambda r: SAMPLE_RATE / (8 * _neural_chip_len(r))),
    # Hellschreiber glyphs at half the pixel rate.
    "SLOW_HELL": ModeSpec(
        "SLOW_HELL", lambda d, r: hellschreiber_modulate(d.decode("utf-8", "ignore"), baud=61.25),
        lambda x, r, device=None: hellschreiber_demodulate(x, baud=61.25, device=device).encode("utf-8"),
        lambda r: 7, fixed_baud=61.25),
    # The reference GUI lists SSTV but ships no SSTV modulator; payloads ride
    # a DQPSK carrier.
    "SSTV": ModeSpec("SSTV", lambda d, r: qpsk_modulate(d, r, 3000.0),
                     lambda x, r, device=None: qpsk_demodulate(x, r, 3000.0, device=device),
                     lambda r: 50),
}


# Display-only mode catalogs (reference filebeep_advanced_v2.py:80-87): the
# reference GUI lists 45+ ham modes it cannot transmit; they are kept verbatim
# as labels for UI parity. Transmittable modes are exactly MODES above.
DIGITAL_MODES = [
    "FSK1200", "FSK9600", "BPSK", "QPSK", "8PSK", "FSK19200", "OFDM4", "OFDM8",
    "APSK16", "DSSS", "MSK", "FT8", "FT4", "JT65", "JT9", "MSK144", "WSPR",
    "JS8", "PSK31", "PSK63", "BPSK31", "RTTY", "FSK", "MFSK8", "MFSK16",
    "AFSK1200", "AFSK2400", "AX25", "PACTOR", "ARDOP", "VARA", "WINLINK",
    "DMR", "DSTAR", "NXDN", "P25", "YSF", "TETRA", "OLIVIA", "THOR", "MT63",
    "FSQ", "ALE", "CLOVER", "CHIRP", "COFDM", "LRPT", "DVB_S2", "LORA",
]
ANALOG_MODES = ["SSTV", "HELLSCHREIBER", "FELD_HELL", "SLOW_HELL"]  # all real here


def modulate(mode: str, framed: bytes, symbol_rate: int) -> np.ndarray:
    """Dispatch modulation by mode name; unknown modes raise ValueError."""
    spec = MODES.get(mode)
    if spec is None:
        raise ValueError(f"Unknown mode: {mode}")
    return spec.modulate(framed, symbol_rate)


def demodulate(mode: str, samples: np.ndarray, symbol_rate: int, device: DeviceLike = None) -> bytes:
    """Single-capture demodulation to the raw byte stream (the text modes:
    the decoded text as utf-8), on ``device`` (default: the card). Unknown
    modes fall back to QPSK, like the reference decoder."""
    spec = MODES.get(mode, MODES["QPSK"])
    return spec.demodulate(samples, symbol_rate, device=device)
