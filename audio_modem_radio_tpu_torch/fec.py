"""Forward error correction of the PyTorch port: the parity-triplet code and
the K=7 convolutional code with its Viterbi decoder.

Counterpart of ``audio_modem_radio_tpu/fec.py``, whose host parts are
copied here bit for bit:

* :class:`ReedSolomonFEC`: the reference's parity-triplet wire format (byte
  pairs + XOR parity, 0xFF pad for odd length, CRC32 trailer, ``0x3F``
  substitution on a parity mismatch). Not Reed-Solomon; the name is the
  reference's.
* :class:`ConvolutionalEncoder`: rate 1/2, K=7, G1=0o171 / G2=0o133 with a
  6-bit zero flush, including the reference's low-bits trailing-byte
  packing quirk.
* :func:`viterbi_decode_bits`: the maximum-likelihood decoder of that code,
  hard or soft pairs, one block or the JAX package's block-parallel
  geometry, on the card through the hand-written kernel
  ``ops.kernels.fec_viterbi_blocks`` (``csrc/fec_viterbi.cu``); on the CPU,
  when named, through its plain version.
* :class:`ViterbiDecoder`: inputs longer than one block go to the native
  C++ sweep (``native.viterbi_decode_pairs``, exact over the whole length)
  when that library built, else to :func:`viterbi_decode_bits`. The two
  routes can give different bits on the same long input; the placement is
  the JAX package's.
* The pipeline containers (``FECP``/``FECV`` + encoded payload:
  :func:`wrap_fec`, :func:`unwrap_fec`) and stream FEC (the whole framed
  transmission coded, led by a plaintext ``FBPC`` sync magic:
  :func:`stream_fec_encode`, :func:`stream_fec_decode`,
  :func:`stream_fec_decode_soft`).

Every decoding function takes ``device=``: the card unless the caller
names the CPU.
"""

from __future__ import annotations

import functools
import logging
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops.kernels import fec_viterbi_blocks
from .utils.torchenv import DeviceLike, resolve_device

logger = logging.getLogger("audio_modem_radio_tpu_torch")

TAG_PARITY = b"FECP"
TAG_VITERBI = b"FECV"

G1 = 0o171  # 0b1111001
G2 = 0o133  # 0b1011011
K = 7
N_STATES = 1 << (K - 1)  # 64
FLUSH_BITS = K - 1  # 6


# --- parity-triplet code (reference "ReedSolomonFEC" wire format) -------------

class ReedSolomonFEC:
    """Parity-triplet code, wire-compatible with the reference.

    Each byte pair (a, b) transmits as (a, b, a^b); odd-length input pads
    with 0xFF; a CRC32 of the original data trails the stream. On decode, a
    corrupted triplet is detected (not correctable: one parity can't locate
    the error) and the second byte is replaced by ``0x3F`` exactly as the
    reference does.
    """

    def __init__(self, nsym: int = 32):
        self.nsym = nsym

    def encode(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, dtype=np.uint8)
        if len(arr) % 2:
            arr = np.concatenate([arr, np.asarray([0xFF], np.uint8)])
            # The reference packs the odd final byte as (byte, 0xFF) WITHOUT
            # a parity byte; mirror that exactly.
            pairs = arr[:-2].reshape(-1, 2)
            tail = arr[-2:]
        else:
            pairs = arr.reshape(-1, 2)
            tail = np.empty(0, np.uint8)
        triplets = np.column_stack([pairs, pairs[:, 0] ^ pairs[:, 1]])
        out = np.concatenate([triplets.reshape(-1), tail])
        crc = zlib.crc32(data) & 0xFFFFFFFF
        return out.tobytes() + struct.pack("<I", crc)

    def decode(self, data: bytes) -> bytes:
        if len(data) < 4:
            return data
        crc_expected = struct.unpack("<I", data[-4:])[0]
        body = np.frombuffer(data[:-4], dtype=np.uint8)
        n_triplets = len(body) // 3
        trip = body[: n_triplets * 3].reshape(-1, 3)
        rest = body[n_triplets * 3 :]
        bad = (trip[:, 0] ^ trip[:, 1]) != trip[:, 2]
        out_pairs = trip[:, :2].copy()
        out_pairs[bad, 1] = 0x3F  # '?' substitution, like the reference
        decoded = np.concatenate([out_pairs.reshape(-1), rest]).tobytes()
        self.last_crc_ok = (zlib.crc32(decoded) & 0xFFFFFFFF) == crc_expected
        if not self.last_crc_ok and decoded.endswith(b"\xff"):
            # Odd-length input carries an 0xFF pad byte the stream format
            # cannot distinguish from data; the CRC trailer can.
            stripped = decoded[:-1]
            if (zlib.crc32(stripped) & 0xFFFFFFFF) == crc_expected:
                self.last_crc_ok = True
                return stripped
        return decoded


# --- convolutional encoder ----------------------------------------------------

def _popcount_parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    count = np.zeros_like(x)
    for _ in range(K):
        count ^= x & 1
        x >>= 1
    return count.astype(np.uint8)


def _pack_bits_ref_style(bits: np.ndarray) -> bytes:
    """MSB-first byte packing; a trailing partial byte keeps its bits in the
    LOW positions (the reference's bit loop)."""
    n_full = (len(bits) // 8) * 8
    out = np.packbits(bits[:n_full]).tobytes()
    rem = bits[n_full:]
    if len(rem):
        val = 0
        for b in rem:
            val = (val << 1) | int(b)
        out += bytes([val])
    return out


def _unpack_bits_ref_style(data: bytes, n_bits: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits_ref_style` for a known bit count."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n_full_bytes = n_bits // 8
    bits = np.unpackbits(arr[:n_full_bytes])
    rem = n_bits - n_full_bytes * 8
    if rem:
        last = int(arr[n_full_bytes])
        tail = [(last >> (rem - 1 - i)) & 1 for i in range(rem)]
        bits = np.concatenate([bits, np.asarray(tail, np.uint8)])
    return bits


class ConvolutionalEncoder:
    """Rate-1/2, K=7 convolutional encoder (G1=0o171, G2=0o133, zero flush)."""

    def __init__(self, constraint_length: int = K):
        self.constraint_length = constraint_length
        self.g1, self.g2 = G1, G2

    def encode_bits(self, bits: np.ndarray) -> np.ndarray:
        """(T,) input bits -> (T+6, 2) output bit pairs, including flush.

        ``parity(reg & G)`` is the XOR of the register bits at G's set tap
        positions, so each output stream is <= K shifted-array XORs; no
        (T, K) register window is materialized.
        """
        bits = np.concatenate([bits.astype(np.uint8), np.zeros(FLUSH_BITS, np.uint8)])
        # Register after consuming bit t holds bits [t-6..t], newest in LSB:
        # register bit p is the input bit from p steps back.
        padded = np.concatenate([np.zeros(K - 1, np.uint8), bits])
        T = len(bits)

        def taps_xor(g: int) -> np.ndarray:
            acc = np.zeros(T, np.uint8)
            for p in range(K):
                if (g >> p) & 1:
                    acc ^= padded[K - 1 - p : K - 1 - p + T]
            return acc

        return np.stack([taps_xor(G1), taps_xor(G2)], axis=1)

    def encode(self, data: bytes) -> bytes:
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        pairs = self.encode_bits(bits)
        return _pack_bits_ref_style(pairs.reshape(-1))


# --- Viterbi decoder ------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _trellis_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Predecessor indices and expected output pairs for each new state.

    For new state s: input bit b = s & 1; predecessors p0 = s >> 1 and
    p1 = (s >> 1) | 32; the transition register is (p << 1) | b.
    """
    s = np.arange(N_STATES)
    b = s & 1
    p0 = s >> 1
    p1 = p0 | (N_STATES >> 1)
    reg0 = (p0 << 1) | b
    reg1 = (p1 << 1) | b
    exp0 = np.stack([_popcount_parity(reg0 & G1), _popcount_parity(reg0 & G2)], axis=1)
    exp1 = np.stack([_popcount_parity(reg1 & G1), _popcount_parity(reg1 & G2)], axis=1)
    return p0.astype(np.int32), p1.astype(np.int32), exp0.astype(np.float32), exp1.astype(np.float32)


# Block-parallel Viterbi geometry: blocks of CORE trellis steps decode
# independently with OV-step warmup/cooldown on each side; K=7 survivor
# paths merge within ~5K steps, so 512 is a deep safety margin.
_VIT_CORE = 1 << 13
_VIT_OV = 512


def viterbi_decode_bits(pairs, known_boundaries: bool = True, device: DeviceLike = None) -> np.ndarray:
    """Maximum-likelihood decode of (T, 2) received bit pairs -> (T,) uint8
    bits, on ``device`` (default: the card).

    ``pairs`` (numpy or a tensor) may be hard bits {0,1} or soft values in
    [0,1]; the branch metric is the L1 distance to each transition's
    expected output. ``known_boundaries=True`` assumes the encoder starts
    and ends in state 0 (the framed-container case); ``False`` uses a
    uniform start metric and traces back from the best end state, for a
    coded segment embedded mid-stream (stream FEC).

    Inputs of at most ``_VIT_CORE + 2*_VIT_OV`` pairs decode as one block.
    Longer ones decode block-parallel, as in the JAX package: blocks of
    ``_VIT_CORE`` steps with ``_VIT_OV`` steps of warmup and cooldown on each
    side (0.5, the uninformative soft value, outside the stream), each from
    zero metrics and its best end state whatever ``known_boundaries`` says,
    keeping only the cores. Either way one launch of
    ``ops.kernels.fec_viterbi_blocks``; none for T = 0.
    """
    dev = resolve_device(device)
    if isinstance(pairs, torch.Tensor):
        p = pairs.to(device=dev, dtype=torch.float32)
    else:
        p = torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.float32)).to(dev)
    p = p.reshape(-1, 2)
    T = p.shape[0]
    if T == 0:
        return np.zeros(0, np.uint8)
    if T <= _VIT_CORE + 2 * _VIT_OV:
        bits = fec_viterbi_blocks(p[None].contiguous(), known_boundaries)
        return bits[0].cpu().numpy()

    core, ov = _VIT_CORE, _VIT_OV
    n_blocks = -(-T // core)
    padded = F.pad(p, (0, 0, ov, n_blocks * core - T + ov), value=0.5)
    idx = torch.arange(core + 2 * ov, device=dev)[None, :] + core * torch.arange(n_blocks, device=dev)[:, None]
    bits = fec_viterbi_blocks(padded[idx], False)  # blocks (n_blocks, core + 2ov, 2)
    return bits[:, ov : ov + core].reshape(-1)[:T].cpu().numpy()


class ViterbiDecoder:
    """Viterbi decoder for the K=7 rate-1/2 code above, on ``device``
    (default: the card) where the input goes to :func:`viterbi_decode_bits`."""

    def __init__(self, constraint_length: int = K, device: DeviceLike = None):
        self.constraint_length = constraint_length
        self.g1, self.g2 = G1, G2
        self.device = device

    def decode_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """(T, 2) bit pairs (hard or soft) -> (T - 6,) data bits.

        Inputs longer than one block go to the native C++ sweep
        (``native.viterbi_decode_pairs``: one exact full-length pass, double
        metrics, no blocks) when that library built; the rest, and every
        input when it did not, to :func:`viterbi_decode_bits` on the card.
        Both implement the same metric and tie rule, but the block geometry
        of the card path can give other bits on a long noisy input.
        """
        if pairs.shape[0] > _VIT_CORE + 2 * _VIT_OV:
            from . import native

            decoded_n = native.viterbi_decode_pairs(np.asarray(pairs), known_boundaries=True)
            if decoded_n is not None:
                logger.debug("Viterbi: %d pairs through the native sweep", pairs.shape[0])
                return decoded_n[: max(0, len(decoded_n) - FLUSH_BITS)]
        logger.debug("Viterbi: %d pairs through viterbi_decode_bits", pairs.shape[0])
        decoded = viterbi_decode_bits(pairs, device=self.device)
        return decoded[: max(0, len(decoded) - FLUSH_BITS)]

    def decode(self, data: bytes, n_data_bytes: Optional[int] = None) -> bytes:
        """Decode a byte stream produced by :meth:`ConvolutionalEncoder.encode`.

        The encoded stream for n data bytes is exactly 2n+2 bytes
        (16n+12 bits); ``n_data_bytes`` overrides the inferred length when the
        stream was truncated or padded in transit.
        """
        if n_data_bytes is None:
            n_data_bytes = max(0, (len(data) - 2) // 2)
        n_bits = 16 * n_data_bytes + 2 * FLUSH_BITS
        if len(data) * 8 < n_bits:
            n_data_bytes = max(0, (len(data) * 8 - 2 * FLUSH_BITS) // 16)
            n_bits = 16 * n_data_bytes + 2 * FLUSH_BITS
        pairs = _unpack_bits_ref_style(data, n_bits).reshape(-1, 2)
        bits = self.decode_pairs(pairs)[: n_data_bytes * 8]
        return np.packbits(bits).tobytes()


# --- pipeline container layer -------------------------------------------------

def wrap_fec(payload: bytes, fec_type: str) -> bytes:
    """Wrap a payload in a tagged FEC container ('reed_solomon'|'convolutional')."""
    if fec_type == "convolutional":
        return TAG_VITERBI + ConvolutionalEncoder().encode(payload)
    return TAG_PARITY + ReedSolomonFEC().encode(payload)


def unwrap_fec(blob: bytes, device: DeviceLike = None) -> Optional[bytes]:
    """Decode a tagged FEC container; None if the tag is absent."""
    if blob.startswith(TAG_VITERBI):
        return ViterbiDecoder(device=device).decode(blob[4:])
    if blob.startswith(TAG_PARITY):
        return ReedSolomonFEC().decode(blob[4:])
    return None


# --- stream-level FEC -----------------------------------------------------------

def stream_fec_encode(framed: bytes) -> bytes:
    """Convolutionally encode an ENTIRE framed transmission (rate 1/2).

    Unlike the payload container (wrap_fec), this protects the frame
    header, magic and CRCs too. The coded stream carries no plaintext frame
    magic, so receivers must know stream FEC is in use (an explicit config,
    like mode and rate). A plaintext ``FBPC`` sync magic leads it, so the
    demodulators' magic sync locks there and hands back a byte-aligned
    stream instead of false-firing on random coded bits.
    """
    bits = np.unpackbits(np.frombuffer(framed, np.uint8))
    pairs = ConvolutionalEncoder().encode_bits(bits)  # (T+6, 2)
    return b"FBPC" + np.packbits(pairs.reshape(-1)).tobytes()


def stream_fec_decode(raw: bytes, max_bits: Optional[int] = None, device: DeviceLike = None) -> bytes:
    """Viterbi-decode a demodulated byte stream that carries stream FEC.

    The coded stream leads with a plaintext sync magic per transmission; a
    capture can hold several back-to-back transmissions, so each
    marker-delimited segment decodes on its own and the outputs are
    concatenated (a Viterbi run across a segment boundary would corrupt the
    next frame's head). Within a segment the code-symbol pairing phase is
    unknown: both phases decode with free boundaries and the phase whose
    output holds the frame magic wins. ``max_bits`` optionally caps the
    decoded span per segment (default: unbounded).
    """
    marks = []
    j = raw.find(b"FBPC")
    while j >= 0:
        marks.append(j)
        j = raw.find(b"FBPC", j + 4)
    if len(marks) > 1 or (len(marks) == 1 and marks[0] > 0):
        out = b""
        bounds = marks + [len(raw)]
        for a, b in zip(marks, bounds[1:]):
            out += _stream_fec_decode_segment(raw[a + 4 : b], max_bits, device)
        return out
    if marks:
        raw = raw[4:]
    return _stream_fec_decode_segment(raw, max_bits, device)


def stream_fec_decode_soft(soft_bits: np.ndarray, max_bits: Optional[int] = None,
                           device: DeviceLike = None) -> bytes:
    """Soft-decision stream FEC decode from a [0,1] soft bit stream.

    The stream is located by hard-thresholding a copy and finding the
    plaintext sync magic at the bit level; the SOFT values from there feed
    the decoder (the L1 branch metric uses the confidence directly).
    Single-segment: the hard byte path stays the multi-segment workhorse,
    with this as the low-SNR escalation.
    """
    soft = np.asarray(soft_bits, np.float32)
    if max_bits is not None:
        soft = soft[:max_bits]
    hard = (soft > 0.5).astype(np.uint8)
    magic = np.unpackbits(np.frombuffer(b"FBPC", np.uint8))
    start = 0
    if len(hard) > len(magic):
        win = np.lib.stride_tricks.sliding_window_view(hard, len(magic))
        hits = np.nonzero((win == magic).all(axis=1))[0]
        if len(hits):
            start = int(hits[0]) + len(magic)  # skip the plaintext sync
    return _decode_bit_stream(soft[start:], max_bits, device)


def _stream_fec_decode_segment(raw: bytes, max_bits: Optional[int], device: DeviceLike = None) -> bytes:
    """Viterbi-decode one coded segment (both pair phases, bit-aligned)."""
    if max_bits is not None:
        raw = raw[: max_bits // 8]
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    return _decode_bit_stream(bits, max_bits, device)


def _decode_bit_stream(bits: np.ndarray, max_bits: Optional[int], device: DeviceLike = None) -> bytes:
    """Shared hard/soft segment decoder: both pair phases, free boundaries,
    bit-level frame-magic alignment in the decoded output."""
    magic = np.unpackbits(np.frombuffer(b"FBPC", np.uint8))
    best = b""
    for phase in (0, 1):
        usable = bits[phase:]
        usable = usable[: (len(usable) // 2) * 2]
        if len(usable) < 64:
            continue
        decoded = viterbi_decode_bits(usable.reshape(-1, 2), known_boundaries=False, device=device)
        # The frame can sit at ANY bit offset of the decoded stream (leading
        # channel garbage shifts it); align on the magic at the bit level.
        start = 0
        if len(decoded) >= len(magic):
            win = np.lib.stride_tricks.sliding_window_view(decoded, len(magic))
            hits = np.nonzero((win == magic).all(axis=1))[0]
            if len(hits):
                start = int(hits[0])
        aligned = decoded[start:]
        out = np.packbits(aligned[: (len(aligned) // 8) * 8]).tobytes()
        if out.startswith(b"FBPC"):
            return out
        if phase == 0:
            best = out
    return best
