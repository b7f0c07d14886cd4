"""Shared by ``test_torch_fsk.py`` (CPU) and ``test_torch_cuda.py`` (card):
bit batches for the batched FSK sync tail (``ops.kernels.fsk_sync_pack_batch``)
and a numpy reference of what it computes, independent of the port.

The filler bits never hold the magic (every third bit is 1, and the magic
holds three zeros in a row), so each case's planted copies decide where
the first match lies; the case ``random`` uses plain random bits, which
may hold it by chance. The block edges are those of ``csrc/fsk_sync.cu``'s
scan, which walks the batch as one flat stream: 32 positions a thread,
1,024 a warp, 8,192 a block.
"""

import numpy as np

from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN

_MAGIC = np.array([int(c) for c in MAGIC_BIT_PATTERN], np.uint8)


def _straddle(row: int, n: int, edge: int) -> int:
    """The row position whose magic starts 5 bits before the first flat
    ``edge`` boundary inside the row."""
    return -(-(row * n + 6) // edge) * edge - 5 - row * n


# name -> (B, n, [(row, position of a planted magic), ...]); a plant that
# would run past the row's end is cut there (its part lies in the row).
CASES = {
    "at_0": (2, 4096, [(0, 0), (1, 0)]),
    "mid_row": (2, 4096, [(0, 1777), (1, 2048)]),
    "last_legal": (3, 4096, [(0, 4080), (1, 4080), (2, 4081)]),
    "straddles_edges": (3, 9000, [(0, 1019), (1, _straddle(1, 9000, 8192)), (2, _straddle(2, 9000, 32))]),
    "twice_first_wins": (2, 3000, [(0, 100), (0, 2000), (1, 2500), (1, 7)]),
    "nowhere": (2, 3000, []),
    "across_rows": (2, 500, [(0, 492)]),
    "short_rows": (3, 15, [(0, 0)]),
    "one_position": (2, 16, [(0, 0)]),
    "n_odd": (2, 1001, [(0, 985), (1, 3)]),
    "n_past_1024": (2, 2051, [(0, 2035), (1, 1024)]),
    "n_past_block": (2, 8197, [(0, 8181), (1, 8187)]),
    "tiny": (2, 1, []),
    "b1": (1, 3 * 8192 + 77, [(0, 12345)]),
    "b64": (64, 5000, [(r, (r * 77) % 4985) for r in range(63)]),
    "random": (4, 70001, [(1, 35000)]),
}


def case_bits(name: str) -> np.ndarray:
    """(B, n) uint8 0/1 bits of case ``name``, the same on every call."""
    b, n, plants = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    bits = rng.integers(0, 2, (b, n), dtype=np.uint8)
    if name != "random":
        bits[:, ::3] = 1
    for row, pos in plants:
        k = min(len(_MAGIC), n - pos)
        bits[row, pos : pos + k] = _MAGIC[:k]
    if name == "across_rows":  # the magic split across rows 0 and 1
        bits[1, :8] = _MAGIC[8:]
    return bits


def sync_pack_reference(bits: np.ndarray, pattern: str = MAGIC_BIT_PATTERN):
    """(packed, n_valid, found, start) by a string search and ``np.packbits``:
    each row from its first ``pattern`` (from 0 where it has none), MSB
    first, zero-filled to ``ceil(n / 1024) * 128`` bytes."""
    b, n = bits.shape
    n_out = -(-n // 1024) * 128
    packed = np.zeros((b, n_out), np.uint8)
    n_valid, found, start = np.zeros(b, np.int32), np.zeros(b, bool), np.zeros(b, np.int32)
    for i in range(b):
        p = "".join("1" if v else "0" for v in bits[i]).find(pattern)
        found[i], start[i] = p >= 0, max(p, 0)
        row = np.zeros(8 * n_out, np.uint8)
        row[: n - start[i]] = bits[i, start[i] :]
        packed[i] = np.packbits(row)
        n_valid[i] = (n - start[i]) // 8
    return packed, n_valid, found, start
