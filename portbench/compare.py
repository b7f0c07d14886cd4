"""The comparison that decides ``correct``.

What the timed path returned for a batch (packed bytes, n_valid, found) is
held against the plain reference's answer for the same captures:

- ``bytes_differ_share``: the worst capture's share of bytes within
  n_valid that differ from the reference's; a capture whose found or
  n_valid differs counts as 1. Its limit lies between what sound runs read
  (near ties of float32 rounding) and what the TF32 control reads.
- ``frames_missed``: CRC-valid frames the reference recovers that the
  program's bytes lack. The configuration's guarantee sets its limit, 0.
- ``frames_invented``: CRC-valid frames in the program's bytes that were
  never sent. Limit 0, by the same guarantee.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .frames import Frame, parse_frames

NUMBERS = ("bytes_differ_share", "frames_missed", "frames_invented")


def frames(packed: np.ndarray, n_valid: np.ndarray) -> List[set]:
    return [set(parse_frames(packed[i, : int(n_valid[i])].tobytes())) for i in range(packed.shape[0])]


def byte_shares(got: dict, ref: dict) -> np.ndarray:
    """Per capture, the share of bytes that differ (1 where found or n_valid differs)."""
    out = np.ones(len(ref["n_valid"]))
    for i, n in enumerate(ref["n_valid"]):
        n = int(n)
        if n > 0 and int(got["n_valid"][i]) == n and bool(got["found"][i]) == bool(ref["found"][i]):
            out[i] = np.count_nonzero(got["packed"][i, :n] != ref["packed"][i, :n]) / n
    return out


def compare(got: dict, ref: dict, sent: Sequence[Sequence[Frame]], ref_frames: List[set] = None) -> Dict[str, float]:
    """The numbers of one batch's answer ``got`` against the reference ``ref``."""
    ref_frames = ref_frames if ref_frames is not None else frames(ref["packed"], ref["n_valid"])
    got_frames = frames(got["packed"], got["n_valid"])
    return {
        "bytes_differ_share": float(byte_shares(got, ref).max()),
        "frames_missed": sum(len(r - g) for r, g in zip(ref_frames, got_frames)),
        "frames_invented": sum(len(g - set(s)) for g, s in zip(got_frames, sent)),
    }


def judge(readings: List[Dict[str, float]], limits: Dict[str, float]) -> Dict[str, dict]:
    """The worst reading of each number over the compared batches, beside its limit."""
    return {k: {"value": max(r[k] for r in readings), "limit": limits[k]} for k in NUMBERS}
