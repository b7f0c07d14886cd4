"""Decode-side host helpers of the PyTorch port: bucket padding and saving.

Counterpart of ``audio_modem_radio_tpu/decoder.py:45-62, 81-89, 339-411``.
The recovery ladder (header-tolerant parse, payload and stream FEC, the
clock-drift retry) is not ported yet; neither is the FEC decoder, so a frame
whose payload carries an ``FECP``/``FECV`` container is logged and left
unsaved.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from .assembly import AssemblyRegistry, registry as default_registry
from .config import CONFIG
from .framing import Frame
from .utils.compression import intelligent_decompress

logger = logging.getLogger("audio_modem_radio_tpu_torch")

RECV_DIR = "recv"
_FEC_TAGS = (b"FECP", b"FECV")


def pad_to_bucket(samples: np.ndarray) -> np.ndarray:
    """Zero-pad to the next configured bucket length, so batches of similar
    captures share one shape."""
    buckets: Sequence[int] = CONFIG.get("tpu.batch_bucket_sizes") or []
    n = len(samples)
    for b in sorted(buckets):
        if n <= b:
            if n == b:
                return samples
            return np.concatenate([samples, np.zeros(b - n, dtype=samples.dtype)])
    return samples  # beyond the largest bucket: use the exact length


def _safe_name(name: str) -> str:
    return "".join(c for c in name if c.isalnum() or c in (" ", "-", "_", "."))


def save_decoded_files(
    frames: List[Frame],
    recv_dir: str = RECV_DIR,
    registry: Optional[AssemblyRegistry] = None,
) -> List[str]:
    """Persist parsed frames: single-part directly, multi-part via assembly.

    Completed multi-part files decompress-then-save just like single parts;
    expired assemblies are purged on every call.
    """
    reg = registry or default_registry
    os.makedirs(recv_dir, exist_ok=True)
    saved: List[str] = []

    for frame in frames:
        if frame.data[:4] in _FEC_TAGS:
            logger.warning(
                "frame %s carries an FEC container, which the PyTorch port does not "
                "decode yet; left unsaved", frame.name,
            )
            continue
        try:
            if frame.is_multipart:
                # Parts are compressed one by one at encode time, so each is
                # decompressed before it joins the assembly.
                part_data = intelligent_decompress(frame.data)
                complete = reg.offer(
                    Frame(
                        frame.name,
                        part_data,
                        frame.part_number,
                        frame.total_parts,
                        frame.file_size,
                        frame.file_crc,
                    )
                )
                if complete is None:
                    continue
                final = complete
                base = frame.name.rsplit(".part", 1)[0]
            else:
                final = intelligent_decompress(frame.data)
                base = frame.name
                reg.stats["total_files"] += 1
                reg.stats["total_bytes"] += len(final)
                reg.stats["last_reception"] = time.time()
            path = os.path.join(recv_dir, f"recv_{int(time.time())}_{_safe_name(base)}")
            k = 1
            while os.path.exists(path):  # same name in the same second
                path = os.path.join(recv_dir, f"recv_{int(time.time())}_{k}_{_safe_name(base)}")
                k += 1
            with open(path, "wb") as f:
                f.write(final)
            saved.append(path)
        except Exception:
            logger.exception("failed to save decoded file %s", frame.name)

    reg.purge_expired()
    if frames:
        reg.stats["success_rate"] = (len(saved) / len(frames)) * 100
    return saved
