"""The one traffic generator: a mix's parameters and a configuration -> captures.

A mix (``traffic/<name>.json``) fixes the archive: ``captures`` captures
of ``samples`` samples, decoded in calls of ``batch`` captures (the
harness's key; all of them in one call where it is absent); a lead of
silence drawn from ``lead_samples`` [lo, hi]; every ``noise_every``-th capture (the last of each group) holds
noise only; ``offset_hz`` maps a capture index to a carrier offset; white
noise at ``snr_db`` over the full band; ``part_bytes`` of payload per frame.

Each signal capture carries a file of its own, drawn from the seed, sent as
consecutive parts framed as the upstream encoder frames a multi-part file
(``<name>.partN``, the whole file's size and CRC). The transmission starts
after the lead and runs to the capture's end, so its last part is cut. The
family's transmitter (``transmit/<family>.py``) modulates it on the device.
The sizes depend on the mix alone; the seed moves only the bytes, the leads
and the noise. Each capture draws its bytes and noise from a generator of
its own (seeded from the run's seed and the capture's index), so any range
of captures can be made alone and comes out as it does in the whole batch:
set-up makes the batch in chunks, and the check remakes them after the
window.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .channel import add_noise_and_clip
from .frames import Frame, crc32, pack_frame


@dataclass
class Traffic:
    captures: np.ndarray  # (B, N) float32, what a recording holds
    sent: List[List[Frame]]  # per capture, every frame transmitted whole or cut
    leads: List[int]
    offsets_hz: List[int]
    noise_only: List[bool]


def transmitter(cfg: dict):
    return importlib.import_module(f"{__package__}.transmit.{cfg['family']}")


def _bits(data: bytes, device) -> torch.Tensor:
    b = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    return ((b[:, None] >> torch.arange(7, -1, -1, device=device, dtype=torch.uint8)) & 1).reshape(-1)


def capture_seed(seed: int, i: int) -> int:
    """The seed of capture ``i``'s own generator."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1, np.uint64)[0] >> 1)


def build(cfg: dict, mix: dict, seed: int, device, indices: Sequence[int] = None) -> Traffic:
    """The mix's captures ``indices`` (default: the whole batch), in that order."""
    tx = transmitter(cfg)
    n_cap, n = int(mix["captures"]), int(mix["samples"])
    indices = range(n_cap) if indices is None else [int(i) for i in indices]
    lo, hi = (int(v) for v in mix["lead_samples"])
    every = int(mix["noise_every"])
    offsets = {int(k): int(v) for k, v in mix.get("offset_hz", {}).items()}
    part = int(mix["part_bytes"])
    rng = np.random.default_rng(seed)
    leads = [int(v) for v in rng.integers(lo, hi + 1, size=n_cap)]
    noise_only = [i % every == every - 1 for i in range(n_cap)]
    sigma = (tx.nominal_power(cfg) / 10 ** (float(mix["snr_db"]) / 10)) ** 0.5

    name0 = f"capture{n_cap - 1:03d}.bin.part0000"
    frame_bytes = 4 + 1 + len(name0) + 24 + part
    n_parts = -(-tx.payload_bits(n, cfg) // 8 // frame_bytes) + 1

    # Pinned host memory when the captures are made on the card: the copy
    # back is then a fast DMA. The program sees an ordinary numpy array.
    pinned = torch.device(device).type == "cuda"
    captures = torch.empty((len(indices), n), dtype=torch.float32, pin_memory=pinned)
    sent: List[List[Frame]] = []
    for row, i in enumerate(indices):
        gen = torch.Generator(device=device).manual_seed(capture_seed(seed, i))
        data = torch.randint(0, 256, (n_parts * part,), generator=gen, device=device,
                             dtype=torch.uint8).cpu().numpy().tobytes()
        x = torch.zeros(n, dtype=torch.float32, device=device)
        frames: List[Frame] = []
        if not noise_only[i]:
            name, fcrc = f"capture{i:03d}.bin", crc32(data)
            frames = [Frame(f"{name}.part{k + 1}", k, n_parts, len(data), fcrc, data[k * part : (k + 1) * part])
                      for k in range(n_parts)]
            stream = b"".join(pack_frame(f) for f in frames)
            x = tx.modulate(_bits(stream, device), n, leads[i], offsets.get(i, 0), cfg)
        captures[row].copy_(add_noise_and_clip(x, sigma, gen))
        sent.append(frames)
    return Traffic(captures.numpy(), sent, [leads[i] for i in indices], [offsets.get(i, 0) for i in indices],
                   [noise_only[i] for i in indices])
