"""Multi-host batch decode: the capture farm past one host.

Counterpart of ``audio_modem_radio_tpu/parallel/multihost.py``. Captures
are independent, so nothing of the hot path crosses hosts: each process
decodes its own share of the global WAV list on its own cards through the
single-host pipeline, and the only traffic between processes is the job
setup and one gather of the saved-file manifests, over
``torch.distributed`` with the gloo backend.

* :func:`initialize`: ``torch.distributed.init_process_group("gloo")`` from
  explicit arguments or a launcher's environment; a no-op on one host.
* :func:`partition_files`: the deterministic round-robin share of the list
  by process rank (round robin balances mixed-length capture sets).
* :func:`decode_wav_batch_multihost`: partition, decode locally on a mesh
  of this process's cards, then gather every process's manifest in rank
  order, so that every process returns the global list.

With one process the partition and the gather are the identity.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

from ..utils.torchenv import DeviceLike

logger = logging.getLogger("audio_modem_radio_tpu_torch")

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (gloo); a no-op when already joined.

    With ``coordinator_address`` (``host:port``) and the counts, the group
    meets at ``tcp://host:port``; without them, under a launcher's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), it meets there; with neither, this is a single-host run and
    nothing is done but a log line."""
    import torch.distributed as dist

    if _initialized():
        return
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in _ENV):
            logger.info("torch.distributed not configured (no %s); running single-host", "/".join(_ENV))
            return
        dist.init_process_group("gloo", init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and process_id together")
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=addr, world_size=int(num_processes), rank=int(process_id))


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def partition_files(paths: Sequence[str], process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """This process's share of the global WAV list: deterministic, disjoint
    and, over all processes, exhaustive."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return list(paths[pid::n])


def decode_wav_batch_multihost(
    paths: Sequence[str],
    mode: str,
    symbol_rate: int,
    recv_dir: Optional[str] = None,
    registry=None,
    gather_manifest: bool = True,
    device: DeviceLike = None,
) -> List[str]:
    """Decode a GLOBAL list of WAVs across all processes; returns saved paths.

    Each process decodes ``partition_files(paths)`` through
    ``decode_wav_batch`` on a mesh of its own cards (``device`` names one
    device instead, ``"cpu"`` for a host without a card). With
    ``gather_manifest`` every process returns the union of all processes'
    saved paths, in rank order; otherwise its own."""
    from ..decoder import RECV_DIR
    from .batch import decode_wav_batch
    from .mesh import get_mesh

    mine = partition_files(paths)
    saved_local: List[str] = []
    if mine:
        mesh = get_mesh(devices=None if device is None else [device])
        results = decode_wav_batch(mine, mode, symbol_rate, recv_dir=recv_dir or RECV_DIR, registry=registry,
                                   mesh=mesh)
        saved_local = [p for r in results for p in r]
    if not gather_manifest or process_count() == 1:
        return saved_local

    # One small control-plane gather: each process's manifest, in rank order.
    import torch.distributed as dist

    gathered: list = [None] * process_count()
    dist.all_gather_object(gathered, saved_local)
    return [p for part in gathered for p in part]
