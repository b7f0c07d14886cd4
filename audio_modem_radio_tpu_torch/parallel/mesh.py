"""Device meshes, batch sharding and the in-process collectives.

Counterpart of ``audio_modem_radio_tpu/parallel/mesh.py``. The port runs a
mesh as single-process SPMD: one Python process drives every shard's
tensors on that shard's device, and the collectives are explicit
device-to-device copies (:func:`ppermute`, :func:`psum`,
:func:`all_gather` over lists of per-shard tensors). A device list may
repeat a device: four entries of the one card (or of the CPU) make a
virtual 4-shard mesh, the counterpart of the JAX package's virtual CPU
mesh; on a host with several cards the same list holds real cards.

The data-parallel batch runs each shard on a worker thread of its own
(:func:`run_shards`), so that real cards run at the same time. A decision
that the JAX package takes once over the whole global batch (a ``lax.cond``
on ``jnp.all(found)``) is taken here by :func:`agree_all`: inside
:func:`run_shards` it combines every shard's flag at a barrier before any
shard goes on; outside it, it returns the flag.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _normalize(device: DeviceLike) -> torch.device:
    """``device`` as a torch.device; a CUDA device without an index is the
    current card, so per-device caches see one key for it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> List[torch.device]:
    """The visible CUDA cards; raises when there is none (the CPU is used
    only when named)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An array of ``torch.device`` with named axes.

    ``devices`` is a numpy object array of the mesh's shape, ``shape`` an
    ordered dict of axis name to size, as the JAX ``Mesh`` has, and
    ``flat`` the devices in row-major order (the shard order)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device array for axes {tuple(axis_names)}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def get_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D data-parallel mesh over ``n_devices`` of ``devices`` (default:
    all visible cards)."""
    devs = [_normalize(d) for d in (devices if devices is not None else local_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (DATA_AXIS,))


def get_2d_mesh(data: int, model: int, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """(data, model) mesh for the learned modem's training step (dp x tp)."""
    devs = [_normalize(d) for d in (devices if devices is not None else local_devices())]
    if data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {len(devs)}")
    arr = np.empty(data * model, dtype=object)
    arr[:] = devs[: data * model]
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def batch_sharding(mesh: Mesh) -> Callable[[object], List[torch.Tensor]]:
    """The split of the leading (batch) axis over the mesh's data axis:
    ``place(x)`` gives one tensor per device in shard order, device (i, j)
    holding the i-th of ``mesh.shape["data"]`` equal row blocks (the model
    axis, if any, replicates). The leading axis must divide evenly
    (:func:`pad_batch`)."""
    n_data = mesh.shape[DATA_AXIS]

    def place(x) -> List[torch.Tensor]:
        t = _as_tensor(x)
        if t.shape[0] % n_data:
            raise ValueError(f"batch of {t.shape[0]} does not split over {n_data} shards")
        rows, per = t.shape[0] // n_data, mesh.size // n_data
        return [t[k // per * rows : (k // per + 1) * rows].to(dev) for k, dev in enumerate(mesh.flat)]

    return place


def replicated(mesh: Mesh) -> Callable[[object], List[torch.Tensor]]:
    """``place(x)``: a copy of ``x`` on every device, in shard order."""

    def place(x) -> List[torch.Tensor]:
        t = _as_tensor(x)
        return [t.to(dev) for dev in mesh.flat]

    return place


def pad_batch(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading axis with zeros to a multiple of ``multiple`` (the
    batch must divide evenly over the shards)."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width)


# --- collectives over lists of per-shard tensors -----------------------------------

def left_neighbour_perm(n: int) -> List[tuple]:
    """The circular halo permutation ``(i, (i-1) % n)``: each shard's value
    goes to its left neighbour, shard 0's to the last."""
    return [(i, (i - 1) % n) for i in range(n)]


def ppermute(xs: Sequence[torch.Tensor], perm: Optional[Sequence[tuple]] = None) -> List[torch.Tensor]:
    """``out[dst] = xs[src]`` on ``xs[dst]``'s device for each ``(src, dst)``
    of ``perm`` (default :func:`left_neighbour_perm`); a shard that no pair
    sends to gets zeros, as ``lax.ppermute`` gives."""
    n = len(xs)
    perm = left_neighbour_perm(n) if perm is None else perm
    out: List[Optional[torch.Tensor]] = [None] * n
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of every shard's value, in shard order, on every shard."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return [acc.to(x.device) for x in xs]


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's value stacked on a new leading axis, on every shard."""
    return [torch.stack([y.to(x.device) for y in xs]) for x in xs]


# --- data-parallel shard threads and their global decisions --------------------------

class _FlagReduce:
    """An all-reduce of host booleans among ``n`` shard threads: each
    thread posts its flag and waits at the barrier; every thread then reads
    the same conjunction. A thread that fails aborts the barrier, so that
    the others raise ``threading.BrokenBarrierError`` instead of waiting."""

    def __init__(self, n: int):
        self._flags = [True] * n
        self._barrier = threading.Barrier(n)

    def all(self, rank: int, flag: bool) -> bool:
        self._flags[rank] = bool(flag)
        self._barrier.wait()
        out = all(self._flags)
        self._barrier.wait()  # no thread posts its next flag before all have read
        return out

    def abort(self) -> None:
        self._barrier.abort()


_shard = threading.local()


def agree_all(flag: bool) -> bool:
    """``flag`` for every shard of the running :func:`run_shards` call:
    true only where every shard's is true (the JAX package's ``jnp.all``
    over the global batch). Outside a shard thread, ``flag`` itself. Every
    shard must make the same sequence of calls."""
    group = getattr(_shard, "group", None)
    if group is None:
        return bool(flag)
    return group.all(_shard.rank, flag)


def run_shards(fn: Callable[[int, torch.device], object], devices: Sequence[torch.device]) -> list:
    """``[fn(i, devices[i]) for i in shards]``, each on a thread of its own
    with its device current, the shards' :func:`agree_all` calls combined.
    The first failure is re-raised once every thread has ended (a shard
    that raises breaks the barrier, so no other shard waits for it)."""
    n = len(devices)
    if n == 1:
        return [fn(0, devices[0])]
    group = _FlagReduce(n)
    results: list = [None] * n
    errors: list = [None] * n

    def work(i: int) -> None:
        _shard.group, _shard.rank = group, i
        try:
            dev = devices[i]
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    results[i] = fn(i, dev)
            else:
                results[i] = fn(i, dev)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            group.abort()
        finally:
            _shard.group = None

    threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results
