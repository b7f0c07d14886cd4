"""Entry points: the single-device forward and the multi-device dry run.

:func:`entry` returns the port's main forward, the batched QPSK
demodulate + sync + pack of ``parallel.batch.demod_pack_batch``, with an
example batch on the card.

:func:`dryrun_multichip` builds an ``n``-shard mesh and runs the three
parallel workloads on small shapes:

* the batched demodulation, data-parallel over captures (each shard's rows
  on its own device and thread, the batch-wide decisions taken once);
* sequence parallelism: ONE capture with its sample axis sharded, for each
  of the seven shardable families (halo ``ppermute``, ``psum`` and
  ``all_gather`` consensus; ``parallel/sequence.py``);
* one training step of the learned modem on a (data x model) mesh: the
  batch split over ``data``, the Dense layers' outputs over ``model``,
  the gradients summed over ``data`` before one Adam step.

The shards are real cards where enough are visible, otherwise the one
card repeated (a virtual mesh); ``device="cpu"`` repeats the CPU.

    python -m audio_modem_radio_tpu_torch.entry
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .utils.torchenv import DeviceLike, resolve_device


def entry(device: DeviceLike = None):
    """Return ``(fn, example_args)``: ``demod_pack_batch(x, "QPSK", 9600)``
    and a (4, 2^16) float32 zero batch on ``device`` (default: the card)."""
    from .parallel.batch import demod_pack_batch

    dev = resolve_device(device)

    def forward(samples: torch.Tensor):
        packed, n_valid, found = demod_pack_batch(samples, "QPSK", 9600)
        return packed, n_valid, found

    return forward, (torch.zeros((4, 1 << 16), dtype=torch.float32, device=dev),)


def _mesh_devices(n_devices: int, device: DeviceLike = None) -> List[torch.device]:
    """``n_devices`` shard devices: with no ``device`` named, the visible
    cards when there are enough, else the cards repeated in turn (a virtual
    mesh); a named device repeated. Prints which."""
    if device is not None:
        dev = resolve_device(device)
        print(f"dryrun_multichip: {n_devices} shards on {dev} (virtual mesh)")
        return [dev] * n_devices
    resolve_device(None)
    n_cards = torch.cuda.device_count()
    devs = [torch.device("cuda", i % n_cards) for i in range(n_devices)]
    kind = "real cards" if n_cards >= n_devices else f"virtual mesh over {n_cards} card(s)"
    print(f"dryrun_multichip: {n_devices} shards on {kind}: {[str(d) for d in devs]}")
    return devs


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Run the sharded pipelines on an ``n_devices``-shard mesh (see the
    module docstring); raises on any failed check."""
    from .framing import crc32, pack_frame, parse_frames
    from .models.neural_modem import create_train_state, make_train_step
    from .modem import modulate
    from .ops.hell import hellschreiber_modulate
    from .parallel.batch import demod_pack_batch
    from .parallel.mesh import batch_sharding, get_2d_mesh, get_mesh, run_shards
    from .parallel.sequence import decode_capture_sharded

    devices = _mesh_devices(n_devices, device)

    # --- 1. data-parallel batched demod ---------------------------------------
    mesh = get_mesh(n_devices, devices)
    payload = b"dryrun payload " * 4
    framed = pack_frame("d.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate("QPSK", framed, 9600), np.float32)
    n = 1 << 14
    batch = np.zeros((n_devices, n), np.float32)
    batch[:, : min(len(wave), n)] = wave[:n]
    xs = batch_sharding(mesh)(batch)
    outs = run_shards(lambda i, dev: demod_pack_batch(xs[i], "QPSK", 9600), mesh.flat)
    _check(all(bool(found.all()) for _p, _v, found in outs), "sharded demod lost frame sync")

    # --- 2. sequence parallelism: ONE capture sharded over the mesh ------------
    for mode, rate in (("QPSK", 9600), ("FSK1200", 1200), ("OFDM4", 4800), ("8PSK", 9600), ("DSSS", 9600),
                       ("NEURAL", 1200)):
        w = np.asarray(modulate(mode, framed, rate), np.float32)
        raw = decode_capture_sharded(w, mode, rate, mesh)
        _check(bool(parse_frames(raw)), f"sequence-parallel {mode} decode lost the frame")
    text = "DRYRUN HELL"
    out_h = decode_capture_sharded(np.asarray(hellschreiber_modulate(text), np.float32), "HELLSCHREIBER", 1200, mesh)
    _check(out_h.decode("utf-8") == text, "sequence-parallel HELL text mismatch")

    # --- 3. dp x tp training step of the learned modem -------------------------
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_par = n_devices // model_par
    mesh2 = get_2d_mesh(data_par, model_par, devices)
    model, opt = create_train_state(0, bits_per_symbol=4, hidden=64, samples_per_symbol=8, device=devices[0])
    step = make_train_step(model, opt, mesh=mesh2)
    gen = torch.Generator(device=devices[0]).manual_seed(1)
    loss, _acc = step(torch.zeros((8 * data_par,), dtype=torch.int64, device=devices[0]), 0.1, gen)
    _check(bool(np.isfinite(float(loss))), "training step produced non-finite loss")

    print(
        f"dryrun_multichip OK on {n_devices} devices "
        f"(demod dp={n_devices}; sequence-parallel sp={n_devices} over 7 "
        f"families [QPSK, FSK1200, OFDM4, 8PSK, DSSS, NEURAL, HELL] with "
        f"ppermute halo + psum/all_gather consensus; train dp={data_par} x "
        f"tp={model_par}, loss={float(loss):.3f})"
    )


def main() -> int:
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    _check(out[0].shape[0] == args[0].shape[0], "entry() returned another batch size")
    print("entry() compiled and ran")
    dryrun_multichip(torch.cuda.device_count())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
