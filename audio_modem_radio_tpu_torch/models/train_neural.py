"""Train the NEURAL-mode constellation and export its codebook.

Counterpart of ``audio_modem_radio_tpu/models/train_neural.py``. What the
learned modem deploys is not the network but its *codebook*: the encoder
evaluated once over the symbol alphabet (2^bits codewords of
2*samples_per_symbol reals, each of unit average power). Modulation is
then a gather and demodulation one product and argmax against the table,
the nearest codeword under AWGN, since all codewords have equal norm; that
is the program ``ops/neural.py`` runs.

Usage::

    python -m audio_modem_radio_tpu_torch.models.train_neural [--steps 3000]
        [--bits 8] [--noise 0.35] [--device cpu] [--out <path>.npz]

The default output is the codebook the port ships,
``audio_modem_radio_tpu_torch/data/neural_codebook.npz``; a run with
``--out`` elsewhere leaves it as it is.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEFAULT_CODEBOOK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                                "neural_codebook.npz")


def train_and_export(
    out_path: str = DEFAULT_CODEBOOK,
    bits_per_symbol: int = 8,
    hidden: int = 256,
    samples_per_symbol: int = 8,
    n_steps: int = 3000,
    batch_size: int = 1024,
    noise_std: float = 0.35,
    seed: int = 0,
    device=None,
) -> dict:
    """Train the autoencoder modem on ``device`` (default: the card),
    evaluate the codebook's nearest-codeword symbol error rate at the
    training noise and write the ``.npz``. Returns ``{"codebook", "ser",
    "acc", "steps_per_s"}``."""
    import torch

    from .neural_modem import create_train_state, make_train_step

    model, opt = create_train_state(seed, bits_per_symbol=bits_per_symbol, hidden=hidden,
                                    samples_per_symbol=samples_per_symbol, device=device)
    dev = next(model.parameters()).device
    step = make_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    n_sym = 1 << bits_per_symbol
    loss = acc = None
    t0 = time.perf_counter()
    for i in range(n_steps):
        symbols = torch.randint(0, n_sym, (batch_size,), generator=gen, device=dev)
        loss, acc = step(symbols, noise_std, gen)
        if i % 500 == 0:
            print(f"step {i}: loss={float(loss):.4f} acc={float(acc):.4f}", flush=True)
    loss, acc = float(loss), float(acc)
    steps_per_s = n_steps / (time.perf_counter() - t0)

    with torch.no_grad():
        codebook = model.modulate_symbols(torch.arange(n_sym, device=dev)).cpu().numpy().astype(np.float32)
    # Unit average power per codeword (the encoder's head guarantees it).
    powers = np.mean(codebook**2, axis=-1)
    if not np.allclose(powers, 1.0, atol=1e-3):
        raise RuntimeError("codewords not power-normalized")

    # Nearest-codeword symbol error rate at the training noise level.
    rng_np = np.random.default_rng(seed + 1)
    tx_syms = rng_np.integers(0, n_sym, 4096)
    rx = codebook[tx_syms] + rng_np.normal(0, noise_std, (4096, codebook.shape[1]))
    decided = np.argmax(rx @ codebook.T, axis=-1)
    ser = float(np.mean(decided != tx_syms))

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(
        out_path,
        codebook=codebook,
        bits_per_symbol=bits_per_symbol,
        samples_per_symbol=samples_per_symbol,
        train_noise_std=noise_std,
        train_steps=n_steps,
        train_final_loss=loss,
        train_final_acc=acc,
        nearest_codeword_ser=ser,
    )
    print(
        f"exported {out_path}: {n_sym} codewords x {codebook.shape[1]} dims, "
        f"train acc={acc:.4f}, nearest-codeword SER@sigma={noise_std}: {ser:.4f}"
    )
    return {"codebook": codebook, "ser": ser, "acc": acc, "steps_per_s": steps_per_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--sps", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.35)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_CODEBOOK)
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    train_and_export(
        args.out, args.bits, args.hidden, args.sps, args.steps, args.batch,
        args.noise, args.seed, device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
