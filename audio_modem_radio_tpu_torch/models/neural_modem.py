"""Neural modem: the reference-compatible toy API and a trainable modem.

Counterpart of ``audio_modem_radio_tpu/models/neural_modem.py``. Two layers:

* :func:`neural_modulate` / :func:`neural_demodulate`: the reference's toy
  behaviour (bytes ridden on a carrier as amplitudes, envelope detection
  back), the same numpy code; the demodulator's moving average runs on a
  torch device.
* :class:`LearnedModem`: an autoencoder over an AWGN channel in
  ``torch.nn``. The encoder MLP maps a one-hot k-bit symbol to a
  unit-power I/Q waveform, the decoder MLP recovers the symbol. Its
  layers start as flax's ``Dense`` does (lecun-normal kernels truncated at
  two standard deviations, zero biases), :func:`params_from_flax` carries a
  flax parameter tree across, and :func:`make_train_step` builds the
  cross-entropy step, also sharded over a (data x model) mesh. The trained
  encoder, evaluated once over the alphabet, is the codebook NEURAL ships
  (``models/train_neural.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, psum
from ..utils.torchenv import DeviceLike, resolve_device

# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated lecun-normal divides by it so the kept samples have variance
# 1/fan_in.
_TRUNC_STD = 0.87962566103423978


# --- reference-compatible toy API ---------------------------------------------

def bytes_to_iq(data_bytes: bytes, seq_len: int = 1024) -> np.ndarray:
    """bytes -> normalized amplitudes on a 5 Hz complex carrier."""
    amp = np.frombuffer(data_bytes, dtype=np.uint8).astype(np.float32) / 255.0
    amp = np.pad(amp, (0, max(0, seq_len - len(amp))))[:seq_len]
    t = np.linspace(0, 1, seq_len)
    return amp * np.cos(2 * np.pi * 5 * t) + 1j * amp * np.sin(2 * np.pi * 5 * t)


def iq_to_bytes(iq_signal: np.ndarray) -> bytes:
    amp = np.abs(iq_signal)
    return (amp * 255).astype(np.uint8).tobytes()


def neural_modulate(data_bytes: bytes, symbol_rate: int = 8000) -> np.ndarray:
    """Toy modulation: I/Q on an 8 kHz carrier, normalized to 0.8 peak."""
    iq = bytes_to_iq(data_bytes)
    duration = max(len(data_bytes) / symbol_rate, 1e-6)
    t = np.linspace(0, duration, len(iq))
    carrier = 2 * np.pi * 8000 * t
    wave = np.real(iq) * np.sin(carrier) + np.imag(iq) * np.cos(carrier)
    peak = np.max(np.abs(wave))
    if peak > 0:
        wave = wave / peak * 0.8
    return wave.astype(np.float32)


def neural_demodulate(audio_samples: np.ndarray, symbol_rate: int = 8000, device: DeviceLike = None) -> bytes:
    """Toy demodulation on ``device`` (default: the card): the rectified
    samples' 21-tap moving average (``numpy.convolve(mode="same")``),
    scaled to 255 at its peak and truncated to bytes, one in ten kept."""
    if len(audio_samples) == 0:
        return b""
    dev = resolve_device(device)
    x = torch.abs(torch.as_tensor(np.asarray(audio_samples, np.float32), device=dev))
    win = 21
    kernel = torch.full((1, 1, win), 1.0 / win, dtype=torch.float32, device=dev)
    smooth = F.conv1d(x[None, None], kernel, padding=win // 2)[0, 0]
    peak = torch.max(smooth)
    norm = smooth / peak * 255.0 if float(peak) > 0 else smooth
    out = norm.cpu().numpy().astype(np.uint8)
    return bytes(out[: min(len(audio_samples) // 10, len(out))])


# --- trainable learned modem ---------------------------------------------------

def _mlp(n_in: int, hidden: int, n_out: int) -> nn.ModuleList:
    """Three Dense layers, ReLU between them (flax ``Dense_0..2``)."""
    return nn.ModuleList([nn.Linear(n_in, hidden), nn.Linear(hidden, hidden), nn.Linear(hidden, n_out)])


def _run_mlp(layers: nn.ModuleList, h: torch.Tensor, linear=None) -> torch.Tensor:
    """The MLP on ``h``; ``linear(i, layer, x)`` replaces layer i's product
    (the sharded step's)."""
    linear = linear or (lambda i, layer, x: layer(x))
    for i, layer in enumerate(layers):
        h = linear(i, layer, h)
        if i < len(layers) - 1:
            h = F.relu(h)
    return h


def _unit_power(iq: torch.Tensor) -> torch.Tensor:
    """Per-symbol average-power normalisation (unit transmit power)."""
    return iq * torch.rsqrt(torch.mean(iq * iq, dim=-1, keepdim=True) + 1e-8)


class ModemEncoder(nn.Module):
    """k-bit symbol (one-hot) -> 2*samples_per_symbol unit-power I/Q."""

    def __init__(self, hidden: int = 256, samples_per_symbol: int = 8, n_symbols: int = 256):
        super().__init__()
        self.layers = _mlp(n_symbols, hidden, 2 * samples_per_symbol)

    def forward(self, onehot: torch.Tensor) -> torch.Tensor:
        return _unit_power(_run_mlp(self.layers, onehot))


class ModemDecoder(nn.Module):
    """Received I/Q waveform -> logits over the 2^k symbol alphabet."""

    def __init__(self, hidden: int = 256, n_symbols: int = 256, samples_per_symbol: int = 8):
        super().__init__()
        self.layers = _mlp(2 * samples_per_symbol, hidden, n_symbols)

    def forward(self, rx: torch.Tensor) -> torch.Tensor:
        return _run_mlp(self.layers, rx)


class LearnedModem(nn.Module):
    """End-to-end autoencoder modem: encoder -> AWGN channel -> decoder."""

    def __init__(self, bits_per_symbol: int = 8, hidden: int = 256, samples_per_symbol: int = 8):
        super().__init__()
        self.bits_per_symbol = bits_per_symbol
        self.n_symbols = 1 << bits_per_symbol
        self.samples_per_symbol = samples_per_symbol
        self.encoder = ModemEncoder(hidden, samples_per_symbol, self.n_symbols)
        self.decoder = ModemDecoder(hidden, self.n_symbols, samples_per_symbol)

    def onehot(self, symbols: torch.Tensor) -> torch.Tensor:
        return F.one_hot(symbols.to(torch.int64), self.n_symbols).to(torch.float32)

    def channel_noise(self, shape, noise_std: float, generator: Optional[torch.Generator],
                      device: torch.device) -> torch.Tensor:
        """``noise_std`` times unit normals from ``generator`` (its device),
        moved to ``device``."""
        gdev = generator.device if generator is not None else device
        return (noise_std * torch.randn(shape, generator=generator, device=gdev)).to(device)

    def forward(self, symbols: torch.Tensor, noise_std: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tx = self.encoder(self.onehot(symbols))
        rx = tx + self.channel_noise(tx.shape, noise_std, generator, tx.device)
        return self.decoder(rx)

    def modulate_symbols(self, symbols: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.onehot(symbols))

    def demodulate_iq(self, rx: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.decoder(rx), dim=-1)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax ``Dense``'s initialisation, in place: each kernel lecun-normal
    (variance 1/fan_in) truncated at two standard deviations, each bias
    zero."""
    with torch.no_grad():
        for layer in model.modules():
            if isinstance(layer, nn.Linear):
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                w = torch.empty(layer.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
                layer.weight.copy_(w)
                layer.bias.zero_()


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ``LearnedModem`` parameter tree (``{"params": {"encoder":
    {"Dense_0": {"kernel", "bias"}, ...}, "decoder": ...}}``, leaves as
    numpy arrays) as this module's ``state_dict``: each (in, out) kernel
    transposed to an (out, in) ``weight``."""
    tree = params.get("params", params)
    out = {}
    for part in ("encoder", "decoder"):
        for name, leaf in tree[part].items():
            i = int(name.split("_")[-1])
            out[f"{part}.layers.{i}.weight"] = torch.tensor(np.asarray(leaf["kernel"], np.float32).T)
            out[f"{part}.layers.{i}.bias"] = torch.tensor(np.asarray(leaf["bias"], np.float32))
    return out


def create_train_state(
    seed: int = 0,
    bits_per_symbol: int = 8,
    hidden: int = 256,
    samples_per_symbol: int = 8,
    learning_rate: float = 1e-3,
    device: DeviceLike = None,
) -> Tuple[LearnedModem, torch.optim.Adam]:
    """A modem initialised as flax does from ``seed`` (a CPU generator, so
    the weights do not depend on the device), on ``device`` (default: the
    card), and its Adam with optax's defaults (β 0.9, 0.999, ε 1e-8)."""
    dev = resolve_device(device)
    model = LearnedModem(bits_per_symbol, hidden, samples_per_symbol)
    init_like_flax(model, torch.Generator().manual_seed(int(seed)))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return model, opt


def _loss_acc(logits: torch.Tensor, symbols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    loss = F.cross_entropy(logits, symbols.to(torch.int64))
    acc = (torch.argmax(logits, dim=-1) == symbols).to(torch.float32).mean()
    return loss, acc


def make_train_step(model: LearnedModem, opt: torch.optim.Optimizer, mesh: Optional[Mesh] = None) -> Callable:
    """The training step ``step(symbols, noise_std, generator=None) ->
    (loss, acc)``: symbol cross-entropy over the batch and one optimizer
    step, both results 0-d tensors on the model's device (no host read).

    With a ``mesh`` of axes ("data",) or ("data", "model") the step is
    sharded as the JAX package shards it: the batch splits over ``data``;
    each Dense layer whose output width divides by the ``model`` size
    splits its output columns over ``model`` and the shards' outputs are
    gathered, other layers run whole on the row's first device; the
    shards' gradients are summed in float32 over ``data`` into the model's
    gradients, then one optimizer step. The channel noise is one draw for
    the global batch, so the sharded step equals the unsharded one up to
    the order of the sums."""
    if mesh is None:
        def step(symbols: torch.Tensor, noise_std: float, generator: Optional[torch.Generator] = None):
            opt.zero_grad(set_to_none=True)
            loss, acc = _loss_acc(model(symbols, noise_std, generator), symbols)
            loss.backward()
            opt.step()
            return loss.detach(), acc

        return step

    n_data = mesh.shape[DATA_AXIS]
    n_model = mesh.shape.get(MODEL_AXIS, 1)
    grid = mesh.devices.reshape(n_data, n_model)
    layers = [*model.encoder.layers, *model.decoder.layers]

    def replica(layer: nn.Linear, row: list) -> list:
        """One data row's leaf copies of ``layer``, ``(device, weight,
        bias)`` a model shard: the output columns split over ``model`` where
        they divide, else the whole layer on the row's first device."""
        w, bias = layer.weight.detach(), layer.bias.detach()
        parts = [(row[0], w, bias)]
        if n_model > 1 and w.shape[0] % n_model == 0:
            c = w.shape[0] // n_model
            parts = [(dev, w[j * c : (j + 1) * c], bias[j * c : (j + 1) * c]) for j, dev in enumerate(row)]
        return [(dev, ws.to(dev).requires_grad_(True), bs.to(dev).requires_grad_(True)) for dev, ws, bs in parts]

    def step(symbols: torch.Tensor, noise_std: float, generator: Optional[torch.Generator] = None):
        b = symbols.shape[0]
        if b % n_data:
            raise ValueError(f"batch of {b} does not split over {n_data} data shards")
        per = b // n_data
        master = next(model.parameters()).device
        noise = model.channel_noise((b, 2 * model.samples_per_symbol), noise_std, generator, master)
        opt.zero_grad(set_to_none=True)
        row_grads, losses, hits = [], [], []
        for i in range(n_data):
            row = list(grid[i])
            reps = {layer: replica(layer, row) for layer in layers}

            def linear(_k, layer, h):
                # The model axis: each shard's output columns, gathered on
                # the row's first device.
                return torch.cat([F.linear(h.to(dev), w, bias).to(row[0]) for dev, w, bias in reps[layer]], dim=-1)

            sym = symbols[i * per : (i + 1) * per].to(row[0])
            tx = _unit_power(_run_mlp(model.encoder.layers, model.onehot(sym), linear))
            logits = _run_mlp(model.decoder.layers, tx + noise[i * per : (i + 1) * per].to(row[0]), linear)
            loss_i = F.cross_entropy(logits, sym.to(torch.int64), reduction="sum") / b
            loss_i.backward()
            row_grads.append([(torch.cat([w.grad.to(row[0]) for _d, w, _b in reps[layer]]),
                               torch.cat([bias.grad.to(row[0]) for _d, _w, bias in reps[layer]])) for layer in layers])
            losses.append(loss_i.detach())
            hits.append((torch.argmax(logits, dim=-1) == sym).to(torch.float32).sum())
        # psum over the data axis, into the model's gradients.
        for k, layer in enumerate(layers):
            layer.weight.grad = psum([g[k][0] for g in row_grads])[0].to(master)
            layer.bias.grad = psum([g[k][1] for g in row_grads])[0].to(master)
        opt.step()
        return psum(losses)[0].to(master), psum(hits)[0].to(master) / b

    return step


def train_learned_modem(
    n_steps: int = 200,
    batch_size: int = 512,
    noise_std: float = 0.3,
    bits_per_symbol: int = 4,
    hidden: int = 128,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """A small self-contained training run on ``device`` (default: the
    card); returns the model, its optimizer and the last step's loss and
    accuracy."""
    model, opt = create_train_state(seed, bits_per_symbol=bits_per_symbol, hidden=hidden, device=device)
    dev = next(model.parameters()).device
    step = make_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    loss = acc = None
    for _ in range(n_steps):
        symbols = torch.randint(0, 1 << bits_per_symbol, (batch_size,), generator=gen, device=dev)
        loss, acc = step(symbols, noise_std, gen)
    return {"model": model, "optimizer": opt, "final_loss": float(loss), "final_accuracy": float(acc)}
