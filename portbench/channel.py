"""The channel between transmitter and receiver, and the sample format.

A mistuned receiver sees the whole passband shifted by ``offset_hz``: the
modulators add :func:`cfo_phase` to the phase of every sample. White
Gaussian noise at a full-band SNR, then clipping to the [-1, 1] range a WAV
holds, stand for the recording. :func:`pcm16` is the 16-bit PCM sample a
WAV stores, which the receive works on. :func:`mm` is the references'
product, in float32 or in one of the two TF32 forms of the control.
"""

from __future__ import annotations

import contextlib
import math

import torch


def cfo_phase(n0: int, n: int, offset_hz: int, sample_rate: int, device) -> torch.Tensor:
    """Phase (radians, float64) of a carrier offset at samples ``n0 .. n0+n-1``,
    computed in whole units of 1/sample_rate cycles so it does not drift."""
    idx = torch.arange(n0, n0 + n, dtype=torch.int64, device=device)
    units = (idx * int(offset_hz)) % int(sample_rate)
    return units.to(torch.float64) * (2 * math.pi / sample_rate)


def add_noise_and_clip(x: torch.Tensor, sigma: float, gen: torch.Generator) -> torch.Tensor:
    """``x`` (float32, any shape) plus N(0, sigma^2) noise, clipped to [-1, 1]."""
    noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    return torch.clamp(x + noise * sigma, -1.0, 1.0)


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float samples in [-1, 1] -> 16-bit PCM values (as float32): x * 32768,
    rounded half to even, clipped to the int16 range."""
    return torch.clamp(torch.round(x.to(torch.float32) * 32768.0), -32768.0, 32767.0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10-bit mantissa (nearest, ties to even),
    as a tensor-core product rounds its operands."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def ieee_float32():
    """Products and convolutions inside the block in IEEE float32: TF32 off
    on a CUDA device, whatever the process had set."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


PRECISIONS = ("float32", "tf32", "cublas_tf32")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 ("float32"); with both operands rounded to TF32
    first ("tf32": a tensor core's TF32 product, on every device and for
    every shape); or with cuBLAS's own TF32 switch on ("cublas_tf32": what a
    program that allows TF32 gets; cuBLAS keeps some narrow products in
    float32, and on a CPU it changes nothing)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    if precision != "cublas_tf32":
        return a @ b
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
