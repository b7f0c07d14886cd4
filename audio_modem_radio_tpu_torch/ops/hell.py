"""Hellschreiber (Feld-Hell-style) text fax on PyTorch.

Counterpart of ``audio_modem_radio_tpu/ops/hell.py``, the same wire format:
10 all-on 7-pixel sync rows, then per character 7 rows of 7 pixels (each
row value LSB first) and a 2-pixel gap, then 5 all-on closing rows; a pixel
is ``round(sample_rate/baud)`` samples of a 1 kHz tone or silence,
normalised to 0.8 peak. The font (95 printable ASCII glyphs x 7 rows of 5
bits) is the port's own copy of the same base-32 string.

Receive: per-pixel mean-square energy against a threshold, then either
the single-capture host decoder (:func:`hellschreiber_demodulate`: skip
the sync run, nearest glyph per 7x7 block, stop at a mostly-on block) or
the batched one (:func:`hell_demod_text_batch`: the glyph match as one
product and argmax, stop at the first all-on row, a sync gate against
noise), which both decoders' text branches use. The JAX package runs no
Pallas kernel here.
"""

from __future__ import annotations

import functools
import string
from typing import Dict, List

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device
from .psk import _to_device

SAMPLE_RATE = 96000
SYNC_ROWS = 10
CLOSE_ROWS = 5
ROW_PIXELS = 7
CHAR_ROWS = 7
GAP_PIXELS = 2
CHAR_PIXELS = CHAR_ROWS * ROW_PIXELS + GAP_PIXELS  # 51

# Glyph font packed as base-32: 95 printable ASCII chars x 7 row values (0..31).
_B32 = string.digits + string.ascii_uppercase
_PACKED_FONT = (
    "00000004444404AAA0000AAVAVAA4FKE5U4OP248J3CIK8LIDC4800002488842842224804LEL4004"
    "4V4400000C48000V00000000CC01248G0EHJLPHE4C4444EEH1248VV2421HE26AIV22VGU11HE68GU"
    "HHEV124888EHHEHHEEHHF12C0CC0CC00CC0C48248G84200V0V008421248EH12404EHNLNGE4AHHVH"
    "HUHHUHHUEHGGGHEUHHHHHUVGGUGGVVGGUGGGEHGJHHFHHHVHHHE44444E72222ICHIKOKIHGGGGGGVH"
    "RLLHHHHPPLJJHEHHHHHEUHHUGGGEHHHLIDUHHUKIHFGGE11UV444444HHHHHHEHHHHHA4HHHLLLAHHA"
    "4AHHHHA4444V1248GVE88888E0G84210E22222E4AH0000000000V840000000E1FHFGGMPHHU00EGG"
    "HE11DJHHF00EHVGE698S8880FHHF1EGGMPHHH40C444E20622ICGGIKOKIC44444E00QLLLL00MPHHH"
    "00EHHHE00UHUGG00DJF1100MPGGG00EGE1U88S889600HHHJD00HHHA400HHLLA00HA4AH00HHF1E00"
    "V248V244844244444448442448000DI00"
)


@functools.lru_cache(maxsize=1)
def char_map() -> Dict[str, List[int]]:
    """Printable-ASCII char -> 7 row values (5-bit patterns)."""
    return {chr(32 + i): [_B32.index(c) for c in _PACKED_FONT[i * 7 : (i + 1) * 7]] for i in range(95)}


@functools.lru_cache(maxsize=1)
def _glyph_pixel_templates() -> np.ndarray:
    """(95, 49) float32: each glyph's 7x7 pixel block, rows LSB first."""
    cm = char_map()
    out = np.zeros((95, CHAR_ROWS * ROW_PIXELS), dtype=np.float32)
    for i in range(95):
        for r, val in enumerate(cm[chr(32 + i)]):
            for b in range(ROW_PIXELS):
                out[i, r * ROW_PIXELS + b] = (val >> b) & 1
    return out


def text_to_pixels(text: str) -> np.ndarray:
    """Text -> uint8 pixel stream with the sync and closing rows; characters
    outside the font go out as a blank glyph space."""
    cm = char_map()
    tmpl = _glyph_pixel_templates()
    gap = np.zeros(GAP_PIXELS, np.uint8)
    chunks = [np.ones(SYNC_ROWS * ROW_PIXELS, np.uint8)]
    for ch in text:
        if ch in cm:
            chunks.append(tmpl[ord(ch) - 32].astype(np.uint8))
            chunks.append(gap)
        else:
            chunks.append(np.zeros(CHAR_PIXELS, np.uint8))
    chunks.append(np.ones(CLOSE_ROWS * ROW_PIXELS, np.uint8))
    return np.concatenate(chunks)


def _synthesize(pixels: np.ndarray, spp: int, carrier: float, sample_rate: int) -> torch.Tensor:
    """Pixels x one pixel's tone (an outer product), normalised to 0.8 peak."""
    t = np.arange(spp, dtype=np.float64) / sample_rate
    tone = torch.from_numpy(np.sin(2 * np.pi * carrier * t).astype(np.float32))
    out = (torch.from_numpy(pixels.astype(np.float32))[:, None] * tone[None, :]).reshape(-1)
    peak = torch.max(torch.abs(out))
    return out / peak * 0.8 if peak > 0 else out


def hellschreiber_modulate(
    text: str, baud: float = 122.5, carrier: float = 1000.0, samp_rate: int = SAMPLE_RATE
) -> np.ndarray:
    spp = int(round(samp_rate / baud))
    return _synthesize(text_to_pixels(text), spp, float(carrier), int(samp_rate)).numpy()


def detect_pixels(samples, baud: float = 122.5, samp_rate: int = SAMPLE_RATE, threshold: float = 0.1,
                  device: DeviceLike = None) -> np.ndarray:
    """Per-pixel energy detection on ``device``: uint8, 1 where the pixel's
    mean square exceeds ``threshold``."""
    spp = int(round(samp_rate / baud))
    x = _to_device(samples, device)
    n_pix = x.shape[-1] // spp
    windows = x[: n_pix * spp].reshape(n_pix, spp)
    return (torch.mean(windows * windows, dim=1) > threshold).to(torch.uint8).cpu().numpy()


def _decode_naive(pixels: np.ndarray) -> str:
    """The reference decoder: each 7-pixel row looked up in any glyph row."""
    cm = char_map()
    text = []
    for i in range(0, len(pixels) - ROW_PIXELS + 1, ROW_PIXELS):
        val = sum(int(b) << j for j, b in enumerate(pixels[i : i + ROW_PIXELS]))
        text.append(next((ch for ch, rows in cm.items() if val in rows), "?"))
    return "".join(text)


def _decode_blocks(pixels: np.ndarray) -> str:
    """Glyph-block decoder: skip the leading all-on rows, then the nearest
    template (L1) per 7x7 block until a block opens with an all-on row and
    is at least 90% on."""
    px = np.asarray(pixels, dtype=np.float32)
    i, n = 0, len(px)
    while i + ROW_PIXELS <= n and px[i : i + ROW_PIXELS].sum() >= ROW_PIXELS - 0.5:
        i += ROW_PIXELS
    tmpl = _glyph_pixel_templates()
    text = []
    while i + CHAR_ROWS * ROW_PIXELS <= n:
        block = px[i : i + CHAR_ROWS * ROW_PIXELS]
        if block[:ROW_PIXELS].sum() >= ROW_PIXELS - 0.5 and block.sum() >= 0.9 * len(block):
            break
        text.append(chr(32 + int(np.argmin(np.abs(tmpl - block[None, :]).sum(axis=1)))))
        i += CHAR_PIXELS
    return "".join(text)


def hellschreiber_demodulate(samples, baud: float = 122.5, carrier: float = 1000.0, samp_rate: int = SAMPLE_RATE,
                             threshold: float = 0.1, naive: bool = False, device: DeviceLike = None) -> str:
    pixels = detect_pixels(samples, baud, samp_rate, threshold, device=device)
    return _decode_naive(pixels) if naive else _decode_blocks(pixels)


def _first_true(mask: torch.Tensor, default: int) -> torch.Tensor:
    """Index of the first True along the last axis (``jnp.argmax`` on
    booleans: torch's argmax takes no bool), ``default`` where none is."""
    if mask.shape[-1] == 0:
        return torch.full(mask.shape[:-1], default, dtype=torch.int64, device=mask.device)
    return torch.where(mask.any(dim=-1), torch.argmax(mask.to(torch.uint8), dim=-1), default)


def hell_demod_text_batch(samples: torch.Tensor, spp: int, threshold: float = 0.1):
    """(B, N) captures or (B, n_pix, spp) pixel windows (int16 at scale
    32768, or float) -> ``(chars (B, max_blocks) uint8, n_chars (B,) int32,
    found (B,))`` on the input's device.

    Glyph blocks start right after the leading run of all-on rows; each is
    classified by ``argmax(2 t.b - t.sum)`` over the templates (the L1
    nearest template for binary blocks), one product for the batch. Decoding
    stops at the first block whose first row is all on (no glyph row is:
    the font is 5 bits wide) or past the capture. A capture is found when
    its leading run holds at least SYNC_ROWS - 2 rows; otherwise n_chars is 0.
    """
    b = samples.shape[0]
    if samples.ndim == 3:
        win = samples
        n_pix = win.shape[1]
    else:
        n_pix = samples.shape[-1] // spp
        win = samples[:, : n_pix * spp].reshape(b, n_pix, spp)
    wf = win.to(torch.float32)
    if not samples.dtype.is_floating_point:
        wf = wf * (1.0 / 32768.0)
    px = (torch.mean(wf * wf, dim=-1) > threshold).to(torch.float32)
    n_rows = n_pix // ROW_PIXELS
    rows_on = px[:, : n_rows * ROW_PIXELS].reshape(b, n_rows, ROW_PIXELS).sum(-1) >= ROW_PIXELS - 0.5
    sync_rows = _first_true(~rows_on, n_rows)
    found = sync_rows >= SYNC_ROWS - 2
    blk = CHAR_ROWS * ROW_PIXELS
    max_blocks = max(n_pix // CHAR_PIXELS, 1)
    dev = px.device
    starts = (sync_rows * ROW_PIXELS)[:, None] + torch.arange(max_blocks, device=dev)[None, :] * CHAR_PIXELS
    idx = starts[:, :, None] + torch.arange(blk, device=dev)[None, None, :]
    valid = (starts + blk) <= n_pix
    blocks = torch.gather(px, 1, idx.reshape(b, -1).clamp(0, max(n_pix - 1, 0))).reshape(b, max_blocks, blk)
    tmpl = torch.from_numpy(_glyph_pixel_templates()).to(dev)
    score = 2.0 * (blocks @ tmpl.T) - tmpl.sum(dim=1)[None, None, :]
    chars = (32 + torch.argmax(score, dim=-1)).to(torch.uint8)
    stop = (blocks[..., :ROW_PIXELS].sum(-1) >= ROW_PIXELS - 0.5) | ~valid
    n_chars = torch.where(found, _first_true(stop, max_blocks), 0)
    return chars, n_chars.to(torch.int32), found


def hellschreiber_demodulate_batch(batch, baud: float = 122.5, samp_rate: int = SAMPLE_RATE,
                                   threshold: float = 0.1, device: DeviceLike = None) -> List[str]:
    """(B, N) captures -> the decoded texts, on ``device`` (empty where no
    sync was found)."""
    spp = int(round(samp_rate / baud))
    x = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32)).to(resolve_device(device))
    chars, n_chars, _found = hell_demod_text_batch(x, spp, float(threshold))
    chars, n_chars = chars.cpu().numpy(), n_chars.cpu().numpy()
    return [bytes(chars[i, : n_chars[i]]).decode("ascii") for i in range(len(n_chars))]
