"""ASCII mode diagrams: the console analog of the reference's GUI cartoons.

The reference paints static mode illustrations in a Qt widget
(ModeDiagramWidget, reference filebeep_advanced_v2.py:148-242): an FSK
square-frequency sketch, PSK phase flips, a QPSK constellation, OFDM carrier
humps. Here the diagrams are DERIVED from the actual modulators — the
oscillogram renders real synthesized samples and the constellation plots the
mode's true decision points — so the picture can never drift from the wire
format.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mode_diagram", "ascii_oscillogram", "ascii_constellation"]


def ascii_oscillogram(wave: np.ndarray, width: int = 64, height: int = 9) -> str:
    """Render a waveform as an ASCII oscillogram (column min/max fill)."""
    wave = np.asarray(wave, dtype=np.float64)
    if len(wave) == 0:
        return "(empty waveform)"
    peak = np.max(np.abs(wave)) or 1.0
    wave = wave / peak
    edges = np.linspace(0, len(wave), width + 1).astype(int)
    grid = [[" "] * width for _ in range(height)]
    mid = (height - 1) / 2
    for c in range(width):
        seg = wave[edges[c] : max(edges[c] + 1, edges[c + 1])]
        r_lo = int(round(mid - np.max(seg) * mid))
        r_hi = int(round(mid - np.min(seg) * mid))
        for r in range(max(0, r_lo), min(height - 1, r_hi) + 1):
            grid[r][c] = "#"
    for c in range(width):  # midline where empty
        r = int(mid)
        if grid[r][c] == " ":
            grid[r][c] = "-"
    return "\n".join("".join(row) for row in grid)


def ascii_constellation(
    points: np.ndarray, labels=None, width: int = 33, height: int = 17
) -> str:
    """Unit-circle scatter with optional per-point labels."""
    grid = [[" "] * width for _ in range(height)]
    cx, cy = (width - 1) // 2, (height - 1) // 2
    for r in range(height):
        grid[r][cx] = "|"
    for c in range(width):
        grid[cy][c] = "-"
    grid[cy][cx] = "+"
    pts = np.atleast_2d(points)
    for i, (x, y) in enumerate(pts):
        c = int(round(cx + x * (width - 3) / 2))
        r = int(round(cy - y * (height - 3) / 2))
        c, r = max(0, min(width - 1, c)), max(0, min(height - 1, r))
        mark = "o"
        grid[r][c] = mark
        if labels is not None and i < len(labels):
            lab = str(labels[i])
            start = c + 1 if c + 1 + len(lab) <= width else c - len(lab)
            for j, ch in enumerate(lab):
                if 0 <= start + j < width:
                    grid[r][start + j] = ch
    return "\n".join("".join(row) for row in grid)


def _spectrum_bars(wave: np.ndarray, sample_rate: int = 96000, width: int = 64) -> str:
    """Log-magnitude spectrum as bar rows (0..24 kHz)."""
    n = min(len(wave), 1 << 15)
    if n == 0:
        return "(empty)"
    spec = np.abs(np.fft.rfft(np.asarray(wave[:n], np.float64) * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1 / sample_rate)
    keep = freqs <= 24000
    spec, freqs = spec[keep], freqs[keep]
    edges = np.linspace(0, len(spec), width + 1).astype(int)
    cols = np.array([spec[edges[i] : max(edges[i] + 1, edges[i + 1])].max() for i in range(width)])
    cols = cols / (cols.max() or 1.0)
    height = 6
    rows = []
    for h in range(height, 0, -1):
        rows.append("".join("#" if v >= h / height else " " for v in cols))
    rows.append("0kHz" + " " * (width - 9) + "24kHz")
    return "\n".join(rows)


def mode_diagram(mode: str, symbol_rate: int = 2400) -> str:
    """ASCII diagram for a mode, built from its real modulator output."""
    from .modem import MODES, modulate

    mode = mode.upper()
    if mode not in MODES:
        return f"unknown mode {mode}; see `modes`"

    head = f"=== {mode} ==="
    try:
        if mode in ("HELLSCHREIBER", "FELD_HELL"):
            from .ops.hell import _glyph_pixel_templates

            tmpl = _glyph_pixel_templates()
            rows = [""] * 7
            for ch in "HELL":
                glyph = np.asarray(tmpl[ord(ch) - 32]).reshape(7, 7)
                for r in range(7):
                    # Pixels are LSB-first within each row (reference
                    # hellschreiber.py wire order); flip for display.
                    rows[r] += "".join("#" if px else " " for px in glyph[r][::-1]) + "  "
            return head + "\n7x7 glyph raster (1 kHz tone per lit pixel):\n" + "\n".join(rows)

        if mode == "NEURAL":
            from .ops.neural import _codebook

            cb = _codebook()
            pts = np.stack([cb[:24, 0], cb[:24, 8]], axis=1)
            pts = pts / (np.max(np.abs(pts)) or 1.0)
            return (
                head
                + "\nlearned codebook, chip-0 I/Q plane (24 of 256 codewords):\n"
                + ascii_constellation(pts)
            )

        demo = bytes([0x5A, 0xC3])
        wave = np.asarray(modulate(mode, demo, symbol_rate), np.float64)

        if mode.startswith("OFDM"):
            return (
                head
                + "\nsubcarrier spectrum (per-subcarrier DQPSK):\n"
                + _spectrum_bars(wave)
            )
        if mode.startswith("FSK") or mode in ("MSK", "FT8"):
            spsym = int(96000 / MODES[mode].fixed_baud) if MODES[mode].fixed_baud else 40
            return (
                head
                + "\nmark/space tones (continuous phase):\n"
                + ascii_oscillogram(wave[: 6 * max(spsym, 16)])
                + "\n"
                + _spectrum_bars(wave)
            )
        # PSK family: waveform + decision constellation.
        qt = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], float)
        labels = ["00", "01", "11", "10"] if mode != "BPSK" else ["0", "", "1", ""]
        spsym = int(96000 / symbol_rate)
        return (
            head
            + "\nphase-keyed carrier (10% ramp envelope):\n"
            + ascii_oscillogram(wave[: 6 * spsym])
            + "\ndifferential decision constellation (Gray):\n"
            + ascii_constellation(qt, labels)
        )
    except Exception as exc:  # diagrams must never crash a workflow
        return head + f"\n(diagram unavailable: {exc})"
