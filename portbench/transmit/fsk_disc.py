"""CPFSK transmitter of the ``fsk_disc`` family: the upstream ``fsk_modulate``
wire format (szumanski/Audio-Modem-Radio ``modem.py:270-341``: mark 1200 Hz,
space 2200 Hz by default, ``round(sample_rate / baud)`` samples a bit, the
phase continuous across bits, amplitude 0.9, a ``0xAA`` x 4 preamble, then
the bytes MSB first). That is the ``fsk`` family's format at other tones, so
its transmitter is the one of ``transmit.fsk``."""

from .fsk import modulate, nominal_power, payload_bits

__all__ = ["modulate", "nominal_power", "payload_bits"]
