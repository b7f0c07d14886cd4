"""The FBPC wire frame, written out plainly for the benchmark.

    b'FBPC' | u8 name_len | name | LE u32 part | LE u32 total | LE u32 file_size
    | LE u32 file_crc | LE u32 data_len | LE u32 part_crc | payload

This is the upstream encoder's frame (szumanski/Audio-Modem-Radio
``encoder.py:94-114``) and its parser's accept rule (every magic offset, a
50 MB payload bound, the payload's CRC32). The benchmark frames what it sends
and parses what comes back with this file alone, so the yardstick does not
move with the program.
"""

from __future__ import annotations

import binascii
import struct
from typing import List, NamedTuple

MAGIC = b"FBPC"
MAGIC_BITS = "0100011001000010"  # b"FB", the receivers' sync pattern
MAGIC_BITS2 = "0101000001000011"  # b"PC", the PSK receivers' validation
MAX_PAYLOAD = 50_000_000
MAX_PARTS = 16384
_META = struct.Struct("<IIIIII")


def crc32(data: bytes) -> int:
    return binascii.crc32(data) & 0xFFFFFFFF


class Frame(NamedTuple):
    """A frame as sent, or as parsed with a valid payload CRC."""

    name: str
    part: int
    total: int
    file_size: int
    file_crc: int
    data: bytes


def pack_frame(f: Frame) -> bytes:
    name = f.name.encode("utf-8")[:255]
    meta = _META.pack(f.part, f.total, f.file_size, f.file_crc, len(f.data), crc32(f.data))
    return MAGIC + bytes([len(name)]) + name + meta + f.data


def parse_frames(raw: bytes) -> List[Frame]:
    """Every frame in ``raw`` whose header is sane and whose payload CRC holds."""
    out: List[Frame] = []
    n = len(raw)
    start = raw.find(MAGIC)
    while start != -1:
        name_len = raw[start + 4] if start + 30 <= n else 0
        meta_at = start + 5 + name_len
        if name_len and meta_at + _META.size <= n:
            part, total, fsize, fcrc, dlen, pcrc = _META.unpack_from(raw, meta_at)
            at = meta_at + _META.size
            if (0 < dlen <= MAX_PAYLOAD and at + dlen <= n and 0 < total <= MAX_PARTS and part < total):
                data = raw[at : at + dlen]
                if crc32(data) == pcrc:
                    name = raw[start + 5 : meta_at].decode("utf-8", "ignore")
                    out.append(Frame(name, part, total, fsize, fcrc, data))
        start = raw.find(MAGIC, start + 1)
    return out
