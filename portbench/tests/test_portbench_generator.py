"""The generator repeats for a seed, and the seed moves the bytes, not the sizes."""

import json
from pathlib import Path

import numpy as np

from portbench import generator
from portbench.frames import crc32, parse_frames, pack_frame

ROOT = Path(generator.__file__).resolve().parent
MIX = {"captures": 3, "samples": 1 << 19, "lead_samples": [0, 1280], "noise_every": 3,
       "offset_hz": {"1": 100}, "snr_db": 20.0, "part_bytes": 4096}


def _cfg(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def test_same_seed_same_traffic():
    for name in ("qpsk-9600", "fsk-19200"):
        a = generator.build(_cfg(name), MIX, 2**31 + 11, "cpu")
        b = generator.build(_cfg(name), MIX, 2**31 + 11, "cpu")
        assert np.array_equal(a.captures, b.captures) and a.sent == b.sent and a.leads == b.leads
        c = generator.build(_cfg(name), MIX, 2**31 + 12, "cpu")
        assert c.captures.shape == a.captures.shape and not np.array_equal(c.captures, a.captures)
        assert [len(s) for s in c.sent] == [len(s) for s in a.sent]
        assert a.noise_only == [False, False, True] and a.offsets_hz == [0, 100, 0]
        assert float(np.abs(a.captures).max()) <= 1.0 and a.captures.dtype == np.float32


def test_frames_round_trip():
    sent = generator.build(_cfg("qpsk-9600"), MIX, 5, "cpu").sent[0]
    assert sent[0].name == "capture000.bin.part1" and sent[0].total == len(sent)
    assert sent[0].file_crc == crc32(b"".join(f.data for f in sent))
    stream = b"\x00junk" + b"".join(pack_frame(f) for f in sent[:3])
    assert parse_frames(stream) == sent[:3]
    broken = bytearray(stream)
    broken[-10] ^= 1
    assert parse_frames(bytes(broken)) == sent[:2]


def test_any_captures_come_out_as_in_the_whole_batch():
    """Set-up makes the batch in chunks and the check remakes a sample: each
    capture has its own generator, so both see the captures of the whole."""
    whole = generator.build(_cfg("fsk-19200"), MIX, 2**31 + 21, "cpu")
    part = generator.build(_cfg("fsk-19200"), MIX, 2**31 + 21, "cpu", indices=[2, 0])
    assert np.array_equal(part.captures, whole.captures[[2, 0]])
    assert part.sent == [whole.sent[2], whole.sent[0]] and part.noise_only == [True, False]
    assert generator.capture_seed(2**31 + 21, 0) != generator.capture_seed(2**31 + 21, 1)
