"""A run with the timed path broken underneath comes out not correct: the
chip's check skipped, the rest of a run driven on the host at a small size.

Of the faults a cell can have, a decode has two: half of the batch left out,
and an answer altered where it is produced. It holds no state a step could
leave unchanged, and a one-chip cell has no exchange between chips."""

import pytest
import torch

from portbench import harness


def _half_left_out(real):
    def broken(x, *args, **kwargs):
        h = x.shape[0] // 2
        packed, n_valid, found = real(x[:h], *args, **kwargs)
        pad = x.shape[0] - h
        return (torch.cat([packed, torch.zeros((pad,) + packed.shape[1:], dtype=packed.dtype)]),
                torch.cat([n_valid, n_valid[:1].expand(pad)]), torch.cat([found, torch.zeros(pad, dtype=torch.bool)]))
    return broken


def _byte_altered(real):
    def broken(*args, **kwargs):
        packed, n_valid, found = real(*args, **kwargs)
        packed = packed.clone()
        packed[0, int(n_valid[0]) // 2] ^= 0x10
        return packed, n_valid, found
    return broken


@pytest.mark.parametrize("config", ["qpsk-9600", "fsk-19200"])
@pytest.mark.parametrize("fault", [None, _half_left_out, _byte_altered])
def test_broken_timed_path_is_not_correct(config, fault, small_root, int16_rows, monkeypatch):
    from audio_modem_radio_tpu_torch.parallel import batch

    if fault is not None:
        monkeypatch.setattr(batch, "demod_pack_batch", fault(batch.demod_pack_batch))
    root, bench = small_root
    result = harness.run(f"{config}.small", 2**31 + 77, 0.1, False, "cpu", bench=bench, root=root)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks" and set(result["metrics"]) == {"decode_msamples_per_s", "batch_p95_ms",
                                                                     "setup_s"}
