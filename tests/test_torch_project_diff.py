"""K11 and K12, the projection + differential kernels: the port's plain
versions and wrappers vs the JAX package's Pallas kernels in interpret mode,
and the single-capture stream length, on the CPU at small sizes.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays. Tolerance: 1e-5 of the stream's RMS (the projection's summation
order differs between XLA and PyTorch; nothing else does).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu.framing import crc32, pack_frame
from audio_modem_radio_tpu.modem import modulate as j_modulate
from audio_modem_radio_tpu.ops import psk as jpsk
from audio_modem_radio_tpu.ops.pallas_kernels import psk_project_diff as j_k11
from audio_modem_radio_tpu.ops.pallas_kernels import psk_project_diff_batch as j_k12

from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import psk as tpsk

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000


def _capture(seed: int, n: int, lead: int, mode: str = "QPSK", baud: int = 9600) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    wave = np.asarray(j_modulate(mode, pack_frame("d.bin", p, 0, 1, len(p), crc32(p)), baud), np.float32)
    x = np.zeros(n, np.float32)
    x[lead : lead + len(wave)] = wave[: n - lead]
    return x


def _close(got, ref, n: int):
    """Max abs error over the first n entries, and the RMS of ref there."""
    got = [np.asarray(g).reshape(-1)[:n] for g in got]
    ref = [np.asarray(r).reshape(-1)[:n] for r in ref]
    rms = float(np.sqrt(np.mean(ref[0] ** 2 + ref[1] ** 2)))
    return max(float(np.max(np.abs(g - r))) for g, r in zip(got, ref)), rms


def test_k11_plain_matches_pallas_interpret():
    """64 rows at spsym 10, offset 5's template: equal over every entry (the
    kernel's zero lookahead past the last row is the plain version's)."""
    spsym, r = 10, 64
    x2d = _capture(1, r * 128 * spsym, 37).reshape(r, 128 * spsym)
    W = jpsk._blocked_templates(spsym, 3000.0, SR, 8)[5]
    ref = j_k11(jnp.asarray(x2d), jnp.asarray(W), block_rows=64, interpret=True)
    got = tk.psk_project_diff(torch.from_numpy(x2d), torch.from_numpy(W), block_rows=64)
    assert all(g.shape == (r, 128) and g.dtype == torch.float32 for g in got)
    err, rms = _close([g.numpy() for g in got], ref, r * 128)
    assert rms > 0 and err <= 1e-5 * rms, (err, rms)
    assert np.array_equal(got[0].numpy(), tk.psk_project_diff_plain(torch.from_numpy(x2d), torch.from_numpy(W))[0].numpy())


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_k12_plain_matches_pallas_interpret(dtype):
    """B=2, 256 rows, different offsets per capture: equal inside each
    capture's span (the Pallas kernel's last row reads the next capture's
    head, which its contract calls garbage; the port reads zeros)."""
    spsym, r = 10, 256
    x = np.stack([_capture(2 + i, r * 128 * spsym, 11 * i) for i in range(2)]).reshape(2, r, 128 * spsym)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    W = jpsk._blocked_templates(spsym, 3000.0, SR, 8)
    best = np.array([2, 6], np.int32)
    ref = j_k12(jnp.asarray(x), jnp.asarray(W), jnp.asarray(best), rows_per_capture=r, interpret=True)
    got = tk.psk_project_diff_batch(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(best),
                                    rows_per_capture=r)
    for b in range(2):
        err, rms = _close([g[b].numpy() for g in got], [np.asarray(v)[b] for v in ref], (r - 1) * 128)
        assert rms > 0 and err <= 1e-5 * rms, (b, err, rms)
    assert all(g.shape == (2, r, 128) for g in got)
    # Past the span: the last entry has no successor and is exactly 0.
    assert float(got[0][0, -1, -1]) == 0.0 and float(got[1][1, -1, -1]) == 0.0


def test_k11_k12_wrappers_refuse_bad_operands():
    W = torch.from_numpy(jpsk._blocked_templates(10, 3000.0, SR, 8))
    x = torch.zeros((64, 1280))
    with pytest.raises(ValueError, match="block_rows"):
        tk.psk_project_diff(torch.zeros((60, 1280)), W[0])
    with pytest.raises(ValueError, match="dtype"):
        tk.psk_project_diff(x.to(torch.int8), W[0])
    with pytest.raises(ValueError, match="template"):
        tk.psk_project_diff(x, W[0, :1280])
    with pytest.raises(ValueError, match="best"):
        tk.psk_project_diff_batch(torch.zeros((2, 256, 1280)), W, torch.zeros(2, dtype=torch.int64),
                                  rows_per_capture=256)
    with pytest.raises(ValueError, match="rows_per_capture"):
        tk.psk_project_diff_batch(torch.zeros((2, 256, 1280)), W, torch.zeros(2, dtype=torch.int32),
                                  rows_per_capture=512)


@pytest.mark.parametrize("n,lead", [(1 << 17, 5), (200_003, 1234)])
def test_single_capture_stream_length_is_the_xla_paths(n, lead):
    """The TPU's K11 returns its 64-row-padded R*128 entries; the port trims
    to the JAX package's CPU length, ceil(n_frames/128)*128 - 1, on every
    device, so the raw streams agree byte for byte."""
    x = _capture(7, n, lead)
    d_j = jpsk.psk_demod_streams(jnp.asarray(x), 9600.0, 3000.0, SR)
    d_t = tpsk.psk_demod_streams(torch.from_numpy(x), 9600.0, 3000.0, SR)
    n_frames = -(-n // 10)
    assert d_t[0].shape[0] == d_j[0].shape[0] == -(-n_frames // 128) * 128 - 1
    err, rms = _close([d.numpy() for d in d_t[:2]], d_j[:2], d_t[0].shape[0])
    assert err <= 1e-5 * rms
    assert jpsk.qpsk_demodulate(x, 9600, 3000.0) == tpsk.qpsk_demodulate(x, 9600, 3000.0, device="cpu")
