"""The close-tone FSK decision after K8 (``ops.kernels.fsk_disc_decide_batch``,
``csrc/fsk_eq_bits.cu`` on the card) on the CPU: the wrapper is the plain
chain ``ops.kernels.fsk_disc_decide_batch_plain`` there, and the routing
of ``fsk_disc_bits_rows_batch`` (``kernel=False`` and ``tpu.demod_backend
= "xla"`` keep the plain chain). The card's own comparison is in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu_torch import modulate
from audio_modem_radio_tpu_torch.config import CONFIG
from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
from audio_modem_radio_tpu_torch.ops import fsk as tf
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.parallel import batch as tb

from fsk_eq_cases import CASES, MARK, SAMPLE_RATE, SPACE, case_coef, case_sums, plan_coef, tie_sums

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

ARGS = (9600.0, MARK, SPACE, SAMPLE_RATE)


def _fsk9600_rows(n_cap: int = 2, n: int = 1 << 17) -> torch.Tensor:
    """Host-shaped FIR windows of ``n_cap`` framed FSK9600 captures."""
    rng = np.random.default_rng(9)
    x = np.zeros((n_cap, n), np.float32)
    for i in range(n_cap):
        p = rng.integers(0, 256, 1200, dtype=np.uint8).tobytes()
        wave = modulate("FSK9600", pack_frame("e.bin", p, 0, 1, len(p), crc32(p)), 9600)
        x[i, 31 * i : 31 * i + len(wave)] = wave
    return torch.from_numpy(tb.host_shape_batch(x, "FSK9600", 9600, device="cpu"))


def _check(sr: np.ndarray, si: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """Wrapper == plain chain; no launch counted."""
    plan, _ = plan_coef()
    sr_t, si_t = torch.from_numpy(sr), torch.from_numpy(si)
    before = tk.fsk_disc_decide_batch.launches
    got = tk.fsk_disc_decide_batch(sr_t, si_t, plan, coef, SAMPLE_RATE, MARK, SPACE)
    ref = tk.fsk_disc_decide_batch_plain(sr_t, si_t, plan, coef, SAMPLE_RATE, MARK, SPACE)
    assert tk.fsk_disc_decide_batch.launches == before
    assert got.dtype == torch.uint8 and got.shape == sr_t.shape and torch.equal(got, ref)
    return ref.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decide_wrapper_is_the_plain_chain_on_cpu(case):
    """Every hand-made case: zeros, signed zeros, denormals, huge and
    infinite sums, both tones, the mid-tone tie, rows of 1 to 9 bits, n off
    the kernel's 16 and 4096 grains, B = 1 and 256."""
    bits = _check(*case_sums(case), case_coef(case))
    if case == "tie_bias":
        assert not bits.any()  # |eq - mark| == |eq - space|: `<` decides 0
    if case == "tones":
        assert 0.2 < bits.mean() < 0.8


def test_decide_wrapper_on_k8_sums_and_swept_ties():
    """K8's sums of a generated FSK9600 batch, and one-bit rows whose plain
    equalized frequency is exactly the mid-tone (each decides 0)."""
    x = _fsk9600_rows()
    best, plan, Wf, Wb, coef = tf.fsk_disc_pass1(x, *ARGS)
    sr, si = tk.fsk_disc_sums_batch(x, Wf, Wb, best, rows_per_capture=x.shape[1], nrow2=plan["nrow2"],
                                    row2=plan["row2"], ov2=plan["ov2"], spr2=plan["spr2"])
    bits = _check(sr.numpy(), si.numpy(), coef)
    assert 0 < bits.mean() < 1
    sr, si, tie = tie_sums("cpu")
    assert int(tie.sum()) >= 8
    assert not _check(sr.numpy(), si.numpy(), coef)[tie.numpy()].any()


def _spy(monkeypatch):
    """Record each call of the decision's wrapper from ``ops.fsk``."""
    calls = []
    real = tf.fsk_disc_decide_batch
    monkeypatch.setattr(tf, "fsk_disc_decide_batch", lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def test_rows_batch_routes_the_decision(monkeypatch):
    """``fsk_disc_bits_rows_batch`` takes the wrapper once by default, the
    plain chain with ``kernel=False`` or ``decide_kernel=False``, and the
    wrapper after K8's plain version with ``kernel=False,
    decide_kernel=True``; the bits are the same, and nothing launches on
    the CPU."""
    calls = _spy(monkeypatch)
    x = _fsk9600_rows()
    tk.reset_launch_counts()
    got = tf.fsk_disc_bits_rows_batch(x, *ARGS)
    assert len(calls) == 1
    plain = tf.fsk_disc_bits_rows_batch(x, *ARGS, kernel=False)
    kept = tf.fsk_disc_bits_rows_batch(x, *ARGS, decide_kernel=False)
    assert len(calls) == 1
    mixed = tf.fsk_disc_bits_rows_batch(x, *ARGS, kernel=False, decide_kernel=True)
    assert len(calls) == 2
    assert torch.equal(got, plain) and torch.equal(got, kept) and torch.equal(got, mixed)
    assert not any(tk.launch_counts().values())


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_demod_pack_batch_decision_by_backend(monkeypatch, backend):
    """Through ``demod_pack_batch`` on pre-shaped FIR windows: the wrapper
    once a call, and under ``tpu.demod_backend = "xla"`` the plain chain;
    the same bytes either way."""
    calls = _spy(monkeypatch)
    x = _fsk9600_rows()
    monkeypatch.setitem(CONFIG._config["tpu"], "demod_backend", backend)
    packed, n_valid, found = tb.demod_pack_batch(x, "FSK9600", 9600)
    assert len(calls) == (0 if backend == "xla" else 1)
    assert found.tolist() == [True, True]
    monkeypatch.setitem(CONFIG._config["tpu"], "demod_backend", "xla" if backend == "auto" else "auto")
    other = tb.demod_pack_batch(x, "FSK9600", 9600)
    assert all(torch.equal(a, b) for a, b in zip((packed, n_valid, found), other))
