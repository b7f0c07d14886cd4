"""The JAX package's kernel switches in the port, against the JAX package
on the CPU: K1's "succ" body, K3's and K4's "shift" generation, K10's bf16
operands, "stack" compaction and "dot" argmax (with its tie rule),
``demod_pack_batch(psk_variant=, pack_variant=)`` and
``demod_td_batch(kernel=)``. The FSK front ends and the helpers are
``tests/test_torch_helpers.py``.

Inputs are made with numpy from seeds and handed to both packages as numpy
arrays; the Pallas kernels run in interpret mode. Tolerance: decisions,
packed bytes and symbols bitwise (over the modulated span, and within
``n_valid``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames
from audio_modem_radio_tpu.ops import neural as jn
from audio_modem_radio_tpu.ops import psk as jpsk
from audio_modem_radio_tpu.ops.pallas_kernels import (
    bit_select_pack_batch as j_bit_select_pack,
    neural_extract_batch as j_neural_extract,
    psk_project_decide_batch as j_decide,
    relabel_pack_batch as j_relabel_pack,
)
from audio_modem_radio_tpu.parallel import batch as jb

from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import neural as tn
from audio_modem_radio_tpu_torch.ops import psk as tpsk
from audio_modem_radio_tpu_torch.parallel import batch as tb

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

SR = 96000
N_OFF = 8


def _framed(seed: int, n_bytes: int) -> bytes:
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return pack_frame(f"v{seed}.bin", p, 0, 1, len(p), crc32(p))


def _place(wave, n: int, lead: int = 0) -> np.ndarray:
    x = np.zeros(n, np.float32)
    w = np.asarray(wave, np.float32)[: n - lead]
    x[lead : lead + len(w)] = w
    return x


# --- K1 "succ" ------------------------------------------------------------------------

_PSK = {2: ("BPSK", 3000.0), 4: ("QPSK", 3000.0), 8: ("8PSK", 12000.0)}


def _decide_inputs(n_psk: int):
    """Two captures of one framed wave (the second 7 samples later) as
    blocked rows, with pass 1's offsets and rotations (for DBPSK turned a
    further π/4, so that the sign of the imaginary part, rounding noise on
    a clean capture, carries the signal too)."""
    mode, carrier = _PSK[n_psk]
    wave = np.asarray(jmodem.modulate(mode, _framed(3, 900), 9600), np.float32)
    if n_psk == 8:
        wave = np.asarray(jpsk.psk8_real_modulate(_framed(3, 900), 9600, carrier), np.float32)
    n = 1 << 17
    batch = np.stack([_place(wave, n), _place(wave, n, 7)])
    r, row = tpsk.blocked_row_shape(n, 9600, SR)
    x3d = np.zeros((2, r * row), np.float32)
    x3d[:, :n] = batch
    x3d = x3d.reshape(2, r, row)
    _, _, best, theta = jpsk._batch_pass1(None, jnp.asarray(x3d), 2, r * 128, 10, carrier, SR, N_OFF, r,
                                          n_psk=8 if n_psk == 8 else 4)
    theta = np.asarray(theta, np.float32) + np.float32(np.pi / 4 if n_psk == 2 else 0.0)
    rot = np.stack([np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    return x3d, np.array(best, np.int32), rot, r, carrier, len(wave) // 10 - 2


def test_succ_templates_equal_jax_bitwise():
    got = tpsk._blocked_templates_succ(10, 3000.0, SR, N_OFF)
    ref = jpsk._blocked_templates_succ(10, 3000.0, SR, N_OFF)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(got[:, :, :256], tpsk._blocked_templates(10, 3000.0, SR, N_OFF))


@pytest.mark.parametrize("n_psk", [2, 4, 8])
def test_decide_succ_equals_pallas_succ(n_psk):
    """K1 with the succ templates == the Pallas "succ" body (interpret mode)
    bitwise over the modulated span, and == the port's "roll" everywhere."""
    x3d, best, rot, r, carrier, n_sig = _decide_inputs(n_psk)
    Ws = jpsk._blocked_templates_succ(10, carrier, SR, N_OFF)
    ref = j_decide(jnp.asarray(x3d), jnp.asarray(Ws), jnp.asarray(best), jnp.asarray(rot), rows_per_capture=r,
                   n_psk=n_psk, interpret=True, variant="succ")
    args = (torch.from_numpy(x3d), torch.from_numpy(Ws), torch.from_numpy(best), torch.from_numpy(rot))
    got = tk.psk_project_decide_batch(*args, rows_per_capture=r, n_psk=n_psk, variant="succ")
    roll = tk.psk_project_decide_batch(torch.from_numpy(x3d),
                                       torch.from_numpy(tpsk._blocked_templates(10, carrier, SR, N_OFF)),
                                       *args[2:], rows_per_capture=r, n_psk=n_psk)
    got, ref, roll = ((o,) if n_psk == 8 else o for o in (got, ref, roll))
    for g, j, rl in zip(got, ref, roll):
        assert np.array_equal(g.numpy(), rl.numpy())
        assert np.array_equal(g.numpy().reshape(2, -1)[:, :n_sig], np.asarray(j).reshape(2, -1)[:, :n_sig])


def test_decision_streams_kernel_variant():
    """psk_decision_streams_batch(kernel_variant="succ") gives the "roll"
    streams; an unknown body raises."""
    x3d, *_ = _decide_inputs(4)
    flat = torch.from_numpy(x3d.reshape(2, -1)[:, : 1 << 17].copy())
    roll = tpsk.psk_decision_streams_batch(flat, 9600.0, 3000.0, SR)
    succ = tpsk.psk_decision_streams_batch(flat, 9600.0, 3000.0, SR, kernel_variant="succ")
    assert all(torch.equal(a, b) for a, b in zip(roll, succ))
    with pytest.raises(ValueError, match="kernel_variant"):
        tpsk.psk_decision_streams_batch(flat, 9600.0, 3000.0, SR, kernel_variant="nope")


# --- K3 and K4 "shift" ------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_packs_shift_equal_pallas_shift(k):
    """K3 and K4 with variant "shift" (their default) == the Pallas "shift"
    generation (interpret mode) within n_valid, and == "weights"."""
    rng = np.random.default_rng(40 + k)
    r, b = 256, 2
    hi = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    lo = rng.integers(0, 2, (b, r, 128), dtype=np.uint8)
    s = np.array([5 + 8 * k, 3 * k + 1], np.int32)
    ksel = np.array([k, 3 - k], np.int32)
    t = [torch.from_numpy(a) for a in (hi, lo, s, ksel)]
    for j_fn, t_fn, n_bits in ((j_relabel_pack, tk.relabel_pack_batch, 2 * r * 128),
                               (j_bit_select_pack, tk.bit_select_pack_batch, r * 128)):
        ref = np.asarray(j_fn(*(jnp.asarray(a) for a in (hi, lo, s, ksel)), r, interpret=True, variant="shift"))
        got = t_fn(*t, r).numpy()
        assert np.array_equal(got, t_fn(*t, r, variant="weights").numpy())
        for i in range(b):
            n_valid = (n_bits - (int(s[i]) & 7)) // 8
            assert np.array_equal(got[i, :n_valid], ref[i, :n_valid]), (t_fn.__name__, i)


@pytest.mark.parametrize("mode", ["QPSK", "BPSK"])
def test_demod_pack_batch_variants_same_frames(mode):
    """demod_pack_batch(psk_variant="succ", pack_variant="shift") gives the
    default call's bytes and the JAX package's frames."""
    waves = [np.asarray(jmodem.modulate(mode, _framed(60 + i, 700), 9600), np.float32) for i in range(2)]
    n = 1 << 17
    batch = np.stack([_place(waves[0], n, 11), _place(waves[1], n, 300)])
    x = torch.from_numpy(batch)
    base = tb.demod_pack_batch(x, mode, 9600)
    var = tb.demod_pack_batch(x, mode, 9600, psk_variant="succ", pack_variant="shift")
    assert all(torch.equal(a, b) for a, b in zip(base, var))
    jp, jv, _ = jb.demod_pack_batch(jnp.asarray(batch), mode, 9600, psk_variant="succ", pack_variant="shift")
    for i in range(2):
        got = parse_frames(var[0][i, : int(var[1][i])].numpy().tobytes())
        ref = parse_frames(np.asarray(jp)[i, : int(jv[i])].tobytes())
        assert [f.data for f in got] == [f.data for f in ref] and len(got) == 1
    with pytest.raises(ValueError):
        tb.demod_pack_batch(x, mode, 9600, pack_variant="nope")


# --- K10: bf16, stack compaction, the dot argmax and its tie rule ------------------------

def _neural_rows(n: int = 1 << 16):
    """Two clean NEURAL@9600 captures of one 512-row block each, with
    offsets and phasors as the sync would give them."""
    wave = tn.neural_mode_modulate(_framed(70, 500), 9600)
    cap = np.stack([_place(wave, n), _place(wave, n, 300)])
    s = np.array([5, 300 % 128], np.int32)
    ph = np.array([[1.0, 0.0], [0.6, 0.8]], np.float32)
    return cap, s, ph, n // 128


def _j_extract(cap, cb, s, ph, r3, **kw):
    return np.asarray(j_neural_extract(
        jnp.asarray(cap).reshape(-1, 128), jn._chip_shift_table(2, jnp.float32(1.0)), jnp.asarray(cb),
        jnp.asarray(ph), jnp.asarray(s), rows_per_capture=r3, spr=8, interpret=True, **kw))


@pytest.mark.parametrize("kw", [dict(bf16=True), dict(compaction="stack"), dict(argmax="dot"),
                                dict(bf16=True, argmax="dot")], ids=["bf16", "stack", "dot", "bf16-dot"])
def test_extract_switches_equal_pallas(kw):
    """The port's K10 with each switch == the Pallas kernel with it on clean
    captures (every row but each capture's last, where the Pallas kernel
    reads the next capture)."""
    cap, s, ph, r3 = _neural_rows()
    ref = _j_extract(cap, jn._codebook_blocked(2), s, ph, r3, **kw)
    got = tk.neural_extract_batch(torch.from_numpy(cap).reshape(-1, 128), torch.from_numpy(tn._codebook()),
                                  torch.from_numpy(ph), torch.from_numpy(s), r3, **kw).numpy()
    keep = slice(0, (r3 - 1) * 8)
    assert np.array_equal(got[:, keep], ref[:, keep])
    assert got[:, keep].any()


def test_extract_bf16_follows_pallas_where_rounding_moves_symbols():
    """On the captures with AWGN at 0 dB, where bf16 rounding moves symbols
    from float32 (at least 16 of 8176 in each package), the port's bf16 K10
    differs from the Pallas bf16 kernel in at most 4 symbols (5e-4: near
    ties that the two packages' float32 unrotation, one a dot and one
    elementwise, rounds apart), with either argmax."""
    cap, s, ph, r3 = _neural_rows()
    sigma = float(np.mean(cap[cap != 0] ** 2)) ** 0.5
    noisy = (cap + np.random.default_rng(5).normal(0.0, sigma, cap.shape)).astype(np.float32)
    keep = slice(0, (r3 - 1) * 8)
    args = (torch.from_numpy(noisy).reshape(-1, 128), torch.from_numpy(tn._codebook()), torch.from_numpy(ph),
            torch.from_numpy(s), r3)
    for argmax in ("dot", "loop"):
        ref = [_j_extract(noisy, jn._codebook_blocked(2), s, ph, r3, bf16=b, argmax=argmax)[:, keep]
               for b in (False, True)]
        got = [tk.neural_extract_batch(*args, bf16=b, argmax=argmax).numpy()[:, keep] for b in (False, True)]
        assert np.array_equal(got[0], ref[0]), argmax
        assert int((got[1] != ref[1]).sum()) <= 4, argmax
        assert int((got[1] != got[0]).sum()) >= 16 and int((ref[1] != ref[0]).sum()) >= 16, argmax


def test_extract_bf16_differences_from_pallas_are_near_ties():
    """On the captures with AWGN at 0 dB, every symbol where the Pallas bf16
    kernel and the port's plain bf16 version differ, with either argmax, is
    a near tie of the exact bf16 scores (``neural_bf16_mismatches``), and
    no symbol of the clean captures is a near tie (``neural_near_ties``)."""
    cap, s, ph, r3 = _neural_rows()
    sigma = float(np.mean(cap[cap != 0] ** 2)) ** 0.5
    noisy = (cap + np.random.default_rng(5).normal(0.0, sigma, cap.shape)).astype(np.float32)
    keep = slice(0, (r3 - 1) * 8)
    cb, tph, ts = torch.from_numpy(tn._codebook()), torch.from_numpy(ph), torch.from_numpy(s)
    x = torch.from_numpy(noisy).reshape(-1, 128)
    for argmax in ("dot", "loop"):
        ref = _j_extract(noisy, jn._codebook_blocked(2), s, ph, r3, bf16=True, argmax=argmax)
        got = tk.neural_extract_batch_plain(x, cb, tph, ts, r3, bf16=True, argmax=argmax)
        ref = torch.from_numpy(np.array(ref))
        ref[:, (r3 - 1) * 8:] = got[:, (r3 - 1) * 8:]  # the Pallas kernel's last row reads the next capture
        differ, outside = tk.neural_bf16_mismatches(x, cb, tph, ts, r3, got, ref, argmax=argmax)
        assert outside == 0, (argmax, differ)
    clean = torch.from_numpy(cap).reshape(-1, 128)
    assert not tk.neural_near_ties(clean, cb, tph, ts, r3)[:, keep].any()


def test_near_tie_margin():
    """The near-tie rule on exact scores: a top-two gap under δ (2 x 32 x
    2^-24 times the largest magnitude involved) is a near tie, a wider one
    or an answer far from the top is not, the count gate's 0 is taken at a
    near tie, and an all-zero row (δ = 0) is no near tie."""
    u = tk._NEAR_TIE_UNITS
    scores = torch.tensor([[1.0, 1.0 - 0.5 * u, 0.0], [1.0, 1.0 - 2.0 * u, 0.0], [0.0, 0.0, 0.0],
                           [1.0, 1.0 - 0.5 * u, 0.0]], dtype=torch.float64)
    mags = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], dtype=torch.float64)
    assert tk._near_tie(scores, mags).tolist() == [True, False, False, True]
    top, second, far = (torch.tensor([v] * 4) for v in (0, 1, 2))
    assert tk._near_tie(scores, mags, top, second).tolist() == [True, False, False, True]
    assert tk._near_tie(scores, mags, top, far).tolist() == [False] * 4
    gate = torch.tensor([1, 0, 0, 1])
    assert tk._near_tie(scores, mags, gate, top, count_gate=True)[[0, 3]].tolist() == [True, True]


def _blocked(cb: np.ndarray) -> np.ndarray:
    """The JAX kernel's (128, 8*256) block-diagonal scorer of a codebook, by
    the recipe of its ``_codebook_blocked`` at chip length 2."""
    W = np.zeros((128, 8 * 256), np.float32)
    for m in range(8):
        for c in range(8):
            W[m * 8 + c, m * 256 : (m + 1) * 256] = cb[:, c]
            W[64 + m * 8 + c, m * 256 : (m + 1) * 256] = cb[:, 8 + c]
    return W


def test_extract_dot_tie_rule_equals_pallas():
    """Codewords 3 and 200 identical: on rows of symbol 3 the JAX kernel's
    "dot" argmax and the port's give 0, "loop" the lower index, 3."""
    cb = jn._codebook().copy()
    cb[200] = cb[3]
    assert np.array_equal(_blocked(jn._codebook()), jn._codebook_blocked(2))
    r3 = 512
    syms = np.full(r3 * 8, 3)
    syms[::7] = 5  # a codeword without a twin keeps its index
    cap = tn._synth(syms, cb, 2)[None]
    s, ph = np.zeros(1, np.int32), np.array([[1.0, 0.0]], np.float32)
    args = (torch.from_numpy(cap).reshape(-1, 128), torch.from_numpy(cb), torch.from_numpy(ph), torch.from_numpy(s))
    for argmax, want in (("dot", np.where(syms == 5, 5, 0)), ("loop", syms)):
        ref = _j_extract(cap, _blocked(cb), s, ph, r3, argmax=argmax)[0]
        got = tk.neural_extract_batch(*args, r3, argmax=argmax).numpy()[0]
        assert np.array_equal(ref, want) and np.array_equal(got, want), argmax


def test_demod_td_batch_kernel_switch(monkeypatch):
    """demod_td_batch: kernel=None on a CPU tensor keeps the JAX XLA path's
    first maximum, kernel=True takes kernel_argmax ("dot": 0 on an exact
    tie) and kernel_bf16, kernel=False the plain float32 first maximum.
    With the real codebook all agree with the JAX package's XLA path."""
    payload = bytes([3, 9, 3, 3, 77]) * 120
    wave = tn.neural_mode_modulate(payload, 9600)
    batch = np.stack([_place(wave, 1 << 17, 40), _place(wave, 1 << 17, 1000)])
    x = torch.from_numpy(batch)
    ref = np.asarray(jn.demod_td_batch(jnp.asarray(batch), 2, kernel=False))
    for kw in (dict(), dict(kernel=False), dict(kernel=True), dict(kernel=True, kernel_bf16=True),
               dict(kernel=True, kernel_argmax="loop")):
        assert np.array_equal(tn.demod_td_batch(x, 2, **kw).numpy(), ref), kw
    with pytest.raises(ValueError, match="kernel_argmax"):
        tn.demod_td_batch(x, 2, kernel_argmax="nope")
    tables = dict(tn._device_tables(2, torch.device("cpu")))
    tied = tables["cb"].clone()
    tied[200] = tied[3]
    tables["cb"] = tied
    monkeypatch.setattr(tn, "_device_tables", lambda chip_len, dev: tables)
    body = slice(tn.PREAMBLE_LEN, tn.PREAMBLE_LEN + len(payload))
    sent = np.frombuffer(payload, np.uint8)
    loop = tn.demod_td_batch(x, 2).numpy()[:, body]
    dot = tn.demod_td_batch(x, 2, kernel=True).numpy()[:, body]
    assert (loop == sent).all() and np.array_equal(tn.demod_td_batch(x, 2, kernel=False).numpy()[:, body], loop)
    assert (dot == np.where(sent == 3, 0, sent)).all()
