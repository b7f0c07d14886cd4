"""The port's learned modem (``models/neural_modem.py``,
``models/train_neural.py``) vs the JAX package's flax/optax modem, on the CPU.

The port cannot draw JAX's random numbers, so the flax parameters are
carried across (``params_from_flax``) wherever values are compared:
logits within 1e-5 of flax's ``apply``, three Adam steps at zero channel
noise within 1e-5 of optax's (each parameter tensor against its largest
magnitude), the codebook within 1e-6. The port's own initialisation is held
to flax's statistics, its training to the JAX package's accuracy test, and
``train_and_export`` to the JAX file's keys. The dp x tp step on a 2 x 2
mesh of the CPU equals the unsharded step within 1e-5 (gradients and
parameters, against each tensor's largest). The toy API's bytes equal
JAX's, or differ by 1 on at most 1% of them (the moving average's float
sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_modem_radio_tpu.models import neural_modem as jnm
from audio_modem_radio_tpu.models import train_neural as jtrain

from audio_modem_radio_tpu_torch.models import neural_modem as tnm
from audio_modem_radio_tpu_torch.models import train_neural as ttrain
from audio_modem_radio_tpu_torch.parallel.mesh import get_2d_mesh, get_mesh

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _carried(bits: int, hidden: int, seed: int, sps: int = 8):
    """(flax model, flax params, optax tx, opt state, port model, port Adam)
    with the port holding the flax weights."""
    jmodel, params, tx, st = jnm.create_train_state(jax.random.PRNGKey(seed), bits_per_symbol=bits, hidden=hidden,
                                                    samples_per_symbol=sps)
    tmodel, opt = tnm.create_train_state(seed, bits_per_symbol=bits, hidden=hidden, samples_per_symbol=sps,
                                         device="cpu")
    tmodel.load_state_dict(tnm.params_from_flax(_np_tree(params)))
    return jmodel, params, tx, st, tmodel, opt


def _assert_tensors_close(got: dict, want: dict, tol: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert float(np.max(np.abs(g - w))) <= tol * float(np.max(np.abs(w))), k


# --- the toy API -------------------------------------------------------------------

def test_toy_api_matches_jax():
    data = b"neural modem bytes " * 10
    for d in (data, b"", b"\x00\xff" * 600):
        assert np.array_equal(tnm.neural_modulate(d), jnm.neural_modulate(d))
    assert np.array_equal(tnm.bytes_to_iq(b"abc", seq_len=64), jnm.bytes_to_iq(b"abc", seq_len=64))
    iq = tnm.bytes_to_iq(data)
    assert tnm.iq_to_bytes(iq) == jnm.iq_to_bytes(iq)
    rng = np.random.default_rng(4)
    for x in (tnm.neural_modulate(data), rng.normal(0, 0.5, 5000).astype(np.float32), np.zeros(300, np.float32)):
        got = np.frombuffer(tnm.neural_demodulate(x, device="cpu"), np.uint8).astype(int)
        ref = np.frombuffer(jnm.neural_demodulate(x), np.uint8).astype(int)
        assert got.shape == ref.shape
        diff = np.abs(got - ref)
        assert diff.max(initial=0) <= 1 and np.count_nonzero(diff) <= 0.01 * len(ref)
    assert tnm.neural_demodulate(np.zeros(0, np.float32), device="cpu") == b""


# --- the learned modem against flax and optax --------------------------------------

@pytest.mark.parametrize("bits,hidden", [(4, 64), (8, 256)])
def test_carried_weights_give_flax_logits(bits, hidden):
    jmodel, params, _tx, _st, tmodel, _opt = _carried(bits, hidden, 3)
    sym = np.random.default_rng(0).integers(0, 1 << bits, 64)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(sym), 0.0, jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(sym), 0.0).numpy()
    assert float(np.max(np.abs(got - ref))) <= 1e-5 * float(np.max(np.abs(ref)))
    tx_ref = np.asarray(jmodel.apply(params, jnp.arange(1 << bits), method=jnm.LearnedModem.modulate_symbols))
    rx = jnp.asarray(tx_ref + np.random.default_rng(1).normal(0, 0.1, tx_ref.shape).astype(np.float32))
    dec_ref = np.asarray(jmodel.apply(params, rx, method=jnm.LearnedModem.demodulate_iq))
    with torch.no_grad():
        dec = tmodel.demodulate_iq(torch.tensor(np.asarray(rx))).numpy()
    assert np.array_equal(dec, dec_ref)


def test_three_adam_steps_match_optax():
    jmodel, params, tx, st, tmodel, opt = _carried(4, 64, 5)
    jstep = jax.jit(jnm.make_train_step(jmodel, tx))
    tstep = tnm.make_train_step(tmodel, opt)
    for k in range(3):
        sym = np.random.default_rng(10 + k).integers(0, 16, 128)
        params, st, jloss, jacc = jstep(params, st, jnp.asarray(sym), 0.0, jax.random.PRNGKey(k))
        tloss, tacc = tstep(torch.from_numpy(sym), 0.0)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert float(tacc) == float(jacc)
    _assert_tensors_close({k: v.detach() for k, v in tmodel.state_dict().items()},
                          tnm.params_from_flax(_np_tree(params)), 1e-5)


def test_codebook_from_carried_weights_matches_jax():
    jmodel, params, _tx, _st, tmodel, _opt = _carried(8, 256, 7)
    ref = np.asarray(jmodel.apply(params, jnp.arange(256), method=jnm.LearnedModem.modulate_symbols), np.float32)
    with torch.no_grad():
        got = tmodel.modulate_symbols(torch.arange(256)).numpy()
    assert got.shape == ref.shape == (256, 16)
    assert float(np.max(np.abs(got - ref))) <= 1e-6 * float(np.max(np.abs(ref)))
    assert np.allclose(np.mean(got ** 2, axis=-1), 1.0, atol=1e-3)


def test_initialisation_statistics_match_flax():
    """Kernels lecun-normal truncated at two standard deviations (variance
    1/fan_in), biases zero, as flax's ``Dense``; the port's weights and
    flax's have the same spread and bound."""
    _jm, params, _tx, _st, _t, _o = _carried(8, 256, 0)
    flax_sd = tnm.params_from_flax(_np_tree(params))
    tmodel, _opt = tnm.create_train_state(0, bits_per_symbol=8, hidden=256, device="cpu")
    for name, w in tmodel.state_dict().items():
        ref = flax_sd[name].numpy()
        w = w.numpy()
        if name.endswith("bias"):
            assert not w.any() and not ref.any()
            continue
        sigma = np.sqrt(1.0 / w.shape[1])
        bound = 2 * sigma / tnm._TRUNC_STD
        for arr in (w, ref):
            assert abs(arr.std() / sigma - 1) < 0.06 and abs(arr.mean()) < 0.05 * sigma
            assert np.abs(arr).max() <= bound * (1 + 1e-6)
    again, _ = tnm.create_train_state(0, bits_per_symbol=8, hidden=256, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tmodel.state_dict().values(), again.state_dict().values()))


def test_learned_modem_trains_to_high_accuracy():
    """The JAX package's accuracy test: 150 steps, batch 256, sigma 0.1, a
    16-symbol alphabet, hidden 64."""
    result = tnm.train_learned_modem(n_steps=150, batch_size=256, noise_std=0.1, bits_per_symbol=4, hidden=64,
                                     device="cpu")
    assert result["final_accuracy"] > 0.95
    assert np.isfinite(result["final_loss"])
    model = result["model"]
    with torch.no_grad():
        tx = model.modulate_symbols(torch.arange(16))
        assert tx.shape == (16, 16)
        np.testing.assert_allclose(torch.mean(tx ** 2, dim=-1).numpy(), 1.0, rtol=1e-3)
        assert float((model.demodulate_iq(tx) == torch.arange(16)).float().mean()) > 0.95


def test_train_and_export_writes_the_jax_keys(tmp_path):
    out = tmp_path / "cb.npz"
    res = ttrain.train_and_export(str(out), bits_per_symbol=4, hidden=32, samples_per_symbol=8, n_steps=120,
                                  batch_size=128, noise_std=0.1, device="cpu")
    jout = tmp_path / "jcb.npz"
    jtrain.train_and_export(str(jout), bits_per_symbol=4, hidden=32, samples_per_symbol=8, n_steps=2,
                            batch_size=8, noise_std=0.1)
    with np.load(out) as z, np.load(jout) as zj:
        assert sorted(z.files) == sorted(zj.files)
        for k in zj.files:
            assert z[k].shape == zj[k].shape and z[k].dtype.kind == zj[k].dtype.kind, k
        cb = z["codebook"]
        assert cb.shape == (16, 16) and cb.dtype == np.float32
        assert np.allclose(np.mean(cb ** 2, axis=-1), 1.0, atol=1e-3)
        assert float(z["nearest_codeword_ser"]) == res["ser"] <= 0.05
    assert np.array_equal(res["codebook"], cb)
    assert ttrain.DEFAULT_CODEBOOK.endswith("audio_modem_radio_tpu_torch/data/neural_codebook.npz")


def test_train_neural_main(tmp_path):
    out = tmp_path / "main.npz"
    assert ttrain.main(["--steps", "5", "--bits", "3", "--hidden", "16", "--batch", "32", "--out", str(out),
                        "--device", "cpu"]) == 0
    with np.load(out) as z:
        assert z["codebook"].shape == (8, 16) and int(z["train_steps"]) == 5


# --- the dp x tp step ----------------------------------------------------------------

@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
def test_sharded_step_equals_unsharded(data, model):
    """The batch over ``data``, each Dense layer's output columns over
    ``model`` where they divide (bits 4, hidden 64: every layer), the
    gradients summed over ``data``, then one Adam step."""
    ma, oa = tnm.create_train_state(0, bits_per_symbol=4, hidden=64, device="cpu")
    mb, ob = tnm.create_train_state(0, bits_per_symbol=4, hidden=64, device="cpu")
    mesh = get_2d_mesh(data, model, devices=["cpu"] * 4) if model > 1 else get_mesh(devices=["cpu"] * data)
    sa, sb = tnm.make_train_step(ma, oa), tnm.make_train_step(mb, ob, mesh=mesh)
    for k in range(3):
        sym = torch.from_numpy(np.random.default_rng(20 + k).integers(0, 16, 64))
        la, aa = sa(sym, 0.1, torch.Generator().manual_seed(k))
        lb, ab = sb(sym, 0.1, torch.Generator().manual_seed(k))
        assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(la)) and float(aa) == float(ab)
        _assert_tensors_close({n: p.grad for n, p in mb.named_parameters()},
                              {n: p.grad for n, p in ma.named_parameters()}, 1e-5)
    _assert_tensors_close({k: v for k, v in mb.state_dict().items()}, dict(ma.state_dict()), 1e-5)
    with pytest.raises(ValueError):
        sb(torch.zeros(5, dtype=torch.int64), 0.1)  # 5 rows do not split over the data shards
