"""The port's entry points (``audio_modem_radio_tpu_torch/entry.py``) vs
the JAX package's ``__graft_entry__``, on the CPU: the single-device
forward on the example batch, and the multi-device dry run on virtual
meshes of the CPU (1, 4 and 5 shards: data parallel, the seven sequence
families, the dp x tp training step)."""

import numpy as np
import pytest
import torch

import jax

from audio_modem_radio_tpu_torch import entry as tentry

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)


def test_entry_forward_matches_jax():
    import __graft_entry__ as g

    fn, args = tentry.entry(device="cpu")
    (x,) = args
    assert x.shape == (4, 1 << 16) and x.dtype == torch.float32 and not x.any()
    packed, n_valid, found = fn(*args)
    jfn, jargs = g.entry()
    jpacked, jn_valid, jfound = (np.asarray(a) for a in jax.jit(jfn)(*jargs))
    assert packed.shape[0] == jpacked.shape[0] == 4
    assert np.array_equal(found.numpy(), jfound) and not found.any()
    # The port takes the JAX package's TPU path, the kernel sync tail over
    # the blocked stream (2^16 dibits: 8192 bytes); the JAX package on the
    # CPU takes its XLA tail over the differential stream, one dibit shorter.
    assert n_valid.tolist() == [8192] * 4 and jn_valid.tolist() == [8191] * 4
    assert not packed.numpy().any() and not jpacked.any()


@pytest.mark.parametrize("n", [1, 4, 5])
def test_dryrun_multichip_on_a_virtual_cpu_mesh(n, capsys):
    tentry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip: {n} shards on cpu (virtual mesh)" in out
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    assert (f"dryrun_multichip OK on {n} devices (demod dp={n}; sequence-parallel sp={n} over 7 families "
            f"[QPSK, FSK1200, OFDM4, 8PSK, DSSS, NEURAL, HELL] with ppermute halo + psum/all_gather consensus; "
            f"train dp={n // model_par} x tp={model_par}, loss=") in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is visible")
def test_entry_points_need_a_card_unless_the_cpu_is_named():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.dryrun_multichip(2)
