"""The port's data-parallel scale-out (``parallel/mesh.py``, the ``mesh=``
options of ``parallel/batch.py``, ``parallel/multihost.py``) vs the JAX
package's, on the CPU.

The port's meshes repeat the CPU device (4 entries make a 4-shard mesh);
the JAX side runs on its 8-device virtual CPU mesh. ``decode_sample_batch``
on 3- and 4-shard meshes, each batch with one noise capture in its last
shard, must give the bytes of the unsharded port call, and the batch-wide
decisions must be taken once for the global batch: every shard scans the
unsharded call's QPSK tiers and takes NEURAL's full-lag search. On the
CPU the JAX package's QPSK batch takes its XLA sync tail (the kernel tail
is TPU-only), which starts the stream at another byte, so its frames are
compared; the JAX kernel tail (interpret mode) run on the global decision
streams gives the port's sharded bytes. NEURAL's bytes equal the JAX
sharded call's.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.encoder import encode_file as j_encode_file
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames as j_parse
from audio_modem_radio_tpu.modem import modulate as j_modulate
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.parallel import mesh as jm
from audio_modem_radio_tpu.parallel import multihost as jmh

from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2, parse_frames as t_parse
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import neural as tneural
from audio_modem_radio_tpu_torch.ops.psk import psk_decision_streams_batch
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.parallel import mesh as tm
from audio_modem_radio_tpu_torch.parallel import multihost as tmh

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

B = 5  # captures a batch: pads to 6 on 3 shards and to 8 on 4


def _frames(raw_list, parse):
    return [[(f.name, f.part_number, f.total_parts, f.data) for f in parse(raw)] for raw in raw_list]


def _batch(mode: str, n: int, seed: int, late: int = 0):
    """B captures of ``n`` samples: B-1 seeded payloads at seeded leads (the
    fourth after ``late`` more samples of silence), the last capture noise
    (it lands in the last shard on every mesh here)."""
    rng = np.random.default_rng(seed)
    batch = np.zeros((B, n), np.float32)
    payloads = []
    for i in range(B - 1):
        p = rng.integers(0, 256, 1500 + 100 * i, dtype=np.uint8).tobytes()
        w = np.asarray(j_modulate(mode, pack_frame(f"c{i}.bin", p, 0, 1, len(p), crc32(p)), 9600), np.float32)
        lead = int(rng.integers(0, 4000)) + (late if i == B - 2 else 0)
        batch[i, lead : lead + len(w)] = w[: n - lead]
        payloads.append(p)
    batch[-1] = rng.normal(0.0, 0.3, n).astype(np.float32)
    return batch, payloads


def _cpu_mesh(k: int) -> tm.Mesh:
    return tm.get_mesh(devices=["cpu"] * k)


# --- the mesh helpers ------------------------------------------------------------

def test_mesh_helpers_match_jax():
    jmesh, tmesh = jm.get_mesh(4), _cpu_mesh(4)
    assert tmesh.shape == dict(jmesh.shape) == {"data": 4}
    assert tm.get_mesh(3, devices=["cpu"] * 8).shape == dict(jm.get_mesh(3).shape)
    j2, t2 = jm.get_2d_mesh(4, 2), tm.get_2d_mesh(4, 2, devices=["cpu"] * 8)
    assert t2.shape == dict(j2.shape) == {"data": 4, "model": 2}
    assert t2.devices.shape == j2.devices.shape == (4, 2)
    for fn in (lambda: jm.get_2d_mesh(8, 2), lambda: tm.get_2d_mesh(8, 2, devices=["cpu"] * 8)):
        with pytest.raises(ValueError):
            fn()
    assert tm.DATA_AXIS == jm.DATA_AXIS and tm.MODEL_AXIS == jm.MODEL_AXIS


@pytest.mark.parametrize("b,multiple", [(5, 4), (8, 4), (5, 5), (1, 3), (7, 2)])
def test_pad_batch_matches_jax(b, multiple):
    a = np.arange(b * 3, dtype=np.float32).reshape(b, 3) + 1
    got, ref = tm.pad_batch(a, multiple), jm.pad_batch(a, multiple)
    assert got.shape == ref.shape and np.array_equal(got, ref)
    if b % multiple == 0:
        assert got is a


def test_batch_sharding_and_replicated_match_jax():
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    jmesh, tmesh = jm.get_mesh(4), _cpu_mesh(4)
    placed = jax.device_put(jnp.asarray(x), jm.batch_sharding(jmesh))
    ref = [np.asarray(s.data) for s in sorted(placed.addressable_shards, key=lambda s: s.index[0].start)]
    got = tm.batch_sharding(tmesh)(x)
    assert len(got) == 4 and all(np.array_equal(g.numpy(), r) for g, r in zip(got, ref))
    rep = jax.device_put(jnp.asarray(x), jm.replicated(jmesh))
    assert all(np.array_equal(np.asarray(s.data), x) for s in rep.addressable_shards)
    assert all(np.array_equal(t.numpy(), x) for t in tm.replicated(tmesh)(x))
    # On a (data, model) mesh the batch splits over data and repeats over model.
    got2 = tm.batch_sharding(tm.get_2d_mesh(2, 2, devices=["cpu"] * 4))(x)
    assert [g.numpy().tolist() for g in got2] == [x[:4].tolist()] * 2 + [x[4:].tolist()] * 2
    with pytest.raises(ValueError):
        tm.batch_sharding(tmesh)(x[:6])


def test_collectives_match_jax_shard_map():
    """ppermute to the left neighbour (circular), psum and all_gather over 4
    shards, against ``lax`` under ``shard_map``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = 4
    x = np.random.default_rng(3).normal(size=(n, 5)).astype(np.float32)
    jmesh = jm.get_mesh(n)
    perm = [(i, (i - 1) % n) for i in range(n)]

    def body(v):
        return (jax.lax.ppermute(v, "data", perm), jax.lax.psum(v, "data"),
                jax.lax.all_gather(v, "data")[None])

    fn = shard_map(body, mesh=jmesh, in_specs=P("data"), out_specs=(P("data"), P("data"), P("data")))
    pp, ps, ag = (np.asarray(a) for a in fn(jnp.asarray(x)))
    xs = tm.batch_sharding(_cpu_mesh(n))(x)
    assert tm.left_neighbour_perm(n) == perm
    assert np.array_equal(torch.cat(tm.ppermute(xs)).numpy(), pp)
    got_ps = torch.cat(tm.psum(xs)).numpy()
    assert np.max(np.abs(got_ps - ps)) <= 1e-6 * np.max(np.abs(ps))
    assert np.array_equal(torch.cat(tm.all_gather(xs)).numpy(), ag.reshape(n * n, 1, 5))
    # A shard no pair sends to gets zeros, as lax.ppermute gives.
    out = tm.ppermute(xs, [(0, 1)])
    assert np.array_equal(out[1].numpy(), x[:1]) and not out[0].any() and not out[2].any()


# --- the shard threads: counts, consensus, failures --------------------------------

def test_launch_counter_counts_every_thread():
    """The wrappers' counts under one lock: 16 threads (more than the
    cores) adding 2,000 launches each to two kernels' counters, with the
    interpreter switching threads every microsecond, lose none."""
    tk.reset_launch_counts()
    n_threads, n_adds = 16, 2000
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait(timeout=30)
        for _ in range(n_adds):
            tk._count(tk.relabel_pack_batch)
            tk._count(tk.rotation_match_batch)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts = tk.launch_counts()
    assert counts["relabel_pack_batch"] == counts["rotation_match_batch"] == n_threads * n_adds
    assert sum(counts.values()) == 2 * n_threads * n_adds
    tk.reset_launch_counts()
    assert sum(tk.launch_counts().values()) == 0


def test_agree_all_combines_every_shard_and_a_failure_breaks_the_barrier():
    flags = {0: [True, True], 1: [True, False], 2: [True, True]}
    seen = tm.run_shards(lambda i, dev: [tm.agree_all(f) for f in flags[i]], [torch.device("cpu")] * 3)
    assert seen == [[True, False]] * 3
    assert tm.agree_all(False) is False and tm.agree_all(True) is True  # outside a shard: the flag

    def fail_one(i, dev):
        if i == 1:
            raise KeyError("shard 1 failed")
        return tm.agree_all(True)  # would wait for shard 1 forever without the abort

    with pytest.raises(KeyError, match="shard 1 failed"):
        tm.run_shards(fail_one, [torch.device("cpu")] * 3)


# --- decode_sample_batch(mesh=) ----------------------------------------------------

def _spy(monkeypatch, module, name, key):
    """Record ``key(args, kwargs)`` with the calling thread's name for every
    call of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((threading.current_thread().name, key(args, kwargs)))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture(scope="module")
def qpsk_batch():
    """The fourth capture's frame starts past the 256-row tier (1280 samples
    a row at 9600 Bd), so the batch needs the full scan; it sits in pass
    1's middle window (rows 480-543 of the 1024 host-shaped rows)."""
    return _batch("QPSK", 1 << 20, 11, late=482 * 1280)


@pytest.mark.parametrize("k", [3, 4])
def test_qpsk_mesh_batch_equals_unsharded_and_jax(qpsk_batch, monkeypatch, k):
    batch, payloads = qpsk_batch
    calls = _spy(monkeypatch, tb, "rotation_match_batch", lambda a, kw: kw["rows_scanned"])
    ref = tb.decode_sample_batch(batch, "QPSK", 9600, device="cpu")
    tiers = [rows for _t, rows in calls]
    r = tb.host_shape_batch(batch[:1], "QPSK", 9600, device="cpu").shape[1]
    assert tiers == [256, r]  # the late capture fails the 256-row tier: the full scan
    calls.clear()
    got = tb.decode_sample_batch(batch, "QPSK", 9600, mesh=_cpu_mesh(k))
    assert got == ref
    # The tier decision is global: every shard scans the unsharded call's tiers.
    per_shard = {}
    for name, rows in calls:
        per_shard.setdefault(name, []).append(rows)
    assert len(per_shard) == k and all(v == tiers for v in per_shard.values())
    assert [[f[3] for f in fr] for fr in _frames(got, t_parse)] == [[p] for p in payloads] + [[]]
    jref = jb.decode_sample_batch(batch, "QPSK", 9600, mesh=jm.get_mesh(k))
    assert _frames(jref, j_parse) == _frames(got, t_parse)
    # The JAX kernel tail over the padded global batch's decision streams
    # (one program, one tier decision) gives the sharded call's bytes.
    padded = tm.pad_batch(tb.host_shape_batch(batch, "QPSK", 9600, device="cpu"), k)
    hi, lo = psk_decision_streams_batch(torch.from_numpy(padded), 9600.0, 3000.0, 96000, cfo=True)
    packed, n_valid, _found = jb.psk4_kernel_sync_tail(jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy()), True,
                                                       interpret=True)
    packed, n_valid = np.asarray(packed), np.asarray(n_valid)
    assert [packed[i, : int(n_valid[i])].tobytes() for i in range(B)] == got


def test_qpsk_mesh_batch_takes_the_first_tier_when_every_shard_matches(qpsk_batch, monkeypatch):
    batch, payloads = qpsk_batch
    signal = batch[:3]  # the early captures; 3 shards, no zero rows
    calls = _spy(monkeypatch, tb, "rotation_match_batch", lambda a, kw: kw["rows_scanned"])
    got = tb.decode_sample_batch(signal, "QPSK", 9600, mesh=_cpu_mesh(3))
    assert sorted(calls) == sorted((f"shard-{i}", 256) for i in range(3))
    assert got == tb.decode_sample_batch(signal, "QPSK", 9600, device="cpu")
    assert [[f.data for f in t_parse(r)] for r in got] == [[p] for p in payloads[:3]]


@pytest.fixture(scope="module")
def neural_batch():
    return _batch("NEURAL", 1 << 17, 12)


@pytest.mark.parametrize("k", [3, 4])
def test_neural_mesh_batch_equals_unsharded_and_jax(neural_batch, monkeypatch, k):
    """One noise capture fails the prefix test, so every shard takes the
    full-lag search (the JAX package's cond over the global batch)."""
    batch, payloads = neural_batch
    calls = _spy(monkeypatch, tneural, "_peaks", lambda a, kw: (a[2], a[3]))
    ref = tb.decode_sample_batch(batch, "NEURAL", 9600, device="cpu")
    unsharded = [c for _t, c in calls]
    r3 = (1 << 17) // 128
    assert unsharded == [(r3 // 8, True), (r3, False)]
    calls.clear()
    got = tb.decode_sample_batch(batch, "NEURAL", 9600, mesh=_cpu_mesh(k))
    assert got == ref
    per_shard = {}
    for name, c in calls:
        per_shard.setdefault(name, []).append(c)
    assert len(per_shard) == k and all(v == unsharded for v in per_shard.values())
    assert jb.decode_sample_batch(batch, "NEURAL", 9600, mesh=jm.get_mesh(k)) == got
    assert [[f.data for f in t_parse(r)] for r in got] == [[p] for p in payloads] + [[]]


def test_mesh_defaults_to_the_named_device_alone(qpsk_batch, monkeypatch):
    """With a device named (or no second card) no mesh is built: one shard,
    run on the calling thread."""
    monkeypatch.setattr(tb, "get_mesh", lambda *a, **k: pytest.fail("a mesh was built"))
    calls = _spy(monkeypatch, tb, "run_shards", lambda a, kw: list(a[1]))
    batch, _p = qpsk_batch
    assert len(tb.decode_sample_batch(batch[:1], "QPSK", 9600, device="cpu")) == 1
    assert calls == [(threading.current_thread().name, [torch.device("cpu")])]


# --- decode_wav_batch(mesh=) and the multi-host decode ------------------------------

@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _wavs(workdir, n: int, tag: str):
    contents, wavs = [], []
    for i in range(n):
        data = bytes(f"{tag} file {i} ".encode() * 30)
        p = workdir / f"{tag}{i}.bin"
        p.write_bytes(data)
        wavs.append(j_encode_file(str(p), mode="QPSK", symbol_rate=4800))
        contents.append(data)
    return contents, wavs


def test_decode_wav_batch_mesh_matches_unsharded_and_jax(workdir):
    contents, wavs = _wavs(workdir, 3, "w")
    sharded = tb.decode_wav_batch(wavs, "QPSK", 4800, recv_dir="rs", registry=TRegistry(journal_dir=""),
                                  mesh=_cpu_mesh(2))
    single = tb.decode_wav_batch(wavs, "QPSK", 4800, recv_dir="ru", registry=TRegistry(journal_dir=""),
                                 device="cpu")
    jax_out = jb.decode_wav_batch(wavs, "QPSK", 4800, recv_dir="rj", registry=JRegistry(), mesh=jm.get_mesh(2))

    def read(out):
        return [[open(p, "rb").read() for p in paths] for paths in out]

    assert read(sharded) == read(single) == read(jax_out) == [[c] for c in contents]


def test_partition_files_matches_jax():
    paths = [f"p{i}" for i in range(7)]
    for n in range(1, 5):
        parts = [tmh.partition_files(paths, pid, n) for pid in range(n)]
        assert parts == [jmh.partition_files(paths, pid, n) for pid in range(n)]
        assert sorted(p for part in parts for p in part) == sorted(paths)
    assert tmh.partition_files(["a", "b", "c"]) == ["a", "b", "c"]  # one process
    assert tmh.process_index() == 0 and tmh.process_count() == 1


def test_multihost_single_process_path(workdir):
    """One process: the identity partition, a local mesh, the same files
    (the JAX package's ``tests/test_batch.py`` case)."""
    tmh.initialize()  # no launcher environment: a logged no-op
    contents, wavs = _wavs(workdir, 3, "m")
    saved = tmh.decode_wav_batch_multihost(wavs, "QPSK", 4800, registry=TRegistry(journal_dir=""), device="cpu")
    assert len(saved) == 3
    assert sorted(open(p, "rb").read() for p in saved) == sorted(contents)
