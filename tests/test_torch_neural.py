"""The port's NEURAL mode vs the JAX package's, on the CPU: transmit, the
codebook and tables, K10's plain version against the Pallas kernel in
interpret mode, the batched time-domain receive (prefix and escalated
sync, chip lengths 2 and 4), the single-capture receive (time domain and
FFT), and the decoders' saved files.

Captures are made with numpy from seeds and handed to both packages as
numpy arrays. Tolerance: symbols are equal wherever a symbol's top two
codeword scores differ by more than 1e-5 of the top score; the unrotation
and the 16-term scores round differently in XLA and in PyTorch, so a
symbol within rounding of a tie may flip. Symbols at or under that margin
are counted, and on clean captures none may differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.framing import crc32, pack_frame, parse_frames
from audio_modem_radio_tpu.ops import neural as jn
from audio_modem_radio_tpu.ops.pallas_kernels import neural_extract_batch as j_neural_extract
from audio_modem_radio_tpu.parallel import batch as jb
from audio_modem_radio_tpu.utils.compression import intelligent_compress

from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.ops import kernels as tk
from audio_modem_radio_tpu_torch.ops import neural as tn
from audio_modem_radio_tpu_torch.ops.tables import tables_from_reference
from audio_modem_radio_tpu_torch.parallel import batch as tb
from audio_modem_radio_tpu_torch.utils.wavio import write_wav

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

N = 1 << 17
_TIE = 1e-5  # relative top-two score margin under which a symbol may flip


def _framed(seed: int, n_bytes: int, name: str = "n.bin"):
    p = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    return p, pack_frame(name, p, 0, 1, len(p), crc32(p))


def _place(wave, n: int = N, lead: int = 0, sign: float = 1.0) -> np.ndarray:
    x = np.zeros(n, np.float32)
    w = np.asarray(wave, np.float32)[: n - lead]
    x[lead : lead + len(w)] = sign * w
    return x


def _frames(raw: bytes):
    return [(f.name, f.part_number, f.data) for f in parse_frames(raw)]


def _read_all(paths):
    return sorted(open(p, "rb").read() for r in paths for p in ([r] if isinstance(r, str) else r))


def _near_ties(x: np.ndarray, k0, ph, chip_len: int) -> np.ndarray:
    """(B, L) bool on the grid that starts at sample k0 of each capture
    (circularly over its 128-padded length): True where the symbol's top
    two codeword scores, in float64 from the same chips and phasor, differ
    by at most ``_TIE`` of the top score."""
    cb = jn._codebook().astype(np.float64)
    spsym = 8 * chip_len
    n_pad = -(-x.shape[1] // 128) * 128
    xp = np.zeros((x.shape[0], n_pad))
    xp[:, : x.shape[1]] = x
    L = n_pad // 128 * (128 // spsym)
    out = np.zeros((x.shape[0], L), bool)
    for i in range(x.shape[0]):
        pos = (int(k0[i]) + np.arange(L)[:, None] * spsym + np.arange(spsym)) % n_pad
        v = xp[i][pos]
        zr = v * np.array([1.0, 0.0, -1.0, 0.0])[pos % 4]
        zi = v * np.array([0.0, -1.0, 0.0, 1.0])[pos % 4]
        cr = zr.reshape(L, 8, chip_len).mean(-1)
        ci = zi.reshape(L, 8, chip_len).mean(-1)
        a, b = float(ph[i][0]), float(ph[i][1])
        sc = np.concatenate([a * cr + b * ci, a * ci - b * cr], axis=1) @ cb.T
        top = np.sort(sc, axis=1)[:, -2:]
        out[i] = top[:, 1] - top[:, 0] <= _TIE * np.abs(top[:, 1])
    return out


def _assert_symbols_equal(got, ref, ties, clean_rows=()):
    """Every mismatch is a near tie, and none on the ``clean_rows``."""
    bad = got != ref
    assert not (bad & ~ties).any(), np.argwhere(bad & ~ties)[:10]
    for i in clean_rows:
        assert not bad[i].any(), (i, np.flatnonzero(bad[i])[:10])


# --- transmit, codebook, tables --------------------------------------------------

@pytest.mark.parametrize("rate", [1200, 3000, 9600])
def test_modulate_equals_jax_bitwise(rate):
    _, fr = _framed(rate, 300)
    ref = jn.neural_mode_modulate(fr, rate)
    assert np.array_equal(tn.neural_mode_modulate(fr, rate), ref)
    assert np.array_equal(tmodem.modulate("NEURAL", fr, rate), jmodem.modulate("NEURAL", fr, rate))
    assert tn._chip_len(rate) == jn._chip_len(rate)


def test_codebook_copy_equals_jax_bitwise():
    got, ref = tn._codebook(), jn._codebook()
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)
    assert open(tn._CODEBOOK_PATH, "rb").read() == open(jn._CODEBOOK_PATH, "rb").read()
    assert "audio_modem_radio_tpu_torch" in tn._CODEBOOK_PATH
    assert np.array_equal(tn._preamble_symbols(), jn._preamble_symbols())


def test_codebook_loads_zip_safe(monkeypatch):
    """Without the file path the codebook loads through importlib.resources
    from the port's own package."""
    tn._codebook.cache_clear()
    monkeypatch.setattr(tn, "_CODEBOOK_PATH", "/nonexistent/neural_codebook.npz")
    try:
        assert np.array_equal(tn._codebook(), jn._codebook())
    finally:
        tn._codebook.cache_clear()
        monkeypatch.undo()
    assert tn._codebook().shape == (256, 16)


@pytest.mark.parametrize("chip_len", [2, 4])
def test_tables_equal_jax_and_carry_over(chip_len):
    P = len(jn._preamble_baseband(chip_len))
    arrays = {
        "_codebook": jn._codebook(),
        "_corr_table": jn._corr_table(chip_len),
        "_codebook_blocked": jn._codebook_blocked(chip_len),
        "_energy_table": jn._energy_table(P),
    }
    got = tables_from_reference(arrays, "cpu")
    ours = {"_codebook": tn._codebook(), "_corr_table": tn._corr_table(chip_len),
            "_codebook_blocked": tn._codebook_blocked(chip_len), "_energy_table": tn._energy_table(P)}
    for name, a in arrays.items():
        assert got[name].dtype == torch.float32 and np.array_equal(got[name].numpy(), a), name
        assert np.array_equal(ours[name], a), name
    ref_tab = np.asarray(jn._chip_shift_table(chip_len, jnp.float32(1.0)))
    assert np.array_equal(tn._chip_shift_table(chip_len), ref_tab)
    assert tn._preamble_energy(chip_len) == jn._preamble_energy(chip_len)
    assert tn._td_supported(chip_len) and not tn._td_supported(10)


# --- K10 ------------------------------------------------------------------------------

def test_extract_plain_equals_pallas_interpret(rng):
    """Plain K10 vs the Pallas kernel (interpret mode, first-max argmax) on
    captures of 2^16 samples (one 512-row block each): every symbol outside
    each capture's last row (the Pallas kernel reads the next capture's
    head there). Capture 0 is clean, capture 1 led by 4096 samples of
    silence, whose rows decode to 0 in both, capture 2 noisy (10 dB)."""
    _, fr = _framed(3, 700)
    wave = tn.neural_mode_modulate(fr, 9600)
    n = 1 << 16
    cap = np.stack([_place(wave, n), _place(wave, n, 4096), _place(wave, n, 300)])
    p = float(np.mean(wave ** 2))
    cap[2] += rng.normal(0, np.sqrt(p / 10), n).astype(np.float32)
    r3 = n // 128
    s = np.array([5, 4096 % 128 + 3, 300 % 128], np.int32)
    ph = np.array([[1.0, 0.0], [0.6, 0.8], [-0.28, 0.96]], np.float32)
    ref = np.asarray(j_neural_extract(
        jnp.asarray(cap).reshape(3 * r3, 128), jn._chip_shift_table(2, jnp.float32(1.0)),
        jnp.asarray(jn._codebook_blocked(2)), jnp.asarray(ph), jnp.asarray(s),
        rows_per_capture=r3, spr=8, interpret=True, argmax="loop"))
    got = tk.neural_extract_batch(torch.from_numpy(cap).reshape(3 * r3, 128), torch.from_numpy(tn._codebook()),
                                  torch.from_numpy(ph), torch.from_numpy(s), r3).numpy()
    keep = slice(0, (r3 - 1) * 8)
    _assert_symbols_equal(got[:, keep], ref[:, keep], _near_ties(cap, s, ph, 2)[:, keep], clean_rows=(0, 1))
    assert not got[1, : 4096 // 16 - 8].any() and not ref[1, : 4096 // 16 - 8].any()


def test_extract_contract_wrap_first_max_and_offsets():
    """The contract K10's kernel is held to: row j's successor is row j+1
    and the capture's row 0 after its last row; the first maximum wins a
    tie; s is taken mod 128; int16 rows cast unscaled."""
    rng = np.random.default_rng(11)
    r3 = 4
    x = rng.normal(0, 1, (2, r3 * 128)).astype(np.float32)
    cb = torch.from_numpy(tn._codebook())
    ph = torch.tensor([[0.8, -0.6], [1.0, 0.0]])
    s = torch.tensor([77, 3], dtype=torch.int32)
    got = tk.neural_extract_batch(torch.from_numpy(x).reshape(-1, 128), cb, ph, s, r3).numpy()
    # the rolled-grid oracle at k0 = s is the unrotated grid, circular per capture
    for i in range(2):
        zr = x[i] * np.tile([1.0, 0.0, -1.0, 0.0], r3 * 32)
        zi = x[i] * np.tile([0.0, -1.0, 0.0, 1.0], r3 * 32)
        pos = (int(s[i]) + np.arange(r3 * 8)[:, None] * 16 + np.arange(16)) % (r3 * 128)
        cr, ci = zr[pos].reshape(-1, 8, 2).mean(-1), zi[pos].reshape(-1, 8, 2).mean(-1)
        a, b = float(ph[i, 0]), float(ph[i, 1])
        sc = np.concatenate([a * cr + b * ci, a * ci - b * cr], 1) @ tn._codebook().T.astype(np.float64)
        assert np.array_equal(got[i], np.argmax(sc, 1)), i
    s_wrapped = s + torch.tensor([128, -128], dtype=torch.int32)
    assert np.array_equal(tk.neural_extract_batch(torch.from_numpy(x).reshape(-1, 128), cb, ph, s_wrapped, r3).numpy(), got)
    # a codebook whose codewords 9 and 200 repeat codeword 3: ties go to 3
    tied = cb.clone()
    tied[9] = tied[200] = tied[3]
    x3 = np.zeros((1, 128), np.float32)
    x3[0, :16] = tn._synth(np.array([3]), tn._codebook(), 2)
    out = tk.neural_extract_batch(torch.from_numpy(x3), tied, ph[1:], s[1:] * 0, 1).numpy()
    assert out[0, 0] == 3 and (out[0, 1:] == 0).all()  # silent slots: all scores 0, symbol 0
    i16 = np.round(x3 * 1000).astype(np.int16)
    assert np.array_equal(tk.neural_extract_batch(torch.from_numpy(i16), cb, ph[1:], s[1:] * 0, 1).numpy(),
                          tk.neural_extract_batch(torch.from_numpy(i16.astype(np.float32)), cb, ph[1:], s[1:] * 0, 1).numpy())


# csrc/neural_extract.cu's launch: threads a block, symbols a thread, blocks a multiprocessor.
_K10_THREADS, _K10_SYMS, _K10_BLOCKS_PER_SM = 256, 8, 1


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("rows", [300, 512])
def test_extract_kernel_symbol_walk_mirrored(rows, sms):
    """csrc/neural_extract.cu's walk over symbols, on 3 captures: block
    ``blk`` of the grid scores, at each stride of the grid, symbol ``base +
    thread + u * 256`` for u < 8. Every symbol is written exactly once, none
    past the batch, and at each u a warp's 32 lanes take 32 neighbouring
    symbols (its byte stores and sample loads stay together). One
    multiprocessor makes each block stride several times."""
    n_sym = 3 * rows * 8
    per_block = _K10_THREADS * _K10_SYMS
    grid = min(-(-n_sym // per_block), sms * _K10_BLOCKS_PER_SM)
    writes = np.zeros(n_sym, np.int64)
    thread = np.arange(_K10_THREADS)
    for blk in range(grid):
        for base in range(blk * per_block, n_sym, grid * per_block):
            for u in range(_K10_SYMS):
                g = base + thread + u * _K10_THREADS
                assert (np.diff(g.reshape(-1, 32), axis=1) == 1).all()
                np.add.at(writes, g[g < n_sym], 1)
    assert (writes == 1).all()


@pytest.mark.parametrize("case", ["x_width", "rows", "x_dtype", "codebook", "phasors", "s_dtype", "argmax",
                                  "compaction"])
def test_extract_wrapper_raises_on_bad_input(case):
    x = torch.zeros((8, 128))
    cb = torch.from_numpy(tn._codebook())
    ph = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    s = torch.zeros(2, dtype=torch.int32)
    calls = {
        "x_width": lambda: tk.neural_extract_batch(torch.zeros((8, 64)), cb, ph, s, 4),
        "rows": lambda: tk.neural_extract_batch(x, cb, ph, s, 3),
        "x_dtype": lambda: tk.neural_extract_batch(x.double(), cb, ph, s, 4),
        "codebook": lambda: tk.neural_extract_batch(x, cb[:, :8], ph, s, 4),
        "phasors": lambda: tk.neural_extract_batch(x, cb, ph[:1], s, 4),
        "s_dtype": lambda: tk.neural_extract_batch(x, cb, ph, s.long(), 4),
        "argmax": lambda: tk.neural_extract_batch(x, cb, ph, s, 4, argmax="max"),
        "compaction": lambda: tk.neural_extract_batch(x, cb, ph, s, 4, compaction="nope"),
    }
    with pytest.raises(ValueError):
        calls[case]()


# --- the batched receive ------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["prefix", "escalate"])
@pytest.mark.parametrize("rate", [9600, 3000])
def test_demod_td_batch_equals_jax(rate, scenario, monkeypatch):
    """3 x 2^17 clean captures (one sign-flipped): every symbol equal to the
    JAX package's XLA path. In the escalating batch one transmission starts
    past the first 1/8 of its capture, so both packages search every lag."""
    _, fr = _framed(rate + 1, 600)
    wave = tn.neural_mode_modulate(fr, rate)
    late = N // 2 if scenario == "escalate" else 3333
    batch = np.stack([_place(wave, N, 0), _place(wave, N, 777, -1.0), _place(wave, N, late)])
    chip_len = tn._chip_len(rate)
    searched = []
    real = tn._peaks
    monkeypatch.setattr(tn, "_peaks", lambda x, c, rows, rho: searched.append(rows) or real(x, c, rows, rho))
    ref = np.asarray(jn.demod_td_batch(jnp.asarray(batch), chip_len, kernel=False))
    got = tn.demod_td_batch(torch.from_numpy(batch), chip_len).numpy()
    assert got.shape == ref.shape == (3, N // 128 * (16 // chip_len))
    assert np.array_equal(got, ref)
    assert searched == ([N // 128 // 8] if scenario == "prefix" else [N // 128 // 8, N // 128])


def test_sync_prefix_rho_separates_signal_and_noise(rng):
    """The prefix test's normalized peak: far above TD_PREFIX_RHO on a clean
    capture, far below on noise, as in the JAX package."""
    _, fr = _framed(5, 600)
    x = torch.from_numpy(np.stack([_place(tn.neural_mode_modulate(fr, 9600), N, 1000),
                                   rng.normal(0, 0.3, N).astype(np.float32)]))
    k0, _pr, _pi, rho = tn._peaks(x, 2, N // 128 // 8, True)
    assert int(k0[0]) == 1000
    assert float(rho[0]) > 2 * tn.TD_PREFIX_RHO and float(rho[1]) < tn.TD_PREFIX_RHO / 3


@pytest.mark.parametrize("rate", [9600, 3000, 1200])
def test_decode_sample_batch_matches_jax(rate):
    """decode_sample_batch and demod_pack_batch's triple (the stream after
    the preamble, its full length, found): equal streams at 9600 (K10's
    plain version), 3000 (chip length 4) and 1200 (the FFT path per
    capture), and each capture's frame."""
    rows, payloads = [], []
    for i in range(2):
        p, fr = _framed(20 + i, 400 + 100 * i, f"b{i}.bin")
        rows.append(_place(tn.neural_mode_modulate(fr, rate), N if rate > 1200 else 1 << 18, 97 * i + 5))
        payloads.append(p)
    batch = np.stack(rows)
    got = tb.decode_sample_batch(batch, "NEURAL", rate, device="cpu")
    ref = jb.decode_sample_batch(batch, "NEURAL", rate)
    assert got == ref
    assert [[f[2] for f in _frames(r)] for r in got] == [[p] for p in payloads]
    packed, n_valid, found = tb.demod_pack_batch(torch.from_numpy(batch), "NEURAL", rate)
    assert packed.dtype == torch.uint8 and n_valid.tolist() == [packed.shape[1]] * 2
    assert found.tolist() == [True, True] and packed[0].numpy().tobytes() == got[0]


# --- the single-capture receive and the decoders --------------------------------------

@pytest.mark.parametrize("rate", [1200, 3000, 9600])
def test_neural_mode_demodulate_equals_jax(rate, rng):
    """Bytes equal to the JAX package's: the FFT path at 1200, the time
    domain at 3000 and 9600 (a sign-flipped capture with a lead and noise)."""
    p, fr = _framed(30 + rate, 500)
    x = _place(tn.neural_mode_modulate(fr, rate), 1 << 17 if rate > 1200 else 1 << 18, 1777, -1.0)
    x = x + rng.normal(0, 0.02, len(x)).astype(np.float32)
    ref = jn.neural_mode_demodulate(x, rate)
    got = tn.neural_mode_demodulate(x, rate, device="cpu")
    assert got == ref == tmodem.demodulate("NEURAL", x, rate, device="cpu")
    assert [f[2] for f in _frames(got)] == [p]
    assert tn.neural_mode_demodulate(np.zeros(10, np.float32), rate, device="cpu") == b""


def _compressed_frame(data: bytes, name: str) -> bytes:
    return pack_frame(name, intelligent_compress(data), 0, 1, len(data), crc32(data))


@pytest.mark.parametrize("rate", [9600, 1200])
def test_decode_wav_file_saves_the_jax_files(tmp_path, rate):
    data = bytes(f"neural single {rate} ".encode()) * 40
    x = _place(tn.neural_mode_modulate(_compressed_frame(data, "s.bin"), rate), N if rate > 1200 else 1 << 18, 211)
    wav = str(tmp_path / "s.wav")
    write_wav(wav, x)
    ref = jdec.decode_wav_file(wav, "NEURAL", rate, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    got = tdec.decode_wav_file(wav, "NEURAL", rate, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                               device="cpu")
    assert _read_all(got) == _read_all(ref) == [data]


def test_decode_wav_batch_with_drift_retry_saves_the_jax_files(tmp_path):
    """A clean WAV and one from a transmitter clock 5% fast, which only the
    ±5% drift retry recovers, in both packages."""
    paths, contents = [], []
    for i, factor in enumerate((1.0, 1.05)):
        data = bytes(f"neural batch {i} ".encode()) * 30
        x = _place(tn.neural_mode_modulate(_compressed_frame(data, f"w{i}.bin"), 3000), 1 << 16, 50 + i)
        n = len(x)
        x = np.interp(np.arange(int(n / factor)) * factor, np.arange(n), x).astype(np.float32)
        paths.append(str(tmp_path / f"w{i}.wav"))
        write_wav(paths[-1], x)
        contents.append(data)
    assert tdec.decode_wav_file(paths[1], "NEURAL", 3000, recv_dir=str(tmp_path / "n"), registry=TRegistry(),
                                device="cpu") == []
    ref = jb.decode_wav_batch(paths, "NEURAL", 3000, recv_dir=str(tmp_path / "j"), registry=JRegistry())
    got = tb.decode_wav_batch(paths, "NEURAL", 3000, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                              device="cpu")
    assert [_read_all(g) for g in got] == [_read_all(r) for r in ref] == [[c] for c in contents]


def test_noise_saves_nothing(tmp_path, rng):
    noise = rng.normal(0, 0.3, N).astype(np.float32)
    wav = str(tmp_path / "noise.wav")
    write_wav(wav, noise)
    assert tdec.decode_wav_file(wav, "NEURAL", 9600, recv_dir=str(tmp_path / "t"), registry=TRegistry(),
                                device="cpu") == []
    assert tb.decode_wav_batch([wav], "NEURAL", 9600, recv_dir=str(tmp_path / "b"), registry=TRegistry(),
                               device="cpu", drift_retry=False) == [[]]
    assert parse_frames(tb.decode_sample_batch(noise[None], "NEURAL", 3000, device="cpu")[0]) == []
