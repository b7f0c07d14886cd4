"""The port's public API against the JAX package's: the mode registry's
``bytes_per_sec`` and ``fixed_baud``, the mode catalogs, the package
exports, and the decoder's reference-named helpers, on the CPU.
"""

import dataclasses

import numpy as np
import pytest

import audio_modem_radio_tpu as jpkg
from audio_modem_radio_tpu import decoder as jdec
from audio_modem_radio_tpu import modem as jmodem
from audio_modem_radio_tpu.assembly import AssemblyRegistry as JRegistry
from audio_modem_radio_tpu.utils.compression import intelligent_compress

import audio_modem_radio_tpu_torch as tpkg
from audio_modem_radio_tpu_torch import decoder as tdec
from audio_modem_radio_tpu_torch import modem as tmodem
from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry as TRegistry
from audio_modem_radio_tpu_torch.framing import Frame, crc32, pack_frame

CARRIED = ("FSK1200", "FSK9600", "FSK19200", "BPSK", "QPSK", "8PSK", "OFDM4", "OFDM8", "APSK16", "DSSS", "MSK",
           "FT8", "PSK31", "HELLSCHREIBER", "FELD_HELL", "NEURAL", "SLOW_HELL", "SSTV")


def test_registry_carries_the_twelve_modes():
    """Every mode of the JAX registry, in its order. (The name dates from
    when the port carried twelve of them.)"""
    assert list(tmodem.MODES) == list(jmodem.MODES) == list(CARRIED)


@pytest.mark.parametrize("mode", CARRIED)
def test_mode_spec_throughput_and_fixed_baud_match_jax(mode):
    ours, theirs = tmodem.MODES[mode], jmodem.MODES[mode]
    assert ours.name == theirs.name == mode
    assert ours.fixed_baud == theirs.fixed_baud
    for rate in (1200, 9600, 19200):
        got, want = ours.bytes_per_sec(rate), theirs.bytes_per_sec(rate)
        assert got == want and type(got) is type(want)


def test_mode_catalogs_are_the_carried_part_of_the_jax_lists():
    """The display catalogs are the JAX package's, label for label and in
    its order (``modes --all`` prints them); every mode the port carries is
    in them, NEURAL aside. (The name dates from when the port kept only the
    carried labels.)"""
    assert tmodem.DIGITAL_MODES == jmodem.DIGITAL_MODES
    assert tmodem.ANALOG_MODES == jmodem.ANALOG_MODES
    assert all(m in tmodem.DIGITAL_MODES or m in tmodem.ANALOG_MODES or m == "NEURAL" for m in tmodem.MODES)


@pytest.mark.parametrize("name", ["get_quality_threshold", "set_quality_threshold", "wav_from_array"])
def test_package_exports(name):
    assert name in tpkg.__all__ and name in jpkg.__all__
    assert callable(getattr(tpkg, name))
    assert set(jpkg.__all__) <= set(tpkg.__all__)


def test_quality_threshold_and_wav_bytes_match_jax():
    old = tpkg.get_quality_threshold()
    assert old == jpkg.get_quality_threshold()
    try:
        tpkg.set_quality_threshold(0.25)
        assert tpkg.get_quality_threshold() == 0.25
    finally:
        tpkg.set_quality_threshold(old)
    wave = np.random.default_rng(3).uniform(-1, 1, 999).astype(np.float32)
    assert tpkg.wav_from_array(wave) == jpkg.wav_from_array(wave)
    assert tmodem.wav_from_array is tpkg.wav_from_array


@pytest.mark.parametrize("name", [
    "parse_fbp_stream_enhanced", "smart_decompress", "find_frame_start", "get_reception_stats",
    "clear_reception_stats", "get_assembly_status", "calculate_global_average_quality", "debug_demodulation",
])
def test_decoder_helper_exists(name):
    assert callable(getattr(tdec, name)) and callable(getattr(jdec, name))


def test_parse_decompress_and_frame_start_match_jax():
    data = np.random.default_rng(7).integers(0, 64, 3000, dtype=np.uint8).tobytes()
    comp = intelligent_compress(data)
    framed = pack_frame("api.bin", comp, 0, 1, len(data), crc32(data))
    stream = b"\x00\x13" * 9 + b"\xAA" * 6 + framed + b"\x55" * 7 + b"\xAA" * 4 + framed[:40]
    ours, theirs = tdec.parse_fbp_stream_enhanced(stream), jdec.parse_fbp_stream_enhanced(stream)
    assert [dataclasses.astuple(f) for f in ours] == [dataclasses.astuple(f) for f in theirs]
    assert len(ours) == 1 and isinstance(ours[0], Frame) and ours[0].data == comp
    assert tdec.smart_decompress(ours[0].data) == jdec.smart_decompress(theirs[0].data) == data
    assert tdec.smart_decompress(b"plain bytes") == jdec.smart_decompress(b"plain bytes")
    for start in (0, 20, 21, 30, len(stream)):
        assert tdec.find_frame_start(stream, start) == jdec.find_frame_start(stream, start)
    assert tdec.find_frame_start(stream) == 20 and tdec.find_frame_start(b"no frame") == -1


def test_observability_helpers_match_jax(tmp_path):
    treg, jreg = TRegistry(journal_dir=str(tmp_path / "t")), JRegistry(journal_dir=str(tmp_path / "j"))
    part = Frame("o.bin.part1of2", b"half", 0, 2, 8, crc32(b"halfhalf"))
    assert treg.offer(part) is None and jreg.offer(part) is None

    def timeless(v):
        """Drop wall-clock fields (the two registries were fed at different instants)."""
        if isinstance(v, dict):
            return {k: timeless(x) for k, x in v.items() if not isinstance(x, float) or x < 1e9}
        return [timeless(x) for x in v] if isinstance(v, list) else v

    assert timeless(tdec.get_reception_stats(treg)) == timeless(jdec.get_reception_stats(jreg))
    assert timeless(tdec.get_assembly_status(treg)) == timeless(jdec.get_assembly_status(jreg))
    assert len(tdec.get_assembly_status(treg)) == 1
    assert tdec.calculate_global_average_quality(treg) == jdec.calculate_global_average_quality(jreg)
    tdec.clear_reception_stats(treg)
    jdec.clear_reception_stats(jreg)
    assert timeless(tdec.get_reception_stats(treg)) == timeless(jdec.get_reception_stats(jreg))
    x = np.random.default_rng(5).normal(0, 0.2, 500).astype(np.float32)
    assert tdec.debug_demodulation(x, "QPSK", 9600) == jdec.debug_demodulation(x, "QPSK", 9600)
    assert tdec.debug_demodulation(x[:0], "QPSK", 9600) == jdec.debug_demodulation(x[:0], "QPSK", 9600)


def test_modem_all_is_the_carried_part_of_the_jax_list():
    carried = [n for n in jmodem.__all__ if hasattr(tmodem, n)]
    assert tmodem.__all__ == carried
    assert {"ofdm_modulate_simple", "ofdm_demodulate_simple", "dsss_modulate", "dsss_demodulate"} <= set(carried)
    assert {"fsk_demodulate", "fsk_high_speed_demodulate", "msk_demodulate", "ft8_demodulate"} <= set(carried)
    # The HELL names too, since ROADMAP.md queue 1 item 6: the whole list.
    assert tmodem.__all__ == jmodem.__all__


@pytest.mark.parametrize("data", [
    np.random.default_rng(11).normal(0, 0.4, 777).astype(np.float32),
    np.random.default_rng(12).uniform(-3, 3, 64).astype(np.float64),
    np.zeros(9, np.float32),
    np.zeros(0, np.float32),
    [0.25, -0.5, 0.125],
])
def test_adaptive_gain_control_and_advanced_modem_match_jax(data):
    for peak in (0.95, 0.5):
        got, want = tmodem.adaptive_gain_control(data, peak), jmodem.adaptive_gain_control(data, peak)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    ours, theirs = tmodem.AdvancedModem(), jmodem.AdvancedModem()
    assert ours.sample_rate == theirs.sample_rate == tmodem.SAMPLE_RATE
    assert tmodem.AdvancedModem(48000).sample_rate == jmodem.AdvancedModem(48000).sample_rate == 48000
    assert np.array_equal(ours._adaptive_gain_control(data), theirs._adaptive_gain_control(data))


@pytest.mark.parametrize("name,args", [
    ("dsss", (9600, 3000.0)),
    ("dsss", (4800, 1500.0)),
    ("ofdm", (9600, 12000.0, 4)),
    ("ofdm", (4800, 12000.0, 8)),
])
def test_alias_helpers_match_jax(name, args):
    """``dsss_*`` and ``ofdm_*_simple``: the waveforms within 1e-6 (the
    QPSK modulate test's tolerance), the streams byte-equal on the JAX
    package's capture, with the frame recovered."""
    p = np.random.default_rng(args[0]).integers(0, 256, 240, dtype=np.uint8).tobytes()
    framed = pack_frame("h.bin", p, 0, 1, len(p), crc32(p))
    mod, demod = (f"{name}_modulate", f"{name}_demodulate") if name == "dsss" else (
        "ofdm_modulate_simple", "ofdm_demodulate_simple")
    ref = np.asarray(getattr(jmodem, mod)(framed, *args), np.float32)
    got = getattr(tmodem, mod)(framed, *args)
    assert got.dtype == np.float32 and got.shape == ref.shape and np.max(np.abs(got - ref)) <= 1e-6
    x = np.zeros(len(ref) + 4096, np.float32)
    x[300 : 300 + len(ref)] = ref
    stream = getattr(tmodem, demod)(x, *args, device="cpu")
    assert stream == getattr(jmodem, demod)(x, *args)
    assert [f.data for f in tpkg.parse_frames(stream)] == [p]
