#!/usr/bin/env python3
"""Drive the PyTorch port's receive once on one NVIDIA GPU: the batched PSK
(DQPSK, DBPSK, D8PSK), FSK (FSK1200, FSK9600, FSK19200, with MSK and FT8
on the dual-tone kernel), NEURAL, OFDM (OFDM4, OFDM8) and DSSS slices, the
single-capture PSK, NEURAL and FSK receive (``decode_wav_file`` ->
``modem.demodulate`` -> the recovery ladder; for FSK9600 the MLSE Viterbi
kernel), the Hellschreiber text modes, the round trips from the port's
own encoder to the card (file -> ``encode_file`` -> WAV, FEC-coded or not
-> ``decode_wav_file`` -> saved file), the front ends (the command
line, the console app, the GUI's view model, live reception), and the
scale-out and training (the data- and sequence-parallel meshes, the dry
run of ``entry.py``, the learned modem's ``train_and_export``).

    python3 chip_smoke.py    # one card, full size, about 7 minutes on an H100

It runs only on a CUDA card; the CPU checks of the same code are the tests
``tests/test_torch_*.py``. On a host with several cards it uses the first
visible one and hides the others. Every phase prints its seconds.

Phases, in order; any failure exits non-zero and prints no result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compiles ``audio_modem_radio_tpu_torch/csrc/*.cu``, one nvcc per
   source, all at once;
3. K1 vs plain: real QPSK@9600 (3 kHz), BPSK@9600 (3 kHz) and
   8PSK@9600 (12 kHz) batches of 8 x 2^24 samples through the port's host
   shaping and pass 1, in float32 and int16 rows (and int8 rows for QPSK):
   decisions bitwise equal on clean captures, at most 1e-4 of them
   different on a capture with AWGN at 6 dB SNR. DBPSK's lo stream (the
   sign of the imaginary part, rounding noise on a clean derotated
   capture) is compared under a further π/4 rotation, where it carries
   the signal;
3b. the FSK kernels vs plain on 8 x 2^24-sample captures through the
   port's host shaping and pass 1, float32 and int16 rows: K7 at spr 16
   (FSK1200), 128 (MSK@9600), 12 (MSK@1000) and 1 (FT8), K13 on flat
   FSK1200 rows (and equal to K7 at the same offsets), K8 (FSK9600) and K9
   (FSK19200). Bits equal on clean captures, at most 1e-4 different with
   AWGN (6 dB for the dual tones, 15 dB for FSK9600 and FSK19200); K8's
   sums and K9's margins within 1e-4 of the largest plain value;
3c. K12 vs plain on 8 x 2^24-sample QPSK and 8PSK captures (blocked rows,
   float32 and int16) and K11 vs plain on one 2^24-sample float32 capture
   (the single-capture layout, 64-row padded): the float streams within
   1e-5 of their RMS, and the Gray dibits (QPSK) or π/4 sectors (8PSK)
   decided from them after derotation by pass 1's θ equal on every symbol;
3d. K10 vs plain on 8 x 2^24-sample NEURAL@9600 captures synced by the
   port's ``td_sync_batch``, float32 and int16 rows: symbols equal on clean
   captures, at most 1e-4 different with AWGN at 6 dB, all zeros on an
   all-zero capture;
3e. the MLSE Viterbi kernel (``mlse_viterbi.cu``) vs plain on the blocks
   the single-capture receiver gives it for one 2^24-sample capture at
   9600 Bd, clean and with AWGN at 15 dB, on three trellises: 48 states
   (1200/2200 Hz, FSK9600), 96 (1100/2200 Hz) and 8 (1200/2400 Hz): bits
   equal on every block;
3f. the FEC Viterbi kernel (``fec_viterbi.cu``) vs plain: on the 205
   blocks of 9,216 steps that the stream-FEC decode of the largest file
   fitting one 2^24-sample QPSK@9600 WAV (written by the port's
   ``encode_file``, ``fec_type="stream"``) gives it, hard bits from the
   demodulator and soft values of the same WAV at -2 dB full-band SNR
   (the soft escalation); on one short block with known boundaries (a 1
   KiB ``FECV`` container); on all-0.5 input (every candidate ties), both
   boundaries: bits equal on every block;
4. the matchers and packs vs plain at the main path's row count: K2 (qpsk
   and bpsk families), K5 on streams built under every hypothesis plus a
   noise capture, (first, found) equal at each tier of the sync tail (256
   rows, an eighth, all); K3, K4 and K6 packed bytes equal on every byte,
   for every shift (K6: every ksel x r8 pair);
5. the slices at real size, 5 QPSK, 5b BPSK, 5c 8PSK, 5d FSK1200, 5e
   FSK9600, 5f FSK19200: 64 captures x 2^24 samples each (one seeded 16 KiB
   payload per capture, 0-2 bytes shorter for 8PSK so that the tiled frames
   stay byte-aligned, random leads, for PSK two captures at the carrier +-
   100 Hz, one pure noise) through ``decode_sample_batch`` and
   ``parse_frames``; each slice must launch its own kernels and none of
   the others' (launch counts reset before each). FSK1200 also runs its
   flat (B, N) captures through ``demod_pack_batch``, the path of K13, with
   the counts reset again. Then ``decode_wav_batch`` on 4 WAVs written by
   the port (QPSK, 8PSK, FSK1200 and FSK9600);
5g. single-capture decodes: for QPSK@9600, BPSK@9600 and 8PSK@9600, one
   2^24-sample WAV written by the port carrying a 128 KiB random file in 8
   parts of 16 KiB (each compressed on its own and framed, one
   transmission), decoded by ``decoder.decode_wav_file(device="cuda")``: the
   reassembled file equals the sent one and K11 is the only kernel
   launched, once; the same at the carrier +100 Hz; a noise-only WAV saves
   nothing (its launches and the ladder's host reads are printed). Then a
   PSK31 WAV (one short file; no kernel at 3072 samples per symbol) and a
   batch of 8 captures under 256 symbols through ``decode_sample_batch``
   (K11 once per capture);
5h. the 8PSK slice batch again under CONFIG ``tpu.demod_backend = "xla"``:
   the staged float path, K12 launched once and no other kernel;
5i. the NEURAL@9600 slice: 64 x 2^24 captures (one seeded 16 KiB payload
   each, tiled, random leads, one capture sign-flipped, one pure noise,
   which escalates the batch to the full-lag search) through
   ``decode_sample_batch``: K10 launched once and nothing else, every
   signal capture its own frames, the peak device memory printed and under
   40 GB; then ``decode_wav_batch`` on 2 NEURAL WAVs written by the port;
5j. the same at NEURAL@3000 (chip length 4) on 8 captures: no kernel;
5k. ``decode_wav_file(device="cuda")`` of a 2^24-sample NEURAL@9600 WAV
   carrying the 128 KiB file in 8 parts (the time-domain path) and of one
   at NEURAL@1200 (the FFT path): the file reassembles, no kernel launches;
5l. the single-capture FSK receive: ``decode_wav_file(device="cuda")`` of
   one 2^24-sample WAV each for FSK1200, FSK9600, FSK19200, MSK@9600 and
   FT8, carrying the largest random file in 16 KiB parts (each compressed
   on its own) that fits, up to 128 KiB (FT8: one 512-byte part): the file
   reassembles; FSK9600 launches the Viterbi kernel once, FSK1200, MSK
   and FT8 K7 once, FSK19200 no kernel; 2 FSK1200 captures under CONFIG
   ``tpu.demod_backend = "xla"`` launch K7 once and keep their frames; a
   noise WAV saves nothing. Then the marginal FSK9600 capture of
   the JAX package's ``tests/test_batch_ladder.py`` (300 bytes, AWGN
   sigma 0.08): ``decode_from_buffer`` saves it, the equalizer-only batch
   parses nothing, and ``decode_wav_batch`` of a healthy WAV and it saves
   both, the Viterbi kernel launched once, for the escalated capture only;
   and ``decode_sample_batch`` of 8 x 2^24 FSK9600 captures (one
   continuous transmission of 16 KiB frames at 8 leads) under CONFIG
   ``modem.batch_mlse``: every capture all its frames, one Viterbi launch
   for the batch;
5m. the FEC slice through the port's own encoder, every check
   byte-equality with the source file: ``decode_wav_file(stream_fec=True)``
   of phase 3f's WAV (the FEC Viterbi launched once or twice, K11 and
   nothing else); the same WAV at -2 dB through ``decode_from_buffer``
   (the soft escalation runs, the soft decode gets fewer frame bits wrong
   than the hard one, nothing wrong is saved); a 1,200-byte file at
   QPSK@4800 and -2 dB that the soft escalation recovers; 8 such
   stream-FEC WAVs through ``decode_wav_batch(stream_fec=True)`` (K1, K2,
   K3, then the Viterbi per capture); ``convolutional`` payload FEC in 1
   KiB parts (each container decoded by the card's kernel) and in 16 KiB
   parts (the native sweep where the port's native library built, else
   the card), and ``reed_solomon``, each file's part WAVs as one capture;
   one FSK9600 stream-FEC WAV (the MLSE, then the FEC Viterbi);
   ``decode_wav_file(denoise=True)`` of a clean QPSK transmission after a
   lead of silence; and whether the native library built;
5n, 5o. the OFDM4 and OFDM8 slices at 9600 Bd: 64 captures x 2^24 samples
   (one seeded 16 KiB payload per capture, tiled from a lead of i mod S
   samples plus a random number of whole symbols, S = 32 and 64, so that
   every timing offset class occurs, OFDM8's 64th aside; captures 1 and 2
   at the carrier +-100 Hz, the last noise) through
   ``decode_sample_batch``: every signal capture only its own frames, at
   least floor(2^24/len(wave)) - 1, noise none, K2 and K3 launched and no
   other kernel; ``decode_wav_batch`` of 4 WAVs written by the port; K2 at
   each tier and K3 at every (ksel, s8) pair on the dibit streams of a
   bench batch with its last capture noise, equal to their plain versions;
5p. the DSSS slice: 64 x 2^24 at 9600 chips/s, 4 KiB payloads, the same
   gate, no kernel launched;
5q. the text modes HELLSCHREIBER, FELD_HELL and SLOW_HELL: a 37-character
   text (the port's ``encode_hellschreiber_text``, FELD_HELL through
   ``modulate``) and a noise WAV through ``decode_wav_batch`` and
   ``decode_wav_file``: the text, nothing from noise, no kernel;
5r. round trips through the port's ``encode_file`` and
   ``decode_wav_file``: OFDM4 (24 KiB), OFDM8 with stream FEC (the FEC
   Viterbi kernel) and DSSS (1.5 KiB): the same bytes;
5s. the front ends on the card, through the entry points a user calls and
   with no device named: a 100 KiB random file through ``cli encode-file``
   (QPSK@9600), decoded by ``gui.GuiViewModel.start_decode`` (first: a
   worker thread's decode), ``decode_wav_file``, the GUI again, ``cli
   decode-wav``, the console app (scripted input) and
   ``audio_io.ReceiveSession`` over a ``FileRecorder`` of the WAV at 48 kHz,
   each the same bytes with K11 launched; ``decode-wav --batch`` of 8 such
   WAVs (K1, K2, K3), ``--stream-fec`` of 32 KiB (the FEC Viterbi), an
   FSK9600 file of 16 KiB (the MLSE Viterbi), ``decode-stream --wav`` (K11)
   and a noise WAV (exit 1); ``PerformanceMonitor`` names the card; each
   front end's host wall beside ``decode_wav_file``'s;
5t. scale-out and training on a virtual mesh of 4 shards of the card (the
   script hides every other card): the QPSK slice batch (5) through
   ``decode_sample_batch(mesh=)``, bytes equal to the unsharded call's, K1
   and K3 launched once a shard and K2 at the unsharded call's tiers on
   every shard (its noise capture sits in the last shard); one 2^24-sample
   capture per sequence family (QPSK, FSK1200, OFDM4, 8PSK, DSSS,
   NEURAL@1200, HELL; tiled transmissions) through
   ``decode_capture_sharded``: every frame (HELL: the text), QPSK, FSK1200
   and DSSS bytes equal to the single-device demodulator's over their
   common prefix, wall and peak memory printed; ``dryrun_multichip(4)`` and
   ``(5)``; ``train_and_export`` at the shipped configuration (bits 8,
   hidden 256, 3000 steps, batch 1024, sigma 0.35) into a scratch file:
   unit power, nearest-codeword SER at most 0.01, steps per second; one dp
   x tp training step on a 2 x 2 mesh beside the unsharded step: gradients
   within 1e-5 of each tensor's largest, parameters inside Adam's bound on
   that difference;
6. timing with CUDA events (one warm-up, median of 5): ``demod_pack_batch``
   of each mode on its 64 x 2^24 int16 batch staged on the card (PSK with
   cfo_retry on and off, and again with its last capture noise, which
   takes K2 or K5 to a later tier until the noise false-matches; 8PSK
   also under CONFIG ``tpu.demod_backend = "xla"``, K12's path; FSK1200
   also on flat float32 captures, the path of K13; NEURAL on float32, on
   the prefix branch and, with one noise capture, the full search), and
   each kernel and variant
   beside its plain version and its bound (K1@4 also on int8 rows; the
   matchers K2 and K5 at each tier, 256 rows, 1792 and all 13,312; K3 and
   K4 also on K1's lanes of the bench batch at every (ksel, s8) pair,
   bytes equal to the plain version's; the
   plain K8, K9 and K10 at 8 captures, where their float32 intermediates
   fit; K11 on one float32 capture, K12 on 64 x 2^24 int16 rows); 5 calls
   of ``sector_match_batch`` and of ``rotation_match_batch`` (each family)
   at 256 rows under ``torch.profiler`` must show exactly 5 device kernels
   and no copy or fill; and each mode's single-capture
   ``decode_wav_file`` (the PSK modes and NEURAL@9600) by the host clock
   (median of 3) with its device kernel time under ``torch.profiler``,
   the FSK modes' too; the Viterbi kernel on the FSK9600 capture's 205
   blocks of 10,240 steps beside its plain version (one run), and on the
   ``batch_mlse`` batch's one launch of 1,640 blocks, each with its bound,
   its cycles a step at the SM clock read during the run and its bound by
   the chain (10,240 forward and 320 traceback steps at their dependent
   cycles, from the kernel's SASS and latencies measured on the card); the
   FEC Viterbi kernel on phase 3f's 205 blocks beside its plain version
   (one run), its bound and its bound by the chain (9,216 forward and 288
   traceback steps), and on phase 3f's 1 KiB ``FECV`` container (one block,
   known boundaries), the stream-FEC ``decode_wav_file`` of QPSK and
   FSK9600 (wall, median of 3, and device time) and ``spectral_gate`` on a
   2^24-sample capture; last, on the OFDM4, OFDM8 and DSSS bench batches
   (float32 rows), ``demod_pack_batch`` by CUDA events and, for OFDM, its
   stages alone by CUDA events and under ``torch.profiler`` and the whole
   call under the profiler (idle share, largest kernels).

The line before the last is one JSON object with the kernels' names,
sources, launch counts, errors, times and bounds (one entry per kernel and
PSK variant): ``bound_ms`` is the larger of the bytes the call must move
over 3.35 TB/s and its operations over 67 T/s (the H100 SXM's published
memory rate and float32 CUDA-core rate; integer operations are counted
against the same rate), from the shapes and templates of the timed call.
No single PyTorch call computes any of these functions, so ``library_ms``
is null throughout. The two Viterbi kernels' bounds by bytes and
operations are far below their real floor, the chain of 10,240 (MLSE) or
9,216 (FEC) dependent steps a block, which phase 6 prints beside them. The last line is ``{"ok": true, "device": {...}}``. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 96000
BAUD = 9600
SPSYM = SR // BAUD
_QT_TO_DIBIT = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
_PALLAS = "audio_modem_radio_tpu/ops/pallas_kernels.py"
_CSRC = "audio_modem_radio_tpu_torch/csrc"
# Each slice: carrier, the decision's n_psk, the kernels its main path must
# launch, and whether phase 5 also decodes WAVs written by the port.
_SLICES = {
    "QPSK": dict(carrier=3000.0, n_psk=4, wav=True, kernels=(
        "psk_project_decide_batch", "rotation_match_batch", "relabel_pack_batch")),
    "BPSK": dict(carrier=3000.0, n_psk=2, wav=False, kernels=(
        "psk_project_decide_batch", "rotation_match_batch", "bit_select_pack_batch")),
    "8PSK": dict(carrier=12000.0, n_psk=8, wav=True, kernels=(
        "psk_project_decide_batch", "sector_match_batch", "psk8_relabel_pack_rows")),
}
# FSK slices: symbol rate, the kernels its main path must launch, and
# whether phase 5 also decodes WAVs written by the port.
_FSK_SLICES = {
    "FSK1200": dict(rate=1200, wav=True, kernels=("fsk_tile_bits_batch",)),
    "FSK9600": dict(rate=9600, wav=True, kernels=("fsk_disc_sums_batch",)),
    "FSK19200": dict(rate=19200, wav=False, kernels=("fsk_quad_margin_batch",)),
}
# The single-capture FSK decodes of phase 5l: mode -> symbol rate.
_FSK_SINGLE = {"FSK1200": 1200, "FSK9600": 9600, "FSK19200": 19200, "MSK": 9600, "FT8": 50}
# The kernel each of those single-capture decodes launches once (FSK19200's
# quadrature receiver is plain torch).
_FSK_SINGLE_KERNEL = {"FSK1200": "fsk_tile_bits_batch", "FSK9600": "mlse_viterbi_blocks",
                      "MSK": "fsk_tile_bits_batch", "FT8": "fsk_tile_bits_batch"}
# The Viterbi trellises of phase 3e at 9600 Bd: label -> (mark, space).
_TRELLISES = {"48 states": (1200.0, 2200.0), "96 states": (1100.0, 2200.0), "8 states": (1200.0, 2400.0)}
# The Viterbi kernel's operations per state and step, from its code: two
# metrics of 2 products, a sum and a difference, two candidate sums, the
# compare, the select, the step maximum and the subtraction.
_VITERBI_OPS = 14
# The FEC Viterbi kernel's operations, from its code: per state and step two
# candidate sums, the compare, the select, the step minimum and the
# subtraction; per step the four distinct branch metrics of 5 operations.
_FEC_OPS_STATE, _FEC_OPS_STEP = 6, 20
# K7's geometries in phase 3b: label -> (mode, symbol rate, payload bytes).
_K7_CASES = {
    "FSK1200": ("FSK1200", 1200, 16384),
    "MSK@9600": ("MSK", 9600, 16384),
    "MSK@1000": ("MSK", 1000, 16384),
    "FT8": ("FT8", 50, 400),
}
_PEAK_BYTES, _PEAK_OPS = 3.35e12, 67e12  # H100 SXM: HBM3 bytes/s, float32 CUDA-core ops/s
# The kernels line: entry -> (wrapper, the run whose launches it reports,
# source, the TPU kernel it replaces).
_ENTRIES = {
    "psk_project_decide_batch@4": ("psk_project_decide_batch", "QPSK", "decide.cu", 359),
    "psk_project_decide_batch@2": ("psk_project_decide_batch", "BPSK", "decide.cu", 359),
    "psk_project_decide_batch@8": ("psk_project_decide_batch", "8PSK", "decide.cu", 359),
    "rotation_match_batch:qpsk": ("rotation_match_batch", "QPSK", "rotmatch.cu", 1724),
    "rotation_match_batch:bpsk": ("rotation_match_batch", "BPSK", "rotmatch.cu", 1724),
    "relabel_pack_batch": ("relabel_pack_batch", "QPSK", "relabel_pack.cu", 1325),
    "bit_select_pack_batch": ("bit_select_pack_batch", "BPSK", "bit_select_pack.cu", 1510),
    "sector_match_batch": ("sector_match_batch", "8PSK", "sector_match.cu", 1900),
    "psk8_relabel_pack_rows": ("psk8_relabel_pack_rows", "8PSK", "psk8_pack.cu", 2021),
    "fsk_tile_bits_batch": ("fsk_tile_bits_batch", "FSK1200", "fsk_tile.cu", 582),
    "fsk_project_bits_batch": ("fsk_project_bits_batch", "FSK1200 flat", "fsk_tile.cu", 481),
    "fsk_disc_sums_batch": ("fsk_disc_sums_batch", "FSK9600", "fsk_disc.cu", 741),
    "fsk_quad_margin_batch": ("fsk_quad_margin_batch", "FSK19200", "fsk_quad.cu", 858),
    "psk_project_diff": ("psk_project_diff", "QPSK single", "project_diff.cu", 199),
    "psk_project_diff_batch": ("psk_project_diff_batch", "8PSK xla", "project_diff.cu", 126),
    "neural_extract_batch": ("neural_extract_batch", "NEURAL", "neural_extract.cu", 1083),
    # No Pallas kernel: the lax.scan pair of _mlse_refine.
    "mlse_viterbi_blocks": ("mlse_viterbi_blocks", "FSK9600 single", "mlse_viterbi.cu",
                            "audio_modem_radio_tpu/ops/fsk.py:375"),
    # No Pallas kernel: the lax.scan pair of fec._viterbi_block.
    "fec_viterbi_blocks": ("fec_viterbi_blocks", "QPSK stream", "fec_viterbi.cu",
                           "audio_modem_radio_tpu/fec.py:203"),
}
# K10's operations per symbol, from its code: 256 codewords x 16 FMAs, 256
# compares, 16 chips of 4 (two mask products, a sum, the half) and 16
# unrotated chips of 3.
_K10_OPS = 256 * 16 * 2 + 256 + 16 * 4 + 16 * 3
# The single-capture decodes of phase 5g: 128 KiB in 8 parts of 16 KiB.
_FILE_BYTES, _N_PARTS = 128 * 1024, 8


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# --- inputs -----------------------------------------------------------------------

def _payload(seed: int, n_bytes: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()


def _wave(payload: bytes, name: str, mode: str = "QPSK", offset_hz: float = 0.0) -> np.ndarray:
    """A framed ``mode`` wave through the port's ``modulate``, or through its
    modulator on the mode's carrier + ``offset_hz``."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops.psk import bpsk_modulate, psk8_real_modulate, qpsk_modulate

    framed = pack_frame(name, payload, 0, 1, len(payload), crc32(payload))
    if offset_hz == 0.0:
        return modulate(mode, framed, BAUD)
    fn = {"QPSK": qpsk_modulate, "BPSK": bpsk_modulate, "8PSK": psk8_real_modulate}[mode]
    return fn(framed, BAUD, _SLICES[mode]["carrier"] + offset_hz)


def _multipart_transmission(mode: str, seed: int, offset_hz: float = 0.0, rate: int = BAUD):
    """(file, wave): a random 128 KiB file in 8 parts of 16 KiB, each part
    compressed on its own and framed as the JAX ``encoder.py`` frames a
    multi-part file (``name.partN``, the whole file's size and CRC), the 8
    frames modulated as one transmission on the mode's carrier +
    ``offset_hz`` (NEURAL: at ``rate`` on its own carrier)."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops.psk import bpsk_modulate, psk8_real_modulate, qpsk_modulate
    from audio_modem_radio_tpu_torch.utils.compression import adaptive_compress

    data = _payload(seed, _FILE_BYTES)
    part = _FILE_BYTES // _N_PARTS
    framed = b"".join(
        pack_frame(f"file{seed}.bin.part{i + 1}", adaptive_compress(data[i * part : (i + 1) * part], mode),
                   i, _N_PARTS, len(data), crc32(data))
        for i in range(_N_PARTS)
    )
    if mode == "NEURAL":
        return data, modulate(mode, framed, rate)
    fn = {"QPSK": qpsk_modulate, "BPSK": bpsk_modulate, "8PSK": psk8_real_modulate}[mode]
    return data, fn(framed, BAUD, _SLICES[mode]["carrier"] + offset_hz)


def _tiled(wave: np.ndarray, n: int, lead: int = 0) -> np.ndarray:
    out = np.zeros(n, np.float32)
    reps = -(-(n - lead) // len(wave))
    out[lead:] = np.tile(wave, reps)[: n - lead]
    return out


def _rows(batch: np.ndarray, dtype: str, device, mode: str = "QPSK", rate: int = BAUD):
    """Rows ("f32", "int16" or "int8") through the port's own host shaping,
    on ``device``."""
    import torch

    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.parallel.batch import host_shape_batch

    old = CONFIG.get("tpu.int16_rows"), CONFIG.get("tpu.int8_rows")
    CONFIG.set("tpu.int16_rows", dtype == "int16")
    CONFIG.set("tpu.int8_rows", dtype == "int8")
    try:
        shaped = host_shape_batch(batch, mode, rate, device=device)
    finally:
        CONFIG.set("tpu.int16_rows", old[0])
        CONFIG.set("tpu.int8_rows", old[1])
    return torch.from_numpy(shaped).to(device)


def _mode_wave(payload: bytes, name: str, mode: str, rate: int) -> np.ndarray:
    """A framed ``mode`` wave at symbol rate ``rate`` through the port's ``modulate``."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate

    return modulate(mode, pack_frame(name, payload, 0, 1, len(payload), crc32(payload)), rate)


def _fsk_params(mode: str, rate: int):
    """(baud, mark, space) of an FSK mode, as the port's batch layer plans it."""
    from audio_modem_radio_tpu_torch.parallel.batch import resolve_demod_plan

    return resolve_demod_plan(mode, rate)[1]


def _awgn(clean: np.ndarray, snr_db: float, device) -> np.ndarray:
    """``clean`` plus white Gaussian noise at ``snr_db`` (seeded on the card)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1234)
    sigma = (float(np.mean(clean ** 2)) / 10 ** (snr_db / 10)) ** 0.5
    noise = (torch.randn(clean.shape, generator=gen, device=device) * sigma).cpu().numpy()
    return np.clip(clean + noise, -1.0, 1.0).astype(np.float32)


def _bound(n_bytes: float, n_ops: float):
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``n_bytes`` and does ``n_ops``, at the card's published peaks."""
    t_bytes, t_ops = n_bytes / _PEAK_BYTES * 1e3, n_ops / _PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _magic_bits(rng, n_bits: int, start: int) -> np.ndarray:
    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2

    bits = rng.integers(0, 2, n_bits, dtype=np.uint8)
    pat = np.array([int(c) for c in MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2], np.uint8)
    bits[start : start + len(pat)] = pat
    return bits


def _magic_streams(rng, r: int, k: int, parity: int, start_dib: int):
    """Random raw Gray lanes whose relabel by rotation k holds the magic +
    validation pattern at flat bit 2*start_dib + parity."""
    bits = _magic_bits(rng, 2 * r * 128, 2 * start_dib + parity)
    h, l = bits[0::2], bits[1::2]
    raw = _QT_TO_DIBIT[(2 * h + (h ^ l) + k) & 3]
    return raw[:, 0].reshape(r, 128), raw[:, 1].reshape(r, 128)


def _bpsk_streams(rng, r: int, h: int, start: int):
    """Random re/im sign-bit lanes with the magic + validation pattern at bit
    ``start`` of stream h & 1 (0 re, 1 im), complemented for h >= 2."""
    pat = _magic_bits(rng, r * 128, start) ^ np.uint8(h >= 2)
    other = rng.integers(0, 2, r * 128, dtype=np.uint8)
    re, im = (other, pat) if h & 1 else (pat, other)
    return re.reshape(r, 128), im.reshape(r, 128)


def _psk8_stream(rng, r: int, k: int, lead: int):
    """Random received sectors whose tribits, read as rotation-k sectors,
    hold the magic + validation pattern at symbol ``lead``."""
    from audio_modem_radio_tpu_torch.ops.psk import _GRAY8_INV

    bits = _magic_bits(rng, 3 * r * 128, 3 * lead)
    tri = bits[0::3] * 4 + bits[1::3] * 2 + bits[2::3]
    return ((_GRAY8_INV[tri].astype(np.int64) + k) % 8).astype(np.uint8).reshape(r, 128)


# --- timing -----------------------------------------------------------------------

def _time_ms(fn, reps: int = 5) -> float:
    """Median time of ``fn()`` in ms by CUDA events: one warm-up, then
    ``reps`` timed calls, each ending in a synchronize."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --- phases -----------------------------------------------------------------------

def phase_environment():
    import torch

    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"[1 env] device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    check(torch.cuda.device_count() == 1, "more than one card is visible")
    return torch.device("cuda"), card


def phase_build():
    from audio_modem_radio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.compile_library()
    _build.load_library()
    say(f"[2 build] {path.name} by {_build.find_nvcc()} in {time.perf_counter() - t0:.3f} s")
    kernel = None
    for line in log.splitlines():  # ptxas -v: one usage line per kernel
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "Used" in line and "registers" in line and kernel:
            say(f"[2 build] {kernel[:60]}: {line.split(':', 1)[1].strip()}")


def phase_decide(device, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """K1 vs plain on real captures of every slice's mode; returns the max
    abs decision error on the clean captures per kernels-line entry.

    Decisions are bitwise equal on clean captures and differ on at most 1e-4
    of them on a capture with AWGN at 6 dB SNR. One exception is stated: a
    clean DBPSK differential is real after derotation by θ, so the sign of
    its imaginary part (K1@2's lo stream) is rounding noise there; lo is
    compared under θ + π/4, where it carries the signal, and hi under both.
    """
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables

    errs = {}
    cases = [(mode, dtype) for mode in _SLICES for dtype in ("f32", "int16")] + [("QPSK", "int8")]
    batches = {}
    for mode, dtype in cases:
        t0 = time.perf_counter()
        spec = _SLICES[mode]
        n_psk, carrier = spec["n_psk"], spec["carrier"]
        if mode not in batches:
            clean = np.stack([_tiled(_wave(_payload(100 + i, payload_bytes), f"k1_{i}.bin", mode), n,
                                     lead=3 * i) for i in range(n_cap)])
            gen = torch.Generator(device=device).manual_seed(1234)
            sigma = (float(np.mean(clean[0] ** 2)) / 10 ** (6.0 / 10)) ** 0.5
            noisy = clean[:1] + (torch.randn((1, n), generator=gen, device=device) * sigma).cpu().numpy()
            batches[mode] = (clean, np.clip(noisy, -1.0, 1.0).astype(np.float32))
        n_sig = n // SPSYM - 2
        worst = 0
        for label, data in zip(("clean", "awgn6dB"), batches[mode]):
            x = _rows(data, dtype, device, mode)
            b, r, _ = x.shape
            _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r,
                                             n_psk=8 if n_psk == 8 else 4)
            W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, x.device)
            # (rotation, number of output streams compared) per comparison.
            rots = [(theta, 1), (theta + np.pi / 4, 2)] if n_psk == 2 else [(theta, 2)]
            n_bad = n_all = 0
            for th, n_streams in rots:
                rot = torch.stack([torch.cos(th), torch.sin(th)], dim=1)
                got = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
                ref = tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)
                if n_psk == 8:
                    got, ref = (got,), (ref,)
                torch.cuda.synchronize()
                for g, p in list(zip(got, ref))[:n_streams]:
                    g = g.reshape(b, -1)[:, :n_sig].int()
                    p = p.reshape(b, -1)[:, :n_sig].int()
                    n_bad += int((g != p).sum())
                    n_all += g.numel()
                    if label == "clean":
                        worst = max(worst, int((g - p).abs().max()))
            frac = n_bad / n_all
            say(f"[3 K1@{n_psk}] {mode} {label} {dtype} rows B={b} R={r}: best={best.tolist()} "
                f"mismatches={n_bad} of {n_all} ({frac:.3e}) | {card}")
            if label == "clean":
                check(n_bad == 0, f"K1@{n_psk} differs from plain on clean {mode} {dtype} captures")
            else:
                check(frac <= 1e-4, f"K1@{n_psk} mismatch fraction {frac} > 1e-4 at 6 dB SNR")
            del x
        key = f"psk_project_decide_batch@{n_psk}"
        errs[key] = float(max(errs.get(key, 0.0), worst))
        say(f"[3 K1@{n_psk}] {mode} {dtype}: {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def _check_match(name, got, ref_first, limit, expect, card, p, r, b):
    """(first, found) of a kernel vs its plain version's raw first positions
    after the limit epilogue; ``expect`` lists (capture, hypothesis, first)
    that must be found. Returns the max abs error of first."""
    import torch

    first_k, found_k = got
    found_p = (ref_first < (1 << 30)) & (ref_first < limit)
    first_p = torch.where(found_p, ref_first, torch.zeros_like(ref_first))
    check(torch.equal(found_k, found_p) and torch.equal(first_k, first_p),
          f"{name} differs from plain on the {p}-row scan")
    for i, h, pos in expect:
        if pos < limit:
            check(bool(found_k[i, h]) and int(first_k[i, h]) == pos,
                  f"{name} missed hypothesis {h} at {pos}")
    say(f"[4 {name}] rows_scanned={p} of R={r}, B={b}: first/found equal; "
        f"noise-capture hypotheses found={int(found_k[-1].sum())} | {card}")
    return int((first_k - first_p).abs().max())


def phase_match_pack(device, r: int, card: str) -> dict:
    """K2 (both families), K3, K4, K5 and K6 vs plain at the main path's row
    count; returns the max abs error per kernels-line entry."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    t0 = time.perf_counter()
    pattern = MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2
    rng = np.random.default_rng(7)
    errs = {}
    # The sync tail's tiers (parallel/batch.py _scan_tiered): 256 rows, an eighth, all.
    tiers = tuple(p for p in sorted({256, -(-r // 8 // 256) * 256}) if 2 * p <= r) + (r,)

    def lanes(caps):
        caps = caps + [tuple(rng.integers(0, 2, (r, 128), dtype=np.uint8) for _ in caps[0])]
        return [torch.from_numpy(np.stack([c[j] for c in caps])).to(device) for j in range(len(caps[0]))]

    # K2 family qpsk: every rotation x parity, plus a noise capture.
    starts = [500 + 3001 * h for h in range(8)]
    hi, lo = lanes([_magic_streams(rng, r, h % 4, h // 4, starts[h]) for h in range(8)])
    conds, _ = tk.rotation_match_conditions(pattern)
    errs["rotation_match_batch:qpsk"] = float(max(
        _check_match("K2 qpsk", tk.rotation_match_batch(
            hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, p), p * 128 - 17,
            [(h, h, starts[h]) for h in range(8)], card, p, r, hi.shape[0])
        for p in tiers))
    # K3 on the same lanes: every s8 in 0..7 x every k.
    b = hi.shape[0]
    k3 = 0
    for j in range(8):
        s = (8 * torch.randint(0, 5000, (b,), device=device, dtype=torch.int32)
             + (torch.arange(b, device=device) + j) % 8).to(torch.int32)
        ksel = ((torch.arange(b, device=device) + j) % 4).to(torch.int32)
        got = tk.relabel_pack_batch(hi, lo, s, ksel, rows_per_capture=r)
        ref = tk.relabel_pack_batch_plain(hi, lo, s, ksel)
        k3 = max(k3, int((got.int() - ref.int()).abs().max()))
    check(k3 == 0, "K3 differs from plain")
    errs["relabel_pack_batch"] = float(k3)
    say(f"[4 K3] R={r}, B={b}, every s8 in 0..7 x every k: bytes equal | {card}")

    # K2 family bpsk: every stream x inversion, plus a noise capture; K4 on them.
    starts = [700 + 4001 * h for h in range(4)]
    re, im = lanes([_bpsk_streams(rng, r, h, starts[h]) for h in range(4)])
    conds, _ = tk.bpsk_match_conditions(pattern)
    errs["rotation_match_batch:bpsk"] = float(max(
        _check_match("K2 bpsk", tk.rotation_match_batch(
            re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.rotation_match_batch_plain(re, im, conds, 16, 3, p), p * 128 - 33,
            [(h, h, starts[h]) for h in range(4)], card, p, r, re.shape[0])
        for p in tiers))
    b = re.shape[0]
    k4 = 0
    for j in range(8):
        s = (8 * torch.randint(0, 5000, (b,), device=device, dtype=torch.int32)
             + (torch.arange(b, device=device) + j) % 8).to(torch.int32)
        ksel = ((torch.arange(b, device=device) + j) % 4).to(torch.int32)
        got = tk.bit_select_pack_batch(re, im, s, ksel, rows_per_capture=r)
        ref = tk.bit_select_pack_batch_plain(re, im, s, ksel)
        k4 = max(k4, int((got.int() - ref.int()).abs().max()))
    check(k4 == 0, "K4 differs from plain")
    errs["bit_select_pack_batch"] = float(k4)
    say(f"[4 K4] R={r}, B={b}, every s8 in 0..7 x every ksel: bytes equal | {card}")

    # K5: every rotation, plus a noise capture; K6 on them. Uniform random
    # sectors false-match some hypothesis about once per 32k symbols, so the
    # planted magic sits near the start.
    starts = [50 + 97 * k for k in range(8)]
    sec = [_psk8_stream(rng, r, k, starts[k]) for k in range(8)]
    sec = torch.from_numpy(np.stack(sec + [rng.integers(0, 8, (r, 128), dtype=np.uint8)])).to(device)
    conds, n_sym = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    errs["sector_match_batch"] = float(max(
        _check_match("K5", tk.sector_match_batch(
            sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.sector_match_batch_plain(sec, conds, 3, p), p * 128 - (n_sym + 1),
            [(k, k, starts[k]) for k in range(8)], card, p, r, sec.shape[0])
        for p in tiers))
    b = sec.shape[0]
    k6 = 0
    for j in range(8):  # capture i at ksel i % 8 and every r8 in turn: every pair
        ksel = (torch.arange(b, device=device) % 8).to(torch.int32)
        r8 = ((torch.arange(b, device=device) + j) % 8).to(torch.int32)
        got = tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r)
        ref = tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)
        k6 = max(k6, int((got.int() - ref.int()).abs().max()))
    check(k6 == 0, "K6 differs from plain")
    errs["psk8_relabel_pack_rows"] = float(k6)
    say(f"[4 K6] R={r}, B={b}, every r8 in 0..7 x every ksel: bytes equal | {card}")
    say(f"[4] {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def _psk_slice_batch(mode: str, n_cap: int, n: int, payload_bytes: int):
    """A PSK slice's batch: ``n_cap`` captures of ``n`` samples, capture i
    one seeded payload framed and tiled from a random lead (captures 1 and
    2 at the carrier +-100 Hz), the last capture noise. Returns (batch,
    payloads, min_frames), None and 0 for the noise capture."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame

    rng = np.random.default_rng(2024)
    batch = np.empty((n_cap, n), np.float32)
    payloads, min_frames = [], []
    for i in range(n_cap):
        if i == n_cap - 1:
            batch[i] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
            payloads.append(None)
            min_frames.append(0)
            continue
        p = _payload(5000 + i, payload_bytes)
        if mode == "8PSK":
            # The tail aligns a capture once, at its first magic; the later
            # copies of a tiled wave stay byte-aligned only when the framed
            # length is a whole number of 8-symbol (3-byte) groups, so trim
            # the payload by 0-2 bytes (the JAX package behaves the same).
            p = p[: len(p) - len(pack_frame(f"cap{i}.bin", p, 0, 1, len(p), crc32(p))) % 3]
        wave = _wave(p, f"cap{i}.bin", mode, {1: 100.0, 2: -100.0}.get(i, 0.0))
        batch[i] = _tiled(wave, n, lead=int(rng.integers(0, 1281)))
        payloads.append(p)
        min_frames.append(n // len(wave) - 1)
    return batch, payloads, min_frames


def phase_slice(device, mode: str, n_cap: int, n: int, payload_bytes: int, card: str,
                kernels=None, tag=None, wav=None) -> dict:
    """One slice's main path at real size; returns the launch counts of its
    ``decode_sample_batch`` run. ``kernels`` (default: the slice's own) are
    the kernels the path must launch, and no others."""
    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    tag = tag or {"QPSK": "5", "BPSK": "5b", "8PSK": "5c"}[mode]
    kernels = kernels or _SLICES[mode]["kernels"]
    t_phase = t0 = time.perf_counter()
    batch, payloads, min_frames = _psk_slice_batch(mode, n_cap, n, payload_bytes)
    noise_i = n_cap - 1
    carrier = _SLICES[mode]["carrier"]
    say(f"[{tag} {mode}] built {n_cap} x {n} captures ({carrier:g} Hz carrier, captures 1 and 2 "
        f"at +-100 Hz, capture {noise_i} noise) in {time.perf_counter() - t0:.1f} s | {card}")

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, mode, BAUD, device=device)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    say(f"[{tag} {mode}] decode_sample_batch wall {wall:.3f} s (host shaping, copy, device, "
        f"copy back) launches={counts} | {card}")
    for name, c in counts.items():
        if name in kernels:
            check(c > 0, f"{name} was not launched on the {mode} path")
        else:
            check(c == 0, f"{name} was launched on the {mode} path")

    n_frames = []
    for i, raw in enumerate(raws):
        frames = parse_frames(raw)
        n_frames.append(len(frames))
        if payloads[i] is None:
            check(not frames, f"{mode} noise capture {i} yielded {len(frames)} frames")
            continue
        check(all(f.data == payloads[i] for f in frames), f"{mode} capture {i} decoded a foreign payload")
        check(len(frames) >= min_frames[i],
              f"{mode} capture {i}: {len(frames)} frames < {min_frames[i]}")
    say(f"[{tag} {mode}] frames per capture min={min(n_frames[:noise_i])} max={max(n_frames)} "
        f"(need >= {min(min_frames[:noise_i])}); +100 Hz {n_frames[1]}, -100 Hz {n_frames[2]}; "
        f"noise capture frames={n_frames[noise_i]} | {card}")
    del batch, raws

    if _SLICES[mode]["wav"] if wav is None else wav:
        _wav_roundtrip(device, mode, payload_bytes, tag)
    say(f"[{tag} {mode}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def _wav_roundtrip(device, mode: str, payload_bytes: int, tag: str, rate: int = BAUD, n_wavs: int = 4) -> None:
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.parallel.batch import decode_wav_batch
    from audio_modem_radio_tpu_torch.utils.compression import intelligent_compress
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    try:
        sources, wavs = [], []
        for i in range(n_wavs):
            data = (f"{mode} wav file {i} ".encode() * 100) + _payload(900 + i, payload_bytes // 4)
            blob = intelligent_compress(data)
            framed = pack_frame(f"src{i}.bin", blob, 0, 1, len(data), crc32(data))
            path = os.path.join(work, f"src{i}.wav")
            write_wav(path, modulate(mode, framed, rate))
            sources.append(data)
            wavs.append(path)
        saved = decode_wav_batch(wavs, mode, rate, recv_dir=os.path.join(work, "recv"),
                                 registry=AssemblyRegistry(journal_dir=""), device=device)
        for i, paths in enumerate(saved):
            check(len(paths) == 1, f"{mode} WAV {i}: {len(paths)} files saved")
            with open(paths[0], "rb") as f:
                check(f.read() == sources[i], f"{mode} WAV {i}: saved file differs from its source")
        say(f"[{tag} {mode}] decode_wav_batch: {n_wavs} WAVs written by the port, {n_wavs} saved files byte-equal")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_timing(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """Times on the bench workload of every PSK slice; returns ({entry: (ms,
    plain_ms)}, {mode: {cfo: Msamples/s}}, {entry: (bound_ms, bound_by)}).
    Operations per item, from the kernels' code: K1 8*spsym + 12 per symbol
    (two 2*spsym-tap correlations, the differential and derotation); K2 12
    per position and hypothesis (four masked popcounts); K3 8 per dibit; K4
    3 per bit; K5 6 per position and hypothesis; K6 6 per symbol."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    pattern = MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2
    t, msps, bounds = {}, {}, {}
    for mode, spec in _SLICES.items():
        t0 = time.perf_counter()
        n_psk, carrier = spec["n_psk"], spec["carrier"]
        wave = _wave(_payload(0, payload_bytes), "bench.bin", mode)
        one = _rows(_tiled(wave, n)[None], "int16", device, mode)
        x = one.expand(n_cap, -1, -1).contiguous()  # ship once, tile on the card
        del one
        b, r, row = x.shape
        # The sync tail's tiers (parallel/batch.py _scan_tiered): 256 rows, an eighth, all.
        tiers = tuple(p for p in sorted({256, -(-r // 8 // 256) * 256}) if 2 * p <= r) + (r,)
        msps[mode] = {}
        for cfo in (True, False):
            ms = _time_ms(lambda: demod_pack_batch(x, mode, BAUD, cfo_retry=cfo))
            msps[mode][cfo] = b * n / (ms * 1e-3) / 1e6
            say(f"[6 time] demod_pack_batch {mode} {b} x {n} int16 rows cfo_retry="
                f"{'on' if cfo else 'off'}: {ms:.3f} ms = {msps[mode][cfo]:.2f} Msamples/s | {card}")
        _, _, found = demod_pack_batch(x, mode, BAUD, cfo_retry=True)
        check(bool(found.all()), f"{mode} bench batch: a capture found no magic")
        _time_noise_last(x, mode, n, tiers, card)
        if mode == "8PSK":
            _time_psk8_xla(x, n, card)

        _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r,
                                         n_psk=8 if n_psk == 8 else 4)
        W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, x.device)
        rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
        key = f"psk_project_decide_batch@{n_psk}"
        n_sym = b * r * 128
        bounds[key] = _bound(x.numel() * x.element_size() + n_sym * (1 if n_psk == 8 else 2),
                             n_sym * (8 * SPSYM + 12))
        t[key] = (
            _time_ms(lambda: tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)),
            _time_ms(lambda: tk.psk_project_decide_batch_plain(x, W8, best, rot, n_psk=n_psk)),
        )
        out = tk.psk_project_decide_batch(x, W8, best, rot, rows_per_capture=r, n_psk=n_psk)
        zeros = torch.zeros(b, dtype=torch.int32, device=x.device)
        if mode == "QPSK":
            hi, lo = out
            conds, _ = tk.rotation_match_conditions(pattern)
            first, _ = tk.rotation_match_batch(hi, lo, MAGIC_BIT_PATTERN, r,
                                               pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            bounds["relabel_pack_batch"] = _bound(n_sym * 2 + b * r * 32, n_sym * 8)
            for p in tiers:
                bounds[f"rotation_match_batch:qpsk@{p}"] = _bound(2 * b * p * 128, b * p * 128 * 8 * 12)
                t[f"rotation_match_batch:qpsk@{p}"] = (
                    _time_ms(lambda: tk.rotation_match_batch(
                        hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)),
                    _time_ms(lambda: tk.rotation_match_batch_plain(hi, lo, conds, 16, 3, p)),
                )
            _check_one_launch(lambda: tk.rotation_match_batch(
                hi, lo, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256),
                "rotmatch_kernel", card)
            s = (2 * first[:, 0]).to(torch.int32)
            t["relabel_pack_batch"] = (
                _time_ms(lambda: tk.relabel_pack_batch(hi, lo, s, zeros, rows_per_capture=r)),
                _time_ms(lambda: tk.relabel_pack_batch_plain(hi, lo, s, zeros)),
            )
            _check_pack_every_pair("K3", tk.relabel_pack_batch, tk.relabel_pack_batch_plain, hi, lo, s, card)
            del x
            x8 = _rows(_tiled(wave, n)[None], "int8", device, mode).expand(n_cap, -1, -1).contiguous()
            key8 = "psk_project_decide_batch@4 int8"
            bounds[key8] = _bound(x8.numel() + n_sym * 2, n_sym * (8 * SPSYM + 12))
            t[key8] = (
                _time_ms(lambda: tk.psk_project_decide_batch(x8, W8, best, rot, rows_per_capture=r)),
                _time_ms(lambda: tk.psk_project_decide_batch_plain(x8, W8, best, rot)),
            )
            say(f"[6 time] K1@4 on int8 rows {tuple(x8.shape)}: kernel {t[key8][0]:.4f} ms, plain "
                f"{t[key8][1]:.4f} ms, bound {bounds[key8][0]:.4f} ms by {bounds[key8][1]}; int16 rows "
                f"{t[key][0]:.4f} ms | {card}")
            del x8
        elif mode == "BPSK":
            re, im = out
            conds, _ = tk.bpsk_match_conditions(pattern)
            first, _ = tk.rotation_match_batch(re, im, MAGIC_BIT_PATTERN, r, family="bpsk",
                                               pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            bounds["bit_select_pack_batch"] = _bound(n_sym + b * r * 16, n_sym * 3)
            for p in tiers:
                bounds[f"rotation_match_batch:bpsk@{p}"] = _bound(2 * b * p * 128, b * p * 128 * 4 * 12)
                t[f"rotation_match_batch:bpsk@{p}"] = (
                    _time_ms(lambda: tk.rotation_match_batch(
                        re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2,
                        rows_scanned=p)),
                    _time_ms(lambda: tk.rotation_match_batch_plain(re, im, conds, 16, 3, p)),
                )
            _check_one_launch(lambda: tk.rotation_match_batch(
                re, im, MAGIC_BIT_PATTERN, r, family="bpsk", pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256),
                "rotmatch_kernel", card)
            s = first[:, 0].contiguous()
            t["bit_select_pack_batch"] = (
                _time_ms(lambda: tk.bit_select_pack_batch(re, im, s, zeros, rows_per_capture=r)),
                _time_ms(lambda: tk.bit_select_pack_batch_plain(re, im, s, zeros)),
            )
            _check_pack_every_pair("K4", tk.bit_select_pack_batch, tk.bit_select_pack_batch_plain, re, im, s, card)
            del x
        else:
            sec = out
            conds, _ = tk.psk8_match_conditions(MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
            first, found8 = tk.sector_match_batch(sec, MAGIC_BIT_PATTERN, r,
                                                  pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256)
            bounds["psk8_relabel_pack_rows"] = _bound(n_sym + b * r * 48, n_sym * 6)
            for p in tiers:
                bounds[f"sector_match_batch@{p}"] = _bound(b * p * 128, b * p * 128 * 8 * 6)
                t[f"sector_match_batch@{p}"] = (
                    _time_ms(lambda: tk.sector_match_batch(
                        sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p)),
                    _time_ms(lambda: tk.sector_match_batch_plain(sec, conds, 3, p)),
                )
            _check_one_launch(lambda: tk.sector_match_batch(
                sec, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=256),
                "sector_match_kernel", card)
            ksel = torch.argmax(found8.to(torch.uint8), dim=1).to(torch.int32)
            r8 = (torch.gather(first, 1, ksel[:, None].long())[:, 0] % 8).to(torch.int32)
            t["psk8_relabel_pack_rows"] = (
                _time_ms(lambda: tk.psk8_relabel_pack_rows(sec, ksel, r8, rows_per_capture=r)),
                _time_ms(lambda: tk.psk8_relabel_pack_rows_plain(sec, ksel, r8)),
            )
            del x
        del out
        torch.cuda.empty_cache()
        say(f"[6 time] {mode}: {time.perf_counter() - t0:.1f} s | {card}")
    for name, (ms, plain) in t.items():
        bound = f", bound {bounds[name][0]:.4f} ms by {bounds[name][1]}" if name in bounds else ""
        say(f"[6 time] {name} B={n_cap} R={r}: kernel {ms:.4f} ms, plain {plain:.4f} ms{bound} | {card}")
    for entry in ("rotation_match_batch:qpsk", "rotation_match_batch:bpsk", "sector_match_batch"):
        bounds[entry] = bounds[f"{entry}@256"]  # the kernels line reports the first tier
    return t, msps, bounds


def _check_pack_every_pair(label: str, kernel, plain, a, b, s, card: str) -> None:
    """K3 or K4 on K1's lanes ``a``, ``b`` of the bench batch with capture
    i at ksel i % 4 and s8 (i // 4) % 8 (the sync's ``s`` otherwise), so
    that the 64 captures take every (ksel, s8) pair twice: bytes equal to
    the plain version's, and the kernel's time at those pairs."""
    import torch

    i = torch.arange(a.shape[0], device=a.device)
    s_pairs = (s - (s & 7) + (i // 4) % 8).to(torch.int32)
    ksel = (i % 4).to(torch.int32)
    got = kernel(a, b, s_pairs, ksel, rows_per_capture=a.shape[1])
    n_diff = int((got != plain(a, b, s_pairs, ksel)).sum())
    check(n_diff == 0, f"{label} on the bench lanes at every (ksel, s8): {n_diff} bytes differ from plain")
    ms = _time_ms(lambda: kernel(a, b, s_pairs, ksel, rows_per_capture=a.shape[1]))
    say(f"[6 {label}] bench lanes {tuple(a.shape)}, every (ksel, s8) pair: 0 of {got.numel()} bytes differ "
        f"from plain; kernel {ms:.4f} ms | {card}")


_MATCHER = {"QPSK": ("rotation_match_batch", "K2"), "BPSK": ("rotation_match_batch", "K2"),
            "8PSK": ("sector_match_batch", "K5")}


def _time_noise_last(x, mode: str, n: int, tiers, card: str) -> None:
    """PSK ``demod_pack_batch`` on the bench batch ``x`` with its last
    capture seeded noise. The noise capture has no magic, so the sync tail
    takes the next tier until a false match in the noise satisfies it
    (QPSK: hypothesis 0 at either parity; BPSK: hypothesis 0; 8PSK: with
    cfo_retry on any of the 8, with it off hypothesis 0). Each run's matcher
    launches (K2 or K5) are printed."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    b = x.shape[0]
    matcher, label = _MATCHER[mode]
    xn = x.clone()
    g = torch.Generator(device=x.device).manual_seed(31)
    xn[-1] = (torch.randn(x.shape[1:], generator=g, device=x.device) * (0.3 * 32767)).round().clamp(
        -32768, 32767).to(x.dtype)
    for cfo in (True, False):
        tk.reset_launch_counts()
        _, _, found = demod_pack_batch(xn, mode, BAUD, cfo_retry=cfo)
        k = tk.launch_counts()[matcher]
        check(bool(found[:-1].all()), f"{mode} with a noise capture: a signal capture found no magic")
        check(1 <= k <= len(tiers), f"{mode} with a noise capture: {k} {label} launches for {len(tiers)} tiers")
        ms = _time_ms(lambda: demod_pack_batch(xn, mode, BAUD, cfo_retry=cfo))
        say(f"[6 time] demod_pack_batch {mode} {b} x {n} int16 rows, last capture noise, cfo_retry="
            f"{'on' if cfo else 'off'}: {ms:.3f} ms = {b * n / (ms * 1e-3) / 1e6:.2f} Msamples/s; {label} launches "
            f"{k} (rows_scanned {', '.join(map(str, tiers[:k]))}) | {card}")


def _time_psk8_xla(x, n: int, card: str) -> None:
    """8PSK ``demod_pack_batch`` on the bench batch ``x`` under CONFIG
    ``tpu.demod_backend = "xla"`` (the staged float path: K12 once, then
    the per-capture tails)."""
    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    b = x.shape[0]
    CONFIG.set("tpu.demod_backend", "xla")
    try:
        tk.reset_launch_counts()
        _, _, found = demod_pack_batch(x, "8PSK", BAUD, cfo_retry=True)
        counts = tk.launch_counts()
        check(bool(found.all()), "8PSK under xla: a capture found no magic")
        check(counts["psk_project_diff_batch"] == 1 and sum(counts.values()) == 1,
              f"8PSK under xla must launch K12 once and nothing else: {counts}")
        ms = _time_ms(lambda: demod_pack_batch(x, "8PSK", BAUD, cfo_retry=True), reps=3)
    finally:
        CONFIG.set("tpu.demod_backend", "auto")
    say(f"[6 time] demod_pack_batch 8PSK {b} x {n} int16 rows under tpu.demod_backend=xla (K12, then the "
        f"per-capture tails), cfo_retry=on, median of 3: {ms:.3f} ms = {b * n / (ms * 1e-3) / 1e6:.2f} "
        f"Msamples/s | {card}")


def _check_one_launch(fn, kernel: str, card: str, reps: int = 5) -> None:
    """``reps`` calls of ``fn()`` under ``torch.profiler`` (after a warm-up
    call) run exactly ``reps`` device kernels, each ``kernel``, and no copy
    or fill. A session that recorded no device activity at all is the
    profiler's fault (it happened in one of three runs on an H100, in the
    process's first session), so up to three sessions are taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    copies = [nm for nm in names if nm.startswith(("Memcpy", "Memset"))]
    kernels = [nm for nm in names if nm not in copies]
    check(len(kernels) == reps and all(kernel in k for k in kernels) and not copies,
          f"{reps} calls must be {reps} device kernels {kernel} and no copy: {names}")
    say(f"[6 time] {reps} calls under torch.profiler: one device kernel each ({kernels[0][:60]}), no copy | {card}")


_RAGGED_BOXCAR_ROWS = 53  # 265 FIR rows: 16 passes of 16 and one of 9


def _bit_mismatch(got, ref, n_sig: int):
    """(mismatched bits, compared bits) over [0, n_sig) of every capture."""
    g, p = got[:, :n_sig], ref[:, :n_sig]
    return int((g != p).sum()), g.numel()


def phase_fsk_kernels(device, n_cap: int, n: int, card: str) -> dict:
    """K7, K13, K8 and K9 vs plain on real FSK captures; returns
    {entry: (max abs error, max relative error)} over the clean captures."""
    import torch

    from audio_modem_radio_tpu_torch.ops import fsk as tf
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    errs = {}
    for label, (mode, rate, pbytes) in _K7_CASES.items():
        t0 = time.perf_counter()
        baud, mark, space = _fsk_params(mode, rate)
        spb = int(round(SR / baud))
        clean = np.stack([_tiled(_mode_wave(_payload(300 + i, pbytes), f"k7_{i}.bin", mode, rate), n,
                                 lead=7 * i) for i in range(n_cap)])
        noisy = _awgn(clean[:1], 6.0, device)
        n_sig = n // spb - 2
        for dtype in ("f32", "int16"):
            for tag, data in (("clean", clean), ("awgn6dB", noisy)):
                x = _rows(data, dtype, device, mode, rate)
                if dtype == "int16" and x.dtype != torch.int16:
                    break  # no 256-row plan (MSK@1000, FT8): the rows are float32 on every device
                best, W, spr = tf.fsk_dual_pass1(x, baud, mark, space, SR)
                got = tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=x.shape[1], spr=spr)
                ref = tk.fsk_tile_bits_batch_plain(x, W, best, spr)
                torch.cuda.synchronize()
                n_bad, n_all = _bit_mismatch(got, ref, n_sig)
                say(f"[3b K7] {label} spr={spr} {tag} {dtype} rows {tuple(x.shape)}: best={best.tolist()} "
                    f"mismatches={n_bad} of {n_all} ({n_bad / n_all:.3e}) | {card}")
                if tag == "clean":
                    check(n_bad == 0, f"K7 differs from plain on clean {label} {dtype} captures")
                else:
                    check(n_bad / n_all <= 1e-4, f"K7 mismatch fraction {n_bad / n_all} > 1e-4 at 6 dB")
                if label == "FSK1200" and dtype == "f32" and tag == "clean":
                    # K13 on the same captures' flat rows, at the same offsets.
                    flat = torch.from_numpy(data).to(device)
                    r = x.shape[1]
                    rows = torch.nn.functional.pad(flat, (0, r * spr * spb - n)).reshape(n_cap, r, spr * spb)
                    got13 = tk.fsk_project_bits_batch(rows, W, best, rows_per_capture=r, spr=spr)
                    ref13 = tk.fsk_project_bits_batch_plain(rows, W, best, spr)
                    torch.cuda.synchronize()
                    bad13, _ = _bit_mismatch(got13, ref13, n_sig)
                    bad_k7, _ = _bit_mismatch(got13, got, n_sig)
                    say(f"[3b K13] FSK1200 flat f32 rows {tuple(rows.shape)}: mismatches vs plain={bad13}, "
                        f"vs K7={bad_k7} of {n_all} | {card}")
                    check(bad13 == 0 and bad_k7 == 0, "K13 differs from plain or from K7 on clean FSK1200")
                    errs["fsk_project_bits_batch"] = (0.0, None)
                    del flat, rows, got13, ref13
                del x, got, ref
        errs["fsk_tile_bits_batch"] = (0.0, None)
        say(f"[3b K7] {label}: {time.perf_counter() - t0:.1f} s | {card}")

    for mode, entry in (("FSK9600", "fsk_disc_sums_batch"), ("FSK19200", "fsk_quad_margin_batch")):
        t0 = time.perf_counter()
        rate = _FSK_SLICES[mode]["rate"]
        baud, mark, space = _fsk_params(mode, rate)
        clean = np.stack([_tiled(_mode_wave(_payload(400 + i, 16384), f"k8_{i}.bin", mode, rate), n,
                                 lead=5 * i) for i in range(n_cap)])
        noisy = _awgn(clean[:1], 15.0, device)
        n_sig = n // int(round(SR / baud)) - 2
        worst_abs = worst_rel = 0.0
        for dtype in ("f32", "int16"):
            for tag, data in (("clean", clean), ("awgn15dB", noisy)):
                x = _rows(data, dtype, device, mode, rate)
                if mode == "FSK9600":
                    best, plan, Wf, W2, coef = tf.fsk_disc_pass1(x, baud, mark, space, SR)
                else:
                    best, plan, Wf, W2 = tf.fsk_quad_pass1(x, baud, mark, space, SR)
                kw = dict(rows_per_capture=x.shape[1], nrow2=plan["nrow2"], row2=plan["row2"],
                          ov2=plan["ov2"], spr2=plan["spr2"])
                if mode == "FSK9600":
                    got = tk.fsk_disc_sums_batch(x, Wf, W2, best, **kw)
                    ref = tk.fsk_disc_sums_batch_plain(x, Wf, W2, best, plan["row2"], plan["ov2"])
                    bits_k = tf.disc_decide(*got, plan, coef, SR, mark, space)
                    bits_p = tf.disc_decide(*ref, plan, coef, SR, mark, space)
                else:
                    got = (tk.fsk_quad_margin_batch(x, Wf, W2, best, **kw),)
                    ref = (tk.fsk_quad_margin_batch_plain(x, Wf, W2, best, plan["row2"], plan["ov2"],
                                                          plan["spr2"]),)
                    bits_k, bits_p = got[0] > 0, ref[0] > 0
                torch.cuda.synchronize()
                rel = ab = 0.0
                for g, p in zip(got, ref):
                    d = (g[:, :n_sig] - p[:, :n_sig]).abs().amax(dim=1)
                    rel = max(rel, float((d / p[:, :n_sig].abs().amax(dim=1)).max()))
                    ab = max(ab, float(d.max()))
                n_bad, n_all = _bit_mismatch(bits_k, bits_p, n_sig)
                say(f"[3b {entry}] {mode} {tag} {dtype} rows {tuple(x.shape)}: best={best.tolist()} max abs "
                    f"err {ab:.4e}, max rel err {rel:.4e}; bit mismatches={n_bad} of {n_all} | {card}")
                check(rel <= 1e-4, f"{entry} relative error {rel} > 1e-4 on {mode} {tag} {dtype}")
                if tag == "clean":
                    check(n_bad == 0, f"{entry} bits differ from plain on clean {mode} {dtype} captures")
                    worst_abs, worst_rel = max(worst_abs, ab), max(worst_rel, rel)
                else:
                    check(n_bad / n_all <= 1e-4, f"{entry} bit mismatch fraction {n_bad / n_all} > 1e-4")
                if tag == "clean":
                    # A FIR row count that is no multiple of the kernels' 16-row pass (nor of the
                    # 512 rows a block walks): the last pass is cut short and reads past the
                    # capture's last FIR row.
                    del got, ref
                    rows_pb = plan["row2"] // 128
                    xr = x[:, : rows_pb * _RAGGED_BOXCAR_ROWS].contiguous()
                    kwr = dict(kw, rows_per_capture=xr.shape[1], nrow2=1)
                    if mode == "FSK9600":
                        got = tk.fsk_disc_sums_batch(xr, Wf, W2, best, **kwr)
                        ref = tk.fsk_disc_sums_batch_plain(xr, Wf, W2, best, plan["row2"], plan["ov2"])
                        bits_k = tf.disc_decide(*got, plan, coef, SR, mark, space)
                        bits_p = tf.disc_decide(*ref, plan, coef, SR, mark, space)
                    else:
                        got = (tk.fsk_quad_margin_batch(xr, Wf, W2, best, **kwr),)
                        ref = (tk.fsk_quad_margin_batch_plain(xr, Wf, W2, best, plan["row2"], plan["ov2"],
                                                              plan["spr2"]),)
                        bits_k, bits_p = got[0] > 0, ref[0] > 0
                    torch.cuda.synchronize()
                    rel = max(float(((g - p).abs().amax(dim=1) / p.abs().amax(dim=1)).max())
                              for g, p in zip(got, ref))
                    n_bad, n_all = _bit_mismatch(bits_k, bits_p, bits_p.shape[1])
                    say(f"[3b {entry}] {mode} ragged pass {dtype} dec={plan['dec']} rows {tuple(xr.shape)} "
                        f"({_RAGGED_BOXCAR_ROWS} boxcar rows): max rel err {rel:.4e}; bit mismatches={n_bad} "
                        f"of {n_all} | {card}")
                    check(rel <= 1e-4, f"{entry} relative error {rel} > 1e-4 on the ragged pass, {mode} {dtype}")
                    check(n_bad == 0, f"{entry} bits differ from plain on the ragged pass, {mode} {dtype}")
                    worst_rel = max(worst_rel, rel)
                    del xr
                del x, got, ref
        errs[entry] = (worst_abs, worst_rel)
        torch.cuda.empty_cache()
        say(f"[3b {entry}] {mode}: {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def _check_frames(mode: str, raws, payloads, min_frames, tag: str, card: str, what: str) -> None:
    from audio_modem_radio_tpu_torch.framing import parse_frames

    n_frames = []
    noise_i = len(payloads) - 1
    for i, raw in enumerate(raws):
        frames = parse_frames(raw)
        n_frames.append(len(frames))
        if payloads[i] is None:
            check(not frames, f"{mode} noise capture {i} yielded {len(frames)} frames ({what})")
            continue
        check(all(f.data == payloads[i] for f in frames), f"{mode} capture {i} decoded a foreign payload ({what})")
        check(len(frames) >= min_frames[i], f"{mode} capture {i}: {len(frames)} frames < {min_frames[i]} ({what})")
    say(f"[{tag} {mode}] {what}: frames per capture min={min(n_frames[:noise_i])} max={max(n_frames)} "
        f"(need >= {min(min_frames[:noise_i])}); noise capture frames={n_frames[noise_i]} | {card}")


def _check_launches(counts: dict, want, mode: str, what: str) -> None:
    for name, c in counts.items():
        if name in want:
            check(c > 0, f"{name} was not launched on the {mode} {what} path")
        else:
            check(c == 0, f"{name} was launched on the {mode} {what} path")


def phase_fsk_slice(device, mode: str, n_cap: int, n: int, payload_bytes: int, tag: str, card: str) -> dict:
    """One FSK slice's main path at real size; returns the launch counts of
    its ``decode_sample_batch`` run (and, for FSK1200, of the flat path
    under the key "FSK1200 flat")."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch, demod_pack_batch

    rate = _FSK_SLICES[mode]["rate"]
    rng = np.random.default_rng(2025)
    t_phase = t0 = time.perf_counter()
    batch = np.empty((n_cap, n), np.float32)
    payloads, min_frames = [], []
    noise_i = n_cap - 1
    for i in range(n_cap):
        if i == noise_i:
            batch[i] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
            payloads.append(None)
            min_frames.append(0)
            continue
        p = _payload(6000 + i, payload_bytes)
        wave = _mode_wave(p, f"cap{i}.bin", mode, rate)
        batch[i] = _tiled(wave, n, lead=int(rng.integers(0, 1281)))
        payloads.append(p)
        min_frames.append(max(1, n // len(wave) - 1))
    say(f"[{tag} {mode}] built {n_cap} x {n} captures (capture {noise_i} noise) in "
        f"{time.perf_counter() - t0:.1f} s | {card}")

    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, mode, rate, device=device)
    wall = time.perf_counter() - t0
    counts = {mode: tk.launch_counts()}
    say(f"[{tag} {mode}] decode_sample_batch wall {wall:.3f} s (host shaping, copy, device, copy back) "
        f"launches={counts[mode]} | {card}")
    _check_launches(counts[mode], _FSK_SLICES[mode]["kernels"], mode, "decode_sample_batch")
    _check_frames(mode, raws, payloads, min_frames, tag, card, "decode_sample_batch")
    del raws

    if mode == "FSK1200":
        flat = torch.from_numpy(batch).to(device)
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        packed, n_valid, _found = demod_pack_batch(flat, mode, rate)
        packed, n_valid = packed.cpu().numpy(), n_valid.cpu().numpy()
        wall = time.perf_counter() - t0
        counts["FSK1200 flat"] = tk.launch_counts()
        say(f"[{tag} {mode}] flat (B, N) captures through demod_pack_batch: wall {wall:.3f} s "
            f"launches={counts['FSK1200 flat']} | {card}")
        _check_launches(counts["FSK1200 flat"], ("fsk_project_bits_batch",), mode, "flat")
        raws = [packed[i, : int(n_valid[i])].tobytes() for i in range(n_cap)]
        _check_frames(mode, raws, payloads, min_frames, tag, card, "flat demod_pack_batch")
        del flat, packed, raws
    del batch
    torch.cuda.empty_cache()
    if _FSK_SLICES[mode]["wav"]:
        _wav_roundtrip(device, mode, payload_bytes, tag, rate)
    say(f"[{tag} {mode}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def phase_fsk_timing(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """``demod_pack_batch`` and the FSK kernels on each FSK mode's bench
    batch; returns ({entry: (ms, plain_ms, plain_captures)}, {mode:
    Msamples/s}, {entry: (bound_ms, bound_by)}). Operations: K7 and K13 8*spb
    + 7 per bit (four spb-tap correlations and the energies), K8 and K9 4 x
    129 per analytic output (two 129-tap FMAs), 6 per phasor (K8), 4 per
    nonzero boxcar or quadrature tap of the winning offset (two streams)
    and 11 per K9 margin."""
    import torch

    from audio_modem_radio_tpu_torch.ops import fsk as tf
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    t, msps, bounds = {}, {}, {}
    plain_cap = min(8, n_cap)
    for mode, spec in _FSK_SLICES.items():
        t0 = time.perf_counter()
        rate = spec["rate"]
        baud, mark, space = _fsk_params(mode, rate)
        spb = int(round(SR / baud))
        wave = _mode_wave(_payload(0, payload_bytes), "bench.bin", mode, rate)
        one = _rows(_tiled(wave, n)[None], "int16", device, mode, rate)
        x = one.expand(n_cap, -1, -1).contiguous()  # ship once, tile on the card
        del one
        b, r, c = x.shape
        ms = _time_ms(lambda: demod_pack_batch(x, mode, rate))
        msps[mode] = b * n / (ms * 1e-3) / 1e6
        say(f"[6 time] demod_pack_batch {mode} {b} x {n} int16 rows {tuple(x.shape)}: {ms:.3f} ms = "
            f"{msps[mode]:.2f} Msamples/s | {card}")
        _, _, found = demod_pack_batch(x, mode, rate)
        check(bool(found.all()), f"{mode} bench batch: a capture found no magic")
        x_bytes = x.numel() * x.element_size()
        if mode == "FSK1200":
            best, W, spr = tf.fsk_dual_pass1(x, baud, mark, space, SR)
            n_bits = b * r * spr
            bounds["fsk_tile_bits_batch"] = _bound(x_bytes + n_bits, n_bits * (8 * spb + 7))
            t["fsk_tile_bits_batch"] = (
                _time_ms(lambda: tk.fsk_tile_bits_batch(x, W, best, rows_per_capture=r, spr=spr)),
                _time_ms(lambda: tk.fsk_tile_bits_batch_plain(x, W, best, spr)), b)
            del x
            # The flat (B, N) float32 captures of the same wave: the path of K13.
            samples = torch.from_numpy(_tiled(wave, n)[None]).to(device).expand(n_cap, -1).contiguous()
            ms = _time_ms(lambda: demod_pack_batch(samples, mode, rate))
            msps["FSK1200 flat"] = b * n / (ms * 1e-3) / 1e6
            say(f"[6 time] demod_pack_batch {mode} {b} x {n} flat float32 captures: {ms:.3f} ms = "
                f"{msps['FSK1200 flat']:.2f} Msamples/s | {card}")
            _, _, found = demod_pack_batch(samples, mode, rate)
            check(bool(found.all()), f"{mode} flat bench batch: a capture found no magic")
            flat = torch.nn.functional.pad(samples, (0, r * spr * spb - n))
            del samples
            rows = flat.reshape(n_cap, r, spr * spb)
            bounds["fsk_project_bits_batch"] = _bound(rows.numel() * 4 + n_bits, n_bits * (8 * spb + 7))
            t["fsk_project_bits_batch"] = (
                _time_ms(lambda: tk.fsk_project_bits_batch(rows, W, best, rows_per_capture=r, spr=spr)),
                _time_ms(lambda: tk.fsk_project_bits_batch_plain(rows, W, best, spr)), b)
            del flat, rows
        else:
            pass1 = tf.fsk_disc_pass1 if mode == "FSK9600" else tf.fsk_quad_pass1
            best, plan, Wf, W2 = pass1(x, baud, mark, space, SR)[:4]
            kw = dict(rows_per_capture=r, nrow2=plan["nrow2"], row2=plan["row2"], ov2=plan["ov2"],
                      spr2=plan["spr2"])
            r2 = r * 128 // plan["row2"]
            n_bits = b * r2 * plan["spr2"]
            taps_nz = float(sum(int((W2[int(k)] != 0).sum()) for k in best.tolist()))  # per boxcar row
            fir_ops = b * r * 128 * 4 * 129
            if mode == "FSK9600":
                entry = "fsk_disc_sums_batch"
                ops = fir_ops + b * r * 128 * 6 + r2 * taps_nz * 4
                bounds[entry] = _bound(x_bytes + 2 * 4 * n_bits, ops)
                fn = lambda: tk.fsk_disc_sums_batch(x, Wf, W2, best, **kw)  # noqa: E731
                xp = x[:plain_cap]
                plain = lambda: tk.fsk_disc_sums_batch_plain(  # noqa: E731
                    xp, Wf, W2, best[:plain_cap], plan["row2"], plan["ov2"])
            else:
                entry = "fsk_quad_margin_batch"
                ops = fir_ops + r2 * taps_nz * 4 + n_bits * 11
                bounds[entry] = _bound(x_bytes + 4 * n_bits, ops)
                fn = lambda: tk.fsk_quad_margin_batch(x, Wf, W2, best, **kw)  # noqa: E731
                xp = x[:plain_cap]
                plain = lambda: tk.fsk_quad_margin_batch_plain(  # noqa: E731
                    xp, Wf, W2, best[:plain_cap], plan["row2"], plan["ov2"], plan["spr2"])
            t[entry] = (_time_ms(fn), _time_ms(plain), plain_cap)
            del x, xp
        torch.cuda.empty_cache()
        say(f"[6 time] {mode}: {time.perf_counter() - t0:.1f} s | {card}")
    for name, (ms, plain, pc) in t.items():
        say(f"[6 time] {name} B={n_cap}: kernel {ms:.4f} ms, plain {plain:.4f} ms (plain at {pc} captures), "
            f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]} | {card}")
    return t, msps, bounds


# --- the single-capture receive: K11, K12 and decode_wav_file ---------------------

def _k11_rows(n: int) -> int:
    """Rows of a capture of n samples in the single-capture receiver's K11
    layout: ceil(n_frames / 128), padded to a multiple of 64."""
    r = -(-(-(-n // SPSYM)) // 128)
    return -(-r // 64) * 64


def _diff_decisions(d_re, d_im, theta, n_psk: int):
    """Decisions from float differential streams after derotation by θ:
    stacked Gray (hi, lo) for n_psk 4, π/4 sectors for 8."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import derotate

    dr, di = derotate(d_re, d_im, theta)
    return tk.psk8_sector_stream(dr, di) if n_psk == 8 else torch.stack(tk._decide(dr, di, 4))


def _diff_compare(got, ref, theta, n_psk: int, n_sig: int):
    """(max abs error, error / RMS, decision mismatches, decisions compared)
    of two (d_re, d_im) pairs over each capture's first n_sig entries."""
    import torch

    b = theta.shape[0]
    got = [g.reshape(b, -1)[:, :n_sig] for g in got]
    ref = [p.reshape(b, -1)[:, :n_sig] for p in ref]
    err = max(float((g - p).abs().max()) for g, p in zip(got, ref))
    rms = float(torch.sqrt(torch.mean(ref[0] ** 2 + ref[1] ** 2)))
    dk, dp = _diff_decisions(*got, theta, n_psk), _diff_decisions(*ref, theta, n_psk)
    return err, err / rms, int((dk != dp).sum()), dk.numel()


def phase_project_diff(device, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """K12 and K11 vs plain; returns {entry: (max abs error, max relative
    error)} (relative to the stream's RMS)."""
    import torch
    import torch.nn.functional as F

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables

    errs = {"psk_project_diff_batch": (0.0, 0.0), "psk_project_diff": (0.0, 0.0)}
    n_sig = n // SPSYM - 2
    for mode in ("QPSK", "8PSK"):
        t0 = time.perf_counter()
        n_psk, carrier = _SLICES[mode]["n_psk"], _SLICES[mode]["carrier"]
        clean = np.stack([_tiled(_wave(_payload(700 + i, payload_bytes), f"k12_{i}.bin", mode), n, lead=3 * i)
                          for i in range(n_cap)])
        W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, device)
        for dtype in ("f32", "int16"):
            x = _rows(clean, dtype, device, mode)
            b, r, _ = x.shape
            _, _, best, theta = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r, n_psk=n_psk)
            got = tk.psk_project_diff_batch(x, W8, best, rows_per_capture=r)
            ref = tk.psk_project_diff_batch_plain(x, W8, best)
            torch.cuda.synchronize()
            err, rel, bad, n_all = _diff_compare(got, ref, theta, n_psk, n_sig)
            say(f"[3c K12] {mode} {dtype} rows B={b} R={r}: best={best.tolist()} max abs err {err:.4e} "
                f"({rel:.3e} of the RMS); decisions after derotation: mismatches={bad} of {n_all} | {card}")
            check(rel <= 1e-5, f"K12 differs from plain by {rel:.3e} of the RMS on {mode} {dtype}")
            check(bad == 0, f"K12's decisions differ from plain on clean {mode} {dtype} captures")
            e = errs["psk_project_diff_batch"]
            errs["psk_project_diff_batch"] = (max(e[0], err), max(e[1], rel))
            if dtype == "f32":
                # K11: capture 0 in the single-capture layout (rows of the
                # flat capture padded to a multiple of 64), its own offset.
                flat = torch.from_numpy(clean[0]).to(device)
                r64 = _k11_rows(n)
                x2d = F.pad(flat, (0, r64 * 128 * SPSYM - n)).reshape(r64, 128 * SPSYM)
                got1 = tk.psk_project_diff(x2d, W8[best[0]], block_rows=64)
                ref1 = tk.psk_project_diff_plain(x2d, W8[best[0]])
                torch.cuda.synchronize()
                err, rel, bad, n_all = _diff_compare(got1, ref1, theta[:1], n_psk, n_sig)
                say(f"[3c K11] {mode} f32 one capture, {r64} rows: max abs err {err:.4e} ({rel:.3e} of the "
                    f"RMS); decisions after derotation: mismatches={bad} of {n_all} | {card}")
                check(rel <= 1e-5 and bad == 0, f"K11 differs from plain on a clean {mode} capture")
                e = errs["psk_project_diff"]
                errs["psk_project_diff"] = (max(e[0], err), max(e[1], rel))
                del flat, x2d, got1, ref1
            del x, got, ref
        torch.cuda.empty_cache()
        say(f"[3c] {mode}: {time.perf_counter() - t0:.1f} s | {card}")
    return errs


def _decode_wav(device, path: str, mode: str, rate: int, work: str, label: str, **options):
    """decode_wav_file on ``device`` (with ``options``: stream_fec, denoise)
    with the launch counts and the ladder's host reads reset first: (saved
    paths, counts, host reads, wall s)."""
    import torch

    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.decoder import decode_wav_file
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops import psk as tpsk

    tk.reset_launch_counts()
    tpsk._found.host_reads = 0
    t0 = time.perf_counter()
    saved = decode_wav_file(path, mode, rate, recv_dir=os.path.join(work, "recv_" + label),
                            registry=AssemblyRegistry(journal_dir=""), device=device, **options)
    torch.cuda.synchronize()
    return saved, tk.launch_counts(), tpsk._found.host_reads, time.perf_counter() - t0


def phase_single(device, n: int, card: str) -> dict:
    """Single-capture decodes at full width; returns the launch counts of
    the clean QPSK decode under the key "QPSK single" and the WAV paths
    kept for phase 6 under "wavs"."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    scratch = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    out = {"work": work, "wavs": {}}
    rng = np.random.default_rng(77)
    for k, mode in enumerate(_SLICES):
        for offset in (0.0, 100.0):
            t0 = time.perf_counter()
            data, wave = _multipart_transmission(mode, 40 + k, offset)
            x = np.zeros(n, np.float32)
            lead = int(rng.integers(0, 96000))
            check(lead + len(wave) <= n, f"{mode}: the 8-part transmission does not fit 2^24 samples")
            x[lead : lead + len(wave)] = wave
            path = os.path.join(work, f"{mode}_{offset:g}.wav")
            write_wav(path, x)
            saved, counts, reads, wall = _decode_wav(device, path, mode, BAUD, work, f"{mode}{offset:g}")
            say(f"[5g {mode}] decode_wav_file, carrier +{offset:g} Hz, {len(wave) / SR:.1f} s of signal in "
                f"{n / SR:.1f} s: wall {wall:.3f} s, saved {len(saved)}, launches={counts}, ladder host "
                f"reads {reads} | {card}")
            check(len(saved) == 1, f"{mode} +{offset:g} Hz: {len(saved)} files saved")
            with open(saved[0], "rb") as f:
                check(f.read() == data, f"{mode} +{offset:g} Hz: the reassembled file differs")
            if offset == 0.0:
                check(counts["psk_project_diff"] == 1 and sum(counts.values()) == 1,
                      f"{mode}: a clean single capture must launch K11 once and nothing else: {counts}")
                out["wavs"][mode] = path
                if mode == "QPSK":
                    out["QPSK single"] = counts
            say(f"[5g {mode}] +{offset:g} Hz: {time.perf_counter() - t0:.1f} s | {card}")

    path = os.path.join(work, "noise.wav")
    write_wav(path, np.clip(rng.normal(0.0, 0.3, n), -1, 1).astype(np.float32))
    saved, counts, reads, wall = _decode_wav(device, path, "QPSK", BAUD, work, "noise")
    say(f"[5g noise] decode_wav_file QPSK on a noise-only WAV: wall {wall:.3f} s, saved {len(saved)}, "
        f"launches={counts}, ladder host reads {reads} | {card}")
    check(saved == [], "a noise-only WAV saved files")

    t0 = time.perf_counter()
    text = b"PSK31 single-capture smoke"
    framed = pack_frame("psk31.txt", text, 0, 1, len(text), crc32(text))
    wave = modulate("PSK31", framed, 31)
    path = os.path.join(work, "psk31.wav")
    write_wav(path, np.concatenate([np.zeros(4000, np.float32), wave, np.zeros(4000, np.float32)]))
    saved, counts, reads, wall = _decode_wav(device, path, "PSK31", 31, work, "psk31")
    say(f"[5g PSK31] decode_wav_file, {len(wave) / SR:.1f} s: wall {wall:.3f} s, saved {len(saved)}, "
        f"launches={counts}, ladder host reads {reads} | {card}")
    check(len(saved) == 1 and open(saved[0], "rb").read() == text, "PSK31: the saved file differs")
    check(sum(counts.values()) == 0, f"PSK31 (3072 samples per symbol) launched a kernel: {counts}")

    payloads, rows = [], []
    for i in range(8):
        p = _payload(900 + i, 16)
        w = modulate("QPSK", pack_frame(f"s{i}", p, 0, 1, len(p), crc32(p)), BAUD)
        rows.append(np.pad(w, (3 * i, 2550 - 3 * i - len(w))))
        payloads.append(p)
    tk.reset_launch_counts()
    raws = decode_sample_batch(np.stack(rows).astype(np.float32), "QPSK", BAUD, device=device)
    counts = tk.launch_counts()
    say(f"[5g short] decode_sample_batch of 8 QPSK captures of 2550 samples (255 symbols): "
        f"launches={counts} | {card}")
    check([[f.data for f in parse_frames(r)] for r in raws] == [[p] for p in payloads],
          "short captures: decoded frames differ")
    check(counts["psk_project_diff"] == 8 and sum(counts.values()) == 8,
          f"short captures must launch K11 once per capture: {counts}")
    say(f"[5g] PSK31 and short captures: {time.perf_counter() - t0:.1f} s | {card}")
    return out


def phase_single_timing(device, n_cap: int, n: int, payload_bytes: int, wavs: dict, work: str, card: str):
    """K11 and K12 beside their plain versions, and each mode's
    decode_wav_file; returns ({entry: (ms, plain_ms, plain_captures)},
    {entry: (bound_ms, bound_by)}, {mode: (wall s median of 3, device ms)}).
    Operations per symbol, from the kernel's code: 8*spsym (two
    2*spsym-tap correlations) + 6 (the differential)."""
    import torch
    import torch.nn.functional as F

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.psk import _batch_pass1, _device_tables

    t, bounds, decodes = {}, {}, {}
    carrier = _SLICES["8PSK"]["carrier"]
    wave = _wave(_payload(0, payload_bytes), "bench.bin", "8PSK")
    one = _rows(_tiled(wave, n)[None], "int16", device, "8PSK")
    x = one.expand(n_cap, -1, -1).contiguous()  # the bench batch, shipped once
    del one
    b, r, row = x.shape
    _, _, best, _ = _batch_pass1(None, x, b, r * 128, SPSYM, carrier, SR, 8, r, n_psk=8)
    W8, _, _ = _device_tables(SPSYM, carrier, SR, 8, device)
    n_sym = b * r * 128
    bounds["psk_project_diff_batch"] = _bound(x.numel() * x.element_size() + n_sym * 8, n_sym * (8 * SPSYM + 6))
    t["psk_project_diff_batch"] = (
        _time_ms(lambda: tk.psk_project_diff_batch(x, W8, best, rows_per_capture=r)),
        _time_ms(lambda: tk.psk_project_diff_batch_plain(x, W8, best)), b)
    del x
    torch.cuda.empty_cache()
    flat = torch.from_numpy(_tiled(wave, n)).to(device)
    r64 = _k11_rows(n)
    x2d = F.pad(flat, (0, r64 * row - n)).reshape(r64, row)
    w = W8[best[0]]
    bounds["psk_project_diff"] = _bound(x2d.numel() * 4 + r64 * 128 * 8, r64 * 128 * (8 * SPSYM + 6))
    t["psk_project_diff"] = (_time_ms(lambda: tk.psk_project_diff(x2d, w, block_rows=64)),
                             _time_ms(lambda: tk.psk_project_diff_plain(x2d, w)), 1)
    del flat, x2d
    for name in ("psk_project_diff_batch", "psk_project_diff"):
        ms, plain, pc = t[name]
        say(f"[6 time] {name} ({pc} x {n} samples): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms by {bounds[name][1]} | {card}")

    for mode, path in wavs.items():
        decodes[mode] = _profile_decode(device, path, mode, BAUD, work, mode, card)
    return t, bounds, decodes


def _profile_decode(device, path: str, mode: str, rate: int, work: str, label: str, card: str, **options):
    """``decode_wav_file`` of one WAV by the host clock (median of 3) and
    once under ``torch.profiler`` (device kernel time, the six largest
    kernels printed): (wall s, device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = [_decode_wav(device, path, mode, rate, work, f"t{label}{i}", **options)[3] for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _decode_wav(device, path, mode, rate, work, f"p{label}", **options)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() / 1e3
            ms_n[1] += 1
    dev_ms = sum(ms for ms, _ in by_name.values())
    wall = statistics.median(walls)
    say(f"[6 time] decode_wav_file {label} 2^24 samples{' ' + str(options) if options else ''}: wall median of 3 "
        f"{wall:.3f} s ({', '.join(f'{v:.3f}' for v in walls)}); device kernel time under the profiler "
        f"{dev_ms:.3f} ms in {sum(c for _, c in by_name.values())} kernels, host and copies the rest | {card}")
    for name, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        say(f"[6 time]   {ms:9.4f} ms x{c:<5d} {name[:100]}")
    return wall, dev_ms


# --- NEURAL: K10, the batched slices, the single-capture decodes --------------------

def phase_neural_kernel(device, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """K10 vs plain on ``n_cap`` x 2^24-sample NEURAL@9600 captures (tiled
    waves, capture 1 sign-flipped) synced by the port's ``td_sync_batch``, in
    float32 and int16 rows: symbols equal on the clean captures, at most
    1e-4 of them different on a capture with AWGN at 6 dB SNR, and all zeros
    on an all-zero capture. Returns {entry: (max abs symbol error, None)}."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.neural import _codebook, td_sync_batch

    t0 = time.perf_counter()
    clean = np.stack([_tiled(_mode_wave(_payload(800 + i, payload_bytes), f"k10_{i}.bin", "NEURAL", BAUD), n,
                             lead=5 * i + 3) for i in range(n_cap)])
    clean[1] *= -1.0
    cases = (("clean", clean), ("awgn6dB", _awgn(clean[:1], 6.0, device)), ("zero", np.zeros((1, n), np.float32)))
    cb = torch.from_numpy(_codebook()).to(device)
    r3 = n // 128
    worst = 0
    for dtype in ("f32", "int16"):
        for tag, data in cases:
            x = torch.from_numpy(data).to(device)
            if dtype == "int16":
                x = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16)
            k0, pr, pi = td_sync_batch(x, 2)
            b = x.shape[0]
            x2d = x.reshape(b * r3, 128)
            ph = torch.stack([pr, pi], dim=1).contiguous()
            s = (k0 % 128).to(torch.int32)
            got = tk.neural_extract_batch(x2d, cb, ph, s, rows_per_capture=r3)
            ref = tk.neural_extract_batch_plain(x2d, cb, ph, s, r3)
            torch.cuda.synchronize()
            n_bad, n_all = int((got != ref).sum()), got.numel()
            say(f"[3d K10] {tag} {dtype} rows ({b * r3}, 128): k0={k0.tolist()[:4]} mismatches={n_bad} of "
                f"{n_all} ({n_bad / n_all:.3e}) | {card}")
            if tag == "clean":
                check(n_bad == 0, f"K10 differs from plain on clean {dtype} captures")
                worst = max(worst, int((got.int() - ref.int()).abs().max()))
            elif tag == "zero":
                check(not got.any() and not ref.any(), f"K10 or plain decoded nonzero symbols from zeros ({dtype})")
            else:
                check(n_bad / n_all <= 1e-4, f"K10 mismatch fraction {n_bad / n_all} > 1e-4 at 6 dB")
            del x, x2d, got, ref
    torch.cuda.empty_cache()
    say(f"[3d K10] {time.perf_counter() - t0:.1f} s | {card}")
    return {"neural_extract_batch": (float(worst), None)}


def phase_neural_slice(device, rate: int, n_cap: int, n: int, payload_bytes: int, tag: str, card: str) -> dict:
    """A NEURAL slice at real size: one seeded payload per capture, its
    framed wave tiled with a random lead of 0-1280 samples, capture 1
    sign-flipped, the last one pure noise (so the batch escalates to the
    full-lag search), through ``decode_sample_batch`` and ``parse_frames``.
    At 9600 Bd K10 launches once and nothing else, at 3000 Bd (chip length
    4) nothing; the peak device memory stays under 40 GB. At 9600 Bd also
    ``decode_wav_batch`` on 2 WAVs written by the port. Returns the launch
    counts of the ``decode_sample_batch`` run."""
    import torch

    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops import neural as tn
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    label = f"NEURAL@{rate}"
    rng = np.random.default_rng(2026)
    t_phase = t0 = time.perf_counter()
    batch = np.empty((n_cap, n), np.float32)
    payloads, min_frames = [], []
    noise_i = n_cap - 1
    for i in range(n_cap):
        if i == noise_i:
            batch[i] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
            payloads.append(None)
            min_frames.append(0)
            continue
        p = _payload(7000 + i, payload_bytes)
        wave = _mode_wave(p, f"cap{i}.bin", "NEURAL", rate)
        batch[i] = _tiled(wave, n, lead=int(rng.integers(0, 1281))) * (-1.0 if i == 1 else 1.0)
        payloads.append(p)
        min_frames.append(max(1, n // len(wave) - 1))
    say(f"[{tag} {label}] built {n_cap} x {n} captures (capture 1 sign-flipped, capture {noise_i} noise) in "
        f"{time.perf_counter() - t0:.1f} s | {card}")

    searched = []  # the lag rows of each matched-filter search
    real_peaks = tn._peaks
    tn._peaks = lambda x, c, rows, rho: searched.append(rows) or real_peaks(x, c, rows, rho)
    try:
        tk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        raws = decode_sample_batch(batch, "NEURAL", rate, device=device)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        tn._peaks = real_peaks
    counts = tk.launch_counts()
    say(f"[{tag} {label}] decode_sample_batch wall {wall:.3f} s (copy, sync, extraction, copy back) "
        f"launches={counts}; matched-filter rows searched {searched}; peak device memory "
        f"{peak / 1e9:.3f} GB | {card}")
    want = ("neural_extract_batch",) if tn._chip_len(rate) == 2 else ()
    _check_launches(counts, want, label, "decode_sample_batch")
    check(sum(counts.values()) == len(want), f"{label}: a kernel launched more than once: {counts}")
    check(searched[-1] == -(-n // 128), f"{label}: the noise capture did not escalate the batch to the full search")
    check(peak < 40e9, f"{label}: peak device memory {peak / 1e9:.1f} GB is not under 40 GB")
    _check_frames(label, raws, payloads, min_frames, tag, card, "decode_sample_batch")
    del batch, raws
    torch.cuda.empty_cache()
    if want:
        _wav_roundtrip(device, "NEURAL", payload_bytes, tag, rate, n_wavs=2)
    say(f"[{tag} {label}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def phase_neural_single(device, n: int, work: str, card: str) -> str:
    """``decode_wav_file(device)`` of a NEURAL@9600 (time domain) and a
    NEURAL@1200 (FFT matched filter) 2^24-sample WAV, each carrying the
    128 KiB file in 8 parts: the reassembled file equals the sent one and
    no kernel launches. Returns the 9600 Bd WAV's path."""
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(78)
    out = None
    for rate, seed in ((BAUD, 50), (1200, 51)):
        t0 = time.perf_counter()
        data, wave = _multipart_transmission("NEURAL", seed, rate=rate)
        x = np.zeros(n, np.float32)
        lead = int(rng.integers(0, 96000))
        check(lead + len(wave) <= n, f"NEURAL@{rate}: the 8-part transmission does not fit 2^24 samples")
        x[lead : lead + len(wave)] = wave
        path = os.path.join(work, f"NEURAL_{rate}.wav")
        write_wav(path, x)
        saved, counts, _reads, wall = _decode_wav(device, path, "NEURAL", rate, work, f"NEURAL{rate}")
        say(f"[5k NEURAL@{rate}] decode_wav_file, {len(wave) / SR:.1f} s of signal in {n / SR:.1f} s: wall "
            f"{wall:.3f} s, saved {len(saved)}, launches={counts} | {card}")
        check(len(saved) == 1, f"NEURAL@{rate}: {len(saved)} files saved")
        with open(saved[0], "rb") as f:
            check(f.read() == data, f"NEURAL@{rate}: the reassembled file differs")
        check(sum(counts.values()) == 0, f"NEURAL@{rate}: the single-capture decode launched a kernel: {counts}")
        if rate == BAUD:
            out = path
        say(f"[5k NEURAL@{rate}] {time.perf_counter() - t0:.1f} s | {card}")
    return out


def phase_neural_timing(device, n_cap: int, n: int, payload_bytes: int, card: str):
    """``demod_pack_batch`` NEURAL on the 64 x 2^24 float32 bench batch
    staged on the card (the prefix branch), again with its last capture
    pure noise (the full search), and K10 beside its bound and its plain
    version at 8 captures (the plain scores of 64 captures would take 69
    GB). Returns ({entry: (ms, plain_ms, plain_captures)}, {label:
    Msamples/s}, {entry: (bound_ms, bound_by)})."""
    import torch

    from audio_modem_radio_tpu_torch.framing import parse_frames
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.neural import _codebook, td_sync_batch
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    t0 = time.perf_counter()
    wave = _mode_wave(_payload(0, payload_bytes), "bench.bin", "NEURAL", BAUD)
    one = torch.from_numpy(_tiled(wave, n)[None]).to(device)
    x = one.expand(n_cap, -1).contiguous()  # ship once, tile on the card
    del one
    packed, n_valid, _ = demod_pack_batch(x, "NEURAL", BAUD)
    check(len(parse_frames(packed[0, : int(n_valid[0])].cpu().numpy().tobytes())) >= n // len(wave) - 1,
          "NEURAL bench batch: capture 0 lost frames")
    del packed
    msps = {}
    for label in ("prefix", "full search"):
        if label == "full search":
            gen = torch.Generator(device=device).manual_seed(99)
            x[-1] = torch.clamp(torch.randn(n, generator=gen, device=device) * 0.3, -1.0, 1.0)
        ms = _time_ms(lambda: demod_pack_batch(x, "NEURAL", BAUD))
        msps[label] = n_cap * n / (ms * 1e-3) / 1e6
        say(f"[6 time] demod_pack_batch NEURAL {n_cap} x {n} float32, {label}: {ms:.3f} ms = "
            f"{msps[label]:.2f} Msamples/s | {card}")
    x[-1] = x[0]
    k0, pr, pi = td_sync_batch(x, 2)
    r3 = n // 128
    x2d = x.reshape(n_cap * r3, 128)
    cb = torch.from_numpy(_codebook()).to(device)
    ph = torch.stack([pr, pi], dim=1).contiguous()
    s = (k0 % 128).to(torch.int32)
    n_sym = n_cap * r3 * 8
    bounds = {"neural_extract_batch": _bound(x2d.numel() * 4 + n_sym + cb.numel() * 4 + n_cap * 12,
                                             n_sym * _K10_OPS)}
    pc = min(8, n_cap)
    xp = x2d[: pc * r3]
    t = {"neural_extract_batch": (
        _time_ms(lambda: tk.neural_extract_batch(x2d, cb, ph, s, rows_per_capture=r3)),
        _time_ms(lambda: tk.neural_extract_batch_plain(xp, cb, ph[:pc], s[:pc], r3)), pc)}
    ms, plain, _ = t["neural_extract_batch"]
    say(f"[6 time] neural_extract_batch B={n_cap}: kernel {ms:.4f} ms, plain {plain:.4f} ms (plain at {pc} "
        f"captures), bound {bounds['neural_extract_batch'][0]:.4f} ms by {bounds['neural_extract_batch'][1]} | {card}")
    del x, x2d, xp
    torch.cuda.empty_cache()
    say(f"[6 time] NEURAL: {time.perf_counter() - t0:.1f} s | {card}")
    return t, msps, bounds


# --- the single-capture FSK receive: the MLSE Viterbi and decode_wav_file -----------

def _calls(module, name: str, fn):
    """Run ``fn()``; return its result and the arguments of every call of
    ``module.name`` in it (the main path's inputs to a kernel wrapper)."""
    calls, real = [], getattr(module, name)

    def record(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, record)
    try:
        out = fn()
    finally:
        setattr(module, name, real)
    return out, calls


def _viterbi_calls(fn):
    """``_calls`` of ``mlse_viterbi_blocks`` as the FSK receiver calls it."""
    from audio_modem_radio_tpu_torch.ops import fsk as tf

    return _calls(tf, "mlse_viterbi_blocks", fn)


def phase_viterbi_kernel(device, n: int, card: str):
    """The Viterbi kernel vs its plain version on the blocks
    ``fsk_demod_bits`` gives it for one 2^n-sample capture of random bytes
    at 9600 Bd, clean and at 15 dB AWGN, on three trellises. Returns
    ((the most bit mismatches of any call, None), the clean 48-state call's
    arguments)."""
    import torch

    from audio_modem_radio_tpu_torch.ops import fsk as tf
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    keep, worst = None, 0
    for label, (mark, space) in _TRELLISES.items():
        t0 = time.perf_counter()
        clean = _tiled(tf.fsk_modulate(_payload(500, 200_000), BAUD, mark, space, SR), n, lead=211)
        for tag, x in (("clean", clean), ("awgn15dB", _awgn(clean, 15.0, device))):
            xt = torch.from_numpy(x).to(device)
            _, calls = _viterbi_calls(lambda: tf.fsk_demod_bits(xt, float(BAUD), mark, space, SR))
            check(len(calls) == 1, f"{label} {tag}: {len(calls)} Viterbi calls, not 1")
            args = calls[0]
            got = tk.mlse_viterbi_blocks(*args)
            ref = tk.mlse_viterbi_blocks_plain(*args)
            torch.cuda.synchronize()
            n_bad = int((got != ref).sum())
            worst = max(worst, n_bad)
            say(f"[3e Viterbi] {label} ({mark:g}/{space:g} Hz) {tag}: {args[0].shape[0]} blocks x "
                f"{args[0].shape[2]} steps, {args[1].shape[0]} states, advances {args[4]}/{args[5]}: "
                f"bit mismatches {n_bad} of {got.numel()} | {card}")
            check(n_bad == 0, f"the Viterbi kernel differs from plain on {label} {tag}")
            if label == "48 states" and tag == "clean":
                keep = args
            del xt, got, ref
        say(f"[3e Viterbi] {label}: {time.perf_counter() - t0:.1f} s | {card}")
    return (float(worst), None), keep


def _fsk_transmission(mode: str, rate: int, seed: int, n: int, lead: int):
    """(file, wave) of the largest random file in 16 KiB parts, up to 128
    KiB, whose multi-part transmission fits ``n - lead`` samples (FT8: one
    512-byte part), each part compressed on its own and framed as the JAX
    ``encoder.py`` frames a multi-part file."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.utils.compression import adaptive_compress

    sizes = [(1, 512)] if mode == "FT8" else [(k, _FILE_BYTES // _N_PARTS) for k in range(_N_PARTS, 0, -1)]
    for n_parts, part in sizes:
        data = _payload(seed, n_parts * part)
        framed = b"".join(
            pack_frame(f"{mode.lower()}{seed}.bin.part{i + 1}", adaptive_compress(data[i * part : (i + 1) * part], mode),
                       i, n_parts, len(data), crc32(data))
            for i in range(n_parts)
        )
        wave = modulate(mode, framed, rate)
        if lead + len(wave) <= n:
            return data, wave
    raise PhaseError(f"{mode}: no file fits {n} samples")


def phase_fsk_single(device, n: int, work: str, card: str):
    """Phase 5l; returns ({mode: WAV path} for phase 6, the launch counts of
    the FSK9600 decode, the arguments of the ``batch_mlse`` batch's Viterbi
    launch)."""
    import torch

    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.config import CONFIG
    from audio_modem_radio_tpu_torch.decoder import decode_from_buffer
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch, decode_wav_batch
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(79)
    wavs, fsk9600 = {}, None
    for k, (mode, rate) in enumerate(_FSK_SINGLE.items()):
        t0 = time.perf_counter()
        lead = int(rng.integers(0, 96000))
        data, wave = _fsk_transmission(mode, rate, 60 + k, n, lead)
        x = np.zeros(n, np.float32)
        x[lead : lead + len(wave)] = wave
        path = os.path.join(work, f"{mode}_single.wav")
        write_wav(path, x)
        saved, counts, _reads, wall = _decode_wav(device, path, mode, rate, work, f"{mode}single")
        say(f"[5l {mode}@{rate}] decode_wav_file, a {len(data)}-byte file, {len(wave) / SR:.1f} s of signal in "
            f"{n / SR:.1f} s: wall {wall:.3f} s, saved {len(saved)}, launches={counts} | {card}")
        check(len(saved) == 1, f"{mode}: {len(saved)} files saved")
        with open(saved[0], "rb") as f:
            check(f.read() == data, f"{mode}: the reassembled file differs")
        want = _FSK_SINGLE_KERNEL.get(mode)
        check({k: v for k, v in counts.items() if v} == ({want: 1} if want else {}),
              f"{mode}: the single capture must launch {want or 'no kernel'} once and nothing else: {counts}")
        if mode == "FSK9600":
            fsk9600 = counts
        wavs[mode] = path
        say(f"[5l {mode}] {time.perf_counter() - t0:.1f} s | {card}")

    # Dual tones under CONFIG tpu.demod_backend = "xla": the JAX package's
    # XLA layout (unpadded float32 rows), still through K7.
    t0 = time.perf_counter()
    data = _payload(62, 1500)
    wave = _mode_wave(data, "xla.bin", "FSK1200", 1200)
    batch = np.zeros((2, n), np.float32)
    for i in range(2):
        batch[i, 333 * i : 333 * i + len(wave)] = wave
    CONFIG.set("tpu.demod_backend", "xla")
    try:
        tk.reset_launch_counts()
        raws = decode_sample_batch(batch, "FSK1200", 1200, device=device)
        counts = tk.launch_counts()
    finally:
        CONFIG.set("tpu.demod_backend", "auto")
    say(f"[5l xla] decode_sample_batch of 2 x {n} FSK1200 captures under tpu.demod_backend=xla: "
        f"{time.perf_counter() - t0:.1f} s, launches={counts} | {card}")
    check([[f.data for f in parse_frames(r)] for r in raws] == [[data]] * 2, "FSK1200 under xla lost a frame")
    check({k: v for k, v in counts.items() if v} == {"fsk_tile_bits_batch": 1},
          f"FSK1200 under xla must launch K7 once and nothing else: {counts}")

    path = os.path.join(work, "fsk_noise.wav")
    write_wav(path, np.clip(rng.normal(0.0, 0.3, n), -1, 1).astype(np.float32))
    saved, counts, _reads, wall = _decode_wav(device, path, "FSK9600", 9600, work, "fsknoise")
    say(f"[5l noise] decode_wav_file FSK9600 on a noise-only WAV: wall {wall:.3f} s, saved {len(saved)}, "
        f"launches={counts} | {card}")
    check(saved == [], "a noise-only FSK9600 WAV saved files")

    t0 = time.perf_counter()
    data = np.random.default_rng(5).integers(0, 256, 300, dtype=np.uint8).tobytes()
    wave = modulate("FSK9600", pack_frame("m.bin", data, 0, 1, len(data), crc32(data)), 9600)
    marginal = (wave + np.random.default_rng(2001).normal(0, 0.08, len(wave))).astype(np.float32)
    tk.reset_launch_counts()
    single = decode_from_buffer(marginal, "FSK9600", 9600, recv_dir=os.path.join(work, "recv_marginal"),
                                registry=AssemblyRegistry(journal_dir=""), device=device)
    check(len(single) == 1 and open(single[0], "rb").read() == data, "the marginal capture: single decode failed")
    raws = decode_sample_batch(marginal[None], "FSK9600", 9600, device=device, fsk_mlse=False)
    check(not parse_frames(raws[0]), "the marginal capture must defeat the equalizer-only batch")
    healthy = b"healthy capture " * 30
    paths = [os.path.join(work, "healthy.wav"), os.path.join(work, "marginal.wav")]
    write_wav(paths[0], modulate("FSK9600", pack_frame("ok.bin", healthy, 0, 1, len(healthy), crc32(healthy)), 9600))
    write_wav(paths[1], marginal)
    tk.reset_launch_counts()
    results = decode_wav_batch(paths, "FSK9600", 9600, recv_dir=os.path.join(work, "recv_escalation"),
                               registry=AssemblyRegistry(journal_dir=""), device=device)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    say(f"[5l escalation] decode_wav_batch of a healthy and the marginal FSK9600 WAV: saved "
        f"{[len(r) for r in results]}, launches={counts} | {card}")
    check([[open(q, "rb").read() for q in r] for r in results] == [[healthy], [data]],
          "decode_wav_batch did not save both captures")
    check(counts["mlse_viterbi_blocks"] == 1, f"the escalation must launch the Viterbi kernel once: {counts}")

    # One continuous-phase transmission of as many 16 KiB frames as fit: the
    # MLSE's trellis follows the phase across frames, so tiled copies of one
    # frame (a phase restart at every copy) would lose frames in both
    # packages.
    payload = _payload(61, 16384)
    n_frames = (n - 8 * 13) // len(_mode_wave(payload, "mlse.bin", "FSK9600", 9600))
    wave = modulate("FSK9600", b"".join(pack_frame(f"mlse{j}.bin", payload, 0, 1, len(payload), crc32(payload))
                                        for j in range(n_frames)), 9600)
    batch = np.zeros((8, n), np.float32)
    for i in range(8):
        batch[i, 13 * i : 13 * i + len(wave)] = wave
    CONFIG.set("modem.batch_mlse", True)
    try:
        tk.reset_launch_counts()
        t1 = time.perf_counter()
        raws, calls = _viterbi_calls(lambda: decode_sample_batch(batch, "FSK9600", 9600, device=device))
        wall = time.perf_counter() - t1
        counts = tk.launch_counts()
    finally:
        CONFIG.set("modem.batch_mlse", False)
    got = [[f.data for f in parse_frames(r)] for r in raws]
    say(f"[5l batch_mlse] decode_sample_batch of 8 x {n} FSK9600 captures under modem.batch_mlse: wall "
        f"{wall:.3f} s, frames per capture {[len(g) for g in got]} of {n_frames}, launches={counts} | {card}")
    check(got == [[payload] * n_frames] * 8, "modem.batch_mlse: a capture lost frames")
    check(counts["mlse_viterbi_blocks"] == 1 and sum(counts.values()) == 1,
          f"modem.batch_mlse must launch the Viterbi once for the batch: {counts}")
    say(f"[5l] marginal, escalation and batch_mlse: {time.perf_counter() - t0:.1f} s | {card}")
    return wavs, fsk9600, calls[0]


def _viterbi_bound(args):
    """(ms, by) of one Viterbi call: each input read once, the bits written
    once, _VITERBI_OPS a state and step."""
    x, S = args[0], args[1].shape[0]
    nb, _, L = x.shape
    return _bound((x.numel() + 2 * S + args[3].numel()) * 4 + nb * L, nb * L * S * _VITERBI_OPS)


def phase_viterbi_timing(args, batch_args, card: str):
    """The Viterbi kernel on the FSK9600 capture's blocks (median of 5 by
    CUDA events) and its plain version (one run), and the kernel on the
    ``batch_mlse`` batch's one launch; each beside its bound by bytes and
    operations, its cycles a step at the SM clock ``nvidia-smi`` reads while
    it runs, and the bound by the chain: L forward steps and L / 32
    traceback steps (phase A: the lanes walk their stages side by side; the
    data-dependent merge walk of phase B left out) at the cycles of their
    dependent chains, read from the kernel's SASS
    (``sass_stats.chain_cycles``, each instruction at its latency measured
    on this card by ``csrc/probe/latency.cu``). Returns ({entry:
    (ms, plain_ms, 1)}, {entry: (bound_ms, bound_by)})."""
    import torch

    from audio_modem_radio_tpu_torch import sass_stats
    from audio_modem_radio_tpu_torch.kernel_variants import clock_samples
    from audio_modem_radio_tpu_torch.ops import _build
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    x = args[0]
    nb, _, L = x.shape
    S = args[1].shape[0]
    ms = _time_ms(lambda: tk.mlse_viterbi_blocks(*args))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    tk.mlse_viterbi_blocks_plain(*args)
    b.record()
    torch.cuda.synchronize()
    plain = a.elapsed_time(b)
    bound = _viterbi_bound(args)
    lat = sass_stats.probe_latencies()
    instance = f"mlse_viterbi_kernelILi{-(-S // 32)}E"
    fwd, fwd_path, back, back_path = sass_stats.chain_cycles(
        sass_stats.library_sass(_build.library_path()), lat, instance)
    say(f"[6 chain] latencies on this card (SM cycles): "
        f"{', '.join(f'{op} {c:.2f}' for op, c in lat.items())} | {card}")
    say(f"[6 chain] {instance}: forward step {fwd:.1f} cycles ({' -> '.join(fwd_path)}); traceback step "
        f"{back:.1f} cycles ({' -> '.join(back_path)}) | {card}")
    nb_batch = batch_args[0].shape[0]
    ms_batch = _time_ms(lambda: tk.mlse_viterbi_blocks(*batch_args))
    bound_batch = _viterbi_bound(batch_args)
    for label, t, bd, call_args in ((f"{nb} blocks", ms, bound, args),
                                    (f"the modem.batch_mlse batch's one launch, {nb_batch} blocks", ms_batch,
                                     bound_batch, batch_args)):
        mhz, watts, n_reads = clock_samples(lambda: tk.mlse_viterbi_blocks(*call_args))
        check(n_reads > 0, "nvidia-smi read no SM clock")
        chain_ms = (L * fwd + -(-L // 32) * back) / (mhz * 1e3)
        say(f"[6 time] mlse_viterbi_blocks ({label} x {L} steps, {S} states): kernel {t:.4f} ms, "
            f"{t * mhz * 1e3 / L:.1f} cycles a step at SM {mhz:.0f} MHz ({watts:.1f} W); bound {bd[0]:.4f} ms by "
            f"{bd[1]}, {chain_ms:.4f} ms by the chain ({L} x {fwd:.1f} + {-(-L // 32)} x {back:.1f} cycles)"
            + (f"; plain {plain:.4f} ms (one run)" if call_args is args else
               f"; {t * nb / nb_batch:.4f} ms per {nb} blocks") + f" | {card}")
    return {"mlse_viterbi_blocks": (ms, plain, 1)}, {"mlse_viterbi_blocks": bound}


# --- FEC: the convolutional code's Viterbi kernel and the encoder-to-decoder slice ---

def _fec_calls(fn):
    """``_calls`` of ``fec_viterbi_blocks`` as the port's ``fec`` module calls it."""
    from audio_modem_radio_tpu_torch import fec as tfec

    return _calls(tfec, "fec_viterbi_blocks", fn)


_STREAM_SIZES = {}  # (mode, rate, n) -> the file size _stream_fec_wav found


def _stream_fec_wav(mode: str, rate: int, n: int, work: str, seed: int):
    """(file, WAV path, framed bytes) of the largest random file that the
    port's ``encode_file`` (stream FEC, one WAV) fits into ``n`` samples;
    the framed bytes are the frame before its stream FEC."""
    from audio_modem_radio_tpu_torch.encoder import encode_file
    from audio_modem_radio_tpu_torch.fec import stream_fec_encode
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.utils.compression import intelligent_compress

    name = f"{mode.lower()}_stream{seed}.bin"

    def framed_wave(size: int):
        data = _payload(seed, size)
        framed = pack_frame(name, intelligent_compress(data), 0, 1, len(data), crc32(data))
        return data, framed, len(modulate(mode, stream_fec_encode(framed), rate))

    size = _STREAM_SIZES.get((mode, rate, n))
    if size is None:
        size = n // 200
        _, _, length = framed_wave(size)
        per_byte = SR * 16 // (rate * (2 if mode == "QPSK" else 1))  # samples a coded data byte
        size += (n - length) // per_byte
    data, framed, length = framed_wave(size)
    while length > n:
        size -= 1
        data, framed, length = framed_wave(size)
    _STREAM_SIZES[(mode, rate, n)] = size
    src = os.path.join(work, name)
    with open(src, "wb") as f:
        f.write(data)
    path = encode_file(src, mode, True, rate, split_large_files=False, cache_dir=os.path.join(work, "cache"),
                       use_fec=True, fec_type="stream")
    return data, path, framed


def _noisy(samples: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    """``samples`` plus white Gaussian noise at ``snr_db`` over their power
    (full band, unclipped)."""
    p = float(np.mean(samples.astype(np.float64) ** 2))
    noise = np.random.default_rng(seed).normal(0.0, (p / 10 ** (snr_db / 10)) ** 0.5, len(samples))
    return (samples + noise).astype(np.float32)


def _bit_errors(out: bytes, framed: bytes) -> int:
    """Bits of ``framed`` that ``out`` (a decoded stream) gets wrong, a
    missing tail counted wrong."""
    want = np.unpackbits(np.frombuffer(framed, np.uint8))
    got = np.unpackbits(np.frombuffer(out[: len(framed)], np.uint8))
    return int((got != want[: len(got)]).sum()) + len(want) - len(got)


def phase_fec_kernel(device, n: int, work: str, card: str):
    """Phase 3f: the Viterbi kernel vs its plain version on the blocks the
    port's stream-FEC decode gives it for the largest file that fits one
    2^n-sample QPSK@9600 WAV (hard bits from ``demodulate``, and soft values
    of the same WAV at -2 dB full-band SNR through the soft escalation), on
    one short block with known boundaries (a 1 KiB FECV container) and on
    all-0.5 input. Returns ((the most bit mismatches of any call, None), the
    clean call's and the container call's arguments, the inputs of phase
    5m)."""
    import torch

    from audio_modem_radio_tpu_torch import fec as tfec
    from audio_modem_radio_tpu_torch.decoder import _stream_fec_soft, pad_to_bucket
    from audio_modem_radio_tpu_torch.modem import demodulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.utils.wavio import read_wav

    t0 = time.perf_counter()
    data, path, framed = _stream_fec_wav("QPSK", BAUD, n, work, 81)
    samples, _ = read_wav(path)
    say(f"[3f FEC Viterbi] encode_file of a {len(data)}-byte file, stream FEC, QPSK@{BAUD}: {len(samples)} "
        f"samples, {time.perf_counter() - t0:.1f} s | {card}")
    raw = demodulate("QPSK", pad_to_bucket(samples), BAUD, device=device)
    out, hard = _fec_calls(lambda: tfec.stream_fec_decode(raw, device=device))
    check(out[: len(framed)] == framed, "the clean stream-FEC capture did not decode to its frame")
    noisy = _noisy(samples, -2.0, 82)
    _, soft = _fec_calls(lambda: _stream_fec_soft(noisy, "QPSK", BAUD, device))
    blob = tfec.wrap_fec(_payload(83, 1024), "convolutional")
    _, short = _fec_calls(lambda: tfec.ViterbiDecoder(device=device).decode(blob[4:]))
    half = torch.full((205, 9216, 2), 0.5, dtype=torch.float32, device=device)
    cases = (("clean capture, hard bits", hard[0]), ("-2 dB soft values", soft[0]),
             ("a 1 KiB FECV container", short[0]), ("all 0.5, free boundaries", (half, False)),
             ("all 0.5, known boundaries", (half[:1], True)))
    worst = 0
    for label, args in cases:
        got = tk.fec_viterbi_blocks(*args)
        ref = tk.fec_viterbi_blocks_plain(*args)
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        say(f"[3f FEC Viterbi] {label}: {args[0].shape[0]} blocks x {args[0].shape[1]} steps, known boundaries "
            f"{args[1]}: bit mismatches {n_bad} of {got.numel()} | {card}")
        worst = max(worst, n_bad)
        check(n_bad == 0, f"the FEC Viterbi kernel differs from plain on {label}")
    n_pairs = 8 * (len(raw) - 4) // 2  # the coded stream after its plaintext sync
    check(tuple(hard[0][0].shape) == (-(-n_pairs // 8192), 9216, 2),
          f"{n_pairs} pairs gave blocks of {tuple(hard[0][0].shape)}")
    say(f"[3f FEC Viterbi] {time.perf_counter() - t0:.1f} s | {card}")
    return (float(worst), None), (hard[0], short[0]), (data, path, framed, samples, noisy)


def _concat_wavs(paths, out: str) -> None:
    """One capture of several WAVs back to back, 1,000 zero samples between."""
    from audio_modem_radio_tpu_torch.utils.wavio import read_wav, write_wav

    gap = np.zeros(1000, np.float32)
    write_wav(out, np.concatenate([np.concatenate([read_wav(p)[0], gap]) for p in paths]))


def _parts(name: str, data: bytes, part: int):
    """The encoder's FilePart tuples of ``data`` in parts of ``part`` bytes."""
    from audio_modem_radio_tpu_torch.framing import crc32

    total = -(-len(data) // part)
    return [(f"{name}.part{i + 1}", data[i * part : (i + 1) * part], i, total, len(data), crc32(data))
            for i in range(total)]


def phase_fec_single(device, n: int, work: str, fec_in, card: str) -> dict:
    """Phase 5m: the encoder-to-decoder slice on the card, through the
    port's own encoder; every check is byte-equality with the source file.
    Returns {"QPSK stream": the launch counts of the stream-FEC decode,
    "wav": its WAV path, "FSK9600 stream": the FSK9600 WAV path}."""
    import torch

    from audio_modem_radio_tpu_torch import native
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.decoder import _stream_fec_soft, decode_from_buffer, pad_to_bucket
    from audio_modem_radio_tpu_torch.encoder import encode_file, encode_file_parts
    from audio_modem_radio_tpu_torch.fec import stream_fec_decode
    from audio_modem_radio_tpu_torch.modem import demodulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_wav_batch
    from audio_modem_radio_tpu_torch.utils.wavio import read_wav, write_wav

    def same(saved, data) -> bool:
        return len(saved) == 1 and open(saved[0], "rb").read() == data

    out = {}
    data, path, framed, samples, noisy = fec_in
    say(f"[5m native] the port's native library built: {native.NATIVE_AVAILABLE}"
        + ("" if native.NATIVE_AVAILABLE else "; the long-span Viterbi route is the card kernel") + f" | {card}")
    saved, counts, _reads, wall = _decode_wav(device, path, "QPSK", BAUD, work, "fecstream", stream_fec=True)
    say(f"[5m stream] decode_wav_file(stream_fec=True) of the {len(data)}-byte file's QPSK@{BAUD} WAV: wall "
        f"{wall:.3f} s, saved {len(saved)}, launches={counts} | {card}")
    check(same(saved, data), "stream FEC: the saved file differs")
    check(counts["fec_viterbi_blocks"] in (1, 2) and counts["psk_project_diff"] >= 1
          and sum(counts.values()) == counts["fec_viterbi_blocks"] + counts["psk_project_diff"],
          f"the stream-FEC decode must launch the Viterbi once or twice, K11 and nothing else: {counts}")
    out["QPSK stream"], out["wav"] = counts, path

    t0 = time.perf_counter()
    tk.reset_launch_counts()
    saved = decode_from_buffer(noisy, "QPSK", BAUD, recv_dir=os.path.join(work, "recv_fec_noisy"),
                               registry=AssemblyRegistry(journal_dir=""), stream_fec=True, device=device)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    hard = _bit_errors(stream_fec_decode(demodulate("QPSK", pad_to_bucket(noisy), BAUD, device=device),
                                         device=device), framed)
    soft = _bit_errors(_stream_fec_soft(noisy, "QPSK", BAUD, device) or b"", framed)
    say(f"[5m -2 dB] decode_from_buffer(stream_fec=True) of the same WAV at -2 dB full-band SNR: saved "
        f"{len(saved)}, launches={counts}; frame bits wrong after the hard decode {hard}, after the soft "
        f"{soft} of {8 * len(framed)} ({time.perf_counter() - t0:.1f} s) | {card}")
    check(saved == [] or same(saved, data), "-2 dB: a saved file differs")
    check(counts["fec_viterbi_blocks"] >= 3, f"-2 dB: the soft escalation did not run: {counts}")
    check(soft < hard, "-2 dB: the soft decode is no better than the hard one")

    t0 = time.perf_counter()
    small = _payload(41, 1200)
    src = os.path.join(work, "s4800.bin")
    with open(src, "wb") as f:
        f.write(small)
    wav = encode_file(src, "QPSK", True, 4800, cache_dir=os.path.join(work, "cache"), use_fec=True,
                      fec_type="stream")
    x, _ = read_wav(wav)
    tk.reset_launch_counts()
    saved = decode_from_buffer(_noisy(x, -2.0, 26), "QPSK", 4800, recv_dir=os.path.join(work, "recv_4800"),
                               registry=AssemblyRegistry(journal_dir=""), stream_fec=True, device=device)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    say(f"[5m -2 dB] a 1,200-byte file, stream FEC at QPSK@4800, -2 dB (the noise draw where the JAX "
        f"package's soft escalation recovers it on the CPU): saved {len(saved)}, launches={counts} "
        f"({time.perf_counter() - t0:.1f} s) | {card}")
    check(same(saved, small), "-2 dB at 4800 Bd: the soft escalation did not recover the file")

    t0 = time.perf_counter()
    batch_paths, batch_data = [], []
    for i in range(8):
        d, p, _ = _stream_fec_wav("QPSK", BAUD, n, work, 90 + i)
        batch_paths.append(p)
        batch_data.append(d)
    t1 = time.perf_counter()
    tk.reset_launch_counts()
    results = decode_wav_batch(batch_paths, "QPSK", BAUD, recv_dir=os.path.join(work, "recv_fec_batch"),
                               registry=AssemblyRegistry(journal_dir=""), device=device, stream_fec=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    say(f"[5m batch] decode_wav_batch(stream_fec=True) of 8 stream-FEC WAVs of up to {n} samples: wall "
        f"{time.perf_counter() - t1:.3f} s (encoding {t1 - t0:.1f} s), saved {[len(r) for r in results]}, "
        f"launches={counts} | {card}")
    check(all(same(r, d) for r, d in zip(results, batch_data)), "the stream-FEC batch: a saved file differs")
    check(counts["psk_project_decide_batch"] == 1 and counts["relabel_pack_batch"] == 1
          and counts["rotation_match_batch"] >= 1 and 8 <= counts["fec_viterbi_blocks"] <= 16,
          f"the stream-FEC batch must launch K1, K2, K3, then the Viterbi per capture: {counts}")
    for p in batch_paths:
        os.remove(p)

    # At 2^24 samples: 64 KiB in 64 parts, 128 KiB in 8 and 64 KiB in 4.
    cases = (("convolutional, 1 KiB parts", "convolutional", n // 256, 1024),
             ("convolutional, 16 KiB parts", "convolutional", n // 128, 16384),
             ("reed_solomon, 16 KiB parts", "reed_solomon", n // 256, 16384))
    for k, (label, ftype, size, part) in enumerate(cases):
        t0 = time.perf_counter()
        d = _payload(95 + k, size)
        wavs = encode_file_parts(_parts(f"fec{k}.bin", d, part), "QPSK", True, BAUD,
                                 cache_dir=os.path.join(work, f"cache_parts{k}"), use_fec=True, fec_type=ftype)
        one = os.path.join(work, f"fec_parts{k}.wav")
        _concat_wavs(wavs, one)
        saved, counts, _reads, wall = _decode_wav(device, one, "QPSK", BAUD, work, f"fecparts{k}")
        say(f"[5m payload] {label}: a {size}-byte file in {len(wavs)} WAVs, one capture, decode_wav_file: wall "
            f"{wall:.3f} s, saved {len(saved)}, launches={counts} ({time.perf_counter() - t0:.1f} s) | {card}")
        check(same(saved, d), f"{label}: the saved file differs")
        if part == 1024:
            check(counts["fec_viterbi_blocks"] == len(wavs),
                  f"{label}: each container (at most 9,216 pairs) must decode on the card: {counts}")
        elif ftype == "convolutional":
            want = 0 if native.viterbi_available() else len(wavs)
            check(counts["fec_viterbi_blocks"] == want, f"{label}: the long route launched {counts}")
        else:
            check(counts["fec_viterbi_blocks"] == 0, f"{label}: the parity code launched the Viterbi: {counts}")

    t0 = time.perf_counter()
    d, p, _ = _stream_fec_wav("FSK9600", 9600, n, work, 96)
    saved, counts, _reads, wall = _decode_wav(device, p, "FSK9600", 9600, work, "fskstream", stream_fec=True)
    say(f"[5m FSK9600] decode_wav_file(stream_fec=True) of a {len(d)}-byte file's FSK9600 WAV: wall {wall:.3f} s, "
        f"saved {len(saved)}, launches={counts} ({time.perf_counter() - t0:.1f} s) | {card}")
    check(same(saved, d), "FSK9600 stream FEC: the saved file differs")
    check(counts["mlse_viterbi_blocks"] == 1 and counts["fec_viterbi_blocks"] in (1, 2),
          f"FSK9600 stream FEC must launch the MLSE Viterbi once and the FEC Viterbi once or twice: {counts}")
    out["FSK9600 stream"] = p

    t0 = time.perf_counter()
    d = _payload(97, n // 128)  # 128 KiB at 2^24 samples
    src = os.path.join(work, "denoise.bin")
    with open(src, "wb") as f:
        f.write(d)
    wave, _ = read_wav(encode_file(src, "QPSK", True, BAUD, split_large_files=False,
                                   cache_dir=os.path.join(work, "cache")))
    # A recording: the transmission after a lead of silence. (Where the
    # signal fills most of the capture, the gate's wideband floor is the
    # signal's own level and both packages' gates cut its band.)
    p = os.path.join(work, "denoise.wav")
    capture = np.zeros(n, np.float32)
    capture[77777 : 77777 + len(wave)] = wave
    write_wav(p, capture)
    saved, counts, _reads, wall = _decode_wav(device, p, "QPSK", BAUD, work, "denoise", denoise=True)
    say(f"[5m denoise] decode_wav_file(denoise=True) of a clean {len(d)}-byte QPSK transmission ({len(wave)} samples "
        f"after 77,777 of silence, {n} in all): wall {wall:.3f} s, saved {len(saved)}, launches={counts} "
        f"({time.perf_counter() - t0:.1f} s) | {card}")
    check(same(saved, d), "denoise: the saved file differs")
    return out


def phase_fec_timing(fec_args, fec_out: dict, work: str, device, card: str):
    """The FEC Viterbi kernel on the clean capture's 205 blocks (median of 5
    by CUDA events) beside its plain version (one run), its bound by bytes
    and operations and by the chain (9,216 forward steps and, in the
    traceback's first phase, 9,216 / 32 walk steps a lane, at the cycles of
    their dependent chains, from the kernel's SASS and latencies measured on
    this card); the kernel on the 1 KiB FECV container's one block (known
    boundaries: one warp is the launch); the stream-FEC decode_wav_file of
    QPSK and FSK9600 (wall and device time); spectral_gate on a 2^24-sample
    capture. Returns ({entry: (ms, plain_ms, 1)}, {entry: (bound_ms, by)})."""
    import torch

    from audio_modem_radio_tpu_torch import sass_stats
    from audio_modem_radio_tpu_torch.kernel_variants import clock_samples
    from audio_modem_radio_tpu_torch.ops import _build
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.utils.denoise import _gate, spectral_gate
    from audio_modem_radio_tpu_torch.utils.wavio import read_wav

    args, container = fec_args
    pairs = args[0]
    nb, L, _ = pairs.shape
    ms = _time_ms(lambda: tk.fec_viterbi_blocks(*args))
    ms_container = _time_ms(lambda: tk.fec_viterbi_blocks(*container))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    tk.fec_viterbi_blocks_plain(*args)
    b.record()
    torch.cuda.synchronize()
    plain = a.elapsed_time(b)
    bound = _bound(pairs.numel() * 4 + nb * L, nb * L * (64 * _FEC_OPS_STATE + _FEC_OPS_STEP))
    lat = sass_stats.probe_latencies()
    fwd, fwd_path, back, back_path = sass_stats.chain_cycles(
        sass_stats.library_sass(_build.library_path()), lat, "fec_viterbi_kernel", forward="REDUX.MIN")
    mhz, watts, n_reads = clock_samples(lambda: tk.fec_viterbi_blocks(*args))
    check(n_reads > 0, "nvidia-smi read no SM clock")
    chain_ms = (L * fwd + -(-L // 32) * back) / (mhz * 1e3)
    say(f"[6 chain] fec_viterbi_kernel: forward step {fwd:.1f} cycles ({' -> '.join(fwd_path)}); traceback step "
        f"{back:.1f} cycles ({' -> '.join(back_path)}) | {card}")
    say(f"[6 time] fec_viterbi_blocks ({nb} blocks x {L} steps, 64 states): kernel {ms:.4f} ms, "
        f"{ms * mhz * 1e3 / L:.1f} cycles a step at SM {mhz:.0f} MHz ({watts:.1f} W); bound {bound[0]:.4f} ms by "
        f"{bound[1]}, {chain_ms:.4f} ms by the chain ({L} x {fwd:.1f} + {-(-L // 32)} x {back:.1f} cycles); plain "
        f"{plain:.4f} ms (one run) | {card}")
    steps = container[0].shape[1]
    say(f"[6 time] fec_viterbi_blocks on a 1 KiB FECV container (1 block x {steps} steps, known boundaries): kernel "
        f"{ms_container:.4f} ms, {ms_container * mhz * 1e3 / steps:.1f} cycles a step | {card}")
    _profile_decode(device, fec_out["wav"], "QPSK", BAUD, work, "QPSK stream", card, stream_fec=True)
    _profile_decode(device, fec_out["FSK9600 stream"], "FSK9600", 9600, work, "FSK9600 stream", card,
                    stream_fec=True)
    x, _ = read_wav(fec_out["wav"])
    xp = torch.from_numpy(np.pad(x, (0, (-len(x)) % 1024 + 2048))).to(device)
    gate_ms = _time_ms(lambda: _gate(xp))
    t0 = time.perf_counter()
    spectral_gate(x, device=device)
    say(f"[6 time] spectral_gate of {len(x)} samples: the gate on the card {gate_ms:.4f} ms (CUDA events, "
        f"median of 5); with the copies to and from the host {1e3 * (time.perf_counter() - t0):.1f} ms | {card}")
    return {"fec_viterbi_blocks": (ms, plain, 1)}, {"fec_viterbi_blocks": bound}


# --- OFDM, DSSS and Hellschreiber: the batches, the text modes, the round trips ---

# OFDM slices: mode -> (subcarriers, symbol length S at 9600 Bd).
_OFDM_SLICES = {"OFDM4": (4, 32), "OFDM8": (8, 64)}


def _slice_batch(mode: str, n_cap: int, n: int, payload_bytes: int, carrier: float, lead_of, seed: int):
    """``n_cap`` captures of ``n`` samples: capture i one seeded payload
    framed and modulated by the port's modulator on ``carrier`` (+100 Hz for
    capture 1, -100 Hz for capture 2), tiled from sample ``lead_of(i)``;
    the last capture seeded noise. Returns (batch, payloads, min_frames),
    None and 0 for the noise capture."""
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame
    from audio_modem_radio_tpu_torch.ops.dsss import dsss_real_modulate
    from audio_modem_radio_tpu_torch.ops.ofdm import ofdm_modulate

    rng = np.random.default_rng(seed)
    batch = np.empty((n_cap, n), np.float32)
    batch[-1] = np.clip(rng.normal(0.0, 0.3, n), -1, 1)
    payloads, min_frames = [], []
    for i in range(n_cap - 1):
        p = _payload(seed + i, payload_bytes)
        framed = pack_frame(f"cap{i}.bin", p, 0, 1, len(p), crc32(p))
        c = carrier + {1: 100.0, 2: -100.0}.get(i, 0.0)
        if mode == "DSSS":
            wave = dsss_real_modulate(framed, BAUD, c)
        else:
            wave = ofdm_modulate(framed, BAUD, c, _OFDM_SLICES[mode][0])
        batch[i] = _tiled(wave, n, lead=lead_of(i))
        payloads.append(p)
        min_frames.append(max(1, n // len(wave) - 1))
    return batch, payloads + [None], min_frames + [0]


def _launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _profiled(fn):
    """One call of ``fn()`` under ``torch.profiler`` after a warm-up call
    and a warm-up session (the first session of a process can record no
    device activity, or its own start-up as wall time): ({kernel name:
    [ms, count]}, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() / 1e3
            ms_n[1] += 1
    return by_name, wall_ms


def _stage_ms(x, mode: str, card: str, tag: str) -> None:
    """OFDM ``demod_pack_batch`` on the staged batch ``x``: Msamples/s by
    CUDA events (median of 5); each stage alone (passes 1 and 2, the
    differentials and decisions, the K2 + K3 tail) by CUDA events (median
    of 5) and by its device kernel time under ``torch.profiler``; the whole
    call under the profiler, its idle share and its largest kernels."""
    import torch

    from audio_modem_radio_tpu_torch.ops.kernels import _decide
    from audio_modem_radio_tpu_torch.ops.ofdm import _ofdm_differentials, _ofdm_front
    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch, psk4_kernel_sync_tail

    k = _OFDM_SLICES[mode][0]
    b, n = x.shape[0], x.shape[1] * (x.shape[2] - _OFDM_SLICES[mode][1])
    ms = _time_ms(lambda: demod_pack_batch(x, mode, BAUD))
    say(f"[{tag} time] demod_pack_batch {mode} {b} x {n} float32 rows {tuple(x.shape)}: {ms:.3f} ms = "
        f"{b * n / (ms * 1e-3) / 1e6:.2f} Msamples/s (CUDA events, median of 5) | {card}")
    front = _ofdm_front(x, BAUD, 12000.0, k, SR)
    dr, di, _g = _ofdm_differentials(front)
    hi, lo = _decide(dr, di, 4)
    del dr, di
    pad = -hi.shape[1] % (128 * 256)
    hi, lo = torch.nn.functional.pad(hi, (0, pad)), torch.nn.functional.pad(lo, (0, pad))
    stages = {
        "passes 1 and 2 (windows, offset score, the row-shifted table bmm)": lambda: _ofdm_front(x, BAUD, 12000.0, k, SR),
        "differentials, gains, rotation, Gray decisions": lambda: _decide(*_ofdm_differentials(front)[:2], 4),
        "the DQPSK tail on the padded streams (K2 tiers, fold, K3)": lambda: psk4_kernel_sync_tail(hi, lo, True),
    }
    for label, fn in stages.items():
        by_name, _wall = _profiled(fn)
        say(f"[{tag} time]   {_time_ms(fn):9.3f} ms by CUDA events, {sum(v[0] for v in by_name.values()):9.3f} ms "
            f"of device kernels ({sum(v[1] for v in by_name.values())}) under the profiler: {label} | {card}")
    del front, hi, lo
    by_name, wall_ms = _profiled(lambda: demod_pack_batch(x, mode, BAUD))
    dev_ms = sum(v[0] for v in by_name.values())
    say(f"[{tag} time] one demod_pack_batch under torch.profiler: device kernels {dev_ms:.3f} ms in "
        f"{sum(v[1] for v in by_name.values())} kernels, wall {wall_ms:.3f} ms, idle share "
        f"{1 - dev_ms / wall_ms:.3f} | {card}")
    for name, (ms_k, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        say(f"[{tag} time]   {ms_k:9.4f} ms x{c:<5d} {name[:100]}")


def phase_ofdm_slice(device, mode: str, n_cap: int, n: int, payload_bytes: int, tag: str, card: str) -> dict:
    """One OFDM slice at full width through ``decode_sample_batch`` (K2 and
    K3 and no other kernel), the frames gate, ``decode_wav_batch`` of 4 WAVs
    written by the port, and K2 and K3 against their plain versions on
    OFDM dibit streams (the bench batch with its last capture noise).
    Returns the launch counts."""
    import torch

    from audio_modem_radio_tpu_torch.framing import MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.ofdm import ofdm_decision_streams_batch
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    k, S = _OFDM_SLICES[mode]
    t_phase = t0 = time.perf_counter()
    rng = np.random.default_rng(2026)
    # Capture i starts at i mod S (every offset class once over the signal
    # captures, OFDM8's last class aside) plus a random whole number of symbols.
    batch, payloads, min_frames = _slice_batch(mode, n_cap, n, payload_bytes, 12000.0,
                                               lambda i: i % S + S * int(rng.integers(0, 40)), 7000)
    say(f"[{tag} {mode}] built {n_cap} x {n} captures (S={S}, leads 0..{min(S, n_cap - 1) - 1} mod S, captures 1 "
        f"and 2 at +-100 Hz, capture {n_cap - 1} noise) in {time.perf_counter() - t0:.1f} s | {card}")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, mode, BAUD, device=device)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    say(f"[{tag} {mode}] decode_sample_batch wall {wall:.3f} s (host shaping, copy, device, copy back) "
        f"launches={_launched(counts)} | {card}")
    _check_launches(counts, ("rotation_match_batch", "relabel_pack_batch"), mode, "decode_sample_batch")
    _check_frames(mode, raws, payloads, min_frames, tag, card, "decode_sample_batch, captures 1 and 2 at +-100 Hz")
    del batch, raws
    torch.cuda.empty_cache()
    _wav_roundtrip(device, mode, payload_bytes, tag)

    # The bench batch: one capture shaped and shipped once, copied on the card.
    wave = _mode_wave(_payload(0, payload_bytes), "bench.bin", mode, BAUD)
    xn = _rows(_tiled(wave, n)[None], "f32", device, mode).expand(n_cap, -1, -1).contiguous()
    g = torch.Generator(device=device).manual_seed(32)
    xn[-1] = torch.randn(xn.shape[1:], generator=g, device=device) * 0.3
    hi, lo = ofdm_decision_streams_batch(xn, BAUD, 12000.0, k, SR)
    pad = -hi.shape[1] % (128 * 256)
    hi3 = torch.nn.functional.pad(hi, (0, pad)).reshape(n_cap, -1, 128)
    lo3 = torch.nn.functional.pad(lo, (0, pad)).reshape(n_cap, -1, 128)
    r = hi3.shape[1]
    conds, _ = tk.rotation_match_conditions(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    tiers = tuple(p for p in sorted({256, -(-r // 8 // 256) * 256}) if 2 * p <= r) + (r,)
    for p in tiers:
        _check_match(f"K2 qpsk on {mode} streams", tk.rotation_match_batch(
            hi3, lo3, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2, rows_scanned=p),
            tk.rotation_match_batch_plain(hi3, lo3, conds, 16, 3, p), p * 128 - 17, [], card, p, r, n_cap)
    first, found = tk.rotation_match_batch(hi3, lo3, MAGIC_BIT_PATTERN, r, pattern2=MAGIC_BIT_PATTERN2,
                                           rows_scanned=r)
    check(bool(found[:-1, 0].all()), f"{mode} bench streams: a signal capture has no k=0 magic")
    _check_pack_every_pair(f"K3 on {mode} streams", tk.relabel_pack_batch, tk.relabel_pack_batch_plain,
                           hi3, lo3, (2 * first[:, 0]).to(torch.int32), card)
    del hi, lo, hi3, lo3, xn
    torch.cuda.empty_cache()
    say(f"[{tag} {mode}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def phase_dsss_slice(device, n_cap: int, n: int, payload_bytes: int, card: str) -> dict:
    """DSSS at 9600 chips/s at full width through ``decode_sample_batch``:
    no hand-written kernel, the frames gate. Returns the launch counts."""
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch

    tag, mode = "5p", "DSSS"
    t_phase = t0 = time.perf_counter()
    rng = np.random.default_rng(2027)
    batch, payloads, min_frames = _slice_batch(mode, n_cap, n, payload_bytes, 3000.0,
                                               lambda i: int(rng.integers(0, 1281)), 8000)
    say(f"[{tag} {mode}] built {n_cap} x {n} captures ({payload_bytes}-byte payloads, 16 chips a bit, captures "
        f"1 and 2 at +-100 Hz, capture {n_cap - 1} noise) in {time.perf_counter() - t0:.1f} s | {card}")
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    raws = decode_sample_batch(batch, mode, BAUD, device=device)
    wall = time.perf_counter() - t0
    counts = tk.launch_counts()
    say(f"[{tag} {mode}] decode_sample_batch wall {wall:.3f} s launches={_launched(counts)} | {card}")
    check(sum(counts.values()) == 0, f"DSSS launched a hand-written kernel: {counts}")
    _check_frames(mode, raws, payloads, min_frames, tag, card, "decode_sample_batch, captures 1 and 2 at +-100 Hz")
    say(f"[{tag} {mode}] {time.perf_counter() - t_phase:.1f} s | {card}")
    return counts


def phase_ofdm_dsss_timing(device, n_cap: int, n: int, payload_bytes: int, card: str) -> None:
    """Phase 6's OFDM and DSSS times on their bench batches (one capture
    tiled to ``n`` samples, shaped as ``host_shape_batch`` ships it, float32,
    shipped once and copied ``n_cap`` times on the card): OFDM4 and OFDM8
    by :func:`_stage_ms`, DSSS (``payload_bytes // 4``) ``demod_pack_batch``
    by CUDA events (median of 5). Run last: the profiler sessions of
    :func:`_stage_ms` come after every launch check."""
    import torch

    from audio_modem_radio_tpu_torch.parallel.batch import demod_pack_batch

    for mode in (*_OFDM_SLICES, "DSSS"):
        t0 = time.perf_counter()
        p = _payload(0, payload_bytes // 4 if mode == "DSSS" else payload_bytes)
        x = _rows(_tiled(_mode_wave(p, "bench.bin", mode, BAUD), n)[None], "f32", device, mode)
        x = x.expand(n_cap, -1, -1).contiguous()
        check(x.dtype == torch.float32, f"{mode} rows must ship as float32")
        _, _, found = demod_pack_batch(x, mode, BAUD)
        check(bool(found.all()), f"{mode} bench batch: a capture found no magic")
        if mode == "DSSS":
            ms = _time_ms(lambda: demod_pack_batch(x, mode, BAUD))
            say(f"[6 time] demod_pack_batch DSSS {n_cap} x {n} float32 rows {tuple(x.shape)}: {ms:.3f} ms = "
                f"{n_cap * n / (ms * 1e-3) / 1e6:.2f} Msamples/s (CUDA events, median of 5) | {card}")
        else:
            _stage_ms(x, mode, card, "6")
        del x
        torch.cuda.empty_cache()
        say(f"[6 time] {mode}: {time.perf_counter() - t0:.1f} s | {card}")


_HELL_TEXT = "CQ CQ DE H100 PYTORCH PORT 0123456789"


def phase_hell(device, work: str, card: str) -> None:
    """The text modes: for HELLSCHREIBER and SLOW_HELL a WAV from the port's
    ``encode_hellschreiber_text``, for FELD_HELL one from ``modulate``, and a
    noise WAV, through ``decode_wav_batch`` and ``decode_wav_file``: the
    text saved equals the text sent, noise saves nothing, no hand-written
    kernel launches."""
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.decoder import decode_wav_file
    from audio_modem_radio_tpu_torch.encoder import encode_hellschreiber_text
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.parallel.batch import decode_wav_batch
    from audio_modem_radio_tpu_torch.utils.wavio import write_wav

    noise = os.path.join(work, "hell_noise.wav")
    write_wav(noise, np.clip(np.random.default_rng(9).normal(0.0, 0.3, 1 << 22), -1, 1).astype(np.float32))
    for mode, baud in (("HELLSCHREIBER", 122.5), ("FELD_HELL", 122.5), ("SLOW_HELL", 61.25)):
        t0 = time.perf_counter()
        if mode == "FELD_HELL":
            path = os.path.join(work, "feld_hell.wav")
            write_wav(path, modulate(mode, _HELL_TEXT.encode(), 9600))
        else:
            path = encode_hellschreiber_text(_HELL_TEXT, cache_dir=os.path.join(work, "cache_" + mode), baud=baud)
        tk.reset_launch_counts()
        saved = decode_wav_batch([path, noise], mode, 9600, recv_dir=os.path.join(work, "recv_b" + mode),
                                 registry=AssemblyRegistry(journal_dir=""), device=device)
        check(len(saved[0]) == 1 and open(saved[0][0]).read() == _HELL_TEXT and saved[1] == [],
              f"{mode}: decode_wav_batch saved {saved}")
        single = decode_wav_file(path, mode, 9600, recv_dir=os.path.join(work, "recv_f" + mode), device=device)
        check(len(single) == 1 and open(single[0]).read() == _HELL_TEXT, f"{mode}: decode_wav_file saved {single}")
        check(decode_wav_file(noise, mode, 9600, recv_dir=os.path.join(work, "recv_n" + mode), device=device) == [],
              f"{mode}: a noise WAV saved text")
        counts = tk.launch_counts()
        check(sum(counts.values()) == 0, f"{mode} launched a hand-written kernel: {counts}")
        say(f"[5q {mode}] {len(_HELL_TEXT)} characters through decode_wav_batch and decode_wav_file: the text, "
            f"nothing from noise, no kernel; {time.perf_counter() - t0:.1f} s | {card}")


def phase_roundtrips(device, work: str, card: str) -> None:
    """file -> the port's ``encode_file`` -> WAV -> ``decode_wav_file`` on the
    card -> the same bytes, for OFDM4, OFDM8 (stream FEC) and DSSS."""
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.decoder import decode_wav_file
    from audio_modem_radio_tpu_torch.encoder import encode_file
    from audio_modem_radio_tpu_torch.ops import kernels as tk

    for mode, size, fec in (("OFDM4", 24576, None), ("OFDM8", 24576, "stream"), ("DSSS", 1536, None)):
        t0 = time.perf_counter()
        data = _payload(300 + size, size // 2) + b"round trip on the card " * (size // 46)
        src = os.path.join(work, f"rt_{mode}.bin")
        with open(src, "wb") as f:
            f.write(data)
        wav = encode_file(src, mode, symbol_rate=BAUD, cache_dir=os.path.join(work, "cache_rt"),
                          use_fec=fec is not None, fec_type=fec)
        t_enc = time.perf_counter() - t0
        tk.reset_launch_counts()
        t1 = time.perf_counter()
        saved = decode_wav_file(wav, mode, BAUD, recv_dir=os.path.join(work, "recv_rt" + mode),
                                registry=AssemblyRegistry(journal_dir=""), stream_fec=fec == "stream",
                                device=device)
        wall = time.perf_counter() - t1
        check(len(saved) == 1 and open(saved[0], "rb").read() == data, f"{mode} round trip: saved {saved}")
        say(f"[5r {mode}] {len(data)} bytes{' with stream FEC' if fec else ''}: encode_file {t_enc:.3f} s, "
            f"decode_wav_file {wall:.3f} s, launches={_launched(tk.launch_counts())}, the same bytes | {card}")


# Phase 5s: the size of the QPSK file the front ends decode, of the
# stream-FEC file and of the FSK9600 file; the batch's WAV count.
_FRONT_BYTES, _FRONT_FEC_BYTES, _FRONT_FSK_BYTES, _FRONT_BATCH = 100 * 1024, 32 * 1024, 16 * 1024, 8
# Each front-end decode -> the kernels it must launch.
_FRONT_KERNELS = {
    "single": ("psk_project_diff",),
    "batch": ("psk_project_decide_batch", "rotation_match_batch", "relabel_pack_batch"),
    "stream FEC": ("fec_viterbi_blocks",),
    "FSK9600": ("mlse_viterbi_blocks",),
}

# The phase's decodes of the QPSK WAV that decode_wav_file also decodes.
_FRONT_SAME_WAV = ("gui start_decode (first)", "gui start_decode", "cli decode-wav", "console app decode", "ReceiveSession (48 kHz)",
                   "cli decode-stream --wav")


def _front_file(work: str, name: str, n_bytes: int, seed: int) -> bytes:
    data = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    with open(os.path.join(work, name), "wb") as f:
        f.write(data)
    return data


def _cli(argv):
    """The port's ``cli.main(argv)``: (exit code, stdout lines, host seconds)."""
    import contextlib
    import io

    from audio_modem_radio_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t0


def _read_all(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def phase_front_ends(work: str, card: str) -> None:
    """The port's front ends on the card, each through the entry point a
    user calls, with no device named (the card): a ~100 KiB
    random file through ``cli encode-file`` (QPSK@9600), then decoded by the
    GUI view model on its worker thread (first: the first front-end decode
    of the process is a worker thread's), ``decode_wav_file`` (the
    reference wall), ``cli decode-wav``, the console app (scripted input)
    and ``ReceiveSession`` over a ``FileRecorder`` of the WAV at 48 kHz; then
    ``decode-wav --batch`` of 8 such WAVs, ``--stream-fec``, an FSK9600 WAV,
    ``decode-stream --wav`` and a noise WAV (exit 1). Each decode saves the
    source's bytes and launches its kernels; each front end's host wall is
    printed beside ``decode_wav_file``'s."""
    import builtins
    import contextlib
    import io
    import logging
    import queue

    import torch

    from audio_modem_radio_tpu_torch.app import ConsoleApp
    from audio_modem_radio_tpu_torch.audio_io import FileRecorder, ReceiveSession
    from audio_modem_radio_tpu_torch.decoder import decode_wav_file
    from audio_modem_radio_tpu_torch.gui import GuiViewModel
    from audio_modem_radio_tpu_torch.observability import LOGGER_NAME, AnalyticsStore, PerformanceMonitor
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.utils.wavio import read_wav, resample, write_wav

    t_phase = time.perf_counter()
    qpsk = ["--mode", "QPSK", "--symbol-rate", str(BAUD)]
    walls, launches = {}, {}

    def launched(label: str, kind: str) -> None:
        counts = _launched(tk.launch_counts())
        launches[label] = counts
        missing = [k for k in _FRONT_KERNELS[kind] if not counts.get(k)]
        check(not missing, f"{label}: kernels {missing} not launched ({counts})")

    root = os.path.join(work, "front")
    os.makedirs(root, exist_ok=True)
    old_cwd, old_input = os.getcwd(), builtins.input
    os.chdir(root)  # the front ends write their analytics, playlist and log here
    try:
        data = _front_file(root, "front.bin", _FRONT_BYTES, 501)
        rc, out, walls["cli encode-file"] = _cli(["encode-file", "front.bin", *qpsk])
        check(rc == 0 and out[-1].endswith(".wav"), f"cli encode-file: rc {rc}, {out}")
        wav = os.path.abspath(out[-1])
        n_samples = len(read_wav(wav)[0])

        vm = GuiViewModel(playlist_path=os.path.join(root, "playlist.json"))
        vm.mode, vm.symbol_rate = "QPSK", BAUD

        def gui_decode(label: str) -> None:
            tk.reset_launch_counts()
            t0 = time.perf_counter()
            vm.start_decode(wav).join(timeout=600)
            walls[label] = time.perf_counter() - t0
            events = []
            while True:
                try:
                    events.append(vm.events.get_nowait())
                except queue.Empty:
                    break
            errors = [e for e in events if e[0] == "error"]
            decoded = [e for e in events if e[0] == "decoded"]
            check(not errors and len(decoded) == 1 and _read_all(decoded[0][1]) == [data],
                  f"{label}: events {events}")
            launched(label, "single")

        gui_decode("gui start_decode (first)")
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        saved = decode_wav_file(wav, "QPSK", BAUD, recv_dir=os.path.join(root, "recv_ref"))
        walls["decode_wav_file"] = time.perf_counter() - t0
        check(_read_all(saved) == [data], f"decode_wav_file saved {saved}")
        launched("decode_wav_file", "single")
        gui_decode("gui start_decode")

        tk.reset_launch_counts()
        rc, out, walls["cli decode-wav"] = _cli(["decode-wav", wav, *qpsk, "--recv-dir", "recv_cli"])
        check(rc == 0 and out[0] == f"{wav}: 1 file(s)" and _read_all(out[1:]) == [data],
              f"cli decode-wav: rc {rc}, {out}")
        launched("cli decode-wav", "single")

        tk.reset_launch_counts()
        script = iter(["decode", wav, "QPSK", str(BAUD), "quit"])
        builtins.input = lambda *_: next(script)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ConsoleApp(analytics=AnalyticsStore(os.path.join(root, "app_analytics.json"))).run()
        walls["console app decode"] = time.perf_counter() - t0
        builtins.input = old_input
        lines = buf.getvalue().splitlines()
        check("1 file(s) recovered" in lines, f"console app: {lines}")
        got = _read_all([lines[lines.index("1 file(s) recovered") + 1].strip()])
        check(got == [data], "console app: saved other bytes")
        launched("console app decode", "single")

        mic = os.path.join(root, "mic48k.wav")
        x, sr = read_wav(wav)
        write_wav(mic, resample(x, sr, 48000), 48000)
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        saved = ReceiveSession("QPSK", BAUD, FileRecorder(mic), recv_dir=os.path.join(root, "recv_live")).run(60.0)
        walls["ReceiveSession (48 kHz)"] = time.perf_counter() - t0
        check(_read_all(saved) == [data], f"ReceiveSession saved {saved}")
        launched("ReceiveSession (48 kHz)", "single")

        batch_data, batch_wavs = [], []
        for i in range(_FRONT_BATCH):
            batch_data.append(_front_file(root, f"batch{i}.bin", _FRONT_BYTES, 510 + i))
            rc, out, _ = _cli(["encode-file", f"batch{i}.bin", *qpsk, "--cache-dir", "cache_batch"])
            check(rc == 0, f"cli encode-file batch{i}: rc {rc}")
            batch_wavs.append(os.path.abspath(out[-1]))
        tk.reset_launch_counts()
        label = f"cli decode-wav --batch ({_FRONT_BATCH})"
        rc, out, walls[label] = _cli(
            ["decode-wav", *batch_wavs, *qpsk, "--batch", "--recv-dir", "recv_batch"])
        check(rc == 0 and out[:_FRONT_BATCH] == [f"{w}: 1 file(s)" for w in batch_wavs]
              and _read_all(out[_FRONT_BATCH:]) == batch_data, f"cli decode-wav --batch: rc {rc}, {out}")
        launched(label, "batch")

        fec_data = _front_file(root, "fec.bin", _FRONT_FEC_BYTES, 520)
        rc, out, _ = _cli(["encode-file", "fec.bin", *qpsk, "--fec", "--fec-type", "stream", "--cache-dir",
                           "cache_fec"])
        check(rc == 0, f"cli encode-file --fec-type stream: rc {rc}")
        tk.reset_launch_counts()
        rc, out, walls["cli decode-wav --stream-fec"] = _cli(
            ["decode-wav", out[-1], *qpsk, "--stream-fec", "--recv-dir", "recv_fec"])
        check(rc == 0 and _read_all(out[1:]) == [fec_data], f"cli decode-wav --stream-fec: rc {rc}, {out}")
        launched("cli decode-wav --stream-fec", "stream FEC")

        fsk_data = _front_file(root, "fsk.bin", _FRONT_FSK_BYTES, 530)
        fsk = ["--mode", "FSK9600", "--symbol-rate", "9600"]
        rc, out, _ = _cli(["encode-file", "fsk.bin", *fsk, "--cache-dir", "cache_fsk"])
        check(rc == 0, f"cli encode-file FSK9600: rc {rc}")
        tk.reset_launch_counts()
        rc, out, walls["cli decode-wav FSK9600"] = _cli(["decode-wav", out[-1], *fsk, "--recv-dir", "recv_fsk"])
        check(rc == 0 and _read_all(out[1:]) == [fsk_data], f"cli decode-wav FSK9600: rc {rc}, {out}")
        launched("cli decode-wav FSK9600", "FSK9600")

        tk.reset_launch_counts()
        window = str(1 << max(20, n_samples.bit_length()))  # one window holds the whole frame
        rc, out, walls["cli decode-stream --wav"] = _cli(
            ["decode-stream", "--wav", wav, *qpsk, "--window", window, "--recv-dir", "recv_stream"])
        check(rc == 0 and _read_all([ln.split(": ", 1)[1] for ln in out]) == [data],
              f"cli decode-stream: rc {rc}, {out}")
        launched("cli decode-stream --wav", "single")

        noise = os.path.join(root, "noise.wav")
        write_wav(noise, np.clip(np.random.default_rng(540).normal(0.0, 0.3, n_samples), -1, 1).astype(np.float32))
        rc, out, walls["cli decode-wav (noise)"] = _cli(["decode-wav", noise, *qpsk, "--recv-dir", "recv_noise"])
        check(rc == 1 and out == [f"{noise}: 0 file(s)"], f"cli decode-wav of noise: rc {rc}, {out}")

        devices = PerformanceMonitor().sample().get("devices", [])
        check(devices and torch.cuda.get_device_name(0) in devices[0],
              f"PerformanceMonitor lists {devices}, not the card")
    finally:
        builtins.input = old_input
        os.chdir(old_cwd)
        logger = logging.getLogger(LOGGER_NAME)  # the app's file handler
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()
    ref = walls["decode_wav_file"]
    say(f"[5s front ends] {len(data)}-byte QPSK@{BAUD} file, {n_samples} samples; PerformanceMonitor devices "
        f"{devices} | {card}")
    for label, wall in walls.items():
        # The front ends that decode the same WAV as decode_wav_file: their
        # host overhead is the difference.
        beside = f", decode_wav_file {ref:.3f} s, overhead {wall - ref:+.3f} s" if label in _FRONT_SAME_WAV else ""
        say(f"[5s front ends] {label}: wall {wall:.3f} s{beside}, launches={launches.get(label, {})} | {card}")
    say(f"[5s front ends] phase {time.perf_counter() - t_phase:.1f} s | {card}")


# --- scale-out and training: the data-parallel and sequence-parallel meshes ---------

# The sequence families of phase 5t, at the dry run's rates: label -> (mode,
# rate, payload bytes or None for the text, compare with the single-device
# demod).
_SEQ_FAMILIES = {
    "QPSK": ("QPSK", 9600, 16384, True), "FSK1200": ("FSK1200", 1200, 4096, True),
    "OFDM4": ("OFDM4", 4800, 4096, False), "8PSK": ("8PSK", 9600, 16384, False),
    "DSSS": ("DSSS", 9600, 1024, True), "NEURAL@1200": ("NEURAL", 1200, 4096, False),
    "HELL": ("HELLSCHREIBER", 1200, None, False),
}
_SHARDS = 4


def _single_device_raw(mode: str, x: np.ndarray, device) -> bytes:
    """The port's single-device demodulator of ``mode`` on one capture."""
    from audio_modem_radio_tpu_torch.ops.dsss import dsss_real_demodulate
    from audio_modem_radio_tpu_torch.ops.fsk import fsk_demodulate
    from audio_modem_radio_tpu_torch.ops.psk import qpsk_demodulate

    if mode == "QPSK":
        return qpsk_demodulate(x, BAUD, 3000.0, SR, device=device)
    if mode == "FSK1200":
        return fsk_demodulate(x, 1200, 1200.0, 2200.0, SR, device=device)
    return dsss_real_demodulate(x, BAUD, 3000.0, SR, device=device)


def phase_scaleout(device, n_cap: int, n: int, payload_bytes: int, work: str, card: str) -> None:
    """5t. Scale-out and training on a virtual mesh of the one card (4
    shards; the script hides every other card): the QPSK slice batch
    through ``decode_sample_batch(mesh=)`` against the unsharded call, one
    2^24-sample capture per sequence family through
    ``decode_capture_sharded``, ``dryrun_multichip(4)`` and ``(5)``,
    ``train_and_export`` at the shipped configuration, and the dp x tp
    training step against the unsharded one."""
    import torch

    from audio_modem_radio_tpu_torch.entry import dryrun_multichip
    from audio_modem_radio_tpu_torch.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio_tpu_torch.modem import modulate
    from audio_modem_radio_tpu_torch.ops import kernels as tk
    from audio_modem_radio_tpu_torch.ops.hell import hellschreiber_modulate
    from audio_modem_radio_tpu_torch.parallel.batch import decode_sample_batch
    from audio_modem_radio_tpu_torch.parallel.mesh import get_mesh
    from audio_modem_radio_tpu_torch.parallel.sequence import decode_capture_sharded

    t_phase = time.perf_counter()
    mesh = get_mesh(devices=[device] * _SHARDS)

    # The data-parallel batch: the noise capture sits in the last shard, so
    # every shard must take the unsharded call's tiers.
    batch, payloads, _min = _psk_slice_batch("QPSK", n_cap, n, payload_bytes)
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    ref = decode_sample_batch(batch, "QPSK", BAUD, device=device)
    wall_ref = time.perf_counter() - t0
    c_ref = _launched(tk.launch_counts())
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    got = decode_sample_batch(batch, "QPSK", BAUD, mesh=mesh)
    wall = time.perf_counter() - t0
    counts = _launched(tk.launch_counts())
    check(got == ref, "decode_sample_batch(mesh=) differs from the unsharded call")
    want = {"psk_project_decide_batch": _SHARDS, "relabel_pack_batch": _SHARDS,
            "rotation_match_batch": _SHARDS * c_ref.get("rotation_match_batch", 0)}
    check(c_ref.get("rotation_match_batch", 0) >= 2, f"the noise capture must pass the first tier: {c_ref}")
    check(counts == want, f"decode_sample_batch(mesh=) launches {counts}, want {want}")
    for i, raw in enumerate(got):
        frames = parse_frames(raw)
        check(bool(frames) == (payloads[i] is not None) and all(f.data == payloads[i] for f in frames),
              f"mesh capture {i}: {len(frames)} frames")
    say(f"[5t dp] {n_cap} x {n} QPSK through decode_sample_batch on {_SHARDS} shards of the card: bytes equal "
        f"to the unsharded call's; launches {counts} (unsharded {c_ref}); wall {wall:.3f} s vs unsharded "
        f"{wall_ref:.3f} s | {card}")
    del batch, ref, got

    # One capture per sequence family, sharded over the samples.
    for label, (mode, rate, size, compare) in _SEQ_FAMILIES.items():
        if size is None:
            wave = np.asarray(hellschreiber_modulate(_HELL_TEXT), np.float32)
        else:
            p = _payload(7000 + rate, size)
            if mode == "8PSK":  # whole 3-byte groups keep the tiled copies byte-aligned (phase 5c)
                p = p[: len(p) - len(pack_frame(f"seq_{label}.bin", p, 0, 1, len(p), crc32(p))) % 3]
            wave = modulate(mode, pack_frame(f"seq_{label}.bin", p, 0, 1, len(p), crc32(p)), rate)
        x = _tiled(wave, n, lead=0 if size is None else 1234)
        walls = []
        for _ in range(2):  # the first call builds the tables
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            raw = decode_capture_sharded(x, mode, rate, mesh)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9  # the call's own, over what was allocated
        if size is None:
            check(raw.decode("utf-8") == _HELL_TEXT, f"sequence-parallel HELL: {raw[:60]!r}")
            what = f"the text ({len(_HELL_TEXT)} characters)"
        else:
            frames = parse_frames(raw)
            check(frames and all(f.data == p for f in frames), f"sequence-parallel {label}: {len(frames)} frames")
            what = f"{len(frames)} frames (>= {max(1, (n - 1234) // len(wave) - 1)} expected)"
            check(len(frames) >= max(1, (n - 1234) // len(wave) - 1), f"sequence-parallel {label}: {what}")
        if compare:
            single = _single_device_raw(label, x, device)
            m = min(len(single), len(raw))
            check(m > 0 and single[:m] == raw[:m],
                  f"sequence-parallel {label} differs from the single-device demod over {m} bytes")
            what += f", bytes equal to the single-device demod over {m}"
        say(f"[5t sp {label}] one {n}-sample capture on {_SHARDS} shards: {what}; wall {walls[1]:.3f} s "
            f"(first call {walls[0]:.3f} s), peak {peak:.2f} GB over the {base / 1e9:.2f} GB allocated | {card}")

    for k in (_SHARDS, 5):
        t0 = time.perf_counter()
        dryrun_multichip(k)
        say(f"[5t dryrun] dryrun_multichip({k}) {time.perf_counter() - t0:.1f} s | {card}")

    phase_training(device, work, card)
    say(f"[5t] {time.perf_counter() - t_phase:.1f} s | {card}")


def phase_training(device, work: str, card: str) -> None:
    """``train_and_export`` at the shipped configuration into ``work``, and
    the dp x tp step on a virtual 2 x 2 mesh against the unsharded step."""
    import torch

    from audio_modem_radio_tpu_torch.models.neural_modem import create_train_state, make_train_step
    from audio_modem_radio_tpu_torch.models.train_neural import DEFAULT_CODEBOOK, train_and_export
    from audio_modem_radio_tpu_torch.parallel.mesh import get_2d_mesh

    out = os.path.join(work, "neural_codebook.npz")
    t0 = time.perf_counter()
    res = train_and_export(out, device=device)
    wall = time.perf_counter() - t0
    with np.load(DEFAULT_CODEBOOK) as z:
        shipped_ser = float(z["nearest_codeword_ser"])
    with np.load(out) as z:
        cb = np.asarray(z["codebook"])
    check(cb.shape == (256, 16) and np.allclose(np.mean(cb ** 2, axis=-1), 1.0, atol=1e-3),
          "the trained codebook is not unit power")
    check(res["ser"] <= 0.01, f"trained codebook SER {res['ser']} > 0.01")
    say(f"[5t train] train_and_export (bits 8, hidden 256, sps 8, 3000 steps, batch 1024, sigma 0.35): "
        f"{res['steps_per_s']:.1f} steps/s, {wall:.1f} s, final accuracy {res['acc']:.4f}, nearest-codeword SER "
        f"{res['ser']:.4f} (the shipped codebook's {shipped_ser:.4f}) | {card}")

    # Sharding changes only the order of the sums: the gradients agree to
    # float32 rounding, and Adam's first step, lr * g / (|g| + eps), moves an
    # element by at most 2 * lr * |dg| / (max |g| + eps) more.
    lr = 1e-3
    models = [create_train_state(0, device=device, learning_rate=lr) for _ in range(2)]
    steps = [make_train_step(*models[0]), make_train_step(*models[1], mesh=get_2d_mesh(2, 2, [device] * 4))]
    symbols = torch.randint(0, 256, (1024,), generator=torch.Generator(device=device).manual_seed(5), device=device)
    res = [step(symbols, 0.35, torch.Generator(device=device).manual_seed(6)) for step in steps]
    worst_g = worst_p = 0.0
    for (name, pa), pb in zip(models[0][0].named_parameters(), models[1][0].parameters()):
        ga, gb, pa, pb = pa.grad, pb.grad, pa.detach(), pb.detach()
        worst_g = max(worst_g, float((ga - gb).abs().max() / ga.abs().max().clamp_min(1e-30)))
        dp = (pa - pb).abs()
        worst_p = max(worst_p, float(dp.max() / pa.abs().max().clamp_min(1e-30)))
        bound = 1e-6 * pa.abs().max() + 2 * lr * (ga - gb).abs() / (torch.maximum(ga.abs(), gb.abs()) + 1e-8)
        check(bool((dp <= bound).all()), f"the dp x tp step moved {name} past Adam's bound on the gradient difference")
    check(worst_g <= 1e-5, f"the dp x tp gradients differ from the unsharded ones by {worst_g:.2e} of the largest")
    check(abs(float(res[0][0]) - float(res[1][0])) <= 1e-5 * abs(float(res[0][0])), f"losses {res}")
    say(f"[5t dp x tp] one step on a virtual 2 x 2 mesh beside the unsharded step: gradients within {worst_g:.2e} "
        f"of each tensor's largest, parameters within {worst_p:.2e} (inside Adam's bound on the gradient "
        f"difference), loss {float(res[1][0]):.6f} vs {float(res[0][0]):.6f} | {card}")


def main() -> int:
    n, n_k1, n_slice, payload_bytes = 1 << 24, 8, 64, 16384
    # One card: the first visible one (set before torch initialises CUDA).
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false: this smoke needs a card")
        return 2
    sys.path.insert(0, HERE)
    try:
        import audio_modem_radio_tpu_torch  # noqa: F401
        from audio_modem_radio_tpu_torch.config import CONFIG
        from audio_modem_radio_tpu_torch.ops.psk import blocked_row_shape
    except ImportError as e:
        say(f"FAIL: the port's package is not beside this script ({e})")
        return 2

    t_start = time.perf_counter()
    phase = "1 env"
    single = fec_work = None
    try:
        device, card = phase_environment()
        phase = "2 build"
        phase_build()
        phase = "3 K1"
        errs = {k: (v, None) for k, v in phase_decide(device, n_k1, n, payload_bytes, card).items()}
        phase = "3b FSK kernels"
        errs.update(phase_fsk_kernels(device, n_k1, n, card))
        phase = "3c K11/K12"
        errs.update(phase_project_diff(device, n_k1, n, payload_bytes, card))
        phase = "3d K10"
        errs.update(phase_neural_kernel(device, n_k1, n, payload_bytes, card))
        phase = "3e Viterbi"
        viterbi_err, viterbi_args = phase_viterbi_kernel(device, n, card)
        errs["mlse_viterbi_blocks"] = viterbi_err
        phase = "3f FEC Viterbi"
        scratch = os.path.join(HERE, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        fec_work = tempfile.mkdtemp(dir=scratch)
        errs["fec_viterbi_blocks"], fec_args, fec_in = phase_fec_kernel(device, n, fec_work, card)
        phase = "4 match/pack"
        r = blocked_row_shape(n, BAUD, SR)[0]
        errs.update({k: (v, None) for k, v in phase_match_pack(device, r, card).items()})
        counts = {}
        for mode in _SLICES:
            phase = f"5 slice {mode}"
            counts[mode] = phase_slice(device, mode, n_slice, n, payload_bytes, card)
        for tag, mode in zip(("5d", "5e", "5f"), _FSK_SLICES):
            phase = f"5 slice {mode}"
            counts.update(phase_fsk_slice(device, mode, n_slice, n, payload_bytes, tag, card))
        phase = "5g single-capture decodes"
        single = phase_single(device, n, card)
        counts["QPSK single"] = single["QPSK single"]
        phase = "5h 8PSK under tpu.demod_backend=xla"
        CONFIG.set("tpu.demod_backend", "xla")
        try:
            counts["8PSK xla"] = phase_slice(device, "8PSK", n_slice, n, payload_bytes, card,
                                             kernels=("psk_project_diff_batch",), tag="5h", wav=False)
        finally:
            CONFIG.set("tpu.demod_backend", "auto")
        check(counts["8PSK xla"]["psk_project_diff_batch"] == 1, "K12 must launch once on the xla path")
        phase = "5i NEURAL slice"
        counts["NEURAL"] = phase_neural_slice(device, BAUD, n_slice, n, payload_bytes, "5i", card)
        phase = "5j NEURAL@3000"
        phase_neural_slice(device, 3000, n_k1, n, payload_bytes, "5j", card)
        phase = "5k NEURAL single-capture decodes"
        single["wavs"]["NEURAL"] = phase_neural_single(device, n, single["work"], card)
        phase = "5l FSK single-capture decodes"
        fsk_wavs, counts["FSK9600 single"], mlse_batch_args = phase_fsk_single(device, n, single["work"], card)
        single["wavs"].update(fsk_wavs)
        phase = "5m FEC, encoder to decoder"
        fec_out = phase_fec_single(device, n, fec_work, fec_in, card)
        counts["QPSK stream"] = fec_out["QPSK stream"]
        for tag, mode in (("5n", "OFDM4"), ("5o", "OFDM8")):
            phase = f"{tag} {mode} slice"
            counts[mode] = phase_ofdm_slice(device, mode, n_slice, n, payload_bytes, tag, card)
        phase = "5p DSSS slice"
        counts["DSSS"] = phase_dsss_slice(device, n_slice, n, payload_bytes // 4, card)
        phase = "5q Hellschreiber"
        phase_hell(device, fec_work, card)
        phase = "5r round trips"
        phase_roundtrips(device, fec_work, card)
        phase = "5s front ends"
        phase_front_ends(fec_work, card)
        phase = "5t scale-out and training"
        phase_scaleout(device, n_slice, n, payload_bytes, fec_work, card)
        phase = "6 timing"
        psk_times, _, bounds = phase_timing(device, n_slice, n, payload_bytes, card)
        times = {k: (ms, plain, n_slice) for k, (ms, plain) in psk_times.items()}
        fsk_times, _, fsk_bounds = phase_fsk_timing(device, n_slice, n, payload_bytes, card)
        times.update(fsk_times)
        bounds.update(fsk_bounds)
        neural_times, _, neural_bounds = phase_neural_timing(device, n_slice, n, payload_bytes, card)
        times.update(neural_times)
        bounds.update(neural_bounds)
        diff_times, diff_bounds, _ = phase_single_timing(device, n_slice, n, payload_bytes, single["wavs"],
                                                         single["work"], card)
        times.update(diff_times)
        bounds.update(diff_bounds)
        viterbi_times, viterbi_bounds = phase_viterbi_timing(viterbi_args, mlse_batch_args, card)
        times.update(viterbi_times)
        bounds.update(viterbi_bounds)
        fec_times, fec_bounds = phase_fec_timing(fec_args, fec_out, fec_work, device, card)
        times.update(fec_times)
        bounds.update(fec_bounds)
        phase_ofdm_dsss_timing(device, n_slice, n, payload_bytes, card)
    except Exception as e:  # any failure: report the phase, print no result
        import traceback

        traceback.print_exc()
        say(f"FAIL in phase {phase}: {type(e).__name__}: {e}")
        return 1
    finally:
        if single is not None:
            shutil.rmtree(single["work"], ignore_errors=True)
        if fec_work is not None:
            shutil.rmtree(fec_work, ignore_errors=True)

    kernels = []
    for entry, (wrapper, run, src, line) in _ENTRIES.items():
        timed = times.get(entry) or times[f"{entry}@256"]  # the matchers: the 256-row tier
        err_abs, err_rel = errs[entry]
        item = {
            "name": entry, "route": "cuda", "source": f"{_CSRC}/{src}",
            "replaces": line if isinstance(line, str) else f"{_PALLAS}:{line}",
            "launches": counts[run][wrapper],
            "max_abs_err": err_abs, "ms": timed[0], "plain_ms": timed[1],
            "bound_ms": bounds[entry][0], "bound_by": bounds[entry][1], "library_ms": None,
        }
        if err_rel is not None:
            item["max_rel_err"] = err_rel
        if timed[2] != n_slice:
            item["plain_captures"] = timed[2]
        kernels.append(item)
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s | {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
