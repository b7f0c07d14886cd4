// K6: D8PSK sector relabel by the winning rotation, Gray coding, mod-8-symbol
// alignment and byte pack.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py psk8_relabel_pack_rows
// (_kernel_psk8_relabel_pack with the per-shift tables of
// _psk8_shifted_pack_weights).
//
// What it computes. For capture b with k = ksel[b] and r8 = r8[b] (the sync
// shift in symbols, already reduced mod 8), symbol t's true sector is
// x = (sec[t] + 8 - k) & 7 and its Gray code x ^ (x >> 1) gives 3 flat bits,
// plane q = 0 (the Gray MSB) first: flat bit 3t + q. Output byte c of the
// capture is sum_{i<8} bit[8c + 3*r8 + i] * 2^(7 - i); 128 symbols are
// exactly 48 bytes, so row r holds bytes 48r .. 48r + 47. Bits past the
// capture's end are zero, as in the plain version; the TPU kernel read the
// next capture's head there, which only the capture's last bytes can see.
//
// What bounds it on the H100: device memory, 1 B of sectors read per 3/8 B
// written, a few integer operations each (bound 0.045 ms for 64 captures of
// 13,312 rows). The TPU version expressed the shifted byte assembly as six
// MXU matmuls per tile against per-shift weight tables; on CUDA cores the
// shift is a register shift, so no tables exist.
//
// Design. The first design ran a thread per output byte (41 M threads on
// that batch): 4 single-byte loads of sectors its neighbours also loaded, a
// 64-bit divide and modulo by 3, one byte stored; it reached 20% of the
// bound. Here a thread owns a run of kRun = 32 symbols, 12 output bytes:
// * two 16-byte loads; each 32-bit word of 4 sectors is relabelled in SWAR,
//   ((x & 7) + 8 - k) & 7 per byte (at most 15, so nothing carries across
//   bytes), Gray-coded, byte-reversed and packed to 12 bits, and the 8
//   groups make a 96-bit big-endian register stream;
// * the shift by 3*r8 bits (at most 21) takes the next run's first word,
//   by a shuffle from the next lane, or for the warp's last lane from one
//   8-byte load; zero past the capture's end;
// * three funnel shifts, byte swaps and streaming 4-byte stores. No division.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel psk8_pack, PERF.md section 6), K1's sectors of the 8PSK bench
// batch at every (ksel, r8): the kernel alone 0.050 ms (0.0465 in the
// slice's profile: 96% of the bound), from 0.185; every byte equal to the
// first design's. 24 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                // symbols a thread
constexpr int kOutWords = 3 * kRun / 32;  // 12 bytes out

// Four sectors, one a byte (little-endian: the first in the low byte) ->
// their 12 Gray bits, the first sector's in bits 11..9.
__device__ __forceinline__ uint32_t gray12(uint32_t x, uint32_t add) {
  x = ((x & 0x07070707u) + add) & 0x07070707u;  // (sector + 8 - k) & 7 per byte
  x ^= (x >> 1) & 0x03030303u;                   // Gray code per byte
  x = __byte_perm(x, 0, 0x0123);                 // the first sector in the high byte
  x = (x | (x >> 5)) & 0x003F003Fu;
  return (x | (x >> 10)) & 0xFFFu;
}

__global__ void __launch_bounds__(kThreads)
    psk8_pack_kernel(const uint8_t* __restrict__ sec, const int* __restrict__ ksel, const int* __restrict__ r8,
                     uint8_t* __restrict__ out, int runs_per_capture) {
  const int b = blockIdx.y;
  const int run = blockIdx.x * kThreads + threadIdx.x;
  const bool live = run < runs_per_capture;
  const uint32_t add = (uint32_t)(8 - ksel[b]) * 0x01010101u;
  const int s = 3 * r8[b];
  const uint8_t* sc = sec + (long long)b * runs_per_capture * kRun;

  // This run's 96 stream bits, big-endian: w[0] bit 31 is its first bit.
  uint32_t w[kOutWords + 1] = {};
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(sc + (long long)run * kRun);
    const uint4 q0 = __ldg(src), q1 = __ldg(src + 1);
    const uint32_t x[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int o = 12 * e;  // from the stream's first bit
      const uint32_t v = gray12(x[e], add);
      if (o % 32 <= 20) {
        w[o / 32] |= v << (20 - o % 32);
      } else {
        w[o / 32] |= v >> (o % 32 - 20);
        w[o / 32 + 1] |= v << (52 - o % 32);
      }
    }
  }
  // The next run's first bits: the next lane's w[0], or a load for the
  // warp's last lane; none past the capture's end.
  const uint32_t from_next = __shfl_down_sync(0xffffffffu, w[0], 1);
  if (run + 1 < runs_per_capture) {
    if ((threadIdx.x & 31) == 31) {
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(sc + (long long)(run + 1) * kRun));
      w[kOutWords] = gray12(h.x, add) << 20 | gray12(h.y, add) << 8;  // its first 24 bits
    } else {
      w[kOutWords] = from_next;
    }
  }
  if (!live) return;
  unsigned* dst = reinterpret_cast<unsigned*>(out) + ((long long)b * runs_per_capture + run) * kOutWords;
#pragma unroll
  for (int j = 0; j < kOutWords; ++j)
    __stcs(dst + j, __byte_perm(__funnelshift_l(w[j + 1], w[j], s), 0, 0x0123));
}

}  // namespace

// sec: (n_captures, rows, 128) uint8, contiguous and 16-byte aligned; ksel,
// r8: (n_captures,) int32, 0 <= ksel < 8, 0 <= r8 < 8; out: (n_captures,
// rows*48) uint8, 4-byte aligned. Returns the cudaError_t of the launch.
extern "C" int amr_psk8_pack(const uint8_t* sec, const int* ksel, const int* r8, uint8_t* out, int n_captures,
                             int rows, void* stream) {
  if (n_captures < 1 || n_captures > 65535 || rows < 1 || reinterpret_cast<uintptr_t>(sec) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int runs_per_capture = rows * (128 / kRun);
  dim3 grid((unsigned)((runs_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  psk8_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(sec, ksel, r8, out, runs_per_capture);
  return (int)cudaGetLastError();
}
