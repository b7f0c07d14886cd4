// K4: DBPSK stream select + complement + mod-8 bit alignment + byte pack.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py bit_select_pack_batch
// (variant "weights": _kernel_bit_select_pack_w with the per-shift tables of
// _shifted_pack_weights_bpsk).
//
// What it computes. For capture b with k = ksel[b] (bpsk_match_conditions
// order: 0 re, 1 im, 2 re inverted, 3 im inverted) and s8 = s[b] & 7, the bit
// stream is v = (k & 1) ? im : re, complemented when k >= 2, and output byte c
// of the capture is sum_{i<8} v[8c + s8 + i] * 2^(7 - i). Bits past the
// capture's end are zero, as in the plain version. The TPU kernel read the
// next capture's head there, so only bytes at or past n_valid =
// (R*128 - s8) / 8 can differ from it: those are garbage by contract.
//
// What bounds it on the H100: device memory. Per stream bit it reads 1 B (the
// selected lane of the two; the TPU kernel read both) and writes 1/8 B, with a
// few integer operations (bound 0.037 ms for 64 captures of 13,312 rows).
// The TPU version assembled bytes as MXU matmuls against per-shift weight
// tables; on CUDA cores the shift is a register shift, so no tables exist.
//
// Design. The first design ran a thread per output byte with eight byte
// loads and reached 33-54% of the bound. Here a thread owns a run of kRun =
// 64 stream bits, 8 output bytes:
// * four 16-byte loads of the selected lane only;
// * each 32-bit word of 4 bits is compacted by one multiply to 4 stream
//   bits, MSB first; two words make a byte and three byte permutes gather
//   32 bits into one big-endian stream word, complemented by an XOR with a
//   mask of 0 or ~0 fixed per capture;
// * the shift by s8 bits takes the next run's first word, by a shuffle from
//   the next lane, or for the warp's last lane from one 8-byte load; zero
//   past the capture's end;
// * a funnel shift and a byte swap a word, one 8-byte streaming store. No
//   division.
// Decisions are 0 or 1 (K1's output): only bit 0 of a byte is read.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel bit_select_pack, PERF.md section 6), K1's BPSK lanes of the
// bench batch at every (ksel, s8): the kernel alone 0.042 ms (87% of the
// bound), from 0.067; every byte equal to the first design's. 28
// registers, no spills. 128 bits a thread (one 16-byte store) took
// 0.049 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 64;            // stream bits a thread
constexpr int kWords = kRun / 32;   // big-endian stream words of a run, 8 bytes out

// The stream bits of 4 bytes (little-endian: the first in the low byte), MSB
// first in bits 31..28. The multiply moves byte a's bit to bit 31 - a; its
// other copies land in disjoint bits below 28 or past 31, so nothing carries.
__device__ __forceinline__ uint32_t bits4(uint32_t x) { return (x & 0x01010101u) * 0x80402010u; }

// 8 bytes -> their 8 stream bits, MSB first in bits 31..24.
__device__ __forceinline__ uint32_t bits8(uint32_t x0, uint32_t x1) {
  return (bits4(x0) & 0xF0000000u) | ((bits4(x1) >> 4) & 0x0F000000u);
}

// 32 bytes -> 32 stream bits, the first in bit 31.
__device__ __forceinline__ uint32_t stream32(uint4 a, uint4 b) {
  const uint32_t p = __byte_perm(bits8(a.x, a.y), bits8(a.z, a.w), 0x3700);
  const uint32_t q = __byte_perm(bits8(b.x, b.y), bits8(b.z, b.w), 0x3700);
  return __byte_perm(p, q, 0x3276);
}

__global__ void __launch_bounds__(kThreads)
    bit_select_pack_kernel(const uint8_t* __restrict__ re, const uint8_t* __restrict__ im,
                           const int* __restrict__ s, const int* __restrict__ ksel,
                           uint8_t* __restrict__ out, int runs_per_capture) {
  const int b = blockIdx.y;
  const int run = blockIdx.x * kThreads + threadIdx.x;
  const bool live = run < runs_per_capture;
  const int k = ksel[b];
  const int s8 = s[b] & 7;
  const uint8_t* v = (k & 1 ? im : re) + (long long)b * runs_per_capture * kRun;
  const uint32_t flip = k >= 2 ? 0xFFFFFFFFu : 0u;

  // This run's kRun stream bits, big-endian: w[0] bit 31 is its first bit.
  uint32_t w[kWords + 1] = {};
  if (live) {
    const uint4* src = reinterpret_cast<const uint4*>(v + (long long)run * kRun);
    uint4 q[2 * kWords];
#pragma unroll
    for (int j = 0; j < 2 * kWords; ++j) q[j] = __ldg(src + j);
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[j] = stream32(q[2 * j], q[2 * j + 1]) ^ flip;
  }
  // The next run's first bits: the next lane's w[0], or a load for the
  // warp's last lane; none past the capture's end.
  const uint32_t from_next = __shfl_down_sync(0xffffffffu, w[0], 1);
  if (run + 1 < runs_per_capture) {
    if ((threadIdx.x & 31) == 31) {
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(v + (long long)(run + 1) * kRun));
      w[kWords] = (bits8(h.x, h.y) ^ flip) & 0xFF000000u;  // its first 8 bits
    } else {
      w[kWords] = from_next;
    }
  }
  if (!live) return;
  uint32_t o[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) o[j] = __byte_perm(__funnelshift_l(w[j + 1], w[j], s8), 0, 0x0123);
  __stcs(reinterpret_cast<uint2*>(out) + (long long)b * runs_per_capture + run, make_uint2(o[0], o[1]));
}

}  // namespace

// re/im: (n_captures, rows, 128) uint8 sign-bit lanes, contiguous and 16-byte
// aligned; s, ksel: (n_captures,) int32; out: (n_captures, rows*16) uint8,
// 8-byte aligned. Returns the cudaError_t of the launch.
extern "C" int amr_bit_select_pack(const uint8_t* re, const uint8_t* im, const int* s,
                                   const int* ksel, uint8_t* out, int n_captures, int rows,
                                   void* stream) {
  if (n_captures < 1 || n_captures > 65535 || rows < 1 || reinterpret_cast<uintptr_t>(re) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(im) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int runs_per_capture = rows * (128 / kRun);
  dim3 grid((unsigned)((runs_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  bit_select_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(re, im, s, ksel, out,
                                                                                     runs_per_capture);
  return (int)cudaGetLastError();
}
