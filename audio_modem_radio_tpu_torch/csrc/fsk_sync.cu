// The batched FSK sync tail: the first exact magic in each capture's bit
// stream, then the stream packed into bytes from there.
//
// Replaces no TPU kernel: the JAX package runs this tail as plain XLA
// (audio_modem_radio_tpu/ops/common.py find_bit_pattern :52, pack_bits_from
// :150). The port's plain version (ops/common.py, the same two functions)
// runs 16 strided compares and 16 ANDs over the batch, an argmax, a padded
// copy of the stream, a host read of the starts and one slice a capture.
//
// What it computes, for bits (B, n) uint8 and a literal pattern of L <= 32
// bits (bit t of the pattern word is pattern[t]), with length = n - L + 1:
// * amr_fsk_first: first[b] = min(first[b], the least p < length with
//   bits[b, p + t] == pattern[t] for every t < L). The wrapper fills first
//   with length beforehand, so first[b] < length exactly where the pattern
//   occurs (never in a row shorter than the pattern, where length <= 0);
// * amr_fsk_pack: s = first[b] < length ? first[b] : 0; byte j of packed row
//   b holds bits[b, s + 8j .. s + 8j + 7] MSB first, zero at or past n, for
//   j < n_out = ceil(n / 1024) * 128; n_valid[b] = (n - s) / 8 and found[b]
//   = first[b] < length.
// That is find_bit_pattern followed by pack_bits_from, bit for bit. The
// bits are 0 or 1 (K9's `margin > 0` and the other FSK decisions): only
// bit 0 of a byte is read.
//
// What bounds it on the H100: device memory. The scan reads the B*n bytes,
// the pack reads them once more and writes B*n_out: for 64 captures of
// 3,355,443 bits (FSK19200 at 2^24 samples) 429.5 MB read and 26.8 MB
// written, 0.136 ms at 3.35 TB/s.
//
// Design.
// * The scan walks the batch as one flat byte stream, so a row needs no
//   alignment and any n costs the same. A thread takes 32 positions: two
//   16-byte loads become a 32-bit mask (one multiply a 4-byte word), the
//   next 32 bits come from the next lane by a shuffle (the warp's last lane
//   loads them), and the pattern is tested at all 32 positions at once, an
//   AND over t of the mask shifted by t, complemented where pattern[t] is 0.
//   A hit's row comes from a division (hits are rare: the magic itself and
//   about one random hit in 2^16 bits); it counts where its row position is
//   below length, so a window that runs into the next row never counts, and
//   a thread posts only its first hit in each row, by atomicMin. A min does
//   not depend on the order of the atomics, so the result is deterministic.
//   The scan is not tiered: a full pass takes less than a tier's host read.
// * The pack reads each row's start from device memory: no host read. A
//   thread writes 16 bytes, the 128 bits from s + 128k of its row: nine
//   aligned 16-byte loads around them become 144 mask bits, a funnel shift
//   aligns them, bits at or past n are cleared, and a bit reverse and a byte
//   swap a word give the MSB-first bytes for one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 32;  // positions a scanning thread tests

// Four 0/1 bytes (the first in the low byte) -> 4 bits, the first in bit 0.
// The multiply moves byte i's bit 0 to bit 28 + i; its other copies land in
// distinct bits below 28 or past 31, so nothing carries.
__device__ __forceinline__ uint32_t bits4(uint32_t w) { return ((w & 0x01010101u) * 0x10204080u) >> 28; }

// The 16 bytes at flat byte `at` (a multiple of 16) as a mask, bit i for
// byte at + i; zeros at or past `total`.
__device__ __forceinline__ uint32_t mask16(const uint8_t* __restrict__ bits, long long at, long long total) {
  if (at + 16 <= total) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(bits + at));
    return bits4(q.x) | bits4(q.y) << 4 | bits4(q.z) << 8 | bits4(q.w) << 12;
  }
  uint32_t m = 0;
  for (int i = 0; i < 16 && at + i < total; ++i) m |= (uint32_t)(bits[at + i] & 1) << i;
  return m;
}

__device__ __forceinline__ uint32_t mask32(const uint8_t* __restrict__ bits, long long at, long long total) {
  return mask16(bits, at, total) | mask16(bits, at + 16, total) << 16;
}

__global__ void __launch_bounds__(kThreads)
    fsk_first_kernel(const uint8_t* __restrict__ bits, long long total, int n, int length, uint32_t pattern,
                     int pattern_len, int* __restrict__ first) {
  const long long at = ((long long)blockIdx.x * kThreads + threadIdx.x) * kSpan;
  const uint32_t own = mask32(bits, at, total);
  uint32_t next = __shfl_down_sync(0xffffffffu, own, 1);
  if ((threadIdx.x & 31) == 31) next = mask32(bits, at + kSpan, total);
  if (at >= total) return;
  // Bit i of hit: the pattern starts at flat position at + i.
  uint32_t hit = 0xffffffffu;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (t < pattern_len) {
      const uint32_t x = __funnelshift_r(own, next, t);
      hit &= (pattern >> t & 1u) ? x : ~x;
    }
  }
  long long posted = -1;  // the row this thread has posted its first hit in
  while (hit) {
    const long long f = at + (__ffs(hit) - 1);
    hit &= hit - 1;
    if (f >= total) break;
    const long long row = f / n;
    const long long p = f - row * n;
    if (row != posted && p < length) {
      atomicMin(first + row, (int)p);
      posted = row;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fsk_pack_kernel(const uint8_t* __restrict__ bits, long long total, int n, int length,
                    const int* __restrict__ first, uint8_t* __restrict__ packed, int* __restrict__ n_valid,
                    uint8_t* __restrict__ found, int n_out) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;  // output bytes 16k .. 16k + 15
  const int f = first[b];
  const bool hit = f < length;
  const int s = hit ? f : 0;
  if (k == 0) {
    n_valid[b] = (n - s) / 8;
    found[b] = hit;
  }
  if (16LL * k >= n_out) return;
  const long long q0 = (long long)s + 128LL * k;  // the row position of this thread's first bit
  const long long left = n - q0;                  // row bits from there
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (left > 0) {
    const long long a = (long long)b * n + q0;
    const long long a0 = a & ~15LL;
    const int off = (int)(a - a0);
    uint32_t m[5];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = mask32(bits, a0 + 32 * j, total);
    m[4] = mask16(bits, a0 + 128, total);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x = __funnelshift_r(m[j], m[j + 1], off);  // bit i: row position q0 + 32j + i
      if (left <= 32 * j) {
        x = 0u;
      } else if (left < 32 * (j + 1)) {
        x &= (1u << (left - 32 * j)) - 1u;
      }
      w[j] = __byte_perm(__brev(x), 0, 0x0123);  // MSB first within each byte, bytes in order
    }
  }
  reinterpret_cast<uint4*>(packed + (long long)b * n_out)[k] = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

// bits: (n_rows, n) uint8, contiguous and 16-byte aligned; first: (n_rows,)
// int32 holding n - pattern_len + 1 (the wrapper's fill). Posts each row's
// first match; launches nothing where no position can match. Returns the
// cudaError_t of the launch.
extern "C" int amr_fsk_first(const uint8_t* bits, int n_rows, int n, unsigned pattern, int pattern_len, int* first,
                             void* stream) {
  if (n_rows < 1 || n < 0 || pattern_len < 1 || pattern_len > 32 || reinterpret_cast<uintptr_t>(bits) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_rows * n;
  const int length = n - pattern_len + 1;
  if (length <= 0) return (int)cudaSuccess;
  const long long blocks = (total + (long long)kThreads * kSpan - 1) / ((long long)kThreads * kSpan);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fsk_first_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bits, total, n, length, (uint32_t)pattern, pattern_len, first);
  return (int)cudaGetLastError();
}

// bits as for amr_fsk_first; first: its output; packed: (n_rows,
// ceil(n / 1024) * 128) uint8, 16-byte aligned; n_valid: (n_rows,) int32;
// found: (n_rows,) bool. Returns the cudaError_t of the launch.
extern "C" int amr_fsk_pack(const uint8_t* bits, int n_rows, int n, int pattern_len, const int* first,
                            uint8_t* packed, int* n_valid, uint8_t* found, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || n < 0 || pattern_len < 1 || pattern_len > 32 ||
      reinterpret_cast<uintptr_t>(bits) % 16 != 0 || reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_out = ((long long)n + 1023) / 1024 * 128;
  const long long per_row = (n_out / 16 + kThreads - 1) / kThreads;
  dim3 grid((unsigned)(per_row > 0 ? per_row : 1), (unsigned)n_rows);
  fsk_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bits, (long long)n_rows * n, n, n - pattern_len + 1, first, packed, n_valid, found, (int)n_out);
  return (int)cudaGetLastError();
}
