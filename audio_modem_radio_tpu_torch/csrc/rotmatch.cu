// K2: first validated frame-magic match for the 8 DQPSK rotation x parity
// hypotheses, or the 4 DBPSK stream x inversion hypotheses.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py rotation_match_batch
// (body _rotmatch_kernel, family "qpsk" with rotation_match_conditions and
// family "bpsk" with bpsk_match_conditions).
//
// What it computes. For capture b and every position pos below
// n_pos = rows_scanned*128 - (n_pat + 1) (dibits for "qpsk", bits for
// "bpsk"), each hypothesis h holds a set of conditions
// "(hi or lo)[pos + off] == bit", off in 0..31: 0..16 for "qpsk" (two
// streams, 16 dibits plus the odd parity's one), 0..31 for "bpsk" (one
// stream, 32 bits). The first 16 conditions (the 16-bit magic, at offsets
// 0..15) must all hold and the next 16 (the validating follow-up) may miss
// at most `tol`. first[b, h] is the smallest such pos and found[b, h] is 1,
// or both are 0 where no position matched. Positions at or past n_pos are
// never accepted (the JAX epilogue rejects them); entries past the scanned
// prefix read as 0, as in the plain version.
//
// What bounds it on the H100: the integer pipe. hi and lo interleave into
// one bit stream, bit 2j = hi[j] & 1 and bit 2j + 1 = lo[j] & 1, so the
// window of a position is two 32-bit words, W0 over offsets 0..15 and W1
// over 16..31, and each hypothesis is a (mask, value) pair over W0 for the
// exact part, (W0 & mask) == value, and two over W0 and W1 for the tolerant
// part, popc((W0 ^ v0) & m0) + popc((W1 ^ v1) & m1) <= tol. The TPU version
// built 9 lane-rolled copies of each stream per tile and evaluated 256
// conditions one XOR at a time.
//
// Design (K5's, sector_match.cu). The first design (a block per 256
// positions, the windows rebuilt a bit at a time from shared bytes, 4
// popcounts and a warp reduction for every hypothesis at every position, a
// fill kernel before it and 3-4 PyTorch kernels after it) paid fixed costs
// at the 256-row tier and a reduction a hypothesis a position on the full
// scan. Here:
// * A thread owns kPos consecutive positions. It reads the hi and lo bytes
//   its exact parts need with 16-byte loads (zeros past the scanned prefix),
//   compacts 4 dibits at a time into 8 stream bits with one multiply, and
//   takes each position's W0 with one funnel shift.
// * The exact part of a hypothesis holds at a random position with
//   probability 2^-16, so each position costs one funnel shift and two
//   instructions a hypothesis (kHyp: 8 for "qpsk", 4 for "bpsk"). Only where
//   some lane of the warp passed one (__any_sync, rare) does the warp load
//   the rest of its window, evaluate both parts of every hypothesis at its
//   positions in a rolled loop, and record a match with a shared atomicMin.
// * The hypotheses' masks travel as a kernel parameter (the constant bank).
// * A one-wave persistent grid, split over the captures; the capture's last
//   block reduces the blocks' minima, writes first and found and resets its
//   ticket (match_first.cuh, shared with K5). A call is one launch, with no
//   fill, no epilogue and no host read.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel rotation_match, PERF.md section 6), K1's lanes of the QPSK and
// BPSK bench batches (64 captures of 13,312 rows): the kernel alone 0.0115
// ms (qpsk) and 0.0080 (bpsk) at the 256-row tier, 0.040 and 0.022 at 1792
// rows, 0.181 and 0.104 on the full scan, from 0.039, 0.042, 0.255, 0.276,
// 1.88 and 2.03 with the fill; first and found equal the first design's at
// every tier, with and without a noise capture. 32 registers, no spills.
// At 32 positions a thread (a third word in the fast pass, a fourth in the
// slow one) it took 6-41% longer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_first.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPos = 16;  // positions a thread
// A thread's dibits as 16-byte chunks of hi and lo, one 32-bit stream word
// each: the fast pass needs [p0, p0 + kPos + 15), two words, the slow pass
// [p0, p0 + kPos + 31), three.
constexpr int kFast = 2, kWords = 3;
static_assert(kPos + 15 <= 16 * kFast && kPos + 31 <= 16 * kWords, "a thread's windows lie in its words");

// Per hypothesis [exact mask, exact value] over W0, then [tolerant mask,
// tolerant value] over W0 and over W1.
struct Masks {
  unsigned v[kMatchHyp][6];
};

// 16 hi and 16 lo decision bytes (bit 0 of each) -> 32 stream bits,
// hi[j] at bit 2j and lo[j] at bit 2j + 1.
__device__ __forceinline__ uint32_t interleave16(uint4 h, uint4 l) {
  const uint32_t hw[4] = {h.x, h.y, h.z, h.w}, lw[4] = {l.x, l.y, l.z, l.w};
  uint32_t p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // One 2-bit field a byte; the multiply moves field a to bits 24 + 2a
    // (shifts 24, 18, 12, 6) and the fields' other copies land in disjoint
    // bits below 24 or past 31, so nothing carries.
    const uint32_t x = (hw[e] & 0x01010101u) | ((lw[e] & 0x01010101u) << 1);
    p[e] = x * 0x01041040u;
  }
  return __byte_perm(__byte_perm(p[0], p[1], 0x73), __byte_perm(p[2], p[3], 0x73), 0x5410);
}

template <int kHyp>
__global__ void __launch_bounds__(kThreads)
    rotmatch_kernel(const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                    const __grid_constant__ Masks masks, int tol, int* __restrict__ first,
                    uint8_t* __restrict__ found, int* __restrict__ scratch, int* __restrict__ ticket,
                    int per_capture, int n_iters, long long dib_per_capture, long long scan_dibs, long long n_pos) {
  __shared__ int s_first[kMatchHyp];
  const int b = blockIdx.x / per_capture;
  const int blk = blockIdx.x % per_capture;
  if (threadIdx.x < kMatchHyp) s_first[threadIdx.x] = kMatchBig;
  __syncthreads();

  const uint8_t* hc = hi + (long long)b * dib_per_capture;
  const uint8_t* lc = lo + (long long)b * dib_per_capture;
  for (int it = blk; it < n_iters; it += per_capture) {
    const long long p0 = ((long long)it * kThreads + threadIdx.x) * kPos;
    uint32_t g[kWords];
#pragma unroll
    for (int c = 0; c < kFast; ++c)
      g[c] = interleave16(match_chunk(hc, p0 + 16 * c, scan_dibs), match_chunk(lc, p0 + 16 * c, scan_dibs));
    // Fast pass: the exact parts only.
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      const uint32_t w = __funnelshift_r(g[0], g[1], 2 * i);
#pragma unroll
      for (int h = 0; h < kHyp; ++h) any |= (w & masks.v[h][0]) == masks.v[h][1];
    }
    if (__any_sync(0xffffffffu, any)) {
      // Rare: the rest of the window, then both parts of every hypothesis
      // at each position, in a rolled loop (K5's unrolled one cost 12%).
      g[2] = interleave16(match_chunk(hc, p0 + 32, scan_dibs), match_chunk(lc, p0 + 32, scan_dibs));
      const uint64_t q0 = g[0] | (uint64_t)g[1] << 32, q1 = g[1] | (uint64_t)g[2] << 32;
#pragma unroll 1
      for (int i = 0; i < kPos; ++i) {
        const uint32_t w0 = (uint32_t)(q0 >> 2 * i), w1 = (uint32_t)(q1 >> 2 * i);
        const long long pos = p0 + i;
#pragma unroll
        for (int h = 0; h < kHyp; ++h) {
          const unsigned* m = masks.v[h];
          if ((w0 & m[0]) == m[1] && __popc((w0 ^ m[3]) & m[2]) + __popc((w1 ^ m[5]) & m[4]) <= tol &&
              pos < n_pos)
            atomicMin(s_first + h, (int)pos);
        }
      }
    }
  }

  match_publish<kThreads>(s_first, kHyp, first, found, scratch, ticket, b, blk, per_capture);
}

template <int kHyp>
int launch(const uint8_t* hi, const uint8_t* lo, const Masks& m, int tol, int* first, uint8_t* found, int* scratch,
           int scratch_blocks, int* ticket, int n_captures, int rows, int rows_scanned, long long n_pos,
           cudaStream_t st) {
  const int n_iters = n_pos > 0 ? (int)((n_pos + kThreads * kPos - 1) / (kThreads * kPos)) : 0;
  int per_capture = 1;
  const cudaError_t err =
      match_per_capture(rotmatch_kernel<kHyp>, kThreads, n_captures, n_iters, scratch_blocks, &per_capture);
  if (err != cudaSuccess) return (int)err;
  rotmatch_kernel<kHyp><<<(unsigned)(per_capture * n_captures), kThreads, 0, st>>>(
      hi, lo, m, tol, first, found, scratch, ticket, per_capture, n_iters, (long long)rows * 128,
      (long long)rows_scanned * 128, n_pos);
  return (int)cudaGetLastError();
}

}  // namespace

// hi/lo: (n_captures, rows, 128) uint8 decision lanes, contiguous and
// 16-byte aligned. Scans the first rows_scanned rows of each capture:
// positions [0, rows_scanned*128 - (n_pat + 1)). masks: HOST (n_hyp, 6)
// int32, n_hyp 4 or 8: [exact mask, exact value] over W0, [tolerant mask,
// tolerant value] over W0 and over W1 (each value inside its mask). first:
// (n_captures, n_hyp) int32 and found (n_captures, n_hyp) uint8 outputs.
// scratch: scratch_blocks * 8 int32; ticket: n_captures int32, zero before
// the call and zero after it. Returns the cudaError_t of the launch.
extern "C" int amr_rotation_first(const uint8_t* hi, const uint8_t* lo, const int* masks, int n_hyp, int tol,
                                  int n_pat, int* first, uint8_t* found, int* scratch, int scratch_blocks,
                                  int* ticket, int n_captures, int rows, int rows_scanned, void* stream) {
  if ((n_hyp != 4 && n_hyp != 8) || rows_scanned < 1 || rows_scanned > rows || n_pat < 1 || n_captures < 1 ||
      scratch_blocks < n_captures || reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Masks m = {};
  for (int h = 0; h < n_hyp; ++h)
    for (int e = 0; e < 6; ++e) m.v[h][e] = (unsigned)masks[6 * h + e];
  const long long n_pos = (long long)rows_scanned * 128 - (n_pat + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n_hyp == 8 ? launch<8>(hi, lo, m, tol, first, found, scratch, scratch_blocks, ticket, n_captures, rows,
                                rows_scanned, n_pos, st)
                    : launch<4>(hi, lo, m, tol, first, found, scratch, scratch_blocks, ticket, n_captures, rows,
                                rows_scanned, n_pos, st);
}
