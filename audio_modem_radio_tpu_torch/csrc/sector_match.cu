// K5: first validated frame-magic match for the 8 D8PSK pi/4-rotation
// hypotheses, on the Gray bit planes of received sectors.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py sector_match_batch
// (body _sector_match_kernel, conditions psk8_match_conditions).
//
// What it computes. For capture b and every symbol position pos below
// n_pos = rows_scanned*128 - (n_sym + 1), the received sector x = sec[pos + j]
// of each window symbol j < n_sym (10 for the 32-bit magic + validation, as
// full tribits) gives the Gray planes g2 = b2, g1 = b2 ^ b1, g0 = b1 ^ b0 of
// its bits (b2, b1, b0). Hypothesis k (channel rotation k*pi/4) expects one
// value of each plane at each window symbol; the expectations inside the
// 16-bit magic must all hold and the other 14 may miss at most `tol`.
// first[b, k] is the smallest such pos and found[b, k] is 1, or both are 0
// where no position matched. Positions at or past n_pos are never accepted
// (the JAX epilogue rejects them), so every window that counts lies inside
// the scanned prefix.
//
// What bounds it on the H100: integer instructions. Plane q of window symbol
// j is bit 3j + q of one 30-bit word, and each hypothesis is two (mask,
// value) pairs over it: the exact part ((w ^ v) & m) == 0, the loose part
// popc((w ^ v') & m') <= tol. The TPU version built 10 lane-rolled views of
// each plane and evaluated 8 x 30 conditions one XOR at a time.
//
// Design. The first design (one block per 256 positions, the planes staged a
// byte at a time, both popcounts and a warp reduction for every hypothesis
// at every position, a fill kernel before it and 3-4 PyTorch kernels after
// it) paid fixed costs at the 256-row tier and 8 warp reductions a position
// on the full scan. Here:
// * A thread owns 16 consecutive positions. It reads the 16 + n_sym - 1
//   sectors they need with two 16-byte loads of the capture's bytes (zeros
//   past the scanned prefix), turns 4 sectors at a time into their Gray
//   planes with a few logic operations, packs them 3 bits a sector into a
//   bit stream, and takes position i's window word with one funnel shift
//   from bit 3i (the masks ignore the bits past the window).
// * The exact part of a hypothesis holds at a random position with
//   probability 2^-16, so each position costs one masked compare a
//   hypothesis; only where some lane of the warp passed one (__any_sync,
//   rare) does the warp evaluate both parts of every hypothesis at its
//   positions and record a match with a shared atomicMin. A min does not
//   depend on the order of the atomics.
// * The hypotheses' masks travel as a kernel parameter, so they sit in the
//   constant bank and the compares read them from there.
// * A one-wave persistent grid, split over the captures, walks each
//   capture's positions in strides of kThreads*kPos; the capture's last
//   block reduces the blocks' minima (match_first.cuh, shared with K2). A
//   call is one launch, with no host read.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel sector_match, PERF.md section 6), K1's sectors of the 8PSK bench
// batch (64 captures of 13,312 rows): the kernel alone 0.013 ms at the
// 256-row tier, 0.039 at 1792 rows and 0.214 on the full scan (bound 0.078,
// integer operations), from 0.025, 0.162 and 1.205 (without the fill and
// the epilogue); first and found equal the first design's. 32 registers,
// no spills. The integer pipe binds: LOP3 and ISETP are most of the code.
// With the slow pass unrolled (its code then filled most of the kernel) the
// full scan took 12% longer, and 65% longer again at 32 positions a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_first.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPos = 16;     // positions a thread
constexpr int kMaxSym = 10;  // 3 * 10 = 30 window bits
constexpr int kMaxHyp = kMatchHyp;
constexpr int kBig = kMatchBig;
// A thread's sectors, [p0, p0 + kPos + kMaxSym - 1), as whole 16-byte chunks,
// and the 3-bit-a-sector stream they make.
constexpr int kChunks = (kPos + kMaxSym - 1 + 15) / 16;
constexpr int kWords = (12 * 4 * kChunks + 31) / 32;
static_assert(3 * (kPos - 1) + 3 * kMaxSym <= 32 * kWords, "the last window lies inside the stream");
static_assert(3 * (kPos - 1) / 32 + 1 < kWords, "the fast pass's funnel shifts stay in the stream");
static_assert(3 * (kPos - 1) < 64, "the slow pass shifts one of two 64-bit words");

// Per hypothesis [exact mask, exact value, loose mask, loose value]; bit
// 3j + q is Gray plane q (0: g2, 1: g1, 2: g0) of window symbol j.
struct Masks {
  unsigned v[kMaxHyp][4];
};

// Four sectors, one a byte, -> their Gray planes, plane q at bit q of each byte.
__device__ __forceinline__ uint32_t gray4(uint32_t x) {
  x &= 0x07070707u;
  const uint32_t y = x ^ ((x >> 1) & 0x03030303u);  // bit 0: g0, bit 1: g1, bit 2: g2
  return ((y >> 2) & 0x01010101u) | (y & 0x02020202u) | ((y & 0x01010101u) << 2);
}

// Four 3-bit bytes -> 12 bits, 3 a sector in stream order.
__device__ __forceinline__ uint32_t pack12(uint32_t g) {
  g = (g | (g >> 5)) & 0x003F003Fu;
  return (g | (g >> 10)) & 0xFFFu;
}

__global__ void __launch_bounds__(kThreads)
    sector_match_kernel(const uint8_t* __restrict__ sec, const __grid_constant__ Masks masks, int n_hyp,
                        int tol, int* __restrict__ first, uint8_t* __restrict__ found,
                        int* __restrict__ scratch, int* __restrict__ ticket, int per_capture, int n_iters,
                        long long sym_per_capture, long long scan_bytes, long long n_pos) {
  __shared__ int s_first[kMaxHyp];
  const int b = blockIdx.x / per_capture;
  const int blk = blockIdx.x % per_capture;
  if (threadIdx.x < kMaxHyp) s_first[threadIdx.x] = kBig;
  __syncthreads();

  const uint8_t* sc = sec + (long long)b * sym_per_capture;
  for (int it = blk; it < n_iters; it += per_capture) {
    const long long p0 = ((long long)it * kThreads + threadIdx.x) * kPos;
    uint32_t g[kWords] = {};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 q = match_chunk(sc, p0 + 16 * c, scan_bytes);
      const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 12 * (4 * c + e);  // bit offset of these 4 sectors in the stream
        const uint32_t v = pack12(gray4(w4[e]));
        g[o / 32] |= v << (o % 32);
        if (o % 32 > 20) g[o / 32 + 1] |= v >> (32 - o % 32);
      }
    }
    // Fast pass: the exact parts only.
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      const uint32_t w = __funnelshift_r(g[3 * i / 32], g[3 * i / 32 + 1], 3 * i % 32);
#pragma unroll
      for (int h = 0; h < kMaxHyp; ++h) any |= ((w ^ masks.v[h][1]) & masks.v[h][0]) == 0u;
    }
    if (__any_sync(0xffffffffu, any)) {
      // Rare: both parts of every hypothesis at each position, in a rolled
      // loop (unrolled, this pass would be most of the kernel's code).
      const uint64_t lo = g[0] | (uint64_t)g[1] << 32, hi = g[1] | (uint64_t)g[2] << 32;
#pragma unroll 1
      for (int i = 0; i < kPos; ++i) {
        const int at = 3 * i;
        const uint32_t w = (uint32_t)(at < 32 ? lo >> at : hi >> (at - 32));
        const long long pos = p0 + i;
#pragma unroll
        for (int h = 0; h < kMaxHyp; ++h) {
          if (h < n_hyp && ((w ^ masks.v[h][1]) & masks.v[h][0]) == 0u &&
              __popc((w ^ masks.v[h][3]) & masks.v[h][2]) <= tol && pos < n_pos)
            atomicMin(s_first + h, (int)pos);
        }
      }
    }
  }

  match_publish<kThreads>(s_first, n_hyp, first, found, scratch, ticket, b, blk, per_capture);
}

}  // namespace

// sec: (n_captures, rows, 128) uint8 received sectors, contiguous and 16-byte
// aligned. Scans the first rows_scanned rows of each capture: symbol
// positions [0, rows_scanned*128 - (n_sym + 1)). masks: HOST (n_hyp, 4)
// int32 [exact mask, exact value, loose mask, loose value]. first:
// (n_captures, n_hyp) int32 and found (n_captures, n_hyp) uint8 outputs.
// scratch: scratch_blocks * 8 int32; ticket: n_captures int32, zero before
// the call and zero after it. Returns the cudaError_t of the launch.
extern "C" int amr_sector_first(const uint8_t* sec, const int* masks, int n_hyp, int tol, int n_sym,
                                int* first, uint8_t* found, int* scratch, int scratch_blocks, int* ticket,
                                int n_captures, int rows, int rows_scanned, void* stream) {
  if (n_hyp < 1 || n_hyp > kMaxHyp || rows_scanned < 1 || rows_scanned > rows || n_sym < 1 ||
      n_sym > kMaxSym || n_captures < 1 || scratch_blocks < n_captures ||
      reinterpret_cast<uintptr_t>(sec) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Masks m;
  for (int h = 0; h < kMaxHyp; ++h)  // unused hypotheses repeat the first: the fast pass ORs them
    for (int e = 0; e < 4; ++e) m.v[h][e] = (unsigned)masks[4 * (h < n_hyp ? h : 0) + e];
  const long long n_pos = (long long)rows_scanned * 128 - (n_sym + 1);
  const int n_iters = n_pos > 0 ? (int)((n_pos + kThreads * kPos - 1) / (kThreads * kPos)) : 0;
  int per_capture = 1;
  const cudaError_t err = match_per_capture(sector_match_kernel, kThreads, n_captures, n_iters, scratch_blocks,
                                            &per_capture);
  if (err != cudaSuccess) return (int)err;
  sector_match_kernel<<<(unsigned)(per_capture * n_captures), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sec, m, n_hyp, tol, first, found, scratch, ticket, per_capture, n_iters, (long long)rows * 128,
      (long long)rows_scanned * 128, n_pos);
  return (int)cudaGetLastError();
}
