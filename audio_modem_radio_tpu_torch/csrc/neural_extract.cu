// K10: NEURAL chip extraction + unrotation + codebook scores + argmax.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py neural_extract_batch
// (body _kernel_neural_extract).
//
// What it computes. Capture b is R rows of 128 samples; row j and its
// successor (row j+1, and row 0 after the last: the circular wrap of the JAX
// package's XLA extraction) form a 256-sample pair with lanes L = 0..255. The
// fs/4 downconversion is zr = x * {1, 0, -1, 0}[L % 4], zi = x * {0, -1, 0, 1}[L % 4].
// With s = k0 % 128 the capture's in-row offset, chip c (0..63) of row j is
// the mean of lanes s+2c and s+2c+1 for re and for im; unrotated by the
// capture's unit phasor (a, b) as re' = a*re + b*im, im' = a*im - b*re. Slot m
// (0..7) of row j scores codeword w with
//     sum_{c<8} re'[8m+c] * cb[w][c] + im'[8m+c] * cb[w][8+c],
// and symbol 8j+m is the first w with the largest score, written as one byte.
//
// What bounds it on the H100: operations. Per symbol it reads 16 samples
// (64 B as float32) and writes 1 B, against 256 x 16 FMAs of scoring: about
// 130 flop/B, above the card's ~20 flop/B float32 ridge (67 TFLOP/s over
// 3.35 TB/s, published H100 SXM peaks). At 64 x 2^24 samples that is 2^26
// symbols, about 5.7e11 operations, 8.6 ms at 67 TFLOP/s. The first-maximum
// argmax costs a compare and two selects per codeword and symbol beside the
// 16 FFMA, each an issue slot of the FMA pipe's rate, so the scoring loop can
// reach at most 16/19 of the FFMA rate.
//
// Design: the TPU kernel runs all of this as dense block-diagonal matmuls
// (chip projections, a rotation dot, a 15/16-zero scorer, one-hot index dots);
// here each thread owns kSyms = 8 symbols (kThreads apart, so a warp's loads
// and byte stores stay on neighbouring symbols), computes their 16 chips in
// registers from the 16 samples each reads (they may span rows j and j+1),
// unrotates them, and loops over the 256 codewords: one codeword's four
// 16-byte shared-memory loads (a broadcast: every thread of a block reads the
// same codeword), issued a codeword ahead, feed 16 * 8 FMAs, c outside and
// the symbols inside, so each score is still summed over c = 0..15 in order
// and consecutive FMAs share the codeword's register. Each score then updates
// its symbol's running maximum and first index. A thread that owned one
// symbol issued a shared load per 4 FMAs, and the shared-memory pipe, not the
// FMA pipe, set its pace. The 8 symbols' chips take 128 registers, so a block
// of 256 threads fills a multiprocessor; blocks stride over the batch, and
// the codebook is staged once per block. The chips and the unrotation use
// round-to-nearest products and sums in the plain version's order, so only
// the 16-term scores can round differently from the plain PyTorch version,
// and every symbol equals the first (one symbol a thread) kernel's.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 6
// and profile_slice.py, PERF.md): 14.6 ms at 64 x 2^24 float32 samples, 59%
// of the 8.6 ms bound (the one-symbol kernel: 21.2 ms, 41%). The scoring
// loop is 80% FFMA (256 FFMA, 47 compare-and-select, 8 LDS.128 for two
// codewords, sass_stats.py), 198 registers, no spills. What holds it there:
// the 3 argmax instructions a score, and register-bank conflicts among the
// FMAs' register operands (a quarter of the FFMA read two fresh registers of
// one bank).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSyms = 8;  // symbols a thread scores against each codeword
constexpr int kBlocksPerSm = 1;
constexpr int kCodewords = 256;
constexpr int kDim = 16;  // [re 0..7 | im 0..7]
constexpr int kSpr = 8;   // symbols per 128-sample row

__device__ __forceinline__ float mask_re(int lane) {
  const int m = lane & 3;
  return m == 0 ? 1.f : (m == 2 ? -1.f : 0.f);
}

__device__ __forceinline__ float mask_im(int lane) {
  const int m = lane & 3;
  return m == 1 ? -1.f : (m == 3 ? 1.f : 0.f);
}

// The 16 unrotated chips [re 0..7 | im 0..7] of symbol g.
template <typename T>
__device__ __forceinline__ void chips(const T* __restrict__ x, const float* __restrict__ phasors,
                                      const int* __restrict__ s_off, long long g, long long rows,
                                      float (&v)[kDim]) {
  const long long sym_per_capture = rows * kSpr;
  const long long n_capture = rows * 128;
  const long long b = g / sym_per_capture;
  const long long i = g - b * sym_per_capture;
  const long long row0 = (i / kSpr) * 128;
  const int l0 = (s_off[b] & 127) + 16 * (int)(i % kSpr);  // first lane of the pair
  const float a = phasors[2 * b], c = phasors[2 * b + 1];
  const T* xc = x + b * n_capture;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int l = l0 + 2 * k;
    long long p0 = row0 + l;
    if (p0 >= n_capture) p0 -= n_capture;  // the last row's successor is row 0
    long long p1 = p0 + 1;
    if (p1 >= n_capture) p1 -= n_capture;
    const float x0 = static_cast<float>(xc[p0]);
    const float x1 = static_cast<float>(xc[p1]);
    const float re = __fmul_rn(__fadd_rn(__fmul_rn(x0, mask_re(l)), __fmul_rn(x1, mask_re(l + 1))), 0.5f);
    const float im = __fmul_rn(__fadd_rn(__fmul_rn(x0, mask_im(l)), __fmul_rn(x1, mask_im(l + 1))), 0.5f);
    v[k] = __fadd_rn(__fmul_rn(re, a), __fmul_rn(im, c));
    v[8 + k] = __fsub_rn(__fmul_rn(im, a), __fmul_rn(re, c));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    neural_extract_kernel(const T* __restrict__ x, const float* __restrict__ codebook,
                          const float* __restrict__ phasors, const int* __restrict__ s_off,
                          uint8_t* __restrict__ out, long long rows, long long n_sym) {
  __shared__ float4 cbs[kCodewords * kDim / 4];
  float* cbf = reinterpret_cast<float*>(cbs);
  for (int i = threadIdx.x; i < kCodewords * kDim; i += blockDim.x) cbf[i] = codebook[i];
  __syncthreads();

  constexpr long long kPerBlock = (long long)kThreads * kSyms;
  for (long long base = (long long)blockIdx.x * kPerBlock; base < n_sym; base += (long long)gridDim.x * kPerBlock) {
    float v[kSyms][kDim];
#pragma unroll
    for (int u = 0; u < kSyms; ++u) {
      const long long g = base + threadIdx.x + u * kThreads;
      if (g < n_sym) {
        chips(x, phasors, s_off, g, rows, v[u]);
      } else {
#pragma unroll
        for (int c = 0; c < kDim; ++c) v[u][c] = 0.f;
      }
    }

    float best[kSyms];
    int arg[kSyms];
#pragma unroll
    for (int u = 0; u < kSyms; ++u) {
      best[u] = __int_as_float(0xff800000);  // -inf
      arg[u] = 0;
    }
    float4 n0 = cbs[0], n1 = cbs[1], n2 = cbs[2], n3 = cbs[3];  // the next codeword
#pragma unroll 2
    for (int w = 0; w < kCodewords; ++w) {
      const float e[kDim] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w,
                             n2.x, n2.y, n2.z, n2.w, n3.x, n3.y, n3.z, n3.w};
      const float4* q = cbs + ((w + 1) & (kCodewords - 1)) * (kDim / 4);  // the last loads codeword 0 again
      n0 = q[0];
      n1 = q[1];
      n2 = q[2];
      n3 = q[3];
      float acc[kSyms];
#pragma unroll
      for (int u = 0; u < kSyms; ++u) acc[u] = 0.f;
#pragma unroll
      for (int c = 0; c < kDim; ++c) {
#pragma unroll
        for (int u = 0; u < kSyms; ++u) acc[u] = fmaf(v[u][c], e[c], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kSyms; ++u) {
        if (acc[u] > best[u]) {  // strictly greater: the first maximum wins
          best[u] = acc[u];
          arg[u] = w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSyms; ++u) {
      const long long g = base + threadIdx.x + u * kThreads;
      if (g < n_sym) out[g] = static_cast<uint8_t>(arg[u]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* codebook, const float* phasors, const int* s, uint8_t* out,
           long long n_sym, long long rows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)kThreads * kSyms;
  const long long need = (n_sym + per_block - 1) / per_block;
  const long long cap = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  neural_extract_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), codebook, phasors, s,
                                                             out, rows, n_sym);
  return (int)cudaGetLastError();
}

}  // namespace

// K10. dtype: 0 = float32, 1 = int16. x is (n_captures * rows, 128)
// contiguous; codebook (256, 16) float32; phasors (n_captures, 2) float32;
// s (n_captures,) int32, taken mod 128; out (n_captures, rows * 8) uint8.
// Returns the cudaError_t of the launch.
extern "C" int amr_neural_extract(const void* x, int dtype, const float* codebook, const float* phasors,
                                  const int* s, uint8_t* out, int n_captures, int rows, void* stream) {
  if (n_captures < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const long long n_sym = (long long)n_captures * rows * kSpr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, codebook, phasors, s, out, n_sym, rows, st);
    case 1:
      return launch<int16_t>(x, codebook, phasors, s, out, n_sym, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
