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
// symbols, about 5.7e11 operations, 8.6 ms at 67 TFLOP/s.
//
// Design: the TPU kernel runs all of this as dense block-diagonal matmuls
// (chip projections, a rotation dot, a 15/16-zero scorer, one-hot index dots);
// here one thread owns one symbol and computes its 16 chips in registers from
// the 16 samples it reads (they may span rows j and j+1), unrotates them, and
// loops over the 256 codewords with 16 FMAs each in the order c = 0..15,
// keeping the running maximum and its first index. The (256, 16) codebook
// (16 KB) sits in shared memory; every thread of a warp reads the same
// codeword, a broadcast. Blocks stride over the batch, a few per SM, so the
// codebook is staged once per block. The chips and the unrotation use
// round-to-nearest products and sums in the plain version's order, so only
// the 16-term scores can round differently from the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    neural_extract_kernel(const T* __restrict__ x, const float* __restrict__ codebook,
                          const float* __restrict__ phasors, const int* __restrict__ s_off,
                          uint8_t* __restrict__ out, long long rows, long long n_sym) {
  __shared__ float4 cbs[kCodewords * kDim / 4];
  float* cbf = reinterpret_cast<float*>(cbs);
  for (int i = threadIdx.x; i < kCodewords * kDim; i += blockDim.x) cbf[i] = codebook[i];
  __syncthreads();

  const long long sym_per_capture = rows * kSpr;
  const long long n_capture = rows * 128;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n_sym; g += stride) {
    const long long b = g / sym_per_capture;
    const long long i = g - b * sym_per_capture;
    const long long row0 = (i / kSpr) * 128;
    const int l0 = (s_off[b] & 127) + 16 * (int)(i % kSpr);  // first lane of the pair
    const float a = phasors[2 * b], c = phasors[2 * b + 1];
    const T* xc = x + b * n_capture;

    float v[kDim];  // unrotated chips [re 0..7 | im 0..7]
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

    float best = __int_as_float(0xff800000);  // -inf
    int arg = 0;
#pragma unroll 2
    for (int w = 0; w < kCodewords; ++w) {
      const float4* q = cbs + w * (kDim / 4);
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kDim / 4; ++t) {
        const float4 e = q[t];
        acc = fmaf(v[4 * t], e.x, acc);
        acc = fmaf(v[4 * t + 1], e.y, acc);
        acc = fmaf(v[4 * t + 2], e.z, acc);
        acc = fmaf(v[4 * t + 3], e.w, acc);
      }
      if (acc > best) {  // strictly greater: the first maximum wins
        best = acc;
        arg = w;
      }
    }
    out[g] = static_cast<uint8_t>(arg);
  }
}

template <typename T>
int launch(const void* x, const float* codebook, const float* phasors, const int* s, uint8_t* out,
           long long n_sym, long long rows, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n_sym + kThreads - 1) / kThreads;
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
