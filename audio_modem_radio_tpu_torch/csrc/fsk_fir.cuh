// The decimating analytic FIR that K8 (fsk_disc.cu) and K9 (fsk_quad.cu) share.
//
// FIR row g of a capture holds the c_pad input samples x[g, 0:c_pad) that its
// 128 analytic outputs need (host shaping builds the rows from the zero-led
// capture, ops/fsk.py fsk_disc_row_shape / fsk_quad_row_shape). Output l is
//     z[128g + l] = sum_{k < 129} x[g, DEC*l + k] * (hr[k], hi[k]),
// with (hr, hi) the reversed complex taps of ops/common.py _fir_dec_template;
// the (c_pad, 256) matrix the TPU kernel multiplies by holds those taps shifted
// by DEC per column, 60-80% zeros. Rows past the capture's end are zero, so
// their outputs are zero.
//
// What bounds it: float32 operations. Each output costs 2 x 129 FMAs against
// DEC*2 bytes of int16 input, 65-260 flop/B, far above the 20 flop/B ridge of
// the CUDA cores (67 TFLOP/s over 3.35 TB/s); it stays in IEEE float32 (no
// TF32, no bf16).
//
// Design. The taps travel as a kernel parameter and the tap loop is unrolled,
// so each FMA takes its tap straight from the constant bank. A block stages
// kChunk FIR rows at a time in shared memory, split into DEC polyphase arrays
// with one pad word every 32 samples; each thread computes kQ = 4 consecutive
// outputs, loading each of the DEC*(kQ-1) + 129 input samples once and using
// it in up to kQ outputs, and the pad keeps a warp's 32 threads (kQ*DEC
// samples apart) on distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 129;     // ops/kernels.py _FIR_TAPS
constexpr int kOut = 128;      // analytic outputs per FIR row
constexpr int kQ = 4;          // consecutive outputs per thread
constexpr int kChunk = 8;      // FIR rows staged per pass (kChunk * kOut / kQ = kThreads)
constexpr int kThreads = 256;
constexpr int kTileRows = 16;  // boxcar rows per block (K8 and K9)

struct FirTaps {
  float re[kTaps];
  float im[kTaps];
};

// Words of one staged FIR row: DEC polyphase arrays of c_pad/DEC samples, each
// with one pad word per 32 samples and one spare.
template <int DEC>
__host__ __device__ inline int staged_row_words(int c_pad) {
  const int len = c_pad / DEC;
  return DEC * (len + len / 32 + 1);
}

// Computes the analytic stream of FIR rows [fir0, fir0 + n_fir) of one capture
// (rows_cap rows of c_pad samples at xc) into zr, zi (n_fir * 128 each, shared
// memory), staging kChunk rows at a time in xs (kChunk * staged_row_words).
// Called by every thread of the block; ends with a barrier.
template <typename T, int DEC>
__device__ __forceinline__ void fir_rows(const T* __restrict__ xc, long long rows_cap, int c_pad,
                                         long long fir0, int n_fir, const FirTaps& h, float* xs,
                                         float* zr, float* zi) {
  const int len = c_pad / DEC;
  const int phase_words = len + len / 32 + 1;
  const int row_words = DEC * phase_words;
  for (int c0 = 0; c0 < n_fir; c0 += kChunk) {
    const int nch = min(kChunk, n_fir - c0);
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int e = threadIdx.x; e < nch * c_pad; e += blockDim.x) {
      const int fr = e / c_pad, c = e - fr * c_pad;
      const long long g = fir0 + c0 + fr;
      const float v = g < rows_cap ? static_cast<float>(xc[g * c_pad + c]) : 0.f;
      const int i = c / DEC;
      xs[fr * row_words + (c % DEC) * phase_words + i + (i >> 5)] = v;
    }
    __syncthreads();
    const int fr = threadIdx.x / (kOut / kQ);
    if (fr < nch) {
      const int l0 = kQ * (threadIdx.x % (kOut / kQ));
      const float* xr = xs + fr * row_words;
      float ar[kQ], ai[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) ar[q] = ai[q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kTaps + DEC * (kQ - 1); ++kk) {
        const int i = l0 + kk / DEC;  // sample DEC*l0 + kk sits in phase kk % DEC
        const float v = xr[(kk % DEC) * phase_words + i + (i >> 5)];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int k = kk - DEC * q;
          if (k >= 0 && k < kTaps) {
            ar[q] = fmaf(v, h.re[k], ar[q]);
            ai[q] = fmaf(v, h.im[k], ai[q]);
          }
        }
      }
      float* zrr = zr + (c0 + fr) * kOut + l0;
      float* zir = zi + (c0 + fr) * kOut + l0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        zrr[q] = ar[q];
        zir[q] = ai[q];
      }
    }
  }
  __syncthreads();
}

// Shared memory of a K8/K9 block: zr, zi over n_fir rows, the staging area,
// then the caller's tables.
template <int DEC>
inline size_t fir_smem_bytes(int n_fir, int c_pad) {
  return sizeof(float) *
         ((size_t)2 * n_fir * kOut + (size_t)kChunk * staged_row_words<DEC>(c_pad));
}

}  // namespace
