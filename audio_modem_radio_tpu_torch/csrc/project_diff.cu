// K11 and K12: PSK projection + differential, one capture or a batch.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py psk_project_diff (K11,
// one capture, body _kernel) and psk_project_diff_batch (K12, the batch with
// each capture's template chosen by scalar prefetch, body _kernel_batched);
// both run the tile math of _project_diff_body.
//
// What it computes. Capture b is a flat stream x[b, 0 : R*128*spsym) stored as
// (R, 128*spsym) rows; samples past the capture's end read as zero. Symbol t
// (flat index row*128 + lane) has the phasor
//     z_t = sum_{j < 2*spsym} x[t*spsym + j] * (T[j, 2k], T[j, 2k+1]),  k = best[b],
// where T is the (2*spsym, 2*n_offsets) dual-basis template of ops/psk.py
// _offset_templates (the TPU kernel multiplies by the same template repeated
// along a block diagonal). The outputs are the differential
//     d_re[t] = re_{t+1} * re_t + im_{t+1} * im_t,
//     d_im[t] = im_{t+1} * re_t - re_{t+1} * im_t,
// two float32 streams of R*128 entries per capture; z past the capture's end
// is zero, so the last entry is 0. Zero samples past the end are what K11's
// appended zero rows hold; K12's Pallas kernel reads the next capture's head
// there instead, which its contract calls garbage. Each z_t is two fmaf
// chains in tap order from 0.f and the differential is round-to-nearest
// products and sums in the plain version's order, so every output float
// equals that of every earlier design of this kernel, and only the
// projection's summation order differs from the plain PyTorch version.
//
// What bounds it on the H100: device memory. Per symbol it reads spsym samples
// (20 B as int16 at 9600 Bd, spsym = 10; 40 B as float32) and writes 8 B,
// against 8*spsym + 6 flops: 3-4 flop/B, far below the card's ~20 flop/B
// float32 ridge (67 TFLOP/s over 3.35 TB/s, published H100 SXM peaks).
//
// Design. The first design (one short-lived block per 256 symbols, scalar
// staging with the conversion on the way in, windows read from shared memory
// at a stride of spsym floats, a bank conflict on every tap at spsym 10, and
// the successor phasor through shared memory behind a third barrier) moved
// about 1.05 TB/s. This one is K1's (decide.cu) without the derotation and
// the decision: the tile walk of psk_tile.cuh (a one-wave persistent grid,
// split over the captures; with one capture, K11, the whole grid walks it)
// stages tiles of 256*K symbols (K = 4 for int16, 2 for float32) in their
// storage type by 16-byte cp.async into a two-buffer ring while the previous
// tile is correlated; a thread reads its (K+2)*spsym samples with 16-byte
// shared loads, converts each once, and projects K+1 symbols against template
// columns in registers (spsym 10 and 8 compiled; any other spsym from 1 to 32
// takes the scalar walk). It forms its K differentials in registers and
// writes d_re and d_im with one 16-byte (int16) or 8-byte (float32) store
// each, streaming (st.global.cs): the outputs are not read again by this
// kernel and would only evict the samples staged through L2. Plain stores
// took 15% longer on int16 rows and 1% on float32.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel project_diff, PERF.md section 6), the 8PSK bench batch of 64 x
// 13,312 rows: int16 rows 1.06 ms alone (86% of the 0.9115 ms bytes
// bound), float32 rows 1.81 ms (86% of 1.56), from 2.78 and 2.90; one
// 13,120-row float32 capture (K11) 0.030 ms alone, from 0.053; every float
// equal to the first design's. 40 registers on int16 rows, 64 on float32,
// no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psk_tile.cuh"

namespace {

// K floats from one thread as one streaming vector store (the address is
// 4K-aligned).
template <int K>
__device__ __forceinline__ void store_floats(float* dst, const float (&v)[K]) {
  static_assert(K == 2 || K == 4, "float32 and int16 rows only");
  if constexpr (K == 4) __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  else __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
}

// S: spsym as a compile-time constant, or 0 for any spsym (the argument).
// best == nullptr: one template for every capture (K11).
template <typename T, int S>
__global__ void __launch_bounds__(kTileThreads)
    project_diff_kernel(const T* __restrict__ x, const float* __restrict__ tmpl,
                        const int* __restrict__ best, float* __restrict__ d_re,
                        float* __restrict__ d_im, int per_capture, int n_tiles,
                        long long sym_per_capture, int spsym, int buf_chunks) {
  constexpr int K = 8 / (int)sizeof(T);
  const int b = blockIdx.x / per_capture;
  const float* tb = tmpl + (best == nullptr ? 0LL : (long long)best[b] * 4 * spsym);
  walk_tiles<T, S>(x, tb, b, blockIdx.x % per_capture, per_capture, n_tiles, sym_per_capture, spsym,
                   buf_chunks, [&](long long t0, const float (&zr)[K + 1], const float (&zi)[K + 1]) {
    float vr[K], vi[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float r0 = zr[u], i0 = zi[u], r1 = zr[u + 1], i1 = zi[u + 1];
      vr[u] = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
      vi[u] = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
    }
    if (t0 < sym_per_capture) {
      const long long o = b * sym_per_capture + t0;
      store_floats<K>(d_re + o, vr);
      store_floats<K>(d_im + o, vi);
    }
  });
}

template <typename T, int S>
int launch(const void* x, const float* tmpl, const int* best, float* d_re, float* d_im, int n_captures,
           int rows, int spsym, cudaStream_t stream) {
  constexpr int kTile = kTileThreads * (8 / (int)sizeof(T));
  const long long sym_per_capture = (long long)rows * 128;
  const int n_tiles = (int)((sym_per_capture + kTile - 1) / kTile);
  const int buf_chunks = Layout<S>::buf_chunks(tile_chunks(kTile, spsym, (int)sizeof(T)));
  const size_t smem = walk_smem_bytes<S>(buf_chunks);
  auto kernel = project_diff_kernel<T, S>;
  int per_capture = 0;
  long long n_blocks = 0;
  const cudaError_t err = wave_grid(kernel, smem, n_captures, n_tiles, &per_capture, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_blocks, kTileThreads, smem, stream>>>(static_cast<const T*>(x), tmpl, best, d_re,
                                                             d_im, per_capture, n_tiles, sym_per_capture,
                                                             spsym, buf_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spsym(const void* x, const float* tmpl, const int* best, float* d_re, float* d_im,
                 int n_captures, int rows, int spsym, cudaStream_t stream) {
  switch (spsym) {
    case 10:
      return launch<T, 10>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    case 8:
      return launch<T, 8>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    default:
      return launch<T, 0>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
  }
}

int dispatch(const void* x, int dtype, const float* tmpl, const int* best, float* d_re,
             float* d_im, int n_captures, int rows, int spsym, cudaStream_t stream) {
  if (rows < 2 || rows % 2 != 0 || spsym < 1 || spsym > 32 || n_captures < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_spsym<float>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    case 1:
      return launch_spsym<int16_t>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K12. dtype: 0 = float32, 1 = int16. x is (n_captures, rows, 128*spsym)
// contiguous and 16-byte aligned; tmpl is (n_offsets, 2*spsym, 2) float32;
// best (n_captures,) int32; d_re/d_im (n_captures, rows, 128) float32. rows
// must be even and 1 <= spsym <= 32. Returns the cudaError_t of the launch.
extern "C" int amr_project_diff_batch(const void* x, int dtype, const float* tmpl, const int* best,
                                      float* d_re, float* d_im, int n_captures, int rows,
                                      int spsym, void* stream) {
  if (best == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(x, dtype, tmpl, best, d_re, d_im, n_captures, rows, spsym,
                  static_cast<cudaStream_t>(stream));
}

// K11: one capture, x (rows, 128*spsym), tmpl (2*spsym, 2) the one template.
extern "C" int amr_project_diff(const void* x, int dtype, const float* tmpl, float* d_re,
                                float* d_im, int rows, int spsym, void* stream) {
  return dispatch(x, dtype, tmpl, nullptr, d_re, d_im, 1, rows, spsym,
                  static_cast<cudaStream_t>(stream));
}
