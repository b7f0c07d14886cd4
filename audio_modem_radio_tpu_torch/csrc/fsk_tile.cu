// K7 and K13: batched dual-tone FSK projection + mark/space energy decision.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py fsk_tile_bits_batch (K7,
// body _kernel_fsk_tile, over host-overlapped rows) and fsk_project_bits_batch
// (K13, body _kernel_fsk_decide, over flat rows whose overlap is the next row).
//
// What it computes. Bit s of row j of capture b, at the capture's winning
// offset k = best[b], correlates its samples with the four dual-basis columns
// {mark, space} x {sin, cos} of ops/fsk.py _fsk_blocked_templates:
//     a_g = sum_{t < span} x[j, first[k, s] + t] * tab[k, g, t, s],   g = 0..3,
// and bit = (a_0^2 + a_1^2) - (a_2^2 + a_3^2) > 0. tab and first are the
// template compacted to each bit's band by the wrapper (ops/kernels.py
// _band_tables): the dense (row+ov, 4*spr) matrix the TPU kernel multiplies by
// is 94% zeros at FSK1200. K7 reads row j of the (R, row+ov) overlapped rows;
// K13 (FLAT) reads the flat stream of (R, row) rows at j*row + column, so the
// overlap columns are the next row's head and samples past the capture's
// last row are zero, as in the plain version (the TPU kernel read the next
// capture there). Integer rows are cast to float without scaling.
//
// What bounds it on the H100: device memory. Per bit it reads its row's share
// of the samples (about spb+ov/spr int16 at FSK1200, 2.4 GB for 64 captures of
// 2^24 samples, 0.72 ms at 3.35 TB/s) against 4*spb FMAs, about 4 flop/B,
// under the float32 ridge of 20 flop/B.
//
// Design. One thread per bit, a block per 256 consecutive bits of a capture.
// The block stages its capture's (4, span, spr) band table in shared memory
// (bits along the fast axis, so a warp's neighbouring bits read neighbouring
// banks) and each thread correlates its own span samples, read straight from
// device memory: a warp's reads fall in the few rows its 32 bits cover and
// are served from L1 after the first touch. Unlike the Pallas kernel it takes
// any spr and any row count (the 128 % spr and 256-row conditions were its
// lane layout's), so MSK at 1000 Bd (spr 12) and FT8 (spr 1) run it too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool FLAT>
__global__ void fsk_tile_kernel(const T* __restrict__ x, const float* __restrict__ tab,
                                const int* __restrict__ first, const int* __restrict__ best,
                                uint8_t* __restrict__ bits, int rows, int cols, int spr,
                                int span) {
  extern __shared__ float tw[];  // (4, span, spr) of the capture's offset
  const int b = blockIdx.y;
  const int k = best[b];
  const int n_tab = 4 * span * spr;
  const float* tk = tab + (long long)k * n_tab;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tw[i] = tk[i];
  __syncthreads();

  const long long bits_per_capture = (long long)rows * spr;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= bits_per_capture) return;
  const int j = (int)(g / spr);
  const int s = (int)(g % spr);
  const long long n_cap = (long long)rows * cols;
  const T* xc = x + (long long)b * n_cap;
  const long long p = (long long)j * cols + first[k * spr + s];
  const float* w0 = tw + s;
  const int gs = span * spr;  // stride between the four columns
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (!FLAT || p + span <= n_cap) {
    for (int t = 0; t < span; ++t) {
      const float v = static_cast<float>(xc[p + t]);
      const float* w = w0 + t * spr;
      a0 = fmaf(v, w[0], a0);
      a1 = fmaf(v, w[gs], a1);
      a2 = fmaf(v, w[2 * gs], a2);
      a3 = fmaf(v, w[3 * gs], a3);
    }
  } else {
    for (int t = 0; t < span; ++t) {
      const float v = p + t < n_cap ? static_cast<float>(xc[p + t]) : 0.f;
      const float* w = w0 + t * spr;
      a0 = fmaf(v, w[0], a0);
      a1 = fmaf(v, w[gs], a1);
      a2 = fmaf(v, w[2 * gs], a2);
      a3 = fmaf(v, w[3 * gs], a3);
    }
  }
  const float em = __fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1));
  const float es = __fadd_rn(__fmul_rn(a2, a2), __fmul_rn(a3, a3));
  bits[(long long)b * bits_per_capture + g] = __fsub_rn(em, es) > 0.f;
}

template <typename T, bool FLAT>
int launch(const void* x, const float* tab, const int* first, int span, const int* best,
           uint8_t* bits, int n_captures, int rows, int cols, int spr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)span * spr;
  cudaError_t err = cudaFuncSetAttribute(fsk_tile_kernel<T, FLAT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long bits_per_capture = (long long)rows * spr;
  dim3 grid((unsigned)((bits_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  fsk_tile_kernel<T, FLAT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), tab, first, best, bits, rows, cols, spr, span);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flat(int flat, const void* x, const float* tab, const int* first, int span,
                const int* best, uint8_t* bits, int n_captures, int rows, int cols, int spr,
                cudaStream_t st) {
  return flat ? launch<T, true>(x, tab, first, span, best, bits, n_captures, rows, cols, spr, st)
              : launch<T, false>(x, tab, first, span, best, bits, n_captures, rows, cols, spr, st);
}

}  // namespace

// dtype: 0 = float32, 1 = int16. flat: 0 for K7 (x is (n_captures, rows, cols)
// overlapped rows, cols = row+ov), 1 for K13 (x is (n_captures, rows, cols)
// flat rows, cols = row). tab: (n_offsets, 4, span, spr) float32; first:
// (n_offsets, spr) int32 with first + span <= the template's rows; best:
// (n_captures,) int32; bits: (n_captures, rows*spr) uint8. Returns the
// cudaError_t of the launch.
extern "C" int amr_fsk_tile(const void* x, int dtype, int flat, const float* tab,
                            const int* first, int span, const int* best, uint8_t* bits,
                            int n_captures, int rows, int cols, int spr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_flat<float>(flat, x, tab, first, span, best, bits, n_captures, rows, cols,
                                spr, st);
    case 1:
      return launch_flat<int16_t>(flat, x, tab, first, span, best, bits, n_captures, rows, cols,
                                  spr, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
