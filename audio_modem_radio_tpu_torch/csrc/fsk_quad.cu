// K9: batched mid-separation FSK matched filter: analytic FIR at full rate,
// per-bit tone quadratures, noncoherent mark-space margin.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py fsk_quad_margin_batch
// (body _kernel_fsk_quad).
//
// What it computes. Per capture, the analytic stream z = zr + i*zi of its FIR
// rows (fsk_fir.cuh, dec 1; zero past the capture's last row, as in the plain
// version; the TPU kernel read the next capture there), and for boxcar row i
// and bit s at the capture's winning offset k the projections of zr and zi on
// the quadratures [cos_m, sin_m, cos_s, sin_s] of ops/fsk.py
// _fsk_quadrature_templates_geom, compacted to each bit's band by the wrapper:
//     M_g = sum_{t < span} zr[i*row2 + first[k, s] + t] * tab[k, g, t, s], N_g with zi,
// then u_m = M_0 + N_1, v_m = N_0 - M_1, u_s = M_2 + N_3, v_s = N_2 - M_3 and
// margin = u_m^2 + v_m^2 - u_s^2 - v_s^2 (E_mark - E_space), with
// round-to-nearest operations in the plain version's order.
//
// What bounds it on the H100: float32 operations, in the FIR. At FSK19200
// (dec 1, 129 taps) 64 captures of 2^24 samples need 64 x 131200 x 128 outputs
// x 258 FMAs, 555 GFLOP or 8.3 ms at 67 TFLOP/s, plus about 17 GFLOP of
// quadratures, against 4.3 GB read and 0.86 GB written (1.5 ms at 3.35 TB/s).
//
// Design. As K8 (fsk_disc.cu): one block per 16 boxcar rows of a capture, the
// FIR of its 16*row2/128 + 1 FIR rows into shared memory (83 KB at FSK19200),
// then one thread per (row, bit) reads its span analytic samples and the
// offset's (4, span, spr2) band table from shared memory.

#include "fsk_fir.cuh"

namespace {

template <typename T, int DEC>
__global__ void fsk_quad_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps h,
                                const int* __restrict__ first, const float* __restrict__ tab,
                                int span, const int* __restrict__ best,
                                float* __restrict__ margin, int rows, int c_pad, int row2,
                                int spr2, int r2, int tiles_per_capture, int n_fir) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zi = zr + n_fir * kOut;
  float* xs = zi + n_fir * kOut;
  float* wt = xs + kChunk * staged_row_words<DEC>(c_pad);  // (4, span, spr2)
  int* ft = reinterpret_cast<int*>(wt + 4 * span * spr2);   // (spr2,)

  const int b = blockIdx.x / tiles_per_capture;
  const int i0 = (blockIdx.x % tiles_per_capture) * kTileRows;
  const int k = best[b];
  const int n_tab = 4 * span * spr2;
  for (int e = threadIdx.x; e < n_tab; e += blockDim.x) wt[e] = tab[(long long)k * n_tab + e];
  for (int e = threadIdx.x; e < spr2; e += blockDim.x) ft[e] = first[k * spr2 + e];

  const int rows_pb = row2 / kOut;
  fir_rows<T, DEC>(x + (long long)b * rows * c_pad, rows, c_pad, (long long)i0 * rows_pb, n_fir,
                   h, xs, zr, zi);

  const int gs = span * spr2;
  const long long out0 = (long long)b * r2 * spr2;
  for (int e = threadIdx.x; e < kTileRows * spr2; e += blockDim.x) {
    const int il = e / spr2, s = e - il * spr2;
    if (i0 + il >= r2) break;
    const int n0 = il * row2 + ft[s];
    float m[4] = {0.f, 0.f, 0.f, 0.f}, nn[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < span; ++t) {
      const float vr = zr[n0 + t], vi = zi[n0 + t];
      const float* w = wt + t * spr2 + s;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        m[g] = fmaf(vr, w[g * gs], m[g]);
        nn[g] = fmaf(vi, w[g * gs], nn[g]);
      }
    }
    const float u_m = __fadd_rn(m[0], nn[1]), v_m = __fsub_rn(nn[0], m[1]);
    const float u_s = __fadd_rn(m[2], nn[3]), v_s = __fsub_rn(nn[2], m[3]);
    const float e_m = __fadd_rn(__fmul_rn(u_m, u_m), __fmul_rn(v_m, v_m));
    margin[out0 + (long long)(i0 + il) * spr2 + s] =
        __fsub_rn(__fsub_rn(e_m, __fmul_rn(u_s, u_s)), __fmul_rn(v_s, v_s));
  }
}

template <typename T, int DEC>
int launch(const void* x, const FirTaps& h, const int* first, const float* tab, int span,
           const int* best, float* margin, int n_captures, int rows, int c_pad, int row2, int ov2,
           int spr2, cudaStream_t stream) {
  const int r2 = (int)((long long)rows * kOut / row2);
  const int tiles = (r2 + kTileRows - 1) / kTileRows;
  const int n_fir = kTileRows * (row2 / kOut) + ov2 / kOut;
  const size_t smem = fir_smem_bytes<DEC>(n_fir, c_pad) + sizeof(float) * 4 * span * spr2 +
                      sizeof(int) * spr2;
  cudaError_t err = cudaFuncSetAttribute(fsk_quad_kernel<T, DEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fsk_quad_kernel<T, DEC><<<(unsigned)((long long)n_captures * tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), h, first, tab, span, best, margin, rows, c_pad, row2, spr2, r2,
      tiles, n_fir);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dec(int dec, const void* x, const FirTaps& h, const int* first, const float* tab,
               int span, const int* best, float* margin, int n_captures, int rows, int c_pad,
               int row2, int ov2, int spr2, cudaStream_t st) {
  switch (dec) {
    case 1:
      return launch<T, 1>(x, h, first, tab, span, best, margin, n_captures, rows, c_pad, row2,
                          ov2, spr2, st);
    case 4:
      return launch<T, 4>(x, h, first, tab, span, best, margin, n_captures, rows, c_pad, row2,
                          ov2, spr2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// As amr_fsk_disc (fsk_disc.cu), with tab (n_offsets, 4, span, spr2) and one
// output, margin (n_captures, rows*128/row2 * spr2) float32; the second output
// pointer is unused. Returns the cudaError_t of the launch.
extern "C" int amr_fsk_quad(const void* x, int dtype, const float* taps, int dec, const int* first,
                            const float* tab, int span, const int* best, float* margin,
                            void* unused, int n_captures, int rows, int c_pad, int row2, int ov2,
                            int spr2, void* stream) {
  (void)unused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FirTaps h;
  for (int k = 0; k < kTaps; ++k) {
    h.re[k] = taps[k];
    h.im[k] = taps[kTaps + k];
  }
  switch (dtype) {
    case 0:
      return launch_dec<float>(dec, x, h, first, tab, span, best, margin, n_captures, rows, c_pad,
                               row2, ov2, spr2, st);
    case 1:
      return launch_dec<int16_t>(dec, x, h, first, tab, span, best, margin, n_captures, rows,
                                 c_pad, row2, ov2, spr2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
