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
// quadratures, against 2.1 GB read (each sample once) and 0.86 GB written
// (0.9 ms at 3.35 TB/s). What holds it back is every issued instruction that is
// not one of those FMAs, and every warp that is not in the tap loop.
//
// Design (fsk_fir.cuh has the FIR's). One block walks 512 FIR rows of one
// capture in 32 passes of 16 rows: it loads the winning offset's (4, span,
// spr2) band table once, and after each pass one thread per (boxcar row, bit)
// sums the bits whose windows that pass completed, reading the analytic stream
// from a ring in shared memory that holds the pass and the row before it. The
// filter's outputs never reach global memory; about 45 KB of shared memory and
// a cap of 85 registers a thread let three blocks share a multiprocessor.

#include "fsk_fir.cuh"

namespace {

template <typename T, int DEC>
__global__ void __launch_bounds__(kThreads, 3)
    fsk_quad_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps h,
                    const int* __restrict__ first, const float* __restrict__ tab, int span,
                    const int* __restrict__ best, float* __restrict__ margin, int rows, int row2,
                    int ov2, int spr2, int r2, int chunk_step, int chunks_per_capture,
                    int ring) {
  extern __shared__ __align__(16) float smem[];
  float* zr = smem;  // the ring: analytic sample n of the chunk at n % ring
  float* zi = zr + ring;
  unsigned char* staging = reinterpret_cast<unsigned char*>(zi + ring);
  float* wt = reinterpret_cast<float*>(staging + FirGeom<T, DEC>::kStagingBytes);  // (4, span, spr2)
  int* ft = reinterpret_cast<int*>(wt + 4 * span * spr2);                           // (spr2,)

  const int b = blockIdx.x / chunks_per_capture;
  const int row0 = (blockIdx.x % chunks_per_capture) * chunk_step;
  // The bits this block owns start in [own_lo, own_hi) of the capture's analytic stream.
  const int own_lo = row0 * kOut, own_hi = own_lo + chunk_step * kOut;
  const int z_need = min(own_hi, rows * kOut + ov2) - own_lo + span;
  const int n_rows = min(kChunkRows, (z_need + kOut - 1) / kOut);
  const FirStream<T, DEC> fir(x + (long long)b * rows * FirGeom<T, DEC>::kCPad, rows, row0, n_rows, staging);
  fir.begin();

  const int k = best[b];
  const int n_tab = 4 * span * spr2, gs = span * spr2;
  for (int e = threadIdx.x; e < n_tab; e += blockDim.x) wt[e] = tab[(long long)k * n_tab + e];
  for (int e = threadIdx.x; e < spr2; e += blockDim.x) ft[e] = first[k * spr2 + e];

  const ItemStep step(kThreads, spr2);
  const int row_t = threadIdx.x / spr2, bit_t = threadIdx.x % spr2;
  const long long out0 = (long long)b * r2 * spr2;
  int zbase = 0;  // where the ring holds this pass's first output
  for (int p = 0; p * kPassRows < n_rows; ++p) {
    int zpos = zbase + kQ * threadIdx.x;
    if (zpos >= ring) zpos -= ring;
    fir.pass(p, h, zr + zpos, zi + zpos);
    __syncthreads();
    // The bits whose windows end in this pass's outputs.
    const int prev = own_lo + p * kPassOut, lim = prev + kPassOut;
    int i_lo, i_hi;
    rows_ending_in(prev, lim, span, row2, ov2, r2, i_lo, i_hi);
    int i = i_lo + row_t, s = bit_t;
    for (; i <= i_hi; step.advance(i, s, spr2)) {
      const int n0 = i * row2 + ft[s];
      if (n0 < own_lo || n0 >= own_hi || n0 + span <= prev || n0 + span > lim) continue;
      float m[4] = {0.f, 0.f, 0.f, 0.f}, nn[4] = {0.f, 0.f, 0.f, 0.f};
      int n = zbase + n0 - prev;  // the window starts at most `ring - kPassOut` samples before this pass
      if (n < 0) n += ring;
      if (n >= ring) n -= ring;
      for (int t = 0; t < span; ++t) {
        const float vr = zr[n], vi = zi[n];
        if (++n == ring) n = 0;
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
      margin[out0 + (long long)i * spr2 + s] =
          __fsub_rn(__fsub_rn(e_m, __fmul_rn(u_s, u_s)), __fmul_rn(v_s, v_s));
    }
    zbase += kPassOut;
    if (zbase >= ring) zbase -= ring;
  }
}

template <typename T, int DEC>
int launch(const void* x, const FirTaps& h, const int* first, const float* tab, int span,
           const int* best, float* margin, int n_captures, int rows, int c_pad, int row2, int ov2,
           int spr2, cudaStream_t stream) {
  if (!fir_operands_ok<T, DEC>(x, c_pad)) return (int)cudaErrorInvalidValue;
  const int r2 = (int)((long long)rows * kOut / row2);
  FirWalk walk;
  cudaError_t err = fir_plan_walk<T, DEC>(fsk_quad_kernel<T, DEC>, rows + ov2 / kOut, span,
                                          sizeof(float) * 4 * span * spr2 + sizeof(int) * spr2, &walk);
  if (err != cudaSuccess) return (int)err;
  fsk_quad_kernel<T, DEC><<<n_captures * walk.chunks_per_capture, kThreads, walk.smem, stream>>>(
      static_cast<const T*>(x), h, first, tab, span, best, margin, rows, row2, ov2, spr2, r2,
      walk.chunk_step, walk.chunks_per_capture, walk.ring);
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
