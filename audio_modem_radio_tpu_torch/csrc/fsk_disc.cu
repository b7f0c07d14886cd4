// K8: batched FSK discriminator front half: decimating analytic FIR, phasor
// z[n+1] * conj z[n], fractional per-bit boxcar.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py fsk_disc_sums_batch
// (body _kernel_fsk_disc).
//
// What it computes. Per capture, the analytic stream z of its FIR rows
// (fsk_fir.cuh), the phasor p[n] = z[n+1] * conj(z[n]) along the flat stream
// (z past the capture's last row is zero, so p is zero at and past its last
// sample, as in the plain version; the TPU kernel read the next capture
// there), and for boxcar row i and bit s at the capture's winning offset k:
//     (sr, si)[i, s] = sum_{t < span} p[i*row2 + first[k, s] + t] * tab[k, t, s],
// the fractional-overlap boxcar of ops/fsk.py _fsk_boxcar_templates_geom
// compacted to each bit's 2-4 taps by the wrapper (ops/kernels.py _band_tables).
// The phasor uses round-to-nearest products and sums in the plain version's
// order; the FIR and boxcar sums differ from it in summation order only.
//
// What bounds it on the H100: float32 operations, in the FIR. At FSK9600
// (dec 4, 129 taps) 64 captures of 2^24 samples need 64 x 33280 x 128 outputs
// x 258 FMAs, 141 GFLOP or 2.1 ms at 67 TFLOP/s, against 2.2 GB read (each
// sample once) and 0.9 GB written (0.9 ms at 3.35 TB/s). What holds it back is
// every issued instruction that is not one of those FMAs, and every warp that
// is not in the tap loop: at dec 4 a pass stages and converts four samples per
// output, and a bit takes 2.5 outputs, so the share outside the loop is larger
// than K9's.
//
// Design (fsk_fir.cuh has the FIR's). One block walks 512 FIR rows of one
// capture in 32 passes of 16 rows: it loads the winning offset's (span, spr2)
// band table once, and after each pass one thread per (boxcar row, bit) forms
// the phasors of the bits whose windows that pass completed and sums them,
// reading the analytic stream from a ring in shared memory that holds the pass
// and the row before it (a bit of span phasors reads span + 1 samples). The
// filter's outputs never reach global memory; about 75 KB of shared memory and
// a cap of 85 registers a thread let three blocks share a multiprocessor.

#include "fsk_fir.cuh"

namespace {

template <typename T, int DEC>
__global__ void __launch_bounds__(kThreads, 3)
    fsk_disc_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps h,
                    const int* __restrict__ first, const float* __restrict__ tab, int span,
                    const int* __restrict__ best, float* __restrict__ sr, float* __restrict__ si,
                    int rows, int row2, int ov2, int spr2, int r2, int chunk_step,
                    int chunks_per_capture, int ring) {
  extern __shared__ __align__(16) float smem[];
  float* zr = smem;  // the ring: analytic sample n of the chunk at n % ring
  float* zi = zr + ring;
  unsigned char* staging = reinterpret_cast<unsigned char*>(zi + ring);
  float* wt = reinterpret_cast<float*>(staging + FirGeom<T, DEC>::kStagingBytes);  // (span, spr2)
  int* ft = reinterpret_cast<int*>(wt + span * spr2);                               // (spr2,)

  const int b = blockIdx.x / chunks_per_capture;
  const int row0 = (blockIdx.x % chunks_per_capture) * chunk_step;
  // The bits this block owns start in [own_lo, own_hi) of the capture's analytic
  // stream; a bit reads span phasors, span + 1 analytic samples.
  const int window = span + 1;
  const int own_lo = row0 * kOut, own_hi = own_lo + chunk_step * kOut;
  const int z_need = min(own_hi, rows * kOut + ov2) - own_lo + window;
  const int n_rows = min(kChunkRows, (z_need + kOut - 1) / kOut);
  const FirStream<T, DEC> fir(x + (long long)b * rows * FirGeom<T, DEC>::kCPad, rows, row0, n_rows, staging);
  fir.begin();

  const int k = best[b];
  for (int e = threadIdx.x; e < span * spr2; e += blockDim.x) wt[e] = tab[(long long)k * span * spr2 + e];
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
    rows_ending_in(prev, lim, window, row2, ov2, r2, i_lo, i_hi);
    int i = i_lo + row_t, s = bit_t;
    for (; i <= i_hi; step.advance(i, s, spr2)) {
      const int n0 = i * row2 + ft[s];
      if (n0 < own_lo || n0 >= own_hi || n0 + window <= prev || n0 + window > lim) continue;
      float ar = 0.f, ai = 0.f;
      int n = zbase + n0 - prev;  // the window starts at most `ring - kPassOut` samples before this pass
      if (n < 0) n += ring;
      if (n >= ring) n -= ring;
      float r0 = zr[n], i0v = zi[n];
      for (int t = 0; t < span; ++t) {
        if (++n == ring) n = 0;
        const float r1 = zr[n], i1 = zi[n];
        const float pr = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0v));
        const float pi = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0v));
        const float w = wt[t * spr2 + s];
        ar = fmaf(pr, w, ar);
        ai = fmaf(pi, w, ai);
        r0 = r1, i0v = i1;
      }
      sr[out0 + (long long)i * spr2 + s] = ar;
      si[out0 + (long long)i * spr2 + s] = ai;
    }
    zbase += kPassOut;
    if (zbase >= ring) zbase -= ring;
  }
}

template <typename T, int DEC>
int launch(const void* x, const FirTaps& h, const int* first, const float* tab, int span,
           const int* best, float* sr, float* si, int n_captures, int rows, int c_pad, int row2,
           int ov2, int spr2, cudaStream_t stream) {
  if (!fir_operands_ok<T, DEC>(x, c_pad)) return (int)cudaErrorInvalidValue;
  const int r2 = (int)((long long)rows * kOut / row2);
  FirWalk walk;
  cudaError_t err = fir_plan_walk<T, DEC>(fsk_disc_kernel<T, DEC>, rows + ov2 / kOut, span + 1,
                                          sizeof(float) * span * spr2 + sizeof(int) * spr2, &walk);
  if (err != cudaSuccess) return (int)err;
  fsk_disc_kernel<T, DEC><<<n_captures * walk.chunks_per_capture, kThreads, walk.smem, stream>>>(
      static_cast<const T*>(x), h, first, tab, span, best, sr, si, rows, row2, ov2, spr2, r2,
      walk.chunk_step, walk.chunks_per_capture, walk.ring);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dec(int dec, const void* x, const FirTaps& h, const int* first, const float* tab,
               int span, const int* best, float* sr, float* si, int n_captures, int rows,
               int c_pad, int row2, int ov2, int spr2, cudaStream_t st) {
  switch (dec) {
    case 1:
      return launch<T, 1>(x, h, first, tab, span, best, sr, si, n_captures, rows, c_pad, row2,
                          ov2, spr2, st);
    case 4:
      return launch<T, 4>(x, h, first, tab, span, best, sr, si, n_captures, rows, c_pad, row2,
                          ov2, spr2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = int16. x: (n_captures, rows, c_pad) FIR windows with
// c_pad >= 127*dec + 129; taps: host pointer to 2 x 129 float32 (reversed Re
// then Im taps, zero-padded); dec: 1 or 4; first: (n_offsets, spr2) int32;
// tab: (n_offsets, 1, span, spr2) float32; best: (n_captures,) int32; sr, si:
// (n_captures, rows*128/row2 * spr2) float32. row2 and ov2 are multiples of
// 128 with ov2 <= row2. Returns the cudaError_t of the launch.
extern "C" int amr_fsk_disc(const void* x, int dtype, const float* taps, int dec, const int* first,
                            const float* tab, int span, const int* best, float* sr, float* si,
                            int n_captures, int rows, int c_pad, int row2, int ov2, int spr2,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sr == nullptr || si == nullptr) return (int)cudaErrorInvalidValue;
  FirTaps h;
  for (int k = 0; k < kTaps; ++k) {
    h.re[k] = taps[k];
    h.im[k] = taps[kTaps + k];
  }
  switch (dtype) {
    case 0:
      return launch_dec<float>(dec, x, h, first, tab, span, best, sr, si, n_captures, rows, c_pad,
                               row2, ov2, spr2, st);
    case 1:
      return launch_dec<int16_t>(dec, x, h, first, tab, span, best, sr, si, n_captures, rows,
                                 c_pad, row2, ov2, spr2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
