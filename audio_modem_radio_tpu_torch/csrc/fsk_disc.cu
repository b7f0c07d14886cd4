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
// x 258 FMAs, 141 GFLOP or 2.1 ms at 67 TFLOP/s, against 2.7 GB read and 0.9
// GB written (1.1 ms at 3.35 TB/s).
//
// Design. One block per kTileRows = 16 boxcar rows of one capture: it runs the
// FIR over the 16*row2/128 + 2 FIR rows those need (one for the overlap
// columns, one for the last phasor's successor) into shared memory, about 84 KB
// at FSK9600, where the Pallas kernel's 640-row block would need 657 KB, then
// one thread per (row, bit) forms the phasors of its window from shared memory
// and sums them against the offset's band table, also in shared memory.

#include "fsk_fir.cuh"

namespace {

template <typename T, int DEC>
__global__ void fsk_disc_kernel(const T* __restrict__ x, const __grid_constant__ FirTaps h,
                                const int* __restrict__ first, const float* __restrict__ tab,
                                int span, const int* __restrict__ best, float* __restrict__ sr,
                                float* __restrict__ si, int rows, int c_pad, int row2, int ov2,
                                int spr2, int r2, int tiles_per_capture, int n_fir) {
  extern __shared__ float smem[];
  float* zr = smem;
  float* zi = zr + n_fir * kOut;
  float* xs = zi + n_fir * kOut;
  float* wt = xs + kChunk * staged_row_words<DEC>(c_pad);  // (span, spr2)
  int* ft = reinterpret_cast<int*>(wt + span * spr2);       // (spr2,)

  const int b = blockIdx.x / tiles_per_capture;
  const int i0 = (blockIdx.x % tiles_per_capture) * kTileRows;
  const int k = best[b];
  for (int e = threadIdx.x; e < span * spr2; e += blockDim.x)
    wt[e] = tab[(long long)k * span * spr2 + e];
  for (int e = threadIdx.x; e < spr2; e += blockDim.x) ft[e] = first[k * spr2 + e];

  const int rows_pb = row2 / kOut;
  fir_rows<T, DEC>(x + (long long)b * rows * c_pad, rows, c_pad, (long long)i0 * rows_pb, n_fir,
                   h, xs, zr, zi);

  const long long out0 = (long long)b * r2 * spr2;
  for (int e = threadIdx.x; e < kTileRows * spr2; e += blockDim.x) {
    const int il = e / spr2, s = e - il * spr2;
    if (i0 + il >= r2) break;
    const int n0 = il * row2 + ft[s];
    float ar = 0.f, ai = 0.f;
    for (int t = 0; t < span; ++t) {
      const int n = n0 + t;
      const float r0 = zr[n], i0v = zi[n], r1 = zr[n + 1], i1 = zi[n + 1];
      const float pr = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0v));
      const float pi = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0v));
      const float w = wt[t * spr2 + s];
      ar = fmaf(pr, w, ar);
      ai = fmaf(pi, w, ai);
    }
    sr[out0 + (long long)(i0 + il) * spr2 + s] = ar;
    si[out0 + (long long)(i0 + il) * spr2 + s] = ai;
  }
}

template <typename T, int DEC>
int launch(const void* x, const FirTaps& h, const int* first, const float* tab, int span,
           const int* best, float* sr, float* si, int n_captures, int rows, int c_pad, int row2,
           int ov2, int spr2, cudaStream_t stream) {
  const int r2 = (int)((long long)rows * kOut / row2);
  const int tiles = (r2 + kTileRows - 1) / kTileRows;
  const int n_fir = kTileRows * (row2 / kOut) + ov2 / kOut + 1;
  const size_t smem = fir_smem_bytes<DEC>(n_fir, c_pad) + sizeof(float) * span * spr2 +
                      sizeof(int) * spr2;
  cudaError_t err = cudaFuncSetAttribute(fsk_disc_kernel<T, DEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fsk_disc_kernel<T, DEC><<<(unsigned)((long long)n_captures * tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), h, first, tab, span, best, sr, si, rows, c_pad, row2, ov2, spr2,
      r2, tiles, n_fir);
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
