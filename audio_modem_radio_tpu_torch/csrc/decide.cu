// K1: batched PSK projection + differential + derotation + decision.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py psk_project_decide_batch
// (body _kernel_decide + _project_diff_body, n_psk = 2, 4 and 8, "roll" variant).
//
// What it computes. Capture b is a flat stream x[b, 0 : R*128*spsym) stored as
// (R, 128*spsym) rows; samples past the capture's end read as zero. Symbol t
// (flat index row*128 + lane) has the phasor
//     z_t = sum_{j < 2*spsym} x[t*spsym + j] * (T[j, 2k], T[j, 2k+1]),  k = best[b],
// where T is the (2*spsym, 2*n_offsets) dual-basis template of ops/psk.py
// _offset_templates. The block-diagonal (ROW+OV, 256) matrix the TPU kernel
// multiplies by is that template repeated along the diagonal, so this is the
// same projection without the zero blocks. Then d = z_{t+1} * conj(z_t),
// derotated by the capture's (cos, sin) into (dr, di), and the decision of
// pallas_kernels.py:321-352, a template parameter:
//   NPSK = 4: Gray sector, hi = neg, lo = neg ^ swap;
//   NPSK = 2: sign bits, hi = dr < 0, lo = di < 0;
//   NPSK = 8: the nearest k*pi/4 sector into hi alone: a diagonal sector
//     (1, 3, 5, 7) when |di| > t*|dr| and |dr| > t*|di| with t = tan(pi/8)
//     rounded to float32 (0.41421356f), an axis sector (0, 2, 4, 6) otherwise.
//
// What bounds it on the H100: device memory. Per symbol it reads spsym samples
// (20 B as int16 at 9600 Bd, spsym = 10) and writes 2 B (1 B for 8PSK), against 4*spsym
// FMAs: about 4 flop/B, far below the card's ~20 flop/B float32 ridge
// (67 TFLOP/s over 3.35 TB/s, published H100 SXM peaks). The dense TPU
// formulation multiplies each 1408-sample overlap row by all 256 template
// columns, about 70x the multiplies, which a matrix unit absorbs and CUDA
// cores would not. That is the bound in principle; measured on an H100 80GB
// HBM3 at 700 W, int8 rows (half the bytes of int16) take the same time, so
// at this design the shared-memory staging and each thread's serial
// 2*spsym-tap correlation bound it (PERF.md).
//
// Design. One block owns 256 consecutive symbols of one capture. It stages
// the (256 + 2)*spsym samples its windows touch in shared memory with
// coalesced loads (int16/int8 cast to float exactly, no scaling), each thread
// correlates one window against the winning offset's two template columns
// (also in shared memory), and the successor phasor z_{t+1} is read back from
// shared memory (thread 0 also projects symbol 256, the next block's first).
// The differential, derotation and the 8PSK products t*|x| use explicit
// round-to-nearest products and sums in the plain version's operation order,
// so only the projection's summation order differs from the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSymPerBlock = 256;
constexpr int kThreads = 256;

template <typename T, int NPSK>
__global__ void decide_kernel(const T* __restrict__ x, const float* __restrict__ tmpl,
                                   const int* __restrict__ best, const float* __restrict__ rot,
                                   uint8_t* __restrict__ hi, uint8_t* __restrict__ lo,
                                   int blocks_per_capture, long long sym_per_capture,
                                   int spsym) {
  extern __shared__ float smem[];
  const int win = 2 * spsym;
  float* tw = smem;                                    // (win, 2): re, im columns
  float* xs = tw + 2 * win;                            // (kSymPerBlock + 2) * spsym samples
  float* zr = xs + (kSymPerBlock + 2) * spsym;         // kSymPerBlock + 1 phasors
  float* zi = zr + kSymPerBlock + 1;

  const int b = blockIdx.x / blocks_per_capture;
  const long long t0 = (long long)(blockIdx.x % blocks_per_capture) * kSymPerBlock;
  const long long n_cap = sym_per_capture * spsym;
  const T* xc = x + (long long)b * n_cap;

  const float* tb = tmpl + (long long)best[b] * 2 * win;
  for (int j = threadIdx.x; j < 2 * win; j += blockDim.x) tw[j] = tb[j];
  const long long s0 = t0 * spsym;
  const int n_load = (kSymPerBlock + 2) * spsym;
  for (int j = threadIdx.x; j < n_load; j += blockDim.x) {
    const long long g = s0 + j;
    xs[j] = g < n_cap ? static_cast<float>(xc[g]) : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i <= kSymPerBlock; i += blockDim.x) {
    const float* w = xs + i * spsym;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < win; ++j) {
      ar = fmaf(w[j], tw[2 * j], ar);
      ai = fmaf(w[j], tw[2 * j + 1], ai);
    }
    zr[i] = ar;
    zi[i] = ai;
  }
  __syncthreads();

  const float c = rot[2 * b], s = rot[2 * b + 1];
  const long long out0 = (long long)b * sym_per_capture + t0;
  for (int i = threadIdx.x; i < kSymPerBlock; i += blockDim.x) {
    const float r0 = zr[i], i0 = zi[i], r1 = zr[i + 1], i1 = zi[i + 1];
    const float d_re = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
    const float d_im = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
    const float dr = __fadd_rn(__fmul_rn(d_re, c), __fmul_rn(d_im, s));
    const float di = __fsub_rn(__fmul_rn(d_im, c), __fmul_rn(d_re, s));
    if constexpr (NPSK == 4) {
      const bool swap = fabsf(di) > fabsf(dr);
      const bool neg = (swap ? di : dr) < 0.f;
      hi[out0 + i] = neg;
      lo[out0 + i] = neg ^ swap;
    } else if constexpr (NPSK == 2) {
      hi[out0 + i] = dr < 0.f;
      lo[out0 + i] = di < 0.f;
    } else {
      const float t = 0.41421356f;
      const float ax = fabsf(dr), bx = fabsf(di);
      const bool diag = bx > __fmul_rn(t, ax) && ax > __fmul_rn(t, bx);
      int k;
      if (diag)
        k = di >= 0.f ? (dr >= 0.f ? 1 : 3) : (dr >= 0.f ? 7 : 5);
      else
        k = ax >= bx ? (dr >= 0.f ? 0 : 4) : (di >= 0.f ? 2 : 6);
      hi[out0 + i] = (uint8_t)k;
    }
  }
}

template <typename T, int NPSK>
int launch(const void* x, const float* tmpl, const int* best, const float* rot, uint8_t* hi,
           uint8_t* lo, int n_captures, int rows, int spsym, cudaStream_t stream) {
  const long long sym_per_capture = (long long)rows * 128;
  const int blocks_per_capture = (int)(sym_per_capture / kSymPerBlock);
  const size_t smem =
      sizeof(float) * (2 * 2 * spsym + (kSymPerBlock + 2) * spsym + 2 * (kSymPerBlock + 1));
  const long long n_blocks = (long long)n_captures * blocks_per_capture;
  decide_kernel<T, NPSK><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), tmpl, best, rot, hi, lo, blocks_per_capture, sym_per_capture,
      spsym);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_psk(int n_psk, const void* x, const float* tmpl, const int* best, const float* rot,
               uint8_t* hi, uint8_t* lo, int n_captures, int rows, int spsym,
               cudaStream_t stream) {
  switch (n_psk) {
    case 2:
      return launch<T, 2>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    case 4:
      return launch<T, 4>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    case 8:
      return launch<T, 8>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8. x is (n_captures, rows, 128*spsym)
// contiguous; tmpl is (n_offsets, 2*spsym, 2) float32; best (n_captures,)
// int32; rot (n_captures, 2) float32; hi/lo (n_captures, rows, 128) uint8,
// lo unused (may be null) for n_psk = 8. rows must be even (256 symbols per
// block); spsym <= 32 keeps shared memory under the 48 KB static limit.
// Returns the cudaError_t of the launch.
extern "C" int amr_decide(const void* x, int dtype, int n_psk, const float* tmpl,
                          const int* best, const float* rot, uint8_t* hi, uint8_t* lo,
                          int n_captures, int rows, int spsym, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_psk != 8 && lo == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_psk<float>(n_psk, x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, st);
    case 1:
      return launch_psk<int16_t>(n_psk, x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, st);
    case 2:
      return launch_psk<int8_t>(n_psk, x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
