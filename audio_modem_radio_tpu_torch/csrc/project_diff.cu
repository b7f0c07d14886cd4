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
// there instead, which its contract calls garbage.
//
// What bounds it on the H100: device memory. Per symbol it reads spsym samples
// (40 B as float32 at 9600 Bd, spsym = 10; 20 B as int16) and writes 8 B,
// against 4*spsym + 6 flops: about 1 flop/B, far below the card's ~20 flop/B
// float32 ridge (67 TFLOP/s over 3.35 TB/s, published H100 SXM peaks).
//
// Design: K1's (decide.cu) with the rotation and the decision removed. One
// block owns 256 consecutive symbols of one capture; it stages the
// (256 + 2)*spsym samples its windows touch in shared memory with coalesced
// loads (int16 cast to float exactly, no scaling) and the winning offset's
// (2*spsym, 2) template columns; each thread correlates one window, and the
// successor phasor is read back from shared memory (the block also projects
// symbol 256, the next block's first). The differential uses round-to-nearest
// products and sums in the plain version's order, so only the projection's
// summation order differs from the plain PyTorch version. One kernel body, two
// entry points: amr_project_diff_batch reads best[b] per capture, as K1 does;
// amr_project_diff is the B = 1 launch with the single template.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSymPerBlock = 256;
constexpr int kThreads = 256;

template <typename T>
__global__ void project_diff_kernel(const T* __restrict__ x, const float* __restrict__ tmpl,
                                    const int* __restrict__ best, float* __restrict__ d_re,
                                    float* __restrict__ d_im, int blocks_per_capture,
                                    long long sym_per_capture, int spsym) {
  extern __shared__ float smem[];
  const int win = 2 * spsym;
  float* tw = smem;                             // (win, 2): re, im columns
  float* xs = tw + 2 * win;                     // (kSymPerBlock + 2) * spsym samples
  float* zr = xs + (kSymPerBlock + 2) * spsym;  // kSymPerBlock + 1 phasors
  float* zi = zr + kSymPerBlock + 1;

  const int b = blockIdx.x / blocks_per_capture;
  const long long t0 = (long long)(blockIdx.x % blocks_per_capture) * kSymPerBlock;
  const long long n_cap = sym_per_capture * spsym;
  const T* xc = x + (long long)b * n_cap;

  const float* tb = tmpl + (best == nullptr ? 0LL : (long long)best[b] * 2 * win);
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
    zr[i] = ar;  // 0 past the capture's end, whose samples read as zero
    zi[i] = ai;
  }
  __syncthreads();

  const long long out0 = (long long)b * sym_per_capture + t0;
  for (int i = threadIdx.x; i < kSymPerBlock; i += blockDim.x) {
    const float r0 = zr[i], i0 = zi[i], r1 = zr[i + 1], i1 = zi[i + 1];
    d_re[out0 + i] = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
    d_im[out0 + i] = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
  }
}

template <typename T>
int launch(const void* x, const float* tmpl, const int* best, float* d_re, float* d_im,
           int n_captures, int rows, int spsym, cudaStream_t stream) {
  const long long sym_per_capture = (long long)rows * 128;
  const int blocks_per_capture = (int)(sym_per_capture / kSymPerBlock);
  const size_t smem =
      sizeof(float) * (2 * 2 * spsym + (kSymPerBlock + 2) * spsym + 2 * (kSymPerBlock + 1));
  const long long n_blocks = (long long)n_captures * blocks_per_capture;
  project_diff_kernel<T><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), tmpl, best, d_re, d_im, blocks_per_capture, sym_per_capture,
      spsym);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, int dtype, const float* tmpl, const int* best, float* d_re,
             float* d_im, int n_captures, int rows, int spsym, cudaStream_t stream) {
  if (rows % 2 != 0 || spsym < 1 || spsym > 32 || n_captures < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    case 1:
      return launch<int16_t>(x, tmpl, best, d_re, d_im, n_captures, rows, spsym, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K12. dtype: 0 = float32, 1 = int16. x is (n_captures, rows, 128*spsym)
// contiguous; tmpl is (n_offsets, 2*spsym, 2) float32; best (n_captures,)
// int32; d_re/d_im (n_captures, rows, 128) float32. rows must be even (256
// symbols per block); spsym <= 32 keeps shared memory under the 48 KB static
// limit. Returns the cudaError_t of the launch.
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
