// Batched PSK pass 1: every capture's timing offset and common rotation.
//
// Replaces no TPU kernel: the JAX package runs pass 1 as plain XLA
// (audio_modem_radio_tpu/ops/psk.py _batch_pass1), and so does the port's
// plain version (ops/kernels.py psk_pass1_batch_plain): the window rows cut
// and cast, one dense product with the (ROW+OV, K*256) block-diagonal
// templates, then a chain of elementwise passes over the product.
//
// What it computes. A capture's scored rows are up to three windows of wr
// rows (ops/kernels.py pass1_windows): window row w = (window i, row j)
// holds the 128*spsym samples of row start[i] + j followed by the first ov
// samples of row head[i] + j. With
//     wscale = max(max |x| over every sample of those rows, 1e-12),
// symbol s of a window row (s < 128) has, for each timing offset k < K,
//     z = sum_{j < 2*spsym} (x[s*spsym + j] / wscale) * (T_k[j, 0], T_k[j, 1]),
// T_k the (2*spsym, 2) dual basis that offset k's block-diagonal template
// repeats; z is scaled by sqrt(|G_k z|^2 / (|z|^2 + 1e-20)), G_k offset k's
// Gram matrix. Each row's 127 differentials d = z_{s+1} * conj(z_s) are
// raised to the energy-normalised p-th power (p = 8 for D8PSK, 4 otherwise:
// |d|^2 e^{j p arg d}) and summed over every window row into S_k. Then
//     best  = the first k with the largest hypot(Re S_k, Im S_k),
//     theta = atan2(Im S_best, Re S_best) / p.
// The plain chain sums S_k twice, once for the score and once, after a
// gather, for theta; the sums are the same, so here they are made once.
// The scale is a maximum, so it is the plain chain's to the bit; every
// elementwise step is the plain chain's operations in its order, rounded
// one at a time (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn). Only the
// projection's and the sums' order of addition differ from it.
//
// What bounds it on the H100. For 256 captures of 192 int16 window rows at
// spsym 10: the rows, 138 MB, read twice (the scale, then the sums), 0.08 ms
// at 3.35 TB/s; the projection, 2 * 2*spsym fmaf per symbol and offset
// (4.0e9 flop), and the scoring, 39 operations per symbol and offset
// (2.0e9), 0.09 ms at 67 T/s. The dense product did 70 times the
// projection's multiply-adds: a template column holds 2*spsym nonzero rows
// of 1408.
//
// Design. Three launches on the caller's stream:
// 1. pass1_max_kernel, a block a window row: the row's largest |x|.
// 2. pass1_sums_kernel, a block of 128 threads a window row, a thread a
//    symbol: the block reduces the capture's row maxima to wscale, stages
//    the row and the head of the next as x / wscale in shared memory (one
//    pad word after every spsym samples when spsym is even, so the threads'
//    windows, spsym + 1 words apart, fall in distinct banks), and each
//    thread projects its symbol onto 8 offsets at a time, each sample read
//    once against the offsets' taps (four broadcast 16-byte loads). The
//    scaled phasors go to shared memory, each thread forms its differential
//    with its successor, and the block sums the p-th powers in a fixed
//    order (8 threads a sum, 16 terms each in turn, then a shuffle tree)
//    into the row's partial (Re, Im) per offset.
// 3. pass1_finish_kernel, a block a capture: the rows' partials summed in a
//    fixed order, the argmax and theta.
// Every order is fixed, so a call gives the same bits each time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSym = 128;        // symbols a row
constexpr int kThreads = 128;    // pass1_sums_kernel: a thread a symbol
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;        // offsets a thread projects at once
constexpr int kMaxOffsets = 16;
constexpr int kMaxWindows = 3;
constexpr int kFinishThreads = 256;

struct Windows {
  int wr;                   // rows a window
  int n;                    // windows, 1 to 3
  int start[kMaxWindows];   // a window's first row
  int head[kMaxWindows];    // the row whose first ov samples follow the window's first row
};

// The rows window row w reads: (its own row, the row whose head follows it).
__device__ __forceinline__ void window_rows(const Windows& win, int w, int& own, int& next) {
  const int i = w / win.wr, j = w - i * win.wr;
  own = (i == 0 ? win.start[0] : i == 1 ? win.start[1] : win.start[2]) + j;
  next = (i == 0 ? win.head[0] : i == 1 ? win.head[1] : win.head[2]) + j;
}

// The 16 / sizeof(T) samples of a 16-byte chunk, as float (exact for integers).
template <typename T>
__device__ __forceinline__ void chunk_floats(const uint4& q, float (&v)[16 / sizeof(T)]) {
  constexpr int E = 16 / (int)sizeof(T);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(T) == 2) {
      v[i] = (float)(int16_t)(w[i / 2] >> (16 * (i % 2)));
    } else {
      v[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
    }
  }
}

// The largest of the block's values, in every thread.
template <int kN>
__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();  // red may still be read from an earlier use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < kN / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pass1_max_kernel(const T* __restrict__ x, Windows win, int n_rows, int row, int ov,
                     float* __restrict__ rowmax) {
  __shared__ float red[kWarps];
  constexpr int E = 16 / (int)sizeof(T);
  const int w = blockIdx.x, b = blockIdx.y;
  int own, next;
  window_rows(win, w, own, next);
  const uint4* a = reinterpret_cast<const uint4*>(x + ((long long)b * n_rows + own) * row);
  const uint4* h = reinterpret_cast<const uint4*>(x + ((long long)b * n_rows + next) * row);
  const int n_own = row / E, n_all = n_own + ov / E;
  float m = 0.f;
  for (int q = threadIdx.x; q < n_all; q += kThreads) {
    float v[E];
    chunk_floats<T>(__ldg(q < n_own ? a + q : h + (q - n_own)), v);
#pragma unroll
    for (int i = 0; i < E; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  m = block_max<kThreads>(m, red);
  if (threadIdx.x == 0) rowmax[(long long)b * gridDim.x + w] = m;
}

// Shared memory of pass1_sums_kernel, in floats, and the offsets of its parts.
struct SumsSmem {
  int xs, tw, gs, zs, red, total;
  __host__ __device__ SumsSmem(int spsym, int staged, int kp) {
    const bool pad = spsym % 2 == 0;
    const int xs_words = staged + (pad ? staged / spsym + 1 : 0);
    xs = 0;
    tw = (xs_words + 3) / 4 * 4;           // [2*spsym][kp][2], 16-byte aligned
    gs = tw + 2 * spsym * kp * 2;          // [kp][3]
    zs = (gs + 3 * kp + 3) / 4 * 4;        // float2 [kp][kSym]
    red = zs + 2 * kp * kSym;              // [kWarps]
    total = red + kWarps;
  }
};

// The p-th power of a differential, energy-normalised: |d|^2 e^{j p arg d},
// in ops/psk.py _fourth_power's (and _eighth_power's) operations and order.
template <int P>
__device__ __forceinline__ void power_p(float dr, float di, float& re, float& im) {
  const float a = __fmul_rn(dr, dr), b = __fmul_rn(di, di);
  const float u = __fsub_rn(a, b);
  const float v = __fmul_rn(__fmul_rn(2.f, dr), di);
  const float w = __fadd_rn(__fadd_rn(a, b), 1e-20f);
  const float r4 = __fdiv_rn(__fsub_rn(__fmul_rn(u, u), __fmul_rn(v, v)), w);
  const float i4 = __fdiv_rn(__fmul_rn(__fmul_rn(2.f, u), v), w);
  if constexpr (P == 4) {
    re = r4;
    im = i4;
  } else {
    const float w8 = __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(r4, r4), __fmul_rn(i4, i4))), 1e-20f);
    re = __fdiv_rn(__fsub_rn(__fmul_rn(r4, r4), __fmul_rn(i4, i4)), w8);
    im = __fdiv_rn(__fmul_rn(__fmul_rn(2.f, r4), i4), w8);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    pass1_sums_kernel(const T* __restrict__ x, const float* __restrict__ tmpl, const float* __restrict__ grams,
                      int n_offsets, Windows win, int n_rows, int spsym, int staged,
                      const float* __restrict__ rowmax, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int E = 16 / (int)sizeof(T);
  const int w = blockIdx.x, b = blockIdx.y, nw = gridDim.x, tid = threadIdx.x;
  const int kp = (n_offsets + kGroup - 1) / kGroup * kGroup;
  const int row = kSym * spsym, taps = 2 * spsym;
  const bool pad = spsym % 2 == 0;
  const SumsSmem lay(spsym, staged, kp);
  float* xs = smem + lay.xs;
  float* tw = smem + lay.tw;
  float* gs = smem + lay.gs;
  float2* zs = reinterpret_cast<float2*>(smem + lay.zs);
  float* red = smem + lay.red;

  // The capture's scale: the largest |x| of its window rows, at least 1e-12.
  float m = 0.f;
  for (int i = tid; i < nw; i += kThreads) m = fmaxf(m, rowmax[(long long)b * nw + i]);
  const float wscale = fmaxf(block_max<kThreads>(m, red), 1e-12f);

  // The taps, offsets side by side ([j][k][re, im], zero past n_offsets), and the Gram entries.
  for (int i = tid; i < taps * kp; i += kThreads) {
    const int j = i / kp, k = i - j * kp;
    const bool on = k < n_offsets;
    tw[2 * i] = on ? tmpl[(k * taps + j) * 2] : 0.f;
    tw[2 * i + 1] = on ? tmpl[(k * taps + j) * 2 + 1] : 0.f;
  }
  for (int i = tid; i < 3 * kp; i += kThreads) gs[i] = i < 3 * n_offsets ? grams[i] : 0.f;

  // The row and the next row's head, as x / wscale.
  int own, next;
  window_rows(win, w, own, next);
  const uint4* a = reinterpret_cast<const uint4*>(x + ((long long)b * n_rows + own) * row);
  const uint4* h = reinterpret_cast<const uint4*>(x + ((long long)b * n_rows + next) * row);
  const int n_own = row / E, n_all = staged / E;
  for (int q = tid; q < n_all; q += kThreads) {
    float v[E];
    chunk_floats<T>(__ldg(q < n_own ? a + q : h + (q - n_own)), v);
    // Sample q*E + i's word: the sample index plus the pad words before it.
    int word = q * E, left = spsym;
    if (pad) {
      const int blk = word / spsym;
      word += blk;
      left = spsym * (blk + 1) - q * E;  // samples until the next pad word
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      xs[word] = __fdiv_rn(v[i], wscale);
      ++word;
      if (pad && --left == 0) {
        ++word;
        left = spsym;
      }
    }
  }
  __syncthreads();

  // Each thread's symbol against every offset, 8 at a time: two fmaf chains
  // over j = 0..2*spsym-1 per offset; then the Gram scale.
  const float* xp = xs + tid * (spsym + (pad ? 1 : 0));
  for (int g = 0; g < kp; g += kGroup) {
    float ar[kGroup], ai[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) ar[u] = ai[u] = 0.f;
    for (int j = 0; j < taps; ++j) {
      const float v = xp[j + (pad && j >= spsym ? 1 : 0)];
      const float4* t = reinterpret_cast<const float4*>(tw + (j * kp + g) * 2);
#pragma unroll
      for (int u = 0; u < kGroup / 2; ++u) {
        const float4 q = t[u];
        ar[2 * u] = fmaf(v, q.x, ar[2 * u]);
        ai[2 * u] = fmaf(v, q.y, ai[2 * u]);
        ar[2 * u + 1] = fmaf(v, q.z, ar[2 * u + 1]);
        ai[2 * u + 1] = fmaf(v, q.w, ai[2 * u + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float* gk = gs + 3 * (g + u);
      const float re = ar[u], im = ai[u];
      const float ga = __fadd_rn(__fmul_rn(gk[0], re), __fmul_rn(gk[1], im));
      const float gc = __fadd_rn(__fmul_rn(gk[1], re), __fmul_rn(gk[2], im));
      const float num = __fadd_rn(__fmul_rn(ga, ga), __fmul_rn(gc, gc));
      const float den = __fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), 1e-20f);
      const float s = __fsqrt_rn(__fdiv_rn(num, den));
      zs[(g + u) * kSym + tid] = make_float2(__fmul_rn(re, s), __fmul_rn(im, s));
    }
  }
  __syncthreads();

  // Each thread's differential with its successor (none for the row's last
  // symbol) and its p-th power, 8 offsets at a time; the powers replace the
  // group's phasors in shared memory as [re, im of each offset][symbol], and
  // 8 threads sum each of those 16 rows: 16 symbols each in turn, then the
  // 8 partial sums by a shuffle tree.
  float* out = part + ((long long)b * nw + w) * n_offsets * 2;
  const int v = tid >> 3, j8 = tid & 7;
  for (int g = 0; g < kp; g += kGroup) {
    float pr[kGroup], pi[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      pr[u] = pi[u] = 0.f;
      if (tid < kSym - 1) {
        const float2 z0 = zs[(g + u) * kSym + tid], z1 = zs[(g + u) * kSym + tid + 1];
        const float dr = __fadd_rn(__fmul_rn(z1.x, z0.x), __fmul_rn(z1.y, z0.y));
        const float di = __fsub_rn(__fmul_rn(z1.y, z0.x), __fmul_rn(z1.x, z0.y));
        power_p<P>(dr, di, pr[u], pi[u]);
      }
    }
    __syncthreads();  // every phasor of the group is read
    float* acc = reinterpret_cast<float*>(zs + g * kSym);  // [2 * kGroup][kSym]
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      acc[(2 * u) * kSym + tid] = pr[u];
      acc[(2 * u + 1) * kSym + tid] = pi[u];
    }
    __syncthreads();
    const float* src = acc + v * kSym + j8 * (kSym / 8);
    float s = src[0];
#pragma unroll
    for (int i = 1; i < kSym / 8; ++i) s += src[i];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (j8 == 0 && g + v / 2 < n_offsets) out[2 * g + v] = s;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    pass1_finish_kernel(const float* __restrict__ part, int nw, int n_offsets, int power,
                        int* __restrict__ best, float* __restrict__ theta) {
  constexpr int kSlices = kFinishThreads / 32;
  __shared__ float red[kSlices][32];
  const int b = blockIdx.x, pair = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int n_pairs = 2 * n_offsets;
  const float* p = part + (long long)b * nw * n_pairs;
  float s = 0.f;
  if (pair < n_pairs)
    for (int w = slice; w < nw; w += kSlices) s += p[(long long)w * n_pairs + pair];
  red[slice][pair] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = red[0][pair];
#pragma unroll
    for (int i = 1; i < kSlices; ++i) t += red[i][pair];
    red[0][pair] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // torch.argmax: the first maximum, a NaN counting as the largest.
    int k_best = 0;
    float top = hypotf(red[0][0], red[0][1]);
    for (int k = 1; k < n_offsets; ++k) {
      const float sc = hypotf(red[0][2 * k], red[0][2 * k + 1]);
      if (sc > top || (isnan(sc) && !isnan(top))) {
        top = sc;
        k_best = k;
      }
    }
    best[b] = k_best;
    theta[b] = __fdiv_rn(atan2f(red[0][2 * k_best + 1], red[0][2 * k_best]), (float)power);
  }
}

template <typename T, int P>
int launch(const void* x, const float* tmpl, const float* grams, int n_offsets, int n_captures, int n_rows,
           int spsym, int ov, const Windows& win, float* rowmax, float* part, int* best, float* theta,
           cudaStream_t st) {
  constexpr int E = 16 / (int)sizeof(T);
  const int row = kSym * spsym, nw = win.n * win.wr;
  // The samples a row's last symbol reads past the row, in whole chunks.
  const int staged = row + (spsym + E - 1) / E * E;
  const int kp = (n_offsets + kGroup - 1) / kGroup * kGroup;
  const size_t smem = sizeof(float) * (size_t)SumsSmem(spsym, staged, kp).total;
  const T* xt = static_cast<const T*>(x);
  const dim3 grid((unsigned)nw, (unsigned)n_captures);
  pass1_max_kernel<T><<<grid, kThreads, 0, st>>>(xt, win, n_rows, row, ov, rowmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass1_sums_kernel<T, P><<<grid, kThreads, smem, st>>>(xt, tmpl, grams, n_offsets, win, n_rows, spsym, staged,
                                                       rowmax, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass1_finish_kernel<<<(unsigned)n_captures, kFinishThreads, 0, st>>>(part, nw, n_offsets, P, best, theta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_power(int power, const void* x, const float* tmpl, const float* grams, int n_offsets, int n_captures,
                 int n_rows, int spsym, int ov, const Windows& win, float* rowmax, float* part, int* best,
                 float* theta, cudaStream_t st) {
  if (power == 4)
    return launch<T, 4>(x, tmpl, grams, n_offsets, n_captures, n_rows, spsym, ov, win, rowmax, part, best, theta,
                        st);
  return launch<T, 8>(x, tmpl, grams, n_offsets, n_captures, n_rows, spsym, ov, win, rowmax, part, best, theta, st);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8. x is (n_captures, n_rows,
// 128*spsym) contiguous and 16-byte aligned; power 4 or 8; tmpl (n_offsets,
// 2*spsym, 2) float32, the offsets' dual bases; grams (n_offsets, 3)
// float32; windows the host array {wr, n, start0, head0, start1, head1,
// start2, head2} (n of 1 to 3 windows of wr rows; a window's rows and their
// heads' rows inside the capture); ov the samples a row's scale reads past
// it (ov * sizeof(T) a multiple of 16, ov >= spsym). Scratch: rowmax
// (n_captures, n*wr) and part (n_captures, n*wr, n_offsets, 2) float32.
// Out: best (n_captures,) int32, theta (n_captures,) float32. Returns the
// cudaError_t of the launches.
extern "C" int amr_psk_pass1(const void* x, int dtype, int power, const float* tmpl, const float* grams,
                             int n_offsets, int n_captures, int n_rows, int spsym, int ov, const int* windows,
                             float* rowmax, float* part, int* best, float* theta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Windows win;
  win.wr = windows[0];
  win.n = windows[1];
  if (win.n < 1 || win.n > kMaxWindows || win.wr < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxWindows; ++i) {
    win.start[i] = i < win.n ? windows[2 + 2 * i] : 0;
    win.head[i] = i < win.n ? windows[3 + 2 * i] : 0;
    if (win.start[i] < 0 || win.head[i] < 0 || win.start[i] + win.wr > n_rows || win.head[i] + win.wr > n_rows)
      return (int)cudaErrorInvalidValue;
  }
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 1;
  if (dtype < 0 || dtype > 2 || (power != 4 && power != 8) || n_offsets < 1 || n_offsets > kMaxOffsets ||
      n_captures < 1 || n_captures > 65535 || spsym < 1 || spsym > 32 || ov < spsym || (ov * size) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_power<float>(power, x, tmpl, grams, n_offsets, n_captures, n_rows, spsym, ov, win, rowmax, part,
                                 best, theta, st);
    case 1:
      return launch_power<int16_t>(power, x, tmpl, grams, n_offsets, n_captures, n_rows, spsym, ov, win, rowmax,
                                   part, best, theta, st);
    default:
      return launch_power<int8_t>(power, x, tmpl, grams, n_offsets, n_captures, n_rows, spsym, ov, win, rowmax,
                                  part, best, theta, st);
  }
}
