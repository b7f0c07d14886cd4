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
// Each z_t is two fmaf chains over j = 0..2*spsym-1 in that order, and the
// differential, derotation and 8PSK products are explicit round-to-nearest
// operations in the plain version's order, so only the projection's
// summation order differs from the plain PyTorch version, and the decisions
// equal those of every earlier design of this kernel bit for bit.
//
// What bounds it on the H100: device memory. Per symbol it reads spsym samples
// (20 B as int16 at 9600 Bd, spsym = 10) and writes 2 B (1 B for 8PSK), against
// 4*spsym FMAs: about 4 flop/B, far below the card's ~20 flop/B float32 ridge
// (67 TFLOP/s over 3.35 TB/s, published H100 SXM peaks). The dense TPU
// formulation multiplies each 1408-sample overlap row by all 256 template
// columns, about 70x the multiplies, which a matrix unit absorbs and CUDA
// cores would not.
//
// Design. The first design (one short-lived block per 256 symbols: scalar
// staging loads, then a barrier, then one thread's serial correlation) was
// paced by load latency, not bytes: int8 rows took longer than int16 rows.
// Here a persistent grid of one wave (as many blocks a multiprocessor as fit,
// split evenly over the captures) walks tiles of kThreads*K symbols of one
// capture, K = 8 / sizeof(T) (4 for int16, 8 for int8, 2 for float32), so a
// thread's K symbols span 8*spsym bytes. Per tile the block copies the
// (tile+2)*spsym samples its windows touch into shared memory in their storage
// type, in 16-byte cp.async chunks past L1 (zero-filled past the capture's
// end), while it correlates the previous tile from the other buffer: the
// loads stay in flight and int8 rows move half the bytes of int16. Each
// thread computes the phasors of its K symbols and of the next one (the
// warp's last lane needs that one anyway, and a warp issues a lane's extra
// work for all its lanes, so a shuffle from the neighbour would save nothing).
// For spsym 10 and 8 (every carried PSK mode at 9600 and 12000 Bd) spsym is a
// template parameter: a thread reads its (K+2)*spsym samples with 16-byte
// shared loads into registers, converts each sample once (integers by an
// exact float bit trick, no I2F) and feeds it to the two symbols whose windows
// hold it, against template columns held in registers. A thread's window
// starts spsym/2 chunks after its neighbour's; where that is even (spsym 8) a
// pad chunk follows every spsym/2 staged chunks, so the 8 threads of a
// quarter-warp always read 8 different 16-byte bank groups. Other spsym
// (1..32) run the same tile walk with scalar shared reads and the template in
// shared memory. Each thread writes its K decision bytes with one vector store.
// The rows must start on a 16-byte boundary (the wrapper checks; R is even, so
// every capture and tile then does too).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 6 and
// kernel_variants.py --kernel decide, PERF.md section 6), at 64 x 2^24
// samples: on int16 rows 0.92-0.94 ms through the wrapper at n_psk 4 (0.85
// ms alone, 85% of the 0.716 ms bytes bound), 0.89-0.97 ms at n_psk 2 and 8;
// on int8 rows 0.54-0.56 ms (bound 0.39 ms). The first design took 2.70-2.89
// ms on either; the decisions equal its decisions on every symbol. 32 to 40
// registers on integer rows, 64 on float32 (the template columns sit in
// uniform registers), no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 16-byte chunks a tile of ``tile`` symbols stages: samples [0, (tile+2)*spsym).
__host__ __device__ constexpr int tile_chunks(int tile, int spsym, int bytes) {
  return ((tile + 2) * spsym * bytes + 15) / 16;
}

// Staged chunk c's place in the shared buffer: for a specialised spsym whose
// thread stride q = spsym/2 chunks is even, one pad chunk after every q.
template <int S>
struct Layout {
  static constexpr int kQ = S / 2;
  static constexpr bool kPad = S > 0 && kQ % 2 == 0;
  __host__ __device__ static constexpr int place(int c) { return kPad ? c + c / (kQ > 0 ? kQ : 1) : c; }
  __host__ __device__ static constexpr int buf_chunks(int n_chunks) {
    return kPad ? place(n_chunks - 1) + 1 : n_chunks;
  }
};

// Sample m of a thread's window held as 32-bit words, as float: integers by
// placing the offset-binary value in a float's mantissa (2^23 + v + 2^15 for
// int16, + 2^7 for int8) and subtracting the offset, which is exact.
template <typename T, int N>
__device__ __forceinline__ float unpack(const uint32_t (&w)[N], int m) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[m]);
  } else if constexpr (sizeof(T) == 2) {
    const uint32_t q = w[m >> 1] ^ 0x80008000u;
    return __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, (m & 1) ? 0x7432 : 0x7410)), 8421376.f);
  } else {
    const uint32_t q = w[m >> 2] ^ 0x80808080u;
    return __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | (m & 3))), 8388736.f);
  }
}

// The K+1 phasors of a thread's symbols, spsym = S a compile-time constant:
// the (K+2)*S samples by 16-byte shared loads, each converted once and fed to
// tap j of its own symbol and tap S+j of the one before, so each symbol's
// taps still run j = 0..2S-1 in order.
template <typename T, int S, int K>
__device__ __forceinline__ void project_fixed(const uint4* buf, const float (&tr)[2 * S],
                                              const float (&ti)[2 * S], float (&zr)[K + 1],
                                              float (&zi)[K + 1]) {
  using L = Layout<S>;
  constexpr int kSamples = (K + 2) * S;
  constexpr int kChunks = (kSamples * (int)sizeof(T) + 15) / 16;
  uint32_t w[4 * kChunks];
  const uint4* src = buf + threadIdx.x * (L::kQ | 1);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const uint4 q = src[L::kPad ? j + j / L::kQ : j];
    w[4 * j] = q.x;
    w[4 * j + 1] = q.y;
    w[4 * j + 2] = q.z;
    w[4 * j + 3] = q.w;
  }
#pragma unroll
  for (int u = 0; u <= K; ++u) zr[u] = zi[u] = 0.f;
#pragma unroll
  for (int m = 0; m < kSamples; ++m) {
    const float v = unpack<T>(w, m);
    const int u = m / S, j = m % S;
    if (u <= K) {
      zr[u] = fmaf(v, tr[j], zr[u]);
      zi[u] = fmaf(v, ti[j], zi[u]);
    }
    if (u >= 1) {
      zr[u - 1] = fmaf(v, tr[S + j], zr[u - 1]);
      zi[u - 1] = fmaf(v, ti[S + j], zi[u - 1]);
    }
  }
}

// The same for any spsym: scalar shared reads, the (2*spsym, 2) template in
// shared memory.
template <typename T, int K>
__device__ __forceinline__ void project_any(const uint4* buf, const float2* tw, int spsym,
                                            float (&zr)[K + 1], float (&zi)[K + 1]) {
  const T* xs = reinterpret_cast<const T*>(buf) + threadIdx.x * K * spsym;
  const int win = 2 * spsym;
#pragma unroll
  for (int u = 0; u <= K; ++u) {
    const T* p = xs + u * spsym;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < win; ++j) {
      const float v = static_cast<float>(p[j]);
      const float2 t = tw[j];
      ar = fmaf(v, t.x, ar);
      ai = fmaf(v, t.y, ai);
    }
    zr[u] = ar;
    zi[u] = ai;
  }
}

// K bytes from one thread as one vector store (the address is K-aligned).
template <int K>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t (&v)[K]) {
  if constexpr (K == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(v[0] | (v[1] << 8));
  } else if constexpr (K == 4) {
    *reinterpret_cast<uint32_t*>(dst) = v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
  } else {
    uint2 q;
    q.x = v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
    q.y = v[4] | (v[5] << 8) | (v[6] << 16) | ((uint32_t)v[7] << 24);
    *reinterpret_cast<uint2*>(dst) = q;
  }
}

// S: spsym as a compile-time constant, or 0 for any spsym (the argument).
template <typename T, int NPSK, int S>
__global__ void __launch_bounds__(kThreads)
    decide_kernel(const T* __restrict__ x, const float* __restrict__ tmpl,
                  const int* __restrict__ best, const float* __restrict__ rot,
                  uint8_t* __restrict__ hi, uint8_t* __restrict__ lo, int per_capture,
                  int n_tiles, long long sym_per_capture, int spsym, int buf_chunks) {
  constexpr int K = 8 / (int)sizeof(T);
  constexpr int kTile = kThreads * K;
  using L = Layout<S>;
  extern __shared__ uint4 smem[];  // S == 0: the template first; then two tile buffers
  const int b = blockIdx.x / per_capture;
  const int first_tile = blockIdx.x % per_capture;
  const int win = 2 * spsym;
  const float* tb = tmpl + (long long)best[b] * 2 * win;

  constexpr int kTr = S > 0 ? 2 * S : 1;
  float tr[kTr], ti[kTr];
  uint4* bufs = smem;
  if constexpr (S > 0) {
#pragma unroll
    for (int j = 0; j < 2 * S; ++j) {
      tr[j] = __ldg(tb + 2 * j);
      ti[j] = __ldg(tb + 2 * j + 1);
    }
  } else {
    float* tw = reinterpret_cast<float*>(smem);
    for (int j = threadIdx.x; j < 2 * win; j += kThreads) tw[j] = tb[j];
    bufs = smem + 32;  // 2 * 2 * 32 floats
  }
  const float c = rot[2 * b], s = rot[2 * b + 1];

  const long long n_bytes = sym_per_capture * spsym * (long long)sizeof(T);  // a multiple of 256
  const char* xc = reinterpret_cast<const char*>(x) + b * n_bytes;
  const int n_chunks = tile_chunks(kTile, spsym, (int)sizeof(T));
  auto stage = [&](int tile, uint4* buf) {
    const long long byte0 = (long long)tile * kTile * spsym * (long long)sizeof(T);
    const unsigned d = (unsigned)__cvta_generic_to_shared(buf);
    for (int q = threadIdx.x; q < n_chunks; q += kThreads) {
      const long long g = byte0 + 16LL * q;
      const int bytes = g < n_bytes ? 16 : 0;  // whole chunks: n_bytes is a multiple of 16
      const void* from = bytes ? static_cast<const void*>(xc + g) : static_cast<const void*>(xc);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d + 16 * L::place(q)),
                   "l"(from), "r"(bytes));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int i = 0;
  if (first_tile < n_tiles) stage(first_tile, bufs);
  for (int tile = first_tile; tile < n_tiles; tile += per_capture, ++i) {
    // Stage the next tile into the other buffer while this one is correlated.
    const int next = tile + per_capture;
    if (next < n_tiles) {
      stage(next, bufs + ((i + 1) & 1) * buf_chunks);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint4* buf = bufs + (i & 1) * buf_chunks;
    float zr[K + 1], zi[K + 1];
    if constexpr (S > 0) {
      project_fixed<T, S, K>(buf, tr, ti, zr, zi);
    } else {
      project_any<T, K>(buf, reinterpret_cast<const float2*>(smem), spsym, zr, zi);
    }
    uint8_t h[K], l[K];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float r0 = zr[u], i0 = zi[u], r1 = zr[u + 1], i1 = zi[u + 1];
      const float d_re = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
      const float d_im = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
      const float dr = __fadd_rn(__fmul_rn(d_re, c), __fmul_rn(d_im, s));
      const float di = __fsub_rn(__fmul_rn(d_im, c), __fmul_rn(d_re, s));
      if constexpr (NPSK == 4) {
        const bool swap = fabsf(di) > fabsf(dr);
        const bool neg = (swap ? di : dr) < 0.f;
        h[u] = neg;
        l[u] = neg ^ swap;
      } else if constexpr (NPSK == 2) {
        h[u] = dr < 0.f;
        l[u] = di < 0.f;
      } else {
        const float t = 0.41421356f;
        const float ax = fabsf(dr), bx = fabsf(di);
        const bool diag = bx > __fmul_rn(t, ax) && ax > __fmul_rn(t, bx);
        int k;
        if (diag)
          k = di >= 0.f ? (dr >= 0.f ? 1 : 3) : (dr >= 0.f ? 7 : 5);
        else
          k = ax >= bx ? (dr >= 0.f ? 0 : 4) : (di >= 0.f ? 2 : 6);
        h[u] = (uint8_t)k;
        l[u] = 0;
      }
    }
    // A capture holds a multiple of 256 symbols, so a thread's K are all
    // inside it or all past it (a ragged last tile).
    const long long t0 = (long long)tile * kTile + threadIdx.x * K;
    if (t0 < sym_per_capture) {
      const long long o = b * sym_per_capture + t0;
      store_bytes<K>(hi + o, h);
      if constexpr (NPSK != 8) store_bytes<K>(lo + o, l);
    }
    __syncthreads();  // this buffer is staged again two tiles on
  }
}

template <typename T, int NPSK, int S>
int launch(const void* x, const float* tmpl, const int* best, const float* rot, uint8_t* hi,
           uint8_t* lo, int n_captures, int rows, int spsym, cudaStream_t stream) {
  constexpr int K = 8 / (int)sizeof(T);
  constexpr int kTile = kThreads * K;
  const long long sym_per_capture = (long long)rows * 128;
  const int n_tiles = (int)((sym_per_capture + kTile - 1) / kTile);
  const int buf_chunks = Layout<S>::buf_chunks(tile_chunks(kTile, spsym, (int)sizeof(T)));
  const size_t smem = 16 * ((size_t)2 * buf_chunks + (S > 0 ? 0 : 32));
  auto kernel = decide_kernel<T, NPSK, S>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // One wave: every block resident at once, each walking tiles of one capture.
  long long per_capture = (long long)per_sm * sms / n_captures;
  if (per_capture < 1) per_capture = 1;
  if (per_capture > n_tiles) per_capture = n_tiles;
  const long long n_blocks = per_capture * n_captures;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)n_blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), tmpl, best, rot, hi, lo,
                                                         (int)per_capture, n_tiles, sym_per_capture, spsym,
                                                         buf_chunks);
  return (int)cudaGetLastError();
}

template <typename T, int NPSK>
int launch_spsym(const void* x, const float* tmpl, const int* best, const float* rot, uint8_t* hi,
                 uint8_t* lo, int n_captures, int rows, int spsym, cudaStream_t stream) {
  switch (spsym) {
    case 10:
      return launch<T, NPSK, 10>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    case 8:
      return launch<T, NPSK, 8>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    default:
      return launch<T, NPSK, 0>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
  }
}

template <typename T>
int launch_psk(int n_psk, const void* x, const float* tmpl, const int* best, const float* rot,
               uint8_t* hi, uint8_t* lo, int n_captures, int rows, int spsym,
               cudaStream_t stream) {
  switch (n_psk) {
    case 2:
      return launch_spsym<T, 2>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    case 4:
      return launch_spsym<T, 4>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    case 8:
      return launch_spsym<T, 8>(x, tmpl, best, rot, hi, lo, n_captures, rows, spsym, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8. x is (n_captures, rows, 128*spsym)
// contiguous and 16-byte aligned; tmpl is (n_offsets, 2*spsym, 2) float32;
// best (n_captures,) int32; rot (n_captures, 2) float32; hi/lo (n_captures,
// rows, 128) uint8, lo unused (may be null) for n_psk = 8. rows must be even
// and 1 <= spsym <= 32. Returns the cudaError_t of the launch.
extern "C" int amr_decide(const void* x, int dtype, int n_psk, const float* tmpl,
                          const int* best, const float* rot, uint8_t* hi, uint8_t* lo,
                          int n_captures, int rows, int spsym, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_psk != 8 && lo == nullptr) return (int)cudaErrorInvalidValue;
  if (rows < 2 || rows % 2 != 0 || spsym < 1 || spsym > 32 || n_captures < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
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
