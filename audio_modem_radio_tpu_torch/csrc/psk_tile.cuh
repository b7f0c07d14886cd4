// The PSK tile walk that K1 (decide.cu) and K11/K12 (project_diff.cu) share:
// a capture's symbol phasors against the winning offset's dual basis.
//
// Capture b is a flat stream x[b, 0 : R*128*spsym) stored as (R, 128*spsym)
// rows; samples past the capture's end read as zero. Symbol t has the phasor
//     z_t = sum_{j < 2*spsym} x[t*spsym + j] * (tb[2j], tb[2j+1]),
// tb the (2*spsym, 2) template columns of the capture's offset: two fmaf
// chains over j = 0..2*spsym-1 in that order, starting from 0.f, so every
// phasor is the same float whatever the tile, the layout or the caller.
//
// Design (measured on K1, PERF.md section 6). A persistent grid of one
// wave (as many kTileThreads-thread blocks a multiprocessor as fit, split
// evenly over the captures) walks tiles of kTileThreads*K symbols of one
// capture, K = 8 / sizeof(T) (4 for int16, 8 for int8, 2 for float32), so a
// thread's K symbols span 8*spsym bytes. Per tile the block copies the
// (tile+2)*spsym samples its windows touch into shared memory in their
// storage type, in 16-byte cp.async chunks past L1 (zero-filled past the
// capture's end), while it correlates the previous tile from the other
// buffer: the loads stay in flight and narrow samples move fewer bytes. Each
// thread computes the phasors of its K symbols and of the next one (the
// warp's last lane needs that one anyway, and a warp issues a lane's extra
// work for all its lanes, so a shuffle from the neighbour would save
// nothing). For spsym 10 and 8 (every carried PSK mode at 9600 and 12000 Bd)
// spsym is a template parameter: a thread reads its (K+2)*spsym samples with
// 16-byte shared loads into registers, converts each sample once (integers
// by an exact float bit trick, no I2F) and feeds it to the two symbols whose
// windows hold it, against template columns held in (uniform) registers. A
// thread's window starts spsym/2 chunks after its neighbour's; where that is
// even (spsym 8) a pad chunk follows every spsym/2 staged chunks, so the 8
// threads of a quarter-warp always read 8 different 16-byte bank groups.
// Other spsym (1..32) run the same tile walk with scalar shared reads and the
// template in shared memory. The rows must start on a 16-byte boundary (the
// wrappers check; R is even, so every capture and tile then does too).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "one_wave.cuh"

namespace {

constexpr int kTileThreads = 256;

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

// Shared memory of a tile walk: two tile buffers, after the template for the
// generic spsym (S == 0).
template <int S>
__host__ __device__ constexpr size_t walk_smem_bytes(int buf_chunks) {
  return 16 * ((size_t)2 * buf_chunks + (S > 0 ? 0 : 32));
}

// Block blockIdx.x walks tiles first_tile, first_tile + per_capture, ... of
// capture b and calls emit(t0, zr, zi) once per tile: t0 is the thread's
// first symbol in the capture (its K symbols are all inside the capture or
// all past it: a capture holds a multiple of 256 symbols), zr/zi the K+1
// phasors of symbols t0..t0+K. tb is the capture's (2*spsym, 2) template.
template <typename T, int S, typename Emit>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ x, const float* __restrict__ tb, int b,
                                           int first_tile, int per_capture, int n_tiles,
                                           long long sym_per_capture, int spsym, int buf_chunks,
                                           Emit&& emit) {
  constexpr int K = 8 / (int)sizeof(T);
  constexpr int kTile = kTileThreads * K;
  using L = Layout<S>;
  extern __shared__ uint4 smem[];  // S == 0: the template first; then two tile buffers
  const int win = 2 * spsym;

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
    for (int j = threadIdx.x; j < 2 * win; j += kTileThreads) tw[j] = tb[j];
    bufs = smem + 32;  // 2 * 2 * 32 floats
  }

  const long long n_bytes = sym_per_capture * spsym * (long long)sizeof(T);  // a multiple of 256
  const char* xc = reinterpret_cast<const char*>(x) + b * n_bytes;
  const int n_chunks = tile_chunks(kTile, spsym, (int)sizeof(T));
  auto stage = [&](int tile, uint4* buf) {
    const long long byte0 = (long long)tile * kTile * spsym * (long long)sizeof(T);
    const unsigned d = (unsigned)__cvta_generic_to_shared(buf);
    for (int q = threadIdx.x; q < n_chunks; q += kTileThreads) {
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
    emit((long long)tile * kTile + threadIdx.x * K, zr, zi);
    __syncthreads();  // this buffer is staged again two tiles on
  }
}

// The one-wave grid of ``kernel`` with ``smem`` dynamic bytes over
// n_captures captures of n_tiles tiles: the resident blocks split evenly over
// the captures, at least one and at most n_tiles a capture.
template <typename Kernel>
__host__ cudaError_t wave_grid(Kernel kernel, size_t smem, int n_captures, int n_tiles, int* per_capture,
                               long long* n_blocks) {
  long long wave = 0;
  const cudaError_t err = one_wave_blocks(kernel, kTileThreads, smem, &wave);
  if (err != cudaSuccess) return err;
  long long pc = wave / n_captures;
  if (pc < 1) pc = 1;
  if (pc > n_tiles) pc = n_tiles;
  *per_capture = (int)pc;
  *n_blocks = pc * n_captures;
  return *n_blocks > 0x7fffffffLL ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace
