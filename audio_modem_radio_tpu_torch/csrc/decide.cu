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
// Here the tile walk of psk_tile.cuh (shared with K11/K12, project_diff.cu)
// computes each thread's K+1 phasors per tile of a one-wave persistent grid
// from a two-buffer cp.async ring of samples in their storage type; this
// kernel derotates and decides them and writes each thread's K decision bytes
// with one vector store.
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

#include "psk_tile.cuh"

namespace {

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
__global__ void __launch_bounds__(kTileThreads)
    decide_kernel(const T* __restrict__ x, const float* __restrict__ tmpl,
                  const int* __restrict__ best, const float* __restrict__ rot,
                  uint8_t* __restrict__ hi, uint8_t* __restrict__ lo, int per_capture,
                  int n_tiles, long long sym_per_capture, int spsym, int buf_chunks) {
  constexpr int K = 8 / (int)sizeof(T);
  const int b = blockIdx.x / per_capture;
  const float* tb = tmpl + (long long)best[b] * 4 * spsym;
  const float c = rot[2 * b], s = rot[2 * b + 1];
  walk_tiles<T, S>(x, tb, b, blockIdx.x % per_capture, per_capture, n_tiles, sym_per_capture, spsym,
                   buf_chunks, [&](long long t0, const float (&zr)[K + 1], const float (&zi)[K + 1]) {
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
    if (t0 < sym_per_capture) {
      const long long o = b * sym_per_capture + t0;
      store_bytes<K>(hi + o, h);
      if constexpr (NPSK != 8) store_bytes<K>(lo + o, l);
    }
  });
}

template <typename T, int NPSK, int S>
int launch(const void* x, const float* tmpl, const int* best, const float* rot, uint8_t* hi,
           uint8_t* lo, int n_captures, int rows, int spsym, cudaStream_t stream) {
  constexpr int kTile = kTileThreads * (8 / (int)sizeof(T));
  const long long sym_per_capture = (long long)rows * 128;
  const int n_tiles = (int)((sym_per_capture + kTile - 1) / kTile);
  const int buf_chunks = Layout<S>::buf_chunks(tile_chunks(kTile, spsym, (int)sizeof(T)));
  const size_t smem = walk_smem_bytes<S>(buf_chunks);
  auto kernel = decide_kernel<T, NPSK, S>;
  int per_capture = 0;
  long long n_blocks = 0;
  const cudaError_t err = wave_grid(kernel, smem, n_captures, n_tiles, &per_capture, &n_blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_blocks, kTileThreads, smem, stream>>>(static_cast<const T*>(x), tmpl, best, rot, hi,
                                                             lo, per_capture, n_tiles, sym_per_capture,
                                                             spsym, buf_chunks);
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
