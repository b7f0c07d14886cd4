// K7 and K13: batched dual-tone FSK projection + mark/space energy decision.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py fsk_tile_bits_batch (K7,
// body _kernel_fsk_tile, over host-overlapped rows) and fsk_project_bits_batch
// (K13, body _kernel_fsk_decide, over flat rows whose overlap is the next row).
//
// What it computes. Bit s of row j of capture b, at the capture's winning
// offset k = best[b], correlates its samples with the four dual-basis columns
// {mark, space} x {sin, cos} of ops/fsk.py _fsk_blocked_templates:
//     a_g = sum_{t < span} x[j, first[k, s] + t] * tab[k, g, t, s],   g = 0..3,
// and bit = (a_0^2 + a_1^2) - (a_2^2 + a_3^2) > 0. tab and first are the
// template compacted to each bit's band by the wrapper (ops/kernels.py
// _band_tables): the dense (row+ov, 4*spr) matrix the TPU kernel multiplies by
// is 94% zeros at FSK1200. K7 reads row j of the (R, row+ov) overlapped rows;
// K13 reads the flat stream of (R, row) rows at j*row + column, so the
// overlap columns are the next row's head and samples past the capture's
// last row are zero, as in the plain version (the TPU kernel read the next
// capture there). Integer rows are cast to float without scaling. Both sum
// each a_g over t = 0..span-1 in order, so K13's bits equal K7's on the same
// samples.
//
// What bounds it on the H100: device memory. Per bit it reads its row's share
// of the samples (about spb+ov/spr int16 at FSK1200, 2.4 GB for 64 captures of
// 2^24 samples, 0.72 ms at 3.35 TB/s; K13's flat float32 rows 4.3 GB, 1.31
// ms) against 4*spb FMAs, about 4 flop/B, under the float32 ridge of 20 flop/B.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 6,
// profile_slice.py --flat and kernel_variants.py, PERF.md section 6): K13
// 1.58 ms alone, 1.70 ms through its wrapper, 83% and 77% of its bound (the
// one-thread-a-bit K13: 4.61 and 5.98 ms, 22%). K7 at FSK1200 on int16 rows:
// 0.81-0.82 ms through its wrapper, 0.75 ms alone (89% and 96% of its 0.72
// ms bound; the one-thread-a-bit K7: 2.36-2.38 ms, 30%), its bits equal to
// that kernel's; a thread summing 1 or 2 rows of a bit instead of 4 took the
// same time.
//
// K7's design. The first K7 (one thread a bit, a block per 256 bits, each
// block copying its capture's whole band table, each thread reading its bit's
// samples with scalar loads straight from device memory) was limited by L1
// wavefronts, as the first K13 was: neighbouring bits lie spb samples apart,
// so a warp-wide load touched some 32 sectors. Now a persistent one-wave grid
// (one block a multiprocessor, split evenly over the captures) walks tiles of
// up to kK7TileRows overlapped rows of one capture. Every row starts on a
// 16-byte boundary (row+ov is a multiple of 128; the wrapper rejects a
// misaligned view), so each row's band [lo, hi) of the capture's offset is
// the same run of 16-byte chunks, staged with cp.async past L1 in the
// storage type (int16 converted at the shared read, 8 samples a 16-byte
// load, by an exact float bit trick, no I2F), the next tile while this one is
// correlated. The capture's (4, span, spr) table is staged once per block as
// (spr, span) float4s. A thread owns bit s of kRowsPerItem rows of the tile,
// so each t's float4 of weights feeds 4*kRowsPerItem FMAs; its rows lie
// G = ceil(rows/kRowsPerItem) apart, so a quarter-warp reads one bit of 8
// consecutive rows, whose shared rows lie an odd number of chunks apart: 8
// different chunks of banks. K7 reads within its own rows, so it needs no
// zero fill and no next-row logic.
//
// K13's design. A thread that reads its own bit's samples from device memory
// makes every warp-wide load touch 32 cache lines (its bits lie spb samples
// apart): the first K13 ran at 22% of the bytes bound, limited by L1
// wavefronts. Here a block walks tiles of kTileRows consecutive rows of one
// capture. For each it stages, per row, the band [j*row + lo, j*row + hi) of
// the flat stream that the row's bits read (lo..hi: the band of the
// capture's offset; a row's tail and the next row's head are both staged
// where the band is wider than a row) in whole 16-byte chunks with cp.async
// into a shared-memory row, zero-filled past the capture's end (int16 rows
// are converted sample by sample instead). The next tile is staged while this
// one is correlated, so the loads stay in flight; the grid is one wave of
// kFlatBlocks blocks a multiprocessor. A thread owns one (row, s) of the tile
// and sums t = 0..span-1 with 16-byte shared loads of its samples and of the
// capture's (spr, span, 4) weights (staged once per block). Shared rows lie
// an odd number of chunks apart, so the 8 rows a quarter-warp reads for one
// bit s fall in 8 different chunks of banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "one_wave.cuh"

namespace {

constexpr int kRowsPerItem = 4;                      // K7 rows a thread sums for one bit
constexpr int kK7TileRows = 32;                       // K7 rows a tile buffer holds at most
constexpr int kTileThreads = 16 * kK7TileRows / kRowsPerItem;  // one item each at FSK1200 (spr 16)
constexpr int kK7Smem = 220 * 1024;                   // a K7 block's shared memory at most: one a multiprocessor
constexpr int kTileRows = 8;       // flat rows a K13 tile buffer holds
constexpr int kFlatThreads = 128;  // one (row, bit) of a tile each at FSK1200
constexpr int kFlatBlocks = 2;     // K13 blocks a multiprocessor
constexpr int kFlatSmem = 224 * 1024 / kFlatBlocks;  // a K13 block's shared memory at most

// One sample's four multiply-adds into a bit's sums, in K7's and K13's order.
__device__ __forceinline__ void acc4(float (&a)[4], float v, float4 w) {
  a[0] = fmaf(v, w.x, a[0]);
  a[1] = fmaf(v, w.y, a[1]);
  a[2] = fmaf(v, w.z, a[2]);
  a[3] = fmaf(v, w.w, a[3]);
}

// The band [band[0], band[1]) of a row that the bits of one offset read,
// from its (spr,) first samples; visible to the block after its next barrier.
__device__ __forceinline__ void offset_band(const int* fk, int spr, int span, int* band) {
  if (threadIdx.x == 0) {
    band[0] = 0x7fffffff;
    band[1] = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < spr; s += blockDim.x) {
    atomicMin(&band[0], fk[s]);
    atomicMax(&band[1], fk[s] + span);
  }
}

// --- K7 -------------------------------------------------------------------------------

// Sample i of a 16-byte chunk as float: float32 as is; int16 by placing the
// offset-binary value in a float's mantissa (2^23 + v + 2^15) and
// subtracting the offset, which is exact (no I2F).
__device__ __forceinline__ float chunk_sample(const uint4& q, int i, float) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float chunk_sample(const uint4& q, int i, int16_t) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  const uint32_t u = w[i >> 1] ^ 0x80008000u;
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, (i & 1) ? 0x7432 : 0x7410)), 8421376.f);
}

// The four sums of kRowsPerItem rows of one bit over t = 0..span-1 in order:
// each row's samples from shared memory 16 bytes at a time (the first M of
// the first chunk skipped), each t's float4 of weights read once for all rows.
template <typename T, int M>
__device__ __forceinline__ void correlate_rows(const uint4* const (&xr)[kRowsPerItem], const float4* w,
                                               int span, float (&a)[kRowsPerItem][4]) {
  constexpr int E = 16 / (int)sizeof(T);  // samples a chunk
  int t = 0, c = 0;
  {
    uint4 q[kRowsPerItem];
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) q[r] = xr[r][0];
#pragma unroll
    for (int i = M; i < E; ++i, ++t) {
      if (t < span) {
        const float4 wt = w[t];
#pragma unroll
        for (int r = 0; r < kRowsPerItem; ++r) acc4(a[r], chunk_sample(q[r], i, T()), wt);
      }
    }
    ++c;
  }
#pragma unroll 2
  for (; t + E <= span; t += E, ++c) {
    uint4 q[kRowsPerItem];
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) q[r] = xr[r][c];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float4 wt = w[t + i];
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) acc4(a[r], chunk_sample(q[r], i, T()), wt);
    }
  }
  if (t < span) {
    uint4 q[kRowsPerItem];
#pragma unroll
    for (int r = 0; r < kRowsPerItem; ++r) q[r] = xr[r][c];
#pragma unroll
    for (int i = 0; i < E - 1; ++i) {
      if (t + i < span) {
        const float4 wt = w[t + i];
#pragma unroll
        for (int r = 0; r < kRowsPerItem; ++r) acc4(a[r], chunk_sample(q[r], i, T()), wt);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    fsk_tile_kernel(const T* __restrict__ x, const float* __restrict__ tab, const int* __restrict__ first,
                    const int* __restrict__ best, uint8_t* __restrict__ bits, int rows, int cols, int spr,
                    int span, int per_capture, int tile_rows, int buf_chunks) {
  constexpr int E = 16 / (int)sizeof(T);
  extern __shared__ float4 smem[];  // the capture's (spr, span) weights, then two tile buffers
  __shared__ int band[2];           // lo, hi of the capture's offset
  const int b = blockIdx.x / per_capture;
  const int first_tile = blockIdx.x % per_capture;
  const int k = best[b];
  const int* fk = first + (long long)k * spr;
  offset_band(fk, spr, span, band);
  // The (4, span, spr) table of offset k as (spr, span) float4s, read along s.
  float4* tw = smem;
  const float* tk = tab + (long long)k * 4 * span * spr;
  const int gs = span * spr;
  for (int q = threadIdx.x; q < gs; q += blockDim.x) {
    const int t = q / spr, s = q - t * spr;
    tw[s * span + t] = make_float4(tk[q], tk[gs + q], tk[2 * gs + q], tk[3 * gs + q]);
  }
  uint4* bufs = reinterpret_cast<uint4*>(smem + gs);
  __syncthreads();
  // Every row starts on a 16-byte boundary, so all rows stage the same
  // chunks [c_lo, c_lo + cpr) and the band starts at sample phase of them.
  const int c_lo = band[0] / E;
  const int phase = band[0] - c_lo * E;
  const int cpr = (band[1] + E - 1) / E - c_lo;
  const int rs = cpr | 1;  // odd: the rows a quarter-warp reads lie in 8 different chunks of banks

  const T* xc = x + (long long)b * rows * cols;
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kTileThreads / 32;
  auto stage = [&](int tile, uint4* buf) {
    const int j0 = tile * tile_rows;
    const int n_rows = min(tile_rows, rows - j0);
    const unsigned d = (unsigned)__cvta_generic_to_shared(buf);
    for (int jj = warp; jj < n_rows; jj += kWarps) {
      const uint4* src = reinterpret_cast<const uint4*>(xc + (long long)(j0 + jj) * cols) + c_lo;
      for (int q = lane; q < cpr; q += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * (jj * rs + q)), "l"(src + q));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  uint8_t* out = bits + (long long)b * rows * spr;
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
    const int j0 = tile * tile_rows;
    const int n_rows = min(tile_rows, rows - j0);
    // Item (g, s): bit s of rows g, g + G, g + 2G, ...; g fastest, so a
    // quarter-warp reads 8 consecutive rows of one bit at the same column.
    const int G = (n_rows + kRowsPerItem - 1) / kRowsPerItem;
    for (int it = threadIdx.x; it < G * spr; it += kTileThreads) {
      const int g = it % G, s = it / G;
      const int e = phase + fk[s] - band[0];  // the bit's first sample in a staged row
      const uint4* xr[kRowsPerItem];
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) {
        const int jj = g + r * G;
        xr[r] = buf + (jj < n_rows ? jj : g) * rs + e / E;
      }
      const float4* w = tw + s * span;
      float a[kRowsPerItem][4] = {};
      if constexpr (E == 8) {
        switch (e & 7) {
          case 0: correlate_rows<T, 0>(xr, w, span, a); break;
          case 1: correlate_rows<T, 1>(xr, w, span, a); break;
          case 2: correlate_rows<T, 2>(xr, w, span, a); break;
          case 3: correlate_rows<T, 3>(xr, w, span, a); break;
          case 4: correlate_rows<T, 4>(xr, w, span, a); break;
          case 5: correlate_rows<T, 5>(xr, w, span, a); break;
          case 6: correlate_rows<T, 6>(xr, w, span, a); break;
          default: correlate_rows<T, 7>(xr, w, span, a); break;
        }
      } else {
        switch (e & 3) {
          case 0: correlate_rows<T, 0>(xr, w, span, a); break;
          case 1: correlate_rows<T, 1>(xr, w, span, a); break;
          case 2: correlate_rows<T, 2>(xr, w, span, a); break;
          default: correlate_rows<T, 3>(xr, w, span, a); break;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerItem; ++r) {
        const int jj = g + r * G;
        if (jj < n_rows) {
          const float em = __fadd_rn(__fmul_rn(a[r][0], a[r][0]), __fmul_rn(a[r][1], a[r][1]));
          const float es = __fadd_rn(__fmul_rn(a[r][2], a[r][2]), __fmul_rn(a[r][3], a[r][3]));
          out[(long long)(j0 + jj) * spr + s] = __fsub_rn(em, es) > 0.f;
        }
      }
    }
    __syncthreads();  // this buffer is staged again two tiles on
  }
}

// --- K13 ------------------------------------------------------------------------------

// Where a staged row's samples start in its shared-memory row: a float32 row
// is copied in whole 16-byte chunks, so its first sample keeps its offset in
// its chunk; an int16 row is converted sample by sample from offset 0.
__device__ __forceinline__ int row_phase(const float* row) { return (int)(((uintptr_t)row >> 2) & 3); }
__device__ __forceinline__ int row_phase(const int16_t*) { return 0; }

// Stage samples [0, n) of a flat row (n_valid of them before the capture's
// end, zeros after) into dst, from dst[row_phase(src)] on; ``any`` is an
// address of the capture, given where no byte is read.
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n, long long n_valid,
                                          const float* any, int lane, int n_lanes) {
  const int phase = row_phase(src);
  const char* base = reinterpret_cast<const char*>(src) - 4 * phase;  // 16-byte aligned
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int chunks = (phase + n + 3) >> 2;
  for (int c = lane; c < chunks; c += n_lanes) {
    const long long valid = n_valid + phase - 4LL * c;  // samples of the chunk before the end
    const int bytes = valid >= 4 ? 16 : (valid > 0 ? 4 * (int)valid : 0);
    const void* from = bytes > 0 ? static_cast<const void*>(base + 16LL * c) : static_cast<const void*>(any);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d + 16 * c), "l"(from), "r"(bytes));
  }
}

__device__ __forceinline__ void stage_row(float* dst, const int16_t* src, int n, long long n_valid,
                                          const int16_t*, int lane, int n_lanes) {
  for (int q = lane; q < n; q += n_lanes) dst[q] = q < n_valid ? static_cast<float>(src[q]) : 0.f;
}

// The four sums of one bit over t = 0..span-1 in order: samples from shared
// memory 16 bytes at a time, the first M of the first chunk skipped.
template <int M>
__device__ __forceinline__ void correlate(const float4* xv, const float4* w, int span, float (&a)[4]) {
  const float4 q0 = xv[0];
  const float h[4] = {q0.x, q0.y, q0.z, q0.w};
  int t = 0;
#pragma unroll
  for (int i = M; i < 4; ++i, ++t) {
    if (t < span) acc4(a, h[i], w[t]);
  }
  int c = 1;
#pragma unroll 4
  for (; t + 4 <= span; t += 4, ++c) {
    const float4 q = xv[c];
    acc4(a, q.x, w[t]);
    acc4(a, q.y, w[t + 1]);
    acc4(a, q.z, w[t + 2]);
    acc4(a, q.w, w[t + 3]);
  }
  if (t < span) {
    const float4 q = xv[c];
    acc4(a, q.x, w[t]);
    if (t + 1 < span) acc4(a, q.y, w[t + 1]);
    if (t + 2 < span) acc4(a, q.z, w[t + 2]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
    fsk_flat_kernel(const T* __restrict__ x, const float4* __restrict__ tab4,
                    const int* __restrict__ first, const int* __restrict__ best,
                    uint8_t* __restrict__ bits, int rows, int cols, int spr, int span,
                    int tile_rows, int buf_floats) {
  extern __shared__ float4 smem[];  // the capture's (spr, span) weights, then two tile buffers
  __shared__ int band[2];           // lo, hi of the capture's offset
  const int b = blockIdx.y;
  const int k = best[b];
  const int* fk = first + (long long)k * spr;
  offset_band(fk, spr, span, band);
  float4* tw = smem;
  const float4* tk = tab4 + (long long)k * spr * span;
  for (int i = threadIdx.x; i < spr * span; i += blockDim.x) tw[i] = tk[i];
  float* bufs = reinterpret_cast<float*>(smem + spr * span);
  __syncthreads();
  const int lo = band[0];
  const int ls = band[1] - lo;  // staged samples a row
  // Row stride in 16-byte chunks: room for the phase, and odd, so that the
  // 8 rows a quarter-warp reads for one bit s lie in 8 different chunks of banks.
  const int rs = 4 * (((ls + 3 + 3) >> 2) | 1);

  const long long n_cap = (long long)rows * cols;
  const T* xc = x + (long long)b * n_cap;
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kFlatThreads / 32;
  auto stage = [&](int tile, float* buf) {
    const int j0 = tile * tile_rows;
    const int n_rows = min(tile_rows, rows - j0);
    for (int jj = warp; jj < n_rows; jj += kWarps) {
      const long long p0 = (long long)(j0 + jj) * cols + lo;
      stage_row(buf + jj * rs, xc + p0, ls, n_cap - p0, xc, lane, 32);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  uint8_t* out = bits + (long long)b * rows * spr;
  int i = 0;
  if (blockIdx.x < n_tiles) stage(blockIdx.x, bufs);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    // Stage the next tile into the other buffer while this one is correlated.
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      stage(next, bufs + ((i + 1) & 1) * buf_floats);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* buf = bufs + (i & 1) * buf_floats;
    const int j0 = tile * tile_rows;
    const int n_rows = min(tile_rows, rows - j0);
    for (int it = threadIdx.x; it < n_rows * spr; it += kFlatThreads) {
      // Items row-fastest: a quarter-warp takes 8 rows of one bit s.
      const int jj = it % n_rows, s = it / n_rows;
      const int e0 = jj * rs + row_phase(xc + (long long)(j0 + jj) * cols + lo) + (fk[s] - lo);
      const float4* xv = reinterpret_cast<const float4*>(buf) + (e0 >> 2);
      const float4* w = tw + s * span;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      switch (e0 & 3) {
        case 0: correlate<0>(xv, w, span, a); break;
        case 1: correlate<1>(xv, w, span, a); break;
        case 2: correlate<2>(xv, w, span, a); break;
        default: correlate<3>(xv, w, span, a); break;
      }
      const float em = __fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1]));
      const float es = __fadd_rn(__fmul_rn(a[2], a[2]), __fmul_rn(a[3], a[3]));
      out[(long long)(j0 + jj) * spr + s] = __fsub_rn(em, es) > 0.f;
    }
    __syncthreads();  // this buffer is staged again two tiles on
  }
}

template <typename T>
int launch_tile(const void* x, const float* tab, const int* first, int span, const int* best,
                uint8_t* bits, int n_captures, int rows, int cols, int spr, cudaStream_t stream) {
  constexpr int E = 16 / (int)sizeof(T);
  if (cols % E != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorInvalidValue;
  // A row's band lies in its cols samples, so it stages at most cols / E
  // chunks; two buffers of tile_rows rows beside the weights.
  const size_t row_chunks = (size_t)((cols / E) | 1);
  const size_t w_bytes = 16 * (size_t)spr * span;
  const size_t fit = w_bytes < (size_t)kK7Smem ? (kK7Smem - w_bytes) / (2 * 16 * row_chunks) : 0;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int tile_rows = (int)(fit > (size_t)kK7TileRows ? kK7TileRows : fit);
  const int buf_chunks = (int)(tile_rows * row_chunks);
  const size_t smem = w_bytes + 2 * 16 * (size_t)buf_chunks;
  auto kernel = fsk_tile_kernel<T>;
  long long wave = 0;
  const cudaError_t err = one_wave_blocks(kernel, kTileThreads, smem, &wave);
  if (err != cudaSuccess) return (int)err;
  // One wave: every block resident at once, each walking tiles of one capture.
  const long long n_tiles = (rows + (long long)tile_rows - 1) / tile_rows;
  long long per_capture = wave / n_captures;
  if (per_capture < 1) per_capture = 1;
  if (per_capture > n_tiles) per_capture = n_tiles;
  const long long n_blocks = per_capture * n_captures;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)n_blocks, kTileThreads, smem, stream>>>(static_cast<const T*>(x), tab, first, best, bits,
                                                             rows, cols, spr, span, (int)per_capture, tile_rows,
                                                             buf_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flat(const void* x, const float* tab4, const int* first, int span, const int* best,
                uint8_t* bits, int n_captures, int rows, int cols, int spr, int tab_rows,
                cudaStream_t stream) {
  // A row's band lies in the template's tab_rows columns, so its stride is at
  // most row_floats; two buffers of tile_rows rows beside the weights.
  const size_t row_floats = 4 * (size_t)((((tab_rows + 6) >> 2)) | 1);
  const size_t w_bytes = 16 * (size_t)spr * span;
  const size_t fit = w_bytes < kFlatSmem ? (kFlatSmem - w_bytes) / (2 * 4 * row_floats) : 0;
  const size_t tile_rows = fit < 1 ? 1 : (fit > (size_t)kTileRows ? kTileRows : fit);
  const size_t buf_floats = tile_rows * row_floats;
  const size_t smem = w_bytes + 2 * 4 * buf_floats;
  cudaError_t err = cudaFuncSetAttribute(fsk_flat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // At most kFlatBlocks blocks a multiprocessor, all resident at once, each
  // walking tiles of one capture (one wave: a second would run alone).
  const long long n_tiles = (rows + (long long)tile_rows - 1) / (long long)tile_rows;
  long long per_capture = (long long)kFlatBlocks * sms / n_captures;
  if (per_capture < 1) per_capture = 1;
  if (per_capture > n_tiles) per_capture = n_tiles;
  dim3 grid((unsigned)per_capture, (unsigned)n_captures);
  fsk_flat_kernel<T><<<grid, kFlatThreads, smem, stream>>>(static_cast<const T*>(x),
                                                           reinterpret_cast<const float4*>(tab4), first, best,
                                                           bits, rows, cols, spr, span, (int)tile_rows,
                                                           (int)buf_floats);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int flat, const void* x, const float* tab, const int* first, int span, const int* best,
           uint8_t* bits, int n_captures, int rows, int cols, int spr, int tab_rows, cudaStream_t st) {
  return flat ? launch_flat<T>(x, tab, first, span, best, bits, n_captures, rows, cols, spr, tab_rows, st)
              : launch_tile<T>(x, tab, first, span, best, bits, n_captures, rows, cols, spr, st);
}

}  // namespace

// dtype: 0 = float32, 1 = int16. flat: 0 for K7 (x is (n_captures, rows, cols)
// overlapped rows, cols = row+ov; tab (n_offsets, 4, span, spr) float32), 1
// for K13 (x is (n_captures, rows, cols) flat rows, cols = row; tab
// (n_offsets, spr, span, 4) float32). first: (n_offsets, spr) int32 with
// first + span <= tab_rows, the template's rows; best: (n_captures,) int32;
// bits: (n_captures, rows*spr) uint8. Returns the cudaError_t of the launch.
extern "C" int amr_fsk_tile(const void* x, int dtype, int flat, const float* tab,
                            const int* first, int span, const int* best, uint8_t* bits,
                            int n_captures, int rows, int cols, int spr, int tab_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(flat, x, tab, first, span, best, bits, n_captures, rows, cols, spr, tab_rows, st);
    case 1:
      return launch<int16_t>(flat, x, tab, first, span, best, bits, n_captures, rows, cols, spr, tab_rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
