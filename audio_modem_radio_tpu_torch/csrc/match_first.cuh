// The magic matchers' shared launch shape and result step: K2 (rotmatch.cu)
// and K5 (sector_match.cu).
//
// A matcher walks each capture's positions with a one-wave persistent grid
// split over the captures: block blk of capture b takes the position
// strides it, it + per_capture, ... of the capture's n_iters. Each block
// keeps its smallest matching position per hypothesis in shared memory
// (kMatchBig where none). match_publish then writes the block's minima to
// its scratch row, fences and takes the capture's ticket; the capture's
// last block reduces the rows, writes first (0 where no match) and found,
// and resets the ticket to 0 for the next call. A min does not depend on
// the order of the blocks or the atomics, so the result is deterministic,
// and a call is one launch with no host read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "one_wave.cuh"

namespace {

constexpr int kMatchHyp = 8;  // hypotheses a matcher tests at most
constexpr int kMatchBig = 1 << 30;

// One 16-byte chunk of a capture at byte `at`, zeros at or past `limit`
// (the scanned prefix's end, a multiple of 16, so a chunk lies wholly on
// one side of it).
__device__ __forceinline__ uint4 match_chunk(const uint8_t* __restrict__ capture, long long at, long long limit) {
  return at < limit ? __ldg(reinterpret_cast<const uint4*>(capture + at)) : make_uint4(0, 0, 0, 0);
}

// Every thread of the block calls this once, after its walk; s_first holds
// the block's kMatchHyp minima.
template <int kThreads>
__device__ __forceinline__ void match_publish(int* s_first, int n_hyp, int* __restrict__ first,
                                              uint8_t* __restrict__ found, int* __restrict__ scratch,
                                              int* __restrict__ ticket, int b, int blk, int per_capture) {
  __shared__ bool s_last;
  __syncthreads();
  int* row = scratch + ((long long)b * per_capture + blk) * kMatchHyp;
  if (threadIdx.x < kMatchHyp) row[threadIdx.x] = s_first[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket + b, 1) == per_capture - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x < kMatchHyp) s_first[threadIdx.x] = kMatchBig;
  __syncthreads();
  int m[kMatchHyp];
#pragma unroll
  for (int h = 0; h < kMatchHyp; ++h) m[h] = kMatchBig;
  const int* rows = scratch + (long long)b * per_capture * kMatchHyp;
  for (int j = threadIdx.x; j < per_capture; j += kThreads) {
#pragma unroll
    for (int h = 0; h < kMatchHyp; ++h) m[h] = min(m[h], __ldcg(rows + j * kMatchHyp + h));
  }
#pragma unroll
  for (int h = 0; h < kMatchHyp; ++h) {
    const int v = __reduce_min_sync(0xffffffffu, m[h]);
    if ((threadIdx.x & 31) == 0 && v < kMatchBig) atomicMin(s_first + h, v);
  }
  __syncthreads();
  if (threadIdx.x < n_hyp) {
    const int v = s_first[threadIdx.x];
    first[b * n_hyp + threadIdx.x] = v < kMatchBig ? v : 0;
    found[b * n_hyp + threadIdx.x] = v < kMatchBig;
  }
  if (threadIdx.x == 0) ticket[b] = 0;
}

// Blocks a capture: one wave of `kernel` split over the captures, at most
// n_iters (no block without work) and what the scratch rows hold, at least 1.
template <typename Kernel>
__host__ cudaError_t match_per_capture(Kernel kernel, int threads, int n_captures, int n_iters,
                                       int scratch_blocks, int* per_capture) {
  long long wave = 0;
  const cudaError_t err = one_wave_blocks(kernel, threads, 0, &wave);
  if (err != cudaSuccess) return err;
  long long n = wave / n_captures;
  if (n > n_iters) n = n_iters;
  if (n > scratch_blocks / n_captures) n = scratch_blocks / n_captures;
  *per_capture = n < 1 ? 1 : (int)n;
  return cudaSuccess;
}

}  // namespace
