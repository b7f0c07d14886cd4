// The size of a one-wave persistent grid, kept per kernel.
//
// A persistent kernel launches as many blocks as are resident at once:
// blocks a multiprocessor (the occupancy query) times the multiprocessors.
// The query costs host time on every launch, so its answer is kept per
// kernel (by its address: instantiations can share a type), device and
// shared-memory size. The kernel's dynamic shared-memory limit is a
// property of the function, not of a launch: it is raised when a launch
// needs more than any before it and never lowered, so a launch with less
// after one with more still fits.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

template <typename Kernel>
__host__ cudaError_t one_wave_blocks(Kernel kernel, int threads, size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> limit;  // the limit as set, per kernel and device
  static std::map<std::tuple<const void*, int, size_t>, long long> kept;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t& lim = limit[std::make_pair(fn, dev)];
  if (smem > lim) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  const auto key = std::make_tuple(fn, dev, smem);
  const auto hit = kept.find(key);
  if (hit != kept.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = kept[key] = (long long)per_sm * sms;
  return cudaSuccess;
}

}  // namespace
