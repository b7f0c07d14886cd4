// K4: DBPSK stream select + complement + mod-8 bit alignment + byte pack.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py bit_select_pack_batch
// (variant "weights": _kernel_bit_select_pack_w with the per-shift tables of
// _shifted_pack_weights_bpsk).
//
// What it computes. For capture b with k = ksel[b] (bpsk_match_conditions
// order: 0 re, 1 im, 2 re inverted, 3 im inverted) and s8 = s[b] & 7, the bit
// stream is v = (k & 1) ? im : re, complemented when k >= 2, and output byte c
// of the capture is sum_{i<8} v[8c + s8 + i] * 2^(7 - i). Bits past the
// capture's end are zero, as in the plain version. The TPU kernel read the
// next capture's head there, so only bytes at or past n_valid =
// (R*128 - s8) / 8 can differ from it: those are garbage by contract.
//
// What bounds it on the H100: device memory. Per stream bit it reads 1 B (the
// selected lane of the two; the TPU kernel read both) and writes 1/8 B, with a
// few integer operations. The TPU version assembled bytes as MXU matmuls
// against per-shift weight tables; on CUDA cores the shift is an index, so no
// tables exist here.
//
// Design. One thread per output byte reads the 8 consecutive stream bytes its
// bits come from (a warp's 32 threads read 256 consecutive bytes, which the L1
// cache coalesces) and shifts them into the byte MSB first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bit_select_pack_kernel(const uint8_t* __restrict__ re,
                                       const uint8_t* __restrict__ im,
                                       const int* __restrict__ s, const int* __restrict__ ksel,
                                       uint8_t* __restrict__ out, long long bits_per_capture,
                                       long long bytes_per_capture) {
  const int b = blockIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bytes_per_capture) return;
  const int k = ksel[b];
  const uint8_t* v = ((k & 1) ? im : re) + (long long)b * bits_per_capture;
  const unsigned inv = k >= 2;
  const long long p = 8 * c + (s[b] & 7);  // first stream bit of the byte
  unsigned byte = 0;
  for (int i = 0; i < 8; ++i) {
    const long long q = p + i;
    const unsigned bit = q < bits_per_capture ? ((v[q] ^ inv) & 1u) : 0u;
    byte = (byte << 1) | bit;
  }
  out[(long long)b * bytes_per_capture + c] = (uint8_t)byte;
}

}  // namespace

// re/im: (n_captures, rows, 128) uint8 sign-bit lanes, contiguous; s, ksel:
// (n_captures,) int32; out: (n_captures, rows*16) uint8. Returns the
// cudaError_t of the launch.
extern "C" int amr_bit_select_pack(const uint8_t* re, const uint8_t* im, const int* s,
                                   const int* ksel, uint8_t* out, int n_captures, int rows,
                                   void* stream) {
  const long long bytes_per_capture = (long long)rows * 16;
  dim3 grid((unsigned)((bytes_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  bit_select_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, s, ksel, out, (long long)rows * 128, bytes_per_capture);
  return (int)cudaGetLastError();
}
