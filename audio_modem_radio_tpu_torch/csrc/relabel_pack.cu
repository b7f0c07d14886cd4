// K3: inverse-Gray relabel by the winning rotation, mod-8 bit alignment and
// byte pack of the DQPSK decision lanes.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py relabel_pack_batch
// (variant "weights": _kernel_relabel_pack_w with the per-shift tables of
// _shifted_pack_weights_qpsk).
//
// What it computes. For capture b with k = ksel[b] and s8 = s[b] & 7, each
// dibit (h, l) relabels to s2 = (2h + (h ^ l) + 4 - k) & 3, rh = s2 >= 2,
// rl = s2 in {1, 2} (pallas_kernels.py:1255-1261). The flat bit stream is
// bit[2t] = rh[t], bit[2t + 1] = rl[t], and output byte c of the capture is
// sum_{i<8} bit[8c + s8 + i] * 2^(7 - i). Bits past the capture's end are
// zero, as in the plain version, so only the capture's last byte differs from
// the TPU kernel, whose last byte reads the next capture's head: that byte is
// garbage by contract.
//
// What bounds it on the H100: device memory, 2 B read per dibit and 0.25 B
// written, a few integer operations each. The TPU version expressed the
// shifted byte assembly as MXU matmuls against per-shift weight tables; on
// CUDA cores the shift is a register shift, so no tables exist here.
//
// Design. One thread per output byte reads the 5 dibits its 8 bits can touch
// (neighbouring threads read neighbouring 4-byte groups, which the L1 cache
// coalesces), relabels them into a 10-bit register window and shifts the byte
// out of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void relabel_pack_kernel(const uint8_t* __restrict__ hi,
                                    const uint8_t* __restrict__ lo, const int* __restrict__ s,
                                    const int* __restrict__ ksel, uint8_t* __restrict__ out,
                                    long long dib_per_capture, long long bytes_per_capture) {
  const int b = blockIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bytes_per_capture) return;
  const int k = ksel[b];
  const long long p = 8 * c + (s[b] & 7);  // first flat bit of the byte
  const long long t = p >> 1;
  const uint8_t* hc = hi + (long long)b * dib_per_capture;
  const uint8_t* lc = lo + (long long)b * dib_per_capture;
  unsigned v = 0;  // flat bits 2t .. 2t+9, bit 2t most significant
  for (int q = 0; q < 5; ++q) {
    const long long tt = t + q;
    unsigned rh = 0, rl = 0;  // bits past the capture's end are zero
    if (tt < dib_per_capture) {
      const int h = hc[tt], l = lc[tt];
      const int s2 = (2 * h + (h ^ l) + 4 - k) & 3;
      rh = s2 >= 2;
      rl = (s2 == 1) | (s2 == 2);
    }
    v = (v << 2) | (rh << 1) | rl;
  }
  out[(long long)b * bytes_per_capture + c] = (uint8_t)((v >> (2 - (p & 1))) & 0xffu);
}

}  // namespace

// hi/lo: (n_captures, rows, 128) uint8, contiguous; s, ksel: (n_captures,)
// int32; out: (n_captures, rows*32) uint8. Returns the cudaError_t of the
// launch.
extern "C" int amr_relabel_pack(const uint8_t* hi, const uint8_t* lo, const int* s,
                                const int* ksel, uint8_t* out, int n_captures, int rows,
                                void* stream) {
  const long long bytes_per_capture = (long long)rows * 32;
  dim3 grid((unsigned)((bytes_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  relabel_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hi, lo, s, ksel, out, (long long)rows * 128, bytes_per_capture);
  return (int)cudaGetLastError();
}
