// K6: D8PSK sector relabel by the winning rotation, Gray coding, mod-8-symbol
// alignment and byte pack.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py psk8_relabel_pack_rows
// (_kernel_psk8_relabel_pack with the per-shift tables of
// _psk8_shifted_pack_weights).
//
// What it computes. For capture b with k = ksel[b] and r8 = r8[b] (the sync
// shift in symbols, already reduced mod 8), symbol t's true sector is
// x = (sec[t] + 8 - k) & 7 and its Gray code x ^ (x >> 1) gives 3 flat bits,
// plane q = 0 (the Gray MSB) first: flat bit 3t + q. Output byte c of the
// capture is sum_{i<8} bit[8c + 3*r8 + i] * 2^(7 - i); 128 symbols are
// exactly 48 bytes, so row r holds bytes 48r .. 48r + 47. Bits past the
// capture's end are zero, as in the plain version; the TPU kernel read the
// next capture's head there, which only the capture's last bytes can see.
//
// What bounds it on the H100: device memory, 1 B of sectors read per 3/8 B
// written, a few integer operations each. The TPU version expressed the
// shifted byte assembly as six MXU matmuls per tile against per-shift weight
// tables; on CUDA cores the shift is a register shift, so no tables exist.
//
// Design. One thread per output byte reads the 4 sectors its 8 bits can touch
// (neighbouring threads read overlapping neighbouring sectors, which the L1
// cache coalesces), relabels and Gray-codes them into a 12-bit register window
// and shifts the byte out of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void psk8_pack_kernel(const uint8_t* __restrict__ sec, const int* __restrict__ ksel,
                                 const int* __restrict__ r8, uint8_t* __restrict__ out,
                                 long long sym_per_capture, long long bytes_per_capture) {
  const int b = blockIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= bytes_per_capture) return;
  const int k = ksel[b];
  const long long p = 8 * c + 3LL * r8[b];  // first flat bit of the byte
  const long long t0 = p / 3;
  const int q0 = (int)(p - 3 * t0);
  const uint8_t* sc = sec + (long long)b * sym_per_capture;
  unsigned v = 0;  // flat bits 3*t0 .. 3*t0 + 11, bit 3*t0 most significant
  for (int j = 0; j < 4; ++j) {
    const long long t = t0 + j;
    unsigned g = 0;  // bits past the capture's end are zero
    if (t < sym_per_capture) {
      const unsigned x = ((unsigned)sc[t] + 8u - (unsigned)k) & 7u;
      g = x ^ (x >> 1);
    }
    v = (v << 3) | g;
  }
  out[(long long)b * bytes_per_capture + c] = (uint8_t)((v >> (4 - q0)) & 0xffu);
}

}  // namespace

// sec: (n_captures, rows, 128) uint8, contiguous; ksel, r8: (n_captures,)
// int32, 0 <= ksel < 8, 0 <= r8 < 8; out: (n_captures, rows*48) uint8.
// Returns the cudaError_t of the launch.
extern "C" int amr_psk8_pack(const uint8_t* sec, const int* ksel, const int* r8, uint8_t* out,
                             int n_captures, int rows, void* stream) {
  const long long bytes_per_capture = (long long)rows * 48;
  dim3 grid((unsigned)((bytes_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  psk8_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sec, ksel, r8, out, (long long)rows * 128, bytes_per_capture);
  return (int)cudaGetLastError();
}
