// The batched FSK discriminator's back half: K8's per-bit vector sums to
// bits, through atan2, the calibrated equalizer and the tone decision.
//
// Replaces no TPU kernel: the JAX package runs this step as plain XLA after
// K8 (audio_modem_radio_tpu/ops/fsk.py fsk_disc_bits_rows_batch, :1004-1019).
// The port's plain version is ops/fsk.py disc_decide: an atan2, a scale, an
// edge-padded copy, nine strided multiplies and ten adds, two distances and
// a compare, each writing its (B, n) float32 result to memory.
//
// What it computes, for sums sr, si (n_rows, n) float32 and the float32
// parameters scale, c[0..8], bias, mark and space, per row position k:
//     f[k]  = atan2f(si[k], sr[k]) * scale
//     eq    = bias + c[0] * f[k - 4] + ... + c[8] * f[k + 4]   (in that order)
//     bit   = |eq - mark| < |eq - space|
// where f at a position before 0 or past n - 1 is f[0] or f[n - 1] (the
// capture's own first or last frequency repeated). Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA) and
// atan2f is the library's, so the bits equal the plain chain's, bit for bit.
//
// What bounds it on the H100: device memory. Each bit reads two float32 sums
// and writes one byte: for 256 captures of 1,703,936 bits (FSK9600 at 2^24
// samples) 3.49 GB read and 0.44 GB written, 1.17 ms at 3.35 TB/s. The
// arithmetic (an atan2f, 19 float operations) stays below that.
//
// Design. A block takes a tile of 4096 positions of one row (grid: tiles x
// rows). Its threads read the tile's sums with coalesced 16-byte loads,
// turn each into f once and keep it in shared memory, with 4 positions of
// halo on each side that eight threads compute again from the sums; slots
// past the row's ends hold the clamped edge frequency, so the equalizer
// needs no test. Each thread then reads the 24 frequencies around its 16
// positions (one padding slot every 16 keeps those reads free of bank
// conflicts) and writes its 16 bits as one 16-byte store. Where n is not a
// multiple of 16 the rows are not 16-byte aligned, and the loads and stores
// go one element at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                  // bits a thread writes
constexpr int kTile = kThreads * kPer;    // row positions a block covers
constexpr int kTaps = 9;
constexpr int kHalo = kTaps / 2;
constexpr int kSlots = kTile + 2 * kHalo;  // slot s: row position tile0 - kHalo + s
constexpr int kSmem = kSlots + kSlots / 16 + 1;

struct EqParams {
  float scale;
  float c[kTaps];
  float bias, mark, space;
};

__device__ __forceinline__ int phys(int s) { return s + (s >> 4); }

__device__ __forceinline__ float freq(float si, float sr, float scale) { return __fmul_rn(atan2f(si, sr), scale); }

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fsk_eq_bits_kernel(const float* __restrict__ sr, const float* __restrict__ si, int n,
                       const __grid_constant__ EqParams p, uint8_t* __restrict__ bits) {
  __shared__ float f[kSmem];
  const int tile0 = blockIdx.x * kTile;
  const long long row = (long long)blockIdx.y * n;
  const float* rr = sr + row;
  const float* ri = si + row;
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int k = tile0 + 4 * (q * kThreads + threadIdx.x);
    float a[4], b[4];
    if (kVec && k + 4 <= n) {
      const float4 vr = __ldg(reinterpret_cast<const float4*>(rr + k));
      const float4 vi = __ldg(reinterpret_cast<const float4*>(ri + k));
      a[0] = vr.x, a[1] = vr.y, a[2] = vr.z, a[3] = vr.w;
      b[0] = vi.x, b[1] = vi.y, b[2] = vi.z, b[3] = vi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = min(k + e, n - 1);
        a[e] = rr[c];
        b[e] = ri[c];
      }
    }
    const int s = kHalo + k - tile0;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[phys(s + e)] = freq(b[e], a[e], p.scale);
  }
  if (threadIdx.x < 2 * kHalo) {
    const int s = threadIdx.x < kHalo ? threadIdx.x : kTile + threadIdx.x;
    const int c = min(max(tile0 - kHalo + s, 0), n - 1);
    f[phys(s)] = freq(ri[c], rr[c], p.scale);
  }
  __syncthreads();

  const int k0 = tile0 + kPer * threadIdx.x;
  if (k0 >= n) return;
  float w[kPer + 2 * kHalo];
#pragma unroll
  for (int i = 0; i < kPer + 2 * kHalo; ++i) w[i] = f[phys(kPer * threadIdx.x + i)];
  uint32_t word[kPer / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    float eq = p.bias;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) eq = __fadd_rn(eq, __fmul_rn(p.c[j], w[e + j]));
    const uint32_t bit = fabsf(__fsub_rn(eq, p.mark)) < fabsf(__fsub_rn(eq, p.space));
    word[e / 4] |= bit << (8 * (e % 4));
  }
  uint8_t* out = bits + row + k0;
  if (kVec && k0 + kPer <= n) {
    *reinterpret_cast<uint4*>(out) = make_uint4(word[0], word[1], word[2], word[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (k0 + e < n) out[e] = (uint8_t)(word[e / 4] >> (8 * (e % 4)));
  }
}

}  // namespace

// sr, si: (n_rows, n) float32, contiguous and 16-byte aligned; params: host
// pointer to 13 float32 (scale, the 9 taps, bias, mark, space); bits:
// (n_rows, n) uint8, 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int amr_fsk_eq_bits(const float* sr, const float* si, int n_rows, int n, const float* params,
                               uint8_t* bits, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || n < 1 || reinterpret_cast<uintptr_t>(sr) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(si) % 16 != 0 || reinterpret_cast<uintptr_t>(bits) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EqParams p;
  p.scale = params[0];
  for (int j = 0; j < kTaps; ++j) p.c[j] = params[1 + j];
  p.bias = params[1 + kTaps];
  p.mark = params[2 + kTaps];
  p.space = params[3 + kTaps];
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)n_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 16 == 0)
    fsk_eq_bits_kernel<true><<<grid, kThreads, 0, st>>>(sr, si, n, p, bits);
  else
    fsk_eq_bits_kernel<false><<<grid, kThreads, 0, st>>>(sr, si, n, p, bits);
  return (int)cudaGetLastError();
}
