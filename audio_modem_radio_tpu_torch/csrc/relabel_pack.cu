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
// written, a few integer operations each (bound 0.073 ms for 64 captures of
// 13,312 rows). The TPU version expressed the shifted byte assembly as MXU
// matmuls against per-shift weight tables; on CUDA cores the shift is a
// register shift, so no tables exist here.
//
// Design. The first design ran a thread per output byte with five byte
// loads of each lane and reached 37-45% of the bound. Here a thread owns a
// run of kRun = 32 dibits, 8 output bytes:
// * the relabel is a plane swap and an XOR, both fixed per capture: on the
//   bit planes (H, L) of the decisions, (rh, rl) is (H, L) at k = 0,
//   (~L, H) at 1, (~H, ~L) at 2 and (L, ~H) at 3, so the thread reads rh
//   from hi or lo and rl from the other, and complements after packing;
// * two 16-byte loads a lane; each 32-bit word of 4 dibits is compacted by
//   one multiply to 8 stream bits, MSB first (K2's interleave16 packs LSB
//   first, so this is its own copy), and three byte permutes gather 16
//   dibits into one big-endian stream word;
// * the shift by s8 bits takes the next run's first word, by a shuffle from
//   the next lane, or for the warp's last lane from one 4-byte load of each
//   lane; zero past the capture's end;
// * a funnel shift and a byte swap a word, one 8-byte streaming store. No
//   division.
// Decisions are 0 or 1 (K1's output): only bit 0 of a byte is read.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --kernel relabel_pack, PERF.md section 6), K1's QPSK lanes of the bench
// batch at every (ksel, s8): the kernel alone 0.075-0.080 ms (91-97% of
// the bound), from 0.161; every byte equal to the first design's. 32
// registers, no spills. 64 dibits a thread (one 16-byte store) took
// 0.084 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;            // dibits a thread
constexpr int kWords = kRun / 16;   // big-endian stream words of a run, 8 bytes out

// The 8 stream bits of 4 dibits (rh, rl bytes, little-endian: the first
// dibit in the low byte), MSB first in bits 31..24. The multiply moves byte
// a's 2-bit field to bits 30 - 2a; its other copies land in disjoint bits
// below 24 or past 31, so nothing carries.
__device__ __forceinline__ uint32_t dibits4(uint32_t h, uint32_t l) {
  return (((h & 0x01010101u) << 1) | (l & 0x01010101u)) * 0x40100401u;
}

// 16 rh and 16 rl bytes -> 32 stream bits, rh[0] in bit 31, rl[0] in 30.
__device__ __forceinline__ uint32_t stream16(uint4 h, uint4 l) {
  const uint32_t a = __byte_perm(dibits4(h.x, l.x), dibits4(h.y, l.y), 0x3700);
  const uint32_t b = __byte_perm(dibits4(h.z, l.z), dibits4(h.w, l.w), 0x3700);
  return __byte_perm(a, b, 0x3276);
}

__global__ void __launch_bounds__(kThreads)
    relabel_pack_kernel(const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                        const int* __restrict__ s, const int* __restrict__ ksel,
                        uint8_t* __restrict__ out, int runs_per_capture) {
  const int b = blockIdx.y;
  const int run = blockIdx.x * kThreads + threadIdx.x;
  const bool live = run < runs_per_capture;
  const int k = ksel[b] & 3;
  const int s8 = s[b] & 7;
  const long long base = (long long)b * runs_per_capture * kRun;
  const uint8_t* rh = (k & 1 ? lo : hi) + base;  // the plane swap
  const uint8_t* rl = (k & 1 ? hi : lo) + base;
  const uint32_t flip = (k == 1 || k == 2 ? 0xAAAAAAAAu : 0u) | (k >= 2 ? 0x55555555u : 0u);

  // This run's 2*kRun stream bits, big-endian: w[0] bit 31 is its first bit.
  uint32_t w[kWords + 1] = {};
  if (live) {
    const uint4* ph = reinterpret_cast<const uint4*>(rh + (long long)run * kRun);
    const uint4* pl = reinterpret_cast<const uint4*>(rl + (long long)run * kRun);
    uint4 qh[kWords], ql[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      qh[j] = __ldg(ph + j);
      ql[j] = __ldg(pl + j);
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[j] = stream16(qh[j], ql[j]) ^ flip;
  }
  // The next run's first bits: the next lane's w[0], or a load for the
  // warp's last lane; none past the capture's end.
  const uint32_t from_next = __shfl_down_sync(0xffffffffu, w[0], 1);
  if (run + 1 < runs_per_capture) {
    if ((threadIdx.x & 31) == 31) {
      const long long nx = (long long)(run + 1) * kRun;
      const uint32_t h = __ldg(reinterpret_cast<const uint32_t*>(rh + nx));
      const uint32_t l = __ldg(reinterpret_cast<const uint32_t*>(rl + nx));
      w[kWords] = (dibits4(h, l) & 0xFF000000u) ^ (flip & 0xFF000000u);  // its first 8 bits
    } else {
      w[kWords] = from_next;
    }
  }
  if (!live) return;
  uint32_t o[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) o[j] = __byte_perm(__funnelshift_l(w[j + 1], w[j], s8), 0, 0x0123);
  __stcs(reinterpret_cast<uint2*>(out) + (long long)b * runs_per_capture + run, make_uint2(o[0], o[1]));
}

}  // namespace

// hi/lo: (n_captures, rows, 128) uint8, contiguous and 16-byte aligned; s,
// ksel: (n_captures,) int32; out: (n_captures, rows*32) uint8, 8-byte
// aligned. Returns the cudaError_t of the launch.
extern "C" int amr_relabel_pack(const uint8_t* hi, const uint8_t* lo, const int* s,
                                const int* ksel, uint8_t* out, int n_captures, int rows,
                                void* stream) {
  if (n_captures < 1 || n_captures > 65535 || rows < 1 || reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int runs_per_capture = rows * (128 / kRun);
  dim3 grid((unsigned)((runs_per_capture + kThreads - 1) / kThreads), (unsigned)n_captures);
  relabel_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(hi, lo, s, ksel, out,
                                                                                  runs_per_capture);
  return (int)cudaGetLastError();
}
