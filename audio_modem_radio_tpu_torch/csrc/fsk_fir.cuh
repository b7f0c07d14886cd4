// The decimating analytic FIR that K8 (fsk_disc.cu) and K9 (fsk_quad.cu) share.
//
// FIR row g of a capture is the window x[g, 0:c_pad) of the zero-led capture
// that starts 128*DEC samples after row g-1's, c_pad = 128*DEC + 128 (host
// shaping, ops/fsk.py fsk_disc_row_shape / fsk_quad_row_shape): its first 128
// samples repeat the last 128 of row g-1. Output l of row g is
//     z[128g + l] = sum_{k < 129} x[g, DEC*l + k] * (hr[k], hi[k]),
// with (hr, hi) the reversed complex taps of ops/common.py _fir_dec_template;
// the (c_pad, 256) matrix the TPU kernel multiplies by holds those taps shifted
// by DEC per column, 60-80% zeros. Rows past the capture's end are zero, so
// their outputs are zero.
//
// What bounds it: float32 operations. Each output costs 2 x 129 FMAs against
// DEC*2 bytes of int16 input, 65-260 flop/B, far above the 20 flop/B ridge of
// the CUDA cores (67 TFLOP/s over 3.35 TB/s); it stays in IEEE float32 (no
// TF32, no bf16). A sub-partition issues one warp instruction a clock and one
// FFMA a clock is the peak, so the share of issued instructions that are FFMA
// caps the kernel, and every load, address and barrier is paid out of it.
//
// Design.
// * Tap loop. A thread computes kQ = 8 consecutive outputs in 16 accumulators.
//   It reads its DEC*7 + 129 samples as 16-byte shared loads at compile-time
//   offsets from one base register and uses each loaded sample in up to 16
//   FMAs. The taps travel as a __grid_constant__ kernel parameter and the loop
//   is unrolled, so each tap is a constant-bank word, which the compiler moves
//   through a uniform register: 2064 FFMA to 34 (DEC 1) or 40 (DEC 4) vector
//   loads and about 150 uniform loads, no address arithmetic. (Rolled over
//   blocks of 32 taps the loop is a quarter of the code and slower: the taps
//   then come by indexed constant loads.)
// * Layout. The 256 threads of a block compute a pass of 16 FIR rows from one
//   float32 buffer that holds the pass's samples in stream order: thread t's
//   window starts at sample 8*DEC*t. The buffer keeps 4 pad words after every
//   8*DEC samples, so thread t's base is word (8*DEC + 4)*t: the eight threads
//   of a quarter warp then fall on eight distinct 4-bank groups, the vector
//   loads are free of bank conflicts, and offsets stay compile-time because
//   every window starts on a group boundary. No polyphase split is needed: the
//   four lanes of a vector load are the four phases.
// * Staging. Raw input (int16 or float32) travels global -> shared with
//   16-byte cp.async into a ring of 2 stages of 8 FIR rows, one pass; a stage
//   holds each row's 128*DEC samples x[g, 128:c_pad), so every sample is
//   fetched once, plus the pass's first row's 128-sample head. Each pass
//   converts its stages to float32 from shared memory, once per sample, with
//   indices that divide by compile-time powers of two only, and then starts the
//   next pass's copies, which land while this pass is in the FMA loop.
// * Streaming. A block walks 512 consecutive FIR rows of one capture in 32
//   full passes and hands each pass's outputs to the caller's per-bit sums
//   through a ring in shared memory (FirWalk below). A warp in the tap loop
//   alone takes the loop's ~100 scoreboard waits unhidden, so a ragged pass
//   costs a full one: hence full passes only, and one start a block.
// * Rows past the capture's last FIR row are neither fetched nor computed:
//   their outputs are written as zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 129;     // ops/kernels.py _FIR_TAPS
constexpr int kOut = 128;      // analytic outputs per FIR row
constexpr int kHead = 128;     // leading samples of a row that repeat its predecessor's tail
constexpr int kQ = 8;          // consecutive outputs per thread
constexpr int kThreads = 256;
constexpr int kPassRows = kThreads * kQ / kOut;  // FIR rows per pass of the block
constexpr int kStageRows = 8;                    // FIR rows per ring stage
constexpr int kStagesPerPass = kPassRows / kStageRows;
constexpr int kStages = kStagesPerPass;          // the raw ring holds one pass

struct FirTaps {
  float re[kTaps];
  float im[kTaps];
};

template <typename T, int DEC>
struct FirGeom {
  static constexpr int kRun = kOut * DEC;      // samples a row adds to its predecessor's
  static constexpr int kCPad = kRun + kHead;   // the only row width the kernels take
  static constexpr int kGroup = kQ * DEC;      // samples between two threads' windows
  static constexpr int kGroupStride = kGroup + (kGroup % 8 == 0 ? 4 : 0);
  static constexpr int kPassSamples = kPassRows * kRun + kHead;
  static constexpr int kPassWords = kPassSamples / kGroup * kGroupStride;
  static constexpr int kChunks = (DEC * (kQ - 1) + kTaps + 3) / 4;  // vector loads per thread
  static constexpr int kStageBytes = kStageRows * kRun * (int)sizeof(T);
  static constexpr int kHeadBytes = kHead * (int)sizeof(T);
  // The float32 pass buffer, the raw ring, the head.
  static constexpr size_t kStagingBytes =
      sizeof(float) * kPassWords + (size_t)kStages * kStageBytes + kHeadBytes;
  static_assert(DEC * (kThreads - 1) * kQ + 4 * kChunks <= kPassSamples, "window past the buffer");
};

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src_global) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const int16_t* p, float (&v)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<float>(static_cast<int16_t>(w[i] & 0xffff));
    v[2 * i + 1] = static_cast<float>(w[i] >> 16);
  }
}

// The tap loop: kQ outputs of one thread from its window in the pass buffer.
template <typename T, int DEC>
__device__ __forceinline__ void fir_taps_loop(const FirTaps& h, const float* xf, float (&ar)[kQ],
                                              float (&ai)[kQ]) {
  using G = FirGeom<T, DEC>;
  const float* xb = xf + threadIdx.x * G::kGroupStride;
#pragma unroll
  for (int j = 0; j < G::kChunks; ++j) {
    const int o = 4 * j;
    const float4 v4 = *reinterpret_cast<const float4*>(xb + o / G::kGroup * G::kGroupStride + o % G::kGroup);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int k = o + c - DEC * q;  // sample DEC*l0 + o + c is tap k of output l0 + q
        if (k >= 0 && k < kTaps) {
          ar[q] = fmaf(v[c], h.re[k], ar[q]);
          ai[q] = fmaf(v[c], h.im[k], ai[q]);
        }
      }
    }
  }
}

// A block's walk over FIR rows [row0, row0 + n_rows) of one capture (rows_cap
// rows of c_pad samples at xc), kPassRows rows a pass. Stage s holds rows
// [row0 + s*kStageRows, +kStageRows) in ring slot s % kStages; the ring and the
// head hold one pass, and the next pass's are fetched once this one's are
// converted.
template <typename T, int DEC>
struct FirStream {
  using G = FirGeom<T, DEC>;
  const T* xc;
  long long rows_cap, row0;
  int n_rows;
  float* xf;  // the float32 pass buffer, G::kPassWords
  unsigned char* ring;
  unsigned char* head;

  __device__ __forceinline__ FirStream(const T* xc_, long long rows_cap_, long long row0_, int n_rows_,
                                       unsigned char* staging)
      : xc(xc_), rows_cap(rows_cap_), row0(row0_), n_rows(n_rows_), xf(reinterpret_cast<float*>(staging)),
        ring(staging + sizeof(float) * G::kPassWords),
        head(staging + sizeof(float) * G::kPassWords + kStages * G::kStageBytes) {}

  // Starts the copies of stage s: each row's x[g, 128:c_pad), and with a pass's
  // first stage that row's head x[g, 0:128). Rows past the walk or the capture
  // are not fetched.
  __device__ __forceinline__ void issue(int s) const {
    constexpr int kRowChunks = G::kRun * (int)sizeof(T) / 16;
    constexpr int kHeadChunks = G::kHeadBytes / 16;
    const int r0 = s * kStageRows;
    unsigned char* dst = ring + (s % kStages) * G::kStageBytes;
    for (int e = threadIdx.x; e < kStageRows * kRowChunks; e += kThreads) {
      const int row = r0 + e / kRowChunks;
      const long long g = row0 + row;
      if (row < n_rows && g < rows_cap)
        cp_async16(dst + e * 16, reinterpret_cast<const unsigned char*>(xc + g * G::kCPad + kHead) +
                                     (e % kRowChunks) * 16);
    }
    if (s % kStagesPerPass == 0 && threadIdx.x < kHeadChunks && r0 < n_rows && row0 + r0 < rows_cap)
      cp_async16(head + threadIdx.x * 16,
                 reinterpret_cast<const unsigned char*>(xc + (row0 + r0) * G::kCPad) + threadIdx.x * 16);
  }

  // Fills the ring; called once, before pass 0.
  __device__ __forceinline__ void begin() const {
    for (int s = 0; s < kStages; ++s) issue(s);
    cp_async_commit();
  }

  // Converts the raw stages of pass p into the float32 pass buffer: sample L of
  // the pass's stream (the head, then the rows' runs) goes to word
  // L/kGroup * kGroupStride + L%kGroup.
  __device__ __forceinline__ void convert(int p) const {
    for (int e = threadIdx.x; e < G::kPassSamples / 8; e += kThreads) {
      const int L = 8 * e;
      const T* src;
      if (L < kHead) {
        src = reinterpret_cast<const T*>(head) + L;
      } else {
        const int m = L - kHead;
        const int row = m / G::kRun;
        const int s = p * kStagesPerPass + row / kStageRows;
        src = reinterpret_cast<const T*>(ring + (s % kStages) * G::kStageBytes) +
              (row % kStageRows) * G::kRun + m % G::kRun;
      }
      float v[8];
      load8(src, v);
      float* dst = xf + L / G::kGroup * G::kGroupStride + L % G::kGroup;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }

  // Pass p, passes in order from 0: the 8 analytic outputs of this thread (of
  // rows [row0 + p*kPassRows, +kPassRows)) to zr, zi (shared memory), zeros for
  // rows past the capture. Called by every thread of the block; the caller's
  // barrier makes the outputs visible.
  __device__ __forceinline__ void pass(int p, const FirTaps& h, float* zr, float* zi) const {
    cp_async_wait_all();
    __syncthreads();  // this pass's stages have landed; the last pass's reads of xf are done
    convert(p);
    __syncthreads();  // xf is whole; the stages it came from are free
    for (int s = 0; s < kStagesPerPass; ++s) issue(kStages + p * kStagesPerPass + s);
    cp_async_commit();
    float ar[kQ], ai[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) ar[q] = ai[q] = 0.f;
    const int row = p * kPassRows + threadIdx.x / (kOut / kQ);
    if (row < n_rows && row0 + row < rows_cap) fir_taps_loop<T, DEC>(h, xf, ar, ai);
#pragma unroll
    for (int q = 0; q < kQ; q += 4) {
      *reinterpret_cast<float4*>(zr + q) = make_float4(ar[q], ar[q + 1], ar[q + 2], ar[q + 3]);
      *reinterpret_cast<float4*>(zi + q) = make_float4(ai[q], ai[q + 1], ai[q + 2], ai[q + 3]);
    }
  }
};

// How K8 and K9 walk a capture. A block owns the bits whose windows start in a
// chunk of the capture's analytic stream and computes the FIR rows under them:
// kChunkRows rows, the last `extra` of which only finish windows that started
// before them (the next chunk computes those rows again: extra of 512). After
// each pass it sums the bits whose windows that pass completed, from a ring in
// shared memory that holds the pass's outputs and the `extra` rows before them.
// So every pass is a full one, the filter's outputs never leave shared memory,
// and a block's start (tables, the first fetch) is paid once in 32 passes. The
// ring, one pass buffer and a one-pass raw ring keep a block near 45 KB (K9 at
// FSK19200) and 75 KB (K8 at FSK9600), and the kernels cap their registers at
// 85, so that three blocks share a multiprocessor: a warp outside the tap loop
// runs latency-bound code, and it is the other blocks' tap loops that keep the
// FMA pipe fed meanwhile.
constexpr int kChunkRows = 512;
constexpr int kPassOut = kPassRows * kOut;  // analytic outputs per pass

struct FirWalk {
  int extra, chunk_step, chunks_per_capture, ring;  // ring: analytic samples kept, (kPassRows + extra) * 128
  size_t smem;
};

// window: the longest run of analytic samples one bit reads.
template <typename T, int DEC, typename Kernel>
inline cudaError_t fir_plan_walk(Kernel kernel, int rows, int window, size_t table_bytes, FirWalk* walk) {
  if (window < 1 || window > kPassOut) return cudaErrorInvalidValue;
  walk->extra = (window + kOut - 1) / kOut;
  walk->chunk_step = kChunkRows - walk->extra;
  walk->chunks_per_capture = (rows + walk->chunk_step - 1) / walk->chunk_step;
  walk->ring = kPassOut + walk->extra * kOut;
  walk->smem = sizeof(float) * 2 * walk->ring + FirGeom<T, DEC>::kStagingBytes + table_bytes;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)walk->smem);
}

// Steps (row, bit) index pairs through e = tid, tid + step, ... without a
// division per item: e = row * spr2 + bit.
struct ItemStep {
  int d_row, d_bit;  // step / spr2, step % spr2
  __device__ __forceinline__ ItemStep(int step, int spr2) : d_row(step / spr2), d_bit(step % spr2) {}
  __device__ __forceinline__ void advance(int& row, int& bit, int spr2) const {
    row += d_row;
    bit += d_bit;
    if (bit >= spr2) {
      bit -= spr2;
      ++row;
    }
  }
};

// The boxcar rows [i_lo, i_hi] that can hold a bit whose window [n0, n0 + window)
// ends in (prev, lim]: n0 = i*row2 + first, 0 <= first < row2 + ov2.
__device__ __forceinline__ void rows_ending_in(int prev, int lim, int window, int row2, int ov2, int r2,
                                               int& i_lo, int& i_hi) {
  const int lo = prev + 1 - window - (row2 + ov2 - 1);  // the least i*row2
  i_lo = lo <= 0 ? 0 : (lo + row2 - 1) / row2;
  i_hi = min(r2 - 1, (lim - window) / row2);
}

// The operands the FIR takes: the row width of this DEC and 16-byte aligned rows.
template <typename T, int DEC>
inline bool fir_operands_ok(const void* x, int c_pad) {
  return c_pad == FirGeom<T, DEC>::kCPad && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace
