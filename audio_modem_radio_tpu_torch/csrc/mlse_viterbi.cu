// The Viterbi of the single-capture FSK receiver's MLSE over the CPFSK phase
// trellis, every block of one or more captures in one launch.
//
// Replaces the two jax.lax.scan calls of audio_modem_radio_tpu/ops/fsk.py
// _mlse_refine (the forward `step` scan and the `back` traceback scan), which
// the JAX package vmaps over blocks. There is no Pallas kernel there: XLA
// compiles each scan to one device-side loop. Without a kernel the port would
// launch every step from the host, some 150-200 thousand launches a 2^24-sample
// FSK9600 capture.
//
// What it computes, for block b of length L (ops/kernels.py
// mlse_viterbi_blocks_plain is the same function in PyTorch):
// * x[b] holds L steps of [S_m, C_m, S_s, C_s], the theta-corrected tone
//   correlations; cos_t, sin_t (S) the state phases; aec[b] (2, S) the
//   hypothesis energies times a/2 of the block's capture, rows [mark, space];
// * from pm = 0, step t takes for state s the better of its predecessors
//   p1 = s - adv_m (bit 1) and p0 = s - adv_s (bit 0), mod S, with
//   m = (S*cos_t + C*sin_t) - aec, cand = pm[p] + m[p] and bit 1 only where
//   cand1 > cand0 (strictly), then subtracts the step's maximum;
// * the traceback starts at the first maximum of the final metrics and
//   writes L bits.
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: nvcc contracts none of them into an FMA), in the
// plain version's order, so the bits equal the plain version's bit for bit.
//
// What bounds it on the H100: neither bytes nor operations. A 2^24-sample
// FSK9600 capture is 205 blocks of 10,240 steps: about 34 MB read and 1e9
// operations, some 0.015 ms at the card's peaks. The floor is the dependent
// chain of 10,240 steps a block, each of which needs the whole previous step.
//
// Design: one warp a block, one block a CUDA block of 32 threads (205 warps
// a capture run at once on 132 SMs; a batch's captures share the launch). Lane l holds states l, l + 32 and l + 64 (S <= 96)
// with their path metrics in registers. A step: each lane writes
// pm[q] + m1[q] and pm[q] + m0[q] of its states into the warp's shared slice
// (two buffers, alternating by step), reads its states' two predecessors'
// candidates, decides, votes the decisions into ceil(S/32) __ballot_sync
// words that lane 0 stores in the survivor scratch (L * ceil(S/32) words a
// block, allocated by the wrapper), and takes the step's maximum by five
// shuffles. The correlations come in 32 steps at a time by one coalesced
// load a lane into shared memory. The traceback stages 1024 steps of
// survivors in shared memory at a time and one lane walks them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPerLane = 3;    // states a lane: S <= 96
constexpr int kMaxStates = 32 * kPerLane;
constexpr int kStage = 32;     // forward steps staged a load
constexpr int kBack = 1024;    // traceback steps staged a load

__global__ void __launch_bounds__(32)
    mlse_viterbi_kernel(const float* __restrict__ x, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, const float* __restrict__ aec, int S, int adv_m,
                        int adv_s, uint32_t* __restrict__ surv, uint8_t* __restrict__ out, int L) {
  __shared__ float cand1[2][kMaxStates];
  __shared__ float cand0[2][kMaxStates];
  __shared__ float xs[4][kStage];
  __shared__ uint32_t back[kBack * kPerLane];
  __shared__ uint8_t bits[kBack];

  const int lane = threadIdx.x;
  const int W = (S + 31) >> 5;
  const float* xb = x + (size_t)blockIdx.x * 4 * L;
  const float* ab = aec + (size_t)blockIdx.x * 2 * S;
  uint32_t* sv = surv + (size_t)blockIdx.x * L * W;

  float c[kPerLane], sn[kPerLane], e1[kPerLane], e0[kPerLane], pm[kPerLane];
  int p1[kPerLane], p0[kPerLane];
  bool live[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int s = lane + 32 * j;
    live[j] = s < S;
    const int q = live[j] ? s : 0;
    c[j] = cos_t[q];
    sn[j] = sin_t[q];
    e1[j] = ab[q];
    e0[j] = ab[S + q];
    p1[j] = q - adv_m < 0 ? q - adv_m + S : q - adv_m;
    p0[j] = q - adv_s < 0 ? q - adv_s + S : q - adv_s;
    pm[j] = 0.0f;
  }

  for (int t0 = 0; t0 < L; t0 += kStage) {
    __syncwarp();
    if (t0 + lane < L) {
#pragma unroll
      for (int k = 0; k < 4; ++k) xs[k][lane] = xb[(size_t)k * L + t0 + lane];
    }
    __syncwarp();
    const int n = min(kStage, L - t0);
    for (int i = 0; i < n; ++i) {
      const int buf = i & 1;  // kStage is even: the parity of the step t0 + i
      const float sm = xs[0][i], cm = xs[1][i], ss = xs[2][i], cs = xs[3][i];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (live[j]) {
          const float m1 = __fsub_rn(__fadd_rn(__fmul_rn(sm, c[j]), __fmul_rn(cm, sn[j])), e1[j]);
          const float m0 = __fsub_rn(__fadd_rn(__fmul_rn(ss, c[j]), __fmul_rn(cs, sn[j])), e0[j]);
          cand1[buf][lane + 32 * j] = __fadd_rn(pm[j], m1);
          cand0[buf][lane + 32 * j] = __fadd_rn(pm[j], m0);
        }
      }
      __syncwarp();
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        bool take = false;
        if (live[j]) {
          const float a = cand1[buf][p1[j]], b = cand0[buf][p0[j]];
          take = a > b;
          pm[j] = take ? a : b;
          mx = fmaxf(mx, pm[j]);
        }
        const uint32_t word = __ballot_sync(kFull, take);
        if (lane == 0 && j < W) sv[(size_t)(t0 + i) * W + j] = word;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) pm[j] = __fsub_rn(pm[j], mx);
    }
  }

  // The first state holding the final maximum.
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (live[j]) mx = fmaxf(mx, pm[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  int first = S;
#pragma unroll
  for (int j = kPerLane - 1; j >= 0; --j)
    if (live[j] && pm[j] == mx) first = lane + 32 * j;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) first = min(first, __shfl_xor_sync(kFull, first, off));

  // Traceback, kBack steps at a time from the end.
  int state = first;
  uint8_t* ob = out + (size_t)blockIdx.x * L;
  for (int end = L; end > 0; end -= kBack) {
    const int beg = max(0, end - kBack);
    const int n = end - beg;
    __syncwarp();
    for (int k = lane; k < n * W; k += 32) back[k] = sv[(size_t)beg * W + k];
    __syncwarp();
    if (lane == 0) {
      for (int t = n - 1; t >= 0; --t) {
        const uint32_t bit = (back[t * W + (state >> 5)] >> (state & 31)) & 1u;
        bits[t] = (uint8_t)bit;
        state -= bit ? adv_m : adv_s;
        if (state < 0) state += S;
      }
    }
    __syncwarp();
    for (int k = lane; k < n; k += 32) ob[beg + k] = bits[k];
  }
}

}  // namespace

extern "C" int amr_mlse_viterbi(const float* x, const float* cos_t, const float* sin_t, const float* aec, int S,
                                int adv_m, int adv_s, uint32_t* surv, uint8_t* out, int n_blocks, int L,
                                cudaStream_t stream) {
  if (n_blocks <= 0 || L <= 0) return 0;
  if (S < 2 || S > kMaxStates) return (int)cudaErrorInvalidValue;
  mlse_viterbi_kernel<<<n_blocks, 32, 0, stream>>>(x, cos_t, sin_t, aec, S, adv_m, adv_s, surv, out, L);
  return (int)cudaGetLastError();
}
