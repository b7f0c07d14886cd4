// The Viterbi of the single-capture FSK receiver's MLSE over the CPFSK phase
// trellis, every block of one or more captures in one launch.
//
// Replaces the two jax.lax.scan calls of audio_modem_radio_tpu/ops/fsk.py
// _mlse_refine (the forward `step` scan and the `back` traceback scan), which
// the JAX package vmaps over blocks. There is no Pallas kernel there: XLA
// compiles each scan to one device-side loop.
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
// FSK9600 capture is 205 blocks of 10,240 steps: about 34 MB read and 1.4e9
// operations, some 0.02 ms at the card's peaks. The floor is the chain of
// 10,240 dependent steps a block: each step needs every state's metric from
// the step before, and its maximum. A capture's 205 blocks run one warp
// each, at most two on an SM and never two on one scheduler, so the
// kernel's time is one warp's chain; a batch's 1,640 blocks put three or
// four warps on each scheduler, where issue slots and the shared-memory
// pipe (LDS, STS, REDUX) count as well.
//
// Design: one warp a block, one block a CUDA block of 32 threads. Lane l
// holds states l + 32 j, j < K = ceil(S/32) (a template argument: 1, 2 or
// 3, so no slot tests liveness at run time), with their raw (not yet
// normalised) path metrics pm[j] in registers; a dead slot (l + 32 j >= S)
// gets aec = +inf, so its metric stays -inf and neither wins the maximum
// nor sets a bit. A step, t:
//   1. the step maximum mx: fmaxf over the lane's K metrics, then two
//      REDUX (__reduce_max_sync and __reduce_min_sync) on the raw bits as
//      int32, side by side, and a select (warp_max below);
//   2. beside them the exchange: each lane stores its K metrics with one
//      vector store to shared memory (state p at K' (p mod 32) + p / 32,
//      K' = 1, 2, 4; two buffers by step parity, one __syncwarp) and each
//      state loads its two predecessors' raw metrics;
//   3. in the REDUX's shadow, the next step's branch metrics m1, m0 of the
//      lane's predecessors (4 rounded operations each) from the next
//      step's correlations (one broadcast LDS.128);
//   4. the receiver normalises: cand = (pm_raw[p] - mx) + m[p], the same
//      two roundings as the plain version's pm - max followed by pm[p] + m;
//      bit = cand1 > cand0, pm = fmaxf(cand1, cand0);
//   5. off the chain: K __ballot_sync words of the bits (bit l of word j
//      for state l + 32 j), which lane (t mod 32) keeps; every 32 steps
//      each lane stores its K words, one coalesced store a word (survivors
//      laid out [t / 32][j][t mod 32]).
// The correlations of the next 32 steps are loaded into registers when a
// stage starts and stored to shared memory halfway through it, so no step
// waits on global memory.
//
// Per-step cycle budget (K = 2, S = 48: FSK9600), the loop-carried chain as
// sass_stats.py --chain reads it from the SASS, at the latencies that
// csrc/probe/latency.cu measured on the card (SM cycles; NVIDIA H100 80GB
// HBM3, 700 W; PERF.md): FMNMX (the new metric, 4.1) -> FMNMX (the lane's
// maximum, 4.1) -> REDUX.MAX beside REDUX.MIN (44.1) -> IMAD.U32 (the
// uniform result into a vector register, counted in the REDUX) -> ISETP
// (3.4) -> SEL (4.1) -> FADD (pm_raw[p] - mx, 4.1) -> FADD (+ m[p], 4.1):
// 68 cycles. The exchange (STS.64, the __syncwarp, LDS: 23) runs beside the
// REDUX. A step issues about 46 instructions (16 for the branch metrics, 5
// LDS, 2 REDUX, the FSETP, the ballots and their keeping); the card ran
// 122-124 cycles a step for the capture's 205 blocks, so about 55 cycles a
// step go to issue and to the shared-memory pipe (LDS, STS and REDUX share
// it), and a traceback step costs about 20 (its chain: ISETP, SEL, SHF,
// LOP3, SEL).
//
// What the parent design lost and what this one does about it:
// * One warp on a scheduler hides no latency, so the step is the chain:
//   the five SHFL + FMNMX rounds of the maximum (about 150 cycles) became
//   two REDUX side by side (44); no order-preserving key is needed on
//   either side of them (below); the exchange runs beside them; the branch
//   metrics, which do not depend on pm, are computed in the REDUX's shadow
//   a step ahead, from correlations already in shared memory.
// * Off-chain work no longer sits in the chain's way: the ballots stay in
//   registers (no lane-0 global store a step), K is a template argument
//   (no liveness branches), x comes with one LDS.128 a step.
// * The synchronous global load every 32 steps is issued a stage ahead.
// * The traceback was one lane walking 10,240 steps through shared memory;
//   now it is two phases of lane-parallel work (below).
// A second path with the survivors in shared memory (80 KB a block at 48
// states) was not taken: phase A reads each stage's words once, from L2,
// 16 LDG.128 a lane. Several blocks a warp (fewer lanes, more states a
// lane) was not taken either: it lengthens each step's chain, and the
// single capture is bound by that chain. A shuffle exchange (the sender
// picking the slot, one SHFL a predecessor) measured slower than shared
// memory, as did one REDUX on an order-preserving key (two more ALU
// operations on each side of it).
//
// Why the bits equal the plain version's though the maximum and the
// normalisation are taken elsewhere:
// * warp_max: a float's bits as int32 order the non-negative floats (+0
//   included) as floats, and every negative float (-0 included) is a
//   negative int whose value grows with its magnitude. So where some value
//   is >= +0 the signed int maximum is the bits of the float maximum, and
//   where every value is negative or -0 the signed int minimum is. The
//   result is a float equal (==) to fmaxf's maximum, differing at most in
//   the sign of an exact zero.
// * fmaxf(cand1, cand0) equals the plain select (cand1 where cand1 > cand0,
//   else cand0) as a value: the two differ only when cand1 == cand0 are
//   zeros of opposite sign.
// * The sign of a zero changes no later decision: IEEE sums and
//   differences of equal values are equal values (a zero's sign can only
//   decide the sign of a zero result), > and == ignore it, and fmaxf and
//   warp_max pick equal values. So every cand, pm and mx equals the plain
//   version's as a value at every step, and every bit and the traceback's
//   first maximum (pm == mx, which holds exactly where the plain version's
//   pm - mx is 0) are the same.
// * The receiver rounds pm_raw[p] - mx and then + m[p], the plain version's
//   two operations on the same floats; nothing is reassociated.
//
// Traceback, exact in two phases. The block's stages are cut into 32
// segments, lane g holding stages [g n / 32, (g + 1) n / 32). Phase A: lane
// g walks its segment back from a guess, the first state holding the
// maximum after its last step (found beside that step's maximum; lane 31,
// which holds the last stage, starts from the true final state), writing
// each step's bit and guessed state; a stage's survivor words come in 16
// LDG.128 and its 32-step walk is unrolled over registers. Phase B: from
// the end, the true path enters each stage at a known state X. Where X is
// the guessed state after the stage's last step, the two paths have met
// and the rest of that segment is right, so X becomes its entry state;
// else the warp walks the stage's 32 steps (the words broadcast by
// __shfl_sync, the next stage's loaded meanwhile) and stores their bits.
// A walk step's chain is s -> (s >= 32: the word) -> bit s mod 32 -> the
// predecessor, both predecessors computed beside the bit. On the FSK9600
// capture the guessed paths meet most segments within a stage or two;
// some do not meet within the segment, and phase B walks those whole.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxPerLane = 3;  // S <= 96

// The warp's maximum of one non-NaN float a lane, from two REDUX on the
// raw bits as int32: where some value is >= +0 the signed maximum is the
// largest of them (every negative float, -0 included, is a negative int);
// where all are negative the signed minimum is the one of least magnitude.
__device__ __forceinline__ float warp_max(float v) {
  const int b = __float_as_int(v);
  const int hi = __reduce_max_sync(kFull, b), lo = __reduce_min_sync(kFull, b);
  return __int_as_float(hi >= 0 ? hi : lo);
}

// Survivor bit of state s (bit s mod 32 of ballot word s / 32) in the
// step's K words.
template <int K>
__device__ __forceinline__ uint32_t survivor_bit(const uint32_t (&w)[K], int s) {
  uint32_t word = w[0];
  if constexpr (K > 1) word = s >= 32 ? w[1] : word;
  if constexpr (K > 2) word = s >= 64 ? w[2] : word;
  return (word >> (s & 31)) & 1u;
}

// The state before the step, given the state after it and its survivor bit:
// both predecessors are computed beside the bit, which then picks one.
__device__ __forceinline__ int predecessor(int s, uint32_t bit, int S, int adv_m, int adv_s) {
  const int p1 = s >= adv_m ? s - adv_m : s - adv_m + S;
  const int p0 = s >= adv_s ? s - adv_s : s - adv_s + S;
  return bit ? p1 : p0;
}

template <int K>
__global__ void __launch_bounds__(32)
    mlse_viterbi_kernel(const float* __restrict__ x, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, const float* __restrict__ aec, int S, int adv_m,
                        int adv_s, uint32_t* __restrict__ scratch, uint8_t* __restrict__ out, int L) {
  __shared__ float4 xs[64];          // two stages of correlations, a ring
  constexpr int kStride = K == 3 ? 4 : K;  // state p at kStride * (p mod 32) + p / 32
  __shared__ __align__(16) float xch[2][32 * kStride];  // the exchange, two buffers by step parity

  const int lane = threadIdx.x;
  const int n_stages = (L + 31) >> 5;
  const float* xb = x + (size_t)blockIdx.x * 4 * L;
  const float* ab = aec + (size_t)blockIdx.x * 2 * S;
  uint32_t* sv = scratch + (size_t)blockIdx.x * n_stages * (32 * K + 8);
  uint32_t* guessed = sv + (size_t)n_stages * 32 * K;  // phase A's states, 4 a word

  // This lane's states and their predecessors' tables.
  float c1[K], s1[K], e1[K], c0[K], s0[K], e0[K], pm[K];
  int p1[K], p0[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = lane + 32 * j;
    const bool live = s < S;
    const int q = live ? s : 0;
    p1[j] = q >= adv_m ? q - adv_m : q - adv_m + S;
    p0[j] = q >= adv_s ? q - adv_s : q - adv_s + S;
    c1[j] = cos_t[p1[j]];
    s1[j] = sin_t[p1[j]];
    e1[j] = live ? ab[p1[j]] : INFINITY;
    c0[j] = cos_t[p0[j]];
    s0[j] = sin_t[p0[j]];
    e0[j] = live ? ab[S + p0[j]] : INFINITY;
    pm[j] = live ? 0.0f : -INFINITY;
  }
  uint32_t sw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) sw[j] = 0u;

  // The correlations of step t + lane (zeros past the block).
  auto load_x = [&](int t) {
    const int i = t + lane;
    return i < L ? make_float4(xb[i], xb[L + i], xb[2 * L + i], xb[3 * L + i]) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // The branch metrics of this lane's predecessors for one step.
  float m1[K], m0[K];
  auto metrics = [&](float4 xv, float (&n1)[K], float (&n0)[K]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      n1[j] = __fsub_rn(__fadd_rn(__fmul_rn(xv.x, c1[j]), __fmul_rn(xv.y, s1[j])), e1[j]);
      n0[j] = __fsub_rn(__fadd_rn(__fmul_rn(xv.z, c0[j]), __fmul_rn(xv.w, s0[j])), e0[j]);
    }
  };

  // Lane g's stages are [sb, se): phase A of the traceback starts from the
  // first state holding the maximum after step 32 se - 1, which the first
  // step of stage se finds beside its own maximum.
  const int sb = (lane * n_stages) >> 5, se = ((lane + 1) * n_stages) >> 5;
  int guess = 0;

  // One step t with this step's metrics in m1, m0; computes the next
  // step's from xn while the maximum and the exchange are in flight.
  auto step = [&](int t, float4 xn, bool stage_start) {
    float lm = pm[0];
#pragma unroll
    for (int j = 1; j < K; ++j) lm = fmaxf(lm, pm[j]);
    const float mx = warp_max(lm);
    float* buf = xch[t & 1];
    if constexpr (K == 1) buf[lane] = pm[0];
    else if constexpr (K == 2) *reinterpret_cast<float2*>(buf + 2 * lane) = make_float2(pm[0], pm[1]);
    else *reinterpret_cast<float4*>(buf + 4 * lane) = make_float4(pm[0], pm[1], pm[2], 0.0f);
    __syncwarp();
    float v1[K], v0[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v1[j] = buf[kStride * (p1[j] & 31) + (p1[j] >> 5)];
      v0[j] = buf[kStride * (p0[j] & 31) + (p0[j] >> 5)];
    }
    float n1[K], n0[K];
    metrics(xn, n1, n0);
    if (stage_start && t > 0) {
      int f = 0x7FFFFFFF;
#pragma unroll
      for (int j = K - 1; j >= 0; --j)
        if (pm[j] == mx) f = lane + 32 * j;
      f = __reduce_min_sync(kFull, f);
      guess = t == (se << 5) ? f : guess;
    }
    const bool keep = lane == (t & 31);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float a = __fadd_rn(__fsub_rn(v1[j], mx), m1[j]);
      const float b = __fadd_rn(__fsub_rn(v0[j], mx), m0[j]);
      pm[j] = fmaxf(a, b);
      const uint32_t word = __ballot_sync(kFull, a > b);
      sw[j] = keep ? word : sw[j];
      m1[j] = n1[j];
      m0[j] = n0[j];
    }
  };

  xs[lane] = load_x(0);
  __syncwarp();
  metrics(xs[0], m1, m0);
  for (int st = 0; st < n_stages; ++st) {
    const int t0 = st << 5;
    float4* xr = xs + ((st & 1) << 5);
    float4* xnext = xs + (((st + 1) & 1) << 5);
    const float4 nx = load_x(t0 + 32);  // in flight during the stage's first 16 steps
    if (t0 + 32 <= L) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i == 16) xnext[lane] = nx;  // read from step 31 on, after the steps' __syncwarp
        step(t0 + i, i < 31 ? xr[i + 1] : xnext[0], i == 0);
      }
    } else {
      step(t0, xr[1], true);
      for (int i = 1; i < L - t0; ++i) step(t0 + i, xr[(i + 1) & 31], false);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) sv[(st * K + j) * 32 + lane] = sw[j];
  }

  // The first state holding the final maximum.
  float lm = pm[0];
#pragma unroll
  for (int j = 1; j < K; ++j) lm = fmaxf(lm, pm[j]);
  const float mx = warp_max(lm);
  int first = 0x7FFFFFFF;
#pragma unroll
  for (int j = K - 1; j >= 0; --j)
    if (pm[j] == mx) first = lane + 32 * j;
  const int s_end = __reduce_min_sync(kFull, first);

#ifndef AMR_MLSE_NO_TRACEBACK  // defined only to time the forward pass alone (kernel_variants.py)
  __syncwarp();  // every lane's survivor words stored before any lane reads a stage
  // Traceback, phase A: lane g walks its own stages back from its guess
  // (lane 31, which holds the last stage, from the true final state),
  // writing the bits and the guessed state of every step.
  uint8_t* ob = out + (size_t)blockIdx.x * L;
  int s = lane == 31 ? s_end : guess;
  // Steps 32 st + n - 1 down to 32 st of the stage whose words are w.
  auto walk = [&](const uint32_t (&w)[K][32], int st, int n, uint32_t (&packed)[8]) {
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      if (i < n) {
        uint32_t wi[K];
#pragma unroll
        for (int j = 0; j < K; ++j) wi[j] = w[j][i];
        const uint32_t bit = survivor_bit<K>(wi, s);
        packed[i >> 2] |= (uint32_t)s << (8 * (i & 3));
        ob[(st << 5) + i] = (uint8_t)bit;
        s = predecessor(s, bit, S, adv_m, adv_s);
      }
    }
  };
  for (int st = se - 1; st >= sb; --st) {
    uint32_t w[K][32];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint4* src = reinterpret_cast<const uint4*>(sv + (st * K + j) * 32);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const uint4 q = src[v];
        w[j][4 * v] = q.x;
        w[j][4 * v + 1] = q.y;
        w[j][4 * v + 2] = q.z;
        w[j][4 * v + 3] = q.w;
      }
    }
    uint32_t packed[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if ((st << 5) + 32 <= L)
      walk(w, st, 32, packed);  // n = 32: no step's bound is tested
    else
      walk(w, st, L - (st << 5), packed);
    uint4* dst = reinterpret_cast<uint4*>(guessed + st * 8);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
  const int entry = s;  // the guessed state before this lane's first step
  __syncwarp();

  // Phase B: from lane 31's first stage back, the true path enters each
  // stage at a known state X. Where X is phase A's guessed state after the
  // stage's last step, the paths have met: the rest of that lane's stages
  // are right, and X becomes its entry state. Else the warp walks the 32
  // steps (the words broadcast by __shfl_sync) and stores their bits, the
  // next stage's words in flight meanwhile.
  int X = __shfl_sync(kFull, entry, 31);
  int st = ((31 * n_stages) >> 5) - 1;
  uint32_t gl = 0u, wl[K];
  auto load_stage = [&](int at) {
    gl = (guessed[at * 8 + (lane >> 2)] >> (8 * (lane & 3))) & 0xFFu;
#pragma unroll
    for (int j = 0; j < K; ++j) wl[j] = sv[(at * K + j) * 32 + lane];
  };
  if (st >= 0) load_stage(st);
  while (st >= 0) {
    if ((int)__shfl_sync(kFull, gl, 31) == X) {
      const int g = ((32 * (st + 1) + n_stages - 1) / n_stages) - 1;  // the lane holding stage st
      X = __shfl_sync(kFull, entry, g);
      st = ((g * n_stages) >> 5) - 1;
      if (st >= 0) load_stage(st);
      continue;
    }
    uint32_t cur[K];
#pragma unroll
    for (int j = 0; j < K; ++j) cur[j] = wl[j];
    if (st > 0) load_stage(st - 1);
    uint32_t mine = 0u;
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      uint32_t wi[K];
#pragma unroll
      for (int j = 0; j < K; ++j) wi[j] = __shfl_sync(kFull, cur[j], i);
      const uint32_t bit = survivor_bit<K>(wi, X);
      mine = lane == i ? bit : mine;
      X = predecessor(X, bit, S, adv_m, adv_s);
    }
    ob[(st << 5) + lane] = (uint8_t)mine;
    --st;
  }
#else
  if (lane == 0) out[blockIdx.x] = (uint8_t)s_end;
#endif
}

template <int K>
int launch(const float* x, const float* cos_t, const float* sin_t, const float* aec, int S, int adv_m, int adv_s,
           uint32_t* scratch, uint8_t* out, int n_blocks, int L, cudaStream_t stream) {
  mlse_viterbi_kernel<K><<<n_blocks, 32, 0, stream>>>(x, cos_t, sin_t, aec, S, adv_m, adv_s, scratch, out, L);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: n_blocks * ceil(L / 32) * (32 * ceil(S / 32) + 8) words.
extern "C" int amr_mlse_viterbi(const float* x, const float* cos_t, const float* sin_t, const float* aec, int S,
                                int adv_m, int adv_s, uint32_t* scratch, uint8_t* out, int n_blocks, int L,
                                cudaStream_t stream) {
  if (n_blocks <= 0 || L <= 0) return 0;
  if (S < 2 || S > 32 * kMaxPerLane || adv_m < 0 || adv_m >= S || adv_s < 0 || adv_s >= S)
    return (int)cudaErrorInvalidValue;
  if (S <= 32) return launch<1>(x, cos_t, sin_t, aec, S, adv_m, adv_s, scratch, out, n_blocks, L, stream);
  if (S <= 64) return launch<2>(x, cos_t, sin_t, aec, S, adv_m, adv_s, scratch, out, n_blocks, L, stream);
  return launch<3>(x, cos_t, sin_t, aec, S, adv_m, adv_s, scratch, out, n_blocks, L, stream);
}
