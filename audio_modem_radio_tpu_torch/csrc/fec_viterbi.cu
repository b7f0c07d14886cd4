// The Viterbi decoder of the K = 7, rate-1/2 convolutional code (G1 = 0o171,
// G2 = 0o133), every block of a call in one launch.
//
// Replaces the two jax.lax.scan calls of audio_modem_radio_tpu/fec.py
// _viterbi_block (the forward `step` scan and the `back` traceback scan),
// which viterbi_decode_bits vmaps over the blocks of a long stream. There is
// no Pallas kernel there: XLA compiles each scan to one device-side loop.
//
// What it computes, for block b of L steps (ops/kernels.py
// fec_viterbi_blocks_plain is the same function in PyTorch):
// * pairs[b] holds L received pairs (r0, r1), hard bits or soft values;
// * new state s (input bit s & 1) has the predecessors p0 = s >> 1 and
//   p1 = (s >> 1) | 32, whose transitions expect the output pairs e0(s),
//   e1(s) (the parities of the register (p << 1) | b under G1 and G2);
// * the branch metric is |r0 - e0| + |r1 - e1|, the candidates are
//   cand = pm[p] + bm, state s keeps p1 only where cand1 < cand0 (strictly:
//   ties keep p0), and the step's minimum is subtracted from every metric;
// * with `known_boundaries` the metrics start at 0 for state 0 and 1e9 for
//   the others and the traceback starts at state 0; without, the metrics
//   start at 0 and the traceback starts at the first state holding the
//   final minimum; it writes each step's input bit (the state's low bit).
// Every sum and difference is rounded on its own (__fadd_rn, __fsub_rn), in
// the plain version's order; there is no product, so nothing could fuse into
// an FMA anyway. The bits equal the plain version's bit for bit (below).
//
// What bounds it on the H100: neither bytes nor operations. A stream-FEC
// decode of one 2^24-sample QPSK@9600 capture is 205 blocks of 9,216 steps:
// 15 MB of pairs in, 1.9 MB of bits out and about 0.8e9 operations, some
// 0.01 ms at the card's peaks. The floor is the chain of 9,216 dependent
// steps a block: each step needs every state's metric from the step before,
// and their minimum. The 205 blocks run one warp each, at most two on an SM
// and never two on one scheduler, so one warp hides no latency and the
// kernel's time is one warp's chain plus what its issue adds.
//
// Design: one warp a block, one block a CUDA block of 32 threads. Lane l
// holds the raw (not yet normalised) metrics of states l and l + 32, exactly
// the two predecessors of the new states 2l and 2l + 1, so both candidates
// of both new states are local to the lane. A step t:
//   1. the receiver normalises: a = pm_raw[l] - mn, c = pm_raw[l + 32] - mn,
//      with mn the minimum of step t - 1 (0 before the first step, and
//      x - 0 == x), then the four candidates a + bm and c + bm;
//   2. the two new raw metrics by fminf, and beside them the two decisions
//      (FSETP, off the chain);
//   3. the step minimum: fminf over the lane's two, then one REDUX
//      (__reduce_min_sync) on the raw bits as int32 (why that is the float
//      minimum: below); beside it the exchange: each lane stores its two raw
//      new metrics at once with one STS.64 (two buffers by step parity, one
//      __syncwarp) and loads states l and l + 32;
//   4. in the REDUX's shadow, step t + 1's two branch metrics from its pair,
//      already in shared memory (below: two suffice);
//   5. off the chain: two __ballot_sync give the 64 decisions (word 0: the
//      even states 2l at bit l, word 1: the odd states 2l + 1 at bit l),
//      which lane t mod 32 keeps; every 32 steps each lane stores its two
//      words, one coalesced store a word (survivors laid out
//      [t / 32][word][t mod 32]).
// So the exchange no longer sits between the REDUX and the next step: the
// chain is REDUX.MIN -> FADD (pm_raw - mn) -> FADD (+ bm) -> FMNMX (the new
// metric) -> FMNMX (the lane's minimum) -> REDUX.MIN, and the STS.64, the
// __syncwarp and the LDS run beside the REDUX.
// The pairs of the next 32 steps are loaded into a register when a stage
// starts and stored to shared memory halfway through it, so no step waits
// on global memory.
//
// Per-step cycle budget, the loop-carried chain as sass_stats.py reads it
// from the SASS at the latencies csrc/probe/latency.cu measured on the card
// (SM cycles; NVIDIA H100 80GB HBM3, 700 W; PERF.md): REDUX.MIN (44.1, the
// uniform result's move into a vector register counted in it) -> FADD ->
// FADD -> FMNMX -> FMNMX (4.1 each): 60.5 cycles, from the parent design's
// 98.9, whose exchange sat between the REDUX and the next step. A step
// issues about 30 instructions (6 FADD for the branch metrics, 6 for the
// candidates, 3 FMNMX, 2 FSETP, the REDUX and its move, STS.64, the
// __syncwarp, 3 LDS, 2 ballots and their keeping), and the card ran 87-90
// cycles a step for a capture's 205 blocks, from 183. ptxas issues the
// STS.64 and an LDS of the exchange before the REDUX in every variant
// tried, and one warp alone on its scheduler hides none of the other
// instructions' latencies: a timing probe with neither the REDUX nor the
// exchange (wrong bits) still ran 63.5 cycles a step. Not faster, so not
// kept: the REDUX as volatile asm; the pairs read two steps at a time
// (LDS.128); the branch metrics of a stage tabled a stage ahead (fewer
// FADD, more shared memory: slower); the REDUX's input computed before the
// candidates as (min(pm_raw[l], pm_raw[l + 32]) - mn) + min(bm(E),
// bm(~E)), which rounding's monotony makes the same float.
//
// Two branch metrics a step, not four: G1 and G2 both have their first and
// last taps (bits 0 and 6) set. Predecessor l + 32's register differs from
// predecessor l's in bit 6 only, and input 1's from input 0's in bit 0 only,
// so each flips both parities: with E = (e0, e1) the pair that predecessor l
// expects for input 0, predecessor l expects ~E for input 1, and predecessor
// l + 32 expects ~E for input 0 and E for input 1. So new state 2l takes
// a + bm(E) and c + bm(~E), new state 2l + 1 takes a + bm(~E) and c + bm(E).
// bm(E) and bm(~E) are the plain version's metrics of those codes, rounded
// the same way, so nothing changes but the count.
//
// Why the bits equal the plain version's though the minimum and the
// normalisation are taken elsewhere:
// * The receiver rounds pm_raw[p] - mn and then + bm, the plain version's
//   two operations (pm - pm.amin() after step t - 1, then pm[p] + bm) on the
//   same floats; nothing is reassociated.
// * No metric is -0 or NaN: a branch metric is a sum of two absolute values
//   (>= +0); pm_raw - mn >= +0, since mn is the minimum and x - x is +0 in
//   round to nearest; so every candidate, and every raw metric, is a sum of
//   two values >= +0, which is >= +0, and finite for finite pairs (an
//   infinite or NaN pair would make NaN metrics, for which no order holds:
//   inputs must be finite). The start metrics 0 and 1e9 are >= +0 too.
// * fminf(cand0, cand1) equals the plain select (cand1 where cand1 < cand0,
//   else cand0) as bits: they differ only where the two are equal values of
//   opposite sign, which needs a -0.
// * The REDUX gives the float minimum: the bits of non-negative floats (+0
//   included), read as int32, are non-negative ints ordered as the floats
//   are, so the signed int minimum is the bits of the float minimum.
// * The traceback's end state without known boundaries: the plain version
//   takes the first state whose normalised final metric x - mn is 0 (its
//   argmin, since the minimum normalises to +0 and none is below). With
//   gradual underflow (nvcc's default, no -ftz), x - mn == 0 holds exactly
//   where x == mn, so the first state whose raw final metric equals mn is
//   the same state.
//
// Traceback, exact in two phases. The block's n stages of 32 steps are cut
// into 32 segments, lane g holding stages [g n / 32, (g + 1) n / 32) (empty
// for some lanes where n < 32). Phase A: lane g walks its segment back from a
// guess, the first state holding the step minimum after its segment's last
// step (found beside that step's REDUX from two ballots, once a stage); lane
// 31, which holds the last stage, starts from the true end
// state. It writes each step's bit and, once a stage, the state it entered
// the stage at (the state after the stage's last step). A stage's 64
// survivor words come in 16 LDG.128, its 32-step walk is unrolled over
// registers: a state s's survivor bit is bit s >> 1 of word s & 1, its
// predecessor (s >> 1) | (bit << 5). Phase B: from the end, the true path
// enters each stage at a known state X. Where X is phase A's state at that
// stage, the two paths have met and the rest of that lane's segment is
// right, so X becomes the segment's entry state; else the warp walks the
// stage's 32 steps (both words broadcast by __shfl_sync before the state
// picks one, the next stage's loaded meanwhile) and stores their bits. A
// walk step's chain is s -> the word -> the bit -> the predecessor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kG1 = 0171, kG2 = 0133;  // octal, as in fec.py

// The first state that holds a minimum, from two ballots of the lanes that
// hold it: states 2l (in b0) and 2l + 1 (in b1) where `odd` is 1 (the new
// metrics of a step), states l (in b0) and l + 32 (in b1) where it is 0
// (the exchanged ones). At least one ballot is not 0.
__device__ __forceinline__ int first_state(uint32_t b0, uint32_t b1, int odd) {
  const int f0 = b0 ? (__ffs(b0) - 1) << odd : 64;
  const int f1 = b1 ? (odd ? 2 * __ffs(b1) - 1 : __ffs(b1) + 31) : 64;
  return f0 < f1 ? f0 : f1;
}

__device__ __forceinline__ float parity7(uint32_t x) { return (float)(__popc(x & 0x7Fu) & 1); }

// |r0 - e0| + |r1 - e1|, rounded as the plain version rounds it.
__device__ __forceinline__ float branch(float2 r, float e0, float e1) {
  return __fadd_rn(fabsf(__fsub_rn(r.x, e0)), fabsf(__fsub_rn(r.y, e1)));
}

__global__ void __launch_bounds__(32)
    fec_viterbi_kernel(const float2* __restrict__ pairs, int known_boundaries, uint32_t* __restrict__ scratch,
                       uint8_t* __restrict__ out, int L) {
  __shared__ float2 ps[64];                   // two stages of pairs, a ring
  __shared__ __align__(16) float xch[2][64];  // the exchange, two buffers by step parity

  const int lane = threadIdx.x;
  const int n_stages = (L + 31) >> 5;
  const float2* pb = pairs + (size_t)blockIdx.x * L;
  uint32_t* sv = scratch + (size_t)blockIdx.x * n_stages * 64;
  // Phase A's state at each stage, after every block's survivors.
  uint32_t* entered = scratch + (size_t)gridDim.x * n_stages * 64 + (size_t)blockIdx.x * n_stages;

  // The pair E that predecessor l expects for input 0 (eE*) and its
  // complement ~E, which it expects for input 1 (eN*).
  const uint32_t reg = (uint32_t)lane << 1;
  const float eE0 = parity7(reg & kG1), eE1 = parity7(reg & kG2);
  const float eN0 = parity7((reg | 1u) & kG1), eN1 = parity7((reg | 1u) & kG2);
  // Raw metrics of states l (pa) and l + 32 (pc); mn: the minimum to subtract.
  float pa = known_boundaries ? (lane == 0 ? 0.0f : 1e9f) : 0.0f;
  float pc = known_boundaries ? 1e9f : 0.0f;
  float mn = 0.0f;
  float bE, bN;               // this step's bm(E), bm(~E)
  uint32_t k0 = 0u, k1 = 0u;  // the survivor words of step 32 st + lane

  // Lane g's stages are [sb, se); phase A starts from the first state
  // holding the minimum after step 32 se - 1.
  const int sb = (lane * n_stages) >> 5, se = ((lane + 1) * n_stages) >> 5;
  int guess = 0;

  // One step t with this step's branch metrics in bE, bN; computes the next
  // step's from the pair rn while the minimum and the exchange are in flight.
  auto step = [&](int t, float2 rn, bool stage_end) {
    const float a = __fsub_rn(pa, mn), c = __fsub_rn(pc, mn);
    const float c00 = __fadd_rn(a, bE), c10 = __fadd_rn(c, bN);  // new state 2l
    const float c01 = __fadd_rn(a, bN), c11 = __fadd_rn(c, bE);  // new state 2l + 1
    const float n0 = fminf(c00, c10), n1 = fminf(c01, c11);
    const bool ch0 = c10 < c00, ch1 = c11 < c01;
    const float m = __int_as_float(__reduce_min_sync(kFull, __float_as_int(fminf(n0, n1))));
    float* buf = xch[t & 1];
    *reinterpret_cast<float2*>(buf + 2 * lane) = make_float2(n0, n1);
    __syncwarp();
    pa = buf[lane];
    pc = buf[lane + 32];
    bE = branch(rn, eE0, eE1);
    bN = branch(rn, eN0, eN1);
    const uint32_t w0 = __ballot_sync(kFull, ch0), w1 = __ballot_sync(kFull, ch1);
    const bool keep = lane == (t & 31);
    k0 = keep ? w0 : k0;
    k1 = keep ? w1 : k1;
    if (stage_end) {
      const int first = first_state(__ballot_sync(kFull, n0 == m), __ballot_sync(kFull, n1 == m), 1);
      guess = (t >> 5) == se - 1 ? first : guess;
    }
    mn = m;
  };

  const float2 zero = make_float2(0.0f, 0.0f);
  ps[lane] = lane < L ? pb[lane] : zero;
  __syncwarp();
  bE = branch(ps[0], eE0, eE1);
  bN = branch(ps[0], eN0, eN1);
  for (int st = 0; st < n_stages; ++st) {
    const int t0 = st << 5;
    const float2* pr = ps + ((st & 1) << 5);
    float2* pnext = ps + (((st + 1) & 1) << 5);
    const float2 nx = t0 + 32 + lane < L ? pb[t0 + 32 + lane] : zero;  // in flight for 16 steps
    if (t0 + 32 <= L) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i == 16) pnext[lane] = nx;  // its readers were stage st - 1's steps; read from step 31 on
        step(t0 + i, i < 31 ? pr[i + 1] : pnext[0], i == 31);
      }
    } else {
      for (int i = 0; i < L - t0; ++i) step(t0 + i, pr[(i + 1) & 31], false);
    }
    sv[(st * 2) * 32 + lane] = k0;
    sv[(st * 2 + 1) * 32 + lane] = k1;
  }

  // The true end state: 0, or the first state holding the final minimum.
  int s_end = 0;
  if (!known_boundaries) s_end = first_state(__ballot_sync(kFull, pa == mn), __ballot_sync(kFull, pc == mn), 0);

  __syncwarp();  // every lane's survivor words stored before any lane reads a stage
  // Phase A: lane g walks its own stages back from its guess (lane 31 from
  // the true end state), writing the bits and each stage's entry state.
  uint8_t* ob = out + (size_t)blockIdx.x * L;
  int s = lane == 31 ? s_end : guess;
  // Steps 32 st + n - 1 down to 32 st of the stage whose words are w0, w1.
  auto walk = [&](const uint32_t (&w0)[32], const uint32_t (&w1)[32], int st, int n) {
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      if (i < n) {
        ob[(st << 5) + i] = (uint8_t)(s & 1);
        const uint32_t w = (s & 1) ? w1[i] : w0[i];
        s = (s >> 1) | (int)(((w >> (s >> 1)) & 1u) << 5);
      }
    }
  };
  for (int st = se - 1; st >= sb; --st) {
    uint32_t w0[32], w1[32];
    const uint4* src = reinterpret_cast<const uint4*>(sv + st * 64);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const uint4 q0 = src[v], q1 = src[8 + v];
      w0[4 * v] = q0.x;
      w0[4 * v + 1] = q0.y;
      w0[4 * v + 2] = q0.z;
      w0[4 * v + 3] = q0.w;
      w1[4 * v] = q1.x;
      w1[4 * v + 1] = q1.y;
      w1[4 * v + 2] = q1.z;
      w1[4 * v + 3] = q1.w;
    }
    entered[st] = (uint32_t)s;
    if ((st << 5) + 32 <= L)
      walk(w0, w1, st, 32);  // n = 32: no step's bound is tested
    else
      walk(w0, w1, st, L - (st << 5));
  }
  const int entry = s;  // the guessed state before this lane's first step
  __syncwarp();

  // Phase B: from lane 31's first stage back, the true path enters each
  // stage at a known state X. Where X is phase A's entry state of the
  // stage, the paths have met: the rest of that lane's stages are right,
  // and X becomes its entry state. Else the warp walks the stage's 32 steps
  // and stores their bits, the next stage in flight meanwhile.
  int X = __shfl_sync(kFull, entry, 31);
  int st = ((31 * n_stages) >> 5) - 1;  // every stage before lane 31's is whole
  uint32_t gl = 0u, wl0 = 0u, wl1 = 0u;
  auto load_stage = [&](int at) {
    gl = entered[at];
    wl0 = sv[(at * 2) * 32 + lane];
    wl1 = sv[(at * 2 + 1) * 32 + lane];
  };
  if (st >= 0) load_stage(st);
  while (st >= 0) {
    if ((int)gl == X) {
      const int g = ((32 * (st + 1) + n_stages - 1) / n_stages) - 1;  // the lane holding stage st
      X = __shfl_sync(kFull, entry, g);
      st = ((g * n_stages) >> 5) - 1;
      if (st >= 0) load_stage(st);
      continue;
    }
    const uint32_t c0 = wl0, c1 = wl1;
    if (st > 0) load_stage(st - 1);
    uint32_t mine = 0u;
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      const uint32_t a0 = __shfl_sync(kFull, c0, i), a1 = __shfl_sync(kFull, c1, i);
      mine = lane == i ? (uint32_t)(X & 1) : mine;
      const uint32_t w = (X & 1) ? a1 : a0;
      X = (X >> 1) | (int)(((w >> (X >> 1)) & 1u) << 5);
    }
    ob[(st << 5) + lane] = (uint8_t)mine;
    --st;
  }
}

}  // namespace

// pairs: (n_blocks, L, 2) float32; scratch: n_blocks * ceil(L / 32) * 65
// words (the survivors, then each stage's entry state); out: (n_blocks, L)
// uint8.
extern "C" int amr_fec_viterbi(const float* pairs, int known_boundaries, uint32_t* scratch, uint8_t* out,
                               int n_blocks, int L, cudaStream_t stream) {
  if (n_blocks <= 0 || L <= 0) return 0;
  fec_viterbi_kernel<<<n_blocks, 32, 0, stream>>>(reinterpret_cast<const float2*>(pairs), known_boundaries,
                                                  scratch, out, L);
  return (int)cudaGetLastError();
}
