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
// * the metrics start at 0 for every state, or with `known_start` at 0 for
//   state 0 and 1e9 for the others; the traceback starts at state 0, or with
//   `from_best_end` at the first state holding the final minimum, and writes
//   each step's input bit (the state's low bit).
// Every sum and difference is rounded on its own (__fadd_rn, __fsub_rn), in
// the plain version's order; there is no product, so nothing could fuse into
// an FMA anyway. The bits equal the plain version's bit for bit.
//
// What bounds it on the H100: neither bytes nor operations. A stream-FEC
// decode of one 2^24-sample QPSK@9600 capture is 205 blocks of 9,216 steps:
// 15 MB of pairs in, 1.9 MB of bits out and about 0.8e9 operations, some
// 0.01 ms at the card's peaks. The floor is the chain of 9,216 dependent
// steps a block: each step needs every state's metric from the step before,
// and their minimum. The 205 blocks run one warp each, at most two on an SM,
// so the kernel's time is one warp's chain plus its traceback.
//
// Design (simple first; a later redesign can take mlse_viterbi.cu's): one
// warp a block, one block a CUDA block of 32 threads. Lane l holds the
// metrics of states l and l + 32, exactly the two predecessors of the new
// states 2l and 2l + 1, so both candidates of both new states are local to
// the lane. A step t:
//   1. the lane's four branch metrics (two new states x two predecessors)
//      from the step's pair, read from shared memory (one broadcast LDS.64);
//   2. the candidates, the strict compare and the select for new states 2l
//      and 2l + 1;
//   3. the step minimum: fminf over the lane's two, then one REDUX
//      (__reduce_min_sync) on the raw bits as int32, and the subtraction;
//   4. two __ballot_sync give the 64 decisions (word 0: the even states 2l
//      at bit l, word 1: the odd states 2l + 1 at bit l), which lane t mod 32
//      keeps; every 32 steps each lane stores its two words, one coalesced
//      store a word (survivors laid out [t / 32][word][t mod 32]);
//   5. the exchange back to the layout of step 1: each lane stores its two
//      new metrics with one STS.64 (two buffers by step parity, one
//      __syncwarp) and loads states l and l + 32.
// The pairs of the next 32 steps are loaded into a register at the start of
// each stage and stored to shared memory at its end.
//
// Why the REDUX gives the float minimum: every metric is a non-negative,
// non-NaN float. The candidates are sums of a metric (>= +0) and a branch
// metric (a sum of two absolute values, >= +0), so none is -0; after the
// subtraction every metric is x - mn >= +0 (x - x is +0 in round to
// nearest). The bits of non-negative floats, read as int32, are
// non-negative ints ordered as the floats are, so the signed int minimum is
// the bits of the float minimum. (Inputs must be finite: an infinite or NaN
// pair would make NaN metrics, for which no order holds.)
//
// Traceback: from the end state, stage by stage from the last: each lane
// loads the two survivor words of its step of the stage (the next stage's
// loaded meanwhile); for each of the stage's steps, last first, every lane
// selects its word by the (uniform) state's low bit, one __shfl_sync
// broadcasts step i's word, and the survivor bit of the state picks its
// predecessor; lane i keeps step i's output bit, and the stage's bits go out
// as one coalesced 32-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kG1 = 0171, kG2 = 0133;  // octal, as in fec.py

__device__ __forceinline__ float parity7(uint32_t x) { return (float)(__popc(x & 0x7Fu) & 1); }

// |r0 - e0| + |r1 - e1|, rounded as the plain version rounds it.
__device__ __forceinline__ float branch(float r0, float r1, float e0, float e1) {
  return __fadd_rn(fabsf(__fsub_rn(r0, e0)), fabsf(__fsub_rn(r1, e1)));
}

__global__ void __launch_bounds__(32)
    fec_viterbi_kernel(const float2* __restrict__ pairs, int known_start, int from_best_end,
                       uint32_t* __restrict__ scratch, uint8_t* __restrict__ out, int L) {
  __shared__ float2 ps[64];                       // two stages of pairs, a ring
  __shared__ __align__(16) float xch[2][64];      // the exchange, two buffers by step parity

  const int lane = threadIdx.x;
  const int n_stages = (L + 31) >> 5;
  const float2* pb = pairs + (size_t)blockIdx.x * L;
  uint32_t* sv = scratch + (size_t)blockIdx.x * n_stages * 64;

  // Expected outputs of the lane's four transitions: new state 2l + b from
  // p0 = l (ea*) and from p1 = l + 32 (eb*).
  float ea0[2], ea1[2], eb0[2], eb1[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint32_t reg0 = ((uint32_t)lane << 1) | b, reg1 = ((uint32_t)(lane | 32) << 1) | b;
    ea0[b] = parity7(reg0 & kG1);
    ea1[b] = parity7(reg0 & kG2);
    eb0[b] = parity7(reg1 & kG1);
    eb1[b] = parity7(reg1 & kG2);
  }
  // Metrics of states l (pa) and l + 32 (pc).
  float pa = known_start ? (lane == 0 ? 0.0f : 1e9f) : 0.0f;
  float pc = known_start ? 1e9f : 0.0f;
  uint32_t k0 = 0u, k1 = 0u;  // the survivor words of step 32 st + lane

  auto step = [&](int t, float2 r) {
    float nv[2];
    bool ch[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float c0 = __fadd_rn(pa, branch(r.x, r.y, ea0[b], ea1[b]));
      const float c1 = __fadd_rn(pc, branch(r.x, r.y, eb0[b], eb1[b]));
      ch[b] = c1 < c0;
      nv[b] = ch[b] ? c1 : c0;
    }
    const float mn = __int_as_float(__reduce_min_sync(kFull, __float_as_int(fminf(nv[0], nv[1]))));
    const uint32_t w0 = __ballot_sync(kFull, ch[0]), w1 = __ballot_sync(kFull, ch[1]);
    const bool keep = lane == (t & 31);
    k0 = keep ? w0 : k0;
    k1 = keep ? w1 : k1;
    float* buf = xch[t & 1];
    *reinterpret_cast<float2*>(buf + 2 * lane) = make_float2(__fsub_rn(nv[0], mn), __fsub_rn(nv[1], mn));
    __syncwarp();
    pa = buf[lane];
    pc = buf[lane + 32];
  };

  const float2 zero = make_float2(0.0f, 0.0f);
  ps[lane] = lane < L ? pb[lane] : zero;
  __syncwarp();
  for (int st = 0; st < n_stages; ++st) {
    const int t0 = st << 5;
    const float2* pr = ps + ((st & 1) << 5);
    const float2 nx = t0 + 32 + lane < L ? pb[t0 + 32 + lane] : zero;
    if (t0 + 32 <= L) {
#pragma unroll
      for (int i = 0; i < 32; ++i) step(t0 + i, pr[i]);
    } else {
      for (int i = 0; i < L - t0; ++i) step(t0 + i, pr[i]);
    }
    sv[(st * 2) * 32 + lane] = k0;
    sv[(st * 2 + 1) * 32 + lane] = k1;
    ps[(((st + 1) & 1) << 5) + lane] = nx;  // that buffer's readers were stage st - 1's steps
    __syncwarp();
  }

  int s = 0;
  if (from_best_end) {
    const float mn = __int_as_float(__reduce_min_sync(kFull, __float_as_int(fminf(pa, pc))));
    const int f = pa == mn ? lane : (pc == mn ? lane + 32 : 0x7FFFFFFF);
    s = __reduce_min_sync(kFull, f);
  }

  __syncwarp();  // every lane's survivor words stored before any lane reads a stage
  uint8_t* ob = out + (size_t)blockIdx.x * L;
  int st = n_stages - 1;
  uint32_t w0 = sv[(st * 2) * 32 + lane], w1 = sv[(st * 2 + 1) * 32 + lane];
  // Step i of the stage whose words are c0, c1: lane i keeps the bit.
  auto back = [&](int i, uint32_t c0, uint32_t c1, uint32_t& mine) {
    const uint32_t word = __shfl_sync(kFull, (s & 1) ? c1 : c0, i);
    mine = lane == i ? (uint32_t)(s & 1) : mine;
    s = (word >> (s >> 1)) & 1u ? ((s >> 1) | 32) : (s >> 1);
  };
  for (; st >= 0; --st) {
    const uint32_t c0 = w0, c1 = w1;
    if (st > 0) {
      w0 = sv[((st - 1) * 2) * 32 + lane];
      w1 = sv[((st - 1) * 2 + 1) * 32 + lane];
    }
    const int n = L - (st << 5) < 32 ? L - (st << 5) : 32;
    uint32_t mine = 0u;
    if (n == 32) {
#pragma unroll
      for (int i = 31; i >= 0; --i) back(i, c0, c1, mine);
    } else {
      for (int i = n - 1; i >= 0; --i) back(i, c0, c1, mine);
    }
    if (lane < n) ob[(st << 5) + lane] = (uint8_t)mine;
  }
}

}  // namespace

// pairs: (n_blocks, L, 2) float32; scratch: n_blocks * ceil(L / 32) * 64
// words; out: (n_blocks, L) uint8.
extern "C" int amr_fec_viterbi(const float* pairs, int known_start, int from_best_end, uint32_t* scratch,
                               uint8_t* out, int n_blocks, int L, cudaStream_t stream) {
  if (n_blocks <= 0 || L <= 0) return 0;
  fec_viterbi_kernel<<<n_blocks, 32, 0, stream>>>(reinterpret_cast<const float2*>(pairs), known_start,
                                                  from_best_end, scratch, out, L);
  return (int)cudaGetLastError();
}
