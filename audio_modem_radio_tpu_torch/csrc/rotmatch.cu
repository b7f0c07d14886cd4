// K2: first validated frame-magic match for the 8 DQPSK rotation x parity
// hypotheses, or the 4 DBPSK stream x inversion hypotheses.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py rotation_match_batch
// (body _rotmatch_kernel, family "qpsk" with rotation_match_conditions and
// family "bpsk" with bpsk_match_conditions).
//
// What it computes. For capture b and every position pos below
// n_pos = rows_scanned*128 - (n_pat + 1) (dibits for "qpsk", bits for
// "bpsk"), each hypothesis h holds a set of conditions
// "(hi or lo)[pos + off] == bit", off in 0..span-1: 0..16 for "qpsk" (two
// streams, 16 dibits plus the odd parity's one), 0..31 for "bpsk" (one
// stream, 32 bits). The first 16 conditions (the 16-bit magic) must all hold
// and the next 16 (the validating follow-up) may miss at most `tol`. first[b, h] receives the smallest such pos, or stays at
// 2^30. Positions at or past n_pos are never evaluated: the JAX epilogue
// rejects them, so skipping them gives the same (first, found) and keeps every
// read inside the scanned prefix of the capture.
//
// What bounds it on the H100: integer issue, lightly. Each position reads
// 2 B of input and does 8 hypotheses x 4 popcounts. The TPU version built 9
// lane-rolled copies of each stream per tile and evaluated 256 conditions one
// XOR at a time; here each condition set collapses into two (mask, value)
// pairs per part, so a hypothesis is `popc((w ^ v) & m)` over a window of at
// most 32 bits.
//
// Design. A block owns 256 consecutive positions of one capture and stages
// the 256 + span - 1 hi/lo bytes it needs in shared memory. Each thread packs
// its span-bit hi and lo windows, scores the hypotheses, and each warp takes the
// min over its lanes with __reduce_min_sync; a warp that found a match does
// one atomicMin per hypothesis. A min does not depend on the order of the
// atomics, so the result is deterministic. Prefix tiers scan the first
// rows_scanned rows of each capture in place, using the full capture stride.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPosPerBlock = 256;
constexpr int kMaxSpan = 32;  // window offsets 0..31: one 32-bit word
constexpr int kBig = 1 << 30;
constexpr int kMaxHyp = 8;

__global__ void fill_big(int* first, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) first[i] = kBig;
}

// masks: (n_hyp, 8) uint32 = [hi_mask, hi_val, lo_mask, lo_val] for the exact
// part, then the same four for the tolerant part; bit j of a mask/value is the
// condition at window offset j.
__global__ void rotmatch_kernel(const uint8_t* __restrict__ hi, const uint8_t* __restrict__ lo,
                                const unsigned* __restrict__ masks, int n_hyp, int span, int tol,
                                int* __restrict__ first, long long dib_per_capture,
                                long long n_pos) {
  __shared__ uint8_t sh[kPosPerBlock + kMaxSpan];
  __shared__ uint8_t sl[kPosPerBlock + kMaxSpan];
  __shared__ unsigned sm[kMaxHyp * 8];

  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kPosPerBlock;
  const uint8_t* hc = hi + (long long)b * dib_per_capture;
  const uint8_t* lc = lo + (long long)b * dib_per_capture;
  for (int j = threadIdx.x; j < n_hyp * 8; j += blockDim.x) sm[j] = masks[j];
  for (int j = threadIdx.x; j < kPosPerBlock + span - 1; j += blockDim.x) {
    const long long g = p0 + j;
    const bool in = g < n_pos + span - 1;  // last window of the prefix ends here
    sh[j] = in ? hc[g] : 0;
    sl[j] = in ? lc[g] : 0;
  }
  __syncthreads();

  const long long pos = p0 + threadIdx.x;
  unsigned hw = 0, lw = 0;
  for (int j = 0; j < span; ++j) {
    hw |= (unsigned)(sh[threadIdx.x + j] & 1) << j;
    lw |= (unsigned)(sl[threadIdx.x + j] & 1) << j;
  }
  const bool valid = pos < n_pos;
  const int lane = threadIdx.x & 31;
  for (int h = 0; h < n_hyp; ++h) {
    const unsigned* m = sm + 8 * h;
    const int exact = __popc((hw ^ m[1]) & m[0]) + __popc((lw ^ m[3]) & m[2]);
    const int loose = __popc((hw ^ m[5]) & m[4]) + __popc((lw ^ m[7]) & m[6]);
    const int cand = (valid && exact == 0 && loose <= tol) ? (int)pos : kBig;
    const int wmin = __reduce_min_sync(0xffffffffu, cand);
    if (lane == 0 && wmin < kBig) atomicMin(first + (long long)b * n_hyp + h, wmin);
  }
}

}  // namespace

// hi/lo: (n_captures, rows, 128) uint8 decision lanes, contiguous. Scans the
// first rows_scanned rows of each capture: positions [0, rows_scanned*128 -
// (n_pat + 1)), each reading the window [pos, pos + span); span <= n_pat + 1
// keeps every read inside the scanned prefix. first: (n_captures, n_hyp)
// int32 output, 2^30 where no position matched. Returns the cudaError_t of
// the launches.
extern "C" int amr_rotation_match(const uint8_t* hi, const uint8_t* lo, const unsigned* masks,
                                  int n_hyp, int span, int tol, int n_pat, int* first,
                                  int n_captures, int rows, int rows_scanned, void* stream) {
  if (n_hyp < 1 || n_hyp > kMaxHyp || rows_scanned > rows || span < 1 || span > kMaxSpan ||
      span > n_pat + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = n_captures * n_hyp;
  fill_big<<<(n_out + 255) / 256, 256, 0, st>>>(first, n_out);
  const long long n_pos = (long long)rows_scanned * 128 - (n_pat + 1);
  if (n_pos > 0) {
    dim3 grid((unsigned)((n_pos + kPosPerBlock - 1) / kPosPerBlock), (unsigned)n_captures);
    rotmatch_kernel<<<grid, kPosPerBlock, 0, st>>>(hi, lo, masks, n_hyp, span, tol, first,
                                                   (long long)rows * 128, n_pos);
  }
  return (int)cudaGetLastError();
}
