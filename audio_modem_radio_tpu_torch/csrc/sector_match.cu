// K5: first validated frame-magic match for the 8 D8PSK pi/4-rotation
// hypotheses, on the Gray bit planes of received sectors.
//
// Replaces audio_modem_radio_tpu/ops/pallas_kernels.py sector_match_batch
// (body _sector_match_kernel, conditions psk8_match_conditions).
//
// What it computes. For capture b and every symbol position pos below
// n_pos = rows_scanned*128 - (n_sym + 1), the received sector x = sec[pos + j]
// of each window symbol j < n_sym (10 for the 32-bit magic + validation, as
// full tribits) gives the Gray planes g2 = b2, g1 = b2 ^ b1, g0 = b1 ^ b0 of
// its bits (b2, b1, b0). Hypothesis k (channel rotation k*pi/4) expects one
// value of each plane at each window symbol; the expectations inside the
// 16-bit magic must all hold and the other 14 may miss at most `tol`.
// first[b, k] receives the smallest such pos, or stays at 2^30. Positions at
// or past n_pos are never evaluated (the JAX epilogue rejects them), so every
// read stays inside the scanned prefix; a zero-padded tail cannot match the
// exact part, whose tribits hit 5 distinct sectors under any rotation.
//
// What bounds it on the H100: integer instruction rate, lightly. Each
// position reads one byte and does 8 hypotheses x 2 popcounts. The TPU
// version extracted the planes, built 10 lane-rolled views of each and
// evaluated 8 x 30 conditions one XOR at a time; here plane q of window
// symbol j is bit 3j + q of one 30-bit word, and each hypothesis collapses
// into two (mask, value) pairs, so it is `popc((w ^ v) & m)` twice.
//
// Design. The same shape as K2 (csrc/rotmatch.cu): a block owns 256
// consecutive positions of one capture, stages the Gray planes of the
// 256 + n_sym - 1 sectors it needs in shared memory (3 bits a byte), each
// thread packs its window word, scores the 8 hypotheses, and each warp takes
// the min over its lanes with __reduce_min_sync and does one atomicMin per
// hypothesis that matched; a min does not depend on the order of the atomics.
// Prefix tiers scan the first rows_scanned rows of each capture in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPosPerBlock = 256;
constexpr int kMaxSym = 10;  // 3 * 10 = 30 window bits
constexpr int kBig = 1 << 30;
constexpr int kMaxHyp = 8;

__global__ void fill_big(int* first, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) first[i] = kBig;
}

// masks: (n_hyp, 4) int32 = [exact_mask, exact_val, loose_mask, loose_val];
// bit 3j + q is Gray plane q (0: g2, 1: g1, 2: g0) of window symbol j.
__global__ void sector_match_kernel(const uint8_t* __restrict__ sec, const int* __restrict__ masks,
                                    int n_hyp, int n_sym, int tol, int* __restrict__ first,
                                    long long sym_per_capture, long long n_pos) {
  __shared__ uint8_t sg[kPosPerBlock + kMaxSym];
  __shared__ unsigned sm[kMaxHyp * 4];

  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kPosPerBlock;
  const uint8_t* sc = sec + (long long)b * sym_per_capture;
  for (int j = threadIdx.x; j < n_hyp * 4; j += blockDim.x) sm[j] = (unsigned)masks[j];
  for (int j = threadIdx.x; j < kPosPerBlock + n_sym - 1; j += blockDim.x) {
    const long long g = p0 + j;
    const unsigned x = g < n_pos + n_sym - 1 ? sc[g] : 0u;  // last window ends here
    const unsigned b2 = (x >> 2) & 1u, b1 = (x >> 1) & 1u, b0 = x & 1u;
    sg[j] = (uint8_t)(b2 | ((b2 ^ b1) << 1) | ((b1 ^ b0) << 2));
  }
  __syncthreads();

  const long long pos = p0 + threadIdx.x;
  unsigned w = 0;
  for (int j = 0; j < n_sym; ++j) w |= (unsigned)sg[threadIdx.x + j] << (3 * j);
  const bool valid = pos < n_pos;
  const int lane = threadIdx.x & 31;
  for (int h = 0; h < n_hyp; ++h) {
    const unsigned* m = sm + 4 * h;
    const int exact = __popc((w ^ m[1]) & m[0]);
    const int loose = __popc((w ^ m[3]) & m[2]);
    const int cand = (valid && exact == 0 && loose <= tol) ? (int)pos : kBig;
    const int wmin = __reduce_min_sync(0xffffffffu, cand);
    if (lane == 0 && wmin < kBig) atomicMin(first + (long long)b * n_hyp + h, wmin);
  }
}

}  // namespace

// sec: (n_captures, rows, 128) uint8 received sectors, contiguous. Scans the
// first rows_scanned rows of each capture: symbol positions
// [0, rows_scanned*128 - (n_sym + 1)). first: (n_captures, n_hyp) int32
// output, 2^30 where no position matched. Returns the cudaError_t of the
// launches.
extern "C" int amr_sector_match(const uint8_t* sec, const int* masks, int n_hyp, int tol,
                                int n_sym, int* first, int n_captures, int rows,
                                int rows_scanned, void* stream) {
  if (n_hyp < 1 || n_hyp > kMaxHyp || rows_scanned > rows || n_sym < 1 || n_sym > kMaxSym)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = n_captures * n_hyp;
  fill_big<<<(n_out + 255) / 256, 256, 0, st>>>(first, n_out);
  const long long n_pos = (long long)rows_scanned * 128 - (n_sym + 1);
  if (n_pos > 0) {
    dim3 grid((unsigned)((n_pos + kPosPerBlock - 1) / kPosPerBlock), (unsigned)n_captures);
    sector_match_kernel<<<grid, kPosPerBlock, 0, st>>>(sec, masks, n_hyp, n_sym, tol, first,
                                                       (long long)rows * 128, n_pos);
  }
  return (int)cudaGetLastError();
}
