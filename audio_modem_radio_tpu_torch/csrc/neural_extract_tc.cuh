// K10 with bf16 operands on the tensor cores: NEURAL chip extraction +
// unrotation + codebook scores + argmax, included by neural_extract.cu,
// whose C entry amr_neural_extract launches it for bf16 = 1.
//
// Replaces the bf16=True branch of audio_modem_radio_tpu/ops/pallas_kernels.py
// _kernel_neural_extract (its bf16 operands :979-998, scores :1000-1002,
// the count gate :1004-1028, the first maximum :1029-1036; called from
// neural_extract_batch, pallas_call :1151). The JAX kernel has the switch
// only for speed: bf16 doubles the matrix unit's rate on its TPU.
//
// What it computes, as neural_extract.cu's float32 kernel but in bf16:
// the samples are rounded to bfloat16 (to nearest even) before the chip
// means, and the unrotated chips and the codebook before the scores; the
// unrotation is float32, the 16 products of a score are exact and their
// sum is the tensor core's float32 sum. The output is the first maximum
// (argmax "loop": the lowest index of the largest score) or the count gate
// ("dot": that index where one codeword alone holds the maximum, 0 where
// several do). The tensor cores add the 16 products in their own order and
// alignment, not the plain version's float32 order, so a symbol may differ
// from the plain version's where the exact scores of two codewords lie
// within rounding of each other (ops/kernels.py neural_bf16_mismatches
// holds the kernel to that).
//
// Floors at the bench batch (64 x 2^24 float32 samples, 2^26 symbols;
// published H100 SXM peaks): bytes, 4.29 GB read once, 1.30 ms at 3.35
// TB/s; the tensor cores' 2^26 x 256 x 16 multiply-adds, 0.56 ms at 989
// TFLOP/s; the CUDA cores, 2 instructions a score in the epilogue below
// and 152 a symbol for its chips, 2^26 x 664 instructions, 1.33 ms at
// 33.5e12 a second (132 SMs x 128 lanes at 1.98 GHz: half the 67 TFLOP/s
// float32 rate, which counts an FFMA as two). The CUDA cores bind, by a
// hair over the bytes. Compares, maxima, selects and integer work issue on
// the ALU pipe, 16 lanes a cycle per scheduler, half the FMA pipe's 32; the
// design moves what it can off that pipe.
//
// Design. One warp scores 16 symbols at a time (a tile: rows 2q and 2q+1
// of a capture) as one m16n8k16 product per 8 codewords, mma.sync with
// bf16 operands and float32 sums:
// - mma.sync, not wgmma: wgmma's m64 tiles need 64 symbols a warpgroup and
//   B in shared memory; its 128 accumulator registers a thread leave no
//   room for the argmax. The tensor cores' floor is under half the CUDA
//   cores', so their lower mma.sync rate costs little here (16 more
//   products a tile changed the time by under 2%).
// - The codebook is B, staged once per thread in registers as the
//   m16n8k16 B fragments: codewords 8j+g, chips 2t, 2t+1 and 8+2t, 9+2t of
//   lane (g, t) = (lane / 4, lane % 4), 64 registers.
// - The chips go straight into the A fragment: lane (g, t) holds, for
//   symbols 16q+g and 16q+8+g, re chips 2t, 2t+1 and im chips 2t, 2t+1,
//   which are the means of its own 4 samples at 256q + s + 4 * lane (+128
//   for the second symbol), mod the capture's length (the last row's
//   successor is row 0). So a warp's loads are 128 consecutive samples a
//   row, and no chip passes through shared memory. The masks depend on s
//   mod 4 only (a constant-bank table). The warp's next tile's samples
//   are loaded, as stored, while it scores this one; they are converted
//   only when used, so the loads stay in flight. Reading every tile from
//   the cache instead of the card's memory saved 3%, and staging a block's
//   rows through shared memory with cp.async (4 stages) cost 17%: the
//   bytes do not bind.
// - The argmax is the epilogue, with the tensor cores' help: the 32
//   products leave 64 scores of each of the lane's two symbols in 128
//   registers. Their maximum is the integer maximum of their bits, two
//   scores an instruction (DPX VIMNMX3), then two __shfl_xor_sync across
//   the quad; that is the float maximum wherever it is not negative, and
//   warps where it is take FMNMX instead. Then the one-hot of "score ==
//   maximum" as bf16 (1.0 or 0, exact; onehot2: two FFMAs, a pack and a
//   packed compare a pair) times a (256 x 8) bf16 matrix whose column 0
//   holds the codeword index and column 1 ones: 16 m16n8k16 products give
//   lane (g, 0) each symbol's count of maxima and the sum of their
//   indices, both exact in float32. That is the JAX kernel's own count
//   gate (one-hot index dots); selects of the first index and a count in
//   its place were 11% slower, FMNMX and FSET in place of the integer
//   maximum and the FFMAs 11%. Where the count is 1 the sum is the index;
//   the count gate gives 0 otherwise; the first maximum takes, in warps
//   where some symbol has several maxima (exact ties: duplicate codewords,
//   all-zero rows), the lowest index among them by selects over the scores
//   computed again (so that the 128 scores die in the one-hot: holding them
//   for the rare tie cost 60%). No branch depends on a score but those two
//   warp-uniform ones.
// - Registers: 128 scores + 64 codebook + 8 prefetched samples + 8 index
//   sums, 234-248 a thread, two blocks of 4 warps an SM; as many
//   persistent blocks as fit each SM walk the tiles. Fewer registers and
//   more warps (the scores computed twice, the codebook in shared memory)
//   were no faster.
// (The percentages: kernel_variants.py --bf16 on the bench batch, against
// variant sources, NVIDIA H100 80GB HBM3, 700.00 W.)
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (kernel_variants.py
// --bf16 [--argmax dot] on the bench batch, against the earlier CUDA-core
// bf16 kernel, built from the parent source, in the same call): the count
// gate 5.03-5.13 ms through the wrapper, 4.80 ms alone, beside 15.63-16.27
// (alone 15.74-15.94); the first maximum 4.92-4.97 beside 14.25-14.57;
// every symbol equal to the CUDA-core kernel's. The kernel alone is at 28% of its 1.33 ms floor, the
// card at up to 689 W of its 700: the ALU pipe and the scheduling of two
// warps a scheduler hold it, not the bytes or the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace neural_tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNTiles = 32;  // 256 codewords in n8 tiles
constexpr int kSlices = 16;  // 256 codewords in k16 slices of the index product
constexpr unsigned kFull = 0xffffffffu;

// The fs/4 downconversion's sign masks by lane mod 4, twice over, read at
// a warp-uniform index (s mod 4 + 0..3): a constant-bank load in place of
// the compares and selects that would compute them.
__constant__ float kMaskRe[8] = {1.f, 0.f, -1.f, 0.f, 1.f, 0.f, -1.f, 0.f};
__constant__ float kMaskIm[8] = {0.f, -1.f, 0.f, 1.f, 0.f, -1.f, 0.f, 1.f};

// (lo, hi) rounded to bfloat16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// d = A (16 x 16, row) . B (16 x 8, col) + c, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// Sample p of capture xc (n samples; p < 2n wraps to p - n).
template <typename T>
__device__ __forceinline__ T sample(const T* __restrict__ xc, long long p, long long n) {
  return xc[p >= n ? p - n : p];
}

// The lane's 8 samples of tile (b, q), as stored: 4 at 256q + s + 4 * lane
// for symbol 16q + g, 4 at 128 further for symbol 16q + 8 + g (zeros where
// row 2q + 1 is past the capture's last row). Nothing here uses them, so
// the loads stay in flight until the next tile converts them.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, const int* __restrict__ s_off, int b, int q,
                                          int rows, int lane, int& s, T (&v)[8]) {
  const long long n = (long long)rows * 128;
  s = s_off[b] & 127;
  const T* xc = x + (long long)b * n;
  const long long base = 256LL * q + s + 4 * lane;
  const bool second = 2 * q + 1 < rows;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = sample(xc, base + k, n);
    v[4 + k] = second ? sample(xc, base + 128 + k, n) : T(0);
  }
}

// Chips 2t and 2t+1 (re and im) of one symbol from its 4 samples at lanes
// l..l+3 of the row pair (l = s mod 4 here: the masks repeat every 4
// lanes), rounded to bfloat16, unrotated by (a, c), packed as A fragments:
// re in *re, im in *im. The same rounded products and sums as the plain
// version.
template <typename T>
__device__ __forceinline__ void chips(const T* v, int l, float a, float c, uint32_t* re, uint32_t* im) {
  float ur[2], ui[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float x0 = bf16_round(static_cast<float>(v[2 * h]));
    const float x1 = bf16_round(static_cast<float>(v[2 * h + 1]));
    const int m = l + 2 * h;
    const float cr = __fmul_rn(__fadd_rn(__fmul_rn(x0, kMaskRe[m]), __fmul_rn(x1, kMaskRe[m + 1])), 0.5f);
    const float ci = __fmul_rn(__fadd_rn(__fmul_rn(x0, kMaskIm[m]), __fmul_rn(x1, kMaskIm[m + 1])), 0.5f);
    ur[h] = __fadd_rn(__fmul_rn(cr, a), __fmul_rn(ci, c));
    ui[h] = __fsub_rn(__fmul_rn(ci, a), __fmul_rn(cr, c));
  }
  *re = pack_bf16(ur[0], ur[1]);
  *im = pack_bf16(ui[0], ui[1]);
}

constexpr float kScale = 0x1p40f;  // see onehot2

// The one-hot of two scores x, y against the maximum, given as m_scaled =
// maximum * 2^40, as a bf16 pair (1.0 where a score equals the maximum, 0
// elsewhere). x * 2^40 - m_scaled is exact before its one rounding, so it
// is zero exactly where x equals the maximum and otherwise at least
// 2^-109 in magnitude, a normal bf16; for scores below 2^88 in magnitude
// nothing overflows. Two FFMAs on the FMA pipe, a pack and one packed
// compare with zero, in place of two FSETs on the ALU pipe and a pack.
__device__ __forceinline__ uint32_t onehot2(float x, float y, float m_scaled) {
  const __nv_bfloat162 d = __floats2bfloat162_rn(fmaf(x, kScale, -m_scaled), fmaf(y, kScale, -m_scaled));
  const __nv_bfloat162 e = __heq2(d, __float2bfloat162_rn(0.f));
  uint32_t u;
  memcpy(&u, &e, sizeof(u));
  return u;
}

template <typename T, bool kCountMax>
__global__ void __launch_bounds__(kThreads, 1)
    neural_extract_tc_kernel(const T* __restrict__ x, const float* __restrict__ codebook,
                             const float* __restrict__ phasors, const int* __restrict__ s_off,
                             uint8_t* __restrict__ out, int rows, int n_captures, int tiles_per_capture) {
  // B of the index product, slice kk: column 0 the codeword index, column 1
  // ones, the rest zeros, as lane (g, t)'s two registers.
  __shared__ uint2 index_b[kSlices][32];
  for (int i = threadIdx.x; i < kSlices * 32; i += kThreads) {
    const int kk = i / 32, g = (i % 32) / 4, t = i % 4;
    const float w = (float)(16 * kk + 2 * t);
    uint2 v = make_uint2(0u, 0u);
    if (g == 0) v = make_uint2(pack_bf16(w, w + 1.f), pack_bf16(w + 8.f, w + 9.f));
    if (g == 1) v = make_uint2(pack_bf16(1.f, 1.f), pack_bf16(1.f, 1.f));
    index_b[kk][i % 32] = v;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // The codebook as B fragments: codeword 8j+g, chips 2t, 2t+1 | 8+2t, 9+2t.
  uint32_t cb[kNTiles][2];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const float* w = codebook + (8 * j + g) * 16;
    cb[j][0] = pack_bf16(w[2 * t], w[2 * t + 1]);
    cb[j][1] = pack_bf16(w[2 * t + 8], w[2 * t + 9]);
  }
  __syncthreads();

  const long long n_sym = (long long)rows * 8;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  const int db = stride / tiles_per_capture, dq = stride % tiles_per_capture;
  int b = warp / tiles_per_capture, q = warp % tiles_per_capture;
  int s = 0;
  T v[8] = {};
  if (b < n_captures) load_tile(x, s_off, b, q, rows, lane, s, v);
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  while (b < n_captures) {
    int nb = b + db, nq = q + dq;
    if (nq >= tiles_per_capture) {
      nq -= tiles_per_capture;
      ++nb;
    }
    int ns = 0;
    T nv[8] = {};
    if (nb < n_captures) load_tile(x, s_off, nb, nq, rows, lane, ns, nv);

    const float a = phasors[2 * b], c = phasors[2 * b + 1];
    uint32_t a0, a1, a2, a3;  // A: re of symbols g, g+8, then im of g, g+8
    chips(v, s & 3, a, c, &a0, &a2);
    chips(v + 4, s & 3, a, c, &a1, &a3);
    float sc[kNTiles][4];  // codewords 8j+2t, 8j+2t+1 of symbol g, then of g+8
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) mma(sc[j], a0, a1, a2, a3, cb[j][0], cb[j][1], zero);

    // The maximum as the signed-integer maximum of the scores' bits, two
    // scores an instruction (Hopper's DPX VIMNMX3): the float maximum
    // wherever it is not negative, as the bits of every negative score are
    // negative integers. Where some symbol's maximum is negative, the float
    // maximum instead.
    int ig = INT_MIN, ih = INT_MIN;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      ig = __vimax3_s32(ig, __float_as_int(sc[j][0]), __float_as_int(sc[j][1]));
      ih = __vimax3_s32(ih, __float_as_int(sc[j][2]), __float_as_int(sc[j][3]));
    }
    ig = max(ig, __shfl_xor_sync(kFull, ig, 1));
    ih = max(ih, __shfl_xor_sync(kFull, ih, 1));
    ig = max(ig, __shfl_xor_sync(kFull, ig, 2));
    ih = max(ih, __shfl_xor_sync(kFull, ih, 2));
    float mg = __int_as_float(ig), mh = __int_as_float(ih);
    if (__any_sync(kFull, (ig | ih) < 0)) {
      float mg0 = sc[0][0], mg1 = sc[0][1], mh0 = sc[0][2], mh1 = sc[0][3];
#pragma unroll
      for (int j = 1; j < kNTiles; ++j) {
        mg0 = fmaxf(mg0, sc[j][0]);
        mg1 = fmaxf(mg1, sc[j][1]);
        mh0 = fmaxf(mh0, sc[j][2]);
        mh1 = fmaxf(mh1, sc[j][3]);
      }
      mg = fmaxf(mg0, mg1);
      mh = fmaxf(mh0, mh1);
      mg = fmaxf(mg, __shfl_xor_sync(kFull, mg, 1));
      mh = fmaxf(mh, __shfl_xor_sync(kFull, mh, 1));
      mg = fmaxf(mg, __shfl_xor_sync(kFull, mg, 2));
      mh = fmaxf(mh, __shfl_xor_sync(kFull, mh, 2));
    }

    // One-hot of the maxima times [index | 1]: two accumulators, so that
    // the 16 products form two chains.
    const float mg_scaled = mg * kScale, mh_scaled = mh * kScale;
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSlices; ++kk) {
      const float* lo = sc[2 * kk];
      const float* hi = sc[2 * kk + 1];
      const uint32_t e0 = onehot2(lo[0], lo[1], mg_scaled);
      const uint32_t e1 = onehot2(lo[2], lo[3], mh_scaled);
      const uint32_t e2 = onehot2(hi[0], hi[1], mg_scaled);
      const uint32_t e3 = onehot2(hi[2], hi[3], mh_scaled);
      const uint2 ib = index_b[kk][lane];
      if (kk & 1)
        mma(d1, e0, e1, e2, e3, ib.x, ib.y, d1);
      else
        mma(d0, e0, e1, e2, e3, ib.x, ib.y, d0);
    }
    // Lane (g, 0): symbol g's index sum and count, then symbol g+8's.
    const float count_g = d0[1] + d1[1], count_h = d0[3] + d1[3];
    int sym_g = (int)(d0[0] + d1[0]), sym_h = (int)(d0[2] + d1[2]);
    if (kCountMax) {
      sym_g = count_g == 1.f ? sym_g : 0;
      sym_h = count_h == 1.f ? sym_h : 0;
    } else if (__any_sync(kFull, t == 0 && (count_g != 1.f || count_h != 1.f))) {
      // Several maxima: the lowest index among them, by selects over the
      // scores computed again (so that the 128 scores die in the one-hot).
      int first_g = 256, first_h = 256;
#pragma unroll
      for (int j = kNTiles - 1; j >= 0; --j) {
        float r[4];
        mma(r, a0, a1, a2, a3, cb[j][0], cb[j][1], zero);
        first_g = r[1] == mg ? 8 * j + 2 * t + 1 : first_g;
        first_g = r[0] == mg ? 8 * j + 2 * t : first_g;
        first_h = r[3] == mh ? 8 * j + 2 * t + 1 : first_h;
        first_h = r[2] == mh ? 8 * j + 2 * t : first_h;
      }
      first_g = min(first_g, __shfl_xor_sync(kFull, first_g, 1));
      first_h = min(first_h, __shfl_xor_sync(kFull, first_h, 1));
      first_g = min(first_g, __shfl_xor_sync(kFull, first_g, 2));
      first_h = min(first_h, __shfl_xor_sync(kFull, first_h, 2));
      sym_g = count_g == 1.f ? sym_g : first_g;
      sym_h = count_h == 1.f ? sym_h : first_h;
    }
    if (t == 0) {
      uint8_t* o = out + (long long)b * n_sym + 16LL * q + g;
      o[0] = static_cast<uint8_t>(sym_g);
      if (2 * q + 1 < rows) o[8] = static_cast<uint8_t>(sym_h);
    }

    b = nb;
    q = nq;
    s = ns;
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = nv[k];
  }
}

template <typename T, bool kCountMax>
int launch(const void* x, const float* codebook, const float* phasors, const int* s, uint8_t* out, int n_captures,
           int rows, cudaStream_t stream) {
  const long long tiles_per_capture = ((long long)rows + 1) / 2;
  const long long n_tiles = (long long)n_captures * tiles_per_capture;
  if (n_tiles > INT_MAX / 2) return (int)cudaErrorInvalidValue;  // tile indices and their steps stay ints
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, neural_extract_tc_kernel<T, kCountMax>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  neural_extract_tc_kernel<T, kCountMax><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), codebook, phasors, s, out, rows, n_captures, (int)tiles_per_capture);
  return (int)cudaGetLastError();
}

}  // namespace neural_tc
