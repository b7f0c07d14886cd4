// Dependent-issue latency of single SASS instructions on the card, for
// sass_stats.py's chain bounds. Not part of the kernel library (_build.py
// compiles csrc/*.cu only): sass_stats.py builds it alone.
//
// One warp runs trips of 32 copies of one PTX instruction (or of a pair,
// where one alone would fold: SHF -> LOP3, VIADD -> LOP3, ISETP -> SEL),
// each taking the previous one's result, between two clock64() reads. The
// caller divides the cycles a trip by the number of instructions of that
// opcode the probe's own SASS holds in the loop (ptxas may merge copies)
// and subtracts the other opcode's latency from a pair's.

#include <cuda_runtime.h>
#include <stdint.h>

#define REP4(s) s s s s
#define REP32(s) REP4(REP4(s) REP4(s))

template <int kOp>
__global__ void latency_kernel(int trips, float f, float g, int m, long long* cycles, int* sink) {
  __shared__ uint32_t ring[32];
  const int lane = threadIdx.x;
  float x = f + (float)lane;
  int k = m + lane;
  ring[lane] = (uint32_t)__cvta_generic_to_shared(&ring[(lane + 1) & 31]);
  uint32_t addr = ring[lane];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < trips; ++i) {
    switch (kOp) {
      case 0:  // FADD
        asm volatile(REP32("add.rn.f32 %0, %0, %1;\n") : "+f"(x) : "f"(f));
        break;
      case 1:  // FMNMX
        asm volatile(REP32("max.f32 %0, %0, %1;\nmax.f32 %0, %0, %2;\n") : "+f"(x) : "f"(f), "f"(g));
        break;
      case 2:  // SHF
        asm volatile(REP32("shr.s32 %0, %0, %1;\n") : "+r"(k) : "r"(m & 1));
        break;
      case 3:  // SHF -> LOP3: the float key of mlse_viterbi.cu
        asm volatile(
            "{\n.reg .b32 t;\n"
            REP32("shr.s32 t, %0, 31;\nand.b32 t, t, 0x7fffffff;\nxor.b32 %0, %0, t;\n") "}\n"
            : "+r"(k));
        break;
      case 4:  // SEL
        asm volatile(
            "{\n.reg .pred p, q;\nsetp.ne.s32 p, %1, 0;\nsetp.eq.s32 q, %1, 0;\n"
            REP32("selp.b32 %0, %0, %1, p;\nselp.b32 %0, %1, %0, q;\n") "}\n"
            : "+r"(k) : "r"(m));
        break;
      case 5:  // REDUX, its result moved back to a vector register
        asm volatile(REP32("redux.sync.max.s32 %0, %0, 0xffffffff;\n") : "+r"(k));
        break;
      case 6:  // SHFL
        asm volatile(REP32("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;\n") : "+r"(k) : "r"(lane ^ 1));
        break;
      case 7:  // LDS
        asm volatile(REP32("ld.shared.u32 %0, [%0];\n") : "+r"(addr));
        break;
      case 8:  // VIADD -> LOP3
        asm volatile(REP32("add.s32 %0, %0, %1;\nxor.b32 %0, %0, %2;\n") : "+r"(k) : "r"(m), "r"(m + 7));
        break;
      case 9:  // ISETP -> SEL through a predicate
        asm volatile(
            "{\n.reg .pred p;\n"
            REP32("setp.gt.s32 p, %0, %1;\nselp.b32 %0, %2, %3, p;\n") "}\n"
            : "+r"(k) : "r"(m), "r"(m + 5), "r"(m - 3));
        break;
      default:
        break;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[0] = t1 - t0;
  sink[lane] = k + (int)x + (int)addr;
}

template <int kOp>
int launch(int trips, long long* cycles, int* sink) {
  latency_kernel<kOp><<<1, 32>>>(trips, 1.5f, 0.25f, 0, cycles, sink);
  return (int)cudaGetLastError();
}

// op: the case of latency_kernel (0 FADD ... 9 ISETP -> SEL); cycles, sink:
// device pointers of 1 and 32 elements.
extern "C" int amr_latency_probe(int op, int trips, long long* cycles, int* sink) {
  switch (op) {
    case 0: return launch<0>(trips, cycles, sink);
    case 1: return launch<1>(trips, cycles, sink);
    case 2: return launch<2>(trips, cycles, sink);
    case 3: return launch<3>(trips, cycles, sink);
    case 4: return launch<4>(trips, cycles, sink);
    case 5: return launch<5>(trips, cycles, sink);
    case 6: return launch<6>(trips, cycles, sink);
    case 7: return launch<7>(trips, cycles, sink);
    case 8: return launch<8>(trips, cycles, sink);
    case 9: return launch<9>(trips, cycles, sink);
    default: return (int)cudaErrorInvalidValue;
  }
}
