// Issue rates of single instruction classes on Hopper (sm_90a).
//
// One kernel per instruction class (and a few mixed loops): every thread
// runs independent chains of that class's instruction, 8 chains (6 for
// the predicate classes, whose chains live in predicate registers),
// unrolled kSteps deep in a loop that is not unrolled further, so the
// loop body is the timed opcode and little else. Launched with 2,048
// threads on every SM (8 blocks of 256, at most 32 registers a thread),
// each kernel's rate is its instructions over its time: thread
// instructions per SM-clock, a packed bf16x2 instruction counting once.
//
// The instructions are written in PTX (asm volatile), so the front end
// neither merges nor hoists them; scripts/issue_rates.py checks in the
// SASS that each loop holds the opcode it names, as many times as this
// file says, and that nothing else dominates it.
//
// Built like the port's kernels (--fmad=false, sm_90a) by
// scripts/issue_rates.py through glaze_tpu_torch.cuda_build into
// build/libglaze_rates.so. It is a measurement, not part of the port.

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

namespace {

__device__ __forceinline__ __nv_bfloat162 from_bits(uint32_t r) {
  __nv_bfloat162 v;
  memcpy(&v, &r, 4);
  return v;
}

constexpr int kThreads = 256;
constexpr int kSteps = 16;  // steps of every chain per loop iteration

#define CH8(S) S(0) S(1) S(2) S(3) S(4) S(5) S(6) S(7)

// in[0..7]: the chains' start values; in[8], in[9]: operands a, b;
// in[10]: a nonzero flag (selects); all the same for every thread
struct F32 {
  float x[8];
  float a, b;
  uint32_t flag;
  __device__ explicit F32(const uint32_t* in) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __uint_as_float(in[i]);
    a = __uint_as_float(in[8]);
    b = __uint_as_float(in[9]);
    flag = in[10];
  }
  __device__ uint32_t fold() const {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) r ^= __float_as_uint(x[i]);
    return r;
  }
};

struct B32 {
  uint32_t x[8];
  uint32_t a, b;
  __device__ explicit B32(const uint32_t* in) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = in[i];
    a = in[8];
    b = in[9];
  }
  __device__ uint32_t fold() const {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) r ^= x[i];
    return r;
  }
};

// One step of eight f32 / b32 chains.
__device__ __forceinline__ void fadd8(F32& s) {
#define S(i) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(s.x[i]) : "f"(s.a));
  CH8(S)
#undef S
}

__device__ __forceinline__ void fmul8(F32& s) {
#define S(i) asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(s.x[i]) : "f"(s.a));
  CH8(S)
#undef S
}

__device__ __forceinline__ void ffma8(F32& s) {
#define S(i) \
  asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(s.x[i]) : "f"(s.a), "f"(s.b));
  CH8(S)
#undef S
}

// min on even steps, max on odd ones (FMNMX either way)
__device__ __forceinline__ void fmnmx8(F32& s, int step) {
  if (step & 1) {
#define S(i) asm volatile("max.f32 %0, %0, %1;" : "+f"(s.x[i]) : "f"(s.b));
    CH8(S)
#undef S
  } else {
#define S(i) asm volatile("min.f32 %0, %0, %1;" : "+f"(s.x[i]) : "f"(s.a));
    CH8(S)
#undef S
  }
}

// x = flag ? x : a; the flag's test is loop-invariant and leaves the loop
__device__ __forceinline__ void fsel8(F32& s) {
#define S(i)                                                          \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"     \
               "selp.f32 %0, %0, %1, p;\n\t}"                         \
               : "+f"(s.x[i]) : "f"(s.a), "r"(s.flag));
  CH8(S)
#undef S
}

// x^(-1/2), so no two steps undo each other (MUFU.RSQ, the SFU's rate)
__device__ __forceinline__ void mufu8(F32& s) {
#define S(i) asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(s.x[i]));
  CH8(S)
#undef S
}

__device__ __forceinline__ void hadd8(B32& s) {
#define S(i) asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(s.x[i]) : "r"(s.a));
  CH8(S)
#undef S
}

__device__ __forceinline__ void hfma8(B32& s) {
#define S(i) \
  asm volatile("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(s.x[i]) : "r"(s.a), "r"(s.b));
  CH8(S)
#undef S
}

// a packed compare into a lane mask (0xFFFF a true half), as
// __hle2_mask writes it
__device__ __forceinline__ void hset8(B32& s) {
#define S(i) s.x[i] = __hle2_mask(from_bits(s.x[i]), from_bits(s.a));
  CH8(S)
#undef S
}

__device__ __forceinline__ void hmul8(B32& s) {
#define S(i) asm volatile("mul.rn.bf16x2 %0, %0, %1;" : "+r"(s.x[i]) : "r"(s.a));
  CH8(S)
#undef S
}

// Each chain takes the min (even steps) or max (odd) with its neighbour:
// every result has two readers, so no two of them fuse into a
// three-input VHMNMX.
__device__ __forceinline__ void hmnmx8(B32& s, int step) {
  if (step & 1) {
#define S(i) asm volatile("max.bf16x2 %0, %0, %1;" : "+r"(s.x[i]) : "r"(s.x[(i + 1) & 7]));
    CH8(S)
#undef S
  } else {
#define S(i) asm volatile("min.bf16x2 %0, %0, %1;" : "+r"(s.x[i]) : "r"(s.x[(i + 1) & 7]));
    CH8(S)
#undef S
  }
}

// min(min(x, a), b): two PTX mins whose middle value has one reader,
// which ptxas fuses into one three-input VHMNMX
__device__ __forceinline__ void vhmnmx8(B32& s) {
#define S(i)                                                        \
  asm volatile("{\n\t.reg .b32 t;\n\tmin.bf16x2 t, %0, %1;\n\t"    \
               "min.bf16x2 %0, t, %2;\n\t}"                         \
               : "+r"(s.x[i]) : "r"(s.a), "r"(s.b));
  CH8(S)
#undef S
}

__device__ __forceinline__ void lop8(B32& s) {
#define S(i) \
  asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(s.x[i]) : "r"(s.a), "r"(s.b));
  CH8(S)
#undef S
}

__device__ __forceinline__ void f2fp8(B32& s) {
#define S(i)                                                    \
  asm volatile("cvt.rn.bf16x2.f32 %0, %1, %2;"                 \
               : "=r"(s.x[i]) : "f"(__uint_as_float(s.x[i])),   \
                 "f"(__uint_as_float(s.a)));
  CH8(S)
#undef S
}

// Predicate chains: one asm block a loop iteration holds every step, so
// the six chains stay in predicate registers; they enter and leave it
// as 0/1 words (6 ISETP and 6 SEL an iteration besides the compares).
#define P_IN                                              \
  ".reg .pred q0, q1, q2, q3, q4, q5;\n\t"                 \
  "setp.ne.u32 q0, %0, 0;\n\tsetp.ne.u32 q1, %1, 0;\n\t"   \
  "setp.ne.u32 q2, %2, 0;\n\tsetp.ne.u32 q3, %3, 0;\n\t"   \
  "setp.ne.u32 q4, %4, 0;\n\tsetp.ne.u32 q5, %5, 0;\n\t"
#define P_OUT                                             \
  "selp.u32 %0, 1, 0, q0;\n\tselp.u32 %1, 1, 0, q1;\n\t"   \
  "selp.u32 %2, 1, 0, q2;\n\tselp.u32 %3, 1, 0, q3;\n\t"   \
  "selp.u32 %4, 1, 0, q4;\n\tselp.u32 %5, 1, 0, q5;\n\t"

// six f32 compares, chain k against operands %(6 + (k + r) % 8), %14
#define FSETP_STEP(A, B, C, D, E, F)                      \
  "setp.lt.and.f32 q0, %" #A ", %14, q0;\n\t"              \
  "setp.gt.and.f32 q1, %" #B ", %14, q1;\n\t"              \
  "setp.lt.and.f32 q2, %" #C ", %14, q2;\n\t"              \
  "setp.gt.and.f32 q3, %" #D ", %14, q3;\n\t"              \
  "setp.lt.and.f32 q4, %" #E ", %14, q4;\n\t"              \
  "setp.gt.and.f32 q5, %" #F ", %14, q5;\n\t"
#define FSETP_8STEPS                                                  \
  FSETP_STEP(6, 7, 8, 9, 10, 11) FSETP_STEP(7, 8, 9, 10, 11, 12)      \
  FSETP_STEP(8, 9, 10, 11, 12, 13) FSETP_STEP(9, 10, 11, 12, 13, 6)   \
  FSETP_STEP(10, 11, 12, 13, 6, 7) FSETP_STEP(11, 12, 13, 6, 7, 8)    \
  FSETP_STEP(12, 13, 6, 7, 8, 9) FSETP_STEP(13, 6, 7, 8, 9, 10)

// three bf16x2 compares of two halves each, chains q0|q1, q2|q3, q4|q5
#define HSETP_STEP(A, B, C)                                    \
  "setp.lt.and.bf16x2 q0|q1, %" #A ", %14, q0;\n\t"             \
  "setp.gt.and.bf16x2 q2|q3, %" #B ", %14, q2;\n\t"             \
  "setp.lt.and.bf16x2 q4|q5, %" #C ", %14, q4;\n\t"
#define HSETP_8STEPS                                                      \
  HSETP_STEP(6, 7, 8) HSETP_STEP(7, 8, 9) HSETP_STEP(8, 9, 10)            \
  HSETP_STEP(9, 10, 11) HSETP_STEP(10, 11, 12) HSETP_STEP(11, 12, 13)     \
  HSETP_STEP(12, 13, 6) HSETP_STEP(13, 6, 7)

// the f32 min/max chains %6..%13 between the compares of FSETP_STEP
#define FMNMX_STEP                                                        \
  "min.f32 %6, %6, %14;\n\tmax.f32 %7, %7, %15;\n\t"                      \
  "min.f32 %8, %8, %14;\n\tmax.f32 %9, %9, %15;\n\t"                      \
  "min.f32 %10, %10, %14;\n\tmax.f32 %11, %11, %15;\n\t"                  \
  "min.f32 %12, %12, %14;\n\tmax.f32 %13, %13, %15;\n\t"

struct Pred {
  uint32_t q[6];
  __device__ Pred() {
#pragma unroll
    for (int i = 0; i < 6; ++i) q[i] = 1;
  }
};

// kSteps (16) steps of the six FSETP chains: 96 FSETP
__device__ __forceinline__ void fsetp_iter(Pred& p, F32& s) {
  asm volatile("{\n\t" P_IN FSETP_8STEPS FSETP_8STEPS P_OUT "}"
               : "+r"(p.q[0]), "+r"(p.q[1]), "+r"(p.q[2]), "+r"(p.q[3]),
                 "+r"(p.q[4]), "+r"(p.q[5])
               : "f"(s.x[0]), "f"(s.x[1]), "f"(s.x[2]), "f"(s.x[3]),
                 "f"(s.x[4]), "f"(s.x[5]), "f"(s.x[6]), "f"(s.x[7]),
                 "f"(s.a));
}

// 32 steps of the three HSETP2 chains: 96 HSETP2 (192 compares)
__device__ __forceinline__ void hsetp_iter(Pred& p, B32& s) {
  asm volatile("{\n\t" P_IN HSETP_8STEPS HSETP_8STEPS HSETP_8STEPS
               HSETP_8STEPS P_OUT "}"
               : "+r"(p.q[0]), "+r"(p.q[1]), "+r"(p.q[2]), "+r"(p.q[3]),
                 "+r"(p.q[4]), "+r"(p.q[5])
               : "r"(s.x[0]), "r"(s.x[1]), "r"(s.x[2]), "r"(s.x[3]),
                 "r"(s.x[4]), "r"(s.x[5]), "r"(s.x[6]), "r"(s.x[7]),
                 "r"(s.a));
}

// 16 steps of six FSETP chains and eight FMNMX chains: 96 FSETP, 128 FMNMX
__device__ __forceinline__ void fsetp_fmnmx_iter(Pred& p, F32& s) {
#define FS_STEP(A, B, C, D, E, F) FMNMX_STEP FSETP_STEP(A, B, C, D, E, F)
  asm volatile(
      "{\n\t" P_IN
      FS_STEP(6, 7, 8, 9, 10, 11) FS_STEP(7, 8, 9, 10, 11, 12)
      FS_STEP(8, 9, 10, 11, 12, 13) FS_STEP(9, 10, 11, 12, 13, 6)
      FS_STEP(10, 11, 12, 13, 6, 7) FS_STEP(11, 12, 13, 6, 7, 8)
      FS_STEP(12, 13, 6, 7, 8, 9) FS_STEP(13, 6, 7, 8, 9, 10)
      FS_STEP(6, 7, 8, 9, 10, 11) FS_STEP(7, 8, 9, 10, 11, 12)
      FS_STEP(8, 9, 10, 11, 12, 13) FS_STEP(9, 10, 11, 12, 13, 6)
      FS_STEP(10, 11, 12, 13, 6, 7) FS_STEP(11, 12, 13, 6, 7, 8)
      FS_STEP(12, 13, 6, 7, 8, 9) FS_STEP(13, 6, 7, 8, 9, 10)
      P_OUT "}"
      : "+r"(p.q[0]), "+r"(p.q[1]), "+r"(p.q[2]), "+r"(p.q[3]),
        "+r"(p.q[4]), "+r"(p.q[5]), "+f"(s.x[0]), "+f"(s.x[1]),
        "+f"(s.x[2]), "+f"(s.x[3]), "+f"(s.x[4]), "+f"(s.x[5]),
        "+f"(s.x[6]), "+f"(s.x[7])
      : "f"(s.a), "f"(s.b));
#undef FS_STEP
}

}  // namespace

// The kernels. Each: `iters` loop iterations of kSteps steps; out gets one
// word a thread so that no chain is dead.
#define KERNEL(NAME) \
  extern "C" __global__ void __launch_bounds__(kThreads, 8) NAME( \
      const uint32_t* __restrict__ in, int iters, uint32_t* __restrict__ out)
#define OUT(v) out[blockIdx.x * kThreads + threadIdx.x] = (v)
#define LOOP(BODY)                                \
  _Pragma("unroll 1") for (int it = 0; it < iters; ++it) { \
    _Pragma("unroll") for (int step = 0; step < kSteps; ++step) { BODY; } \
  }

KERNEL(rate_fadd) { F32 s(in); LOOP(fadd8(s)) OUT(s.fold()); }
KERNEL(rate_fmul) { F32 s(in); LOOP(fmul8(s)) OUT(s.fold()); }
KERNEL(rate_ffma) { F32 s(in); LOOP(ffma8(s)) OUT(s.fold()); }
KERNEL(rate_fmnmx) { F32 s(in); LOOP(fmnmx8(s, step)) OUT(s.fold()); }
KERNEL(rate_fsel) { F32 s(in); LOOP(fsel8(s)) OUT(s.fold()); }
KERNEL(rate_mufu) { F32 s(in); LOOP(mufu8(s)) OUT(s.fold()); }
KERNEL(rate_hadd2) { B32 s(in); LOOP(hadd8(s)) OUT(s.fold()); }
KERNEL(rate_hmul2) { B32 s(in); LOOP(hmul8(s)) OUT(s.fold()); }
KERNEL(rate_hfma2) { B32 s(in); LOOP(hfma8(s)) OUT(s.fold()); }
KERNEL(rate_hset2) { B32 s(in); LOOP(hset8(s)) OUT(s.fold()); }
KERNEL(rate_hmnmx2) { B32 s(in); LOOP(hmnmx8(s, step)) OUT(s.fold()); }
KERNEL(rate_vhmnmx) { B32 s(in); LOOP(vhmnmx8(s)) OUT(s.fold()); }
KERNEL(rate_lop3) { B32 s(in); LOOP(lop8(s)) OUT(s.fold()); }
KERNEL(rate_f2fp) { B32 s(in); LOOP(f2fp8(s)) OUT(s.fold()); }

KERNEL(rate_fsetp) {
  F32 s(in);
  Pred p;
  _Pragma("unroll 1") for (int it = 0; it < iters; ++it) fsetp_iter(p, s);
  OUT(p.q[0] ^ p.q[1] ^ p.q[2] ^ p.q[3] ^ p.q[4] ^ p.q[5]);
}

KERNEL(rate_hsetp2) {
  B32 s(in);
  Pred p;
  _Pragma("unroll 1") for (int it = 0; it < iters; ++it) hsetp_iter(p, s);
  OUT(p.q[0] ^ p.q[1] ^ p.q[2] ^ p.q[3] ^ p.q[4] ^ p.q[5]);
}

// LDS.64: eight pointer chases a thread through its own 8-byte words,
// each word holding its own shared address (low half) beside a word that
// every chain writes to one dead register
KERNEL(rate_lds64) {
  __shared__ uint2 words[8 * kThreads];
  uint32_t addr[8], dead = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint2* w = &words[i * kThreads + threadIdx.x];
    addr[i] = static_cast<uint32_t>(__cvta_generic_to_shared(w));
    *w = make_uint2(addr[i], in[i]);
  }
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
#define S(i) asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%0];" \
                          : "+r"(addr[i]), "=r"(dead));
      CH8(S)
#undef S
    }
  }
  uint32_t r = dead;
#pragma unroll
  for (int i = 0; i < 8; ++i) r ^= addr[i];
  OUT(r);
}

// Mixed loops: two classes, eight chains each, one instruction of each
// a chain and step. Whether they run at the sum of the two rates or at
// one shared pipe's rate says whether their pipes overlap.
KERNEL(mix_fadd_fmnmx) {
  F32 s(in), t(in);
  LOOP(fadd8(s); fmnmx8(t, step))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fmnmx_fsel) {
  F32 s(in), t(in);
  LOOP(fmnmx8(s, step); fsel8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fmnmx_lop3) {
  F32 s(in);
  B32 t(in);
  LOOP(fmnmx8(s, step); lop8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fmnmx_hmnmx2) {
  F32 s(in);
  B32 t(in);
  LOOP(fmnmx8(s, step); hmnmx8(t, step))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_hmnmx2_lop3) {
  B32 s(in), t(in);
  LOOP(hmnmx8(s, step); lop8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_hmnmx2_vhmnmx) {
  B32 s(in), t(in);
  LOOP(hmnmx8(s, step); vhmnmx8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_hmnmx2_hset2) {
  B32 s(in), t(in);
  LOOP(hmnmx8(s, step); hset8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fmnmx_f2fp) {
  F32 s(in);
  B32 t(in);
  LOOP(fmnmx8(s, step); f2fp8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fadd_hadd2) {
  F32 s(in);
  B32 t(in);
  LOOP(fadd8(s); hadd8(t))
  OUT(s.fold() ^ t.fold());
}
KERNEL(mix_fsetp_fmnmx) {
  F32 s(in);
  Pred p;
  _Pragma("unroll 1") for (int it = 0; it < iters; ++it) fsetp_fmnmx_iter(p, s);
  OUT(s.fold() ^ p.q[0] ^ p.q[1] ^ p.q[2] ^ p.q[3] ^ p.q[4] ^ p.q[5]);
}

namespace {

using Kernel = void (*)(const uint32_t*, int, uint32_t*);

struct Entry {
  const char* name;
  Kernel fn;
};

const Entry kKernels[] = {
    {"rate_fadd", rate_fadd},         {"rate_fmul", rate_fmul},
    {"rate_ffma", rate_ffma},         {"rate_fmnmx", rate_fmnmx},
    {"rate_fsetp", rate_fsetp},       {"rate_fsel", rate_fsel},
    {"rate_mufu", rate_mufu},         {"rate_hadd2", rate_hadd2},
    {"rate_hmul2", rate_hmul2},       {"rate_hfma2", rate_hfma2},
    {"rate_hset2", rate_hset2},       {"rate_hmnmx2", rate_hmnmx2},
    {"rate_vhmnmx", rate_vhmnmx},     {"rate_hsetp2", rate_hsetp2},
    {"rate_lop3", rate_lop3},         {"rate_f2fp", rate_f2fp},
    {"rate_lds64", rate_lds64},       {"mix_fadd_fmnmx", mix_fadd_fmnmx},
    {"mix_fmnmx_fsel", mix_fmnmx_fsel}, {"mix_fmnmx_lop3", mix_fmnmx_lop3},
    {"mix_fmnmx_hmnmx2", mix_fmnmx_hmnmx2},
    {"mix_hmnmx2_lop3", mix_hmnmx2_lop3},
    {"mix_hmnmx2_vhmnmx", mix_hmnmx2_vhmnmx},
    {"mix_hmnmx2_hset2", mix_hmnmx2_hset2},
    {"mix_fmnmx_f2fp", mix_fmnmx_f2fp},
    {"mix_fadd_hadd2", mix_fadd_hadd2}, {"mix_fsetp_fmnmx", mix_fsetp_fmnmx}};
constexpr int kCount = sizeof(kKernels) / sizeof(kKernels[0]);

}  // namespace

extern "C" {

int glaze_rate_count() { return kCount; }

const char* glaze_rate_name(int which) {
  return (which >= 0 && which < kCount) ? kKernels[which].name : nullptr;
}

// Launches kernel ``which`` on ``blocks`` blocks of 256 threads; ``in``
// holds 16 words, ``out`` one word a thread. Returns cudaGetLastError().
int glaze_rate_run(int which, const uint32_t* in, int iters, uint32_t* out,
                   int blocks, void* stream) {
  if (which < 0 || which >= kCount || iters < 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  kKernels[which].fn<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(in, iters, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes a thread of kernel ``which``.
int glaze_rate_attrs(int which, int* regs, int* local_bytes) {
  if (which < 0 || which >= kCount)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kKernels[which].fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* glaze_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
