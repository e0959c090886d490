// Probe kernels for Hopper (sm_90a): the TPU measurement tools of tools/
// as CUDA kernels, driven by the entry points of glaze_tpu_torch/tools/.
// None of them is on the render path; each answers one question about
// the leaf test or the walk loop of the traversal kernels (traverse.cu).
//
// Replaces the Pallas kernels of
//   drain_kernel<P, false>       <- tools/bench_mxu.py:95 make_kernel
//                                   (pallas_call :189)             (T1)
//   drain_kernel<kHighest, true> <- tools/bench_dot.py:112
//                                   run_resolve_case (:167)        (T3b)
//   dot_chain_kernel<P>          <- tools/bench_dot.py:29 run_case
//                                   (:76)                          (T3a)
//   walk_overhead_kernel<V, N>   <- tools/exp_overhead.py:50
//                                   make_kernel (:148)             (T2)
//   slab_rate_f32 / slab_rate_bf16 <- tools/bench_bf16_slab.py:38
//                                   _make_kernel, reached through
//                                   run (:87, pallas_call :94)     (T4)
//
// Precision of the products (the tools' names, their counterparts here;
// the accumulator is f32 throughout, K = 16 is the tools' F, 10 rows used
// by the ray features):
//   highest: 3xTF32 on mma.sync m16n8k8 tf32: hi = cvt.rna.tf32(x),
//            lo = cvt.rna.tf32(x - hi); hi*hi + hi*lo + lo*hi.
//   default: one bf16 pass on mma.sync m16n8k16 bf16, inputs rounded to
//            nearest even (__floats2bfloat162_rn).
//   split3:  bench_dot.py:50-63's hi/lo bf16 split, three bf16 passes
//            hi*hi + hi*lo + lo*hi.
// Products of TF32 or bf16 operands are exact in the f32 accumulator;
// results differ from the plain torch versions (which sum the same exact
// products in float64) only in the order and rounding of the sums.
//
// drain_kernel (T1, T3b). Function: for each step k of a leaf order, the
// product of the leaf's (16, 4T) slab, transposed, with the (16, 128)
// features of a block's 128 rays gives det, u*det, v*det and t*det of
// every (triangle, ray) pair; the det-scaled closest-hit resolve of
// bench_mxu.py:138-163 (|det| >= 1e-12, 1e-4 < t, the step's least t
// with the lowest column on an exact tie, tri = leaf*T + column) replaces
// the ray's best where its t is strictly less. Features (T1): [o' x d, o',
// d, 1, 0...] with o' = o - the leaf's centre; (T3b) feat + carry, where
// the carry grows by ray 0's new best t times 1e-30 in each step that
// improves it (bench_dot.py:132, :161).
// Bound on an H100: one block is one SM. Per (128 rays, leaf) the product
// is 4T x 128 x 16 multiply-adds per pass (3 passes at highest), and the
// resolve ~14 f32 operations per (triangle, ray) pair; the slab (16 x 4T
// floats) comes from L2. At T = 128 and highest the product (6.3 MFLOP,
// 1.7 us at one SM's share of the TF32 rate) outweighs the resolve
// (230k operations, 0.45 us at its share of the f32 rate); at default the
// resolve bounds it. With 4 warps, one per SM sub-partition, the limit
// here is the instruction rate and latency of mma.sync and of each warp's
// TF32 splits of the A fragments.
// Design: one block of 4 warps per 128 rays, a loop over the leaf order.
// Each step copies the slab into shared memory (float4 loads, rows padded
// by 8 floats so the fragment loads do not conflict) and writes the ray
// features beside it. Each warp owns 32 rays (four n8 tiles, B fragments
// split once per step in registers) and walks the m16 tiles of triangles
// m0 .. m0 + 15: the det, ud, vd and td tiles are slab columns
// quantity * T + m0, and the f32 accumulator layout (the same for
// m16n8k8 tf32 and m16n8k16 bf16) puts c[0], c[1] at row g, columns 2q,
// 2q + 1 and c[2], c[3] at row g + 8, so the four quantities of a pair sit
// in the same register slot of the same lane. The resolve reads them
// there: no shared buffer and no barrier. A lane computes the 64
// accumulators of an m16 tile (4 ray tiles x 4 quantities x 4 slots),
// tests its 16 pairs for inside without a division or a branch, and only
// if one passes divides (t = td * (1 / det)), the same operations as the
// one-part test, so the same bits. Each lane keeps a candidate (t, column,
// u, v) for each of its 8 ray slots (2 columns x 4 tiles), taking rows g
// and g + 8 of the tiles in ascending triangle order with a strict <; at
// the end of the step xor shuffles over lanes 4, 8 and 16
// (the eight lanes of one q hold the same rays) keep the (t, column)
// least, u and v come from the lane that holds the winning column, and
// every lane folds the winner into its copy of the ray's best with a
// strict <. Lanes with g = 0 write the results. Two barriers per step
// stay: before the copy (the last step's reads, T3b's carry from thread
// 0, which holds ray 0) and after it. No cp.async, no wgmma: later work.
//
// dot_chain_kernel (T3a). Function: reps dependent products of a (16, W)
// matrix with f = where(feat > acc[0,0], feat, -feat), each folded into
// the (8, 128) acc as acc + sum(out.reshape(-1, 8, 128), 0). Every step
// runs the full product on the tensor cores, no algebraic reduction:
// (W/16 m-tiles) x (16 n-tiles) x passes x k-steps mma.sync, 3 x 2 at
// highest (m16n8k8 tf32), 1 x 1 at default and 3 x 1 at split3 (m16n8k16
// bf16); 3,072 a step at W = 512 highest. Bound: the tensor-core rate of
// one SM (one block). Design: 8 warps, two per sub-partition, so one
// warp's mma latency hides behind the other's. Warp w takes the columns
// of half w / 4 (8 n-tiles) and the m-tiles w % 4, w % 4 + 4, ...; the
// constant matrix is split once, at the start of the chain, into the
// fragment order of shared memory (16-byte loads, no conflicts): hi/lo
// words, except 3xTF32 above W = 1024, where the 256 KB of hi and lo at W
// = 2048 would not fit, so the f32 values stay and each warp splits its
// fragments per step. A lane keeps its feature values and their split in
// registers and applies each step's sign flip to both parts (the TF32 and
// bf16 roundings are symmetric). The m-tiles accumulate in the mma's C
// operand, 8 independent accumulators; rows g and g + 8 fold into row g
// once per step. Each warp keeps its partial acc for the chain; only the
// partials of acc[0, 0] cross warps (one slot per m-group, one barrier a
// step) and the partials are summed across warps once at the end, in the
// order a00 sums them.
//
// walk_overhead_kernel (T2). Function: a packet of rays walks octant 0 of
// nodes16 from node 0 behind one pointer, with no t cap; it enters a node
// (p + 1) when any ray of the packet hits its box (_slab), a leaf or a
// miss goes to the skip link, p >= n_nodes ends. Leaf bodies (when any ray
// hits the leaf): A adds, per ray that hits the leaf box, the t of every
// Moller-Trumbore hit among the 8 triangles of the leaf's tri8 row; B adds
// 1 per leaf; C has no leaf body; D descends on p % 3 != 2 with no vote at
// all (its slab tests are kept alive by a product with a runtime zero).
// Outputs t per ray (0 for C and D, as the tool writes them) and each
// packet's iteration count. Packet 2048 is the tool's; packet 32 is one
// warp, the card's natural packet. Bound: the latency of one iteration
// (node row, slab tests, vote) times a packet's iterations, not bytes or
// operations; at packet 2048 a few packets walk 5x the mean. Design: a
// 2048-ray packet is a block of 256 threads with 8 rays each, so that two
// packets are resident on an SM and one packet's vote overlaps another's
// work, and it loads rows p + 1 and skip[p] as soon as row p arrives (at
// packet 32 the next row follows the vote, see below). A runs its leaf tests only for the rays that
// hit the leaf box: at packet 2048 a list built by warp prefix sums and
// published by the vote's barrier, one listed ray per thread, the leaf's
// row staged in shared memory; at packet 32 the (ray, triangle) pairs
// spread over the lanes and gathered by shuffles. Each ray adds its t
// values in the plain walk's order, so A's outputs are the plain walk's
// bit for bit.
//
// slab_rate_f32 / slab_rate_bf16 (T4). Function: bench_bf16_slab.py:49-83
// per element, iters times: the node row k % 64 (by lane, from shared
// memory), 6 add/sub, 6 mul, 10 min/max, 2 compares, the hit count and
// the capped t; out = acc + t_cap. f32: one element per thread; bf16: one
// __nv_bfloat162 (two neighbouring lanes) per thread with packed
// __hsub2/__hadd2/__hmul2/__hmin2/__hmax2 and packed compares (a bf16
// compare is exact, as in f32). Bound: the issue rate (128 instructions
// per SM-clock) and the 64-wide pipe of min, max, compare, select and
// logic (scripts/issue_rates.py): f32 issues 27 instructions a test, 14
// on that pipe; bf16 26 a pair, 13 on it. Design (bf16): the node rows
// are converted to packed bf16 once, when a block loads them, and one
// 16-byte shared load brings four rows, so the loop holds no conversion
// and no modulo addressing; the two compares are lane masks, and one
// LOP3 makes the count's 1.0 and one the capped t's operand (a NaN where
// the test misses, which min() passes over), in place of a product and
// six integer instructions of a bit select: 26 instructions a pair and
// iteration, from 35. The count and t_cap keep the plain loop's serial
// order, so the output is the plain loop's bit for bit (bf16 addition of
// 1.0 is inexact above 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kF = 16;       // feature rows: the K of every product
constexpr int kRays = 128;   // rays (columns) of one drain or chain block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = kRays / 8 / kWarps;  // n8 tiles of a warp
constexpr int kLd = kRays + 8;  // padded row stride of the features
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTMin = 1e-4f;
constexpr float kDetEps = 1e-12f;

enum Prec { kHighest = 0, kDefault = 1, kSplit3 = 2 };

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ __nv_bfloat162 from_bits(uint32_t r) {
  __nv_bfloat162 v;
  memcpy(&v, &r, 4);
  return v;
}

// (x0, x1) -> packed bf16 hi (x0 in the low half) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Operand fragments of one m16 x n8 x k16 tile, hi (and lo) parts. TF32
// takes two k8 steps: a[4 * step + r], b[2 * step + r]; bf16 one k16 step:
// a[0..3], b[0..1] (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16
// fragment layouts; g = lane / 4, q = lane % 4).
struct FragA {
  uint32_t hi[8], lo[8];
};
struct FragB {
  uint32_t hi[4], lo[4];
};

// A(m, k) = a[k * lda + m]: the (16, M) matrix in shared memory, read as
// its transpose; the tile's rows are m0 .. m0 + 15.
template <int P>
__device__ __forceinline__ FragA load_a(const float* a, int lda, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  FragA f;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* k0 = a + (8 * s + q) * lda + m0 + g;
      const float* k4 = k0 + 4 * lda;
      split_tf32(k0[0], f.hi[4 * s], f.lo[4 * s]);
      split_tf32(k0[8], f.hi[4 * s + 1], f.lo[4 * s + 1]);
      split_tf32(k4[0], f.hi[4 * s + 2], f.lo[4 * s + 2]);
      split_tf32(k4[8], f.hi[4 * s + 3], f.lo[4 * s + 3]);
    }
  } else {
    const float* k0 = a + 2 * q * lda + m0 + g;  // rows k = 2q, 2q + 1
    const float* k8 = k0 + 8 * lda;              // rows k = 2q + 8, 2q + 9
    split_bf16(k0[0], k0[lda], f.hi[0], f.lo[0]);
    split_bf16(k0[8], k0[lda + 8], f.hi[1], f.lo[1]);
    split_bf16(k8[0], k8[lda], f.hi[2], f.lo[2]);
    split_bf16(k8[8], k8[lda + 8], f.hi[3], f.lo[3]);
  }
  return f;
}

// B(k, n) = b[k * ldb + n]; the tile's columns are n0 .. n0 + 7.
template <int P>
__device__ __forceinline__ FragB load_b(const float* b, int ldb, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  FragB f;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* k0 = b + (8 * s + q) * ldb + n0 + g;
      split_tf32(k0[0], f.hi[2 * s], f.lo[2 * s]);
      split_tf32(k0[4 * ldb], f.hi[2 * s + 1], f.lo[2 * s + 1]);
    }
  } else {
    const float* k0 = b + 2 * q * ldb + n0 + g;
    split_bf16(k0[0], k0[ldb], f.hi[0], f.lo[0]);
    split_bf16(k0[8 * ldb], k0[9 * ldb], f.hi[1], f.lo[1]);
  }
  return f;
}

template <int P>
__device__ __forceinline__ void mma_tile(float c[4], const FragA& a,
                                         const FragB& b) {
  if constexpr (P == kHighest) {
    mma_tf32(c, a.hi, b.hi);
    mma_tf32(c, a.hi + 4, b.hi + 2);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi + 4, b.lo + 2);
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.lo + 4, b.hi + 2);
  } else {
    mma_bf16(c, a.hi, b.hi);
    if constexpr (P == kSplit3) {
      mma_bf16(c, a.hi, b.lo);
      mma_bf16(c, a.lo, b.hi);
    }
  }
}

struct DrainArgs {
  const float* mats;     // (n_leaves * 16, w) leaf slabs
  int w, T, n_leaves;
  const float* centres;  // (n_leaves, 3), T1
  const int* order;      // (reps,) leaf of each step
  int reps;
  const float *ox, *oy, *oz, *dx, *dy, *dz;  // (R,) rays, T1
  const float* feat;     // (16, 128) features, T3b
  float t_init;
  float *t_out, *u_out, *v_out;
  int* tri_out;
};

// A ray slot's hit: within a step the lane's candidate (t, column, u, v),
// over the steps the ray's best (t, triangle id, u, v).
struct Hit {
  float t;
  int id;
  float u, v;
};

// The det-scaled test of one (triangle, ray) pair (bench_mxu.py:138-163)
// in two parts. inside: |det| >= 1e-12 and the signs of u*det, v*det and
// det - (u + v)*det, with no division and no branch.
__device__ __forceinline__ bool inside(float det, float ud, float vd) {
  return (fabsf(det) >= kDetEps) & (ud * det >= 0.0f) & (vd * det >= 0.0f) &
         ((ud + vd) * det <= det * det);
}

// The rest, for a pair that is inside: t = td * (1 / det) and, if t > 1e-4
// and strictly less than the candidate's, the pair becomes the candidate.
// A lane meets its columns in ascending order, so an exact tie keeps the
// lower.
__device__ __forceinline__ void take_pair(float det, float ud, float vd,
                                          float td, int col, Hit& c) {
  const float inv = 1.0f / det;
  const float t = td * inv;
  if (t > kTMin && t < c.t) {
    c.t = t;
    c.id = col;
    c.u = ud * inv;
    c.v = vd * inv;
  }
}

// The step's winner of a slot across the eight lanes that share q (lane
// bits 2-4, g): the least t, on an exact tie the lowest column; u and v
// come from the lane that holds that column (g = column % 8). Every lane
// of the eight returns the same hit.
__device__ __forceinline__ Hit warp_winner(const Hit& c, int q) {
  float t = c.t;
  int id = c.id;
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {
    const float t2 = __shfl_xor_sync(kFull, t, s);
    const int id2 = __shfl_xor_sync(kFull, id, s);
    if (t2 < t || (t2 == t && id2 < id)) {
      t = t2;
      id = id2;
    }
  }
  const int src = ((id & 7) << 2) | q;
  return Hit{t, id, __shfl_sync(kFull, c.u, src),
             __shfl_sync(kFull, c.v, src)};
}

template <int P, bool kCarry>
__global__ void __launch_bounds__(kThreads) drain_kernel(const DrainArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int T = p.T;
  const int lda = 4 * T + 8;
  float* mat_s = smem;                   // (16, 4T) slab of the step's leaf
  float* feat_s = mat_s + kF * lda;      // (16, 128) features
  __shared__ float carry_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ray = blockIdx.x * kRays + tid;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if constexpr (kCarry) {
    if (tid == 0) carry_s = 0.0f;
  } else {
    ox = p.ox[ray];
    oy = p.oy[ray];
    oz = p.oz[ray];
    dx = p.dx[ray];
    dy = p.dy[ray];
    dz = p.dz[ray];
    feat_s[9 * kLd + tid] = 1.0f;
    for (int k = 10; k < kF; ++k) feat_s[k * kLd + tid] = 0.0f;
  }
  // slot (j, h): ray (warp * kTilesPerWarp + j) * 8 + 2q + h of the block
  Hit best[kTilesPerWarp][2];
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) best[j][h] = Hit{p.t_init, -1, 0.0f, 0.0f};
  for (int step = 0; step < p.reps; ++step) {
    const int leaf = p.order[step];
    if (leaf < 0 || leaf >= p.n_leaves) __trap();
    __syncthreads();  // the last step is done with the slab; carry is set
    const float4* src = reinterpret_cast<const float4*>(
        p.mats + (size_t)leaf * kF * p.w);
    for (int i = tid; i < kF * T; i += kThreads) {
      const int k = i / T, m4 = i - k * T;
      *reinterpret_cast<float4*>(mat_s + k * lda + 4 * m4) =
          __ldg(src + (size_t)k * (p.w / 4) + m4);
    }
    if constexpr (kCarry) {
      const float carry = carry_s;
      for (int k = 0; k < kF; ++k)
        feat_s[k * kLd + tid] = __ldg(p.feat + k * kRays + tid) + carry;
    } else {
      const float px = ox - __ldg(p.centres + 3 * leaf);
      const float py = oy - __ldg(p.centres + 3 * leaf + 1);
      const float pz = oz - __ldg(p.centres + 3 * leaf + 2);
      feat_s[0 * kLd + tid] = py * dz - pz * dy;
      feat_s[1 * kLd + tid] = pz * dx - px * dz;
      feat_s[2 * kLd + tid] = px * dy - py * dx;
      feat_s[3 * kLd + tid] = px;
      feat_s[4 * kLd + tid] = py;
      feat_s[5 * kLd + tid] = pz;
      feat_s[6 * kLd + tid] = dx;
      feat_s[7 * kLd + tid] = dy;
      feat_s[8 * kLd + tid] = dz;
    }
    __syncthreads();
    FragB fb[kTilesPerWarp];
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
      fb[j] = load_b<P>(feat_s, kLd, (warp * kTilesPerWarp + j) * 8);
    Hit cand[kTilesPerWarp][2];
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) cand[j][h] = Hit{INFINITY, T, 0.0f, 0.0f};
    // m16 tile of triangles m0 .. m0 + 15: its det, ud, vd and td tiles
    // are slab columns quantity * T + m0, so the four accumulators of a
    // pair sit in the same register slot of the same lane
    for (int m0 = 0; m0 < T; m0 += 16) {
      float c[kTilesPerWarp][4][4] = {};  // [ray tile][quantity][slot]
      {
        FragA fa[4];
#pragma unroll
        for (int quantity = 0; quantity < 4; ++quantity)
          fa[quantity] = load_a<P>(mat_s, lda, quantity * T + m0);
#pragma unroll
        for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
          for (int quantity = 0; quantity < 4; ++quantity)
            mma_tile<P>(c[j][quantity], fa[quantity], fb[j]);
      }
      // c[j][.][e], e = 2r + h: triangle m0 + g + 8r, ray slot (j, h). The
      // 16 inside tests run without a branch, the division only for the
      // pairs that pass (few of a leaf's T for any one ray)
      unsigned in = 0;
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          in |= unsigned(inside(c[j][0][e], c[j][1][e], c[j][2][e]))
                << (4 * j + e);
      if (in) {
#pragma unroll
        for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((in >> (4 * j + e)) & 1u)
              take_pair(c[j][0][e], c[j][1][e], c[j][2][e], c[j][3][e],
                        m0 + g + 8 * (e >> 1), cand[j][e & 1]);
      }
    }
    bool won = false;  // ray 0 improved this step (thread 0: T3b's carry)
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Hit w = warp_winner(cand[j][h], q);
        if (w.t < best[j][h].t) {
          best[j][h] = Hit{w.t, leaf * T + w.id, w.u, w.v};
          if (j == 0 && h == 0) won = true;
        }
      }
    if constexpr (kCarry) {
      if (tid == 0)
        carry_s = carry_s + (won ? best[0][0].t : INFINITY) * 1e-30f;
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r =
            blockIdx.x * kRays + (warp * kTilesPerWarp + j) * 8 + 2 * q + h;
        p.t_out[r] = best[j][h].t;
        p.tri_out[r] = best[j][h].id;
        p.u_out[r] = best[j][h].u;
        p.v_out[r] = best[j][h].v;
      }
  }
}

// T3a -------------------------------------------------------------------

constexpr int kChainWarps = 8;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kChainNGroups = 2;                            // column halves
constexpr int kChainMGroups = kChainWarps / kChainNGroups;  // m-tile strides
constexpr int kChainTiles = kRays / 8 / kChainNGroups;      // n8 tiles a warp
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory of a block

// 16-byte words of one lane's A fragment of an m16 tile in shared memory:
// the pre-split hi (and lo) words, or (kRaw) the 8 f32 values.
template <int P, bool kRaw>
__host__ __device__ constexpr int chain_vecs() {
  return kRaw ? 2 : (P == kHighest ? 4 : (P == kDefault ? 1 : 2));
}

template <int P, bool kRaw>
size_t chain_smem(int w) {
  return static_cast<size_t>(w / 16) * 32 * chain_vecs<P, kRaw>() * 16;
}

// The 8 values of lane's A fragment of the m16 tile m0 of the (16, w)
// matrix, in FragA order (load_a's elements, before the split).
template <int P>
__device__ __forceinline__ void a_values(const float* __restrict__ a, int w,
                                         int m0, int lane, float v[8]) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* k0 = a + (8 * s + q) * w + m0 + g;
      const float* k4 = k0 + 4 * w;
      v[4 * s] = __ldg(k0);
      v[4 * s + 1] = __ldg(k0 + 8);
      v[4 * s + 2] = __ldg(k4);
      v[4 * s + 3] = __ldg(k4 + 8);
    }
  } else {
    const float* k0 = a + 2 * q * w + m0 + g;
    const float* k8 = k0 + 8 * w;
    v[0] = __ldg(k0);
    v[1] = __ldg(k0 + w);
    v[2] = __ldg(k0 + 8);
    v[3] = __ldg(k0 + w + 8);
    v[4] = __ldg(k8);
    v[5] = __ldg(k8 + w);
    v[6] = __ldg(k8 + 8);
    v[7] = __ldg(k8 + w + 8);
  }
}

template <int P>
__device__ __forceinline__ FragA split_a(const float v[8]) {
  FragA f;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int i = 0; i < 8; ++i) split_tf32(v[i], f.hi[i], f.lo[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(v[2 * i], v[2 * i + 1], f.hi[i], f.lo[i]);
  }
  return f;
}

__device__ __forceinline__ void put4(uint32_t* d, const uint4 x) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

// lane's A fragment of m-tile mt from the fragment-ordered shared copy
// (a[(mt * vecs + v) * 32 + lane]: conflict-free 16-byte loads).
template <int P, bool kRaw>
__device__ __forceinline__ FragA chain_a(const uint4* a, int mt, int lane) {
  const uint4* p = a + mt * chain_vecs<P, kRaw>() * 32 + lane;
  if constexpr (kRaw) {
    const uint4 x = p[0], y = p[32];
    const float v[8] = {__uint_as_float(x.x), __uint_as_float(x.y),
                        __uint_as_float(x.z), __uint_as_float(x.w),
                        __uint_as_float(y.x), __uint_as_float(y.y),
                        __uint_as_float(y.z), __uint_as_float(y.w)};
    return split_a<P>(v);
  } else {
    FragA f;
    put4(f.hi, p[0]);
    if constexpr (P == kHighest) {
      put4(f.hi + 4, p[32]);
      put4(f.lo, p[64]);
      put4(f.lo + 4, p[96]);
    } else if constexpr (P == kSplit3) {
      put4(f.lo, p[32]);
    }
    return f;
  }
}

// One m-tile against the warp's n-tiles: every pass and k-step, each
// round of kChainTiles mma.sync on independent accumulators.
template <int P>
__device__ __forceinline__ void chain_mma(float (*c)[4], const FragA& a,
                                          const FragB* b) {
  if constexpr (P == kHighest) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kChainTiles; ++j)
        mma_tf32(c[j], a.hi + 4 * s, b[j].hi + 2 * s);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kChainTiles; ++j)
        mma_tf32(c[j], a.hi + 4 * s, b[j].lo + 2 * s);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kChainTiles; ++j)
        mma_tf32(c[j], a.lo + 4 * s, b[j].hi + 2 * s);
  } else {
#pragma unroll
    for (int j = 0; j < kChainTiles; ++j) mma_bf16(c[j], a.hi, b[j].hi);
    if constexpr (P == kSplit3) {
#pragma unroll
      for (int j = 0; j < kChainTiles; ++j) mma_bf16(c[j], a.hi, b[j].lo);
#pragma unroll
      for (int j = 0; j < kChainTiles; ++j) mma_bf16(c[j], a.lo, b[j].hi);
    }
  }
}

// Sets the sign of lane's B fragment values of one n-tile to that of f =
// where(feat > a00, feat, -feat). raw holds feat at the fragment's
// elements (for bf16 two to a word, the first in the low half); hi and lo
// parts of -x are those of x negated (both roundings are symmetric), so a
// sign flip of both parts is the split of the flipped value.
template <int P>
__device__ __forceinline__ void flip_b(FragB& b, const float raw[4],
                                       float a00) {
  if constexpr (P == kHighest) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t want =
          __float_as_uint(raw[e]) ^ (raw[e] > a00 ? 0u : 0x80000000u);
      const uint32_t d = (b.hi[e] ^ want) & 0x80000000u;
      b.hi[e] ^= d;
      b.lo[e] ^= d;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t s0 =
          __float_as_uint(raw[2 * e]) ^ (raw[2 * e] > a00 ? 0u : 0x80000000u);
      const uint32_t s1 = __float_as_uint(raw[2 * e + 1]) ^
                          (raw[2 * e + 1] > a00 ? 0u : 0x80000000u);
      const uint32_t want = ((s0 >> 16) & 0x8000u) | (s1 & 0x80000000u);
      const uint32_t d = (b.hi[e] ^ want) & 0x80008000u;
      b.hi[e] ^= d;
      b.lo[e] ^= d;
    }
  }
}

// lane's feature values of the B fragment of the n-tile at column n0
// (load_b's elements, before the split).
template <int P>
__device__ __forceinline__ void b_values(const float* __restrict__ feat,
                                         int n0, int lane, float raw[4]) {
  const int g = lane >> 2, q = lane & 3;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int e = 0; e < 4; ++e)  // k = 8s + q + 4r, e = 2s + r
      raw[e] = __ldg(feat + (8 * (e >> 1) + q + 4 * (e & 1)) * kRays + n0 + g);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)  // k = 2q + 8 * (e / 2) + e % 2
      raw[e] = __ldg(feat + (2 * q + 8 * (e >> 1) + (e & 1)) * kRays + n0 + g);
  }
}

template <int P, bool kRaw>
__global__ void __launch_bounds__(kChainThreads, 1)
dot_chain_kernel(const float* __restrict__ mat, int w,
                 const float* __restrict__ feat, int reps,
                 float* __restrict__ out, float* __restrict__ trace) {
  extern __shared__ __align__(16) uint4 a_s[];  // fragment-ordered A
  __shared__ float part_s[2][kChainMGroups];    // acc[0, 0] partials
  __shared__ float red_s[kChainMGroups - 1][8][kRays];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ng = warp / kChainMGroups, mg = warp % kChainMGroups;
  const int n_mt = w / 16;
  // the split of the constant matrix, once for the chain
  for (int i = tid; i < n_mt * 32; i += kChainThreads) {
    const int mt = i >> 5, l = i & 31;
    float v[8];
    a_values<P>(mat, w, mt * 16, l, v);
    uint4* d = a_s + mt * chain_vecs<P, kRaw>() * 32 + l;
    if constexpr (kRaw) {
      d[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                        __float_as_uint(v[2]), __float_as_uint(v[3]));
      d[32] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                         __float_as_uint(v[6]), __float_as_uint(v[7]));
    } else {
      const FragA f = split_a<P>(v);
      d[0] = make_uint4(f.hi[0], f.hi[1], f.hi[2], f.hi[3]);
      if constexpr (P == kHighest) {
        d[32] = make_uint4(f.hi[4], f.hi[5], f.hi[6], f.hi[7]);
        d[64] = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
        d[96] = make_uint4(f.lo[4], f.lo[5], f.lo[6], f.lo[7]);
      } else if constexpr (P == kSplit3) {
        d[32] = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
      }
    }
  }
  // the warp's n-tiles: feature values and their split, kept in registers
  float raw[kChainTiles][4];
  FragB fb[kChainTiles];
#pragma unroll
  for (int j = 0; j < kChainTiles; ++j) {
    b_values<P>(feat, (ng * kChainTiles + j) * 8, lane, raw[j]);
    if constexpr (P == kHighest) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[j][e], fb[j].hi[e], fb[j].lo[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_bf16(raw[j][2 * e], raw[j][2 * e + 1], fb[j].hi[e], fb[j].lo[e]);
    }
  }
  float acc[kChainTiles][2] = {};  // the warp's partial of row g, 2 columns
  float a00 = 0.0f;
  __syncthreads();
  for (int step = 0; step < reps; ++step) {
#pragma unroll
    for (int j = 0; j < kChainTiles; ++j) flip_b<P>(fb[j], raw[j], a00);
    float c[kChainTiles][4] = {};
#pragma unroll 2
    for (int mt = mg; mt < n_mt; mt += kChainMGroups)
      chain_mma<P>(c, chain_a<P, kRaw>(a_s, mt, lane), fb);
#pragma unroll
    for (int j = 0; j < kChainTiles; ++j) {
      acc[j][0] += c[j][0] + c[j][2];  // rows g and g + 8 both fold into g
      acc[j][1] += c[j][1] + c[j][3];
    }
    // only acc[0, 0] crosses warps: one slot per m-group, one barrier
    const int buf = step & 1;
    if (ng == 0 && lane == 0) part_s[buf][mg] = acc[0][0];
    __syncthreads();
    a00 = part_s[buf][0];
#pragma unroll
    for (int k = 1; k < kChainMGroups; ++k) a00 += part_s[buf][k];
    if (tid == 0 && trace != nullptr) trace[step] = a00;
  }
  // the m-groups' partials, summed once in the order of a00's
  if (mg > 0) {
#pragma unroll
    for (int j = 0; j < kChainTiles; ++j) {
      const int n = (ng * kChainTiles + j) * 8 + 2 * q;
      red_s[mg - 1][g][n] = acc[j][0];
      red_s[mg - 1][g][n + 1] = acc[j][1];
    }
  }
  __syncthreads();
  if (mg == 0) {
#pragma unroll
    for (int j = 0; j < kChainTiles; ++j) {
      const int n = (ng * kChainTiles + j) * 8 + 2 * q;
      float s0 = acc[j][0], s1 = acc[j][1];
#pragma unroll
      for (int k = 0; k < kChainMGroups - 1; ++k) {
        s0 += red_s[k][g][n];
        s1 += red_s[k][g][n + 1];
      }
      out[g * kRays + n] = s0;
      out[g * kRays + n + 1] = s1;
    }
  }
}

// T2 -------------------------------------------------------------------

enum Variant { kA = 0, kB = 1, kC = 2, kD = 3 };

// glaze_tpu/accel/traverse_pallas.py _safe_inv: every |d| < 1e-20 -> +1e20
__device__ __forceinline__ float pallas_inv(float d) {
  return fabsf(d) < 1e-20f ? 1e20f : 1.0f / d;
}

// A ray of the walk: its origin and the reciprocal of its direction (the
// slab test); the direction itself is read where a leaf test needs it.
struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
};

struct PRay {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ SlabRay slab_ray(const PRay& r) {
  return SlabRay{r.ox, r.oy, r.oz, pallas_inv(r.dx), pallas_inv(r.dy),
                 pallas_inv(r.dz)};
}

// _slab with t_cap = inf: a = bmin.xyz, bmax.x; b = bmax.yz, meta, skip
__device__ __forceinline__ bool slab_nocap(const float4 a, const float4 b,
                                           const SlabRay& r) {
  const float t0x = (a.x - r.ox) * r.ix;
  const float t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy;
  const float t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz;
  const float t1z = (b.y - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return (tn <= tf) && (tf >= kTMin) && (tn <= INFINITY);
}

// _tri_hit_rows: Moller-Trumbore against one triangle's tri8 row (v0, e1,
// e2 in the first 9 floats of its three float4).
__device__ __forceinline__ bool mt_hit(const float4 a, const float4 b,
                                       const float4 c, const PRay& r,
                                       float& t) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kTMin);
}

struct WalkArgs {
  const float* nodes16;
  const float* tri8;
  int n_nodes;
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  int n_rays;
  float zero;  // 0.0f, from the caller: keeps D's slab tests alive
  float* t_out;
  int* iters_out;
};

__device__ __forceinline__ PRay load_ray(const WalkArgs& p, int i) {
  return PRay{__ldg(p.ox + i), __ldg(p.oy + i), __ldg(p.oz + i),
              __ldg(p.dx + i), __ldg(p.dy + i), __ldg(p.dz + i)};
}

constexpr int kWalkThreads = 256;                // a block at either packet
constexpr int kWalkPer = 2048 / kWalkThreads;    // rays a thread, packet 2048
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kWarpRays = 32 * kWalkPer;         // list segment of a warp

// Variant A's leaf lists of a 2048-ray packet, double-buffered by the
// parity of the iteration (iteration i writes buffer i & 1 before its
// barrier and reads it after; i + 1 writes the other; i + 2 writes it again
// only after barrier i + 1, when every read of i is done): the in-packet
// rays that hit the leaf box, in one segment per warp, each warp's count,
// and the leaf's tri8 row. acc holds each ray's sum for the whole walk.
struct LeafLists {
  float acc[2048];
  uint16_t list[2][2048];
  int count[2][kWalkWarps];
  float4 tri[2][24];
};
struct NoLists {};

// Variant A, packet 2048, at a leaf: threads 0-23 stage the leaf's tri8
// row (tri: their float4, loaded before the slab tests), the rays whose
// leaf-box test passed (bits of hit, slot j = ray tid + 256 j) are listed,
// and the barrier that carries the packet's vote publishes the lists. The
// block's threads each take one listed ray and run its 8 tests in order k
// = 0..7 against the staged row, adding each hit's t to the ray's sum
// (adding only the hits leaves the sum of the plain walk's t-or-0 terms
// bit for bit: x + 0 = x for the sums, which start at +0 and add t >
// 1e-4). Returns the vote.
__device__ __forceinline__ bool leaf_lists(LeafLists& L, const WalkArgs& p,
                                           int base, const float4 tri, int par,
                                           unsigned hit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 24) L.tri[par][tid] = tri;
  const int n = __popc(hit);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int pos = warp * kWarpRays + incl - n;
#pragma unroll
  for (int j = 0; j < kWalkPer; ++j)
    if ((hit >> j) & 1u) L.list[par][pos++] = tid + kWalkThreads * j;
  if (lane == 31) L.count[par][warp] = incl;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWalkWarps; ++w) total += L.count[par][w];
  for (int e = tid; e < total; e += kWalkThreads) {
    int w = 0, off = e;
    while (off >= L.count[par][w]) off -= L.count[par][w++];
    const int ray = L.list[par][w * kWarpRays + off];
    const PRay r = load_ray(p, base + ray);
    float s = L.acc[ray];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4* row = L.tri[par] + 3 * k;
      float t;
      if (mt_hit(row[0], row[1], row[2], r, t)) s = s + t;
    }
    L.acc[ray] = s;
  }
  return total != 0;
}

// The position of the set bit of m with n set bits below it (n below m's
// count of set bits): a search over halves, the same 5 steps on every lane.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(m & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// Variant A, packet 32, at a leaf: the (hitting ray, triangle) pairs are
// spread over the warp, four rays a round (lane: ray 4 round + lane / 8 of
// the hitting rays, triangle lane % 8); each ray's owner lane then takes
// its 8 values by shuffles in order k = 0..7 and adds them (a miss adds
// +0, as in the plain walk).
__device__ __forceinline__ float leaf_pairs(const WalkArgs& p, int first,
                                            unsigned vote, const PRay& mine,
                                            float acc) {
  const int lane = threadIdx.x & 31, k = lane & 7;
  const float4* row = reinterpret_cast<const float4*>(p.tri8) + 4 * (first + k);
  const float4 ta = __ldg(row), tb = __ldg(row + 1), tc = __ldg(row + 2);
  const int n_hit = __popc(vote);
  const bool owner = (vote >> lane) & 1u;
  const int rank = __popc(vote & ((1u << lane) - 1u));
  for (int round = 0; 4 * round < n_hit; ++round) {
    const int i = 4 * round + (lane >> 3);  // the hitting ray of my pair
    const int src = nth_bit(vote, i);
    const PRay r{__shfl_sync(kFull, mine.ox, src),
                 __shfl_sync(kFull, mine.oy, src),
                 __shfl_sync(kFull, mine.oz, src),
                 __shfl_sync(kFull, mine.dx, src),
                 __shfl_sync(kFull, mine.dy, src),
                 __shfl_sync(kFull, mine.dz, src)};
    float t;
    const bool h = i < n_hit && mt_hit(ta, tb, tc, r, t);
    const float v = h ? t : 0.0f;
    const bool take = owner && (rank >> 2) == round;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float x = __shfl_sync(kFull, v, ((rank & 3) << 3) | kk);
      if (take) acc = acc + x;
    }
  }
  return acc;
}

// Packet 2048: one block of 256 threads, 8 rays each (up to 128
// registers, so two or more packets are resident on an SM), the vote by
// __syncthreads_or (A's leaves: by the lists' barrier); the rows of both
// successors (p + 1, skip[p]) are loaded as soon as row p arrives, so the
// next iteration's row does not wait on the vote. Packet 32: one warp of a
// 256-thread block, the vote by ballot, the next row loaded after it: an
// SM holds dozens of such packets, whose loads overlap one another's work,
// and the two extra rows cost them registers and load slots (in a scratch
// comparison on the card they slowed C at packet 32 and sped it at 2048).
template <int V, int kPacket>
__global__ void __launch_bounds__(kWalkThreads, kPacket == 2048 ? 2 : 1)
walk_overhead_kernel(const WalkArgs p) {
  constexpr bool kBig = kPacket == 2048;
  constexpr int kPer = kBig ? kWalkPer : 1;
  __shared__ std::conditional_t<V == kA && kBig, LeafLists, NoLists> sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int packet = kBig ? blockIdx.x : (blockIdx.x * kWalkThreads + tid) >> 5;
  if (packet * kPacket >= p.n_rays) return;  // whole packets only
  const int base = packet * kPacket;
  SlabRay r[kPer];
  PRay mine{};  // A, packet 32: the lane's ray, for the leaf pairs
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const PRay q = load_ray(p, base + (kBig ? tid + kWalkThreads * j : lane));
    r[j] = slab_ray(q);
    if constexpr (V == kA && !kBig) mine = q;
    if constexpr (V == kA && kBig) sh.acc[tid + kWalkThreads * j] = 0.0f;
  }
  const float4* nodes = reinterpret_cast<const float4*>(p.nodes16);  // octant 0
  const unsigned last = p.n_nodes - 1;
  int ptr = 0, iters = 0;
  float4 a = __ldg(nodes), b = __ldg(nodes + 1);
  float leaves = 0.0f;  // B: leaves entered, the same for every ray
  float acc = 0.0f;     // A, packet 32: the lane's sum
  float hits = 0.0f;    // D
  while (ptr < p.n_nodes) {
    ++iters;
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    const bool is_leaf = meta >= 0;
    float4 a1, b1, a2, b2;  // packet 2048: rows p + 1 and skip[p]
    if constexpr (kBig) {
      const unsigned n1 = min(static_cast<unsigned>(ptr) + 1u, last);
      const unsigned n2 = min(static_cast<unsigned>(skip), last);
      a1 = __ldg(nodes + 2 * n1);
      b1 = __ldg(nodes + 2 * n1 + 1);
      a2 = __ldg(nodes + 2 * n2);
      b2 = __ldg(nodes + 2 * n2 + 1);
    }
    const int first = (meta >> 3) & ~7;  // the leaf's whole tri8 row
    float4 tri{};  // A, packet 2048: float4 tid % 3 of triangle tid / 3
    if constexpr (V == kA && kBig) {
      if (is_leaf && tid < 24)
        tri = __ldg(reinterpret_cast<const float4*>(p.tri8) +
                    4 * (first + tid / 3) + tid % 3);
    }
    unsigned hit = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) hit |= unsigned(slab_nocap(a, b, r[j])) << j;
    bool down;
    if constexpr (V == kD) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) hits += ((hit >> j) & 1u) ? 1.0f : 0.0f;
      down = ptr % 3 != 2 && !is_leaf;
    } else {
      bool any;
      if constexpr (!kBig) {
        const unsigned vote = __ballot_sync(kFull, hit != 0);
        any = vote != 0;
        if constexpr (V == kA) {
          if (any && is_leaf) acc = leaf_pairs(p, first, vote, mine, acc);
        }
      } else if constexpr (V == kA) {
        any = is_leaf ? leaf_lists(sh, p, base, tri, iters & 1, hit)
                      : __syncthreads_or(hit != 0) != 0;
      } else {
        any = __syncthreads_or(hit != 0) != 0;
      }
      if constexpr (V == kB) {
        if (any && is_leaf) leaves = leaves + 1.0f;
      }
      down = any && !is_leaf;
    }
    ptr = down ? ptr + 1 : skip;
    if constexpr (kBig) {
      a = down ? a1 : a2;
      b = down ? b1 : b2;
    } else if (ptr < p.n_nodes) {
      a = __ldg(nodes + 2 * ptr);
      b = __ldg(nodes + 2 * ptr + 1);
    }
  }
  if constexpr (V == kA && kBig) __syncthreads();  // the last leaf's sums
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int ray = kBig ? tid + kWalkThreads * j : lane;
    float t = 0.0f;
    if constexpr (V == kA && kBig) t = sh.acc[ray];
    if constexpr (V == kA && !kBig) t = acc;
    if constexpr (V == kB) t = leaves;
    if constexpr (V == kD) t = 0.0f + hits * p.zero;
    p.t_out[base + ray] = t;
  }
  if ((kBig ? tid : lane) == 0) p.iters_out[packet] = iters;
}

// T4 -------------------------------------------------------------------

constexpr int kSlabThreads = 256;
constexpr int kNodeRows = 64;
constexpr int kLanes = 128;

__device__ __forceinline__ void load_nodes(const float* __restrict__ nodes,
                                           float* nodes_s) {
  for (int i = threadIdx.x; i < kNodeRows * kLanes; i += blockDim.x)
    nodes_s[i] = __ldg(nodes + i);
  __syncthreads();
}

__global__ void __launch_bounds__(kSlabThreads)
slab_rate_f32(const float* __restrict__ o, const float* __restrict__ in,
              const float* __restrict__ nodes, int n, int iters, float one,
              float* __restrict__ out) {
  __shared__ float nodes_s[kNodeRows * kLanes];
  load_nodes(nodes, nodes_s);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int lane = e % kLanes;
  const float ox = o[e], ix = in[e];
  float t_cap = ox * one, acc = 0.0f;
  for (int k = 0; k < iters; ++k) {
    const float b = nodes_s[(k % kNodeRows) * kLanes + lane];
    const float t0x = (b - ox) * ix;
    const float t1x = (b + ox) * ix;
    const float t0y = (b - ox * one) * ix;
    const float t1y = (b + ox * one) * ix;
    const float t0z = (b - ix) * ox;
    const float t1z = (b + ix) * ox;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
    const bool hit = (tn <= tf) && (tf >= 0.0f);
    acc = acc + (hit ? 1.0f : 0.0f);
    t_cap = hit ? fminf(t_cap, tf) : t_cap;
  }
  out[e] = acc + t_cap;
}

// bf16: the node rows live in shared memory as packed bf16, converted once
// per block: lane pair p's 64 rows at words p * kNodeStride .. + 63, the
// stride padded so that the eight lanes of a 16-byte load phase hit
// distinct banks; one 16-byte load brings four rows.
constexpr int kPairs = kLanes / 2;
constexpr int kNodeStride = kNodeRows + 4;
constexpr uint32_t kBf16Ones = 0x3F803F80u;  // bf16 1.0 in both halves

template <int kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}

struct SlabPair {
  __nv_bfloat162 ox, ix, oxo, zero, acc, t_cap;
};

// One slab test of a pair against the packed node row ``node``. The
// compares are lane masks (0xFFFF a true half); one LOP3 turns both into
// the count's 1.0 (a & b & ones) and one into the capped t's operand
// (tf | ~(a & b)): a missing half is all ones, a NaN, and min() returns
// the other operand, t_cap. Same operations and order as the plain loop.
__device__ __forceinline__ void slab_test_bf16(SlabPair& s, uint32_t node) {
  const __nv_bfloat162 b = from_bits(node);
  const __nv_bfloat162 t0x = __hmul2(__hsub2(b, s.ox), s.ix);
  const __nv_bfloat162 t1x = __hmul2(__hadd2(b, s.ox), s.ix);
  const __nv_bfloat162 t0y = __hmul2(__hsub2(b, s.oxo), s.ix);
  const __nv_bfloat162 t1y = __hmul2(__hadd2(b, s.oxo), s.ix);
  const __nv_bfloat162 t0z = __hmul2(__hsub2(b, s.ix), s.ox);
  const __nv_bfloat162 t1z = __hmul2(__hadd2(b, s.ix), s.ox);
  const __nv_bfloat162 tn = __hmax2(
      __hmax2(__hmin2(t0x, t1x), __hmin2(t0y, t1y)), __hmin2(t0z, t1z));
  const __nv_bfloat162 tf = __hmin2(
      __hmin2(__hmax2(t0x, t1x), __hmax2(t0y, t1y)), __hmax2(t0z, t1z));
  const uint32_t near = __hle2_mask(tn, tf);
  const uint32_t ahead = __hge2_mask(tf, s.zero);
  s.acc = __hadd2(s.acc, from_bits(lop3<0x80>(near, ahead, kBf16Ones)));
  s.t_cap = __hmin2(s.t_cap, from_bits(lop3<0xF7>(bits(tf), near, ahead)));
}

__global__ void __launch_bounds__(kSlabThreads)
slab_rate_bf16(const __nv_bfloat162* __restrict__ o,
               const __nv_bfloat162* __restrict__ in,
               const float* __restrict__ nodes, int n2, int iters, float one_f,
               __nv_bfloat162* __restrict__ out) {
  __shared__ __align__(16) uint32_t nodes_s[kPairs * kNodeStride];
  for (int i = threadIdx.x; i < kNodeRows * kPairs; i += blockDim.x) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(nodes) + i);
    nodes_s[(i % kPairs) * kNodeStride + i / kPairs] =
        bits(__floats2bfloat162_rn(v.x, v.y));
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // element pair
  if (e >= n2) return;
  const uint32_t* row = nodes_s + (e % kPairs) * kNodeStride;
  const __nv_bfloat162 one = __float2bfloat162_rn(one_f);
  SlabPair s;
  s.zero = __float2bfloat162_rn(0.0f);
  s.ox = o[e];
  s.ix = in[e];
  s.oxo = __hmul2(s.ox, one);
  s.t_cap = __hmul2(s.ox, one);
  s.acc = s.zero;
  int k = 0;
  for (; k + 16 <= iters; k += 16) {  // rows k % 64 .. + 15
    const uint4* q =
        reinterpret_cast<const uint4*>(row + (k & (kNodeRows - 1)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 w = q[j];
      slab_test_bf16(s, w.x);
      slab_test_bf16(s, w.y);
      slab_test_bf16(s, w.z);
      slab_test_bf16(s, w.w);
    }
  }
  for (; k < iters; ++k) slab_test_bf16(s, row[k & (kNodeRows - 1)]);
  out[e] = __hadd2(s.acc, s.t_cap);
}

// ----------------------------------------------------------------------

// Launches kernel<<<blocks, threads, smem, stream>>>(args...), first
// allowing dynamic shared memory above the 48 KB default where needed.
template <class Kernel, class... Args>
int launch(Kernel kernel, int blocks, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of drain_kernel at leaf size T: slab and features.
size_t drain_smem(int T) {
  return sizeof(float) * (kF * (4 * T + 8) + kF * kLd);
}

template <int P, bool kCarry>
int launch_drain(const DrainArgs& a, int n_rays, cudaStream_t s) {
  return launch(drain_kernel<P, kCarry>, n_rays / kRays, kThreads,
                drain_smem(a.T), s, a);
}

// Static shared memory of dot_chain_kernel: the acc[0, 0] slots and the
// buffer of the final reduction across m-groups.
constexpr size_t kChainStatic =
    sizeof(float) * (2 * kChainMGroups + (kChainMGroups - 1) * 8 * kRays);

// Whether the chain at width w keeps each fragment's 8 f32 values and
// splits them per step: only 3xTF32 above W = 1024 (its hi and lo words
// would take 256 KB at W = 2048).
template <int P>
bool chain_raw(int w) {
  return P == kHighest && chain_smem<P, false>(w) + kChainStatic > kMaxSmem;
}

template <int P>
int launch_chain(const float* mat, int w, const float* feat, int reps,
                 float* out, float* trace, cudaStream_t s) {
  if constexpr (P == kHighest) {
    if (chain_raw<P>(w))
      return launch(dot_chain_kernel<P, true>, 1, kChainThreads,
                    chain_smem<P, true>(w), s, mat, w, feat, reps, out, trace);
  }
  return launch(dot_chain_kernel<P, false>, 1, kChainThreads,
                chain_smem<P, false>(w), s, mat, w, feat, reps, out, trace);
}

template <int V>
int launch_walk(const WalkArgs& a, int packet, cudaStream_t s) {
  if (packet == 2048)
    return launch(walk_overhead_kernel<V, 2048>, a.n_rays / 2048,
                  kWalkThreads, 0, s, a);
  return launch(walk_overhead_kernel<V, 32>,
                (a.n_rays + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                s, a);
}

// The kernels glaze_probe_kernel_attrs reports on, in its order, each with
// the threads it is launched with and the dynamic shared memory it is
// launched with at leaf size T: T1 at highest and default and T3b (the
// slab of T); T3a at highest, default and split3 (W = 4T) and the
// instance that splits 3xTF32 fragments per step (W = 16T: 2,048 at T =
// 128, the widest case the tool runs); T2 at variants A-D, packet 2048,
// then packet 32.
struct AttrKernel {
  const void* fn;
  int threads;
  size_t (*smem)(int T);
};

size_t no_smem(int) { return 0; }

template <int V, int kPacket>
AttrKernel walk_attr() {
  return {reinterpret_cast<const void*>(walk_overhead_kernel<V, kPacket>),
          kWalkThreads, no_smem};
}

const AttrKernel kAttrKernels[] = {
    {reinterpret_cast<const void*>(drain_kernel<kHighest, false>), kThreads,
     drain_smem},
    {reinterpret_cast<const void*>(drain_kernel<kDefault, false>), kThreads,
     drain_smem},
    {reinterpret_cast<const void*>(drain_kernel<kHighest, true>), kThreads,
     drain_smem},
    {reinterpret_cast<const void*>(dot_chain_kernel<kHighest, false>),
     kChainThreads, [](int T) { return chain_smem<kHighest, false>(4 * T); }},
    {reinterpret_cast<const void*>(dot_chain_kernel<kDefault, false>),
     kChainThreads, [](int T) { return chain_smem<kDefault, false>(4 * T); }},
    {reinterpret_cast<const void*>(dot_chain_kernel<kSplit3, false>),
     kChainThreads, [](int T) { return chain_smem<kSplit3, false>(4 * T); }},
    {reinterpret_cast<const void*>(dot_chain_kernel<kHighest, true>),
     kChainThreads, [](int T) { return chain_smem<kHighest, true>(16 * T); }},
    walk_attr<kA, 2048>(), walk_attr<kB, 2048>(), walk_attr<kC, 2048>(),
    walk_attr<kD, 2048>(), walk_attr<kA, 32>(),   walk_attr<kB, 32>(),
    walk_attr<kC, 32>(),   walk_attr<kD, 32>()};
constexpr int kAttrCount = sizeof(kAttrKernels) / sizeof(kAttrKernels[0]);

}  // namespace

extern "C" {

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 = ok);
// shapes are checked by the Python wrappers (glaze_tpu_torch/tools/
// probes_cuda.py). prec: 0 highest, 1 default, 2 split3.

int glaze_probe_drain(int prec, int carry, const float* mats, int w, int T,
                      int n_leaves, const float* centres, const int* order,
                      int reps, const float* ox, const float* oy,
                      const float* oz, const float* dx, const float* dy,
                      const float* dz, const float* feat, int n_rays,
                      float t_init, float* t_out, int* tri_out, float* u_out,
                      float* v_out, void* stream) {
  const DrainArgs a{mats, w,  T,  n_leaves, centres, order, reps, ox,
                    oy,   oz, dx, dy,       dz,      feat,  t_init, t_out,
                    u_out, v_out, tri_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (carry) return launch_drain<kHighest, true>(a, n_rays, s);
  if (prec == kHighest) return launch_drain<kHighest, false>(a, n_rays, s);
  return launch_drain<kDefault, false>(a, n_rays, s);
}

int glaze_probe_dot_chain(int prec, const float* mat, int w, const float* feat,
                          int reps, float* out, float* trace, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prec == kHighest)
    return launch_chain<kHighest>(mat, w, feat, reps, out, trace, s);
  if (prec == kDefault)
    return launch_chain<kDefault>(mat, w, feat, reps, out, trace, s);
  return launch_chain<kSplit3>(mat, w, feat, reps, out, trace, s);
}

int glaze_probe_walk(int variant, int packet, const float* nodes16,
                     const float* tri8, int n_nodes, const float* ox,
                     const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, int n_rays, float zero,
                     float* t_out, int* iters_out, void* stream) {
  const WalkArgs a{nodes16, tri8, n_nodes, ox,   oy,    oz,
                   dx,      dy,   dz,      n_rays, zero, t_out, iters_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kA: return launch_walk<kA>(a, packet, s);
    case kB: return launch_walk<kB>(a, packet, s);
    case kC: return launch_walk<kC>(a, packet, s);
    default: return launch_walk<kD>(a, packet, s);
  }
}

int glaze_probe_slab_rate(int bf16, const void* o, const void* in,
                          const float* nodes, int n, int iters, float one,
                          void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int n2 = n / 2;
    return launch(slab_rate_bf16, (n2 + kSlabThreads - 1) / kSlabThreads,
                  kSlabThreads, 0, s, static_cast<const __nv_bfloat162*>(o),
                  static_cast<const __nv_bfloat162*>(in), nodes, n2, iters,
                  one, static_cast<__nv_bfloat162*>(out));
  }
  return launch(slab_rate_f32, (n + kSlabThreads - 1) / kSlabThreads,
                kSlabThreads, 0, s, static_cast<const float*>(o),
                static_cast<const float*>(in), nodes, n, iters, one,
                static_cast<float*>(out));
}

// The number of kernels glaze_probe_kernel_attrs reports on.
int glaze_probe_kernel_count() { return kAttrCount; }

// Of kernel ``which`` (kAttrKernels' order) at leaf size T: registers and
// local (spill) bytes per thread, the threads per block it is launched
// with, its resident blocks per SM with the shared memory of that T, and
// the most threads an SM of the current card holds. Returns a cudaError_t
// (0 = ok).
int glaze_probe_kernel_attrs(int which, int T, int* regs, int* local_bytes,
                             int* threads_per_block, int* blocks_per_sm,
                             int* max_threads_per_sm) {
  if (which < 0 || which >= kAttrCount || T <= 0 || T > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttrKernel& k = kAttrKernels[which];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads_per_block = k.threads;
  const size_t smem = k.smem(T);
  if (smem > 48 * 1024)  // as launch() allows it before such a launch
    err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k.fn,
                                                        k.threads, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_threads_per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  return static_cast<int>(err);
}

const char* glaze_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
