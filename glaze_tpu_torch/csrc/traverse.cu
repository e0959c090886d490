// Stackless skip-link BVH walks for Hopper (sm_90a): closest hit and any
// hit on the classic tree, each with and without the baked 8x8 opacity
// cell masks, and on the fat-leaf tree.
//
// Replaces the TPU kernels of glaze_tpu/accel/traverse_pallas.py:
//   closest_kernel<false> <- _closest_kernel_win (reached through
//                      _closest_call) and its schedule variants
//                      _closest_kernel_ww, _closest_kernel (streamed),
//                      _closest_kernel_sub, _closest_kernel_dual: all
//                      compute the same function.                    (K1)
//   closest_kernel<true>  <- _closest_kernel_win(alpha_mask=True), reached
//                      through _closest_call_masked (mask test :669-708).
//                                                                     (K2)
//   anyhit_kernel<false>  <- _anyhit_kernel_win (reached through
//                      _anyhit_call) and _anyhit_kernel_ww,
//                      _anyhit_kernel, _anyhit_kernel_sub.           (K3)
//   anyhit_kernel<true>   <- _anyhit_kernel_win(alpha_mask=True), reached
//                      through _anyhit_call_masked (:875-906).       (K4)
// and of glaze_tpu/accel/traverse_fat.py:
//   closest_kernel_fat    <- _closest_kernel_fat (:352, body
//                      _walk_and_drain :87), reached through
//                      _closest_call_fat (:404).                    (K7c)
//   anyhit_kernel_fat     <- _anyhit_kernel_fat (:366), reached through
//                      _anyhit_call_fat (:434).                     (K7a)
// The Pallas kernels walk one tree pointer per 128-ray row and queue leaf
// work, because the TPU's VPU only runs dense (8, 128) tiles, and the fat
// kernels drain a queued leaf as one MXU product. None of that carries
// over: here ONE THREAD WALKS ONE RAY through one octant walk and one
// slab test, and all six kernels walk through walk_postponed<Drain>
// (below), each with its own leaf test in the drain; the four classic
// kernels also share one Moller-Trumbore.
//
// Every walk was first written as a per-lane walk, each lane running its
// own leaf loop where it met a leaf; it spent most of its time at leaves
// with few lanes active. The lanes of a warp reach their leaves at
// different node steps of their own walks, so the warp ran one leaf loop
// (up to 8 triangles, or the fat kernels' T = 128 columns) for every
// distinct moment at which some lane entered a leaf, mostly with one or a
// few lanes active while the lanes still walking interior nodes, or
// already finished, idled. In walk_postponed a lane that enters a leaf
// PARKS there and the warp drains only when every lane is parked or
// finished (__ballot_sync over all 32 lanes; a lane with no ray, or an
// inactive one, is a finished lane, so the ragged last warp votes too): a
// warp runs about as many drains as its busiest lane has leaves. No lane
// passes an untested leaf, so each ray still tests its leaves in its own
// order with the cap the earlier ones left it (a closest walk's t_best,
// an any-hit walk's fixed tmax), and every result, exact-t ties included,
// is the one the per-lane loop gave. K1/K2 and K3/K4 drain each parked
// lane's own leaf loop, now with every parked lane active at once; an
// any-hit lane that is blocked leaves the walk as a finished lane. The fat
// kernels' drains split the leaves' columns across the lanes: with g
// parked lanes, each takes a subgroup of w = 32 / g' lanes (g' the next
// power of two >= g) that scans every w-th column of its leaf; K7c's
// butterfly keeps the least t and, on a tie, the lowest column, and K7a's
// ballot ORs the subgroup's hits; so even one parked lane keeps all 32
// lanes busy. After each drain the warp reconverges (__syncwarp), so the
// walk to the next leaves runs with every lane at once.
//
// Function (identical to glaze_tpu_torch.accel.bvh.closest_hit / any_hit
// and closest_hit_masked / any_hit_masked, the plain versions):
//   * each ray picks its direction octant o = (dx>=0) + 2(dy>=0) + 4(dz>=0)
//     and walks that octant's depth-first node order in nodes16 (node i of
//     octant o at float offset (o*M16*16 + i)*8: bmin.xyz, bmax.xyz, meta
//     and skip as int bits). A box hit goes to node p+1 (a leaf to its
//     skip link after testing it), a miss to skip; p >= n_nodes ends.
//   * a leaf holds count = (meta&7)+1 triangles from first = meta>>3;
//     triangle k sits at float offset k*16 of tri8 as v0, e1, e2, then
//     (masked trees) four int32 payload words at floats 9..12.
//   * Moller-Trumbore with |det| >= 1e-12 and t > 1e-4. Closest hit keeps a
//     hit only when t < t_best (t_best starts at tmax); any hit stops at
//     the first t in (t_min, tmax); inactive rays report false.
//   * masked: an accepted hit reads the 2-bit code of its barycentric cell
//     cu = min((int)(u*8), 7), cv = min((int)(v*8), 7), cell = cv*8 + cu,
//     word cell>>4, shift (cell&15)*2 (the layout of
//     scene/flatten.py _classify_alpha_cells). Closest: code 2
//     (TRANSPARENT) drops the hit, which never shrinks t_best; mixed =
//     the kept hit's code is 0 (MIXED). Any hit: code 1 (OPAQUE) blocks
//     and stops the ray, code 0 sets pending and the walk goes on, code 2
//     is ignored; pending is reported only where not blocked.
//   * reciprocal direction: |d| < 1e-20 maps to 1e20*sign(d) and an exact
//     0 to +1e20 -- the XLA walker's rule (glaze_tpu/accel/bvh.py:654-658),
//     which the plain version shares. (The Pallas kernels use +1e20 for
//     every tiny component; only exactly axis-parallel rays can differ.)
//   * built with --fmad=false and sums taken as x + y + z, so t/u/v are
//     bit-identical to the plain torch version for the same triangle. Rays
//     whose closest t ties exactly between two triangles may report either
//     one (and, masked, either one's mixed flag): the octant order
//     decides, as on the TPU.
//
// What bounds it on an H100: not bytes and not float operations. Each step
// is a dependent gather (node row, then triangle rows) whose address comes
// from the previous step, and the 32 rays of a warp diverge in both path
// length and position in the tree. So the kernel is bound by memory
// LATENCY and warp divergence. The design answers with what is cheap and
// simple: both tables (about 20 MB each at 262k triangles) stay in the
// 50 MB L2 and are read through the read-only path (__ldg) as 16-byte
// float4 loads, a node is two loads and a triangle three; rays are
// Morton-sorted by the caller, so neighbouring threads walk similar paths;
// and many warps per SM hide the latency of each one. The masks add the
// same latency and divergence plus, per ACCEPTED hit only, the cell
// decode and at most one 4-byte load: words 0..2 arrive with the third
// float4 that Moller-Trumbore already loads, and word 3 (cells 48..63) is
// read only when the cell needs it, so a miss costs exactly what it costs
// unmasked. Shared-memory treelets, warp-cooperative packets and wider
// trees are later work.
//
// The fat-leaf kernels (identical to glaze_tpu_torch.accel.fat
// closest_hit_fat / any_hit_fat, the plain versions):
//   * the same octant walk; a leaf's meta is its LEAF INDEX L, and its T
//     triangle slots are L*T .. L*T+T-1 (padding slots have all-zero
//     coefficients: det 0, never valid).
//   * features of the ray, built once in registers: o x d = (oy*dz -
//     oz*dy, oz*dx - ox*dz, ox*dy - oy*dx), then o, d, 1.
//   * column k of a leaf: det, u*det, v*det and t*det are the products of
//     the features with the slab's column k in blocks 0..3. Only 19 of
//     the 64 slab entries can be non-zero (det: rows 6..8; u and v: rows
//     0..2 and 6..8; t: rows 3..5 and 9); the caller gathers them per slot
//     into a (L*T, 20) table (five float4 loads a column), and each block
//     is summed in ascending row order, one multiply then one add per
//     term. ok = |det| >= 1e-12, inv = 1/det, t = td*inv; the inside test
//     is ud*det >= 0, vd*det >= 0, (ud+vd)*det <= det*det (the Pallas
//     resolve, traverse_fat.py:145-149).
//   * closest: a column replaces the best when 1e-4 < t < t_best; scanning
//     k = 0..T-1 with a strict < keeps the lowest column of a tie in t, the
//     Pallas kernel's rule (:162-165); u = ud*inv, v = vd*inv. Any hit: the
//     first column with t_min < t < tmax stops the ray; inactive rays
//     report false.
//
// What bounds the fat kernels on an H100: a leaf costs T = 128 columns of
// about 48 float operations (34 for the four sums, the rest for the
// resolve), so a ray that enters ~5 leaves needs ~30,000 operations where
// the classic walk needs a few thousand; the float32 rate bounds them
// (about 1 ms for a 1080p launch), not bytes: the coefficient table (30
// MB on the benchmark scene) fits the 50 MB L2, where the (16, 4T) slabs
// (96.5 MB) would not, and the neighbouring rays of a Morton-sorted warp
// mostly read the same leaf, so one load serves the warp. Dependent node
// loads and divergence between rays in different leaves remain. No tensor
// cores: TF32 keeps about 10 mantissa bits, which loses hits the way the
// JAX package's DEFAULT matmul precision does (traverse_fat.py:59-67); a
// 3xTF32 or mma leaf test is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTMin = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) < 1e-20f) return d == 0.0f ? 1e20f : copysignf(1e20f, d);
  return 1.0f / d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ bool slab(const float4 a, const float4 b,
                                     const Ray& r, float cap) {
  // a = bmin.x, bmin.y, bmin.z, bmax.x ; b = bmax.y, bmax.z, meta, skip
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
  return (tn <= tf) && (tf >= kTMin) && (tn <= cap);
}

// Moller-Trumbore against triangle k of tri8; returns hit, writes t/u/v
// and the row's third float4 c (c.yzw are payload words 0..2).
__device__ __forceinline__ bool tri_hit(const float4* __restrict__ tri8,
                                        int k, const Ray& r, float& t,
                                        float& u, float& v, float4& c) {
  const float4 a = __ldg(tri8 + 4 * (size_t)k);      // v0.xyz, e1.x
  const float4 b = __ldg(tri8 + 4 * (size_t)k + 1);  // e1.yz, e2.xy
  c = __ldg(tri8 + 4 * (size_t)k + 2);               // e2.z, payload 0..2
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) >= 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - v0x;
  const float tvy = r.oy - v0y;
  const float tvz = r.oz - v0z;
  u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kTMin);
}

// 2-bit opacity code of the cell at (u, v) of triangle k, for an ACCEPTED
// hit only (u, v in [0, 1], so the float->int casts are defined). Words
// 0..2 come from c; word 3 (payload float 12) is loaded here if needed.
__device__ __forceinline__ int cell_code(const float* __restrict__ tri8,
                                         int k, const float4& c, float u,
                                         float v) {
  const int cu = min(static_cast<int>(u * 8.0f), 7);
  const int cv = min(static_cast<int>(v * 8.0f), 7);
  const int cell = cv * 8 + cu;
  const int word = cell >> 4;
  int w;
  if (word == 0) {
    w = __float_as_int(c.y);
  } else if (word == 1) {
    w = __float_as_int(c.z);
  } else if (word == 2) {
    w = __float_as_int(c.w);
  } else {
    w = __ldg(reinterpret_cast<const int*>(tri8) + 16 * (size_t)k + 12);
  }
  return (w >> ((cell & 15) * 2)) & 3;
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

__device__ __forceinline__ const float4* octant_nodes(const float* nodes16,
                                                      const Ray& r,
                                                      long long oct_floats) {
  const int oct = (r.dx >= 0.0f) + 2 * (r.dy >= 0.0f) + 4 * (r.dz >= 0.0f);
  return reinterpret_cast<const float4*>(nodes16 + oct * oct_floats);
}

// One lane's place in its walk: node p of its octant slab, and the leaf
// it is parked at (-1: none).
struct Walker {
  int p;
  int leaf;
};

// The octant walk of every kernel, from w.p: a node whose box the ray
// enters within cap leads to node p+1, or, for a leaf, to the skip link
// after the leaf is tested; a miss leads to the skip link; p >= n_nodes
// ends (the lane is finished). At a leaf the lane PARKS: w.leaf is the
// leaf's meta and w.p its skip link, the node after it. The lane goes no
// further until the leaf is tested, so each ray tests its leaves in its
// own order, each with the cap that the earlier ones left it.
__device__ __forceinline__ void walk_to_leaf(const float4* __restrict__ nodes,
                                             int n_nodes, const Ray& r,
                                             float cap, Walker& w) {
  while (w.p < n_nodes) {
    const float4 a = __ldg(nodes + 2 * w.p);
    const float4 b = __ldg(nodes + 2 * w.p + 1);
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    if (!slab(a, b, r, cap)) {
      w.p = skip;
    } else if (meta < 0) {
      w.p = w.p + 1;
    } else {
      w.leaf = meta;
      w.p = skip;
      return;
    }
  }
}

// The best hit of a closest walk so far.
struct Best {
  float t, u, v;
  int tri;
  bool mix;
};

// Tests the leaf ``meta`` of the classic tree against one ray:
// Moller-Trumbore on each of its triangles in order; a hit replaces the
// best when t < best.t and, masked, its cell is not TRANSPARENT (code 2);
// mix = the kept hit's cell is MIXED (code 0).
template <bool kMasked>
__device__ __forceinline__ void classic_leaf(const float* __restrict__ tri8,
                                             int meta, const Ray& r,
                                             Best& best) {
  const float4* tris = reinterpret_cast<const float4*>(tri8);
  const int first = meta >> 3;
  const int count = (meta & 7) + 1;
  for (int k = 0; k < count; ++k) {
    float t, u, v;
    float4 c;
    if (tri_hit(tris, first + k, r, t, u, v, c) && t < best.t) {
      if constexpr (kMasked) {
        const int code = cell_code(tri8, first + k, c, u, v);
        if (code == 2) continue;  // TRANSPARENT cell: skip the hit
        best.mix = code == 0;
      }
      best.t = t;
      best.tri = first + k;
      best.u = u;
      best.v = v;
    }
  }
}

// One lane of a warp-synchronous walk: its ray, its octant's node slab
// and its place in the walk.
struct Lane {
  Ray r;
  const float4* nodes;
  Walker w;
};

// Starts ray i on the lane, with the walk at the root of its octant's
// slab; a lane that is not ``live`` (no ray, or an inactive one) starts
// finished and holds ray 0, which it never tests.
__device__ __forceinline__ void start_lane(Lane& s, int i, bool live,
                                           int n_nodes, const float* nodes16,
                                           long long oct_floats,
                                           const float* ox, const float* oy,
                                           const float* oz, const float* dx,
                                           const float* dy, const float* dz) {
  s.r = load_ray(ox, oy, oz, dx, dy, dz, live ? i : 0);
  s.nodes = octant_nodes(nodes16, s.r, oct_floats);
  s.w.p = live ? 0 : n_nodes;
  s.w.leaf = -1;
}

// One lane of a closest walk: a Lane and its best hit so far.
struct ClosestLane : Lane {
  Best best;
};

// Starts ray i (the output's index) on the lane: its cap, and the walk at
// the root of its octant's slab; no ray (i >= n_rays) leaves the lane
// finished.
__device__ __forceinline__ void start_ray(ClosestLane& s, int i, int n_rays,
                                          int n_nodes, const float* nodes16,
                                          long long oct_floats,
                                          const float* ox, const float* oy,
                                          const float* oz, const float* dx,
                                          const float* dy, const float* dz,
                                          const float* tmax) {
  const bool live = i < n_rays;
  start_lane(s, i, live, n_nodes, nodes16, oct_floats, ox, oy, oz, dx, dy,
             dz);
  s.best.t = live ? tmax[i] : 0.0f;
  s.best.u = 0.0f;
  s.best.v = 0.0f;
  s.best.tri = -1;
  s.best.mix = false;
}

template <bool kMasked>
__device__ __forceinline__ void store_hit(const Best& b, int i,
                                          float* __restrict__ t_out,
                                          int* __restrict__ tri_out,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out,
                                          uint8_t* __restrict__ mixed_out) {
  t_out[i] = b.tri >= 0 ? b.t : INFINITY;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  if constexpr (kMasked) mixed_out[i] = b.tri >= 0 && b.mix;
}

// The warp-synchronous walk with postponed leaves, of every kernel. Every
// lane of the warp calls it (a lane with no ray, or an inactive one,
// starts finished: w.p = n_nodes), and each lane walks its own ray to its
// next leaf under its cap: a closest walk passes its best t, which the
// drains shrink, an any-hit walk its fixed tmax. When every lane is parked
// or finished, the warp drains: drain(parked) runs on all 32 lanes with
// the ballot of the parked ones and tests their leaves together, updating
// each owner's best (and so its cap), or, in an any-hit walk, finishing
// each owner that is blocked (w.p = n_nodes). Then the parked lanes go on
// from their skip links. A warp thus runs one drain per leaf of its
// busiest lane, where the per-lane walk ran one leaf loop per distinct
// moment at which some lane entered a leaf, mostly with one lane active.
// The walk ends when no lane parks. The __syncwarp after the drain is what makes
// the next walk run with all 32 lanes: without it the compiler need not
// reconverge the warp there, and lanes that left a drain's leaf loop early
// walk on to their next leaf alone, the rest after them: K1 and K2 ran
// about 1.5x slower that way on an H100 (PERF.md).
template <class Drain>
__device__ __forceinline__ void walk_postponed(Lane& s, int n_nodes,
                                               const float& cap,
                                               Drain&& drain) {
  for (;;) {
    walk_to_leaf(s.nodes, n_nodes, s.r, cap, s.w);
    const unsigned parked = __ballot_sync(kFull, s.w.leaf >= 0);
    if (!parked) return;
    drain(parked);
    s.w.leaf = -1;
    __syncwarp(kFull);
  }
}

// Closest hit on the classic tree (K1, and K2 with kMasked): one lane per
// ray, leaves postponed warp-wide; the drain runs each parked lane's own
// leaf loop, with every parked lane active at once. A lane whose ray has
// ended idles until its warp's longest ray ends.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ nodes16,
               const float* __restrict__ tri8, const float* __restrict__ ox,
               const float* __restrict__ oy, const float* __restrict__ oz,
               const float* __restrict__ dx, const float* __restrict__ dy,
               const float* __restrict__ dz, const float* __restrict__ tmax,
               int n_rays, int n_nodes, long long oct_floats,
               float* __restrict__ t_out, int* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               uint8_t* __restrict__ mixed_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  ClosestLane s;
  start_ray(s, i, n_rays, n_nodes, nodes16, oct_floats, ox, oy, oz, dx, dy,
            dz, tmax);
  walk_postponed(s, n_nodes, s.best.t, [&](unsigned) {
    if (s.w.leaf >= 0) classic_leaf<kMasked>(tri8, s.w.leaf, s.r, s.best);
  });
  if (i < n_rays)
    store_hit<kMasked>(s.best, i, t_out, tri_out, u_out, v_out, mixed_out);
}

// Any hit on the classic tree (K3, and K4 with kMasked): the closest
// walks' postponed walk under the lane's fixed cap; the drain runs each
// parked lane's own leaf loop, with every parked lane active at once, and
// a lane whose ray is blocked leaves the walk finished. Inactive lanes
// and the surplus lanes of the last warp start finished and stay in the
// warp, so every ballot sees all 32 lanes.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
anyhit_kernel(const float* __restrict__ nodes16,
              const float* __restrict__ tri8, const float* __restrict__ ox,
              const float* __restrict__ oy, const float* __restrict__ oz,
              const float* __restrict__ dx, const float* __restrict__ dy,
              const float* __restrict__ dz, const float* __restrict__ tmax,
              const uint8_t* __restrict__ active, int n_rays, int n_nodes,
              long long oct_floats, float t_min,
              uint8_t* __restrict__ hit_out,
              uint8_t* __restrict__ pending_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays && active[i];
  Lane s;
  start_lane(s, i, live, n_nodes, nodes16, oct_floats, ox, oy, oz, dx, dy,
             dz);
  const float cap = live ? tmax[i] : 0.0f;
  const float4* tris = reinterpret_cast<const float4*>(tri8);
  bool hit = false, pending = false;
  walk_postponed(s, n_nodes, cap, [&](unsigned) {
    if (s.w.leaf < 0) return;
    const int first = s.w.leaf >> 3;
    const int count = (s.w.leaf & 7) + 1;
    for (int k = 0; k < count; ++k) {
      float t, u, v;
      float4 c;
      if (tri_hit(tris, first + k, s.r, t, u, v, c) && t > t_min && t < cap) {
        if constexpr (kMasked) {
          const int code = cell_code(tri8, first + k, c, u, v);
          if (code == 0) pending = true;  // MIXED: the caller resolves it
          if (code != 1) continue;        // only an OPAQUE cell blocks
        }
        hit = true;
        s.w.p = n_nodes;  // blocked: the lane's walk ends
        return;
      }
    }
  });
  if (i < n_rays) {
    hit_out[i] = hit;
    if constexpr (kMasked) pending_out[i] = pending && !hit;
  }
}

// Features o x d of a ray (o and d are in the Ray itself).
struct Cross {
  float x, y, z;
};

__device__ __forceinline__ Cross ray_cross(const Ray& r) {
  return {r.oy * r.dz - r.oz * r.dy, r.oz * r.dx - r.ox * r.dz,
          r.ox * r.dy - r.oy * r.dx};
}

// Column ``slot`` of a fat leaf: returns whether it is a valid hit with t
// in (lo, hi), writing t, the det-scaled ud/vd and inv = 1/det. The five
// float4 of the slot's coefficient row hold, in order: det rows 6..8; u
// rows 0..2, 6..8; v rows 0..2, 6..8; t rows 3..5, 9; a zero.
__device__ __forceinline__ bool fat_column(const float4* __restrict__ coef,
                                           int slot, const Ray& r,
                                           const Cross& x, float lo, float hi,
                                           float& t, float& ud, float& vd,
                                           float& inv) {
  const float4* row = coef + 5 * (size_t)slot;
  const float4 c0 = __ldg(row), c1 = __ldg(row + 1), c2 = __ldg(row + 2);
  const float4 c3 = __ldg(row + 3), c4 = __ldg(row + 4);
  float det = c0.x * r.dx;
  det = det + c0.y * r.dy;
  det = det + c0.z * r.dz;
  ud = c0.w * x.x;
  ud = ud + c1.x * x.y;
  ud = ud + c1.y * x.z;
  ud = ud + c1.z * r.dx;
  ud = ud + c1.w * r.dy;
  ud = ud + c2.x * r.dz;
  vd = c2.y * x.x;
  vd = vd + c2.z * x.y;
  vd = vd + c2.w * x.z;
  vd = vd + c3.x * r.dx;
  vd = vd + c3.y * r.dy;
  vd = vd + c3.z * r.dz;
  float td = c3.w * r.ox;
  td = td + c4.x * r.oy;
  td = td + c4.y * r.oz;
  td = td + c4.z * 1.0f;
  if (!(fabsf(det) >= 1e-12f)) return false;
  inv = 1.0f / det;
  t = td * inv;
  return ud * det >= 0.0f && vd * det >= 0.0f &&
         (ud + vd) * det <= det * det && t > lo && t < hi;
}

// Position of the (s+1)-th set bit of m (s < popc(m)), by halving.
__device__ __forceinline__ int nth_set_bit(unsigned m, int s) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const unsigned low = m & ((1u << width) - 1u);
    const int c = __popc(low);
    if (s >= c) {
      s -= c;
      m >>= width;
      pos += width;
    } else {
      m = low;
    }
  }
  return pos;
}

// Fat closest hit (K7c): the postponed walk, and a drain that splits each
// parked lane's leaf across a subgroup of lanes. With g parked lanes, g'
// the next power of two >= g and w = 32 / g', the lanes form g' subgroups
// of w; subgroup s serves the parked lane of ballot rank s (its owner),
// whose features, best t and leaf its lanes read by shuffle. Lane r of a
// subgroup tests columns k = r, r + w, ... of the owner's leaf with
// fat_column on (kTMin, its own best so far), keeping its best (t, k) with
// a strict < in ascending k, as the sequential scan does; a butterfly over
// the subgroup then keeps the smaller t and, on an exact tie, the smaller
// k -- the lowest column of a tie, the Pallas kernel's rule (traverse_fat
// .py:162-165). The owner takes the winner's t, slot and its u = ud*inv,
// v = vd*inv, the same operations on the same numbers as the sequential
// scan, so the result is bit for bit the same. w = 1 (g > 16) is one leaf
// per lane; g = 1 gives 32 lanes of T/32 columns each.
__global__ void __launch_bounds__(kThreads)
closest_kernel_fat(const float* __restrict__ nodes16,
                   const float* __restrict__ coef,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tmax, int n_rays, int n_nodes,
                   long long oct_floats, int leaf_size,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int kNone = 0x7fffffff;  // no column found
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  ClosestLane s;
  start_ray(s, i, n_rays, n_nodes, nodes16, oct_floats, ox, oy, oz, dx, dy,
            dz, tmax);
  const Cross x = ray_cross(s.r);
  const float4* cf = reinterpret_cast<const float4*>(coef);
  walk_postponed(s, n_nodes, s.best.t, [&](unsigned parked) {
    const int g = __popc(parked);
    const int w = 32 >> (32 - __clz(g - 1));  // 32 / g', g' = 2^ceil(log2 g)
    const int sub = lane / w;
    const int owner = sub < g ? nth_set_bit(parked, sub) : lane;
    Ray ro;
    ro.ox = __shfl_sync(kFull, s.r.ox, owner);
    ro.oy = __shfl_sync(kFull, s.r.oy, owner);
    ro.oz = __shfl_sync(kFull, s.r.oz, owner);
    ro.dx = __shfl_sync(kFull, s.r.dx, owner);
    ro.dy = __shfl_sync(kFull, s.r.dy, owner);
    ro.dz = __shfl_sync(kFull, s.r.dz, owner);
    Cross xo;
    xo.x = __shfl_sync(kFull, x.x, owner);
    xo.y = __shfl_sync(kFull, x.y, owner);
    xo.z = __shfl_sync(kFull, x.z, owner);
    float bt = __shfl_sync(kFull, s.best.t, owner);
    const int leaf = __shfl_sync(kFull, s.w.leaf, owner);
    int bk = kNone;
    float bu = 0.0f, bv = 0.0f;
    if (sub < g) {
      const int first = leaf * leaf_size;
      for (int k = lane - sub * w; k < leaf_size; k += w) {
        float t, ud, vd, inv;
        if (fat_column(cf, first + k, ro, xo, kTMin, bt, t, ud, vd, inv)) {
          bt = t;
          bk = k;
          bu = ud * inv;
          bv = vd * inv;
        }
      }
    }
    for (int off = w >> 1; off >= 1; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, bt, off);
      const int ok = __shfl_xor_sync(kFull, bk, off);
      if (ot < bt || (ot == bt && ok < bk)) {
        bt = ot;
        bk = ok;
      }
    }
    // each parked lane reads its subgroup's result: t and k from its first
    // lane, u and v from the lane that tested column k
    const bool mine = s.w.leaf >= 0;
    const int head = mine ? __popc(parked & ((1u << lane) - 1u)) * w : lane;
    const float wt = __shfl_sync(kFull, bt, head);
    const int wk = __shfl_sync(kFull, bk, head);
    const int src = head + (wk == kNone ? 0 : wk % w);
    const float wu = __shfl_sync(kFull, bu, src);
    const float wv = __shfl_sync(kFull, bv, src);
    if (mine && wk != kNone) {
      s.best.t = wt;
      s.best.tri = s.w.leaf * leaf_size + wk;
      s.best.u = wu;
      s.best.v = wv;
    }
  });
  if (i < n_rays) store_hit<false>(s.best, i, t_out, tri_out, u_out, v_out,
                                   nullptr);
}

// Fat any hit (K7a): the postponed walk under the lane's fixed cap, and
// K7c's split drain with an OR in place of the (t, column) butterfly. With
// g parked lanes, g' the next power of two >= g and w = 32 / g', subgroup
// s of w lanes serves the parked lane of ballot rank s (its owner), whose
// features, cap and leaf its lanes read by shuffle. Lane r of a subgroup
// tests columns k = r, r + w, ... of the owner's leaf with fat_column on
// (t_min, cap) and stops at its own first hit, with no collective inside
// the scan; then one full-mask ballot gives each owner its subgroup's w
// bits, and an owner with any bit set is blocked and leaves the walk
// finished. Which column hits first does not matter to a flag, so the
// result is the sequential scan's. Inactive lanes and the surplus lanes
// of the last warp start finished and stay in the warp.
__global__ void __launch_bounds__(kThreads)
anyhit_kernel_fat(const float* __restrict__ nodes16,
                  const float* __restrict__ coef,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax,
                  const uint8_t* __restrict__ active, int n_rays,
                  int n_nodes, long long oct_floats, int leaf_size,
                  float t_min, uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n_rays && active[i];
  Lane s;
  start_lane(s, i, live, n_nodes, nodes16, oct_floats, ox, oy, oz, dx, dy,
             dz);
  const float cap = live ? tmax[i] : 0.0f;
  const Cross x = ray_cross(s.r);
  const float4* cf = reinterpret_cast<const float4*>(coef);
  bool hit = false;
  walk_postponed(s, n_nodes, cap, [&](unsigned parked) {
    const int g = __popc(parked);
    const int w = 32 >> (32 - __clz(g - 1));  // 32 / g', g' = 2^ceil(log2 g)
    const int sub = lane / w;
    const int owner = sub < g ? nth_set_bit(parked, sub) : lane;
    Ray ro;
    ro.ox = __shfl_sync(kFull, s.r.ox, owner);
    ro.oy = __shfl_sync(kFull, s.r.oy, owner);
    ro.oz = __shfl_sync(kFull, s.r.oz, owner);
    ro.dx = __shfl_sync(kFull, s.r.dx, owner);
    ro.dy = __shfl_sync(kFull, s.r.dy, owner);
    ro.dz = __shfl_sync(kFull, s.r.dz, owner);
    Cross xo;
    xo.x = __shfl_sync(kFull, x.x, owner);
    xo.y = __shfl_sync(kFull, x.y, owner);
    xo.z = __shfl_sync(kFull, x.z, owner);
    const float co = __shfl_sync(kFull, cap, owner);
    const int leaf = __shfl_sync(kFull, s.w.leaf, owner);
    bool found = false;
    if (sub < g) {
      const int first = leaf * leaf_size;
      for (int k = lane - sub * w; k < leaf_size; k += w) {
        float t, ud, vd, inv;
        if (fat_column(cf, first + k, ro, xo, t_min, co, t, ud, vd, inv)) {
          found = true;
          break;
        }
      }
    }
    const unsigned votes = __ballot_sync(kFull, found);
    if (s.w.leaf >= 0) {
      // the owner's subgroup: w bits from lane rank * w (kFull >> (32 - w)
      // is defined for every w in 1..32, where 1u << 32 is not)
      const int rank = __popc(parked & ((1u << lane) - 1u));
      if ((votes >> (rank * w)) & (kFull >> (32 - w))) {
        hit = true;
        s.w.p = n_nodes;  // blocked: the lane's walk ends
      }
    }
  });
  if (i < n_rays) hit_out[i] = hit;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kMasked>
int launch_closest(const float* nodes16, const float* tri8, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, const float* tmax,
                   int n_rays, int n_nodes, long long oct_floats,
                   float* t_out, int* tri_out, float* u_out, float* v_out,
                   uint8_t* mixed_out, void* stream) {
  closest_kernel<kMasked><<<blocks_for(n_rays), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax, n_rays, n_nodes,
      oct_floats, t_out, tri_out, u_out, v_out, mixed_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked>
int launch_anyhit(const float* nodes16, const float* tri8, const float* ox,
                  const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const float* tmax,
                  const uint8_t* active, int n_rays, int n_nodes,
                  long long oct_floats, float t_min, uint8_t* hit_out,
                  uint8_t* pending_out, void* stream) {
  anyhit_kernel<kMasked><<<blocks_for(n_rays), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax, active, n_rays, n_nodes,
      oct_floats, t_min, hit_out, pending_out);
  return static_cast<int>(cudaGetLastError());
}

// The kernels glaze_kernel_attrs reports on, in its order.
const void* const kAttrKernels[] = {
    reinterpret_cast<const void*>(closest_kernel<false>),
    reinterpret_cast<const void*>(closest_kernel<true>),
    reinterpret_cast<const void*>(anyhit_kernel<false>),
    reinterpret_cast<const void*>(anyhit_kernel<true>),
    reinterpret_cast<const void*>(closest_kernel_fat),
    reinterpret_cast<const void*>(anyhit_kernel_fat)};
constexpr int kAttrCount = sizeof(kAttrKernels) / sizeof(kAttrKernels[0]);

}  // namespace

extern "C" {

// Each entry launches on ``stream`` and returns cudaGetLastError() (0 = ok).
int glaze_closest_hit(const float* nodes16, const float* tri8,
                      const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tmax, int n_rays, int n_nodes,
                      long long oct_floats, float* t_out, int* tri_out,
                      float* u_out, float* v_out, void* stream) {
  return launch_closest<false>(nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax,
                               n_rays, n_nodes, oct_floats, t_out, tri_out,
                               u_out, v_out, nullptr, stream);
}

int glaze_closest_hit_masked(const float* nodes16, const float* tri8,
                             const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tmax, int n_rays, int n_nodes,
                             long long oct_floats, float* t_out,
                             int* tri_out, float* u_out, float* v_out,
                             uint8_t* mixed_out, void* stream) {
  return launch_closest<true>(nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax,
                              n_rays, n_nodes, oct_floats, t_out, tri_out,
                              u_out, v_out, mixed_out, stream);
}

int glaze_any_hit(const float* nodes16, const float* tri8, const float* ox,
                  const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const float* tmax,
                  const uint8_t* active, int n_rays, int n_nodes,
                  long long oct_floats, float t_min, uint8_t* hit_out,
                  void* stream) {
  return launch_anyhit<false>(nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax,
                              active, n_rays, n_nodes, oct_floats, t_min,
                              hit_out, nullptr, stream);
}

int glaze_any_hit_masked(const float* nodes16, const float* tri8,
                         const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* tmax, const uint8_t* active,
                         int n_rays, int n_nodes, long long oct_floats,
                         float t_min, uint8_t* blocked_out,
                         uint8_t* pending_out, void* stream) {
  return launch_anyhit<true>(nodes16, tri8, ox, oy, oz, dx, dy, dz, tmax,
                             active, n_rays, n_nodes, oct_floats, t_min,
                             blocked_out, pending_out, stream);
}

int glaze_closest_hit_fat(const float* nodes16, const float* coef,
                          const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmax, int n_rays, int n_nodes,
                          long long oct_floats, int leaf_size, float* t_out,
                          int* tri_out, float* u_out, float* v_out,
                          void* stream) {
  closest_kernel_fat<<<blocks_for(n_rays), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      nodes16, coef, ox, oy, oz, dx, dy, dz, tmax, n_rays, n_nodes,
      oct_floats, leaf_size, t_out, tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

int glaze_any_hit_fat(const float* nodes16, const float* coef,
                      const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tmax, const uint8_t* active, int n_rays,
                      int n_nodes, long long oct_floats, int leaf_size,
                      float t_min, uint8_t* hit_out, void* stream) {
  anyhit_kernel_fat<<<blocks_for(n_rays), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      nodes16, coef, ox, oy, oz, dx, dy, dz, tmax, active, n_rays, n_nodes,
      oct_floats, leaf_size, t_min, hit_out);
  return static_cast<int>(cudaGetLastError());
}

// The number of kernels glaze_kernel_attrs reports on.
int glaze_kernel_count() { return kAttrCount; }

// Of kernel ``which`` (0 closest, 1 closest masked, 2 any hit, 3 any hit
// masked, 4 fat closest, 5 fat any hit): registers and local (spill)
// bytes per thread, the threads per block it is launched with, its
// resident blocks per SM at that size, and the most threads an SM of the
// current card holds. Returns a cudaError_t (0 = ok).
int glaze_kernel_attrs(int which, int* regs, int* local_bytes,
                       int* threads_per_block, int* blocks_per_sm,
                       int* max_threads_per_sm) {
  if (which < 0 || which >= kAttrCount)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kAttrKernels[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads_per_block = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kAttrKernels[which], kThreads, 0);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_threads_per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  return static_cast<int>(err);
}

const char* glaze_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
