// Stackless skip-link BVH walks for Hopper (sm_90a): closest hit and any
// hit, each with and without the baked 8x8 opacity cell masks.
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
// The Pallas kernels walk one tree pointer per 128-ray row and queue leaf
// work, because the TPU's VPU only runs dense (8, 128) tiles. None of
// that carries over: here ONE THREAD WALKS ONE RAY, and the masked and
// unmasked kernels are one template, so all four share one slab test,
// one Moller-Trumbore and one octant walk.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTMin = 1e-4f;

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
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float4* nodes = octant_nodes(nodes16, r, oct_floats);
  const float4* tris = reinterpret_cast<const float4*>(tri8);
  float bt = tmax[i], bu = 0.0f, bv = 0.0f;
  int btri = -1;
  bool bmix = false;
  int p = 0;
  while (p < n_nodes) {
    const float4 a = __ldg(nodes + 2 * p);
    const float4 b = __ldg(nodes + 2 * p + 1);
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    if (!slab(a, b, r, bt)) {
      p = skip;
      continue;
    }
    if (meta < 0) {
      p = p + 1;
      continue;
    }
    const int first = meta >> 3;
    const int count = (meta & 7) + 1;
    for (int k = 0; k < count; ++k) {
      float t, u, v;
      float4 c;
      if (tri_hit(tris, first + k, r, t, u, v, c) && t < bt) {
        if constexpr (kMasked) {
          const int code = cell_code(tri8, first + k, c, u, v);
          if (code == 2) continue;  // TRANSPARENT cell: skip the hit
          bmix = code == 0;
        }
        bt = t;
        btri = first + k;
        bu = u;
        bv = v;
      }
    }
    p = skip;
  }
  t_out[i] = btri >= 0 ? bt : INFINITY;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  if constexpr (kMasked) mixed_out[i] = btri >= 0 && bmix;
}

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
  if (i >= n_rays) return;
  if (!active[i]) {
    hit_out[i] = 0;
    if constexpr (kMasked) pending_out[i] = 0;
    return;
  }
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float4* nodes = octant_nodes(nodes16, r, oct_floats);
  const float4* tris = reinterpret_cast<const float4*>(tri8);
  const float cap = tmax[i];
  uint8_t hit = 0, pending = 0;
  int p = 0;
  while (p < n_nodes && !hit) {
    const float4 a = __ldg(nodes + 2 * p);
    const float4 b = __ldg(nodes + 2 * p + 1);
    const int meta = __float_as_int(b.z);
    const int skip = __float_as_int(b.w);
    if (!slab(a, b, r, cap)) {
      p = skip;
      continue;
    }
    if (meta < 0) {
      p = p + 1;
      continue;
    }
    const int first = meta >> 3;
    const int count = (meta & 7) + 1;
    for (int k = 0; k < count; ++k) {
      float t, u, v;
      float4 c;
      if (tri_hit(tris, first + k, r, t, u, v, c) && t > t_min && t < cap) {
        if constexpr (kMasked) {
          const int code = cell_code(tri8, first + k, c, u, v);
          if (code == 0) pending = 1;  // MIXED: the caller resolves it
          if (code != 1) continue;     // only an OPAQUE cell blocks
        }
        hit = 1;
        break;
      }
    }
    p = skip;
  }
  hit_out[i] = hit;
  if constexpr (kMasked) pending_out[i] = pending && !hit;
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

const char* glaze_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
