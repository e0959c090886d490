// The integrator's three shading stages, one thread a lane, for Hopper
// (sm_90a): surface_kernel (the shade stage), nee_kernel (the NEE stage
// before its shadow ray) and bsdf_kernel (the BSDF stage). Their lane
// arithmetic is csrc/shade_lane.cuh (surface_lane, nee_lane, bsdf_lane),
// which says how it keeps the plain versions' operations, in order, one
// rounding each.
//
// surface_kernel replaces no Pallas kernel: the JAX package leaves the
// closest-hit shader and the miss shader to XLA's fusion. The port ran the
// stage as ~445 eager kernels a launch (render/shade_cuda.py surface_plain:
// interpolate_hit over strided columns of a gathered (P, 34) copy of the
// hits' attribute rows, the shading frame, bsdf.gather_material's four
// material gathers, and sky_radiance with its Smits upsampling and to_rgb_t
// over every lane, a torch.where keeping the missed ones), each reading and
// writing whole planes. Here one thread reads its hit, gathers its
// attribute row once, interpolates, normal-maps where the scene has a
// normal map, builds the frame, reads its material's specular flag and, on
// a missed lane that sees the sky, evaluates the sky alone; it writes the
// lane floats the NEE and BSDF kernels take, as the rows of one buffer.
// What bounds it: bytes. A lane reads its hit (row index, barycentrics),
// direction, bounce and last_specular, and writes 20 floats, its material
// row and two flags; a lane that adds the sky also reads 16 bins of
// importance; the lanes read each attribute row they hit (34 floats), and
// neighbouring lanes share rows, which stay in L2. At a 1080p launch of the
// Sponza-class scene, about 0.25 GB with each distinct row read once,
// 0.076 ms at 3.35 TB/s (chip_smoke.py _surface_bytes; 0.53 GB if each
// lane's row were read from memory).
//
// nee_kernel replaces no Pallas kernel. The JAX package leaves this stage to
// XLA, which fuses the elementwise work of glaze_tpu/render/integrator.py
// direct_light on the TPU; the port ran it as eager PyTorch
// (render/shade_cuda.py nee_plain: lights.sample_light, bsdf.bsdf_value, the
// weight and spectra.to_rgb_t), some 1,500 small kernels a launch, each of
// which runs every light type and every BSDF family present in the scene
// over every lane and selects with torch.where, and reads and writes
// 16-bin spectra of 133 MB at a 1080p launch. Here one thread computes
// what that chain computes for its lane, up to the shadow test: it samples
// only the picked light's type, evaluates only the lane's own BSDF family,
// keeps its spectra in registers and sums them straight to linear RGB.
//
// nee_kernel's outputs, one a lane: the shadow ray's direction wiw and cap
// (distance - 1e-3), its active flag (nee_active and a usable sample), the
// unshadowed RGB contribution, the shadow ray's coherence sort key
// (integrator._trace_key) and the texels bsdf.bsdf_value fetches, which
// the BSDF stage takes as an argument (the diffuse rgb, roughness and
// metalness, written for every lane where the caller asks for them).
//
// What bounds nee_kernel on an H100: bytes. A lane reads ~40 floats (the
// hit point, the shading frame, wo, uv, the material row index, 16 bins of
// importance, the five draws) and writes ~14, about 0.4 GB at a 1080p
// launch, 0.13 ms at 3.35 TB/s; the material, light and sky rows, the
// Smits bases and most texels come from L2. The arithmetic is a few
// hundred operations a lane, with a handful of IEEE divisions and square
// roots.
//
// bsdf_kernel replaces no Pallas kernel either: the JAX package's
// path_trace step leaves the bounce to XLA as well. The port ran it as
// ~1,150 eager kernels a launch (render/shade_cuda.py bsdf_plain: the
// accumulation, the roulette, bsdf.bsdf_sample, which samples every family
// present over every lane and selects, and the masked writes of the new
// PathState), each reading and writing whole (16, P) or (3, P) planes. Here
// one thread does its lane's accumulation, roulette and the sample of its
// own family only, and writes the new state once. What bounds it: bytes.
// Every lane reads its miss flag, material row index, bounce,
// last_specular, accum, sq and the two contributions and writes the 29
// floats of its new state; a lane that hit also reads the frame, wo, the
// hit point, uv, 16 bins of the launch's importance and the texels its
// family needs, a lane that missed the old importance, origin and
// direction: about 0.65 GB at a 1080p launch, 0.19 ms at 3.35 TB/s
// (chip_smoke.py _bsdf_bytes).
//
// The design of all three: structure-of-arrays inputs, so the 32 lanes of a
// warp read 32 neighbouring words of each; the importance bins strided by
// the lane count, so each bin is one coalesced read; the constants table
// copied into shared memory once a block; 256 threads a block. Lanes of
// one warp that hit different families (or lights) diverge: that costs
// issue slots, not bytes.
#include <cuda_runtime.h>

#include "shade_lane.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
surface_kernel(const glaze_shade::SurfaceArgs a) {
  __shared__ float K[glaze_shade::kConsts];
  for (int k = threadIdx.x; k < glaze_shade::kConsts; k += blockDim.x)
    K[k] = a.consts[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n_lanes) glaze_shade::surface_lane(a, K, i);
}

__global__ void __launch_bounds__(kThreads)
nee_kernel(const glaze_shade::NeeArgs a) {
  __shared__ float K[glaze_shade::kConsts];
  for (int k = threadIdx.x; k < glaze_shade::kConsts; k += blockDim.x)
    K[k] = a.consts[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n_lanes) glaze_shade::nee_lane(a, K, i);
}

__global__ void __launch_bounds__(kThreads)
bsdf_kernel(const glaze_shade::BsdfArgs a) {
  __shared__ float K[glaze_shade::kConsts];
  for (int k = threadIdx.x; k < glaze_shade::kConsts; k += blockDim.x)
    K[k] = a.consts[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n_lanes) glaze_shade::bsdf_lane(a, K, i);
}

// a kernel's registers and local (spill) bytes per thread, its threads per
// block and resident blocks per SM, and the most threads an SM holds
template <class Kernel>
int kernel_attrs(Kernel kernel, int* regs, int* local_bytes,
                 int* threads_per_block, int* blocks_per_sm,
                 int* max_threads_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads_per_block = kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, 0);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_threads_per_sm,
                                 cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launches surface_kernel over args->n_lanes lanes on ``stream`` and
// returns cudaGetLastError() (0 = ok).
int glaze_surface_launch(const glaze_shade::SurfaceArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0)
    surface_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// surface_kernel's registers and local (spill) bytes per thread, its
// threads per block and resident blocks per SM, and the most threads an SM
// of the current card holds. Returns a cudaError_t (0 = ok).
int glaze_surface_attrs(int* regs, int* local_bytes, int* threads_per_block,
                        int* blocks_per_sm, int* max_threads_per_sm) {
  return kernel_attrs(surface_kernel, regs, local_bytes, threads_per_block,
                      blocks_per_sm, max_threads_per_sm);
}

// Launches nee_kernel over args->n_lanes lanes on ``stream`` and returns
// cudaGetLastError() (0 = ok).
int glaze_nee_launch(const glaze_shade::NeeArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0)
    nee_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// nee_kernel's numbers, as glaze_surface_attrs gives surface_kernel's.
int glaze_nee_attrs(int* regs, int* local_bytes, int* threads_per_block,
                    int* blocks_per_sm, int* max_threads_per_sm) {
  return kernel_attrs(nee_kernel, regs, local_bytes, threads_per_block,
                      blocks_per_sm, max_threads_per_sm);
}

// Launches bsdf_kernel over args->n_lanes lanes on ``stream`` and returns
// cudaGetLastError() (0 = ok).
int glaze_bsdf_launch(const glaze_shade::BsdfArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0)
    bsdf_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// bsdf_kernel's numbers, as glaze_nee_attrs gives nee_kernel's.
int glaze_bsdf_attrs(int* regs, int* local_bytes, int* threads_per_block,
                     int* blocks_per_sm, int* max_threads_per_sm) {
  return kernel_attrs(bsdf_kernel, regs, local_bytes, threads_per_block,
                      blocks_per_sm, max_threads_per_sm);
}

const char* glaze_shade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
