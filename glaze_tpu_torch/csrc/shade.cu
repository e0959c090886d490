// The integrator's two shading stages, one thread a lane, for Hopper
// (sm_90a): nee_kernel (the NEE stage before its shadow ray) and
// bsdf_kernel (the BSDF stage). Their lane arithmetic is
// csrc/shade_lane.cuh (nee_lane, bsdf_lane), which says how it keeps the
// plain versions' operations, in order, one rounding each.
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
// The design of both: structure-of-arrays inputs, so the 32 lanes of a
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

// Launches nee_kernel over args->n_lanes lanes on ``stream`` and returns
// cudaGetLastError() (0 = ok).
int glaze_nee_launch(const glaze_shade::NeeArgs* args, void* stream) {
  const int n = args->n_lanes;
  if (n > 0)
    nee_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// nee_kernel's registers and local (spill) bytes per thread, its threads
// per block and resident blocks per SM, and the most threads an SM of the
// current card holds. Returns a cudaError_t (0 = ok).
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
