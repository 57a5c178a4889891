// Fused dense forward: camera rays -> bounce tree -> pixel colour, one
// thread per pixel, CUDA C++ for sm_90a.
//
// Replaces: raytpu/kernels/trace_pallas.py:_make_kernel (launched by
// _forward_tiles).  It computes the same function: for each pixel
// {offset + j*stride}, clamped to P-1, all alias^2 camera samples are traced
// through the Whitted bounce tree to max_depth (closest hit, matte shading
// with the root-free shadow test, Fresnel refraction and reflection with the
// container lookup) and averaged.
//
// What bounds it on this card: fp32 ALU work with divergence, not bytes.
// A pixel reads nothing from device memory but the scene and writes 12
// bytes; its cost is the sphere loops (closest hit, shadow rays per light,
// container probe) at every tree node, and neighbouring pixels walk trees of
// different shapes, so warps diverge.
//
// What the design does about it:
//   * The scene table (12 x N), lights (6 x L) and background (5) are
//     staged once per block in shared memory; every sphere loop then reads
//     shared memory, where converged lanes of a warp read the same word
//     (a broadcast, no bank conflict).
//   * Depth-first walk with an explicit per-thread stack of at most
//     kMaxDepth pending nodes: follow the refraction child, push the
//     reflection child.  Nodes whose intensity is exactly zero are dead and
//     are skipped, so a thread does only its own tree's live work instead
//     of the 2^(depth+1)-1 slots of the breadth-first form.  It sums the
//     same tree in another order.
//   * Loops stop early where the answer is fixed: the shadow loop at the
//     first blocker, the container loop at the first match, the matte block
//     when the node is masked.
//   * Every division and square root is IEEE (no fast math), 1/sqrtf stands
//     for rsqrt, and it is built with -fmad=false, so that the kernel rounds
//     as the plain PyTorch version does.
//
// The per-node arithmetic and the tree walk live in trace_common.cuh, which
// the backward kernel (trace_bwd.cu) shares, so that it differentiates the
// tree this kernel sums.  The kernel allocates nothing and launches on the
// caller's stream; the C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
trace_fwd_kernel(const float* __restrict__ scene, int n_spheres,
                 const float* __restrict__ lights, int n_lights,
                 const float* __restrict__ bg, float* __restrict__ out,
                 long long offset, long long count, long long stride,
                 long long total_pixels, int max_depth, Camera cam) {
  extern __shared__ float smem[];
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  for (int k = threadIdx.x; k < n_scene + n_light + BG_ROWS; k += blockDim.x) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
  }
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  long long g = offset + j * stride;
  if (g > total_pixels - 1) g = total_pixels - 1;  // tail re-renders P-1

  const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                     n_spheres, n_lights};
  float rgb[3];
  pixel_forward(sc, cam, g, max_depth, rgb);
  out[j] = rgb[0];
  out[count + j] = rgb[1];
  out[2 * count + j] = rgb[2];
}

}  // namespace

extern "C" int raytpu_trace_fwd(const float* scene, int n_spheres,
                                const float* lights, int n_lights,
                                const float* bg, float* out, long long offset,
                                long long count, long long stride,
                                long long total_pixels, int width, int alias,
                                int max_depth, float xstep, float ystep,
                                float aspect, float sub, float half_w,
                                float half_h, float zoom, float weight,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
  err = cudaFuncSetAttribute(trace_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const long long blocks = (count + kBlock - 1) / kBlock;
  trace_fwd_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, out, offset, count, stride,
      total_pixels, max_depth, cam);
  return (int)cudaGetLastError();
}
