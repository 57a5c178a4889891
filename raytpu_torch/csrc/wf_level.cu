// One bounce level of the wavefront tracer over flat SoA ray state, one
// thread per ray, CUDA C++ for sm_90a.
//
// Replaces: raytpu/kernels/wavefront.py:_make_wf_kernel (launched by
// _wf_level_call).  It computes the same function: for each of R rays in
// the 10-field state (origin xyz, direction xyz, intensity rgb, medium
// index as a float, -1 for the background) it regathers the medium's
// values from the scene table, runs the node, and writes the 3 emission
// channels and, when `spawn`, the 10 fields of both children.  The
// children of ray i sit at 2i (refraction, medium = the refraction
// target's index) and 2i+1 (reflection, medium = the parent's index), so
// parents in pixel order give children in pixel order and the compaction
// (wf_compact.cu) needs no sort.  A child that is not spawned is written as
// ten exact zeros: zero intensity is what marks it dead, and the
// compaction's exactness rests on it (raytpu/kernels/wavefront.py:14-22).
//
// What bounds it on this card: fp32 ALU work, as in the dense forward
// (trace_fwd.cu): every live ray runs the closest-hit loop over N spheres,
// a shadow loop over N per facing light, and the container loop.  Bytes are
// small beside it: 40 read and 12 + 80 written per ray.
//
// What the design does about it:
//   * The per-node arithmetic is trace_common.cuh's node_forward, the
//     dense kernels' own, so a wavefront node rounds bit for bit as a K1
//     node does (both are built with -fmad=false).  The node runs at level
//     0 with max_depth = spawn ? 1 : 0: the depth bound never enters the
//     state.
//   * The scene, lights and background are staged once per block in shared
//     memory, where converged lanes read the same word as a broadcast.
//   * Between levels the rays are compacted, so a warp's lanes are live
//     rays of neighbouring pixels: the warp divergence of the dense
//     kernel's depth-first walk (lanes at different depths of different
//     trees) does not arise.  A dead ray (intensity exactly zero, the
//     compaction's zero tail) reads 12 bytes, writes zeros and exits.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() after the launch.  Compiled by g++ as
// plain C++ (no __CUDACC__), the file instead gives a host entry that runs
// the same per-ray function in a loop, for the CPU tests.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int kStateIn = 10;  // ox oy oz dx dy dz ir ig ib medium-index

// One child's ten fields at out[f * stride], or ten zeros when it is absent.
RT_HD void put_child(float* out, long long stride, bool spawned, const Ray& k,
                     float mix) {
  const float v[kStateIn] = {k.ox, k.oy, k.oz, k.dx, k.dy, k.dz,
                             k.ir, k.ig, k.ib, mix};
  for (int f = 0; f < kStateIn; ++f) out[f * stride] = spawned ? v[f] : 0.0f;
}

RT_HD void put_zero_child(float* out, long long stride) {
  for (int f = 0; f < kStateIn; ++f) out[f * stride] = 0.0f;
}

// Ray i of the level: emission and children, as described above.
RT_HD void level_ray(const SceneView& sc, const float* __restrict__ state,
                     long long rays, long long i, bool spawn,
                     float* __restrict__ em, float* __restrict__ children) {
  const float ir = state[6 * rays + i];
  const float ig = state[7 * rays + i];
  const float ib = state[8 * rays + i];
  const long long kids = 2 * rays;
  if (dead(ir, ig, ib)) {
    em[i] = em[rays + i] = em[2 * rays + i] = 0.0f;
    if (spawn) {
      put_zero_child(children + 2 * i, kids);
      put_zero_child(children + 2 * i + 1, kids);
    }
    return;
  }
  const float mix = state[9 * rays + i];
  const int m = (int)mix;
  const bool in = m >= 0;
  const Ray r{state[i], state[rays + i], state[2 * rays + i],
              state[3 * rays + i], state[4 * rays + i], state[5 * rays + i],
              ir, ig, ib,
              in ? sc.sph(S_MR, m) : sc.bg[B_MR],
              in ? sc.sph(S_MG, m) : sc.bg[B_MG],
              in ? sc.sph(S_MB, m) : sc.bg[B_MB],
              in ? sc.sph(S_IOR, m) : sc.bg[B_IOR],
              in ? sc.sph(S_OP, m) : sc.bg[B_OP], 0};
  float e[3] = {0.0f, 0.0f, 0.0f};
  Node nd;
  Ray refl = {}, refr = {};
  node_forward(sc, r, spawn ? 1 : 0, e, &nd, &refl, &refr);
  em[i] = e[0];
  em[rays + i] = e[1];
  em[2 * rays + i] = e[2];
  if (!spawn) return;
  // nd.tgt is set whenever the node spawned, which a refraction child needs.
  put_child(children + 2 * i, kids, nd.refr, refr, nd.refr ? (float)nd.tgt : 0.0f);
  put_child(children + 2 * i + 1, kids, nd.refl, refl, mix);
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
wf_level_kernel(const float* __restrict__ scene, int n_spheres,
                const float* __restrict__ lights, int n_lights,
                const float* __restrict__ bg,
                const float* __restrict__ state, long long rays, int spawn,
                float* __restrict__ em, float* __restrict__ children) {
  extern __shared__ float smem[];
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  for (int k = threadIdx.x; k < n_scene + n_light + BG_ROWS; k += blockDim.x) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays) return;
  const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                     n_spheres, n_lights};
  level_ray(sc, state, rays, i, spawn != 0, em, children);
}

}  // namespace

extern "C" int raytpu_wf_level(const float* scene, int n_spheres,
                               const float* lights, int n_lights,
                               const float* bg, const float* state,
                               long long rays, int spawn, float* em,
                               float* children, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rays <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) *
      (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
  err = cudaFuncSetAttribute(wf_level_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rays + kBlock - 1) / kBlock;
  wf_level_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, state, rays, spawn, em,
      children);
  return (int)cudaGetLastError();
}

#else

// The kernel's per-ray function over all R rays, on the CPU.
extern "C" void raytpu_wf_level_host(const float* scene, int n_spheres,
                                     const float* lights, int n_lights,
                                     const float* bg, const float* state,
                                     long long rays, int spawn, float* em,
                                     float* children) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  for (long long i = 0; i < rays; ++i) {
    level_ray(sc, state, rays, i, spawn != 0, em, children);
  }
}

#endif
