// Fused dense backward: the scene gradient of sum_pixels g . colour, one
// thread per pixel, CUDA C++ for sm_90a.
//
// Replaces: raytpu/kernels/trace_pallas.py:_make_bwd_kernel (launched by
// _grad_pixels_pallas_tbl).  It computes the same function: for each pixel
// {offset + j*stride}, clamped to P-1, with cotangent g[:, j], every one of
// the alias^2 camera samples' bounce trees is rebuilt and differentiated,
// and the cotangents of the sphere table (12 x N), the lights (6 x L) and
// the background (5) are summed over all pixels.  The TPU kernel gets its
// adjoint from jax.vjp of _trace_level inside the kernel; here the adjoint
// of one tree node (node_adjoint, trace_adjoint.cuh, shared with the
// wavefront's level backward) is written by hand, from the semantics of
// trace_pallas.py:_VjpScene and _trace_level.
//
// What bounds it on this card: fp32 ALU work with divergence, as the
// forward, plus atomics on a few hot addresses.  A pixel reads 12 bytes of
// cotangent and nothing else from device memory; each tree node recomputes
// its forward twice (once to spawn its children, once for its adjoint) and
// adds ~30 gradient terms.  The default scene has 3 spheres and 2 lights,
// so every thread of a block adds into the same ~50 words.
//
// What the design does about it:
//   * Per-node forward values come from trace_common.cuh's node_forward,
//     the forward kernel's own code, so the tree and every branch decision
//     are bit-identical to the forward's.
//   * A post-order depth-first walk with a stack of at most kMaxDepth + 1
//     frames: a frame holds its node's input state, the pending reflection
//     child, and the state cotangents its two children return.  Dead nodes
//     (intensity exactly zero) are never visited, as in the forward: their
//     cotangent is exactly zero (trace_pallas.py:1066-1079).
//   * The scene is staged in shared memory, and so is the block's gradient
//     table (atomicAdd in shared memory, then one global atomicAdd per
//     nonzero entry per block): global atomics fall from one per term to
//     one per table entry per block.  Both tables must fit the 227 KB a
//     block may use; the wrapper raises above that.
//   * Pixels with an all-zero cotangent are skipped.
//   * IEEE division and sqrt, built with -fmad=false, as the forward.
// Atomics sum in an order that changes from run to run: results vary in
// the last bits between runs.
//
// Compiled as plain C++ (g++ -x c++, no __CUDACC__), this file gives CPU
// entry points instead of the kernel: the tests check node_adjoint and the
// walk there against torch.autograd of the plain version.

#include "trace_adjoint.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace rt {

// One frame of the post-order walk.
struct Frame {
  Ray r;                          // the node's input state
  Ray refl;                       // its reflection child, while pending
  float dc[2][kStateFields];      // its children's state cotangents
  int stage;                      // 0: new; 1: refraction done; 2: both
  bool has_refl;
};

// One camera sample's tree, differentiated: every node's emission has the
// cotangent gw; the root's medium is the background.
RT_HD void sample_grad(const SceneView& sc, const GradView& G, int max_depth,
                       float dx, float dy, float dz, const float* gw) {
  Frame stack[kMaxDepth + 1];
  int top = 0;
  stack[0].r = camera_ray(sc, dx, dy, dz);
  stack[0].stage = 0;
  for (;;) {
    Frame& f = stack[top];
    if (f.stage == 0) {
      Node nd;
      // The frame above is free; it is written only if this node spawns,
      // and then its level, top, is below max_depth.
      node_forward(sc, f.r, max_depth, nullptr, &nd, &f.refl,
                   &stack[top + 1].r);
      for (int i = 0; i < kStateFields; ++i) f.dc[0][i] = f.dc[1][i] = 0.0f;
      f.has_refl = nd.refl;
      f.stage = 1;
      if (nd.refr) {
        ++top;
        stack[top].stage = 0;
        continue;
      }
    }
    if (f.stage == 1) {
      f.stage = 2;
      if (f.has_refl) {
        ++top;
        stack[top].r = f.refl;
        stack[top].stage = 0;
        continue;
      }
    }
    float dr[kStateFields];
    node_adjoint(sc, G, f.r, max_depth, gw, f.dc[0], f.dc[1], dr);
    if (top == 0) {
      // The camera ray starts in the background medium.
      G.back(B_MR, dr[R_MR]);
      G.back(B_MG, dr[R_MG]);
      G.back(B_MB, dr[R_MB]);
      G.back(B_IOR, dr[R_MIOR]);
      G.back(B_OP, dr[R_MOP]);
      return;
    }
    --top;
    float* slot = stack[top].dc[stack[top].stage == 1 ? 0 : 1];
    for (int i = 0; i < kStateFields; ++i) slot[i] = dr[i];
  }
}

// Pixel g's gradient terms for its colour cotangent g3.
RT_HD void pixel_grad(const SceneView& sc, const GradView& G,
                      const Camera& cam, long long g, int max_depth,
                      const float* g3) {
  const float gw[3] = {g3[0] * cam.weight, g3[1] * cam.weight,
                       g3[2] * cam.weight};
  float px, py;
  pixel_position(cam, g, &px, &py);
  for (int si = 0; si < cam.alias; ++si) {
    for (int sj = 0; sj < cam.alias; ++sj) {
      float dx, dy, dz;
      camera_dir(cam, px, py, si, sj, &dx, &dy, &dz);
      sample_grad(sc, G, max_depth, dx, dy, dz, gw);
    }
  }
}

}  // namespace rt

#ifdef __CUDACC__

namespace {

using namespace rt;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
trace_bwd_kernel(const float* __restrict__ scene, int n_spheres,
                 const float* __restrict__ lights, int n_lights,
                 const float* __restrict__ bg, const float* __restrict__ g,
                 float* __restrict__ gout, long long offset, long long count,
                 long long stride, long long total_pixels, int max_depth,
                 Camera cam) {
  extern __shared__ float smem[];
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  const int n_tbl = n_scene + n_light + BG_ROWS;
  float* gsm = smem + n_tbl;
  for (int k = threadIdx.x; k < n_tbl; k += blockDim.x) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
    gsm[k] = 0.0f;
  }
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < count) {
    const float g3[3] = {g[j], g[count + j], g[2 * count + j]};
    if (g3[0] != 0.0f || g3[1] != 0.0f || g3[2] != 0.0f) {
      long long p = offset + j * stride;
      if (p > total_pixels - 1) p = total_pixels - 1;  // tail: pixel P-1
      const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                         n_spheres, n_lights};
      const GradView gv{gsm, gsm + n_scene, gsm + n_scene + n_light,
                        n_spheres, n_lights};
      pixel_grad(sc, gv, cam, p, max_depth, g3);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_tbl; k += blockDim.x) {
    const float v = gsm[k];
    if (v != 0.0f) atomicAdd(&gout[k], v);
  }
}

}  // namespace

// g: (3, count) colour cotangent; gout: the zeroed (12N + 6L + 5) gradient
// table, laid out as [scene | lights | background].
extern "C" int raytpu_trace_bwd(const float* scene, int n_spheres,
                                const float* lights, int n_lights,
                                const float* bg, const float* g, float* gout,
                                long long offset, long long count,
                                long long stride, long long total_pixels,
                                int width, int alias, int max_depth,
                                float xstep, float ystep, float aspect,
                                float sub, float half_w, float half_h,
                                float zoom, float weight, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) *
      (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
  err = cudaFuncSetAttribute(trace_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const long long blocks = (count + kBlock - 1) / kBlock;
  trace_bwd_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, g, gout, offset, count, stride,
      total_pixels, max_depth, cam);
  return (int)cudaGetLastError();
}

#else  // plain C++: CPU entry points for the tests

namespace {

using namespace rt;

Camera make_camera(int width, int alias, float xstep, float ystep,
                   float aspect, float sub, float half_w, float half_h,
                   float zoom, float weight) {
  return Camera{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                width, alias};
}

long long clamp_pixel(long long offset, long long j, long long stride,
                      long long total_pixels) {
  const long long p = offset + j * stride;
  return p > total_pixels - 1 ? total_pixels - 1 : p;
}

}  // namespace

// The forward kernel's per-pixel function: out is (3, count).
extern "C" void raytpu_trace_fwd_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, float* out, long long offset, long long count,
    long long stride, long long total_pixels, int width, int alias,
    int max_depth, float xstep, float ystep, float aspect, float sub,
    float half_w, float half_h, float zoom, float weight) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const Camera cam = make_camera(width, alias, xstep, ystep, aspect, sub,
                                 half_w, half_h, zoom, weight);
  for (long long j = 0; j < count; ++j) {
    float rgb[3];
    pixel_forward(sc, cam, clamp_pixel(offset, j, stride, total_pixels),
                  max_depth, rgb);
    for (int c = 0; c < 3; ++c) out[c * count + j] = rgb[c];
  }
}

// The backward kernel's per-pixel walk: g is (3, count), gout the zeroed
// [scene | lights | background] gradient table.
extern "C" void raytpu_trace_bwd_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, const float* g, float* gout, long long offset,
    long long count, long long stride, long long total_pixels, int width,
    int alias, int max_depth, float xstep, float ystep, float aspect,
    float sub, float half_w, float half_h, float zoom, float weight) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const GradView gv{gout, gout + SCENE_ROWS * n_spheres,
                    gout + SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights,
                    n_spheres, n_lights};
  const Camera cam = make_camera(width, alias, xstep, ystep, aspect, sub,
                                 half_w, half_h, zoom, weight);
  for (long long j = 0; j < count; ++j) {
    const float g3[3] = {g[j], g[count + j], g[2 * count + j]};
    if (g3[0] == 0.0f && g3[1] == 0.0f && g3[2] == 0.0f) continue;
    pixel_grad(sc, gv, cam, clamp_pixel(offset, j, stride, total_pixels),
               max_depth, g3);
  }
}

// One node: its forward (emission (3), children [refraction | reflection]
// states (2 x 14, zero where not spawned), spawned flags (2)) and its
// adjoint for the cotangents gw, dc0, dc1 (dstate (14), terms added to
// gout).
extern "C" void raytpu_node_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, const float* state, int level, int max_depth,
    const float* gw, const float* dc0, const float* dc1, float* emission,
    float* children, int* spawned, float* dstate, float* gout) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const GradView gv{gout, gout + SCENE_ROWS * n_spheres,
                    gout + SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights,
                    n_spheres, n_lights};
  const Ray r{state[0], state[1], state[2], state[3], state[4], state[5],
              state[6], state[7], state[8], state[9], state[10], state[11],
              state[12], state[13], level};
  Node nd;
  Ray refl, refr;
  emission[0] = emission[1] = emission[2] = 0.0f;
  node_forward(sc, r, max_depth, emission, &nd, &refl, &refr);
  const bool has[2] = {nd.refr, nd.refl};
  const Ray* kids[2] = {&refr, &refl};
  for (int c = 0; c < 2; ++c) {
    spawned[c] = has[c] ? 1 : 0;
    float* out = children + c * kStateFields;
    for (int f = 0; f < kStateFields; ++f) out[f] = 0.0f;
    if (!has[c]) continue;
    const Ray& k = *kids[c];
    const float v[kStateFields] = {k.ox, k.oy, k.oz, k.dx, k.dy, k.dz, k.ir,
                                   k.ig, k.ib, k.mr, k.mg, k.mb, k.mior,
                                   k.mop};
    for (int f = 0; f < kStateFields; ++f) out[f] = v[f];
  }
  node_adjoint(sc, gv, r, max_depth, gw, dc0, dc1, dstate);
}

#endif
