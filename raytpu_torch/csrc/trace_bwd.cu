// Fused dense backward: the scene gradient of sum_pixels g . colour, one
// thread per camera sample, CUDA C++ for sm_90a.
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
// forward, plus the adds of ~30 gradient terms a node.  A sample reads 12
// bytes of cotangent and nothing else from device memory.  The default
// scene has 3 spheres and 2 lights, so every term of a block lands on the
// same ~50 words.
//
// What the design does about it:
//   * Per-node forward values come from trace_common.cuh's node_forward,
//     the forward kernel's own code, so the tree and every branch decision
//     are bit-identical to the forward's.
//   * One thread per camera sample, not per pixel: a thread walks one tree,
//     so a warp waits for its deepest tree, not for its deepest nine.
//   * A post-order depth-first walk over a slim stack frame: a node's input
//     state (the medium as a sphere index, regathered from the table, as
//     the wavefront keeps it), its selections (hit and container:
//     trace_common.cuh's Selection) and its refraction child's state
//     cotangent, 88 bytes; the old frame also held the pending reflection
//     child and a 14-field cotangent for each child, 240 bytes.  The
//     closest-hit and container loops run once a node, on the way down,
//     under the Recording policy; the reflection child is rebuilt from the
//     state and the selections when its turn comes, and the adjoint's own
//     forward runs under the Saved policy: no closest-hit or container
//     loop either time.  (Pushing the reflection child at once where there
//     is no refraction child keeps its ray live across the push: more
//     spills, and K2 11-12% slower at config 3 and the golden frame.)
//     The shadow tests run once, in the adjoint (a word of lit-light bits
//     recorded on the way down instead was not faster).
//     A medium's cotangent goes straight to its sphere's (or the
//     background's) table entries at the node that reads it, so a child
//     returns 9 fields.
//   * Where a thread's own gradient table fits (12N + 6L + 5 <= 64 entries)
//     every thread of a block adds into its own copy in shared memory,
//     interleaved so that no two lanes share an address or a bank: no
//     atomics at all until the block sums its copies and adds each nonzero
//     entry to the global table once.  Above that the block shares one
//     table in shared memory (shared atomics), as before; summing a warp's
//     adds to one address first (__match_any_sync) was slower there.
//   * Launch bounds: 4 blocks an SM for the instance with a table a thread
//     (128 registers, a few spills), 8 for the shared table's (64, more
//     spills, twice the warps to hide them); uncapped it takes ~155.
// PERF.md has the times of each step of the design.
//   * The scene is staged in shared memory.  Its table and the block's
//     gradient table must fit the 227 KB a block may use; the wrapper
//     raises above that.
//   * Samples of pixels with an all-zero cotangent are skipped.
//   * IEEE division and sqrt, built with -fmad=false, as the forward.
// Atomics sum in an order that changes from run to run: results vary in
// the last bits between runs.
//
// raytpu_trace_bwd_ref is the previous design, kept as it was: one thread
// per pixel, a 2,176-byte stack, node_forward with the sphere loops on the
// way down and again in the adjoint, shared atomics.  chip_smoke.py and
// the card's tests hold this kernel to it and time it against it; the main
// path never calls it.
//
// Compiled as plain C++ (g++ -x c++, no __CUDACC__), this file gives CPU
// entry points instead of the kernels: the tests check node_adjoint and
// both walks there against torch.autograd of the plain version.

#include "trace_adjoint.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace rt {

constexpr int kDiff = 9;  // state fields with a cotangent a child returns

// One frame of the walk: a node of the current root-to-node path.
struct Frame {
  float ox, oy, oz, dx, dy, dz, ir, ig, ib;  // the node's input state
  int medium;      // its medium: a sphere index, -1 for the background
  int stage;       // kNew, kRefrDone or kReflDone, plus kHasRefl
  Selection sel;   // what its closest-hit and container queries answered
  float dc0[kDiff];  // its refraction child's state cotangent
};

enum { kNew = 0, kRefrDone = 1, kReflDone = 2, kStageMask = 3, kHasRefl = 4 };

RT_HD void put_frame(Frame* f, const Ray& r, int medium) {
  f->ox = r.ox;
  f->oy = r.oy;
  f->oz = r.oz;
  f->dx = r.dx;
  f->dy = r.dy;
  f->dz = r.dz;
  f->ir = r.ir;
  f->ig = r.ig;
  f->ib = r.ib;
  f->medium = medium;
  f->stage = kNew;
}

// The node's Ray, its medium regathered from the scene table.
RT_HD Ray frame_ray(const SceneView& sc, const Frame& f, int level) {
  const int m = f.medium;
  const bool in = m >= 0;
  return Ray{f.ox, f.oy, f.oz, f.dx, f.dy, f.dz, f.ir, f.ig, f.ib,
             in ? sc.sph(S_MR, m) : sc.bg[B_MR],
             in ? sc.sph(S_MG, m) : sc.bg[B_MG],
             in ? sc.sph(S_MB, m) : sc.bg[B_MB],
             in ? sc.sph(S_IOR, m) : sc.bg[B_IOR],
             in ? sc.sph(S_OP, m) : sc.bg[B_OP], level};
}

// One camera sample's tree, differentiated: every node's emission has the
// cotangent gw; the root's medium is the background.
template <class GV>
RT_HD void sample_grad(const SceneView& sc, const GV& G, int max_depth,
                       float dx, float dy, float dz, const float* gw) {
  Frame stack[kMaxDepth + 1];
  int top = 0;
  put_frame(&stack[0], camera_ray(sc, dx, dy, dz), -1);
  float ret[kDiff];  // the state cotangent a reflection child returns
  for (;;) {
    Frame& f = stack[top];
    const Ray r = frame_ray(sc, f, top);
    if (f.stage == kNew) {
      // The closest-hit and container loops, once.  The frame above is
      // free; it is written only if this node spawns, and then its level,
      // top, is below max_depth.
      f.sel = Selection{-1, -1};
      Node nd;
      Ray refl, refr;
      node_forward(sc, Recording<BruteForce>{BruteForce{&sc}, &f.sel}, r,
                   max_depth, nullptr, &nd, &refl, &refr);
      for (int i = 0; i < kDiff; ++i) f.dc0[i] = 0.0f;
      f.stage = kRefrDone | (nd.refl ? kHasRefl : 0);
      if (nd.refr) {
        put_frame(&stack[++top], refr, nd.tgt);
        continue;
      }
    }
    if (f.stage == (kRefrDone | kHasRefl)) {
      // Rebuild the reflection child from the state and the selections.
      Node nd;
      Ray refl, refr;
      node_forward(sc, Saved<false>{&sc, f.sel.hit, f.sel.tgt, nullptr, 0}, r,
                   max_depth, nullptr, &nd, &refl, &refr);
      f.stage = kReflDone;
      put_frame(&stack[++top], refl, f.medium);
      continue;
    }
    float d0[kStateFields] = {}, d1[kStateFields] = {}, dr[kStateFields];
    for (int i = 0; i < kDiff; ++i) {
      d0[i] = f.dc0[i];
      d1[i] = (f.stage & kStageMask) == kReflDone ? ret[i] : 0.0f;
    }
    node_adjoint(sc, Saved<false>{&sc, f.sel.hit, f.sel.tgt, nullptr, 0}, G, r,
                 max_depth, gw, d0, d1, dr);
    const int srow[5] = {S_MR, S_MG, S_MB, S_IOR, S_OP};
    const int brow[5] = {B_MR, B_MG, B_MB, B_IOR, B_OP};
    for (int k = 0; k < 5; ++k) {
      const float v = dr[R_MR + k];
      if (v != 0.0f) G.medium(srow[k], brow[k], f.medium, v);
    }
    if (top == 0) return;
    --top;
    float* slot = (stack[top].stage & kStageMask) == kRefrDone ? stack[top].dc0
                                                               : ret;
    for (int i = 0; i < kDiff; ++i) slot[i] = dr[i];
  }
}

// Sample s of pixel p's gradient terms for the pixel's colour cotangent g3.
template <class GV>
RT_HD void pixel_sample_grad(const SceneView& sc, const GV& G,
                             const Camera& cam, long long p, int s,
                             int max_depth, const float* g3) {
  const float gw[3] = {g3[0] * cam.weight, g3[1] * cam.weight,
                       g3[2] * cam.weight};
  float px, py, dx, dy, dz;
  pixel_position(cam, p, &px, &py);
  camera_dir(cam, px, py, s / cam.alias, s % cam.alias, &dx, &dy, &dz);
  sample_grad(sc, G, max_depth, dx, dy, dz, gw);
}

// ---- The reference instance's walk: the previous design, unchanged. ----

// One frame of the post-order walk.
struct RefFrame {
  Ray r;                          // the node's input state
  Ray refl;                       // its reflection child, while pending
  float dc[2][kStateFields];      // its children's state cotangents
  int stage;                      // 0: new; 1: refraction done; 2: both
  bool has_refl;
};

// One camera sample's tree, differentiated: every node's emission has the
// cotangent gw; the root's medium is the background.
RT_HD void ref_sample_grad(const SceneView& sc, const GradView& G,
                           int max_depth, float dx, float dy, float dz,
                           const float* gw) {
  RefFrame stack[kMaxDepth + 1];
  int top = 0;
  stack[0].r = camera_ray(sc, dx, dy, dz);
  stack[0].stage = 0;
  for (;;) {
    RefFrame& f = stack[top];
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
RT_HD void ref_pixel_grad(const SceneView& sc, const GradView& G,
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
      ref_sample_grad(sc, G, max_depth, dx, dy, dz, gw);
    }
  }
}

// Entries of a thread's own gradient table at most (LaneGrad).
constexpr int kLaneEntries = 64;

RT_HD int table_entries(int n_spheres, int n_lights) {
  return SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS;
}

}  // namespace rt

#ifdef __CUDACC__

namespace {

using namespace rt;

constexpr int kBlock = 128;

// Blocks an SM each instance should hold: with a table a thread, and with
// the shared one.
constexpr int kLaneMinBlocks = 4, kSharedMinBlocks = 8;

// kLane: each thread adds into its own table (LaneGrad) in shared memory,
// else the block shares one (GradView, shared atomics).
template <bool kLane>
__global__ void __launch_bounds__(kBlock, kLane ? kLaneMinBlocks : kSharedMinBlocks)
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
  for (int k = threadIdx.x; k < n_tbl; k += kBlock) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
  }
  for (int k = threadIdx.x; k < (kLane ? n_tbl * kBlock : n_tbl); k += kBlock) {
    gsm[k] = 0.0f;
  }
  __syncthreads();
  const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                     n_spheres, n_lights};
  const int spp = cam.alias * cam.alias;
  // The thread's camera sample j: sample s of the pixel set's element q.
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j < count * spp) {
    const long long q = j / spp;
    const float g3[3] = {g[q], g[count + q], g[2 * count + q]};
    if (g3[0] != 0.0f || g3[1] != 0.0f || g3[2] != 0.0f) {
      const long long p = clamp_pixel(offset, q, stride, total_pixels);
      const int s = (int)(j - q * spp);
      if (kLane) {
        const LaneGrad gv{gsm + threadIdx.x, kBlock, n_spheres, n_lights};
        pixel_sample_grad(sc, gv, cam, p, s, max_depth, g3);
      } else {
        const GradView gv{gsm, gsm + n_scene, gsm + n_scene + n_light,
                          n_spheres, n_lights};
        pixel_sample_grad(sc, gv, cam, p, s, max_depth, g3);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_tbl; k += kBlock) {
    float v = 0.0f;
    if (kLane) {
      // Lane (l + k) mod kBlock of entry k: the warp's reads fall in 32
      // banks.
      for (int l = 0; l < kBlock; ++l) v += gsm[k * kBlock + ((l + k) & (kBlock - 1))];
    } else {
      v = gsm[k];
    }
    if (v != 0.0f) atomicAdd(&gout[k], v);
  }
}

template <bool kLane>
int launch(const float* scene, int n_spheres, const float* lights,
           int n_lights, const float* bg, const float* g, float* gout,
           long long offset, long long count, long long stride,
           long long total_pixels, int max_depth, const Camera& cam,
           void* stream) {
  const int n_tbl = table_entries(n_spheres, n_lights);
  const size_t smem = sizeof(float) * (size_t)n_tbl * (kLane ? 1 + kBlock : 2);
  auto kernel = trace_bwd_kernel<kLane>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (count * cam.alias * cam.alias + kBlock - 1) / kBlock;
  kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, g, gout, offset, count, stride,
      total_pixels, max_depth, cam);
  return (int)cudaGetLastError();
}

// The previous design (the reference instance), unchanged.
__global__ void __launch_bounds__(kBlock)
trace_bwd_ref_kernel(const float* __restrict__ scene, int n_spheres,
                     const float* __restrict__ lights, int n_lights,
                     const float* __restrict__ bg, const float* __restrict__ g,
                     float* __restrict__ gout, long long offset,
                     long long count, long long stride,
                     long long total_pixels, int max_depth, Camera cam) {
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
      ref_pixel_grad(sc, gv, cam, p, max_depth, g3);
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
  if (count <= 0) return (int)cudaSuccess;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const bool lane = table_entries(n_spheres, n_lights) <= kLaneEntries;
  return lane
             ? launch<true>(scene, n_spheres, lights, n_lights, bg, g, gout,
                            offset, count, stride, total_pixels, max_depth,
                            cam, stream)
             : launch<false>(scene, n_spheres, lights, n_lights, bg, g, gout,
                             offset, count, stride, total_pixels, max_depth,
                             cam, stream);
}

// The reference instance (the previous design); the same arguments.
extern "C" int raytpu_trace_bwd_ref(const float* scene, int n_spheres,
                                    const float* lights, int n_lights,
                                    const float* bg, const float* g,
                                    float* gout, long long offset,
                                    long long count, long long stride,
                                    long long total_pixels, int width,
                                    int alias, int max_depth, float xstep,
                                    float ystep, float aspect, float sub,
                                    float half_w, float half_h, float zoom,
                                    float weight, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) *
      (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
  err = cudaFuncSetAttribute(trace_bwd_ref_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const long long blocks = (count + kBlock - 1) / kBlock;
  trace_bwd_ref_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
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

GradView host_grad_view(float* gout, int n_spheres, int n_lights) {
  return GradView{gout, gout + SCENE_ROWS * n_spheres,
                  gout + SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights,
                  n_spheres, n_lights};
}

}  // namespace

// The forward's per-pixel function (pixel_forward, which K1 sums a sample
// a thread, bit for bit): out is (3, count).
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

// The backward kernel's walk, one camera sample at a time: g is (3,
// count), gout the zeroed [scene | lights | background] gradient table.
extern "C" void raytpu_trace_bwd_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, const float* g, float* gout, long long offset,
    long long count, long long stride, long long total_pixels, int width,
    int alias, int max_depth, float xstep, float ystep, float aspect,
    float sub, float half_w, float half_h, float zoom, float weight) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const GradView gv = host_grad_view(gout, n_spheres, n_lights);
  const Camera cam = make_camera(width, alias, xstep, ystep, aspect, sub,
                                 half_w, half_h, zoom, weight);
  for (long long j = 0; j < count; ++j) {
    const float g3[3] = {g[j], g[count + j], g[2 * count + j]};
    if (g3[0] == 0.0f && g3[1] == 0.0f && g3[2] == 0.0f) continue;
    const long long p = clamp_pixel(offset, j, stride, total_pixels);
    for (int s = 0; s < alias * alias; ++s) {
      pixel_sample_grad(sc, gv, cam, p, s, max_depth, g3);
    }
  }
}

// The reference instance's per-pixel walk (the previous design); the same
// arguments.
extern "C" void raytpu_trace_bwd_ref_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, const float* g, float* gout, long long offset,
    long long count, long long stride, long long total_pixels, int width,
    int alias, int max_depth, float xstep, float ystep, float aspect,
    float sub, float half_w, float half_h, float zoom, float weight) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const GradView gv = host_grad_view(gout, n_spheres, n_lights);
  const Camera cam = make_camera(width, alias, xstep, ystep, aspect, sub,
                                 half_w, half_h, zoom, weight);
  for (long long j = 0; j < count; ++j) {
    const float g3[3] = {g[j], g[count + j], g[2 * count + j]};
    if (g3[0] == 0.0f && g3[1] == 0.0f && g3[2] == 0.0f) continue;
    ref_pixel_grad(sc, gv, cam, clamp_pixel(offset, j, stride, total_pixels),
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
  const GradView gv = host_grad_view(gout, n_spheres, n_lights);
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
