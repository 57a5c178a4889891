// Backward of one bounce level of the wavefront tracer over flat SoA ray
// state, one thread per ray, CUDA C++ for sm_90a.
//
// Replaces: raytpu/kernels/wavefront.py:_make_wf_bwd_kernel (launched by
// _wf_level_bwd_call; paired with the level by the custom VJP
// _wf_level_ad).  It computes the same function: the vector-Jacobian
// product of one level (wf_level.cu) for the cotangents of its emissions
// em_ct (3, R) and, on a spawning level, of its children ch_ct (10, 2R),
// ray i's children at 2i (refraction) and 2i+1 (reflection).  It writes
// the cotangent of the 9 differentiable state fields of every ray (the
// medium index is discrete: its cotangent is 0) and adds the scene (12 x
// N), light (6 x L) and background (5) cotangents of all rays into `gout`.
// The TPU kernel gets its adjoint from jax.vjp of the level body; here it
// is trace_adjoint.cuh's hand-written node_adjoint, the dense backward's
// own.
//
// Ray i is rebuilt exactly as the level kernel builds it: the medium is
// regathered from the scene table by its index, and node_forward runs at
// level 0 with max_depth = spawn.  Its sphere queries are not run again:
// the level kernel saved their answers in `sel` (the hit sphere, the
// container, one bit per lit light), and the Saved policy below returns
// them, with the hit's t recomputed by sphere_root of that one sphere (the
// arithmetic the forward's running minimum kept, so t is bit-identical).
// So every branch decision matches the forward bit for bit and no loop
// over the spheres is left.  The medium's cotangents go back through that
// gather to sphere m's matte, ior and opacity, or to the background's
// where m < 0 (raytpu differentiates its level with the gather inside,
// wavefront.py:301-308).  A dead ray (intensity exactly zero: the
// compaction's zero tail, or an unspawned child) writes zeros and adds
// nothing, as raytpu's dead-block exit and the dense backward, which never
// visits a dead node.
//
// What bounds it on this card: fp32 ALU work with divergence: a live ray
// rebuilds its node's O(1) forward and runs its adjoint, ~30 gradient
// terms added with atomics, many to the few spheres and lights that a
// level's rays share.  Bytes: 40 + 12 + 72 + 4 (2 + ceil(L/32)) read and
// 40 written per ray.
//
// What the design does about it:
//   * The selections replace the forward's three sphere queries, which
//     were ~98% of the operations this kernel counted when it re-ran them.
//   * The scene is staged in shared memory, and so is the block's gradient
//     table when both fit the 227 KB a block may use, 8 (12N + 6L + 5)
//     bytes (shared atomics, then one global atomic per nonzero entry per
//     block).  Above that the same kernel adds straight into the global
//     table, so K4 takes every scene the level kernel takes; the wrapper
//     picks the instance from N and L.
//   * A block whose rays are all dead (the zero tail past a compaction's
//     kept prefix) writes its zeros and exits before it stages anything.
//   * Occupancy over registers: uncapped, the adjoint leaves 4 blocks of
//     128 threads an SM; the launch bounds ask for 8.
//   * IEEE division and sqrt, built with -fmad=false, as the forward.
//   * raytpu_wf_level_bwd_ref is the same kernel re-running the
//     brute-force queries (sel unread): the reference instance that
//     chip_smoke.py and the card's tests hold this one to.  The main path
//     never calls it.
// Atomics sum in an order that changes from run to run: the tables vary
// in the last bits between runs; d_state is per ray and exact.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() after the launch.  Compiled by g++ as
// plain C++ (no __CUDACC__), the file instead gives a host entry that runs
// the same per-ray function in a loop, for the CPU tests; there sel ==
// nullptr means the brute-force queries.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "trace_adjoint.cuh"

namespace {

using namespace rt;

constexpr int kStateIn = 10;  // ox oy oz dx dy dz ir ig ib medium-index
constexpr int kDiff = 9;      // the fields with a cotangent

RT_HD void zero_state(float* __restrict__ d_state, long long rays,
                      long long i) {
  for (int f = 0; f < kStateIn; ++f) d_state[f * rays + i] = 0.0f;
}

// The sphere queries of ray i answered from the level kernel's saved
// selections: no sphere is tested but the hit one, whose root gives t.
struct Saved {
  const SceneView* sc;
  int hit, tgt;
  const int* bits;  // the ray's first bit word; word w at bits[w * stride]
  long long stride;
  RT_HD int closest(const Ray& r, float* t) const {
    if (hit < 0) {
      *t = kMaxDist;
      return -1;
    }
    const float a = dir_sq(r);
    SphereRoot s;
    sphere_root(*sc, r, a, inv_two_a(a), hit, &s);
    *t = s.t;
    return hit;
  }
  RT_HD bool blocked(int l, float, float, float, float, float, float,
                     float) const {
    return !((bits[(l >> 5) * stride] >> (l & 31)) & 1);
  }
  RT_HD int contain(float, float, float) const { return tgt; }
};

RT_HD Saved saved_query(const SceneView& sc, const int* __restrict__ sel,
                        long long rays, long long i) {
  return Saved{&sc, sel[i], sel[rays + i], sel + 2 * rays + i, rays};
}

// Ray i's cotangents: its state's to d_state (if not null), its terms to G.
// q answers the node's sphere queries.
template <class Q>
RT_HD void level_ray_bwd(const SceneView& sc, const Q& q, const GradView& G,
                         const float* __restrict__ state, long long rays,
                         long long i, bool spawn,
                         const float* __restrict__ em_ct,
                         const float* __restrict__ ch_ct,
                         float* __restrict__ d_state) {
  const float ir = state[6 * rays + i];
  const float ig = state[7 * rays + i];
  const float ib = state[8 * rays + i];
  if (dead(ir, ig, ib)) {
    if (d_state) zero_state(d_state, rays, i);
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
  const float gw[3] = {em_ct[i], em_ct[rays + i], em_ct[2 * rays + i]};
  // The children's cotangents, with zero for their medium values: a
  // child's medium reaches the scene through its own index at the next
  // level, not through this node.
  float dc[2][kStateFields] = {};
  if (spawn) {
    const long long kids = 2 * rays;
    for (int c = 0; c < 2; ++c) {
      for (int f = 0; f < kDiff; ++f) dc[c][f] = ch_ct[f * kids + 2 * i + c];
    }
  }
  float dr[kStateFields];
  node_adjoint(sc, q, G, r, spawn ? 1 : 0, gw, dc[0], dc[1], dr);
  const int srow[5] = {S_MR, S_MG, S_MB, S_IOR, S_OP};
  const int brow[5] = {B_MR, B_MG, B_MB, B_IOR, B_OP};
  for (int k = 0; k < 5; ++k) {
    const float v = dr[R_MR + k];
    if (v != 0.0f) G.medium(srow[k], brow[k], m, v);
  }
  if (!d_state) return;
  for (int f = 0; f < kDiff; ++f) d_state[f * rays + i] = dr[f];
  d_state[kDiff * rays + i] = 0.0f;
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 128;
// Blocks an SM should hold: 8 caps the kernel at 64 registers, with
// spills to L1; uncapped, the adjoint takes about twice that and 4 blocks
// fit an SM.  The occupancy pays: config 5's chunk 0 backward ran faster
// capped than uncapped on an H100 (PERF.md).
constexpr int kMinBlocks = 8;

// kSaved: the queries from sel (the main instance); else the brute-force
// loops (the reference instance, sel unused).
template <bool kSharedGrad, bool kSaved>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
wf_level_bwd_kernel(const float* __restrict__ scene, int n_spheres,
                    const float* __restrict__ lights, int n_lights,
                    const float* __restrict__ bg,
                    const float* __restrict__ state, long long rays,
                    int spawn, const float* __restrict__ em_ct,
                    const float* __restrict__ ch_ct,
                    const int* __restrict__ sel,
                    float* __restrict__ d_state, float* __restrict__ gout) {
  extern __shared__ float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < rays && !dead(state[6 * rays + i], state[7 * rays + i],
                                      state[8 * rays + i]);
  if (!__syncthreads_or(live)) {
    if (i < rays && d_state) zero_state(d_state, rays, i);
    return;
  }
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  const int n_tbl = n_scene + n_light + BG_ROWS;
  float* gsm = kSharedGrad ? smem + n_tbl : gout;
  for (int k = threadIdx.x; k < n_tbl; k += blockDim.x) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
    if (kSharedGrad) gsm[k] = 0.0f;
  }
  __syncthreads();
  if (i < rays) {
    const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                       n_spheres, n_lights};
    const GradView gv{gsm, gsm + n_scene, gsm + n_scene + n_light, n_spheres,
                      n_lights};
    if (kSaved) {
      level_ray_bwd(sc, saved_query(sc, sel, rays, i), gv, state, rays, i,
                    spawn != 0, em_ct, ch_ct, d_state);
    } else {
      level_ray_bwd(sc, BruteForce{&sc}, gv, state, rays, i, spawn != 0,
                    em_ct, ch_ct, d_state);
    }
  }
  if (kSharedGrad) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_tbl; k += blockDim.x) {
      const float v = gsm[k];
      if (v != 0.0f) atomicAdd(&gout[k], v);
    }
  }
}

template <bool kSharedGrad, bool kSaved>
int launch(const float* scene, int n_spheres, const float* lights,
           int n_lights, const float* bg, const float* state, long long rays,
           int spawn, const float* em_ct, const float* ch_ct, const int* sel,
           float* d_state, float* gout, void* stream) {
  const size_t tbl = sizeof(float) *
      (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
  const size_t smem = kSharedGrad ? 2 * tbl : tbl;
  cudaError_t err = cudaFuncSetAttribute(
      wf_level_bwd_kernel<kSharedGrad, kSaved>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rays + kBlock - 1) / kBlock;
  wf_level_bwd_kernel<kSharedGrad, kSaved><<<(unsigned)blocks, kBlock, smem,
                                             (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, state, rays, spawn, em_ct, ch_ct,
      sel, d_state, gout);
  return (int)cudaGetLastError();
}

template <bool kSaved>
int run(const float* scene, int n_spheres, const float* lights, int n_lights,
        const float* bg, const float* state, long long rays, int spawn,
        const float* em_ct, const float* ch_ct, const int* sel,
        float* d_state, float* gout, int shared_grad, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rays <= 0) return (int)cudaSuccess;
  return shared_grad
             ? launch<true, kSaved>(scene, n_spheres, lights, n_lights, bg,
                                    state, rays, spawn, em_ct, ch_ct, sel,
                                    d_state, gout, stream)
             : launch<false, kSaved>(scene, n_spheres, lights, n_lights, bg,
                                     state, rays, spawn, em_ct, ch_ct, sel,
                                     d_state, gout, stream);
}

}  // namespace

// state (10, R), em_ct (3, R), ch_ct (10, 2R) or null when !spawn; sel
// (2 + ceil(L/32), R) int32, the level kernel's selections for this state;
// d_state (10, R) or null (no state cotangent wanted); gout the zeroed
// (12N + 6L + 5) gradient table [scene | lights | background].
// shared_grad picks the instance with the block's gradient table in shared
// memory.
extern "C" int raytpu_wf_level_bwd(const float* scene, int n_spheres,
                                   const float* lights, int n_lights,
                                   const float* bg, const float* state,
                                   long long rays, int spawn,
                                   const float* em_ct, const float* ch_ct,
                                   const int* sel, float* d_state,
                                   float* gout, int shared_grad, int device,
                                   void* stream) {
  return run<true>(scene, n_spheres, lights, n_lights, bg, state, rays, spawn,
                   em_ct, ch_ct, sel, d_state, gout, shared_grad, device,
                   stream);
}

// The reference instance: the same entry re-running the brute-force
// queries; sel is not read.
extern "C" int raytpu_wf_level_bwd_ref(const float* scene, int n_spheres,
                                       const float* lights, int n_lights,
                                       const float* bg, const float* state,
                                       long long rays, int spawn,
                                       const float* em_ct, const float* ch_ct,
                                       const int*, float* d_state,
                                       float* gout, int shared_grad,
                                       int device, void* stream) {
  return run<false>(scene, n_spheres, lights, n_lights, bg, state, rays,
                    spawn, em_ct, ch_ct, nullptr, d_state, gout, shared_grad,
                    device, stream);
}

#else

// The kernel's per-ray function over all R rays, on the CPU: from the
// selections sel, or re-running the brute-force queries when sel is null.
extern "C" void raytpu_wf_level_bwd_host(const float* scene, int n_spheres,
                                         const float* lights, int n_lights,
                                         const float* bg, const float* state,
                                         long long rays, int spawn,
                                         const float* em_ct,
                                         const float* ch_ct, const int* sel,
                                         float* d_state, float* gout) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const GradView gv{gout, gout + SCENE_ROWS * n_spheres,
                    gout + SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights,
                    n_spheres, n_lights};
  for (long long i = 0; i < rays; ++i) {
    if (sel) {
      level_ray_bwd(sc, saved_query(sc, sel, rays, i), gv, state, rays, i,
                    spawn != 0, em_ct, ch_ct, d_state);
    } else {
      level_ray_bwd(sc, BruteForce{&sc}, gv, state, rays, i, spawn != 0,
                    em_ct, ch_ct, d_state);
    }
  }
}

#endif
