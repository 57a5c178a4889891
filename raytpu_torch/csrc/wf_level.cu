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
// On the training path it also writes the node's selections, `sel`, int32
// (2 + ceil(L/32), R): the hit sphere (-1 on a miss), the container of the
// refraction probe where the node spawned (else -1), and one bit per light
// that lit the hit point (light_term returned true).  The level's backward
// (wf_level_bwd.cu, K4) reads them instead of re-running the sphere
// queries.  A dead ray's are -1, -1, 0.
//
// What bounds it on this card: fp32 ALU work.  Brute force, every live ray
// tests all N spheres for its closest hit, all N per facing light for
// shadow, and the container: ~99% of the operations on config 5 and 10%
// of that bound reached.  Bytes are small beside it: 40 read and 12 + 80
// (+ 4 (2 + ceil(L/32)) with sel) written per ray.  Through the tree the
// operations fall ~5x, and what bounds the level is the walk's loop, which
// a warp runs in lock step for as long as its longest lane's walk.
//
// What the design does about it:
//   * Each ray walks a bounding-volume hierarchy of the spheres (bvh.cuh,
//     built on the device once per frame by kernels/bvh.py) and tests only
//     the spheres of the boxes its ray, shadow segment or probe point
//     meets; the decisions are bit-identical to the loops' (bvh.cuh).  The
//     walk takes four children at a time: an iteration tests four boxes
//     from six 16-byte loads, so the lock-step loop runs about a quarter as
//     often as a binary walk's over as many boxes.
//   * The per-node arithmetic is trace_common.cuh's node_forward, the
//     dense kernels' own, so a wavefront node rounds bit for bit as a K1
//     node does (both are built with -fmad=false).  The node runs at level
//     0 with max_depth = spawn ? 1 : 0: the depth bound never enters the
//     state.
//   * The scene, lights and background are staged once per block in shared
//     memory, and so are the tree's boxes (at a 16-byte offset) and leaf
//     order where all of it fits the 227 KB a block may use; above that
//     (large N) the tree is read through the read-only cache (a second
//     template instance), and where the scene table alone outgrows shared
//     memory (more than ~4800 spheres, or ~9600 lights) the table too is
//     read in place from global memory (a third), so the wavefront takes
//     scenes of any size.
//   * Between levels the rays are compacted, so a warp's lanes are live
//     rays of neighbouring pixels.  A dead ray (intensity exactly zero, the
//     compaction's zero tail) reads 12 bytes, writes zeros and exits.
//   * raytpu_wf_level_ref is the same kernel with the brute-force loops:
//     the reference instance that chip_smoke.py and the card's tests hold
//     the BVH instance to, bit for bit.  The main path never calls it.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() after the launch.  Compiled by g++ as
// plain C++ (no __CUDACC__), the file instead gives host entries that run
// the same per-ray function in a loop, and each query alone, for the CPU
// tests (boxes == nullptr means brute force).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "bvh.cuh"

namespace {

using namespace rt;

constexpr int kStateIn = 10;  // ox oy oz dx dy dz ir ig ib medium-index
constexpr size_t kSmemMax = 232448;  // shared memory one block may use

// n floats rounded up to a multiple of 4: 16 bytes.
RT_HD int align4(int n) { return (n + 3) & ~3; }

size_t table_bytes(int n_spheres, int n_lights) {
  return sizeof(float) *
         (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
}

// The table padded to 16 bytes, then the tree: what instance 1 stages.
size_t staged_bytes(int n_spheres, int n_lights, int n_leaves) {
  return sizeof(float) * (size_t)align4(SCENE_ROWS * n_spheres +
                                        LIGHT_ROWS * n_lights + BG_ROWS) +
         sizeof(float) * (size_t)(BOX_ROWS * 2 * n_leaves) +
         sizeof(int) * (size_t)n_spheres;
}

// The instance raytpu_wf_level launches for the scene and its tree: 1 where
// the table and the tree fit in shared memory, 2 where the table alone
// fits, else 3 (the table read in place from global memory).
int level_instance(int n_spheres, int n_lights, int n_leaves) {
  if (staged_bytes(n_spheres, n_lights, n_leaves) <= kSmemMax) return 1;
  return table_bytes(n_spheres, n_lights) <= kSmemMax ? 2 : 3;
}

// The query policy Q, recording which lights were unblocked into the ray's
// bit words bits[(l / 32) * stride] (zeroed by the caller) when bits is
// not null.  light_term asks blocked() only for a light the hit point
// faces, so a set bit is exactly "light_term returned true".
template <class Q>
struct RecordLit {
  Q q;
  int* bits;
  long long stride;
  RT_HD int closest(const Ray& r, float* t) const { return q.closest(r, t); }
  RT_HD bool blocked(int l, float px, float py, float pz, float lx, float ly,
                     float lz, float gap) const {
    const bool b = q.blocked(l, px, py, pz, lx, ly, lz, gap);
    if (!b && bits) bits[(l >> 5) * stride] |= (int)(1u << (l & 31));
    return b;
  }
  RT_HD int contain(float px, float py, float pz) const {
    return q.contain(px, py, pz);
  }
};

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

// Ray i of the level: emission, children and (if sel is not null) the
// selections, as described above.
template <class Q>
RT_HD void level_ray(const SceneView& sc, const Q& q,
                     const float* __restrict__ state, long long rays,
                     long long i, bool spawn, float* __restrict__ em,
                     float* __restrict__ children, int* __restrict__ sel) {
  const float ir = state[6 * rays + i];
  const float ig = state[7 * rays + i];
  const float ib = state[8 * rays + i];
  const long long kids = 2 * rays;
  const int words = (sc.nl + 31) / 32;
  if (sel) {
    for (int w = 0; w < words; ++w) sel[(2 + w) * rays + i] = 0;
  }
  if (dead(ir, ig, ib)) {
    em[i] = em[rays + i] = em[2 * rays + i] = 0.0f;
    if (spawn) {
      put_zero_child(children + 2 * i, kids);
      put_zero_child(children + 2 * i + 1, kids);
    }
    if (sel) sel[i] = sel[rays + i] = -1;
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
  const RecordLit<Q> rq{q, sel ? sel + 2 * rays + i : nullptr, rays};
  node_forward(sc, rq, r, spawn ? 1 : 0, e, &nd, &refl, &refr);
  em[i] = e[0];
  em[rays + i] = e[1];
  em[2 * rays + i] = e[2];
  if (sel) {
    sel[i] = nd.hit;
    sel[rays + i] = nd.spawn ? nd.tgt : -1;
  }
  if (!spawn) return;
  // nd.tgt is set whenever the node spawned, which a refraction child needs.
  put_child(children + 2 * i, kids, nd.refr, refr, nd.refr ? (float)nd.tgt : 0.0f);
  put_child(children + 2 * i + 1, kids, nd.refl, refl, mix);
}

}  // namespace

// The instance raytpu_wf_level launches for n_spheres spheres, n_lights
// lights and a tree of n_leaves leaves (level_instance), in both builds.
extern "C" int raytpu_wf_level_instance(int n_spheres, int n_lights,
                                        int n_leaves) {
  return level_instance(n_spheres, n_lights, n_leaves);
}

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 128;
// Blocks an SM must hold by registers: 72 a thread, which every instance
// fits without spilling; left to itself ptxas gave the BVH instances 80-96
// and spilled in the third (H100: chunk 0 of config 5 ran 1.02x faster).
constexpr int kMinBlocks = 7;

// kMode 0: the brute-force loops (the reference instance); 1: the BVH
// staged in shared memory; 2: the BVH read through the read-only cache;
// 3: the BVH and the scene table read in place from global memory.
template <int kMode>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
wf_level_kernel(const float* __restrict__ scene, int n_spheres,
                const float* __restrict__ lights, int n_lights,
                const float* __restrict__ bg,
                const float* __restrict__ boxes,
                const int* __restrict__ order, int n_leaves,
                const float* __restrict__ state, long long rays, int spawn,
                float* __restrict__ em, float* __restrict__ children,
                int* __restrict__ sel) {
  extern __shared__ __align__(16) float smem[];
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  const int n_tbl = n_scene + n_light + BG_ROWS;
  const int box_at = align4(n_tbl);  // the staged boxes' 16-byte offset
  if (kMode != 3) {
    for (int k = threadIdx.x; k < n_tbl; k += blockDim.x) {
      smem[k] = k < n_scene ? scene[k]
                : k < n_scene + n_light ? lights[k - n_scene]
                                        : bg[k - n_scene - n_light];
    }
  }
  const int nodes = 2 * n_leaves;
  const int n_box = BOX_ROWS * nodes;
  if (kMode == 1) {
    float* sbox = smem + box_at;
    int* sorder = reinterpret_cast<int*>(sbox + n_box);
    for (int k = threadIdx.x; k < n_box; k += blockDim.x) sbox[k] = boxes[k];
    for (int k = threadIdx.x; k < n_spheres; k += blockDim.x) sorder[k] = order[k];
  }
  if (kMode != 3) __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays) return;
  const SceneView sc = kMode == 3
      ? SceneView{scene, lights, bg, n_spheres, n_lights}
      : SceneView{smem, smem + n_scene, smem + n_scene + n_light, n_spheres,
                  n_lights};
  if (kMode == 0) {
    level_ray(sc, BruteForce{&sc}, state, rays, i, spawn != 0, em, children,
              sel);
  } else {
    const float* b = kMode == 1 ? smem + box_at : boxes;
    const int* o = kMode == 1 ? reinterpret_cast<const int*>(b + n_box) : order;
    const BvhQuery q{&sc, BvhView{b, o, nodes, n_leaves, n_spheres, kMode >= 2}};
    level_ray(sc, q, state, rays, i, spawn != 0, em, children, sel);
  }
}

template <int kMode>
int launch(const float* scene, int n_spheres, const float* lights,
           int n_lights, const float* bg, const float* boxes,
           const int* order, int n_leaves, const float* state,
           long long rays, int spawn, float* em, float* children, int* sel,
           size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wf_level_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rays + kBlock - 1) / kBlock;
  wf_level_kernel<kMode><<<(unsigned)blocks, kBlock, smem,
                           (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, boxes, order, n_leaves, state,
      rays, spawn, em, children, sel);
  return (int)cudaGetLastError();
}

}  // namespace

// state (10, R); em (3, R); children (10, 2R) or null when !spawn; sel
// (2 + ceil(L/32), R) int32 or null (not wanted).  boxes (6, 2 n_leaves)
// and order (N,) are the tree of kernels/bvh.py; boxes 16-byte aligned
// (the walk reads four columns a load).
extern "C" int raytpu_wf_level(const float* scene, int n_spheres,
                               const float* lights, int n_lights,
                               const float* bg, const float* boxes,
                               const int* order, int n_leaves,
                               const float* state, long long rays, int spawn,
                               float* em, float* children, int* sel,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rays <= 0) return (int)cudaSuccess;
  switch (level_instance(n_spheres, n_lights, n_leaves)) {
    case 1:
      return launch<1>(scene, n_spheres, lights, n_lights, bg, boxes, order,
                       n_leaves, state, rays, spawn, em, children, sel,
                       staged_bytes(n_spheres, n_lights, n_leaves), stream);
    case 2:
      return launch<2>(scene, n_spheres, lights, n_lights, bg, boxes, order,
                       n_leaves, state, rays, spawn, em, children, sel,
                       table_bytes(n_spheres, n_lights), stream);
  }
  return launch<3>(scene, n_spheres, lights, n_lights, bg, boxes, order,
                   n_leaves, state, rays, spawn, em, children, sel, 0,
                   stream);
}

// The reference instance: the brute-force loops, the same entry without
// the tree.
extern "C" int raytpu_wf_level_ref(const float* scene, int n_spheres,
                                   const float* lights, int n_lights,
                                   const float* bg, const float* state,
                                   long long rays, int spawn, float* em,
                                   float* children, int* sel, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rays <= 0) return (int)cudaSuccess;
  return launch<0>(scene, n_spheres, lights, n_lights, bg, nullptr, nullptr,
                   0, state, rays, spawn, em, children, sel,
                   table_bytes(n_spheres, n_lights), stream);
}

#else

namespace {

BvhQuery host_tree(const SceneView& sc, const float* boxes, const int* order,
                   int n_leaves) {
  return BvhQuery{&sc, BvhView{boxes, order, 2 * n_leaves, n_leaves, sc.n,
                               false}};
}

}  // namespace

// The kernel's per-ray function over all R rays, on the CPU: through the
// tree, or the brute-force loops when boxes is null.
extern "C" void raytpu_wf_level_host(const float* scene, int n_spheres,
                                     const float* lights, int n_lights,
                                     const float* bg, const float* boxes,
                                     const int* order, int n_leaves,
                                     const float* state, long long rays,
                                     int spawn, float* em, float* children,
                                     int* sel) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  if (!boxes) {
    for (long long i = 0; i < rays; ++i) {
      level_ray(sc, BruteForce{&sc}, state, rays, i, spawn != 0, em, children,
                sel);
    }
    return;
  }
  const BvhQuery q = host_tree(sc, boxes, order, n_leaves);
  for (long long i = 0; i < rays; ++i) {
    level_ray(sc, q, state, rays, i, spawn != 0, em, children, sel);
  }
}

// One query alone over R inputs in (6, R): query 0 (closest) reads a ray's
// origin and direction and writes the sphere to out_i and its t to out_f;
// 1 (blocked) reads a point and a light position, with gap = |light -
// point|^2 as light_term computes it, and writes 0 or 1 to out_i; 2
// (contain) reads a point and writes the sphere to out_i.  Through the
// tree, or the brute-force loops when boxes is null.
extern "C" void raytpu_bvh_query_host(const float* scene, int n_spheres,
                                      const float* boxes, const int* order,
                                      int n_leaves, int query,
                                      const float* in, long long count,
                                      int* out_i, float* out_f) {
  const SceneView sc{scene, nullptr, nullptr, n_spheres, 0};
  const BruteForce brute{&sc};
  const BvhQuery tree = host_tree(sc, boxes, order, n_leaves);
  for (long long j = 0; j < count; ++j) {
    float v[6];
    for (int f = 0; f < 6; ++f) v[f] = in[f * count + j];
    if (query == Q_CLOSEST) {
      const Ray r{v[0], v[1], v[2], v[3], v[4], v[5], 1.0f, 1.0f, 1.0f,
                  0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0};
      float t;
      out_i[j] = boxes ? tree.closest(r, &t) : brute.closest(r, &t);
      out_f[j] = t;
    } else if (query == Q_BLOCKED) {
      const float ex = v[3] - v[0], ey = v[4] - v[1], ez = v[5] - v[2];
      const float gap = ex * ex + ey * ey + ez * ez;
      out_i[j] = boxes ? tree.blocked(0, v[0], v[1], v[2], v[3], v[4], v[5], gap)
                       : brute.blocked(0, v[0], v[1], v[2], v[3], v[4], v[5], gap);
    } else {
      out_i[j] = boxes ? tree.contain(v[0], v[1], v[2])
                       : brute.contain(v[0], v[1], v[2]);
    }
  }
}

// The counting build's tallies since the last call, then reset: the
// expansions of closest, blocked and contain, then the boxes each tested,
// then the spheres (zeros unless built with -DRT_BVH_COUNT).
extern "C" void raytpu_bvh_counts_host(long long* out) {
#ifdef RT_BVH_COUNT
  for (int q = 0; q < N_QUERIES; ++q) {
    out[q] = bvh_counts.expansions[q];
    out[N_QUERIES + q] = bvh_counts.boxes[q];
    out[2 * N_QUERIES + q] = bvh_counts.spheres[q];
  }
  bvh_counts = BvhCounts{};
#else
  for (int q = 0; q < 3 * N_QUERIES; ++q) out[q] = 0;
#endif
}

#endif
