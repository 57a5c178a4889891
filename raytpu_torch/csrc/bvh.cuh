// Per-ray sphere culling for the wavefront's level kernel (wf_level.cu,
// K3): the three sphere queries of trace_common.cuh, answered by a walk of
// a bounding-volume hierarchy (BVH) instead of a loop over every sphere.
//
// Why per ray: a TPU has no per-ray control flow, so raytpu tests every
// sphere for every ray; every chunk- or tile-level culling it could express
// left 79-95% of the work live (BASELINE.md:556-580, raytpu/kernels/
// culling.py).  A Hopper thread branches on its own, so each ray walks the
// tree and skips whole groups of spheres.
//
// The tree (built on the device by raytpu_torch/kernels/bvh.py) is
// implicit and complete: node 1 is the root, node k's children are 2k and
// 2k+1, and the n_leaves leaves (a power of two) are nodes n_leaves ..
// 2 n_leaves - 1.  Leaf j holds the spheres order[p] for p in
// [j n / n_leaves, (j + 1) n / n_leaves): the spheres in Morton order of
// their centres, every leaf non-empty.  Each node's box holds the boxes of
// its spheres, inflated by a pad derived from a bound on the tests'
// rounding (kernels/bvh.py), so that no sphere a float test accepts lies
// outside its box.
//
// What bounds the walk on this card: the lock-step loop, not the tests.
// A walk that visits one binary node an iteration spends six dependent
// scalar loads, one slab test and a branch a visit, and the lanes of a
// warp finish their walks at different times, so the warp runs every
// lane's longest loop (config 5: ~124 box tests a live ray and level over
// its three queries).
//
// What the walk does about it: it walks the same tree four children at a
// time.  Expanding node k tests the boxes of its four grandchildren
// 4k .. 4k+3, which lie side by side in each box row, 16-byte aligned: six
// 16-byte loads and four independent tests give a 4-bit mask of the boxes
// met.  The walk's stack is one 64-bit register of 4-bit masks, one a
// level of expansions (a tree of up to 2^32 leaves), and the node whose
// grandchildren the top mask covers lives in a register: take the lowest
// set bit, expand that grandchild (push the rest, descend into its mask)
// or test its leaf's spheres; an empty mask pops to k >> 2.  No
// local-memory stack.  The leaves lie log2(n_leaves) levels down: when
// that is odd, the first mask covers the root's children 2 and 3 (bits 2
// and 3 of node 0's "grandchildren", whose column 0 is unused); a tree of
// one leaf is that leaf.  The loop runs about a quarter as often as the
// binary walk's, over about as many boxes.
//
// Exactness: a policy only chooses which spheres it tests.  Every test is
// trace_common.cuh's own function, so a frame is bit-identical to the
// brute-force loops':
//   * closest: prune a box whose clipped slab interval is empty, with the
//     interval clipped to [0, min_t] as min_t stood when the box's parent
//     was expanded (a box entered exactly at min_t is still visited, so a
//     tie with a lower index is seen; a smaller min_t later only clips the
//     box's own children); the winner is replaced on t < min_t, or t ==
//     min_t and a lower index: the lowest index among the smallest t, as
//     the loop's strict '<' leaves it, whatever the order of the leaves.
//   * blocked: any sphere whose test blocks, among the boxes the shadow
//     segment [0, C] meets; the order does not matter.
//   * contain: the lowest index whose test holds, among the boxes that
//     hold the point.
//
// A build with -DRT_BVH_COUNT (host only) counts each query's expansions
// and the boxes and spheres it tests, for chip_smoke.py's operation bound.

#pragma once

#include "trace_common.cuh"

namespace rt {

// Box rows of the (BOX_ROWS, 2 n_leaves) node table.
enum { X_LOX, X_LOY, X_LOZ, X_HIX, X_HIY, X_HIZ, BOX_ROWS };
enum { Q_CLOSEST, Q_BLOCKED, Q_CONTAIN, N_QUERIES };

#ifdef RT_BVH_COUNT
struct BvhCounts {
  long long expansions[N_QUERIES], boxes[N_QUERIES], spheres[N_QUERIES];
};
inline BvhCounts bvh_counts = {};
#define RT_COUNT(field, q, by) (bvh_counts.field[q] += (by))
#else
#define RT_COUNT(field, q, by) ((void)0)
#endif

struct BvhView {
  const float* box;  // (BOX_ROWS, nodes); column 0 unused; 16-byte aligned
  const int* order;  // (n,) sphere indices in leaf order
  int nodes, n_leaves, n;
  bool ldg;          // box and order lie in global memory: read them
                     // through the read-only cache
  // Row `row` of node k's four grandchildren 4k .. 4k+3: one 16-byte load.
  RT_HD void row4(int row, int k, float v[4]) const {
    const float* p = box + row * nodes + 4 * k;
#ifdef __CUDA_ARCH__
    const float4 q = ldg ? __ldg(reinterpret_cast<const float4*>(p))
                         : *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
#else
    for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
  }
  RT_HD int sphere(int p) const {
#ifdef __CUDA_ARCH__
    if (ldg) return __ldg(order + p);
#endif
    return order[p];
  }
};

// The 4-bit mask of node k's grandchildren whose boxes meet the ray
// o + t d for some t in [t0, t1], with (ix, iy, iz) = 1 / d.  A zero
// component gives an infinite inverse: the axis then constrains nothing
// when o lies strictly inside the slab and empties the interval otherwise
// (on a face, inf * 0 is NaN and fminf / fmaxf take the other bound, which
// also empties it: the face is the pad away from every sphere inside).
RT_HD unsigned slab4(const BvhView& bv, int k, float ox, float oy, float oz,
                     float ix, float iy, float iz, float t0, float t1) {
  float lo[4], hi[4], a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = t0, b[j] = t1;
  const float o[3] = {ox, oy, oz}, inv[3] = {ix, iy, iz};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    bv.row4(X_LOX + axis, k, lo);
    bv.row4(X_HIX + axis, k, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = (lo[j] - o[axis]) * inv[axis];
      const float w = (hi[j] - o[axis]) * inv[axis];
      a[j] = fmaxf(a[j], fminf(u, w));
      b[j] = fminf(b[j], fmaxf(u, w));
    }
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) m |= (unsigned)(a[j] <= b[j]) << j;
  return m;
}

// The 4-bit mask of node k's grandchildren whose boxes hold the point.
RT_HD unsigned point4(const BvhView& bv, int k, float px, float py,
                      float pz) {
  float lo[4], hi[4];
  unsigned m = 0xFu;
  const float p[3] = {px, py, pz};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    bv.row4(X_LOX + axis, k, lo);
    bv.row4(X_HIX + axis, k, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(lo[j] <= p[axis] && p[axis] <= hi[j])) m &= ~(1u << j);
    }
  }
  return m;
}

RT_HD int low_bit(unsigned m) {  // m != 0
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The walk four children at a time (see the head of the file):
// expand(k) is the mask of node k's grandchildren to open; leaf(lo, hi)
// tests the spheres order[lo..hi) and returns true to end the walk.
template <class Expand, class Leaf>
RT_HD void bvh_walk(const BvhView& bv, int query, const Expand& expand,
                    const Leaf& leaf) {
  if (bv.n_leaves == 1) {
    leaf(0, bv.n);
    return;
  }
  // The root's grandchildren, or (leaves an odd number of levels down) its
  // children 2 and 3 as node 0's.
  int k = (low_bit((unsigned)bv.n_leaves) & 1) ? 0 : 1;
  RT_COUNT(expansions, query, 1);
  RT_COUNT(boxes, query, k ? 4 : 2);
  unsigned mask = expand(k) & (k ? 0xFu : 0xCu);
  unsigned long long stack = 0;  // the ancestors' masks, 4 bits a level
  for (;;) {
    while (mask == 0) {
      if (k <= 1) return;
      mask = (unsigned)(stack & 0xFu);
      stack >>= 4;
      k >>= 2;
    }
    const int c = 4 * k + low_bit(mask);
    mask &= mask - 1;
    if (c >= bv.n_leaves) {
      const long long j = c - bv.n_leaves;
      if (leaf((int)(j * bv.n / bv.n_leaves),
               (int)((j + 1) * bv.n / bv.n_leaves))) {
        return;
      }
      continue;
    }
    RT_COUNT(expansions, query, 1);
    RT_COUNT(boxes, query, 4);
    const unsigned m = expand(c);
    if (m) {
      stack = stack << 4 | mask;
      mask = m;
      k = c;
    }
  }
}

// The three queries through the tree (see the head of the file).
struct BvhQuery {
  const SceneView* sc;
  BvhView bv;

  RT_HD int closest(const Ray& r, float* t_out) const {
    const float a = dir_sq(r);
    const float inv2a = inv_two_a(a);
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    float min_t = kMaxDist;
    int idx = -1;
    bvh_walk(
        bv, Q_CLOSEST,
        [&](int k) {
          return slab4(bv, k, r.ox, r.oy, r.oz, ix, iy, iz, 0.0f, min_t);
        },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            const int i = bv.sphere(p);
            RT_COUNT(spheres, Q_CLOSEST, 1);
            SphereRoot s;
            sphere_root(*sc, r, a, inv2a, i, &s);
            if (!s.real) continue;
            if (s.t < min_t || (s.t == min_t && i < idx)) {
              min_t = s.t;
              idx = i;
            }
          }
          return false;
        });
    *t_out = min_t;
    return idx;
  }

  RT_HD bool blocked(int, float px, float py, float pz, float lx, float ly,
                     float lz, float gap) const {
    const ShadowRay s = shadow_ray(px, py, pz, lx, ly, lz, gap);
    const float ix = 1.0f / s.dx, iy = 1.0f / s.dy, iz = 1.0f / s.dz;
    bool hit = false;
    bvh_walk(
        bv, Q_BLOCKED,
        [&](int k) { return slab4(bv, k, px, py, pz, ix, iy, iz, 0.0f, s.cc); },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            RT_COUNT(spheres, Q_BLOCKED, 1);
            if (shadow_hits(*sc, s, px, py, pz, bv.sphere(p))) {
              hit = true;
              return true;
            }
          }
          return false;
        });
    return hit;
  }

  RT_HD int contain(float px, float py, float pz) const {
    int best = -1;
    bvh_walk(
        bv, Q_CONTAIN, [&](int k) { return point4(bv, k, px, py, pz); },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            const int i = bv.sphere(p);
            if (best >= 0 && i > best) continue;  // cannot win
            RT_COUNT(spheres, Q_CONTAIN, 1);
            if (contains(*sc, px, py, pz, i)) best = i;
          }
          return false;
        });
    return best;
  }
};

}  // namespace rt
