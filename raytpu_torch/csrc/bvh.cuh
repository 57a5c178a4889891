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
// The walk is stackless: descend to 2k on a hit, else shift the trailing
// ones off k (climb while k is a right child) and step to the sibling; it
// ends back at the root.  No local-memory stack.
//
// Exactness: a policy only chooses which spheres it tests.  Every test is
// trace_common.cuh's own function, so a frame is bit-identical to the
// brute-force loops':
//   * closest: prune a box whose clipped slab interval is empty, with the
//     interval clipped to [0, min_t] (a box entered exactly at min_t is
//     still visited, so a tie with a lower index is seen); the winner is
//     replaced on t < min_t, or t == min_t and a lower index: the lowest
//     index among the smallest t, as the loop's strict '<' leaves it.
//   * blocked: any sphere whose test blocks, among the boxes the shadow
//     segment [0, C] meets; the order does not matter.
//   * contain: the lowest index whose test holds, among the boxes that
//     hold the point.
//
// A build with -DRT_BVH_COUNT (host only) counts the boxes and spheres
// each query tests, for chip_smoke.py's operation bound.

#pragma once

#include "trace_common.cuh"

namespace rt {

// Box rows of the (BOX_ROWS, 2 n_leaves) node table.
enum { X_LOX, X_LOY, X_LOZ, X_HIX, X_HIY, X_HIZ, BOX_ROWS };
enum { Q_CLOSEST, Q_BLOCKED, Q_CONTAIN, N_QUERIES };

#ifdef RT_BVH_COUNT
struct BvhCounts {
  long long boxes[N_QUERIES], spheres[N_QUERIES];
};
inline BvhCounts bvh_counts = {};
#define RT_COUNT(field, q) (++bvh_counts.field[q])
#else
#define RT_COUNT(field, q) ((void)0)
#endif

struct BvhView {
  const float* box;  // (BOX_ROWS, nodes); column 0 unused
  const int* order;  // (n,) sphere indices in leaf order
  int nodes, n_leaves, n;
  bool ldg;          // box and order lie in global memory: read them
                     // through the read-only cache
  RT_HD float b(int row, int k) const {
#ifdef __CUDA_ARCH__
    if (ldg) return __ldg(box + row * nodes + k);
#endif
    return box[row * nodes + k];
  }
  RT_HD int sphere(int p) const {
#ifdef __CUDA_ARCH__
    if (ldg) return __ldg(order + p);
#endif
    return order[p];
  }
};

// Whether node k's box meets the ray o + t d for t in [t0, t1], with
// (ix, iy, iz) = 1 / d.  A zero component gives an infinite inverse: the
// axis then constrains nothing when o lies strictly inside the slab and
// empties the interval otherwise (on a face, inf * 0 is NaN and fminf /
// fmaxf take the other bound, which also empties it: the face is the pad
// away from every sphere inside).
RT_HD bool slab(const BvhView& bv, int k, float ox, float oy, float oz,
                float ix, float iy, float iz, float t0, float t1) {
  const float ax = (bv.b(X_LOX, k) - ox) * ix, bx = (bv.b(X_HIX, k) - ox) * ix;
  t0 = fmaxf(t0, fminf(ax, bx));
  t1 = fminf(t1, fmaxf(ax, bx));
  const float ay = (bv.b(X_LOY, k) - oy) * iy, by = (bv.b(X_HIY, k) - oy) * iy;
  t0 = fmaxf(t0, fminf(ay, by));
  t1 = fminf(t1, fmaxf(ay, by));
  const float az = (bv.b(X_LOZ, k) - oz) * iz, bz = (bv.b(X_HIZ, k) - oz) * iz;
  t0 = fmaxf(t0, fminf(az, bz));
  t1 = fminf(t1, fmaxf(az, bz));
  return t0 <= t1;
}

// The stackless walk: enter(k) says whether to open node k; leaf(lo, hi)
// tests the spheres order[lo..hi) and returns true to end the walk.
template <class Enter, class Leaf>
RT_HD void bvh_walk(const BvhView& bv, int query, const Enter& enter,
                    const Leaf& leaf) {
  int k = 1;
  for (;;) {
    RT_COUNT(boxes, query);
    if (enter(k)) {
      if (k < bv.n_leaves) {
        k <<= 1;
        continue;
      }
      const long long j = k - bv.n_leaves;
      if (leaf((int)(j * bv.n / bv.n_leaves),
               (int)((j + 1) * bv.n / bv.n_leaves))) {
        return;
      }
    }
    while (k & 1) k >>= 1;
    if (k == 0) return;
    ++k;
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
          return slab(bv, k, r.ox, r.oy, r.oz, ix, iy, iz, 0.0f, min_t);
        },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            const int i = bv.sphere(p);
            RT_COUNT(spheres, Q_CLOSEST);
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
        [&](int k) { return slab(bv, k, px, py, pz, ix, iy, iz, 0.0f, s.cc); },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            RT_COUNT(spheres, Q_BLOCKED);
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
        bv, Q_CONTAIN,
        [&](int k) {
          return bv.b(X_LOX, k) <= px && px <= bv.b(X_HIX, k) &&
                 bv.b(X_LOY, k) <= py && py <= bv.b(X_HIY, k) &&
                 bv.b(X_LOZ, k) <= pz && pz <= bv.b(X_HIZ, k);
        },
        [&](int lo, int hi) {
          for (int p = lo; p < hi; ++p) {
            const int i = bv.sphere(p);
            if (best >= 0 && i > best) continue;  // cannot win
            RT_COUNT(spheres, Q_CONTAIN);
            if (contains(*sc, px, py, pz, i)) best = i;
          }
          return false;
        });
    return best;
  }
};

}  // namespace rt
