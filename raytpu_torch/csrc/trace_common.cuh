// The per-node arithmetic of the dense tracer, shared by the forward kernel
// (trace_fwd.cu) and the backward kernel (trace_bwd.cu).
//
// Both kernels take every value and every branch decision of a tree node
// from node_forward() below, so the backward differentiates exactly the tree
// the forward summed.  Every function is __host__ __device__: compiled as
// plain C++ (g++ -x c++ -ffp-contract=off, where __CUDACC__ is undefined and
// the qualifiers are defined away) the same code runs on the CPU, which is
// how the tests check the hand-written adjoint without a card.
//
// Semantics: raytpu/kernels/trace_pallas.py:_trace_level and the reference
// functions named beside each helper.  Every division and square root is
// IEEE, 1/sqrtf stands for rsqrt, and the kernels are built with
// -fmad=false, so that they round as the plain PyTorch version does.

#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#include <math.h>

#define RT_HD __host__ __device__ __forceinline__

namespace rt {

constexpr int kMaxDepth = 8;  // compile-time bound of the per-thread stacks

constexpr float kEpsRay = 1e-5f;       // raytracer.h:86
constexpr float kEpsContain = 1e-6f;   // raytracer.h:252
constexpr float kEpsFresnel = 1e-6f;   // raytracer.h:376
constexpr float kMaxDist = 1e3f;       // raytracer.h:156
constexpr float kBigT = 1e4f;          // raytracer.h:119
constexpr float kMinSig = 1e-3f;       // raytracer.h:236
constexpr float kShift = 0.01f;        // raytracer.h:688, :831
constexpr float kTol = 1e-3f;          // algebra.h:10

// Scene table rows: pos xyz, radius, matte rgb, gloss rgb, opacity, ior.
enum { S_PX, S_PY, S_PZ, S_RAD, S_MR, S_MG, S_MB, S_GR, S_GG, S_GB, S_OP,
       S_IOR, SCENE_ROWS };
// Light table rows: pos xyz, colour rgb.
enum { L_PX, L_PY, L_PZ, L_CR, L_CG, L_CB, LIGHT_ROWS };
// Background: matte rgb, ior, opacity.
enum { B_MR, B_MG, B_MB, B_IOR, B_OP, BG_ROWS };
// A ray's state as a flat vector, in the order of Ray's float fields (the
// backward carries state cotangents in this form).
enum { R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_IR, R_IG, R_IB, R_MR, R_MG,
       R_MB, R_MIOR, R_MOP, kStateFields };

struct Ray {
  float ox, oy, oz;     // origin
  float dx, dy, dz;     // direction (refracted ones are unnormalized)
  float ir, ig, ib;     // intensity
  float mr, mg, mb;     // medium matte
  float mior, mop;      // medium ior and opacity
  int level;
};

struct Camera {
  float xstep, ystep, aspect, sub, half_w, half_h, zoom, weight;
  int width, alias;
};

struct SceneView {
  const float* s;  // (SCENE_ROWS, n)
  const float* l;  // (LIGHT_ROWS, nl)
  const float* bg; // (BG_ROWS,)
  int n, nl;
  RT_HD float sph(int row, int i) const { return s[row * n + i]; }
  RT_HD float light(int row, int i) const { return l[row * nl + i]; }
};

RT_HD float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

RT_HD float sqrt_pos(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

RT_HD bool dead(float r, float g, float b) {
  return r == 0.0f && g == 0.0f && b == 0.0f;
}

// raySphere (raytracer.h:81-141) for sphere i, with a = |d|^2 and
// inv2a = 1/(2a) (1 where a == 0) hoisted by the caller.  `real` is false
// when the radicand is negative; then nothing else is set.
struct SphereRoot {
  float px, py, pz;  // origin - centre
  float b, c, radicand, root, u0, u1, t;
  bool real;
};

RT_HD void sphere_root(const SceneView& sc, const Ray& r, float a,
                       float inv2a, int i, SphereRoot* s) {
  s->px = r.ox - sc.sph(S_PX, i);
  s->py = r.oy - sc.sph(S_PY, i);
  s->pz = r.oz - sc.sph(S_PZ, i);
  const float rad = sc.sph(S_RAD, i);
  s->b = 2.0f * (r.dx * s->px + r.dy * s->py + r.dz * s->pz);
  s->c = (s->px * s->px + s->py * s->py + s->pz * s->pz) - rad * rad;
  s->radicand = s->b * s->b - 4.0f * a * s->c;
  s->real = s->radicand >= 0.0f;
  if (!s->real) return;
  s->root = sqrt_pos(s->radicand);
  s->u0 = (-s->b + s->root) * inv2a;
  s->u1 = (-s->b - s->root) * inv2a;
  const float t0 = s->u0 > kEpsRay ? s->u0 : kBigT;
  const float t1 = s->u1 > kEpsRay ? s->u1 : kBigT;
  s->t = fminf(t0, t1);
}

RT_HD float dir_sq(const Ray& r) {
  return r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
}

RT_HD float inv_two_a(float a) { return 1.0f / (a == 0.0f ? 1.0f : 2.0f * a); }

// calcIntersection (raytracer.h:145-194): index of the closest sphere with a
// root in (1e-5, 1000), strict '<' so the lowest index wins ties; -1 if none.
RT_HD int closest_hit(const SceneView& sc, const Ray& r, float* t_out) {
  const float a = dir_sq(r);
  const float inv2a = inv_two_a(a);
  float min_t = kMaxDist;
  int idx = -1;
  for (int i = 0; i < sc.n; ++i) {
    SphereRoot s;
    sphere_root(sc, r, a, inv2a, i, &s);
    if (!s.real) continue;
    if (s.t < min_t) {  // min_t <= 1000 < kBigT, so this also means "found"
      min_t = s.t;
      idx = i;
    }
  }
  *t_out = min_t;
  return idx;
}

// hasClearLineOfSight (raytracer.h:272-309), inverted, in the root-free
// interval form of trace_pallas.py:_shadow_blocked: with a unit shadow ray
// and C = min(sqrt(gap), 1000), a sphere blocks iff q(t) = a t^2 + b t + c
// has a root in (eps, C): the endpoint signs differ, or both are positive
// with a real radicand and the vertex inside the interval.  ShadowRay holds
// what every sphere's test shares; shadow_hits is one sphere's test.
struct ShadowRay {
  float dx, dy, dz, a, cc, c2, two_a_eps, two_a_c;
};

RT_HD ShadowRay shadow_ray(float px, float py, float pz, float lx, float ly,
                           float lz, float gap) {
  ShadowRay s;
  const float inv = inv_sqrt(gap == 0.0f ? 1.0f : gap);
  s.dx = (lx - px) * inv;
  s.dy = (ly - py) * inv;
  s.dz = (lz - pz) * inv;
  s.a = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz;
  s.cc = fminf(sqrtf(gap), kMaxDist);
  s.c2 = s.cc * s.cc;
  s.two_a_eps = 2.0f * s.a * kEpsRay;
  s.two_a_c = 2.0f * s.a * s.cc;
  return s;
}

RT_HD bool shadow_hits(const SceneView& sc, const ShadowRay& s, float px,
                       float py, float pz, int i) {
  const float ex = px - sc.sph(S_PX, i);
  const float ey = py - sc.sph(S_PY, i);
  const float ez = pz - sc.sph(S_PZ, i);
  const float rad = sc.sph(S_RAD, i);
  const float b = 2.0f * (s.dx * ex + s.dy * ey + s.dz * ez);
  const float c = (ex * ex + ey * ey + ez * ez) - rad * rad;
  const float q_eps = (s.a * kEpsRay + b) * kEpsRay + c;
  const float q_c = s.a * s.c2 + b * s.cc + c;
  const bool neg_eps = q_eps < 0.0f;
  const bool neg_c = q_c < 0.0f;
  const float radicand = b * b - 4.0f * s.a * c;
  const float mb = -b;
  const bool vertex_in = (mb > s.two_a_eps) && (mb < s.two_a_c);
  return (neg_eps != neg_c) ||
         (!neg_eps && !neg_c && radicand >= 0.0f && vertex_in);
}

RT_HD bool shadow_blocked(const SceneView& sc, float px, float py, float pz,
                          float lx, float ly, float lz, float gap) {
  const ShadowRay s = shadow_ray(px, py, pz, lx, ly, lz, gap);
  for (int i = 0; i < sc.n; ++i) {
    if (shadow_hits(sc, s, px, py, pz, i)) return true;
  }
  return false;
}

// primaryContainer (raytracer.h:245-270): first sphere whose
// (radius + 1e-6)-ball holds the point, else -1.
RT_HD bool contains(const SceneView& sc, float px, float py, float pz, int i) {
  const float ex = px - sc.sph(S_PX, i);
  const float ey = py - sc.sph(S_PY, i);
  const float ez = pz - sc.sph(S_PZ, i);
  const float r = sc.sph(S_RAD, i) + kEpsContain;
  return ex * ex + ey * ey + ez * ez <= r * r;
}

RT_HD int container(const SceneView& sc, float px, float py, float pz) {
  for (int i = 0; i < sc.n; ++i) {
    if (contains(sc, px, py, pz, i)) return i;
  }
  return -1;
}

// The three sphere queries a node asks, as a policy of the node code:
// closest(r, &t) (closest_hit), blocked(l, hit point, light, gap)
// (shadow_blocked, for light l) and contain(point) (container).  A policy
// chooses which spheres it tests, never how: every test is the functions
// above, in the exact o - centre form (reassociating it flips 2.5-3.6% of
// pixels, BASELINE.md:582-596).  BruteForce is the loops over every
// sphere; the dense kernels (K1, K2) use it.  bvh.cuh and wf_level_bwd.cu
// hold the others.
struct BruteForce {
  const SceneView* sc;
  RT_HD int closest(const Ray& r, float* t) const {
    return closest_hit(*sc, r, t);
  }
  RT_HD bool blocked(int, float px, float py, float pz, float lx, float ly,
                     float lz, float gap) const {
    return shadow_blocked(*sc, px, py, pz, lx, ly, lz, gap);
  }
  RT_HD int contain(float px, float py, float pz) const {
    return container(*sc, px, py, pz);
  }
};

// polarisedReflection (raytracer.h:370-403), float32.
RT_HD float fresnel(float n1, float n2, float c1, float c2) {
  const float left = n1 * c1;
  const float right = n2 * c2;
  const float num = left - right;
  const float den2 = (left + right) * (left + right);
  if (den2 < kEpsFresnel) return 1.0f;
  const float refl = num * num / den2;
  return refl < 1.0f ? refl : 1.0f;
}

// One light's term of calculateMatte (raytracer.h:313-367) at hit point h
// with unit normal n: false when the light faces away or is shadowed, else
// w = incidence / gap with its intermediates.
struct LightTerm {
  float ex, ey, ez, gap, inv, incidence, w;
};

template <class Q>
RT_HD bool light_term(const SceneView& sc, const Q& q, int l, float hx,
                      float hy, float hz, float nx, float ny, float nz,
                      LightTerm* t) {
  const float lx = sc.light(L_PX, l), ly = sc.light(L_PY, l),
              lz = sc.light(L_PZ, l);
  t->ex = lx - hx;
  t->ey = ly - hy;
  t->ez = lz - hz;
  t->gap = t->ex * t->ex + t->ey * t->ey + t->ez * t->ez;
  t->inv = inv_sqrt(t->gap == 0.0f ? 1.0f : t->gap);
  t->incidence = nx * t->ex * t->inv + ny * t->ey * t->inv + nz * t->ez * t->inv;
  if (!(t->incidence > 0.0f)) return false;
  if (q.blocked(l, hx, hy, hz, lx, ly, lz, t->gap)) return false;
  t->w = t->incidence / (t->gap == 0.0f ? 1.0f : t->gap);
  return true;
}

// What one tree node computes from its input state beyond its emission and
// its children's states: which children it spawns, and the intermediates
// the backward's adjoint reads.  Fields are set only where the comments say
// so.
struct Node {
  int hit;                 // closest sphere, -1 on a miss
  bool live;               // hit by a significant ray: shades, may spawn
  // live:
  float t;
  float hx, hy, hz;        // hit point
  float rnx, rny, rnz;     // hit point - centre
  float n2, ninv;          // its squared length and 1/length
  float nx, ny, nz;        // unit normal
  float op, transparency;
  bool spawn;              // level < max_depth and transparency > 0
  // spawn (calculateRefraction, raytracer.h:642-815):
  float dot_dn, cos1, sin1;
  int tgt;                 // container of the probe point, -1: background
  float tior, tmop, tmr, tmg, tmb;
  float ratio, sin2;
  bool tir;
  float qb, ratio2, qrad, qroot, r0, r1;
  bool rad_zero, take0, take1;
  float cos2mag, cos2, rs, rp, factor, rscale;
  // spawn (calculateReflection, raytracer.h:817-842):
  float pr, perp, gvx, gvy, gvz, g2, ginv;
  bool refr, refl;         // which children exist
};

// One node.  If `emission` is not null, the node's emission is added to
// emission[0..2] (the matte sum over lights, the costly part, runs only
// then).  The children, where nd->refl and nd->refr say they exist, are
// written to *reflection and *refraction as soon as each is known.  The
// forward kernel points these at its stack's free slot and at `r` itself,
// as its own loop did before the node was shared: returned in Node, the
// children cost it 8 more registers (72, by ptxas for sm_90a).
// *refraction may alias r: it is written last.  `q` answers the node's
// sphere queries (BruteForce where it is not given).
template <class Q>
RT_HD void node_forward(const SceneView& sc, const Q& q, const Ray& r,
                        int max_depth, float* emission, Node* nd,
                        Ray* reflection, Ray* refraction) {
  nd->live = nd->spawn = nd->refr = nd->refl = false;
  float t;
  nd->hit = q.closest(r, &t);
  const bool sig = r.ir >= kMinSig || r.ig >= kMinSig || r.ib >= kMinSig;
  if (nd->hit < 0) {
    // A miss paints the medium whatever the ray's significance.
    if (emission) {
      emission[0] += r.ir * r.mr;
      emission[1] += r.ig * r.mg;
      emission[2] += r.ib * r.mb;
    }
    return;
  }
  if (!sig) return;
  const int hit = nd->hit;
  nd->live = true;
  nd->t = t;
  const float hx = r.ox + t * r.dx;
  const float hy = r.oy + t * r.dy;
  const float hz = r.oz + t * r.dz;
  nd->hx = hx;
  nd->hy = hy;
  nd->hz = hz;
  nd->rnx = hx - sc.sph(S_PX, hit);
  nd->rny = hy - sc.sph(S_PY, hit);
  nd->rnz = hz - sc.sph(S_PZ, hit);
  nd->n2 = nd->rnx * nd->rnx + nd->rny * nd->rny + nd->rnz * nd->rnz;
  nd->ninv = inv_sqrt(nd->n2 == 0.0f ? 1.0f : nd->n2);
  const float nx = nd->rnx * nd->ninv;
  const float ny = nd->rny * nd->ninv;
  const float nz = nd->rnz * nd->ninv;
  nd->nx = nx;
  nd->ny = ny;
  nd->nz = nz;
  const float op = sc.sph(S_OP, hit);
  const float transparency = 1.0f - op;
  nd->op = op;
  nd->transparency = transparency;

  if (emission && op > 0.0f) {
    float lr = 0.0f, lg = 0.0f, lb = 0.0f;
    for (int l = 0; l < sc.nl; ++l) {
      LightTerm lt;
      if (!light_term(sc, q, l, hx, hy, hz, nx, ny, nz, &lt)) continue;
      lr += lt.w * sc.light(L_CR, l);
      lg += lt.w * sc.light(L_CG, l);
      lb += lt.w * sc.light(L_CB, l);
    }
    emission[0] += op * r.ir * sc.sph(S_MR, hit) * lr;
    emission[1] += op * r.ig * sc.sph(S_MG, hit) * lg;
    emission[2] += op * r.ib * sc.sph(S_MB, hit) * lb;
  }

  nd->spawn = r.level < max_depth && transparency > 0.0f;
  if (!nd->spawn) return;

  const float dot_dn = r.dx * nx + r.dy * ny + r.dz * nz;
  const float cos1 = dot_dn < -1.0f ? -1.0f : (dot_dn > 1.0f ? 1.0f : dot_dn);
  const float sin1 = sqrt_pos(1.0f - cos1 * cos1);
  nd->dot_dn = dot_dn;
  nd->cos1 = cos1;
  nd->sin1 = sin1;
  const int tgt = q.contain(hx + kShift * r.dx, hy + kShift * r.dy,
                            hz + kShift * r.dz);
  const bool t_in = tgt >= 0;
  const float tior = t_in ? sc.sph(S_IOR, tgt) : sc.bg[B_IOR];
  const float tmop = t_in ? sc.sph(S_OP, tgt) : sc.bg[B_OP];
  nd->tgt = tgt;
  nd->tior = tior;
  nd->tmop = tmop;
  nd->tmr = t_in ? sc.sph(S_MR, tgt) : sc.bg[B_MR];
  nd->tmg = t_in ? sc.sph(S_MG, tgt) : sc.bg[B_MG];
  nd->tmb = t_in ? sc.sph(S_MB, tgt) : sc.bg[B_MB];

  const float ratio = r.mior / (tior == 0.0f ? 1.0f : tior);
  const float sin2 = ratio * sin1;
  nd->ratio = ratio;
  nd->sin2 = sin2;
  nd->tir = sin2 <= -1.0f || sin2 >= 1.0f;

  // solveQuadratic(1, 2 cos1, 1 - 1/ratio^2) (algebra.h:22-65).
  const float qb = 2.0f * cos1;
  const float ratio2 = ratio * ratio;
  const float qc = 1.0f - 1.0f / (ratio2 == 0.0f ? 1.0f : ratio2);
  const float qrad = qb * qb - 4.0f * qc;
  const bool rad_zero = fabsf(qrad) < kTol;
  const float qroot = sqrt_pos(qrad);
  const float dbl = -qb * 0.5f;
  const float r0 = rad_zero ? dbl : (-qb + qroot) * 0.5f;
  const float r1 = rad_zero ? dbl : (-qb - qroot) * 0.5f;
  nd->qb = qb;
  nd->ratio2 = ratio2;
  nd->qrad = qrad;
  nd->rad_zero = rad_zero;
  nd->qroot = qroot;
  nd->r0 = r0;
  nd->r1 = r1;

  // The root whose direction best aligns with the incident one; strict '>'
  // against a running max from -0.1, else a zero direction
  // (raytracer.h:750-771).
  const float c0x = r.dx + r0 * nx, c0y = r.dy + r0 * ny, c0z = r.dz + r0 * nz;
  const float c1x = r.dx + r1 * nx, c1y = r.dy + r1 * ny, c1z = r.dz + r1 * nz;
  const float a0 = r.dx * c0x + r.dy * c0y + r.dz * c0z;
  const float a1 = rad_zero ? -INFINITY : r.dx * c1x + r.dy * c1y + r.dz * c1z;
  const float floor_ = -0.1f;
  const bool take0 = a0 > floor_;
  const bool take1 = a1 > fmaxf(a0, floor_);
  nd->take0 = take0;
  nd->take1 = take1;
  const float rdx = take1 ? c1x : (take0 ? c0x : 0.0f);
  const float rdy = take1 ? c1y : (take0 ? c0y : 0.0f);
  const float rdz = take1 ? c1z : (take0 ? c0z : 0.0f);

  const float cos2mag = sqrt_pos(1.0f - sin2 * sin2);
  const float cos2 = cos1 < 0.0f ? -cos2mag : cos2mag;
  const float rs = fresnel(r.mior, tior, cos1, cos2);
  const float rp = fresnel(r.mior, tior, cos2, cos1);
  const float factor = nd->tir ? 1.0f : 0.5f * (rs + rp);
  nd->cos2mag = cos2mag;
  nd->cos2 = cos2;
  nd->rs = rs;
  nd->rp = rp;
  nd->factor = factor;

  const float rscale = transparency * (1.0f - factor);
  const float r_ir = rscale * r.ir, r_ig = rscale * r.ig, r_ib = rscale * r.ib;
  nd->rscale = rscale;

  // Reflection (raytracer.h:552-615): the hit object's gloss scaled by the
  // containing medium's opacity, a reference quirk.
  const float pr = transparency * factor;
  nd->pr = pr;
  const float rcr = (pr + r.mop * sc.sph(S_GR, hit)) * r.ir;
  const float rcg = (pr + r.mop * sc.sph(S_GG, hit)) * r.ig;
  const float rcb = (pr + r.mop * sc.sph(S_GB, hit)) * r.ib;
  nd->refl = rcr >= kMinSig || rcg >= kMinSig || rcb >= kMinSig;
  if (nd->refl) {
    const float perp = 2.0f * (r.dx * nx + r.dy * ny + r.dz * nz);
    const float gvx = r.dx - perp * nx, gvy = r.dy - perp * ny,
                gvz = r.dz - perp * nz;
    const float g2 = gvx * gvx + gvy * gvy + gvz * gvz;
    const float ginv = inv_sqrt(g2 == 0.0f ? 1.0f : g2);
    nd->perp = perp;
    nd->gvx = gvx;
    nd->gvy = gvy;
    nd->gvz = gvz;
    nd->g2 = g2;
    nd->ginv = ginv;
    const float gx = gvx * ginv, gy = gvy * ginv, gz = gvz * ginv;
    *reflection = Ray{hx + kShift * gx, hy + kShift * gy, hz + kShift * gz,
                      gx, gy, gz, rcr, rcg, rcb,
                      r.mr, r.mg, r.mb, r.mior, r.mop, r.level + 1};
  }
  // A child of exactly zero intensity is dead: it and its subtree add
  // exactly zero, and (trace_pallas.py:1066-1079) exactly zero cotangent.
  nd->refr = !dead(r_ir, r_ig, r_ib);
  if (nd->refr) {
    // The refracted child starts unshifted at the hit point.
    *refraction = Ray{hx, hy, hz, rdx, rdy, rdz, r_ir, r_ig, r_ib,
                      nd->tmr, nd->tmg, nd->tmb, tior, tmop, r.level + 1};
  }
}

RT_HD void node_forward(const SceneView& sc, const Ray& r, int max_depth,
                        float* emission, Node* nd, Ray* reflection,
                        Ray* refraction) {
  node_forward(sc, BruteForce{&sc}, r, max_depth, emission, nd, reflection,
               refraction);
}

// Pixel g's position on the image plane (raytrace_kernel.cl:908-930).
RT_HD void pixel_position(const Camera& cam, long long g, float* px,
                          float* py) {
  const float ix = (float)(g % cam.width);
  const float iy = (float)(g / cam.width);
  *px = (ix - cam.half_w) * cam.xstep;
  *py = (cam.half_h - iy) * cam.ystep;
}

// Supersample (si, sj)'s unit direction from the pixel at (px, py)
// (raytrace_kernel.cl:931-952).
RT_HD void camera_dir(const Camera& cam, float px, float py, int si, int sj,
                      float* dx, float* dy, float* dz) {
  const float x = (px + (float)sj * cam.sub) * cam.aspect;
  const float y = py + (float)si * cam.sub;
  const float z = cam.zoom;
  const float n2 = x * x + y * y + z * z;
  const float inv = inv_sqrt(n2 == 0.0f ? 1.0f : n2);
  *dx = x * inv;
  *dy = y * inv;
  *dz = z * inv;
}

RT_HD Ray camera_ray(const SceneView& sc, float dx, float dy, float dz) {
  return Ray{0.0f, 0.0f, 0.0f, dx, dy, dz, 1.0f, 1.0f, 1.0f,
             sc.bg[B_MR], sc.bg[B_MG], sc.bg[B_MB], sc.bg[B_IOR], sc.bg[B_OP],
             0};
}

// One camera sample's whole tree, depth first with a stack of pending
// reflection children: follow the refraction child, push the reflection
// child.  Returns the sum of the emissions in (er, eg, eb).
RT_HD void trace_tree(const SceneView& sc, int max_depth, float dx, float dy,
                      float dz, float* er, float* eg, float* eb) {
  Ray stack[kMaxDepth];
  int top = 0;
  Ray r = camera_ray(sc, dx, dy, dz);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (;;) {
    // Only a node above max_depth spawns, and then fewer than max_depth
    // reflection children are pending: the slot written is in the stack.
    // The refraction child, if any, overwrites r.
    Node nd;
    node_forward(sc, r, max_depth, acc, &nd, &stack[top], &r);
    if (nd.refl) ++top;
    if (!nd.refr) {
      if (top == 0) break;
      r = stack[--top];
    }
  }
  *er = acc[0];
  *eg = acc[1];
  *eb = acc[2];
}

// Pixel g's colour: the weighted sum of its alias^2 samples.
RT_HD void pixel_forward(const SceneView& sc, const Camera& cam, long long g,
                         int max_depth, float* rgb) {
  float px, py;
  pixel_position(cam, g, &px, &py);
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int si = 0; si < cam.alias; ++si) {
    for (int sj = 0; sj < cam.alias; ++sj) {
      float dx, dy, dz, er, eg, eb;
      camera_dir(cam, px, py, si, sj, &dx, &dy, &dz);
      trace_tree(sc, max_depth, dx, dy, dz, &er, &eg, &eb);
      acc_r += cam.weight * er;
      acc_g += cam.weight * eg;
      acc_b += cam.weight * eb;
    }
  }
  rgb[0] = acc_r;
  rgb[1] = acc_g;
  rgb[2] = acc_b;
}

}  // namespace rt
