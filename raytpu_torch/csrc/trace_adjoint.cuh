// The hand-written adjoint of one tree node, shared by the dense backward
// kernel (trace_bwd.cu, K2) and the wavefront's level backward
// (wf_level_bwd.cu, K4).
//
// node_adjoint() reverses trace_common.cuh's node_forward(): it rebuilds the
// node's forward values and branch decisions with node_forward itself, so
// the adjoint differentiates exactly the node the forward kernels computed.
// It is written from the semantics of raytpu/kernels/trace_pallas.py:
// _VjpScene and _trace_level.  The selections (closest hit, container,
// shadow visibility, significance, which refraction root) are constants of
// the derivative; values flow through the winning sphere's root, the
// normal, the matte sum over lit lights, Fresnel and the children's states.
// Gradients are added through a gradient view: GradView, with atomics on
// the device and plain adds on the host (g++ builds, for the CPU tests), or
// LaneGrad, a table private to one thread.

#pragma once

#include "trace_common.cuh"

namespace rt {

RT_HD void grad_add(float* p, float v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// Gradient tables laid out as the scene tables.
struct GradView {
  float* s;   // (SCENE_ROWS, n)
  float* l;   // (LIGHT_ROWS, nl)
  float* bg;  // (BG_ROWS,)
  int n, nl;
  RT_HD void sph(int row, int i, float v) const { grad_add(&s[row * n + i], v); }
  RT_HD void light(int row, int i, float v) const {
    grad_add(&l[row * nl + i], v);
  }
  RT_HD void back(int row, float v) const { grad_add(&bg[row], v); }
  // A medium field of sphere `tgt`, or of the background where tgt < 0.
  RT_HD void medium(int srow, int brow, int tgt, float v) const {
    if (tgt >= 0) sph(srow, tgt, v); else back(brow, v);
  }
};

// A gradient table private to one thread, laid out as GradView's: entry k
// at base[k * stride], added without atomics.  The dense backward keeps
// one per thread of a block in shared memory, interleaved (stride = the
// block's size), so that no two lanes touch one address or one bank.
struct LaneGrad {
  float* base;
  int stride, n, nl;
  RT_HD void add(int k, float v) const { base[k * stride] += v; }
  RT_HD void sph(int row, int i, float v) const { add(row * n + i, v); }
  RT_HD void light(int row, int i, float v) const {
    add(SCENE_ROWS * n + row * nl + i, v);
  }
  RT_HD void back(int row, float v) const {
    add(SCENE_ROWS * n + LIGHT_ROWS * nl + row, v);
  }
  RT_HD void medium(int srow, int brow, int tgt, float v) const {
    if (tgt >= 0) sph(srow, tgt, v); else back(brow, v);
  }
};

// out = v * inv with inv = 1/sqrt(v2) (1 where v2 == 0): adds to dv the
// cotangent of v, given the cotangent of out.
RT_HD void normalize_adjoint(float vx, float vy, float vz, float v2,
                             float inv, float dox, float doy, float doz,
                             float* dvx, float* dvy, float* dvz) {
  *dvx += dox * inv;
  *dvy += doy * inv;
  *dvz += doz * inv;
  if (v2 == 0.0f) return;
  const float dinv = dox * vx + doy * vy + doz * vz;
  const float dv2 = dinv * (-0.5f * inv * inv * inv);
  *dvx += 2.0f * vx * dv2;
  *dvy += 2.0f * vy * dv2;
  *dvz += 2.0f * vz * dv2;
}

// Adjoint of fresnel(n1, n2, c1, c2) for the cotangent d: zero where the
// forward clamps (den2 < eps, or the ratio capped at 1).
RT_HD void fresnel_adjoint(float n1, float n2, float c1, float c2, float d,
                           float* dn1, float* dn2, float* dc1, float* dc2) {
  const float left = n1 * c1;
  const float right = n2 * c2;
  const float num = left - right;
  const float s = left + right;
  const float den2 = s * s;
  if (den2 < kEpsFresnel) return;
  const float refl = num * num / den2;
  if (!(refl < 1.0f)) return;
  const float dnum = d * 2.0f * num / den2;
  const float ds = -d * refl / den2 * 2.0f * s;
  const float dleft = dnum + ds;
  const float dright = ds - dnum;
  *dn1 += dleft * c1;
  *dc1 += dleft * n1;
  *dn2 += dright * c2;
  *dc2 += dright * n2;
}

// Adjoint of the winning root t of sphere k along r (trace_pallas.py:152-167,
// with _inv2a's a == 0 guard): adds to dr the cotangents of the origin and
// direction, and to G those of sphere k's centre and radius.
template <class GV>
RT_HD void hit_t_adjoint(const SceneView& sc, const GV& G, const Ray& r,
                         int k, float dt, float* dr) {
  const float a = dir_sq(r);
  const float inv2a = inv_two_a(a);
  SphereRoot s;
  sphere_root(sc, r, a, inv2a, k, &s);
  if (!s.real) return;  // never: the closest hit has a real root
  const float t0 = s.u0 > kEpsRay ? s.u0 : kBigT;
  const float t1 = s.u1 > kEpsRay ? s.u1 : kBigT;
  const float sign = t0 <= t1 ? 1.0f : -1.0f;  // u = (-b + sign*root) * inv2a
  float db = -dt * inv2a;
  const float droot = sign * dt * inv2a;
  const float dinv2a = dt * (-s.b + sign * s.root);
  float da = 0.0f, dc = 0.0f;
  if (s.radicand > 0.0f) {
    const float drad = droot * 0.5f / s.root;
    db += 2.0f * s.b * drad;
    da -= 4.0f * s.c * drad;
    dc -= 4.0f * a * drad;
  }
  if (a != 0.0f) da -= 2.0f * dinv2a * inv2a * inv2a;
  // a = d.d, b = 2 d.p, c = p.p - rad^2, p = o - centre.
  dr[R_DX] += 2.0f * r.dx * da + 2.0f * s.px * db;
  dr[R_DY] += 2.0f * r.dy * da + 2.0f * s.py * db;
  dr[R_DZ] += 2.0f * r.dz * da + 2.0f * s.pz * db;
  const float dpx = 2.0f * r.dx * db + 2.0f * s.px * dc;
  const float dpy = 2.0f * r.dy * db + 2.0f * s.py * dc;
  const float dpz = 2.0f * r.dz * db + 2.0f * s.pz * dc;
  dr[R_OX] += dpx;
  dr[R_OY] += dpy;
  dr[R_OZ] += dpz;
  G.sph(S_PX, k, -dpx);
  G.sph(S_PY, k, -dpy);
  G.sph(S_PZ, k, -dpz);
  G.sph(S_RAD, k, -2.0f * sc.sph(S_RAD, k) * dc);
}

// The adjoint of one tree node.  Given the cotangent gw of its emission and
// the cotangents dc0 (refraction child) and dc1 (reflection child) of the
// input states of the children it spawns, writes the cotangent of its own
// input state to dr and adds its scene, light and background terms to G.
// `q` answers the node's sphere queries (BruteForce where it is not given):
// only their answers enter the adjoint.  G is a gradient view.
template <class Q, class GV>
RT_HD void node_adjoint(const SceneView& sc, const Q& q, const GV& G,
                        const Ray& r, int max_depth, const float* gw,
                        const float* dc0, const float* dc1, float* dr) {
  for (int f = 0; f < kStateFields; ++f) dr[f] = 0.0f;
  Node nd;
  Ray children[2];  // not needed: the walk has them
  node_forward(sc, q, r, max_depth, nullptr, &nd, &children[0], &children[1]);
  const float I[3] = {r.ir, r.ig, r.ib};
  if (nd.hit < 0) {  // miss: emission = intensity * medium matte
    const float M[3] = {r.mr, r.mg, r.mb};
    for (int c = 0; c < 3; ++c) {
      dr[R_IR + c] = gw[c] * M[c];
      dr[R_MR + c] = gw[c] * I[c];
    }
    return;
  }
  if (!nd.live) return;  // an insignificant hit adds nothing
  const int k = nd.hit;
  const float nx = nd.nx, ny = nd.ny, nz = nd.nz;
  float dhx = 0.0f, dhy = 0.0f, dhz = 0.0f;  // hit point
  float dnx = 0.0f, dny = 0.0f, dnz = 0.0f;  // unit normal
  float dop = 0.0f;                          // sphere k's opacity

  // Matte: e_c = op * I_c * matte_c * L_c, L = sum over lit lights of
  // w * colour, w = incidence / gap (trace_pallas.py:270-286).
  if (nd.op > 0.0f) {
    const float mat[3] = {sc.sph(S_MR, k), sc.sph(S_MG, k), sc.sph(S_MB, k)};
    float dL[3], L[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 3; ++c) dL[c] = gw[c] * nd.op * I[c] * mat[c];
    for (int l = 0; l < sc.nl; ++l) {
      LightTerm lt;
      if (!light_term(sc, q, l, nd.hx, nd.hy, nd.hz, nx, ny, nz, &lt)) continue;
      float dw = 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float col = sc.light(L_CR + c, l);
        L[c] += lt.w * col;
        G.light(L_CR + c, l, dL[c] * lt.w);
        dw += dL[c] * col;
      }
      // gap > 0 wherever incidence > 0.
      const float dinc = dw / lt.gap;
      float dgap = -dw * lt.w / lt.gap;
      dnx += dinc * lt.ex * lt.inv;
      dny += dinc * lt.ey * lt.inv;
      dnz += dinc * lt.ez * lt.inv;
      const float dinv = dinc * (nx * lt.ex + ny * lt.ey + nz * lt.ez);
      dgap += dinv * (-0.5f * lt.inv * lt.inv * lt.inv);
      const float dex = dinc * nx * lt.inv + 2.0f * lt.ex * dgap;
      const float dey = dinc * ny * lt.inv + 2.0f * lt.ey * dgap;
      const float dez = dinc * nz * lt.inv + 2.0f * lt.ez * dgap;
      G.light(L_PX, l, dex);
      G.light(L_PY, l, dey);
      G.light(L_PZ, l, dez);
      dhx -= dex;
      dhy -= dey;
      dhz -= dez;
    }
    for (int c = 0; c < 3; ++c) {
      dop += gw[c] * I[c] * mat[c] * L[c];
      dr[R_IR + c] += gw[c] * nd.op * mat[c] * L[c];
      G.sph(S_MR + c, k, gw[c] * nd.op * I[c] * L[c]);
    }
  }

  if (nd.spawn) {
    const float T = nd.transparency, factor = nd.factor;
    float dT = 0.0f, dfactor = 0.0f, dtior = 0.0f, dratio = 0.0f;
    float dcos1 = 0.0f, dsin1 = 0.0f;

    if (nd.refl) {
      // Child: origin h + 0.01 g, direction g = normalize(d - 2(d.n) n),
      // intensity (T * factor + mop * gloss) * I, the parent's medium.
      dr[R_MR] += dc1[R_MR];
      dr[R_MG] += dc1[R_MG];
      dr[R_MB] += dc1[R_MB];
      dr[R_MIOR] += dc1[R_MIOR];
      dr[R_MOP] += dc1[R_MOP];
      float dpr = 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float gloss = sc.sph(S_GR + c, k);
        const float di = dc1[R_IR + c];
        dpr += di * I[c];
        dr[R_MOP] += di * gloss * I[c];
        G.sph(S_GR + c, k, di * r.mop * I[c]);
        dr[R_IR + c] += di * (nd.pr + r.mop * gloss);
      }
      dT += dpr * factor;
      dfactor += dpr * T;
      dhx += dc1[R_OX];
      dhy += dc1[R_OY];
      dhz += dc1[R_OZ];
      float dgvx = 0.0f, dgvy = 0.0f, dgvz = 0.0f;
      normalize_adjoint(nd.gvx, nd.gvy, nd.gvz, nd.g2, nd.ginv,
                        dc1[R_DX] + kShift * dc1[R_OX],
                        dc1[R_DY] + kShift * dc1[R_OY],
                        dc1[R_DZ] + kShift * dc1[R_OZ], &dgvx, &dgvy, &dgvz);
      const float dperp = -(dgvx * nx + dgvy * ny + dgvz * nz);
      dr[R_DX] += dgvx + 2.0f * dperp * nx;
      dr[R_DY] += dgvy + 2.0f * dperp * ny;
      dr[R_DZ] += dgvz + 2.0f * dperp * nz;
      dnx += 2.0f * dperp * r.dx - nd.perp * dgvx;
      dny += 2.0f * dperp * r.dy - nd.perp * dgvy;
      dnz += 2.0f * dperp * r.dz - nd.perp * dgvz;
    }

    if (nd.refr) {
      // Child: origin h (unshifted), direction d + r_i n (unnormalized),
      // intensity T (1 - factor) I, the container's (or background's)
      // medium.
      dhx += dc0[R_OX];
      dhy += dc0[R_OY];
      dhz += dc0[R_OZ];
      G.medium(S_MR, B_MR, nd.tgt, dc0[R_MR]);
      G.medium(S_MG, B_MG, nd.tgt, dc0[R_MG]);
      G.medium(S_MB, B_MB, nd.tgt, dc0[R_MB]);
      G.medium(S_OP, B_OP, nd.tgt, dc0[R_MOP]);
      dtior += dc0[R_MIOR];
      float drscale = 0.0f;
      for (int c = 0; c < 3; ++c) {
        drscale += dc0[R_IR + c] * I[c];
        dr[R_IR + c] += dc0[R_IR + c] * nd.rscale;
      }
      dT += drscale * (1.0f - factor);
      dfactor -= drscale * T;
      float dr0 = 0.0f, dr1 = 0.0f;
      if (nd.take1 || nd.take0) {
        const float root = nd.take1 ? nd.r1 : nd.r0;
        const float droot = dc0[R_DX] * nx + dc0[R_DY] * ny + dc0[R_DZ] * nz;
        if (nd.take1) dr1 = droot; else dr0 = droot;
        dr[R_DX] += dc0[R_DX];
        dr[R_DY] += dc0[R_DY];
        dr[R_DZ] += dc0[R_DZ];
        dnx += root * dc0[R_DX];
        dny += root * dc0[R_DY];
        dnz += root * dc0[R_DZ];
      }
      // r0, r1 = (-qb +- sqrt(qrad)) / 2, or -qb / 2 when |qrad| < TOL;
      // qb = 2 cos1, qrad = qb^2 - 4 qc, qc = 1 - 1/ratio^2.
      float dqb = -0.5f * (dr0 + dr1);
      if (!nd.rad_zero && nd.qrad > 0.0f) {
        const float dqrad = 0.5f * (dr0 - dr1) * 0.5f / nd.qroot;
        dqb += 2.0f * nd.qb * dqrad;
        if (nd.ratio2 != 0.0f) {
          const float dratio2 = -4.0f * dqrad / (nd.ratio2 * nd.ratio2);
          dratio += 2.0f * nd.ratio * dratio2;
        }
      }
      dcos1 += 2.0f * dqb;
    }

    // factor = (rs + rp) / 2, or the constant 1 under total internal
    // reflection; cos2 = +-sqrt_pos(1 - sin2^2) with cos1's sign.
    if (!nd.tir && dfactor != 0.0f) {
      float dmior = 0.0f, dcos2 = 0.0f;
      fresnel_adjoint(r.mior, nd.tior, nd.cos1, nd.cos2, 0.5f * dfactor,
                      &dmior, &dtior, &dcos1, &dcos2);
      fresnel_adjoint(r.mior, nd.tior, nd.cos2, nd.cos1, 0.5f * dfactor,
                      &dmior, &dtior, &dcos2, &dcos1);
      dr[R_MIOR] += dmior;
      if (1.0f - nd.sin2 * nd.sin2 > 0.0f) {
        const float dmag = nd.cos1 < 0.0f ? -dcos2 : dcos2;
        const float dsin2 = -2.0f * nd.sin2 * (dmag * 0.5f / nd.cos2mag);
        dratio += dsin2 * nd.sin1;
        dsin1 += dsin2 * nd.ratio;
      }
    }
    // ratio = mior / tior (mior where tior == 0); sin1 = sqrt_pos(1 - cos1^2);
    // cos1 = clip(d.n, -1, 1).
    if (nd.tior != 0.0f) {
      dr[R_MIOR] += dratio / nd.tior;
      dtior -= dratio * nd.ratio / nd.tior;
    } else {
      dr[R_MIOR] += dratio;
    }
    G.medium(S_IOR, B_IOR, nd.tgt, dtior);
    if (1.0f - nd.cos1 * nd.cos1 > 0.0f) dcos1 -= dsin1 * nd.cos1 / nd.sin1;
    if (nd.dot_dn >= -1.0f && nd.dot_dn <= 1.0f) {
      dr[R_DX] += dcos1 * nx;
      dr[R_DY] += dcos1 * ny;
      dr[R_DZ] += dcos1 * nz;
      dnx += dcos1 * r.dx;
      dny += dcos1 * r.dy;
      dnz += dcos1 * r.dz;
    }
    dop -= dT;  // transparency = 1 - opacity
  }
  G.sph(S_OP, k, dop);

  // n = (h - centre) / |h - centre|, h = o + t d.
  float drnx = 0.0f, drny = 0.0f, drnz = 0.0f;
  normalize_adjoint(nd.rnx, nd.rny, nd.rnz, nd.n2, nd.ninv, dnx, dny, dnz,
                    &drnx, &drny, &drnz);
  dhx += drnx;
  dhy += drny;
  dhz += drnz;
  G.sph(S_PX, k, -drnx);
  G.sph(S_PY, k, -drny);
  G.sph(S_PZ, k, -drnz);
  dr[R_OX] += dhx;
  dr[R_OY] += dhy;
  dr[R_OZ] += dhz;
  dr[R_DX] += nd.t * dhx;
  dr[R_DY] += nd.t * dhy;
  dr[R_DZ] += nd.t * dhz;
  hit_t_adjoint(sc, G, r, k, dhx * r.dx + dhy * r.dy + dhz * r.dz, dr);
}

RT_HD void node_adjoint(const SceneView& sc, const GradView& G, const Ray& r,
                        int max_depth, const float* gw, const float* dc0,
                        const float* dc1, float* dr) {
  node_adjoint(sc, BruteForce{&sc}, G, r, max_depth, gw, dc0, dc1, dr);
}

}  // namespace rt
