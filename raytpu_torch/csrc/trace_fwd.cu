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
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDepth = 8;  // compile-time bound of the per-thread stack
constexpr int kBlock = 128;

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
  const float* s;  // (SCENE_ROWS, n) in shared memory
  const float* l;  // (LIGHT_ROWS, nl)
  const float* bg; // (BG_ROWS,)
  int n, nl;
  __device__ float sph(int row, int i) const { return s[row * n + i]; }
  __device__ float light(int row, int i) const { return l[row * nl + i]; }
};

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float sqrt_pos(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// calcIntersection (raytracer.h:145-194): index of the closest sphere with a
// root in (1e-5, 1000), strict '<' so the lowest index wins ties; -1 if none.
__device__ int closest_hit(const SceneView& sc, const Ray& r, float* t_out) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv2a = 1.0f / (a == 0.0f ? 1.0f : 2.0f * a);
  float min_t = kMaxDist;
  int idx = -1;
  for (int i = 0; i < sc.n; ++i) {
    const float px = r.ox - sc.sph(S_PX, i);
    const float py = r.oy - sc.sph(S_PY, i);
    const float pz = r.oz - sc.sph(S_PZ, i);
    const float rad = sc.sph(S_RAD, i);
    const float b = 2.0f * (r.dx * px + r.dy * py + r.dz * pz);
    const float c = (px * px + py * py + pz * pz) - rad * rad;
    const float radicand = b * b - 4.0f * a * c;
    if (!(radicand >= 0.0f)) continue;
    const float root = sqrt_pos(radicand);
    const float u0 = (-b + root) * inv2a;
    const float u1 = (-b - root) * inv2a;
    const float t0 = u0 > kEpsRay ? u0 : kBigT;
    const float t1 = u1 > kEpsRay ? u1 : kBigT;
    const float t = fminf(t0, t1);
    if (t < min_t) {  // min_t <= 1000 < kBigT, so this also means "found"
      min_t = t;
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
// with a real radicand and the vertex inside the interval.
__device__ bool shadow_blocked(const SceneView& sc, float px, float py,
                               float pz, float lx, float ly, float lz,
                               float gap) {
  const float inv = inv_sqrt(gap == 0.0f ? 1.0f : gap);
  const float dx = (lx - px) * inv, dy = (ly - py) * inv, dz = (lz - pz) * inv;
  const float a = dx * dx + dy * dy + dz * dz;
  const float cc = fminf(sqrtf(gap), kMaxDist);
  const float c2 = cc * cc;
  const float two_a_eps = 2.0f * a * kEpsRay;
  const float two_a_c = 2.0f * a * cc;
  for (int i = 0; i < sc.n; ++i) {
    const float ex = px - sc.sph(S_PX, i);
    const float ey = py - sc.sph(S_PY, i);
    const float ez = pz - sc.sph(S_PZ, i);
    const float rad = sc.sph(S_RAD, i);
    const float b = 2.0f * (dx * ex + dy * ey + dz * ez);
    const float c = (ex * ex + ey * ey + ez * ez) - rad * rad;
    const float q_eps = (a * kEpsRay + b) * kEpsRay + c;
    const float q_c = a * c2 + b * cc + c;
    const bool neg_eps = q_eps < 0.0f;
    const bool neg_c = q_c < 0.0f;
    const float radicand = b * b - 4.0f * a * c;
    const float mb = -b;
    const bool vertex_in = (mb > two_a_eps) && (mb < two_a_c);
    if ((neg_eps != neg_c) ||
        (!neg_eps && !neg_c && radicand >= 0.0f && vertex_in)) {
      return true;
    }
  }
  return false;
}

// primaryContainer (raytracer.h:245-270): first sphere whose
// (radius + 1e-6)-ball holds the point, else -1.
__device__ int container(const SceneView& sc, float px, float py, float pz) {
  for (int i = 0; i < sc.n; ++i) {
    const float ex = px - sc.sph(S_PX, i);
    const float ey = py - sc.sph(S_PY, i);
    const float ez = pz - sc.sph(S_PZ, i);
    const float r = sc.sph(S_RAD, i) + kEpsContain;
    if (ex * ex + ey * ey + ez * ez <= r * r) return i;
  }
  return -1;
}

// polarisedReflection (raytracer.h:370-403), float32.
__device__ float fresnel(float n1, float n2, float c1, float c2) {
  const float left = n1 * c1;
  const float right = n2 * c2;
  const float num = left - right;
  const float den2 = (left + right) * (left + right);
  if (den2 < kEpsFresnel) return 1.0f;
  const float refl = num * num / den2;
  return refl < 1.0f ? refl : 1.0f;
}

__device__ __forceinline__ bool dead(float r, float g, float b) {
  return r == 0.0f && g == 0.0f && b == 0.0f;
}

// One camera sample's whole tree; adds its emissions into (er, eg, eb).
__device__ void trace_tree(const SceneView& sc, int max_depth, float dx,
                           float dy, float dz, float* er, float* eg,
                           float* eb) {
  Ray stack[kMaxDepth];
  int top = 0;
  Ray r{0.0f, 0.0f, 0.0f, dx, dy, dz, 1.0f, 1.0f, 1.0f,
        sc.bg[B_MR], sc.bg[B_MG], sc.bg[B_MB], sc.bg[B_IOR], sc.bg[B_OP], 0};
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  for (;;) {
    bool next = false;
    float t;
    const int hit = closest_hit(sc, r, &t);
    const bool sig = r.ir >= kMinSig || r.ig >= kMinSig || r.ib >= kMinSig;
    if (hit < 0) {
      // A miss paints the medium whatever the ray's significance.
      sr += r.ir * r.mr;
      sg += r.ig * r.mg;
      sb += r.ib * r.mb;
    } else if (sig) {
      const float hx = r.ox + t * r.dx;
      const float hy = r.oy + t * r.dy;
      const float hz = r.oz + t * r.dz;
      float nx = hx - sc.sph(S_PX, hit);
      float ny = hy - sc.sph(S_PY, hit);
      float nz = hz - sc.sph(S_PZ, hit);
      const float n2 = nx * nx + ny * ny + nz * nz;
      const float ninv = inv_sqrt(n2 == 0.0f ? 1.0f : n2);
      nx *= ninv;
      ny *= ninv;
      nz *= ninv;
      const float op = sc.sph(S_OP, hit);
      const float transparency = 1.0f - op;

      // calculateMatte (raytracer.h:313-367).
      if (op > 0.0f) {
        float lr = 0.0f, lg = 0.0f, lb = 0.0f;
        for (int l = 0; l < sc.nl; ++l) {
          const float lx = sc.light(L_PX, l), ly = sc.light(L_PY, l),
                      lz = sc.light(L_PZ, l);
          const float ex = lx - hx, ey = ly - hy, ez = lz - hz;
          const float gap = ex * ex + ey * ey + ez * ez;
          const float inv = inv_sqrt(gap == 0.0f ? 1.0f : gap);
          const float incidence = nx * ex * inv + ny * ey * inv + nz * ez * inv;
          if (!(incidence > 0.0f)) continue;
          if (shadow_blocked(sc, hx, hy, hz, lx, ly, lz, gap)) continue;
          const float w = incidence / (gap == 0.0f ? 1.0f : gap);
          lr += w * sc.light(L_CR, l);
          lg += w * sc.light(L_CG, l);
          lb += w * sc.light(L_CB, l);
        }
        sr += op * r.ir * sc.sph(S_MR, hit) * lr;
        sg += op * r.ig * sc.sph(S_MG, hit) * lg;
        sb += op * r.ib * sc.sph(S_MB, hit) * lb;
      }

      if (r.level < max_depth && transparency > 0.0f) {
        // calculateRefraction (raytracer.h:642-815).
        const float dot_dn = r.dx * nx + r.dy * ny + r.dz * nz;
        const float cos1 = dot_dn < -1.0f ? -1.0f : (dot_dn > 1.0f ? 1.0f : dot_dn);
        const float sin1 = sqrt_pos(1.0f - cos1 * cos1);
        const int tgt = container(sc, hx + kShift * r.dx, hy + kShift * r.dy,
                                  hz + kShift * r.dz);
        const bool t_in = tgt >= 0;
        const float tior = t_in ? sc.sph(S_IOR, tgt) : sc.bg[B_IOR];
        const float tmop = t_in ? sc.sph(S_OP, tgt) : sc.bg[B_OP];
        const float tmr = t_in ? sc.sph(S_MR, tgt) : sc.bg[B_MR];
        const float tmg = t_in ? sc.sph(S_MG, tgt) : sc.bg[B_MG];
        const float tmb = t_in ? sc.sph(S_MB, tgt) : sc.bg[B_MB];

        const float ratio = r.mior / (tior == 0.0f ? 1.0f : tior);
        const float sin2 = ratio * sin1;
        const bool tir = sin2 <= -1.0f || sin2 >= 1.0f;

        // solveQuadratic(1, 2 cos1, 1 - 1/ratio^2) (algebra.h:22-65).
        const float qb = 2.0f * cos1;
        const float ratio2 = ratio * ratio;
        const float qc = 1.0f - 1.0f / (ratio2 == 0.0f ? 1.0f : ratio2);
        const float radicand = qb * qb - 4.0f * qc;
        const bool rad_zero = fabsf(radicand) < kTol;
        const float root = sqrt_pos(radicand);
        const float dbl = -qb * 0.5f;
        const float r0 = rad_zero ? dbl : (-qb + root) * 0.5f;
        const float r1 = rad_zero ? dbl : (-qb - root) * 0.5f;

        // The root whose direction best aligns with the incident one; strict
        // '>' against a running max from -0.1, else a zero direction
        // (raytracer.h:750-771).
        const float c0x = r.dx + r0 * nx, c0y = r.dy + r0 * ny, c0z = r.dz + r0 * nz;
        const float c1x = r.dx + r1 * nx, c1y = r.dy + r1 * ny, c1z = r.dz + r1 * nz;
        const float a0 = r.dx * c0x + r.dy * c0y + r.dz * c0z;
        const float a1 = rad_zero ? -INFINITY : r.dx * c1x + r.dy * c1y + r.dz * c1z;
        const float floor_ = -0.1f;
        const bool take0 = a0 > floor_;
        const bool take1 = a1 > fmaxf(a0, floor_);
        const float rdx = take1 ? c1x : (take0 ? c0x : 0.0f);
        const float rdy = take1 ? c1y : (take0 ? c0y : 0.0f);
        const float rdz = take1 ? c1z : (take0 ? c0z : 0.0f);

        float cos2 = sqrt_pos(1.0f - sin2 * sin2);
        cos2 = cos1 < 0.0f ? -cos2 : cos2;
        const float rs = fresnel(r.mior, tior, cos1, cos2);
        const float rp = fresnel(r.mior, tior, cos2, cos1);
        const float factor = tir ? 1.0f : 0.5f * (rs + rp);

        const float rscale = transparency * (1.0f - factor);
        const float r_ir = rscale * r.ir, r_ig = rscale * r.ig, r_ib = rscale * r.ib;

        // Reflection (raytracer.h:552-615): the hit object's gloss scaled by
        // the containing medium's opacity, a reference quirk.
        const float pr = transparency * factor;
        const float rcr = (pr + r.mop * sc.sph(S_GR, hit)) * r.ir;
        const float rcg = (pr + r.mop * sc.sph(S_GG, hit)) * r.ig;
        const float rcb = (pr + r.mop * sc.sph(S_GB, hit)) * r.ib;
        const bool rsig = rcr >= kMinSig || rcg >= kMinSig || rcb >= kMinSig;

        if (rsig) {
          const float perp = 2.0f * (r.dx * nx + r.dy * ny + r.dz * nz);
          float gx = r.dx - perp * nx, gy = r.dy - perp * ny, gz = r.dz - perp * nz;
          const float g2 = gx * gx + gy * gy + gz * gz;
          const float ginv = inv_sqrt(g2 == 0.0f ? 1.0f : g2);
          gx *= ginv;
          gy *= ginv;
          gz *= ginv;
          stack[top++] = Ray{hx + kShift * gx, hy + kShift * gy, hz + kShift * gz,
                             gx, gy, gz, rcr, rcg, rcb,
                             r.mr, r.mg, r.mb, r.mior, r.mop, r.level + 1};
        }
        if (!dead(r_ir, r_ig, r_ib)) {
          // The refracted child starts unshifted at the hit point.
          r = Ray{hx, hy, hz, rdx, rdy, rdz, r_ir, r_ig, r_ib,
                  tmr, tmg, tmb, tior, tmop, r.level + 1};
          next = true;
        }
      }
    }
    if (!next) {
      if (top == 0) break;
      r = stack[--top];
    }
  }
  *er = sr;
  *eg = sg;
  *eb = sb;
}

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
  const float ix = (float)(g % cam.width);
  const float iy = (float)(g / cam.width);
  const float px = (ix - cam.half_w) * cam.xstep;
  const float py = (cam.half_h - iy) * cam.ystep;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int si = 0; si < cam.alias; ++si) {
    for (int sj = 0; sj < cam.alias; ++sj) {
      const float x = (px + (float)sj * cam.sub) * cam.aspect;
      const float y = py + (float)si * cam.sub;
      const float z = cam.zoom;
      const float n2 = x * x + y * y + z * z;
      const float inv = inv_sqrt(n2 == 0.0f ? 1.0f : n2);
      float er, eg, eb;
      trace_tree(sc, max_depth, x * inv, y * inv, z * inv, &er, &eg, &eb);
      acc_r += cam.weight * er;
      acc_g += cam.weight * eg;
      acc_b += cam.weight * eb;
    }
  }
  out[j] = acc_r;
  out[count + j] = acc_g;
  out[2 * count + j] = acc_b;
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
