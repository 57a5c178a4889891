// The strict-semantics oracle renderer, one thread per pixel, CUDA C++ for
// sm_90a: the port's copy of native/rt_oracle.cpp, written for the card.
//
// It renders the reference tracer's observable semantics bug for bug
// (raytracer.h:410-636 and callees; raytpu_torch/oracle.py's module
// docstring derives them): stack-capacity truncation, the stale colourSum,
// NaN total internal reflection and the background opacity the scene
// carries, as a recursion with a stack budget.  It replaces no TPU kernel:
// raytpu renders the oracle on the host only (raytpu/oracle.py in numpy,
// raytpu/native.py through g++).  Its plain version is
// raytpu_torch.oracle.render_oracle, which it equals bit for bit.
//
// It is a scalar recursion whose work depends on each sample's tree; what
// bounds it is fp32 ALU work and divergence, not bytes (a pixel reads the
// scene and writes 12 bytes).  The design: one thread a camera sample
// (oracle_sample_kernel writes each sample's colour to a scratch the
// wrapper allocates), then one thread a pixel (oracle_sum_kernel adds its
// alias^2 samples from zero in rt_render's order, rt_oracle.cpp:378-414).
// A warp waits for the deepest of 32 trees, not of 32 x alias^2.  The
// scene is read from global memory through the cache; nothing is staged.
//
// Why not the reference's own OpenCL layout (raytrace_kernel.cl, one
// work-item a pixel looping over its samples): built that way at -O3
// (ptxas -O1 to -O3, 223 registers), the card's result differed from the
// host build on a few pixels in every frame larger than 96x72 (54 of 360,000
// channels at 400x300 cap 5, 4,614 of 1,440,000 at 800x600 cap 6), a value
// that lives across the recursive call in the sample loop coming back
// wrong; at ptxas -O0, with trace() not inlined, or with a thread a sample
// it was exact (measured on an H100; PERF.md).  A thread a sample is also
// the fastest of the three.
//
// Bit parity with the host oracle:
//   * built with -fmad=false and without fast math: every multiply and add
//     rounds on its own, '/' and sqrtf are IEEE, denormals are kept.  The
//     FMA experiment's contractions are explicit fmaf calls under
//     fma_mask, the approximate lowerings explicit under approx_mask.
//   * the masks and wide_fresnel are kernel arguments, not process
//     globals: each launch names its own experiment.
//
// The recursion: trace() recurses up to `cap` deep on the thread's stack.
// The stack's size cannot be known when the kernel is compiled, so the C
// entry raises cudaLimitStackSize to kStackBase + cap * kStackPerLevel
// bytes before the launch (never lowering it); chip_smoke.py holds the
// ptxas frame of trace() within kStackPerLevel.  A cap below 1 or a stack
// the device refuses returns an error.
//
// Compiled as plain C++ (g++ -x c++ -O2 -ffp-contract=off, no __CUDACC__),
// this file gives raytpu_oracle_host, the kernels' per-sample and per-pixel
// functions over a pixel range on the CPU, for the tests.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_HD __host__ __device__
#else
#define RT_HD
#endif

#include <cmath>
#include <cstdint>

namespace {

constexpr float kRayEps = 1e-5f;       // raytracer.h:86
constexpr float kContainEps = 1e-6f;   // raytracer.h:252
constexpr float kFresnelEps = 1e-6f;   // raytracer.h:376
constexpr float kMaxDist = 1000.0f;    // raytracer.h:156
constexpr float kBigT = 10000.0f;      // raytracer.h:119
constexpr float kMinSig = 1e-3f;       // raytracer.h:236
constexpr float kShift = 0.01f;        // raytracer.h:688/:831
constexpr float kTol = 1e-3f;          // algebra.h:10

struct V3 {
  float x, y, z;
};

RT_HD inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
RT_HD inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
RT_HD inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
RT_HD inline V3 hadamard(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

// The golden-residual experiments of rt_oracle.cpp, per launch.
//   fma: the FMA-contraction sites a GPU compiler may contract
//     bit 0: dot products fma-chained (vdot, raytrace_kernel.cl:96-100)
//     bit 1: quadratic radicands b*b - 4ac as fma (raytrace_kernel.cl:170)
//     bit 2: c = |disp|^2 - r^2 as fma (raytrace_kernel.cl:167)
//     bit 3: Fresnel numerator n1 c1 - n2 c2 as fma (:409-411)
//     bit 4: point = origin + t*dir / probe shifts as per-component fma
//   approx: approximate division/sqrt lowerings and 1-ulp probes at the
//   per-bounce sites (rt_oracle.cpp:53-72)
//     bit 0: a/b      -> a * (1.0f/b)        (reciprocal-multiply)
//     bit 1: sqrt(x)  -> x * (1.0f/sqrt(x))  (rsqrt-multiply; 0 stays 0)
//     bit 2: quotients nudged 1 ulp up      (sensitivity probe)
//     bit 3: quotients nudged 1 ulp down
//     bit 4: sqrts nudged 1 ulp up
//     bit 5: sqrts nudged 1 ulp down
// Both 0: the pinned strict semantics.
struct Knobs {
  int fma;
  int approx;
  bool wide_fresnel;  // double Fresnel intermediates (the CPU build)
};

RT_HD inline float fdiv(const Knobs& k, float a, float b) {
  float q = (k.approx & 1) ? a * (1.0f / b) : a / b;
  if (k.approx & 4) q = nextafterf(q, INFINITY);
  if (k.approx & 8) q = nextafterf(q, -INFINITY);
  return q;
}

RT_HD inline float nudgeSqrt(const Knobs& k, float r) {
  if (k.approx & 16) r = nextafterf(r, INFINITY);
  if (k.approx & 32) r = nextafterf(r, -INFINITY);
  return r;
}

RT_HD inline float fsqrt(const Knobs& k, float x) {
  float r = ((k.approx & 2) && x > 0.0f) ? x * (1.0f / sqrtf(x)) : sqrtf(x);
  return nudgeSqrt(k, r);
}

RT_HD inline float dot(const Knobs& k, V3 a, V3 b) {
  if (k.fma & 1) return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

RT_HD inline V3 madd(const Knobs& k, float t, V3 d, V3 o) {  // o + t*d
  if (k.fma & 16) return {fmaf(t, d.x, o.x), fmaf(t, d.y, o.y), fmaf(t, d.z, o.z)};
  return o + t * d;
}

RT_HD inline V3 unit(const Knobs& k, V3 a) {
  float inv = fdiv(k, 1.0f, fsqrt(k, dot(k, a, a)));
  return inv * a;
}

struct Medium {
  V3 matte;
  float ior;
  float opacity;
};

// spheres: 12 rows * n [px py pz rad mr mg mb gr gg gb opacity ior];
// lights: 6 rows * l [px py pz cr cg cb] (raytpu_torch.kernels.trace_cuda's
// scene_tables, native/rt_oracle.cpp's layout).
struct SceneView {
  const float* sph;
  int n;
  const float* lgt;
  int l;
  Medium bg;

  RT_HD V3 centre(int i) const { return {sph[i], sph[n + i], sph[2 * n + i]}; }
  RT_HD float radius(int i) const { return sph[3 * n + i]; }
  RT_HD V3 matte(int i) const { return {sph[4 * n + i], sph[5 * n + i], sph[6 * n + i]}; }
  RT_HD V3 gloss(int i) const { return {sph[7 * n + i], sph[8 * n + i], sph[9 * n + i]}; }
  RT_HD float opacity(int i) const { return sph[10 * n + i]; }
  RT_HD float ior(int i) const { return sph[11 * n + i]; }
  RT_HD V3 lightPos(int j) const { return {lgt[j], lgt[l + j], lgt[2 * l + j]}; }
  RT_HD V3 lightCol(int j) const { return {lgt[3 * l + j], lgt[4 * l + j], lgt[5 * l + j]}; }
};

RT_HD inline bool significant(V3 c) {
  // NaN channels compare false, like the C >= (raytracer.h:238-240).
  return c.x >= kMinSig || c.y >= kMinSig || c.z >= kMinSig;
}

// Smallest quadratic root > kRayEps for |o + t d - c| = r, else kBigT.
RT_HD float sphereRoot(const Knobs& k, V3 o, V3 d, V3 c, float r, bool* ok) {
  V3 disp = o - c;
  float a = dot(k, d, d);
  float b = 2.0f * dot(k, d, disp);
  float cc = (k.fma & 4) ? fmaf(-r, r, dot(k, disp, disp)) : dot(k, disp, disp) - r * r;
  float radicand = (k.fma & 2) ? fmaf(b, b, -(4.0f * a * cc)) : b * b - 4.0f * a * cc;
  float best = kBigT;
  if (radicand >= 0.0f) {
    float root = fsqrt(k, radicand);
    float den = 2.0f * a;
    float u0 = fdiv(k, -b + root, den);
    float u1 = fdiv(k, -b - root, den);
    if (u0 > kRayEps && u0 < best) best = u0;
    if (u1 > kRayEps && u1 < best) best = u1;
  }
  *ok = best < kBigT;
  return best;
}

struct HitInfo {
  bool found;
  int index;
  V3 point, normal;
  float sqDist;
};

RT_HD HitInfo closestHit(const Knobs& k, const SceneView& s, V3 o, V3 d) {
  HitInfo h{false, -1, {0, 0, 0}, {0, 0, 0}, 0.0f};
  float minT = kMaxDist;
  for (int i = 0; i < s.n; ++i) {
    bool ok;
    float t = sphereRoot(k, o, d, s.centre(i), s.radius(i), &ok);
    if (ok && t < minT) {
      minT = t;
      h.found = true;
      h.index = i;
    }
  }
  if (h.found) {
    h.point = madd(k, minT, d, o);
    h.normal = unit(k, h.point - s.centre(h.index));
    V3 seg = minT * d;
    h.sqDist = dot(k, seg, seg);
  }
  return h;
}

RT_HD bool lineOfSightClear(const Knobs& k, const SceneView& s, V3 a, V3 b) {
  V3 gapVec = b - a;
  float gap = dot(k, gapVec, gapVec);
  HitInfo h = closestHit(k, s, a, unit(k, gapVec));
  return !(h.found && h.sqDist < gap);
}

RT_HD V3 matteLightSum(const Knobs& k, const SceneView& s, V3 point, V3 normal) {
  V3 total{0, 0, 0};
  for (int j = 0; j < s.l; ++j) {
    V3 lp = s.lightPos(j);
    if (!lineOfSightClear(k, s, point, lp)) continue;
    V3 toLight = lp - point;
    float incidence = dot(k, normal, unit(k, toLight));
    if (incidence > 0.0f) {
      float w = fdiv(k, incidence, dot(k, toLight, toLight));
      total = total + w * s.lightCol(j);
    }
  }
  return total;
}

RT_HD int containerOf(const Knobs& k, const SceneView& s, V3 p) {
  for (int i = 0; i < s.n; ++i) {
    float r = s.radius(i) + kContainEps;
    V3 d = p - s.centre(i);
    if (dot(k, d, d) <= r * r) return i;
  }
  return -1;
}

RT_HD float fresnelTerm(const Knobs& k, float n1, float n2, float c1, float c2) {
  float left = n1 * c1;
  float right = n2 * c2;
  if (k.wide_fresnel) {
    // The CPU build's double intermediates (raytracer.h:380-384).
    double num = static_cast<double>(left - right);
    double den = static_cast<double>(left + right);
    den *= den;
    if (den < kFresnelEps) return 1.0f;
    float refl = static_cast<float>(num * num / den);
    return refl > 1.0f ? 1.0f : refl;
  }
  float num = (k.fma & 8) ? fmaf(n1, c1, -right) : left - right;
  float den = (left + right) * (left + right);
  if (den < kFresnelEps) return 1.0f;
  float refl = fdiv(k, num * num, den);
  return refl > 1.0f ? 1.0f : refl;  // NaN stays NaN, as in the C cap
}

struct Refraction {
  V3 dir;
  float factor;  // NaN under TIR: the reference's fall-through
  Medium target;
};

RT_HD Refraction refractAt(const Knobs& k, const SceneView& s, V3 point,
                           V3 normal, V3 d, float mediumIor) {
  float c1raw = dot(k, d, normal);
  float c1 = c1raw, s1;
  if (c1raw <= -1.0f) {
    c1 = -1.0f;
    s1 = 0.0f;
  } else if (c1raw >= 1.0f) {
    c1 = 1.0f;
    s1 = 0.0f;
  } else {
    // The double sqrt of raytracer.h:663-684; its float result still takes
    // the 1-ulp sensitivity probes.
    s1 = nudgeSqrt(k, static_cast<float>(sqrt(1.0 - static_cast<double>(c1 * c1))));
  }

  V3 probe = madd(k, kShift, d, point);
  int inside = containerOf(k, s, probe);
  Refraction r;
  if (inside >= 0) {
    r.target = {s.matte(inside), s.ior(inside), s.opacity(inside)};
  } else {
    r.target = {{0, 0, 0}, 1.0f, s.bg.opacity};
  }

  float ratio = fdiv(k, mediumIor, r.target.ior);
  float s2 = ratio * s1;

  // k^2 + 2 c1 k + (1 - 1/ratio^2) = 0; the root whose bent direction best
  // aligns with the incident one, above the -0.1 floor (algebra.h:45,
  // raytracer.h:750-771).  A TIR radicand gives NaN roots that never beat
  // the floor, leaving dir = 0.
  float qb = 2.0f * c1;
  float qc = 1.0f - fdiv(k, 1.0f, ratio * ratio);
  float radicand = (k.fma & 2) ? fmaf(qb, qb, -(4.0f * qc)) : qb * qb - 4.0f * qc;
  float roots[2];
  int nroots;
  if (fabsf(radicand) < kTol) {
    roots[0] = -qb * 0.5f;
    nroots = 1;
  } else {
    float root = fsqrt(k, radicand);
    roots[0] = (-qb + root) * 0.5f;
    roots[1] = (-qb - root) * 0.5f;
    nroots = 2;
  }
  float bestAlign = -0.1f;
  r.dir = {0, 0, 0};
  for (int i = 0; i < nroots; ++i) {
    V3 cand = d + roots[i] * normal;
    float align = dot(k, d, cand);
    if (align > bestAlign) {
      bestAlign = align;
      r.dir = cand;
    }
  }

  float c2 = fsqrt(k, 1.0f - s2 * s2);  // NaN when |s2| > 1
  if (c1 < 0.0f) c2 = -c2;
  float rs = fresnelTerm(k, mediumIor, r.target.ior, c1, c2);
  float rp = fresnelTerm(k, mediumIor, r.target.ior, c2, c1);
  r.factor = static_cast<float>((rs + rp) * 0.5);
  return r;
}

// The stack machine as recursion with a budget: `anc` counts the ancestor
// resume-frames the reference would hold.  At anc == cap-1 both pushes are
// dropped and the colourSum protocol double-counts the node's emission (2m,
// or 4m when its reflection colour is significant); a hit with
// insignificant intensity returns the caller's running partial colour.
RT_HD V3 trace(const Knobs& k, const SceneView& s, V3 o, V3 d, V3 intensity,
               const Medium& medium, int anc, V3 parentPartial, int cap) {
  HitInfo hit = closestHit(k, s, o, d);
  if (!hit.found) return hadamard(intensity, medium.matte);
  if (!significant(intensity)) return parentPartial;

  float opacity = s.opacity(hit.index);
  float transparency = 1.0f - opacity;

  V3 m{0, 0, 0};
  if (opacity > 0.0f) {
    V3 term = hadamard(intensity, s.matte(hit.index));
    term = opacity * term;
    m = hadamard(matteLightSum(k, s, hit.point, hit.normal), term);
  }
  if (!(transparency > 0.0f)) return m;

  V3 refrIntensity = transparency * intensity;
  Refraction rf = refractAt(k, s, hit.point, hit.normal, d, medium.ior);

  float prod = transparency * rf.factor;
  V3 reflCol = {prod, prod, prod};
  reflCol = reflCol + medium.opacity * s.gloss(hit.index);
  reflCol = hadamard(intensity, reflCol);
  bool reflSig = significant(reflCol);

  if (anc >= cap - 1) {
    V3 twoM = m + m;
    return reflSig ? twoM + twoM : twoM;
  }

  V3 childI = (1.0f - rf.factor) * refrIntensity;
  V3 c = m + trace(k, s, hit.point, rf.dir, childI, rf.target, anc + 1, m, cap);

  if (reflSig) {
    float perp = 2.0f * dot(k, d, hit.normal);
    V3 rd = unit(k, d - perp * hit.normal);
    V3 ro = madd(k, kShift, rd, hit.point);
    c = c + trace(k, s, ro, rd, reflCol, medium, anc + 1, c, cap);
  }
  return c;
}

struct Camera {
  float xstep, ystep, aspect, sub, weight, zoom;
  int width, height, alias;
};

// rt_render's camera (raytrace_kernel.cl:908-952); the plane's world size
// is the caller's, as in rt_render.
RT_HD Camera make_camera(int width, int height, float zoom, float world_w,
                         float world_h, int alias) {
  Camera c;
  c.xstep = world_w / static_cast<float>(width);
  c.ystep = world_h / static_cast<float>(height);
  c.aspect = world_w / world_h;
  c.sub = c.xstep / static_cast<float>(alias);
  c.weight = 1.0f / static_cast<float>(alias * alias);
  c.zoom = zoom;
  c.width = width;
  c.height = height;
  c.alias = alias;
  return c;
}

// Sample si = i * alias + j of pixel `gid` (rt_render's loop order).
RT_HD V3 trace_sample(const Knobs& k, const SceneView& s, const Camera& cam,
                      long long gid, int si, int cap) {
  const int i = si / cam.alias, j = si % cam.alias;
  float px = (static_cast<float>(gid % cam.width) -
              static_cast<float>(cam.width) * 0.5f) * cam.xstep;
  float py = (static_cast<float>(cam.height) * 0.5f -
              static_cast<float>(gid / cam.width)) * cam.ystep;
  float x = (px + static_cast<float>(j) * cam.sub) * cam.aspect;
  float y = py + static_cast<float>(i) * cam.sub;
  V3 dir = unit(k, {x, y, cam.zoom});
  return trace(k, s, {0, 0, 0}, dir, {1, 1, 1}, s.bg, 0, {0, 0, 0}, cap);
}

// A pixel's colour from its alias^2 samples (rgb each, in the order of si),
// added from zero as rt_render adds them.
RT_HD V3 sum_samples(const Camera& cam, const float* samples) {
  V3 colour{0, 0, 0};
  for (int si = 0; si < cam.alias * cam.alias; ++si) {
    const V3 c{samples[3 * si], samples[3 * si + 1], samples[3 * si + 2]};
    colour = colour + cam.weight * c;
  }
  return colour;
}

RT_HD SceneView make_view(const float* spheres, int n_spheres,
                          const float* lights, int n_lights, const float* bg) {
  return SceneView{spheres, n_spheres, lights, n_lights,
                   {{bg[0], bg[1], bg[2]}, bg[3], bg[4]}};
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 128;
// Per-thread stack: the sample kernel's own frame, then one trace() frame
// (its callees inlined) for each level of recursion.  chip_smoke.py holds
// the ptxas frames within kStackBase and kStackPerLevel.
constexpr size_t kStackBase = 1024;
constexpr size_t kStackPerLevel = 640;

// One thread a camera sample: sample t = pixel * alias^2 + si.
__global__ void __launch_bounds__(kBlock)
oracle_sample_kernel(const float* __restrict__ spheres, int n_spheres,
                     const float* __restrict__ lights, int n_lights,
                     const float* __restrict__ bg, Camera cam, int cap, Knobs k,
                     long long offset, long long count,
                     float* __restrict__ samples) {
  const long long t = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int spp = cam.alias * cam.alias;
  if (t >= count * spp) return;
  const SceneView s = make_view(spheres, n_spheres, lights, n_lights, bg);
  const V3 c = trace_sample(k, s, cam, offset + t / spp, (int)(t % spp), cap);
  samples[3 * t] = c.x;
  samples[3 * t + 1] = c.y;
  samples[3 * t + 2] = c.z;
}

// One thread a pixel: its samples added in order.
__global__ void __launch_bounds__(kBlock)
oracle_sum_kernel(Camera cam, long long count,
                  const float* __restrict__ samples, float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (idx >= count) return;
  const V3 c = sum_samples(cam, samples + 3 * idx * cam.alias * cam.alias);
  out[3 * idx] = c.x;
  out[3 * idx + 1] = c.y;
  out[3 * idx + 2] = c.z;
}

cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Raise the current device's per-thread stack to `bytes` where it is lower.
cudaError_t ensure_stack(size_t bytes) {
  size_t have = 0;
  cudaError_t err = cudaDeviceGetLimit(&have, cudaLimitStackSize);
  if (err != cudaSuccess || have >= bytes) return err;
  return cudaDeviceSetLimit(cudaLimitStackSize, bytes);
}

}  // namespace

// The per-thread stack a launch at `cap` asks for, in bytes.
extern "C" int raytpu_oracle_stack_bytes(int cap) {
  return (int)(kStackBase + (size_t)cap * kStackPerLevel);
}

extern "C" int raytpu_oracle_stack_base() { return (int)kStackBase; }

extern "C" int raytpu_oracle_stack_per_level() { return (int)kStackPerLevel; }

// out: (count, 3) linear colour of the pixels offset .. offset+count-1 of a
// width x height frame, as rt_render writes it.  samples: (count * alias^2,
// 3) scratch, which the caller allocates.
extern "C" int raytpu_oracle(const float* spheres, int n_spheres,
                             const float* lights, int n_lights, const float* bg,
                             int width, int height, float zoom, float world_w,
                             float world_h, int alias, int cap, int wide_fresnel,
                             int fma_mask, int approx_mask, long long offset,
                             long long count, float* samples, float* out,
                             int device, void* stream) {
  if (cap < 1 || alias < 1 || width < 1 || height < 1 || n_spheres < 0 ||
      n_lights < 0 || offset < 0 || count < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long sample_blocks = (count * alias * alias + kBlock - 1) / kBlock;
  if (sample_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (count == 0) return (int)cudaSuccess;
  err = ensure_stack((size_t)raytpu_oracle_stack_bytes(cap));
  if (err != cudaSuccess) return (int)err;
  const Camera cam = make_camera(width, height, zoom, world_w, world_h, alias);
  const Knobs k{fma_mask, approx_mask, wide_fresnel != 0};
  oracle_sample_kernel<<<(unsigned)sample_blocks, kBlock, 0,
                         (cudaStream_t)stream>>>(
      spheres, n_spheres, lights, n_lights, bg, cam, cap, k, offset, count,
      samples);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  oracle_sum_kernel<<<(unsigned)((count + kBlock - 1) / kBlock), kBlock, 0,
                      (cudaStream_t)stream>>>(cam, count, samples, out);
  return (int)cudaGetLastError();
}

#else  // plain C++: the CPU entry point for the tests

#include <vector>

// The kernels' work over the pixels offset .. offset+count-1, pixel after
// pixel: each sample traced by trace_sample, then added by sum_samples;
// the same arguments as raytpu_oracle without the scratch, device and
// stream.
extern "C" void raytpu_oracle_host(const float* spheres, int n_spheres,
                                   const float* lights, int n_lights,
                                   const float* bg, int width, int height,
                                   float zoom, float world_w, float world_h,
                                   int alias, int cap, int wide_fresnel,
                                   int fma_mask, int approx_mask,
                                   long long offset, long long count,
                                   float* out) {
  const SceneView s = make_view(spheres, n_spheres, lights, n_lights, bg);
  const Camera cam = make_camera(width, height, zoom, world_w, world_h, alias);
  const Knobs k{fma_mask, approx_mask, wide_fresnel != 0};
  std::vector<float> samples(3 * (size_t)alias * alias);
  for (long long idx = 0; idx < count; ++idx) {
    for (int si = 0; si < alias * alias; ++si) {
      const V3 c = trace_sample(k, s, cam, offset + idx, si, cap);
      samples[3 * si] = c.x;
      samples[3 * si + 1] = c.y;
      samples[3 * si + 2] = c.z;
    }
    const V3 c = sum_samples(cam, samples.data());
    out[3 * idx] = c.x;
    out[3 * idx + 1] = c.y;
    out[3 * idx + 2] = c.z;
  }
}

#endif
