// Fused dense forward: camera rays -> bounce tree -> pixel colour, one
// thread per camera sample, CUDA C++ for sm_90a.
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
// container probe) at every tree node, and neighbouring samples walk trees
// of different shapes, so warps diverge.
//
// What the design does about it:
//   * One thread per camera sample, not per pixel: a thread walks one tree
//     (trace_common.cuh's sample_forward), so a warp waits for the deepest
//     of its 32 trees, not of its 32 x alias^2.  A block takes whole
//     pixels, kBlock / alias^2 of them (one where alias^2 >= kBlock), so a
//     pixel's samples never straddle two blocks; its sample slots are
//     adjacent, so a warp traces the neighbouring samples of a few pixels.
//   * The order of the sum is pixel_forward's.  Each thread stages its
//     sample's emissions in shared memory; then one thread a pixel adds
//     them with add_sample in the order of s = si * alias + sj, starting
//     from zero, as pixel_forward does.  Built with -fmad=false, the
//     kernel is bit-identical to the previous design (the reference
//     instance below).  Where a pixel has more samples than a block has
//     threads, the block traces them in rounds of kBlock and the pixel's
//     thread adds each round's in order: the buffer stays kBlock samples
//     (1,536 bytes) at any alias, beside the largest tables the wrapper
//     admits (221,204 bytes at 4096 spheres and 1024 lights).
//   * The scene table (12 x N), lights (6 x L) and background (5) are
//     staged once per block in shared memory; every sphere loop then reads
//     shared memory, where converged lanes of a warp read the same word
//     (a broadcast, no bank conflict).
//   * Depth-first walk with an explicit per-thread stack of at most
//     kMaxDepth pending nodes: follow the refraction child, push the
//     reflection child.  Nodes whose intensity is exactly zero are dead and
//     are skipped, so a thread does only its own tree's live work.
//   * Loops stop early where the answer is fixed: the shadow loop at the
//     first blocker, the container loop at the first match, the matte block
//     when the node is masked.
//   * Every division and square root is IEEE (no fast math), 1/sqrtf stands
//     for rsqrt, and it is built with -fmad=false, so that the kernel rounds
//     as the plain PyTorch version does.
//   * The entry raises the kernel's shared-memory limit
//     (cudaFuncSetAttribute) once per device and size, not on every
//     launch, and sets the device only where it is not current.
//
// raytpu_trace_fwd_ref is the previous design, kept as it was: one thread
// per pixel walking its alias^2 trees in a row (pixel_forward).
// chip_smoke.py and the card's tests hold this kernel to it bit for bit and
// time it against it; the main path never calls it.
//
// The per-node arithmetic and the tree walk live in trace_common.cuh, which
// the backward kernel (trace_bwd.cu) shares, so that it differentiates the
// tree this kernel sums.  The kernel allocates nothing and launches on the
// caller's stream; the C entry returns cudaGetLastError() after the launch.
//
// Compiled as plain C++ (g++ -x c++, no __CUDACC__), this file gives CPU
// entry points instead of the kernels: the kernel's block walk (its
// per-sample step, its rounds and its ordered sum, thread by thread) and the
// reference instance's per-pixel function, for the tests.

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>
#endif

#include "trace_common.cuh"

namespace {

using namespace rt;

constexpr int kBlock = 128;
// Blocks an SM the kernel is built for: 64 registers, no spills.  Measured
// on an H100 (PERF.md): 4% faster than the uncapped 72 registers at
// config 3 and the golden frame; 64- and 256-thread blocks were slower.
constexpr int kMinBlocks = 8;

// A block's share of the pixel set: elements [q0, q0 + pixels), whose
// pixels * spp samples it traces in rounds of kBlock sample slots.
struct BlockSpan {
  long long q0;
  int pixels;
  int spp;
};

// Pixel-set elements a block takes: as many whole pixels as kBlock sample
// slots hold, and at least one.
RT_HD int block_pixels(int spp) { return spp >= kBlock ? 1 : kBlock / spp; }

RT_HD BlockSpan block_span(long long b, long long count, int spp) {
  const int per = block_pixels(spp);
  const long long q0 = b * per;
  const long long left = count - q0;
  return BlockSpan{q0, (int)(left < per ? left : per), spp};
}

// Sample slot t of the round starting at block sample r: trace block sample
// r + t (element q0 + (r + t) / spp, sample (r + t) % spp) into the staged
// emissions es (3 x kBlock).
RT_HD void trace_slot(const SceneView& sc, const Camera& cam,
                      const BlockSpan& blk, int r, int t, long long offset,
                      long long stride, long long total_pixels, int max_depth,
                      float* es) {
  const int i = r + t;
  if (i >= blk.pixels * blk.spp) return;
  const long long q = blk.q0 + i / blk.spp;
  float e[3];
  sample_forward(sc, cam, clamp_pixel(offset, q, stride, total_pixels),
                 i % blk.spp, max_depth, e);
  es[t] = e[0];
  es[kBlock + t] = e[1];
  es[2 * kBlock + t] = e[2];
}

// The round's samples of the block's element `own` added to its sum acc
// (3), in the order of s.
RT_HD void sum_slots(const Camera& cam, const BlockSpan& blk, int r, int own,
                     const float* es, float* acc) {
  int lo = own * blk.spp, hi = lo + blk.spp;
  if (lo < r) lo = r;
  if (hi > r + kBlock) hi = r + kBlock;
  for (int i = lo; i < hi; ++i) {
    const float e[3] = {es[i - r], es[kBlock + i - r], es[2 * kBlock + i - r]};
    add_sample(cam, e, acc);
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(kBlock, kMinBlocks)
trace_fwd_kernel(const float* __restrict__ scene, int n_spheres,
                 const float* __restrict__ lights, int n_lights,
                 const float* __restrict__ bg, float* __restrict__ out,
                 long long offset, long long count, long long stride,
                 long long total_pixels, int max_depth, Camera cam) {
  extern __shared__ float smem[];
  const int n_scene = SCENE_ROWS * n_spheres;
  const int n_light = LIGHT_ROWS * n_lights;
  const int n_tbl = n_scene + n_light + BG_ROWS;
  for (int k = threadIdx.x; k < n_tbl; k += kBlock) {
    smem[k] = k < n_scene ? scene[k]
              : k < n_scene + n_light ? lights[k - n_scene]
                                      : bg[k - n_scene - n_light];
  }
  float* es = smem + n_tbl;  // (3, kBlock) staged sample emissions
  __syncthreads();

  const SceneView sc{smem, smem + n_scene, smem + n_scene + n_light,
                     n_spheres, n_lights};
  const BlockSpan blk = block_span(blockIdx.x, count, cam.alias * cam.alias);
  const int own = threadIdx.x;  // sums element q0 + own where own < pixels
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int r = 0; r < blk.pixels * blk.spp; r += kBlock) {
    trace_slot(sc, cam, blk, r, threadIdx.x, offset, stride, total_pixels,
               max_depth, es);
    __syncthreads();
    if (own < blk.pixels) sum_slots(cam, blk, r, own, es, acc);
    __syncthreads();
  }
  if (own < blk.pixels) {
    const long long j = blk.q0 + own;
    out[j] = acc[0];
    out[count + j] = acc[1];
    out[2 * count + j] = acc[2];
  }
}

// The previous design (the reference instance), unchanged.
__global__ void __launch_bounds__(kBlock)
trace_fwd_ref_kernel(const float* __restrict__ scene, int n_spheres,
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
  float rgb[3];
  pixel_forward(sc, cam, g, max_depth, rgb);
  out[j] = rgb[0];
  out[count + j] = rgb[1];
  out[2 * count + j] = rgb[2];
}

constexpr int kMaxDevices = 64;

// The dynamic shared memory each kernel has been allowed on each device:
// cudaFuncSetAttribute runs only when a launch needs more.
std::mutex smem_mutex;
size_t fwd_allowed[kMaxDevices], ref_allowed[kMaxDevices];

cudaError_t allow_smem(const void* kernel, size_t* allowed, int device,
                       size_t bytes) {
  std::lock_guard<std::mutex> lock(smem_mutex);
  if (bytes <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed[device] = bytes;
  return err;
}

cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

size_t table_bytes(int n_spheres, int n_lights) {
  return sizeof(float) *
         (size_t)(SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS);
}

}  // namespace

// out: (3, count) linear colour of the pixels {offset + j*stride}.
extern "C" int raytpu_trace_fwd(const float* scene, int n_spheres,
                                const float* lights, int n_lights,
                                const float* bg, float* out, long long offset,
                                long long count, long long stride,
                                long long total_pixels, int width, int alias,
                                int max_depth, float xstep, float ystep,
                                float aspect, float sub, float half_w,
                                float half_h, float zoom, float weight,
                                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (max_depth < 0 || max_depth > kMaxDepth || alias < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (count <= 0) return (int)cudaSuccess;
  const size_t smem =
      table_bytes(n_spheres, n_lights) + 3 * kBlock * sizeof(float);
  err = allow_smem((const void*)trace_fwd_kernel, fwd_allowed, device, smem);
  if (err != cudaSuccess) return (int)err;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const int per = block_pixels(alias * alias);
  const long long blocks = (count + per - 1) / per;
  trace_fwd_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, out, offset, count, stride,
      total_pixels, max_depth, cam);
  return (int)cudaGetLastError();
}

// The reference instance (the previous design); the same arguments.
extern "C" int raytpu_trace_fwd_ref(const float* scene, int n_spheres,
                                    const float* lights, int n_lights,
                                    const float* bg, float* out,
                                    long long offset, long long count,
                                    long long stride, long long total_pixels,
                                    int width, int alias, int max_depth,
                                    float xstep, float ystep, float aspect,
                                    float sub, float half_w, float half_h,
                                    float zoom, float weight, int device,
                                    void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (max_depth < 0 || max_depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  if (count <= 0) return (int)cudaSuccess;
  const size_t smem = table_bytes(n_spheres, n_lights);
  err = allow_smem((const void*)trace_fwd_ref_kernel, ref_allowed, device, smem);
  if (err != cudaSuccess) return (int)err;
  const Camera cam{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                   width, alias};
  const long long blocks = (count + kBlock - 1) / kBlock;
  trace_fwd_ref_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      scene, n_spheres, lights, n_lights, bg, out, offset, count, stride,
      total_pixels, max_depth, cam);
  return (int)cudaGetLastError();
}

#else  // plain C++: CPU entry points for the tests

namespace {

Camera make_camera(int width, int alias, float xstep, float ystep,
                   float aspect, float sub, float half_w, float half_h,
                   float zoom, float weight) {
  return Camera{xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
                width, alias};
}

}  // namespace

// The kernel's walk, block by block: each round's sample slots traced one
// thread after another, then each element's thread adds them, as the
// kernel's two barriers order them.  out is (3, count).
extern "C" void raytpu_trace_fwd_host(
    const float* scene, int n_spheres, const float* lights, int n_lights,
    const float* bg, float* out, long long offset, long long count,
    long long stride, long long total_pixels, int width, int alias,
    int max_depth, float xstep, float ystep, float aspect, float sub,
    float half_w, float half_h, float zoom, float weight) {
  const SceneView sc{scene, lights, bg, n_spheres, n_lights};
  const Camera cam = make_camera(width, alias, xstep, ystep, aspect, sub,
                                 half_w, half_h, zoom, weight);
  const int spp = alias * alias, per = block_pixels(spp);
  float es[3 * kBlock];
  float acc[kBlock][3];
  for (long long b = 0; b * per < count; ++b) {
    const BlockSpan blk = block_span(b, count, spp);
    for (int own = 0; own < kBlock; ++own) {
      acc[own][0] = acc[own][1] = acc[own][2] = 0.0f;
    }
    for (int r = 0; r < blk.pixels * blk.spp; r += kBlock) {
      for (int t = 0; t < kBlock; ++t) {
        trace_slot(sc, cam, blk, r, t, offset, stride, total_pixels,
                   max_depth, es);
      }
      for (int own = 0; own < blk.pixels; ++own) {
        sum_slots(cam, blk, r, own, es, acc[own]);
      }
    }
    for (int own = 0; own < blk.pixels; ++own) {
      for (int c = 0; c < 3; ++c) out[c * count + blk.q0 + own] = acc[own][c];
    }
  }
}

// The reference instance's per-pixel function; the same arguments.
extern "C" void raytpu_trace_fwd_ref_host(
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

#endif
