// Live-ray compaction between two wavefront levels: a stable prefix-sum
// stream compaction, CUDA C++ for sm_90a.
//
// Replaces: raytpu/kernels/wavefront.py:_make_cursor_copy_kernel (launched
// by _cursor_copy_call), the step that places each block's sorted live
// prefix at a row cursor, and with it the per-block sort of
// _compact_blocked that feeds it.  The function is that of _compact (:435):
// the live children (intensity not all exactly zero), in order, in the
// first slots of a capacity-`cap` state, with their pixel slot ids; live
// children past `cap` are dropped and counted.  Here the kept prefix keeps
// the children's own order (no sort: the level kernel writes ray i's
// children at 2i and 2i+1, so parents in pixel order give children in
// pixel order), the drop count is exact to the ray (the blocked TPU form
// commits whole 128-lane rows and leaves dead fillers at block seams), and
// the slots past the kept prefix hold zero state.
//
// Two kernels, with a cumulative sum of the per-block counts between them
// (torch.cumsum in the wrapper, as jnp.cumsum sits outside the Pallas
// kernel at wavefront.py:569):
//   wf_count_kernel    each block of kBlock children counts its live ones:
//                      a warp ballot and popc per warp, the 32 warp counts
//                      summed through shared memory;
//   wf_scatter_kernel  each block ranks its live children again (ballot,
//                      popc of the lanes below, an exclusive scan of the
//                      warp counts in shared memory) and writes child j at
//                      cursor[block] + rank when that is below `cap`: its
//                      ten fields and the pid of its parent j / 2.  Threads
//                      whose index lies in [kept, cap) write zero state and
//                      the pid (index mod n_slots): in range for the
//                      caller's scatter, and spread so that its atomics on
//                      the zeros they add do not pile onto one address.
//
// What bounds it on this card: bytes.  It does no arithmetic worth the
// name; it reads the three intensity fields of every child twice and the
// other seven fields of the live ones once, and writes 44 bytes per kept
// slot.  The design keeps the reads coalesced (thread j reads element j of
// each field) and never moves a dead child's other fields.  It moves values
// and never rounds them, so it equals the plain version bit for bit.

#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace {

using rt::dead;

constexpr int kBlock = 1024;  // children per block: 32 warps
constexpr int kFields = 10;   // ox oy oz dx dy dz ir ig ib medium-index

__device__ __forceinline__ bool live_child(const float* __restrict__ children,
                                           long long kids, long long j) {
  return j < kids && !dead(children[6 * kids + j], children[7 * kids + j],
                           children[8 * kids + j]);
}

__global__ void __launch_bounds__(kBlock)
wf_count_kernel(const float* __restrict__ children, long long kids,
                int* __restrict__ counts) {
  __shared__ int warp_n[kBlock / 32];
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  const unsigned ballot = __ballot_sync(0xffffffffu, live_child(children, kids, j));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_n[lane];
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) counts[blockIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kBlock)
wf_scatter_kernel(const float* __restrict__ children, long long kids,
                  const int* __restrict__ pid,
                  const long long* __restrict__ starts,
                  const long long* __restrict__ total, long long cap,
                  int n_slots, float* __restrict__ out,
                  int* __restrict__ out_pid, int* __restrict__ src) {
  __shared__ int warp_off[kBlock / 32];
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = live_child(children, kids, j);
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 warp counts
    const int own = warp_off[lane];
    int v = own;
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, s);
      if (lane >= s) v += u;
    }
    warp_off[lane] = v - own;
  }
  __syncthreads();
  if (live) {
    const long long dest = starts[blockIdx.x] + warp_off[warp] +
                           __popc(ballot & ((1u << lane) - 1u));
    if (dest < cap) {
      for (int f = 0; f < kFields; ++f) {
        out[f * cap + dest] = children[f * kids + j];
      }
      out_pid[dest] = pid[j >> 1];
      if (src) src[dest] = (int)j;
    }
  }
  const long long kept = *total < cap ? *total : cap;
  if (j >= kept && j < cap) {
    for (int f = 0; f < kFields; ++f) out[f * cap + j] = 0.0f;
    out_pid[j] = (int)(j % n_slots);
    if (src) src[j] = -1;
  }
}

}  // namespace

// counts[b] = live children among children[:, b*1024 : (b+1)*1024].
extern "C" int raytpu_wf_count(const float* children, long long kids,
                               int* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kids <= 0) return (int)cudaSuccess;
  const long long blocks = (kids + kBlock - 1) / kBlock;
  wf_count_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      children, kids, counts);
  return (int)cudaGetLastError();
}

// The compacted state (10, cap) and pids (cap,), from the exclusive block
// cursors `starts` and the live total `total` (one int64 on the device).
extern "C" int raytpu_wf_scatter(const float* children, long long kids,
                                 const int* pid, const long long* starts,
                                 const long long* total, long long cap,
                                 int n_slots, float* out, int* out_pid,
                                 int* src, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long span = kids > cap ? kids : cap;
  if (span <= 0) return (int)cudaSuccess;
  const long long blocks = (span + kBlock - 1) / kBlock;
  wf_scatter_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      children, kids, pid, starts, total, cap, n_slots, out, out_pid, src);
  return (int)cudaGetLastError();
}
