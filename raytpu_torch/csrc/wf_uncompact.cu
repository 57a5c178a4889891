// The transpose of the live-ray compaction (wf_compact.cu): slot
// cotangents back to the child columns they were kept from, CUDA C++ for
// sm_90a.
//
// Replaces: raytpu/kernels/wavefront.py:_make_inverse_cursor_kernel
// (launched by _inverse_cursor_call) and the batched inverse co-sort of
// _compact_blocked_ad_bwd around it.  The function is the adjoint of the
// compaction: given the cotangent d_state (10, cap) of the compacted state
// and src (cap,), the child column each kept slot was copied from (-1 past
// the kept prefix, as the scatter kernel writes it), it writes d_children
// (10, kids) with d_children[f, src[k]] = d_state[f, k] for the 9
// differentiable fields of every kept slot k and an exact zero everywhere
// else: in the medium-index row, and in the column of every child that was
// dead or dropped past the capacity.  raytpu's seam fillers and per-block
// sorts are TPU artifacts; the port's compaction is stable, so the kept
// prefix of src is strictly increasing.
//
// One launch, one thread per child column j, and no host read of the kept
// count: thread j finds the slot that holds j by a binary search of src
// (the -1 tail sorts as +infinity; slot k holds a column >= k, so the
// search ends at j + 1), then writes its whole column, the value or zeros.
// Every element of d_children is written once, so the output needs no
// zero-fill, and no two threads write one address, so no atomics.
//
// What bounds it on this card: bytes, 36 read per kept slot and 40 written
// per child column.  Writes are coalesced (thread j, column j); the search's
// first steps read the same words across a warp and hit L1.  It moves
// values and never rounds them, so it equals the plain version bit for bit.
//
// Compiled by g++ as plain C++ (no __CUDACC__), the file gives a host entry
// that runs the same per-column function in a loop, for the CPU tests.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "trace_common.cuh"

namespace {

constexpr int kFields = 10;  // ox oy oz dx dy dz ir ig ib medium-index
constexpr int kDiff = 9;     // the fields with a cotangent

// Child column j of d_children.
RT_HD void uncompact_column(const float* __restrict__ d_state, long long cap,
                            const int* __restrict__ src, long long kids,
                            long long j, float* __restrict__ d_children) {
  // The first slot whose source is >= j (a -1 source counts as +infinity).
  long long lo = 0, hi = j + 1 < cap ? j + 1 : cap;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const int s = src[mid];
    if (s >= 0 && s < j) lo = mid + 1; else hi = mid;
  }
  const bool kept = lo < cap && src[lo] == j;
  for (int f = 0; f < kDiff; ++f) {
    d_children[f * kids + j] = kept ? d_state[f * cap + lo] : 0.0f;
  }
  d_children[kDiff * kids + j] = 0.0f;
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
wf_uncompact_kernel(const float* __restrict__ d_state, long long cap,
                    const int* __restrict__ src, long long kids,
                    float* __restrict__ d_children) {
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j < kids) uncompact_column(d_state, cap, src, kids, j, d_children);
}

}  // namespace

// d_state (10, cap), src (cap,) -> d_children (10, kids).
extern "C" int raytpu_wf_uncompact(const float* d_state, long long cap,
                                   const int* src, long long kids,
                                   float* d_children, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kids <= 0) return (int)cudaSuccess;
  const long long blocks = (kids + kBlock - 1) / kBlock;
  wf_uncompact_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      d_state, cap, src, kids, d_children);
  return (int)cudaGetLastError();
}

#else

// The kernel's per-column function over all columns, on the CPU.
extern "C" void raytpu_wf_uncompact_host(const float* d_state, long long cap,
                                         const int* src, long long kids,
                                         float* d_children) {
  for (long long j = 0; j < kids; ++j) {
    uncompact_column(d_state, cap, src, kids, j, d_children);
  }
}

#endif
