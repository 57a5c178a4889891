// The transpose of the live-ray compaction (wf_compact.cu): each child
// column's cotangent gathered from the slot it was compacted to, CUDA C++
// for sm_90a.
//
// Replaces: raytpu/kernels/wavefront.py:_make_inverse_cursor_kernel
// (launched by _inverse_cursor_call) and the batched inverse co-sort of
// _compact_blocked_ad_bwd around it.  The function is the adjoint of the
// compaction: given the cotangent d_state (10, cap) of the compacted state
// and dst (kids,), the slot each child column was written to (-1 for a
// dead child or one dropped past the capacity, as the scatter kernel
// writes it on the training path), it writes d_children (10, kids) with
// d_children[f, j] = d_state[f, dst[j]] for the 9 differentiable fields of
// every kept child j and an exact zero everywhere else: in the
// medium-index row, and in the column of every dead or dropped child.
// raytpu's seam fillers and per-block sorts are TPU artifacts.
//
// One launch, one thread per child column j, and no host read of the kept
// count: thread j reads dst[j] and writes its whole column, the gathered
// values or zeros.  Every element of d_children is written once, so the
// output needs no zero-fill, and no two threads write one address, so no
// atomics.
//
// What bounds it on this card: bytes, 4 read per child (dst), 36 read per
// kept child and 40 written per child.  Every access but the gather is
// coalesced (thread j, column j), and the gather nearly so: the
// compaction is stable, so the kept children of a warp hold consecutive
// slots.  (The first design searched a cap-long source index for each
// column, ~22 dependent reads at config 5's capacity.)  It moves values
// and never rounds them, so it equals the plain version bit for bit.
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
                            const int* __restrict__ dst, long long kids,
                            long long j, float* __restrict__ d_children) {
  const int k = dst[j];
  const bool kept = k >= 0 && k < cap;  // the wrapper checks d_state's cap
  for (int f = 0; f < kDiff; ++f) {
    d_children[f * kids + j] = kept ? d_state[f * cap + k] : 0.0f;
  }
  d_children[kDiff * kids + j] = 0.0f;
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
wf_uncompact_kernel(const float* __restrict__ d_state, long long cap,
                    const int* __restrict__ dst, long long kids,
                    float* __restrict__ d_children) {
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (j < kids) uncompact_column(d_state, cap, dst, kids, j, d_children);
}

}  // namespace

// d_state (10, cap), dst (kids,) -> d_children (10, kids).
extern "C" int raytpu_wf_uncompact(const float* d_state, long long cap,
                                   const int* dst, long long kids,
                                   float* d_children, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kids <= 0) return (int)cudaSuccess;
  const long long blocks = (kids + kBlock - 1) / kBlock;
  wf_uncompact_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      d_state, cap, dst, kids, d_children);
  return (int)cudaGetLastError();
}

#else

// The kernel's per-column function over all columns, on the CPU.
extern "C" void raytpu_wf_uncompact_host(const float* d_state, long long cap,
                                         const int* dst, long long kids,
                                         float* d_children) {
  for (long long j = 0; j < kids; ++j) {
    uncompact_column(d_state, cap, dst, kids, j, d_children);
  }
}

#endif
