// Live-ray compaction between two wavefront levels: a single-pass stable
// stream compaction with decoupled look-back, CUDA C++ for sm_90a.
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
// What bounds it on this card: bytes.  It does no arithmetic worth the
// name: it must read the three intensity fields of every child and the
// other seven fields of the kept ones, and write 44 bytes per output slot
// (and 4 per child with dst).  It moves values and never rounds them, so
// it equals the plain version bit for bit.
//
// Two kernels, and no host read and no PyTorch op between them:
//   wf_compact_kernel  one pass over the children (Merrill and Garland,
//                      "Single-pass Parallel Prefix Scan with Decoupled
//                      Look-back", 2016), a persistent block an SM.  A
//                      block takes tiles of kTile children by an atomic
//                      ticket (blocks do not start in blockIdx order; with
//                      the ticket a tile waits only on tiles that have
//                      started).  It loads a tile's three intensity rows
//                      once, kItems children a thread striped kThreads
//                      apart so that a warp's loads are coalesced, stages
//                      them in shared memory, ranks them (a ballot per
//                      stripe row and warp, popc of the lanes below, a
//                      warp scan of the kRows row-warp counts) and
//                      publishes the tile's count in its status word.
//                      Then, for its current tile: it takes the next
//                      ticket and issues that tile's loads, looks back
//                      over the current tile's predecessors' words for its
//                      exclusive prefix (warp 0, 32 words at a time) while
//                      they land, stages and publishes the next tile, and
//                      only then writes the current tile's kept children:
//                      the seven fields it has not read, the three
//                      intensities from shared memory and the pid of the
//                      parent j / 2; and on the training path dst[j], the
//                      slot child j went to or -1 for a dead or dropped
//                      child (the backward, wf_uncompact.cu, gathers from
//                      there).  The last tile writes dropped and n_kept.
//   wf_tail_kernel     the slots [n_kept, cap), reading n_kept on the
//                      device: zero state and the pid (slot mod n_slots),
//                      in range for the caller's scatter and spread so that
//                      its atomics on the zeros they add do not pile onto
//                      one address; four slots a thread with 16-byte
//                      stores where cap is a multiple of 4 (the wavefront's
//                      always is).  Each output slot is written once.
// The status words and the ticket are zeroed on the caller's stream
// (cudaMemsetAsync) before the first kernel, so a compaction never reads
// the flags of the one before it.  A status word holds its flag and its
// count in one aligned 64-bit word, so a read is never torn, and a tile
// reads nothing else through it: relaxed atomics at device scope suffice
// (per-address coherence keeps a tile's aggregate before its prefix), and
// release/acquire ordering cost 2% on config-5 chunk 0.
//
// Why it cannot deadlock: a block only waits in the look-back of its
// current tile w, on tiles below w; a tile it has taken ahead is published
// as soon as that look-back ends.  So every tile below the lowest current
// tile is published (one that is not would have been taken ahead by a
// block whose current tile is lower still), and that tile's look-back
// ends.
//
// The design was measured on an H100 (PERF.md).  What the single
// pass pays is the look-back: with a block a tile, a tile spun ~9 times on
// its predecessors' words (their loads still in flight) while its block
// waited, and the best tile shape (1024 threads of 4) took 1.25 ms on
// config-5 chunk 0 against the two-pass design's 1.39; loading the next
// tile during the look-back took 1.10.

// Compiled by g++ as plain C++ (no __CUDACC__), the file gives a host entry
// that runs the same tile functions, tile after tile, for the CPU tests.

#ifdef __CUDACC__
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <mutex>
#endif

#include "trace_common.cuh"

namespace {

using rt::dead;

constexpr int kFields = 10;   // ox oy oz dx dy dz ir ig ib medium-index
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;     // children a thread
constexpr int kTile = kThreads * kItems;  // children a tile
constexpr int kRows = kItems * kWarps;    // row-warp counts a tile
constexpr int kPer = kRows / 32;          // of them, scanned by each lane
static_assert(kPer * 32 == kRows, "the rank scan takes kPer counts a lane");

// The scratch words (int64): dropped, n_kept, the ticket, then one status
// word per tile.
enum { kDropped, kKept, kTicket, kStatus };

// Child k of thread t of the tile starting at child `base`.
RT_HD long long tile_child(long long base, int t, int k) {
  return base + (long long)k * kThreads + t;
}

// Child j's intensities into i3; zeros past the last child (dead).
RT_HD void load_intensity(const float* __restrict__ children, long long kids,
                          long long j, float* i3) {
  const bool in = j < kids;
  i3[0] = in ? children[6 * kids + j] : 0.0f;
  i3[1] = in ? children[7 * kids + j] : 0.0f;
  i3[2] = in ? children[8 * kids + j] : 0.0f;
}

// Kept child j, whose intensities i3 are already read, to slot `dest`.
RT_HD void place_child(const float* __restrict__ children, long long kids,
                       const int* __restrict__ pid, long long j,
                       const float* i3, long long dest, long long cap,
                       float* __restrict__ out, int* __restrict__ out_pid) {
  for (int f = 0; f < 6; ++f) out[f * cap + dest] = children[f * kids + j];
  out[6 * cap + dest] = i3[0];
  out[7 * cap + dest] = i3[1];
  out[8 * cap + dest] = i3[2];
  out[9 * cap + dest] = children[9 * kids + j];
  out_pid[dest] = pid[j >> 1];
}

// Slot s past the kept prefix: zero state, pid s mod n_slots.
RT_HD void tail_slot(long long s, long long cap, int n_slots,
                     float* __restrict__ out, int* __restrict__ out_pid) {
  for (int f = 0; f < kFields; ++f) out[f * cap + s] = 0.0f;
  out_pid[s] = (int)(s % n_slots);
}

// dropped and n_kept from the live total.
RT_HD void write_counts(long long total, long long cap, long long* scratch) {
  scratch[kDropped] = total > cap ? total - cap : 0;
  scratch[kKept] = total < cap ? total : cap;
}

}  // namespace

#ifdef __CUDACC__

namespace {

// A status word: the flag in the top two bits, the count below.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own count
constexpr unsigned long long kPrefix = 2ull << 62;     // the inclusive prefix
constexpr unsigned long long kCount = (1ull << 62) - 1;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
constexpr auto kRelaxed = cuda::std::memory_order_relaxed;

// A tile's count, published when the tile is staged: the inclusive prefix
// for tile 0, its aggregate for the others.
__device__ __forceinline__ void publish(unsigned long long* status,
                                        long long tile, int count) {
  Status(status[tile]).store((tile == 0 ? kPrefix : kAggregate) |
                                 (unsigned long long)count, kRelaxed);
}

// Warp 0's look-back for tile > 0 whose count is published: returns the
// number of live children before the tile and publishes its inclusive
// prefix.  Lane i reads the word of tile (last - i); a window with no
// prefix in it adds all 32 counts and moves 32 tiles back.
__device__ long long look_back(unsigned long long* status, long long tile,
                               int count, int lane) {
  long long before = 0;
  for (long long last = tile - 1;; last -= 32) {
    const long long p = last - lane;
    unsigned long long w;
    do {
      w = p >= 0 ? Status(status[p]).load(kRelaxed) : kPrefix;
    } while (__any_sync(0xffffffffu, (w >> 62) == 0));
    const unsigned prefixed = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int stop = prefixed ? __ffs(prefixed) - 1 : 31;
    long long v = lane <= stop ? (long long)(w & kCount) : 0;
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    before += v;
    if (prefixed) break;
  }
  if (lane == 0) {
    Status(status[tile]).store(kPrefix | (unsigned long long)(before + count), kRelaxed);
  }
  return before;
}

// This thread's kItems children of `tile`: their intensities into i3k.
__device__ __forceinline__ void load_tile(const float* __restrict__ children,
                                          long long kids, long long tile,
                                          int t, float* i3k) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    load_intensity(children, kids, tile_child(tile * kTile, t, k), i3k + 3 * k);
  }
}

// A tile's stage, in shared memory: its intensities `in` (3, kTile), the
// ballot of each stripe row and warp, and their live counts in `off`, which
// warp 0 then turns into exclusive offsets (scan_counts).  Flat pointers,
// not a struct of them: nvcc 12.8 has loaded a pointer held in a struct
// through local memory (PERF.md).
__device__ __forceinline__ void stage_tile(const float* i3k, float* in,
                                           unsigned* ballot, int* off, int t,
                                           int lane, int warp) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + t;
    const float* i3 = i3k + 3 * k;
    in[idx] = i3[0];
    in[kTile + idx] = i3[1];
    in[2 * kTile + idx] = i3[2];
    const unsigned b = __ballot_sync(0xffffffffu, !dead(i3[0], i3[1], i3[2]));
    if (lane == 0) {
      ballot[k * kWarps + warp] = b;
      off[k * kWarps + warp] = __popc(b);
    }
  }
}

// Warp 0: the exclusive scan of a staged tile's kRows counts in child order
// (row, then warp), lane l taking kPer neighbouring ones; returns the
// tile's count.
__device__ __forceinline__ int scan_counts(int* off, int lane) {
  int c[kPer], own = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    c[i] = off[kPer * lane + i];
    own += c[i];
  }
  int v = own;
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) v += u;
  }
  int run = v - own;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    off[kPer * lane + i] = run;
    run += c[i];
  }
  return __shfl_sync(0xffffffffu, v, 31);
}

__global__ void __launch_bounds__(kThreads)
wf_compact_kernel(const float* __restrict__ children, long long kids,
                  const int* __restrict__ pid, long long cap,
                  float* __restrict__ out, int* __restrict__ out_pid,
                  int* __restrict__ dst, long long* __restrict__ scratch,
                  long long tiles) {
  extern __shared__ float s_in[];  // two stages' intensities, (3, kTile) each
  __shared__ unsigned s_ballot[2][kRows];
  __shared__ int s_off[2][kRows];
  __shared__ int s_count[2];
  __shared__ long long s_tile[2], s_before;  // each stage's tile
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + kTicket);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + kStatus);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float i3k[3 * kItems];

  if (t == 0) s_tile[0] = (long long)atomicAdd(ticket, 1u);
  __syncthreads();
  long long tile = s_tile[0];
  if (tile >= tiles) return;
  int b = 0;  // the current tile's stage
  load_tile(children, kids, tile, t, i3k);
  stage_tile(i3k, s_in, s_ballot[0], s_off[0], t, lane, warp);
  __syncthreads();
  if (warp == 0) {
    const int count = scan_counts(s_off[0], lane);
    if (lane == 0) {
      s_count[0] = count;
      publish(status, tile, count);
    }
  }
  for (;;) {
    if (t == 0) s_tile[b ^ 1] = (long long)atomicAdd(ticket, 1u);
    __syncthreads();  // the next ticket; the current stage's offsets and count
    const long long next = s_tile[b ^ 1];
    const bool more = next < tiles;
    if (more) load_tile(children, kids, next, t, i3k);  // lands during the look-back
    if (warp == 0) {
      const int count = s_count[b];
      const long long before = tile == 0 ? 0 : look_back(status, tile, count, lane);
      if (lane == 0) {
        s_before = before;
        if (tile == tiles - 1) write_counts(before + count, cap, scratch);
      }
    }
    if (more) {
      stage_tile(i3k, s_in + (b ^ 1) * 3 * kTile, s_ballot[b ^ 1],
                 s_off[b ^ 1], t, lane, warp);
    }
    __syncthreads();  // s_before; the next tile staged
    if (more && warp == 0) {
      const int count = scan_counts(s_off[b ^ 1], lane);
      if (lane == 0) {
        s_count[b ^ 1] = count;
        publish(status, next, count);
      }
    }

    // The current tile's kept children, after the next tile's count is out.
    const float* in = s_in + b * 3 * kTile;
    const long long before = s_before;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long j = tile_child(tile * kTile, t, k);
      if (j >= kids) break;
      const unsigned ballot = s_ballot[b][k * kWarps + warp];
      long long dest = -1;
      if ((ballot >> lane) & 1u) {
        dest = before + s_off[b][k * kWarps + warp] + __popc(ballot & below);
        if (dest < cap) {
          const int idx = k * kThreads + t;
          const float i3[3] = {in[idx], in[kTile + idx], in[2 * kTile + idx]};
          place_child(children, kids, pid, j, i3, dest, cap, out, out_pid);
        } else {
          dest = -1;  // dropped past the capacity
        }
      }
      if (dst) dst[j] = (int)dest;
    }
    if (!more) return;
    tile = next;
    b ^= 1;
  }
}

constexpr int kTailThreads = 256;
constexpr int kTailBlocks = 132 * 8;  // a grid-stride loop: 8 blocks an SM

__global__ void __launch_bounds__(kTailThreads)
wf_tail_kernel(const long long* __restrict__ scratch, long long cap,
               int n_slots, float* __restrict__ out, int* __restrict__ out_pid) {
  const long long step = (long long)gridDim.x * kTailThreads;
  const long long id = (long long)blockIdx.x * kTailThreads + threadIdx.x;
  const long long kept = scratch[kKept];
  if (cap % 4 != 0) {
    for (long long s = kept + id; s < cap; s += step) {
      tail_slot(s, cap, n_slots, out, out_pid);
    }
    return;
  }
  // One by one up to a multiple of 4, then 4 slots a thread.
  const long long head = (kept + 3) & ~3ll;
  if (kept + id < head) tail_slot(kept + id, cap, n_slots, out, out_pid);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long q = head / 4 + id; q < cap / 4; q += step) {
    for (int f = 0; f < kFields; ++f) {
      reinterpret_cast<float4*>(out + f * cap)[q] = zero;
    }
    int4 p;
    p.x = (int)((4 * q) % n_slots);
    p.y = p.x + 1 < n_slots ? p.x + 1 : 0;
    p.z = p.y + 1 < n_slots ? p.y + 1 : 0;
    p.w = p.z + 1 < n_slots ? p.z + 1 : 0;
    reinterpret_cast<int4*>(out_pid)[q] = p;
  }
}

constexpr int kMaxDevices = 64;
constexpr int kStageBytes = 2 * 3 * kTile * (int)sizeof(float);

// Once per device: the scan's shared-memory limit raised to its two stages
// (96 KB), and the SM count, its grid.
std::mutex prepare_mutex;
int device_sms[kMaxDevices];

cudaError_t prepare(int device, int* sms) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(prepare_mutex);
  if (device_sms[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        wf_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&device_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = device_sms[device];
  return cudaSuccess;
}

}  // namespace

// The scan: state (10, cap) and pids (cap,) for the kept prefix, dst
// (kids,) or null (not wanted), and scratch[kDropped], scratch[kKept];
// `scratch` holds `words` >= 3 + ceil(kids / kTile) int64 words and is
// zeroed here, on the stream, first.
extern "C" int raytpu_wf_compact(const float* children, long long kids,
                                 const int* pid, long long cap, float* out,
                                 int* out_pid, int* dst, long long* scratch,
                                 long long words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (kids + kTile - 1) / kTile;
  if (kids < 0 || cap < 0 || words < kStatus + tiles) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaMemsetAsync(scratch, 0, sizeof(long long) * (kStatus + tiles),
                        (cudaStream_t)stream);
  if (err != cudaSuccess || kids == 0) return (int)err;
  int sms = 0;
  err = prepare(device, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = tiles < sms ? tiles : sms;
  wf_compact_kernel<<<(unsigned)blocks, kThreads, kStageBytes,
                      (cudaStream_t)stream>>>(children, kids, pid, cap, out,
                                              out_pid, dst, scratch, tiles);
  return (int)cudaGetLastError();
}

// The tail: slots [scratch[kKept], cap) of state and pids, after the scan.
extern "C" int raytpu_wf_compact_tail(const long long* scratch, long long cap,
                                      int n_slots, float* out, int* out_pid,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cap <= 0) return (int)cudaSuccess;
  if (n_slots < 1) return (int)cudaErrorInvalidValue;
  const long long need = (cap + kTailThreads - 1) / kTailThreads;
  const unsigned blocks = (unsigned)(need < kTailBlocks ? need : kTailBlocks);
  wf_tail_kernel<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>(
      scratch, cap, n_slots, out, out_pid);
  return (int)cudaGetLastError();
}

// Children a tile: the wrapper sizes the scratch from it.
extern "C" int raytpu_wf_compact_tile() { return kTile; }

#else

// The kernels' tile functions over all tiles in order, on the CPU: each
// tile's children ranked in child order after the tiles before it, then
// the tail.  Same arguments as the two entries, scratch (3,) int64.
extern "C" void raytpu_wf_compact_host(const float* children, long long kids,
                                       const int* pid, long long cap,
                                       int n_slots, float* out, int* out_pid,
                                       int* dst, long long* scratch) {
  long long before = 0;
  for (long long base = 0; base < kids; base += kTile) {
    for (int k = 0; k < kItems; ++k) {
      for (int t = 0; t < kThreads; ++t) {
        const long long j = tile_child(base, t, k);
        if (j >= kids) continue;
        float i3[3];
        load_intensity(children, kids, j, i3);
        long long dest = -1;
        if (!dead(i3[0], i3[1], i3[2])) {
          dest = before++;
          if (dest < cap) {
            place_child(children, kids, pid, j, i3, dest, cap, out, out_pid);
          } else {
            dest = -1;
          }
        }
        if (dst) dst[j] = (int)dest;
      }
    }
  }
  write_counts(before, cap, scratch);
  for (long long s = scratch[kKept]; s < cap; ++s) {
    tail_slot(s, cap, n_slots, out, out_pid);
  }
}

extern "C" int raytpu_wf_compact_tile() { return kTile; }

#endif
