// MoE dispatch positions for Hopper (sm_90a): for a flat, priority-ordered
// stream of R expert ids, each request's position within its expert (how
// many earlier requests of the stream name the same expert) and whether
// that position is below the capacity.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_dispatch/kernel.py  moe_dispatch_kernel
// whose grid runs in order over blocks of 512 requests and carries an (E,)
// running count in VMEM scratch from one block to the next.  Blocks of a
// CUDA grid run in no order, so nothing can be carried; the running count
// becomes a multi-block ordered scan in three launches:
//
//   1. dispatch_hist — one block per tile of kTile = 4096 requests writes
//      the tile's count per expert into an (E, n_tiles) int32 buffer;
//   2. dispatch_scan — one block per expert turns its row of that buffer
//      into an exclusive scan over the tiles: the count of the expert's
//      requests in all earlier tiles;
//   3. dispatch_rank — one block per tile again ranks each request inside
//      its tile and writes pos = tile base + earlier warps' count + rank
//      within the warp, and kept = pos < capacity.
//
// Inside a tile, warp w owns 512 consecutive requests as 16 rows of 32 (one
// request a lane, so loads and stores are coalesced) and walks them in
// order.  For each row, __match_any_sync finds the lanes with the same id;
// a lane's rank within the row is __popc(peers & lanes below it), and the
// warp's running count per expert lives in shared memory (count[w][e]: one
// row per warp, so no atomics).  Both the histogram and the rank pass run
// this walk, so both see the same counts.  After the walk an exclusive scan
// over the 8 warps, per expert, gives each warp the count of the tile's
// earlier warps.  Positions are therefore exact ranks in stream order:
// deterministic and equal to the reference bit for bit (atomicAdd on
// per-expert counters would hand out some slot, not the rank).
//
// Edge cases, as the Pallas body (kernel.py:33-50) has them: an id outside
// [0, E), negative ones included, counts nowhere, gets pos = 0 and is kept
// iff 0 < capacity; capacity <= 0 keeps nothing; capacity > R keeps all.
//
// Expert counts: one pass over the stream handles up to kChunk = 1024
// experts (8 warps x 1024 counters x 4 bytes = 32 KB of shared memory, in
// the default 48 KB).  A larger E runs the three launches once per chunk
// of 1024 experts, each counting only the ids of its chunk and writing only
// their positions (chunk 0 also writes the ids outside [0, E)): every E
// the reference takes works, at ceil(E / 1024) times the reads.  E = 0
// (the reference takes it: every id is outside [0, 0)) runs the rank
// launch alone.  Each launch has its own C entry, so each entry is one
// launch a call; the wrapper (kernels/moe_dispatch/ops.py) calls them in
// order, once per chunk of experts.
//
// What bounds it: bytes.  The function reads 4 bytes and writes 5 a
// request: at 2^24 requests 151 MB, 45.1 us at 3.35 TB/s; at the bench's
// 8192 requests 0.022 us, far below a launch.  This design reads the ids
// twice (13 bytes a request, plus the (E, n_tiles) buffer: 256 KB at 2^24
// requests and E = 16, written, scanned and read); one launch with a
// decoupled look-back would read them once (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                  // rows of 32 requests per warp
constexpr int kWarpTile = kRows * 32;      // 512 requests per warp
constexpr int kTile = kWarps * kWarpTile;  // 4096 requests per block
constexpr int kChunk = 1024;               // experts per pass
constexpr int kScanThreads = 1024;

// The warp's 16 ids (beyond the stream: -1) and each one's counter in the
// chunk [e_lo, e_lo + ew), -1 for an id the chunk does not count.
__device__ __forceinline__ void load_ids(const int* __restrict__ ids,
                                         long long start, long long r,
                                         int lane, int e_lo, int ew,
                                         int (&id)[kRows],
                                         int (&slot)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = start + k * 32 + lane;
    id[k] = i < r ? __ldg(ids + i) : -1;
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const unsigned d = static_cast<unsigned>(id[k]) -
                       static_cast<unsigned>(e_lo);
    slot[k] = d < static_cast<unsigned>(ew) ? static_cast<int>(d) : -1;
  }
}

// Walk the warp's rows in order: rank[k] is the number of earlier requests
// of the warp's 512 with the same counted id; count (the warp's row of the
// shared counters, zeroed) ends holding the warp's count per expert.
__device__ __forceinline__ void rank_rows(const int (&slot)[kRows],
                                          int* count, int lane,
                                          int (&rank)[kRows]) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int s = slot[k];
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const int before = __popc(peers & below);
    const int seen = s >= 0 ? count[s] : 0;
    rank[k] = seen + before;
    __syncwarp();
    if (s >= 0 && before == 0) count[s] = seen + __popc(peers);
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_counts(int* count, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) count[i] = 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
dispatch_hist(const int* __restrict__ ids, long long r, int e_lo, int ew,
              int n_tiles, int* __restrict__ hist) {
  extern __shared__ int count[];  // [kWarps][ew]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  zero_counts(count, kWarps * ew);
  int id[kRows], slot[kRows], rank[kRows];
  load_ids(ids, static_cast<long long>(blockIdx.x) * kTile + warp * kWarpTile,
           r, lane, e_lo, ew, id, slot);
  rank_rows(slot, count + warp * ew, lane, rank);
  __syncthreads();
  for (int e = threadIdx.x; e < ew; e += kThreads) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += count[w * ew + e];
    hist[static_cast<long long>(e) * n_tiles + blockIdx.x] = total;
  }
}

// One block per expert: its row of n_tiles counts becomes an exclusive
// scan.  Each thread sums a contiguous segment, the block scans the 1024
// sums (warp shuffles, then one warp over the 32 warp totals), and each
// thread rewrites its segment.
__global__ void __launch_bounds__(kScanThreads)
dispatch_scan(int* __restrict__ hist, int n_tiles) {
  __shared__ int warp_total[kScanThreads / 32];
  int* row = hist + static_cast<long long>(blockIdx.x) * n_tiles;
  const int t = threadIdx.x;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += row[i];
  const int lane = t & 31, warp = t >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp ? warp_total[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = row[i];
    row[i] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(kThreads)
dispatch_rank(const int* __restrict__ ids, int* __restrict__ pos,
              uint8_t* __restrict__ kept, long long r, int n_experts,
              int e_lo, int ew, int n_tiles, const int* __restrict__ hist,
              int capacity, bool first_chunk) {
  extern __shared__ int count[];  // [kWarps][ew]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  zero_counts(count, kWarps * ew);
  const long long start =
      static_cast<long long>(blockIdx.x) * kTile + warp * kWarpTile;
  int id[kRows], slot[kRows], rank[kRows];
  load_ids(ids, start, r, lane, e_lo, ew, id, slot);
  rank_rows(slot, count + warp * ew, lane, rank);
  __syncthreads();
  // per expert: the tile's base, then an exclusive scan over the warps
  for (int e = threadIdx.x; e < ew; e += kThreads) {
    int run = hist[static_cast<long long>(e) * n_tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = count[w * ew + e];
      count[w * ew + e] = run;
      run += c;
    }
  }
  __syncthreads();
  const int* base = count + warp * ew;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = start + k * 32 + lane;
    if (i >= r) continue;
    if (slot[k] >= 0) {
      const int p = base[slot[k]] + rank[k];
      pos[i] = p;
      kept[i] = p < capacity;
    } else if (first_chunk && (id[k] < 0 || id[k] >= n_experts)) {
      pos[i] = 0;
      kept[i] = 0 < capacity;
    }
  }
}

}  // namespace

extern "C" {

// The three launches of one chunk of experts [e_lo, e_lo + ew), ew in
// [1, 1024] (rank also takes ew = 0: no experts), over n_tiles =
// ceil(r / 4096) tiles.  hist is (ew, n_tiles) int32 scratch.  Each
// returns cudaGetLastError() after its one launch, or cudaErrorInvalidValue
// for sizes it does not take (and then launches nothing).

static bool sizes_ok(long long r, int ew, int n_tiles, bool need_ew) {
  return r > 0 && ew >= (need_ew ? 1 : 0) && ew <= kChunk &&
         static_cast<long long>(n_tiles) == (r + kTile - 1) / kTile;
}

// experts (r,) int32 -> hist[e][t]: tile t's count of expert e_lo + e.
int moe_dispatch_hist(const int* experts, int* hist, long long r, int e_lo,
                      int ew, int n_tiles, void* stream) {
  if (!sizes_ok(r, ew, n_tiles, true))
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch_hist<<<n_tiles, kThreads, sizeof(int) * kWarps * ew,
                  static_cast<cudaStream_t>(stream)>>>(experts, r, e_lo, ew,
                                                       n_tiles, hist);
  return static_cast<int>(cudaGetLastError());
}

// hist[e][:] -> its exclusive scan over the tiles, for each of ew experts.
int moe_dispatch_scan(int* hist, int ew, int n_tiles, void* stream) {
  if (ew < 1 || ew > kChunk || n_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch_scan<<<ew, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// experts (r,) int32 -> pos (r,) int32 and kept (r,) bool (one byte each)
// for the ids of the chunk, and, when first_chunk is set, for the ids
// outside [0, n_experts).
int moe_dispatch_rank(const int* experts, int* pos, uint8_t* kept,
                      long long r, int n_experts, int e_lo, int ew,
                      int n_tiles, const int* hist, int capacity,
                      int first_chunk, void* stream) {
  if (!sizes_ok(r, ew, n_tiles, false) || n_experts < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dispatch_rank<<<n_tiles, kThreads, sizeof(int) * kWarps * ew,
                  static_cast<cudaStream_t>(stream)>>>(
      experts, pos, kept, r, n_experts, e_lo, ew, n_tiles, hist, capacity,
      first_chunk != 0);
  return static_cast<int>(cudaGetLastError());
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
