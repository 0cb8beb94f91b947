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
// becomes a single-pass scan with a decoupled look-back, one launch a pass
// of up to kChunk = 1024 experts.  Each id is read once and each output
// written once.
//
//   * Ordered tiles without an ordered grid.  Each block takes its tile of
//     kTile = 8192 requests from a device ticket counter (atomicAdd), not
//     from blockIdx: every tile below its own was taken by a block that is
//     already running, so waiting on those tiles always ends.
//   * Inside a tile.  Warp w owns 1024 consecutive requests as 32 rows of
//     32, loaded and stored a row at a time (coalesced); int64 ids keep
//     their low 32 bits, as astype(int32) does.  With at most 32 experts
//     in the pass the rows are transposed through shared memory so that
//     each lane holds 32 consecutive requests, which it counts in order in
//     its own column of per-lane counters (a request's rank among the
//     lane's is the column's count before it); one scan per expert across
//     the lanes (lane e scans row e in registers) gives each lane the
//     count of the warp's earlier lanes.  With more experts each row's
//     lanes find their peers with one ballot per key bit (__match_any_sync
//     was slower) and the warp's running count per expert lives in shared
//     memory.  A scan over the 8 warps, per expert, gives each warp the
//     count of the tile's earlier warps, and the total is the tile's
//     aggregate.
//   * Publishing and looking back.  The tile publishes its aggregate per
//     expert (status[e][tile]) as soon as it has counted, then looks back
//     over the tiles below it until it meets an inclusive prefix for each
//     expert: a warp serves m of its experts at once, W = 32 / m lanes
//     each, and in a round each lane reads one predecessor's word.  The
//     tile then publishes its inclusive prefix and writes pos = earlier
//     tiles' count + rank in the tile, and kept = pos < capacity.  Tile 0
//     publishes its inclusive prefix at once.  Positions are exact ranks in
//     stream order, deterministic and equal to the reference bit for bit.
//   * The status word.  64 bits: the count in bits 0-31 (an inclusive
//     prefix is at most R <= 2^31 - 1), the flag in bit 32 (1: inclusive
//     prefix, 0: the tile's aggregate alone) and the call's tag in bits
//     33-63, stored and loaded whole through cuda::atomic_ref, so no word
//     tears, and a word counts only when its tag is the call's.  The word
//     carries all a reader needs, so relaxed order suffices; release and
//     acquire cost 6-13 % (PERF.md).
//   * Safe to replay from a CUDA graph.  The workspace (allocated zeroed by
//     the wrapper, one per device and stream, and never during a capture,
//     where the zero fill would wait for that graph's replay) starts with
//     a header of the ticket counter, a done counter and the epoch; the
//     call's tag is epoch + 1, read on the device.  The last block to count itself done
//     resets the ticket and done counters and advances the epoch, so the
//     host passes nothing that a replayed launch could find stale.  Tags
//     run from 1 to kTagLimit = 2^31 - 1 (a zeroed word, tag 0, is never
//     valid); when the epoch wraps, the last block zeroes every status
//     word, so a word from 2^31 - 1 calls ago cannot pass for a new one.
//
// Edge cases, as the Pallas body (kernel.py:33-50) has them: an id outside
// [0, E), negative ones included, counts nowhere, gets pos = 0 and is kept
// iff 0 < capacity; capacity <= 0 keeps nothing; capacity > R keeps all.
// kept is written as bytes 0 and 1 only (torch.bool).
//
// Expert counts: a pass handles up to kChunk experts.  A larger E runs one
// launch per chunk of 1024 experts, each counting only the ids of its chunk
// and writing only their positions (chunk 0 also writes the ids outside
// [0, E)).  E = 0 (the reference takes it: every id is outside [0, 0)) is
// one launch with no experts and no look-back.
//
// What bounds it: bytes.  The function reads 4 bytes and writes 5 a
// request: at 2^24 requests 151 MB, 45.1 us at 3.35 TB/s; at the bench's
// 8192 requests 0.022 us, far below a launch.  Besides, it moves two status
// words per tile and expert and the look-back's reads of them.  What the
// design still loses is latency: a block's load, count, look-back and
// stores run one after another, 4 blocks an SM (PERF.md).

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;                  // rows of 32 requests per warp
constexpr int kWarpTile = kRows * 32;      // 1024 requests per warp
constexpr int kTile = kWarps * kWarpTile;  // 8192 requests per block
constexpr int kChunk = 1024;               // experts per pass
constexpr int kMinBlocks = 4;              // blocks an SM: <= 64 registers
constexpr int kWindow = 32;                // lanes a warp looks back with
constexpr int kRowPad = 33;                // kSmall: a lane counter row

// The status word (repro_torch.kernels.moe_dispatch.ops pins the same).
constexpr int kFlagBit = 32;               // 1: inclusive prefix
constexpr int kTagShift = 33;              // bits 33-63: the call's tag
constexpr unsigned kTagLimit = 0x7fffffffu;
constexpr int kHeaderWords = 2;            // the Header below, in u64 words

struct Header {
  unsigned ticket;  // tiles handed out in this call
  unsigned done;    // blocks finished in this call
  unsigned epoch;   // the call's tag is epoch + 1
  unsigned unused;
};
static_assert(sizeof(Header) == kHeaderWords * sizeof(u64), "header size");

typedef cuda::atomic_ref<u64, cuda::thread_scope_device> Word;

__device__ __forceinline__ u64 pack(unsigned tag, bool inclusive,
                                    unsigned count) {
  return (static_cast<u64>(tag) << kTagShift) |
         (static_cast<u64>(inclusive) << kFlagBit) | count;
}

// The warp's 1024 requests as 32 rows of 32, request k of a lane at start +
// 32 k + lane (coalesced loads and stores), as keys: an id's counter in the
// chunk [e_lo, e_lo + ew), or ew for an id the chunk does not count (and
// for requests beyond the stream).  int64 ids keep their low 32 bits.  Bit
// k of `writes` marks request k as one this pass writes: counted, or
// outside [0, n_experts) in the first chunk (it gets pos = 0).
template <typename Id>
__device__ __forceinline__ void load_keys(const Id* __restrict__ ids,
                                          long long start, long long r,
                                          int lane, int n_experts, int e_lo,
                                          int ew, bool first_chunk,
                                          int (&key)[kRows],
                                          unsigned& writes) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = start + k * 32 + lane;
    key[k] = i < r ? static_cast<int>(__ldg(ids + i)) : e_lo + ew;
  }
  writes = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int id = key[k];
    const unsigned d =
        static_cast<unsigned>(id) - static_cast<unsigned>(e_lo);
    key[k] = d < static_cast<unsigned>(ew) ? static_cast<int>(d) : ew;
    if (key[k] < ew || (first_chunk && start + k * 32 + lane < r &&
                        (id < 0 || id >= n_experts)))
      writes |= 1u << k;
  }
}

// kSmall: the warp's 32 x 32 words pass between rows (request 32 k + j in
// lane j) and lanes (request 32 j + k in lane j) through a shared buffer
// padded by a word every 32, so both sides hit 32 distinct banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

// kSmall: each lane counts its 32 consecutive requests (lane j: requests
// 32 j + k of the warp's 1024), in order, in its own column of
// the warp's counters h[e][lane] (rows padded to kRowPad = 33 words, so
// the lanes' accesses to one row, and lane e's reads of row e at one
// column, fall in distinct banks), so a request's rank among the lane's
// is the column's count before it.
// Then lane e scans row e (expert e's count in each lane) in registers,
// leaving in h[e][lane] the count of the warp's earlier lanes, and puts the
// warp's count of expert e into count (the warp's row of the shared
// counters).
__device__ __forceinline__ void count_lanes(int (&kr)[kRows], int* h,
                                            int* count, int ew, int lane) {
  for (int e = 0; e < ew; ++e) h[e * kRowPad + lane] = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int key = kr[k];
    if (key < ew) {
      const int c = h[key * kRowPad + lane];
      h[key * kRowPad + lane] = c + 1;
      kr[k] = key | c << 16;
    }
  }
  __syncwarp();
  if (lane < ew) {
    int* row = h + lane * kRowPad;
    int v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = row[j];
    int run = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = v[j];
      v[j] = run;
      run += c;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) row[j] = v[j];
    count[lane] = run;
  }
  __syncwarp();
}

// More than 32 experts: the lanes of the warp whose key equals this
// lane's, from one ballot per key bit (keys < 2^nbits, nbits <= 11): nbits
// ballots in place of __match_any_sync, which runs far slower.
__device__ __forceinline__ unsigned match_key(int key, int nbits) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 11; ++b) {
    if (b < nbits) {
      const unsigned m = __ballot_sync(0xffffffffu, (key >> b) & 1);
      peers &= (key >> b) & 1 ? m : ~m;
    }
  }
  return peers;
}

// More than 32 experts: the warp's count of each counted key over its 1024
// requests, by shared-memory atomics into count (its zeroed row).
__device__ __forceinline__ void count_keys(const int (&key)[kRows],
                                           int* count, int ew) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    if (key[k] < ew) atomicAdd(count + key[k], 1);
}

// More than 32 experts: walk the warp's rows in order.  Each request's rank
// in the tile (the number of earlier requests of the tile with the same
// counted key) goes into the high half of its key word, kr[k] = key | rank
// << 16.  count (the warp's row) starts as the count of the tile's earlier
// warps per expert and runs on through the rows: a row's first lane of
// each key updates it.
__device__ __forceinline__ void rank_rows(int (&kr)[kRows], int* count,
                                          int ew, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const int nbits = 32 - __clz(ew);       // keys 0 .. ew
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int key = kr[k];
    const unsigned peers = match_key(key, nbits);
    const int before = __popc(peers & below);
    const int seen = key < ew ? count[key] : 0;
    kr[k] = key | (seen + before) << 16;
    __syncwarp();
    if (key < ew && before == 0) count[key] = seen + __popc(peers);
    __syncwarp();
  }
}

// The look-back of the warp's experts e = warp + kWarps i, m of them at
// once (m a power of two, at most 32): lanes g W .. g W + W - 1 (W = 32 /
// m) serve expert g, lane j reading the status word of tile from - 1 - j.
// An expert's window is used once every word below its nearest inclusive
// prefix carries the call's tag (the prefix is found, the expert is done)
// or once all W words do and none is inclusive (the next window lies
// below); otherwise the expert waits and the next round reads again.  The
// result, the count of the expert's requests in tiles [0, tile), replaces
// base[e] (the tile's aggregate, which the segment's first lane adds to
// publish the tile's inclusive prefix).
__device__ __forceinline__ void look_back(u64* status, int n_tiles, int tile,
                                          unsigned tag, int ew, int warp,
                                          int lane, int* base) {
  const int n_mine = ew > warp ? (ew - warp + kWarps - 1) / kWarps : 0;
  if (n_mine == 0) return;
  int log_m = 0;
  while ((1 << log_m) < min(n_mine, kWindow)) ++log_m;
  const int log_w = 5 - log_m, w = 1 << log_w;
  const int g = lane >> log_w, j = lane & (w - 1);
  const unsigned low = w == 32 ? 0xffffffffu : (1u << w) - 1u;
  for (int i0 = 0; i0 < n_mine; i0 += 1 << log_m) {
    const int e = warp + kWarps * (i0 + g);
    bool done = i0 + g >= n_mine;
    u64* col = status + static_cast<long long>(done ? 0 : e) * n_tiles;
    int from = tile;
    unsigned total = 0;
    while (__any_sync(0xffffffffu, !done)) {
      const int t = from - 1 - j;
      // done, or below tile 0: an inclusive prefix of 0
      u64 word = pack(tag, true, 0);
      if (!done && t >= 0)
        word = Word(col[t]).load(cuda::memory_order_relaxed);
      const bool valid = static_cast<unsigned>(word >> kTagShift) == tag;
      const bool incl = valid && ((word >> kFlagBit) & 1u);
      const unsigned vs =
          (__ballot_sync(0xffffffffu, valid) >> (g << log_w)) & low;
      const unsigned is =
          (__ballot_sync(0xffffffffu, incl) >> (g << log_w)) & low;
      // the lanes below the first word not yet published, and the nearest
      // inclusive prefix among them
      const unsigned waiting = ~vs & low;
      const unsigned ready = waiting ? (waiting & (0u - waiting)) - 1u : low;
      const unsigned stop = is & ready;
      const int last = stop ? __ffs(stop) - 1 : w - 1;
      unsigned sum = j <= last ? static_cast<unsigned>(word) : 0u;
      for (int o = w >> 1; o; o >>= 1)    // the segment's sum
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (!done && (stop || !waiting)) {
        total += sum;
        done = stop != 0;
        from -= w;
      }
    }
    if (i0 + g < n_mine && j == 0) {
      Word(col[tile]).store(
          pack(tag, true, total + static_cast<unsigned>(base[e])),
          cuda::memory_order_relaxed);
      base[e] = static_cast<int>(total);
    }
  }
}

// After its look-back a block reads no status word and every tile has been
// handed out, so it counts itself done then, before its position stores;
// the last block to do so readies the workspace for the next call (on the
// epoch's wrap it zeroes every status word alone: once in 2^31 - 1 calls).
// The fence orders the block's status words before its count (so none
// lands after the zeroing); it waits on those few stores only.
__device__ __forceinline__ void finish(Header* head, u64* status,
                                       int n_tiles, long long ws_words) {
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(&head->done, 1u) != static_cast<unsigned>(n_tiles) - 1u)
    return;
  head->ticket = 0;
  head->done = 0;
  const unsigned next = head->epoch + 1u;
  head->epoch = next == kTagLimit ? 0u : next;
  if (next == kTagLimit)
    for (long long i = 0; i < ws_words - kHeaderWords; ++i) status[i] = 0;
}

template <typename Id, bool kSmall>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dispatch_scan(const Id* __restrict__ ids, int* __restrict__ pos,
              uint8_t* __restrict__ kept, long long r, int n_experts,
              int e_lo, int ew, int capacity, bool first_chunk,
              u64* __restrict__ ws, long long ws_words) {
  // count[kWarps][ew], base[ew], then kSmall: the lanes' counters
  // h[kWarps][ew][kRowPad] and the transpose buffers [kWarps][528]; else
  // the key words' stash [kRows][kThreads]
  extern __shared__ int smem[];
  int* base = smem + kWarps * ew;
  int* more = base + ew;
  __shared__ int s_tile;
  __shared__ unsigned s_tag;
  Header* head = reinterpret_cast<Header*>(ws);
  u64* status = ws + kHeaderWords;  // status[e * n_tiles + tile]
  const int n_tiles = static_cast<int>(gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* h = more + warp * ew * kRowPad;  // kSmall: the warp's lane counters
  int* t = more + kWarps * ew * kRowPad +
           warp * padded(kWarpTile);      // kSmall: the warp's transpose
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(&head->ticket, 1u));
    s_tag = *reinterpret_cast<volatile unsigned*>(&head->epoch) + 1u;
  }
  if (!kSmall)
    for (int i = threadIdx.x; i < kWarps * ew; i += kThreads) smem[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const unsigned tag = s_tag;
  const long long start =
      static_cast<long long>(tile) * kTile + warp * kWarpTile;
  int kr[kRows];
  unsigned writes;
  load_keys(ids, start, r, lane, n_experts, e_lo, ew, first_chunk, kr,
            writes);
  if constexpr (kSmall) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) t[padded(k * 32 + lane)] = kr[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRows; ++k) kr[k] = t[padded(lane * kRows + k)];
    count_lanes(kr, h, smem + warp * ew, ew, lane);
  } else {
    count_keys(kr, smem + warp * ew, ew);
  }
  __syncthreads();
  // per expert: an exclusive scan over the warps, and the tile's aggregate
  // published at once (tile 0: as its inclusive prefix, with nothing
  // before it), so that the tiles after it wait as little as possible
  for (int e = threadIdx.x; e < ew; e += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = smem[w * ew + e];
      smem[w * ew + e] = run;
      run += c;
    }
    Word(status[static_cast<long long>(e) * n_tiles + tile])
        .store(pack(tag, tile == 0, static_cast<unsigned>(run)),
               cuda::memory_order_relaxed);
    base[e] = tile == 0 ? 0 : run;
  }
  __syncthreads();
  if constexpr (kSmall) {
    if (tile > 0) look_back(status, n_tiles, tile, tag, ew, warp, lane, base);
    __syncthreads();
    finish(head, status, n_tiles, ws_words);
    // each lane's column: the count of its expert's requests before the
    // lane's first, in the stream
    for (int e = 0; e < ew; ++e)
      h[e * kRowPad + lane] += base[e] + smem[warp * ew + e];
    // positions in lane order, back to rows through the buffer
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int key = kr[k] & 0xffff;
      t[padded(lane * kRows + k)] =
          key < ew ? h[key * kRowPad + lane] + (kr[k] >> 16) : 0;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if ((writes >> k) & 1u) {
        const long long i = start + k * 32 + lane;
        const int p = t[padded(k * 32 + lane)];
        pos[i] = p;
        kept[i] = p < capacity;
      }
    }
  } else {
    // the rank walk runs while the tiles before this one publish theirs
    rank_rows(kr, smem + warp * ew, ew, lane);
    if (tile > 0) {
      // the key words wait in shared memory, so the look-back has the
      // registers
#pragma unroll
      for (int k = 0; k < kRows; ++k) more[k * kThreads + threadIdx.x] = kr[k];
      look_back(status, n_tiles, tile, tag, ew, warp, lane, base);
#pragma unroll
      for (int k = 0; k < kRows; ++k) kr[k] = more[k * kThreads + threadIdx.x];
    }
    __syncthreads();
    finish(head, status, n_tiles, ws_words);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if ((writes >> k) & 1u) {
        const long long i = start + k * 32 + lane;
        const int key = kr[k] & 0xffff;
        const int p = key < ew ? base[key] + (kr[k] >> 16) : 0;
        pos[i] = p;
        kept[i] = p < capacity;
      }
    }
  }
}

}  // namespace

extern "C" {

// One pass of experts [e_lo, e_lo + ew), ew in [0, 1024], over r requests
// (1 <= r <= 2^31 - 1): ids (r,) of id_bytes 4 (int32) or 8 (int64, the low
// 32 bits count) -> pos (r,) int32 and kept (r,) bool (one byte each) for
// the ids of the chunk, and, when first_chunk is set, for the ids outside
// [0, n_experts).  ws is the zeroed workspace of ws_words >= 2 +
// ceil(r / 8192) * ew u64 words; calls that share it must run in stream
// order.  One launch; returns cudaGetLastError(), or cudaErrorInvalidValue
// for sizes it does not take (and then launches nothing).
int moe_dispatch_launch(const void* experts, int id_bytes, int* pos,
                        uint8_t* kept, long long r, int n_experts, int e_lo,
                        int ew, int capacity, int first_chunk, u64* ws,
                        long long ws_words, void* stream) {
  if (r < 1 || r > 0x7fffffffLL || ew < 0 || ew > kChunk || n_experts < 0 ||
      (id_bytes != 4 && id_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (r + kTile - 1) / kTile;
  if (ws_words < kHeaderWords + n_tiles * ew)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool small = ew <= 32;
  const int smem = static_cast<int>(sizeof(int)) *
                   ((kWarps + 1) * ew +
                    (small ? kWarps * (ew * kRowPad + padded(kWarpTile))
                           : kRows * kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  // above the default 48 KB (ew > 896) the kernel must be allowed more
#define DISPATCH_SCAN(Id, small)                                            \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t err = cudaFuncSetAttribute(                        \
          dispatch_scan<Id, small>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
      if (err != cudaSuccess) return static_cast<int>(err);                 \
    }                                                                       \
    dispatch_scan<Id, small><<<grid, kThreads, smem, s>>>(                  \
        static_cast<const Id*>(experts), pos, kept, r, n_experts, e_lo, ew, \
        capacity, first_chunk != 0, ws, ws_words);                          \
  } while (0)
  if (id_bytes == 4 && small) DISPATCH_SCAN(int, true);
  else if (id_bytes == 4) DISPATCH_SCAN(int, false);
  else if (small) DISPATCH_SCAN(long long, true);
  else DISPATCH_SCAN(long long, false);
#undef DISPATCH_SCAN
  return static_cast<int>(cudaGetLastError());
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
