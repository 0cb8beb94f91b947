// Bank-major row gather and scatter for Hopper (sm_90a): the paged-KV read
// and write paths of the serving engine.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/banked_gather/kernel.py  banked_gather_kernel
//   src/repro/kernels/banked_scatter/kernel.py banked_scatter_kernel
// There the BlockSpec index map did the gather: a scalar-prefetched request
// stream picked the (physical row, column tile) block each grid step DMAs.
// Here one warp serves one (request row, column chunk) task: it loads the
// row's index once (all lanes the same word, one transaction), maps it to
// its physical row (physical_row_of below, the __device__ copy of
// repro_torch.core.arch.physical_row_of) and copies the chunk with 16-byte
// words, neighbouring lanes on neighbouring words, kUnroll loads in flight
// per lane and table before the stores.
//
// What bounds it: bytes.  A call moves N rows in and N rows out and does no
// arithmetic beyond the row address, so its floor is 2·N·D·elt bytes over
// the card's memory rate.  At the serving shapes (tens of page lines of 4 K
// elements) that floor is well under a microsecond, below the launch
// latency; there the time is the launch and the chain index load -> row
// map -> data load -> store, and the design keeps that chain short:
//   * the row map runs in 32-bit integers when the table's rows and the
//     call's indices fit in int32 (every serving pool), 64-bit otherwise;
//     power-of-two bank counts divide by shift and mask, other counts (12,
//     6) by a multiply-shift constant the host computes
//     (repro_torch.kernels.banked_gather.ops.row_map);
//   * the K and V pools of a layer share one index vector, so the paired
//     entries copy both tables in one launch, one index load and one row
//     map for both;
//   * a small call cuts a row into chunks so that more warps share it; a
//     large one gives each warp a whole row (the host picks the chunk).
// Where bytes rule (thousands of page lines) each warp keeps 2·kUnroll
// (pair) or kUnroll 16-byte loads in flight per lane.
//
// The scatter's rule for duplicate indices is the reference's: the last
// writer in index order wins.  Warps run in no order, so it cannot come
// from launch order.  Two designs, both linear in N:
//   * staged (N <= kStagedMax, one launch: the decode append and the
//     serving prefill ingest): each block copies the N indices into shared
//     memory once, and a warp writes its row only when no later index
//     names the same row;
//   * claimed (any N, two launches): scatter_claim takes atomicMax(i + 1)
//     of every update into a zeroed per-device workspace word of its
//     physical row; scatter_claimed then gives each warp one whole row,
//     writes it where the word holds its own i + 1 and zeroes the word.
//     Only the winner zeroes a word, after reading it, and a loser's tag
//     never equals the word's value or 0, so the workspace is zero again
//     after every call and the result does not depend on warp order.  No
//     host counter is involved, so a call captured in a CUDA graph replays
//     correctly.
//
// A row index outside the table is a caller bug that would read or write
// another allocation: the kernels stop (__trap; the error surfaces at the
// next synchronisation, like a failed device-side assert).
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); the Python wrappers check device, dtype, shape and
// contiguity before they get here.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

// The row map's constants, built once per (table rows, layout, index
// width) on the host (RowMap of the Python wrapper, same layout) and
// passed to every entry by pointer.
struct RowMap {
  u64 v_rows;
  u64 rows_per_bank;
  u64 magic;        // ceil(2^magic_shift / n_banks): 32-bit path, other counts
  int n_banks;
  int map;
  int shift;        // offset map: bank bits start here
  int log2_banks;   // -1 when n_banks is not a power of two
  int magic_shift;
  int index_bits;   // 32 or 64: the integer width of the row math
};

namespace {

enum MapKind { MAP_LSB = 0, MAP_OFFSET = 1, MAP_XOR = 2, MAP_FOLD = 3 };

constexpr int kWarps = 4;              // warps per block: one task each
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;             // loads in flight per lane and table
constexpr int kStagedMax = 256;        // most indices the staged scatter takes
constexpr int kClaimThreads = 256;

// x / n_banks for x < 2^31 on the 32-bit path; any x on the 64-bit one.
template <typename I>
__device__ __forceinline__ I div_banks(I x, const RowMap& m) {
  if (m.log2_banks >= 0) return x >> m.log2_banks;
  if constexpr (sizeof(I) == 4) {
    return static_cast<I>((static_cast<u64>(x) * m.magic) >> m.magic_shift);
  } else {
    return x / static_cast<I>(m.n_banks);
  }
}

// bank_slot_of + physical_row_of of repro_torch.core.arch in unsigned I;
// xor and fold take power-of-two bank counts only (the host refuses others).
template <typename I>
__device__ __forceinline__ I physical_row_of(I r, const RowMap& m) {
  const I n_banks = static_cast<I>(m.n_banks);
  I bank, slot;
  switch (m.map) {
    case MAP_LSB:
      slot = div_banks<I>(r, m);
      bank = r - slot * n_banks;
      break;
    case MAP_OFFSET: {
      const I high = r >> m.shift;
      const I q = div_banks<I>(high, m);
      bank = high - q * n_banks;
      slot = (q << m.shift) | (r & ((I(1) << m.shift) - 1));
      break;
    }
    case MAP_XOR:
      bank = (r ^ (r >> m.log2_banks)) & (n_banks - 1);
      slot = r >> m.log2_banks;
      break;
    default:  // MAP_FOLD
      bank = (r + (r >> m.log2_banks)) & (n_banks - 1);
      slot = r >> m.log2_banks;
      break;
  }
  return bank * static_cast<I>(m.rows_per_bank) + slot;
}

// The physical row of logical row r; stops the kernel when r or its
// physical row lies outside the table.  r < v_rows <= 2^31 - 1 on the
// 32-bit path, so the cast to I is exact there.
template <typename I>
__device__ __forceinline__ I checked_row(long long r, const RowMap& m) {
  if (static_cast<u64>(r) >= m.v_rows) __trap();
  const I phys = physical_row_of<I>(static_cast<I>(r), m);
  if (static_cast<u64>(phys) >= m.v_rows) __trap();
  return phys;
}

// Up to two tables that share one index vector: src[t] rows are copied to
// dst[t] rows.
struct Tables {
  const void* src[2];
  void* dst[2];
};

// Words [begin, end) of one row of each of the NT tables, from row offset
// src_off (words) of src[t] to dst_off of dst[t], by one warp.
template <typename V, int NT>
__device__ __forceinline__ void copy_span(const Tables& t, size_t src_off,
                                          size_t dst_off, long long begin,
                                          long long end, int lane) {
  const V* src[NT];
  V* dst[NT];
#pragma unroll
  for (int s = 0; s < NT; ++s) {
    src[s] = static_cast<const V*>(t.src[s]) + src_off;
    dst[s] = static_cast<V*>(t.dst[s]) + dst_off;
  }
  for (long long k = begin + lane; k < end; k += 32 * kUnroll) {
    V buf[NT][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = k + 32 * u;
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        if (w < end) buf[s][u] = src[s][w];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = k + 32 * u;
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        if (w < end) dst[s][w] = buf[s][u];
      }
    }
  }
}

// One warp per (row i, chunk blockIdx.y): out_t[i] = table_t[phys(idx[i])].
template <typename V, typename I, int NT>
__global__ void __launch_bounds__(kThreads)
    gather_rows(Tables t, const long long* __restrict__ idx, long long n,
                long long row_vecs, long long chunk_vecs, RowMap m) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const I phys = checked_row<I>(idx[i], m);
  const long long begin = static_cast<long long>(blockIdx.y) * chunk_vecs;
  const long long end =
      begin + chunk_vecs < row_vecs ? begin + chunk_vecs : row_vecs;
  copy_span<V, NT>(t, static_cast<size_t>(phys) * row_vecs,
                   static_cast<size_t>(i) * row_vecs, begin, end,
                   threadIdx.x & 31);
}

// The staged scatter (n <= kStagedMax): table_t[phys(idx[i])] = updates_t[i]
// where no later index names the same row.  Logical rows inside the table
// map one to one onto physical rows, so equal indices are equal rows.
template <typename V, typename I, int NT>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_staged(Tables t, const long long* __restrict__ idx,
                        long long n, long long row_vecs, long long chunk_vecs,
                        RowMap m) {
  __shared__ long long staged[kStagedMax];
  for (int k = threadIdx.x; k < n; k += kThreads) staged[k] = idx[k];
  __syncthreads();
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp: i is the warp's
  const int lane = threadIdx.x & 31;
  const long long r = staged[i];
  const I phys = checked_row<I>(r, m);
  bool later = false;
  for (long long k = i + 1 + lane; k < n; k += 32) later |= staged[k] == r;
  if (__any_sync(0xffffffffu, later)) return;
  const long long begin = static_cast<long long>(blockIdx.y) * chunk_vecs;
  const long long end =
      begin + chunk_vecs < row_vecs ? begin + chunk_vecs : row_vecs;
  copy_span<V, NT>(t, static_cast<size_t>(i) * row_vecs,
                   static_cast<size_t>(phys) * row_vecs, begin, end, lane);
}

// The claimed scatter, first launch: the workspace word of each update's
// physical row ends as 1 + the largest i naming it.
template <typename I>
__global__ void __launch_bounds__(kClaimThreads)
    scatter_claim(const long long* __restrict__ idx, long long n,
                  u64* __restrict__ claims, RowMap m) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kClaimThreads + threadIdx.x;
  if (i >= n) return;
  atomicMax(claims + checked_row<I>(idx[i], m), static_cast<u64>(i + 1));
}

// The claimed scatter, second launch: one warp per update row; the winner
// copies its whole row into each table and zeroes its word.
template <typename V, typename I, int NT>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_claimed(Tables t, const long long* __restrict__ idx,
                         long long n, long long row_vecs, u64* claims,
                         RowMap m) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const I phys = checked_row<I>(idx[i], m);
  int won = 0;
  if (lane == 0) {
    won = claims[phys] == static_cast<u64>(i + 1);
    if (won) claims[phys] = 0;
  }
  if (!__shfl_sync(0xffffffffu, won, 0)) return;
  copy_span<V, NT>(t, static_cast<size_t>(i) * row_vecs,
                   static_cast<size_t>(phys) * row_vecs, 0, row_vecs, lane);
}

// The widest access (16, 8, 4, 2 or 1 bytes) that divides the row and
// chunk widths and the alignment of every base pointer.
int vector_bytes(long long row_bytes, long long chunk_bytes, const Tables& t,
                 int nt) {
  uintptr_t addr = 0;
  for (int s = 0; s < nt; ++s) {
    addr |= reinterpret_cast<uintptr_t>(t.src[s]) |
            reinterpret_cast<uintptr_t>(t.dst[s]);
  }
  for (int w = 16; w > 1; w /= 2) {
    if (row_bytes % w == 0 && chunk_bytes % w == 0 && addr % w == 0) return w;
  }
  return 1;
}

// Calls f with a value of the unsigned word type of the given width and of
// the index type of the given width; f instantiates the kernel for them.
template <typename F>
void with_types(int vec_bytes, int index_bits, F&& f) {
  auto by_index = [&](auto word) {
    if (index_bits == 32) {
      f(word, uint32_t{});
    } else {
      f(word, u64{});
    }
  };
  switch (vec_bytes) {
    case 16: by_index(uint4{}); break;
    case 8: by_index(uint2{}); break;
    case 4: by_index(uint32_t{}); break;
    case 2: by_index(uint16_t{}); break;
    default: by_index(uint8_t{}); break;
  }
}

// A (rows / kWarps, chunks) grid of kWarps-warp blocks.
dim3 task_grid(long long n, long long row_bytes, long long chunk_bytes) {
  return dim3(static_cast<unsigned>((n + kWarps - 1) / kWarps),
              static_cast<unsigned>((row_bytes + chunk_bytes - 1) /
                                    chunk_bytes));
}

template <typename V, typename I>
void gather_as(int nt, const Tables& t, const long long* idx, long long n,
               long long row_bytes, long long chunk_bytes, const RowMap& m,
               cudaStream_t s) {
  const dim3 grid = task_grid(n, row_bytes, chunk_bytes);
  const long long rv = row_bytes / sizeof(V), cv = chunk_bytes / sizeof(V);
  if (nt == 2) {
    gather_rows<V, I, 2><<<grid, kThreads, 0, s>>>(t, idx, n, rv, cv, m);
  } else {
    gather_rows<V, I, 1><<<grid, kThreads, 0, s>>>(t, idx, n, rv, cv, m);
  }
}

template <typename V, typename I>
void staged_as(int nt, const Tables& t, const long long* idx, long long n,
               long long row_bytes, long long chunk_bytes, const RowMap& m,
               cudaStream_t s) {
  const dim3 grid = task_grid(n, row_bytes, chunk_bytes);
  const long long rv = row_bytes / sizeof(V), cv = chunk_bytes / sizeof(V);
  if (nt == 2) {
    scatter_rows_staged<V, I, 2><<<grid, kThreads, 0, s>>>(t, idx, n, rv, cv,
                                                          m);
  } else {
    scatter_rows_staged<V, I, 1><<<grid, kThreads, 0, s>>>(t, idx, n, rv, cv,
                                                          m);
  }
}

template <typename V, typename I>
void claimed_as(int nt, const Tables& t, const long long* idx, long long n,
                long long row_bytes, u64* claims, const RowMap& m,
                cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  const long long rv = row_bytes / sizeof(V);
  if (nt == 2) {
    scatter_rows_claimed<V, I, 2><<<blocks, kThreads, 0, s>>>(t, idx, n, rv,
                                                             claims, m);
  } else {
    scatter_rows_claimed<V, I, 1><<<blocks, kThreads, 0, s>>>(t, idx, n, rv,
                                                             claims, m);
  }
}

int launch_gather(int nt, const Tables& t, const long long* idx, long long n,
                  long long row_bytes, long long chunk_bytes, const RowMap& m,
                  cudaStream_t s) {
  with_types(vector_bytes(row_bytes, chunk_bytes, t, nt), m.index_bits,
             [&](auto word, auto index) {
               gather_as<decltype(word), decltype(index)>(
                   nt, t, idx, n, row_bytes, chunk_bytes, m, s);
             });
  return static_cast<int>(cudaGetLastError());
}

int launch_staged(int nt, const Tables& t, const long long* idx, long long n,
                  long long row_bytes, long long chunk_bytes, const RowMap& m,
                  cudaStream_t s) {
  if (n > kStagedMax) return static_cast<int>(cudaErrorInvalidValue);
  with_types(vector_bytes(row_bytes, chunk_bytes, t, nt), m.index_bits,
             [&](auto word, auto index) {
               staged_as<decltype(word), decltype(index)>(
                   nt, t, idx, n, row_bytes, chunk_bytes, m, s);
             });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry takes the row map (RowMap above) by pointer and launches on
// the given stream.

// out[i] = table[physical_row_of(idx[i])], rows of row_bytes bytes.
int banked_gather_launch(const void* table, void* out, const long long* idx,
                         long long n, long long row_bytes,
                         long long chunk_bytes, const RowMap* map,
                         void* stream) {
  const Tables t = {{table, nullptr}, {out, nullptr}};
  return launch_gather(1, t, idx, n, row_bytes, chunk_bytes, *map,
                       static_cast<cudaStream_t>(stream));
}

// The same for two tables of one shape that share the indices (a layer's
// K and V pools), in one launch.
int banked_gather_pair_launch(const void* table0, const void* table1,
                              void* out0, void* out1, const long long* idx,
                              long long n, long long row_bytes,
                              long long chunk_bytes, const RowMap* map,
                              void* stream) {
  const Tables t = {{table0, table1}, {out0, out1}};
  return launch_gather(2, t, idx, n, row_bytes, chunk_bytes, *map,
                       static_cast<cudaStream_t>(stream));
}

// table[physical_row_of(idx[i])] = updates[i] in place, last writer wins;
// one launch, n <= kStagedMax (cudaErrorInvalidValue otherwise).
int banked_scatter_launch(void* table, const void* updates,
                          const long long* idx, long long n,
                          long long row_bytes, long long chunk_bytes,
                          const RowMap* map, void* stream) {
  const Tables t = {{updates, nullptr}, {table, nullptr}};
  return launch_staged(1, t, idx, n, row_bytes, chunk_bytes, *map,
                       static_cast<cudaStream_t>(stream));
}

// The same for two tables that share the indices, in one launch.
int banked_scatter_pair_launch(void* table0, void* table1,
                               const void* updates0, const void* updates1,
                               const long long* idx, long long n,
                               long long row_bytes, long long chunk_bytes,
                               const RowMap* map, void* stream) {
  const Tables t = {{updates0, updates1}, {table0, table1}};
  return launch_staged(2, t, idx, n, row_bytes, chunk_bytes, *map,
                       static_cast<cudaStream_t>(stream));
}

// The claimed scatter's first launch: claims (>= v_rows words, all zero)
// gets 1 + the last index naming each physical row.
int banked_scatter_claim_launch(const long long* idx, long long n,
                                unsigned long long* claims,
                                const RowMap* map, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n + kClaimThreads - 1) / kClaimThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map->index_bits == 32) {
    scatter_claim<uint32_t><<<blocks, kClaimThreads, 0, s>>>(idx, n, claims,
                                                             *map);
  } else {
    scatter_claim<u64><<<blocks, kClaimThreads, 0, s>>>(idx, n, claims,
                                                        *map);
  }
  return static_cast<int>(cudaGetLastError());
}

// Its second launch, on n_tables (1 or 2) tables: each claimed row is
// written by its last writer, and claims is all zero again.
int banked_scatter_copy_launch(int n_tables, void* table0, void* table1,
                               const void* updates0, const void* updates1,
                               const long long* idx, long long n,
                               long long row_bytes,
                               unsigned long long* claims,
                               const RowMap* map, void* stream) {
  const Tables t = {{updates0, updates1}, {table0, table1}};
  const RowMap m = *map;
  with_types(vector_bytes(row_bytes, row_bytes, t, n_tables), m.index_bits,
             [&](auto word, auto index) {
               claimed_as<decltype(word), decltype(index)>(
                   n_tables, t, idx, n, row_bytes, claims, m,
                   static_cast<cudaStream_t>(stream));
             });
  return static_cast<int>(cudaGetLastError());
}

const char* banked_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
