// The paper's two memory-controller kernels for Hopper (sm_90a): the issue
// controllers' conflict popcount (paper §III.A) and the carry-chain arbiter
// (paper §III.C).  One source, one library, two C entries.
//
// conflict_popcount replaces the Pallas TPU kernel
//   src/repro/kernels/conflict_popcount/kernel.py  conflict_popcount_kernel
// There each grid step takes 256 operations into VMEM and forms a
// (256, 16, B) one-hot equality on the VPU, sums it over the lanes and takes
// the max.  Here one thread owns one operation: it loads the op's 16 lane
// bank ids into registers (4 × int4 when the row is 16 aligned ids), counts
// them into a per-thread array of B counters, writes the counts row and the
// max.  For B in {4, 8, 16, 32} the array is a template-sized register array
// filled by an unrolled 16 × B compare (no dynamic index, so no local
// memory) and stored as int4 vectors; any other B (12 and 6 occur among the
// port's memories) takes a runtime loop over the banks, each bank counted
// by 16 compares against the ids in registers.  Ids outside [0, B),
// negative ones included, equal no counter and so count nowhere; the
// kernel never writes outside its own row.  The reference kernel counts the
// first min(lanes, 16) lanes of each row (its block is 16 lanes wide), so
// the row stride and the counted lanes are separate arguments.
//
// What bounds it: bytes.  An op reads 16 4-byte ids and writes B + 1 4-byte
// words, about 16 B compares of work: far below the card's operation rate.
// At 4096 ops and B = 16 the 540,672 bytes take 0.16 µs at 3.35 TB/s, less
// than a launch, so that shape measures launch latency; at 2^20 ops the
// 138 MB take 41 µs.  The design's answer is to touch each byte once,
// with 16-byte loads and stores where the row allows them.
//
// carry_arbiter replaces the Pallas TPU kernel
//   src/repro/kernels/carry_arbiter/kernel.py  carry_arbiter_kernel
// which evaluates all 16 grant cycles of a block of 128 operations per VPU
// pass.  Here a thread owns V neighbouring (op, bank) request words, keeps
// them in registers and runs exactly kMaxCycles = 16 unrolled steps of
//   grant = v & ~(v - 1);  v &= v - 1
// writing each grant to out[op, c, bank].  Words with more than 16 bits set
// do not drain (0xFFFFFFFF grants 0x1 … 0x8000 and stops), as in the
// reference.
//
// The port carries request and grant words as int64 tensors holding the
// 32-bit pattern, so the kernel is templated on its word widths: it reads
// 32-bit or int64 requests as they are (an int64 word keeps its low 32
// bits, as the reference's astype(uint32) and torch's int64 -> int32 do)
// and writes 32-bit or int64 grants (zero-extended, as uint32 -> int64
// widens).  A wrapper call on int32 or int64 words is one launch, with no
// conversion in front of or behind it.
//
// What bounds it: bytes, and nearly all of them are stores.  The function
// reads 4 bytes and writes 16 x 4 a request word: at 2^18 ops x 16 banks
// 285 MB, 85.1 us at 3.35 TB/s (the output is five times the L2).  The
// wrapper's contract on the port's int64 words moves twice that (8 in,
// 16 x 8 out), 570 MB, 170.3 us: the int64 grant words double the stores.
// The stores: a block computes a grant tile of up to kBulkBytes = 32 KB into
// shared memory, laid out as the grants are in device memory, and one
// thread writes it with one TMA bulk store (cp.async.bulk), so no thread
// spends instructions or registers on the stores.  A tile holds whole ops
// (each op's 16 x B grants are contiguous) when an op's row fits in 32 KB;
// a longer row (B > 256 int64 banks) is written in 32 KB chunks, one block
// and one bulk store a chunk.  16-byte streaming stores from registers
// (st.global.cs) were tried too and were slower (PERF.md).

// Both C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); the Python wrappers check shapes and types first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;      // lane ids an op can count (the SIMT width)
constexpr int kMaxCycles = 16;  // arbitration cycles per request word
constexpr int kThreads = 256;

// The op's counted lane ids, in registers; unused lanes hold -1 (no bank).
__device__ __forceinline__ void load_ids(const int* __restrict__ banks,
                                         long long op, int stride, int lanes,
                                         bool vec, int (&id)[kLanes]) {
  const int* row = banks + op * stride;
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int q = 0; q < kLanes / 4; ++q) {
      const int4 w = v[q];
      id[4 * q] = w.x;
      id[4 * q + 1] = w.y;
      id[4 * q + 2] = w.z;
      id[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) id[l] = l < lanes ? row[l] : -1;
  }
}

template <int B>
__global__ void popcount_fixed(const int* __restrict__ banks,
                               int* __restrict__ counts,
                               int* __restrict__ cycles, long long n_ops,
                               int stride, int lanes, bool vec) {
  const long long op = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (op >= n_ops) return;
  int id[kLanes];
  load_ids(banks, op, stride, lanes, vec, id);
  int c[B];
#pragma unroll
  for (int b = 0; b < B; ++b) c[b] = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int b = 0; b < B; ++b) c[b] += id[l] == b;
  }
  int most = 0;
  int4* out = reinterpret_cast<int4*>(counts + op * B);
#pragma unroll
  for (int q = 0; q < B / 4; ++q) {
    out[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
    most = max(most, max(max(c[4 * q], c[4 * q + 1]),
                         max(c[4 * q + 2], c[4 * q + 3])));
  }
  cycles[op] = most;
}

__global__ void popcount_any(const int* __restrict__ banks,
                             int* __restrict__ counts,
                             int* __restrict__ cycles, long long n_ops,
                             int stride, int lanes, bool vec, int n_banks) {
  const long long op = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (op >= n_ops) return;
  int id[kLanes];
  load_ids(banks, op, stride, lanes, vec, id);
  int most = 0;
  int* out = counts + op * n_banks;
  for (int b = 0; b < n_banks; ++b) {
    int c = 0;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) c += id[l] == b;
    out[b] = c;
    most = max(most, c);
  }
  cycles[op] = most;
}

constexpr int kBulkBytes = 32 * 1024;  // a block's grant tile, at most

// One request word as its 32-bit pattern (an int64 keeps its low 32 bits).
template <typename In>
__device__ __forceinline__ uint32_t word_of(In w) {
  return static_cast<uint32_t>(w);
}

// One cycle of the carry chain on a word: its grant, and the word cleared
// of it.
__device__ __forceinline__ uint32_t grant_step(uint32_t& v) {
  const uint32_t w = v - 1u;
  const uint32_t g = v & ~w;  // lowest set bit
  v &= w;                     // clear it
  return g;
}

// Block (x, y) fills its shared tile and writes it with one bulk store.
// With ops_per_block > 0 the tile is ops [x ops_per_block, ...), whole rows
// (gridDim.y = 1); with ops_per_block = 0 it is chunk y of op x's row,
// elements [y chunk, (y + 1) chunk) of its 16 x B grants, each computed
// from its own word by c + 1 carry-chain steps.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
arbiter_bulk(const In* __restrict__ req, Out* __restrict__ grants,
             long long n_ops, int n_banks, int ops_per_block) {
  extern __shared__ __align__(128) unsigned char tile_bytes[];
  Out* tile = reinterpret_cast<Out*>(tile_bytes);
  const int row = kMaxCycles * n_banks;  // grant words an op
  long long first;                       // the tile's first grant word
  int n_out;                             // and its count
  if (ops_per_block > 0) {
    const long long op0 =
        static_cast<long long>(blockIdx.x) * ops_per_block;
    const int n_op = static_cast<int>(
        min(static_cast<long long>(ops_per_block), n_ops - op0));
    const int words = n_op * n_banks;
    const In* in = req + op0 * n_banks;
    for (int i = threadIdx.x; i < words; i += kThreads) {
      const int o = i / n_banks;
      uint32_t v = word_of(in[i]);
      Out* out = tile + o * row + (i - o * n_banks);
#pragma unroll
      for (int c = 0; c < kMaxCycles; ++c)
        out[c * n_banks] = static_cast<Out>(grant_step(v));
    }
    first = op0 * row;
    n_out = n_op * row;
  } else {
    const int chunk = kBulkBytes / static_cast<int>(sizeof(Out));
    const int e0 = static_cast<int>(blockIdx.y) * chunk;
    const In* in = req + static_cast<long long>(blockIdx.x) * n_banks;
    n_out = min(chunk, row - e0);
    for (int i = threadIdx.x; i < n_out; i += kThreads) {
      const int c = (e0 + i) / n_banks;
      uint32_t v = word_of(in[e0 + i - c * n_banks]);
      uint32_t g = 0;
      for (int k = 0; k <= c; ++k) g = grant_step(v);
      tile[i] = static_cast<Out>(g);
    }
    first = static_cast<long long>(blockIdx.x) * row + e0;
  }
  // the generic-proxy writes above, before the async proxy reads the tile
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = static_cast<unsigned>(n_out) * sizeof(Out);
    const unsigned src =
        static_cast<unsigned>(__cvta_generic_to_shared(tile));
    Out* dst = grants + first;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(dst), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the tile must outlive the copy's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// banks (n_ops, stride) int32 -> counts (n_ops, n_banks), cycles (n_ops,)
// int32, counting the first `lanes` (<= 16) ids of each row.
int conflict_popcount_launch(const int* banks, int* counts, int* cycles,
                             long long n_ops, int stride, int lanes,
                             int n_banks, void* stream) {
  if (n_ops <= 0 || lanes < 1 || lanes > kLanes || stride < lanes ||
      n_banks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = stride == kLanes && lanes == kLanes &&
                   (reinterpret_cast<uintptr_t>(banks) & 15) == 0;
  const unsigned grid = blocks_for(n_ops);
  switch (n_banks) {
    case 4:
      popcount_fixed<4><<<grid, kThreads, 0, s>>>(banks, counts, cycles,
                                                  n_ops, stride, lanes, vec);
      break;
    case 8:
      popcount_fixed<8><<<grid, kThreads, 0, s>>>(banks, counts, cycles,
                                                  n_ops, stride, lanes, vec);
      break;
    case 16:
      popcount_fixed<16><<<grid, kThreads, 0, s>>>(banks, counts, cycles,
                                                   n_ops, stride, lanes, vec);
      break;
    case 32:
      popcount_fixed<32><<<grid, kThreads, 0, s>>>(banks, counts, cycles,
                                                   n_ops, stride, lanes, vec);
      break;
    default:
      popcount_any<<<grid, kThreads, 0, s>>>(banks, counts, cycles, n_ops,
                                             stride, lanes, vec, n_banks);
  }
  return static_cast<int>(cudaGetLastError());
}

// requests (n_ops, n_banks) words of in_bytes 4 or 8 -> grants (n_ops, 16,
// n_banks) words of out_bytes 4 or 8 (zero-extended); grants 16-byte
// aligned (a bulk store's destination must be).
int carry_arbiter_launch(const void* requests, int in_bytes, void* grants,
                         int out_bytes, long long n_ops, int n_banks,
                         void* stream) {
  if (n_ops <= 0 || n_banks < 1 || n_banks > (1 << 23) ||
      (in_bytes != 4 && in_bytes != 8) || (out_bytes != 4 && out_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(grants) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes =
      static_cast<long long>(kMaxCycles) * n_banks * out_bytes;
  // whole ops a tile, or (per_block 0) 32 KB chunks of one op's row
  const int per_block =
      row_bytes <= kBulkBytes ? static_cast<int>(kBulkBytes / row_bytes) : 0;
  const dim3 grid =
      per_block > 0
          ? dim3(static_cast<unsigned>((n_ops + per_block - 1) / per_block))
          : dim3(static_cast<unsigned>(n_ops),
                 static_cast<unsigned>((row_bytes + kBulkBytes - 1) /
                                       kBulkBytes));
  const size_t smem = per_block > 0
                          ? static_cast<size_t>(per_block * row_bytes)
                          : static_cast<size_t>(kBulkBytes);
#define ARBITER_BULK(In, Out)                                          \
  arbiter_bulk<In, Out><<<grid, kThreads, smem, s>>>(                  \
      static_cast<const In*>(requests), static_cast<Out*>(grants), n_ops, \
      n_banks, per_block)
  if (in_bytes == 4 && out_bytes == 4) ARBITER_BULK(uint32_t, uint32_t);
  else if (in_bytes == 4) ARBITER_BULK(uint32_t, long long);
  else if (out_bytes == 4) ARBITER_BULK(long long, uint32_t);
  else ARBITER_BULK(long long, long long);
#undef ARBITER_BULK
  return static_cast<int>(cudaGetLastError());
}

const char* controllers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
