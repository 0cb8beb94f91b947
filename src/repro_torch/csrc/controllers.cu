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
// pass.  Here one thread owns one (op, bank) request word, keeps it in a
// register and runs exactly kMaxCycles = 16 unrolled steps of
//   grant = v & ~(v - 1);  v &= v - 1
// writing each grant to out[op, c, bank].  Words with more than 16 bits set
// do not drain (0xFFFFFFFF grants 0x1 … 0x8000 and stops), as in the
// reference.
//
// What bounds it: bytes.  A word in, 16 words out, a few integer operations
// per word: at 1024 ops × 16 banks the 1,114,112 bytes take 0.33 µs (a
// launch again), at 2^18 ops the 285 MB take 85 µs.  Neighbouring threads
// own neighbouring banks, so every one of the 16 stores of a warp writes
// whole 32-byte sectors.
//
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

__global__ void arbiter(const uint32_t* __restrict__ req,
                        uint32_t* __restrict__ grants, long long n_words,
                        int n_banks) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_words) return;
  const long long op = i / n_banks;
  const int bank = static_cast<int>(i - op * n_banks);
  uint32_t v = req[i];
  uint32_t* out = grants + op * kMaxCycles * n_banks + bank;
#pragma unroll
  for (int c = 0; c < kMaxCycles; ++c) {
    const uint32_t w = v - 1u;
    out[static_cast<long long>(c) * n_banks] = v & ~w;  // lowest set bit
    v &= w;                                            // clear it
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

// requests (n_ops, n_banks) 32-bit words -> grants (n_ops, 16, n_banks).
int carry_arbiter_launch(const uint32_t* requests, uint32_t* grants,
                         long long n_ops, int n_banks, void* stream) {
  if (n_ops <= 0 || n_banks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_words = n_ops * n_banks;
  arbiter<<<blocks_for(n_words), kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(requests, grants, n_words,
                                                 n_banks);
  return static_cast<int>(cudaGetLastError());
}

const char* controllers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
