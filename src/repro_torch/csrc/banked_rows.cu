// Bank-major row gather and scatter for Hopper (sm_90a): the paged-KV read
// and write paths of the serving engine.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/banked_gather/kernel.py  banked_gather_kernel
//   src/repro/kernels/banked_scatter/kernel.py banked_scatter_kernel
// There the BlockSpec index map did the gather: a scalar-prefetched request
// stream picked the (physical row, column tile) block each grid step DMAs.
// Here one thread block serves one (request row, column tile) pair and loads
// its own index; physical_row_of below is the __device__ copy of
// repro_torch.core.arch.physical_row_of.
//
// What bounds it: bytes.  A call moves N rows in and N rows out and does no
// arithmetic beyond the row address, so its floor is 2·N·D·elt bytes over
// the card's memory rate.  At serving shapes (tens of page lines of 4 K
// elements) that floor is well under a microsecond, below the launch
// latency, so the design keeps the kernel simple: rows are copied as raw
// bytes with the widest vector access (16 bytes when the row allows it) so
// one kernel serves every element type, neighbouring threads touch
// neighbouring 16-byte words, and a row is cut into 512-element tiles
// (the reference's D_TILE) or taken whole when it is narrower.
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); the Python wrappers check device, dtype, shape and
// contiguity before they get here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum MapKind { MAP_LSB = 0, MAP_OFFSET = 1, MAP_XOR = 2, MAP_FOLD = 3 };

struct Layout {
  long long n_banks;
  long long rows_per_bank;
  int map;
  int shift;       // offset map: bank bits start here
  int log2_banks;  // xor / fold maps (power-of-two bank counts only)
};

// bank_slot_of + physical_row_of of repro_torch.core.arch.  lsb and offset
// use / and % exactly as the Python does (equal to its floor forms for the
// non-negative rows the kernels accept), so any bank count works; xor and
// fold mix address bits and take power-of-two counts only.
__device__ __forceinline__ long long physical_row_of(long long r,
                                                     const Layout& L) {
  long long bank, slot;
  switch (L.map) {
    case MAP_LSB:
      bank = r % L.n_banks;
      slot = r / L.n_banks;
      break;
    case MAP_OFFSET: {
      const long long high = r >> L.shift;
      const long long low = r & ((1LL << L.shift) - 1);
      bank = high % L.n_banks;
      slot = ((high / L.n_banks) << L.shift) | low;
      break;
    }
    case MAP_XOR:
      bank = (r ^ (r >> L.log2_banks)) & (L.n_banks - 1);
      slot = r >> L.log2_banks;
      break;
    default:  // MAP_FOLD
      bank = (r + (r >> L.log2_banks)) & (L.n_banks - 1);
      slot = r >> L.log2_banks;
      break;
  }
  return bank * L.rows_per_bank + slot;
}

// A row index outside the table is a caller bug that would otherwise read
// or write another allocation: stop the kernel (the error surfaces at the
// next synchronisation, like a failed device-side assert).
__device__ __forceinline__ long long checked_row(long long r, long long v_rows,
                                                 const Layout& L) {
  const long long phys = physical_row_of(r, L);
  if (r < 0 || phys < 0 || phys >= v_rows) __trap();
  return phys;
}

template <typename V>
__global__ void gather_rows(const V* __restrict__ table,
                            const long long* __restrict__ idx,
                            V* __restrict__ out, long long v_rows,
                            long long row_vecs, long long tile_vecs,
                            Layout L) {
  const long long i = blockIdx.x;
  const long long phys = checked_row(idx[i], v_rows, L);
  const long long start = blockIdx.y * tile_vecs;
  const long long end =
      start + tile_vecs < row_vecs ? start + tile_vecs : row_vecs;
  const V* src = table + phys * row_vecs;
  V* dst = out + i * row_vecs;
  for (long long k = start + threadIdx.x; k < end; k += blockDim.x) {
    dst[k] = src[k];
  }
}

// Blocks run in no order, so duplicate indices cannot resolve by launch
// order: the block of update i writes only when no later update names the
// same row (last writer in index order wins, the reference's rule).  The
// check is O(N) per block, O(N²) in all — right for the tens of page lines
// a serving step writes, not for very large N.
template <typename V>
__global__ void scatter_rows(V* __restrict__ table,
                             const long long* __restrict__ idx,
                             const V* __restrict__ updates, long long n,
                             long long v_rows, long long row_vecs,
                             long long tile_vecs, Layout L) {
  const long long i = blockIdx.x;
  const long long r = idx[i];
  const long long phys = checked_row(r, v_rows, L);
  int later = 0;
  for (long long k = i + 1 + threadIdx.x; k < n; k += blockDim.x) {
    later |= (idx[k] == r);
  }
  if (__syncthreads_or(later)) return;
  const long long start = blockIdx.y * tile_vecs;
  const long long end =
      start + tile_vecs < row_vecs ? start + tile_vecs : row_vecs;
  const V* src = updates + i * row_vecs;
  V* dst = table + phys * row_vecs;
  for (long long k = start + threadIdx.x; k < end; k += blockDim.x) {
    dst[k] = src[k];
  }
}

constexpr int kThreads = 128;

// The widest access (16, 8, 4, 2 or 1 bytes) that divides the row and tile
// widths and the alignment of both base pointers.
int vector_bytes(long long row_bytes, long long tile_bytes, const void* a,
                 const void* b) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w > 1; w /= 2) {
    if (row_bytes % w == 0 && tile_bytes % w == 0 && addr % w == 0) return w;
  }
  return 1;
}

// Calls f with a value of the unsigned word type of the given width; f
// instantiates the copy kernel for that word.
template <typename F>
void with_vector_type(int bytes, F&& f) {
  switch (bytes) {
    case 16: f(uint4{}); break;
    case 8: f(uint2{}); break;
    case 4: f(uint32_t{}); break;
    case 2: f(uint16_t{}); break;
    default: f(uint8_t{}); break;
  }
}

Layout make_layout(long long v_rows, int n_banks, int map, int shift,
                   int log2_banks) {
  Layout L;
  L.n_banks = n_banks;
  L.rows_per_bank = v_rows / n_banks;
  L.map = map;
  L.shift = shift;
  L.log2_banks = log2_banks;
  return L;
}

template <typename V>
void launch_gather(const void* table, const long long* idx, void* out,
                   long long n, long long v_rows, long long row_bytes,
                   long long tile_bytes, const Layout& L,
                   cudaStream_t stream) {
  const long long row_vecs = row_bytes / sizeof(V);
  const long long tile_vecs = tile_bytes / sizeof(V);
  const unsigned tiles =
      static_cast<unsigned>((row_vecs + tile_vecs - 1) / tile_vecs);
  const dim3 grid(static_cast<unsigned>(n), tiles);
  gather_rows<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), v_rows,
      row_vecs, tile_vecs, L);
}

template <typename V>
void launch_scatter(void* table, const long long* idx, const void* updates,
                    long long n, long long v_rows, long long row_bytes,
                    long long tile_bytes, const Layout& L,
                    cudaStream_t stream) {
  const long long row_vecs = row_bytes / sizeof(V);
  const long long tile_vecs = tile_bytes / sizeof(V);
  const unsigned tiles =
      static_cast<unsigned>((row_vecs + tile_vecs - 1) / tile_vecs);
  const dim3 grid(static_cast<unsigned>(n), tiles);
  scatter_rows<V><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(table), idx, static_cast<const V*>(updates), n, v_rows,
      row_vecs, tile_vecs, L);
}

}  // namespace

extern "C" {

// out[i] = table[physical_row_of(idx[i])], rows of row_bytes bytes.
int banked_gather_launch(const void* table, const long long* idx, void* out,
                         long long n, long long v_rows, long long row_bytes,
                         long long tile_bytes, int n_banks, int map, int shift,
                         int log2_banks, void* stream) {
  const Layout L = make_layout(v_rows, n_banks, map, shift, log2_banks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_vector_type(vector_bytes(row_bytes, tile_bytes, table, out),
                   [&](auto word) {
                     launch_gather<decltype(word)>(table, idx, out, n, v_rows,
                                                   row_bytes, tile_bytes, L,
                                                   s);
                   });
  return static_cast<int>(cudaGetLastError());
}

// table[physical_row_of(idx[i])] = updates[i] in place; last writer wins.
int banked_scatter_launch(void* table, const long long* idx,
                          const void* updates, long long n, long long v_rows,
                          long long row_bytes, long long tile_bytes,
                          int n_banks, int map, int shift, int log2_banks,
                          void* stream) {
  const Layout L = make_layout(v_rows, n_banks, map, shift, log2_banks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_vector_type(vector_bytes(row_bytes, tile_bytes, table, updates),
                   [&](auto word) {
                     launch_scatter<decltype(word)>(table, idx, updates, n,
                                                    v_rows, row_bytes,
                                                    tile_bytes, L, s);
                   });
  return static_cast<int>(cudaGetLastError());
}

const char* banked_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
