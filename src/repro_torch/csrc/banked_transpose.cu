// Tiled matrix transpose for Hopper (sm_90a): the data path of the paper's
// Table II workload.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/banked_transpose/kernel.py  banked_transpose_kernel
// There each grid step DMAs one 128×128 tile into VMEM, transposes it in
// registers and writes it back at the mirrored tile position.  Here one
// thread block of 32×8 threads moves one 32×32 tile through shared memory:
// it reads tile (i, j) of x row by row (neighbouring threads on neighbouring
// addresses) and writes tile (j, i) of the output row by row, so both sides
// of the transpose touch device memory in whole 128-byte lines.
//
// What bounds it: bytes.  A call reads N·M elements and writes N·M elements
// and computes nothing, so its floor is 2·N·M·elt bytes over the card's
// memory rate (about 160 µs for an 8192×8192 f32 matrix at 3.35 TB/s).
//
// The shared-memory tile is the paper's own problem on a GPU.  Shared memory
// has 32 banks of 4-byte words.  Without padding, the column read of the
// write-out phase (32 threads reading tile[0..31][k]) hits one bank 32 times
// and serializes 32:1 — the column-store serialization of the paper's Table II,
// where the store cycles of the 16-bank LSB memory run about 16× its load
// cycles.  Padding each tile row by one 4-byte word (tile[32][33] for 4-byte
// elements, tile[32][34] for 2-byte ones) is the paper's offset map: it skews
// row r by r banks, so the 32 reads of a column land in 32 distinct banks.
//
// The kernel is templated on the element size, not the type: bf16, f16, f32
// and int32 move as raw 2- or 4-byte words.  It handles any N and M (edge
// tiles are masked); the Python wrapper keeps the reference's shape rule.
// The C entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // tile edge: one warp spans a tile row
constexpr int kRows = 8;   // thread rows per block: each thread moves 4 rows

template <typename W>
__global__ void transpose_tiles(const W* __restrict__ x, W* __restrict__ out,
                                long long n, long long m) {
  // one 4-byte word of padding per tile row (see the note above)
  constexpr int kPad = 4 / sizeof(W);
  __shared__ W tile[kTile][kTile + kPad];

  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;  // of x
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;  // of x
  const int tx = threadIdx.x, ty = threadIdx.y;

  const long long c = col0 + tx;
  for (int k = ty; k < kTile; k += kRows) {
    const long long r = row0 + k;
    if (r < n && c < m) tile[k][tx] = x[r * m + c];
  }
  __syncthreads();
  // out[c][r] = x[r][c]: output row col0 + k holds input column col0 + k
  const long long oc = row0 + tx;
  for (int k = ty; k < kTile; k += kRows) {
    const long long orow = col0 + k;
    if (orow < m && oc < n) out[orow * n + oc] = tile[tx][k];
  }
}

template <typename W>
void launch(const void* x, void* out, long long n, long long m,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kTile - 1) / kTile),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  const dim3 block(kTile, kRows);
  transpose_tiles<W><<<grid, block, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), n, m);
}

}  // namespace

extern "C" {

// out (m, n) = x (n, m) transposed; elements of elt_bytes (2 or 4) bytes.
int banked_transpose_launch(const void* x, void* out, long long n,
                            long long m, int elt_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elt_bytes) {
    case 4: launch<uint32_t>(x, out, n, m, s); break;
    case 2: launch<uint16_t>(x, out, n, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* banked_transpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
