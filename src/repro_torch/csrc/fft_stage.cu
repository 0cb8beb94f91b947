// Radix-4 decimation-in-frequency FFT for Hopper (sm_90a): the data path of
// the paper's Table III workload.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft_stage/kernel.py  fft_stage_kernel
// There each grid step holds 128 rows of the (rows, 4, sub) split re/im
// planes in VMEM and runs one DIF pass as vector arithmetic over the last
// axis; a transform is log4(n) such calls.  Here three kernels share one
// butterfly:
//
//   radix4_pass     (fft_stage_launch) one pass on the reference's planar
//                   (rows, 4, sub) layout, one thread a butterfly column:
//                   the one-pass API.
//   transform_tile  (fft_transform_launch) every pass whose segment fits
//                   4096 points, for one tile of 4096 points a block, held
//                   in shared memory; complex64 in and out, one launch.
//   wide_pass       (fft_wide_pass_launch) one pass on interleaved
//                   complex64 for a segment above 4096 points (n > 4096
//                   only), one thread a column, in place allowed.
//
// What bounds a transform: bytes.  The function reads 8 bytes a point and
// writes 8 (complex64); its arithmetic is 40 flops a butterfly column, 60
// a point over the six passes of n = 4096, far below the card's 67 TFLOP/s
// f32: 1024 transforms of 4096 points are bound at 20.0 µs by 64 MiB at
// 3.35 TB/s and at 3.8 µs by their flops.  So transform_tile reads its
// tile once and writes it once, and keeps the passes in between on chip:
//
//   * A thread owns 16 points at a time and runs two passes on them in
//     registers: in a DIF pass the butterfly digit of pass p is the point
//     index's bits 2(L-1-p)..2(L-1-p)+1 (L = the segment's passes), so 16
//     points that differ only in a 4-bit window of the index close under
//     the two passes whose digits lie in it.  The tile index (12 bits) is
//     cut into three windows, bits 8..11, 4..7 and 0..3: rounds W = 8, 4,
//     0 run local passes L-6, L-5 / L-4, L-3 / L-2, L-1 (those >= 0), so
//     every L from 1 to 6 takes the same three rounds.  Thread t's j-th
//     point in round W is tile_point<W>(t, j): the window holds j, the
//     other 8 bits hold t.
//   * The points change hands through shared memory between the rounds:
//     re and im planes of 4096 words each (32 KB), written and read with
//     three __syncthreads().  Device memory is touched twice: the load in
//     the W = 8 layout (t + 256 j: a warp reads 256 neighbouring bytes an
//     instruction) and the store in the same layout.
//   * Bank conflicts.  In the plain linear layout a warp's 32 words fall
//     on 32, 16 and 2 distinct banks in the W = 8, 4 and 0 layouts
//     (degree 1, 2 and 16).  The map below XORs the bank bits with the
//     index's bits 5..8 (bank bits 0..3) and bit 8 (bank bit 4):
//
//         word(a) = a ^ (((a >> 5) & 15) | ((a >> 4) & 16))
//
//     It is a bijection on [0, 4096), needs no padding, and puts every
//     warp access of every round on 32 distinct banks: degree 1 for the
//     puts and gets of W = 8, 4 and 0 (passes 0-1, 2-3 and 4-5 of n =
//     4096, and the store).  ops.py writes the same map as smem_word; the
//     CPU tests price every warp access with the port's conflict counter
//     and pin the degrees.
//   * Twiddles: one table per n, the per-pass (4, sub) tables of the
//     reference laid end to end as complex64 (pass p at offset
//     sum_{i<p} n / 4^i), so a warp's twiddle loads are neighbouring words
//     (or one broadcast word) in every round; 43 KB for n = 4096, read
//     through the read-only cache.  The values are the reference's own
//     (numpy complex128 cast to complex64), so no twiddle is recomputed
//     on the card.
//   * Registers: __launch_bounds__ asks for 2 blocks an SM, which leaves
//     the 16 points, a butterfly's twiddles and the addresses in registers
//     without spills; at 4 blocks an SM (64 registers) the tile spills and
//     at 3 it runs slower.
//
// A transform of n > 4096 points first runs its passes whose segments are
// larger than a tile as wide_pass launches (log4(n / 4096) of them, each
// moving the array once), then one transform_tile launch.
//
// The arithmetic is the reference's, operation for operation, in round-to-
// nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn) that nvcc never
// contracts into fused multiply-adds, with row 0's twiddle multiplied as
// the reference does: every kernel rounds where the plain PyTorch passes
// round, and a transform is bit-equal to them.
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError(); the Python wrapper checks shapes, dtype and device.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // radix4_pass and wide_pass blocks
constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;   // points a transform_tile block holds
constexpr int kTileThreads = 256;      // 16 points a thread
constexpr int kPer = kTile / kTileThreads;

__device__ __forceinline__ float2 twiddle(float yr, float yi, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(yr, w.x), __fmul_rn(yi, w.y)),
                     __fadd_rn(__fmul_rn(yr, w.y), __fmul_rn(yi, w.x)));
}

// The reference's butterfly on one column: the radix-4 DFT
// W4 = [[1,1,1,1],[1,-j,-1,j],[1,-1,1,-1],[1,j,-1,-j]], then each output
// times its twiddle.
__device__ __forceinline__ void radix4(float2& x0, float2& x1, float2& x2,
                                       float2& x3, float2 w0, float2 w1,
                                       float2 w2, float2 w3) {
  const float a_r = __fadd_rn(x0.x, x2.x), a_i = __fadd_rn(x0.y, x2.y);
  const float b_r = __fsub_rn(x0.x, x2.x), b_i = __fsub_rn(x0.y, x2.y);
  const float c_r = __fadd_rn(x1.x, x3.x), c_i = __fadd_rn(x1.y, x3.y);
  const float d_r = __fsub_rn(x1.x, x3.x), d_i = __fsub_rn(x1.y, x3.y);
  x0 = twiddle(__fadd_rn(a_r, c_r), __fadd_rn(a_i, c_i), w0);
  x1 = twiddle(__fadd_rn(b_r, d_i), __fsub_rn(b_i, d_r), w1);  // b - j·d
  x2 = twiddle(__fsub_rn(a_r, c_r), __fsub_rn(a_i, c_i), w2);
  x3 = twiddle(__fsub_rn(b_r, d_i), __fadd_rn(b_i, d_r), w3);  // b + j·d
}

__global__ void radix4_pass(const float* __restrict__ xr,
                            const float* __restrict__ xi,
                            const float* __restrict__ twr,
                            const float* __restrict__ twi,
                            float* __restrict__ yr, float* __restrict__ yi,
                            long long rows, long long sub) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * sub) return;
  const long long row = t / sub;
  const long long q = t - row * sub;
  const long long base = row * 4 * sub + q;
  float2 x[4], w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = make_float2(xr[base + k * sub], xi[base + k * sub]);
    w[k] = make_float2(twr[k * sub + q], twi[k * sub + q]);
  }
  radix4(x[0], x[1], x[2], x[3], w[0], w[1], w[2], w[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    yr[base + k * sub] = x[k].x;
    yi[base + k * sub] = x[k].y;
  }
}

// One pass on (rows, 4, 2^log_sub) complex64 with its (4, 2^log_sub)
// table.  x and y may be the same array: a thread reads the four points it
// writes, and no other thread touches them.
__global__ void wide_pass(const float2* x, float2* y,
                          const float2* __restrict__ tw, long long rows,
                          int log_sub) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (rows << log_sub)) return;
  const long long sub = 1LL << log_sub;
  const long long q = t & (sub - 1);
  const long long base = ((t >> log_sub) << (log_sub + 2)) + q;
  float2 v0 = x[base], v1 = x[base + sub], v2 = x[base + 2 * sub],
         v3 = x[base + 3 * sub];
  radix4(v0, v1, v2, v3, __ldg(tw + q), __ldg(tw + sub + q),
         __ldg(tw + 2 * sub + q), __ldg(tw + 3 * sub + q));
  y[base] = v0;
  y[base + sub] = v1;
  y[base + 2 * sub] = v2;
  y[base + 3 * sub] = v3;
}

// A point's word in each shared-memory plane (see the header).
__device__ __forceinline__ int smem_word(int a) {
  return a ^ (((a >> 5) & 15) | ((a >> 4) & 16));
}

// Thread t's j-th point of the tile when the round's window sits at bit W.
template <int W>
__device__ __forceinline__ int tile_point(int t, int j) {
  return ((t >> W) << (W + 4)) | (j << W) | (t & ((1 << W) - 1));
}

// Offset of local pass p's (4, sub) table in a segment of 4^L points.
__host__ __device__ constexpr int table_offset(int L, int p) {
  return p == 0 ? 0 : table_offset(L, p - 1) + (1 << (2 * (L - p + 1)));
}

// Round W on a thread's 16 points: local pass L-2-W/2 (digit j >> 2: four
// butterflies, one per j & 3) then L-1-W/2 (digit j & 3: four butterflies
// on the same column, so one set of twiddles), each if it exists.
template <int L, int W>
__device__ __forceinline__ void tile_round(float2 (&v)[kPer], int t,
                                           const float2* __restrict__ tw) {
  constexpr int pa = L - 2 - W / 2, pb = pa + 1;
  const int low = t & ((1 << W) - 1);
  if constexpr (pa >= 0) {
    constexpr int sub = 1 << (W + 2);
    constexpr int off = table_offset(L, pa);
    const float2* tp = tw + off;
#pragma unroll
    for (int jl = 0; jl < 4; ++jl) {
      const int q = (jl << W) | low;
      radix4(v[jl], v[4 + jl], v[8 + jl], v[12 + jl], __ldg(tp + q),
             __ldg(tp + sub + q), __ldg(tp + 2 * sub + q),
             __ldg(tp + 3 * sub + q));
    }
  }
  if constexpr (pb >= 0) {
    constexpr int sub = 1 << W;
    constexpr int off = table_offset(L, pb);
    const float2* tp = tw + off + low;
    const float2 w0 = __ldg(tp), w1 = __ldg(tp + sub),
                 w2 = __ldg(tp + 2 * sub), w3 = __ldg(tp + 3 * sub);
#pragma unroll
    for (int jh = 0; jh < 4; ++jh)
      radix4(v[4 * jh], v[4 * jh + 1], v[4 * jh + 2], v[4 * jh + 3], w0, w1,
             w2, w3);
  }
}

// The map and the tile index are XOR-linear in the index bits, and j and t
// fill disjoint bits, so point j's word is smem_word of t's point 0 XOR a
// constant: one register a round, not sixteen addresses.
template <int W>
__device__ __forceinline__ void put(float* re, float* im,
                                    const float2 (&v)[kPer], int t) {
  const int s0 = smem_word(tile_point<W>(t, 0));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = s0 ^ smem_word(j << W);
    re[s] = v[j].x;
    im[s] = v[j].y;
  }
}

template <int W>
__device__ __forceinline__ void take(const float* re, const float* im,
                                     float2 (&v)[kPer], int t) {
  const int s0 = smem_word(tile_point<W>(t, 0));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = s0 ^ smem_word(j << W);
    v[j] = make_float2(re[s], im[s]);
  }
}

// The last L passes of every 4^L-point segment of a tile of 4096 points,
// with the segment's twiddle table (those passes' tables end to end).  x
// and y may be the same array: a block reads its whole tile before it
// writes any of it.  A ragged last tile (n_points not a multiple of 4096,
// n < 4096 only) loads zeros past the end and stores nothing there: its
// segments are whole, so the zeros meet no real point.
template <int L>
__global__ void __launch_bounds__(kTileThreads, 2)
    transform_tile(const float2* x, float2* y, const float2* __restrict__ tw,
                   long long n_points) {
  __shared__ float re[kTile], im[kTile];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) << kTileLog;
  // points base + t + 256 j: the W = 8 layout, neighbouring lanes on
  // neighbouring points
  const bool whole = base + kTile <= n_points;
  const long long left = n_points - base - t;
  const float2* src = x + base + t;
  float2 v[kPer];
  if (whole) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = src[j << 8];
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = (j << 8) < left ? src[j << 8] : make_float2(0.f, 0.f);
  }
  tile_round<L, 8>(v, t, tw);
  put<8>(re, im, v, t);
  __syncthreads();
  take<4>(re, im, v, t);
  tile_round<L, 4>(v, t, tw);
  put<4>(re, im, v, t);
  __syncthreads();
  take<0>(re, im, v, t);
  tile_round<L, 0>(v, t, tw);
  put<0>(re, im, v, t);
  __syncthreads();
  take<8>(re, im, v, t);
  float2* dst = y + base + t;
  if (whole) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) dst[j << 8] = v[j];
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if ((j << 8) < left) dst[j << 8] = v[j];
  }
}

using TileKernel = void (*)(const float2*, float2*, const float2*, long long);
const TileKernel kTileKernels[] = {
    transform_tile<1>, transform_tile<2>, transform_tile<3>,
    transform_tile<4>, transform_tile<5>, transform_tile<6>};

}  // namespace

extern "C" {

// One pass on (rows, 4, sub) planes with (1, 4, sub) twiddles.
int fft_stage_launch(const float* xr, const float* xi, const float* twr,
                     const float* twi, float* yr, float* yi, long long rows,
                     long long sub, void* stream) {
  const long long total = rows * sub;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  radix4_pass<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, twr, twi, yr, yi, rows, sub);
  return static_cast<int>(cudaGetLastError());
}

// The last `passes` (1..6) passes of every 4^passes-point segment of
// n_points complex64, x -> y (x == y allowed), twiddles from `tw`.
int fft_transform_launch(const void* x, void* y, const void* tw,
                         long long n_points, int passes, void* stream) {
  if (passes < 1 || passes > 6 || n_points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((n_points + kTile - 1) >> kTileLog);
  kTileKernels[passes - 1]<<<blocks, kTileThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float2*>(tw), n_points);
  return static_cast<int>(cudaGetLastError());
}

// One pass on (rows, 4, 2^log_sub) complex64, x -> y (x == y allowed),
// with its (4, 2^log_sub) twiddles.
int fft_wide_pass_launch(const void* x, void* y, const void* tw,
                         long long rows, int log_sub, void* stream) {
  const long long total = rows << log_sub;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  wide_pass<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float2*>(tw), rows, log_sub);
  return static_cast<int>(cudaGetLastError());
}

const char* fft_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
