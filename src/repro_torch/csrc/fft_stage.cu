// One radix-4 decimation-in-frequency pass for Hopper (sm_90a): the data
// path of the paper's Table III workload.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft_stage/kernel.py  fft_stage_kernel
// There each grid step holds 128 rows of the (rows, 4, sub) split re/im
// planes in VMEM and runs the butterfly as vector arithmetic over the last
// axis.  Here one thread computes one butterfly column (row, q): it loads
// x[row, k, q] for k = 0..3 from both planes, applies the ±1/±j radix-4 DFT
// of the reference, multiplies all four outputs by their twiddles (row 0's
// twiddle is 1, multiplied all the same, as the reference does) and writes
// the four outputs to new planes.  Neighbouring threads take neighbouring q,
// so every load and store of a warp is one run of neighbouring words when
// sub ≥ 32; the short tail passes (sub < 32) stride by 4·sub words and lean
// on the L1/L2 lines the neighbouring threads share.
//
// What bounds it: bytes.  A pass reads two f32 planes and writes two (16
// bytes a point; the twiddles are 8 bytes per (k, q), shared by all rows)
// and does 40 flops a column (10 a point), far below the card's 67 TFLOP/s
// f32, so a pass over 1024 transforms of 4096 points (64 MiB moved) is
// bound at about 20 µs at 3.35 TB/s.  The design keeps one pass per launch, as the
// reference does, so a whole transform moves its planes log4(n) times.
//
// The arithmetic is the reference's, operation for operation, in round-to-
// nearest intrinsics (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never
// contracts into fused multiply-adds: the kernel rounds where the plain
// PyTorch version rounds.  The tests still hold it to a stated tolerance
// (1e-5 per pass), not to equality.
//
// The C entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper checks shapes, dtype and device.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

  const float x0r = xr[base], x1r = xr[base + sub];
  const float x2r = xr[base + 2 * sub], x3r = xr[base + 3 * sub];
  const float x0i = xi[base], x1i = xi[base + sub];
  const float x2i = xi[base + 2 * sub], x3i = xi[base + 3 * sub];

  // radix-4 DFT: W4 = [[1,1,1,1],[1,-j,-1,j],[1,-1,1,-1],[1,j,-1,-j]]
  const float a_r = __fadd_rn(x0r, x2r), a_i = __fadd_rn(x0i, x2i);
  const float b_r = __fsub_rn(x0r, x2r), b_i = __fsub_rn(x0i, x2i);
  const float c_r = __fadd_rn(x1r, x3r), c_i = __fadd_rn(x1i, x3i);
  const float d_r = __fsub_rn(x1r, x3r), d_i = __fsub_rn(x1i, x3i);
  float y_r[4], y_i[4];
  y_r[0] = __fadd_rn(a_r, c_r); y_i[0] = __fadd_rn(a_i, c_i);
  y_r[1] = __fadd_rn(b_r, d_i); y_i[1] = __fsub_rn(b_i, d_r);  // b - j·d
  y_r[2] = __fsub_rn(a_r, c_r); y_i[2] = __fsub_rn(a_i, c_i);
  y_r[3] = __fsub_rn(b_r, d_i); y_i[3] = __fadd_rn(b_i, d_r);  // b + j·d

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wr = twr[k * sub + q], wi = twi[k * sub + q];
    yr[base + k * sub] =
        __fsub_rn(__fmul_rn(y_r[k], wr), __fmul_rn(y_i[k], wi));
    yi[base + k * sub] =
        __fadd_rn(__fmul_rn(y_r[k], wi), __fmul_rn(y_i[k], wr));
  }
}

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

const char* fft_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
