// P3M 6th-order finite-difference gradient, hand-written for Hopper
// (sm_90a).
//
// No Pallas original: it replaces the XLA stencil at the end of
// tpu_nbody/ops/mesh.py::_mesh_grids_one (:648-672) and the slab stencil
// of tpu_nbody/parallel/sharded_pm.py::_fd_force_window. Its plain torch
// form is ops/mesh.py::_fd_window_ref (the wrapped columns, then slices).
//
// What it computes: from the potential rows P (R, W) of row stride W, the
// force-grid windows fx, fy (rows, cols), rows + 6 <= R, cols <= W:
//   fx[i][j] = (c1 (P[i+3][j+1] - P[i+3][j-1]) - c2 (P[i+3][j+2] -
//               P[i+3][j-2])) + c3 (P[i+3][j+3] - P[i+3][j-3]),
//   fy[i][j] = the same over P[i+3+k][j], k = -3..3,
// columns taken mod W: the three negative taps wrap to the far padded
// edge, which is the JAX version's roll(P, 3) folded into the index.
// c1 = 45/(60h), c2 = 9/(60h), c3 = 1/(60h) as float32, the values torch
// uses for the Python scalars.
//
// What bounds it on this card: bytes. At the main path's shape (2055
// potential rows, the 2049 x 4097 windows) the 4103 columns the stencil
// reads (34 MB) and the two windows written once (67 MB): 0.030 ms at
// 3.35 TB/s. There are 16 flops an output cell.
//
// Where trouble is likely, and what the design does about it:
// - The bits: every subtraction, product and sum is rounded on its own in
//   the plain version's order (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
//   contraction), so fx and fy equal the plain version's bit for bit.
// - Re-reads: each source value feeds 13 outputs. A thread walks ROWS
//   output rows of one column and keeps the column's ROWS + 6 values in
//   registers for fy; fx's six row taps are the neighbouring lanes' loads,
//   served by L1. Lanes hold neighbouring columns, so every load and store
//   coalesces.
//
// Design: a CTA of 128 columns x ROWS rows; the row count is a launch
// parameter, so the sharded P3M launches it on its halo-extended slab.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 8;

__device__ __forceinline__ float stencil(float p1, float m1, float p2,
                                         float m2, float p3, float m3,
                                         float c1, float c2, float c3) {
  const float a = __fmul_rn(c1, __fsub_rn(p1, m1));
  const float b = __fmul_rn(c2, __fsub_rn(p2, m2));
  const float c = __fmul_rn(c3, __fsub_rn(p3, m3));
  return __fadd_rn(__fsub_rn(a, b), c);
}

__device__ __forceinline__ int wrap(int j, int W) {
  return j < 0 ? j + W : (j >= W ? j - W : j);
}

__global__ void __launch_bounds__(THREADS)
    fd_kernel(const float* __restrict__ src, int W, int rows, int cols,
              float c1, float c2, float c3, float* __restrict__ fx,
              float* __restrict__ fy) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int i0 = blockIdx.y * ROWS;
  if (j >= cols) return;
  float col[ROWS + 6];
#pragma unroll
  for (int t = 0; t < ROWS + 6; ++t)
    col[t] = i0 + t < rows + 6 ? src[(long long)(i0 + t) * W + j] : 0.0f;
  const int jm1 = wrap(j - 1, W), jm2 = wrap(j - 2, W), jm3 = wrap(j - 3, W);
  const int jp1 = wrap(j + 1, W), jp2 = wrap(j + 2, W), jp3 = wrap(j + 3, W);
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int i = i0 + t;
    if (i < rows) {
      const float* r = src + (long long)(i + 3) * W;
      const long long o = (long long)i * cols + j;
      fx[o] = stencil(r[jp1], r[jm1], r[jp2], r[jm2], r[jp3], r[jm3], c1,
                      c2, c3);
      fy[o] = stencil(col[t + 4], col[t + 2], col[t + 5], col[t + 1],
                      col[t + 6], col[t], c1, c2, c3);
    }
  }
}

}  // namespace

// src (R, W) float32, R >= rows + 6, 3 <= W, cols <= W; fx, fy (rows,
// cols).
extern "C" int tnt_fd_gradient(const float* src, int R, int W, int rows,
                               int cols, float c1, float c2, float c3,
                               float* fx, float* fy, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (R < rows + 6 || W < 3 || cols > W) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + THREADS - 1) / THREADS, (rows + ROWS - 1) / ROWS);
  fd_kernel<<<grid, THREADS, 0, stream>>>(src, W, rows, cols, c1, c2, c3, fx,
                                          fy);
  return (int)cudaGetLastError();
}
