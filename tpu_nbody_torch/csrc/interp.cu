// P3M force interpolation, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA interpolation of
// tpu_nbody/ops/mesh.py: _interp_packed (:596), which packs the force-grid
// windows into a per-cell table (_interp_table, :550) and gathers one row
// a body (_interp_rows, :577). Its plain torch forms are
// ops/mesh.py::_interp_packed_ref and _interp_rows_ref.
//
// What it computes: each body's weighted sum of the K cells of its
// assignment (K = 1 NGP, 4 CIC, 9 TSC) from its base cell
// base = by * nw + bx, the lanes in the table's order (k = 3 oy + ox for
// TSC; (0,0), (0,1), (1,0), (1,1) for CIC, as (oy, ox)):
//     ax = ((0 + w_0 fx_0) + w_1 fx_1) + ...,   ay alike from fy,
// and for K = 1 simply (w_0 fx_0, w_0 fy_0). Two entries:
// - windows: fx and fy read straight from the (rows, ld) force-grid
//   windows of _fd_gradient at (by + oy) * ld + bx + ox. The table's rows
//   are nw wide, the windows' ld = nw + 1 + reach: the kernel splits base
//   by nw and indexes with ld. No table is built.
// - table: a packed table of rows of L = 2K lanes (fx_k, fy_k pairs) or
//   L = 4K lanes [T | dT] (pm_mesh_state's carried mesh), read at row base;
//   with frac each lane is first t + frac * dt, without it T alone.
//
// What bounds it on this card: bytes. At the bench's shape (2^20 bodies,
// CIC, a 2049 x 4097 window each of fx and fy) the two windows (67 MB),
// the base cells and weights (21 MB) and the output (8 MB): 28 us at
// 3.35 TB/s. There are 2 (2K - 1) flops a body.
//
// Where trouble is likely, and what the design does about it:
// - The bits: every product and sum is rounded on its own in the plain
//   version's order (__fmul_rn, __fadd_rn: no FMA contraction), the sums
//   starting from +0.0 as Python's sum does, so kernel and plain agree bit
//   for bit.
// - The gather: bodies arrive in Hilbert order, so a warp's 32 bodies read
//   a few neighbouring cells and the loads coalesce into few sectors; each
//   window value is read once for the bodies of a cell, through L1/L2.
// - Strides: the wrapper passes ld, the windows' row stride, and nw, the
//   table's; the table entry's rows are L lanes, read as float2 pairs
//   (L is even and a row starts on an 8-byte boundary).
//
// Design: a thread a body, K a template parameter so the lanes unroll;
// base may be int32 (mesh._cic_cells) or int64.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int K>
__device__ __forceinline__ void offset(int k, int& oy, int& ox) {
  if (K == 9) {
    oy = k / 3;
    ox = k - 3 * (k / 3);
  } else {
    oy = k >> 1;
    ox = k & 1;
  }
}

// (ax, ay) of K lane pairs r and weights w, in the plain version's order.
template <int K>
__device__ __forceinline__ float2 weigh(const float2* r, const float* w) {
  if (K == 1) return make_float2(__fmul_rn(r[0].x, w[0]),
                                 __fmul_rn(r[0].y, w[0]));
  float ax = __fadd_rn(0.0f, __fmul_rn(w[0], r[0].x));
  float ay = __fadd_rn(0.0f, __fmul_rn(w[0], r[0].y));
#pragma unroll
  for (int k = 1; k < K; ++k) {
    ax = __fadd_rn(ax, __fmul_rn(w[k], r[k].x));
    ay = __fadd_rn(ay, __fmul_rn(w[k], r[k].y));
  }
  return make_float2(ax, ay);
}

template <int K>
__device__ __forceinline__ void load_weights(const float* w, int i,
                                             float* wk) {
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = w[(long long)i * K + k];
}

__device__ __forceinline__ long long base_of(const void* base, int is64,
                                             int i) {
  return is64 ? static_cast<const long long*>(base)[i]
              : static_cast<const int*>(base)[i];
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    windows_kernel(const float* fx, const float* fy, const void* base,
                   int is64, const float* w, int n, int nw, int ld,
                   float2* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = base_of(base, is64, i);
  const long long by = b / nw, bx = b - by * nw;
  const long long c0 = by * ld + bx;
  float wk[K];
  load_weights<K>(w, i, wk);
  float2 r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int oy, ox;
    offset<K>(k, oy, ox);
    const long long c = c0 + (long long)oy * ld + ox;
    r[k] = make_float2(fx[c], fy[c]);
  }
  out[i] = weigh<K>(r, wk);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    table_kernel(const float* T, int L, const void* base, int is64,
                 const float* w, int n, int has_frac, float frac,
                 float2* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2* row =
      reinterpret_cast<const float2*>(T + base_of(base, is64, i) * L);
  float wk[K];
  load_weights<K>(w, i, wk);
  float2 r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = row[k];
  if (has_frac) {   // L = 4K: the rows carry [T | dT]
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 d = row[K + k];
      r[k].x = __fadd_rn(r[k].x, __fmul_rn(frac, d.x));
      r[k].y = __fadd_rn(r[k].y, __fmul_rn(frac, d.y));
    }
  }
  out[i] = weigh<K>(r, wk);
}

int grid_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// From the windows: fx, fy (rows, ld) float32, base (n,) int32 or int64
// (is64), w (n, K), out (n, 2).
extern "C" int tnt_interp_windows(const float* fx, const float* fy,
                                  const void* base, int is64, const float* w,
                                  float* out, int n, int K, int nw, int ld,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || ld < nw) return (int)cudaErrorInvalidValue;
  float2* o = reinterpret_cast<float2*>(out);
  switch (K) {
    case 1:
      windows_kernel<1><<<grid_of(n), THREADS, 0, stream>>>(
          fx, fy, base, is64, w, n, nw, ld, o);
      break;
    case 4:
      windows_kernel<4><<<grid_of(n), THREADS, 0, stream>>>(
          fx, fy, base, is64, w, n, nw, ld, o);
      break;
    case 9:
      windows_kernel<9><<<grid_of(n), THREADS, 0, stream>>>(
          fx, fy, base, is64, w, n, nw, ld, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// From a packed table T (rows, L), L = 2K or 4K; has_frac (L = 4K only)
// extrapolates each lane by frac.
extern "C" int tnt_interp_table(const float* T, int L, const void* base,
                                int is64, const float* w, float* out, int n,
                                int K, int has_frac, float frac,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  if (L != 2 * K && L != 4 * K) return (int)cudaErrorInvalidValue;
  if (has_frac && L != 4 * K) return (int)cudaErrorInvalidValue;
  float2* o = reinterpret_cast<float2*>(out);
  switch (K) {
    case 1:
      table_kernel<1><<<grid_of(n), THREADS, 0, stream>>>(
          T, L, base, is64, w, n, has_frac, frac, o);
      break;
    case 4:
      table_kernel<4><<<grid_of(n), THREADS, 0, stream>>>(
          T, L, base, is64, w, n, has_frac, frac, o);
      break;
    case 9:
      table_kernel<9><<<grid_of(n), THREADS, 0, stream>>>(
          T, L, base, is64, w, n, has_frac, frac, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
