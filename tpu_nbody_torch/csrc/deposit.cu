// P3M mass assignment and deposit, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA code of tpu_nbody/ops/mesh.py:
// _cic_cells (:399), each body's base cell and assignment weights, and
// _deposit_packed (:471), K plane scatter-adds at the base cell and a
// pad-shift combine into the padded FFT grid. Its plain torch forms are
// ops/mesh.py::_cic_cells_ref and _deposit_packed_ref.
//
// What it computes, for order 1 (NGP, K = 1), 2 (CIC, K = 4) and 3 (TSC,
// K = 9), per body at (px, py) with mass m:
//   s = (p - origin) / h per axis; the base cell (bx, by), clipped to
//   [0, nw-1] x [0, ny-1], and K weights, exactly as _cic_cells_ref:
//   NGP  c = floor(s), weight 1;
//   CIC  u = s - 0.5, b = floor(u), f = u - b; weights (1-fx)(1-fy),
//        fx(1-fy), (1-fx)fy, fx fy for the offsets (oy, ox) = (0,0),
//        (0,1), (1,0), (1,1);
//   TSC  c = floor(s), d = (s - c) - 0.5, base c - 1; per axis
//        0.5 (0.5-d)^2, 0.75 - d^2, 0.5 (0.5+d)^2, weight k = 3 oy + ox
//        the product wy[oy] wx[ox];
//   base = by * nw + bx (int32), and rho[(by + oy) * ld + bx + ox] += m w_k
//   into the padded (grid_y, ld = grid) grid, which the wrapper zeroes:
//   plane (oy, ox) of the plain version's pad-shift combine is this index
//   arithmetic.
// Three entries: cells and deposit in one pass (the fresh P3M pass: the
// cells are written out for the interpolation), cells only (the carried
// table's interpolation) and the deposit from given cells (int32 or int64
// base, _deposit_packed).
//
// What bounds it on this card: bytes. At the main path's shape (2^20
// bodies, CIC, the 4096 x 8192 padded grid) the grid written once is
// 134 MB of the 168 MB (bodies 13 MB, cells and weights 21 MB): 0.050 ms
// at 3.35 TB/s; most of the grid is the wrapper's memset of zeros. There
// are 2K flops a body beyond the cells.
//
// Where trouble is likely, and what the design does about it:
// - The cells' bits: every subtraction, product and division is rounded
//   on its own in the plain version's order (__fsub_rn, __fmul_rn,
//   __fdiv_rn: IEEE division, no contraction into FMA), floor and the
//   float -> int conversion as torch does them, so base and weights equal
//   the plain version's bit for bit.
// - Atomics on one cell: bodies arrive in Hilbert order, so a warp's 32
//   bodies mostly share a few cells. The lanes that share a base cell
//   (__match_any_sync) are summed by their lowest lane, in lane order,
//   before one float atomicAdd a cell and offset. The order of the adds
//   still changes from run to run: rho is held to the plain version within
//   a relative tolerance, not bit for bit. Zero products (dead bodies) add
//   nothing.
//
// Design: a thread a body, a CTA of 256; the order (K) and the entry are
// template parameters, so the weights unroll in registers.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum Entry { CELLS_DEPOSIT = 0, CELLS = 1, GIVEN = 2 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

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

// Per-axis TSC weights at offset d from the containing cell's centre.
__device__ __forceinline__ void tsc3(float d, float* w) {
  const float a = __fsub_rn(0.5f, d);
  const float b = __fadd_rn(0.5f, d);
  w[0] = __fmul_rn(0.5f, __fmul_rn(a, a));
  w[1] = __fsub_rn(0.75f, __fmul_rn(d, d));
  w[2] = __fmul_rn(0.5f, __fmul_rn(b, b));
}

// Base cell (by, bx) and the K weights of one body, as _cic_cells_ref.
template <int K>
__device__ __forceinline__ void cells(float px, float py, float ox, float oy,
                                      float h, int nw, int ny, int& by,
                                      int& bx, float* w) {
  const float sx = __fdiv_rn(__fsub_rn(px, ox), h);
  const float sy = __fdiv_rn(__fsub_rn(py, oy), h);
  if (K == 1) {
    bx = clampi((int)floorf(sx), 0, nw - 1);
    by = clampi((int)floorf(sy), 0, ny - 1);
    w[0] = 1.0f;
  } else if (K == 9) {
    const int cx = (int)floorf(sx), cy = (int)floorf(sy);
    const float dx = __fsub_rn(__fsub_rn(sx, (float)cx), 0.5f);
    const float dy = __fsub_rn(__fsub_rn(sy, (float)cy), 0.5f);
    bx = clampi(cx - 1, 0, nw - 1);
    by = clampi(cy - 1, 0, ny - 1);
    float wx[3], wy[3];
    tsc3(dx, wx);
    tsc3(dy, wy);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) w[3 * a + b] = __fmul_rn(wy[a], wx[b]);
  } else {
    const float ux = __fsub_rn(sx, 0.5f), uy = __fsub_rn(sy, 0.5f);
    const int cx = (int)floorf(ux), cy = (int)floorf(uy);
    const float wx1 = __fsub_rn(ux, (float)cx);
    const float wy1 = __fsub_rn(uy, (float)cy);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    bx = clampi(cx, 0, nw - 1);
    by = clampi(cy, 0, ny - 1);
    w[0] = __fmul_rn(wx0, wy0);
    w[1] = __fmul_rn(wx1, wy0);
    w[2] = __fmul_rn(wx0, wy1);
    w[3] = __fmul_rn(wx1, wy1);
  }
}

// Add m w_k into the K cells at (by + oy, bx + ox) of the grid, the lanes
// of the warp that share ``key`` (the base cell; -1 for a lane without a
// body) summed by the lowest of them first; every lane of the warp must
// call it.
template <int K>
__device__ __forceinline__ void scatter(float* rho, int ld, long long by,
                                        long long bx, float m, const float* w,
                                        long long key, float* slot) {
  const long long c0 = by * ld + bx;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu,
                                          (unsigned long long)key);
  const bool leader = key >= 0 && lane == __ffs(peers) - 1;
  float* warp_slot = slot + (threadIdx.x & ~31);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int oy, ox;
    offset<K>(k, oy, ox);
    slot[threadIdx.x] = key >= 0 ? __fmul_rn(m, w[k]) : 0.0f;
    __syncwarp();
    if (leader) {
      float s = 0.0f;
      for (unsigned p = peers; p; p &= p - 1)
        s = __fadd_rn(s, warp_slot[__ffs(p) - 1]);
      if (s != 0.0f) atomicAdd(rho + c0 + (long long)oy * ld + ox, s);
    }
    __syncwarp();
  }
}

template <int K, int ENTRY>
__global__ void __launch_bounds__(THREADS)
    deposit_kernel(const float2* pos, const float* mass, const void* base_in,
                   int is64, const float* w_in, int* base_out, float* w_out,
                   float* rho, int n, float ox, float oy, float h, int nw,
                   int ny, int ld) {
  __shared__ float slot[ENTRY == CELLS ? 1 : THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool body = i < n;
  float w[K];
  long long by = 0, bx = 0, key = -1;
  if (body) {
    if (ENTRY == GIVEN) {
      const long long b = is64 ? static_cast<const long long*>(base_in)[i]
                               : static_cast<const int*>(base_in)[i];
      by = b / nw;
      bx = b - by * nw;
      key = b;
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = w_in[(long long)i * K + k];
    } else {
      const float2 p = pos[i];
      int cy, cx;
      cells<K>(p.x, p.y, ox, oy, h, nw, ny, cy, cx, w);
      by = cy;
      bx = cx;
      key = (long long)cy * nw + cx;
      base_out[i] = (int)key;
#pragma unroll
      for (int k = 0; k < K; ++k) w_out[(long long)i * K + k] = w[k];
    }
  }
  if (ENTRY == CELLS) return;
  const float m = body ? mass[i] : 0.0f;
  scatter<K>(rho, ld, by, bx, m, w, key, slot);
}

template <int K, int ENTRY>
int launch(const float* pos, const float* mass, const void* base_in,
           int is64, const float* w_in, int* base_out, float* w_out,
           float* rho, int n, float ox, float oy, float h, int nw, int ny,
           int ld, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  deposit_kernel<K, ENTRY><<<blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const float2*>(pos), mass, base_in, is64, w_in,
      base_out, w_out, rho, n, ox, oy, h, nw, ny, ld);
  return (int)cudaGetLastError();
}

template <int ENTRY>
int by_taps(int K, const float* pos, const float* mass, const void* base_in,
            int is64, const float* w_in, int* base_out, float* w_out,
            float* rho, int n, float ox, float oy, float h, int nw, int ny,
            int ld, cudaStream_t stream) {
  switch (K) {
    case 1:
      return launch<1, ENTRY>(pos, mass, base_in, is64, w_in, base_out,
                              w_out, rho, n, ox, oy, h, nw, ny, ld, stream);
    case 4:
      return launch<4, ENTRY>(pos, mass, base_in, is64, w_in, base_out,
                              w_out, rho, n, ox, oy, h, nw, ny, ld, stream);
    case 9:
      return launch<9, ENTRY>(pos, mass, base_in, is64, w_in, base_out,
                              w_out, rho, n, ox, oy, h, nw, ny, ld, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int taps_of(int order) {
  return order == 1 ? 1 : (order == 2 ? 4 : (order == 3 ? 9 : 0));
}

}  // namespace

// The cells of n bodies at pos (n, 2) for the assignment ``order`` (1, 2,
// 3) on a (ny, nw) mesh of cell h at (ox, oy): base (n,) int32 and w
// (n, K). With mass (n,) and rho, the zeroed padded grid of row stride
// ld, also the deposit (mass null: cells only).
extern "C" int tnt_deposit_cells(const float* pos, const float* mass,
                                 int* base, float* w, float* rho, int n,
                                 int order, float ox, float oy, float h,
                                 int nw, int ny, int ld,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int K = taps_of(order);
  if (K == 0 || nw <= 0 || ny <= 0) return (int)cudaErrorInvalidValue;
  if (mass == nullptr)
    return by_taps<CELLS>(K, pos, nullptr, nullptr, 0, nullptr, base, w,
                          nullptr, n, ox, oy, h, nw, ny, ld, stream);
  if (rho == nullptr || ld < nw) return (int)cudaErrorInvalidValue;
  return by_taps<CELLS_DEPOSIT>(K, pos, mass, nullptr, 0, nullptr, base, w,
                                rho, n, ox, oy, h, nw, ny, ld, stream);
}

// The deposit from given cells: mass (n,), base (n,) int32 or int64
// (is64), w (n, K) into the zeroed padded grid rho of row stride ld.
extern "C" int tnt_deposit_given(const float* mass, const void* base,
                                 int is64, const float* w, float* rho, int n,
                                 int K, int nw, int ld,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nw <= 0 || ld < nw) return (int)cudaErrorInvalidValue;
  return by_taps<GIVEN>(K, nullptr, mass, base, is64, w, nullptr, nullptr,
                        rho, n, 0.0f, 0.0f, 1.0f, nw, 0, ld, stream);
}
