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
//   into a block of the padded grid, its leading ``rows`` rows at row
//   stride ld (the whole (grid_y, grid) grid for _deposit_packed; the
//   ny + 2 + reach rows the FFT reads for the fresh pass): plane (oy, ox)
//   of the plain version's pad-shift combine is this index arithmetic.
// Three entries: cells and deposit in one pass (the fresh P3M pass: the
// cells are written out for the interpolation), cells only (the carried
// table's interpolation) and the deposit from given cells (int32 or int64
// base, _deposit_packed).
//
// What bounds it on this card: bytes. At the main path's shape (2^20
// bodies, CIC, the 2050 x 8192 block of the 4096 x 8192 grid) the block
// written once is 67 MB of the 101 MB (bodies 13 MB, cells and weights
// 21 MB): 0.030 ms at 3.35 TB/s. There are 2K flops a body beyond the
// cells.
//
// Design (the deposit entries): the block only, zeroed by a
// stream-ordered cudaMemsetAsync (0.025 ms for the 67 MB block on an
// NVIDIA H100 80GB HBM3 at 700 W), then one kernel: BPT = 2 bodies a
// thread and 512 a CTA (a thread loads both bodies before it computes
// either), so the CTAs in flight hold consecutive bodies: they arrive
// Hilbert-sorted, and the atomics of the CTAs in flight meet a compact
// band of the grid in L2. The cells stay in registers (the fused entry
// writes them out), or are the given ones. The lanes of a warp that share
// a base cell (__match_any_sync) are summed by their lowest lane, in lane
// order, before one float atomicAdd a cell and tap. Zeroing the block
// inside the kernel (one device operation), a CTA pre-sum in a
// shared-memory window of its cells and float2/float4 vector atomics
// read slower or no faster on that card (PERF.md).
//
// Where trouble is likely, and what the design does about it:
// - The cells' bits: every subtraction, product and division is rounded
//   on its own in the plain version's order (__fsub_rn, __fmul_rn,
//   __fdiv_rn: IEEE division, no contraction into FMA), floor and the
//   float -> int conversion as torch does them, so base and weights equal
//   the plain version's bit for bit.
// - Atomics reorder the sums from run to run: rho is held to the plain
//   version within a relative tolerance, not bit for bit. Zero products
//   (dead bodies) add nothing.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BPT = 2;  // bodies a thread of the deposit kernel

enum Entry { CELLS_DEPOSIT = 0, CELLS = 1, GIVEN = 2 };

struct Args {
  const float2* pos;
  const float* mass;
  const void* base_in;  // GIVEN: int32 or int64 (is64)
  const float* w_in;    // GIVEN
  int* base_out;        // CELLS_DEPOSIT, CELLS
  float* w_out;
  float* rho;           // the block, rows x ld
  int is64;
  int n;
  float ox, oy, h;
  int nw, ny, ld;
};

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

// The given cells of body i: (by, bx) and the K weights.
template <int K>
__device__ __forceinline__ void given(const Args& a, int i, long long& by,
                                      long long& bx, float* w) {
  const long long b = a.is64 ? static_cast<const long long*>(a.base_in)[i]
                             : static_cast<const int*>(a.base_in)[i];
  by = b / a.nw;
  bx = b - by * a.nw;
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = a.w_in[(long long)i * K + k];
}

// Add the K sums s of one base cell at c0 into the block.
template <int K>
__device__ __forceinline__ void add_taps(float* rho, int ld, long long c0,
                                         const float* s) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int oy, ox;
    offset<K>(k, oy, ox);
    if (s[k] != 0.0f) atomicAdd(rho + c0 + (long long)oy * ld + ox, s[k]);
  }
}

// The warp pre-sum: the lanes of the warp that share ``key`` (the base
// cell; -1 for a lane without a body) summed by the lowest of them, in
// lane order, into its s[K]; returns whether this lane leads. Every lane
// of the warp must call it.
template <int K>
__device__ __forceinline__ bool warp_presum(float m, const float* w,
                                            long long key, float* slot,
                                            float* s) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu,
                                          (unsigned long long)key);
  const bool leader = key >= 0 && lane == __ffs(peers) - 1;
  float* warp_slot = slot + (threadIdx.x & ~31);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    slot[threadIdx.x] = key >= 0 ? __fmul_rn(m, w[k]) : 0.0f;
    __syncwarp();
    s[k] = 0.0f;
    if (leader)
      for (unsigned p = peers; p; p &= p - 1)
        s[k] = __fadd_rn(s[k], warp_slot[__ffs(p) - 1]);
    __syncwarp();
  }
  return leader;
}

// The deposit entries (the file's design notes): K taps, ENTRY
// CELLS_DEPOSIT or GIVEN, into the zeroed block.
template <int K, int ENTRY>
__global__ void __launch_bounds__(THREADS) deposit_kernel(Args a) {
  __shared__ float slot[THREADS];
  const int t = threadIdx.x;
  // this thread's BPT bodies, i = CTA start + r THREADS + t: the loads
  // first, then the cells (kept in registers)
  float w[BPT][K], m[BPT];
  long long by[BPT], bx[BPT], key[BPT];
  float2 p[BPT];
#pragma unroll
  for (int r = 0; r < BPT; ++r) {
    const long long i = ((long long)blockIdx.x * BPT + r) * THREADS + t;
    m[r] = 0.0f;
    by[r] = bx[r] = 0;
    key[r] = -1;
    if (i < a.n) {
      m[r] = a.mass[i];
      if constexpr (ENTRY == GIVEN)
        given<K>(a, (int)i, by[r], bx[r], w[r]);
      else
        p[r] = a.pos[i];
    }
  }
#pragma unroll
  for (int r = 0; r < BPT; ++r) {
    const long long i = ((long long)blockIdx.x * BPT + r) * THREADS + t;
    if (i >= a.n) continue;
    if constexpr (ENTRY != GIVEN) {
      int cy, cx;
      cells<K>(p[r].x, p[r].y, a.ox, a.oy, a.h, a.nw, a.ny, cy, cx, w[r]);
      a.base_out[i] = cy * a.nw + cx;
#pragma unroll
      for (int k = 0; k < K; ++k) a.w_out[i * K + k] = w[r][k];
      by[r] = cy;
      bx[r] = cx;
    }
    key[r] = by[r] * a.nw + bx[r];
  }
  // the products, through the warp pre-sum, into the block
#pragma unroll
  for (int r = 0; r < BPT; ++r) {
    float s[K];
    if (warp_presum<K>(m[r], w[r], key[r], slot, s))
      add_taps<K>(a.rho, a.ld, by[r] * a.ld + bx[r], s);
  }
}

// The cells-only entry: a thread a body.
template <int K>
__global__ void __launch_bounds__(THREADS) cells_kernel(Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  float w[K];
  int cy, cx;
  const float2 p = a.pos[i];
  cells<K>(p.x, p.y, a.ox, a.oy, a.h, a.nw, a.ny, cy, cx, w);
  a.base_out[i] = cy * a.nw + cx;
#pragma unroll
  for (int k = 0; k < K; ++k) a.w_out[(long long)i * K + k] = w[k];
}

// The deposit kernel of K taps and entry (nullptr if none).
const void* kernel_of(int K, int entry) {
  const bool fused = entry == CELLS_DEPOSIT;
  switch (K) {
    case 1:
      return fused ? (const void*)deposit_kernel<1, CELLS_DEPOSIT>
                   : (const void*)deposit_kernel<1, GIVEN>;
    case 4:
      return fused ? (const void*)deposit_kernel<4, CELLS_DEPOSIT>
                   : (const void*)deposit_kernel<4, GIVEN>;
    case 9:
      return fused ? (const void*)deposit_kernel<9, CELLS_DEPOSIT>
                   : (const void*)deposit_kernel<9, GIVEN>;
    default:
      return nullptr;
  }
}

int taps_of(int order) {
  return order == 1 ? 1 : (order == 2 ? 4 : (order == 3 ? 9 : 0));
}

// One deposit into the (rows, ld) block: a memset of the block, then the
// kernel.
int deposit(int K, int entry, int rows, Args& a, cudaStream_t stream) {
  const void* fn = kernel_of(K, entry);
  if (fn == nullptr || a.rho == nullptr || a.ld < a.nw || rows < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(a.rho, 0, sizeof(float) * (size_t)rows * a.ld, stream);
  const int blocks = (a.n + BPT * THREADS - 1) / (BPT * THREADS);
  if (e != cudaSuccess || blocks == 0) return (int)e;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(fn, blocks, THREADS, args, 0, stream);
}

}  // namespace

// The cells of n bodies at pos (n, 2) for the assignment ``order`` (1, 2,
// 3) on a (ny, nw) mesh of cell h at (ox, oy): base (n,) int32 and w
// (n, K). With mass (n,) and rho, a (rows, ld) block, also the deposit,
// which zeroes the block first (rho null: cells only).
extern "C" int tnt_deposit_cells(const float* pos, const float* mass,
                                 int* base, float* w, float* rho, int n,
                                 int order, float ox, float oy, float h,
                                 int nw, int ny, int ld, int rows,
                                 cudaStream_t stream) {
  const int K = taps_of(order);
  if (K == 0 || nw <= 0 || ny <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const float2*>(pos), mass, nullptr, nullptr,
         base, w, rho, 0, n, ox, oy, h, nw, ny, ld};
  if (rho == nullptr) {
    if (n == 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    if (K == 1)
      cells_kernel<1><<<blocks, THREADS, 0, stream>>>(a);
    else if (K == 4)
      cells_kernel<4><<<blocks, THREADS, 0, stream>>>(a);
    else
      cells_kernel<9><<<blocks, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return deposit(K, CELLS_DEPOSIT, rows, a, stream);
}

// The deposit from given cells: mass (n,), base (n,) int32 or int64
// (is64), w (n, K) into the (rows, ld) block rho, which it zeroes first.
extern "C" int tnt_deposit_given(const float* mass, const void* base,
                                 int is64, const float* w, float* rho, int n,
                                 int K, int nw, int ld, int rows,
                                 cudaStream_t stream) {
  if (nw <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  Args a{nullptr, mass, base, w, nullptr, nullptr, rho, is64, n,
         0.0f, 0.0f, 1.0f, nw, 0, ld};
  return deposit(K, GIVEN, rows, a, stream);
}
