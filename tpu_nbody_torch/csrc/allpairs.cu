// Exact softened all-pairs acceleration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_nbody/ops/forces.py::_allpairs_kernel
// (called by _allpairs_pallas through accel_allpairs(implementation=
// "pallas")). For each target i, over every source j,
//     r2 = eps2 + |p_j - t_i|^2,   acc_i += m_j * (p_j - t_i) * r2^(-3/2),
// in dim 2 or 3, without G (the wrapper applies it). Targets may be a
// separate array from the sources; with targets == sources this is the TPU
// kernel. A self pair gives d = 0 and a mass-0 (dead or padding) source
// gives w = 0, so both contribute exactly 0 when eps2 > 0: there is no
// index skip.
//
// What bounds it on this card: arithmetic. Counted from the plain formula
// (rsqrt and divide one operation each), a pair costs 13 flops in 2D and 18
// in 3D against 12-16 bytes per source that every target reuses: 4096 x
// 2^20 sources in 2D is 5.6e10 flops over 12.6 MB, 0.83 ms at the 67
// TFLOP/s float32 peak and 0.004 ms at 3.35 TB/s. The rsqrt unit (16
// results per clock per SM) puts a second floor of ~1.0 ms under it.
//
// Design:
// - The sources are split across blockIdx.y (ops/forces.py::_split_plan),
//   so a few thousand targets still give several blocks per SM. Splits
//   differ by at most one tile, so a grid of k blocks per SM gives every SM
//   the same work (equal splits rounded up to whole tiles left a few SMs a
//   fifth block on an H100, ~20% slower). Each block writes its float64
//   partial sums to scratch[split][target]; a second pass adds the splits
//   in a fixed order. No atomics: the same inputs give the same bits on
//   every call, which the force-error oracle relies on.
// - Each thread holds T = 8 targets (faster on an H100 than 2 or 4 at
//   4096 x 2^20 in 2D), and the grid is one full wave: as many blocks an
//   SM as the occupancy API says one SM holds at once (registers set it).
//   Sources are staged as packed float4
//   (x, y, m, -) in 2D or (x, y, z, m) in 3D, so one 16-byte broadcast
//   shared load feeds T pair terms.
// - Tiles of 256 sources are double-buffered with cp.async: the next tile
//   lands while this one is summed.
// - The weight is m * rinv^3 with rinv from the rsqrt unit (no divide).
//   Each tile is summed in float32 registers and the tile sum added to a
//   float64 sum: a float32 sum over all 2^20 sources differs between
//   summation orders by ~5e-5 of max |a| (measured on an H100), over the
//   1e-5 kernel-vs-plain tolerance; over 256 sources it does not.
// - wgmma does not apply: every pair needs its own rsqrt, and forming r2 as
//   a matrix product (|p|^2 + |t|^2 - 2 p.t) loses the precision of close
//   pairs, whose forces are the largest.

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int THREADS = 128;  // threads per block (forces.THREADS)
constexpr int TILE = 256;     // sources per staged tile (forces.TILE)
constexpr int T = 8;          // targets per thread (forces.T)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage sources [j0, j0 + TILE) into buf as packed float4; sources at or
// past ns become zeros (mass 0).
template <int DIM>
__device__ __forceinline__ void stage_tile(float4* buf,
                                           const float* __restrict__ src,
                                           const float* __restrict__ mass,
                                           int j0, int ns) {
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const int g = j0 + j;
    float* d = reinterpret_cast<float*>(buf + j);
    if (g < ns) {
      if (DIM == 2) {
        cp_async<8>(d, src + 2LL * g);
        cp_async<4>(d + 2, mass + g);
      } else {
        cp_async<4>(d, src + 3LL * g);
        cp_async<4>(d + 1, src + 3LL * g + 1);
        cp_async<4>(d + 2, src + 3LL * g + 2);
        cp_async<4>(d + 3, mass + g);
      }
    } else {
      buf[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Block (x, y) sums the source tiles [y tiles / splits, (y + 1) tiles /
// splits) on targets x * THREADS * T + threadIdx.x + k * THREADS, k < T.
template <int DIM>
__global__ void __launch_bounds__(THREADS) allpairs_partial(
    const float* __restrict__ tgt, const float* __restrict__ src,
    const float* __restrict__ mass, double* __restrict__ part, int nt,
    int ns, float soft2) {
  __shared__ float4 buf[2][TILE];
  const long long tiles = (ns + TILE - 1) / TILE;
  const int t0 = (int)(blockIdx.y * tiles / gridDim.y);
  const int ntiles = (int)((blockIdx.y + 1) * tiles / gridDim.y) - t0;
  const int begin = t0 * TILE;
  const int base = blockIdx.x * (THREADS * T) + threadIdx.x;

  float t[T][DIM];
  double acc[T][DIM];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int i = base + k * THREADS;
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      t[k][c] = i < nt ? tgt[(long long)i * DIM + c] : 0.0f;
      acc[k][c] = 0.0;
    }
  }

  if (ntiles > 0) stage_tile<DIM>(buf[0], src, mass, begin, ns);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles)
      stage_tile<DIM>(buf[(tile + 1) & 1], src, mass,
                      begin + (tile + 1) * TILE, ns);
    cp_async_commit();  // possibly empty, so wait_group 1 always fits
    cp_async_wait_one();
    __syncthreads();
    const float4* b = buf[tile & 1];
    float a[T][DIM];
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int c = 0; c < DIM; ++c) a[k][c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float4 s = b[j];
      const float sp[3] = {s.x, s.y, s.z};
      const float m = DIM == 2 ? s.z : s.w;
#pragma unroll
      for (int k = 0; k < T; ++k) {
        float d[DIM];
        float r2 = soft2;
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          d[c] = sp[c] - t[k][c];
          r2 = fmaf(d[c], d[c], r2);
        }
        const float rinv = rsqrt_ftz(r2);
        const float w = (m * rinv) * (rinv * rinv);
#pragma unroll
        for (int c = 0; c < DIM; ++c) a[k][c] = fmaf(w, d[c], a[k][c]);
      }
    }
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int c = 0; c < DIM; ++c) acc[k][c] += (double)a[k][c];
    __syncthreads();  // everyone is done with buf[tile & 1] before refill
  }

#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int i = base + k * THREADS;
    if (i < nt) {
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        part[((long long)blockIdx.y * nt + i) * DIM + c] = acc[k][c];
    }
  }
}

// out[e] = float(sum over p of part[p][e]), p in order: deterministic.
__global__ void sum_splits(const double* __restrict__ part,
                           float* __restrict__ out, int n, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int p = 0; p < splits; ++p) s += part[(long long)p * n + e];
  out[e] = (float)s;
}

using PartialFn = void (*)(const float*, const float*, const float*,
                           double*, int, int, float);

// The kernel for dim 2 or 3, else null.
PartialFn partial_for(int dim) {
  return dim == 2 ? allpairs_partial<2> : dim == 3 ? allpairs_partial<3>
                                                   : nullptr;
}

}  // namespace

// out is (nt, dim): the sum over all ns sources for each target. scratch
// is float64 (splits, nt, dim); split p sums the source tiles [p tiles /
// splits, (p + 1) tiles / splits).
extern "C" int tnt_allpairs(const float* targets, const float* sources,
                            const float* masses, double* scratch, float* out,
                            int nt, int ns, int dim, float soft2, int splits,
                            cudaStream_t stream) {
  if (nt <= 0) return 0;
  const PartialFn partial = partial_for(dim);
  if (partial == nullptr || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nt + THREADS * T - 1) / (THREADS * T), splits);
  partial<<<grid, THREADS, 0, stream>>>(targets, sources, masses, scratch, nt,
                                         ns, soft2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nt * dim;
  sum_splits<<<(n + 255) / 256, 256, 0, stream>>>(scratch, out, n, splits);
  return (int)cudaGetLastError();
}

// How many blocks of the dim's kernel one SM holds at once (its registers
// set it), so a grid of that many blocks per SM is one full wave; 0 for an
// unknown dim or on error.
extern "C" int tnt_allpairs_blocks_per_sm(int dim) {
  const PartialFn partial = partial_for(dim);
  int n = 0;
  if (partial == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, partial, THREADS, 0) !=
          cudaSuccess)
    return 0;
  return n;
}
