// Barnes–Hut point-mass pair blocks, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA pair blocks of
// tpu_nbody/ops/traverse.py::_point_accel, called by the hier force
// evaluation (_hier_accel) and by the dense/bfs one (bh_accel_from_tree),
// whose plain torch form is ops/traverse.py::_point_accel.
//
// What it computes: for each of the M x C target sets (m, c), its NT
// targets sum, over the S sources of row m (shared by the C sets of the row,
// as the candidates of a hier chunk are shared by its groups) with the
// masses of set (m, c),
//     a_i += m_j * d * rsqrt(r2)^3,   d = p_j - p_i,   r2 = |d|^2 + eps2,
// the reference point-mass kernel without G. Masked candidates and padded
// partner slots carry mass 0 and add exactly 0.
//
// What bounds it on this card: arithmetic, 13 flops a pair counted from the
// plain formula (ops/forces.py::_PAIR_FLOPS), as the all-pairs kernel. The
// lists are padded to the widest chunk's widths, so most source slots carry
// mass 0 (at N = 2^20 about 251 padded pairs for each needed one); what
// bounds a call is the pairs its nonzero masses need.
//
// Design:
// - One CTA a target set; its threads are `lanes` lanes of tpg threads, each
//   thread T targets of the set (the all-pairs kernel's scheme). The
//   sources pass in tiles of TILE: the CTA stages a tile's positions and
//   its set's masses in shared memory as float4 (x, y, m, 0), and lane L
//   sums the tile's sources L, L + lanes, ...
// - A tile whose masses are all 0 for the set is skipped as a whole
//   (__syncthreads_or over the staging): it changes no result and cuts the
//   padded tails of the lists. Pairs with mass 0 inside a tile are summed.
// - The lanes' sums meet in shared memory and are added in lane order;
//   every output row is written by one CTA.
// - T, tpg and lanes come from ops/traverse.py::_pairs_plan.

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int TILE = 256;            // sources a staged tile
constexpr int MAX_SMEM = 48 * 1024;  // default dynamic shared memory limit

template <int T>
__global__ void bh_pairs_kernel(const float* __restrict__ tgt,
                                const float* __restrict__ src,
                                const float* __restrict__ mass,
                                float* __restrict__ out, int C, int NT,
                                int S, int tpg, float soft2) {
  __shared__ float4 tile[TILE];
  extern __shared__ float2 part[];  // (lanes, tpg T) lane sums
  const long long g = blockIdx.x;   // target set (g / C, g % C)
  const long long row = g / C;
  const int lanes = blockDim.x / tpg;
  const int L = threadIdx.x / tpg;
  const int t = threadIdx.x - L * tpg;
  const float2* tg = reinterpret_cast<const float2*>(tgt) + g * NT;
  float xi[T], yi[T], ax[T], ay[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const float2 p = tg[min(t + q * tpg, NT - 1)];  // past NT: not kept
    xi[q] = p.x;
    yi[q] = p.y;
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  const float2* sp = reinterpret_cast<const float2*>(src) + row * S;
  const float* sm = mass + g * S;
  for (int j0 = 0; j0 < S; j0 += TILE) {
    const int n = min(TILE, S - j0);
    int any = 0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float m = sm[j0 + j];
      const float2 p = sp[j0 + j];
      tile[j] = make_float4(p.x, p.y, m, 0.0f);
      any |= m != 0.0f;
    }
    if (!__syncthreads_or(any)) continue;  // every mass 0: adds nothing
#pragma unroll 4
    for (int j = L; j < n; j += lanes) {
      const float4 p = tile[j];
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const float dx = p.x - xi[q];
        const float dy = p.y - yi[q];
        const float inv = rsqrt_ftz(fmaf(dx, dx, fmaf(dy, dy, soft2)));
        const float f = p.z * (inv * inv * inv);
        ax[q] = fmaf(f, dx, ax[q]);
        ay[q] = fmaf(f, dy, ay[q]);
      }
    }
    __syncthreads();
  }
  float2* o2 = reinterpret_cast<float2*>(out) + g * NT;
  if (lanes == 1) {
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int i = t + q * tpg;
      if (i < NT) o2[i] = make_float2(ax[q], ay[q]);
    }
    return;
  }
  const int w = tpg * T;  // slots a lane's row of part holds
#pragma unroll
  for (int q = 0; q < T; ++q)
    part[L * w + t + q * tpg] = make_float2(ax[q], ay[q]);
  __syncthreads();
  for (int i = threadIdx.x; i < NT; i += blockDim.x) {
    float sx = 0.0f, sy = 0.0f;
    for (int q = 0; q < lanes; ++q) {
      const float2 v = part[q * w + i];
      sx += v.x;
      sy += v.y;
    }
    o2[i] = make_float2(sx, sy);
  }
}

}  // namespace

// tgt (M C NT, 2), src (M S, 2), mass (M C S), out (M C NT, 2) float32,
// tgt, src and out 8-byte aligned; T in {1, 2, 4, 8}; tpg threads hold the
// NT targets of a set, T each; lanes lanes of them a CTA
// (ops/traverse.py::_pairs_plan).
extern "C" int tnt_bh_pairs(const float* tgt, const float* src,
                            const float* mass, float* out, int M, int C,
                            int NT, int S, float soft2, int T, int tpg,
                            int lanes, cudaStream_t stream) {
  if (M <= 0 || C <= 0 || NT <= 0) return 0;
  if ((T != 1 && T != 2 && T != 4 && T != 8) || tpg < 1 || lanes < 1 ||
      (long long)tpg * T < NT || S < 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)tpg * lanes;
  const size_t smem =
      lanes > 1 ? (size_t)threads * T * sizeof(float2) : 0;
  if (threads > 1024 || smem + TILE * sizeof(float4) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)M * C;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (T == 1)
    bh_pairs_kernel<1><<<(int)grid, (int)threads, smem, stream>>>(
        tgt, src, mass, out, C, NT, S, tpg, soft2);
  else if (T == 2)
    bh_pairs_kernel<2><<<(int)grid, (int)threads, smem, stream>>>(
        tgt, src, mass, out, C, NT, S, tpg, soft2);
  else if (T == 4)
    bh_pairs_kernel<4><<<(int)grid, (int)threads, smem, stream>>>(
        tgt, src, mass, out, C, NT, S, tpg, soft2);
  else
    bh_pairs_kernel<8><<<(int)grid, (int)threads, smem, stream>>>(
        tgt, src, mass, out, C, NT, S, tpg, soft2);
  return (int)cudaGetLastError();
}
