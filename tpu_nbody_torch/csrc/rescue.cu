// P3M block-rescue pair sum, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA pair sums of
// tpu_nbody/ops/mesh.py::_block_rescue (both tiers) and
// tpu_nbody/parallel/sharded_pm.py::_cross_shard_rescue, whose plain torch
// form is ops/band.py::_pair_sum on gathered block rows.
//
// What it computes: output block o holds the S target bodies of block
// tid[o] of the target rows; each target i sums, over the k partner blocks
// pidx[o, :] of the partner rows whose flag pvalid[o, :] is set, and over
// every body j of such a block,
//     a_i += m_j * d * rsqrt(r2 + eps2)^3 * w(r2),   d = p_j - p_i,
// with w the switch of pair_switch.cuh, the band kernel's pair formula.
// Rows are (x, y, m) triplets, S of them a block; padded bodies carry mass
// 0. Output (m, S, 2) in the target rows' order.
//
// What bounds it on this card: arithmetic, as the band kernel. At 2^20
// bodies, S = 128 and k = 8 partner blocks (the bench configuration) it is
// at most 1.07e9 pairs, 2.3e10 flops (poly4), 0.34 ms at the 67 TFLOP/s
// float32 peak; its inputs are the 12 MB of rows and the index lists.
//
// Design:
// - One CTA an output block. Its PL lanes of tps threads each take one
//   partner block at a time: a round stages PL partner blocks in shared
//   memory as packed float4 (x, y, m, 0), read through pidx (no gathered
//   copy of the rows in device memory), and lane L sums block L of the
//   round. A partner block whose flag is false is neither staged nor
//   summed: a branch uniform over the lane (a lane is whole warps when tps
//   is a multiple of 32, as at S = 128).
// - Each thread holds T targets, so a broadcast 16-byte shared load feeds T
//   pair terms (band.cu's scheme).
// - The lanes' partial sums meet in shared memory (the staging buffer,
//   reused) and are added in lane order: every output block is written by
//   one CTA, so a hot-tier list that names one target block many times
//   (mesh.py's clamped hid) gives separate output rows and no races.
// - PL, T and tps come from ops/band.py::_rescue_plan.

#include <cuda_runtime.h>

#include "pair_switch.cuh"

namespace {

constexpr int MAX_SMEM = 48 * 1024;  // default dynamic shared memory limit

template <int SWITCH, int T>
__global__ void rescue_kernel(const float* __restrict__ trows,
                              const long long* __restrict__ tid,
                              const float* __restrict__ prows,
                              const long long* __restrict__ pidx,
                              const unsigned char* __restrict__ pvalid,
                              float* __restrict__ out, int k, int S, int tps,
                              int PL, float soft2, float c) {
  extern __shared__ float4 win[];  // PL partner blocks of S bodies
  const long long o = blockIdx.x;
  const int L = threadIdx.x / tps;
  const int l = threadIdx.x - L * tps;
  const float* trow = trows + tid[o] * (long long)S * 3;
  float xi[T], yi[T], ax[T], ay[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const int li = min(l + q * tps, S - 1);  // past S: computed, not kept
    xi[q] = trow[3 * li];
    yi[q] = trow[3 * li + 1];
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  const float ck = switch_k<SWITCH>(soft2, c);
  const long long* pi = pidx + o * k;
  const unsigned char* pv = pvalid + o * k;
  for (int r0 = 0; r0 < k; r0 += PL) {
    const int nb = min(PL, k - r0);
    for (int j = threadIdx.x; j < nb * S; j += blockDim.x) {
      const int b = j / S;
      if (pv[r0 + b]) {
        const float* p = prows + (pi[r0 + b] * S + (j - b * S)) * 3;
        win[j] = make_float4(p[0], p[1], p[2], 0.0f);
      }
    }
    __syncthreads();
    if (L < nb && pv[r0 + L]) {
      const float4* w = win + L * S;
#pragma unroll 4
      for (int j = 0; j < S; ++j) {
        const float4 p = w[j];
#pragma unroll
        for (int q = 0; q < T; ++q)
          switched_pair<SWITCH>(p, xi[q], yi[q], soft2, c, ck, ax[q],
                                ay[q]);
      }
    }
    __syncthreads();
  }
  // lane sums, in the staging buffer: (PL, S) float2 fit in PL S float4
  float2* part = reinterpret_cast<float2*>(win);
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const int li = l + q * tps;
    if (li < S) part[L * S + li] = make_float2(ax[q], ay[q]);
  }
  __syncthreads();
  float2* o2 = reinterpret_cast<float2*>(out) + o * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float sx = 0.0f, sy = 0.0f;
    for (int q = 0; q < PL; ++q) {
      const float2 v = part[q * S + i];
      sx += v.x;
      sy += v.y;
    }
    o2[i] = make_float2(sx, sy);
  }
}

template <int SWITCH>
void launch(int T, int grid, int threads, size_t smem, cudaStream_t stream,
            const float* trows, const long long* tid, const float* prows,
            const long long* pidx, const unsigned char* pvalid, float* out,
            int k, int S, int tps, int PL, float soft2, float c) {
  if (T == 1)
    rescue_kernel<SWITCH, 1><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, k, S, tps, PL, soft2, c);
  else if (T == 2)
    rescue_kernel<SWITCH, 2><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, k, S, tps, PL, soft2, c);
  else if (T == 4)
    rescue_kernel<SWITCH, 4><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, k, S, tps, PL, soft2, c);
  else
    rescue_kernel<SWITCH, 8><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, k, S, tps, PL, soft2, c);
}

}  // namespace

// trows (Bt, 3 S), prows (Bp, 3 S) float32; tid (m,) and pidx (m, k) int64
// row indices into them; pvalid (m, k) bool; out (m, S, 2), 8-byte
// aligned. T in {1, 2, 4, 8}, T <= S; PL partner lanes a CTA, PL <= k
// (ops/band.py::_rescue_plan).
extern "C" int tnt_rescue_pairs(const float* trows, const long long* tid,
                                const float* prows, const long long* pidx,
                                const unsigned char* pvalid, float* out,
                                int m, int k, int band, float soft2,
                                float inv_scale, int sw, int T, int PL,
                                cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  if (band < 1 || band > 1024 || (sw != SWITCH_EXP4 && sw != SWITCH_POLY4) ||
      (T != 1 && T != 2 && T != 4 && T != 8) || T > band || PL < 1 ||
      PL > k)
    return (int)cudaErrorInvalidValue;
  const int tps = (band + T - 1) / T;
  const long long threads = (long long)PL * tps;
  const size_t smem = (size_t)PL * band * sizeof(float4);
  if (threads > 1024 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  (sw == SWITCH_POLY4 ? launch<SWITCH_POLY4> : launch<SWITCH_EXP4>)(
      T, m, (int)threads, smem, stream, trows, tid, prows, pidx, pvalid, out,
      k, band, tps, PL, soft2, inv_scale);
  return (int)cudaGetLastError();
}
