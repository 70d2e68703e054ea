// P3M band short-range pair sum, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_nbody/ops/band_pallas.py::_band_kernel
// (called by band_short_range_pallas) and computes what its XLA twin
// tpu_nbody/ops/mesh.py::_band_short_range computes, for any band width S
// up to 1024 and both short/long switches (exp4, poly4).
//
// What it computes: bodies are in Hilbert order, cut into blocks of S
// consecutive slots. Body i of block b sums, over every partner j of blocks
// b-1, b and b+1,
//     a_i += m_j * d * rsqrt(r2 + eps2)^3 * w(r2),   d = p_j - p_i,
// with w the switch of ops/band.py::_short_weight (pair_switch.cuh).
// Partners before the first or after the last body have mass 0 (the zero
// guard blocks of the JAX forms), so there are no wrap-around pairs. The
// self pair gives d = 0, hence 0.
//
// What bounds it on this card: arithmetic. Counted from the plain formula
// (rsqrt and max one operation each), a poly4 pair costs 21 flops: at
// S = 128 and 2^20 bodies that is 4.03e8 pairs, 8.5e9 flops, 0.126 ms at
// the 67 TFLOP/s float32 peak, against 21 MB in and out (0.006 ms at 3.35
// TB/s). In instructions a poly4 pair is 13 float32 issue slots and one
// rsqrt, so the issue rate (4 warp instructions a clock per SM, ~0.17 ms
// here at 1.98 GHz), not the flop rate, is the practical ceiling.
//
// Design:
// - One CTA covers B consecutive S-blocks and stages their (B + 2) S
//   partners once, as packed float4 (x, y, m, 0), so neighbouring S-blocks
//   share the staging instead of each loading its 3S partners. Partners
//   outside [0, cap) are masked to mass 0 instead of padding copies of the
//   arrays. (B + 2) S float4 fit the default 48 KB for every S <= 1024.
// - Each thread holds T targets of one S-block (all of a thread's targets
//   share the same 3S partner window), so every broadcast 16-byte shared
//   load feeds T pair terms. Threads of one S-block walk the same partner
//   sequence: the loads are broadcasts without bank conflicts.
// - B and T come from ops/band.py::_band_plan, which covers every body
//   exactly once for every S in 1..1024 and ragged tails.
// - The switch multiplies by 1/(4a^2) (poly4) or 1/a^2 (exp4) passed from
//   the wrapper, as the TPU kernel does, instead of dividing in the pair
//   loop, and reads r2 + eps2 with eps2 folded into a constant, so r2 is
//   never formed alone; poly4's m rsqrt^3 t^4 is m rsqrt (t^2 rsqrt)^2, one
//   multiply fewer. expf stays IEEE (exp4 is off the default path).
// - The TPU kernel's 1024-body tiles of 8x3 (128 x 128) sub-blocks exist
//   for the TPU's layout rules and are not carried over.

#include <cuda_runtime.h>

#include "pair_switch.cuh"

namespace {

constexpr int MAX_SMEM = 48 * 1024;  // default dynamic shared memory limit

// CTA c covers S-blocks [c B, c B + B); thread s * tps + l of it holds the
// targets l + k tps (k < T, below S) of its S-block s.
template <int SWITCH, int T>
__global__ void band_kernel(const float* __restrict__ pos,
                            const float* __restrict__ mass,
                            float* __restrict__ out, int cap, int S, int B,
                            int tps, float soft2, float c) {
  extern __shared__ float4 win[];  // (B + 2) S partners from S-block c B - 1
  const long long first = ((long long)blockIdx.x * B - 1) * S;
  const int n = (B + 2) * S;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const long long g = first + j;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g >= 0 && g < cap) {
      const float2 p = reinterpret_cast<const float2*>(pos)[g];
      v = make_float4(p.x, p.y, mass[g], 0.0f);
    }
    win[j] = v;
  }
  __syncthreads();

  const int s = threadIdx.x / tps;
  const int lane = threadIdx.x - s * tps;
  const long long blk0 = ((long long)blockIdx.x * B + s) * S;  // 1st body
  if (blk0 >= cap) return;
  const float4* w = win + s * S;  // S-blocks s - 1, s, s + 1 of the CTA
  float xi[T], yi[T], ax[T], ay[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int li = min(lane + k * tps, S - 1);  // past S: computed, not kept
    xi[k] = w[S + li].x;
    yi[k] = w[S + li].y;
    ax[k] = 0.0f;
    ay[k] = 0.0f;
  }
  const float ck = switch_k<SWITCH>(soft2, c);
  const int np = 3 * S;
#pragma unroll 4
  for (int j = 0; j < np; ++j) {
    const float4 p = w[j];
#pragma unroll
    for (int k = 0; k < T; ++k)
      switched_pair<SWITCH>(p, xi[k], yi[k], soft2, c, ck, ax[k], ay[k]);
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int li = lane + k * tps;
    const long long i = blk0 + li;
    if (li < S && i < cap)
      reinterpret_cast<float2*>(out)[i] = make_float2(ax[k], ay[k]);
  }
}

template <int SWITCH>
void launch(int T, int grid, int threads, size_t smem, cudaStream_t stream,
            const float* pos, const float* mass, float* out, int cap, int S,
            int B, int tps, float soft2, float inv_scale) {
  if (T == 1)
    band_kernel<SWITCH, 1><<<grid, threads, smem, stream>>>(
        pos, mass, out, cap, S, B, tps, soft2, inv_scale);
  else if (T == 2)
    band_kernel<SWITCH, 2><<<grid, threads, smem, stream>>>(
        pos, mass, out, cap, S, B, tps, soft2, inv_scale);
  else if (T == 4)
    band_kernel<SWITCH, 4><<<grid, threads, smem, stream>>>(
        pos, mass, out, cap, S, B, tps, soft2, inv_scale);
  else
    band_kernel<SWITCH, 8><<<grid, threads, smem, stream>>>(
        pos, mass, out, cap, S, B, tps, soft2, inv_scale);
}

}  // namespace

// pos (cap, 2) and out (cap, 2) 8-byte aligned; T in {1, 2, 4, 8}, T <= S;
// B S-blocks per CTA (ops/band.py::_band_plan).
extern "C" int tnt_band_short_range(const float* pos, const float* mass,
                                    float* out, int cap, int band,
                                    float soft2, float inv_scale, int sw,
                                    int T, int B, cudaStream_t stream) {
  if (cap <= 0) return 0;
  if (band < 1 || band > 1024 || (sw != SWITCH_EXP4 && sw != SWITCH_POLY4) ||
      (T != 1 && T != 2 && T != 4 && T != 8) || T > band || B < 1)
    return (int)cudaErrorInvalidValue;
  const int tps = (band + T - 1) / T;
  const long long threads = (long long)B * tps;
  const size_t smem = (size_t)(B + 2) * band * sizeof(float4);
  if (threads > 1024 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int nb = (cap + band - 1) / band;
  const int grid = (nb + B - 1) / B;
  (sw == SWITCH_POLY4 ? launch<SWITCH_POLY4> : launch<SWITCH_EXP4>)(
      T, grid, (int)threads, smem, stream, pos, mass, out, cap, band, B, tps,
      soft2, inv_scale);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by any launcher of this library.
extern "C" const char* tnt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
