// P3M block-rescue pair sum, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA pair sums of
// tpu_nbody/ops/mesh.py::_block_rescue (both tiers, :331-347) and
// tpu_nbody/parallel/sharded_pm.py::_cross_shard_rescue (:197), whose
// plain torch form is ops/band.py::rescue_pair_sum_ref on gathered block
// rows.
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
// What bounds it on this card: arithmetic, and under poly4 only the pairs
// within the cutoff 2a count: its weight (1 - r2/(2a)^2)^4 is exactly 0
// past it. At 2^20 bodies, S = 128, k = 8 (the bench configuration) the
// two-disk scene has 2.7e8 such pairs of the 9.8e8 its valid partner
// blocks hold: 5.8e9 flops at 21 a pair, 0.086 ms at the 67 TFLOP/s
// float32 peak (ops/band.py::rescue_pair_work from rescue_cutoff_pairs).
// The inputs are 12 MB of rows and the index lists.
//
// Design:
// - A warp owns a run of 32 consecutive target rows and tests its box
//   against the box of each partner sub-tile of 32 consecutive bodies;
//   under poly4 a sub-tile pair whose box gap is past the cutoff is
//   skipped whole, a branch uniform over the warp. Hilbert order keeps
//   both runs compact: at the bench shape 58% of the 32 x 32 sub-tile
//   pairs of the valid blocks are near. The old design (T = 4 targets a
//   thread strided over all S rows, a warp a partner block) could skip
//   nothing.
// - Within the warp, T = 4 phases of 8 lanes: a lane holds T rows of the
//   run (lr, lr + 8, ...) and walks every T-th partner of a sub-tile, so
//   each broadcast 16-byte shared load feeds T pair terms, as in the old
//   design, while the skip keeps the 32-row grain (a lane of one row, T =
//   1, reads 16 bytes a pair, and the shared loads then bound it). The
//   phases' sums of a row meet by shuffles in an order every lane shares.
// - The skip is exact. A pair is skipped only when g2 >= cut, with g2 the
//   squared box gap rounded as ops/mesh.py::_box_gaps rounds it
//   (box_gap.cuh) and cut = rcut2 (1 + 2^-10) from the wrapper (NaN: no
//   skip). Rounding is monotone, so g2 never exceeds a member pair's r2,
//   and the margin keeps t = 1 + eps2 c - r2s c below 0 through the
//   kernel's roundings: every skipped term is t = 0 here and in the plain
//   version, and +0 added to a sum that starts at +0 changes no bit. The
//   kernel with the skip equals the kernel without it bit for bit.
// - Boxes are built here, from the rows the kernel stages: a target run's
//   over every slot of the run, a partner sub-tile's over every slot of
//   the tile (dead and padded slots only widen a box), so the three call
//   forms need no new input. A box with a coordinate that is not finite
//   or above 2^126 in magnitude (where d could overflow), or a partner
//   mass that is not finite, is NaN and never skips: such a pair's term
//   is NaN in both versions.
// - The tests cost little beside the walk: a lane tests one sub-tile, a
//   ballot gathers the warp's near ones and the warp walks the set bits
//   (a test a sub-tile inside the walk loop, with its block's flag and
//   index, was slower on the card).
// - exp4 (weight never 0) tests nothing and walks every sub-tile.
// - The CTA stages R partner blocks at a time in shared memory as packed
//   float4 (x, y, m, 0), each block padded to whole sub-tiles, read
//   through pidx (no gathered copy of the rows in device memory), a warp
//   a sub-tile at a time, a body a lane, so the warp takes the sub-tile's
//   box as it stages it; a block whose flag is false is neither staged
//   nor walked.
// - No atomics in the sums, so a call is bitwise repeatable; every output
//   block is written by one CTA, so a hot-tier list that names one target
//   block many times (mesh.py's clamped hid) gives separate output rows
//   and no races. The optional walked counter (one integer atomic a warp)
//   counts the (target run, partner sub-tile) pairs evaluated, what
//   ops/band.py::rescue_near_tiles counts.
// - T and R come from ops/band.py::_rescue_plan. At T = 4 ptxas gives the
//   poly4 kernel 60 registers (no spill), so 8 CTAs of 4 warps an SM.
//   chip_smoke.py times T = 1, 2 and 4 (PERF.md); more warps a CTA sharing
//   the sub-tiles of a run were slower on the card.

#include <cfloat>
#include <cuda_runtime.h>

#include "box_gap.cuh"
#include "pair_switch.cuh"

namespace {

constexpr int MAX_SMEM = 48 * 1024;  // default dynamic shared memory limit
constexpr int TILE = 32;             // partner bodies a sub-tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 0x1p126f;  // |d| stays below FLT_MAX

// a box over the lanes' points (unused lanes pass +inf/-inf), NaN when a
// lane flags its point
__device__ __forceinline__ float4 warp_box(float lox, float hix, float loy,
                                           float hiy, bool bad) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lox = fminf(lox, __shfl_xor_sync(FULL, lox, o));
    hix = fmaxf(hix, __shfl_xor_sync(FULL, hix, o));
    loy = fminf(loy, __shfl_xor_sync(FULL, loy, o));
    hiy = fmaxf(hiy, __shfl_xor_sync(FULL, hiy, o));
  }
  if (__any_sync(FULL, bad)) {
    const float nan = __int_as_float(0x7fc00000);
    return make_float4(nan, nan, nan, nan);
  }
  return make_float4(lox, hix, loy, hiy);
}

__device__ __forceinline__ bool out_of_range(float x, float y) {
  return !(fabsf(x) <= BIG && fabsf(y) <= BIG);
}

// a += the pair terms of one staged sub-tile of n partners: this lane's
// phase h takes partners h, h + T, h + 2T, ... against its T targets
template <int SWITCH, int T>
__device__ __forceinline__ void walk_tile(const float4* wp, int n, int h,
                                          const float* xi, const float* yi,
                                          float soft2, float c, float ck,
                                          float* ax, float* ay) {
  if (n == TILE) {
#pragma unroll 4
    for (int i = 0; i < TILE / T; ++i) {
      const float4 p = wp[i * T + h];
#pragma unroll
      for (int q = 0; q < T; ++q)
        switched_pair<SWITCH>(p, xi[q], yi[q], soft2, c, ck, ax[q], ay[q]);
    }
  } else {
    for (int j = h; j < n; j += T) {
      const float4 p = wp[j];
#pragma unroll
      for (int q = 0; q < T; ++q)
        switched_pair<SWITCH>(p, xi[q], yi[q], soft2, c, ck, ax[q], ay[q]);
    }
  }
}

template <int SWITCH, int T>
__global__ void __launch_bounds__(1024)
    rescue_kernel(const float* __restrict__ trows,
                  const long long* __restrict__ tid,
                  const float* __restrict__ prows,
                  const long long* __restrict__ pidx,
                  const unsigned char* __restrict__ pvalid,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ walked, int k, int S,
                  int R, float soft2, float c, float cut) {
  constexpr int LPR = TILE / T;  // lanes of one phase: rows lr + LPR q
  extern __shared__ float4 smem[];
  const int NTb = (S + TILE - 1) / TILE;  // sub-tiles a partner block
  const int SP = NTb * TILE;              // a staged block, padded
  float4* win = smem;                     // R SP staged partners
  float4* tbox = smem + R * SP;           // R NTb sub-tile boxes
  const int lane = threadIdx.x & 31;
  const int h = lane / LPR;
  const int lr = lane - h * LPR;
  const int g = threadIdx.x >> 5;         // this warp's run of rows
  const int nw = blockDim.x >> 5;
  const long long o = blockIdx.x;
  const float* trow = trows + tid[o] * (long long)S * 3;
  const int row0 = g * TILE;
  const bool cull = SWITCH == SWITCH_POLY4 && cut == cut;
  const bool ragged = S != SP;

  float xi[T], yi[T], ax[T], ay[T];
  const float inf = __int_as_float(0x7f800000);
  float lox = inf, hix = -inf, loy = inf, hiy = -inf;
  bool bad = false;
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const int r = row0 + lr + q * LPR;
    const int rr = min(r, S - 1);  // past S: computed, not kept
    xi[q] = trow[3 * rr];
    yi[q] = trow[3 * rr + 1];
    ax[q] = 0.0f;
    ay[q] = 0.0f;
    if (r < S) {
      lox = fminf(lox, xi[q]);
      hix = fmaxf(hix, xi[q]);
      loy = fminf(loy, yi[q]);
      hiy = fmaxf(hiy, yi[q]);
      bad |= out_of_range(xi[q], yi[q]);
    }
  }
  float4 mybox = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (cull) mybox = warp_box(lox, hix, loy, hiy, bad);

  const float ck = switch_k<SWITCH>(soft2, c);
  const long long* pi = pidx + o * k;
  const unsigned char* pv = pvalid + o * k;
  unsigned count = 0;
  for (int r0 = 0; r0 < k; r0 += R) {
    const int nb = min(R, k - r0);
    // a warp stages a sub-tile at a time, a body a lane, and takes its box
    const int nt = nb * NTb;
#pragma unroll 2
    for (int t = g; t < nt; t += nw) {
      const int b = t / NTb;
      if (!pv[r0 + b]) continue;
      const int i = (t - b * NTb) * TILE + lane;
      const bool in = i < S;
      float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const float* src = prows + (pi[r0 + b] * S + i) * 3;
        p = make_float4(src[0], src[1], src[2], 0.0f);
        win[t * TILE + lane] = p;
      }
      if (cull) {
        const bool pbad =
            in && (out_of_range(p.x, p.y) || !(fabsf(p.z) <= FLT_MAX));
        const float4 box = warp_box(in ? p.x : inf, in ? p.x : -inf,
                                    in ? p.y : inf, in ? p.y : -inf, pbad);
        if (lane == 0) tbox[t] = box;
      }
    }
    __syncthreads();
    // a lane tests one sub-tile, a ballot gathers the near ones, the warp
    // walks them in order
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      bool near = false;
      if (t < nt) {
        near = pv[r0 + t / NTb] != 0;
        if (near && cull) near = !(gap2(mybox, tbox[t]) >= cut);  // NaN: in
      }
      unsigned mask = __ballot_sync(FULL, near);
      count += __popc(mask);
      while (mask) {
        const int tt = t0 + __ffs(mask) - 1;
        mask &= mask - 1;
        const int n = ragged ? min(TILE, S - (tt % NTb) * TILE) : TILE;
        walk_tile<SWITCH, T>(win + tt * TILE, n, h, xi, yi, soft2, c, ck,
                             ax, ay);
      }
    }
    __syncthreads();
  }
  if (walked != nullptr && lane == 0 && count)
    atomicAdd(walked, (unsigned long long)count);

  // the T phases' sums of each row, in a fixed order every lane shares
#pragma unroll
  for (int q = 0; q < T; ++q)
#pragma unroll
    for (int s = LPR; s < TILE; s <<= 1) {
      ax[q] += __shfl_xor_sync(FULL, ax[q], s);
      ay[q] += __shfl_xor_sync(FULL, ay[q], s);
    }
  if (h == 0) {
    float2* o2 = reinterpret_cast<float2*>(out) + o * S;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int r = row0 + lr + q * LPR;
      if (r < S) o2[r] = make_float2(ax[q], ay[q]);
    }
  }
}

template <int SWITCH>
void launch(int T, int grid, int threads, size_t smem, cudaStream_t stream,
            const float* trows, const long long* tid, const float* prows,
            const long long* pidx, const unsigned char* pvalid, float* out,
            unsigned long long* walked, int k, int S, int R, float soft2,
            float c, float cut) {
  if (T == 1)
    rescue_kernel<SWITCH, 1><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, walked, k, S, R, soft2, c, cut);
  else if (T == 2)
    rescue_kernel<SWITCH, 2><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, walked, k, S, R, soft2, c, cut);
  else
    rescue_kernel<SWITCH, 4><<<grid, threads, smem, stream>>>(
        trows, tid, prows, pidx, pvalid, out, walked, k, S, R, soft2, c, cut);
}

}  // namespace

// trows (Bt, 3 S), prows (Bp, 3 S) float32; tid (m,) and pidx (m, k) int64
// row indices into them; pvalid (m, k) bool; out (m, S, 2), 8-byte
// aligned; walked (one uint64, added to) or null. cut: skip a sub-tile
// pair whose squared box gap is >= cut (poly4 only; NaN skips none). T in
// {1, 2, 4} target rows a lane, R staged partner blocks a round
// (ops/band.py::_rescue_plan); a CTA has a warp a run of 32 rows.
extern "C" int tnt_rescue_pairs(const float* trows, const long long* tid,
                                const float* prows, const long long* pidx,
                                const unsigned char* pvalid, float* out,
                                unsigned long long* walked, int m, int k,
                                int band, float soft2, float inv_scale,
                                float cut, int sw, int T, int R,
                                cudaStream_t stream) {
  if (m <= 0 || k <= 0) return 0;
  if (band < 1 || band > 1024 || (sw != SWITCH_EXP4 && sw != SWITCH_POLY4) ||
      (T != 1 && T != 2 && T != 4) || R < 1 || R > k)
    return (int)cudaErrorInvalidValue;
  const int NTb = (band + TILE - 1) / TILE;
  const size_t smem = (size_t)R * NTb * (TILE + 1) * sizeof(float4);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  (sw == SWITCH_POLY4 ? launch<SWITCH_POLY4> : launch<SWITCH_EXP4>)(
      T, m, NTb * 32, smem, stream, trows, tid, prows, pidx, pvalid, out,
      walked, k, band, R, soft2, inv_scale, cut);
  return (int)cudaGetLastError();
}
