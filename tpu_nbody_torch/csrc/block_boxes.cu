// P3M rescue block rows and boxes, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA block boxes of
// tpu_nbody/ops/mesh.py::_block_rescue (:286-300) and of
// tpu_nbody/parallel/sharded_pm.py::_cross_shard_rescue (:197), whose
// plain torch form is ops/mesh.py::_block_boxes_ref (a pad, a concat, two
// masked reductions: about ten launches).
//
// What it computes: the sorted bodies cut into B = ceil(cap / S) blocks of
// S slots; X (B, S, 3) holds each slot's (x, y, m), zero past cap; box
// (B, 4) holds each block's [minx, maxx, miny, maxy] over its alive slots,
// NaN if any alive coordinate is NaN (torch's amin and amax propagate it),
// and the inverted (FLT_MAX, -FLT_MAX, FLT_MAX, -FLT_MAX) for a block with
// no alive slot. Min, max and copies are exact, so the bits equal the
// plain version's (a -0/+0 tie may pick either zero, which compares equal).
//
// What bounds it on this card: bytes. Positions, masses and alive flags
// are read once and the rows and boxes written once, 26 MB at 2^20 bodies
// and S = 128 (ops/mesh.py::block_boxes_work): 0.008 ms at 3.35 TB/s.
//
// Design: a warp a block, eight a CTA. The warp writes the block's 3 S
// floats of X in order, a float a lane (coalesced stores; the loads of
// the interleaved pos and mass come through L1), then takes the box over
// the slots a lane at a time with NaN-propagating min and max, reduced by
// shuffles. One launch in place of the plain version's chain, which is
// what the selection phase's host enqueue paid for.

#include <cfloat>
#include <cuda_runtime.h>

#include "box_gap.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;

// torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(32 * WARPS)
    block_boxes_kernel(const float* __restrict__ pos,
                       const float* __restrict__ mass,
                       const unsigned char* __restrict__ alive,
                       float* __restrict__ X, float4* __restrict__ box,
                       int cap, int S, int B) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long s0 = b * S;
  float* xb = X + s0 * 3;
  for (int f = lane; f < 3 * S; f += 32) {
    const int s = f / 3;
    const int c = f - 3 * s;
    const long long i = s0 + s;
    float v = 0.0f;
    if (i < cap) v = c == 2 ? mass[i] : pos[2 * i + c];
    xb[f] = v;
  }
  float lox = FLT_MAX, hix = -FLT_MAX, loy = FLT_MAX, hiy = -FLT_MAX;
  for (int s = lane; s < S; s += 32) {
    const long long i = s0 + s;
    if (i < cap && alive[i]) {
      const float2 p = reinterpret_cast<const float2*>(pos)[i];
      lox = tmin(lox, p.x);
      hix = tmax(hix, p.x);
      loy = tmin(loy, p.y);
      hiy = tmax(hiy, p.y);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lox = tmin(lox, __shfl_xor_sync(FULL, lox, o));
    hix = tmax(hix, __shfl_xor_sync(FULL, hix, o));
    loy = tmin(loy, __shfl_xor_sync(FULL, loy, o));
    hiy = tmax(hiy, __shfl_xor_sync(FULL, hiy, o));
  }
  if (lane == 0) box[b] = make_float4(lox, hix, loy, hiy);
}

}  // namespace

// pos (cap, 2), mass (cap,) float32, alive (cap,) bool; X (B, 3 S) and
// box (B, 4) float32 with B = ceil(cap / S), box 16-byte aligned and pos
// 8-byte aligned (torch's allocations are).
extern "C" int tnt_block_boxes(const float* pos, const float* mass,
                               const unsigned char* alive, float* X,
                               float* box, int cap, int S,
                               cudaStream_t stream) {
  if (cap <= 0) return 0;
  if (S < 1 || S > 1024) return (int)cudaErrorInvalidValue;
  const int B = (cap + S - 1) / S;
  const int grid = (B + WARPS - 1) / WARPS;
  block_boxes_kernel<<<grid, 32 * WARPS, 0, stream>>>(
      pos, mass, alive, X, reinterpret_cast<float4*>(box), cap, S, B);
  return (int)cudaGetLastError();
}
