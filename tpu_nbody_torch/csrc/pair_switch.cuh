// The P3M short-range pair weight, shared by the band kernel (band.cu) and
// the block-rescue kernel (rescue.cu) so the switch is written once.
#pragma once

#include "fastmath.cuh"

enum { SWITCH_EXP4 = 0, SWITCH_POLY4 = 1 };  // ops/band.py::_SWITCH_IDS

// m rsqrt(r2s)^3 w(r2) from the softened r2s = r2 + eps2, its rsqrt inv and
// the mass m, with w poly4 (1 - r2 c)^4 clamped at 0 (c = 1/(4a^2)) or exp4
// exp(-(r2 c)^2) (c = 1/a^2). r2 c = r2s c - eps2 c, so k = 1 + eps2 c
// (poly4) or eps2 c (exp4): see switch_k.
template <int SWITCH>
__device__ __forceinline__ float pair_weight(float r2s, float inv, float m,
                                             float c, float k) {
  if (SWITCH == SWITCH_POLY4) {
    const float t = fmaxf(0.0f, fmaf(-r2s, c, k));
    const float q = (t * t) * inv;
    return (q * q) * (m * inv);
  } else {
    const float q = fmaf(r2s, c, -k);
    return (m * (inv * inv * inv)) * expf(-(q * q));
  }
}

// The constant k of pair_weight for softening eps2 and scale c.
template <int SWITCH>
__device__ __forceinline__ float switch_k(float soft2, float c) {
  return SWITCH == SWITCH_POLY4 ? fmaf(soft2, c, 1.0f) : soft2 * c;
}

// a += m_j d w over one partner p = (x, y, m) for the target (xi, yi).
template <int SWITCH>
__device__ __forceinline__ void switched_pair(float4 p, float xi, float yi,
                                              float soft2, float c, float k,
                                              float& ax, float& ay) {
  const float dx = p.x - xi;
  const float dy = p.y - yi;
  const float r2s = fmaf(dx, dx, fmaf(dy, dy, soft2));
  const float f = pair_weight<SWITCH>(r2s, rsqrt_ftz(r2s), p.z, c, k);
  ax = fmaf(f, dx, ax);
  ay = fmaf(f, dy, ay);
}
