// The squared gap between two axis-aligned boxes, shared by the rescue's
// selection (rescue_select.cu) and pair sum (rescue.cu) so both skip with
// the bits of ops/mesh.py::_box_gaps.
#pragma once

// torch.maximum: NaN if either side is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The squared gap of boxes t and c, each (minx, maxx, miny, maxy), rounded
// as torch's separate elementwise ops round it: no FMA contraction, and a
// NaN corner gives a NaN gap, which no `g2 >= cut` test skips.
__device__ __forceinline__ float gap2(float4 t, float4 c) {
  const float gx =
      tmax(tmax(__fsub_rn(t.x, c.y), __fsub_rn(c.x, t.y)), 0.0f);
  const float gy =
      tmax(tmax(__fsub_rn(t.z, c.w), __fsub_rn(c.z, t.w)), 0.0f);
  return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
}
