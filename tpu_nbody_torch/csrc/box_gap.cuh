// The squared gap between two axis-aligned boxes, shared by the rescue's
// selection (rescue_select.cu) and pair sum (rescue.cu) so both skip with
// the bits of ops/mesh.py::_box_gaps; and the NaN-propagating min, max and
// warp union of boxes that block_boxes.cu and rescue_select.cu build.
#pragma once

// torch.maximum: NaN if either side is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// torch.minimum: NaN if either side is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
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

// The union of the warp's 32 boxes (minx, maxx, miny, maxy) in every lane:
// NaN in a coordinate if any box has NaN there, as torch.amin and amax
// reduce. Min and max are exact, so the order of the shuffles changes no
// bit (a tie of -0 and +0 may keep either zero, which compare equal).
__device__ __forceinline__ float4 warp_union(float4 b) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    b.x = tmin(b.x, __shfl_xor_sync(0xffffffffu, b.x, o));
    b.y = tmax(b.y, __shfl_xor_sync(0xffffffffu, b.y, o));
    b.z = tmin(b.z, __shfl_xor_sync(0xffffffffu, b.z, o));
    b.w = tmax(b.w, __shfl_xor_sync(0xffffffffu, b.w, o));
  }
  return b;
}
