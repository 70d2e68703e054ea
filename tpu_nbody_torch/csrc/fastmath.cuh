// Device math shared by the kernels of this directory.
#pragma once

// rsqrt.approx without the denormal fix-up rsqrtf adds. The kernels call it
// on r2 + eps2 >= eps2 > 0, which is never denormal, so the results are the
// same as rsqrtf's.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
