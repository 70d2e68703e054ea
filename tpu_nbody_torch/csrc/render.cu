// Point-splat render of a frame, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the plain torch splat of
// ops/render.py::_splat_sum (the JAX package's tpu_nbody/ops/render.py:91-105
// is an XLA scatter), which adds every slot into the framebuffer once for
// the centre pixel and once more for each of the 20 sprite offsets, 21
// index_add_ passes of every slot; a slot off screen, dead or too light
// for a ring went to one extra row, so most of those adds were float
// atomics on the same three addresses. _splat_sum stays as the plain
// version (CPU tensors, and the tests' oracle).
//
// What it computes, for each alive slot i of n (render.py's rules):
//   the pixel (ix, iy) = floor((p - view) * zoom) per axis, the floor
//   clamped to [-1 - REACH, size + REACH] before the int cast and NaN to
//   the low end, so a non-finite or far-off coordinate is off screen for
//   every sprite offset;
//   the colour: "speed" mode the shader's ramp of |v| (2 or 3 columns),
//   white -> mid (smoothstep 0..0.5 of t) -> fast (smoothstep 0.5..1),
//   t = 5 clamp(|v| speed_scale, 0, 1), mid and fast given (the palette
//   render.py computes); "classic" 1 below mass 1000, else 0; times gain;
//   the sprite tier of size = clamp(size_base + size_mass_scale m, 1, 5):
//   none when size_mass_scale is 0, the 3 x 3 disc at size >= 2.5, the
//   21-pixel 5 x 5 disc at >= 4.5;
//   and fb[jy][jx][c] += colour[c] for each on-screen pixel of its disc.
// Every rounding of the geometry (pixel, size) is the plain version's:
// each operation rounded alone (__fsub_rn, __fmul_rn, __fadd_rn), so a
// body lands in the same pixel and tier; torch.clamp keeps NaN, and so
// does clampf below.
//
// What bounds it on this card: bytes. At the frames cell's shape (2^20
// slots, 2400 x 800, speed mode) each slot's position, velocity, mass and
// alive flag read once (22 MB) and the 23 MB frame written once: 0.013 ms
// at 3.35 TB/s (render.splat_work). The wrapper's memset of the frame and
// its clip (a torch clamp_) read and write it twice more.
//
// Design: a thread a slot; a dead slot, or a pixel off screen, writes
// nothing (no dummy row). For each offset k of the warp's widest sprite,
// the lanes that hit the same pixel (__match_any_sync) are summed by their
// lowest lane, in lane order, from the colours kept in shared memory,
// before three float atomicAdds (the deposit kernel's warp pre-sum). It
// holds a crowded pixel's sum, not the time: with an atomic a lane, 2^20
// bodies of one colour on one pixel ended 7.4e-3 from their total (every
// add rounds the same way at the running sum's ulp), pre-summed within
// 1e-4 (tests/test_torch_render_kernel.py). At the frames cell, in the
// engine's slot order, a warp's bodies seldom share a pixel and the two
// time the same (PERF.md). Atomics make a pixel's last bits depend on the
// order of the warps' adds, as the index_add_ they replace did.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int REACH = 2;     // the farthest sprite offset
constexpr unsigned FULL = 0xffffffffu;

// The sprite's offsets: the centre, ring 1 (render.py's _RING1, which
// completes the 3 x 3 disc) and ring 2 (_RING2, the 5 x 5 disc less its
// corners), in their order; tier 0, 1, 2 draws the first 1, 9, 21.
__constant__ signed char DX[21] = {0,  -1, -1, -1, 0,  0,  1,  1,  1,  -2, -2,
                                   -2, -1, -1, 0,  0,  1,  1,  2,  2,  2};
__constant__ signed char DY[21] = {0,  -1, 0, 1,  -1, 1, -1, 0, 1,  -1, 0,
                                   1,  -2, 2, -2, 2,  -2, 2, -1, 0, 1};

enum Mode { SPEED = 0, CLASSIC = 1 };

// The host's floats, in the order of tnt_render_splat's ``params``.
struct Params {
  float view_x, view_y, zoom, speed_scale, gain, size_base, size_scale;
  float mid[3], fast[3];
};
constexpr int N_PARAMS = 13;

struct Args {
  const float* pos;             // (n, pd), columns 0 and 1 read
  const float* vel;             // (n, vd)
  const float* mass;            // (n,)
  const unsigned char* alive;   // (n,) bool
  float* fb;                    // (height, width, 3), zeroed
  int n, pd, vd, width, height, mode;
  Params p;
};

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// render._pixel of (c - view) * zoom on an axis of ``size`` pixels.
__device__ __forceinline__ int pixel(float c, float view, float zoom,
                                     int size) {
  const float f = floorf(__fmul_rn(__fsub_rn(c, view), zoom));
  const float lo = -1.0f - REACH;
  return isnan(f) ? (int)lo : (int)clampf(f, lo, (float)(size + REACH));
}

// render._smoothstep for an edge pair 0.5 apart.
__device__ __forceinline__ float smooth(float e0, float x) {
  const float t = clampf(__fdiv_rn(__fsub_rn(x, e0), 0.5f), 0.0f, 1.0f);
  return __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
}

__global__ void __launch_bounds__(THREADS) splat_kernel(Args a) {
  __shared__ float3 slot[THREADS];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const Params& p = a.p;
  int taps = 0, ix = 0, iy = 0;
  float3 c = make_float3(0.0f, 0.0f, 0.0f);
  if (i < a.n && a.alive[i]) {
    const float* q = a.pos + (long long)i * a.pd;
    ix = pixel(q[0], p.view_x, p.zoom, a.width);
    iy = pixel(q[1], p.view_y, p.zoom, a.height);
    const float m = a.mass[i];
    if (a.mode == SPEED) {
      const float* v = a.vel + (long long)i * a.vd;
      float s2 = __fmul_rn(v[0], v[0]);
      for (int d = 1; d < a.vd; ++d)
        s2 = __fadd_rn(s2, __fmul_rn(v[d], v[d]));
      const float t = __fmul_rn(
          clampf(__fmul_rn(sqrtf(s2), p.speed_scale), 0.0f, 1.0f), 5.0f);
      const float s1 = smooth(0.0f, t), s2r = smooth(0.5f, t);
      const float u1 = __fsub_rn(1.0f, s1), u2 = __fsub_rn(1.0f, s2r);
      float rgb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[k] = __fmul_rn(
            __fadd_rn(__fmul_rn(__fadd_rn(u1, __fmul_rn(p.mid[k], s1)), u2),
                      __fmul_rn(p.fast[k], s2r)),
            p.gain);
      c = make_float3(rgb[0], rgb[1], rgb[2]);
    } else {
      const float w = __fmul_rn(m < 1000.0f ? 1.0f : 0.0f, p.gain);
      c = make_float3(w, w, w);
    }
    int tier = 0;
    if (p.size_scale != 0.0f) {   // render.py's ``if size_mass_scale:``
      const float size = clampf(
          __fadd_rn(p.size_base, __fmul_rn(p.size_scale, m)), 1.0f, 5.0f);
      tier = size >= 4.5f ? 2 : (size >= 2.5f ? 1 : 0);
    }
    taps = tier == 2 ? 21 : (tier == 1 ? 9 : 1);
  }
  slot[threadIdx.x] = c;
  const int K = __reduce_max_sync(FULL, taps);   // the warp's widest sprite
  if (K == 0) return;                            // the whole warp
  __syncwarp();
  const float3* warp_slot = slot + (threadIdx.x & ~31);
  for (int k = 0; k < K; ++k) {
    int key = -1;                 // this lane's pixel at offset k, or none
    if (k < taps) {
      const int jx = ix + DX[k], jy = iy + DY[k];
      if (jx >= 0 && jx < a.width && jy >= 0 && jy < a.height)
        key = jy * a.width + jx;
    }
    const unsigned peers = __match_any_sync(FULL, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      float3 s = make_float3(0.0f, 0.0f, 0.0f);
      for (unsigned b = peers; b; b &= b - 1) {
        const float3 o = warp_slot[__ffs(b) - 1];
        s.x += o.x;
        s.y += o.y;
        s.z += o.z;
      }
      float* px = a.fb + 3LL * key;
      atomicAdd(px, s.x);
      atomicAdd(px + 1, s.y);
      atomicAdd(px + 2, s.z);
    }
  }
}

}  // namespace

// The additive splat of n slots into fb, a (height, width, 3) float32
// frame that it zeroes first (a memset), then one kernel. pos (n, pd), pd
// >= 2, of which columns 0 and 1 are the world coordinates; vel (n, vd),
// vd 2 or 3 (read in speed mode); mass (n,); alive (n,) bool; mode 0
// speed, 1 classic; params (host memory): view_x, view_y, zoom,
// speed_scale, gain, size_base, size_mass_scale, mid (3), fast (3).
extern "C" int tnt_render_splat(const float* pos, const float* vel,
                                const float* mass, const unsigned char* alive,
                                float* fb, int n, int pd, int vd, int width,
                                int height, int mode, const float* params,
                                cudaStream_t stream) {
  if (n < 0 || pd < 2 || (vd != 2 && vd != 3) || width < 0 || height < 0 ||
      (mode != SPEED && mode != CLASSIC) || params == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t pixels = (size_t)width * height;
  if (pixels == 0) return 0;
  const cudaError_t e =
      cudaMemsetAsync(fb, 0, sizeof(float) * 3 * pixels, stream);
  if (e != cudaSuccess || n == 0) return (int)e;
  Args a{pos, vel, mass, alive, fb, n, pd, vd, width, height, mode, {}};
  static_assert(sizeof(Params) == N_PARAMS * sizeof(float), "Params");
  memcpy(&a.p, params, sizeof(Params));
  const int blocks = (n + THREADS - 1) / THREADS;
  splat_kernel<<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
