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
// with w the switch of ops/band.py::_short_weight. Partners before the first or
// after the last body have mass 0 (the zero guard blocks of the JAX forms),
// so there are no wrap-around pairs. The self pair gives d = 0, hence 0.
//
// What bounds it on this card: arithmetic. Each body meets 3S partners at
// about 20 flops a pair (poly4; exp4 adds an expf), while each body moves
// about 56 bytes through device memory (its 20 bytes in and out, plus 36
// bytes of staged partners): at S = 128 that is ~7,700 flops per 56 bytes,
// far above the card's ~20 flops per byte of float32 balance.
//
// Design: one CUDA block per S-block with one thread per body. The block
// stages the 3S partners' (x, y, m) in shared memory once (36 bytes a body,
// 4.6 KB at S = 128), masking out-of-range partners to mass 0 instead of
// padding copies of the arrays. Every thread then walks the same partner
// sequence, so each shared-memory read is a broadcast with no bank
// conflicts, and keeps its (ax, ay) in registers. rsqrtf stands for
// lax.rsqrt; no fast-math flags, so expf and the divisions are IEEE.
// The TPU kernel's 1024-body tiles of 8x3 (128 x 128) sub-blocks exist for
// the TPU's layout rules and are not carried over.

#include <cuda_runtime.h>

namespace {

enum { SWITCH_EXP4 = 0, SWITCH_POLY4 = 1 };

template <int SWITCH>
__device__ __forceinline__ float short_weight(float r2, float a) {
  if (SWITCH == SWITCH_POLY4) {
    float s = r2 / (4.0f * a * a);
    float t = fmaxf(0.0f, 1.0f - s);
    float t2 = t * t;
    return t2 * t2;
  } else {
    float q = r2 / (a * a);
    return expf(-(q * q));
  }
}

template <int SWITCH>
__global__ void band_kernel(const float* __restrict__ pos,
                            const float* __restrict__ mass,
                            float* __restrict__ out, int cap, int S,
                            float soft2, float a) {
  extern __shared__ float sh[];
  float* sx = sh;           // 3S partner x
  float* sy = sh + 3 * S;   // 3S partner y
  float* sm = sh + 6 * S;   // 3S partner mass (0 outside [0, cap))
  const long long first = ((long long)blockIdx.x - 1) * S;  // block b-1
  for (int j = threadIdx.x; j < 3 * S; j += blockDim.x) {
    long long g = first + j;
    bool ok = g >= 0 && g < cap;
    sx[j] = ok ? pos[2 * g] : 0.0f;
    sy[j] = ok ? pos[2 * g + 1] : 0.0f;
    sm[j] = ok ? mass[g] : 0.0f;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const float xi = sx[S + t];
  const float yi = sy[S + t];
  float ax = 0.0f, ay = 0.0f;
  for (int j = 0; j < 3 * S; ++j) {
    float dx = sx[j] - xi;
    float dy = sy[j] - yi;
    float r2 = dx * dx + dy * dy;
    float inv = rsqrtf(r2 + soft2);
    float w = sm[j] * (inv * inv * inv);
    w = w * short_weight<SWITCH>(r2, a);
    ax += w * dx;
    ay += w * dy;
  }
  long long i = (long long)blockIdx.x * S + t;
  if (i < cap) {
    out[2 * i] = ax;
    out[2 * i + 1] = ay;
  }
}

}  // namespace

extern "C" int tnt_band_short_range(const float* pos, const float* mass,
                                    float* out, int cap, int band,
                                    float soft2, float a, int sw,
                                    cudaStream_t stream) {
  if (cap <= 0) return 0;
  if (band < 1 || band > 1024 || (sw != SWITCH_EXP4 && sw != SWITCH_POLY4))
    return (int)cudaErrorInvalidValue;
  const int nb = (cap + band - 1) / band;
  const size_t smem = 9 * sizeof(float) * (size_t)band;
  if (sw == SWITCH_POLY4)
    band_kernel<SWITCH_POLY4><<<nb, band, smem, stream>>>(pos, mass, out, cap,
                                                          band, soft2, a);
  else
    band_kernel<SWITCH_EXP4><<<nb, band, smem, stream>>>(pos, mass, out, cap,
                                                         band, soft2, a);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by any launcher of this library.
extern "C" const char* tnt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
