// Exact softened all-pairs acceleration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_nbody/ops/forces.py::_allpairs_kernel
// (called by _allpairs_pallas through accel_allpairs(implementation=
// "pallas")). For each target i, over every source j,
//     r2 = eps2 + |p_j - t_i|^2,   acc_i += m_j * (p_j - t_i) * rsqrt(r2) / r2,
// in dim 2 or 3, without G (the wrapper applies it). Targets may be a
// separate array from the sources; with targets == sources this is the TPU
// kernel. A self pair gives d = 0 and a mass-0 (dead) source gives w = 0,
// so both contribute exactly 0 when eps2 > 0: there is no index skip.
//
// What bounds it on this card: arithmetic. Every pair costs ~20 flops
// (one rsqrt and one IEEE divide among them) against 12-16 bytes of
// source data that is reused by every target of a block.
//
// Each pair term is float32 as in the TPU kernel, but a thread sums its
// terms in float64, and so does the plain version: a target meets up to
// 2^20 sources, and float32 sums of that length in two different orders
// differ by ~5e-5 of the result (measured on an H100), more than the
// kernel-vs-plain tolerance of 1e-5. FP64 adds run at half the FP32 rate
// on Hopper and are 2-3 of the ~20 operations a pair.
//
// Design, after the reference's GLSL shader (gpu/GPU.kt:101-152): one
// thread per target keeps its sum in registers; the block walks the
// sources in tiles of 256 staged in shared memory, every thread reading
// each staged source as a broadcast. Blocks carry nothing between them.
// With few targets the grid is small (4096 targets make 16 blocks for 132
// SMs); splitting the sources across blocks would fill the card, but this
// kernel is the accuracy oracle, off the timed path, and stays simple.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

template <int DIM>
__global__ void __launch_bounds__(TILE) allpairs_kernel(
    const float* __restrict__ tgt, const float* __restrict__ src,
    const float* __restrict__ mass, float* __restrict__ out, int nt, int ns,
    float soft2) {
  __shared__ float sp[DIM][TILE];
  __shared__ float smass[TILE];
  const int i = blockIdx.x * TILE + threadIdx.x;
  float ti[DIM];
  for (int k = 0; k < DIM; ++k)
    ti[k] = i < nt ? tgt[(long long)i * DIM + k] : 0.0f;
  double acc[DIM];  // float32 pair terms, summed in float64 (see above)
  for (int k = 0; k < DIM; ++k) acc[k] = 0.0;

  for (int j0 = 0; j0 < ns; j0 += TILE) {
    const int j = j0 + threadIdx.x;
    const bool ok = j < ns;
    for (int k = 0; k < DIM; ++k)
      sp[k][threadIdx.x] = ok ? src[(long long)j * DIM + k] : 0.0f;
    smass[threadIdx.x] = ok ? mass[j] : 0.0f;
    __syncthreads();
    const int n = min(TILE, ns - j0);
    for (int jj = 0; jj < n; ++jj) {
      float d[DIM];
      float r2 = soft2;
      for (int k = 0; k < DIM; ++k) {
        d[k] = sp[k][jj] - ti[k];
        r2 = r2 + d[k] * d[k];
      }
      float w = smass[jj] * rsqrtf(r2) / r2;
      for (int k = 0; k < DIM; ++k) acc[k] += (double)(w * d[k]);
    }
    __syncthreads();
  }
  if (i < nt) {
    for (int k = 0; k < DIM; ++k) out[(long long)i * DIM + k] = (float)acc[k];
  }
}

}  // namespace

// out is (nt, dim): the sum over all ns sources for each target.
extern "C" int tnt_allpairs(const float* targets, const float* sources,
                            const float* masses, float* out, int nt, int ns,
                            int dim, float soft2, cudaStream_t stream) {
  if (nt <= 0) return 0;
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  const int blocks = (nt + TILE - 1) / TILE;
  if (dim == 2)
    allpairs_kernel<2><<<blocks, TILE, 0, stream>>>(targets, sources, masses,
                                                    out, nt, ns, soft2);
  else
    allpairs_kernel<3><<<blocks, TILE, 0, stream>>>(targets, sources, masses,
                                                    out, nt, ns, soft2);
  return (int)cudaGetLastError();
}
