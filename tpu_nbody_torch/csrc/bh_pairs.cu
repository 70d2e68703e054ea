// Barnes–Hut point-mass pair blocks, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA pair blocks of
// tpu_nbody/ops/traverse.py::_point_accel, called by the hier force
// evaluation (_hier_accel) and by the dense/bfs one (bh_accel_from_tree),
// whose plain torch form is ops/traverse.py::_point_accel.
//
// What it computes: for each of the M x C target sets (m, c), its NT
// targets sum, over the S sources of row m (shared by the C sets of the row,
// as the candidates of a hier chunk are shared by its groups) with the
// masses of set (m, c),
//     a_i += m_j * d * rsqrt(r2)^3,   d = p_j - p_i,   r2 = |d|^2 + eps2,
// the reference point-mass kernel without G. Masked candidates and padded
// partner slots carry mass 0 and add exactly 0.
//
// What bounds it on this card: arithmetic, 13 flops a pair counted from the
// plain formula (ops/forces.py::_PAIR_FLOPS), as the all-pairs kernel. The
// lists are padded to the widest chunk's widths, so most source slots carry
// mass 0 (at N = 2^20 about 251 padded pairs for each needed one); what
// bounds a call is the pairs its nonzero masses need.
//
// Design:
// - A set's S source slots are dealt in units of UNIT (32) slots to
//   ``splits`` CTAs, round robin: CTA (set, split) takes units split,
//   split + splits, ... (ops/traverse.py::_pairs_plan picks the splits so
//   that a call's CTAs fill half the card: the dense traversal's chunk of
//   64 sets was 64 CTAs on 132 SMs with one CTA a set; a set's nonzero
//   masses are a prefix of its slots plus scattered holes, so dealing
//   small units spreads the prefix over the set's CTAs where contiguous
//   ranges would leave it to the first). Each CTA sums its units for the
//   set's NT targets; its threads are `lanes` lanes of tpg threads, each
//   thread T targets of the set (the all-pairs kernel's scheme). It takes
//   its units TILE slots at a time: it reads their masses for the set
//   first, and stages the positions and masses of the units that hold a
//   nonzero mass, in order, at the front of a shared-memory tile as
//   float4 (x, y, m, 0); lane L sums the tile's sources L, L + lanes, ...
//   A unit whose masses are all 0 adds nothing and is skipped, and a CTA
//   whose units all are reads its masses once and nothing else. Pairs
//   with mass 0 inside a staged unit are summed (0 * inf would be NaN at
//   d = 0 with eps2 = 0, as in the plain version).
// - The lanes' sums meet in shared memory and are added in lane order.
//   With one split that is the set's result, written by its one CTA, and
//   the unit is the whole tile (slots 0..255, 256..511, ...): the kernel
//   before the split, bit for bit. With more, each CTA writes its sums to
//   its own partial slot (and a flag: none for a CTA that staged
//   nothing), and the last CTA of the set to finish (an atomic ticket
//   after __threadfence, which it resets to 0 for the next call on the
//   stream) adds the partials in split order: the result repeats bit for
//   bit from run to run, with no float atomics and no fill launch. The
//   tickets are per stream (kernels/_build.py::stream_counters), the
//   partials per call.
// - T, tpg, lanes and splits come from ops/traverse.py::_pairs_plan.

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int TILE = 256;            // sources a staged tile
constexpr int UNIT = 32;             // sources dealt at once, split sets
constexpr int MAX_SMEM = 48 * 1024;  // default dynamic shared memory limit

template <int T>
__global__ void bh_pairs_kernel(const float* __restrict__ tgt,
                                const float* __restrict__ src,
                                const float* __restrict__ mass,
                                float* __restrict__ out, float2* part,
                                int* flags, int* tickets, int C, int NT,
                                int S, int tpg, int splits, float soft2) {
  __shared__ float4 tile[TILE];
  __shared__ int live[TILE / 32];  // a tile's units holding a nonzero mass
  __shared__ int last;
  extern __shared__ float2 lane_sum[];  // (lanes, tpg T)
  const long long g = blockIdx.x / splits;  // target set (g / C, g % C)
  const int split = blockIdx.x - (int)(g * splits);
  const long long row = g / C;
  const int lanes = blockDim.x / tpg;
  const int L = threadIdx.x / tpg;
  const int t = threadIdx.x - L * tpg;
  // this CTA's units: split + k splits, k < mine; a tile holds per of them
  // (one split: a unit is a tile, the kernel before the split)
  const int unit = splits == 1 ? TILE : UNIT;
  const int units = (S + unit - 1) / unit;
  const int mine = split < units ? (units - split + splits - 1) / splits : 0;
  const int per = TILE / unit;
  const float2* tg = reinterpret_cast<const float2*>(tgt) + g * NT;
  float xi[T], yi[T], ax[T], ay[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  bool loaded = false;
  const float2* sp = reinterpret_cast<const float2*>(src) + row * S;
  const float* sm = mass + g * S;
  for (int k0 = 0; k0 < mine; k0 += per) {
    // units k0.. of this CTA: unit k is source slots (split + k splits)
    // unit + [0, unit); only the set's last unit can be short, and it is
    // the last of its CTA
    const int nu = min(mine, k0 + per) - k0;
    if (threadIdx.x < per) live[threadIdx.x] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < nu * unit; j += blockDim.x) {
      const int src_j = (split + (k0 + j / unit) * splits) * unit + j % unit;
      if (src_j < S && sm[src_j] != 0.0f) live[j / unit] = 1;
    }
    __syncthreads();
    // the live units, in order, at the front of the tile: a unit whose
    // masses are all 0 adds nothing
    unsigned lm = 0;
    for (int k = 0; k < nu; ++k) lm |= live[k] ? 1u << k : 0u;
    const int tail = unit - min(unit, S - (split + (k0 + nu - 1) * splits) *
                                               unit);  // of a short unit
    const int n = unit * __popc(lm) - ((lm >> (nu - 1)) & 1u ? tail : 0);
    if (n == 0) continue;
    for (int j = threadIdx.x; j < nu * unit; j += blockDim.x) {
      const int k = j / unit;
      const int src_j = (split + (k0 + k) * splits) * unit + j % unit;
      if ((lm >> k) & 1u && src_j < S) {
        const float2 p = sp[src_j];
        tile[unit * __popc(lm & ((1u << k) - 1u)) + j % unit] =
            make_float4(p.x, p.y, sm[src_j], 0.0f);
      }
    }
    if (!loaded) {
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const float2 p = tg[min(t + q * tpg, NT - 1)];  // past NT: not kept
        xi[q] = p.x;
        yi[q] = p.y;
      }
      loaded = true;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = L; j < n; j += lanes) {
      const float4 p = tile[j];
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const float dx = p.x - xi[q];
        const float dy = p.y - yi[q];
        const float inv = rsqrt_ftz(fmaf(dx, dx, fmaf(dy, dy, soft2)));
        const float f = p.z * (inv * inv * inv);
        ax[q] = fmaf(f, dx, ax[q]);
        ay[q] = fmaf(f, dy, ay[q]);
      }
    }
    __syncthreads();
  }
  // loaded is the same in every thread: a tile is walked by all or none
  float2* o2 = splits == 1 ? reinterpret_cast<float2*>(out) + g * NT
                           : part + ((long long)g * splits + split) * NT;
  if (splits == 1 || loaded) {
    if (lanes == 1) {
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int i = t + q * tpg;
        if (i < NT) o2[i] = make_float2(ax[q], ay[q]);
      }
    } else {
      const int w = tpg * T;  // slots a lane's row of lane_sum holds
#pragma unroll
      for (int q = 0; q < T; ++q)
        lane_sum[L * w + t + q * tpg] = make_float2(ax[q], ay[q]);
      __syncthreads();
      for (int i = threadIdx.x; i < NT; i += blockDim.x) {
        float sx = 0.0f, sy = 0.0f;
        for (int q = 0; q < lanes; ++q) {
          const float2 v = lane_sum[q * w + i];
          sx += v.x;
          sy += v.y;
        }
        o2[i] = make_float2(sx, sy);
      }
    }
  }
  if (splits == 1) return;
  // the set's last CTA adds the partials in split order
  __threadfence();  // this CTA's partial before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    flags[g * splits + split] = loaded;
    __threadfence();
    last = atomicAdd(&tickets[g], 1) == splits - 1;
    if (last) tickets[g] = 0;  // every CTA of the set has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float2* ps = part + (long long)g * splits * NT;
  const int* fs = flags + g * splits;
  float2* res = reinterpret_cast<float2*>(out) + g * NT;
  for (int i = threadIdx.x; i < NT; i += blockDim.x) {
    float sx = 0.0f, sy = 0.0f;
    for (int s0 = 0; s0 < splits; s0 += 8) {  // 8 loads in flight
      float2 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = s0 + q < splits && __ldcg(fs + s0 + q)
                   ? __ldcg(ps + (long long)(s0 + q) * NT + i)
                   : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (s0 + q < splits && __ldcg(fs + s0 + q)) {
          sx += v[q].x;
          sy += v[q].y;
        }
    }
    res[i] = make_float2(sx, sy);
  }
}

template <int T>
const void* kernel_of() {
  return (const void*)bh_pairs_kernel<T>;
}

const void* kernel_for(int T) {
  switch (T) {
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 4: return kernel_of<4>();
    case 8: return kernel_of<8>();
    default: return nullptr;
  }
}

size_t lane_smem(int T, int tpg, int lanes) {
  return lanes > 1 ? (size_t)tpg * lanes * T * sizeof(float2) : 0;
}

}  // namespace

// CTAs of the pair kernel with T targets a thread, tpg x lanes threads,
// that one SM holds at once (0 on error); the wrapper asks once a
// (device, shape).
extern "C" int tnt_bh_pairs_blocks_per_sm(int T, int tpg, int lanes) {
  const void* fn = kernel_for(T);
  if (fn == nullptr || tpg < 1 || lanes < 1 || tpg * lanes > 1024) return 0;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fn, tpg * lanes, lane_smem(T, tpg, lanes));
  return e == cudaSuccess ? n : 0;
}

// tgt (M C NT, 2), src (M S, 2), mass (M C S), out (M C NT, 2) float32,
// tgt, src and out 8-byte aligned; T in {1, 2, 4, 8}; tpg threads hold the
// NT targets of a set, T each; lanes lanes of them a CTA; each set's
// sources dealt to splits CTAs (ops/traverse.py::_pairs_plan). With
// splits > 1: part (M C splits NT, 2)
// and flags (M C splits) scratch of the call, tickets (M C) ints that are
// 0 before the call and after it.
extern "C" int tnt_bh_pairs(const float* tgt, const float* src,
                            const float* mass, float* out, float* part,
                            int* flags, int* tickets, int M, int C, int NT,
                            int S, float soft2, int T, int tpg, int lanes,
                            int splits, cudaStream_t stream) {
  if (M <= 0 || C <= 0 || NT <= 0) return 0;
  const void* fn = kernel_for(T);
  if (fn == nullptr || tpg < 1 || lanes < 1 ||
      (long long)tpg * T < NT || S < 0 || splits < 1 ||
      (splits > 1 && (part == nullptr || flags == nullptr ||
                      tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)tpg * lanes;
  const size_t smem = lane_smem(T, tpg, lanes);
  if (threads > 1024 ||
      smem + TILE * sizeof(float4) + sizeof(int) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)M * C * splits;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  float2* part2 = reinterpret_cast<float2*>(part);
  void* args[] = {&tgt, &src, &mass, &out, &part2,  &flags, &tickets,
                  &C,   &NT,  &S,    &tpg, &splits, &soft2};
  return (int)cudaLaunchKernel(fn, (unsigned)grid, (unsigned)threads, args,
                               smem, stream);
}
