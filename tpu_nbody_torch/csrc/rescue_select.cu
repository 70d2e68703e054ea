// P3M block-rescue partner selection, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA selection of
// tpu_nbody/ops/mesh.py::_block_rescue (one_chunk, :316-330: the box-gap
// test, the partner counts and jax.lax.top_k, both tiers) and the export
// scores and import picks of
// tpu_nbody/parallel/sharded_pm.py::_cross_shard_rescue (:197). Its plain
// torch form is ops/mesh.py::_rescue_select_ref; the pair sums stay in
// csrc/rescue.cu, which takes this kernel's lists as they are.
//
// What it computes: for each target box t (minx, maxx, miny, maxy) and
// every candidate box j,
//     gx = max(max(t.minx - j.maxx, j.minx - t.maxx), 0), gy alike,
//     g2 = gx gx + gy gy,
//     mask = g2 < rcut2 && |gid_t - gid_j| > 1 && valid_j,
//     cnt_t = sum of mask,   score = mask ? rcut2 - g2 : 0,
// with gid_t = tgid0 + t, gid_j = cgid[j] (j where cgid is null) and
// valid_j = cvalid[j] (true where cvalid is null); then the kh highest
// scores and their indices, highest first, ties to the lower index
// (jax.lax.top_k's order), cnt, need = max cnt and hot = #(cnt > kthr).
// Slots past cnt get score 0 and index 0 (torch's top-k puts score-0
// entries there; they are invalid, mval > 0 is false, and the pair kernel
// skips them). Empty and padding blocks carry the inverted box (FLT_MAX,
// -FLT_MAX, FLT_MAX, -FLT_MAX): their gaps run through +-FLT_MAX to inf,
// never NaN, and they pair with nothing.
//
// What bounds it on this card: the box tests the run's data needs, 11
// float32 operations each: one union box a (target, group of 32
// candidates), then the 32 members of each group whose union box is near
// (counted by the optional groups counter), against its bytes (the boxes
// read once, the kh partner slots and the counts written once):
// ops/mesh.py::select_work. Every pair's test, 11 B^2 operations, is more
// than the kernel does, and no bound. There is no matrix product, so the
// tensor cores have no role.
//
// Where trouble is likely, and what the design does about it:
// - The bits of the test: every product, sum and difference is rounded on
//   its own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction) and the
//   maxima propagate NaN as torch.maximum and torch.clamp do, so mask and
//   score are the bits of torch's separate elementwise ops. The file is
//   built without --use_fast_math and without -ftz, so subnormal scores
//   and the +-FLT_MAX -> inf path follow IEEE.
// - rcut2 arrives as the float32 that torch compares and subtracts (the
//   wrapper rounds the Python double once); it is not recomputed here.
// - Ties are the common case: every partner box that overlaps the target
//   has g2 = 0 and score = rcut2 exactly. The ranking key is
//   (score bits << 32) | (0xffffffff - j), unique per candidate, so the
//   lower index wins every tie, whatever order the lanes see them in.
// - Nothing is dropped for room: a collapsed core can want B - 3 partners.
//   cnt counts every masked candidate; the warp's buffer is pruned to its
//   best kh whenever it fills, and a later candidate enters only above the
//   kh-th best key so far, which is exact.
// - Counts: need and hot are integer atomics (a CTA's in shared memory,
//   then one global atomic each a CTA), order-free and exact; they stay
//   on the device. The optional near-group counter is a shared atomic a
//   batch of 32 union tests, so it holds no register through the loops
//   (a loop-carried counter made ptxas spill at its 40 registers).
//
// Design:
// - A persistent grid (at most the CTAs the card holds at once) of W warps
//   a CTA; a warp takes one target at a time.
// - The candidate boxes are copied into shared memory as float4, a tile
//   at a time (8192 boxes, 128 KB, fit in one tile at N = 1M; the table is
//   tiled where it does not fit), with the union box of each 32
//   consecutive candidates beside them. With one tile the table is loaded
//   once a CTA.
// - Tile skip: a lane tests one union box; a group of 32 candidates whose
//   union gap is at least rcut2 is skipped. Exact: rounding is monotone,
//   so a union's rounded g2 is never above a member's.
// - Each near group is tested a candidate a lane; masked candidates whose
//   key beats the warp's threshold are appended, by ballot, to the warp's
//   key buffer in shared memory (kh rounded up to 32, plus 128 of slack).
//   A full buffer is pruned to its best kh by rank counting (each key's
//   rank is the number of keys above it), which also sets the threshold.
// - At the end the warp ranks its buffer the same way and writes slot
//   rank of the target's row directly; no sort network, no library top-k.

#include <cuda_runtime.h>

#include "box_gap.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a CTA may use
constexpr int HEAD = 16;          // bytes of the CTA's three counters
// threads a CTA at most: at 1024 ptxas caps the kernel at 32 registers and
// spills; at 512 it takes 40 and spills nothing
constexpr int MAX_THREADS = 512;

struct Args {
  const float4* tbox;           // (M,) target boxes
  const float4* cbox;           // (C,) candidate boxes
  const long long* cgid;        // (C,) candidate global ids, or null: j
  const unsigned char* cvalid;  // (C,) or null: every candidate valid
  float* mval;                  // (M, kh) scores, highest first
  long long* midx;              // (M, kh) their candidate indices
  int* cnt;                     // (M,) masked candidates of each target
  int* stats;                   // (2,) need (max cnt), hot (#cnt > kthr)
  unsigned long long* groups;   // () near groups tested in full, or null
  long long tgid0;              // global id of target 0
  int M, C, kh, kthr, tile, bufcap;
  float rcut2;
};

// positive scores order like their bits; the low word favours the lower j
__device__ __forceinline__ u64 make_key(float score, int j) {
  return ((u64)__float_as_uint(score) << 32) |
         (u64)(0xffffffffu - (unsigned)j);
}

__device__ __forceinline__ float key_score(u64 k) {
  return __uint_as_float((unsigned)(k >> 32));
}

__device__ __forceinline__ long long key_index(u64 k) {
  return (long long)(0xffffffffu - (unsigned)k);
}

// Candidates [c0, c0 + n) into box[0, n) and the union box of each 32 into
// uni; the whole CTA takes part.
__device__ __forceinline__ void load_tile(const float4* __restrict__ cbox,
                                          float4* box, float4* uni, int c0,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) box[i] = cbox[c0 + i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const int ng = (n + 31) >> 5;
  for (int u = threadIdx.x >> 5; u < ng; u += W) {
    const int i = (u << 5) + lane;
    const float inf = __int_as_float(0x7f800000);
    float4 b = i < n ? box[i] : make_float4(inf, -inf, inf, -inf);
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      b.x = fminf(b.x, __shfl_xor_sync(FULL, b.x, o));
      b.y = fmaxf(b.y, __shfl_xor_sync(FULL, b.y, o));
      b.z = fminf(b.z, __shfl_xor_sync(FULL, b.z, o));
      b.w = fmaxf(b.w, __shfl_xor_sync(FULL, b.w, o));
    }
    if (lane == 0) uni[u] = b;
  }
  __syncthreads();
}

// The rank of key ki among the warp's n buffered keys: how many are above.
__device__ __forceinline__ int rank_of(const u64* buf, int n, u64 ki) {
  int r = 0;
  for (int e = 0; e < n; ++e) r += buf[e] > ki;
  return r;
}

// Keep the best kh of the warp's n > kh buffered keys (in order, at the
// front); return the kh-th best, the new threshold.
__device__ __forceinline__ u64 prune(u64* buf, u64* srt, int n, int kh,
                                     int lane) {
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const u64 ki = buf[i];
    const int r = rank_of(buf, n, ki);
    if (r < kh) srt[r] = ki;
  }
  __syncwarp();
  for (int i = lane; i < kh; i += 32) buf[i] = srt[i];
  __syncwarp();
  return buf[kh - 1];
}

__global__ void __launch_bounds__(MAX_THREADS)
    select_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_stats = reinterpret_cast<int*>(smem);
  unsigned& s_groups = reinterpret_cast<unsigned*>(smem)[2];
  float4* box = reinterpret_cast<float4*>(smem + HEAD);
  float4* uni = box + a.tile;
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int KP = (a.kh + 31) & ~31;
  u64* keys = reinterpret_cast<u64*>(uni + (a.tile >> 5));
  u64* buf = keys + warp * a.bufcap;
  u64* srt = keys + W * a.bufcap + warp * KP;
  if (threadIdx.x < 3) s_stats[threadIdx.x] = 0;  // read after a barrier
  const unsigned below = (1u << lane) - 1u;
  const int ntiles = (a.C + a.tile - 1) / a.tile;
  const int ngroups = (a.M + W - 1) / W;
  int loaded = -1;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int t = g * W + warp;
    const bool active = t < a.M;
    const float4 tb = active ? a.tbox[t] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long tg = a.tgid0 + t;
    int cnt = 0, nbuf = 0;
    u64 thr = 0;  // every masked key is above 0: its score is > 0
    for (int it = 0; it < ntiles; ++it) {
      const int c0 = it * a.tile;
      const int n = min(a.tile, a.C - c0);
      if (it != loaded) {  // uniform over the CTA
        __syncthreads();   // no warp still reads the old tile
        load_tile(a.cbox, box, uni, c0, n);
        loaded = it;
      }
      if (!active) continue;
      const int ng = (n + 31) >> 5;
      for (int u0 = 0; u0 < ng; u0 += 32) {
        const int u = u0 + lane;
        const bool near = u < ng && !(gap2(tb, uni[u]) >= a.rcut2);
        unsigned todo = __ballot_sync(FULL, near);
        if (a.groups && lane == 0 && todo)  // no register lives on for it
          atomicAdd(&s_groups, (unsigned)__popc(todo));
        while (todo) {
          const int v = u0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const int i = (v << 5) + lane;
          const int j = c0 + i;
          bool m = false;
          u64 key = 0;
          if (i < n) {
            const float g2 = gap2(tb, box[i]);
            if (g2 < a.rcut2) {
              const long long d =
                  tg - (a.cgid ? a.cgid[j] : (long long)j);
              m = (d > 1 || d < -1) && (!a.cvalid || a.cvalid[j]);
              key = make_key(__fsub_rn(a.rcut2, g2), j);
            }
          }
          cnt += __popc(__ballot_sync(FULL, m));
          const bool take = m && a.kh > 0 && key > thr;
          const unsigned tm = __ballot_sync(FULL, take);
          if (take) buf[nbuf + __popc(tm & below)] = key;
          nbuf += __popc(tm);
          if (nbuf > a.bufcap - 32) {  // no room for another group
            thr = prune(buf, srt, nbuf, a.kh, lane);
            nbuf = a.kh;
          }
        }
      }
    }
    if (active) {
      __syncwarp();
      float* mv = a.mval + (long long)t * a.kh;
      long long* mi = a.midx + (long long)t * a.kh;
      for (int i = lane; i < nbuf; i += 32) {
        const u64 ki = buf[i];
        const int r = rank_of(buf, nbuf, ki);
        if (r < a.kh) {
          mv[r] = key_score(ki);
          mi[r] = key_index(ki);
        }
      }
      for (int s = nbuf + lane; s < a.kh; s += 32) {
        mv[s] = 0.0f;
        mi[s] = 0;
      }
      if (lane == 0) {
        a.cnt[t] = cnt;
        atomicMax(&s_stats[0], cnt);
        if (cnt > a.kthr) atomicAdd(&s_stats[1], 1);
      }
      __syncwarp();  // the buffer is refilled by the next target
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(&a.stats[0], s_stats[0]);
    atomicAdd(&a.stats[1], s_stats[1]);
    if (a.groups) atomicAdd(a.groups, (unsigned long long)s_groups);
  }
}

}  // namespace

// tbox (M, 4) and cbox (C, 4) float32, 16-byte aligned; cgid (C,) int64
// or null; cvalid (C,) bool or null; mval (M, kh) float32, midx (M, kh)
// int64, cnt (M,) int32; stats (2,) int32, zeroed by the caller; groups
// (one uint64, zeroed by the caller) or null: it gains the (target, group
// of 32 candidates) pairs whose union box passed the skip test, the work
// the run's data needs beyond the union tests. warps a CTA (at most 16),
// tile candidates a shared tile (a multiple of 32), bufcap buffered keys
// a warp (at least kh rounded up to 32, plus 64): ops/mesh.py::_select_plan.
extern "C" int tnt_rescue_select(const float* tbox, const float* cbox,
                                 const long long* cgid,
                                 const unsigned char* cvalid, float* mval,
                                 long long* midx, int* cnt, int* stats,
                                 unsigned long long* groups,
                                 long long tgid0, int M, int C, int kh,
                                 int kthr, float rcut2, int warps, int tile,
                                 int bufcap, cudaStream_t stream) {
  if (M <= 0 || C <= 0) return 0;
  const int KP = (kh + 31) & ~31;
  if (kh < 0 || kh > C || warps < 1 || 32 * warps > MAX_THREADS ||
      tile < 32 ||
      tile % 32 || bufcap < KP + 64)
    return (int)cudaErrorInvalidValue;
  const long long smem = HEAD + 16LL * tile + 16LL * (tile / 32) +
                         8LL * warps * ((long long)bufcap + KP);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int threads = 32 * warps;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, select_kernel, threads, (size_t)smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ngroups = (M + warps - 1) / warps;
  const int grid = ngroups < nsm * per_sm ? ngroups : nsm * per_sm;
  Args a{reinterpret_cast<const float4*>(tbox),
         reinterpret_cast<const float4*>(cbox),
         cgid,
         cvalid,
         mval,
         midx,
         cnt,
         stats,
         groups,
         tgid0,
         M,
         C,
         kh,
         kthr,
         tile,
         bufcap,
         rcut2};
  select_kernel<<<grid, threads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}
