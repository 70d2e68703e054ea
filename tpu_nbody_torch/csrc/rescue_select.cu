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
// float32 operations each, of the 32 members of each (target, group of 32
// candidates) whose union box is near (counted by the optional groups
// counter), against its bytes (the boxes read once, the kh partner slots
// and the counts written once): ops/mesh.py::select_work. The union tests
// that find those groups are this design's own and are not counted (at
// the main path's shape the bytes bound it either way). Every pair's test, 11 B^2 operations, is more
// than the kernel does, and no bound. There is no matrix product, so the
// tensor cores have no role. At the main path's 8192 blocks the work is a
// few microseconds of latency-bound chains, one a target, so what counts
// is how many warps the card holds at once and what each CTA does before
// its first test.
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
//   cnt counts every masked candidate; a candidate enters the warp's best
//   keys only above the kh-th best key so far, which is exact, and a
//   shared buffer is pruned to its best kh whenever it fills.
// - The union skip: a group of 32 candidates is skipped when its union
//   box's rounded g2 >= rcut2. Rounding is monotone, so a member's g2 is
//   never below its union's. The unions propagate NaN (torch.amin and
//   amax, ops/mesh.py::_union_boxes): a group with a NaN coordinate is
//   near and its members are tested one by one, where a NaN gap masks
//   nothing. The counter of near groups therefore equals the plain count
//   on every input, NaN and infinite boxes included (see the CTA's near
//   list below for the infinite ones).
// - Counts: need and hot are integer atomics (a CTA's in shared memory,
//   then one global atomic each a CTA), order-free and exact; they stay
//   on the device. The global counters are zeroed by the kernel that
//   built the union table (this file's unions_kernel, or
//   block_boxes.cu), so a selection needs no fill launch of its own. The
//   optional near-group counter is a shared atomic a batch of 32 union
//   tests, so it holds no register through the loops.
//
// Design:
// - The union box of each 32 consecutive candidates is built once a call,
//   in global memory: by block_boxes.cu beside the block boxes on the main
//   path, else by unions_kernel below (a warp a group). No CTA copies the
//   candidate table: a near group's 32 member boxes are read straight
//   from global memory, one coalesced 512-byte load from a table that
//   stays in L2.
// - Shared memory holds only the union table (as a tile; the table is
//   tiled only past ops/mesh.py::_SELECT_UNIONS boxes), the CTA's near
//   list and, for kh > 32, the warps' key buffers, so several CTAs share
//   an SM. A grid of at most the
//   CTAs the card holds at once (the occupancy comes from the wrapper,
//   asked once a device) of W warps a CTA; a warp takes one target at a
//   time.
// - A CTA takes W consecutive targets (Hilbert order keeps them close):
//   the CTA tests the union of their boxes against the tile's union boxes
//   once, a union box a thread, and lists the near ones; each warp then
//   tests its own target against the listed union boxes only, a union box
//   a lane, and walks the ballot of its near groups, the member boxes of
//   up to BATCH near groups loaded at once (one latency for the batch),
//   then tested a candidate a lane. A union box far from the CTA's union
//   is far from each of its targets (the same monotone rounding), so the
//   list changes no bit and no count. That holds for targets whose
//   coordinates are finite or NaN; a target with an infinite coordinate
//   can have a NaN gap of its own (inf - inf) against a union box whose
//   gap to the CTA's union is a number, so the CTA of such a target makes
//   its union NaN and lists every union box. The list spares each target
//   most of its union tests (256 a target at 8192 blocks).
// - kh <= 32 (the main path's 8, both tiers of the two-tier rescue): the
//   warp keeps its 32 best keys in registers, lane l the l-th. A near
//   group whose masked keys all lie at or below the kh-th best is done
//   after one ballot; otherwise its keys are sorted by a bitonic network of
//   shuffles and merged (warp_merge). No shared memory, no ranking pass:
//   lane r < kh writes slot r.
// - kh > 32: masked candidates whose key beats the warp's threshold are
//   appended, by ballot, to the warp's key buffer in shared memory (kh
//   rounded up to 32, plus slack). A full buffer is pruned to its best kh
//   by rank counting (each key's rank is the number of keys above it),
//   which also sets the threshold; at the end the warp ranks its buffer
//   the same way and writes slot rank of the target's row directly.
// - The kernel this design replaced copied the whole candidate table
//   (128 KB at 8192 blocks) and rebuilt its union boxes in every CTA, one
//   CTA an SM, and ranked every buffered key against every other
//   (O(nbuf^2) a target, up to 128 keys before the first prune).

#include <cuda_runtime.h>

#include "box_gap.cuh"

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a CTA may use
// bytes of the CTA's head: three counters, the near-list length and the
// union box of the CTA's targets
constexpr int HEAD = 32;
// threads a CTA at most: at 1024 ptxas caps the kernel at 32 registers and
// spills; at 512 it does not
constexpr int MAX_THREADS = 512;
constexpr int UNION_WARPS = 8;    // warps a CTA of the union kernel

struct Args {
  const float4* tbox;           // (M,) target boxes
  const float4* cbox;           // (C,) candidate boxes
  const float4* cuni;           // (ceil(C / 32),) their union boxes
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

// The 32 largest of the warp's keys top (lane l holds the l-th largest)
// and the warp's new keys x (one a lane, any order), in the same layout:
// x sorted by a bitonic network, reversed against top, the larger of each
// pair kept (the top 32 of both, a bitonic sequence) and merged.
__device__ __forceinline__ u64 warp_merge(u64 top, u64 x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 y = __shfl_xor_sync(FULL, x, j);
      x = (((lane & j) == 0) == ((lane & k) == 0)) ? max(x, y) : min(x, y);
    }
  }
  x = max(top, __shfl_sync(FULL, x, 31 - lane));
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 y = __shfl_xor_sync(FULL, x, j);
    x = (lane & j) == 0 ? max(x, y) : min(x, y);
  }
  return x;
}

constexpr int BATCH = 2;  // near groups whose member boxes load at once

__global__ void __launch_bounds__(MAX_THREADS)
    select_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_stats = reinterpret_cast<int*>(smem);
  unsigned& s_groups = reinterpret_cast<unsigned*>(smem)[2];
  int& s_nn = reinterpret_cast<int*>(smem)[3];
  float4& s_tu = reinterpret_cast<float4*>(smem)[1];
  float4* uni = reinterpret_cast<float4*>(smem + HEAD);
  const int UT = a.tile >> 5;  // union boxes a shared tile
  int* s_nl = reinterpret_cast<int*>(uni + UT);  // the CTA's near list
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int KP = (a.kh + 31) & ~31;
  // bufcap 0: the best keys live in registers (kh <= 32), else in a
  // buffer a warp in shared memory
  const bool regs = a.bufcap == 0;
  u64* keys = reinterpret_cast<u64*>(s_nl + 2 * ((UT + 1) >> 1));
  u64* buf = keys + warp * a.bufcap;
  u64* srt = keys + W * a.bufcap + warp * KP;
  if (threadIdx.x < 3) s_stats[threadIdx.x] = 0;  // read after a barrier
  const unsigned below = (1u << lane) - 1u;
  const int NU = (a.C + 31) >> 5;                 // union boxes in all
  const int ntiles = (NU + UT - 1) / UT;
  const int ngroups = (a.M + W - 1) / W;
  const float inf = __int_as_float(0x7f800000);
  int loaded = -1;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int t = g * W + warp;
    const bool active = t < a.M;
    const float4 tb = active ? a.tbox[t] : make_float4(0.f, 0.f, 0.f, 0.f);
    const long long tg = a.tgid0 + t;
    int cnt = 0, nbuf = 0;
    u64 thr = 0;  // every masked key is above 0: its score is > 0
    u64 top = 0;  // regs: lane l holds the l-th best key so far
    for (int it = 0; it < ntiles; ++it) {
      const int ub = it * UT;
      const int nu = min(UT, NU - ub);
      __syncthreads();     // no warp still reads the tile or the near list
      if (it != loaded) {  // uniform over the CTA
        for (int i = threadIdx.x; i < nu; i += blockDim.x)
          uni[i] = __ldg(a.cuni + ub + i);
        loaded = it;
      }
      // the union of the CTA's W targets (NaN if any is NaN, or if any
      // has an infinite coordinate), and the tile's union boxes near it:
      // no target of the CTA is near any other. Lanes past the CTA's
      // targets repeat its first, which leaves the union as it is.
      if (warp == 0) {
        const int tt = g * W + (lane < W && g * W + lane < a.M ? lane : 0);
        float4 u = a.tbox[tt];
        const bool odd = __any_sync(
            FULL, fabsf(u.x) == inf || fabsf(u.y) == inf ||
                      fabsf(u.z) == inf || fabsf(u.w) == inf);
        u = warp_union(u);
        if (lane == 0) {
          const float nan = __int_as_float(0x7fc00000);
          s_tu = odd ? make_float4(nan, nan, nan, nan) : u;
        }
      }
      if (threadIdx.x == 0) s_nn = 0;
      __syncthreads();
      for (int v0 = warp * 32; v0 < nu; v0 += blockDim.x) {
        const int v = v0 + lane;
        const bool near = v < nu && !(gap2(s_tu, uni[v]) >= a.rcut2);
        const unsigned nb = __ballot_sync(FULL, near);
        int at = 0;
        if (lane == 0 && nb) at = atomicAdd(&s_nn, __popc(nb));
        at = __shfl_sync(FULL, at, 0);
        if (near) s_nl[at + __popc(nb & below)] = v;
      }
      __syncthreads();
      const int nn = s_nn;
      if (!active) continue;
      for (int e0 = 0; e0 < nn; e0 += 32) {
        const int e = e0 + lane;
        const int v = e < nn ? s_nl[e] : 0;
        const bool near = e < nn && !(gap2(tb, uni[v]) >= a.rcut2);
        unsigned todo = __ballot_sync(FULL, near);
        if (a.groups && lane == 0 && todo)  // no register lives on for it
          atomicAdd(&s_groups, (unsigned)__popc(todo));
        while (todo) {
          // the member boxes of up to BATCH near groups, loaded at once
          float4 bx[BATCH];
          int js[BATCH];
#pragma unroll
          for (int q = 0; q < BATCH; ++q) {
            js[q] = -1;
            if (todo) {
              const int vq = __shfl_sync(FULL, v, __ffs(todo) - 1);
              js[q] = ((ub + vq) << 5) + lane;
              todo &= todo - 1;
              if (js[q] < a.C) bx[q] = __ldg(a.cbox + js[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < BATCH; ++q) {
            const int j = js[q];
            if (j < 0) continue;  // past the last near group: uniform
            bool m = false;
            u64 key = 0;
            if (j < a.C) {
              const float g2 = gap2(tb, bx[q]);
              if (g2 < a.rcut2) {
                const long long d =
                    tg - (a.cgid ? __ldg(a.cgid + j) : (long long)j);
                m = (d > 1 || d < -1) && (!a.cvalid || __ldg(a.cvalid + j));
                key = make_key(__fsub_rn(a.rcut2, g2), j);
              }
            }
            cnt += __popc(__ballot_sync(FULL, m));
            if (regs) {
              // a key at or below the kh-th best so far never ranks
              const u64 kth =
                  __shfl_sync(FULL, top, a.kh > 0 ? a.kh - 1 : 0);
              const bool take = m && a.kh > 0 && key > kth;
              if (__ballot_sync(FULL, take))
                top = warp_merge(top, take ? key : 0ull, lane);
              continue;
            }
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
    }
    if (active) {
      float* mv = a.mval + (long long)t * a.kh;
      long long* mi = a.midx + (long long)t * a.kh;
      if (regs) {
        if (lane < a.kh) {  // zero keys (no partner) give score 0, index 0
          mv[lane] = key_score(top);
          mi[lane] = top ? key_index(top) : 0;
        }
      } else {
        __syncwarp();
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
        __syncwarp();  // the buffer is refilled by the next target
      }
      if (lane == 0) {
        a.cnt[t] = cnt;
        atomicMax(&s_stats[0], cnt);
        if (cnt > a.kthr) atomicAdd(&s_stats[1], 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_stats[0]) atomicMax(&a.stats[0], s_stats[0]);
    if (s_stats[1]) atomicAdd(&a.stats[1], s_stats[1]);
    if (a.groups && s_groups) atomicAdd(a.groups, (u64)s_groups);
  }
}

// The union box of each 32 consecutive boxes, a warp a group, with the
// NaN-propagating min and max of torch.amin and amax (the last group's
// missing members count as the inverted infinite box, as
// ops/mesh.py::_union_boxes pads them); CTA 0 also zeroes the selection's
// four stats words (need, hot, and the 64-bit near-group counter).
__global__ void __launch_bounds__(32 * UNION_WARPS)
    unions_kernel(const float4* __restrict__ cbox, float4* __restrict__ uni,
                  int* __restrict__ stats, int C) {
  if (blockIdx.x == 0 && threadIdx.x < 4) stats[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * UNION_WARPS + (threadIdx.x >> 5);
  if (u >= (C + 31) >> 5) return;
  const int j = (u << 5) + lane;
  const float inf = __int_as_float(0x7f800000);
  float4 b = j < C ? __ldg(cbox + j) : make_float4(inf, -inf, inf, -inf);
  b = warp_union(b);
  if (lane == 0) uni[u] = b;
}

}  // namespace

// CTAs of threads threads and smem bytes of dynamic shared memory that one
// SM holds at once (0 on error). Also lifts the kernel's dynamic shared
// memory limit to the most a CTA may use, once for all plans on this
// device (the launch then sets no attribute). The wrapper asks once a
// (device, plan).
extern "C" int tnt_rescue_select_blocks_per_sm(int threads, int smem) {
  if (threads < 32 || threads > MAX_THREADS || smem < 0 || smem > SMEM_MAX)
    return 0;
  if (cudaFuncSetAttribute(select_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, select_kernel, threads, (size_t)smem) != cudaSuccess)
    return 0;
  return n;
}

// cbox (C, 4) float32, 16-byte aligned; uni (ceil(C / 32), 4) float32;
// stats (4,) int32, zeroed here for one selection.
extern "C" int tnt_select_unions(const float* cbox, float* uni, int* stats,
                                 int C, cudaStream_t stream) {
  if (C < 0) return (int)cudaErrorInvalidValue;
  const int nu = (C + 31) / 32;
  const int grid = nu > 0 ? (nu + UNION_WARPS - 1) / UNION_WARPS : 1;
  unions_kernel<<<grid, 32 * UNION_WARPS, 0, stream>>>(
      reinterpret_cast<const float4*>(cbox), reinterpret_cast<float4*>(uni),
      stats, C);
  return (int)cudaGetLastError();
}

// tbox (M, 4) and cbox (C, 4) float32, 16-byte aligned; cuni (ceil(C /
// 32), 4) their union boxes (tnt_select_unions or tnt_block_boxes); cgid
// (C,) int64 or null; cvalid (C,) bool or null; mval (M, kh) float32,
// midx (M, kh) int64, cnt (M,) int32; stats (4,) int32 zeroed by the
// kernel that built cuni: need and hot in [0] and [1], and, when count is
// nonzero, the near groups tested in full (the (target, group of 32
// candidates) pairs whose union box passed the skip test, the work the
// run's data needs beyond the union tests) as a uint64 in [2:4]. warps a
// CTA (at most 16), tile candidates a shared tile of unions (a multiple
// of 32), bufcap buffered keys a warp (at least kh rounded up to 32, plus
// 64; or 0: the best keys in registers, for kh <= 32), smem bytes and
// grid CTAs: ops/mesh.py::_select_plan and _select_capacity.
extern "C" int tnt_rescue_select(const float* tbox, const float* cbox,
                                 const float* cuni, const long long* cgid,
                                 const unsigned char* cvalid, float* mval,
                                 long long* midx, int* cnt, int* stats,
                                 int count, long long tgid0, int M, int C,
                                 int kh, int kthr, float rcut2, int warps,
                                 int tile, int bufcap, int smem, int grid,
                                 cudaStream_t stream) {
  if (M <= 0 || C <= 0) return 0;
  const int KP = (kh + 31) & ~31;
  const long long need_smem =
      HEAD + 16LL * (tile / 32) + 8LL * ((tile / 32 + 1) / 2) +
      (bufcap ? 8LL * warps * ((long long)bufcap + KP) : 0);
  if (kh < 0 || kh > C || warps < 1 || 32 * warps > MAX_THREADS ||
      tile < 32 || tile % 32 || grid < 1 ||
      (bufcap == 0 ? kh > 32 : bufcap < KP + 64) || smem > SMEM_MAX ||
      smem < need_smem)
    return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const float4*>(tbox),
         reinterpret_cast<const float4*>(cbox),
         reinterpret_cast<const float4*>(cuni),
         cgid,
         cvalid,
         mval,
         midx,
         cnt,
         stats,
         count ? reinterpret_cast<unsigned long long*>(stats + 2) : nullptr,
         tgid0,
         M,
         C,
         kh,
         kthr,
         tile,
         bufcap,
         rcut2};
  select_kernel<<<grid, 32 * warps, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}
