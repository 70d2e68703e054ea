// The mass-threshold merge ("absorb") rule, hand-written for Hopper
// (sm_90a).
//
// No Pallas original: it replaces the XLA form of
// tpu_nbody/ops/merge.py::merge_bodies (:43: the top-k of the heavies, the
// (capacity x H) distance test, two absorber rounds and the segment sum)
// and the same rule over a gathered table of global ids,
// tpu_nbody/parallel/sharded.py's sharded merge. Its plain torch forms are
// ops/merge.py::_merge_bodies_ref, _heavy_table_ref and _absorb_ref.
//
// What it computes: the heavies are the alive bodies with m > max_mass,
// heavy_need their count. The heavy table holds all of them when they fit
// its H slots, else the H heaviest (ties to the lower index, the order of
// jax.lax.top_k). A valid heavy stops absorbing when a valid heavy of a
// lower id lies within merge_min_dist of it (the JAX rule's
// absorbed_by_lower, which the table alone decides: a heavy's position is
// the table's copy of the same float). Each alive body's absorber is the
// lowest-id still-absorbing heavy with r2 < md2 other than itself; the
// victims get mass 0 and alive false, and each absorber gains the sum of
// its victims' masses. This equals the plain version's second round: a
// still-absorbing heavy is never a victim (a near heavy of lower id would
// have stopped it, one of higher id was stopped by it).
//
// What bounds it on this card: at the bench's shape (2^20 bodies, H = 64)
// the bytes, about 18 MB (positions, masses and flags read once, masses and
// flags written once), 5.4 us at 3.35 TB/s, against the distance tests the
// data needs, n x min(heavy_need, H) at 6 flops each. No matrix product.
//
// Where trouble is likely, and what the design does about it:
// - The bits of the distance test: each difference, square and sum is
//   rounded on its own, in index order (__fsub_rn, __fmul_rn, __fadd_rn: no
//   FMA contraction), as the plain version's explicit sum writes r2, so
//   the absorbers are the plain version's exactly. md2 arrives as the
//   float32 torch compares with.
// - The choice at the cap: the collected heavies are ranked by a 64-bit key
//   (the mass bits made to order like the float, then the complement of
//   the index), unique per body, and a radix select over its 64 bits finds
//   the H-th largest: exactly mesh._topk_lowest_index's choice. It runs in
//   one CTA and only when heavy_need > H, where the engine grows H and
//   redoes the step, so its speed matters little.
// - No host sync: the counts, the "at least two bodies alive" rule and
//   heavy_need stay on the device (the step loop runs 20 merges between
//   syncs).
// - The mass sum uses float atomics, one a victim, so a heavy's gain may
//   differ from the plain version's in its last bits (the plain version's
//   index_add_ is atomic on the card too); the absorbers, alive and
//   heavy_need do not.
//
// Design, single device (tnt_merge): one cooperative launch, a grid of
// at most the CTAs the card holds at once (the CTA size and the occupancy
// come from the wrapper, asked once a device); CTA b owns a contiguous
// chunk of the bodies and the same stretch of the heavy list. Three steps
// split by two grid-wide barriers (cooperative_groups::this_grid()
// .sync()):
// 1. collect: each CTA appends its chunk's heavies to its own stretch of
//    the list by warp-aggregated shared atomics (slot order free:
//    absorbers resolve by id) and writes its heavy and alive counts; a
//    thread loads UNROLL bodies before it tests any, so the loads overlap.
//    Nothing here needs a zeroed counter, so nothing is zeroed before.
// 2. CTA 0 compacts the CTAs' heavies (a prefix sum of their counts),
//    picks the table from them, through the radix select when they
//    overflow it, runs the round-2 test against the whole table (H x H),
//    compacting the still-absorbing heavies, and zeroes the gains, the
//    counters and the finish ticket for step 3.
// 3. the pass over each CTA's chunk, UNROLL bodies loaded at once: the
//    lowest id among the compacted absorbers (staged in shared memory)
//    that hits is kept; victims add their mass to their absorber's slot.
//    The last CTA to finish (an atomic ticket after __threadfence) adds
//    each absorber's gain to its mass and writes heavy_need (0 when the
//    rule is off).
// It replaced a memset and five kernels (collect, pick, still, pass,
// finish), three of them one CTA, whose boundaries and host enqueue were
// most of the call. The cooperative launch is legal on any stream; its
// CTAs are all resident at once, so the barriers cannot wait on a CTA
// that never runs. The port's thread ranks share one stream, so no two of
// these kernels overlap on a card in its paths; a card test runs four at
// once on four streams all the same. Bodies are read by steps 1 and 3;
// the second read of the masses and flags (5 MB at 2^20) comes from L2.
//
// The sharded merge keeps its launches and shares the device functions:
// tnt_merge_heavies runs collect and pick on each rank's bodies (ids from
// gid0), the ranks gather the tables, then tnt_merge_apply runs still and
// the pass against the global table; the ranks sum the gains
// (ops/merge.py, parallel/sharded.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int BIG = 0x7fffffff;   // id of an empty slot (int32 max)
constexpr int BODY_THREADS = 256;
constexpr int PICK_THREADS = 1024;
constexpr int SLOT_THREADS = 256;
constexpr int FUSED_THREADS = 1024;  // threads a CTA of the one-launch merge
constexpr int KPT = 4;  // heavies' keys a thread keeps through the select
constexpr int UNROLL = 4;  // bodies a thread loads at once, one-launch merge
constexpr int STAGE = 256;  // absorbers a CTA of the pass stages in shared

// The scratch buffer, carved into 16-byte aligned parts (the wrapper
// allocates ops/merge.py::_scratch_bytes of them, the same sum):
// ws: [0] heavy count, [1] alive count, [2] still-absorber count, [3] the
// finish ticket; part: two ints a CTA of the one-launch merge (none for
// the sharded halves); gained: nT floats; list: n_list ints; list2:
// n_list ints for the one-launch merge; the table (tpos, tgid, tvalid);
// the compacted absorbers (apos, agid, aslot).
struct Scratch {
  int* ws;
  int* part;   // one-launch merge: a CTA's heavy and alive counts
  float* gained;
  int* list;
  int* list2;  // one-launch merge: the CTAs' heavies, compacted
  float* tpos;
  int* tgid;
  unsigned char* tvalid;
  float* apos;
  int* agid;
  int* aslot;
  long long bytes;
};

inline long long up16(long long x) { return (x + 15) & ~15LL; }

Scratch carve(void* base, int n_list, int nT, int dim, int ctas = 0) {
  char* p = static_cast<char*>(base);
  long long off = 0;
  auto take = [&](long long size) {
    char* out = p + off;
    off += up16(size);
    return out;
  };
  Scratch s;
  s.ws = reinterpret_cast<int*>(take(16));
  s.part = reinterpret_cast<int*>(take(8LL * ctas));
  s.gained = reinterpret_cast<float*>(take(4LL * nT));
  s.list = reinterpret_cast<int*>(take(4LL * n_list));
  s.list2 = reinterpret_cast<int*>(take(ctas ? 4LL * n_list : 0));
  s.tpos = reinterpret_cast<float*>(take(4LL * nT * dim));
  s.tgid = reinterpret_cast<int*>(take(4LL * nT));
  s.tvalid = reinterpret_cast<unsigned char*>(take(nT));
  s.apos = reinterpret_cast<float*>(take(4LL * nT * dim));
  s.agid = reinterpret_cast<int*>(take(4LL * nT));
  s.aslot = reinterpret_cast<int*>(take(4LL * nT));
  s.bytes = off;
  return s;
}

// Ranking key of a heavy: the float's bits made to order like its value,
// then the complement of the index, so the lower index wins a tie.
__device__ __forceinline__ unsigned long long mass_key(float m, int i) {
  unsigned int b = __float_as_uint(m);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) |
         (0xffffffffu - static_cast<unsigned int>(i));
}

// r2 of a - b, each operation rounded alone in index order (the plain
// version's explicit sum).
template <int DIM>
__device__ __forceinline__ float dist2(const float* a, const float* b) {
  float d = __fsub_rn(a[0], b[0]);
  float r2 = __fmul_rn(d, d);
#pragma unroll
  for (int k = 1; k < DIM; ++k) {
    d = __fsub_rn(a[k], b[k]);
    r2 = __fadd_rn(r2, __fmul_rn(d, d));
  }
  return r2;
}

__global__ void __launch_bounds__(BODY_THREADS)
    collect_kernel(const float* mass, const unsigned char* alive, int n,
                   float max_mass, int* list, int* ws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && alive[i];
  const bool heavy = live && mass[i] > max_mass;
  const unsigned ball = __ballot_sync(0xffffffffu, heavy);
  if (ball) {
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ball) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&ws[0], __popc(ball));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (heavy) list[base + __popc(ball & ((1u << lane) - 1u))] = i;
  }
  const int live_n = __syncthreads_count(live);
  if (threadIdx.x == 0 && live_n) atomicAdd(&ws[1], live_n);
}

// Sum of v over the CTA, returned to every thread.
__device__ int cta_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const int out = red[32];
  __syncthreads();   // red is written again by the next call
  return out;
}

template <int DIM>
__device__ __forceinline__ void put_slot(int s, int i, int gid0,
                                         const float* pos, float* tpos,
                                         int* tgid, unsigned char* tvalid) {
  tgid[s] = gid0 + i;
  tvalid[s] = 1;
#pragma unroll
  for (int k = 0; k < DIM; ++k) tpos[s * DIM + k] = pos[i * DIM + k];
}

// The table of H slots from the need collected heavies of list, run by
// one whole CTA (any size; red holds 33 ints, next one): all of them when
// they fit, else the H largest keys by a radix select.
template <int DIM>
__device__ void pick_table(const float* pos, const float* mass,
                           const int* list, int need, int H, int gid0,
                           float* tpos, int* tgid, unsigned char* tvalid,
                           int* red, int* next) {
  const int t = threadIdx.x;
  if (need <= H) {   // every heavy fits: the list is the table
    for (int s = t; s < H; s += blockDim.x) {
      if (s < need) {
        put_slot<DIM>(s, list[s], gid0, pos, tpos, tgid, tvalid);
      } else {
        tgid[s] = BIG;
        tvalid[s] = 0;
#pragma unroll
        for (int k = 0; k < DIM; ++k) tpos[s * DIM + k] = 0.0f;
      }
    }
    return;
  }
  // The H-th largest key, bit by bit from the top: the largest v with at
  // least H keys >= v. Keys are unique, so exactly H keys are >= it. The
  // first KPT keys of each thread stay in registers over the 64 rounds.
  unsigned long long kr[KPT];
  int ir[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int s = t + r * blockDim.x;
    ir[r] = s < need ? list[s] : -1;
    kr[r] = ir[r] >= 0 ? mass_key(mass[ir[r]], ir[r]) : 0ull;
  }
  unsigned long long kth = 0;
  for (int b = 63; b >= 0; --b) {
    const unsigned long long cand = kth | (1ull << b);
    int c = 0;
#pragma unroll
    for (int r = 0; r < KPT; ++r) c += ir[r] >= 0 && kr[r] >= cand;
    for (int s = t + KPT * blockDim.x; s < need; s += blockDim.x) {
      const int i = list[s];
      c += mass_key(mass[i], i) >= cand;
    }
    if (cta_sum(c, red) >= H) kth = cand;
  }
  if (t == 0) *next = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KPT; ++r)
    if (ir[r] >= 0 && kr[r] >= kth)
      put_slot<DIM>(atomicAdd(next, 1), ir[r], gid0, pos, tpos, tgid,
                    tvalid);
  for (int s = t + KPT * blockDim.x; s < need; s += blockDim.x) {
    const int i = list[s];
    if (mass_key(mass[i], i) >= kth)
      put_slot<DIM>(atomicAdd(next, 1), i, gid0, pos, tpos, tgid, tvalid);
  }
}

template <int DIM>
__global__ void __launch_bounds__(PICK_THREADS)
    pick_kernel(const float* pos, const float* mass, const int* list,
                const int* ws, int H, int gid0, float* tpos, int* tgid,
                unsigned char* tvalid) {
  __shared__ int red[33];
  __shared__ int next;
  pick_table<DIM>(pos, mass, list, ws[0], H, gid0, tpos, tgid, tvalid, red,
                  &next);
}

// Round 2 from the table: slot s, a valid heavy, keeps absorbing unless a
// valid heavy of lower id lies within md2. If it does, its position, id
// and slot go to the compacted absorbers at atomicAdd(n_abs, 1).
template <int DIM>
__device__ __forceinline__ void still_slot(int s, const float* tpos,
                                           const int* tgid,
                                           const unsigned char* tvalid,
                                           int nT, float md2, float* apos,
                                           int* agid, int* aslot,
                                           int* n_abs) {
  if (!tvalid[s]) return;
  const int g = tgid[s];
  float p[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) p[k] = tpos[s * DIM + k];
  for (int t = 0; t < nT; ++t) {
    if (tvalid[t] && tgid[t] < g && dist2<DIM>(p, tpos + t * DIM) < md2)
      return;   // absorbed by a lower heavy: never scans
  }
  const int k = atomicAdd(n_abs, 1);
#pragma unroll
  for (int d = 0; d < DIM; ++d) apos[k * DIM + d] = p[d];
  agid[k] = g;
  aslot[k] = s;
}

template <int DIM>
__global__ void __launch_bounds__(SLOT_THREADS)
    still_kernel(const float* tpos, const int* tgid,
                 const unsigned char* tvalid, int nT, float md2, float* apos,
                 int* agid, int* aslot, int* n_abs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nT)
    still_slot<DIM>(s, tpos, tgid, tvalid, nT, md2, apos, agid, aslot,
                    n_abs);
}

// The compacted absorbers a CTA of the pass reads from shared memory.
template <int DIM>
struct Staged {
  float p[STAGE * DIM];
  int g[STAGE];
  int s[STAGE];
};

// Copy the first min(n_abs, STAGE) absorbers into st (the whole CTA takes
// part); returns how many. Read from L2 (__ldcg): in the one-launch merge
// CTA 0 wrote them in the same launch.
template <int DIM>
__device__ int stage_absorbers(Staged<DIM>& st, const float* apos,
                               const int* agid, const int* aslot,
                               int n_abs) {
  const int m = min(n_abs, STAGE);
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
#pragma unroll
    for (int k = 0; k < DIM; ++k)
      st.p[t * DIM + k] = __ldcg(apos + t * DIM + k);
    st.g[t] = __ldcg(agid + t);
    st.s[t] = __ldcg(aslot + t);
  }
  __syncthreads();
  return m;
}

// Body i (live, at p, of mass mi) against the n_abs compacted absorbers
// (the first m staged in st, the rest read from L2; each read is the same
// for every thread, one broadcast): the lowest id that hits, other than
// the body itself, takes it.
template <int DIM>
__device__ __forceinline__ void absorb_body(
    int i, bool live, const float* p, float mi, int gid0, float md2,
    const Staged<DIM>& st, int m, const float* apos, const int* agid,
    const int* aslot, int n_abs, float* mass_out, unsigned char* alive_out,
    float* gained) {
  int best = BIG, slot = -1;
  if (live) {
    const int me = gid0 + i;
    for (int t = 0; t < m; ++t) {
      const int g = st.g[t];
      if (g < best && g != me && dist2<DIM>(p, st.p + t * DIM) < md2) {
        best = g;
        slot = st.s[t];
      }
    }
    for (int t = m; t < n_abs; ++t) {
      const int g = __ldcg(agid + t);
      float q[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) q[k] = __ldcg(apos + t * DIM + k);
      if (g < best && g != me && dist2<DIM>(p, q) < md2) {
        best = g;
        slot = __ldcg(aslot + t);
      }
    }
  }
  if (slot >= 0) {
    atomicAdd(&gained[slot], mi);
    mass_out[i] = 0.0f;
    alive_out[i] = 0;
  } else {
    mass_out[i] = mi;
    alive_out[i] = live;
  }
}

template <int DIM>
__global__ void __launch_bounds__(BODY_THREADS)
    pass_kernel(const float* pos, const float* mass,
                const unsigned char* alive, int n, int gid0, float md2,
                const float* apos, const int* agid, const int* aslot,
                const int* n_abs_p, float* mass_out,
                unsigned char* alive_out, float* gained) {
  __shared__ Staged<DIM> st;
  const int n_abs = *n_abs_p;
  const int m = stage_absorbers<DIM>(st, apos, agid, aslot, n_abs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool live = alive[i];
  float p[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) p[k] = live ? pos[i * DIM + k] : 0.0f;
  absorb_body<DIM>(i, live, p, mass[i], gid0, md2, st, m, apos, agid, aslot,
                   n_abs, mass_out, alive_out, gained);
}

// The exclusive prefix sum of v over the CTA (red holds 33 ints); *total
// gets the sum, in every thread.
__device__ int cta_scan(int v, int* red, int* total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[w] = x;
  __syncthreads();
  if (w == 0) {
    int z = lane < nw ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    if (lane < nw) red[lane] = z;
  }
  __syncthreads();
  const int before = (w ? red[w - 1] : 0) + x - v;
  *total = red[nw - 1];
  __syncthreads();   // red is written again by the next call
  return before;
}

// The whole single-device rule in one cooperative launch (the file's
// design notes): CTA b owns the bodies [b chunk, (b + 1) chunk) and the
// same stretch of list; H table slots; need_out gets heavy_need (0 when
// fewer than two bodies are alive).
template <int DIM>
__global__ void __launch_bounds__(FUSED_THREADS)
    merge_kernel(const float* pos, const float* mass,
                 const unsigned char* alive, int n, float max_mass, float md2,
                 int H, Scratch s, float* mass_out, unsigned char* alive_out,
                 int* need_out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int red[33];
  __shared__ int next;
  __shared__ int cnt;
  __shared__ int last;
  __shared__ Staged<DIM> st;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int chunk = (n + G - 1) / G;
  const int lo = min(n, b * chunk);
  const int hi = min(n, lo + chunk);
  const int lane = t & 31;
  // 1. collect: this CTA's heavies into list[lo, lo + its count), its
  // counts into part[b] (nothing needs zeroing)
  if (t == 0) cnt = 0;
  __syncthreads();
  int live_n = 0;
  for (int base = lo; base < hi; base += UNROLL * T) {
    bool lv[UNROLL];
    float mi[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {   // every load first
      const int i = base + r * T + t;
      lv[r] = i < hi && alive[i];
      mi[r] = i < hi ? mass[i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const bool heavy = lv[r] && mi[r] > max_mass;
      live_n += lv[r];
      const unsigned ball = __ballot_sync(0xffffffffu, heavy);
      if (ball) {
        const int leader = __ffs(ball) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&cnt, __popc(ball));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (heavy)
          s.list[lo + at + __popc(ball & ((1u << lane) - 1u))] =
              base + r * T + t;
      }
    }
  }
  live_n = cta_sum(live_n, red);   // its barriers also settle cnt
  if (t == 0) {
    s.part[2 * b] = cnt;
    s.part[2 * b + 1] = live_n;
  }
  grid.sync();
  // 2. CTA 0: the heavies compacted into list2, the table, the
  // still-absorbing heavies; the gains and the ticket zeroed. What other
  // CTAs wrote is read from L2 (__ldcg).
  if (b == 0) {
    int need = 0, alive_n = 0;
    for (int c0 = 0; c0 < G; c0 += T) {
      const int c = c0 + t;
      const int k = c < G ? __ldcg(s.part + 2 * c) : 0;
      alive_n += c < G ? __ldcg(s.part + 2 * c + 1) : 0;
      int tot;
      const int off = need + cta_scan(k, red, &tot);
      for (int j = 0; j < k; ++j)
        s.list2[off + j] = __ldcg(s.list + (long long)c * chunk + j);
      need += tot;
    }
    alive_n = cta_sum(alive_n, red);   // its barriers also settle list2
    for (int k = t; k < H; k += T) s.gained[k] = 0.0f;
    if (t == 0) cnt = 0;
    if (H > 0) {
      pick_table<DIM>(pos, mass, s.list2, need, H, 0, s.tpos, s.tgid,
                      s.tvalid, red, &next);
      __syncthreads();   // the table is written
      if (alive_n >= 2)
        for (int k = t; k < H; k += T)
          still_slot<DIM>(k, s.tpos, s.tgid, s.tvalid, H, md2, s.apos,
                          s.agid, s.aslot, &cnt);
    }
    __syncthreads();
    if (t == 0) {
      s.ws[0] = need;
      s.ws[1] = alive_n;
      s.ws[2] = cnt;
      s.ws[3] = 0;
    }
  }
  grid.sync();
  // 3. the pass over this CTA's bodies, then the last CTA adds the gains
  const int n_abs = __ldcg(&s.ws[2]);
  const int m = stage_absorbers<DIM>(st, s.apos, s.agid, s.aslot, n_abs);
  for (int base = lo; base < hi; base += UNROLL * T) {
    bool lv[UNROLL];
    float mi[UNROLL];
    float p[UNROLL][DIM];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {   // every load first
      const int i = base + r * T + t;
      lv[r] = i < hi && alive[i];
      mi[r] = i < hi ? mass[i] : 0.0f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) p[r][k] = i < hi ? pos[i * DIM + k] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int i = base + r * T + t;
      if (i < hi)
        absorb_body<DIM>(i, lv[r], p[r], mi[r], 0, md2, st, m, s.apos,
                         s.agid, s.aslot, n_abs, mass_out, alive_out,
                         s.gained);
    }
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();   // this CTA's gains and stores before its ticket
    last = atomicAdd(&s.ws[3], 1) == G - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = t; k < n_abs; k += T) {
    const int i = __ldcg(s.agid + k);
    mass_out[i] = __fadd_rn(mass[i], __ldcg(s.gained + __ldcg(s.aslot + k)));
  }
  if (t == 0)
    *need_out = __ldcg(&s.ws[1]) > 1 ? __ldcg(&s.ws[0]) : 0;
}

int grid_of(int n, int threads) { return (n + threads - 1) / threads; }

template <int DIM>
cudaError_t heavies(const float* pos, const float* mass,
                    const unsigned char* alive, int n, float max_mass,
                    int H, int gid0, const Scratch& s, float* tpos,
                    int* tgid, unsigned char* tvalid, cudaStream_t stream) {
  collect_kernel<<<grid_of(n, BODY_THREADS), BODY_THREADS, 0, stream>>>(
      mass, alive, n, max_mass, s.list, s.ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || H == 0) return e;
  pick_kernel<DIM><<<1, PICK_THREADS, 0, stream>>>(pos, mass, s.list, s.ws,
                                                   H, gid0, tpos, tgid,
                                                   tvalid);
  return cudaGetLastError();
}

template <int DIM>
cudaError_t apply(const float* pos, const float* mass,
                  const unsigned char* alive, int n, int gid0, float md2,
                  const float* tpos, const int* tgid,
                  const unsigned char* tvalid, int nT, const Scratch& s,
                  float* mass_out, unsigned char* alive_out, float* gained,
                  cudaStream_t stream) {
  if (nT > 0) {
    still_kernel<DIM><<<grid_of(nT, SLOT_THREADS), SLOT_THREADS, 0,
                        stream>>>(tpos, tgid, tvalid, nT, md2, s.apos,
                                  s.agid, s.aslot, s.ws + 2);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  pass_kernel<DIM><<<grid_of(n, BODY_THREADS), BODY_THREADS, 0, stream>>>(
      pos, mass, alive, n, gid0, md2, s.apos, s.agid, s.aslot, s.ws + 2,
      mass_out, alive_out, gained);
  return cudaGetLastError();
}

bool bad_shape(int n, int dim, int nT, long long scratch_bytes,
               const Scratch& s) {
  return n <= 0 || nT < 0 || (dim != 2 && dim != 3) ||
         scratch_bytes < s.bytes;
}

}  // namespace

// CTAs of the one-launch merge of dimension dim (FUSED_THREADS threads
// each) that one SM holds at once (0 on error); the wrapper asks once a
// (device, dim).
extern "C" int tnt_merge_blocks_per_sm(int dim) {
  int n = 0;
  const cudaError_t e =
      dim == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, merge_kernel<2>, FUSED_THREADS, 0)
      : dim == 3 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, merge_kernel<3>, FUSED_THREADS, 0)
                 : cudaErrorInvalidValue;
  return e == cudaSuccess ? n : 0;
}

// Single device: the whole rule in one cooperative launch of grid CTAs of
// FUSED_THREADS threads (at most what the card holds at once:
// ops/merge.py::_merge_grid). The table has H slots; need_out gets
// heavy_need (0 when fewer than two bodies are alive). The scratch needs
// no zeroing.
extern "C" int tnt_merge(const float* pos, const float* mass,
                         const unsigned char* alive, int n, int dim,
                         float max_mass, float md2, int H, int grid,
                         void* scratch, long long scratch_bytes,
                         float* mass_out, unsigned char* alive_out,
                         int* need_out, cudaStream_t stream) {
  Scratch s = carve(scratch, n, H, dim, grid);
  if (bad_shape(n, dim, H, scratch_bytes, s) || grid < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&pos, &mass,  &alive, &n,        &max_mass,  &md2,
                  &H,   &s,     &mass_out, &alive_out, &need_out};
  const void* fn = dim == 2 ? (const void*)merge_kernel<2>
                            : (const void*)merge_kernel<3>;
  return (int)cudaLaunchCooperativeKernel(fn, grid, FUSED_THREADS, args, 0,
                                          stream);
}

// One rank of the sharded merge, first half: this rank's heavy table of H
// slots (ids gid0 + index, empty slots id BIG) into tpos/tgid/tvalid; the
// local heavy count in the scratch's first int.
extern "C" int tnt_merge_heavies(const float* pos, const float* mass,
                                 const unsigned char* alive, int n, int dim,
                                 float max_mass, int H, int gid0,
                                 void* scratch, long long scratch_bytes,
                                 float* tpos, int* tgid,
                                 unsigned char* tvalid, cudaStream_t stream) {
  const Scratch s = carve(scratch, n, H, dim);
  if (bad_shape(n, dim, H, scratch_bytes, s))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(s.ws, 0, 16, stream);
  if (e != cudaSuccess) return (int)e;
  e = dim == 2 ? heavies<2>(pos, mass, alive, n, max_mass, H, gid0, s, tpos,
                            tgid, tvalid, stream)
               : heavies<3>(pos, mass, alive, n, max_mass, H, gid0, s, tpos,
                            tgid, tvalid, stream);
  return (int)e;
}

// Second half: the rule for this rank's bodies (ids gid0 + index) against
// the gathered table of nT slots; victims' masses summed into gained (nT),
// by slot.
extern "C" int tnt_merge_apply(const float* pos, const float* mass,
                               const unsigned char* alive, int n, int dim,
                               int gid0, float md2, const float* tpos,
                               const int* tgid, const unsigned char* tvalid,
                               int nT, void* scratch, long long scratch_bytes,
                               float* mass_out, unsigned char* alive_out,
                               float* gained, cudaStream_t stream) {
  const Scratch s = carve(scratch, 0, nT, dim);
  if (bad_shape(n, dim, nT, scratch_bytes, s))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(s.ws, 0, 16, stream);
  if (e == cudaSuccess && nT > 0)
    e = cudaMemsetAsync(gained, 0, 4LL * nT, stream);
  if (e != cudaSuccess) return (int)e;
  e = dim == 2 ? apply<2>(pos, mass, alive, n, gid0, md2, tpos, tgid, tvalid,
                          nT, s, mass_out, alive_out, gained, stream)
               : apply<3>(pos, mass, alive, n, gid0, md2, tpos, tgid, tvalid,
                          nT, s, mass_out, alive_out, gained, stream);
  return (int)e;
}
