// Barnes–Hut hier candidate lists and their needs, hand-written for Hopper
// (sm_90a).
//
// No Pallas original: it replaces the XLA candidate refinement of
// tpu_nbody/ops/traverse.py::_hier_lists (:339) and the leaf and direct
// needs that tpu_nbody/ops/traverse.py::_hier_accel (:410) measures over
// the final lists. Their plain torch forms, ops/traverse.py::_hier_lists
// and _hier_needs (masks over the padded lists, row gathers, a cumsum and
// a scatter a level, then a gather and a cumsum a batch of chunks for the
// needs), serve CPU tensors and are this kernel's yardstick on the card.
//
// What it computes, bit for bit as the plain path: for each refinement
// level l (chunks of sizes[l] groups; C chunks, r = C / C_prev children a
// parent chunk) and each child chunk c of parent p, the candidates of p's
// list (the whole node table, ids 0 .. n_nodes - 1, on the first level)
// that are
//     occupied (mass > 0)  and  (root  or  !pass_c(parent cell))
// with pass_c the conservative group MAC of ops/traverse.py::_box_pass_cols
// against c's box (the amin / amax of its groups' boxes) and the parent
// cell of node-row columns 10-12 (column 13 == 0 marks the root). They go
// to c's row of ids (C, K), in the parent list's order, the first K of
// them; the row's tail holds what the plain gather leaves there: the
// parent list's first entry (the root, in any tree with mass), 0 on the
// first level. total (C,) is the exact, unclipped count, and each level's
// need the largest total. On the last level the rows' validity (C, K) is
// written too, and per final chunk the needs of ops/traverse.py::
// _hier_needs: leaf = the kept candidates in the row (position < K) that
// are leaves (column 6 < 0) and fail the MAC of their own cell (columns
// 3-5) against c's box, direct = the bodies (column 9) of the first LC of
// those, in row order; their maxima over the chunks are the pass's
// leaf_need and direct_need. Each MAC operation is rounded on its own
// (__fmul_rn, __fadd_rn, no FMA) and the max and clamp propagate NaN as
// torch.maximum and torch.clamp do, so every decision is torch's bit.
// Every sum is an integer (counts, ordered scans, atomics of ints), so the
// results repeat exactly.
//
// What bounds it on this card: bytes. A level reads each valid candidate
// of the parent lists once (its id and its node row's mass and parent cell;
// on the last level also its own cell, leaf flag and body count, from a
// node table of 15 MB at N = 1M that stays in L2) and writes the child
// lists once, padded to their width, and the last level's validity;
// ops/traverse.py::lists_work counts them. At the BH cell's widths every
// list written in full comes to about 0.65 GB a pass.
//
// Design:
// - The work of a level is cut into fixed segments of SEG = 1024 entries
//   of a parent list, one CTA of 256 threads a (parent, segment, block of
//   up to 32 children): levels of 1 or 7 parent chunks still fill the
//   card. A segment past the parent's length leaves at once. Each CTA
//   reads a candidate's row once and tests it against all its children's
//   boxes, held in shared memory, into a 32-bit mask a candidate.
// - Three kernels a level: count (each child's kept candidates and kept
//   direct leaves a segment, by warp ballots), scan (a CTA a child row:
//   the exclusive offsets of its segments, its total, the padded tail and,
//   on the last level, the validity row), write (the test again, then
//   each kept candidate stored at its segment's offset plus its rank among
//   the CTA's earlier ones: ballots, popc, a prefix over the warps). So the
//   order is the parent list's, and no CTA waits on another.
// - The needs ride in the last level's write: the direct-leaf test of a
//   kept candidate's own cell, its leaf rank from the same segment offsets
//   as the ids (the leaves counted in earlier segments come before it),
//   and integer atomics of each CTA's sums a chunk. A boxes kernel before
//   the levels and a finish kernel after them (the maxima) complete the
//   pass: 2 + 3 x levels launches, no memset, no host sync.
// - The sizes follow the shapes alone: segments over the parent width,
//   child blocks over r, a scan CTA a child row.

#include <cuda_runtime.h>

#include <cstdint>

#include "box_gap.cuh"

namespace {

constexpr int THREADS = 256;               // a CTA
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;                  // candidates a lane
constexpr int PER_WARP = 32 * ROUNDS;      // consecutive candidates a warp
constexpr int SEG = THREADS * ROUNDS;      // candidates a CTA
constexpr int KIDS = 32;                   // child chunks a CTA: mask bits
constexpr int ROW = 14;                    // floats a node row
constexpr int MAX_LEVELS = 8;
constexpr int FIN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  int C;               // child chunks
  int r;               // children a parent chunk
  int Kp;              // parent list width (the node table on level 0)
  int K;               // this level's list width
  int nseg;            // segments of SEG entries over Kp
  int nblk;            // blocks of KIDS children over r
  const int* pids;     // (C / r, Kp) parent lists; null on level 0
  const int* ptotal;   // (C / r,) parent totals; null on level 0
  int* ids;            // (C, K)
  int* total;          // (C,)
  int* cnt;            // (C, nseg): kept counts, then exclusive offsets
  int* lcnt;           // (C, nseg) direct-leaf counts; null but the last
  const float4* box;   // (C,) child boxes: minx, miny, maxx, maxy
};

// ops/traverse.py::_box_pass_cols for one box and one cell, each operation
// rounded on its own and NaN carried through the max and the clamp, as
// torch's elementwise ops do.
__device__ __forceinline__ bool mac_pass(float4 box, float cx, float cy,
                                         float side, float theta2,
                                         float soft2) {
  const float half = __fmul_rn(0.5f, side);
  const float gx = tmax(tmax(__fsub_rn(__fsub_rn(cx, half), box.z),
                             __fsub_rn(box.x, __fadd_rn(cx, half))),
                        0.0f);
  const float gy = tmax(tmax(__fsub_rn(__fsub_rn(cy, half), box.w),
                             __fsub_rn(box.y, __fadd_rn(cy, half))),
                        0.0f);
  const float d2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  return __fmul_rn(side, side) < __fmul_rn(theta2, __fadd_rn(d2, soft2)) &&
         d2 > 0.0f;
}

// Entries of parent p's list that hold candidates. Level 0's parent is the
// node table, whose ids from n_nodes on are unused.
__device__ __forceinline__ int parent_len(const Level& L, int p,
                                          const int* n_nodes) {
  if (L.pids == nullptr) return min(max(*n_nodes, 0), L.Kp);
  return min(L.ptotal[p], L.Kp);
}

// Entry j of parent p's list against the CTA's nk child boxes: its node
// id, the children that keep it (bit k), on the last level those for which
// it is a direct leaf, and its bodies.
__device__ __forceinline__ void test_one(const Level& L,
                                         const float* __restrict__ rows,
                                         const float4* sbox, int nk, int p,
                                         int j, int len, bool last,
                                         float theta2, float soft2, int& id,
                                         unsigned& keep, unsigned& dl,
                                         int& bodies) {
  id = 0;
  keep = dl = 0u;
  bodies = 0;
  if (j >= len) return;
  id = L.pids != nullptr ? __ldg(L.pids + (long long)p * L.Kp + j) : j;
  const float* row = rows + (long long)id * ROW;
  if (!(__ldg(row) > 0.0f)) return;   // unoccupied (NaN mass too)
  const float pcx = __ldg(row + 10), pcy = __ldg(row + 11);
  const float pside = __ldg(row + 12);
  const bool root = __ldg(row + 13) == 0.0f;
  for (int k = 0; k < nk; ++k)
    if (root || !mac_pass(sbox[k], pcx, pcy, pside, theta2, soft2))
      keep |= 1u << k;
  if (!last || keep == 0u || !(__ldg(row + 6) < 0.0f)) return;
  const float cx = __ldg(row + 3), cy = __ldg(row + 4);
  const float side = __ldg(row + 5);
  for (int k = 0; k < nk; ++k)
    if (((keep >> k) & 1u) && !mac_pass(sbox[k], cx, cy, side, theta2, soft2))
      dl |= 1u << k;
  bodies = (int)__ldg(row + 9);
}

// The CTA's place in a level's grid: (parent, child block, segment), the
// segment fastest.
struct Place {
  int p, k0, nk, s, j0, len;
  long long c0;   // the child row of bit 0
};

__device__ __forceinline__ Place place(const Level& L, const int* n_nodes) {
  Place q;
  q.s = (int)(blockIdx.x % (unsigned)L.nseg);
  const int t = (int)(blockIdx.x / (unsigned)L.nseg);
  q.p = t / L.nblk;
  q.k0 = (t - q.p * L.nblk) * KIDS;
  q.nk = min(KIDS, L.r - q.k0);
  q.c0 = (long long)q.p * L.r + q.k0;
  q.j0 = q.s * SEG;
  q.len = parent_len(L, q.p, n_nodes);
  return q;
}

// Each child's kept candidates and kept direct leaves in the segment.
__global__ void __launch_bounds__(THREADS)
    count_kernel(Level L, const float* __restrict__ rows,
                 const int* __restrict__ n_nodes, int last, float theta2,
                 float soft2) {
  __shared__ float4 sbox[KIDS];
  __shared__ int wk[WARPS][KIDS], wl[WARPS][KIDS];
  const Place q = place(L, n_nodes);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (q.j0 >= q.len) {   // uniform over the CTA
    if (tid < q.nk) {
      L.cnt[(q.c0 + tid) * L.nseg + q.s] = 0;
      if (last) L.lcnt[(q.c0 + tid) * L.nseg + q.s] = 0;
    }
    return;
  }
  if (tid < q.nk) sbox[tid] = L.box[q.c0 + tid];
  __syncthreads();
  int nkeep = 0, nleaf = 0;   // lane k: child k's
  for (int i = 0; i < ROUNDS; ++i) {
    const int j = q.j0 + w * PER_WARP + i * 32 + lane;
    int id, bodies;
    unsigned keep, dl;
    test_one(L, rows, sbox, q.nk, q.p, j, q.len, last, theta2, soft2, id,
             keep, dl, bodies);
    for (int k = 0; k < q.nk; ++k) {
      const int a = __popc(__ballot_sync(FULL, (keep >> k) & 1u));
      if (lane == k) nkeep += a;
      if (last) {
        const int b = __popc(__ballot_sync(FULL, (dl >> k) & 1u));
        if (lane == k) nleaf += b;
      }
    }
  }
  if (lane < q.nk) {
    wk[w][lane] = nkeep;
    wl[w][lane] = nleaf;
  }
  __syncthreads();
  if (tid < q.nk) {
    int a = 0, b = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) {
      a += wk[v][tid];
      b += wl[v][tid];
    }
    L.cnt[(q.c0 + tid) * L.nseg + q.s] = a;
    if (last) L.lcnt[(q.c0 + tid) * L.nseg + q.s] = b;
  }
}

// Exclusive prefix of each thread's v over the CTA; the CTA's sum in
// total. smem holds WARPS ints.
__device__ __forceinline__ int block_excl(int v, int& total, int* smem) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[w] = x;
  __syncthreads();
  int base = 0, sum = 0;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) {
    const int s = smem[u];
    if (u < w) base += s;
    sum += s;
  }
  __syncthreads();   // smem free for the next call
  total = sum;
  return base + x - v;
}

// The segments' counts of row c of a (nrow, n) table turned into exclusive
// offsets in place; returns the row's sum. Each thread scans a run of
// consecutive segments.
__device__ __forceinline__ int scan_row(int* row, int n, int* smem) {
  const int per = (n + THREADS - 1) / THREADS;
  const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
  int a = 0;
  for (int i = i0; i < i1; ++i) a += row[i];
  int total;
  int run = block_excl(a, total, smem);
  for (int i = i0; i < i1; ++i) {
    const int v = row[i];
    row[i] = run;
    run += v;
  }
  return total;
}

// row[from .. K) = v, 16-byte stores where the row is aligned for them.
__device__ __forceinline__ void fill_tail(int* row, int from, int K, int v) {
  int* p = row + from;
  long long n = (long long)K - from;
  if (n <= 0) return;
  const long long head =
      min(n, (long long)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2));
  if (threadIdx.x < head) p[threadIdx.x] = v;
  p += head;
  n -= head;
  const long long n4 = n >> 2;
  int4* p4 = reinterpret_cast<int4*>(p);
  const int4 v4 = make_int4(v, v, v, v);
  for (long long i = threadIdx.x; i < n4; i += THREADS) p4[i] = v4;
  for (long long i = (n4 << 2) + threadIdx.x; i < n; i += THREADS) p[i] = v;
}

// Four validity bytes from position j on: 1 below len, little-endian.
__device__ __forceinline__ unsigned valid_word(long long j, int len) {
  unsigned w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (j + b < len) w |= 1u << (8 * b);
  return w;
}

// row[j] = j < len for j in [0, K), 16 bytes a store where aligned.
__device__ __forceinline__ void valid_row(unsigned char* row, int len,
                                          int K) {
  const int head =
      min(K, (int)((16u - ((uintptr_t)row & 15u)) & 15u));
  if ((int)threadIdx.x < head) row[threadIdx.x] = (int)threadIdx.x < len;
  const int n16 = (K - head) >> 4;
  uint4* q = reinterpret_cast<uint4*>(row + head);
  for (int i = threadIdx.x; i < n16; i += THREADS) {
    const long long j = head + 16LL * i;
    q[i] = make_uint4(valid_word(j, len), valid_word(j + 4, len),
                      valid_word(j + 8, len), valid_word(j + 12, len));
  }
  for (long long j = head + 16LL * n16 + threadIdx.x; j < K; j += THREADS)
    row[j] = j < len;
}

// A CTA a child row c: its segments' offsets, its total and its tail; on
// the last level its validity row, and its needs zeroed for the write.
__global__ void __launch_bounds__(THREADS)
    scan_kernel(Level L, const int* __restrict__ n_nodes,
                unsigned char* __restrict__ cvalid, int* __restrict__ leafs,
                int* __restrict__ direct, int last) {
  __shared__ int smem[WARPS];
  const long long c = blockIdx.x;
  const int total = scan_row(L.cnt + c * L.nseg, L.nseg, smem);
  if (last) scan_row(L.lcnt + c * L.nseg, L.nseg, smem);
  const int len = min(total, L.K);
  // what the plain gather leaves past the length: the parent list's
  // first entry, or 0 where it has none (and on level 0)
  const int p = (int)(c / L.r);
  int pad = 0;
  if (L.pids != nullptr && parent_len(L, p, n_nodes) > 0)
    pad = L.pids[(long long)p * L.Kp];
  fill_tail(L.ids + c * L.K, len, L.K, pad);
  if (threadIdx.x == 0) L.total[c] = total;
  if (last) {
    valid_row(cvalid + c * L.K, len, L.K);
    if (threadIdx.x == 0) {
      leafs[c] = 0;
      direct[c] = 0;
    }
  }
}

// The level's lists: each kept candidate at its segment's offset plus its
// rank among the CTA's earlier ones; on the last level each chunk's needs.
__global__ void __launch_bounds__(THREADS)
    write_kernel(Level L, const float* __restrict__ rows,
                 const int* __restrict__ n_nodes, int* __restrict__ leafs,
                 int* __restrict__ direct, int LC, int last, float theta2,
                 float soft2) {
  __shared__ float4 sbox[KIDS];
  __shared__ int wk[WARPS][KIDS], wl[WARPS][KIDS];
  __shared__ int sbase[KIDS], slbase[KIDS], sleaf[KIDS], sdir[KIDS];
  const Place q = place(L, n_nodes);
  if (q.j0 >= q.len) return;   // uniform over the CTA
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid < q.nk) {
    const long long at = (q.c0 + tid) * L.nseg + q.s;
    sbox[tid] = L.box[q.c0 + tid];
    sbase[tid] = L.cnt[at];
    slbase[tid] = last ? L.lcnt[at] : 0;
    sleaf[tid] = 0;
    sdir[tid] = 0;
  }
  __syncthreads();

  // the warp's candidates and its counts a child (lane k: child k)
  int id[ROUNDS], bodies[ROUNDS];
  unsigned keep[ROUNDS], dl[ROUNDS];
  int nkeep = 0, nleaf = 0;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    const int j = q.j0 + w * PER_WARP + i * 32 + lane;
    test_one(L, rows, sbox, q.nk, q.p, j, q.len, last, theta2, soft2, id[i],
             keep[i], dl[i], bodies[i]);
    for (int k = 0; k < q.nk; ++k) {
      const int a = __popc(__ballot_sync(FULL, (keep[i] >> k) & 1u));
      if (lane == k) nkeep += a;
      if (last) {
        const int b = __popc(__ballot_sync(FULL, (dl[i] >> k) & 1u));
        if (lane == k) nleaf += b;
      }
    }
  }
  if (lane < q.nk) {
    wk[w][lane] = nkeep;
    wl[w][lane] = nleaf;
  }
  __syncthreads();

  // where the warp's next kept candidate (direct leaf) of child k goes
  int base = 0, lbase = 0;
  if (lane < q.nk) {
    base = sbase[lane];
    lbase = slbase[lane];
    for (int v = 0; v < w; ++v) {
      base += wk[v][lane];
      lbase += wl[v][lane];
    }
  }
  const unsigned lt = (1u << lane) - 1u;
  int myleaf = 0;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    for (int k = 0; k < q.nk; ++k) {
      const bool kept = (keep[i] >> k) & 1u;
      const unsigned bk = __ballot_sync(FULL, kept);
      const int pos = __shfl_sync(FULL, base, k) + __popc(bk & lt);
      if (kept && pos < L.K) L.ids[(q.c0 + k) * L.K + pos] = id[i];
      if (lane == k) base += __popc(bk);
      if (last) {
        // a direct leaf in the row (position < K); every kept candidate
        // before it is in the row too, so its leaf rank is the segment's
        // leaf offset plus the earlier ones here
        const bool d = ((dl[i] >> k) & 1u) && pos < L.K;
        const unsigned bd = __ballot_sync(FULL, d);
        const int rank = __shfl_sync(FULL, lbase, k) + __popc(bd & lt);
        if (d && rank < LC) atomicAdd(&sdir[k], bodies[i]);
        if (lane == k) {
          lbase += __popc(bd);
          myleaf += __popc(bd);
        }
      }
    }
  }
  if (!last) return;   // uniform
  if (lane < q.nk && myleaf) atomicAdd(&sleaf[lane], myleaf);
  __syncthreads();
  if (tid < q.nk) {
    if (sleaf[tid]) atomicAdd(leafs + q.c0 + tid, sleaf[tid]);
    if (sdir[tid]) atomicAdd(direct + q.c0 + tid, sdir[tid]);
  }
}

struct Boxes {
  int levels, g_pad, total;
  int C[MAX_LEVELS];
  int off[MAX_LEVELS];   // first box of each level
};

// A warp a chunk of a level: its box, the amin of its groups' minima and
// the amax of their maxima, NaN-propagating (torch.amin, torch.amax).
__global__ void __launch_bounds__(THREADS)
    boxes_kernel(const float2* __restrict__ gmin,
                 const float2* __restrict__ gmax, Boxes b,
                 float4* __restrict__ out) {
  const long long gw =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= b.total) return;   // uniform over the warp
  int l = 0;
  while (l + 1 < b.levels && b.off[l + 1] <= gw) ++l;
  const long long c = gw - b.off[l];
  const int sz = b.g_pad / b.C[l];
  const float inf = __int_as_float(0x7f800000);
  float lox = inf, loy = inf, hix = -inf, hiy = -inf;
  for (int i = lane; i < sz; i += 32) {
    const float2 lo = gmin[c * sz + i], hi = gmax[c * sz + i];
    lox = tmin(lox, lo.x);
    loy = tmin(loy, lo.y);
    hix = tmax(hix, hi.x);
    hiy = tmax(hiy, hi.y);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lox = tmin(lox, __shfl_xor_sync(FULL, lox, o));
    loy = tmin(loy, __shfl_xor_sync(FULL, loy, o));
    hix = tmax(hix, __shfl_xor_sync(FULL, hix, o));
    hiy = tmax(hiy, __shfl_xor_sync(FULL, hiy, o));
  }
  if (lane == 0) out[gw] = make_float4(lox, loy, hix, hiy);
}

struct Finish {
  int levels, n_slots, C_last;
  int C[MAX_LEVELS];
  int off[MAX_LEVELS];    // first total of each level
  int slot[MAX_LEVELS];   // its entry of cand_need
};

// Max of a[0 .. n) over the CTA, in thread 0 (0 where n is 0).
__device__ __forceinline__ int block_max(const int* a, int n, int* smem) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int m = 0;
  for (int i = threadIdx.x; i < n; i += FIN_THREADS) m = max(m, a[i]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) smem[w] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int u = 1; u < FIN_THREADS / 32; ++u) m = max(m, smem[u]);
  __syncthreads();
  return m;
}

// needs = [leaf_need, direct_need, cand_need (n_slots)]: the maxima.
__global__ void __launch_bounds__(FIN_THREADS)
    finish_kernel(const int* __restrict__ totals,
                  const int* __restrict__ leafs,
                  const int* __restrict__ direct, Finish f,
                  int* __restrict__ needs) {
  __shared__ int smem[FIN_THREADS / 32];
  for (int i = threadIdx.x; i < f.n_slots; i += FIN_THREADS)
    needs[2 + i] = 0;
  __syncthreads();
  int m = block_max(leafs, f.C_last, smem);
  if (threadIdx.x == 0) needs[0] = m;
  m = block_max(direct, f.C_last, smem);
  if (threadIdx.x == 0) needs[1] = m;
  for (int l = 0; l < f.levels; ++l) {
    m = block_max(totals + f.off[l], f.C[l], smem);
    if (threadIdx.x == 0) needs[2 + f.slot[l]] = m;
  }
}

// Bytes of scratch a plan needs (ops/traverse.py::_lists_scratch): the
// boxes of every level, the segment counts of every level and the last
// level's leaf counts, then its per-chunk leaf and direct sums.
long long scratch_bytes_of(const int* plan, int levels) {
  long long boxes = 0, ints = 0;
  for (int l = 0; l < levels; ++l) {
    const int* P = plan + 6 * l;
    boxes += P[0];
    ints += (long long)P[0] * P[4];
  }
  const int* P = plan + 6 * (levels - 1);
  ints += (long long)P[0] * P[4] + 2LL * P[0];
  return 16 * boxes + 4 * ints;
}

}  // namespace

// rows (NC, 14) float32 node rows (8-byte aligned), n_nodes () int32,
// gmin / gmax (g_pad, 2) float32 group boxes (8-byte aligned), all on the
// device. plan: levels x 6 host ints (C, r, Kp, K, nseg, nblk), as
// ops/traverse.py::_lists_plan gives them. ids: levels host pointers to
// (C, K) int32 lists; totals (sum C) int32; cvalid (C_last, K_last) bool;
// needs (2 + n_slots) int32; slots: levels host ints, each level's entry of
// cand_need. scratch: scratch_bytes of at least scratch_bytes_of(plan,
// levels), 16-byte aligned. Launches 2 + 3 x levels kernels on the stream.
extern "C" int tnt_bh_lists(const float* rows, const int* n_nodes,
                            const float* gmin, const float* gmax,
                            const int* plan, int levels, void* const* ids,
                            int* totals, unsigned char* cvalid, int* needs,
                            const int* slots, int n_slots, void* scratch,
                            long long scratch_bytes, int NC, int g_pad, int LC,
                            float theta2, float soft2, cudaStream_t stream) {
  if (levels < 1 || levels > MAX_LEVELS || NC < 0 || g_pad < 1 || LC < 0 ||
      n_slots < 1)
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < scratch_bytes_of(plan, levels))
    return (int)cudaErrorInvalidValue;
  Level L[MAX_LEVELS];
  Boxes bx;
  Finish fin;
  bx.levels = fin.levels = levels;
  bx.g_pad = g_pad;
  fin.n_slots = n_slots;
  float4* box = reinterpret_cast<float4*>(scratch);
  int nbox = 0;
  for (int l = 0; l < levels; ++l) nbox += plan[6 * l];
  int* ints = reinterpret_cast<int*>(box + nbox);
  int Cp = 1, Kp = NC, off = 0;
  for (int l = 0; l < levels; ++l) {
    const int* P = plan + 6 * l;
    Level& v = L[l];
    v.C = P[0];
    v.r = P[1];
    v.Kp = P[2];
    v.K = P[3];
    v.nseg = P[4];
    v.nblk = P[5];
    if (v.C < 1 || g_pad % v.C || v.C != Cp * v.r || v.Kp != Kp || v.K < 0 ||
        v.nseg != (Kp + SEG - 1) / SEG || v.nblk != (v.r + KIDS - 1) / KIDS ||
        slots[l] < 0 || slots[l] >= n_slots || (l > 0 && v.K > Kp))
      return (int)cudaErrorInvalidValue;
    v.pids = l ? static_cast<const int*>(ids[l - 1]) : nullptr;
    v.ptotal = l ? L[l - 1].total : nullptr;
    v.ids = static_cast<int*>(ids[l]);
    v.total = totals + off;
    v.box = box + off;
    v.cnt = ints;
    ints += (long long)v.C * v.nseg;
    v.lcnt = nullptr;
    bx.C[l] = fin.C[l] = v.C;
    bx.off[l] = fin.off[l] = off;
    fin.slot[l] = slots[l];
    off += v.C;
    Cp = v.C;
    Kp = v.K;
  }
  Level& last = L[levels - 1];
  last.lcnt = ints;
  ints += (long long)last.C * last.nseg;
  int* leafs = ints;
  int* direct = ints + last.C;
  bx.total = off;
  fin.C_last = last.C;

  const long long box_threads = 32LL * off;
  boxes_kernel<<<(unsigned)((box_threads + THREADS - 1) / THREADS), THREADS,
                 0, stream>>>(reinterpret_cast<const float2*>(gmin),
                              reinterpret_cast<const float2*>(gmax), bx, box);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < levels; ++l) {
    const Level& v = L[l];
    const int is_last = l == levels - 1;
    const long long items = (long long)(v.C / v.r) * v.nblk * v.nseg;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (items > 0) {
      count_kernel<<<(unsigned)items, THREADS, 0, stream>>>(
          v, rows, n_nodes, is_last, theta2, soft2);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    scan_kernel<<<v.C, THREADS, 0, stream>>>(v, n_nodes, cvalid, leafs,
                                             direct, is_last);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (items > 0) {
      write_kernel<<<(unsigned)items, THREADS, 0, stream>>>(
          v, rows, n_nodes, leafs, direct, LC, is_last, theta2, soft2);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  finish_kernel<<<1, FIN_THREADS, 0, stream>>>(totals, leafs, direct, fin,
                                               needs);
  return (int)cudaGetLastError();
}
