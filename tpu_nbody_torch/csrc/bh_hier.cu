// Barnes–Hut force evaluation of the hier traversal, hand-written for
// Hopper (sm_90a).
//
// No Pallas original: it replaces, for the hier traversal, the XLA pair
// blocks of tpu_nbody/ops/traverse.py::_point_accel together with the
// per-group masks and the partner flatten that feed them there
// (_hier_accel). Its plain torch form is ops/traverse.py::hier_accel_ref,
// the masked-dense evaluation; the dense and bfs traversals keep
// csrc/bh_pairs.cu.
//
// What it computes: for each valid group g of final chunk c = g / CH and
// each of its gcount bodies i (sorted slots gstart + i),
//     a_i = sum over accepted nodes n       m_n (com_n - p_i) rsqrt(r2)^3
//         + sum over direct leaves l, j in l  m_j (p_j - p_i) rsqrt(r2)^3
// with r2 = |d|^2 + eps2 and no G, where over the chunk's K candidates
//     accepted <=> occupied & pass_g(n) & !(pass_g(parent n) & n has one)
//     direct   <=> occupied & leaf & !pass_g(n)
// and pass_g is the conservative group MAC against the group's box
// (traverse._box_pass_cols). Row gstart - sl0 + i of the group's GS-row
// window (sl0 = clamp(gstart, 0, cap - GS)) gets a_i; the other rows keep
// the zeros the wrapper wrote. Optionally each group's count of accepted
// nodes and direct bodies, and the pairs the CTAs walk, one atomic a CTA.
// No cap truncates the lists here: where the masked-dense form would drop
// leaves past leaf_list_cap or partners past direct_body_cap (a pass whose
// caps overflow, which the engine redoes), this sums them.
//
// What bounds it on this card: arithmetic, 13 flops a needed pair
// (ops/forces.py::_PAIR_FLOPS), as bh_pairs; the MAC costs two box tests
// a candidate and a group, small beside the pairs a group sums.
//
// Design:
// - One CTA of 256 threads a group. The group's targets are held in
//   registers, T a thread: slots = the smallest of 32, 64, ..., 2048 that
//   holds gcount, tpg = slots / T threads a lane, 256 / tpg lanes that
//   share the sources out (the bh_pairs scheme, sized to gcount, not GS).
// - The chunk's candidates pass in tiles of 256, one a thread, up to the
//   chunk's last valid one (the lists are padded to the widest): the thread
//   reads the node row's lanes as float2 (rows are 56 bytes, 8-aligned)
//   and runs both MAC tests with every product and sum rounded on its own
//   (__fmul_rn, __fadd_rn: no FMA contraction), so the decisions are the
//   bits torch's separate elementwise ops give. The CH CTAs of a chunk
//   read the same candidate rows and share them through L2 (no cluster).
// - Accepted nodes are compacted into shared memory as float4 (x, y, m, 0)
//   and opened leaves as (start, count, offset) in candidate order: warp
//   ballots, per-warp totals in shared memory, a warp scan of the leaves'
//   body counts. The order is fixed, so the sums repeat bit for bit.
// - The tile's monopoles are summed from shared memory; the opened leaves'
//   bodies, contiguous rows of the Hilbert-sorted body_rows, are copied
//   into a shared stage of 2048 rows with cp.async (16 bytes a body, a warp
//   a leaf), in pieces where they do not fit, and summed from there. Shared
//   memory is bounded by the tile, not by K or any cap.
// - The lanes' sums meet in shared memory and are added in lane order.

#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int THREADS = 256;          // a CTA; also candidates a tile
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 2048;           // room for staged leaf bodies
constexpr int ROW = 14;               // floats a node row
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* rows;            // (NC, 14) node rows
  const float* body;            // (cap, 4) body rows: x, y, m, 0
  const float* spos;            // (cap, 2) sorted positions
  const int* ids;               // (C, K) candidates of each chunk
  const unsigned char* cvalid;  // (C, K)
  const int* kend;              // (C,) last valid candidate + 1
  const int* gstart;            // (groups,)
  const int* gcount;            // (groups,)
  const unsigned char* gvalid;  // (groups,)
  const float* gmin;            // (groups, 2) group boxes
  const float* gmax;            // (groups, 2)
  float* out;                   // (groups, GS, 2)
  int* counts;                  // (groups, 2) or null
  unsigned long long* walked;   // () or null
  int K, CH, GS, cap, NC;
  int stage;                    // bodies staged at once, <= STAGE
  float theta2, soft2;
};

struct Smem {
  float4 mono[THREADS];         // accepted nodes of the tile
  int lstart[THREADS];          // opened leaves: first body,
  int lcount[THREADS];          // bodies,
  int loff[THREADS];            // offset in the tile's body stream
  int wa[WARPS], wd[WARPS], wb[WARPS];  // per-warp totals
  union {
    float4 stage[STAGE];        // leaf bodies
    float2 part[THREADS * 8];   // lane sums at the end (threads x T)
  } u;
};

// traverse._box_pass_cols for one box and one cell, each operation rounded
// on its own as torch's elementwise ops round it.
__device__ __forceinline__ bool mac_pass(float4 box, float cx, float cy,
                                         float side, float theta2,
                                         float soft2) {
  const float half = __fmul_rn(0.5f, side);
  const float gx = fmaxf(fmaxf(__fsub_rn(__fsub_rn(cx, half), box.z),
                               __fsub_rn(box.x, __fadd_rn(cx, half))),
                         0.0f);
  const float gy = fmaxf(fmaxf(__fsub_rn(__fsub_rn(cy, half), box.w),
                               __fsub_rn(box.y, __fadd_rn(cy, half))),
                         0.0f);
  const float d2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  return __fmul_rn(side, side) < __fmul_rn(theta2, __fadd_rn(d2, soft2)) &&
         d2 > 0.0f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Lane L's share (sources L, L + lanes, ...) of n staged sources.
template <int T>
__device__ __forceinline__ void walk(const float4* src, int n, int L,
                                     int lanes, const float (&xi)[T],
                                     const float (&yi)[T], float (&ax)[T],
                                     float (&ay)[T], float soft2) {
#pragma unroll 4
  for (int j = L; j < n; j += lanes) {
    const float4 p = src[j];
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
}

template <int T>
__device__ __forceinline__ void group_sum(const Args& a, Smem& sm, int g,
                                          int g0, int row0, int n_t,
                                          int tpg) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lanes = THREADS / tpg;
  const int L = tid / tpg;
  const int t = tid - L * tpg;

  const float2* sp = reinterpret_cast<const float2*>(a.spos) + g0;
  float xi[T], yi[T], ax[T], ay[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const float2 p = sp[min(t + q * tpg, n_t - 1)];  // past n_t: not kept
    xi[q] = p.x;
    yi[q] = p.y;
    ax[q] = 0.0f;
    ay[q] = 0.0f;
  }
  const float4 box = make_float4(a.gmin[2 * g], a.gmin[2 * g + 1],
                                 a.gmax[2 * g], a.gmax[2 * g + 1]);
  const long long cbase = (long long)(g / a.CH) * a.K;
  const int kend = min(a.kend[g / a.CH], a.K);
  const float4* body4 = reinterpret_cast<const float4*>(a.body);
  const unsigned below = (1u << lane) - 1u;
  long long n_acc = 0, n_dir = 0;

  for (int k0 = 0; k0 < kend; k0 += THREADS) {
    // ---- classify one candidate a thread ----
    const int k = k0 + tid;
    bool take_a = false, take_d = false;
    float4 mono = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int ls = 0, lc = 0;
    if (k < kend && a.cvalid[cbase + k]) {
      const int id = a.ids[cbase + k];
      if (id >= 0 && id < a.NC) {
        const float2* r =
            reinterpret_cast<const float2*>(a.rows + (long long)id * ROW);
        // (m, comx) (comy, cx) (cy, side) (child, nchild) (start, count)
        // (pcx, pcy) (pside, has_parent)
        const float2 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
        const float2 r3 = __ldg(r + 3), r4 = __ldg(r + 4);
        const float2 r5 = __ldg(r + 5), r6 = __ldg(r + 6);
        if (r0.x > 0.0f) {
          const bool pn = mac_pass(box, r1.y, r2.x, r2.y, a.theta2, a.soft2);
          const bool pp = r6.y != 0.0f &&
                          mac_pass(box, r5.x, r5.y, r6.x, a.theta2, a.soft2);
          take_a = pn && !pp;
          take_d = !pn && r3.x < 0.0f;
          mono = make_float4(r0.y, r1.x, r0.x, 0.0f);
          ls = __float2int_rn(r4.x);
          lc = __float2int_rn(r4.y);
        }
      }
    }
    // ---- compact both lists in candidate order ----
    const unsigned ba = __ballot_sync(FULL, take_a);
    const unsigned bd = __ballot_sync(FULL, take_d);
    const int cnt = take_d ? lc : 0;
    int inc = cnt;  // inclusive warp scan of the leaves' body counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) sm.wb[warp] = inc;
    if (lane == 0) {
      sm.wa[warp] = __popc(ba);
      sm.wd[warp] = __popc(bd);
    }
    __syncthreads();
    int na = 0, nl = 0, nb = 0, oa = 0, od = 0, ob = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w == warp) {
        oa = na;
        od = nl;
        ob = nb;
      }
      na += sm.wa[w];
      nl += sm.wd[w];
      nb += sm.wb[w];
    }
    if (take_a) sm.mono[oa + __popc(ba & below)] = mono;
    if (take_d) {
      const int l = od + __popc(bd & below);
      sm.lstart[l] = ls;
      sm.lcount[l] = lc;
      sm.loff[l] = ob + inc - cnt;
    }
    __syncthreads();

    // ---- sum the accepted nodes, then the opened leaves' bodies ----
    walk<T>(sm.mono, na, L, lanes, xi, yi, ax, ay, a.soft2);
    for (int b0 = 0; b0 < nb; b0 += a.stage) {
      const int n = min(a.stage, nb - b0);
      if (b0 > 0) __syncthreads();  // the last piece is summed
      for (int l = warp; l < nl; l += WARPS) {
        const int o = sm.loff[l];
        const int s = sm.lstart[l] - o;
        const int hi = min(o + sm.lcount[l], b0 + n);
        for (int p = max(o, b0) + lane; p < hi; p += 32)
          cp_async16(&sm.u.stage[p - b0], body4 + (s + p));
      }
      cp_async_wait_all();
      __syncthreads();
      walk<T>(sm.u.stage, n, L, lanes, xi, yi, ax, ay, a.soft2);
    }
    n_acc += na;
    n_dir += nb;
    __syncthreads();  // the lists and the stage are refilled next tile
  }

  if (tid == 0) {
    if (a.counts) {
      a.counts[2 * g] = (int)n_acc;
      a.counts[2 * g + 1] = (int)n_dir;
    }
    if (a.walked)
      atomicAdd(a.walked, (unsigned long long)(n_acc + n_dir) *
                              (unsigned long long)(tpg * T));
  }
  float2* o2 = reinterpret_cast<float2*>(a.out) +
               ((long long)g * a.GS + row0);
  if (lanes == 1) {
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int i = t + q * tpg;
      if (i < n_t) o2[i] = make_float2(ax[q], ay[q]);
    }
    return;
  }
  const int w = tpg * T;  // slots a lane's row of part holds
#pragma unroll
  for (int q = 0; q < T; ++q)
    sm.u.part[L * w + t + q * tpg] = make_float2(ax[q], ay[q]);
  __syncthreads();
  for (int i = tid; i < n_t; i += THREADS) {
    float sx = 0.0f, sy = 0.0f;
    for (int q = 0; q < lanes; ++q) {
      const float2 v = sm.u.part[q * w + i];
      sx += v.x;
      sy += v.y;
    }
    o2[i] = make_float2(sx, sy);
  }
}

__global__ void __launch_bounds__(THREADS, 3) bh_hier_kernel(Args a) {
  __shared__ Smem sm;
  const int g = blockIdx.x;
  if (!a.gvalid[g]) return;
  const int g0 = a.gstart[g];
  if (g0 < 0 || g0 >= a.cap) return;
  const int row0 = g0 - min(g0, a.cap - a.GS);  // sl0 = clamp(g0, 0, cap-GS)
  const int n_t = min(a.gcount[g], a.GS - row0);
  if (n_t <= 0) return;
  if (n_t <= 32)
    group_sum<1>(a, sm, g, g0, row0, n_t, 32);
  else if (n_t <= 64)
    group_sum<2>(a, sm, g, g0, row0, n_t, 32);
  else if (n_t <= 128)
    group_sum<4>(a, sm, g, g0, row0, n_t, 32);
  else if (n_t <= 256)
    group_sum<4>(a, sm, g, g0, row0, n_t, 64);
  else if (n_t <= 512)
    group_sum<4>(a, sm, g, g0, row0, n_t, 128);
  else if (n_t <= 1024)
    group_sum<4>(a, sm, g, g0, row0, n_t, 256);
  else
    group_sum<8>(a, sm, g, g0, row0, n_t, 256);
}

}  // namespace

// rows (NC, 14), body (cap, 4) 16-byte aligned, spos (cap, 2) 8-byte
// aligned, ids (C, K) int32, cvalid (C, K) bool, kend (C,) int32 (each
// chunk's candidates past it are all invalid), gstart, gcount (groups,)
// int32, gvalid (groups,) bool, gmin, gmax (groups, 2), out (groups, GS, 2)
// float32 zeroed by the caller; counts (groups, 2) int32 and walked (one
// uint64) may be null. groups = C * CH; 1 <= GS <= min(cap, 2048); stage
// (1 to 2048) bodies are staged at once (the wrapper passes 2048; tests
// pass less to put piece boundaries inside leaves).
extern "C" int tnt_bh_hier(const float* rows, const float* body,
                           const float* spos, const int* ids,
                           const unsigned char* cvalid, const int* kend,
                           const int* gstart,
                           const int* gcount, const unsigned char* gvalid,
                           const float* gmin, const float* gmax, float* out,
                           int* counts, unsigned long long* walked,
                           int groups, int K, int CH, int GS, int cap, int NC,
                           int stage, float theta2, float soft2,
                           cudaStream_t stream) {
  if (groups <= 0) return 0;
  if (K < 0 || CH < 1 || groups % CH != 0 || GS < 1 || GS > 2048 ||
      GS > cap || NC < 1 || stage < 1 || stage > STAGE)
    return (int)cudaErrorInvalidValue;
  Args a{rows, body, spos, ids, cvalid, kend, gstart, gcount, gvalid, gmin,
         gmax,
         out, counts, walked, K, CH, GS, cap, NC, stage, theta2, soft2};
  bh_hier_kernel<<<groups, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
