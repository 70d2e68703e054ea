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
// Design: one launch set of five kernels (one CTA's worth for the small
// ones):
// - collect: a thread a body; heavies go to a list by warp-aggregated
//   atomics (slot order free: absorbers resolve by id), alive bodies are
//   counted a CTA at a time (__syncthreads_count);
// - pick (one CTA): the table from the list, through the radix select when
//   the heavies overflow it;
// - still (a thread a table slot): the round-2 test against the whole table
//   (H x H), still-absorbing heavies compacted into a list;
// - pass (a thread a body): the compacted absorbers in shared memory, tiled
//   past TILE, the lowest id that hits kept; victims add their mass to
//   their absorber's slot;
// - finish (one CTA, single device only): each absorber's mass plus its
//   gain, and heavy_need (0 when the rule is off).
// The sharded merge runs collect and pick on each rank's bodies (ids from
// gid0), gathers the tables, then still and pass against the global table;
// the ranks sum the gains (ops/merge.py, parallel/sharded.py).

#include <cuda_runtime.h>

namespace {

constexpr int BIG = 0x7fffffff;   // id of an empty slot (int32 max)
constexpr int BODY_THREADS = 256;
constexpr int PICK_THREADS = 1024;
constexpr int SLOT_THREADS = 256;
constexpr int TILE = 1024;        // absorbers a shared tile of the pass

// The scratch buffer, carved into 16-byte aligned parts (the wrapper
// allocates ops/merge.py::_scratch_bytes of them, the same sum):
// ws: [0] heavy count, [1] alive count, [2] still-absorber count;
// gained: nT floats; list: n_list ints; the table (tpos, tgid, tvalid);
// the compacted absorbers (apos, agid, aslot).
struct Scratch {
  int* ws;
  float* gained;
  int* list;
  float* tpos;
  int* tgid;
  unsigned char* tvalid;
  float* apos;
  int* agid;
  int* aslot;
  long long bytes;
};

inline long long up16(long long x) { return (x + 15) & ~15LL; }

Scratch carve(void* base, int n_list, int nT, int dim) {
  char* p = static_cast<char*>(base);
  long long off = 0;
  auto take = [&](long long size) {
    char* out = p + off;
    off += up16(size);
    return out;
  };
  Scratch s;
  s.ws = reinterpret_cast<int*>(take(16));
  s.gained = reinterpret_cast<float*>(take(4LL * nT));
  s.list = reinterpret_cast<int*>(take(4LL * n_list));
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

template <int DIM>
__global__ void __launch_bounds__(PICK_THREADS)
    pick_kernel(const float* pos, const float* mass, const int* list,
                const int* ws, int H, int gid0, float* tpos, int* tgid,
                unsigned char* tvalid) {
  __shared__ int red[33];
  __shared__ int next;
  const int need = ws[0];
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
  // least H keys >= v. Keys are unique, so exactly H keys are >= it.
  unsigned long long kth = 0;
  for (int b = 63; b >= 0; --b) {
    const unsigned long long cand = kth | (1ull << b);
    int c = 0;
    for (int s = t; s < need; s += blockDim.x) {
      const int i = list[s];
      c += mass_key(mass[i], i) >= cand;
    }
    if (cta_sum(c, red) >= H) kth = cand;
  }
  if (t == 0) next = 0;
  __syncthreads();
  for (int s = t; s < need; s += blockDim.x) {
    const int i = list[s];
    if (mass_key(mass[i], i) >= kth)
      put_slot<DIM>(atomicAdd(&next, 1), i, gid0, pos, tpos, tgid, tvalid);
  }
}

// Round 2 from the table: a valid heavy keeps absorbing unless a valid
// heavy of lower id lies within md2. enable_ws (single device): the rule
// applies only with at least two bodies alive.
template <int DIM>
__global__ void __launch_bounds__(SLOT_THREADS)
    still_kernel(const float* tpos, const int* tgid,
                 const unsigned char* tvalid, int nT, float md2,
                 const int* enable_ws, float* apos, int* agid, int* aslot,
                 int* n_abs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nT || !tvalid[s]) return;
  if (enable_ws != nullptr && enable_ws[1] < 2) return;
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
__global__ void __launch_bounds__(BODY_THREADS)
    pass_kernel(const float* pos, const float* mass,
                const unsigned char* alive, int n, int gid0, float md2,
                const float* apos, const int* agid, const int* aslot,
                const int* n_abs_p, float* mass_out,
                unsigned char* alive_out, float* gained) {
  __shared__ float sp[TILE * DIM];
  __shared__ int sg[TILE];
  __shared__ int ss[TILE];
  const int n_abs = *n_abs_p;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && alive[i];
  float p[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) p[k] = live ? pos[i * DIM + k] : 0.0f;
  const int me = gid0 + i;
  int best = BIG, slot = -1;
  for (int t0 = 0; t0 < n_abs; t0 += TILE) {
    const int m = min(TILE, n_abs - t0);
    __syncthreads();   // the previous tile is read
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
#pragma unroll
      for (int k = 0; k < DIM; ++k) sp[t * DIM + k] = apos[(t0 + t) * DIM + k];
      sg[t] = agid[t0 + t];
      ss[t] = aslot[t0 + t];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < m; ++t) {
        const int g = sg[t];
        if (dist2<DIM>(p, sp + t * DIM) < md2 && g != me && g < best) {
          best = g;
          slot = ss[t];
        }
      }
    }
  }
  if (i >= n) return;
  if (slot >= 0) {
    atomicAdd(&gained[slot], mass[i]);
    mass_out[i] = 0.0f;
    alive_out[i] = 0;
  } else {
    mass_out[i] = mass[i];
    alive_out[i] = alive[i];
  }
}

// Single device: each absorber's mass plus its gain; heavy_need, 0 where
// the rule was off (fewer than two bodies alive).
__global__ void finish_kernel(const float* mass, const int* ws,
                              const int* agid, const int* aslot,
                              const float* gained, float* mass_out,
                              int* need_out) {
  if (threadIdx.x == 0) *need_out = ws[1] > 1 ? ws[0] : 0;
  const int n_abs = ws[2];
  for (int k = threadIdx.x; k < n_abs; k += blockDim.x) {
    const int i = agid[k];
    mass_out[i] = __fadd_rn(mass[i], gained[aslot[k]]);
  }
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
                  const unsigned char* tvalid, int nT, const int* enable_ws,
                  const Scratch& s, float* mass_out,
                  unsigned char* alive_out, float* gained,
                  cudaStream_t stream) {
  if (nT > 0) {
    still_kernel<DIM><<<grid_of(nT, SLOT_THREADS), SLOT_THREADS, 0,
                        stream>>>(tpos, tgid, tvalid, nT, md2, enable_ws,
                                  s.apos, s.agid, s.aslot, s.ws + 2);
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

// Single device: the whole rule in one launch set. The table has H slots;
// need_out gets heavy_need (0 when fewer than two bodies are alive).
extern "C" int tnt_merge(const float* pos, const float* mass,
                         const unsigned char* alive, int n, int dim,
                         float max_mass, float md2, int H, void* scratch,
                         long long scratch_bytes, float* mass_out,
                         unsigned char* alive_out, int* need_out,
                         cudaStream_t stream) {
  const Scratch s = carve(scratch, n, H, dim);
  if (bad_shape(n, dim, H, scratch_bytes, s))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(s.ws, 0, 16 + 4LL * H, stream);
  if (e != cudaSuccess) return (int)e;
  e = dim == 2 ? heavies<2>(pos, mass, alive, n, max_mass, H, 0, s, s.tpos,
                            s.tgid, s.tvalid, stream)
               : heavies<3>(pos, mass, alive, n, max_mass, H, 0, s, s.tpos,
                            s.tgid, s.tvalid, stream);
  if (e != cudaSuccess) return (int)e;
  e = dim == 2 ? apply<2>(pos, mass, alive, n, 0, md2, s.tpos, s.tgid,
                          s.tvalid, H, s.ws, s, mass_out, alive_out,
                          s.gained, stream)
               : apply<3>(pos, mass, alive, n, 0, md2, s.tpos, s.tgid,
                          s.tvalid, H, s.ws, s, mass_out, alive_out,
                          s.gained, stream);
  if (e != cudaSuccess) return (int)e;
  finish_kernel<<<1, SLOT_THREADS, 0, stream>>>(mass, s.ws, s.agid, s.aslot,
                                                s.gained, mass_out, need_out);
  return (int)cudaGetLastError();
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
                          nT, nullptr, s, mass_out, alive_out, gained, stream)
               : apply<3>(pos, mass, alive, n, gid0, md2, tpos, tgid, tvalid,
                          nT, nullptr, s, mass_out, alive_out, gained,
                          stream);
  return (int)e;
}
