// Barnes–Hut tree build, hand-written for Hopper (sm_90a).
//
// No Pallas original: it replaces the XLA build of
// tpu_nbody/ops/tree.py::build_tree (Hilbert codes, sort, boundary scans
// over (L, cap) arrays, slot-wise gathers, prefix-sum aggregates). Its
// plain torch form, ops/tree.py::build_tree_ref, serves CPU tensors and is
// this kernel's yardstick on the card.
//
// What it computes, as build_tree_ref: the 30-bit Hilbert code of each
// body's cell on the 2^15 grid over the root (DEAD_CODE for a dead slot),
// bit for bit as ops/morton.py::hilbert_codes; then, from the order
// torch.argsort(codes, stable=True) gives, the sorted bodies (positions,
// exerted masses, the packed body rows, the original index of each sorted
// slot and its inverse, n_alive) and the flat node table: every cell on a
// path of internal cells (count > leaf_size, level < max_depth), ordered by
// level and then by first body, with its code, level, first body, count,
// first child, occupied children and parent, its cell and its parent's
// cell, and its mass and centre of mass. node_need is the unclipped node
// count, n_nodes its clip to the table; a scene that needs more nodes than
// the table holds keeps the first num_nodes, as the plain path does. Every
// integer field is the plain path's bit for bit, the cell geometry too
// (each float operation rounded on its own, __fadd_rn / __fmul_rn, as
// torch's separate operations round it). Mass and centre of mass are
// float64 prefix sums of the float32 terms, differenced in float64 and
// rounded once, as in the plain path; the sums run in another order, so
// they agree to float32 rounding.
//
// What bounds it on this card: bytes. The bodies are read once (position,
// mass, flag), the codes written and read once and the sort's order read
// once; the sorted bodies and the node table are written once:
// ops/tree.py::build_work counts them, about 94 MB at the BH cell's 2^20
// slots and 272,384 nodes. No flop count matters.
//
// Design:
// - Codes (codes_kernel): one thread a body, the 15 Hilbert rounds in
//   registers. It replaces the ~290 elementwise launches of
//   morton.hilbert_codes.
// - The rest (tree_kernel) is one cooperative launch of the CTAs the card
//   holds at once, in four steps split by grid-wide barriers:
//   0. permute: a thread a sorted slot gathers its body and writes the
//      sorted arrays and the inverse scatter.
//   1. owned levels: the plain path builds an (L, cap) mask of cell starts
//      and scans it four times. Here the shallowest level at which body i
//      starts a cell comes from the highest differing bit of its code and
//      its predecessor's (15 - hb / 2). That cell is a node iff its parent
//      holds more than leaf_size bodies: a search of at most leaf_size
//      codes back finds the parent's first body, and one code leaf_size
//      after it decides. Below it, i owns the node of each level whose
//      cell above holds body i + leaf_size, which that body's code tells
//      in one xor. So each body owns a contiguous range of levels, found
//      in O(log leaf_size) reads and kept as a 16-bit mask. Each CTA owns a
//      contiguous chunk of bodies, counts its owners a level and sums its
//      float64 mass terms; the body at the alive / dead border writes
//      n_alive.
//   2. ranks: each CTA's offsets come from the counts of the CTAs before
//      it, and within a chunk a warp ballot a level ranks the owners in
//      body order: node id = nodes of shallower levels + owners before it
//      at its level, the plain path's order. Each owner records its nodes'
//      first body, level and first child (its own node a level below).
//      The same pass writes the float64 exclusive prefix sums of the mass
//      terms.
//   3. nodes: a thread a node-table slot finds its node's end (a galloping
//      search of the sorted codes) and its occupied children (bisections
//      for the quadrant starts), writes its fields and row and its id as
//      its children's parent, and differences the prefix sums over its
//      range; slots past n_nodes get the plain path's empty row.
//   No (L, cap) array is made, nothing is zeroed first, and nothing syncs
//   with the host. Dead slots sort last under a code that no live prefix
//   matches, so every search may run to cap and stops at them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COORD_BITS = 15;
constexpr int MAX_COORD = (1 << COORD_BITS) - 1;
constexpr int DEAD_CODE = 1 << (2 * COORD_BITS);
constexpr int LEVELS = COORD_BITS + 1;     // levels 0 .. 15
constexpr int CODE_THREADS = 256;
constexpr int THREADS = 256;               // a CTA of tree_kernel
constexpr int BLOCKS_PER_SM = 4;           // its registers' budget
constexpr int WARPS = THREADS / 32;
constexpr int ROW = 14;                    // floats a node row
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  float ox, oy;    // root low corner, float32
  float scale;     // 2^15 / side, float32: the cell-coordinate multiply
  float unit;      // side / 2^15: a finest cell's side
  float side;      // the root's side
};

// morton.cell_coords for one coordinate: the subtraction and the multiply
// rounded alone, floor, torch's float-to-int32 cast on the card
// (saturating, NaN to 0), clamped to the grid.
__device__ __forceinline__ int coord(float p, float o, float scale) {
  const int v = (int)floorf(__fmul_rn(__fsub_rn(p, o), scale));
  return min(max(v, 0), MAX_COORD);
}

// morton.hilbert2d: the same int32 operations in the same order.
__device__ __forceinline__ int hilbert(int x, int y) {
  int d = 0;
#pragma unroll
  for (int i = 0; i < COORD_BITS; ++i) {
    const int s = 1 << (COORD_BITS - 1 - i);
    const int rx = (x & s) > 0;
    const int ry = (y & s) > 0;
    d += s * s * ((3 * rx) ^ ry);
    if (ry == 0) {
      if (rx == 1) {
        x = s - 1 - x;
        y = s - 1 - y;
      }
      const int tmp = x;
      x = y;
      y = tmp;
    }
  }
  return d;
}

__global__ void __launch_bounds__(CODE_THREADS)
    codes_kernel(const float2* __restrict__ pos,
                 const unsigned char* __restrict__ alive, int n, Geo g,
                 int* __restrict__ codes) {
  const int i = blockIdx.x * CODE_THREADS + threadIdx.x;
  if (i >= n) return;
  if (!alive[i]) {
    codes[i] = DEAD_CODE;
    return;
  }
  const float2 p = pos[i];
  codes[i] = hilbert(coord(p.x, g.ox, g.scale), coord(p.y, g.oy, g.scale));
}

// First j in [lo, hi) with a[j] >= v (hi if none) in a sorted array,
// galloping from lo: O(log(j - lo)) reads.
__device__ __forceinline__ int gallop_up(const int* a, int lo, int hi,
                                         int v) {
  if (lo >= hi || a[lo] >= v) return lo;
  int good = lo, bad, step = 1;            // a[good] < v
  while (true) {
    const int probe = good + step;
    if (probe >= hi) {
      bad = hi;
      break;
    }
    if (a[probe] >= v) {
      bad = probe;
      break;
    }
    good = probe;
    step <<= 1;
  }
  while (bad - good > 1) {                 // a[bad] >= v or bad == hi
    const int mid = good + ((bad - good) >> 1);
    if (a[mid] >= v) bad = mid;
    else good = mid;
  }
  return bad;
}

// First j in [lo, hi) with a[j] >= v (hi if none) in a sorted array, by
// bisection.
__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi,
                                           int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First j in [lo, hi) with a[j] >= v, given a[hi - 1] >= v, galloping
// down from hi - 1.
__device__ __forceinline__ int gallop_down(const int* a, int lo, int hi,
                                           int v) {
  int bad = hi - 1, good, step = 1;        // a[bad] >= v
  while (true) {
    const int probe = bad - step;
    if (probe < lo) {
      good = lo - 1;
      break;
    }
    if (a[probe] < v) {
      good = probe;
      break;
    }
    bad = probe;
    step <<= 1;
  }
  while (bad - good > 1) {
    const int mid = good + ((bad - good) >> 1);
    if (a[mid] >= v) bad = mid;
    else good = mid;
  }
  return bad;
}

// The shallowest level at which two codes' cells differ (x their xor,
// not 0): 15 - (highest set bit) / 2.
__device__ __forceinline__ int split_level(int x) {
  return COORD_BITS - ((31 - __clz(x)) >> 1);
}

// The levels at which sorted body i owns a node, as a mask of bits f .. d
// (0: none). f is the shallowest level at which i starts a cell (from its
// predecessor's code); that cell is a node iff its parent holds more than
// leaf bodies (the root always), which a search of at most leaf bodies
// back for the parent's first body and one code leaf bodies after it
// decide. Each cell of i below is a node while the one above holds more
// than leaf bodies, i.e. while it holds body i + leaf: its levels come
// from one more code, i + leaf's.
__device__ __forceinline__ unsigned owned_levels(const int* sc, int i,
                                                 int cap, int leaf,
                                                 int max_depth) {
  const int c = sc[i];
  if (c == DEAD_CODE) return 0u;
  int f = 0;
  if (i > 0) {
    const int x = c ^ sc[i - 1];
    if (x == 0) return 0u;                 // never starts a cell
    f = split_level(x);
  }
  if (f > max_depth) return 0u;
  if (f > 0) {
    const int sh = 2 * (COORD_BITS + 1 - f);   // level f - 1
    const int p = c >> sh;
    const int lo = max(0, i - leaf);
    const int ps = gallop_down(sc, lo, i + 1, p << sh);
    if (ps > lo || lo == 0) {              // the parent's first body
      const int k = ps + leaf;
      if (k >= cap || (sc[k] >> sh) != p) return 0u;
    }                                      // else it starts by i - leaf
  }
  int split = 0;                           // i + leaf leaves every cell
  if (i + leaf < cap) {
    const int y = c ^ sc[i + leaf];
    split = y ? split_level(y) : LEVELS;
  }
  const int d = max(f, min(split, max_depth));
  return (2u << d) - (1u << f);
}

// Occupied children of the internal cell [i, e) at level l (prefix pre =
// code >> sh): the distinct starts of its four quadrants inside it.
__device__ __forceinline__ int children(const int* sc, int i, int e,
                                        int pre, int sh) {
  const int sh1 = sh - 2;
  const int q0 = (sc[i] >> sh1) & 3;
  int k = 1, last = i;
  for (int q = q0 + 1; q < 4; ++q) {
    const int b = lower_bound(sc, last, e, ((pre << 2) | q) << sh1);
    if (b < e && b != last) ++k;
    last = b;
  }
  return k;
}

// The centre and side of the level cell of shift (15 - level) holding grid
// coordinates (gx, gy): build_tree_ref's cell(), each operation rounded
// alone.
__device__ __forceinline__ void cell(int gx, int gy, int shift, const Geo& g,
                                     float* out) {
  const float units = (float)(1 << shift);
  const float half = __fmul_rn(0.5f, units);
  out[0] = __fadd_rn(g.ox, __fmul_rn(__fadd_rn(
                                         (float)((gx >> shift) << shift),
                                         half), g.unit));
  out[1] = __fadd_rn(g.oy, __fmul_rn(__fadd_rn(
                                         (float)((gy >> shift) << shift),
                                         half), g.unit));
  out[2] = __fmul_rn(units, g.unit);
}

struct Args {
  const float2* pos;
  const float* mass;
  const int* codes;
  const long long* order;
  int cap, nc, leaf, max_depth;
  Geo g;
  // scratch
  double* csum;          // 3 x (cap + 1): mass, x, y terms' prefix sums
  double* bsum;          // 3 a CTA: its chunk's sums
  int* sc;               // cap sorted codes
  int* bcnt;             // LEVELS a CTA: its owners a level
  unsigned short* span;  // cap owned-level masks
  // outputs
  int* code;
  int* level;
  int* start;
  int* count;
  int* child;
  int* nchild;
  int* parent;
  float* mass_out;
  float2* com;
  float* rows;
  float4* body_rows;
  float2* spos;
  float* smass;
  int* sidx;
  int* unsort;
  int* scalars;          // n_nodes, node_need, n_alive
  float* geo;            // origin x, origin y, root side
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The nodes sorted body i owns (levels f .. d of span), ids from the
// CTA's ranks: each node's first body, level and first child (the node i
// owns a level below, or -1); step 3 fills in the rest.
__device__ __forceinline__ void record_nodes(const Args& a, int i,
                                             unsigned span, const int* base,
                                             const int* wpre,
                                             const unsigned* ball,
                                             unsigned below) {
  const int f = __ffs(span) - 1;
  const int d = 31 - __clz(span);
  int id = base[f] + wpre[f] + __popc(ball[f] & below);
  for (int l = f; l <= d; ++l) {
    const int next =
        l < d ? base[l + 1] + wpre[l + 1] + __popc(ball[l + 1] & below) : -1;
    if (id < a.nc) {
      a.start[id] = i;
      a.level[id] = l;
      a.child[id] = next;
    }
    id = next;
  }
}

// Node s of level l with first body i and first child first (-1: a
// leaf): its code, count, occupied children and row but the first three
// columns, and its id as its children's parent.
__device__ __forceinline__ int finish_node(const Args& a, int s, int i,
                                           int l, int first) {
  const int c = a.sc[i];
  const int sh = 2 * (COORD_BITS - l);
  const int pre = c >> sh;
  const int e = gallop_up(a.sc, i + 1, a.cap, (pre + 1) << sh);
  const int k = first >= 0 ? children(a.sc, i, e, pre, sh) : 0;
  for (int j = 0; j < k && first + j < a.nc; ++j) a.parent[first + j] = s;
  if (s == 0) a.parent[0] = -1;            // the root
  a.code[s] = pre << sh;
  a.count[s] = e - i;
  a.nchild[s] = k;
  const float2 p = a.spos[i];
  const int gx = coord(p.x, a.g.ox, a.g.scale);
  const int gy = coord(p.y, a.g.oy, a.g.scale);
  float g[3], pg[3] = {0.0f, 0.0f, 0.0f};
  const int shift = COORD_BITS - l;
  cell(gx, gy, shift, a.g, g);
  if (l > 0) cell(gx, gy, min(shift + 1, COORD_BITS), a.g, pg);
  float* row = a.rows + (long long)s * ROW;
  row[3] = g[0];
  row[4] = g[1];
  row[5] = g[2];
  row[6] = (float)first;
  row[7] = (float)k;
  row[8] = (float)i;
  row[9] = (float)(e - i);
  row[10] = pg[0];
  row[11] = pg[1];
  row[12] = pg[2];
  row[13] = l > 0 ? 1.0f : 0.0f;
  return e;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) tree_kernel(Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int cap = a.cap;
  const int gtid = b * THREADS + t;
  const int gstride = G * THREADS;

  // 0. permute
  for (int i = gtid; i < cap; i += gstride) {
    const int o = (int)a.order[i];
    const int c = a.codes[o];
    const bool live = c != DEAD_CODE;
    const float2 p = a.pos[o];
    const float m = live ? a.mass[o] : 0.0f;
    a.sc[i] = c;
    a.spos[i] = p;
    a.smass[i] = m;
    a.body_rows[i] = make_float4(p.x, p.y, m, 0.0f);
    a.sidx[i] = o;
    a.unsort[o] = i;
  }
  if (gtid == 0) {
    a.geo[0] = a.g.ox;
    a.geo[1] = a.g.oy;
    a.geo[2] = a.g.side;
  }
  grid.sync();

  // 1. owned levels; the CTA's owners a level and its mass-term sums.
  // Dead slots sort last with a code no live prefix matches, so every
  // search may run to cap: it stops at the first dead slot.
  const int chunk = (cap + G - 1) / G;
  const int lo = min(cap, b * chunk);
  const int hi = min(cap, lo + chunk);
  __shared__ int s_cnt[LEVELS];
  __shared__ double s_red[WARPS][3];
  if (t < LEVELS) s_cnt[t] = 0;
  __syncthreads();
  double sm = 0.0, sx = 0.0, sy = 0.0;
  for (int base = lo; base < hi; base += THREADS) {
    const int i = base + t;
    unsigned span = 0u;
    if (i < hi) {
      const bool live = a.sc[i] != DEAD_CODE;
      if (live ? i + 1 == cap || a.sc[i + 1] == DEAD_CODE : i == 0)
        a.scalars[2] = live ? i + 1 : 0;  // n_alive, at the border
      span = owned_levels(a.sc, i, cap, a.leaf, a.max_depth);
      a.span[i] = (unsigned short)span;
      if (live) {
        const float m = a.smass[i];
        const float2 p = a.spos[i];
        sm += (double)m;
        sx += (double)__fmul_rn(m, p.x);
        sy += (double)__fmul_rn(m, p.y);
      }
    }
    for (int l = 0; l < LEVELS; ++l) {
      const unsigned bal = __ballot_sync(FULL, (span >> l) & 1u);
      if (lane == 0 && bal) atomicAdd(&s_cnt[l], __popc(bal));
    }
  }
  sm = warp_sum(sm);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  if (lane == 0) {
    s_red[w][0] = sm;
    s_red[w][1] = sx;
    s_red[w][2] = sy;
  }
  __syncthreads();
  if (t < 3) {
    double v = 0.0;
    for (int k = 0; k < WARPS; ++k) v += s_red[k][t];
    a.bsum[3 * b + t] = v;
  } else if (t >= 32 && t < 32 + LEVELS) {
    a.bcnt[b * LEVELS + t - 32] = s_cnt[t - 32];
  }
  grid.sync();

  // 2. ranks, node fields, prefix sums
  __shared__ int s_base[LEVELS];       // id of the next owner a level
  __shared__ int s_cum[LEVELS + 1];    // nodes of the shallower levels
  __shared__ double s_run[3];          // prefix sums before the tile
  __shared__ unsigned s_ball[WARPS][LEVELS];
  __shared__ int s_wpre[WARPS][LEVELS];
  __shared__ int s_tile[LEVELS];
  __shared__ double s_wsum[WARPS][3];
  __shared__ double s_wpre_d[WARPS][3];
  __shared__ double s_tile_d[3];
  for (int l = w; l < LEVELS; l += WARPS) {
    int before = 0, all = 0;
    for (int k = lane; k < G; k += 32) {
      const int v = a.bcnt[k * LEVELS + l];
      all += v;
      if (k < b) before += v;
    }
    before = warp_sum(before);
    all = warp_sum(all);
    if (lane == 0) {
      s_base[l] = before;
      s_cum[l] = all;
    }
  }
  if (w == 0) {
    double pm = 0.0, px = 0.0, py = 0.0;
    for (int k = lane; k < b; k += 32) {
      pm += a.bsum[3 * k];
      px += a.bsum[3 * k + 1];
      py += a.bsum[3 * k + 2];
    }
    pm = warp_sum(pm);
    px = warp_sum(px);
    py = warp_sum(py);
    if (lane == 0) {
      s_run[0] = pm;
      s_run[1] = px;
      s_run[2] = py;
    }
  }
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int l = 0; l < LEVELS; ++l) {
      const int n = s_cum[l];
      s_cum[l] = run;
      run += n;
    }
    s_cum[LEVELS] = run;
  }
  __syncthreads();
  if (t < LEVELS) s_base[t] += s_cum[t];
  const int need = s_cum[LEVELS];
  const int n_nodes = min(need, a.nc);
  if (gtid == 0) {
    a.scalars[0] = n_nodes;
    a.scalars[1] = need;
  }
  const unsigned below = (1u << lane) - 1u;
  double* cm = a.csum;
  double* cx = a.csum + (cap + 1);
  double* cy = a.csum + 2 * (cap + 1);
  __syncthreads();
  for (int base = lo; base < hi; base += THREADS) {
    const int i = base + t;
    const bool in = i < hi;
    const unsigned span = in ? (unsigned)a.span[i] : 0u;
    for (int l = 0; l < LEVELS; ++l) {
      const unsigned bal = __ballot_sync(FULL, (span >> l) & 1u);
      if (lane == 0) s_ball[w][l] = bal;
    }
    double im = 0.0, ix = 0.0, iy = 0.0;
    if (in && a.sc[i] != DEAD_CODE) {
      const float m = a.smass[i];
      const float2 p = a.spos[i];
      im = (double)m;
      ix = (double)__fmul_rn(m, p.x);
      iy = (double)__fmul_rn(m, p.y);
    }
    for (int o = 1; o < 32; o <<= 1) {    // the warp's inclusive sums
      const double vm = __shfl_up_sync(FULL, im, o);
      const double vx = __shfl_up_sync(FULL, ix, o);
      const double vy = __shfl_up_sync(FULL, iy, o);
      if (lane >= o) {
        im += vm;
        ix += vx;
        iy += vy;
      }
    }
    double em = __shfl_up_sync(FULL, im, 1);
    double ex = __shfl_up_sync(FULL, ix, 1);
    double ey = __shfl_up_sync(FULL, iy, 1);
    if (lane == 0) em = ex = ey = 0.0;
    if (lane == 31) {
      s_wsum[w][0] = im;
      s_wsum[w][1] = ix;
      s_wsum[w][2] = iy;
    }
    __syncthreads();
    if (t < LEVELS) {
      int run = 0;
      for (int k = 0; k < WARPS; ++k) {
        s_wpre[k][t] = run;
        run += __popc(s_ball[k][t]);
      }
      s_tile[t] = run;
    } else if (t >= 32 && t < 35) {
      const int q = t - 32;
      double run = s_run[q];
      for (int k = 0; k < WARPS; ++k) {
        s_wpre_d[k][q] = run;
        run += s_wsum[k][q];
      }
      s_tile_d[q] = run;
    }
    __syncthreads();
    if (in) {
      cm[i] = s_wpre_d[w][0] + em;
      cx[i] = s_wpre_d[w][1] + ex;
      cy[i] = s_wpre_d[w][2] + ey;
      if (i == cap - 1) {
        cm[cap] = s_wpre_d[w][0] + im;
        cx[cap] = s_wpre_d[w][1] + ix;
        cy[cap] = s_wpre_d[w][2] + iy;
      }
    }
    if (span)
      record_nodes(a, i, span, s_base, &s_wpre[w][0], &s_ball[w][0], below);
    __syncthreads();
    if (t < LEVELS) s_base[t] += s_tile[t];
    else if (t >= 32 && t < 35) s_run[t - 32] = s_tile_d[t - 32];
    __syncthreads();
  }
  grid.sync();

  // 3. the nodes in use, their aggregates; the empty rows past them
  for (int s = gtid; s < a.nc; s += gstride) {
    float* row = a.rows + (long long)s * ROW;
    if (s < n_nodes) {
      const int s0 = a.start[s];
      const int e = finish_node(a, s, s0, a.level[s], a.child[s]);
      const float m = (float)(cm[e] - cm[s0]);
      const float mx = (float)(cx[e] - cx[s0]);
      const float my = (float)(cy[e] - cy[s0]);
      const float safe = m < 1e-30f ? 1e-30f : m;  // clamp; NaN stays
      const float2 com = make_float2(mx / safe, my / safe);
      a.mass_out[s] = m;
      a.com[s] = com;
      row[0] = m;
      row[1] = com.x;
      row[2] = com.y;
    } else {
      a.code[s] = 0;
      a.level[s] = 0;
      a.start[s] = 0;
      a.count[s] = 0;
      a.child[s] = -1;
      a.nchild[s] = 0;
      a.parent[s] = -1;
      a.mass_out[s] = 0.0f;
      a.com[s] = make_float2(0.0f, 0.0f);
      for (int k = 0; k < ROW; ++k) row[k] = k == 6 ? -1.0f : 0.0f;
    }
  }
}

struct Scratch {
  double* csum;
  double* bsum;
  int* sc;
  int* bcnt;
  unsigned short* span;
  long long bytes;
};

// The scratch layout (ops/tree.py::_tree_scratch computes the same size).
Scratch carve(void* base, int cap, int grid) {
  Scratch s;
  char* p = static_cast<char*>(base);
  long long off = 0;
  s.csum = reinterpret_cast<double*>(p + off);
  off += 8LL * 3 * (cap + 1);
  s.bsum = reinterpret_cast<double*>(p + off);
  off += 8LL * 3 * grid;
  s.sc = reinterpret_cast<int*>(p + off);
  off += 4LL * cap;
  s.bcnt = reinterpret_cast<int*>(p + off);
  off += 4LL * LEVELS * grid;
  s.span = reinterpret_cast<unsigned short*>(p + off);
  off += 2LL * cap;
  s.bytes = off;
  return s;
}

}  // namespace

// codes (n) of the bodies pos (n, 2) and alive (n) on the root low corner
// (ox, oy) with the cell-coordinate multiply scale: morton.hilbert_codes,
// DEAD_CODE for dead slots.
extern "C" int tnt_bh_codes(const float* pos, const unsigned char* alive,
                            int n, float ox, float oy, float scale,
                            int* codes, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Geo g{ox, oy, scale, 0.0f, 0.0f};
  codes_kernel<<<(n + CODE_THREADS - 1) / CODE_THREADS, CODE_THREADS, 0,
                 stream>>>(reinterpret_cast<const float2*>(pos), alive, n, g,
                           codes);
  return (int)cudaGetLastError();
}

// CTAs of the build one SM holds at once (0 on error); the wrapper asks
// once a device.
extern "C" int tnt_bh_tree_blocks_per_sm() {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tree_kernel, THREADS,
                                                    0);
  return e == cudaSuccess ? n : 0;
}

// The tree of cap bodies from their codes and the stable sort's order, in
// one cooperative launch of grid CTAs (at most what the card holds at
// once: ops/tree.py::_tree_grid). outs: code, level, start, count, child,
// n_children, parent (nc int32 each), mass (nc), com (nc, 2), node rows
// (nc, 14), body rows (cap, 4), spos (cap, 2), smass (cap) (float32),
// sidx, unsort (cap int32), scalars (n_nodes, node_need, n_alive int32),
// geo (origin x, y, root side float32).
extern "C" int tnt_bh_tree(const float* pos, const float* mass,
                           const int* codes, const long long* order, int cap,
                           int nc, int leaf_size, int max_depth, float ox,
                           float oy, float scale, float unit, float side,
                           int grid, void* scratch, long long scratch_bytes,
                           void** outs, cudaStream_t stream) {
  const Scratch s = carve(scratch, cap, grid);
  if (cap <= 0 || nc < 0 || grid < 1 || max_depth < 0 ||
      max_depth >= LEVELS || scratch_bytes < s.bytes)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pos = reinterpret_cast<const float2*>(pos);
  a.mass = mass;
  a.codes = codes;
  a.order = order;
  a.cap = cap;
  a.nc = nc;
  a.leaf = leaf_size;
  a.max_depth = max_depth;
  a.g = Geo{ox, oy, scale, unit, side};
  a.csum = s.csum;
  a.bsum = s.bsum;
  a.sc = s.sc;
  a.bcnt = s.bcnt;
  a.span = s.span;
  a.code = static_cast<int*>(outs[0]);
  a.level = static_cast<int*>(outs[1]);
  a.start = static_cast<int*>(outs[2]);
  a.count = static_cast<int*>(outs[3]);
  a.child = static_cast<int*>(outs[4]);
  a.nchild = static_cast<int*>(outs[5]);
  a.parent = static_cast<int*>(outs[6]);
  a.mass_out = static_cast<float*>(outs[7]);
  a.com = static_cast<float2*>(outs[8]);
  a.rows = static_cast<float*>(outs[9]);
  a.body_rows = static_cast<float4*>(outs[10]);
  a.spos = static_cast<float2*>(outs[11]);
  a.smass = static_cast<float*>(outs[12]);
  a.sidx = static_cast<int*>(outs[13]);
  a.unsort = static_cast<int*>(outs[14]);
  a.scalars = static_cast<int*>(outs[15]);
  a.geo = static_cast<float*>(outs[16]);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)tree_kernel, grid,
                                          THREADS, args, 0, stream);
}
