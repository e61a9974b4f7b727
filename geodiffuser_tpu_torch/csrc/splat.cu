// Fused soft-z-buffer point splat for Hopper (sm_90a), as a deterministic
// gather.
//
// Replaces geodiffuser_tpu/kernels/splat.py: splat_image_fused (_splat_kernel).
//
//   l[o, s] = log alpha(o, s) - z_beta * z[s]    on the 2x2 floor corners of s
//   out[o]  = softmax_s(l[o, :]) v * (1 - exp(sum_s log1p(-clip(alpha(o, s)))))
//
// with alpha = (1 - sqrt(clip(d^2 / r^2, 0, 1)))^tau, valid where alpha > 1e-6,
// and 0 in a cell that no corner reaches.
//
// What bounds it on the H100: each point reaches at most 4 cells, so the work
// is a few dozen operations per point against 12 + 4C bytes of input and 4C
// of output, a few MB at the stitch's 512^2: no product for the tensor
// cores, and far too little traffic to fill the memory system.  The latency
// of a handful of dependent passes, and the scattered reads of a gather,
// bound it.
//
// Design: the Pallas grid scanned every output block against every source
// block, a dense O(N_out * N) product of mostly masked pairs, summed in grid
// order.  Here the points are binned by their base cell (floor x, floor y) on
// a grid padded by one row and column at the low edge, and each output cell
// gathers from the four base cells whose corners reach it, all in one
// cooperative launch with grid-wide syncs between the phases:
//   1. count: per point, its 4 corners' logits and log-miss terms (the only
//      powf / logf / log1pf), and, if one is valid, a place in its base
//      cell's segment (one integer atomicAdd per cell a warp's points share);
//   2. scan: exclusive prefix sum of the counts, per 1024-count tile, then
//      of the tiles' totals by one block; segments longer than LONG_SEG are
//      listed with their chunks of SORT_TILE;
//   3. fill: each binned point's index into its place;
//   4. order: every segment sorted by point index, whatever order the places
//      were taken in: in a short segment a point's slot is the count of
//      smaller indices there; a long one's chunks are sorted in shared
//      memory (bitonic, a block each), then merged pairwise, a grid sync
//      between merge passes and a block per SORT_TILE outputs (merge path):
//      a bin of L points costs O(L log L) spread over the grid, not L^2.
//      The output cells reached by more than HEAVY points are listed;
//   5. gather: per output cell, the four base cells in a fixed order and the
//      points of each in ascending index, in one pass with a running max:
//      the sums of exp(l - max) v, exp(l - max) and the log-miss term, then
//      num / den * coverage.  A listed cell's visits are cut into tasks of
//      HEAVY_TILE instead, a warp each: each lane a fixed share of the
//      task's visits, the partial sums merged by a fixed tree of shuffles;
//   6. (only when a cell was listed) each listed cell's task sums merged in
//      a fixed order, a warp a cell.
// No float atomics: every sum runs in a fixed order, so two launches on the
// same inputs give equal bits.  The corner arithmetic uses the _rn
// intrinsics (no FMA contraction), bucketing corners by the same float32
// floor as the plain version and the JAX kernel.
#include "common.cuh"

#include <cooperative_groups.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int SPLAT_NT = 256;                       // threads a block, every phase
constexpr int SCAN_ITEMS = 4;                       // counts a thread scans
constexpr int SCAN_SHIFT = 10;                      // log2 of the counts a block scans
static_assert(SPLAT_NT * SCAN_ITEMS == 1 << SCAN_SHIFT, "scan tile");
constexpr int CH = 4;                               // channels a gather pass keeps in registers
constexpr float MISS_CLIP = (float)(1.0 - 1e-4);   // clip(alpha, 0, 1 - 1e-4)
constexpr int LONG_SEG = 32;    // a longer segment is sorted in chunks and merges
constexpr int HEAVY = 128;      // a cell reached by more points is gathered by warps
static_assert(4 * LONG_SEG <= HEAVY, "a cell with no long segment in reach is not heavy");
constexpr int SORT_TILE = 2048; // indices a block sorts in shared memory at once
constexpr int HEAVY_TILE = 256; // visits of a heavy cell a warp sums at once

struct Point {
  float x, y, z;
};

// Target position of point p in output pixels: (c + 1) * 0.5 * (size - 1).
__device__ __forceinline__ Point load_point(const float* coords, int p, int oh, int ow) {
  const float* c = coords + (size_t)p * 3;
  Point pt;
  pt.x = __fmul_rn(__fmul_rn(__fadd_rn(c[0], 1.f), 0.5f), (float)(ow - 1));
  pt.y = __fmul_rn(__fmul_rn(__fadd_rn(c[1], 1.f), 0.5f), (float)(oh - 1));
  pt.z = c[2];
  return pt;
}

// Corner k (x offset k & 1, y offset k >> 1) of a point: false when it lies
// off the output grid or its alpha is <= 1e-6; else its alpha and logit.
__device__ __forceinline__ bool corner(const Point& pt, int k, int oh, int ow, float r2, float tau,
                                       float z_beta, float& alpha, float& logit) {
  const float cx = __fadd_rn(floorf(pt.x), (float)(k & 1));
  const float cy = __fadd_rn(floorf(pt.y), (float)(k >> 1));
  if (!(cx >= 0.f && cx < (float)ow && cy >= 0.f && cy < (float)oh)) return false;
  const float dx = __fsub_rn(cx, pt.x), dy = __fsub_rn(cy, pt.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float q = fminf(fmaxf(__fdiv_rn(d2, r2), 0.f), 1.f);
  const float a = powf(__fsub_rn(1.f, __fsqrt_rn(q)), tau);
  if (!(a > 1e-6f)) return false;
  alpha = a;
  logit = __fsub_rn(logf(fmaxf(a, 1e-30f)), __fmul_rn(z_beta, pt.z));
  return true;
}

// Sums of a cell's visits so far: the running max of the logits, the sums
// of exp(l - max) and of the log-miss terms, and of exp(l - max) v per channel.
struct Acc {
  float m, den, miss, num[CH];
};

// Buffers and sizes of one call.  The base-cell grid is (oh + 1) x (ow + 1):
// base cell (bx, by), bx in [-1, ow - 1], by in [-1, oh - 1], has index
// (by + 1) * (ow + 1) + bx + 1; its segment holds the binned points whose
// base cell it is.
struct Splat {
  const float* src;     // (n, C)
  const float* coords;  // (n, 3)
  float* out;           // (oh * ow, C)
  float2* corners;      // (n, 4): each corner's logit and log-miss term
  int* loc;             // cells + 1: counts, then exclusive offsets within their tile
  unsigned long long* longs;   // long segments listed << 32 | their chunks of SORT_TILE
  unsigned long long* heavies; // heavy cells listed << 32 | their tasks of HEAVY_TILE
  int* most_chunks;     // the most chunks of a long segment
  int* tot;             // tiles: tile totals, then the tiles' exclusive offsets
  int* pcell;           // n: a point's base cell, -1 if none of its corners is valid
  int* prank;           // n: its place in the segment, in the order the places were taken
  int* slots;           // n: kept points by segment, unordered within one
  int* order;           // n: kept points by segment, ascending within one
  int* list;            // n: from the front, each long segment and its first chunk's
                        // number; from the back, each heavy cell and its first task's
  Acc* part;            // heavy tasks x channel groups: the tasks' partial sums
  int n, oh, ow, C, cells, tiles;
  float r2, tau, z_beta;
};

// log-miss term stored for an invalid corner: a valid one's is <= 0
constexpr float NO_CORNER = 1.f;

// Offset of base cell c's segment (c == cells gives the end of the last).
__device__ __forceinline__ int seg_start(const Splat& P, int c) {
  return P.loc[c] + P.tot[c >> SCAN_SHIFT];
}

// Exclusive prefix sum of v over the block, and the block's total.  Every
// thread of the block must call it.
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sum[SPLAT_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < SPLAT_NT / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < SPLAT_NT / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sum[warp - 1] : 0;
  total = warp_sum[SPLAT_NT / 32 - 1];
  __syncthreads();   // warp_sum is free for the next call
  return before + incl - v;
}

// Phase 1.  t0 / nt: this thread's first index and the stride of a
// grid-stride loop (a multiple of 32).  The only powf / logf / log1pf of the
// splat: each corner's logit and log-miss term, NO_CORNER where it is
// invalid.  The lanes of a warp whose points share a base cell take their
// places with one atomicAdd.
__device__ void count_points(const Splat& P, int t0, int nt) {
  const int lane = threadIdx.x & 31;
  for (int p0 = t0 - lane; p0 < P.n; p0 += nt) {   // every lane runs every iteration
    const int p = p0 + lane;
    int cell = -1;
    if (p < P.n) {
      const Point pt = load_point(P.coords, p, P.oh, P.ow);
      float lg[4], lm[4];
      bool keep = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float alpha;
        if (corner(pt, k, P.oh, P.ow, P.r2, P.tau, P.z_beta, alpha, lg[k])) {
          lm[k] = log1pf(-fminf(alpha, MISS_CLIP));
          keep = true;
        } else {
          lg[k] = -INFINITY;
          lm[k] = NO_CORNER;
        }
      }
      if (keep) {   // a valid corner puts floor(x) in [-1, ow - 1] and floor(y) in [-1, oh - 1]
        float4* dst = reinterpret_cast<float4*>(P.corners + (size_t)p * 4);
        dst[0] = make_float4(lg[0], lm[0], lg[1], lm[1]);
        dst[1] = make_float4(lg[2], lm[2], lg[3], lm[3]);
        cell = ((int)floorf(pt.y) + 1) * (P.ow + 1) + (int)floorf(pt.x) + 1;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (cell >= 0 && lane == leader) base = atomicAdd(P.loc + cell, __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (cell >= 0) P.prank[p] = base + __popc(peers & ((1u << lane) - 1));
    if (p < P.n) P.pcell[p] = cell;
  }
}

// Phase 2a: tiles b0, b0 + nb, ... of the counts, one block each; the
// segments longer than LONG_SEG are listed for phase 4 (at most
// n / LONG_SEG), each with the number of its first chunk: one atomicAdd
// takes both, so the first chunks ascend along the list.
__device__ void scan_tiles(const Splat& P, int b0, int nb) {
  const int len = P.cells + 1;
  for (int t = b0; t < P.tiles; t += nb) {
    const int i0 = (t << SCAN_SHIFT) + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = i0 + j < len ? P.loc[i0 + j] : 0;
      sum += v[j];
      if (v[j] > LONG_SEG) {
        const unsigned chunks = (v[j] + SORT_TILE - 1) / SORT_TILE;
        const unsigned long long r = atomicAdd(P.longs, (1ull << 32) | chunks);
        P.list[2 * (r >> 32)] = i0 + j;
        P.list[2 * (r >> 32) + 1] = (int)(unsigned)r;
        atomicMax(P.most_chunks, (int)chunks);
      }
    }
    int total;
    int run = block_exclusive_scan(sum, total);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (i0 + j < len) P.loc[i0 + j] = run;
      run += v[j];
    }
    if (threadIdx.x == 0) P.tot[t] = total;
  }
}

// Phase 2b: the tiles' totals, by one block.  Other blocks wrote them:
// read them from L2.
__device__ void scan_totals(const Splat& P) {
  int carry = 0;
  for (int i0 = 0; i0 < P.tiles; i0 += SPLAT_NT) {
    const int i = i0 + threadIdx.x;
    const int v = i < P.tiles ? __ldcg(P.tot + i) : 0;
    int total;
    const int x = block_exclusive_scan(v, total);
    if (i < P.tiles) P.tot[i] = carry + x;
    carry += total;
  }
}

// Phase 3.
__device__ void fill_slots(const Splat& P, int t0, int nt) {
  for (int p = t0; p < P.n; p += nt) {
    const int c = P.pcell[p];
    if (c >= 0) P.slots[seg_start(P, c) + P.prank[p]] = p;
  }
}

// Phase 4, short segments: a point's place in its segment is the count of
// smaller indices there (indices are distinct), at most LONG_SEG reads.
__device__ void order_points(const Splat& P, int t0, int nt) {
  for (int p = t0; p < P.n; p += nt) {
    const int c = P.pcell[p];
    if (c < 0) continue;
    const int s = seg_start(P, c), e = seg_start(P, c + 1);
    if (e - s > LONG_SEG) continue;
    int rank = 0;
    for (int j = s; j < e; ++j) rank += P.slots[j] < p;
    P.order[s + rank] = p;
  }
}

// Ascending bitonic sort of sh[0, n), n a power of two, by the block.
__device__ void bitonic_sort(int* sh, int n) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += SPLAT_NT) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = sh[i], b = sh[ixj];
          if ((a > b) == ((i & k) == 0)) {
            sh[i] = b;
            sh[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
}

// Outputs [d0, d1) of the merge of the ascending runs a[0, la) and
// b[0, lb) (distinct values) into out, by the block: each thread writes an
// equal share, its start in a and b found by a binary search along the
// merge path.  The runs were written by other blocks after this SM may have
// cached the same lines in an earlier pass: read them from L2.
__device__ void block_merge(const int* a, int la, const int* b, int lb, int d0, int d1, int* out) {
  const int lo = d0 + (int)((long long)(d1 - d0) * threadIdx.x / SPLAT_NT);
  const int hi = d0 + (int)((long long)(d1 - d0) * (threadIdx.x + 1) / SPLAT_NT);
  int i0 = max(0, lo - lb), i1 = min(lo, la);
  while (i0 < i1) {   // i0: the elements of a among out[0, lo)
    const int mid = (i0 + i1) >> 1;
    if (__ldcg(a + mid) < __ldcg(b + lo - 1 - mid))
      i0 = mid + 1;
    else
      i1 = mid;
  }
  int i = i0, j = lo - i0;
  int ai = i < la ? __ldcg(a + i) : INT_MAX, bj = j < lb ? __ldcg(b + j) : INT_MAX;
  for (int k = lo; k < hi; ++k) {
    if (ai < bj) {
      out[k] = ai;
      ai = ++i < la ? __ldcg(a + i) : INT_MAX;
    } else {
      out[k] = bj;
      bj = ++j < lb ? __ldcg(b + j) : INT_MAX;
    }
  }
}

// Merge passes that sort `chunks` sorted chunks: ceil(log2(chunks)).
__device__ __forceinline__ int merge_passes(int chunks) {
  int q = 0;
  while ((1 << q) < chunks) ++q;
  return q;
}

// One chunk of SORT_TILE of a long segment: chunk task t of all the long
// segments' chunks, numbered segment by segment along the list.
struct Chunk {
  int s, L;   // the segment's slots [s, s + L)
  int c0;     // the chunk's first slot in the segment
  int passes; // merge passes of the segment
  int* b0;    // the buffer its chunks are sorted into (order after `passes` passes)
  int* b1;    // the other
};

__device__ Chunk chunk_task(const Splat& P, int nlong, int t) {
  int lo = 0, hi = nlong - 1;
  while (lo < hi) {   // the last segment whose first chunk is <= t
    const int mid = (lo + hi + 1) >> 1;
    if (__ldcg(P.list + 2 * mid + 1) <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int c = __ldcg(P.list + 2 * lo);
  Chunk k;
  k.s = seg_start(P, c);
  k.L = seg_start(P, c + 1) - k.s;
  k.c0 = (t - __ldcg(P.list + 2 * lo + 1)) * SORT_TILE;
  k.passes = merge_passes((k.L + SORT_TILE - 1) / SORT_TILE);
  k.b0 = (k.passes & 1 ? P.slots : P.order) + k.s;
  k.b1 = (k.passes & 1 ? P.order : P.slots) + k.s;
  return k;
}

// Phase 4, long segments: each chunk task sorts its chunk of slots into
// b0, a block each.  Every thread of the block must call it.
__device__ void sort_chunks(const Splat& P, int* sh) {
  const unsigned long long longs = __ldcg(P.longs);
  const int nlong = (int)(longs >> 32), tasks = (int)(unsigned)longs;
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const Chunk k = chunk_task(P, nlong, t);
    const int len = min(SORT_TILE, k.L - k.c0);
    int n2 = 2;
    while (n2 < len) n2 <<= 1;
    for (int i = threadIdx.x; i < n2; i += SPLAT_NT)
      sh[i] = i < len ? P.slots[k.s + k.c0 + i] : INT_MAX;
    __syncthreads();
    bitonic_sort(sh, n2);
    for (int i = threadIdx.x; i < len; i += SPLAT_NT) k.b0[k.c0 + i] = sh[i];
    __syncthreads();   // sh is free
  }
}

// Merge pass q of the long segments that need it: runs of SORT_TILE << q
// merged pairwise, from b0 into b1 on even passes and back on odd ones;
// each chunk task writes the merged pair's outputs over its chunk's slots.
// Every thread of the block must call it.
__device__ void merge_pass(const Splat& P, int q) {
  const unsigned long long longs = __ldcg(P.longs);
  const int nlong = (int)(longs >> 32), tasks = (int)(unsigned)longs;
  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const Chunk k = chunk_task(P, nlong, t);
    if (q >= k.passes) continue;
    const int* src = q & 1 ? k.b1 : k.b0;
    int* dst = q & 1 ? k.b0 : k.b1;
    const int w = SORT_TILE << q, a0 = k.c0 / (2 * w) * (2 * w);
    const int la = min(w, k.L - a0), lb = max(0, min(w, k.L - a0 - w));
    block_merge(src + a0, la, src + a0 + la, lb, k.c0 - a0, min(k.c0 + SORT_TILE, k.L) - a0,
                dst + a0);
  }
}

// Phase 5: the sums of one output cell over a run of its visits, one
// pass with a running max (the sums so far are rescaled when the max
// rises).  They are loaded in batches of GATHER_BATCH, whose loads are
// issued together: the visits' dependent loads (slot -> point -> corner and
// values), not their arithmetic, take the time.
constexpr int GATHER_BATCH = 4;

__device__ __forceinline__ Acc empty_acc() {
  Acc a;
  a.m = -INFINITY;
  a.den = a.miss = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) a.num[c] = 0.f;
  return a;
}

// The visits of output cell o: the points of its four base cells, (gx - 1,
// gy - 1), (gx, gy - 1), (gx - 1, gy), (gx, gy), each in ascending index.
// Each row's two cells are adjacent on the base grid, so their segments are
// one run [s, e) of order, split at m between them.
struct Runs {
  int s0, m0, e0, s1, m1, e1;
};

// o's runs, and its visits in all.
__device__ __forceinline__ int cell_runs(const Splat& P, int o, Runs& r) {
  const int gx = o % P.ow, gy = o / P.ow;
  const int c0 = gy * (P.ow + 1) + gx + 1, c1 = c0 + P.ow + 1;   // base cells (gx, gy - 1), (gx, gy)
  r.s0 = seg_start(P, c0 - 1);
  r.m0 = seg_start(P, c0);
  r.e0 = seg_start(P, c0 + 1);
  r.s1 = seg_start(P, c1 - 1);
  r.m1 = seg_start(P, c1);
  r.e1 = seg_start(P, c1 + 1);
  return r.e0 - r.s0 + r.e1 - r.s1;
}

// Adds visits [a, b) of the cell's runs, channels [c0, c0 + nc), to acc.
// A point in the run of row gy - 1 + y reaches o by its corner
// 2 (1 - y) + 1 before m (base cell gx - 1), 2 (1 - y) after it.
__device__ void accumulate(const Splat& P, const Runs& r, int a, int b, int c0, int nc, Acc& acc) {
  int j, m, e, k2;   // the slot, the run's split and end, and 2 (1 - y)
  if (a < r.e0 - r.s0) {
    j = r.s0 + a, m = r.m0, e = r.e0, k2 = 2;
  } else {
    j = r.s1 + a - (r.e0 - r.s0), m = r.m1, e = r.e1, k2 = 0;
  }
  for (int left = b - a; left > 0;) {
    int pk[GATHER_BATCH], pp[GATHER_BATCH];
#pragma unroll
    for (int u = 0; u < GATHER_BATCH; ++u) {
      pk[u] = -1;
      if (left > 0) {
        pk[u] = k2 + (j < m);
        pp[u] = P.order[j++];   // every earlier read of order was from L2: no stale line
        --left;
        if (j == e && k2 == 2) j = r.s1, m = r.m1, e = r.e1, k2 = 0;
      }
    }
    float2 cl[GATHER_BATCH];
    float v[GATHER_BATCH][CH];
#pragma unroll
    for (int u = 0; u < GATHER_BATCH; ++u) {
      if (pk[u] < 0) continue;
      cl[u] = P.corners[(size_t)pp[u] * 4 + pk[u]];
      const float* src = P.src + (size_t)pp[u] * P.C + c0;
#pragma unroll
      for (int c = 0; c < CH; ++c) v[u][c] = c < nc ? src[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < GATHER_BATCH; ++u) {
      if (pk[u] < 0 || cl[u].y > 0.f) continue;
      if (cl[u].x > acc.m) {   // exp(-inf) = 0 at the first point
        const float scale = expf(__fsub_rn(acc.m, cl[u].x));
#pragma unroll
        for (int c = 0; c < CH; ++c) acc.num[c] = __fmul_rn(acc.num[c], scale);
        acc.den = __fmul_rn(acc.den, scale);
        acc.m = cl[u].x;
      }
      const float w = expf(__fsub_rn(cl[u].x, acc.m));
#pragma unroll
      for (int c = 0; c < CH; ++c) acc.num[c] = __fadd_rn(acc.num[c], __fmul_rn(w, v[u][c]));
      acc.den = __fadd_rn(acc.den, w);
      acc.miss = __fadd_rn(acc.miss, cl[u].y);
    }
  }
}

// x := the sums of x's visits and then y's.
__device__ __forceinline__ void merge_acc(Acc& x, const Acc& y) {
  const float m = fmaxf(x.m, y.m);
  x.miss = __fadd_rn(x.miss, y.miss);
  if (m == -INFINITY) return;   // neither has a valid corner
  const float rx = expf(__fsub_rn(x.m, m)), ry = expf(__fsub_rn(y.m, m));
#pragma unroll
  for (int c = 0; c < CH; ++c)
    x.num[c] = __fadd_rn(__fmul_rn(x.num[c], rx), __fmul_rn(y.num[c], ry));
  x.den = __fadd_rn(__fmul_rn(x.den, rx), __fmul_rn(y.den, ry));
  x.m = m;
}

__device__ __forceinline__ void store(const Splat& P, int o, int c0, int nc, const Acc& acc) {
  const float coverage = __fsub_rn(1.f, expf(acc.miss));
  float* dst = P.out + (size_t)o * P.C + c0;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (c < nc)
      dst[c] = acc.den > 0.f ? __fmul_rn(__fdiv_rn(acc.num[c], fmaxf(acc.den, 1e-30f)), coverage)
                             : 0.f;
}

// Phase 5: one thread per output cell, but for the listed heavy ones.
__device__ void gather(const Splat& P, int t0, int nt) {
  const int n_out = P.oh * P.ow;
  for (int o = t0; o < n_out; o += nt) {
    Runs r;
    const int total = cell_runs(P, o, r);
    if (total > HEAVY) continue;
    for (int c0 = 0; c0 < P.C; c0 += CH) {
      const int nc = min(CH, P.C - c0);
      Acc acc = empty_acc();
      accumulate(P, r, 0, total, c0, nc, acc);
      store(P, o, c0, nc, acc);
    }
  }
}

// Phase 4: the output cells reached by more than HEAVY points (at most
// 4 n / HEAVY), listed from the back of P.list, each with the number of its
// first task of HEAVY_TILE visits: one atomicAdd takes both, so the first
// tasks ascend along the list.
__device__ void list_heavy(const Splat& P, int t0, int nt) {
  const int n_out = P.oh * P.ow;
  for (int o = t0; o < n_out; o += nt) {
    Runs r;
    const int total = cell_runs(P, o, r);
    if (total <= HEAVY) continue;
    const unsigned tasks = (total + HEAVY_TILE - 1) / HEAVY_TILE;
    const unsigned long long slot = atomicAdd(P.heavies, (1ull << 32) | tasks);
    P.list[P.n - 1 - 2 * (slot >> 32)] = o;
    P.list[P.n - 2 - 2 * (slot >> 32)] = (int)(unsigned)slot;
  }
}

// The heavy cell of task t: the last one in the list whose first task is
// <= t.
__device__ int heavy_cell(const Splat& P, int nheavy, int t) {
  int lo = 0, hi = nheavy - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldcg(P.list + P.n - 2 - 2 * mid) <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// acc := the merge of the lanes' sums by a fixed tree (lane 0 holds it).
__device__ __forceinline__ void warp_merge(Acc& acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc y;
    y.m = __shfl_down_sync(0xffffffffu, acc.m, off);
    y.den = __shfl_down_sync(0xffffffffu, acc.den, off);
    y.miss = __shfl_down_sync(0xffffffffu, acc.miss, off);
#pragma unroll
    for (int c = 0; c < CH; ++c) y.num[c] = __shfl_down_sync(0xffffffffu, acc.num[c], off);
    if (lane < off) merge_acc(acc, y);
  }
}

// Phase 5, heavy cells: task t sums its cell's visits [k, k + HEAVY_TILE),
// a warp each (lane l the l-th of 32 equal runs, merged by a fixed tree),
// into P.part[t * groups + g] for channel group g.  w0 / nw: this warp's
// first task and the stride.
__device__ void gather_heavy(const Splat& P, int w0, int nw) {
  const unsigned long long heavies = __ldcg(P.heavies);
  const int nheavy = (int)(heavies >> 32), tasks = (int)(unsigned)heavies;
  const int groups = (P.C + CH - 1) / CH, lane = threadIdx.x & 31;
  for (int t = w0; t < tasks; t += nw) {
    const int i = heavy_cell(P, nheavy, t);
    Runs r;
    const int total = cell_runs(P, __ldcg(P.list + P.n - 1 - 2 * i), r);
    const int v0 = (t - __ldcg(P.list + P.n - 2 - 2 * i)) * HEAVY_TILE;
    const int len = min(HEAVY_TILE, total - v0);
    const int a = v0 + len * lane / 32, b = v0 + len * (lane + 1) / 32;
    for (int g = 0; g < groups; ++g) {
      Acc acc = empty_acc();
      accumulate(P, r, a, b, g * CH, min(CH, P.C - g * CH), acc);
      warp_merge(acc);
      if (lane == 0) P.part[(size_t)t * groups + g] = acc;
    }
  }
}

// Phase 6: each heavy cell's task sums merged, a warp per cell and channel
// group: lane l merges the l-th of 32 equal runs of the tasks in order, then
// the lanes' by a fixed tree.
__device__ void merge_heavy(const Splat& P, int w0, int nw) {
  const unsigned long long heavies = __ldcg(P.heavies);
  const int nheavy = (int)(heavies >> 32), tasks = (int)(unsigned)heavies;
  const int groups = (P.C + CH - 1) / CH, lane = threadIdx.x & 31;
  for (int u = w0; u < nheavy * groups; u += nw) {
    const int i = u / groups, g = u % groups;
    const int first = P.list[P.n - 2 - 2 * i];
    const int count = (i + 1 < nheavy ? P.list[P.n - 4 - 2 * i] : tasks) - first;
    Acc acc = empty_acc();
    for (int t = first + count * lane / 32; t < first + count * (lane + 1) / 32; ++t)
      merge_acc(acc, P.part[(size_t)t * groups + g]);
    warp_merge(acc);
    if (lane == 0) store(P, P.list[P.n - 1 - 2 * i], g * CH, min(CH, P.C - g * CH), acc);
  }
}

// Every phase in one launch, with grid-wide syncs between them; every block
// must be resident (cooperative launch).  Four blocks an SM hold 64
// registers a thread (a few bytes spill): on the H100 the latency-bound
// gather ran faster so than with 80 registers at three blocks an SM.
__global__ void __launch_bounds__(SPLAT_NT, 4) splat_kernel(Splat P) {
  __shared__ __align__(16) int sh[SORT_TILE];
  cg::grid_group grid = cg::this_grid();
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  for (int i = t0; i <= P.cells; i += nt) P.loc[i] = 0;
  if (t0 == 0) *P.longs = *P.heavies = 0;
  if (t0 == 0) *P.most_chunks = 0;
  grid.sync();
  count_points(P, t0, nt);
  grid.sync();
  scan_tiles(P, blockIdx.x, gridDim.x);
  grid.sync();
  if (blockIdx.x == 0) scan_totals(P);
  grid.sync();
  fill_slots(P, t0, nt);
  grid.sync();
  order_points(P, t0, nt);
  if (__ldcg(P.longs) != 0) list_heavy(P, t0, nt);   // else every cell has <= 4 LONG_SEG visits
  sort_chunks(P, sh);
  for (int q = 0, passes = merge_passes(__ldcg(P.most_chunks)); q < passes; ++q) {
    grid.sync();
    merge_pass(P, q);
  }
  grid.sync();
  gather(P, t0, nt);
  gather_heavy(P, t0 >> 5, nt >> 5);
  if (__ldcg(P.heavies) != 0) {   // the same in every thread: listed before the last sync
    grid.sync();
    merge_heavy(P, t0 >> 5, nt >> 5);
  }
}

inline long long cell_count(int oh, int ow) { return (long long)(oh + 1) * (ow + 1); }
inline long long tile_count(int oh, int ow) {
  return (cell_count(oh, ow) + 1 + (1 << SCAN_SHIFT) - 1) >> SCAN_SHIFT;
}

// Tasks of the heavy cells: each visits at most 4 n points in all, and one
// with more than HEAVY visits has at most visits / HEAVY_TILE + 1 tasks.
inline long long heavy_task_count(int n) { return 4LL * n / HEAVY_TILE + 4LL * n / HEAVY + 2; }

// Workspace, in 4-byte words: the corners (float), the two lists' counts,
// the ints, then the heavy tasks' partial sums.
inline long long workspace_words(int n, int oh, int ow, int C) {
  return 8LL * n + 4 + 1 + cell_count(oh, ow) + 1 + tile_count(oh, ow) + 5LL * n +
         heavy_task_count(n) * ((C + CH - 1) / CH) * (long long)(sizeof(Acc) / 4);
}

}  // namespace

// 4-byte words of the workspace gd_splat_fused takes for n points of C
// channels and an (oh, ow) output; -1 past INT_MAX.
extern "C" int gd_splat_workspace(int n, int oh, int ow, int C) {
  const long long words = workspace_words(n, oh, ow, C);
  return words > INT_MAX ? -1 : (int)words;
}

// src (n, C) and coords (n, 3) float32, n = h * w source points; out
// (oh * ow, C) float32; work: gd_splat_workspace(n, oh, ow, C) words,
// 16-byte aligned, set here.  One cooperative launch on `stream`.
extern "C" int gd_splat_fused(const float* src, const float* coords, void* work, float* out, int n,
                              int oh, int ow, int C, float radius, float tau, float z_beta,
                              void* stream) {
  if (n < 1 || oh < 1 || ow < 1 || C < 1) return cudaErrorInvalidValue;
  if (workspace_words(n, oh, ow, C) > INT_MAX || (long long)oh * ow * C > INT_MAX)
    return cudaErrorInvalidValue;
  Splat P;
  P.src = src;
  P.coords = coords;
  P.out = out;
  P.n = n;
  P.oh = oh;
  P.ow = ow;
  P.C = C;
  P.cells = (int)cell_count(oh, ow);
  P.tiles = (int)tile_count(oh, ow);
  P.corners = static_cast<float2*>(work);
  P.longs = reinterpret_cast<unsigned long long*>(P.corners + (size_t)4 * n);
  P.heavies = P.longs + 1;
  P.most_chunks = reinterpret_cast<int*>(P.heavies + 1);
  P.loc = P.most_chunks + 1;
  P.tot = P.loc + P.cells + 1;
  P.pcell = P.tot + P.tiles;
  P.prank = P.pcell + n;
  P.slots = P.prank + n;
  P.order = P.slots + n;
  P.list = P.order + n;
  P.part = reinterpret_cast<Acc*>(P.list + n);
  P.r2 = fmaxf(radius * radius, 1e-8f);
  P.tau = tau;
  P.z_beta = z_beta;
  cudaError_t e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, splat_kernel, SPLAT_NT, 0)) !=
      cudaSuccess)
    return e;
  void* args[] = {&P};
  return cudaLaunchCooperativeKernel((const void*)splat_kernel, dim3(sms * per_sm), dim3(SPLAT_NT),
                                     args, 0, (cudaStream_t)stream);
}
