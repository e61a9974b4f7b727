// GroupNorm with affine and an optional fused SiLU on channels-last
// activations, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it into the convolutions' layout on the TPU.  It was added because
// the port's UNet and VAE keep every activation channels-last (N, H, W, C in
// memory), which cuDNN's bf16 Hopper convolutions take without transposes,
// and ATen's CUDA GroupNorm takes only NCHW-contiguous input.
//
//   y = act((x - mean_ng) * rstd_ng * w_c + b_c),  act = SiLU or identity,
//
// with mean and biased variance over the C/G channels of group g and all
// H * W pixels of sample n, rstd = 1 / sqrt(var + eps), every sum float32.
//
// What bounds it on the H100: a few operations per element against 2 bytes
// (bf16) read and written: bytes, never arithmetic.  The least traffic is one
// read and one write of the activation; a statistics pass and an apply pass
// take two reads and one write (ATen's moments, apply and a separate SiLU take
// five).  At the DIFT batch of 1, ATen's statistics run one block per (n, g):
// 32 blocks on 132 SMs, each reducing C/32 * H * W values alone.
//
// Design:
//   1. gn_stats_kernel: a block takes a tile of pixels of one sample (grid
//      tiles x N) and reads every channel of them, 16 bytes a load, a warp on
//      neighbouring addresses, several loads in flight a thread.  A thread
//      keeps its columns' per-channel sums of (x - s) and (x - s)^2, s the
//      first value it read (exact variance where |mean| >> std); the block
//      merges rows, then channels, into each group's (mean, M2) of the tile,
//      written to a float32 scratch.  Groups need not align with the 16-byte
//      chunks: the sums are per channel until the last step.
//   2. gn_apply_kernel: each block merges its sample's partials (Chan's rule
//      in its parallel-axis form: exact, fixed order), then normalises,
//      applies the affine and the SiLU in one read and one write.  Tile 0
//      writes (mean, rstd) for the backward.
//   The tiling (tiles a sample, pixels a tile) is the wrapper's: enough
//   blocks to fill the card at batch 1, fewer, larger tiles at 8-24 streams.
//   3. gn_bwd_reduce_kernel / gn_bwd_apply_kernel: the same two passes over
//      x and dy, for x's gradient alone (the models' norms are frozen).  The
//      first recomputes z = x_hat w + b and the SiLU's derivative (only x is
//      saved, not the SiLU's input) and reduces per-group sum(dz w) and
//      sum(dz w x_hat); the second writes
//      dx = rstd (dz w - mean(dz w) - x_hat mean(dz w x_hat)).
// No atomics and no allocation: every sum runs in a fixed order (two launches
// give equal bits), the wrapper allocates outputs and scratch, and nothing
// syncs with the host, so the kernels can be captured in a CUDA graph.
#include "common.cuh"

namespace {

constexpr int GN_NT = 256;                 // threads a block, every kernel
constexpr int GN_WARPS = GN_NT / 32;
constexpr int GN_MAX_CHANNELS = 4096;      // the scratch of a block holds 2 rows of these
constexpr int GN_MAX_GROUPS = 1024;
constexpr int GN_IN_FLIGHT = 8;            // 16-byte loads a thread issues before using one
constexpr int GN_MAX_TILES = 160;          // tiles a sample at most: a lane merges 5 partials
constexpr int GN_TILE_LOADS = GN_MAX_TILES / 32;

// 16 bytes of T: 4 float32 or 8 bfloat16 values, unpacked to float32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  // element 2i is the low half of word i (little-endian)
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
};

// The shape and the tiling.  A pixel's C channels are C8 chunks; a block's
// threads are R rows of K columns: thread (r, k) reads chunks k, k + K, ...
// (M of them at most) of pixels p0 + r, p0 + r + R, ... of its tile.
struct Geo {
  int N, C, HW, G, cpg, tiles, tile, C8, K, R, M;
};

__device__ __forceinline__ int tile_end(const Geo& g, int t) { return min((t + 1) * g.tile, g.HW); }

// Pixels that row r of a tile [p0, p1) visits.
__device__ __forceinline__ int row_pixels(const Geo& g, int r, int p0, int p1) {
  return p0 + r < p1 ? (p1 - p0 - r + g.R - 1) / g.R : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// f(p, m, j, v) for every pixel p of this thread's rows in [p0, p1) and each
// of its chunk columns m (chunk j of the pixel), v[s] the chunk of source s
// unpacked; U pixels' loads are issued before any is used.
template <typename T, int M, int NS, typename F>
__device__ __forceinline__ void sweep(const Geo& g, const T* const (&src)[NS], int r, int k,
                                      int p0, int p1, F&& f) {
  constexpr int V = Chunk<T>::V;
  constexpr int U = GN_IN_FLIGHT / (M * NS) > 0 ? GN_IN_FLIGHT / (M * NS) : 1;
  for (int p = p0 + r; p < p1; p += U * g.R) {
    uint4 raw[U][M][NS];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int pp = p + u * g.R, j = k + m * g.K;
        if (pp < p1 && j < g.C8) {
#pragma unroll
          for (int s = 0; s < NS; ++s)
            raw[u][m][s] = ld16(src[s] + (size_t)pp * g.C + (size_t)j * V);
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int pp = p + u * g.R, j = k + m * g.K;
        if (pp < p1 && j < g.C8) {
          float v[NS][V];
#pragma unroll
          for (int s = 0; s < NS; ++s) Chunk<T>::unpack(raw[u][m][s], v[s]);
          f(pp, m, j, v);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// part[(n G + g) tiles + t] = (mean, M2) of group g over tile t of sample n.
template <typename T, int M>
__global__ void __launch_bounds__(GN_NT) gn_stats_kernel(const T* __restrict__ x,
                                                         float2* __restrict__ part, Geo g) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float sm[];
  float* s_mean = sm;              // [R][C], then [C]
  float* s_m2 = sm + g.R * g.C;    // [R][C], then [C]
  const int n = blockIdx.y, t = blockIdx.x;
  const int r = threadIdx.x / g.K, k = threadIdx.x - r * g.K;
  const int p0 = t * g.tile, p1 = tile_end(g, t);
  if (r < g.R) {
    const T* const src[1] = {x + (size_t)n * g.HW * g.C};
    float shift[M][V], s[M][V], q[M][V];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = k + m * g.K;
#pragma unroll
      for (int i = 0; i < V; ++i) shift[m][i] = s[m][i] = q[m][i] = 0.f;
      if (p0 + r < p1 && j < g.C8)
        Chunk<T>::unpack(ld16(src[0] + (size_t)(p0 + r) * g.C + (size_t)j * V), shift[m]);
    }
    sweep<T, M, 1>(g, src, r, k, p0, p1, [&](int, int m, int, const float (&v)[1][V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[0][i] - shift[m][i];
        s[m][i] += d;
        q[m][i] = fmaf(d, d, q[m][i]);
      }
    });
    const int cnt = row_pixels(g, r, p0, p1);
    const float inv = cnt ? 1.f / (float)cnt : 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = k + m * g.K;
      if (j >= g.C8) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = j * V + i;
        s_mean[r * g.C + c] = cnt ? shift[m][i] + s[m][i] * inv : 0.f;
        s_m2[r * g.C + c] = cnt ? fmaxf(q[m][i] - s[m][i] * s[m][i] * inv, 0.f) : 0.f;
      }
    }
  }
  __syncthreads();
  // rows -> channels: each thread its own channels, into row 0's slots
  const float npx = (float)(p1 - p0);
  for (int c = threadIdx.x; c < g.C; c += GN_NT) {
    float mean = 0.f;
    for (int rr = 0; rr < g.R; ++rr)
      mean = fmaf((float)row_pixels(g, rr, p0, p1), s_mean[rr * g.C + c], mean);
    mean /= npx;
    float m2 = 0.f;
    for (int rr = 0; rr < g.R; ++rr) {
      const float d = s_mean[rr * g.C + c] - mean;
      m2 += s_m2[rr * g.C + c] + (float)row_pixels(g, rr, p0, p1) * d * d;
    }
    s_mean[c] = mean;
    s_m2[c] = m2;
  }
  __syncthreads();
  // channels -> groups: a warp a group, every channel of the tile npx pixels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gg = warp; gg < g.G; gg += GN_WARPS) {
    const int c0 = gg * g.cpg;
    float sum = 0.f;
    for (int i = lane; i < g.cpg; i += 32) sum += s_mean[c0 + i];
    const float mean = warp_sum(sum) / (float)g.cpg;
    float m2 = 0.f;
    for (int i = lane; i < g.cpg; i += 32) {
      const float d = s_mean[c0 + i] - mean;
      m2 += s_m2[c0 + i] + npx * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) part[((size_t)n * g.G + gg) * g.tiles + t] = make_float2(mean, m2);
  }
}

// A warp's lanes load group g's partials of sample n together, tile
// lane + 32 i in pt[i] (zero past the last tile), so that merging a group
// waits for one round of loads.
__device__ __forceinline__ void load_partials(const float2* __restrict__ part, const Geo& g, int n,
                                              int gg, int lane, float2 (&pt)[GN_TILE_LOADS]) {
  const float2* pg = part + ((size_t)n * g.G + gg) * g.tiles;
#pragma unroll
  for (int i = 0; i < GN_TILE_LOADS; ++i) {
    const int t = lane + 32 * i;
    pt[i] = t < g.tiles ? pg[t] : make_float2(0.f, 0.f);
  }
}

// (mean, rstd) of each group of sample n from its tiles' partials, into
// s_mean / s_rstd, and into stats[n G + g] when `stats` is given.
__device__ __forceinline__ void merge_stats(const float2* __restrict__ part, float2* stats,
                                            float* s_mean, float* s_rstd, const Geo& g, int n,
                                            float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float total = (float)g.cpg * (float)g.HW;
  for (int gg = warp; gg < g.G; gg += GN_WARPS) {
    float2 pt[GN_TILE_LOADS];
    float w[GN_TILE_LOADS];
    load_partials(part, g, n, gg, lane, pt);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < GN_TILE_LOADS; ++i) {
      const int t = lane + 32 * i;
      w[i] = t < g.tiles ? (float)g.cpg * (float)(tile_end(g, t) - t * g.tile) : 0.f;
      sum = fmaf(w[i], pt[i].x, sum);
    }
    const float mean = warp_sum(sum) / total;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < GN_TILE_LOADS; ++i) {
      const float d = pt[i].x - mean;
      m2 += pt[i].y + w[i] * d * d;
    }
    const float rstd = rsqrtf(warp_sum(m2) / total + eps);
    if (lane == 0) {
      s_mean[gg] = mean;
      s_rstd[gg] = rstd;
      if (stats) stats[(size_t)n * g.G + gg] = make_float2(mean, rstd);
    }
  }
}

template <typename T, int M, bool SILU>
__global__ void __launch_bounds__(GN_NT) gn_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    const float2* __restrict__ part, float2* __restrict__ stats, T* __restrict__ y, Geo g,
    float eps) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float sm[];
  float* s_mean = sm;
  float* s_rstd = sm + g.G;
  const int n = blockIdx.y, t = blockIdx.x;
  merge_stats(part, t == 0 ? stats : nullptr, s_mean, s_rstd, g, n, eps);
  __syncthreads();
  const int r = threadIdx.x / g.K, k = threadIdx.x - r * g.K;
  if (r >= g.R) return;
  float mu[M][V], a[M][V], sh[M][V];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = k + m * g.K;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = min(j * V + i, g.C - 1);
      const int gi = c / g.cpg;
      mu[m][i] = s_mean[gi];
      a[m][i] = gd::ld(w, c) * s_rstd[gi];
      sh[m][i] = gd::ld(b, c);
    }
  }
  const size_t base = (size_t)n * g.HW * g.C;
  const T* const src[1] = {x + base};
  T* dst = y + base;
  sweep<T, M, 1>(g, src, r, k, t * g.tile, tile_end(g, t),
                 [&](int p, int m, int j, const float (&v)[1][V]) {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float z = fmaf(v[0][i] - mu[m][i], a[m][i], sh[m][i]);
      if (SILU) z = z / (1.f + expf(-z));
      o[i] = z;
    }
    *reinterpret_cast<uint4*>(dst + (size_t)p * g.C + (size_t)j * V) = Chunk<T>::pack(o);
  });
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Per-channel constants of a thread's columns: mean, rstd, w, b of sample n.
template <typename T, int M>
__device__ __forceinline__ void channel_consts(const Geo& g, const float2* __restrict__ stats,
                                               const T* __restrict__ w, const T* __restrict__ b,
                                               int n, int k, float (&mu)[M][Chunk<T>::V],
                                               float (&rs)[M][Chunk<T>::V],
                                               float (&wt)[M][Chunk<T>::V],
                                               float (&bt)[M][Chunk<T>::V]) {
  constexpr int V = Chunk<T>::V;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = k + m * g.K;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = min(j * V + i, g.C - 1);
      const float2 st = stats[(size_t)n * g.G + c / g.cpg];
      mu[m][i] = st.x;
      rs[m][i] = st.y;
      wt[m][i] = gd::ld(w, c);
      bt[m][i] = gd::ld(b, c);
    }
  }
}

// dL/dz from dL/dy at z (the SiLU's derivative when it is fused).
template <bool SILU>
__device__ __forceinline__ float grad_z(float dy, float z) {
  if (!SILU) return dy;
  const float sg = 1.f / (1.f + expf(-z));
  return dy * sg * fmaf(z, 1.f - sg, 1.f);
}

// part[(n G + g) tiles + t] = (sum dz w, sum dz w x_hat) over group g of tile t.
template <typename T, int M, bool SILU>
__global__ void __launch_bounds__(GN_NT) gn_bwd_reduce_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
    const T* __restrict__ b, const float2* __restrict__ stats, float2* __restrict__ part,
    Geo g) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float sm[];
  float* s_db = sm;                // [R][C], then [C]
  float* s_dw = sm + g.R * g.C;    // [R][C], then [C]
  const int n = blockIdx.y, t = blockIdx.x;
  const int r = threadIdx.x / g.K, k = threadIdx.x - r * g.K;
  const int p0 = t * g.tile, p1 = tile_end(g, t);
  if (r < g.R) {
    float mu[M][V], rs[M][V], wt[M][V], bt[M][V], db[M][V], dw[M][V];
    channel_consts<T, M>(g, stats, w, b, n, k, mu, rs, wt, bt);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < V; ++i) db[m][i] = dw[m][i] = 0.f;
    const size_t base = (size_t)n * g.HW * g.C;
    const T* const src[2] = {x + base, dy + base};
    sweep<T, M, 2>(g, src, r, k, p0, p1, [&](int, int m, int, const float (&v)[2][V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (v[0][i] - mu[m][i]) * rs[m][i];
        const float dz = grad_z<SILU>(v[1][i], fmaf(xh, wt[m][i], bt[m][i]));
        db[m][i] += dz;
        dw[m][i] = fmaf(dz, xh, dw[m][i]);
      }
    });
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = k + m * g.K;
      if (j >= g.C8) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s_db[r * g.C + j * V + i] = db[m][i];
        s_dw[r * g.C + j * V + i] = dw[m][i];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g.C; c += GN_NT) {
    float db = 0.f, dw = 0.f;
    for (int rr = 0; rr < g.R; ++rr) {
      db += s_db[rr * g.C + c];
      dw += s_dw[rr * g.C + c];
    }
    s_db[c] = db;
    s_dw[c] = dw;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gg = warp; gg < g.G; gg += GN_WARPS) {
    const int c0 = gg * g.cpg;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < g.cpg; i += 32) {
      const float wc = gd::ld(w, c0 + i);
      s1 = fmaf(wc, s_db[c0 + i], s1);
      s2 = fmaf(wc, s_dw[c0 + i], s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) part[((size_t)n * g.G + gg) * g.tiles + t] = make_float2(s1, s2);
  }
}

template <typename T, int M, bool SILU>
__global__ void __launch_bounds__(GN_NT) gn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
    const T* __restrict__ b, const float2* __restrict__ stats, const float2* __restrict__ part,
    T* __restrict__ dx, Geo g) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ float sm[];
  float* s_c1 = sm;         // mean of dz w over the group
  float* s_c2 = sm + g.G;   // mean of dz w x_hat over the group
  const int n = blockIdx.y, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float total = (float)g.cpg * (float)g.HW;
  for (int gg = warp; gg < g.G; gg += GN_WARPS) {
    float2 pt[GN_TILE_LOADS];
    load_partials(part, g, n, gg, lane, pt);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < GN_TILE_LOADS; ++i) {
      s1 += pt[i].x;
      s2 += pt[i].y;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      s_c1[gg] = s1 / total;
      s_c2[gg] = s2 / total;
    }
  }
  __syncthreads();
  const int r = threadIdx.x / g.K, k = threadIdx.x - r * g.K;
  if (r >= g.R) return;
  float mu[M][V], rs[M][V], wt[M][V], bt[M][V], c1[M][V], c2[M][V];
  channel_consts<T, M>(g, stats, w, b, n, k, mu, rs, wt, bt);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int gi = min((k + m * g.K) * V + i, g.C - 1) / g.cpg;
      c1[m][i] = s_c1[gi];
      c2[m][i] = s_c2[gi];
    }
  const size_t base = (size_t)n * g.HW * g.C;
  const T* const src[2] = {x + base, dy + base};
  T* dst = dx + base;
  sweep<T, M, 2>(g, src, r, k, t * g.tile, tile_end(g, t),
                 [&](int p, int m, int j, const float (&v)[2][V]) {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = (v[0][i] - mu[m][i]) * rs[m][i];
      const float dz = grad_z<SILU>(v[1][i], fmaf(xh, wt[m][i], bt[m][i]));
      o[i] = rs[m][i] * (dz * wt[m][i] - c1[m][i] - xh * c2[m][i]);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)p * g.C + (size_t)j * V) = Chunk<T>::pack(o);
  });
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

bool make_geo(Geo& g, int N, int C, int HW, int G, int tiles, int tile, int vec) {
  if (N < 1 || N > 65535 || C < 1 || HW < 1 || G < 1 || G > GN_MAX_GROUPS || C % G != 0 ||
      C % vec != 0 || C > GN_MAX_CHANNELS || tiles < 1 || tiles > GN_MAX_TILES || tile < 1 ||
      (long long)(tiles - 1) * tile >= HW || (long long)tiles * tile < HW)
    return false;
  g.N = N;
  g.C = C;
  g.HW = HW;
  g.G = G;
  g.cpg = C / G;
  g.tiles = tiles;
  g.tile = tile;
  g.C8 = C / vec;
  g.K = g.C8 < GN_NT ? g.C8 : GN_NT;
  g.R = GN_NT / g.K;
  g.M = (g.C8 + g.K - 1) / g.K;
  return g.M <= 4;
}

// dynamic shared memory of the statistics and reduce kernels: two [R][C] rows
size_t rows_smem(const Geo& g) { return 2 * sizeof(float) * (size_t)g.R * g.C; }

template <typename T, int M>
cudaError_t fwd_m(const T* x, const T* w, const T* b, float2* part, float2* stats, T* y,
                  const Geo& g, float eps, bool silu, cudaStream_t st) {
  const dim3 grid(g.tiles, g.N);
  gn_stats_kernel<T, M><<<grid, GN_NT, rows_smem(g), st>>>(x, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * sizeof(float) * g.G;
  if (silu)
    gn_apply_kernel<T, M, true><<<grid, GN_NT, smem, st>>>(x, w, b, part, stats, y, g, eps);
  else
    gn_apply_kernel<T, M, false><<<grid, GN_NT, smem, st>>>(x, w, b, part, stats, y, g, eps);
  return cudaGetLastError();
}

template <typename T, int M, bool SILU>
cudaError_t bwd_ms(const T* x, const T* dy, const T* w, const T* b, const float2* stats,
                   float2* part, T* dx, const Geo& g, cudaStream_t st) {
  const dim3 grid(g.tiles, g.N);
  gn_bwd_reduce_kernel<T, M, SILU><<<grid, GN_NT, rows_smem(g), st>>>(x, dy, w, b, stats, part,
                                                                       g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_apply_kernel<T, M, SILU><<<grid, GN_NT, 2 * sizeof(float) * g.G, st>>>(
      x, dy, w, b, stats, part, dx, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* part, void* stats, void* y,
                  const Geo& g, float eps, bool silu, cudaStream_t st) {
  const T *xt = (const T*)x, *wt = (const T*)w, *bt = (const T*)b;
  float2 *pt = (float2*)part, *stt = (float2*)stats;
  T* yt = (T*)y;
  if (g.M == 1) return fwd_m<T, 1>(xt, wt, bt, pt, stt, yt, g, eps, silu, st);
  if constexpr (Chunk<T>::V == 8) {   // bf16: at most 4096 channels are 2 chunks a thread
    return fwd_m<T, 2>(xt, wt, bt, pt, stt, yt, g, eps, silu, st);
  } else {
    if (g.M == 2) return fwd_m<T, 2>(xt, wt, bt, pt, stt, yt, g, eps, silu, st);
    return fwd_m<T, 4>(xt, wt, bt, pt, stt, yt, g, eps, silu, st);
  }
}

template <typename T, bool SILU>
cudaError_t bwd_t(const void* x, const void* dy, const void* w, const void* b, const void* stats,
                  void* part, void* dx, const Geo& g, cudaStream_t st) {
  const T *xt = (const T*)x, *dyt = (const T*)dy, *wt = (const T*)w, *bt = (const T*)b;
  const float2* stt = (const float2*)stats;
  float2* pt = (float2*)part;
  T* dxt = (T*)dx;
  if (g.M == 1) return bwd_ms<T, 1, SILU>(xt, dyt, wt, bt, stt, pt, dxt, g, st);
  if constexpr (Chunk<T>::V == 8) {
    return bwd_ms<T, 2, SILU>(xt, dyt, wt, bt, stt, pt, dxt, g, st);
  } else {
    if (g.M == 2) return bwd_ms<T, 2, SILU>(xt, dyt, wt, bt, stt, pt, dxt, g, st);
    return bwd_ms<T, 4, SILU>(xt, dyt, wt, bt, stt, pt, dxt, g, st);
  }
}

}  // namespace

// x, y: channels-last (N, C, H, W) of dtype (0 float32, 1 bfloat16); w, b:
// (C,) of the same dtype; part: float32 scratch of N * G * tiles * 2; stats:
// (N, G, 2) float32 out, (mean, rstd).  Returns a cudaError_t.
extern "C" int gd_group_norm_fwd(const void* x, const void* w, const void* b, void* part,
                                 void* stats, void* y, int N, int C, int HW, int G, int tiles,
                                 int tile, float eps, int silu, int dtype, void* stream) {
  Geo g;
  if (!make_geo(g, N, C, HW, G, tiles, tile, dtype ? 8 : 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype) return (int)fwd_t<__nv_bfloat16>(x, w, b, part, stats, y, g, eps, silu != 0, st);
  return (int)fwd_t<float>(x, w, b, part, stats, y, g, eps, silu != 0, st);
}

// dy, dx like x; stats the forward's; part: float32 scratch of
// N * G * tiles * 2.  dx alone: weight and bias take no gradient.
extern "C" int gd_group_norm_bwd(const void* x, const void* dy, const void* w, const void* b,
                                 const void* stats, void* part, void* dx, int N, int C, int HW,
                                 int G, int tiles, int tile, int silu, int dtype, void* stream) {
  Geo g;
  if (!make_geo(g, N, C, HW, G, tiles, tile, dtype ? 8 : 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype)
    return (int)(silu ? bwd_t<__nv_bfloat16, true>(x, dy, w, b, stats, part, dx, g, st)
                      : bwd_t<__nv_bfloat16, false>(x, dy, w, b, stats, part, dx, g, st));
  return (int)(silu ? bwd_t<float, true>(x, dy, w, b, stats, part, dx, g, st)
                    : bwd_t<float, false>(x, dy, w, b, stats, part, dx, g, st));
}
