// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces geodiffuser_tpu/kernels/flash_attention.py: _flash_fwd_impl
// (_fwd_kernel) and _flash_bwd_impl (_bwd_dq_kernel, _bwd_dkv_kernel).
//
// What bounds it on the H100: at the main path's shapes (Lq = Lk = 4096,
// D = 40; Lq = Lk = 1024, D = 80; the warped-row blend's 1024 x 4096, D = 40;
// at 1024^2 images also Lq = Lk = 16384, D = 40 and Lq = Lk = 1024, D = 160)
// the work is 4*Lq*Lk*D operations per (batch*head) against
// 2*(Lq + 2*Lk)*D bytes in bf16, about 1000 operations per byte: far above
// the ~295 at which the card stops being memory bound, so the tensor-core
// rate bounds it.  What keeps a kernel from that rate is feeding the tensor
// cores: the tiles' traffic from L2, and the softmax between the products.
//
// Design (bf16, the main path): the Pallas grid carried the online-softmax
// state across sequential k blocks in VMEM; here a block loops over the
// whole key (or, for dk/dv, query) axis itself and nothing is carried
// between blocks.  One producer warp keeps a ring of 64-row tiles in flight
// with TMA (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion), so
// loads overlap the products and no consumer thread spends instructions on
// them.  Consumer warpgroups run every product as wgmma: S = Q K^T with both
// operands in shared memory, then P V with P rounded to bf16 in registers
// and V read row-major through wgmma's transpose bit (no transposed copy).
// D = 40 is padded to a k-depth of 48 for Q K^T by TMA's zero fill and runs
// P V at its native width of 40 (m64n40k16); D = 80 and D = 160 run both at
// their width (D = 160: three boxes a tile, the last one half zero).  At
// these widths each 64-key tile carries little work for the bytes it
// brings from L2, so the ring's traffic bounds the kernel before the tensor
// cores do: every loaded tile feeds as many 64-row q tiles as the block's
// registers allow (four in the forward at D = 40), and the wrapper trades
// row tiles for blocks per shape so that small maps still fill the SMs.
// The backward is a dq kernel per q tile, which also computes delta =
// rowsum(dO o O) for its rows and writes it, and a dk/dv kernel per key tile
// that reads it, launched after it on the same stream: no atomics,
// deterministic.  At D = 160 one thread cannot hold both 64 x 160 float32
// accumulators of dK and dV (160 registers before any operand), so the
// dk/dv kernel's two warpgroups share one key tile, one accumulating dV and
// the other dK, and each computes S^T itself.  Probabilities and dS are rounded to bf16 before their
// products, as the Pallas kernels cast them; the LSE is float32, natural log.
//
// float32 inputs run the CUDA-core kernels below (float32 FMAs, 67 TFLOP/s
// peak) and serve only float32 checks.  D is at most 160, the UNet's widest
// head (its 32^2 level at 1024^2 images).  The bf16 kernels need D to be a
// multiple of 8 (16-byte TMA rows); the wrapper pads other widths.
#include "hopper.cuh"

using namespace gd;

namespace {

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk, int D,
                 float scale_log2) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sQ = sm;
  float* sK = sQ + TILE * sd;
  float* sV = sK + TILE * sd;
  float* sP = sV + TILE * sd;
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const T* qb = q + (size_t)b * Lq * D;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;

  load_tile(sQ, qb, q0, Lq, D, sd);
  float m = NEG, l = 0.f, acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_tile(sK, kb, k0, Lk, D, sd);
    load_tile(sV, vb, k0, Lk, D, sd);
    __syncthreads();
    float s[16];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = l4 + 4 * j;
      s[j] = (k0 + c < Lk) ? dot_row(sQ + r * sd, sK + c * sd, D) * scale_log2 : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, max4(mx));
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = exp2f(s[j] - m_new);
      ps += p;
      sP[r * PSTRIDE + l4 + 4 * j] = rnd<T>(p);
    }
    const float alpha = exp2f(m - m_new);
    l = l * alpha + sum4(ps);
    m = m_new;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float a = acc[i] * alpha;
        for (int c = 0; c < TILE; ++c) a = fmaf(sP[r * PSTRIDE + c], sV[c * sd + d], a);
        acc[i] = a;
      }
    }
  }
  if (q0 + r < Lq) {
    const size_t row = (size_t)b * Lq + q0 + r;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) st(o, row * D + d, acc[i] / l);
    }
    if (l4 == 0) lse[row] = (m + log2f(l)) * (1.0f / LOG2E);  // natural log
  }
}

template <typename T>
__global__ void flash_delta_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                                   float* __restrict__ delta, int rows, int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float a = 0.f;
  for (int d = 0; d < D; ++d) a = fmaf(ld(dout, (size_t)i * D + d), ld(o, (size_t)i * D + d), a);
  delta[i] = a;
}

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Lq, int Lk, int D,
                    float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sQ = sm;
  float* sO = sQ + TILE * sd;   // dO rows
  float* sK = sO + TILE * sd;
  float* sV = sK + TILE * sd;
  float* sS = sV + TILE * sd;   // dS tile
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;
  const size_t row = (size_t)b * Lq + q0 + r;
  const bool row_ok = q0 + r < Lq;
  load_tile(sQ, q + (size_t)b * Lq * D, q0, Lq, D, sd);
  load_tile(sO, dout + (size_t)b * Lq * D, q0, Lq, D, sd);
  const float lse2 = row_ok ? lse[row] * LOG2E : 0.f;
  const float dl = row_ok ? delta[row] : 0.f;
  const float scale_log2 = scale * LOG2E;
  const T* kb = k + (size_t)b * Lk * D;
  const T* vb = v + (size_t)b * Lk * D;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_tile(sK, kb, k0, Lk, D, sd);
    load_tile(sV, vb, k0, Lk, D, sd);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int c = l4 + 4 * j;
      float ds = 0.f;
      if (k0 + c < Lk) {
        const float p = exp2f(dot_row(sQ + r * sd, sK + c * sd, D) * scale_log2 - lse2);
        const float dp = dot_row(sO + r * sd, sV + c * sd, D);
        ds = p * (dp - dl);
      }
      sS[r * PSTRIDE + c] = rnd<T>(ds);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float a = acc[i];
        for (int c = 0; c < TILE; ++c) a = fmaf(sS[r * PSTRIDE + c], sK[c * sd + d], a);
        acc[i] = a;
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) st(dq, row * D + d, acc[i] * scale);
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Lq, int Lk, int D, float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sK = sm;
  float* sV = sK + TILE * sd;
  float* sQ = sV + TILE * sd;
  float* sO = sQ + TILE * sd;
  float* sP = sO + TILE * sd;         // P^T tile  (key row, q column)
  float* sS = sP + TILE * PSTRIDE;    // dS^T tile
  float* sL = sS + TILE * PSTRIDE;    // lse * log2(e) of the q tile
  float* sD = sL + TILE;              // delta of the q tile
  const int b = blockIdx.y, k0 = blockIdx.x * TILE;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;  // r: key row of the tile
  load_tile(sK, k + (size_t)b * Lk * D, k0, Lk, D, sd);
  load_tile(sV, v + (size_t)b * Lk * D, k0, Lk, D, sd);
  const T* qb = q + (size_t)b * Lq * D;
  const T* ob = dout + (size_t)b * Lq * D;
  const float scale_log2 = scale * LOG2E;
  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    __syncthreads();
    load_tile(sQ, qb, q0, Lq, D, sd);
    load_tile(sO, ob, q0, Lq, D, sd);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      sL[threadIdx.x] = qi < Lq ? lse[(size_t)b * Lq + qi] * LOG2E : 0.f;
      sD[threadIdx.x] = qi < Lq ? delta[(size_t)b * Lq + qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int c = l4 + 4 * j;  // q column of the tile
      float p = 0.f, ds = 0.f;
      if (q0 + c < Lq) {
        p = exp2f(dot_row(sK + r * sd, sQ + c * sd, D) * scale_log2 - sL[c]);
        const float dp = dot_row(sV + r * sd, sO + c * sd, D);
        ds = p * (dp - sD[c]);
      }
      sP[r * PSTRIDE + c] = rnd<T>(p);
      sS[r * PSTRIDE + c] = rnd<T>(ds);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float av = acc_v[i], ak = acc_k[i];
        for (int c = 0; c < TILE; ++c) {
          av = fmaf(sP[r * PSTRIDE + c], sO[c * sd + d], av);
          ak = fmaf(sS[r * PSTRIDE + c], sQ[c * sd + d], ak);
        }
        acc_v[i] = av;
        acc_k[i] = ak;
      }
    }
  }
  if (k0 + r < Lk) {
    const size_t row = (size_t)b * Lk + k0 + r;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        st(dk, row * D + d, acc_k[i] * scale);
        st(dv, row * D + d, acc_v[i]);
      }
    }
  }
}


// ------------------------------------------------------ bf16: TMA + wgmma
// One block = NC consumer warpgroups (wgmma) + one producer warp (TMA):
// NC = 4 in the forward at D <= 40; 2 at D = 80 and 160 and in the backward
// kernels, whose accumulators take more registers (fwd_nc, BWD_NC).  Every operand tile is 64 rows of the (B, L, D)
// tensor, loaded by TMA as ceil(D/64) boxes of 64 columns x 64 rows with the
// 128-byte swizzle; TMA zero-fills columns >= D (the padding of the
// products' depth) and rows >= L.  The wrapper plans `rows`, the row tiles
// of a block, per shape: more row tiles share each loaded tile of the loop
// axis (the ring's traffic from L2 per operation falls), fewer give more
// blocks.  The TMA, mbarrier and wgmma helpers are in hopper.cuh.

// Store a 64 x DV accumulator (times mul) as bf16 rows [row0, row0 + 64) of
// an (L, D) matrix; the warp's rows are w16 + g and w16 + g + 8.
template <int DV>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DV / 2], int row0,
                                           int L, int D, float mul0, float mul1, int w16, int g,
                                           int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + w16 + g + 8 * h;
    if (row >= L) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn) {
      const int c = jn * 8 + tig * 2;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + c) =
            __floats2bfloat162_rn(acc[4 * jn + 2 * h] * mul, acc[4 * jn + 2 * h + 1] * mul);
    }
  }
}

// Plan: a block's NC consumer warpgroups form `rows` row tiles (64 rows of
// the output axis each) times S = NC / rows splits.  The S warpgroups of a
// row tile take every S-th tile of the loop axis and combine their partial
// results through shared memory at the end (the idle ring and operand
// tiles: every product has completed by then).
__device__ __forceinline__ float* part_slot(float* buf, int n, int rt, int sp, int S, int t) {
  return buf + (size_t)(rt * (S - 1) + sp - 1) * n * 128 + t;
}

// The warpgroups with sp > 0 hand their N values per thread to warpgroup
// sp = 0 of their row tile, which adds them; false for those that handed.
template <int N>
__device__ __forceinline__ bool merge_sum(float* buf, float (&v)[N], int rt, int sp, int S, int t,
                                          int nthreads) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bar_sync(1, nthreads);
  if (sp > 0) {
    float* dst = part_slot(buf, N, rt, sp, S, t);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i * 128] = v[i];
  }
  bar_sync(1, nthreads);
  if (sp > 0) return false;
  for (int s2 = 1; s2 < S; ++s2) {
    const float* src = part_slot(buf, N, rt, s2, S, t);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += src[i * 128];
  }
  return true;
}

// Shared memory of a block: the block's own operand tiles (`own` 64-row
// tiles), the ring of ST stages of two tiles, the barriers (full[ST],
// empty[ST], one for the own tiles) and `stat` floats of row statistics.
template <int DV>
struct Smem {
  uint8_t* base;
  uint32_t own, ring, bars, once;
  float* stat;
  __device__ Smem(uint8_t* raw, int own_tiles) {
    base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    own = smem_u32(base);
    ring = own + own_tiles * Tiles<DV>::TB;
    bars = ring + 2 * Tiles<DV>::STAGES * Tiles<DV>::TB;
    once = bars + 16 * Tiles<DV>::STAGES;
    stat = reinterpret_cast<float*>(base + (once + 16 - own));
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (Tiles<DV>::STAGES + s); }
  __device__ uint32_t stage(int s) const { return ring + s * 2 * Tiles<DV>::TB; }
  // one thread: full barriers count `producers` arrivals, empty barriers
  // the 128 threads of each of the `rows` warpgroups that read a stage
  __device__ void init(int producers, int rows) const {
    for (int s = 0; s < Tiles<DV>::STAGES; ++s) {
      mbar_init(full(s), producers);
      mbar_init(empty(s), 128 * rows);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};

// Producer: tile j of the loop axis, from two maps, into its ring stage
template <int DV>
__device__ __forceinline__ void produce_stage(const Smem<DV>& sm, int j, const CUtensorMap* m0,
                                              const CUtensorMap* m1, int b) {
  constexpr int ST = Tiles<DV>::STAGES, TB = Tiles<DV>::TB;
  const int s = j % ST;
  mbar_expect_tx(sm.full(s), 2 * TB);
  tma_tile<Tiles<DV>::CB>(sm.stage(s), m0, sm.full(s), j * TILE, b);
  tma_tile<Tiles<DV>::CB>(sm.stage(s) + TB, m1, sm.full(s), j * TILE, b);
}

template <int DV>
__device__ __forceinline__ void wait_empty(const Smem<DV>& sm, int j) {
  constexpr int ST = Tiles<DV>::STAGES;
  if (j >= ST) mbar_wait(sm.empty(j % ST), ((j / ST) - 1) & 1);
}

// Forward.  Per key tile a consumer warpgroup runs S = Q K^T (wgmma, both
// operands in shared memory), the online softmax on the accumulators
// (exp2 domain), and O += P V with P rounded to bf16 in registers (the
// Pallas kernel's cast) and V read row-major through the transpose bit.
template <int DV, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Lq, int Lk, int D, float scale_log2, int rows) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = T::STAGES;
  // a stage's barriers advance one phase per use; each use must be waited
  // on by the same warpgroups, so the splits (<= NC) must divide the ring
  static_assert(ST % NC == 0, "ring depth must be a multiple of the warpgroups");
  extern __shared__ uint8_t smem_raw[];
  const Smem<DV> sm(smem_raw, NC);
  const int S = NC / rows;
  const int b = blockIdx.y, q0 = blockIdx.x * rows * TILE;
  const int nt = (Lk + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sm.init(1, rows);
  __syncthreads();

  if (warp == NC * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.once, rows * TB);
      for (int i = 0; i < rows; ++i) tma_tile<T::CB>(sm.own + i * TB, &tq, sm.once, q0 + i * TILE, b);
      for (int j = 0; j < nt; ++j) {
        wait_empty(sm, j);
        produce_stage(sm, j, &tk, &tv, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, rt = wg / S, sp = wg % S;
  const int t = threadIdx.x & 127, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  const uint32_t qt = sm.own + rt * TB;
  const int row0 = q0 + rt * TILE;
  float oacc[T::NACC], sacc[32];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (l: this lane's columns)
  mbar_wait_warp(sm.once, 0);

  for (int j = sp; j < nt; j += S) {
    const int s = j % ST;
    const uint32_t kt = sm.stage(s), vt = kt + TB;
    mbar_wait_warp(sm.full(s), (j / ST) & 1);
    pin(sacc);
    wg_fence();
    mma_abt<DV>(sacc, qt, kt);
    wg_commit();
    wg_wait0();
    pin(sacc);
    if ((j + 1) * TILE > Lk) {   // keys past Lk (zero rows of the K tile) drop out
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * TILE + jn * 8 + tig * 2 + e >= Lk) sacc[4 * jn + e] = sacc[4 * jn + 2 + e] = NEG;
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sacc[4 * jn + e]);
        mx1 = fmaxf(mx1, sacc[4 * jn + 2 + e]);
      }
    }
    // running maxima in the scaled log2 domain; p = 2^(s * scale_log2 - m)
    const float mn0 = fmaxf(m0, max4(mx0) * scale_log2), mn1 = fmaxf(m1, max4(mx1) * scale_log2);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[4 * jn + e] = ex2(fmaf(sacc[4 * jn + e], scale_log2, -mn0));
        sacc[4 * jn + 2 + e] = ex2(fmaf(sacc[4 * jn + 2 + e], scale_log2, -mn1));
        ps0 += sacc[4 * jn + e];
        ps1 += sacc[4 * jn + 2 + e];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < T::NACC; i += 4) {
      oacc[i] *= al0;
      oacc[i + 1] *= al0;
      oacc[i + 2] *= al1;
      oacc[i + 3] *= al1;
    }
    uint32_t pa[4][4];
    pack_a(pa, sacc);
    pin(oacc);
    pin(pa);
    wg_fence();
    mma_rows<DV>(oacc, pa, vt);
    wg_commit();
    wg_wait0();
    pin(oacc);
    pin(pa);
    mbar_arrive(sm.empty(s));
  }

  if (S > 1) {  // merge the splits' softmax states and sums into warpgroup sp = 0's
    constexpr int NP = T::NACC + 4;
    float* buf = reinterpret_cast<float*>(sm.base);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1, NC * 128);
    if (sp > 0) {
      float* dst = part_slot(buf, NP, rt, sp, S, t);
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) dst[i * 128] = oacc[i];
      dst[T::NACC * 128] = m0;
      dst[(T::NACC + 1) * 128] = m1;
      dst[(T::NACC + 2) * 128] = l0;
      dst[(T::NACC + 3) * 128] = l1;
    }
    bar_sync(1, NC * 128);
    if (sp > 0) return;
    for (int s2 = 1; s2 < S; ++s2) {
      const float* src = part_slot(buf, NP, rt, s2, S, t);
      const float om0 = src[T::NACC * 128], om1 = src[(T::NACC + 1) * 128];
      const float n0 = fmaxf(m0, om0), n1 = fmaxf(m1, om1);
      const float a0 = ex2(m0 - n0), b0 = ex2(om0 - n0);
      const float a1 = ex2(m1 - n1), b1 = ex2(om1 - n1);
      l0 = l0 * a0 + src[(T::NACC + 2) * 128] * b0;
      l1 = l1 * a1 + src[(T::NACC + 3) * 128] * b1;
#pragma unroll
      for (int i = 0; i < T::NACC; i += 4) {
        oacc[i] = oacc[i] * a0 + src[i * 128] * b0;
        oacc[i + 1] = oacc[i + 1] * a0 + src[(i + 1) * 128] * b0;
        oacc[i + 2] = oacc[i + 2] * a1 + src[(i + 2) * 128] * b1;
        oacc[i + 3] = oacc[i + 3] * a1 + src[(i + 3) * 128] * b1;
      }
      m0 = n0;
      m1 = n1;
    }
  }
  l0 = sum4(l0);
  l1 = sum4(l1);
  store_rows<DV>(o + (size_t)b * Lq * D, oacc, row0, Lq, D, 1.f / l0, 1.f / l1, w16, g, tig);
  if (tig == 0) {
    const int r = row0 + w16 + g;
    if (r < Lq) lse[(size_t)b * Lq + r] = (m0 + log2f(l0)) * (1.0f / LOG2E);   // natural log
    if (r + 8 < Lq) lse[(size_t)b * Lq + r + 8] = (m1 + log2f(l1)) * (1.0f / LOG2E);
  }
}

// Backward, dq.  A consumer warpgroup computes delta = rowsum(dO o O) of
// its 64 rows (and writes it for the dk/dv kernel), then per key tile
// S = Q K^T and dP = dO V^T (wgmma from shared memory), dS = P (dP - delta)
// rounded to bf16 in registers, and dQ += dS K with K read row-major.
template <int DV, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                          const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int D, float scale,
                          int rows) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = T::STAGES;
  // a stage's barriers advance one phase per use; each use must be waited
  // on by the same warpgroups, so the splits (<= NC) must divide the ring
  static_assert(ST % NC == 0, "ring depth must be a multiple of the warpgroups");
  extern __shared__ uint8_t smem_raw[];
  const Smem<DV> sm(smem_raw, 2 * NC);   // Q tiles, then dO tiles
  float* sdelta = sm.stat;                // [NC][64]
  const int S = NC / rows;
  const int b = blockIdx.y, q0 = blockIdx.x * rows * TILE;
  const int nt = (Lk + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sm.init(1, rows);
  __syncthreads();

  if (warp == NC * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(sm.once, 2 * rows * TB);
      for (int i = 0; i < rows; ++i) {
        tma_tile<T::CB>(sm.own + i * TB, &tq, sm.once, q0 + i * TILE, b);
        tma_tile<T::CB>(sm.own + (NC + i) * TB, &tdo, sm.once, q0 + i * TILE, b);
      }
      for (int j = 0; j < nt; ++j) {
        wait_empty(sm, j);
        produce_stage(sm, j, &tk, &tv, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, rt = wg / S, sp = wg % S;
  const int t = threadIdx.x & 127, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  const uint32_t qt = sm.own + rt * TB, ot = sm.own + (NC + rt) * TB;
  const int row0 = q0 + rt * TILE;
  {  // delta: two threads per row, bf16 pairs, coalesced along the row
    const int r = t >> 1, row = row0 + r;
    float a = 0.f;
    if (row < Lq) {
      const size_t base = ((size_t)b * Lq + row) * D;
      for (int c = (t & 1) * 2; c < D; c += 4) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + base + c));
        a = fmaf(x.x, y.x, fmaf(x.y, y.y, a));
      }
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    if ((t & 1) == 0) {
      sdelta[wg * 64 + r] = a;
      if (row < Lq && sp == 0) delta[(size_t)b * Lq + row] = a;
    }
    bar_sync(2 + wg, 128);
  }
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + w16 + g + 8 * h;
    lse2[h] = row < Lq ? lse[(size_t)b * Lq + row] * LOG2E : 0.f;
    dl[h] = sdelta[wg * 64 + w16 + g + 8 * h];
  }
  const float scale_log2 = scale * LOG2E;
  float acc[T::NACC], sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
  mbar_wait_warp(sm.once, 0);

  for (int j = sp; j < nt; j += S) {
    const int s = j % ST;
    const uint32_t kt = sm.stage(s), vt = kt + TB;
    mbar_wait_warp(sm.full(s), (j / ST) & 1);
    pin(sacc);
    pin(pacc);
    wg_fence();
    mma_abt<DV>(sacc, qt, kt);
    wg_commit();
    mma_abt<DV>(pacc, ot, vt);
    wg_commit();
    wg_wait1();   // S is done; P is computed while dP = dO V^T runs
    pin(sacc);
    const bool ragged = (j + 1) * TILE > Lk;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !ragged || j * TILE + jn * 8 + tig * 2 + (e & 1) < Lk;
        sacc[4 * jn + e] = ok ? ex2(fmaf(sacc[4 * jn + e], scale_log2, -lse2[e >> 1])) : 0.f;
      }
    }
    wg_wait0();
    pin(pacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] *= pacc[i] - dl[(i >> 1) & 1];   // dS
    uint32_t da[4][4];
    pack_a(da, sacc);
    pin(acc);
    pin(da);
    wg_fence();
    mma_rows<DV>(acc, da, kt);
    wg_commit();
    wg_wait0();
    pin(acc);
    pin(da);
    mbar_arrive(sm.empty(s));
  }
  if (S > 1 && !merge_sum<T::NACC>(reinterpret_cast<float*>(sm.base), acc, rt, sp, S, t, NC * 128))
    return;
  store_rows<DV>(dq + (size_t)b * Lq * D, acc, row0, Lq, D, scale, scale, w16, g, tig);
}

// Backward, dk and dv.  A consumer warpgroup keeps its 64 key rows of K and
// V in shared memory and per q tile runs S^T = K Q^T and dP^T = V dO^T,
// P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta), both rounded to bf16
// in registers, then dV += P^T dO and dK += dS^T Q with dO and Q read
// row-major.  The producer warp brings each q tile's LSE and delta (written
// by the dq kernel) into the stage beside its Q and dO tiles.  At DV > 128
// (SPLIT) the block has one row tile: warpgroup 0 runs S^T and dV, warpgroup
// 1 runs S^T, dP^T and dK, each over every q tile.
template <int DV, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Lq,
                           int Lk, int D, float scale, int rows) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = T::STAGES;
  constexpr bool SPLIT = DV > 128;
  // a stage's barriers advance one phase per use; each use must be waited
  // on by the same warpgroups, so the splits (<= NC) must divide the ring
  static_assert(ST % NC == 0, "ring depth must be a multiple of the warpgroups");
  static_assert(!SPLIT || NC == 2, "the split kernel pairs a dK and a dV warpgroup");
  extern __shared__ uint8_t smem_raw[];
  const Smem<DV> sm(smem_raw, 2 * NC);   // K tiles, then V tiles
  float* sstat = sm.stat;                 // [ST][lse * log2(e), delta][64]
  const int S = SPLIT ? 1 : NC / rows;
  const int b = blockIdx.y, k0 = blockIdx.x * rows * TILE;
  const int nt = (Lq + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // every stage is read by one warpgroup of each row tile, or by both (SPLIT)
  if (threadIdx.x == 0) sm.init(32, SPLIT ? NC : rows);
  __syncthreads();

  if (warp == NC * 4) {  // producer warp: lane 0 issues the TMA loads, all lanes the statistics
    if (lane == 0) {
      mbar_expect_tx(sm.once, 2 * rows * TB);
      for (int i = 0; i < rows; ++i) {
        tma_tile<T::CB>(sm.own + i * TB, &tk, sm.once, k0 + i * TILE, b);
        tma_tile<T::CB>(sm.own + (NC + i) * TB, &tv, sm.once, k0 + i * TILE, b);
      }
    }
    for (int j = 0; j < nt; ++j) {
      wait_empty(sm, j);
      float* st = sstat + (j % ST) * 128;
      for (int r = lane; r < TILE; r += 32) {
        const int qi = j * TILE + r;
        st[r] = qi < Lq ? lse[(size_t)b * Lq + qi] * LOG2E : 0.f;
        st[64 + r] = qi < Lq ? delta[(size_t)b * Lq + qi] : 0.f;
      }
      if (lane == 0)
        produce_stage(sm, j, &tq, &tdo, b);
      else
        mbar_arrive(sm.full(j % ST));
    }
    return;
  }

  const int wg = warp >> 2, rt = SPLIT ? 0 : wg / S, sp = SPLIT ? 0 : wg % S;
  const int t = threadIdx.x & 127, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  const uint32_t kt = sm.own + rt * TB, vt = sm.own + (NC + rt) * TB;
  const int row0 = k0 + rt * TILE;
  const float scale_log2 = scale * LOG2E;
  // P^T = exp(S^T - lse) of q tile j in place of S^T, 0 at queries >= Lq
  auto probs_t = [&](float (&s)[32], const float* st, int j) {
    const bool ragged = (j + 1) * TILE > Lq;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = jn * 8 + tig * 2;   // q column of the tile
      const float2 l2 = *reinterpret_cast<const float2*>(st + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !ragged || j * TILE + c + (e & 1) < Lq;
        s[4 * jn + e] = ok ? ex2(fmaf(s[4 * jn + e], scale_log2, -((e & 1) ? l2.y : l2.x))) : 0.f;
      }
    }
  };
  // dS^T = P^T (dP^T - delta) in place of dP^T
  auto grad_t = [&](float (&dp)[32], const float (&p)[32], const float* st) {
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 dd = *reinterpret_cast<const float2*>(st + 64 + jn * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * jn + e] = p[4 * jn + e] * (dp[4 * jn + e] - ((e & 1) ? dd.y : dd.x));
    }
  };

  if constexpr (SPLIT) {
    const bool is_k = wg == 1;
    float acc[T::NACC], sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    mbar_wait_warp(sm.once, 0);
    for (int j = 0; j < nt; ++j) {
      const int s = j % ST;
      const uint32_t qt = sm.stage(s), ot = qt + TB;
      const float* st = sstat + s * 128;
      mbar_wait_warp(sm.full(s), (j / ST) & 1);
      pin(sacc);
      pin(pacc);
      wg_fence();
      mma_abt<DV>(sacc, kt, qt);     // S^T: key rows, q columns
      wg_commit();
      if (is_k) {
        mma_abt<DV>(pacc, vt, ot);   // dP^T
        wg_commit();
        wg_wait1();                  // S^T is done; P^T is formed while dP^T runs
      } else {
        wg_wait0();
      }
      pin(sacc);
      probs_t(sacc, st, j);
      uint32_t pa[4][4];
      if (is_k) {
        wg_wait0();
        pin(pacc);
        grad_t(pacc, sacc, st);
        pack_a(pa, pacc);
      } else {
        pack_a(pa, sacc);
      }
      pin(acc);
      pin(pa);
      wg_fence();
      mma_rows<DV>(acc, pa, is_k ? qt : ot);   // dK += dS^T Q, or dV += P^T dO
      wg_commit();
      wg_wait0();
      pin(acc);
      pin(pa);
      mbar_arrive(sm.empty(s));
    }
    if (is_k)
      store_rows<DV>(dk + (size_t)b * Lk * D, acc, row0, Lk, D, scale, scale, w16, g, tig);
    else
      store_rows<DV>(dv + (size_t)b * Lk * D, acc, row0, Lk, D, 1.f, 1.f, w16, g, tig);
  } else {
    float acc_k[T::NACC], acc_v[T::NACC], sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    mbar_wait_warp(sm.once, 0);

    for (int j = sp; j < nt; j += S) {
      const int s = j % ST;
      const uint32_t qt = sm.stage(s), ot = qt + TB;
      const float* st = sstat + s * 128;
      mbar_wait_warp(sm.full(s), (j / ST) & 1);
      pin(sacc);
      pin(pacc);
      wg_fence();
      mma_abt<DV>(sacc, kt, qt);   // S^T: key rows, q columns
      wg_commit();
      mma_abt<DV>(pacc, vt, ot);   // dP^T
      wg_commit();
      wg_wait1();   // S^T is done; P^T and dV run while dP^T does
      pin(sacc);
      probs_t(sacc, st, j);
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, sacc);
      pin(acc_v);
      pin(pa);
      wg_fence();
      mma_rows<DV>(acc_v, pa, ot);
      wg_commit();
      wg_wait1();   // dP^T is done; dS^T and dK run while dV does
      pin(pacc);
      grad_t(pacc, sacc, st);
      pack_a(da, pacc);
      pin(acc_k);
      pin(da);
      wg_fence();
      mma_rows<DV>(acc_k, da, qt);
      wg_commit();
      wg_wait0();
      pin(acc_k);
      pin(acc_v);
      pin(pa);
      pin(da);
      mbar_arrive(sm.empty(s));
    }
    if (S > 1) {
      float both[2 * T::NACC];
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) both[i] = acc_k[i], both[T::NACC + i] = acc_v[i];
      if (!merge_sum<2 * T::NACC>(reinterpret_cast<float*>(sm.base), both, rt, sp, S, t, NC * 128))
        return;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) acc_k[i] = both[i], acc_v[i] = both[T::NACC + i];
    }
    store_rows<DV>(dk + (size_t)b * Lk * D, acc_k, row0, Lk, D, scale, scale, w16, g, tig);
    store_rows<DV>(dv + (size_t)b * Lk * D, acc_v, row0, Lk, D, 1.f, 1.f, w16, g, tig);
  }
}

// ------------------------------------------------------------ host side

// dynamic shared memory of a kernel (the layout of Smem): 1 KB of
// alignment slack, `own` 64-row tiles, the ring, barriers and statistics
template <int DV>
constexpr size_t smem_bytes(int own, int stat_floats) {
  return 1024 + (size_t)(own + 2 * Tiles<DV>::STAGES) * Tiles<DV>::TB + 16 * Tiles<DV>::STAGES +
         16 + 4 * stat_floats;
}

// consumer warpgroups of a block: four in the forward at D <= 40; two at
// D = 80 and 160, whose accumulators would not fit four warpgroups'
// registers without spilling, and in the backward kernels
template <int DV>
constexpr int fwd_nc() { return DV > 64 ? 2 : 4; }
constexpr int BWD_NC = 2;

template <int DV>
cudaError_t fwd_wgmma_launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                             int Lq, int Lk, int D, float scale, int rows, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  constexpr int NC = fwd_nc<DV>();
  if (rows < 1 || NC % rows != 0 || !tensor_map(&tq, q, B, Lq, D) ||
      !tensor_map(&tk, k, B, Lk, D) || !tensor_map(&tv, v, B, Lk, D))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<DV>(NC, 0);
  auto kern = flash_fwd_wgmma_kernel<DV, NC>;
  static const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const int per_block = rows * TILE;
  kern<<<dim3((Lq + per_block - 1) / per_block, B), NC * 128 + 32, smem, s>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, Lq, Lk, D, scale * LOG2E, rows);
  return cudaGetLastError();
}

template <int DV>
cudaError_t bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int B, int Lq, int Lk, int D, float scale, int rows_q,
                             int rows_k, cudaStream_t s) {
  using bf = __nv_bfloat16;
  CUtensorMap tq, tk, tv, tdo;
  // at DV > 128 the dk/dv kernel's two warpgroups share one row tile
  if (rows_q < 1 || rows_k < 1 || BWD_NC % rows_q != 0 || BWD_NC % rows_k != 0 ||
      (DV > 128 && rows_k != 1) ||
      !tensor_map(&tq, q, B, Lq, D) || !tensor_map(&tk, k, B, Lk, D) ||
      !tensor_map(&tv, v, B, Lk, D) || !tensor_map(&tdo, dout, B, Lq, D))
    return cudaErrorInvalidValue;
  constexpr int threads = BWD_NC * 128 + 32;
  const size_t smem_dq = smem_bytes<DV>(2 * BWD_NC, 64 * BWD_NC);
  auto kdq = flash_bwd_dq_wgmma_kernel<DV, BWD_NC>;
  static const cudaError_t e_dq = prepare(kdq, smem_dq);
  if (e_dq != cudaSuccess) return e_dq;
  const int pq = rows_q * TILE, pk = rows_k * TILE;
  kdq<<<dim3((Lq + pq - 1) / pq, B), threads, smem_dq, s>>>(
      tq, tk, tv, tdo, (const bf*)o, (const bf*)dout, lse, delta, (bf*)dq, Lq, Lk, D, scale,
      rows_q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_kv = smem_bytes<DV>(2 * BWD_NC, 128 * Tiles<DV>::STAGES);
  auto kkv = flash_bwd_dkv_wgmma_kernel<DV, BWD_NC>;
  static const cudaError_t e_kv = prepare(kkv, smem_kv);
  if (e_kv != cudaSuccess) return e_kv;
  kkv<<<dim3((Lk + pk - 1) / pk, B), threads, smem_kv, s>>>(
      tq, tk, tv, tdo, lse, delta, (bf*)dk, (bf*)dv, Lq, Lk, D, scale, rows_k);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Lq, int Lk, int D, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) * (3 * TILE * (D + 1) + TILE * PSTRIDE);
  auto kern = flash_fwd_kernel<T, DPT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Lq + TILE - 1) / TILE, B);
  kern<<<grid, NT, smem, s>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Lq, Lk, D,
                              scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  const int rows = B * Lq;
  flash_delta_kernel<T><<<(rows + 255) / 256, 256, 0, s>>>((const T*)dout, (const T*)o, delta,
                                                          rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem_dq = sizeof(float) * (4 * TILE * (D + 1) + TILE * PSTRIDE);
  auto kdq = flash_bwd_dq_kernel<T, DPT>;
  if ((e = allow_smem(kdq, smem_dq)) != cudaSuccess) return e;
  kdq<<<dim3((Lq + TILE - 1) / TILE, B), NT, smem_dq, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, Lq, Lk, D, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem_kv = sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * PSTRIDE + 2 * TILE);
  auto kkv = flash_bwd_dkv_kernel<T, DPT>;
  if ((e = allow_smem(kkv, smem_kv)) != cudaSuccess) return e;
  kkv<<<dim3((Lk + TILE - 1) / TILE, B), NT, smem_kv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, Lq, Lk,
      D, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 (dtype 1) runs the TMA + wgmma kernels with the row tiles per block
// chosen by the wrapper (fwd, dq: over the queries; dk/dv: over the keys)
// at a padded width of 40, 80 or 160; float32 (dtype 0) the CUDA-core
// kernels, with D/4 rounded up to 10, 20 or 40 columns per thread.  The
// paths have D 40, 80 and 160 (the UNet's head widths); D > 160 is refused.
extern "C" int gd_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int Lq, int Lk, int D, float scale, int dtype, int rows,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 160) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 40) return fwd_wgmma_launch<40>(q, k, v, o, lse, B, Lq, Lk, D, scale, rows, st);
    if (D <= 80) return fwd_wgmma_launch<80>(q, k, v, o, lse, B, Lq, Lk, D, scale, rows, st);
    return fwd_wgmma_launch<160>(q, k, v, o, lse, B, Lq, Lk, D, scale, rows, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (D <= 40) return fwd_launch<float, 10>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
  if (D <= 80) return fwd_launch<float, 20>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
  return fwd_launch<float, 40>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
}

extern "C" int gd_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq, void* dk,
                            void* dv, int B, int Lq, int Lk, int D, float scale, int dtype,
                            int rows_q, int rows_k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 160) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 40)
      return bwd_wgmma_launch<40>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale,
                                  rows_q, rows_k, st);
    if (D <= 80)
      return bwd_wgmma_launch<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale,
                                  rows_q, rows_k, st);
    return bwd_wgmma_launch<160>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale,
                                 rows_q, rows_k, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (D <= 40)
    return bwd_launch<float, 10>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
  if (D <= 80)
    return bwd_launch<float, 20>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
  return bwd_launch<float, 40>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
}
