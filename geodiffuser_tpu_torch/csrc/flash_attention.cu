// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces geodiffuser_tpu/kernels/flash_attention.py: _flash_fwd_impl
// (_fwd_kernel) and _flash_bwd_impl (_bwd_dq_kernel, _bwd_dkv_kernel).
//
// What bounds it on the H100: at the main path's shapes (Lq = Lk = 4096,
// D = 40 and Lq = Lk = 1024, D = 80) the work is 4*Lq*Lk*D operations per
// (batch*head) against 2*(Lq + 2*Lk)*D bytes in bf16, about 1000 operations
// per byte: far above the ~295 at which the card stops being memory bound, so
// the tensor-core rate bounds it.  bf16 (the main path) runs every product
// of the forward and the backward on the tensor cores with mma.sync
// (m16n8k16); float32 inputs use float32 FMAs on the CUDA cores (67 TFLOP/s
// peak, not the 989 of bf16 tensor cores) and serve only float32 checks.
// D is at most 80: flash runs on self-attention at 32^2 and 64^2 only.  Loads
// are synchronous and the tiles small; wgmma, TMA and pipelined loads are
// the next steps.
//
// Design: the Pallas grid carried the online-softmax state across sequential
// k blocks in VMEM.  Here one block owns a 64-row q tile and loops over all
// 64-key tiles itself; nothing is carried between blocks.  Each tile row is
// worked by 4 neighbouring lanes (16 logits each, then D/4 output columns
// each), so row max and row sum are two shuffles.  D stays at its native
// width in device memory (40/80) and is padded only by the +1 shared
// memory stride; ragged Lq/Lk are masked in the kernel.  The backward is a
// delta pre-pass, a dq kernel per q tile that loops over k, and a dk/dv
// kernel per k tile that loops over q: no atomics, deterministic.
// Probabilities and dS are rounded to the input type before their product,
// as the Pallas kernels cast them.
#include "common.cuh"

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


// ---------------------------------------------------------------- bf16 forward
// Tensor-core version of the forward for bf16 inputs: mma.sync m16n8k16
// (bf16 x bf16 -> f32).  4 warps x 16 query rows = one 64-row tile; each
// warp keeps its Q fragments in registers, computes S = Q K^T for 64 keys
// (8 n-tiles), runs the online softmax on the accumulators and feeds P
// (rounded to bf16, as the Pallas kernel casts it) straight from the S
// accumulator layout into the A operand of O += P V.  D is padded to a
// multiple of 16 with zeros in shared memory only (D <= 80, so the three
// bf16 tiles fit the 48 KB of static shared memory).  float32 inputs keep
// the CUDA-core kernel above.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int ND>  // ND = padded D / 16
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int D, float scale_log2) {
  constexpr int DP = ND * 16;
  constexpr int SQ = DP + 8;        // row stride (elements) of Q and K tiles
  constexpr int SV = TILE + 8;      // row stride of the transposed V tile
  __shared__ __align__(16) __nv_bfloat16 sQ[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sK[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sVt[DP * SV];
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* qb = q + (size_t)b * Lq * D;
  const __nv_bfloat16* kb = k + (size_t)b * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Lk * D;

  for (int e = threadIdx.x; e < TILE * DP; e += 128) {
    const int r = e / DP, d = e - r * DP;
    sQ[r * SQ + d] = (q0 + r < Lq && d < D) ? qb[(size_t)(q0 + r) * D + d] : zero;
  }
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[ND][4];
#pragma unroll
  for (int kc = 0; kc < ND; ++kc) {
    const int c = kc * 16 + tig * 2;
    qa[kc][0] = ld32(&sQ[(r0 + g) * SQ + c]);
    qa[kc][1] = ld32(&sQ[(r0 + g + 8) * SQ + c]);
    qa[kc][2] = ld32(&sQ[(r0 + g) * SQ + c + 8]);
    qa[kc][3] = ld32(&sQ[(r0 + g + 8) * SQ + c + 8]);
  }
  float acc[ND * 2][4];
#pragma unroll
  for (int i = 0; i < ND * 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8 (partial sums)

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * DP; e += 128) {
      const int r = e / DP, d = e - r * DP;
      const bool ok = k0 + r < Lk && d < D;
      sK[r * SQ + d] = ok ? kb[(size_t)(k0 + r) * D + d] : zero;
      sVt[d * SV + r] = ok ? vb[(size_t)(k0 + r) * D + d] : zero;
    }
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < ND; ++kc) {
        const __nv_bfloat16* kr = &sK[(j * 8 + g) * SQ + kc * 16 + tig * 2];
        mma_bf16(s[j], qa[kc], ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool ok = k0 + j * 8 + tig * 2 + t < Lk;
        s[j][t] = ok ? s[j][t] * scale_log2 : NEG;
        s[j][t + 2] = ok ? s[j][t + 2] * scale_log2 : NEG;
        mx0 = fmaxf(mx0, s[j][t]);
        mx1 = fmaxf(mx1, s[j][t + 2]);
      }
    }
    const float mn0 = fmaxf(m0, max4(mx0)), mn1 = fmaxf(m1, max4(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        s[j][t] = exp2f(s[j][t] - mn0);
        s[j][t + 2] = exp2f(s[j][t + 2] - mn1);
        ps0 += s[j][t];
        ps1 += s[j][t + 2];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int i = 0; i < ND * 2; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step: S n-tiles 2kk, 2kk+1
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < ND * 2; ++dn) {
        const __nv_bfloat16* vr = &sVt[(dn * 8 + g) * SV + kk * 16 + tig * 2];
        mma_bf16(acc[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }
  l0 = sum4(l0);
  l1 = sum4(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + g + half * 8;
    if (row >= Lq) continue;
    const float l = half ? l1 : l0;
    const size_t base = ((size_t)b * Lq + row) * D;
#pragma unroll
    for (int dn = 0; dn < ND * 2; ++dn) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = dn * 8 + tig * 2 + t;
        if (d < D) o[base + d] = __float2bfloat16(acc[dn][half * 2 + t] / l);
      }
    }
    if (tig == 0) lse[(size_t)b * Lq + row] = ((half ? m1 : m0) + log2f(l)) * (1.0f / LOG2E);
  }
}

template <int ND>
cudaError_t fwd_mma_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  dim3 grid((Lq + TILE - 1) / TILE, B);
  flash_fwd_mma_kernel<ND><<<grid, 128, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, Lq, Lk, D, scale * LOG2E);
  return cudaGetLastError();
}


// Tensor-core backward for bf16 at D <= 80, the same fragment scheme as the
// forward.  dq: one block per 64-row q tile loops over k tiles,
// S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.  dk/dv: one block
// per 64-key tile loops over q tiles, S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q.  P and dS are rounded to bf16 before their
// products, as the Pallas kernels cast them.

// the (16 x DP) A fragments of rows [r0, r0 + 16) of a shared-memory tile
template <int ND>
__device__ __forceinline__ void load_a_frags(uint32_t a[ND][4], const __nv_bfloat16* t, int r0,
                                             int stride, int g, int tig) {
#pragma unroll
  for (int kc = 0; kc < ND; ++kc) {
    const int c = kc * 16 + tig * 2;
    a[kc][0] = ld32(&t[(r0 + g) * stride + c]);
    a[kc][1] = ld32(&t[(r0 + g + 8) * stride + c]);
    a[kc][2] = ld32(&t[(r0 + g) * stride + c + 8]);
    a[kc][3] = ld32(&t[(r0 + g + 8) * stride + c + 8]);
  }
}

// acc[j] (16 x 8 tiles j = 0..7) = A (16 x DP) times the 64 rows of B
// (row-major [n][d] tile): the "x B^T" product of S = Q K^T and its kin
template <int ND>
__device__ __forceinline__ void mma_abt(float acc[8][4], const uint32_t a[ND][4],
                                        const __nv_bfloat16* bt, int stride, int g, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < ND; ++kc) {
      const __nv_bfloat16* r = &bt[(j * 8 + g) * stride + kc * 16 + tig * 2];
      mma_bf16(acc[j], a[kc], ld32(r), ld32(r + 8));
    }
  }
}

// out[dn] += P (16 x 64, accumulator layout, rounded to bf16) times the
// transposed tile bt[d][n] (the 64-row operand stored d-major)
template <int ND>
__device__ __forceinline__ void mma_pb(float out[ND * 2][4], const float p[8][4],
                                       const __nv_bfloat16* bt, int g, int tig) {
  constexpr int SV = TILE + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < ND * 2; ++dn) {
      const __nv_bfloat16* r = &bt[(dn * 8 + g) * SV + kk * 16 + tig * 2];
      mma_bf16(out[dn], pa, ld32(r), ld32(r + 8));
    }
  }
}

// rows [r0, r0 + TILE) of a (L, D) bf16 matrix into t[r][d] (stride SQ) and,
// when tt is given, into tt[d][r] (stride SV); zero outside the matrix
template <int DP>
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* t, __nv_bfloat16* tt,
                                               const __nv_bfloat16* g, int r0, int L, int D) {
  constexpr int SQ = DP + 8, SV = TILE + 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < TILE * DP; e += 128) {
    const int r = e / DP, d = e - r * DP;
    const __nv_bfloat16 x = (r0 + r < L && d < D) ? g[(size_t)(r0 + r) * D + d] : zero;
    if (t != nullptr) t[r * SQ + d] = x;
    if (tt != nullptr) tt[d * SV + r] = x;
  }
}

template <int ND>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int D, float scale) {
  constexpr int DP = ND * 16, SQ = DP + 8, SV = TILE + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sV[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sKt[DP * SV];
  const int b = blockIdx.y, q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  // Q and dO fragments, staged through the K and V buffers
  load_bf16_tile<DP>(sK, nullptr, q + (size_t)b * Lq * D, q0, Lq, D);
  load_bf16_tile<DP>(sV, nullptr, dout + (size_t)b * Lq * D, q0, Lq, D);
  __syncthreads();
  uint32_t qa[ND][4], oa[ND][4];
  load_a_frags<ND>(qa, sK, r0, SQ, g, tig);
  load_a_frags<ND>(oa, sV, r0, SQ, g, tig);
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    lse2[h] = row < Lq ? lse[(size_t)b * Lq + row] * LOG2E : 0.f;
    dl[h] = row < Lq ? delta[(size_t)b * Lq + row] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc[ND * 2][4];
#pragma unroll
  for (int i = 0; i < ND * 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_bf16_tile<DP>(sK, sKt, k + (size_t)b * Lk * D, k0, Lk, D);
    load_bf16_tile<DP>(sV, nullptr, v + (size_t)b * Lk * D, k0, Lk, D);
    __syncthreads();
    float sp[8][4], dp[8][4];
    mma_abt<ND>(sp, qa, sK, SQ, g, tig);
    mma_abt<ND>(dp, oa, sV, SQ, g, tig);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = k0 + j * 8 + tig * 2 + (e & 1) < Lk;
        const float p = ok ? exp2f(sp[j][e] * scale_log2 - lse2[h]) : 0.f;
        sp[j][e] = p * (dp[j][e] - dl[h]);   // dS
      }
    }
    mma_pb<ND>(acc, sp, sKt, g, tig);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + g + 8 * h;
    if (row >= Lq) continue;
    const size_t base = ((size_t)b * Lq + row) * D;
#pragma unroll
    for (int dn = 0; dn < ND * 2; ++dn) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = dn * 8 + tig * 2 + t;
        if (d < D) dq[base + d] = __float2bfloat16(acc[dn][h * 2 + t] * scale);
      }
    }
  }
}

template <int ND>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int D, float scale) {
  constexpr int DP = ND * 16, SQ = DP + 8, SV = TILE + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sO[TILE * SQ];
  __shared__ __align__(16) __nv_bfloat16 sQt[DP * SV];
  __shared__ __align__(16) __nv_bfloat16 sOt[DP * SV];
  __shared__ float sL[TILE], sD[TILE];
  const int b = blockIdx.y, k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;  // key rows of this warp
  load_bf16_tile<DP>(sQ, nullptr, k + (size_t)b * Lk * D, k0, Lk, D);
  load_bf16_tile<DP>(sO, nullptr, v + (size_t)b * Lk * D, k0, Lk, D);
  __syncthreads();
  uint32_t ka[ND][4], va[ND][4];
  load_a_frags<ND>(ka, sQ, r0, SQ, g, tig);
  load_a_frags<ND>(va, sO, r0, SQ, g, tig);
  const float scale_log2 = scale * LOG2E;
  float acc_k[ND * 2][4], acc_v[ND * 2][4];
#pragma unroll
  for (int i = 0; i < ND * 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += TILE) {
    __syncthreads();
    load_bf16_tile<DP>(sQ, sQt, q + (size_t)b * Lq * D, q0, Lq, D);
    load_bf16_tile<DP>(sO, sOt, dout + (size_t)b * Lq * D, q0, Lq, D);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      sL[threadIdx.x] = qi < Lq ? lse[(size_t)b * Lq + qi] * LOG2E : 0.f;
      sD[threadIdx.x] = qi < Lq ? delta[(size_t)b * Lq + qi] : 0.f;
    }
    __syncthreads();
    float st[8][4], dpt[8][4];
    mma_abt<ND>(st, ka, sQ, SQ, g, tig);
    mma_abt<ND>(dpt, va, sO, SQ, g, tig);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);  // q column of the tile
        const float p = q0 + c < Lq ? exp2f(st[j][e] * scale_log2 - sL[c]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sD[c]);     // dS^T
      }
    }
    mma_pb<ND>(acc_v, st, sOt, g, tig);
    mma_pb<ND>(acc_k, dpt, sQt, g, tig);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + r0 + g + 8 * h;
    if (row >= Lk) continue;
    const size_t base = ((size_t)b * Lk + row) * D;
#pragma unroll
    for (int dn = 0; dn < ND * 2; ++dn) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = dn * 8 + tig * 2 + t;
        if (d < D) {
          dk[base + d] = __float2bfloat16(acc_k[dn][h * 2 + t] * scale);
          dv[base + d] = __float2bfloat16(acc_v[dn][h * 2 + t]);
        }
      }
    }
  }
}

template <int ND>
cudaError_t bwd_mma_launch(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int B, int Lq, int Lk, int D, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const int rows = B * Lq;
  flash_delta_kernel<bf><<<(rows + 255) / 256, 256, 0, s>>>((const bf*)dout, (const bf*)o, delta,
                                                            rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_mma_kernel<ND><<<dim3((Lq + TILE - 1) / TILE, B), 128, 0, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta, (bf*)dq, Lq, Lk, D,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkv_mma_kernel<ND><<<dim3((Lk + TILE - 1) / TILE, B), 128, 0, s>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, delta, (bf*)dk, (bf*)dv, Lq,
      Lk, D, scale);
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

// bf16 (dtype 1) runs on the tensor cores; float32 (dtype 0) on the CUDA
// cores, with D/4 rounded up to 10 or 20 columns per thread.  The main path
// has D 40 and 80 only; D > 80 is refused.
extern "C" int gd_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int Lq, int Lk, int D, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 80) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 48) return fwd_mma_launch<3>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
    return fwd_mma_launch<5>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (D <= 40) return fwd_launch<float, 10>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
  return fwd_launch<float, 20>(q, k, v, o, lse, B, Lq, Lk, D, scale, st);
}

extern "C" int gd_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq, void* dk,
                            void* dv, int B, int Lq, int Lk, int D, float scale, int dtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 80) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D <= 48)
      return bwd_mma_launch<3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
    return bwd_mma_launch<5>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (D <= 40)
    return bwd_launch<float, 10>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
  return bwd_launch<float, 20>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Lq, Lk, D, scale, st);
}
