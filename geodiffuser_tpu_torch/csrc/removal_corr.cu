// Removal-correlation loss kernels, forward and backward, for Hopper (sm_90a).
//
// Replaces geodiffuser_tpu/kernels/removal_corr.py: _corr_pallas
// (_corr_kernel) and _corr_bwd_pallas (_corr_bwd_kernel).
//
//   corr[h,i,j] = sum_k softmax(qe ke^T s)[i,k] * softmax(qb kb^T s)[j,k]
//   p_in/j_in, p_bg/j_bg = masked max/argmax over j of corr
//
// What bounds it on the H100: per live row tile it needs L*Lk*D operations
// for the base probabilities and K*L*Lk for the correlation, against inputs
// of a few MB: thousands of operations per byte, so arithmetic bounds it.
// This first version multiplies with float32 FMAs on the CUDA cores.
//
// Design: the Pallas grid carried two online softmaxes and a rescaled
// correlation tile across sequential (j, k) grid steps.  Here a first pass
// computes the natural-log LSE of every edit row (H, K) and every base row
// (H, L); with those, each probability is exp(s - lse) exactly, and every
// correlation tile is a plain sum with no double online rescale.  One block
// owns (head, 64 edit rows, one span of base rows j) and loops over that
// span and over all keys, keeping a running masked max and argmax; a small
// combine pass merges the spans in order.  Ties resolve to the lowest j at
// every level (strict '>' in order, lowest index across lanes), as
// jnp.argmax does.  Probabilities are rounded to bf16 before the product
// (_probs), sums are float32.  Rows whose row_mask is 0 return NEG_INF and
// index 0, and a tile of only dead rows does no work.
//
// The backward (the sparse analytic VJP of _rc_bwd) is two deterministic
// kernels and no atomics: kernel A owns 64 edit rows, computes
// c_i = <d_pe, pe> and d_qe = s * t ke with t = pe * (d_pe - c); kernel B owns
// 64 keys and loops over the live row tiles, recomputing t from the saved
// per-row scalars to form d_ke = s * t^T qe.
#include "common.cuh"

using namespace gd;

namespace {

constexpr float NEG_INF = -1e30f;   // dead-row sentinel (removal_corr.NEG_INF)
constexpr float MASKED = -1e9f;     // mask-excluded correlation
constexpr int JSPAN = 256;          // base rows j per forward block

// Whether any of rows [r0, r0 + TILE) is live; every thread gets the answer
// (the call is a barrier).
__device__ __forceinline__ bool tile_live(const float* row_mask, int r0, int R) {
  const int i = r0 + (int)threadIdx.x;
  return __syncthreads_or(threadIdx.x < TILE && i < R && row_mask[i] > 0.5f) != 0;
}

// Natural-log LSE of scale * q k^T per row of q (H, R, D) against k (H, Lk, D).
template <typename T, int UNUSED>
__global__ void __launch_bounds__(NT)
row_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ lse,
               const float* __restrict__ row_mask, int R, int Lk, int D, float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sQ = sm;
  float* sK = sQ + TILE * sd;
  const int h = blockIdx.y, r0 = blockIdx.x * TILE;
  if (row_mask != nullptr && !tile_live(row_mask, r0, R)) return;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;
  load_tile(sQ, q + (size_t)h * R * D, r0, R, D, sd);
  const T* kh = k + (size_t)h * Lk * D;
  const float scale_log2 = scale * LOG2E;
  float m = NEG, l = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_tile(sK, kh, k0, Lk, D, sd);
    __syncthreads();
    float s[16], mx = NEG;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = l4 + 4 * j;
      s[j] = (k0 + c < Lk) ? dot_row(sQ + r * sd, sK + c * sd, D) * scale_log2 : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, max4(mx));
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) ps += exp2f(s[j] - m_new);
    l = l * exp2f(m - m_new) + sum4(ps);
    m = m_new;
  }
  if (l4 == 0 && r0 + r < R) lse[(size_t)h * R + r0 + r] = (m + log2f(l)) * (1.0f / LOG2E);
}

template <typename T, int UNUSED>
__global__ void __launch_bounds__(NT)
corr_span_kernel(const T* __restrict__ qe, const T* __restrict__ ke, const T* __restrict__ qb,
                 const T* __restrict__ kb, const float* __restrict__ inpaint,
                 const float* __restrict__ background, const float* __restrict__ row_mask,
                 const float* __restrict__ lse_e, const float* __restrict__ lse_b,
                 float* __restrict__ part_val, int* __restrict__ part_idx, int K, int L, int Lk,
                 int D, float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sQe = sm;
  float* sQb = sQe + TILE * sd;
  float* sKe = sQb + TILE * sd;
  float* sKb = sKe + TILE * sd;
  float* sPe = sKb + TILE * sd;
  float* sPb = sPe + TILE * PSTRIDE;
  float* sLe = sPb + TILE * PSTRIDE;
  float* sLb = sLe + TILE;
  float* sIn = sLb + TILE;
  float* sBg = sIn + TILE;
  const int h = blockIdx.y, i0 = blockIdx.x * TILE, span = blockIdx.z, spans = gridDim.z;
  if (!tile_live(row_mask, i0, K)) return;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;
  load_tile(sQe, qe + (size_t)h * K * D, i0, K, D, sd);
  if (threadIdx.x < TILE)
    sLe[threadIdx.x] = i0 + threadIdx.x < K ? lse_e[(size_t)h * K + i0 + threadIdx.x] : 0.f;
  const T* keh = ke + (size_t)h * Lk * D;
  const T* kbh = kb + (size_t)h * Lk * D;
  float best_in = NEG_INF, best_bg = NEG_INF;
  int idx_in = 0, idx_bg = 0;
  const int j_end = min(L, (span + 1) * JSPAN);
  for (int j0 = span * JSPAN; j0 < j_end; j0 += TILE) {
    __syncthreads();
    load_tile(sQb, qb + (size_t)h * L * D, j0, L, D, sd);
    if (threadIdx.x < TILE) {
      const int jg = j0 + threadIdx.x;
      const bool ok = jg < L;
      sLb[threadIdx.x] = ok ? lse_b[(size_t)h * L + jg] : 0.f;
      sIn[threadIdx.x] = ok ? inpaint[jg] : 0.f;
      sBg[threadIdx.x] = ok ? background[jg] : 0.f;
    }
    float c[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) c[m] = 0.f;
    for (int k0 = 0; k0 < Lk; k0 += TILE) {
      __syncthreads();
      load_tile(sKe, keh, k0, Lk, D, sd);
      load_tile(sKb, kbh, k0, Lk, D, sd);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int kc = l4 + 4 * j;
        float pe = 0.f, pb = 0.f;
        if (k0 + kc < Lk) {
          pe = rnd_bf16(expf(dot_row(sQe + r * sd, sKe + kc * sd, D) * scale - sLe[r]));
          pb = rnd_bf16(expf(dot_row(sQb + r * sd, sKb + kc * sd, D) * scale - sLb[r]));
        }
        sPe[r * PSTRIDE + kc] = pe;
        sPb[r * PSTRIDE + kc] = pb;
      }
      __syncthreads();
      for (int kc = 0; kc < TILE; ++kc) {
        const float pe = sPe[r * PSTRIDE + kc];
#pragma unroll
        for (int m = 0; m < 16; ++m) c[m] = fmaf(pe, sPb[(l4 + 4 * m) * PSTRIDE + kc], c[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) {  // increasing j: strict '>' keeps the lowest j
      const int jj = l4 + 4 * m, jg = j0 + jj;
      if (jg < L) {
        const float v_in = sIn[jj] > 0.5f ? c[m] : MASKED;
        const float v_bg = sBg[jj] > 0.5f ? c[m] : MASKED;
        if (v_in > best_in) { best_in = v_in; idx_in = jg; }
        if (v_bg > best_bg) { best_bg = v_bg; idx_bg = jg; }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov_in = __shfl_xor_sync(0xffffffffu, best_in, off);
    const int oi_in = __shfl_xor_sync(0xffffffffu, idx_in, off);
    const float ov_bg = __shfl_xor_sync(0xffffffffu, best_bg, off);
    const int oi_bg = __shfl_xor_sync(0xffffffffu, idx_bg, off);
    if (ov_in > best_in || (ov_in == best_in && oi_in < idx_in)) { best_in = ov_in; idx_in = oi_in; }
    if (ov_bg > best_bg || (ov_bg == best_bg && oi_bg < idx_bg)) { best_bg = ov_bg; idx_bg = oi_bg; }
  }
  if (l4 == 0 && i0 + r < K) {
    const size_t o = (((size_t)h * K + i0 + r) * spans + span) * 2;
    part_val[o] = best_in;
    part_idx[o] = idx_in;
    part_val[o + 1] = best_bg;
    part_idx[o + 1] = idx_bg;
  }
}

__global__ void corr_combine_kernel(const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx,
                                    const float* __restrict__ row_mask, float* __restrict__ p_in,
                                    float* __restrict__ p_bg, int* __restrict__ j_in,
                                    int* __restrict__ j_bg, int H, int K, int spans) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= H * K) return;
  const int i = t % K;
  float b_in = NEG_INF, b_bg = NEG_INF;
  int x_in = 0, x_bg = 0;
  if (row_mask[i] > 0.5f) {
    for (int s = 0; s < spans; ++s) {  // spans in j order: strict '>' keeps the lowest j
      const size_t o = ((size_t)t * spans + s) * 2;
      if (s == 0 || part_val[o] > b_in) { b_in = part_val[o]; x_in = part_idx[o]; }
      if (s == 0 || part_val[o + 1] > b_bg) { b_bg = part_val[o + 1]; x_bg = part_idx[o + 1]; }
    }
  }
  p_in[t] = b_in;
  p_bg[t] = b_bg;
  j_in[t] = x_in;
  j_bg[t] = x_bg;
}

// ------------------------------------------------------------------ backward

// t[i, kc] of one (edit row, key) pair from the per-row scalars.
struct RowScalars {
  float lse_e, lse_in, lse_bg, g_in, g_bg, c;
};

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
corr_bwd_rows_kernel(const T* __restrict__ qe, const T* __restrict__ ke,
                     const T* __restrict__ q_in, const T* __restrict__ q_bg,
                     const T* __restrict__ kb, const float* __restrict__ g_in,
                     const float* __restrict__ g_bg, const float* __restrict__ row_mask,
                     const float* __restrict__ lse_e, const float* __restrict__ lse_in,
                     const float* __restrict__ lse_bg, float* __restrict__ c_out,
                     float* __restrict__ dqe, int K, int Lk, int D, float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sQe = sm;
  float* sQi = sQe + TILE * sd;
  float* sQg = sQi + TILE * sd;
  float* sKe = sQg + TILE * sd;
  float* sKb = sKe + TILE * sd;
  float* sT = sKb + TILE * sd;
  const int h = blockIdx.y, i0 = blockIdx.x * TILE;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;
  const bool row_ok = i0 + r < K;
  const size_t row = (size_t)h * K + i0 + r;
  if (!tile_live(row_mask, i0, K)) {
    if (row_ok)
      for (int d = l4; d < D; d += 4) dqe[row * D + d] = 0.f;
    return;
  }
  load_tile(sQe, qe + (size_t)h * K * D, i0, K, D, sd);
  load_tile(sQi, q_in + (size_t)h * K * D, i0, K, D, sd);
  load_tile(sQg, q_bg + (size_t)h * K * D, i0, K, D, sd);
  const float le = row_ok ? lse_e[row] : 0.f, li = row_ok ? lse_in[row] : 0.f;
  const float lb = row_ok ? lse_bg[row] : 0.f;
  const float gi = row_ok ? g_in[row] : 0.f, gb = row_ok ? g_bg[row] : 0.f;
  const T* keh = ke + (size_t)h * Lk * D;
  const T* kbh = kb + (size_t)h * Lk * D;

  // pass 1: c = <d_pe, pe> over all keys
  float cp = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_tile(sKe, keh, k0, Lk, D, sd);
    load_tile(sKb, kbh, k0, Lk, D, sd);
    __syncthreads();
    for (int j = 0; j < 16; ++j) {
      const int kc = l4 + 4 * j;
      if (k0 + kc < Lk) {
        const float pe = expf(dot_row(sQe + r * sd, sKe + kc * sd, D) * scale - le);
        const float pi = rnd_bf16(expf(dot_row(sQi + r * sd, sKb + kc * sd, D) * scale - li));
        const float pg = rnd_bf16(expf(dot_row(sQg + r * sd, sKb + kc * sd, D) * scale - lb));
        cp = fmaf(gi * pi + gb * pg, pe, cp);
      }
    }
  }
  const float c = sum4(cp);
  if (l4 == 0 && row_ok) c_out[row] = c;

  // pass 2: d_qe = scale * t ke
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += TILE) {
    __syncthreads();
    load_tile(sKe, keh, k0, Lk, D, sd);
    load_tile(sKb, kbh, k0, Lk, D, sd);
    __syncthreads();
    for (int j = 0; j < 16; ++j) {
      const int kc = l4 + 4 * j;
      float t = 0.f;
      if (k0 + kc < Lk) {
        const float pe = expf(dot_row(sQe + r * sd, sKe + kc * sd, D) * scale - le);
        const float pi = rnd_bf16(expf(dot_row(sQi + r * sd, sKb + kc * sd, D) * scale - li));
        const float pg = rnd_bf16(expf(dot_row(sQg + r * sd, sKb + kc * sd, D) * scale - lb));
        t = pe * (gi * pi + gb * pg - c);
      }
      sT[r * PSTRIDE + kc] = t;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float a = acc[i];
        for (int kc = 0; kc < TILE; ++kc) a = fmaf(sT[r * PSTRIDE + kc], sKe[kc * sd + d], a);
        acc[i] = a;
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) dqe[row * D + d] = acc[i] * scale;
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(NT)
corr_bwd_keys_kernel(const T* __restrict__ qe, const T* __restrict__ ke,
                     const T* __restrict__ q_in, const T* __restrict__ q_bg,
                     const T* __restrict__ kb, const float* __restrict__ g_in,
                     const float* __restrict__ g_bg, const float* __restrict__ row_mask,
                     const float* __restrict__ lse_e, const float* __restrict__ lse_in,
                     const float* __restrict__ lse_bg, const float* __restrict__ c_rows,
                     float* __restrict__ dke, int K, int Lk, int D, float scale) {
  extern __shared__ float sm[];
  const int sd = D + 1;
  float* sKe = sm;
  float* sKb = sKe + TILE * sd;
  float* sQe = sKb + TILE * sd;
  float* sQi = sQe + TILE * sd;
  float* sQg = sQi + TILE * sd;
  float* sT = sQg + TILE * sd;
  RowScalars* sR = reinterpret_cast<RowScalars*>(sT + TILE * PSTRIDE);
  const int h = blockIdx.y, k0 = blockIdx.x * TILE;
  const int r = threadIdx.x >> 2, l4 = threadIdx.x & 3;  // r: key row of the tile
  load_tile(sKe, ke + (size_t)h * Lk * D, k0, Lk, D, sd);
  load_tile(sKb, kb + (size_t)h * Lk * D, k0, Lk, D, sd);
  const bool key_ok = k0 + r < Lk;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  for (int i0 = 0; i0 < K; i0 += TILE) {
    if (!tile_live(row_mask, i0, K)) continue;  // uniform: the test is a barrier
    load_tile(sQe, qe + (size_t)h * K * D, i0, K, D, sd);
    load_tile(sQi, q_in + (size_t)h * K * D, i0, K, D, sd);
    load_tile(sQg, q_bg + (size_t)h * K * D, i0, K, D, sd);
    if (threadIdx.x < TILE) {
      const int i = i0 + threadIdx.x;
      RowScalars s = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (i < K) {
        const size_t o = (size_t)h * K + i;
        s = RowScalars{lse_e[o], lse_in[o], lse_bg[o], g_in[o], g_bg[o], c_rows[o]};
      }
      sR[threadIdx.x] = s;
    }
    __syncthreads();
    for (int j = 0; j < 16; ++j) {
      const int ic = l4 + 4 * j;  // edit row of the tile
      const RowScalars s = sR[ic];
      float t = 0.f;
      if (key_ok && i0 + ic < K) {
        const float pe = expf(dot_row(sKe + r * sd, sQe + ic * sd, D) * scale - s.lse_e);
        const float pi = rnd_bf16(expf(dot_row(sKb + r * sd, sQi + ic * sd, D) * scale - s.lse_in));
        const float pg = rnd_bf16(expf(dot_row(sKb + r * sd, sQg + ic * sd, D) * scale - s.lse_bg));
        t = pe * (s.g_in * pi + s.g_bg * pg - s.c);
      }
      sT[r * PSTRIDE + ic] = t;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float a = acc[i];
        for (int ic = 0; ic < TILE; ++ic) a = fmaf(sT[r * PSTRIDE + ic], sQe[ic * sd + d], a);
        acc[i] = a;
      }
    }
  }
  if (key_ok) {
    const size_t row = (size_t)h * Lk + k0 + r;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) dke[row * D + d] = acc[i] * scale;
    }
  }
}

inline size_t tile_bytes(int n_tiles, int D) { return sizeof(float) * n_tiles * TILE * (D + 1); }

template <typename T, int DPT>
cudaError_t row_lse(const void* q, const void* k, float* lse, const float* row_mask, int H, int R,
                    int Lk, int D, float scale, cudaStream_t s) {
  const size_t smem = tile_bytes(2, D);
  auto kern = row_lse_kernel<T, DPT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((R + TILE - 1) / TILE, H), NT, smem, s>>>((const T*)q, (const T*)k, lse, row_mask,
                                                        R, Lk, D, scale);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t corr_fwd(const void* qe, const void* ke, const void* qb, const void* kb,
                     const float* inpaint, const float* background, const float* row_mask,
                     float* lse_e, float* lse_b, float* part_val, int* part_idx, float* p_in,
                     float* p_bg, int* j_in, int* j_bg, int H, int K, int L, int Lk, int D,
                     float scale, cudaStream_t s) {
  cudaError_t e = row_lse<T, DPT>(qe, ke, lse_e, row_mask, H, K, Lk, D, scale, s);
  if (e != cudaSuccess) return e;
  if ((e = row_lse<T, DPT>(qb, kb, lse_b, nullptr, H, L, Lk, D, scale, s)) != cudaSuccess) return e;
  const int spans = (L + JSPAN - 1) / JSPAN;
  const size_t smem = tile_bytes(4, D) + sizeof(float) * (2 * TILE * PSTRIDE + 4 * TILE);
  auto kern = corr_span_kernel<T, DPT>;
  if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
  kern<<<dim3((K + TILE - 1) / TILE, H, spans), NT, smem, s>>>(
      (const T*)qe, (const T*)ke, (const T*)qb, (const T*)kb, inpaint, background, row_mask, lse_e,
      lse_b, part_val, part_idx, K, L, Lk, D, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  corr_combine_kernel<<<(H * K + 255) / 256, 256, 0, s>>>(part_val, part_idx, row_mask, p_in, p_bg,
                                                          j_in, j_bg, H, K, spans);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t corr_bwd(const void* qe, const void* ke, const void* kb, const void* q_in,
                     const void* q_bg, const float* g_in, const float* g_bg,
                     const float* row_mask, float* scratch, float* dqe, float* dke, int H, int K,
                     int Lk, int D, float scale, cudaStream_t s) {
  float* lse_e = scratch;
  float* lse_in = lse_e + (size_t)H * K;
  float* lse_bg = lse_in + (size_t)H * K;
  float* c_rows = lse_bg + (size_t)H * K;
  cudaError_t e = row_lse<T, DPT>(qe, ke, lse_e, row_mask, H, K, Lk, D, scale, s);
  if (e != cudaSuccess) return e;
  if ((e = row_lse<T, DPT>(q_in, kb, lse_in, row_mask, H, K, Lk, D, scale, s)) != cudaSuccess)
    return e;
  if ((e = row_lse<T, DPT>(q_bg, kb, lse_bg, row_mask, H, K, Lk, D, scale, s)) != cudaSuccess)
    return e;
  const size_t smem_a = tile_bytes(5, D) + sizeof(float) * TILE * PSTRIDE;
  auto ka = corr_bwd_rows_kernel<T, DPT>;
  if ((e = allow_smem(ka, smem_a)) != cudaSuccess) return e;
  ka<<<dim3((K + TILE - 1) / TILE, H), NT, smem_a, s>>>(
      (const T*)qe, (const T*)ke, (const T*)q_in, (const T*)q_bg, (const T*)kb, g_in, g_bg,
      row_mask, lse_e, lse_in, lse_bg, c_rows, dqe, K, Lk, D, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem_b =
      tile_bytes(5, D) + sizeof(float) * TILE * PSTRIDE + sizeof(RowScalars) * TILE;
  auto kb_ = corr_bwd_keys_kernel<T, DPT>;
  if ((e = allow_smem(kb_, smem_b)) != cudaSuccess) return e;
  kb_<<<dim3((Lk + TILE - 1) / TILE, H), NT, smem_b, s>>>(
      (const T*)qe, (const T*)ke, (const T*)q_in, (const T*)q_bg, (const T*)kb, g_in, g_bg,
      row_mask, lse_e, lse_in, lse_bg, c_rows, dke, K, Lk, D, scale);
  return cudaGetLastError();
}

// Dispatch on element type (0 = float32, 1 = bfloat16) and on the number of
// head-dim columns each thread owns (D/4 rounded up to 10 or 20).  The loss
// runs at 32^2 and 64^2 only (D 80 and 40); D > 80 is refused.
#define GD_DISPATCH(DTYPE, D, FN, ...)                                           \
  do {                                                                           \
    if ((D) < 1 || (D) > 80) return cudaErrorInvalidValue;                       \
    if ((DTYPE) == 0) {                                                          \
      if ((D) <= 40) return FN<float, 10>(__VA_ARGS__);                          \
      return FN<float, 20>(__VA_ARGS__);                                         \
    }                                                                            \
    if ((DTYPE) == 1) {                                                          \
      if ((D) <= 40) return FN<__nv_bfloat16, 10>(__VA_ARGS__);                  \
      return FN<__nv_bfloat16, 20>(__VA_ARGS__);                                 \
    }                                                                            \
    return cudaErrorInvalidValue;                                                \
  } while (0)

}  // namespace

extern "C" int gd_corr_spans(int L) { return (L + JSPAN - 1) / JSPAN; }

extern "C" int gd_corr_fwd(const void* qe, const void* ke, const void* qb, const void* kb,
                           const float* inpaint, const float* background, const float* row_mask,
                           float* lse_e, float* lse_b, float* part_val, int* part_idx,
                           float* p_in, float* p_bg, int* j_in, int* j_bg, int H, int K, int L,
                           int Lk, int D, float scale, int dtype, void* stream) {
  GD_DISPATCH(dtype, D, corr_fwd, qe, ke, qb, kb, inpaint, background, row_mask, lse_e, lse_b,
              part_val, part_idx, p_in, p_bg, j_in, j_bg, H, K, L, Lk, D, scale,
              (cudaStream_t)stream);
}

extern "C" int gd_corr_bwd(const void* qe, const void* ke, const void* kb, const void* q_in,
                           const void* q_bg, const float* g_in, const float* g_bg,
                           const float* row_mask, float* scratch, float* dqe, float* dke, int H,
                           int K, int Lk, int D, float scale, int dtype, void* stream) {
  GD_DISPATCH(dtype, D, corr_bwd, qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, scratch, dqe, dke,
              H, K, Lk, D, scale, (cudaStream_t)stream);
}
