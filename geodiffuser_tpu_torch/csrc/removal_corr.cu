// Removal-correlation loss kernels, forward and backward, for Hopper (sm_90a).
//
// Replaces geodiffuser_tpu/kernels/removal_corr.py: _corr_pallas
// (_corr_kernel) and _corr_bwd_pallas (_corr_bwd_kernel).
//
//   corr[h,i,j] = sum_k softmax(qe ke^T s)[i,k] * softmax(qb kb^T s)[j,k]
//   p_in/j_in, p_bg/j_bg = masked max/argmax over j of corr
//
// Probabilities are rounded to bf16 before the product (_probs), sums are
// float32; ties resolve to the lowest j; rows whose row_mask is 0 return
// NEG_INF and index 0, and 64-row chunks of only dead rows cost no work.
//
// What bounds it on the H100: per head, L*Lk*D operations for the base
// probabilities and (live rows)*L*Lk for the correlation, against inputs of a
// few MB, and L*Lk exponentials: the tensor cores and the special-function
// unit, not memory.
//
// bf16 (the main path), every product on wgmma fed by TMA rings
// (hopper.cuh), each probability computed once:
//  1. lse pass (sweep_kernel, mode BASE): the natural-log LSE of every base
//     row, skipped when no row of the budget is live (read on the device);
//  2. (mode EDIT_LSE, EDIT_P) the live 64-row chunks of edit rows: LSE
//     partials over key splits, then P_e = bf16(exp(s - lse_e)) written once
//     into a bf16 scratch (H, K, Lk_pad), zero at keys >= Lk;
//  3. corr_wgmma_kernel: a flash-like forward in which P_e plays V: one
//     block owns a head and 64 base rows j; per key tile it forms
//     S_b = Qb Kb^T, P_b = bf16(exp(S_b - lse_b)) in registers and
//     C^T += P_b P_e^T over up to CH live chunks of edit rows (the next
//     tile's S_b and P_b overlap this tile's products), then takes
//     the masked max/argmax of each column i over its rows j as one 64-bit
//     key (ordered value, inverted j) per column, merged by atomicMax in
//     shared and then device memory: max is order-free, so the result is
//     deterministic and the lowest j wins ties at every level;
//  4. corr_finalize_kernel decodes the keys and writes the dead rows.
// The backward takes the forward's LSEs (no LSE pass):
//  d_qe = s * (A - c B) with A = sum_k pe d ke, B = sum_k pe ke,
//  c = sum_k pe d and d = g_in p_in + g_bg p_bg, from one key sweep split
//  over blocks (bwd_rows_kernel) and a fixed-order merge (bwd_merge_kernel);
//  d_ke = s * t^T qe with t = pe (d - c) per 64 keys over the live chunks
//  (bwd_keys_kernel).  pe, pe d and t go to the tensor cores as bf16 pairs
//  (value and rounding residual), so the float32 products of the plain
//  version hold.  No atomics in the backward.
//
// float32 inputs run the CUDA-core kernels below, which serve the float32
// checks and the card-vs-CPU reference edits: a first pass computes the
// LSE of every edit and base row; one block owns (head, 64 edit rows, one
// span of base rows j) and loops over that span and all keys, keeping a
// running masked max and argmax; a combine pass merges the spans in order.
// Their backward is two kernels: A owns 64 edit rows, computes
// c_i = <d_pe, pe> and d_qe = s * t ke with t = pe * (d_pe - c); B owns 64
// keys and loops over the live row tiles to form d_ke = s * t^T qe.
#include "hopper.cuh"

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

// ------------------------------------------------------ bf16: TMA + wgmma

constexpr int CH = 4;            // live chunks per pass of the correlation kernel

// 64-row chunks of a budget of K edit rows; a kernel's list of its live
// chunks holds that many entries and the count after them
__host__ __device__ constexpr int chunks_of(int K) { return (K + 63) / 64; }
inline size_t chunk_list_bytes(int K) { return sizeof(int) * (chunks_of(K) + 1); }

enum SweepMode { BASE_LSE = 0, EDIT_LSE = 1, EDIT_P = 2 };

// Dynamic shared memory of a ring kernel: `own` bytes of the block's own
// tiles, then `stages` stages of `stage_bytes`, the full and empty barriers,
// one barrier for the own tiles, and `extra` bytes (8-byte aligned).
struct Ring {
  uint8_t* base;
  uint32_t own, ring, bars, stage_bytes;
  int stages;
  __device__ Ring(uint8_t* raw, uint32_t own_bytes, uint32_t sb, int st) : stage_bytes(sb), stages(st) {
    base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    own = smem_u32(base);
    ring = own + own_bytes;
    bars = ring + st * sb;
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ uint32_t once() const { return bars + 16 * stages; }
  __device__ uint32_t stage(int s) const { return ring + s * stage_bytes; }
  __device__ uint8_t* extra() const { return base + (once() + 8 - own); }
  // one thread: full barriers count `producers` arrivals, empty barriers
  // `consumers`
  __device__ void init(int producers, int consumers) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), producers);
      mbar_init(empty(s), consumers);
    }
    mbar_init(once(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // use n of the ring (n = 0, 1, ...): wait until its stage is free
  __device__ void wait_free(int n) const {
    if (n >= stages) mbar_wait(empty(n % stages), ((n / stages) - 1) & 1);
  }
  __device__ void wait_full(int n) const { mbar_wait_warp(full(n % stages), (n / stages) & 1); }
};

inline size_t ring_smem(size_t own, size_t stage_bytes, int stages, size_t extra) {
  return 1024 + own + stages * stage_bytes + 16 * stages + 8 + extra;
}

// prepare() for a kernel whose shared memory grows with its input (the
// chunk list): raised to the largest size launched so far, never lowered
template <typename Kernel>
cudaError_t prepare_at_least(Kernel k, size_t bytes, size_t& prepared) {
  if (bytes <= prepared) return cudaSuccess;
  const cudaError_t e = prepare(k, bytes);
  if (e == cudaSuccess) prepared = bytes;
  return e;
}

// Whether any of row_mask[lo, hi) is live; a barrier of the whole block.
__device__ __forceinline__ bool any_live(const float* row_mask, int lo, int hi) {
  bool live = false;
  for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) live |= row_mask[i] > 0.5f;
  return __syncthreads_or(live) != 0;
}

// The 64-row chunks of row_mask (K rows) that hold a live row, in order:
// list[0..n), n in list[chunks_of(K)].  Warp 0 writes; the caller syncs.
__device__ __forceinline__ void live_chunks(const float* row_mask, int K, int* list) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int n = 0;
  for (int c = 0; c < (K + 63) / 64; ++c) {
    const int i0 = c * 64 + lane, i1 = i0 + 32;
    const bool live = (i0 < K && row_mask[i0] > 0.5f) || (i1 < K && row_mask[i1] > 0.5f);
    if (__any_sync(0xffffffffu, live)) {
      if (lane == 0) list[n] = c;
      ++n;
    }
  }
  if (lane == 0) list[chunks_of(K)] = n;
}

// bf16 pairs of a 64 x 64 accumulator as A fragments (pack_a), split into
// the rounded values and their rounding residuals: hi + lo carries ~16 bits
// of each float32 value into a bf16 product
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kc + 2 * r], b = s[8 * kc + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kc][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kc][r] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// Store a 64 x DV float32 accumulator (times mul) as rows [row0, row0 + 64)
// of an (R, D) matrix; the warp's rows are w16 + g and w16 + g + 8.
template <int DV>
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[DV / 2], int row0,
                                               int R, int D, float mul, int w16, int g, int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + w16 + g + 8 * h;
    if (row >= R) continue;
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn) {
      const int c = jn * 8 + tig * 2;
      if (c < D)
        *reinterpret_cast<float2*>(out + (size_t)row * D + c) =
            make_float2(acc[4 * jn + 2 * h] * mul, acc[4 * jn + 2 * h + 1] * mul);
    }
  }
}

// Zero the columns of S at keys >= Lk (TMA's zero rows give s = 0, not -inf)
// to `fill`.
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int Lk, int tig, float fill) {
  if (k0 + TILE <= Lk) return;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (k0 + jn * 8 + tig * 2 + e >= Lk) s[4 * jn + e] = s[4 * jn + 2 + e] = fill;
}

// A sweep of q rows (H, R, D) over split z of the key tiles of k (H, Lk, D),
// the splits taking ceil(tiles / splits) tiles each; NC consumer warpgroups own 64 q rows each and share a ring of
// key tiles.  BASE_LSE: natural-log LSE of every row (one split), skipped
// when no row of row_mask[0, mask_len) is live.  EDIT_LSE: log2-domain
// (max, sum) partials of each split for the live chunks.  EDIT_P: merges
// those partials into lse (natural log; 0 for dead chunks) and writes
// P = bf16(exp(s - lse)), 0 at keys >= Lk, into p (H, R, Lk_pad).
template <int DV, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
sweep_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
             const float* __restrict__ row_mask, int mask_len, int mode, float* __restrict__ lse,
             float2* __restrict__ part, __nv_bfloat16* __restrict__ p, int R, int Lk, int Lk_pad,
             int splits, float scale_log2) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg(smem_raw, NC * TB, TB, ST);
  const int h = blockIdx.y, z = blockIdx.z, r0 = blockIdx.x * NC * TILE;
  const int nt = (Lk + TILE - 1) / TILE;
  const int per = (nt + splits - 1) / splits;  // key tiles of each split
  const int t0 = z * per, t1 = mode == BASE_LSE ? nt : min(nt, t0 + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) rg.init(1, 128 * NC);
  const bool live = mode == BASE_LSE ? any_live(row_mask, 0, mask_len)
                                     : any_live(row_mask, r0, min(R, r0 + NC * TILE));
  if (!live) {
    if (mode == EDIT_P && z == 0)
      for (int r = r0 + (int)threadIdx.x; r < min(R, r0 + NC * TILE); r += blockDim.x)
        lse[(size_t)h * R + r] = 0.f;
    return;
  }

  if (warp == NC * 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(rg.once(), NC * TB);
      for (int i = 0; i < NC; ++i) tma_tile<T::CB>(rg.own + i * TB, &tq, rg.once(), r0 + i * TILE, h);
      for (int t = t0, n = 0; t < t1; ++t, ++n) {
        rg.wait_free(n);
        const int s = n % ST;
        mbar_expect_tx(rg.full(s), TB);
        tma_tile<T::CB>(rg.stage(s), &tk, rg.full(s), t * TILE, h);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int t = threadIdx.x & 127, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  const uint32_t qt = rg.own + wg * TB;
  const int row0 = r0 + wg * TILE;
  float lse2[2] = {0.f, 0.f};
  if (mode == EDIT_P) {  // merge the splits' (max, sum) partials
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + w16 + g + 8 * e;
      if (r >= R) continue;
      const float2* pr = part + ((size_t)h * R + r) * splits;
      float m = NEG;
      for (int zz = 0; zz < splits; ++zz) m = fmaxf(m, pr[zz].x);
      float l = 0.f;
      for (int zz = 0; zz < splits; ++zz) l += pr[zz].y * ex2(pr[zz].x - m);
      lse2[e] = m + log2f(l);
      if (z == 0 && tig == 0) lse[(size_t)h * R + r] = lse2[e] * (1.0f / LOG2E);
    }
  }
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (l: this lane's columns)
  mbar_wait_warp(rg.once(), 0);

  for (int kt = t0, n = 0; kt < t1; ++kt, ++n) {
    const int s = n % ST;
    rg.wait_full(n);
    pin(sacc);
    wg_fence();
    mma_abt<DV>(sacc, qt, rg.stage(s));
    wg_commit();
    wg_wait0();
    pin(sacc);
    mbar_arrive(rg.empty(s));   // S is in registers: the stage is free
    if (mode == EDIT_P) {
      mask_keys(sacc, kt * TILE, Lk, tig, NEG);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + w16 + g + 8 * e;
        if (r >= R) continue;
        __nv_bfloat16* prow = p + ((size_t)h * R + r) * Lk_pad + kt * TILE + tig * 2;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(prow + jn * 8) = __floats2bfloat162_rn(
              ex2(fmaf(sacc[4 * jn + 2 * e], scale_log2, -lse2[e])),
              ex2(fmaf(sacc[4 * jn + 2 * e + 1], scale_log2, -lse2[e])));
      }
      continue;
    }
    mask_keys(sacc, kt * TILE, Lk, tig, NEG);
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sacc[4 * jn + e]);
        mx1 = fmaxf(mx1, sacc[4 * jn + 2 + e]);
      }
    const float mn0 = fmaxf(m0, max4(mx0) * scale_log2), mn1 = fmaxf(m1, max4(mx1) * scale_log2);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ps0 += ex2(fmaf(sacc[4 * jn + e], scale_log2, -mn0));
        ps1 += ex2(fmaf(sacc[4 * jn + 2 + e], scale_log2, -mn1));
      }
    l0 = l0 * ex2(m0 - mn0) + ps0;
    l1 = l1 * ex2(m1 - mn1) + ps1;
    m0 = mn0;
    m1 = mn1;
  }
  if (mode == EDIT_P) return;
  l0 = sum4(l0);
  l1 = sum4(l1);
  if (tig != 0) return;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + w16 + g + 8 * e;
    if (r >= R) continue;
    const float m = e ? m1 : m0, l = e ? l1 : l0;
    if (mode == BASE_LSE)
      lse[(size_t)h * R + r] = (m + log2f(l)) * (1.0f / LOG2E);
    else
      part[((size_t)h * R + r) * splits + z] = make_float2(m, l);
  }
}

// Orderable 64-bit key of (value, j): larger value first, then lower j.
__device__ __forceinline__ unsigned long long arg_key(float v, int j) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (0xFFFFFFFFu - (uint32_t)j);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// Correlation.  One consumer warpgroup owns 64 base rows j; a stage of the
// ring holds one key tile of Kb and the matching 64-key tiles of P_e for the
// pass's live chunks (up to CH).  Per key tile it issues S_b of the next
// tile and C^T += P_b P_e^T of this one as two wgmma groups, and forms the
// next tile's P_b on the special-function unit while the products run.
template <int DV, int NC>
struct CorrStages {   // ring depth: 227 KB of shared memory at D = 80 with two warpgroups
  static constexpr int value = DV > 64 && NC > 1 ? 3 : 4;
};

// P_b = bf16(exp(S_b - lse_b)) of key tile kt as A fragments, 0 at keys >= Lk
__device__ __forceinline__ void base_probs(uint32_t (&pa)[4][4], float (&s)[32], int kt, int Lk,
                                           int tig, float scale_log2, const float (&lb2)[2]) {
  mask_keys(s, kt * TILE, Lk, tig, NEG);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, -lb2[(i >> 1) & 1]));
  pack_a(pa, s);
}

// C^T += P_b P_e^T for NCH live chunks of the key tile in stage st
template <int NCH>
__device__ __forceinline__ void chunk_products(float (&acc)[CH][32], const uint32_t (&pa)[4][4],
                                               uint32_t st, uint32_t tile_bytes) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs64_k(acc[c], pa[kc], desc_k(st + tile_bytes + c * BOX, kc));
}

// One pass over all key tiles for NCH live chunks, ring uses [n, n + nt).
// Every tile but the last issues the next tile's S_b before its own
// products; the last is peeled so that no wgmma is conditional.
template <int DV, int NCH, int ST>
__device__ __forceinline__ void corr_pass(const Ring& rg, uint32_t qt, int n, int nt, int Lk,
                                          float scale_log2, const float (&lb2)[2], int tig,
                                          float (&acc)[CH][32], float (&sacc)[32]) {
  constexpr int TB = Tiles<DV>::TB;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  uint32_t pa[4][4], pn[4][4];
  rg.wait_full(n);
  pin(sacc);
  wg_fence();
  mma_abt<DV>(sacc, qt, rg.stage(n % ST));
  wg_commit();
  wg_wait0();
  pin(sacc);
  base_probs(pa, sacc, 0, Lk, tig, scale_log2, lb2);
  for (int kt = 0; kt + 1 < nt; ++kt) {
    rg.wait_full(n + kt + 1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) pin(acc[c]);
    pin(pa);
    pin(sacc);
    wg_fence();
    mma_abt<DV>(sacc, qt, rg.stage((n + kt + 1) % ST));   // its group completes first
    wg_commit();
    chunk_products<NCH>(acc, pa, rg.stage((n + kt) % ST), TB);
    wg_commit();
    wg_wait1();
    pin(sacc);
    base_probs(pn, sacc, kt + 1, Lk, tig, scale_log2, lb2);
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NCH; ++c) pin(acc[c]);
    pin(pa);
    mbar_arrive(rg.empty((n + kt) % ST));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kc][r] = pn[kc][r];
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) pin(acc[c]);
  pin(pa);
  wg_fence();
  chunk_products<NCH>(acc, pa, rg.stage((n + nt - 1) % ST), TB);
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int c = 0; c < NCH; ++c) pin(acc[c]);
  pin(pa);
  mbar_arrive(rg.empty((n + nt - 1) % ST));
}

// Registers: a consumer keeps CH x 32 accumulators, the S tile and two sets
// of P_b fragments (~230 a thread), so the producer is a whole warpgroup
// (one warp issues the loads) that hands its registers to the consumers.
template <int NC>
struct CorrRegs {
  static constexpr int producer = 40, consumer = NC == 1 ? 240 : 232;
};

template <int DV, int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
corr_wgmma_kernel(__grid_constant__ const CUtensorMap tqb, __grid_constant__ const CUtensorMap tkb,
                  __grid_constant__ const CUtensorMap tpe, const float* __restrict__ lse_b,
                  const float* __restrict__ inpaint, const float* __restrict__ background,
                  const float* __restrict__ row_mask, unsigned long long* __restrict__ keys, int K,
                  int L, int Lk, float scale_log2) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = CorrStages<DV, NC>::value, SB = TB + CH * BOX;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg(smem_raw, NC * TB, SB, ST);
  unsigned long long* skeys = reinterpret_cast<unsigned long long*>(rg.extra());  // [CH][64][2]
  int* list = reinterpret_cast<int*>(skeys + CH * 128);
  const int h = blockIdx.y, j0 = blockIdx.x * NC * TILE;
  const int nt = (Lk + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) rg.init(1, 128 * NC);
  live_chunks(row_mask, K, list);
  __syncthreads();
  const int nlive = list[chunks_of(K)];
  if (nlive == 0) return;
  const int passes = (nlive + CH - 1) / CH;

  if (warp >= NC * 4) {  // producer warpgroup: its first lane issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(CorrRegs<NC>::producer));
    if (warp == NC * 4 && lane == 0) {
      mbar_expect_tx(rg.once(), NC * TB);
      for (int i = 0; i < NC; ++i) tma_tile<T::CB>(rg.own + i * TB, &tqb, rg.once(), j0 + i * TILE, h);
      for (int ps = 0, n = 0; ps < passes; ++ps) {
        const int nch = min(CH, nlive - ps * CH);
        for (int kt = 0; kt < nt; ++kt, ++n) {
          rg.wait_free(n);
          const int s = n % ST;
          mbar_expect_tx(rg.full(s), TB + nch * BOX);
          tma_tile<T::CB>(rg.stage(s), &tkb, rg.full(s), kt * TILE, h);
          for (int c = 0; c < nch; ++c)
            tma_box(rg.stage(s) + TB + c * BOX, &tpe, rg.full(s), kt * TILE, list[ps * CH + c] * TILE, h);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CorrRegs<NC>::consumer));
  const int wg = warp >> 2, tc = threadIdx.x;   // consumer thread index
  const int t = threadIdx.x & 127, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  const uint32_t qt = rg.own + wg * TB;
  int jr[2];
  float lb2[2];
  bool in_ok[2], bg_ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    jr[e] = j0 + wg * TILE + w16 + g + 8 * e;
    const bool ok = jr[e] < L;
    lb2[e] = ok ? lse_b[(size_t)h * L + jr[e]] * LOG2E : 0.f;
    in_ok[e] = ok && inpaint[jr[e]] > 0.5f;
    bg_ok[e] = ok && background[jr[e]] > 0.5f;
  }
  float acc[CH][32], sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  mbar_wait_warp(rg.once(), 0);

  for (int ps = 0; ps < passes; ++ps) {
    const int nch = min(CH, nlive - ps * CH), n = ps * nt;
    switch (nch) {   // uniform: the products of a pass are straight-line code
      case 1: corr_pass<DV, 1, ST>(rg, qt, n, nt, Lk, scale_log2, lb2, tig, acc, sacc); break;
      case 2: corr_pass<DV, 2, ST>(rg, qt, n, nt, Lk, scale_log2, lb2, tig, acc, sacc); break;
      case 3: corr_pass<DV, 3, ST>(rg, qt, n, nt, Lk, scale_log2, lb2, tig, acc, sacc); break;
      default: corr_pass<DV, 4, ST>(rg, qt, n, nt, Lk, scale_log2, lb2, tig, acc, sacc); break;
    }
    // masked max/argmax of each column i over this block's rows j
    bar_sync(1, NC * 128);   // the previous pass's keys are read
    for (int x = tc; x < CH * 128; x += NC * 128) skeys[x] = 0ull;
    bar_sync(1, NC * 128);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c >= nch) continue;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          unsigned long long k_in = 0ull, k_bg = 0ull;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {   // rows g, g + 8
            if (jr[hr] >= L) continue;
            const float v = acc[c][4 * jn + 2 * hr + e];
            k_in = umax64(k_in, arg_key(in_ok[hr] ? v : MASKED, jr[hr]));
            k_bg = umax64(k_bg, arg_key(bg_ok[hr] ? v : MASKED, jr[hr]));
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            k_in = umax64(k_in, __shfl_xor_sync(0xffffffffu, k_in, off));
            k_bg = umax64(k_bg, __shfl_xor_sync(0xffffffffu, k_bg, off));
          }
          if (g == 0) {
            const int col = jn * 8 + tig * 2 + e;
            atomicMax(&skeys[(c * 64 + col) * 2], k_in);
            atomicMax(&skeys[(c * 64 + col) * 2 + 1], k_bg);
          }
        }
    }
    bar_sync(1, NC * 128);
    for (int x = tc; x < nch * 128; x += NC * 128) {
      const int i = list[ps * CH + x / 128] * TILE + (x & 127) / 2;
      if (i < K) atomicMax(&keys[((size_t)h * K + i) * 2 + (x & 1)], skeys[x]);
    }
  }
}

__global__ void corr_finalize_kernel(const unsigned long long* __restrict__ keys,
                                     const float* __restrict__ row_mask, float* __restrict__ p_in,
                                     float* __restrict__ p_bg, int* __restrict__ j_in,
                                     int* __restrict__ j_bg, int H, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= H * K) return;
  float v[2] = {NEG_INF, NEG_INF};
  int j[2] = {0, 0};
  if (row_mask[t % K] > 0.5f) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned long long key = keys[(size_t)t * 2 + m];
      const uint32_t o = (uint32_t)(key >> 32);
      v[m] = __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
      j[m] = (int)(0xFFFFFFFFu - (uint32_t)key);
    }
  }
  p_in[t] = v[0];
  p_bg[t] = v[1];
  j_in[t] = j[0];
  j_bg[t] = j[1];
}

// Per-row scalars of the backward, each row's lse in log2 units.
struct BwdRow {
  float le2, li2, lb2, gi, gb, c;
};

// Backward, rows.  One block owns a live 64-row chunk of a head and a split
// of the keys; per key tile it forms S_e = Qe Ke^T, S_in = Q_in Kb^T,
// S_bg = Q_bg Kb^T, pe = exp(S_e - lse_e), p_in, p_bg rounded to bf16,
// d = g_in p_in + g_bg p_bg, and adds c += pe d, A += (pe d) Ke,
// B += pe Ke (Ke read row-major through the transpose bit).
template <int DV>
__global__ void __launch_bounds__(160, 1)
bwd_rows_kernel(__grid_constant__ const CUtensorMap tqe, __grid_constant__ const CUtensorMap tqin,
                __grid_constant__ const CUtensorMap tqbg, __grid_constant__ const CUtensorMap tke,
                __grid_constant__ const CUtensorMap tkb, const float* __restrict__ row_mask,
                const float* __restrict__ lse_e, const float* __restrict__ lse_in,
                const float* __restrict__ lse_bg, const float* __restrict__ g_in,
                const float* __restrict__ g_bg, float* __restrict__ c_part,
                float* __restrict__ a_part, float* __restrict__ b_part, int H, int K, int Lk, int D,
                int splits, float scale_log2) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg(smem_raw, 3 * TB, 2 * TB, ST);
  const int h = blockIdx.y, z = blockIdx.z, i0 = blockIdx.x * TILE;
  const int nt = (Lk + TILE - 1) / TILE;
  const int per = (nt + splits - 1) / splits;  // key tiles of each split
  const int t0 = z * per, t1 = min(nt, t0 + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) rg.init(1, 128);
  if (!any_live(row_mask, i0, min(K, i0 + TILE))) return;

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(rg.once(), 3 * TB);
      tma_tile<T::CB>(rg.own, &tqe, rg.once(), i0, h);
      tma_tile<T::CB>(rg.own + TB, &tqin, rg.once(), i0, h);
      tma_tile<T::CB>(rg.own + 2 * TB, &tqbg, rg.once(), i0, h);
      for (int kt = t0, n = 0; kt < t1; ++kt, ++n) {
        rg.wait_free(n);
        const int s = n % ST;
        mbar_expect_tx(rg.full(s), 2 * TB);
        tma_tile<T::CB>(rg.stage(s), &tke, rg.full(s), kt * TILE, h);
        tma_tile<T::CB>(rg.stage(s) + TB, &tkb, rg.full(s), kt * TILE, h);
      }
    }
    return;
  }

  const int t = threadIdx.x, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  BwdRow rw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = i0 + w16 + g + 8 * e;
    const size_t o = (size_t)h * K + r;
    rw[e] = r < K ? BwdRow{lse_e[o] * LOG2E, lse_in[o] * LOG2E, lse_bg[o] * LOG2E, g_in[o], g_bg[o], 0.f}
                  : BwdRow{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  }
  float acc_a[T::NACC], acc_b[T::NACC], se[32], si[32], sg[32];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc_a[i] = acc_b[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) se[i] = si[i] = sg[i] = 0.f;
  float cp[2] = {0.f, 0.f};
  mbar_wait_warp(rg.once(), 0);

  for (int kt = t0, n = 0; kt < t1; ++kt, ++n) {
    const int s = n % ST;
    const uint32_t ket = rg.stage(s), kbt = ket + TB;
    rg.wait_full(n);
    pin(se);
    pin(si);
    pin(sg);
    wg_fence();
    mma_abt<DV>(se, rg.own, ket);
    mma_abt<DV>(si, rg.own + TB, kbt);
    mma_abt<DV>(sg, rg.own + 2 * TB, kbt);
    wg_commit();
    wg_wait0();
    pin(se);
    pin(si);
    pin(sg);
    const bool ragged = (kt + 1) * TILE > Lk;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jn + e;
        const BwdRow& q = rw[e >> 1];
        const bool ok = !ragged || kt * TILE + jn * 8 + tig * 2 + (e & 1) < Lk;
        const float pe = ok ? ex2(fmaf(se[x], scale_log2, -q.le2)) : 0.f;
        const float pi = rnd_bf16(ex2(fmaf(si[x], scale_log2, -q.li2)));
        const float pg = rnd_bf16(ex2(fmaf(sg[x], scale_log2, -q.lb2)));
        const float u = pe * (q.gi * pi + q.gb * pg);
        cp[e >> 1] += u;
        se[x] = u;
        si[x] = pe;
      }
    uint32_t uh[4][4], ul[4][4], ph[4][4], pl[4][4];
    pack_a_split(uh, ul, se);
    pack_a_split(ph, pl, si);
    pin(acc_a);
    pin(acc_b);
    pin(uh);
    pin(ul);
    pin(ph);
    pin(pl);
    wg_fence();
    mma_rows<DV>(acc_a, uh, ket);
    mma_rows<DV>(acc_a, ul, ket);
    mma_rows<DV>(acc_b, ph, ket);
    mma_rows<DV>(acc_b, pl, ket);
    wg_commit();
    wg_wait0();
    pin(acc_a);
    pin(acc_b);
    pin(uh);
    pin(ul);
    pin(ph);
    pin(pl);
    mbar_arrive(rg.empty(s));
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float c = sum4(cp[e]);
    const int r = i0 + w16 + g + 8 * e;
    if (tig == 0 && r < K) c_part[((size_t)h * K + r) * splits + z] = c;
  }
  const size_t off = ((size_t)z * H + h) * K * D;
  store_rows_f32<DV>(a_part + off, acc_a, i0, K, D, 1.f, w16, g, tig);
  store_rows_f32<DV>(b_part + off, acc_b, i0, K, D, 1.f, w16, g, tig);
}

// d_qe = scale * (sum A - c sum B) and c = sum c over the key splits, in
// split order; 0 for dead rows.
__global__ void bwd_merge_kernel(const float* __restrict__ row_mask, const float* __restrict__ c_part,
                                 const float* __restrict__ a_part, const float* __restrict__ b_part,
                                 float* __restrict__ c_rows, float* __restrict__ dqe, int H, int K,
                                 int D, int splits, float scale) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= H * K * D) return;
  const int row = t / D, d = t - row * D;   // row = h * K + i
  float out = 0.f, c = 0.f;
  if (row_mask[row % K] > 0.5f) {
    float a = 0.f, b = 0.f;
    const size_t plane = (size_t)H * K * D;
    for (int z = 0; z < splits; ++z) {
      c += c_part[(size_t)row * splits + z];
      a += a_part[z * plane + t];
      b += b_part[z * plane + t];
    }
    out = scale * (a - c * b);
  }
  dqe[t] = out;
  if (d == 0) c_rows[row] = c;
}

// Backward, keys.  One block owns 64 keys of a head and loops over the live
// chunks: S_e^T = Ke Qe^T, S_in^T = Kb Q_in^T, S_bg^T = Kb Q_bg^T,
// t^T = pe (d - c) with each edit row's scalars, and d_ke += t^T Qe (Qe read
// row-major through the transpose bit).  The producer warp brings each
// chunk's row scalars into the stage beside its three tiles.
template <int DV>
struct KeysStages {
  static constexpr int value = DV > 64 ? 3 : 4;
};

template <int DV>
__global__ void __launch_bounds__(160, 1)
bwd_keys_kernel(__grid_constant__ const CUtensorMap tqe, __grid_constant__ const CUtensorMap tqin,
                __grid_constant__ const CUtensorMap tqbg, __grid_constant__ const CUtensorMap tke,
                __grid_constant__ const CUtensorMap tkb, const float* __restrict__ row_mask,
                const float* __restrict__ lse_e, const float* __restrict__ lse_in,
                const float* __restrict__ lse_bg, const float* __restrict__ g_in,
                const float* __restrict__ g_bg, const float* __restrict__ c_rows,
                float* __restrict__ dke, int K, int Lk, int D, float scale, float scale_log2) {
  using T = Tiles<DV>;
  constexpr int TB = T::TB, ST = KeysStages<DV>::value;
  extern __shared__ uint8_t smem_raw[];
  const Ring rg(smem_raw, 2 * TB, 3 * TB, ST);
  BwdRow* sstat = reinterpret_cast<BwdRow*>(rg.extra());   // [ST][64]
  int* list = reinterpret_cast<int*>(sstat + ST * TILE);
  const int h = blockIdx.y, k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) rg.init(32, 128);
  live_chunks(row_mask, K, list);
  __syncthreads();
  const int nlive = list[chunks_of(K)];

  if (warp == 4) {  // producer warp: lane 0 issues the TMA loads, all lanes the scalars
    if (lane == 0 && nlive > 0) {
      mbar_expect_tx(rg.once(), 2 * TB);
      tma_tile<T::CB>(rg.own, &tke, rg.once(), k0, h);
      tma_tile<T::CB>(rg.own + TB, &tkb, rg.once(), k0, h);
    }
    for (int n = 0; n < nlive; ++n) {
      rg.wait_free(n);
      const int s = n % ST, i0 = list[n] * TILE;
      for (int r = lane; r < TILE; r += 32) {
        const int i = i0 + r;
        const size_t o = (size_t)h * K + i;
        sstat[s * TILE + r] = i < K ? BwdRow{lse_e[o] * LOG2E, lse_in[o] * LOG2E, lse_bg[o] * LOG2E,
                                             g_in[o], g_bg[o], c_rows[o]}
                                    : BwdRow{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      }
      if (lane == 0) {
        mbar_expect_tx(rg.full(s), 3 * TB);
        tma_tile<T::CB>(rg.stage(s), &tqe, rg.full(s), i0, h);
        tma_tile<T::CB>(rg.stage(s) + TB, &tqin, rg.full(s), i0, h);
        tma_tile<T::CB>(rg.stage(s) + 2 * TB, &tqbg, rg.full(s), i0, h);
      } else {
        mbar_arrive(rg.full(s));
      }
    }
    return;
  }

  const int t = threadIdx.x, w16 = (t >> 5) * 16, g = lane >> 2, tig = lane & 3;
  float acc[T::NACC], se[32], si[32], sg[32];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) se[i] = si[i] = sg[i] = 0.f;
  if (nlive > 0) mbar_wait_warp(rg.once(), 0);

  for (int n = 0; n < nlive; ++n) {
    const int s = n % ST;
    const uint32_t qet = rg.stage(s);
    const BwdRow* st = sstat + s * TILE;
    rg.wait_full(n);
    pin(se);
    pin(si);
    pin(sg);
    wg_fence();
    mma_abt<DV>(se, rg.own, qet);              // S_e^T: key rows, edit-row columns
    mma_abt<DV>(si, rg.own + TB, qet + TB);
    mma_abt<DV>(sg, rg.own + TB, qet + 2 * TB);
    wg_commit();
    wg_wait0();
    pin(se);
    pin(si);
    pin(sg);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * jn + e;
        const BwdRow q = st[jn * 8 + tig * 2 + (e & 1)];
        const float pe = ex2(fmaf(se[x], scale_log2, -q.le2));
        const float pi = rnd_bf16(ex2(fmaf(si[x], scale_log2, -q.li2)));
        const float pg = rnd_bf16(ex2(fmaf(sg[x], scale_log2, -q.lb2)));
        se[x] = pe * (q.gi * pi + q.gb * pg - q.c);
      }
    uint32_t th[4][4], tl[4][4];
    pack_a_split(th, tl, se);
    pin(acc);
    pin(th);
    pin(tl);
    wg_fence();
    mma_rows<DV>(acc, th, qet);
    mma_rows<DV>(acc, tl, qet);
    wg_commit();
    wg_wait0();
    pin(acc);
    pin(th);
    pin(tl);
    mbar_arrive(rg.empty(s));
  }
  store_rows_f32<DV>(dke + (size_t)h * Lk * D, acc, k0, Lk, D, scale, w16, g, tig);
}

// ------------------------------------------------------------ bf16 launches

template <int DV, int NC>
cudaError_t sweep(const CUtensorMap& tq, const CUtensorMap& tk, const float* row_mask, int mask_len,
                  int mode, float* lse, float2* part, __nv_bfloat16* p, int H, int R, int Lk,
                  int Lk_pad, int splits, float scale_log2, cudaStream_t s) {
  using T = Tiles<DV>;
  const size_t smem = ring_smem(NC * T::TB, T::TB, T::STAGES, 0);
  auto kern = sweep_kernel<DV, NC>;
  static const cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const int per = NC * TILE;
  kern<<<dim3((R + per - 1) / per, H, mode == BASE_LSE ? 1 : splits), NC * 128 + 32, smem, s>>>(
      tq, tk, row_mask, mask_len, mode, lse, part, p, R, Lk, Lk_pad, splits, scale_log2);
  return cudaGetLastError();
}

template <int DV, int NC>
cudaError_t corr_launch(const CUtensorMap& tqb, const CUtensorMap& tkb, const CUtensorMap& tpe,
                        const float* lse_b, const float* inpaint, const float* background,
                        const float* row_mask, unsigned long long* keys, int H, int K, int L,
                        int Lk, float scale_log2, cudaStream_t s) {
  const size_t smem = ring_smem(NC * Tiles<DV>::TB, Tiles<DV>::TB + CH * BOX, CorrStages<DV, NC>::value,
                                CH * 128 * 8 + chunk_list_bytes(K));
  auto kern = corr_wgmma_kernel<DV, NC>;
  static size_t prepared = 0;
  const cudaError_t e = prepare_at_least(kern, smem, prepared);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + NC * TILE - 1) / (NC * TILE), H), (NC + 1) * 128, smem, s>>>(
      tqb, tkb, tpe, lse_b, inpaint, background, row_mask, keys, K, L, Lk, scale_log2);
  return cudaGetLastError();
}

template <int DV>
cudaError_t corr_fwd_bf16(const void* qe, const void* ke, const void* qb, const void* kb, void* pe,
                          float2* part, unsigned long long* keys, const float* inpaint,
                          const float* background, const float* row_mask, float* lse_e,
                          float* lse_b, float* p_in, float* p_bg, int* j_in, int* j_bg, int H,
                          int K, int L, int Lk, int D, int Lk_pad, int splits, int nc, float scale,
                          cudaStream_t s) {
  CUtensorMap tqe, tke, tqb, tkb, tpe;
  if ((nc != 1 && nc != 2) || !tensor_map(&tqe, qe, H, K, D) ||
      !tensor_map(&tke, ke, H, Lk, D) || !tensor_map(&tqb, qb, H, L, D) ||
      !tensor_map(&tkb, kb, H, Lk, D) || !tensor_map(&tpe, pe, H, K, Lk_pad))
    return cudaErrorInvalidValue;
  const float sl2 = scale * LOG2E;
  auto* pb = static_cast<__nv_bfloat16*>(pe);
  cudaError_t e = sweep<DV, 2>(tqb, tkb, row_mask, K, BASE_LSE, lse_b, nullptr, nullptr, H, L, Lk,
                               Lk_pad, 1, sl2, s);
  if (e != cudaSuccess) return e;
  if ((e = sweep<DV, 1>(tqe, tke, row_mask, K, EDIT_LSE, nullptr, part, nullptr, H, K, Lk, Lk_pad,
                        splits, sl2, s)) != cudaSuccess)
    return e;
  if ((e = sweep<DV, 1>(tqe, tke, row_mask, K, EDIT_P, lse_e, part, pb, H, K, Lk, Lk_pad, splits,
                        sl2, s)) != cudaSuccess)
    return e;
  e = nc == 2 ? corr_launch<DV, 2>(tqb, tkb, tpe, lse_b, inpaint, background, row_mask, keys, H, K,
                                   L, Lk, sl2, s)
              : corr_launch<DV, 1>(tqb, tkb, tpe, lse_b, inpaint, background, row_mask, keys, H, K,
                                   L, Lk, sl2, s);
  if (e != cudaSuccess) return e;
  corr_finalize_kernel<<<(H * K + 255) / 256, 256, 0, s>>>(keys, row_mask, p_in, p_bg, j_in, j_bg,
                                                           H, K);
  return cudaGetLastError();
}

template <int DV>
cudaError_t corr_bwd_bf16(const void* qe, const void* ke, const void* kb, const void* q_in,
                          const void* q_bg, const float* g_in, const float* g_bg,
                          const float* row_mask, const float* lse_e, const float* lse_in,
                          const float* lse_bg, float* c_part, float* a_part, float* b_part,
                          float* c_rows, float* dqe, float* dke, int H, int K, int Lk, int D,
                          int splits, float scale, cudaStream_t s) {
  using T = Tiles<DV>;
  CUtensorMap tqe, tqin, tqbg, tke, tkb;
  if (!tensor_map(&tqe, qe, H, K, D) || !tensor_map(&tqin, q_in, H, K, D) ||
      !tensor_map(&tqbg, q_bg, H, K, D) || !tensor_map(&tke, ke, H, Lk, D) ||
      !tensor_map(&tkb, kb, H, Lk, D))
    return cudaErrorInvalidValue;
  const float sl2 = scale * LOG2E;
  const size_t smem_r = ring_smem(3 * T::TB, 2 * T::TB, T::STAGES, 0);
  auto kr = bwd_rows_kernel<DV>;
  static const cudaError_t e_r = prepare(kr, smem_r);
  if (e_r != cudaSuccess) return e_r;
  kr<<<dim3((K + TILE - 1) / TILE, H, splits), 160, smem_r, s>>>(
      tqe, tqin, tqbg, tke, tkb, row_mask, lse_e, lse_in, lse_bg, g_in, g_bg, c_part, a_part, b_part,
      H, K, Lk, D, splits, sl2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_merge_kernel<<<(H * K * D + 255) / 256, 256, 0, s>>>(row_mask, c_part, a_part, b_part, c_rows,
                                                           dqe, H, K, D, splits, scale);
  if ((e = cudaGetLastError()) != cudaSuccess || dke == nullptr) return e;
  constexpr int KST = KeysStages<DV>::value;
  const size_t smem_k =
      ring_smem(2 * T::TB, 3 * T::TB, KST, KST * TILE * sizeof(BwdRow) + chunk_list_bytes(K));
  auto kk = bwd_keys_kernel<DV>;
  static size_t prepared_k = 0;
  const cudaError_t e_k = prepare_at_least(kk, smem_k, prepared_k);
  if (e_k != cudaSuccess) return e_k;
  kk<<<dim3((Lk + TILE - 1) / TILE, H), 160, smem_k, s>>>(tqe, tqin, tqbg, tke, tkb, row_mask, lse_e,
                                                         lse_in, lse_bg, g_in, g_bg, c_rows, dke, K,
                                                         Lk, D, scale, sl2);
  return cudaGetLastError();
}

// float32 only (bf16 runs the wgmma kernels below), with the head-dim
// columns each thread owns (D/4 rounded up to 10 or 20).  The loss runs at
// the two largest UNet levels only (D 40 and 80 at every image size); D > 80
// is refused.
#define GD_DISPATCH_F32(DTYPE, D, FN, ...)                                       \
  do {                                                                           \
    if ((D) < 1 || (D) > 80 || (DTYPE) != 0) return cudaErrorInvalidValue;      \
    if ((D) <= 40) return FN<float, 10>(__VA_ARGS__);                            \
    return FN<float, 20>(__VA_ARGS__);                                           \
  } while (0)

}  // namespace

extern "C" int gd_corr_spans(int L) { return (L + JSPAN - 1) / JSPAN; }

extern "C" int gd_corr_fwd(const void* qe, const void* ke, const void* qb, const void* kb,
                           const float* inpaint, const float* background, const float* row_mask,
                           float* lse_e, float* lse_b, float* part_val, int* part_idx,
                           float* p_in, float* p_bg, int* j_in, int* j_bg, int H, int K, int L,
                           int Lk, int D, float scale, int dtype, void* stream) {
  GD_DISPATCH_F32(dtype, D, corr_fwd, qe, ke, qb, kb, inpaint, background, row_mask, lse_e, lse_b,
              part_val, part_idx, p_in, p_bg, j_in, j_bg, H, K, L, Lk, D, scale,
              (cudaStream_t)stream);
}

extern "C" int gd_corr_bwd(const void* qe, const void* ke, const void* kb, const void* q_in,
                           const void* q_bg, const float* g_in, const float* g_bg,
                           const float* row_mask, float* scratch, float* dqe, float* dke, int H,
                           int K, int Lk, int D, float scale, int dtype, void* stream) {
  GD_DISPATCH_F32(dtype, D, corr_bwd, qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, scratch, dqe, dke,
              H, K, Lk, D, scale, (cudaStream_t)stream);
}

// bf16: D a multiple of 8 up to 80 (the wrapper pads: the loss layers are
// the two largest UNet levels, D 40 and 80 at every image size), any K.
extern "C" int gd_corr_fwd_bf16(const void* qe, const void* ke, const void* qb, const void* kb,
                                void* pe, void* part, void* keys, const float* inpaint,
                                const float* background, const float* row_mask, float* lse_e,
                                float* lse_b, float* p_in, float* p_bg, int* j_in, int* j_bg, int H,
                                int K, int L, int Lk, int D, int Lk_pad, int splits, int nc,
                                float scale, void* stream) {
  if (D < 8 || D > 80 || D % 8 != 0 || Lk_pad % 64 != 0 || splits < 1) return cudaErrorInvalidValue;
  auto* part2 = static_cast<float2*>(part);
  auto* keys64 = static_cast<unsigned long long*>(keys);
  auto st = (cudaStream_t)stream;
  if (D <= 40)
    return corr_fwd_bf16<40>(qe, ke, qb, kb, pe, part2, keys64, inpaint, background, row_mask, lse_e,
                             lse_b, p_in, p_bg, j_in, j_bg, H, K, L, Lk, D, Lk_pad, splits, nc, scale,
                             st);
  return corr_fwd_bf16<80>(qe, ke, qb, kb, pe, part2, keys64, inpaint, background, row_mask, lse_e,
                           lse_b, p_in, p_bg, j_in, j_bg, H, K, L, Lk, D, Lk_pad, splits, nc, scale,
                           st);
}

extern "C" int gd_corr_bwd_bf16(const void* qe, const void* ke, const void* kb, const void* q_in,
                                const void* q_bg, const float* g_in, const float* g_bg,
                                const float* row_mask, const float* lse_e, const float* lse_in,
                                const float* lse_bg, float* c_part, float* a_part, float* b_part,
                                float* c_rows, float* dqe, float* dke, int H, int K, int Lk, int D,
                                int splits, float scale, void* stream) {
  if (D < 8 || D > 80 || D % 8 != 0 || splits < 1) return cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (D <= 40)
    return corr_bwd_bf16<40>(qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, lse_e, lse_in, lse_bg,
                             c_part, a_part, b_part, c_rows, dqe, dke, H, K, Lk, D, splits, scale, st);
  return corr_bwd_bf16<80>(qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, lse_e, lse_in, lse_bg,
                           c_part, a_part, b_part, c_rows, dqe, dke, H, K, Lk, D, splits, scale, st);
}
