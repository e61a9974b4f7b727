// Shared device helpers for the port's hand-written Hopper kernels.
//
// Tiles live in shared memory as float32 with a row stride of D + 1, so that
// the 4 threads that share an output row, and the 8 rows a warp touches,
// read distinct banks.  Inputs are float32 or bfloat16 in device memory and
// are widened on load; every sum is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gd {

constexpr int TILE = 64;       // rows of a tile
constexpr int NT = 256;        // threads of a block: 4 per tile row
constexpr int PSTRIDE = TILE + 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// Round a float32 value to the precision of T (the casts the JAX kernels
// apply before a product, e.g. p.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float rnd_bf16(float v) { return rnd<__nv_bfloat16>(v); }

// Rows [r0, r0 + TILE) of a row-major (L, D) matrix into shared memory with
// row stride sd; rows past L are zero.  Neighbouring threads read
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void load_tile(float* s, const T* g, int r0, int L, int D, int sd) {
  for (int e = threadIdx.x; e < TILE * D; e += NT) {
    const int r = e / D, d = e - r * D;
    s[r * sd + d] = (r0 + r < L) ? ld(g, (size_t)(r0 + r) * D + d) : 0.f;
  }
}

__device__ __forceinline__ float dot_row(const float* a, const float* b, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// Reductions over the 4 consecutive lanes that share a tile row.
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace gd
