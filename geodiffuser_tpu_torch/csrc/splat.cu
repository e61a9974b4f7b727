// Fused soft-z-buffer point splat for Hopper (sm_90a).
//
// Replaces geodiffuser_tpu/kernels/splat.py: splat_image_fused (_splat_kernel).
//
//   l[o, s] = log alpha(o, s) - z_beta * z[s]    on the 2x2 floor corners of s
//   out[o]  = softmax_s(l[o, :]) v * (1 - exp(sum_s log1p(-clip(alpha(o, s)))))
//
// with alpha = (1 - sqrt(clip(d^2 / r^2, 0, 1)))^tau, valid where alpha > 1e-6,
// and 0 in a cell that no corner reaches.
//
// What bounds it on the H100: each point reaches at most 4 cells, so the
// work is a few dozen operations per point against 12 + 4C bytes of input:
// memory (and the atomics into the per-cell sums) bound it.
//
// Design: the Pallas grid scanned every output block against every source
// block, a dense O(N_out * N) product of mostly masked pairs.  Here the work
// is O(N), in passes over the points that scatter with atomics:
//   0. zero the per-cell sums and set the per-cell maxima to their minimum;
//   1. per point, the <= 4 corner logits, atomicMax into the cell's running
//      max (the float mapped to an order-preserving int);
//   2. per point, atomicAdd exp(l - m[cell]) * v, exp(l - m[cell]) and
//      log1p(-clip(alpha)) into per-cell float32 sums;
//   3. per cell, num / den * coverage.
// In real arithmetic this equals the online softmax; the atomics make the
// order of the float32 sums, and so their last bits, run-dependent.  The
// corner arithmetic uses the _rn intrinsics (no FMA contraction), so passes 1
// and 2 compute bit-identical logits and the corners are bucketed by the same
// float32 floor as the plain version and the JAX kernel.
#include "common.cuh"

#include <climits>

namespace {

constexpr int SPLAT_NT = 256;
constexpr float MISS_CLIP = (float)(1.0 - 1e-4);   // clip(alpha, 0, 1 - 1e-4)

// Order-preserving map of a float to an int, and its inverse.
__device__ __forceinline__ int ord(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unord(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

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
// off the output grid or its alpha is <= 1e-6; else its cell, alpha and logit.
__device__ __forceinline__ bool corner(const Point& pt, int k, int oh, int ow, float r2, float tau,
                                       float z_beta, int& cell, float& alpha, float& logit) {
  const float cx = __fadd_rn(floorf(pt.x), (float)(k & 1));
  const float cy = __fadd_rn(floorf(pt.y), (float)(k >> 1));
  if (!(cx >= 0.f && cx < (float)ow && cy >= 0.f && cy < (float)oh)) return false;
  const float dx = __fsub_rn(cx, pt.x), dy = __fsub_rn(cy, pt.y);
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float q = fminf(fmaxf(__fdiv_rn(d2, r2), 0.f), 1.f);
  const float a = powf(__fsub_rn(1.f, __fsqrt_rn(q)), tau);
  if (!(a > 1e-6f)) return false;
  cell = (int)cy * ow + (int)cx;
  alpha = a;
  logit = __fsub_rn(logf(fmaxf(a, 1e-30f)), __fmul_rn(z_beta, pt.z));
  return true;
}

__global__ void __launch_bounds__(SPLAT_NT)
splat_init_kernel(int* __restrict__ cell_max, float* __restrict__ acc, int n_out, int width) {
  const size_t total = (size_t)n_out * width;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    acc[i] = 0.f;
    if (i < (size_t)n_out) cell_max[i] = INT_MIN;
  }
}

__global__ void __launch_bounds__(SPLAT_NT)
splat_max_kernel(const float* __restrict__ coords, int* __restrict__ cell_max, int n, int oh,
                 int ow, float r2, float tau, float z_beta) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Point pt = load_point(coords, p, oh, ow);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int cell;
    float alpha, logit;
    if (corner(pt, k, oh, ow, r2, tau, z_beta, cell, alpha, logit))
      atomicMax(cell_max + cell, ord(logit));
  }
}

// acc is (n_out, C + 2): C numerator sums, the denominator, the log-miss sum.
__global__ void __launch_bounds__(SPLAT_NT)
splat_accumulate_kernel(const float* __restrict__ src, const float* __restrict__ coords,
                        const int* __restrict__ cell_max, float* __restrict__ acc, int n, int oh,
                        int ow, int C, float r2, float tau, float z_beta) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const Point pt = load_point(coords, p, oh, ow);
  const float* v = src + (size_t)p * C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int cell;
    float alpha, logit;
    if (!corner(pt, k, oh, ow, r2, tau, z_beta, cell, alpha, logit)) continue;
    const float e = expf(__fsub_rn(logit, unord(cell_max[cell])));
    float* a = acc + (size_t)cell * (C + 2);
    for (int c = 0; c < C; ++c) atomicAdd(a + c, __fmul_rn(e, v[c]));
    atomicAdd(a + C, e);
    atomicAdd(a + C + 1, log1pf(-fminf(alpha, MISS_CLIP)));
  }
}

__global__ void __launch_bounds__(SPLAT_NT)
splat_finalize_kernel(const float* __restrict__ acc, float* __restrict__ out, int n_out, int C) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const float* a = acc + (size_t)o * (C + 2);
  const float den = a[C];
  const float coverage = __fsub_rn(1.f, expf(a[C + 1]));
  for (int c = 0; c < C; ++c)
    out[(size_t)o * C + c] =
        den > 0.f ? __fmul_rn(__fdiv_rn(a[c], fmaxf(den, 1e-30f)), coverage) : 0.f;
}

inline int blocks_for(size_t n) { return (int)((n + SPLAT_NT - 1) / SPLAT_NT); }

}  // namespace

// src (N, C) and coords (N, 3) float32, N = h * w source points; out
// (oh * ow, C).  cell_max (oh * ow) int32 and acc (oh * ow, C + 2) float32 are
// scratch, set here.
extern "C" int gd_splat_fused(const float* src, const float* coords, int* cell_max, float* acc,
                              float* out, int n, int oh, int ow, int C, float radius, float tau,
                              float z_beta, void* stream) {
  if (n < 1 || oh < 1 || ow < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_out = oh * ow;
  const float r2 = fmaxf(radius * radius, 1e-8f);
  const size_t init_total = (size_t)n_out * (C + 2);
  splat_init_kernel<<<blocks_for(init_total) < 4096 ? blocks_for(init_total) : 4096, SPLAT_NT, 0,
                      s>>>(cell_max, acc, n_out, C + 2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  splat_max_kernel<<<blocks_for(n), SPLAT_NT, 0, s>>>(coords, cell_max, n, oh, ow, r2, tau, z_beta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  splat_accumulate_kernel<<<blocks_for(n), SPLAT_NT, 0, s>>>(src, coords, cell_max, acc, n, oh, ow,
                                                            C, r2, tau, z_beta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  splat_finalize_kernel<<<blocks_for(n_out), SPLAT_NT, 0, s>>>(acc, out, n_out, C);
  return cudaGetLastError();
}
