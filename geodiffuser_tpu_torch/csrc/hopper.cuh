// Hopper (sm_90a) building blocks shared by the port's bf16 kernels: TMA
// tile loads completing on mbarriers, wgmma descriptors and products, the
// register packing of bf16 A operands, and the host-side tensor-map
// encoding.  Tiles are 64 rows of a (B, L, D) bf16 tensor in ceil(D/64)
// boxes of 64 columns x 64 rows with the 128-byte swizzle.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace gd {

constexpr int BOX = 64 * 128;        // bytes of one 64 x 64 bf16 TMA box

template <int DV>  // padded head width: 40 (D <= 40), 80 (D <= 80) or 160 (D <= 160)
struct Tiles {
  static constexpr int CB = (DV + 63) / 64;        // 64-column boxes per tile
  static constexpr int TB = CB * BOX;              // bytes of one 64-row tile
  static constexpr int KS = (DV + 15) / 16;        // k16 steps over the head dim
  static constexpr int NACC = DV / 2;              // fp32 accumulators / thread (64 x DV)
  // ring depth: a block's loads in flight, its bandwidth from L2 being
  // about STAGES tiles per load latency; at DV = 160 (three boxes a tile)
  // two stages are what shared memory holds beside a block's own tiles
  static constexpr int STAGES = DV > 128 ? 2 : DV > 64 ? 4 : 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// A wait that outlives ~2^24 polls (seconds; a healthy wait is microseconds)
// traps, so a pipeline fault is reported as an error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// a consumer warp's wait: its lanes reconverge before the .aligned wgmma
// instructions that follow
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// rows [row, row + 64) of batch b, all ceil(D/64) column boxes, into dst
template <int CB>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int b) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst + c * BOX),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c * 64), "r"(row), "r"(b)
        : "memory");
}

// one 64 x 64 box at coordinates {x, y, z} of a 3-D map into dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                        int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// k16 step kk of a tile read along its columns (K-major: Q, K, V, dO as the
// depth-D operand of S = Q K^T and its kin): 32 bytes per step inside a
// 128-byte swizzled row, the next box after four steps
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * BOX + (kk & 3) * 32, 16, 1024);
}
// k16 step kc of a tile read along its rows (MN-major: V in P V, K in dS K,
// dO in P^T dO, Q in dS^T Q): 16 rows of 128 bytes per step; the 64-column
// boxes lie BOX bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kc) {
  return desc(tile + kc * 2048, BOX, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// all but the last committed group done (groups complete in order)
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// keep the compiler from moving register reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define GD_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GD_F8(i) GD_F4(i), GD_F4(i + 4)

// d (64 x 64) (+)= A (64 x 16, smem) B^T (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : GD_F8(0), GD_F8(8), GD_F8(16), GD_F8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x DV) += A (64 x 16, registers) B (16 x DV, smem, MN-major)
template <int DV> __device__ void wgmma_rs(float (&d)[DV / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : GD_F8(0), GD_F8(8), GD_F4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : GD_F8(0), GD_F8(8), GD_F8(16), GD_F8(24), GD_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : GD_F8(0), GD_F8(8), GD_F8(16), GD_F8(24), GD_F8(32), GD_F8(40), GD_F8(48), GD_F8(56),
        GD_F8(64), GD_F8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 64) += A (64 x 16, registers) B^T (64 x 16, smem, K-major): the
// B tile's rows are the 64 output columns, its columns the depth
__device__ __forceinline__ void wgmma_rs64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : GD_F8(0), GD_F8(8), GD_F8(16), GD_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef GD_F8
#undef GD_F4

// 2^x on the special-function unit (one instruction; subnormal results,
// probabilities below 2^-126, flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (bf16) of a 64 x 64 accumulator for the four k16 steps of
// its columns: the accumulator layout of n8 tiles 2kc, 2kc + 1 is the
// register-A layout of k16 step kc
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    a[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    a[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    a[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// d (64 x DV) += A (64 x 64, four register k-steps) B (64 rows of a tile)
template <int DV>
__device__ __forceinline__ void mma_rows(float (&d)[DV / 2], const uint32_t (&a)[4][4],
                                         uint32_t tile) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_rs<DV>(d, a[kc], desc_mn(tile, kc));
}

// d (64 x 64) = A (tile a) B^T (tile b) over the padded head dim
template <int DV>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < Tiles<DV>::KS; ++kk) wgmma_ss64(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, L, D) tensor as a 3-D TMA map {D, L, B} of 64 x 64 boxes with
// the 128-byte swizzle.  D is a multiple of 8 (16-byte rows); columns >= D
// and rows >= L of a box read as zero.
inline bool tensor_map(CUtensorMap* m, const void* p, int B, int L, int D) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || D % 8 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t el[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box, el,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per kernel: its dynamic shared memory, and the whole carveout for
// shared memory so that two blocks fit an SM where their registers allow.
template <typename Kernel>
cudaError_t prepare(Kernel k, size_t bytes) {
  cudaError_t e = allow_smem(k, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return e;
}

}  // namespace gd
