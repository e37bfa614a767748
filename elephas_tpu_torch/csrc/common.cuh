// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// bf16 tensor-core fragments (ldmatrix, mma.sync m16n8k16) and tile loads
// from device memory into padded shared-memory tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;  // query rows and keys per tile, every kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kWarps = 4;  // bf16 kernels: 16 rows per warp
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two 16x8 accumulator fragments (columns 0-7 and 8-15 of a 16x16 tile)
// rounded to bf16 as the A operand of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// A operand (16 rows x 16 columns starting at `col`) from a padded tile of
// row stride DS; the calling warp's rows start at `row`.
template <int DS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int row, int col) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (row + lane % 16) * DS + col + (lane / 16) * 8);
}

// B operands of two n-fragments: rows `row`..`row`+15 of the tile are the
// n index, columns `col`..`col`+15 the k index (the tile is B transposed,
// e.g. K for Q K^T). b[0], b[1] feed n 0-7; b[2], b[3] feed n 8-15.
template <int DS>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                       int row, int col) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (row + lane % 8 + (lane / 16) * 8) * DS + col + ((lane / 8) % 2) * 8);
}

// B operands of two n-fragments read transposed: rows `row`..`row`+15 of
// the tile are the k index, columns `col`..`col`+15 the n index (the tile
// is B itself, e.g. V for P V).
template <int DS>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                             int row, int col) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (row + lane % 8 + ((lane / 8) % 2) * 8) * DS + col + (lane / 16) * 8);
}

// 64 rows of D elements from `src` (row stride D) starting at `row0` into
// a [64][D + PAD] shared tile, 16 bytes per load; rows past `seq` are zero.
template <typename T, int D, int PAD, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int seq) {
  constexpr int kPerVec = 16 / sizeof(T);
  constexpr int kVecs = D / kPerVec;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * kPerVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
