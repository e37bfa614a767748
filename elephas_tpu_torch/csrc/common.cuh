// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// constants, bf16 packing, and the float32 K2/K3 kernels' tile loads from
// device memory into padded shared-memory tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;  // float32 K2/K3: query rows and keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
