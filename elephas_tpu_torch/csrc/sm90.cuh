// Hopper (sm_90a) building blocks of the flash-attention kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// wgmma.mma_async products (bf16 or tf32 in, f32 accumulate), setmaxnreg,
// named barriers, the proxy fence, and the host-side tensor maps that feed
// TMA.
//
// Tiles in shared memory. A (rows, D) tile of element type T is stored as
// D / W column blocks of W elements (W * sizeof(T) = the swizzle span: in
// bf16 64 bytes at D = 32 and 128 bytes at D = 64 and 128; in float32 128
// bytes, W = 32, except 64 bytes, W = 16, for the 16-wide transposed copies
// the float32 backward writes at head_dim 128), each block `rows` rows of W
// elements, swizzled by TMA (CU_TENSOR_MAP_SWIZZLE_64B / _128B) or, for
// tiles written by threads, as `TileLayout::offset` computes (16-wide
// tiles are also written at head_dim 256: the backward's transposed
// copies and the forward's exchange of P). Every
// block starts on a 1024-byte boundary, so TMA's swizzle and wgmma's
// agree: both XOR address bits of the absolute shared-memory address.
// One tile serves as a K-major operand (rows = M or N, D = the reduction
// axis: Q K^T, K Q^T, V dO^T) and as an MN-major one (rows = the
// reduction axis, D = N: P V, P^T dO, dS^T Q), read through the
// descriptor's transpose bit instead of a transpose in memory. That bit
// exists only for 16-bit types: a float32 (tf32) operand is K-major, so
// the f32 kernels write a transposed copy where they need MN-major data
// (or, float32 K1 at head_dim 256, compute the transposed product).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace flash {
namespace sm90 {

// ------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads (and to TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// spins for seconds (a phase that can never complete) traps, so a fault
// in the pipeline ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 33)) {
      __trap();
    }
  }
}

// ------------------------------------------------------------ TMA

// Box (W, rows, 1) of the 3-D tensor map at element coordinates
// (col, row, bh) into shared memory; completion is counted on `bar`.
// Rows past the tensor's sequence length arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// Column-block width (elements) and swizzle span (bytes) of a D-wide tile.
template <int D, typename T = __nv_bfloat16>
struct TileLayout {
  static constexpr int W = sizeof(T) == 4 ? (D == 16 ? 16 : 32) : (D == 32 ? 32 : 64);
  static constexpr int kSwizzle = sizeof(T) * W;  // bytes per swizzled row
  static constexpr int kBlocks = D / W;
  static constexpr int kSbo = 8 * kSwizzle;  // bytes between 8-row groups
  // Bytes of one column block of a tile of `rows` rows.
  __host__ __device__ static constexpr int block_bytes(int rows) { return rows * kSwizzle; }
  // Byte offset, within a column block, of byte column `col` of row `row`
  // as the swizzle stores it: the 16-byte chunk index XORed with address
  // bits 7-9 (128-byte rows) or 7-8 (64-byte rows).
  __host__ __device__ static constexpr int offset(int row, int col) {
    return row * kSwizzle + (col ^ ((((row * kSwizzle) >> 7) & (kSwizzle / 16 - 1)) << 4));
  }
};

// Bytes a barrier must expect for one (rows, D) tile.
template <int D, typename T = __nv_bfloat16>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return static_cast<uint32_t>(rows) * D * sizeof(T);
}

// Load a (rows, D) tile at sequence row `row` of head `bh`: one TMA box
// per column block, all counted on `bar`.
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void load_tile_tma(void* tile, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int row, int bh) {
  using L = TileLayout<D, T>;
#pragma unroll
  for (int c = 0; c < L::kBlocks; ++c) {
    tma_load_3d(static_cast<char*>(tile) + c * L::block_bytes(rows), map, bar, c * L::W, row, bh);
  }
}

// ------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows `row0`.. of a tile of `rows` rows, reduction step
// `kk` (32 bytes of D: 16 bf16 or 8 tf32 elements).
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ uint64_t desc_k_major(const void* tile, int rows, int row0, int kk) {
  using L = TileLayout<D, T>;
  const int col = kk * (32 / static_cast<int>(sizeof(T)));
  const uint32_t addr = smem_addr(tile) + (col / L::W) * L::block_bytes(rows) +
                        row0 * L::kSwizzle + (col % L::W) * static_cast<int>(sizeof(T));
  return make_desc(addr, 16, L::kSbo, L::kSwizzle);
}

// MN-major operand: rows 16 * kk.. (the reduction axis) of a tile of
// `rows` rows, all D columns as N.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, int rows, int kk) {
  using L = TileLayout<D>;
  const uint32_t addr = smem_addr(tile) + kk * 16 * L::kSwizzle;
  return make_desc(addr, L::block_bytes(rows), L::kSbo, L::kSwizzle);
}

// Orders register writes before the next wgmma that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the registers of `d` at this point of the program, so the compiler
// moves no use of an accumulator across a wgmma wait or issue.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Pins the registers of the A fragment `a` at this point, so the compiler
// builds the fragment here and not between the products that read it: a
// fragment rebuilt in registers that an issued product still reads makes
// ptxas wait for that product, serializing every wgmma (C7520).
__device__ __forceinline__ void fence_operand(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x N, f32) (+)= A (64 x 16, K-major descriptor) * B (16 x N, K-major
// descriptor). Accumulator of thread (warp w, lane l): d[4j + 2i + c] is
// row 16w + l/4 + 8i, column 8j + 2(l%4) + c.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

// d (64 x N, f32) (+)= A (64 x 16, bf16 registers in mma.sync's A layout)
// * B (16 x N, MN-major descriptor).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// The same products in tf32 (k8: 8 elements, 32 bytes, of the reduction
// axis a step). The tensor cores read the top 19 bits (sign, exponent, 10
// mantissa bits) of each float32 operand and ignore the low 13; both
// shared-memory operands are K-major (tf32 has no transpose bit).
//
// d (64 x N, f32) (+)= A (64 x 8, K-major descriptor) * B (8 x N, K-major
// descriptor).
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int accumulate);

// d (64 x N, f32) (+)= A (64 x 8 in registers) * B (8 x N, K-major
// descriptor). A fragment of thread (warp w, lane l): a[0] is row
// 16w + l/4, column l%4; a[1] row + 8; a[2] column + 4; a[3] both.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss_tf32<16>(float (&d)[8], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads, TMA), before a barrier that orders
// them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting: the barrier completes once
// `threads` threads have arrived or synced at it, and this thread's prior
// memory accesses are then performed for those that synced.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


// ------------------------------------------------------------ registers

// Warp-specialised kernels hand registers from the producer warpgroup to
// the consumers; every thread of a warpgroup executes the same one.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x in one MUFU.EX2 (flushes denormals; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library links against nothing but the runtime.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// Tensor map of a (batch_heads, seq, head_dim) tensor of T (bf16 or
// float32) as the 3-D array (head_dim, seq, batch_heads), boxes of (W,
// rows, 1) swizzled as the layout L says; a box never crosses into the
// next head, and its rows past `seq` are filled with zeros.
template <typename L, typename T>
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int head_dim, int batch_heads, int seq,
                       int rows) {
  constexpr cuuint64_t kElem = sizeof(T);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch_heads)};
  const cuuint64_t strides[2] = {dims[0] * kElem, static_cast<cuuint64_t>(seq) * dims[0] * kElem};  // bytes
  const cuuint32_t box[3] = {L::W, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, kElem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a (batch_heads, seq, D) tensor, tiles of TileLayout<D, T>.
template <int D, typename T = __nv_bfloat16>
cudaError_t make_tile_map(CUtensorMap* map, const void* ptr, int batch_heads, int seq, int rows) {
  return encode_map<TileLayout<D, T>, T>(map, ptr, D, batch_heads, seq, rows);
}

// The map of a tensor whose head_dim is a runtime multiple of 256 (the
// instances above 256): the boxes and swizzle of a 256-wide tile, so a
// box of W columns loads at any column that is a multiple of W.
template <typename T>
cudaError_t make_wide_map(CUtensorMap* map, const void* ptr, int head_dim, int batch_heads,
                          int seq, int rows) {
  return encode_map<TileLayout<256, T>, T>(map, ptr, head_dim, batch_heads, seq, rows);
}

// Round `offset` up to the swizzle atom (1024 bytes).
__host__ __device__ constexpr size_t align1k(size_t offset) { return (offset + 1023) & ~size_t{1023}; }

// ------------------------------------------------------------ above D = 256
//
// The instances above head_dim 256 (D = 256 n, n >= 2 at run time) split
// every output by columns over a grid dimension of n: a block owns chunk
// c, the 256 columns 256 c .., of its output rows (O of K1, dQ of K2, dK
// or dV of K3), so its accumulators are a head_dim-256 instance's. The
// products that reduce over head_dim (S = Q K^T and dP = dO V^T, or S^T
// and dP^T) are streamed over all n chunks in slices of kSlice columns
// and recomputed by each of the n blocks of a row tile, in the same order,
// so the blocks agree exactly (block 0 writes K1's lse).
//
// One pipeline serves K1-K3: a block holds kRows fixed rows (query rows;
// keys in K3) and streams tiles of kRows rows of the other side. Its
// warpgroup 0's first warp is the producer (wide_produce), warpgroup 1
// the consumer. Per streamed tile the producer brings each reduction
// product's slices, the fixed rows' slice and the tile's, into a ring of
// kStages stages (full and empty barriers), then the tile's rows of chunk
// c of the output product's operand (V, K, dO or Q) into an out slot,
// with the rows' lse (base 2) and delta for K3. The consumer waits for a
// product's last slice before the next (wgmma_wait<0> a slice: the
// stream, not the tensor cores, sets the pace), so no wgmma sits under a
// branch and every loop bound is uniform over the block.
//
// Both sides stream, the fixed rows too: a block's fixed rows at D = 256
// n take 32 n KiB (bf16, 64 rows) or more, past shared memory for large n.

// bfloat16: 64 fixed rows (one consumer warpgroup) against 64-row tiles,
// slices of 256 columns (a fixed and a streamed 64 x 256 tile, 32 KiB
// each) in 3 stages, and the out slot (64 x 256, 32 KiB): 230,976 of
// 232,448 bytes.
struct WideChunkBf16 {
  using T = __nv_bfloat16;
  static constexpr int kRows = 64;   // fixed rows a block; rows a streamed tile
  static constexpr int kSlice = 256;  // reduction columns a stage
  static constexpr int kStages = 3;
  static constexpr int kStreamRows = kRows;  // rows of a stage's streamed column block
  static constexpr int kThreads = 256;  // the producer warpgroup and the consumer
  static constexpr size_t kFixed = tile_bytes<kSlice, T>(kRows);  // the streamed slice's offset
  static constexpr size_t kStage = kFixed + tile_bytes<kSlice, T>(kStreamRows);
  static constexpr uint32_t kStageTx = 2 * tile_bytes<kSlice, T>(kRows);
  static constexpr size_t kOut = kStages * kStage;
  static constexpr uint32_t kOutTx = tile_bytes<256, T>(kRows);
  static constexpr size_t kRowVals = kOut + kOutTx;  // lse (base 2), then delta
  static constexpr size_t kBar = kRowVals + 2 * kRows * sizeof(float);
  static constexpr size_t kBytes = kBar + (2 * kStages + 2) * sizeof(uint64_t) + 1024;
};

// float32 (split tf32): 32 fixed rows, stacked with their lo parts into
// one 64-row operand (tf32.cuh), against 32-row tiles, slices of 64
// columns in 4 stages (a stage: the fixed 32 x 64 slice, then the
// streamed one as a pair, per column block its 32 rows and their lo
// parts), the out slot (32 x 256, 32 KiB) and its transposed copies C^T
// and C^T_lo (256 x 32 each, 32 KiB): 197,968 of 232,448 bytes.
struct WideChunkF32 {
  using T = float;
  static constexpr int kRows = 32;
  static constexpr int kSlice = 64;
  static constexpr int kStages = 4;
  static constexpr int kStreamRows = 2 * kRows;  // the streamed rows, then their lo parts
  static constexpr int kThreads = 256;
  static constexpr size_t kFixed = tile_bytes<kSlice, T>(kRows);
  static constexpr size_t kStage = kFixed + tile_bytes<kSlice, T>(kStreamRows);
  static constexpr uint32_t kStageTx = 2 * tile_bytes<kSlice, T>(kRows);
  static constexpr size_t kOut = kStages * kStage;
  static constexpr uint32_t kOutTx = tile_bytes<256, T>(kRows);
  static constexpr size_t kCopy = kOut + kOutTx;  // C^T, then C^T_lo
  static constexpr size_t kCopyBytes = tile_bytes<kRows, T>(256);
  static constexpr size_t kRowVals = kCopy + 2 * kCopyBytes;
  static constexpr size_t kBar = kRowVals + 2 * kRows * sizeof(float);
  static constexpr size_t kBytes = kBar + (2 * kStages + 2) * sizeof(uint64_t) + 1024;
};

// The barriers of an instance above 256, after its shared memory's ring,
// out slot and row values: full and empty a stage, out_full, out_empty.
template <typename W>
struct WideBars {
  uint64_t *full, *empty, *out_full, *out_empty;
  __device__ explicit WideBars(uint8_t* smem) {
    full = reinterpret_cast<uint64_t*>(smem + W::kBar);
    empty = full + W::kStages;
    out_full = empty + W::kStages;
    out_empty = out_full + 1;
  }
  // By thread 0, before the block's first barrier: the producer warp's
  // lanes arrive on out_full, the consumer's 4 warps release.
  __device__ void init() const {
    for (int s = 0; s < W::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(out_full, 32);
    mbar_init(out_empty, 4);
    fence_barrier_init();
  }
};

// Columns col .. col + kCols of the map's box rows from `row` of head bh,
// one box per column block, into a tile of TileLayout<kCols, T> whose
// column blocks hold `block_rows` rows; counted on `bar`.
template <int kCols, typename T>
__device__ __forceinline__ void load_slice_tma(void* tile, const CUtensorMap* map, uint64_t* bar,
                                               int block_rows, int col, int row, int bh) {
  using L = TileLayout<kCols, T>;
#pragma unroll
  for (int c = 0; c < L::kBlocks; ++c) {
    tma_load_3d(static_cast<char*>(tile) + c * L::block_bytes(block_rows), map, bar,
                col + c * L::W, row, bh);
  }
}

// The producer warp of an instance above 256 (all its lanes; lane 0
// issues the loads). Streamed tile j's rows start at n_begin + j kRows.
// Per tile: the slices of reduction product 0 (fixed0's rows f0 against
// stream0's, all 256 n columns), then `slices1` slices of product 1
// (fixed1, stream1: all of them, or none), then the tile's rows of chunk
// c of `out`, with, where `lse` is given, the rows' lse (base 2) and
// delta (0 past `seq`). Fill m of a stage waits for fill m - 1's release;
// fill 0 waits on the phase before the barrier's first, which counts as
// complete.
template <typename W>
__device__ __forceinline__ void wide_produce(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                             uint64_t* out_full, uint64_t* out_empty,
                                             const CUtensorMap* fixed0, const CUtensorMap* stream0,
                                             const CUtensorMap* fixed1, const CUtensorMap* stream1,
                                             int slices1, const CUtensorMap* out,
                                             const float* lse, const float* delta, int n, int c,
                                             int f0, int n_begin, int tiles, int bh, int seq) {
  using T = typename W::T;
  constexpr int kPerLane = W::kRows / 32;
  const int lane = threadIdx.x % 32;
  const int slices0 = n * (256 / W::kSlice);
  const int64_t row_base = static_cast<int64_t>(bh) * seq;
  int it = 0;  // stage fills so far
  for (int j = 0; j < tiles; ++j) {
    const int row = n_begin + j * W::kRows;
    if (lane == 0) {
      for (int h = 0; h < slices0 + slices1; ++h, ++it) {
        const bool second = h >= slices0;
        const int col = (second ? h - slices0 : h) * W::kSlice;
        const int s = it % W::kStages;
        uint8_t* st = smem + s * W::kStage;
        mbar_wait(&empty[s], ((it / W::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], W::kStageTx);
        load_slice_tma<W::kSlice, T>(st, second ? fixed1 : fixed0, &full[s], W::kRows, col, f0,
                                     bh);
        load_slice_tma<W::kSlice, T>(st + W::kFixed, second ? stream1 : stream0, &full[s],
                                     W::kStreamRows, col, row, bh);
      }
    }
    // This lane's rows' lse and delta, read before the slot is free.
    float vals[2][kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int r = row + lane + 32 * i;
      const bool live = lse != nullptr && r < seq;
      vals[0][i] = live ? lse[row_base + r] * kLog2e : 0.f;
      vals[1][i] = live ? delta[row_base + r] : 0.f;
    }
    mbar_wait(out_empty, (j & 1) ^ 1);
    float* row_vals = reinterpret_cast<float*>(smem + W::kRowVals);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      row_vals[lane + 32 * i] = vals[0][i];
      row_vals[W::kRows + lane + 32 * i] = vals[1][i];
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(out_full, W::kOutTx);
      load_slice_tma<256, T>(smem + W::kOut, out, out_full, W::kRows, 256 * c, row, bh);
    } else {
      mbar_arrive(out_full);
    }
  }
}

// acc (64 x 64, f32) = the fixed rows' 64 x (256 n) times the streamed
// tile's transposed, over `slices` bf16 ring stages from fill `it` (which
// it advances), each released once its products are done.
__device__ __forceinline__ void wide_reduce_bf16(float (&acc)[32], uint8_t* smem, uint64_t* full,
                                                 uint64_t* empty, int& it, int slices) {
  using W = WideChunkBf16;
  for (int h = 0; h < slices; ++h, ++it) {
    const int s = it % W::kStages;
    const uint8_t* st = smem + s * W::kStage;
    mbar_wait(&full[s], (it / W::kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W::kSlice / 16; ++kk) {
      wgmma_ss<64>(acc, desc_k_major<W::kSlice>(st, W::kRows, 0, kk),
                   desc_k_major<W::kSlice>(st + W::kFixed, W::kRows, 0, kk), h > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
}

}  // namespace sm90
}  // namespace flash
