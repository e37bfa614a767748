// Split tf32: float32 products on the tf32 tensor cores with float32
// accuracy, shared by the float32 kernels (flash_fwd.cu K1, flash_bwd.cu
// K2 and K3).
//
// Each product a b is taken as a_lo b + a b_lo + a b, accumulated in f32:
// the tensor cores read the top 19 bits of a float32 (sign, exponent, 10
// mantissa bits), so a itself is its hi part, and a_lo = a minus a with its
// low 13 bits cleared is formed explicitly; what is left out, a_lo b_lo and
// the low bits of a_lo, is about 2^-21 of |a b|.
//
// tf32 operands in shared memory are K-major only (the descriptor's
// transpose bit exists only for 16-bit types), so a product whose
// reduction axis is not a tile's contiguous axis reads a transposed copy
// that the consumer threads write. A register A operand taken from an f32
// accumulator holds, per thread, columns 2t and 2t+1 of each group of 8,
// where the tf32 A fragment wants t and t+4: the transposed copy permutes
// its reduction index within each group of 8 (`fragment_pos`) so that the
// accumulator registers are the fragment as they are, with no shuffle.
#pragma once

#include "sm90.cuh"

namespace flash {
namespace tf32 {

using sm90::TileLayout;

// The part of x the tensor cores do not read.
__device__ __forceinline__ float lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float4 lo(float4 x) {
  return make_float4(lo(x.x), lo(x.y), lo(x.z), lo(x.w));
}

// lo of `bytes` bytes of float32 data at `src` into `dst`, elementwise, so
// the copy keeps the source's swizzled layout; thread `tid` of `threads`.
__device__ __forceinline__ void write_lo(uint8_t* dst, const uint8_t* src, int bytes, int tid,
                                         int threads) {
  for (int i = tid; i < bytes / 16; i += threads) {
    *reinterpret_cast<float4*>(dst + i * 16) = lo(*reinterpret_cast<const float4*>(src + i * 16));
  }
}

// lo of rows row0 .. row0 + n of a (rows, D) float32 tile.
template <int D>
__device__ __forceinline__ void write_lo_rows(uint8_t* dst, const uint8_t* src, int rows, int row0,
                                              int n, int tid, int threads) {
  using L = TileLayout<D, float>;
#pragma unroll
  for (int c = 0; c < L::kBlocks; ++c) {
    const int base = c * L::block_bytes(rows) + row0 * L::kSwizzle;
    write_lo(dst + base, src + base, n * L::kSwizzle, tid, threads);
  }
}

// Position of reduction index r in a transposed copy: within its group of
// 8, index 2c goes to c and 2c + 1 to c + 4 (c < 4).
__host__ __device__ constexpr int fragment_pos(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// The (R, C) float32 tile `src` (TileLayout<C, float>, as TMA loads it)
// transposed into the K-major B operand of a product that reduces over its
// R rows: C rows of R columns (TileLayout<R, float>), column fragment_pos(r)
// holding source row r; the values into `hi` and their lo into `lo_t`.
template <int R, int C>
__device__ __forceinline__ void write_transposed(uint8_t* hi, uint8_t* lo_t, const uint8_t* src,
                                                 int tid, int threads) {
  using Src = TileLayout<C, float>;
  using Dst = TileLayout<R, float>;
  for (int i = tid; i < R * C / 4; i += threads) {
    const int r = i % R, c = (i / R) * 4;  // source row, first of 4 columns
    const float4 x = *reinterpret_cast<const float4*>(
        src + (c / Src::W) * Src::block_bytes(R) + Src::offset(r, (c % Src::W) * 4));
    const int pos = fragment_pos(r);
    const int block = (pos / Dst::W) * Dst::block_bytes(C), col = (pos % Dst::W) * 4;
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = block + Dst::offset(c + e, col);
      *reinterpret_cast<float*>(hi + off) = v[e];
      *reinterpret_cast<float*>(lo_t + off) = lo(v[e]);
    }
  }
}

// A (64 x N, f32 accumulator layout: d[4j + 2i + c] is row 16w + l/4 + 8i,
// column 8j + 2(l%4) + c) as tf32 A fragments of 8 columns each, hi (low
// 13 bits cleared) and lo, in the column order of fragment_pos.
template <int N>
__device__ __forceinline__ void split_fragments(uint32_t (&hi)[N / 8][4], uint32_t (&lo_f)[N / 8][4],
                                                const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[kk][r] = __float_as_uint(x[r]) & 0xffffe000u;
      lo_f[kk][r] = __float_as_uint(x[r] - __uint_as_float(hi[kk][r]));
    }
  }
}

// ------------------------------------------------ stacked tiles (D = 256)
//
// At head_dim 256 a float32 tile of 64 rows is 64 KiB, so a block cannot
// hold two 64-row operands of one side with their lo copies. A stacked
// tile holds 32 source rows and their lo parts in one 64-row wgmma
// operand: rows 16w .. 16w + 7 are source rows 8w .. 8w + 7 (w < 4) and
// rows 16w + 8 .. 16w + 15 their lo parts, so a product over it leaves
// the hi and the lo product of source row 8w + l/4 in the same thread
// (rows i = 0 and i = 1 of its accumulator), which adds them. As an A
// operand from registers (load_stacked_a, stacked_fragments) a row's hi
// part is in fragment rows g and its lo part in rows g + 8. One product
// against a paired B (B, then B_lo) gives all four terms of the split.

// A paired tile (kCols columns, 256 at D = 256) holds per 128-byte column
// block kRows rows: the kRows / 2 rows TMA brings, then their lo parts, so
// that one product against it gives A B and A B_lo. The first half of each
// block of `pair` as its lo parts into the second; by the 128 threads of
// one warpgroup.
template <int kRows = 32, int kCols = 256>
__device__ __forceinline__ void write_pair_lo(uint8_t* pair, int ctid) {
  using L = TileLayout<kCols, float>;
  constexpr int kBlock = L::block_bytes(kRows);
  constexpr int kChunks = kBlock / 2 / 16;  // 16-byte chunks of half a block
  static_assert(L::kBlocks * kChunks % 128 == 0, "a pair's lo parts split unevenly");
#pragma unroll
  for (int k = 0; k < L::kBlocks * kChunks / 128; ++k) {
    const int i = ctid + 128 * k;
    uint8_t* p = pair + (i / kChunks) * kBlock + (i % kChunks) * 16;
    *reinterpret_cast<float4*>(p + kBlock / 2) = lo(*reinterpret_cast<const float4*>(p));
  }
}

// The stacked A operand of this thread's row `r` of a (32, kCols) float32
// tile as TMA stores it: per k8 step kk, hi and lo of columns 8kk + t
// (a[kk][0], a[kk][1]) and 8kk + t + 4 (a[kk][2], a[kk][3]).
template <int kCols = 256>
__device__ __forceinline__ void load_stacked_a(uint32_t (&a)[kCols / 8][4], const uint8_t* tile,
                                               int r, int t) {
  using L = TileLayout<kCols, float>;
#pragma unroll
  for (int kk = 0; kk < kCols / 8; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * kk + t + 4 * h;
      const float x = *reinterpret_cast<const float*>(
          tile + (col / L::W) * L::block_bytes(32) + L::offset(r, (col % L::W) * 4));
      a[kk][2 * h] = __float_as_uint(x) & 0xffffe000u;
      a[kk][2 * h + 1] = __float_as_uint(x - __uint_as_float(a[kk][2 * h]));
    }
  }
}

// One row's values (m[2j + c]: column 8j + 2(l%4) + c) as stacked tf32 A
// fragments of 8 columns each, in the column order of fragment_pos: hi in
// fragment rows g (a[0], a[2]), lo in rows g + 8 (a[1], a[3]).
template <int N>
__device__ __forceinline__ void stacked_fragments(uint32_t (&a)[N / 8][4], const float (&m)[N / 4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float x = m[2 * kk + c];
      a[kk][2 * c] = __float_as_uint(x) & 0xffffe000u;
      a[kk][2 * c + 1] = __float_as_uint(x - __uint_as_float(a[kk][2 * c]));
    }
  }
}

// ------------------------------------------------ above D = 256
//
// The float32 instances above head_dim 256 (sm90.cuh, WideChunkF32) take
// 32 fixed rows as a stacked operand, as at D = 256, one slice of
// columns at a time: the fixed side streams too.

// x (64 x 64, f32) = the stacked fixed rows (32 rows and their lo parts)
// times the streamed pair (32 rows, then their lo parts) transposed, over
// all head_dim: `slices` float32 ring stages from fill `it` (which it
// advances). Per stage the warpgroup writes the pair's lo parts, loads
// the stacked A from the fixed slice and releases the stage once its
// products are done. Row r (8w + l/4) and column t (l % 4) of this thread
// as in tf32::load_stacked_a; `ctid` its index in the warpgroup.
__device__ __forceinline__ void wide_reduce_f32(float (&x)[32], uint8_t* smem, uint64_t* full,
                                                uint64_t* empty, int& it, int slices, int r,
                                                int t, int ctid) {
  using W = sm90::WideChunkF32;
  constexpr int kSteps = W::kSlice / 8;
  for (int h = 0; h < slices; ++h, ++it) {
    const int s = it % W::kStages;
    uint8_t* st = smem + s * W::kStage;
    sm90::mbar_wait(&full[s], (it / W::kStages) & 1);
    write_pair_lo<W::kStreamRows, W::kSlice>(st + W::kFixed, ctid);
    sm90::fence_proxy_async();
    sm90::named_barrier_sync(1, 128);
    uint32_t a[kSteps][4];
    load_stacked_a<W::kSlice>(a, st, r, t);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) sm90::fence_operand(a[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      sm90::wgmma_rs_tf32<2 * W::kRows>(
          x, a[kk], sm90::desc_k_major<W::kSlice, float>(st + W::kFixed, W::kStreamRows, 0, kk),
          h > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(x);
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[s]);
  }
}

// S (or dP, S^T, dP^T) of this thread's row against 32 streamed rows
// from x: m[2j + c] is streamed row 8j + 2t + c, the sum of the hi and lo
// rows' products with the pair's row and its lo part.
__device__ __forceinline__ void merge_stacked(float (&m)[8], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[2 * j + c] = (x[4 * j + c] + x[4 * j + 2 + c]) + (x[4 * j + 16 + c] + x[4 * j + 18 + c]);
    }
  }
}

// acc (the stacked fixed rows x the 256 columns of chunk c) += the stacked
// A `fr` (P, dS, P^T or dS^T over the 32 streamed rows) times the tile's
// rows of chunk c, from its transposed copies C^T and C^T_lo (256 rows of
// 32, keys in fragment_pos order); one wgmma group.
__device__ __forceinline__ void wide_out_f32(float (&acc)[2][64], uint32_t (&fr)[4][4],
                                             const uint8_t* copy_hi, const uint8_t* copy_lo) {
  using W = sm90::WideChunkF32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::fence_operand(fr[kk]);
  sm90::wgmma_fence();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int kk = 0; kk < W::kRows / 8; ++kk) {
      sm90::wgmma_rs_tf32<128>(acc[half], fr[kk],
                               sm90::desc_k_major<W::kRows, float>(copy_hi, 256, 128 * half, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < W::kRows / 8; ++kk) {
      sm90::wgmma_rs_tf32<128>(acc[half], fr[kk],
                               sm90::desc_k_major<W::kRows, float>(copy_lo, 256, 128 * half, kk), 1);
    }
  }
  sm90::wgmma_commit();
}

}  // namespace tf32
}  // namespace flash
