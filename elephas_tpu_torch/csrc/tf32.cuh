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

}  // namespace tf32
}  // namespace flash
