// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces elephas_tpu/ops/attention_pallas.py::_flash_fwd_kernel (K1):
// softmax(scale * Q K^T, causal or full) V with a float32 online softmax,
// k-tiles wholly above the diagonal skipped, keys past the sequence end
// masked, O written in the input dtype and the per-row log-sum-exp in
// float32. Fully-masked rows get a finite lse, as in K1.
//
// Design. One thread block per (64-row query tile, batch*head). The TPU
// grid's sequential k axis and its VMEM scratch become a loop inside the
// block over K/V tiles of 64 keys staged through shared memory; the running
// max and sum and the output accumulator stay in float32 registers. Scores
// are kept in base 2 (log2(e) folded into the scale) so the exponentials
// are exp2f; the lse is converted back to base e. Two kernels:
//
// - bfloat16: both products on the tensor cores with mma.sync m16n8k16
//   (bf16 in, f32 accumulate). Four warps each own 16 query rows; Q, K and
//   V fragments come from shared memory with ldmatrix (rows padded by 16
//   bytes so the 8-row reads do not conflict), the softmax runs on the
//   score fragments with quad shuffles for the row max, and P is rounded to
//   bf16 as the A operand of P V.
// - float32: float32 FMAs, one thread per query row, so results keep full
//   float32 precision (TF32 tensor cores would not). Scores are taken 16
//   keys at a time so one accumulator rescale serves 16 keys; every K/V
//   read from shared memory is a 16-byte broadcast.
//
// Bound. Causal work is 2*B*H*S^2*D FLOPs (K1's CostEstimate) and the
// traffic is 4*B*H*S*D*itemsize bytes plus the lse, so at the LM's shape
// (8, 8, 2048, 32) both kernels are bound by operations. Neither uses
// wgmma or TMA yet (later work), and neither overlaps tile loads with
// compute beyond what other resident blocks provide.

#include <math.h>

#include "common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = kTile;  // query rows per block
constexpr int kBlockK = kTile;  // keys per shared-memory tile

// ---------------------------------------------------------------- bf16

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBlockQ + 2 * kBlockK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int seq, int causal, float scale_log2) {
  constexpr int DS = D + 8;  // padded row stride (elements)
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* k_s = q_s + kBlockQ * DS;
  __nv_bfloat16* v_s = k_s + kBlockK * DS;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBlockQ;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * D;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<__nv_bfloat16, D, 8, kMmaThreads>(q_s, q + base, q0, seq);
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a<DS>(qf[kk], q_s, warp * 16, kk * 16);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max per row, base 2
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

  const int kv_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<__nv_bfloat16, D, 8, kMmaThreads>(k_s, k + base, k0, seq);
    load_tile<__nv_bfloat16, D, 8, kMmaThreads>(v_s, v + base, k0, seq);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 fragments of 16x8.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBlockK / 16; ++jp) {
        uint32_t b[4];
        load_b<DS>(b, k_s, jp * 16, kk * 16);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // Scale, mask, and the tile's row max (fragment: c0,c1 row g; c2,c3 row g+8).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + j * 8 + 2 * t + (c & 1);
        const bool valid = col < seq && (!causal || col <= rows[c / 2]);
        s[j][c] = valid ? s[j][c] * scale_log2 : -INFINITY;
        mx[c / 2] = fmaxf(mx[c / 2], s[j][c]);
      }
    }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      shift[r] = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[r]) ? exp2f(m[r] - shift[r]) : 0.f;
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V, 16 keys at a time: two score fragments make one A operand.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2f(s[2 * kk][c] - shift[c / 2]);
        p[4 + c] = exp2f(s[2 * kk + 1][c] - shift[c / 2]);
      }
      l[0] += p[0] + p[1] + p[4] + p[5];
      l[1] += p[2] + p[3] + p[6] + p[7];
      const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                             pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        load_b_trans<DS>(b, v_s, kk * 16, np * 16);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    if (rows[r] >= seq) continue;
    if (t == 0) {
      const float shift = isfinite(m[r]) ? m[r] : 0.f;
      lse[static_cast<int64_t>(blockIdx.y) * seq + rows[r]] = (shift + log2f(denom)) * kLn2;
    }
    __nv_bfloat16* out = o + base + static_cast<int64_t>(rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int kChunk = 16;  // keys per online-softmax update

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 4) + 2 * kBlockK * D);
}

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, int causal,
                     float scale_log2) {
  constexpr int QS = D + 4;  // padded query-row stride, 16-byte aligned
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBlockQ * QS;
  float* v_s = k_s + kBlockK * D;

  const int tid = threadIdx.x;  // one thread per query row
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + tid;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * D;

  // Query tile, scaled in float32 (by scale * log2(e)); rows past the end are 0.
  for (int i = tid; i < kBlockQ * D; i += kBlockQ) {
    const int r = i / D, c = i % D;
    q_s[r * QS + c] =
        q0 + r < seq ? q[base + static_cast<int64_t>(q0 + r) * D + c] * scale_log2 : 0.f;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max, base 2
  float l = 0.f;        // running sum

  // Causal: tiles starting past this block's last row contribute nothing.
  const int kv_end = causal ? min(seq, q0 + kBlockQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int i = tid; i < kBlockK * D; i += kBlockQ) {
      const int kr = k0 + i / D;
      const int64_t off = base + static_cast<int64_t>(kr) * D + i % D;
      k_s[i] = kr < seq ? k[off] : 0.f;
      v_s[i] = kr < seq ? v[off] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < kBlockK; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + tid * QS + d);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(k_s + (j0 + j) * D + d);
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
      float chunk_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = k0 + j0 + j;
        const bool valid = kpos < seq && (!causal || kpos <= row);
        s[j] = valid ? s[j] : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float shift = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m) ? exp2f(m - shift) : 0.f;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = exp2f(s[j] - shift);
        p_sum += s[j];
      }
      l = l * corr + p_sum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + (j0 + j) * D + d);
          acc[d] = fmaf(s[j], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  if (row < seq) {
    const float shift = isfinite(m) ? m : 0.f;
    lse[static_cast<int64_t>(blockIdx.y) * seq + row] = (shift + log2f(denom)) * kLn2;
  }
  // Stage the normalised row in this thread's own q_s row, then store the
  // tile row-major so consecutive threads write consecutive addresses.
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(q_s + tid * QS + d) =
        make_float4(acc[d] / denom, acc[d + 1] / denom, acc[d + 2] / denom,
                    acc[d + 3] / denom);
  }
  __syncthreads();
  for (int i = tid; i < kBlockQ * D; i += kBlockQ) {
    const int r = i / D, c = i % D;
    if (q0 + r < seq) o[base + static_cast<int64_t>(q0 + r) * D + c] = q_s[r * QS + c];
  }
}

// ---------------------------------------------------------------- launch

template <int D, bool kBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch_heads, int seq, int causal,
                   float scale_log2, cudaStream_t stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch_heads);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  // Above 48 KB of shared memory the kernel must opt in to the larger size.
  if constexpr (kBf16) {
    using T = __nv_bfloat16;
    constexpr size_t smem = bf16_smem_bytes<D>();
    err = allow_smem(flash_fwd_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse_f, seq, causal,
        scale_log2);
  } else {
    constexpr size_t smem = f32_smem_bytes<D>();
    err = allow_smem(flash_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, kBlockQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse_f, seq,
        causal, scale_log2);
  }
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int batch_heads, int seq, int head_dim,
                         int causal, float scale_log2, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<32, kBf16>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
    case 64:
      return launch<64, kBf16>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
    case 128:
      return launch<128, kBf16>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (batch_heads, seq, head_dim) contiguous and 16-byte aligned,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse: (batch_heads, seq)
// float32. Launches on `stream` and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int batch_heads, int seq, int head_dim,
                         int is_bf16, int causal, float sm_scale, void* stream) {
  const float scale_log2 = sm_scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dim<true>(q, k, v, o, lse, batch_heads, seq, head_dim,
                                   causal, scale_log2, s)
              : dispatch_dim<false>(q, k, v, o, lse, batch_heads, seq, head_dim,
                                    causal, scale_log2, s);
  return static_cast<int>(err);
}
