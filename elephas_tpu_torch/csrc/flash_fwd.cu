// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces elephas_tpu/ops/attention_pallas.py::_flash_fwd_kernel (K1):
// softmax(scale * Q K^T, causal or full) V with a float32 online softmax,
// k-tiles wholly above the diagonal skipped, keys past the sequence end
// masked, O written in the input dtype and the per-row log-sum-exp in
// float32. Fully-masked rows get a finite lse, as in K1.
//
// Design. The TPU grid's sequential k axis and its VMEM scratch become a
// loop inside one block over K/V tiles; the running max and sum and the
// output accumulator stay in float32 registers. Scores are kept in base 2
// (log2(e) folded into the scale) so the exponentials are exp2; the lse is
// converted back to base e. Two kernels:
//
// - bfloat16, built for Hopper (sm90.cuh). One block per (192 query rows,
//   batch*head), four warpgroups. Warp 0 is the producer: it loads the
//   block's Q tile once and streams K and V tiles (128 keys at D = 32 and
//   64, 64 at D = 128) by TMA into a ring of 3 stages, each with its own
//   full barriers for K and for V and an empty barrier the consumers
//   release. TMA's 3-D boxes (D, rows, 1) never cross into the next head
//   and fill rows past the sequence with zeros. Three consumer warpgroups
//   own 64 query rows each (three rather than two, so more warpgroups'
//   products hide each one's softmax; their registers still fit in 160
//   a thread): S = Q K^T and O += P V are wgmma products (Q and K
//   K-major from shared memory; P from registers; V read MN-major through
//   the descriptor's transpose bit). The softmax runs on the accumulator
//   registers: row max by quad shuffles, p = exp2(s*c - m) as one FFMA
//   and one MUFU.EX2, P rounded to bf16 straight into the A-operand
//   layout. Masks run only on tiles that need them (the causal diagonal
//   and a ragged last tile). The exponentials overlap the tensor cores
//   inside each warpgroup: tile j's Q K^T and tile j-1's P V are issued
//   together, and tile j's softmax runs while P V is in flight (no
//   ping-pong between the warpgroups, so no named barriers). Blocks are
//   handed out longest first (causal), so the last wave holds the
//   shortest q tiles. setmaxnreg moves registers from the producer
//   warpgroup (24 a thread) to the consumers (160).
// - float32: float32 FMAs, one thread per query row, so results keep full
//   float32 precision (TF32 tensor cores would not). Scores are taken 16
//   keys at a time so one accumulator rescale serves 16 keys; every K/V
//   read from shared memory is a 16-byte broadcast.
//
// Bound. Causal work is 2*B*H*S^2*D FLOPs (K1's CostEstimate) and the
// traffic is 4*B*H*S*D*itemsize bytes plus the lse, so at the LM's shape
// (8, 8, 2048, 32) both kernels are bound by operations. In bf16 the
// exponentials (one per valid score, 16 per clock per SM) are a floor of
// their own, above the tensor cores' at D = 32.

#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kBlockQ = kTile;  // float32: query rows per block
constexpr int kBlockK = kTile;  // float32: keys per shared-memory tile

// ---------------------------------------------------------------- bf16

namespace hopper {

using namespace flash::sm90;

constexpr int kConsumers = 3;                 // consumer warpgroups, 64 query rows each
constexpr int kRows = 64 * kConsumers;        // query rows per block
constexpr int kStages = 3;                    // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kConsumerRegs = 160;  // after setmaxnreg: 128 * 24 + 384 * 160 <= 65536

template <int D>
constexpr int keys_per_tile() { return D == 128 ? 64 : 128; }

// Shared memory: the Q tile, kStages K tiles, kStages V tiles (each on a
// 1024-byte boundary), then the barriers; plus slack to align the base.
template <int D>
struct Smem {
  static constexpr int kN = keys_per_tile<D>();
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align1k(kQ + tile_bytes<D>(kRows));
  static constexpr size_t kV = kK + kStages * align1k(tile_bytes<D>(kN));
  static constexpr size_t kBar = kV + kStages * align1k(tile_bytes<D>(kN));
  static constexpr size_t kStage = align1k(tile_bytes<D>(kN));
  static constexpr size_t kBytes = kBar + (1 + 3 * kStages) * sizeof(uint64_t) + 1024;
};

// Softmax of one score tile in place (s becomes p = exp2(s*c - m)),
// masked where `mask`, updating this thread's running max m (base 2) and
// its share l of the row sums; returns the factors that rescale O.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool mask, int k0,
                                             const int (&rows)[2], int seq, int causal,
                                             float scale_log2) {
  const int t = threadIdx.x % 4;
  if (mask) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      const int row = rows[(i / 2) & 1];
      if (col >= seq || (causal && col > row)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    shift[r] = isfinite(m_new) ? m_new : 0.f;
    corr[r] = isfinite(m[r]) ? exp2_approx(m[r] - shift[r]) : 0.f;
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i / 2) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -shift[r]));
    sum[r] += s[i];
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// P (64 x N, f32 accumulator layout) rounded to bf16 A operands, 16 keys each.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// S = Q K^T for one warpgroup's 64 query rows (from row q_row0 of the Q
// tile) against a tile of N keys, committed as one wgmma group.
template <int D, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N / 2], const uint8_t* q_s, int q_row0,
                                         const uint8_t* k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<N>(s, desc_k_major<D>(q_s, kRows, q_row0, kk), desc_k_major<D>(k_s, N, 0, kk),
                kk > 0);
  }
  wgmma_commit();
}

// O += P V over a tile of N keys, committed as one wgmma group.
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p)[N / 16][4],
                                         const uint8_t* v_s) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<D>(acc, p[kk], desc_mn_major<D>(v_s, N, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using S = Smem<D>;
  constexpr int N = S::kN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint8_t* q_s = smem + S::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int tiles = (kv_end + N - 1) / N;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, tile_bytes<D>(kRows));
      load_tile_tma<D>(q_s, &q_map, q_full, kRows, q0, bh);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], tile_bytes<D>(N));
        load_tile_tma<D>(smem + S::kK + s * S::kStage, &k_map, &k_full[s], N, j * N, bh);
        mbar_arrive_expect_tx(&v_full[s], tile_bytes<D>(N));
        load_tile_tma<D>(smem + S::kV + s * S::kStage, &v_map, &v_full[s], N, j * N, bh);
      }
    }
    return;
  }

  // Consumers: this warpgroup's 64 rows start at r0.
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = q0 + (warpgroup - 1) * 64;
  const int rows[2] = {r0 + warp * 16 + lane / 4, r0 + warp * 16 + lane / 4 + 8};
  const int q_row0 = (warpgroup - 1) * 64;  // within the Q tile

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2];
  uint32_t p[N / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  const auto k_tile = [&](int j) { return smem + S::kK + (j % kStages) * S::kStage; };
  const auto v_tile = [&](int j) { return smem + S::kV + (j % kStages) * S::kStage; };
  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > r0) || j * N + N > seq;
  };

  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  wgmma_fence();
  issue_qk<D, N>(s, q_s, q_row0, k_tile(0));
  wgmma_wait<0>();
  fence_operand(s);
  softmax_tile<N>(s, m, l, corr, needs_mask(0), 0, rows, seq, causal, scale_log2);
  pack_p<N>(p, s);

  for (int j = 1; j < tiles; ++j) {
    // Tile j's S = Q K^T and tile j-1's O += P V in flight together; tile
    // j's softmax runs while P V is still on the tensor cores.
    mbar_wait(&k_full[j % kStages], (j / kStages) & 1);
    fence_operand(acc);
    wgmma_fence();
    issue_qk<D, N>(s, q_s, q_row0, k_tile(j));
    mbar_wait(&v_full[(j - 1) % kStages], ((j - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<D, N>(acc, p, v_tile(j - 1));
    wgmma_wait<1>();
    fence_operand(s);
    softmax_tile<N>(s, m, l, corr, needs_mask(j), j * N, rows, seq, causal, scale_log2);
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];
    pack_p<N>(p, s);
  }
  mbar_wait(&v_full[(tiles - 1) % kStages], ((tiles - 1) / kStages) & 1);
  fence_operand(acc);
  wgmma_fence();
  issue_pv<D, N>(acc, p, v_tile(tiles - 1));
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(&empty[(tiles - 1) % kStages]);

  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    if (rows[r] >= seq) continue;
    if (t == 0) {
      const float shift = isfinite(m[r]) ? m[r] : 0.f;
      lse[static_cast<int64_t>(bh) * seq + rows[r]] = (shift + log2f(denom)) * kLn2;
    }
    bf16* out = o + (static_cast<int64_t>(bh) * seq + rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int batch_heads, int seq, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int N = keys_per_tile<D>();
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<D>(&q_map, q, batch_heads, seq, kRows)) != cudaSuccess ||
      (err = make_tile_map<D>(&k_map, k, batch_heads, seq, N)) != cudaSuccess ||
      (err = make_tile_map<D>(&v_map, v, batch_heads, seq, N)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = Smem<D>::kBytes;
  if ((err = allow_smem(flash_fwd_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + kRows - 1) / kRows);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace hopper

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
  if constexpr (kBf16) {
    return hopper::launch<D>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
  } else {
    const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch_heads);
    // Above 48 KB of shared memory the kernel must opt in to the larger size.
    constexpr size_t smem = f32_smem_bytes<D>();
    const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_kernel<D><<<grid, kBlockQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), seq,
        causal, scale_log2);
    return cudaGetLastError();
  }
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
