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
// converted back to base e. Both dtypes are built for Hopper (sm90.cuh)
// in one shape: warp 0 is the producer, which loads the block's Q tile once
// and streams K and V tiles by TMA into a ring of stages with full barriers
// and empty barriers the consumers release; TMA's 3-D boxes (D, rows, 1)
// never cross into the next head and fill rows past the sequence with
// zeros. Consumer warpgroups own 64 query rows each: S = Q K^T and O += P V
// are wgmma products, the softmax runs on the accumulator registers (row
// max by quad shuffles, p = exp2(s*c - m) as one FFMA and one MUFU.EX2),
// masks run only on tiles that need them (the causal diagonal and a ragged
// last tile), and tile j's Q K^T and tile j-1's P V are issued together so
// tile j's softmax runs while P V is in flight (no ping-pong between the
// warpgroups). Blocks are handed out longest first (causal), so the last
// wave holds the shortest q tiles. setmaxnreg moves registers from the
// producer warpgroup (24 a thread) to the consumers.
//
// - bfloat16: 192 query rows per block (three consumer warpgroups at 160
//   registers, so more warpgroups' products hide each one's softmax), K/V
//   tiles of 128 keys (64 at D = 128) in 3 stages; at D = 256, where O
//   takes 128 registers a thread, 128 rows (two warpgroups at 240) against
//   64-key tiles in 2 stages (192 KiB). Q and K are K-major
//   operands from shared memory; P is rounded to bf16 straight into the
//   register A-operand layout; V is read MN-major through the descriptor's
//   transpose bit.
// - float32, in split tf32 (tf32.cuh, shared with the float32 backward) so
//   results keep float32 accuracy: each product
//   a b is a_lo b + a b_lo + a b on tf32 tensor cores (m64nNk8), the
//   tensor cores reading the top 19 bits of a float32 and a_lo = a minus a
//   with its low 13 bits cleared, accumulated in f32; what is left out is
//   about 2^-21 of |a b|. tf32 operands in shared memory are K-major only,
//   so the consumers write, per arriving tile, K_lo and a transposed V^T
//   and V^T_lo (keys permuted within groups of 8 so that P's accumulator
//   registers are its A fragment as they are), and Q_lo once; a named
//   barrier over the consumers and a proxy fence publish them to wgmma.
//   Per D, three / two / one consumer warpgroups, tiles of 64 / 64 / 32
//   keys and 3 / 2 / 2 stages fit the registers (S, P_hi and P_lo, N / 2
//   each, and O, D / 2) and the shared memory (Q, Q_lo and five tiles a
//   stage). At D = 256 Q and Q_lo of 64 rows alone take 128 KiB: the
//   block takes 32 query rows as one stacked tile (tf32.cuh), 16-key tiles
//   in 2 stages (F32Shape<256>).
//
// Bound. Causal work is 2*B*H*S^2*D FLOPs (K1's CostEstimate) and the
// traffic is 4*B*H*S*D*itemsize bytes plus the lse, so at the LM's shape
// (8, 8, 2048, 32) both kernels are bound by operations. In bf16 the
// exponentials (one per valid score, 16 per clock per SM) are a floor of
// their own, above the tensor cores' at D = 32. In float32 the split
// takes three tf32 products per product, 6*B*H*S^2*D FLOPs at 495 TFLOP/s,
// against the float32 FMA bound of 2*B*H*S^2*D at 67 TFLOP/s.

#include <math.h>

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16

namespace hopper {

using namespace flash::sm90;

// Consumer warpgroups (64 query rows each), keys per K/V tile and the
// ring's depth: three warpgroups at 160 registers (128 * 24 + 384 * 160 <=
// 65536), tiles of 128 keys (64 at D = 128) in 3 stages; at D = 256, where
// O alone takes 128 registers a thread, two warpgroups at 240 and 64-key
// tiles in 2 stages (a 128-row Q tile and 64 KiB a stage).
template <int D>
struct Shape {
  static constexpr int kConsumers = D == 256 ? 2 : 3;
  static constexpr int kN = D >= 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kRows = 64 * kConsumers;            // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;  // after setmaxnreg
};

// Shared memory: the Q tile, kStages K tiles, kStages V tiles (each on a
// 1024-byte boundary), then the barriers; plus slack to align the base.
template <int D>
struct Smem {
  using Sh = Shape<D>;
  static constexpr int kN = Sh::kN;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = align1k(kQ + tile_bytes<D>(Sh::kRows));
  static constexpr size_t kV = kK + Sh::kStages * align1k(tile_bytes<D>(kN));
  static constexpr size_t kBar = kV + Sh::kStages * align1k(tile_bytes<D>(kN));
  static constexpr size_t kStage = align1k(tile_bytes<D>(kN));
  static constexpr size_t kBytes = kBar + (1 + 3 * Sh::kStages) * sizeof(uint64_t) + 1024;
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
    wgmma_ss<N>(s, desc_k_major<D>(q_s, Shape<D>::kRows, q_row0, kk),
                desc_k_major<D>(k_s, N, 0, kk), kk > 0);
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
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using Sh = Shape<D>;
  using S = Smem<D>;
  constexpr int N = S::kN, kRows = Sh::kRows, kStages = Sh::kStages;
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
      mbar_init(&empty[s], Sh::kConsumerWarps);
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
  setmaxnreg_inc<Sh::kConsumerRegs>();
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
  using Sh = Shape<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<D>(&q_map, q, batch_heads, seq, Sh::kRows)) != cudaSuccess ||
      (err = make_tile_map<D>(&k_map, k, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D>(&v_map, v, batch_heads, seq, Sh::kN)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = Smem<D>::kBytes;
  static_assert(smem <= 232448, "bf16 K1 needs more shared memory than a block has");
  if ((err = allow_smem(flash_fwd_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kRows - 1) / Sh::kRows);
  flash_fwd_bf16_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, causal,
      scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

// float32 on the tensor cores in split tf32 (tf32.cuh).
//
// Consumer warpgroups own 64 query rows; per D, the count, the keys per
// tile and the ring depth are what fit the registers (S, P_hi, P_lo: N / 2
// each, O: D / 2) and the shared memory (Q, Q_lo, and per stage K, V, K_lo,
// V^T, V^T_lo).
template <int D>
struct F32Shape {
  static constexpr int kConsumers = D == 32 ? 3 : (D == 64 ? 2 : 1);
  static constexpr int kN = D == 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStages = D == 32 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;  // after setmaxnreg
};

// Shared memory: Q and Q_lo, then per stage K and V (by TMA), K_lo, V^T
// and V^T_lo (written by the consumers), each on a 1024-byte boundary,
// then the barriers; plus slack to align the base.
template <int D>
struct F32Smem {
  using Sh = F32Shape<D>;
  static constexpr size_t kBuf = align1k(tile_bytes<D, float>(Sh::kN));  // one stage buffer
  static constexpr size_t kQ = 0;
  static constexpr size_t kQlo = align1k(tile_bytes<D, float>(Sh::kRows));
  static constexpr size_t kStage0 = 2 * kQlo;
  static constexpr size_t kK = 0, kV = kBuf, kKlo = 2 * kBuf, kVt = 3 * kBuf, kVtlo = 4 * kBuf;
  static constexpr size_t kStage = 5 * kBuf;
  static constexpr size_t kBar = kStage0 + Sh::kStages * kStage;
  static constexpr size_t kBytes = kBar + (1 + 2 * Sh::kStages) * sizeof(uint64_t) + 1024;
};

// K_lo, V^T and V^T_lo of a stage, shared among the consumer threads. V^T
// is the K-major B operand of P V (rows: D, columns: keys), its keys in
// tf32::fragment_pos order, so that P's accumulator registers are its A
// fragment as they are.
template <int D>
__device__ __forceinline__ void split_stage(uint8_t* st) {
  using Sh = F32Shape<D>;
  using S = F32Smem<D>;
  constexpr int N = Sh::kN;
  const int tid = threadIdx.x - 128;
  tf32::write_lo(st + S::kKlo, st + S::kK, N * D * 4, tid, Sh::kConsumerThreads);
  tf32::write_transposed<N, D>(st + S::kVt, st + S::kVtlo, st + S::kV, tid, Sh::kConsumerThreads);
}

// S = Q_lo K^T + Q K_lo^T + Q K^T for one warpgroup's 64 query rows
// against a stage, committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk_f32(float (&s)[F32Shape<D>::kN / 2], const uint8_t* smem,
                                             int q_row0, const uint8_t* st) {
  using S = F32Smem<D>;
  constexpr int N = F32Shape<D>::kN, kRows = F32Shape<D>::kRows;
  const auto q = [&](size_t at, int kk) {
    return desc_k_major<D, float>(smem + at, kRows, q_row0, kk);
  };
  const auto k = [&](size_t at, int kk) { return desc_k_major<D, float>(st + at, N, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, q(S::kQlo, kk), k(S::kK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, q(S::kQ, kk), k(S::kKlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, q(S::kQ, kk), k(S::kK, kk), 1);
  wgmma_commit();
}

// O += P_lo V^T + P_hi V^T_lo + P_hi V^T over a stage, one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv_f32(float (&acc)[D / 2],
                                             const uint32_t (&hi)[F32Shape<D>::kN / 8][4],
                                             const uint32_t (&lo)[F32Shape<D>::kN / 8][4],
                                             const uint8_t* st) {
  using S = F32Smem<D>;
  constexpr int N = F32Shape<D>::kN;
  const auto vt = [&](size_t at, int kk) { return desc_k_major<N, float>(st + at, D, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, lo[kk], vt(S::kVt, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, hi[kk], vt(S::kVtlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, hi[kk], vt(S::kVt, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::kThreads, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                     float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using Sh = F32Shape<D>;
  using S = F32Smem<D>;
  constexpr int N = Sh::kN, kRows = Sh::kRows, kStages = Sh::kStages;
  // With three stages, tile j+1 is split while tile j's products run; with
  // two, its stage is tile j-1's, so only after that is released.
  constexpr bool kEarly = kStages >= 3;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int tiles = (kv_end + N - 1) / N;
  const int warpgroup = threadIdx.x / 128;
  const auto stage = [&](int j) { return smem + S::kStage0 + (j % kStages) * S::kStage; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], Sh::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, tile_bytes<D, float>(kRows));
      load_tile_tma<D, float>(smem + S::kQ, &q_map, q_full, kRows, q0, bh);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * tile_bytes<D, float>(N));
        load_tile_tma<D, float>(stage(j) + S::kK, &k_map, &kv_full[s], N, j * N, bh);
        load_tile_tma<D, float>(stage(j) + S::kV, &v_map, &kv_full[s], N, j * N, bh);
      }
    }
    return;
  }

  // Consumers: this warpgroup's 64 rows start at r0.
  setmaxnreg_inc<Sh::kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = q0 + (warpgroup - 1) * 64;
  const int rows[2] = {r0 + warp * 16 + lane / 4, r0 + warp * 16 + lane / 4 + 8};
  const int q_row0 = (warpgroup - 1) * 64;  // within the Q tile

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2];
  uint32_t p_hi[N / 8][4], p_lo[N / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > r0) || j * N + N > seq;
  };
  // Tile j's lo parts and V^T, made visible to wgmma; a consumer barrier
  // follows before any warpgroup reads them.
  const auto split = [&](int j) {
    mbar_wait(&kv_full[j % kStages], (j / kStages) & 1);
    split_stage<D>(stage(j));
    fence_proxy_async();
  };
  const auto consumers_sync = [&] { named_barrier_sync(1, Sh::kConsumerThreads); };

  mbar_wait(q_full, 0);
  tf32::write_lo_rows<D>(smem + S::kQlo, smem + S::kQ, kRows, q_row0, 64, threadIdx.x % 128, 128);
  split(0);
  consumers_sync();
  wgmma_fence();
  issue_qk_f32<D>(s, smem, q_row0, stage(0));
  if (tiles > 1) split(1);
  wgmma_wait<0>();
  fence_operand(s);
  softmax_tile<N>(s, m, l, corr, needs_mask(0), 0, rows, seq, causal, scale_log2);
  if (tiles > 1) consumers_sync();
  tf32::split_fragments<N>(p_hi, p_lo, s);

  for (int j = 1; j < tiles; ++j) {
    // Tile j's S and tile j-1's O += P V in flight together; tile j's
    // softmax runs while P V is still on the tensor cores.
    fence_operand(acc);
    wgmma_fence();
    issue_qk_f32<D>(s, smem, q_row0, stage(j));
    wgmma_fence();
    issue_pv_f32<D>(acc, p_hi, p_lo, stage(j - 1));
    if (kEarly && j + 1 < tiles) split(j + 1);
    wgmma_wait<1>();
    fence_operand(s);
    softmax_tile<N>(s, m, l, corr, needs_mask(j), j * N, rows, seq, causal, scale_log2);
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    if (!kEarly && j + 1 < tiles) split(j + 1);
    if (j + 1 < tiles) consumers_sync();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];
    tf32::split_fragments<N>(p_hi, p_lo, s);
  }
  fence_operand(acc);
  wgmma_fence();
  issue_pv_f32<D>(acc, p_hi, p_lo, stage(tiles - 1));
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
    float* out = o + (static_cast<int64_t>(bh) * seq + rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int batch_heads, int seq, int causal, float scale_log2,
                       cudaStream_t stream) {
  using Sh = F32Shape<D>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<D, float>(&q_map, q, batch_heads, seq, Sh::kRows)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&k_map, k, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&v_map, v, batch_heads, seq, Sh::kN)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = F32Smem<D>::kBytes;
  static_assert(smem <= 232448, "float32 K1 needs more shared memory than a block has");
  if ((err = allow_smem(flash_fwd_f32_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kRows - 1) / Sh::kRows);
  flash_fwd_f32_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(o), static_cast<float*>(lse), seq, causal,
      scale_log2);
  return cudaGetLastError();
}

// ------------------------------------------------- float32 at D = 256

// A 64-row float32 tile of head_dim 256 is 64 KiB: Q and Q_lo of 64 rows
// leave too little for a K/V ring. The block takes 32 query rows as a
// stacked tile (tf32.cuh: rows and their lo parts in one 64-row operand,
// 64 KiB), one consumer warpgroup (O takes 128 registers a thread), and
// 16-key tiles in 2 stages (K and V by TMA, K_lo, V^T and V^T_lo written
// by the consumers, 80 KiB a stage): 224 KiB. S = Q_st K^T + Q_st K_lo^T
// and O += P_st V^T + P_st V^T_lo, P_st the stacked fragments of P, give
// the four terms of each split product; each thread merges its row's hi
// and lo halves (merge_stacked) and runs the softmax on one row. The loop
// is float32 K1's: tile j's S and tile j-1's P V in flight together.
template <>
struct F32Shape<256> {
  static constexpr int D = 256;
  static constexpr int kRows = 32;   // query rows per block
  static constexpr int kN = 16;      // keys per K/V tile
  static constexpr int kStages = 2;  // K/V ring depth
  static constexpr int kThreads = 256;  // the producer and one consumer warpgroup
  static constexpr size_t kBuf = align1k(tile_bytes<D, float>(kN));
  static constexpr size_t kQ = 0, kStage0 = align1k(tile_bytes<D, float>(64));
  static constexpr size_t kK = 0, kV = kBuf, kKlo = 2 * kBuf, kVt = 3 * kBuf, kVtlo = 4 * kBuf;
  static constexpr size_t kStage = 5 * kBuf;
  static constexpr size_t kBar = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBar + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
};

// Softmax of one row's merged scores in place (sm becomes p), as
// softmax_tile does for two rows.
template <int N>
__device__ __forceinline__ void softmax_row(float (&sm)[N / 4], float& m, float& l, float& corr,
                                            bool mask, int k0, int row, int seq, int causal,
                                            float scale_log2) {
  const int t = threadIdx.x % 4;
  if (mask) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int col = k0 + (i / 2) * 8 + 2 * t + (i & 1);
      if (col >= seq || (causal && col > row)) sm[i] = -INFINITY;
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) mx = fmaxf(mx, sm[i]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx * scale_log2);
  const float shift = isfinite(m_new) ? m_new : 0.f;
  corr = isfinite(m) ? exp2_approx(m - shift) : 0.f;
  m = m_new;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    sm[i] = exp2_approx(fmaf(sm[i], scale_log2, -shift));
    sum += sm[i];
  }
  l = l * corr + sum;
}

template <>
__global__ void __launch_bounds__(F32Shape<256>::kThreads, 1)
flash_fwd_f32_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                          float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using S = F32Shape<256>;
  constexpr int D = S::D, N = S::kN, kRows = S::kRows, kStages = S::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + kRows) : seq;
  const int tiles = (kv_end + N - 1) / N;
  const int warpgroup = threadIdx.x / 128;
  const auto stage = [&](int j) { return smem + S::kStage0 + (j % kStages) * S::kStage; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, tile_bytes<D, float>(kRows));
      tf32::load_stacked_tma<D>(smem + S::kQ, &q_map, q_full, q0, bh);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * tile_bytes<D, float>(N));
        load_tile_tma<D, float>(stage(j) + S::kK, &k_map, &kv_full[s], N, j * N, bh);
        load_tile_tma<D, float>(stage(j) + S::kV, &v_map, &kv_full[s], N, j * N, bh);
      }
    }
    return;
  }

  // The consumer warpgroup: thread (warp w, lane l) owns query row
  // q0 + 8w + l/4.
  setmaxnreg_inc<240>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = q0 + 8 * warp + lane / 4;
  const int tid = threadIdx.x - 128;

  float acc[D / 2];  // stacked O: hi rows and lo rows of the thread's row
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2], sm[N / 4];
  uint32_t p[N / 8][4];
  float m = -INFINITY, l = 0.f, corr;

  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > q0) || j * N + N > seq;
  };
  // Tile j's K_lo, V^T and V^T_lo, made visible to wgmma; a consumer
  // barrier follows before any warp reads them.
  const auto split = [&](int j) {
    mbar_wait(&kv_full[j % kStages], (j / kStages) & 1);
    uint8_t* st = stage(j);
    tf32::write_lo(st + S::kKlo, st + S::kK, N * D * 4, tid, 128);
    tf32::write_transposed<N, D>(st + S::kVt, st + S::kVtlo, st + S::kV, tid, 128);
    fence_proxy_async();
  };
  const auto consumers_sync = [&] { named_barrier_sync(1, 128); };
  // S (stacked) = Q_st K^T + Q_st K_lo^T against tile j, one wgmma group.
  const auto issue_qk = [&](int j) {
    const uint8_t* st = stage(j);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_ss_tf32<N>(s, desc_k_major<D, float>(smem + S::kQ, 64, 0, kk),
                       desc_k_major<D, float>(st + S::kK, N, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_ss_tf32<N>(s, desc_k_major<D, float>(smem + S::kQ, 64, 0, kk),
                       desc_k_major<D, float>(st + S::kKlo, N, 0, kk), 1);
    }
    wgmma_commit();
  };
  // O (stacked) += P_st V^T + P_st V^T_lo over tile j, one wgmma group.
  const auto issue_pv = [&](int j) {
    const uint8_t* st = stage(j);
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      wgmma_rs_tf32<D>(acc, p[kk], desc_k_major<N, float>(st + S::kVt, D, 0, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      wgmma_rs_tf32<D>(acc, p[kk], desc_k_major<N, float>(st + S::kVtlo, D, 0, kk), 1);
    }
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  tf32::write_stacked_lo<D>(smem + S::kQ, tid, 128);
  split(0);
  consumers_sync();
  wgmma_fence();
  issue_qk(0);
  if (tiles > 1) split(1);
  wgmma_wait<0>();
  fence_operand(s);
  tf32::merge_stacked<N>(sm, s);
  softmax_row<N>(sm, m, l, corr, needs_mask(0), 0, row, seq, causal, scale_log2);
  if (tiles > 1) consumers_sync();
  tf32::stacked_fragments<N>(p, sm);

  for (int j = 1; j < tiles; ++j) {
    // Tile j's S and tile j-1's O += P V in flight together; tile j's
    // softmax runs while P V is still on the tensor cores.
    fence_operand(acc);
    wgmma_fence();
    issue_qk(j);
    wgmma_fence();
    issue_pv(j - 1);
    wgmma_wait<1>();
    fence_operand(s);
    tf32::merge_stacked<N>(sm, s);
    softmax_row<N>(sm, m, l, corr, needs_mask(j), j * N, row, seq, causal, scale_log2);
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    if (j + 1 < tiles) {  // its stage is tile j-1's, released above
      split(j + 1);
      consumers_sync();
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    tf32::stacked_fragments<N>(p, sm);
  }
  fence_operand(acc);
  wgmma_fence();
  issue_pv(tiles - 1);
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(&empty[(tiles - 1) % kStages]);

  const int t = lane % 4;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float denom = fmaxf(l, 1e-30f);
  if (row >= seq) return;
  if (t == 0) {
    const float shift = isfinite(m) ? m : 0.f;
    lse[static_cast<int64_t>(bh) * seq + row] = (shift + log2f(denom)) * kLn2;
  }
  float* out = o + (static_cast<int64_t>(bh) * seq + row) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(out + n * 8) =
        make_float2((acc[4 * n] + acc[4 * n + 2]) / denom, (acc[4 * n + 1] + acc[4 * n + 3]) / denom);
  }
}

template <>
cudaError_t launch_f32<256>(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch_heads, int seq, int causal, float scale_log2,
                            cudaStream_t stream) {
  using S = F32Shape<256>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<S::D, float>(&q_map, q, batch_heads, seq, 8)) != cudaSuccess ||
      (err = make_tile_map<S::D, float>(&k_map, k, batch_heads, seq, S::kN)) != cudaSuccess ||
      (err = make_tile_map<S::D, float>(&v_map, v, batch_heads, seq, S::kN)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = S::kBytes;
  static_assert(smem <= 232448, "float32 K1 needs more shared memory than a block has");
  if ((err = allow_smem(flash_fwd_f32_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + S::kRows - 1) / S::kRows);
  flash_fwd_f32_kernel<256><<<grid, S::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(o), static_cast<float*>(lse), seq, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------- launch

template <int D, bool kBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch_heads, int seq, int causal,
                   float scale_log2, cudaStream_t stream) {
  if constexpr (kBf16) {
    return hopper::launch<D>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
  } else {
    return hopper::launch_f32<D>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
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
    case 256:
      return launch<256, kBf16>(q, k, v, o, lse, batch_heads, seq, causal, scale_log2, stream);
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
