// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces elephas_tpu/ops/attention_pallas.py::_flash_dq_kernel (K2) and
// ::_flash_dkv_kernel (K3). With p_ij = exp(scale * q_i.k_j - lse_i)
// recomputed from the forward's float32 lse (0 where the key is masked)
// and delta_i = rowsum(dO_i * O_i) computed by the caller:
//
//   K2: dq_i = scale * sum_j ds_ij k_j
//   K3: dv_j = sum_i p_ij dO_i,   dk_j = scale * sum_i ds_ij q_i
//
// where ds_ij = p_ij (dO_i.v_j - delta_i). Sums run in float32 over tiles
// in increasing order and are cast to the input dtype at the end.
//
// Design. The TPU grid's sequential axis and its VMEM accumulators become
// a loop inside one block, as in the forward:
//
// - K2: one block per (query-row tile, batch*head). Q, dO, lse and delta
//   stay put; K/V tiles stream through shared memory up to the diagonal
//   (causal) or the end. bf16: 128 rows against 128 keys at D = 32, 192
//   against 64 at D = 64, 128 against 64 at D = 128; float32: 128 rows
//   against 64 keys at D = 32 and 32 at D = 64, 64 rows against 16 at
//   D = 128.
// - K3: one block per (key tile, batch*head): in bf16 192 keys at D = 32
//   and 128 at D = 64 and 128, against query tiles of 64 rows; in float32
//   128 keys against 64-row query tiles at D = 32, 64 keys against 32 and
//   16 rows at D = 64 and 128. K and V stay put; Q/dO tiles stream from
//   the one holding the block's first key (causal) or from the start, with
//   lse and delta staged beside them. dk and dv accumulate in float32
//   registers.
//
// Two kernels per dtype, no atomics, so the sums are deterministic and in
// the reference's order. Keys and rows at or past `seq` contribute nothing.
//
// - bfloat16 K2, built for Hopper (sm90.cuh), in bf16 K1's shape: warp 0
//   is the producer. It loads the block's Q and dO tiles once by TMA and
//   streams K and V tiles (128 keys at D = 32, 64 at D = 64 and 128)
//   through a 3-stage ring with full/empty mbarriers. Consumer warpgroups
//   own 64 query rows each, their lse (base 2) and delta in registers: two
//   at D = 32 and 128 (240 registers a thread), three at D = 64 (160), as
//   S and dP (N / 2 accumulators each), the packed dS (N / 4) and dQ
//   (D / 2) are live together. Per tile: S = Q K^T
//   and dP = dO V^T as one wgmma group with Q, dO, K and V K-major from
//   shared memory; dS = exp2(S c - lse) (dP - delta) in registers (one
//   FFMA and one MUFU.EX2 a score), masked only on the causal diagonal and
//   a ragged last tile, rounded to bf16 straight into the register
//   A-operand layout; dQ += dS K with K read MN-major through the
//   descriptor's transpose bit. Tile j's S and dP are issued with tile
//   j-1's dS K, and tile j's dS is computed while dS K is in flight. A
//   warpgroup stops at its own diagonal and releases the tiles it skips.
//   Blocks go longest first (causal).
// - bfloat16 K3, built for Hopper (sm90.cuh): warp 0 is the producer. It
//   loads the block's K and V tiles once by TMA and streams Q and dO tiles
//   through a 3-stage ring with full/empty mbarriers, its lanes storing the
//   tile's lse (base 2) and delta beside them (rows past `seq` as 0; TMA
//   fills those rows of Q and dO with zeros). Consumer warpgroups own 64
//   keys each: three at D = 32 (160 registers a thread), two at D = 64
//   and 128, where dK and dV take 64-128 accumulators a thread (240
//   registers). They overlap one another, not the exponentials with their
//   own products. Per tile: S^T = K Q^T and dP^T = V dO^T as wgmma with K
//   and V from shared memory and Q and dO K-major; P^T = exp2(S^T c - lse)
//   and dS^T = P^T (dP^T - delta) in registers, masked only on the causal
//   diagonal and a ragged last tile; then dV += P^T dO and dK += dS^T Q
//   with P^T and dS^T as bf16 register A operands and the same dO and Q
//   tiles read MN-major. Keys being the rows (wgmma's 64-row M) is what
//   puts P^T and dS^T in A-operand layout without a transpose.
// - In the bf16 kernels dS (K2, K3) and P (K3) are rounded to bf16 before
//   their products, which is where the error against the plain version
//   comes from.
// - float32 K2 and K3, in split tf32 (tf32.cuh): each product a b as
//   a_lo b + a b_lo + a b on tf32 wgmma (m64nNk8), accumulated in f32,
//   which keeps float32 accuracy. tf32 operands in shared memory are
//   K-major only, so the consumers write derived tiles beside the TMA ones
//   (lo parts, and transposed copies where a product reduces over a tile's
//   rows, that index permuted within groups of 8 so that an accumulator's
//   registers are the A fragment as they are), publish them with
//   fence.proxy.async and a named barrier over the consumer warpgroups,
//   and keep 240 registers a thread (setmaxnreg). Shared memory, f32 tiles
//   of rows x D x 4 bytes, each on a 1024-byte boundary, limit 227 KB:
//   - K2 in float32 K1's shape: Q, dO, Q_lo, dO_lo once; per stage K, V
//     (TMA), K_lo, V_lo, K^T, K^T_lo. D = 32: two warpgroups (128 rows),
//     64 keys, 3 stages: 64 + 3 x 48 = 208 KB, tile j+1 split while tile
//     j's products run. D = 64: two warpgroups, 32 keys, 2 stages: 128 +
//     2 x 48 = 224 KB. D = 128: one warpgroup, 16 keys, 2 stages: 128 + 2 x
//     48 = 224 KB. With 2 stages tile j+1 is split once tile j-1's stage is
//     free. Tile j+1's S and dP are issued with tile j's dS K, as in bf16.
//   - K3 in bf16 K3's shape: K, V, K_lo, V_lo once; a ring of Q, dO (TMA),
//     lse and delta; the six derived tiles of a query tile (Q_lo, dO_lo,
//     Q^T, Q^T_lo, dO^T, dO^T_lo) in separate buffers. D = 32: two
//     warpgroups (128 keys), 64 query rows, 3 stages of 17 KB, 2 buffers of
//     48 KB: 64 + 51 + 96 = 211 KB. D = 64: one warpgroup, 32 rows, the same
//     211 KB. D = 128: one warpgroup, 16 rows (the transposed copies of
//     64-byte rows), 2 stages, 1 buffer: 128 + 34 + 48 = 210 KB. With two
//     buffers tile i+1 is split while tile i's S^T and dP^T run; with one,
//     after tile i's products.

// Bound. Causal work is 3*B*H*S^2*D FLOPs for K2 and 4*B*H*S^2*D for K3
// (the Pallas kernels' CostEstimates) against 5*B*H*S*D*itemsize bytes, so
// at the LM's shape (8, 8, 2048, 32) both are bound by operations. In bf16
// the exponentials (one per valid score, 16 per clock per SM) are a floor
// of their own, about equal to K3's tensor-core bound at D = 32. In float32
// the split takes three tf32 products per product: 9 (K2) and 12 (K3)
// *B*H*S^2*D FLOPs at 495 TFLOP/s, against the float32 FMA bound of 3 and
// 4 *B*H*S^2*D at 67 TFLOP/s.

#include <math.h>

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16

// K2 and K3 in bf16, built for Hopper (sm90.cuh).
namespace hopper {

using namespace flash::sm90;

// ----------------------------------------------------------- bf16 K2

// Consumer warpgroups own 64 query rows each and take K/V tiles of kN
// keys. S, dP (kN / 2 f32 accumulators each), the packed dS (kN / 4) and
// dQ (D / 2) are live together. At D = 32 tiles of 128 keys with two
// warpgroups at 240 registers a thread beat 64 keys with three at 160
// (PERF.md); at D = 64 the 128-key tiles spill, so 64 keys and three
// warpgroups; at D = 128 dQ alone takes 64 registers: 64 keys and two.
template <int D>
struct DqShape {
  static constexpr int kN = D == 32 ? 128 : 64;  // keys per K/V tile
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;  // after setmaxnreg
  static constexpr int kStages = 3;  // K/V ring depth
};

// Shared memory: the Q and dO tiles, then per stage a K and a V tile (each
// on a 1024-byte boundary), then the barriers; plus slack to align the base.
template <int D>
struct DqSmem {
  using Sh = DqShape<D>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDo = align1k(tile_bytes<D>(Sh::kRows));
  static constexpr size_t kKV = align1k(tile_bytes<D>(Sh::kN));
  static constexpr size_t kStage0 = 2 * kDo;
  static constexpr size_t kStage = 2 * kKV;  // K, then V
  static constexpr size_t kBar = kStage0 + Sh::kStages * kStage;
  static constexpr size_t kBytes = kBar + (1 + 2 * Sh::kStages) * sizeof(uint64_t) + 1024;
};

// S = Q K^T and dP = dO V^T for one warpgroup's 64 query rows (from row
// q_row0 of the Q and dO tiles) against a K/V stage, committed as one
// wgmma group.
template <int D>
__device__ __forceinline__ void issue_sdp_dq(float (&s)[DqShape<D>::kN / 2],
                                             float (&dp)[DqShape<D>::kN / 2], const uint8_t* q_s,
                                             const uint8_t* do_s, int q_row0, const uint8_t* st) {
  constexpr int N = DqShape<D>::kN, kRows = DqShape<D>::kRows;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<N>(s, desc_k_major<D>(q_s, kRows, q_row0, kk), desc_k_major<D>(st, N, 0, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<N>(dp, desc_k_major<D>(do_s, kRows, q_row0, kk),
                desc_k_major<D>(st + DqSmem<D>::kKV, N, 0, kk), kk > 0);
  }
  wgmma_commit();
}

// dS = P (dP - delta) in place of S, P = exp2(S c - lse) (base 2); masked
// (P = 0) where `mask` says the tile holds keys past `seq` or above the
// causal diagonal.
template <int N>
__device__ __forceinline__ void ds_tile(float (&s)[N / 2], const float (&dp)[N / 2], bool mask,
                                        int k0, const int (&rows)[2], const float (&lse2)[2],
                                        const float (&dlt)[2], int seq, int causal,
                                        float scale_log2) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i / 2) & 1;
    float p = exp2_approx(fmaf(s[i], scale_log2, -lse2[r]));
    if (mask) {
      const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      if (col >= seq || (causal && col > rows[r])) p = 0.f;
    }
    s[i] = p * (dp[i] - dlt[r]);
  }
}

// dS (64 x N, f32 accumulator layout) rounded to bf16 A operands, 16 keys each.
template <int N>
__device__ __forceinline__ void pack_ds(uint32_t (&a)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// dQ += dS K over a stage's N keys, K read MN-major; one wgmma group.
template <int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2],
                                         const uint32_t (&a)[DqShape<D>::kN / 16][4],
                                         const uint8_t* st) {
  constexpr int N = DqShape<D>::kN;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<D>(acc, a[kk], desc_mn_major<D>(st, N, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DqShape<D>::kThreads, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq, int seq, int causal,
                     float scale_log2, float scale) {
  using Sh = DqShape<D>;
  using S = DqSmem<D>;
  constexpr int N = Sh::kN, kRows = Sh::kRows, kStages = Sh::kStages;
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
      mbar_arrive_expect_tx(q_full, 2 * tile_bytes<D>(kRows));
      load_tile_tma<D>(smem + S::kQ, &q_map, q_full, kRows, q0, bh);
      load_tile_tma<D>(smem + S::kDo, &do_map, q_full, kRows, q0, bh);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * tile_bytes<D>(N));
        load_tile_tma<D>(stage(j), &k_map, &kv_full[s], N, j * N, bh);
        load_tile_tma<D>(stage(j) + S::kKV, &v_map, &kv_full[s], N, j * N, bh);
      }
    }
    return;
  }

  // Consumers: this warpgroup's 64 rows start at r0.
  setmaxnreg_inc<Sh::kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int r0 = q0 + (warpgroup - 1) * 64;
  const int rows[2] = {r0 + warp * 16 + lane / 4, r0 + warp * 16 + lane / 4 + 8};
  const int q_row0 = (warpgroup - 1) * 64;  // within the Q and dO tiles
  float lse2[2], dlt[2];  // lse in base 2 and delta of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = static_cast<int64_t>(bh) * seq + rows[r];
    lse2[r] = rows[r] < seq ? lse[i] * kLog2e : 0.f;
    dlt[r] = rows[r] < seq ? delta[i] : 0.f;
  }
  // Causal: this warpgroup's rows see no key past its own last row, so it
  // stops there; rows wholly past `seq` need no tile.
  const int own_end = causal ? min(seq, r0 + 64) : seq;
  const int mine = r0 < seq ? (own_end + N - 1) / N : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2], dp[N / 2];
  uint32_t ds[N / 16][4];
  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > r0) || j * N + N > seq;
  };

  if (mine > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(&kv_full[0], 0);
    wgmma_fence();
    issue_sdp_dq<D>(s, dp, smem + S::kQ, smem + S::kDo, q_row0, stage(0));
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);
    ds_tile<N>(s, dp, needs_mask(0), 0, rows, lse2, dlt, seq, causal, scale_log2);
    pack_ds<N>(ds, s);
    for (int j = 1; j < mine; ++j) {
      // Tile j's S and dP and tile j-1's dQ += dS K in flight together;
      // tile j's dS is computed while dS K is still on the tensor cores.
      mbar_wait(&kv_full[j % kStages], (j / kStages) & 1);
      fence_operand(acc);
      wgmma_fence();
      issue_sdp_dq<D>(s, dp, smem + S::kQ, smem + S::kDo, q_row0, stage(j));
      wgmma_fence();
      issue_dq<D>(acc, ds, stage(j - 1));
      wgmma_wait<1>();
      fence_operand(s);
      fence_operand(dp);
      ds_tile<N>(s, dp, needs_mask(j), j * N, rows, lse2, dlt, seq, causal, scale_log2);
      wgmma_wait<0>();
      fence_operand(acc);
      if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
      pack_ds<N>(ds, s);
    }
    fence_operand(acc);
    wgmma_fence();
    issue_dq<D>(acc, ds, stage(mine - 1));
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(mine - 1) % kStages]);
  }
  // Tiles this warpgroup skips are released once they have arrived, so the
  // ring keeps turning for the others.
  for (int j = mine; j < tiles; ++j) {
    if (lane == 0) {
      mbar_wait(&kv_full[j % kStages], (j / kStages) & 1);
      mbar_arrive(&empty[j % kStages]);
    }
  }

  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    bf16* out = dq + (static_cast<int64_t>(bh) * seq + rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(scale * acc[4 * n + 2 * r], scale * acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int batch_heads, int seq,
                      int causal, float scale_log2, float scale, cudaStream_t stream) {
  using Sh = DqShape<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<D>(&q_map, q, batch_heads, seq, Sh::kRows)) != cudaSuccess ||
      (err = make_tile_map<D>(&k_map, k, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D>(&v_map, v, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D>(&do_map, dout, batch_heads, seq, Sh::kRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = DqSmem<D>::kBytes;
  if ((err = allow_smem(flash_dq_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kRows - 1) / Sh::kRows);
  flash_dq_bf16_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq), seq, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- bf16 K3

constexpr int kQRows = 64;  // query rows per streamed tile
constexpr int kStages = 3;  // Q/dO ring depth

// Consumer warpgroups own 64 keys each: three at D = 32, where their
// registers fit in 160 a thread; two (240 registers) at D = 64 and 128.
template <int D>
struct DkvShape {
  static constexpr int kConsumers = D == 32 ? 3 : 2;
  static constexpr int kKeys = 64 * kConsumers;  // keys per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;  // after setmaxnreg
};

// Shared memory: the K and V tiles, then per stage a Q tile, a dO tile
// (each on a 1024-byte boundary) and the stage's lse (base 2) and delta
// rows, then the barriers; plus slack to align the base.
template <int D>
struct DkvSmem {
  static constexpr size_t kKV = align1k(tile_bytes<D>(DkvShape<D>::kKeys));
  static constexpr size_t kQ = align1k(tile_bytes<D>(kQRows));
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kKV;
  static constexpr size_t kStage0 = 2 * kKV;
  static constexpr size_t kStage = align1k(2 * kQ + 2 * kQRows * sizeof(float));
  static constexpr size_t kDo = kQ;                // within a stage
  static constexpr size_t kLse = 2 * kQ;           // within a stage
  static constexpr size_t kDlt = kLse + kQRows * sizeof(float);
  static constexpr size_t kBar = kStage0 + kStages * kStage;
  static constexpr size_t kBytes = kBar + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
};

// S^T = K Q^T and dP^T = V dO^T for one warpgroup's 64 keys (from row
// k_row0 of the K and V tiles) against the stage's Q and dO tiles,
// committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_sdp(float (&s)[kQRows / 2], float (&dp)[kQRows / 2],
                                          const uint8_t* k_s, const uint8_t* v_s, int k_row0,
                                          const uint8_t* st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<kQRows>(s, desc_k_major<D>(k_s, DkvShape<D>::kKeys, k_row0, kk),
                     desc_k_major<D>(st, kQRows, 0, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss<kQRows>(dp, desc_k_major<D>(v_s, DkvShape<D>::kKeys, k_row0, kk),
                     desc_k_major<D>(st + DkvSmem<D>::kDo, kQRows, 0, kk), kk > 0);
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DkvShape<D>::kThreads, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int seq, int causal, float scale_log2, float scale) {
  using S = DkvSmem<D>;
  constexpr int kKeys = DkvShape<D>::kKeys;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;  // causal: the longest (first) key tiles first
  // Causal: query tiles before the one holding the block's first key see
  // none of its keys.
  const int q_begin = causal ? k0 : 0;
  const int tiles = (seq - q_begin + kQRows - 1) / kQRows;
  const int warpgroup = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const auto stage = [&](int i) { return smem + S::kStage0 + (i % kStages) * S::kStage; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: their lse/delta stores
      mbar_init(&empty[s], DkvShape<D>::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer: warp 0
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * tile_bytes<D>(kKeys));
      load_tile_tma<D>(smem + S::kK, &k_map, kv_full, kKeys, k0, bh);
      load_tile_tma<D>(smem + S::kV, &v_map, kv_full, kKeys, k0, bh);
    }
    const int64_t row_base = static_cast<int64_t>(bh) * seq;
    for (int i = 0; i < tiles; ++i) {
      const int q0 = q_begin + i * kQRows;
      uint8_t* st = stage(i);
      // This lane's lse (base 2) and delta rows, read before the stage is free.
      float lse_r[kQRows / 32], dlt_r[kQRows / 32];
#pragma unroll
      for (int c = 0; c < kQRows / 32; ++c) {
        const int r = q0 + lane + 32 * c;
        lse_r[c] = r < seq ? lse[row_base + r] * kLog2e : 0.f;
        dlt_r[c] = r < seq ? delta[row_base + r] : 0.f;
      }
      mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
#pragma unroll
      for (int c = 0; c < kQRows / 32; ++c) {
        reinterpret_cast<float*>(st + S::kLse)[lane + 32 * c] = lse_r[c];
        reinterpret_cast<float*>(st + S::kDlt)[lane + 32 * c] = dlt_r[c];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[i % kStages], 2 * tile_bytes<D>(kQRows));
        load_tile_tma<D>(st, &q_map, &full[i % kStages], kQRows, q0, bh);
        load_tile_tma<D>(st + S::kDo, &do_map, &full[i % kStages], kQRows, q0, bh);
      } else {
        mbar_arrive(&full[i % kStages]);
      }
    }
    return;
  }

  // Consumers: this warpgroup's 64 keys start at kw0.
  setmaxnreg_inc<DkvShape<D>::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, t = lane % 4;
  const int k_row0 = (warpgroup - 1) * 64;  // within the K and V tiles
  const int kw0 = k0 + k_row0;
  const int keys[2] = {kw0 + warp * 16 + lane / 4, kw0 + warp * 16 + lane / 4 + 8};

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[kQRows / 2], dp[kQRows / 2];  // S^T = K Q^T and dP^T = V dO^T
  uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];  // P^T and dS^T as bf16 A operands

  const uint8_t* k_s = smem + S::kK;
  const uint8_t* v_s = smem + S::kV;
  mbar_wait(kv_full, 0);
  for (int i = 0; i < tiles; ++i) {
    const int q0 = q_begin + i * kQRows;
    const uint8_t* st = stage(i);
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    wgmma_fence();
    issue_sdp<D>(s, dp, k_s, v_s, k_row0, st);
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);

    // P^T = exp2(S^T c - lse) and dS^T = P^T (dP^T - delta); rows are keys,
    // columns query rows. Masks only on the causal diagonal and a ragged
    // last tile.
    const bool mask = (causal && q0 < kw0 + 63) || q0 + kQRows > seq;
    const float* lse_s = reinterpret_cast<const float*>(st + S::kLse);
    const float* dlt_s = reinterpret_cast<const float*>(st + S::kDlt);
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        float p = exp2_approx(fmaf(s[e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (mask && (qi >= seq || (causal && keys[(e / 2) & 1] > qi))) p = 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - ((e & 1) ? dl.y : dl.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        dsa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
    fence_operand(dk_acc);
    fence_operand(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      wgmma_rs<D>(dv_acc, pa[kk], desc_mn_major<D>(st + S::kDo, kQRows, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      wgmma_rs<D>(dk_acc, dsa[kk], desc_mn_major<D>(st, kQRows, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dk_acc);
    fence_operand(dv_acc);
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= seq) continue;
    const int64_t off = (static_cast<int64_t>(bh) * seq + keys[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(scale * dk_acc[4 * n + 2 * r], scale * dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int batch_heads,
                       int seq, int causal, float scale_log2, float scale, cudaStream_t stream) {
  constexpr int kKeys = DkvShape<D>::kKeys;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<D>(&q_map, q, batch_heads, seq, kQRows)) != cudaSuccess ||
      (err = make_tile_map<D>(&k_map, k, batch_heads, seq, kKeys)) != cudaSuccess ||
      (err = make_tile_map<D>(&v_map, v, batch_heads, seq, kKeys)) != cudaSuccess ||
      (err = make_tile_map<D>(&do_map, dout, batch_heads, seq, kQRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = DkvSmem<D>::kBytes;
  if ((err = allow_smem(flash_dkv_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + kKeys - 1) / kKeys);
  flash_dkv_bf16_kernel<D><<<grid, DkvShape<D>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      seq, causal, scale_log2, scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- float32 K2

// float32 K2 in split tf32 (tf32.cuh), in float32 K1's shape: consumer
// warpgroups own 64 query rows each; Q and dO stay put with their lo
// parts, and K/V tiles of kN keys stream through a ring of kStages stages,
// each also holding the tile's four derived tiles (K_lo, V_lo, and the
// transposed K^T and K^T_lo that dQ += dS K reads as its K-major B
// operand), written by the consumers. With three stages tile j+1 is split
// while tile j's products run; with two, after tile j-1's stage is free.
template <int D>
struct DqF32Shape {
  static constexpr int kConsumers = D == 128 ? 1 : 2;
  static constexpr int kN = D == 32 ? 64 : (D == 64 ? 32 : 16);  // keys per K/V tile
  static constexpr int kStages = D == 32 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;            // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = 240;  // after setmaxnreg
};

// Shared memory: Q, dO, Q_lo and dO_lo, then per stage K and V (by TMA),
// K_lo, V_lo, K^T and K^T_lo, each on a 1024-byte boundary, then the
// barriers; plus slack to align the base.
template <int D>
struct DqF32Smem {
  using Sh = DqF32Shape<D>;
  static constexpr size_t kFixed = align1k(tile_bytes<D, float>(Sh::kRows));
  static constexpr size_t kQ = 0, kDo = kFixed, kQlo = 2 * kFixed, kDolo = 3 * kFixed;
  static constexpr size_t kBuf = align1k(tile_bytes<D, float>(Sh::kN));  // one stage tile
  static constexpr size_t kStage0 = 4 * kFixed;
  static constexpr size_t kK = 0, kV = kBuf, kKlo = 2 * kBuf, kVlo = 3 * kBuf;
  static constexpr size_t kKt = 4 * kBuf, kKtlo = 5 * kBuf;  // within a stage
  static constexpr size_t kStage = 6 * kBuf;
  static constexpr size_t kBar = kStage0 + Sh::kStages * kStage;
  static constexpr size_t kBytes = kBar + (1 + 2 * Sh::kStages) * sizeof(uint64_t) + 1024;
};

// S = Q K^T and dP = dO V^T, each as three tf32 products, for one
// warpgroup's 64 query rows (from row q_row0 of the Q and dO tiles)
// against stage `st`; one wgmma group.
template <int D>
__device__ __forceinline__ void issue_sdp_dq_f32(float (&s)[DqF32Shape<D>::kN / 2],
                                                 float (&dp)[DqF32Shape<D>::kN / 2],
                                                 const uint8_t* smem, int q_row0,
                                                 const uint8_t* st) {
  using S = DqF32Smem<D>;
  constexpr int N = DqF32Shape<D>::kN, kRows = DqF32Shape<D>::kRows;
  const auto a = [&](size_t at, int kk) {
    return desc_k_major<D, float>(smem + at, kRows, q_row0, kk);
  };
  const auto b = [&](size_t at, int kk) { return desc_k_major<D, float>(st + at, N, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, a(S::kQlo, kk), b(S::kK, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, a(S::kQ, kk), b(S::kKlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(s, a(S::kQ, kk), b(S::kK, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(dp, a(S::kDolo, kk), b(S::kV, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(dp, a(S::kDo, kk), b(S::kVlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<N>(dp, a(S::kDo, kk), b(S::kV, kk), 1);
  wgmma_commit();
}

// dQ += dS_lo K + dS_hi K_lo + dS_hi K over stage `st`, dS from registers
// and K read as K^T; one wgmma group.
template <int D>
__device__ __forceinline__ void issue_dq_f32(float (&acc)[D / 2],
                                             const uint32_t (&hi)[DqF32Shape<D>::kN / 8][4],
                                             const uint32_t (&lo)[DqF32Shape<D>::kN / 8][4],
                                             const uint8_t* st) {
  using S = DqF32Smem<D>;
  constexpr int N = DqF32Shape<D>::kN;
  const auto kt = [&](size_t at, int kk) { return desc_k_major<N, float>(st + at, D, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, lo[kk], kt(S::kKt, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, hi[kk], kt(S::kKtlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32<D>(acc, hi[kk], kt(S::kKt, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DqF32Shape<D>::kThreads, 1)
flash_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int seq, int causal,
                    float scale_log2, float scale) {
  using Sh = DqF32Shape<D>;
  using S = DqF32Smem<D>;
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
      mbar_arrive_expect_tx(q_full, 2 * tile_bytes<D, float>(kRows));
      load_tile_tma<D, float>(smem + S::kQ, &q_map, q_full, kRows, q0, bh);
      load_tile_tma<D, float>(smem + S::kDo, &do_map, q_full, kRows, q0, bh);
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
  const int q_row0 = (warpgroup - 1) * 64;  // within the Q and dO tiles
  float lse2[2], dlt[2];  // lse in base 2 and delta of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = static_cast<int64_t>(bh) * seq + rows[r];
    lse2[r] = rows[r] < seq ? lse[i] * kLog2e : 0.f;
    dlt[r] = rows[r] < seq ? delta[i] : 0.f;
  }
  // Every warpgroup takes every tile of the block, a tile past its own
  // diagonal masked to 0: a wgmma issued under a per-warpgroup condition
  // makes ptxas serialize all of them (C7518/C7520). So does float32 K3.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2], dp[N / 2];  // S and dP, then dS in place of S
  uint32_t ds_hi[N / 8][4], ds_lo[N / 8][4];
  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > r0) || j * N + N > seq;
  };
  // Tile j's derived tiles, made visible to wgmma; a consumer barrier
  // follows before any warpgroup reads them.
  const auto split = [&](int j) {
    mbar_wait(&kv_full[j % kStages], (j / kStages) & 1);
    uint8_t* st = stage(j);
    const int tid = threadIdx.x - 128;
    tf32::write_lo(st + S::kKlo, st + S::kK, N * D * 4, tid, Sh::kConsumerThreads);
    tf32::write_lo(st + S::kVlo, st + S::kV, N * D * 4, tid, Sh::kConsumerThreads);
    tf32::write_transposed<N, D>(st + S::kKt, st + S::kKtlo, st + S::kK, tid,
                                 Sh::kConsumerThreads);
    fence_proxy_async();
  };
  const auto consumers_sync = [&] { named_barrier_sync(1, Sh::kConsumerThreads); };

  mbar_wait(q_full, 0);
  tf32::write_lo_rows<D>(smem + S::kQlo, smem + S::kQ, kRows, q_row0, 64, threadIdx.x % 128, 128);
  tf32::write_lo_rows<D>(smem + S::kDolo, smem + S::kDo, kRows, q_row0, 64, threadIdx.x % 128,
                         128);
  split(0);
  consumers_sync();
  wgmma_fence();
  issue_sdp_dq_f32<D>(s, dp, smem, q_row0, stage(0));
  if (tiles > 1) split(1);
  wgmma_wait<0>();
  fence_operand(s);
  fence_operand(dp);
  ds_tile<N>(s, dp, needs_mask(0), 0, rows, lse2, dlt, seq, causal, scale_log2);
  if (tiles > 1) consumers_sync();
  tf32::split_fragments<N>(ds_hi, ds_lo, s);

  for (int j = 1; j < tiles; ++j) {
    // Tile j's S and dP and tile j-1's dQ += dS K in flight together; tile
    // j's dS is computed while dS K is still on the tensor cores.
    fence_operand(acc);
    wgmma_fence();
    issue_sdp_dq_f32<D>(s, dp, smem, q_row0, stage(j));
    wgmma_fence();
    issue_dq_f32<D>(acc, ds_hi, ds_lo, stage(j - 1));
    if (kEarly && j + 1 < tiles) split(j + 1);
    wgmma_wait<1>();
    fence_operand(s);
    fence_operand(dp);
    ds_tile<N>(s, dp, needs_mask(j), j * N, rows, lse2, dlt, seq, causal, scale_log2);
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    if (!kEarly && j + 1 < tiles) split(j + 1);
    if (j + 1 < tiles) consumers_sync();
    tf32::split_fragments<N>(ds_hi, ds_lo, s);
  }
  fence_operand(acc);
  wgmma_fence();
  issue_dq_f32<D>(acc, ds_hi, ds_lo, stage(tiles - 1));
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(&empty[(tiles - 1) % kStages]);

  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    float* out = dq + (static_cast<int64_t>(bh) * seq + rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(scale * acc[4 * n + 2 * r], scale * acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int batch_heads, int seq,
                          int causal, float scale_log2, float scale, cudaStream_t stream) {
  using Sh = DqF32Shape<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<D, float>(&q_map, q, batch_heads, seq, Sh::kRows)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&k_map, k, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&v_map, v, batch_heads, seq, Sh::kN)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&do_map, dout, batch_heads, seq, Sh::kRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = DqF32Smem<D>::kBytes;
  static_assert(smem <= 232448, "float32 K2 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dq_f32_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kRows - 1) / Sh::kRows);
  flash_dq_f32_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<float*>(dq), seq, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- float32 K3

// float32 K3 in split tf32 (tf32.cuh), in bf16 K3's shape: consumer
// warpgroups own 64 keys each, K and V stay put with their lo parts, and
// query tiles of kQ rows stream through a ring of kStages stages (Q and dO
// by TMA, lse and delta by the producer warp's lanes). The consumers write
// each tile's six derived tiles (Q_lo, dO_lo, and the transposed Q^T,
// Q^T_lo, dO^T, dO^T_lo that dK += dS^T Q and dV += P^T dO read as K-major
// B operands) into one of kDerived buffers: with two, tile i+1 is split
// while tile i's S^T and dP^T run; with one, after tile i's products.
template <int D>
struct DkvF32Shape {
  static constexpr int kConsumers = D == 32 ? 2 : 1;
  static constexpr int kKeys = 64 * kConsumers;                  // keys per block
  static constexpr int kQ = D == 32 ? 64 : (D == 64 ? 32 : 16);  // query rows per tile
  static constexpr int kStages = D == 128 ? 2 : 3;               // Q/dO ring depth
  static constexpr int kDerived = D == 128 ? 1 : 2;              // derived-tile buffers
  static constexpr int kThreads = 128 * (1 + kConsumers);        // and the producer warpgroup
  static constexpr int kConsumerThreads = 128 * kConsumers;
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = 240;  // after setmaxnreg
};

// Shared memory: K, V, K_lo and V_lo; the ring (per stage Q, dO, lse in
// base 2 and delta); the derived buffers (per buffer Q_lo, dO_lo, Q^T,
// Q^T_lo, dO^T, dO^T_lo), each tile on a 1024-byte boundary; then the
// barriers, plus slack to align the base.
template <int D>
struct DkvF32Smem {
  using Sh = DkvF32Shape<D>;
  static constexpr size_t kFixed = align1k(tile_bytes<D, float>(Sh::kKeys));
  static constexpr size_t kK = 0, kV = kFixed, kKlo = 2 * kFixed, kVlo = 3 * kFixed;
  static constexpr size_t kTile = align1k(tile_bytes<D, float>(Sh::kQ));
  static constexpr size_t kRing0 = 4 * kFixed;
  static constexpr size_t kDo = kTile, kLse = 2 * kTile;  // within a stage
  static constexpr size_t kDlt = kLse + Sh::kQ * sizeof(float);
  static constexpr size_t kStage = align1k(2 * kTile + 2 * Sh::kQ * sizeof(float));
  static constexpr size_t kDerived0 = kRing0 + Sh::kStages * kStage;
  static constexpr size_t kQlo = 0, kDolo = kTile, kQt = 2 * kTile, kQtlo = 3 * kTile;
  static constexpr size_t kDot = 4 * kTile, kDotlo = 5 * kTile;  // within a buffer
  static constexpr size_t kBuf = 6 * kTile;
  static constexpr size_t kBar = kDerived0 + Sh::kDerived * kBuf;
  static constexpr size_t kBytes = kBar + (1 + 2 * Sh::kStages) * sizeof(uint64_t) + 1024;
};

// S^T = K Q^T and dP^T = V dO^T, each as three tf32 products, for one
// warpgroup's 64 keys (from row k_row0 of the K and V tiles) against ring
// stage `st` and derived buffer `dr`; one wgmma group.
template <int D>
__device__ __forceinline__ void issue_sdp_f32(float (&s)[DkvF32Shape<D>::kQ / 2],
                                              float (&dp)[DkvF32Shape<D>::kQ / 2],
                                              const uint8_t* smem, int k_row0, const uint8_t* st,
                                              const uint8_t* dr) {
  using S = DkvF32Smem<D>;
  constexpr int kQ = DkvF32Shape<D>::kQ, kKeys = DkvF32Shape<D>::kKeys;
  const auto a = [&](size_t at, int kk) {
    return desc_k_major<D, float>(smem + at, kKeys, k_row0, kk);
  };
  const auto b = [&](const uint8_t* tile, int kk) { return desc_k_major<D, float>(tile, kQ, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<kQ>(s, a(S::kKlo, kk), b(st, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<kQ>(s, a(S::kK, kk), b(dr + S::kQlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<kQ>(s, a(S::kK, kk), b(st, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_ss_tf32<kQ>(dp, a(S::kVlo, kk), b(st + S::kDo, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<kQ>(dp, a(S::kV, kk), b(dr + S::kDolo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_ss_tf32<kQ>(dp, a(S::kV, kk), b(st + S::kDo, kk), 1);
  wgmma_commit();
}

// dV += P^T dO and dK += dS^T Q, each as three tf32 products, P^T and dS^T
// from registers and dO^T, Q^T from derived buffer `dr`; one wgmma group.
template <int D>
__device__ __forceinline__ void issue_dkv_f32(float (&dv)[D / 2], float (&dk)[D / 2],
                                              const uint32_t (&p_hi)[DkvF32Shape<D>::kQ / 8][4],
                                              const uint32_t (&p_lo)[DkvF32Shape<D>::kQ / 8][4],
                                              const uint32_t (&ds_hi)[DkvF32Shape<D>::kQ / 8][4],
                                              const uint32_t (&ds_lo)[DkvF32Shape<D>::kQ / 8][4],
                                              const uint8_t* dr) {
  using S = DkvF32Smem<D>;
  constexpr int kQ = DkvF32Shape<D>::kQ;
  const auto bt = [&](size_t at, int kk) { return desc_k_major<kQ, float>(dr + at, D, 0, kk); };
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dv, p_lo[kk], bt(S::kDot, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dv, p_hi[kk], bt(S::kDotlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dv, p_hi[kk], bt(S::kDot, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dk, ds_lo[kk], bt(S::kQt, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dk, ds_hi[kk], bt(S::kQtlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) wgmma_rs_tf32<D>(dk, ds_hi[kk], bt(S::kQt, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DkvF32Shape<D>::kThreads, 1)
flash_dkv_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int seq, int causal, float scale_log2, float scale) {
  using Sh = DkvF32Shape<D>;
  using S = DkvF32Smem<D>;
  constexpr int kQ = Sh::kQ, kKeys = Sh::kKeys, kStages = Sh::kStages;
  constexpr int kRowVals = (kQ + 31) / 32;  // lse/delta values per producer lane
  constexpr bool kEarly = Sh::kDerived >= 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kKeys;  // causal: the longest (first) key tiles first
  const int q_begin = causal ? k0 : 0;
  const int tiles = (seq - q_begin + kQ - 1) / kQ;
  const int warpgroup = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const auto ring = [&](int i) { return smem + S::kRing0 + (i % kStages) * S::kStage; };
  const auto derived = [&](int i) { return smem + S::kDerived0 + (i % Sh::kDerived) * S::kBuf; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: their lse/delta stores
      mbar_init(&empty[s], Sh::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup == 0) {  // producer: warp 0
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * tile_bytes<D, float>(kKeys));
      load_tile_tma<D, float>(smem + S::kK, &k_map, kv_full, kKeys, k0, bh);
      load_tile_tma<D, float>(smem + S::kV, &v_map, kv_full, kKeys, k0, bh);
    }
    const int64_t row_base = static_cast<int64_t>(bh) * seq;
    for (int i = 0; i < tiles; ++i) {
      const int q0 = q_begin + i * kQ;
      uint8_t* st = ring(i);
      // This lane's lse (base 2) and delta rows, read before the stage is free.
      float lse_r[kRowVals], dlt_r[kRowVals];
#pragma unroll
      for (int c = 0; c < kRowVals; ++c) {
        const int r = q0 + lane + 32 * c;
        lse_r[c] = r < seq ? lse[row_base + r] * kLog2e : 0.f;
        dlt_r[c] = r < seq ? delta[row_base + r] : 0.f;
      }
      mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
#pragma unroll
      for (int c = 0; c < kRowVals; ++c) {
        if (lane + 32 * c < kQ) {
          reinterpret_cast<float*>(st + S::kLse)[lane + 32 * c] = lse_r[c];
          reinterpret_cast<float*>(st + S::kDlt)[lane + 32 * c] = dlt_r[c];
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[i % kStages], 2 * tile_bytes<D, float>(kQ));
        load_tile_tma<D, float>(st, &q_map, &full[i % kStages], kQ, q0, bh);
        load_tile_tma<D, float>(st + S::kDo, &do_map, &full[i % kStages], kQ, q0, bh);
      } else {
        mbar_arrive(&full[i % kStages]);
      }
    }
    return;
  }

  // Consumers: this warpgroup's 64 keys start at kw0.
  setmaxnreg_inc<Sh::kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, t = lane % 4;
  const int k_row0 = (warpgroup - 1) * 64;  // within the K and V tiles
  const int kw0 = k0 + k_row0;
  const int keys[2] = {kw0 + warp * 16 + lane / 4, kw0 + warp * 16 + lane / 4 + 8};
  const int ctid = threadIdx.x - 128;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[kQ / 2], dp[kQ / 2];  // S^T = K Q^T and dP^T = V dO^T
  uint32_t p_hi[kQ / 8][4], p_lo[kQ / 8][4], ds_hi[kQ / 8][4], ds_lo[kQ / 8][4];

  // Tile i's derived tiles, shared among the consumers and made visible to
  // wgmma; a consumer barrier follows before any warpgroup reads them.
  const auto split = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    const uint8_t* st = ring(i);
    uint8_t* dr = derived(i);
    tf32::write_lo(dr + S::kQlo, st, kQ * D * 4, ctid, Sh::kConsumerThreads);
    tf32::write_lo(dr + S::kDolo, st + S::kDo, kQ * D * 4, ctid, Sh::kConsumerThreads);
    tf32::write_transposed<kQ, D>(dr + S::kQt, dr + S::kQtlo, st, ctid, Sh::kConsumerThreads);
    tf32::write_transposed<kQ, D>(dr + S::kDot, dr + S::kDotlo, st + S::kDo, ctid,
                                  Sh::kConsumerThreads);
    fence_proxy_async();
  };
  const auto consumers_sync = [&] { named_barrier_sync(1, Sh::kConsumerThreads); };

  mbar_wait(kv_full, 0);
  tf32::write_lo_rows<D>(smem + S::kKlo, smem + S::kK, kKeys, k_row0, 64, threadIdx.x % 128, 128);
  tf32::write_lo_rows<D>(smem + S::kVlo, smem + S::kV, kKeys, k_row0, 64, threadIdx.x % 128, 128);
  split(0);
  consumers_sync();
  for (int i = 0; i < tiles; ++i) {
    const int q0 = q_begin + i * kQ;
    const uint8_t* st = ring(i);
    const uint8_t* dr = derived(i);
    wgmma_fence();
    issue_sdp_f32<D>(s, dp, smem, k_row0, st, dr);
    if (kEarly && i + 1 < tiles) split(i + 1);
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);
    // P^T = exp2(S^T c - lse) and dS^T = P^T (dP^T - delta); rows are
    // keys, columns query rows. Masks only on the causal diagonal (which
    // includes a tile wholly before this warpgroup's keys) and a ragged
    // last tile.
    const bool mask = (causal && q0 < kw0 + 63) || q0 + kQ > seq;
    const float* lse_s = reinterpret_cast<const float*>(st + S::kLse);
    const float* dlt_s = reinterpret_cast<const float*>(st + S::kDlt);
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        float p = exp2_approx(fmaf(s[e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (mask && (qi >= seq || (causal && keys[(e / 2) & 1] > qi))) p = 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    tf32::split_fragments<kQ>(p_hi, p_lo, s);
    tf32::split_fragments<kQ>(ds_hi, ds_lo, dp);
    fence_operand(dk_acc);
    fence_operand(dv_acc);
    wgmma_fence();
    issue_dkv_f32<D>(dv_acc, dk_acc, p_hi, p_lo, ds_hi, ds_lo, dr);
    wgmma_wait<0>();
    fence_operand(dk_acc);
    fence_operand(dv_acc);
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
    if (i + 1 < tiles) {
      if (!kEarly) {  // every warpgroup is done with the one buffer
        consumers_sync();
        split(i + 1);
      }
      consumers_sync();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= seq) continue;
    const int64_t off = (static_cast<int64_t>(bh) * seq + keys[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + off + n * 8) =
          make_float2(scale * dk_acc[4 * n + 2 * r], scale * dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + n * 8) =
          make_float2(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv,
                           int batch_heads, int seq, int causal, float scale_log2, float scale,
                           cudaStream_t stream) {
  using Sh = DkvF32Shape<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<D, float>(&q_map, q, batch_heads, seq, Sh::kQ)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&k_map, k, batch_heads, seq, Sh::kKeys)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&v_map, v, batch_heads, seq, Sh::kKeys)) != cudaSuccess ||
      (err = make_tile_map<D, float>(&do_map, dout, batch_heads, seq, Sh::kQ)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = DkvF32Smem<D>::kBytes;
  static_assert(smem <= 232448, "float32 K3 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dkv_f32_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kKeys - 1) / Sh::kKeys);
  flash_dkv_f32_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      seq, causal, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk, dv
  int batch_heads, seq, causal;
  float scale_log2, scale;
  cudaStream_t stream;
};

template <int D, bool kBf16>
cudaError_t launch_dq(const Args& a) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if constexpr (kBf16) {
    return hopper::launch_dq<D>(a.q, a.k, a.v, a.dout, lse, delta, a.out0, a.batch_heads, a.seq,
                                a.causal, a.scale_log2, a.scale, a.stream);
  } else {
    return hopper::launch_dq_f32<D>(a.q, a.k, a.v, a.dout, lse, delta, a.out0, a.batch_heads,
                                    a.seq, a.causal, a.scale_log2, a.scale, a.stream);
  }
}

template <int D, bool kBf16>
cudaError_t launch_dkv(const Args& a) {
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if constexpr (kBf16) {
    return hopper::launch_dkv<D>(a.q, a.k, a.v, a.dout, lse, delta, a.out0, a.out1,
                                 a.batch_heads, a.seq, a.causal, a.scale_log2, a.scale,
                                 a.stream);
  } else {
    return hopper::launch_dkv_f32<D>(a.q, a.k, a.v, a.dout, lse, delta, a.out0, a.out1,
                                     a.batch_heads, a.seq, a.causal, a.scale_log2, a.scale,
                                     a.stream);
  }
}

template <bool kDq, bool kBf16>
cudaError_t dispatch_dim(const Args& a, int head_dim) {
  switch (head_dim) {
    case 32:
      return kDq ? launch_dq<32, kBf16>(a) : launch_dkv<32, kBf16>(a);
    case 64:
      return kDq ? launch_dq<64, kBf16>(a) : launch_dkv<64, kBf16>(a);
    case 128:
      return kDq ? launch_dq<128, kBf16>(a) : launch_dkv<128, kBf16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int head_dim, int is_bf16) {
  return static_cast<int>(is_bf16 ? dispatch_dim<kDq, true>(a, head_dim)
                                  : dispatch_dim<kDq, false>(a, head_dim));
}

}  // namespace

// q, k, v, dout, dq: (batch_heads, seq, head_dim) contiguous and 16-byte
// aligned, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); lse, delta:
// (batch_heads, seq) float32. Launches K2 on `stream` and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int batch_heads,
                            int seq, int head_dim, int is_bf16, int causal, float sm_scale,
                            void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch_heads, seq, causal,
               sm_scale * kLog2e, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim, is_bf16);
}

// As flash_bwd_dq, writing dk and dv (the layout of k and v); launches K3.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int batch_heads, int seq, int head_dim, int is_bf16, int causal,
                             float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch_heads, seq, causal,
               sm_scale * kLog2e, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim, is_bf16);
}
