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
//   against 64 at D = 64, 128 against 64 at D = 128 and 256; float32: 128
//   rows against 64 keys at D = 32 and 32 at D = 64, 64 rows against 16 at
//   D = 128, 32 (stacked, in registers) against 16 at D = 256.
// - K3: one block per (key tile, batch*head): in bf16 192 keys at D = 32
//   and 128 at D = 64 and 128, 64 at D = 256, against query tiles of 64
//   rows; in float32 128 keys against 64-row query tiles at D = 32, 64
//   keys against 32 and 16 rows at D = 64 and 128, 32 keys (stacked, in
//   registers) against 16 rows at D = 256. K and V stay put; Q/dO tiles
//   stream from the one holding the block's first key (causal) or from the
//   start, with lse and delta staged beside them. dk and dv accumulate in
//   float32 registers; float32 at D = 256 holds half of their columns a
//   block (a third grid axis picks which) and computes S^T and dP^T over
//   all 256 for it.
//
// Two kernels per dtype, no atomics, so the sums are deterministic and in
// the reference's order. Keys and rows at or past `seq` contribute nothing.
//
// - bfloat16 K2 at D <= 128, built for Hopper (sm90.cuh), in bf16 K1's
//   shape: warp 0 is the producer. It loads the block's Q and dO tiles
//   once by TMA and streams K and V tiles (128 keys at D = 32, 64 at D = 64
//   and 128) through a 3-stage ring with full/empty mbarriers. Consumer
//   warpgroups own 64 query rows each, their lse (base 2) and delta in
//   registers: two at D = 32 and 128 (240 registers a thread), three at
//   D = 64 (160), as S and dP (N / 2 accumulators each), the packed dS
//   (N / 4) and dQ (D / 2) are live together. Per tile: S = Q K^T and
//   dP = dO V^T as one wgmma group with Q, dO, K and V K-major from
//   shared memory; dS = exp2(S c - lse) (dP - delta) in registers (one
//   FFMA and one MUFU.EX2 a score), masked only on the causal diagonal and
//   a ragged last tile, rounded to bf16 straight into the register
//   A-operand layout; dQ += dS K with K read MN-major through the
//   descriptor's transpose bit. Tile j's S and dP are issued with tile
//   j-1's dS K, and tile j's dS is computed while dS K is in flight. A
//   warpgroup stops at its own diagonal and releases the tiles it skips.
//   Blocks go longest first (causal).
// - bfloat16 K3 at D <= 128, built for Hopper (sm90.cuh): warp 0 is the
//   producer. It
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
// - bfloat16 K2 and K3 at D = 256 (WideBf16, below): two warpgroups and no
//   producer. K2 takes 128 query rows a block, each warpgroup 64 of them
//   with all 256 columns of dQ, against 64-key tiles; K3 64 keys a block
//   with all 256 columns of dK and dV, warpgroup 0 computing S^T, P^T and
//   dV, warpgroup 1 dP^T, dS^T and dK, P^T crossing through shared memory.
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
//   - D = 256 (WideF32, below): a 64-row tile is 64 KiB, so the fixed
//     side is 32 rows or keys as stacked register A operands (tf32.cuh),
//     one a warpgroup (Q and dO, or K and V), against 16-row tiles in a
//     2-stage ring, the two warpgroups' S and dP (S^T and dP^T) at once,
//     202 KiB; K3 half the columns a block.

// Bound. Causal work is 3*B*H*S^2*D FLOPs for K2 and 4*B*H*S^2*D for K3
// (the Pallas kernels' CostEstimates) against 5*B*H*S*D*itemsize bytes, so
// at the LM's shape (8, 8, 2048, 32) both are bound by operations. In bf16
// the exponentials (one per valid score, 16 per clock per SM) are a floor
// of their own, about equal to K3's tensor-core bound at D = 32. In float32
// the split takes three tf32 products per product: 9 (K2) and 12 (K3)
// *B*H*S^2*D FLOPs at 495 TFLOP/s, against the float32 FMA bound of 3 and
// 4 *B*H*S^2*D at 67 TFLOP/s.

#include <math.h>

#include <type_traits>

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
// D = 256 has a kernel of its own (WideBf16, below).
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
  static_assert(smem <= 232448, "bf16 K2 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dq_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + Sh::kRows - 1) / Sh::kRows);
  flash_dq_bf16_kernel<D><<<grid, Sh::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq), seq, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

// ----------------------------------------------------------- bf16 K3

constexpr int kQRows = 64;  // query rows per streamed tile

// Consumer warpgroups own 64 keys each: three at D = 32, where their
// registers fit in 160 a thread; two (240 registers) at D = 64 and 128.
// D = 256 has a kernel of its own (WideBf16, below).
template <int D>
struct DkvShape {
  static constexpr int kConsumers = D == 32 ? 3 : 2;
  static constexpr int kKeys = 64 * kConsumers;  // keys per block
  static constexpr int kStages = 3;  // Q/dO ring depth
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;  // after setmaxnreg
};

// Shared memory: the K and V tiles, then per stage a Q tile, a dO tile
// (each on a 1024-byte boundary) and the stage's lse (base 2) and delta
// rows, then the barriers; plus slack to align the base.
template <int D>
struct DkvSmem {
  static constexpr int kStages = DkvShape<D>::kStages;
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
  constexpr int kKeys = DkvShape<D>::kKeys, kStages = S::kStages;
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
  static_assert(smem <= 232448, "bf16 K3 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dkv_bf16_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + kKeys - 1) / kKeys);
  flash_dkv_bf16_kernel<D><<<grid, DkvShape<D>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      seq, causal, scale_log2, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 K2 and K3 at D = 256
//
// 64 rows of an output at head_dim 256 take 128 f32 registers a thread in
// one warpgroup, and a 64 x 256 bf16 tile is 32 KiB. Both kernels have two
// warpgroups and no producer warpgroup (256 threads, up to 255 registers
// each, no setmaxnreg). Every streamed tile is 64 rows of K and V (K2) or
// Q and dO (K3), 64 KiB, and an SM takes such tiles in from L2 at about
// 21 bytes a clock, no faster with them multicast to a cluster: a 64 x 64
// tile's products need fewer clocks than its bytes. So a block makes each
// streamed tile serve as many output rows as its registers hold.
//
// - K2, one block per 128 query rows and head, K/V tiles of 64 keys. Each
//   warpgroup owns 64 rows: S = Q K^T and dP = dO V^T (m64n64, Q and dO
//   from the block's fixed tiles in shared memory), dS = P (dP - delta)
//   with P = exp2(S c - lse) in registers, dQ += dS K over all 256 columns
//   (128 registers): 128 rows take a K/V tile in for every 128 x 64 of
//   scores, half of what 64-row blocks take. 64-key tiles keep the
//   products m64n64 (an m64n32 product is issued no faster than one of
//   twice its width), and with no producer warpgroup shared memory holds
//   Q, dO, two K buffers and one V buffer, which dP frees first: each tile
//   issues dP, then S, and releases V once dP is done, so V's next tile
//   loads while S, the exponentials and dS K run. A warpgroup whose rows
//   end before a tile skips it (the causal diagonal) but keeps releasing
//   the ring.
// - K3, one block per 64 keys and head, all 256 columns of dK and dV, so
//   S^T and dP^T are computed once for both (4 M MACs a 64 x 64 tile;
//   half the columns a block would take 6 M). Warpgroup 0 computes S^T =
//   K Q^T and P^T = exp2(S^T c - lse), masked, and owns dV += P^T dO;
//   warpgroup 1 computes dP^T = V dO^T and owns dK += dS^T Q, dS^T = P^T
//   (dP^T - delta). P^T crosses once a tile through shared memory in f32
//   (two buffers): both accumulators have one layout, so thread i of
//   warpgroup 1 reads back exactly the positions thread i of warpgroup 0
//   wrote. K and V stay put; Q, dO and their rows' lse and delta stream
//   through a 2-stage ring that warpgroup 1 fills once a stage is
//   released, so warpgroup 0 waits on nothing but its data and the
//   exchange. Warpgroup 1 issues tile i's dK with tile i+1's dP^T.
//
// Budget (bytes of 232,448): K2 Q and dO 128 KiB + 3 x 32 KiB of K/V +
// barriers + 1 KiB alignment = 230,456; K3 64 KiB of K and V + 2 x 64 KiB
// of Q/dO + 1 KiB of lse and delta + 2 x 16 KiB of exchange + barriers +
// 1 KiB = 231,464. Registers: K2 128 (dQ) + 32 (S) + 32 (dP) + 16 (dS);
// K3 128 (dV or dK) + 32 + 16. Bound: operations, 3 (K2) and 4 (K3) *
// B*H*S^2*D bf16 FLOPs at 989 TFLOP/s (causal, halved).
struct WideBf16 {
  static constexpr int D = 256;
  static constexpr int kRows = 64;      // rows of a streamed tile; keys of a K3 block
  static constexpr int kThreads = 256;  // two warpgroups, no producer
  using L = TileLayout<D>;              // 4 column blocks of 128-byte rows
  static constexpr size_t kTile = tile_bytes<D>(kRows);
  static constexpr int kBox = L::block_bytes(kRows);  // one TMA box: a column block
  static constexpr size_t kXchg = kRows * kRows * sizeof(float);  // a warpgroup's 64 x 64 f32
  static constexpr int kXchgQuads = kRows * kRows / 4;
  // K2: Q and dO of the block's 128 rows, two K buffers, one V buffer.
  static constexpr int kDqRows = 128;
  static constexpr size_t kDqFixed = tile_bytes<D>(kDqRows);
  static constexpr size_t kDqDo = kDqFixed;
  static constexpr size_t kDqK = 2 * kDqFixed;
  static constexpr size_t kDqV = kDqK + 2 * kTile;
  static constexpr size_t kDqBar = kDqV + kTile;
  static constexpr size_t kDqBytes = kDqBar + 7 * sizeof(uint64_t) + 1024;
  // K3: K and V, a 2-stage Q/dO ring, each stage's lse (base 2) and delta,
  // two exchange buffers.
  static constexpr int kDkvStages = 2;
  static constexpr size_t kDkvStage0 = 2 * kTile;
  static constexpr size_t kDkvStage = 2 * kTile;  // Q, then dO
  static constexpr size_t kDkvRowVals = kDkvStage0 + kDkvStages * kDkvStage;
  static constexpr size_t kDkvXchg = kDkvRowVals + kDkvStages * 2 * kRows * sizeof(float);
  static constexpr size_t kDkvBar = kDkvXchg + 2 * kXchg;
  static constexpr size_t kDkvBytes = kDkvBar + (1 + 2 * kDkvStages) * sizeof(uint64_t) + 1024;
};

// The generic kernels' launch bounds name these when the D = 256 kernels
// below are declared.
template <>
struct DqShape<256> {
  static constexpr int kThreads = WideBf16::kThreads;
};
template <>
struct DkvShape<256> {
  static constexpr int kThreads = WideBf16::kThreads;
};

template <>
__global__ void __launch_bounds__(WideBf16::kThreads, 1)
flash_dq_bf16_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int seq,
                          int causal, float scale_log2, float scale) {
  using W = WideBf16;
  constexpr int D = W::D, N = W::kRows, R = W::kDqRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kDqBar);
  uint64_t* qd_full = bars;
  uint64_t* k_full = bars + 1;   // per K buffer
  uint64_t* k_empty = bars + 3;  // per K buffer
  uint64_t* v_full = bars + 5;
  uint64_t* v_empty = bars + 6;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + R) : seq;
  const int tiles = (kv_end + N - 1) / N;
  // The warpgroup, broadcast so that ptxas knows it is warp-uniform.
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4, t = lane % 4;
  uint8_t* const v_s = smem + W::kDqV;
  const auto k_buf = [&](int j) { return smem + W::kDqK + (j % 2) * W::kTile; };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&k_full[b], 4);   // warpgroup 0's warps: a column block of K each
      mbar_init(&k_empty[b], 8);  // every warp
    }
    mbar_init(v_full, 4);   // warpgroup 1's warps: a column block of V each
    mbar_init(v_empty, 8);  // every warp
    fence_barrier_init();
  }
  __syncthreads();  // clock: start

  // Warp w of warpgroup 0 (lane 0) loads column block w of K tiles, of
  // warpgroup 1 of V tiles.
  const auto load_k = [&](int j) {
    uint64_t* bar = &k_full[j % 2];
    mbar_arrive_expect_tx(bar, W::kBox);
    tma_load_3d(k_buf(j) + w * W::kBox, &k_map, bar, w * W::L::W, j * N, bh);
  };
  const auto load_v = [&](int j) {
    mbar_arrive_expect_tx(v_full, W::kBox);
    tma_load_3d(v_s + w * W::kBox, &v_map, v_full, w * W::L::W, j * N, bh);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qd_full, 2 * W::kDqFixed);
    load_tile_tma<D>(smem, &q_map, qd_full, R, q0, bh);
    load_tile_tma<D>(smem + W::kDqDo, &do_map, qd_full, R, q0, bh);
  }
  if (lane == 0) {
    if (g == 0) {
      for (int j = 0; j < min(tiles, 2); ++j) load_k(j);
    } else {
      load_v(0);
    }
  }
  __syncwarp();

  // Warpgroup g owns rows 64g .. 64g + 63 of the block; thread (warp w,
  // lane l) rows 16w + l/4 and + 8 of those, with their lse (base 2) and
  // delta. Its tiles end at its own diagonal (causal); rows wholly past
  // `seq` need none.
  const int r0 = q0 + 64 * g;
  const int rows[2] = {r0 + 16 * w + lane / 4, r0 + 16 * w + lane / 4 + 8};
  const int own_end = causal ? min(seq, r0 + 64) : seq;
  const int mine = r0 < seq ? (own_end + N - 1) / N : 0;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * seq + rows[r];
    lse2[r] = rows[r] < seq ? lse[at] * kLog2e : 0.f;
    dlt[r] = rows[r] < seq ? delta[at] : 0.f;
  }

  float acc[D / 2];        // dQ of the warpgroup's 64 rows
  float s[N / 2], dp[N / 2];  // S, then dS; dP
  uint32_t ds[N / 16][4];  // dS as bf16 A operands
  // Tile j's V is read (every warp arrives) and warpgroup 1 loads tile
  // j + 1's into the buffer once all have; likewise K, two tiles ahead, by
  // warpgroup 0.
  const auto release_v = [&](int j) {
    if (lane == 0) mbar_arrive(v_empty);
    if (g == 1 && j + 1 < tiles) {
      mbar_wait(v_empty, j & 1);
      if (lane == 0) load_v(j + 1);
    }
    __syncwarp();
  };
  const auto release_k = [&](int j) {
    if (lane == 0) mbar_arrive(&k_empty[j % 2]);
    if (g == 0 && j + 2 < tiles) {
      mbar_wait(&k_empty[j % 2], (j / 2) & 1);
      if (lane == 0) load_k(j + 2);
    }
    __syncwarp();
  };
  // dS = P (dP - delta) in place of S, P = exp2(S c - lse); `masked`: 0
  // past `seq` and above the causal diagonal.
  const auto ds_tile = [&](int n0, auto masked) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int r = (e / 2) & 1;
      float p = exp2_approx(fmaf(s[e], scale_log2, -lse2[r]));
      if constexpr (decltype(masked)::value) {
        const int col = n0 + (e / 4) * 8 + 2 * t + (e & 1);
        if (col >= seq || (causal && col > rows[r])) p = 0.f;
      }
      s[e] = p * (dp[e] - dlt[r]);
    }
  };

  mbar_wait(qd_full, 0);
  const uint8_t* q_s = smem;
  const uint8_t* do_s = smem + W::kDqDo;
  for (int j = 0; j < mine; ++j) {
    const int n0 = j * N;
    mbar_wait(&k_full[j % 2], (j / 2) & 1);
    mbar_wait(v_full, j & 1);  // clock: tma_wait
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<N>(dp, desc_k_major<D>(do_s, R, 64 * g, kk), desc_k_major<D>(v_s, N, 0, kk), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<N>(s, desc_k_major<D>(q_s, R, 64 * g, kk), desc_k_major<D>(k_buf(j), N, 0, kk),
                  kk > 0);
    }
    wgmma_commit();  // clock: issue
    wgmma_wait<1>();
    fence_operand(dp);  // clock: dp_wait
    release_v(j);  // clock: v_release
    wgmma_wait<0>();
    fence_operand(s);  // clock: s_wait
    if ((causal && n0 + N - 1 > r0) || n0 + N > seq) {
      ds_tile(n0, std::true_type{});
    } else {
      ds_tile(n0, std::false_type{});
    }  // clock: ds
    pack_ds<N>(ds, s);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_operand(ds[kk]);
    wgmma_fence();
    // dQ += dS K, K read MN-major; tile 0's first product overwrites dQ
    // (zeros set by other instructions could land inside an open wgmma
    // stage, C7515).
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_rs<D>(acc, ds[kk], desc_mn_major<D>(k_buf(j), N, kk), j > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);  // clock: dq
    release_k(j);  // clock: k_release
  }
  // Tiles this warpgroup skips are released at once, so the ring keeps
  // turning for the other.
  for (int j = mine; j < tiles; ++j) {
    release_v(j);
    release_k(j);
  }
  // clock: store

  if (mine == 0) return;
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

template <>
cudaError_t launch_dq<256>(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int batch_heads,
                           int seq, int causal, float scale_log2, float scale,
                           cudaStream_t stream) {
  using W = WideBf16;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<W::D>(&q_map, q, batch_heads, seq, W::kDqRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&k_map, k, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&v_map, v, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&do_map, dout, batch_heads, seq, W::kDqRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = W::kDqBytes;
  static_assert(smem <= 232448, "bf16 K2 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dq_bf16_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + W::kDqRows - 1) / W::kDqRows);
  flash_dq_bf16_kernel<256><<<grid, W::kThreads, smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, static_cast<bf16*>(dq), seq, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

template <>
__global__ void __launch_bounds__(WideBf16::kThreads, 1)
flash_dkv_bf16_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int causal,
                           float scale_log2, float scale) {
  using W = WideBf16;
  constexpr int D = W::D, N = W::kRows, kStages = W::kDkvStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kDkvBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * N;  // causal: the longest (first) key blocks first
  // Causal: query tiles before the one holding the block's first key see
  // none of its keys.
  const int q_begin = causal ? k0 : 0;
  const int tiles = (seq - q_begin + N - 1) / N;
  // The warpgroup, broadcast so that ptxas knows it is warp-uniform: with
  // wgmma in both branches below, a branch it takes as divergent
  // serializes every wgmma (C7520).
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int ctid = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = ctid / 32, t = lane % 4;
  const auto stage = [&](int i) { return smem + W::kDkvStage0 + (i % kStages) * W::kDkvStage; };
  // Tile i's lse (base 2), then its delta, by query row.
  const auto row_vals = [&](int i) {
    return reinterpret_cast<float*>(smem + W::kDkvRowVals) + (i % kStages) * 2 * N;
  };
  float4* xchg = reinterpret_cast<float4*>(smem + W::kDkvXchg);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);  // warpgroup 1's threads: its boxes, lse and delta
      mbar_init(&empty[s], 4);   // warpgroup 0's warps (warpgroup 1 issues the loads)
    }
    fence_barrier_init();
  }
  __syncthreads();  // clock: start

  // Thread (warp w, lane l) of either warpgroup holds keys 16w + l/4 and
  // + 8 of the block.
  const int keys[2] = {k0 + 16 * w + lane / 4, k0 + 16 * w + lane / 4 + 8};
  float acc[D / 2];        // dV (warpgroup 0) or dK (1)
  float x[N / 2];          // S^T, then P^T (0); dP^T, then dS^T (1)
  uint32_t fr[N / 16][4];  // P^T or dS^T as bf16 A operands
  // S^T = K Q^T or dP^T = V dO^T against tile i, all K-major.
  const auto issue_x = [&](int i) {
    const uint8_t* a_s = smem + g * W::kTile;    // K or V
    const uint8_t* b = stage(i) + g * W::kTile;  // Q or dO
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<N>(x, desc_k_major<D>(a_s, N, 0, kk), desc_k_major<D>(b, N, 0, kk), kk > 0);
    }
  };
  // dV += P^T dO or dK += dS^T Q, dO or Q read MN-major; tile 0's first
  // product overwrites the output (C7515).
  const auto issue_out = [&](int i) {
    const uint8_t* b = stage(i) + (1 - g) * W::kTile;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_rs<D>(acc, fr[kk], desc_mn_major<D>(b, N, kk), i > 0 || kk > 0);
    }
  };
  const auto pack = [&] {
    pack_ds<N>(fr, x);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_operand(fr[kk]);
  };

  if (g == 0) {
    // P^T = exp2(S^T c - lse); rows are keys, columns query rows;
    // `masked`: 0 past `seq` and above the causal diagonal (the diagonal
    // tiles and a ragged last tile).
    const auto softmax = [&](int q0, const float* lse_s, auto masked) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          float p = exp2_approx(fmaf(x[e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if constexpr (decltype(masked)::value) {
            const int qi = q0 + 8 * j + 2 * t + (e & 1);
            if (qi >= seq || (causal && keys[(e / 2) & 1] > qi)) p = 0.f;
          }
          x[e] = p;
        }
      }
    };
    mbar_wait(kv_full, 0);
    for (int i = 0; i < tiles; ++i) {
      const int q0 = q_begin + i * N;
      mbar_wait(&full[i % kStages], (i / kStages) & 1);  // clock: tma_wait
      wgmma_fence();
      issue_x(i);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(x);  // clock: x
      if ((causal && q0 < k0 + N - 1) || q0 + N > seq) {
        softmax(q0, row_vals(i), std::true_type{});
      } else {
        softmax(q0, row_vals(i), std::false_type{});
      }  // clock: p
      // P^T into buffer i % 2 (named barrier 1 + i % 2), once warpgroup 1
      // has read tile i - 2's from it (barrier 3 + i % 2).
      if (i >= 2) named_barrier_sync(3 + (i & 1), 256);  // clock: xchg_free
      float4* buf = xchg + (i & 1) * W::kXchgQuads;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        buf[j * 128 + ctid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      }
      named_barrier_arrive(1 + (i & 1), 256);  // clock: xchg_write
      pack();
      wgmma_fence();
      issue_out(i);
      wgmma_commit();  // clock: out_issue
      wgmma_wait<0>();
      fence_operand(acc);  // clock: out_wait
      // Release the stage where a tile follows.
      if (i + kStages < tiles && lane == 0) mbar_arrive(&empty[i % kStages]);
    }
  } else {
    // Warpgroup 1 loads the stream: for tile i, thread ctid stores the lse
    // (base 2; ctid < 64) or delta of query row ctid % 64, read a tile
    // ahead (`ahead`), and warp w's lane 0 issues boxes 2w and 2w + 1 of
    // the tile's 8 (Q's column blocks, then dO's).
    const auto ahead = [&](int i) {
      const int r = q_begin + i * N + ctid % N;
      const int64_t at = static_cast<int64_t>(bh) * seq + r;
      return r >= seq ? 0.f : (ctid < N ? lse[at] * kLog2e : delta[at]);
    };
    const auto load = [&](int i, float v) {
      uint64_t* bar = &full[i % kStages];
      row_vals(i)[ctid] = v;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar, 2 * W::kBox);
#pragma unroll
        for (int b = 2 * w; b < 2 * w + 2; ++b) {
          tma_load_3d(stage(i) + (b / 4) * W::kTile + (b % 4) * W::kBox, b < 4 ? &q_map : &do_map,
                      bar, (b % 4) * W::L::W, q_begin + i * N, bh);
        }
      } else {
        mbar_arrive(bar);
      }
    };
    if (ctid == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * W::kTile);
      load_tile_tma<D>(smem, &k_map, kv_full, N, k0, bh);
      load_tile_tma<D>(smem + W::kTile, &v_map, kv_full, N, k0, bh);
    }
    for (int i = 0; i < min(tiles, kStages); ++i) load(i, ahead(i));
    float v_next = kStages < tiles ? ahead(kStages) : 0.f;
    __syncwarp();

    mbar_wait(kv_full, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_x(0);
    wgmma_commit();
    // Tile i: dS^T, dK of tile i issued with tile i+1's dP^T (kNext; at
    // compile time, so no wgmma sits under a branch), then tile i + 2's
    // loads into this stage once warpgroup 0 has released it (its dV of
    // tile i is done; this warpgroup's dK is).
    const auto step = [&](int i, auto next) {
      constexpr bool kNext = decltype(next)::value;
      wgmma_wait<0>();  // tile i's dP^T and tile i-1's dK
      fence_operand(x);
      fence_operand(acc);  // clock: x
      named_barrier_sync(1 + (i & 1), 256);  // clock: p_wait
      // dS^T = P^T (dP^T - delta), P^T as warpgroup 0 wrote it.
      const float4* buf = xchg + (i & 1) * W::kXchgQuads;
      const float* dlt_s = row_vals(i) + N;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float4 p = buf[j * 128 + ctid];
        const float2 dl = *reinterpret_cast<const float2*>(dlt_s + 8 * j + 2 * t);
        x[4 * j] = p.x * (x[4 * j] - dl.x);
        x[4 * j + 1] = p.y * (x[4 * j + 1] - dl.y);
        x[4 * j + 2] = p.z * (x[4 * j + 2] - dl.x);
        x[4 * j + 3] = p.w * (x[4 * j + 3] - dl.y);
      }
      if (i + 2 < tiles) named_barrier_arrive(3 + (i & 1), 256);  // clock: ds
      pack();
      wgmma_fence();
      issue_out(i);
      wgmma_commit();  // clock: out_issue
      if constexpr (kNext) mbar_wait(&full[(i + 1) % kStages], ((i + 1) / kStages) & 1);  // clock: tma_wait
      wgmma_fence();
      if constexpr (kNext) issue_x(i + 1);
      wgmma_commit();  // clock: x_issue
      wgmma_wait<1>();  // clock: out_wait
      if (i + kStages < tiles) {
        mbar_wait(&empty[i % kStages], (i / kStages) & 1);
        load(i + kStages, v_next);
        v_next = i + kStages + 1 < tiles ? ahead(i + kStages + 1) : 0.f;
      }
      __syncwarp();  // clock: load
    };
    for (int i = 0; i + 1 < tiles; ++i) step(i, std::true_type{});
    step(tiles - 1, std::false_type{});
    wgmma_wait<0>();
    fence_operand(acc);
  }
  // clock: store

  const float s = g == 0 ? 1.f : scale;
  bf16* out = g == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= seq) continue;
    const int64_t off = (static_cast<int64_t>(bh) * seq + keys[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + off + n * 8) =
          __floats2bfloat162_rn(s * acc[4 * n + 2 * r], s * acc[4 * n + 2 * r + 1]);
    }
  }
}

template <>
cudaError_t launch_dkv<256>(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            int batch_heads, int seq, int causal, float scale_log2, float scale,
                            cudaStream_t stream) {
  using W = WideBf16;
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err;
  if ((err = make_tile_map<W::D>(&q_map, q, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&k_map, k, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&v_map, v, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&do_map, dout, batch_heads, seq, W::kRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = W::kDkvBytes;
  static_assert(smem <= 232448, "bf16 K3 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dkv_bf16_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + W::kRows - 1) / W::kRows);
  flash_dkv_bf16_kernel<256><<<grid, W::kThreads, smem, stream>>>(
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

// ------------------------------------------- float32 K2 and K3 at D = 256
//
// A 64-row float32 tile at head_dim 256 is 64 KiB, and 64 rows of an
// output (dQ; dK and dV) take 128 registers a thread per warpgroup. So
// both kernels hold a fixed side of 32 rows (K2: query rows; K3: keys) as
// stacked register operands (tf32.cuh) and stream tiles of 16 rows of the
// other side; K3 keeps computing half of dK's and dV's columns a block
// (blockIdx.z: all 256 would take 256 registers a thread for dK and dV
// beside the 128 of the A operand). One design with the roles swapped
// (WideF32, wide_f32), two warpgroups and no producer warpgroup:
//
// - Warpgroup 0 holds the stacked Q (K2) or K (K3), warpgroup 1 the
//   stacked dO (K2) or V (K3) as the register A operand of its products
//   (128 registers a thread), brought once by TMA into a staging area. S
//   (S^T) and dP (dP^T) run at once, one a warpgroup, each reading only a
//   32-row B tile from shared memory. (The parent read the 64-row stacked
//   operand from shared memory for every m64n16 product, 2 KiB for 8
//   clocks of tf32 work: those products were bound by shared-memory
//   reads, half of a tile's cycles.)
// - Streamed tiles come by TMA into a 2-stage ring. A stage holds two
//   paired tiles of 32 rows, K and V (K2) or Q and dO (K3): per 128-byte
//   column block the 16 rows TMA brings, then their lo parts, which the
//   warpgroup that multiplies by the tile writes. One m64n32 product a k8
//   step against the pair gives A B and A B_lo, all four terms of the
//   split with the stacked A. (With A in registers a warpgroup issues
//   about one m64nNk8 product per 33 clocks at N = 16 or 32: two
//   warpgroups' m64n16 products held the tensor cores at half their tf32
//   rate, m64n32 ones reach it.)
// - P (warpgroup 0, masked) and dP - delta (warpgroup 1), 4 values a
//   thread, cross through shared memory once a tile; each warpgroup forms
//   the stacked dS, or P^T (warpgroup 0) and dS^T (1), as the register A
//   operand of its own output: K2 warpgroup w owns dQ's columns 128w ..
//   128w + 127, K3 warpgroup 0 dV's and warpgroup 1 dK's 128 columns. Its
//   B operands are the transposed copies, hi and lo, of those columns of a
//   streamed tile (K^T; dO^T or Q^T), which the warpgroup writes itself
//   into one of two buffers.
// - Every derived tile is written and read by one warpgroup, published by
//   fence.proxy.async and a warpgroup-local named barrier; the
//   warpgroups meet once a tile, at the exchange. Every warp issues 2 of a
//   tile's 16 TMA boxes: issued by one warp, they held its warpgroup
//   about 1,200 clocks a tile.
//
// Per tile (16 streamed rows, both warpgroups, NVIDIA H100 at 1,980 MHz):
// about 1,200 clocks of S/dP products (the tensor cores near their tf32
// rate, the issuing warps held), 400 of loads, 550 of transposed copies, 250 of exponentials and
// exchange, 270 of output products, 900 of lo parts; the warpgroups run
// in step, so the tensor cores idle while both derive.
//
// Budget: shared memory 2 stages x 64 KiB + 1 KiB (K3's lse and delta) +
// 2 x 32 KiB of transposed copies (the A staging area first) + 8 KiB of
// exchange + barriers = 206,888 of 232,448 bytes; 256 threads, so 255
// registers a thread with no setmaxnreg (A 128, output 64, S or dP 16,
// dS 8): with a producer warpgroup the consumers' 240 made ptxas
// serialize the m64n32 products (C7512). Bound: operations, 9 (K2) and 12
// (K3) * B*H*S^2*D split-tf32 FLOPs at 495 TFLOP/s (causal, halved); the
// stacked operand takes 4 tf32 products per split product where 3 would
// do, and K3's halves compute S^T and dP^T twice (1.5x its products).
struct WideF32 {
  static constexpr int D = 256;
  static constexpr int kFixed = 32;  // rows of the fixed side a block
  static constexpr int kTile = 16;   // rows of a streamed tile
  static constexpr int kCols = 128;  // output columns a consumer warpgroup
  static constexpr int kStages = 2;
  static constexpr int kThreads = 256;  // two warpgroups, no producer
  using L = TileLayout<D, float>;       // 8 column blocks of 128-byte rows
  using T = TileLayout<kTile, float>;   // transposed copies: 64-byte rows
  static constexpr int kPairBlock = L::block_bytes(2 * kTile);  // a column block of a paired tile
  static constexpr size_t kPair = tile_bytes<D, float>(2 * kTile);
  static constexpr size_t kStage = 2 * kPair;
  static constexpr size_t kRowVals = kStages * kStage;  // K3: per stage lse (base 2), delta
  static constexpr size_t kCopy = T::block_bytes(kCols);  // one transposed copy
  static constexpr size_t kCopyBuf = 4 * kCopy;  // per warpgroup hi, lo
  static constexpr size_t kCopies = kRowVals + 1024;
  static constexpr size_t kXchg = kCopies + 2 * kCopyBuf;  // per parity and warpgroup 128 float4
  static constexpr size_t kBar = kXchg + 2 * 2 * 128 * sizeof(float4);
  static constexpr size_t kBytes = kBar + (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
  static_assert(2 * tile_bytes<D, float>(kFixed) <= 2 * kCopyBuf, "A staging exceeds the copies");
};

// The generic kernels' launch bounds name these when the D = 256 kernels
// below are declared.
template <>
struct DqF32Shape<256> {
  static constexpr int kThreads = WideF32::kThreads;
};
template <>
struct DkvF32Shape<256> {
  static constexpr int kThreads = WideF32::kThreads;
};

// Rows 0-15 of the paired tile `pair`, columns c0 .. c0 + 127, transposed
// into the K-major B operand of a product over those rows: 128 rows of 16
// (TileLayout<16, float>), column fragment_pos(r) holding row r; values
// into `hi`, their lo parts into `lo_t`; by one warpgroup. Thread ctid
// writes row ctid as four 16-byte chunks, chunk p (positions 4p .. 4p+3)
// gathered from rows 8(p/2) + p%2 + 2j of source column c0 + ctid: a
// warp's loads read one row's 32 banks, its stores are conflict-free.
__device__ __forceinline__ void write_pair_transposed(uint8_t* hi, uint8_t* lo_t,
                                                      const uint8_t* pair, int c0, int ctid) {
  using W = WideF32;
  const int sc = c0 + ctid;
  const uint8_t* src = pair + (sc / W::L::W) * W::kPairBlock;
  const int cb = (sc % W::L::W) * 4;  // byte column within a 128-byte row
  const int row = ctid * W::T::kSwizzle;
  const int swz = ((ctid >> 1) & 3) << 4;  // TileLayout<16, float>::offset's XOR for row ctid
#pragma unroll 2
  for (int p = 0; p < 4; ++p) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * (p >> 1) + (p & 1) + 2 * j;
      v[j] = *reinterpret_cast<const float*>(src + r * W::L::kSwizzle + (cb ^ ((r & 7) << 4)));
    }
    const int off = row + ((16 * p) ^ swz);
    *reinterpret_cast<float4*>(hi + off) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(lo_t + off) =
        make_float4(tf32::lo(v[0]), tf32::lo(v[1]), tf32::lo(v[2]), tf32::lo(v[3]));
  }
}

// K2 (kDkv false): fixed = Q, dO (32 query rows), streamed = K, V; out0 =
// dQ. K3 (kDkv true): fixed = K, V (32 keys), streamed = Q, dO with their
// lse and delta; out0 = dK, out1 = dV, columns 128 * blockIdx.z on.
template <bool kDkv>
__device__ __forceinline__ void wide_f32(const CUtensorMap* fixed0, const CUtensorMap* fixed1,
                                         const CUtensorMap* stream0, const CUtensorMap* stream1,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ out0,
                                         float* __restrict__ out1, int seq, int causal,
                                         float scale_log2, float scale) {
  using W = WideF32;
  constexpr int D = W::D, kTile = W::kTile, kStages = W::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* a_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  // K2: query rows longest first, key tiles up to the diagonal (causal);
  // K3: keys (the first the longest), query tiles from the diagonal.
  const int f0 = (kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * W::kFixed;
  const int n_begin = kDkv && causal ? f0 : 0;
  const int n_end = !kDkv && causal ? min(seq, f0 + W::kFixed) : seq;
  const int tiles = (n_end - n_begin + kTile - 1) / kTile;
  const int warpgroup = threadIdx.x / 128, lane = threadIdx.x % 32;
  const auto stage = [&](int i) { return smem + (i % kStages) * W::kStage; };
  const auto row_vals = [&](int i) {
    return reinterpret_cast<float*>(smem + W::kRowVals) + (i % kStages) * 2 * kTile;
  };

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 8);  // every warp's share of the tile's loads
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Every warp's lane 0 loads a share of each streamed tile: warp w (of
  // 8) two of its 16 TMA boxes and, K3, the lse (base 2) and delta of the
  // tile's rows 2w and 2w + 1,
  // read a tile ahead (`ahead`). Tile i goes to stage i % 2 once every
  // warp has released it. Warp 0 first loads the fixed tiles.
  const int warp8 = threadIdx.x / 32;
  const int64_t row_base = static_cast<int64_t>(bh) * seq;
  // (lse, lse, delta, delta) of rows 2w, 2w + 1, as read: scaled where
  // they are stored, so the warp does not wait here for the loads.
  const auto ahead = [&](int i) {
    const int n = n_begin + i * kTile + 2 * warp8;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kDkv && n < seq) v.x = lse[row_base + n], v.z = delta[row_base + n];
    if (kDkv && n + 1 < seq) v.y = lse[row_base + n + 1], v.w = delta[row_base + n + 1];
    return v;
  };
  const auto load = [&](int i, float4 rv) {  // lane 0
    const int s = i % kStages, n0 = n_begin + i * kTile;
    if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    if (kDkv) {
      float* v = row_vals(i) + 2 * warp8;
      v[0] = rv.x * kLog2e, v[1] = rv.y * kLog2e, v[kTile] = rv.z, v[kTile + 1] = rv.w;
    }
    mbar_arrive_expect_tx(&full[s], 2 * W::L::block_bytes(kTile));
#pragma unroll
    for (int b = 2 * warp8; b < 2 * warp8 + 2; ++b) {
      const int c = b % W::L::kBlocks, second = b / W::L::kBlocks;
      tma_load_3d(stage(i) + second * W::kPair + c * W::kPairBlock, second ? stream1 : stream0,
                  &full[s], c * W::L::W, n0, bh);
    }
  };
  if (lane == 0) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(a_full, 2 * tile_bytes<D, float>(W::kFixed));
      load_tile_tma<D, float>(smem + W::kCopies, fixed0, a_full, W::kFixed, f0, bh);
      load_tile_tma<D, float>(smem + W::kCopies + W::kCopyBuf, fixed1, a_full, W::kFixed, f0, bh);
    }
    for (int i = 0; i < min(tiles, kStages); ++i) load(i, ahead(i));
  }

  // Warpgroup g; thread (warp w, lane l) owns fixed row f0 + 8w + l/4.
  const int g = warpgroup, ctid = threadIdx.x % 128, t = lane % 4;
  const int r = 8 * (ctid / 32) + lane / 4;
  const int f = f0 + r;
  const int64_t frow = static_cast<int64_t>(bh) * seq + f;
  const int c0 = kDkv ? blockIdx.z * W::kCols : g * W::kCols;  // this warpgroup's output columns
  const int tsrc = kDkv ? 1 - g : 0;  // the paired tile its output reads transposed
  float lse2 = 0.f, dlt = 0.f;        // K2: this row's lse (base 2) and delta
  if (!kDkv && f < seq) {
    lse2 = lse[frow] * kLog2e;
    dlt = delta[frow];
  }

  uint32_t a[D / 8][4];  // stacked Q, dO (K2) or K, V (K3)
  mbar_wait(a_full, 0);
  tf32::load_stacked_a(a, smem + W::kCopies + g * W::kCopyBuf, r, t);
  named_barrier_sync(3, 256);  // both are read before the copies overwrite them

  // Stacked output: dQ, or dV (g = 0) / dK (g = 1). Tile 0's first product
  // overwrites it: zeros set by other instructions could land inside an
  // open wgmma stage, and ptxas then serializes every wgmma (C7515).
  float acc[W::kCols / 2];
  float x[kTile], m[kTile / 4];  // S or dP (S^T or dP^T) against B and B_lo, then merged
  uint32_t fr[kTile / 8][4];         // stacked dS (P^T, dS^T)
  float4* xchg = reinterpret_cast<float4*>(smem + W::kXchg);
  const auto copies = [&](int i) { return smem + W::kCopies + (i % 2) * W::kCopyBuf + g * 2 * W::kCopy; };
  const auto wg_sync = [&] { named_barrier_sync(1 + g, 128); };
  const auto derive_lo = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    tf32::write_pair_lo(stage(i) + g * W::kPair, ctid);
  };
  const auto derive_t = [&](int i) {
    write_pair_transposed(copies(i), copies(i) + W::kCopy, stage(i) + tsrc * W::kPair, c0, ctid);
  };
  // A [B; B_lo]^T over D: one m64n32 product a k8 step against the
  // paired tile.
  const auto issue_x = [&](int i) {
    const uint8_t* p = stage(i) + g * W::kPair;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_rs_tf32<2 * kTile>(x, a[kk], desc_k_major<D, float>(p, 2 * kTile, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  // acc += A_st C^T + A_st C^T_lo over the tile's rows (tile 0: acc =).
  // No fence_operand on acc here: inside the open stage of tile i+1's
  // product it would count as a definition of an accumulator (C7515).
  const auto issue_out = [&](int i) {
    const uint8_t* cp = copies(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      wgmma_rs_tf32<W::kCols>(acc, fr[kk], desc_k_major<kTile, float>(cp, W::kCols, 0, kk),
                              i > 0 || kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      wgmma_rs_tf32<W::kCols>(acc, fr[kk], desc_k_major<kTile, float>(cp + W::kCopy, W::kCols, 0, kk),
                              1);
    }
    wgmma_commit();
  };

  derive_lo(0);
  derive_t(0);
  fence_proxy_async();
  wg_sync();
  issue_x(0);
  if (tiles > 1) {
    derive_lo(1);
    derive_t(1);
    fence_proxy_async();
    wg_sync();
  }
  float4 rv_next = lane == 0 && 2 < tiles ? ahead(2) : float4{};
  for (int i = 0; i < tiles; ++i) {
    const int n0 = n_begin + i * kTile;
    wgmma_wait<0>();  // tile i's product and tile i-1's output product
    fence_operand(x);
    fence_operand(acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // columns 8j + 2t + c against B (x[4j ..]) and B_lo (x[4j + 8 ..])
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        m[2 * j + c] = (x[4 * j + c] + x[4 * j + 2 + c]) + (x[4 * j + 8 + c] + x[4 * j + 10 + c]);
      }
    }
    float rv[4];  // K3: lse (g = 0) or delta (g = 1) of this thread's columns
    if (kDkv) {
      const float* v = row_vals(i) + g * kTile;
      const float2 lo = *reinterpret_cast<const float2*>(v + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(v + 8 + 2 * t);
      rv[0] = lo.x, rv[1] = lo.y, rv[2] = hi.x, rv[3] = hi.y;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % kStages]);  // the stage is read
    if (i + 1 < tiles) issue_x(i + 1);
    // Tile i+2 into the stage every warp released above.
    if (lane == 0) {
      if (i + 2 < tiles) load(i + 2, rv_next);
      if (kDkv && i + 3 < tiles) rv_next = ahead(i + 3);
    }
    if (i >= 1 && i + 1 < tiles) {  // its buffer's last reader, tile i-1's output, is done
      derive_t(i + 1);
      fence_proxy_async();
      wg_sync();
    }

    // Warpgroup 0: P = exp2(S c - lse) (P^T), 0 past `seq` and above the
    // causal diagonal; warpgroup 1: dP - delta (dP^T - delta).
    const bool mask = (causal && (kDkv ? n0 < f0 + W::kFixed - 1 : n0 + kTile - 1 > f0)) ||
                      n0 + kTile > seq;
    float mine[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (g == 0) {
        float p = exp2_approx(fmaf(m[e], scale_log2, -(kDkv ? rv[e] : lse2)));
        const int n = n0 + (e / 2) * 8 + 2 * t + (e & 1);
        if (mask && (n >= seq || (causal && (kDkv ? f > n : n > f)))) p = 0.f;
        mine[e] = p;
      } else {
        mine[e] = m[e] - (kDkv ? rv[e] : dlt);
      }
    }
    xchg[((i % 2) * 2 + g) * 128 + ctid] = make_float4(mine[0], mine[1], mine[2], mine[3]);
    named_barrier_sync(3, 256);
    const float4 o = xchg[((i % 2) * 2 + 1 - g) * 128 + ctid];
    // dS = P (dP - delta) in both (K2); K3: P^T for dV (g = 0), dS^T for dK.
    const bool own = kDkv && g == 0;
    m[0] = own ? mine[0] : mine[0] * o.x;
    m[1] = own ? mine[1] : mine[1] * o.y;
    m[2] = own ? mine[2] : mine[2] * o.z;
    m[3] = own ? mine[3] : mine[3] * o.w;
    tf32::stacked_fragments<kTile>(fr, m);
    issue_out(i);
    if (i + 2 < tiles) {  // its stage was released by both warpgroups above
      derive_lo(i + 2);
      fence_proxy_async();
      wg_sync();
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);

  if (f >= seq) return;
  const float s = kDkv && g == 0 ? 1.f : scale;
  float* out = (kDkv && g == 0 ? out1 : out0) + frow * D + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < W::kCols / 8; ++n) {
    *reinterpret_cast<float2*>(out + n * 8) =
        make_float2(s * (acc[4 * n] + acc[4 * n + 2]), s * (acc[4 * n + 1] + acc[4 * n + 3]));
  }
}

template <>
__global__ void __launch_bounds__(WideF32::kThreads, 1)
flash_dq_f32_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int seq,
                         int causal, float scale_log2, float scale) {
  wide_f32<false>(&q_map, &do_map, &k_map, &v_map, lse, delta, dq, nullptr, seq, causal,
                  scale_log2, scale);
}

template <>
__global__ void __launch_bounds__(WideF32::kThreads, 1)
flash_dkv_f32_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int seq, int causal,
                          float scale_log2, float scale) {
  wide_f32<true>(&k_map, &v_map, &q_map, &do_map, lse, delta, dk, dv, seq, causal, scale_log2,
                 scale);
}

// Tensor maps of the fixed side (boxes of 32 rows) and the streamed side
// (16), shared by both launches.
inline cudaError_t wide_maps(CUtensorMap (&maps)[4], const void* fixed0, const void* fixed1,
                             const void* stream0, const void* stream1, int batch_heads, int seq) {
  using W = WideF32;
  const void* ptrs[4] = {fixed0, fixed1, stream0, stream1};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        make_tile_map<W::D, float>(&maps[i], ptrs[i], batch_heads, seq, i < 2 ? W::kFixed : W::kTile);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <>
cudaError_t launch_dq_f32<256>(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, int batch_heads,
                               int seq, int causal, float scale_log2, float scale,
                               cudaStream_t stream) {
  using W = WideF32;
  CUtensorMap maps[4];  // q, dout, k, v
  cudaError_t err;
  if ((err = wide_maps(maps, q, dout, k, v, batch_heads, seq)) != cudaSuccess) return err;
  constexpr size_t smem = W::kBytes;
  static_assert(smem <= 232448, "float32 K2 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dq_f32_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + W::kFixed - 1) / W::kFixed);
  flash_dq_f32_kernel<256><<<grid, W::kThreads, smem, stream>>>(
      maps[0], maps[2], maps[3], maps[1], lse, delta, static_cast<float*>(dq), seq, causal,
      scale_log2, scale);
  return cudaGetLastError();
}

template <>
cudaError_t launch_dkv_f32<256>(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dk, void* dv,
                                int batch_heads, int seq, int causal, float scale_log2,
                                float scale, cudaStream_t stream) {
  using W = WideF32;
  CUtensorMap maps[4];  // k, v, q, dout
  cudaError_t err;
  if ((err = wide_maps(maps, k, v, q, dout, batch_heads, seq)) != cudaSuccess) return err;
  constexpr size_t smem = W::kBytes;
  static_assert(smem <= 232448, "float32 K3 needs more shared memory than a block has");
  if ((err = allow_smem(flash_dkv_f32_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + W::kFixed - 1) / W::kFixed, W::D / W::kCols);
  flash_dkv_f32_kernel<256><<<grid, W::kThreads, smem, stream>>>(
      maps[2], maps[0], maps[1], maps[3], lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), seq, causal, scale_log2, scale);
  return cudaGetLastError();
}

// ------------------------------------------- K2 and K3 above D = 256
//
// head_dim = 256 n, n >= 2 (sm90.cuh, "above D = 256"), in both dtypes
// one design with the roles swapped, as at D = 256:
// - K2: a block takes fixed query rows (longest first) and owns chunk c =
//   blockIdx.z of dQ; K/V tiles stream up to the diagonal (causal). Per
//   tile S = Q K^T and dP = dO V^T stream over all n chunks, dS = P (dP -
//   delta) with P = exp2(S c - lse), and dQ_c += dS K_c.
// - K3: a block takes fixed keys and owns, by blockIdx.z = 2 c + b, chunk
//   c of dV (b = 0: dV_c += P^T dO_c, no dP^T) or of dK (b = 1: dK_c +=
//   dS^T Q_c, dS^T = P^T (dP^T - delta)); Q/dO tiles stream from the
//   diagonal (causal), their rows' lse and delta beside the out slot.
// S (S^T) is recomputed by every block of a row (key) tile, dP (dP^T) by
// each dQ (dK) block: the work is (2 n + 1) / 3 of K2's CostEstimate and
// (3 n + 2) / 4 of K3's (a dV block computes no dP^T). bf16 rounds dS
// (K2, K3) and P^T (dV) to bf16 before the output product, as at D <=
// 256.

// K2 (kDkv false): fixed = Q, dO; streamed = K, V; out0 = dQ. K3 (kDkv
// true): fixed = K, V; streamed = Q, dO; out0 = dK, out1 = dV.
template <bool kDkv>
__device__ __forceinline__ void wide_bwd_bf16(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                              const CUtensorMap* v_map, const CUtensorMap* do_map,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              bf16* __restrict__ out0, bf16* __restrict__ out1,
                                              int seq, int head_dim, int causal, float scale_log2,
                                              float scale) {
  using W = WideChunkBf16;
  constexpr int N = W::kRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  const WideBars<W> bars(smem);
  const int bh = blockIdx.x, n = head_dim / 256;
  const int c = kDkv ? blockIdx.z / 2 : blockIdx.z;
  const bool dk = kDkv && blockIdx.z % 2 == 1;  // a K3 block of dK
  const bool dv = kDkv && !dk;
  // K2: query rows longest first, key tiles up to the diagonal (causal);
  // K3: keys (the first the longest), query tiles from the diagonal.
  const int f0 = (kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * N;
  const int n_begin = kDkv && causal ? f0 : 0;
  const int n_end = !kDkv && causal ? min(seq, f0 + N) : seq;
  const int tiles = (n_end - n_begin + N - 1) / N;
  const int slices1 = dv ? 0 : n;  // dP's slices (dP^T's)
  // The warpgroup, broadcast so that ptxas knows it is warp-uniform.
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warpgroup == 0) {
    if (threadIdx.x < 32) {
      wide_produce<W>(smem, bars.full, bars.empty, bars.out_full, bars.out_empty,
                      kDkv ? k_map : q_map, kDkv ? q_map : k_map, kDkv ? v_map : do_map,
                      kDkv ? do_map : v_map, slices1, kDkv ? (dk ? q_map : do_map) : k_map,
                      kDkv ? lse : nullptr, kDkv ? delta : nullptr, n, c, f0, n_begin, tiles, bh,
                      seq);
    }
    return;
  }

  // Thread (warp w, lane l) holds fixed rows f0 + 16w + l/4 and + 8.
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4, t = lane % 4;
  const int rows[2] = {f0 + 16 * w + lane / 4, f0 + 16 * w + lane / 4 + 8};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // K2: its rows' lse (base 2) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * seq + rows[r];
    if (!kDkv && rows[r] < seq) lse2[r] = lse[at] * kLog2e, dlt[r] = delta[at];
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s[N / 2], dp[N / 2];  // S (S^T), then dS (P^T or dS^T); dP (dP^T)
  uint32_t fr[N / 16][4];
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    const int n0 = n_begin + j * N;
    wide_reduce_bf16(s, smem, bars.full, bars.empty, it, n);
    wide_reduce_bf16(dp, smem, bars.full, bars.empty, it, slices1);
    mbar_wait(bars.out_full, j & 1);
    if constexpr (!kDkv) {
      ds_tile<N>(s, dp, (causal && n0 + N - 1 > f0) || n0 + N > seq, n0, rows, lse2, dlt, seq,
                 causal, scale_log2);
    } else {
      // P^T = exp2(S^T c - lse), rows keys, columns query rows, 0 past
      // `seq` and above the causal diagonal; dS^T = P^T (dP^T - delta).
      const bool mask = (causal && n0 < f0 + N - 1) || n0 + N > seq;
      const float* lse_s = reinterpret_cast<const float*>(smem + W::kRowVals);
      const float* dlt_s = lse_s + N;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(dlt_s + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 4 * jj; e < 4 * jj + 4; ++e) {
          const int qi = n0 + 8 * jj + 2 * t + (e & 1);
          float p = exp2_approx(fmaf(s[e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (mask && (qi >= seq || (causal && rows[(e / 2) & 1] > qi))) p = 0.f;
          s[e] = dk ? p * (dp[e] - ((e & 1) ? dl.y : dl.x)) : p;
        }
      }
    }
    pack_ds<N>(fr, s);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_operand(fr[kk]);
    // dQ_c += dS K_c, dV_c += P^T dO_c or dK_c += dS^T Q_c: the out slot's
    // tile read MN-major.
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_rs<256>(acc, fr[kk], desc_mn_major<256>(smem + W::kOut, N, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(bars.out_empty);
  }

  const float sc = dv ? 1.f : scale;
  bf16* out = dv ? out1 : out0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    bf16* o = out + (static_cast<int64_t>(bh) * seq + rows[r]) * head_dim + 256 * c + 2 * t;
#pragma unroll
    for (int nn = 0; nn < 32; ++nn) {
      *reinterpret_cast<__nv_bfloat162*>(o + nn * 8) =
          __floats2bfloat162_rn(sc * acc[4 * nn + 2 * r], sc * acc[4 * nn + 2 * r + 1]);
    }
  }
}

// float32 (split tf32): 32 fixed rows (stacked) against 32-row tiles.
// Thread (warp w, lane l) owns fixed row f0 + 8w + l/4 and streamed rows
// 8j + 2t + c of a tile (t = l % 4); the output is a stacked m64n256
// accumulator, each row's hi and lo parts added at the end.
template <bool kDkv>
__device__ __forceinline__ void wide_bwd_f32(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                             const CUtensorMap* v_map, const CUtensorMap* do_map,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ out0, float* __restrict__ out1,
                                             int seq, int head_dim, int causal, float scale_log2,
                                             float scale) {
  using W = WideChunkF32;
  constexpr int N = W::kRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  const WideBars<W> bars(smem);
  const int bh = blockIdx.x, n = head_dim / 256;
  const int c = kDkv ? blockIdx.z / 2 : blockIdx.z;
  const bool dk = kDkv && blockIdx.z % 2 == 1;
  const bool dv = kDkv && !dk;
  const int f0 = (kDkv ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * N;
  const int n_begin = kDkv && causal ? f0 : 0;
  const int n_end = !kDkv && causal ? min(seq, f0 + N) : seq;
  const int tiles = (n_end - n_begin + N - 1) / N;
  const int slices = n * (256 / W::kSlice);
  const int slices1 = dv ? 0 : slices;
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warpgroup == 0) {
    if (threadIdx.x < 32) {
      wide_produce<W>(smem, bars.full, bars.empty, bars.out_full, bars.out_empty,
                      kDkv ? k_map : q_map, kDkv ? q_map : k_map, kDkv ? v_map : do_map,
                      kDkv ? do_map : v_map, slices1, kDkv ? (dk ? q_map : do_map) : k_map,
                      kDkv ? lse : nullptr, kDkv ? delta : nullptr, n, c, f0, n_begin, tiles, bh,
                      seq);
    }
    return;
  }

  const int ctid = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4;
  const int r = 8 * (ctid / 32) + lane / 4, f = f0 + r;
  const int64_t frow = static_cast<int64_t>(bh) * seq + f;
  float lse2 = 0.f, dlt = 0.f;  // K2: this row's lse (base 2) and delta
  if (!kDkv && f < seq) lse2 = lse[frow] * kLog2e, dlt = delta[frow];
  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  float x[N];           // a stacked product against a pair
  float s0[8], s1[8];   // S (S^T), then dS (P^T or dS^T); dP (dP^T)
  uint32_t fr[4][4];
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    const int n0 = n_begin + j * N;
    tf32::wide_reduce_f32(x, smem, bars.full, bars.empty, it, slices, r, t, ctid);
    tf32::merge_stacked(s0, x);
    tf32::wide_reduce_f32(x, smem, bars.full, bars.empty, it, slices1, r, t, ctid);
    tf32::merge_stacked(s1, x);
    mbar_wait(bars.out_full, j & 1);
    // P = exp2(S c - lse) (P^T), 0 past `seq` and above the causal
    // diagonal; dS = P (dP - delta) (dS^T), or P^T for dV.
    const bool mask = (causal && (kDkv ? n0 < f0 + N - 1 : n0 + N - 1 > f0)) || n0 + N > seq;
    const float* rv = reinterpret_cast<const float*>(smem + W::kRowVals);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = 8 * (e / 2) + 2 * t + (e & 1), col = n0 + idx;
      float p = exp2_approx(fmaf(s0[e], scale_log2, -(kDkv ? rv[idx] : lse2)));
      if (mask && (col >= seq || (causal && (kDkv ? f > col : col > f)))) p = 0.f;
      s0[e] = dv ? p : p * (s1[e] - (kDkv ? rv[N + idx] : dlt));
    }
    tf32::stacked_fragments<N>(fr, s0);
    // The out slot's tile transposed (C^T, C^T_lo) for dQ_c += dS K_c,
    // dV_c += P^T dO_c or dK_c += dS^T Q_c.
    tf32::write_transposed<N, 256>(smem + W::kCopy, smem + W::kCopy + W::kCopyBytes,
                                   smem + W::kOut, ctid, 128);
    fence_proxy_async();
    named_barrier_sync(1, 128);
    if (lane == 0) mbar_arrive(bars.out_empty);
    fence_operand(acc[0]);
    fence_operand(acc[1]);
    tf32::wide_out_f32(acc, fr, smem + W::kCopy, smem + W::kCopy + W::kCopyBytes);
    wgmma_wait<0>();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
  }

  if (f >= seq) return;
  const float sc = dv ? 1.f : scale;
  float* o = (dv ? out1 : out0) + frow * head_dim + 256 * c + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int nn = 0; nn < 16; ++nn) {
      const float* a = acc[half];
      *reinterpret_cast<float2*>(o + 128 * half + 8 * nn) =
          make_float2(sc * (a[4 * nn] + a[4 * nn + 2]), sc * (a[4 * nn + 1] + a[4 * nn + 3]));
    }
  }
}

__global__ void __launch_bounds__(WideChunkBf16::kThreads, 1)
flash_dq_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int seq,
                          int head_dim, int causal, float scale_log2, float scale) {
  wide_bwd_bf16<false>(&q_map, &k_map, &v_map, &do_map, lse, delta, dq, nullptr, seq, head_dim,
                       causal, scale_log2, scale);
}

__global__ void __launch_bounds__(WideChunkBf16::kThreads, 1)
flash_dkv_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int head_dim,
                           int causal, float scale_log2, float scale) {
  wide_bwd_bf16<true>(&q_map, &k_map, &v_map, &do_map, lse, delta, dk, dv, seq, head_dim, causal,
                      scale_log2, scale);
}

__global__ void __launch_bounds__(WideChunkF32::kThreads, 1)
flash_dq_f32_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int seq,
                         int head_dim, int causal, float scale_log2, float scale) {
  wide_bwd_f32<false>(&q_map, &k_map, &v_map, &do_map, lse, delta, dq, nullptr, seq, head_dim,
                      causal, scale_log2, scale);
}

__global__ void __launch_bounds__(WideChunkF32::kThreads, 1)
flash_dkv_f32_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int seq, int head_dim,
                          int causal, float scale_log2, float scale) {
  wide_bwd_f32<true>(&q_map, &k_map, &v_map, &do_map, lse, delta, dk, dv, seq, head_dim, causal,
                     scale_log2, scale);
}

// K2 (kDq) or K3 above head_dim 256: grid (batch*heads, fixed tiles,
// chunks), the chunks n for K2 and 2 n (dV and dK) for K3.
template <bool kDq, bool kBf16>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* out0, void* out1,
                        int batch_heads, int seq, int head_dim, int causal, float scale_log2,
                        float scale, cudaStream_t stream) {
  using W = std::conditional_t<kBf16, WideChunkBf16, WideChunkF32>;
  using T = typename W::T;
  CUtensorMap maps[4];  // q, k, v, dout
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err;
  for (int i = 0; i < 4; ++i) {
    if ((err = make_wide_map<T>(&maps[i], ptrs[i], head_dim, batch_heads, seq, W::kRows)) !=
        cudaSuccess) {
      return err;
    }
  }
  constexpr size_t smem = W::kBytes;
  static_assert(smem <= 232448, "K2/K3 above head_dim 256 need more shared memory than a block has");
  const dim3 grid(batch_heads, (seq + W::kRows - 1) / W::kRows, (kDq ? 1 : 2) * (head_dim / 256));
  if constexpr (kBf16 && kDq) {
    if ((err = allow_smem(flash_dq_bf16_wide_kernel, smem)) != cudaSuccess) return err;
    flash_dq_bf16_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(out0), seq, head_dim,
        causal, scale_log2, scale);
  } else if constexpr (kBf16) {
    if ((err = allow_smem(flash_dkv_bf16_wide_kernel, smem)) != cudaSuccess) return err;
    flash_dkv_bf16_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<bf16*>(out0),
        static_cast<bf16*>(out1), seq, head_dim, causal, scale_log2, scale);
  } else if constexpr (kDq) {
    if ((err = allow_smem(flash_dq_f32_wide_kernel, smem)) != cudaSuccess) return err;
    flash_dq_f32_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<float*>(out0), seq, head_dim,
        causal, scale_log2, scale);
  } else {
    if ((err = allow_smem(flash_dkv_f32_wide_kernel, smem)) != cudaSuccess) return err;
    flash_dkv_f32_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<float*>(out0),
        static_cast<float*>(out1), seq, head_dim, causal, scale_log2, scale);
  }
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
    case 256:
      return kDq ? launch_dq<256, kBf16>(a) : launch_dkv<256, kBf16>(a);
    default:  // 256 n, n >= 2, in chunks of 256 (the grid's z dimension)
      if (head_dim <= 256 || head_dim % 256 != 0 || (kDq ? 1 : 2) * (head_dim / 256) > 65535) {
        return cudaErrorInvalidValue;
      }
      return hopper::launch_wide<kDq, kBf16>(
          a.q, a.k, a.v, a.dout, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), a.out0, a.out1, a.batch_heads, a.seq, head_dim,
          a.causal, a.scale_log2, a.scale, a.stream);
  }
}

template <bool kDq>
int dispatch(const Args& a, int head_dim, int is_bf16) {
  return static_cast<int>(is_bf16 ? dispatch_dim<kDq, true>(a, head_dim)
                                  : dispatch_dim<kDq, false>(a, head_dim));
}

}  // namespace

// q, k, v, dout, dq: (batch_heads, seq, head_dim) contiguous and 16-byte
// aligned, head_dim 32, 64, 128 or a multiple of 256, float32 (is_bf16 =
// 0) or bfloat16 (is_bf16 = 1); lse, delta:
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
