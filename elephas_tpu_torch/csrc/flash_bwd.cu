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
// of 64 in increasing order and are cast to the input dtype at the end.
//
// Design. The TPU grid's sequential axis and its VMEM accumulators become
// a loop inside one block, as in the forward:
//
// - K2: one block per (query-row tile, batch*head). Q, dO, lse and delta
//   stay put; K/V tiles stream through shared memory up to the diagonal
//   (causal) or the end. float32: 64-row tiles against 64-key tiles; bf16:
//   128 rows against 128 keys at D = 32, 192 against 64 at D = 64, 128
//   against 64 at D = 128.
// - K3: one block per (key tile, batch*head): 64 keys in float32; in bf16
//   192 at D = 32 and 128 at D = 64 and 128. K and V stay put; Q/dO tiles
//   of 64 rows stream from the one
//   holding the tile's first key (causal) or from the start, with lse and
//   delta staged beside them. dk and dv accumulate in float32 registers.
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
// - float32: float32 FMAs. A row (K2) or key (K3) is split over
//   neighbouring threads that each own 32 (K2) or 16
//   (K3, which keeps two accumulators) of its columns, so the accumulators
//   take 32 registers at every head_dim; the partial dot products meet by
//   warp shuffles. A thread's columns are interleaved 16 bytes at a time
//   with its neighbours', so the threads of one row read neighbouring banks.
//   K2 takes 16 keys per step. K3 takes one query row per step, its key's
//   K and V columns held in registers, the row's Q and dO columns feeding
//   both the dot products and the updates (per-step arrays of scores made
//   ptxas spill up to 6 KB a thread).
//
// Bound. Causal work is 3*B*H*S^2*D FLOPs for K2 and 4*B*H*S^2*D for K3
// (the Pallas kernels' CostEstimates) against 5*B*H*S*D*itemsize bytes, so
// at the LM's shape (8, 8, 2048, 32) both are bound by operations. In bf16
// the exponentials (one per valid score, 16 per clock per SM) are a floor
// of their own, about equal to K3's tensor-core bound at D = 32.

#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

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

}  // namespace hopper

// ---------------------------------------------------------------- float32

constexpr int kChunk = 16;  // K2: keys per inner step

// A row (K2) or key (K3) of a tile is split over kSplit = D / kCols
// neighbouring threads, each owning kCols of its columns in float4 groups
// that interleave with its neighbours'. K2 owns 32 columns (one 32-float
// accumulator), K3 16 (two 16-float accumulators), so each kernel keeps
// 32 accumulator registers at every head_dim.
template <int D, int kCols>
struct F32Layout {
  static constexpr int kSplit = D / kCols;
  static constexpr int kThreads = kTile * kSplit;
  static constexpr int kOwn = kCols / 4;  // float4 groups per thread
  static constexpr int RS = D + 4;        // padded row stride (floats)

  // Column of this thread's i-th float4 group.
  __device__ static __forceinline__ int col(int part, int i) { return 4 * (part + kSplit * i); }

  // Sum of a value over the kSplit threads that share one row.
  __device__ static __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
};

template <int D>
constexpr size_t f32_smem_bytes(int tiles) {
  return sizeof(float) * tiles * kTile * (D + 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float* acc, float s, float4 x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

// Write a [64][D + 4] shared tile's first rows (up to `seq`) to `dst`.
template <int D, int kThreads>
__device__ __forceinline__ void store_tile_f32(float* dst, const float* tile, int row0,
                                               int seq) {
  for (int i = threadIdx.x; i < kTile * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    if (row0 + r < seq) {
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(row0 + r) * D + c) =
          *reinterpret_cast<const float4*>(tile + r * (D + 4) + c);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32Layout<D, 32>::kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int seq, int causal, float scale_log2,
                    float scale) {
  using L = F32Layout<D, 32>;
  constexpr int RS = L::RS, kThreads = L::kThreads;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * RS;
  float* k_s = do_s + kTile * RS;
  float* v_s = k_s + kTile * RS;

  const int r = threadIdx.x / L::kSplit, part = threadIdx.x % L::kSplit;
  const int q0 = blockIdx.x * kTile, row = q0 + r;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * D;
  const int64_t i_row = static_cast<int64_t>(blockIdx.y) * seq + row;
  const float lse2 = row < seq ? lse[i_row] * kLog2e : 0.f;
  const float dlt = row < seq ? delta[i_row] : 0.f;

  load_tile<float, D, 4, kThreads>(q_s, q + base, q0, seq);
  load_tile<float, D, 4, kThreads>(do_s, dout + base, q0, seq);
  float acc[4 * L::kOwn];
#pragma unroll
  for (int i = 0; i < 4 * L::kOwn; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(seq, q0 + kTile) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s written)
    load_tile<float, D, 4, kThreads>(k_s, k + base, k0, seq);
    load_tile<float, D, 4, kThreads>(v_s, v + base, k0, seq);
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      float ds[kChunk], dp[kChunk];  // S and dP, then dS
#pragma unroll
      for (int j = 0; j < kChunk; ++j) ds[j] = dp[j] = 0.f;
#pragma unroll
      for (int i = 0; i < L::kOwn; ++i) {
        const int c = L::col(part, i);
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * RS + c);
        const float4 dov = *reinterpret_cast<const float4*>(do_s + r * RS + c);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          ds[j] = dot4(qv, *reinterpret_cast<const float4*>(k_s + (j0 + j) * RS + c), ds[j]);
          dp[j] = dot4(dov, *reinterpret_cast<const float4*>(v_s + (j0 + j) * RS + c), dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float s = L::row_sum(ds[j]);
        const float dpj = L::row_sum(dp[j]);
        const int col = k0 + j0 + j;
        const bool valid = col < seq && (!causal || col <= row);
        const float p = valid ? exp2f(s * scale_log2 - lse2) : 0.f;
        ds[j] = p * (dpj - dlt);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int i = 0; i < L::kOwn; ++i) {
          axpy4(acc + 4 * i, ds[j],
                *reinterpret_cast<const float4*>(k_s + (j0 + j) * RS + L::col(part, i)));
        }
      }
    }
  }

  // Stage scale * dq in this thread's own slots of q_s, then store the tile
  // row-major so consecutive threads write consecutive addresses.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    *reinterpret_cast<float4*>(q_s + r * RS + L::col(part, i)) =
        make_float4(scale * acc[4 * i], scale * acc[4 * i + 1], scale * acc[4 * i + 2],
                    scale * acc[4 * i + 3]);
  }
  __syncthreads();
  store_tile_f32<D, kThreads>(dq + base, q_s, q0, seq);
}

template <int D>
__global__ void __launch_bounds__(F32Layout<D, 16>::kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int seq, int causal,
                     float scale_log2, float scale) {
  using L = F32Layout<D, 16>;
  constexpr int RS = L::RS, kThreads = L::kThreads;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * RS;
  __shared__ float lse_s[kTile], dlt_s[kTile];  // lse in base 2, delta

  const int r = threadIdx.x / L::kSplit, part = threadIdx.x % L::kSplit;
  const int k0 = blockIdx.x * kTile, key = k0 + r;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * seq * D;
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * seq;

  // This thread's columns of its key's K and V rows stay in registers.
  float4 kr[L::kOwn], vr[L::kOwn];
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    const int64_t off = base + static_cast<int64_t>(key) * D + L::col(part, i);
    kr[i] = key < seq ? *reinterpret_cast<const float4*>(k + off) : make_float4(0, 0, 0, 0);
    vr[i] = key < seq ? *reinterpret_cast<const float4*>(v + off) : make_float4(0, 0, 0, 0);
  }
  float dk_acc[4 * L::kOwn], dv_acc[4 * L::kOwn];
#pragma unroll
  for (int i = 0; i < 4 * L::kOwn; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<float, D, 4, kThreads>(q_s, q + base, q0, seq);
    load_tile<float, D, 4, kThreads>(do_s, dout + base, q0, seq);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < seq;
      lse_s[i] = in ? lse[row_base + q0 + i] * kLog2e : 0.f;
      dlt_s[i] = in ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    // One query row at a time: its Q and dO columns feed both the dot
    // products and, from the same registers, the dK and dV updates.
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float4 qj[L::kOwn], dj[L::kOwn];
      float s = 0.f, dp = 0.f;  // S^T and dP^T for (key, q0 + j)
#pragma unroll
      for (int i = 0; i < L::kOwn; ++i) {
        qj[i] = *reinterpret_cast<const float4*>(q_s + j * RS + L::col(part, i));
        dj[i] = *reinterpret_cast<const float4*>(do_s + j * RS + L::col(part, i));
        s = dot4(kr[i], qj[i], s);
        dp = dot4(vr[i], dj[i], dp);
      }
      s = L::row_sum(s);
      dp = L::row_sum(dp);
      const int qpos = q0 + j;
      const bool valid = key < seq && qpos < seq && (!causal || key <= qpos);
      const float p = valid ? exp2f(s * scale_log2 - lse_s[j]) : 0.f;
      const float ds = p * (dp - dlt_s[j]);
#pragma unroll
      for (int i = 0; i < L::kOwn; ++i) {
        axpy4(dv_acc + 4 * i, p, dj[i]);
        axpy4(dk_acc + 4 * i, ds, qj[i]);
      }
    }
  }

  // Stage scale * dk and dv in this thread's own slots of q_s and do_s,
  // then store both tiles row-major.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L::kOwn; ++i) {
    const int c = L::col(part, i);
    *reinterpret_cast<float4*>(q_s + r * RS + c) =
        make_float4(scale * dk_acc[4 * i], scale * dk_acc[4 * i + 1],
                    scale * dk_acc[4 * i + 2], scale * dk_acc[4 * i + 3]);
    *reinterpret_cast<float4*>(do_s + r * RS + c) =
        make_float4(dv_acc[4 * i], dv_acc[4 * i + 1], dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
  }
  __syncthreads();
  store_tile_f32<D, kThreads>(dk + base, q_s, k0, seq);
  store_tile_f32<D, kThreads>(dv + base, do_s, k0, seq);
}

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
    const dim3 grid((a.seq + kTile - 1) / kTile, a.batch_heads);
    constexpr size_t smem = f32_smem_bytes<D>(4);
    constexpr int threads = F32Layout<D, 32>::kThreads;
    const cudaError_t err = allow_smem(flash_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_dq_f32_kernel<D><<<grid, threads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.out0), a.seq, a.causal, a.scale_log2, a.scale);
    return cudaGetLastError();
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
    const dim3 grid((a.seq + kTile - 1) / kTile, a.batch_heads);
    constexpr size_t smem = f32_smem_bytes<D>(2);
    constexpr int threads = F32Layout<D, 16>::kThreads;
    const cudaError_t err = allow_smem(flash_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_f32_kernel<D><<<grid, threads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse, delta,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.seq, a.causal,
        a.scale_log2, a.scale);
    return cudaGetLastError();
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
