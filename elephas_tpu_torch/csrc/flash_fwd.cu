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
// in one shape (D = 256 apart, below): warp 0 is the producer,
// which loads the block's Q tile once
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
//   tiles of 128 keys (64 at D = 128) in 3 stages. Q and K are K-major
//   operands from shared memory; P is rounded to bf16 straight into the
//   register A-operand layout; V is read MN-major through the descriptor's
//   transpose bit. At D = 256, where O takes 128 registers a thread, 128
//   rows (two warpgroups at 240) against 64-key tiles, with K and V in
//   rings of their own (WideFwdBf16).
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
//   block takes 32 query rows as one stacked operand (tf32.cuh) against
//   16-key tiles, in two warpgroups and no producer warpgroup, one for S
//   and the softmax, one for O (WideFwd).
//
// Bound. Causal work is 2*B*H*S^2*D FLOPs (K1's CostEstimate) and the
// traffic is 4*B*H*S*D*itemsize bytes plus the lse, so at the LM's shape
// (8, 8, 2048, 32) both kernels are bound by operations. In bf16 the
// exponentials (one per valid score, 16 per clock per SM) are a floor of
// their own, above the tensor cores' at D = 32. In float32 the split
// takes three tf32 products per product, 6*B*H*S^2*D FLOPs at 495 TFLOP/s,
// against the float32 FMA bound of 2*B*H*S^2*D at 67 TFLOP/s.

#include <math.h>

#include <type_traits>

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
// ring's depth at D <= 128: three warpgroups at 160 registers (128 * 24 +
// 384 * 160 <= 65536), tiles of 128 keys (64 at D = 128) in 3 stages. D =
// 256 has a shape of its own (WideFwdBf16, below).
template <int D>
struct Shape {
  static constexpr int kConsumers = 3;
  static constexpr int kN = D == 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = 3;
  static constexpr int kRows = 64 * kConsumers;            // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);  // and the producer warpgroup
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kConsumerRegs = 160;  // after setmaxnreg
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

// S = Q K^T for one warpgroup's 64 query rows (from row q_row0 of a Q
// tile of kRows rows) against a tile of N keys, committed as one wgmma group.
template <int D, int N, int kRows>
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

// O = acc / l in bf16 and the lse (base e) of this thread's two rows
// below `seq`; the row sums are first summed over the quad that holds a row.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ o, float* __restrict__ lse,
                                           const float (&acc)[D / 2], const float (&m)[2],
                                           float (&l)[2], const int (&rows)[2], int bh, int seq) {
  const int t = threadIdx.x % 4;
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
  issue_qk<D, N, kRows>(s, q_s, q_row0, k_tile(0));
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
    issue_qk<D, N, kRows>(s, q_s, q_row0, k_tile(j));
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
  store_rows<D>(o, lse, acc, m, l, rows, bh, seq);
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

// ------------------------------------------------- bfloat16 at D = 256

// At D = 256 a K or V tile of 64 keys is 32 KiB and 64 rows of O take 128
// registers a thread, so the block keeps the generic shape's plan at 128
// query rows: two consumer warpgroups at 240 registers beside a producer
// warpgroup at 24 (128 * 24 + 256 * 240 <= 65536), 64-key tiles, S_j and
// P_{j-1} V_{j-1} in flight together. A tile's products take ~2,050 cycles
// of the tensor cores, and its 64 KiB of K and V arrive at 20-odd bytes a
// clock, ~3,000 cycles: the stream sets the pace, and the design keeps it
// busy:
// - K and V have rings of their own, each slot with a full and an empty
//   barrier. K_j's slot is released once S_j = Q K_j^T is done, V_j's once
//   P_j V_j is. (One stage of K and V released after P V left the producer
//   refilling K just before the consumers needed it: a third of a tile's
//   cycles went to waiting for K.)
// - The producer issues the tiles in the order the consumers read them,
//   K_{j+1} before V_j.
// - Two K slots and three V slots: V's release comes later in an iteration
//   than K's, so V's ring is the deeper (3 + 2 and 2 + 2 slots ran ~3%
//   slower; scripts/torch_fwd_variants.py times such variants).
// - Causal: the first consumer warpgroup's last tile (keys q0 + 64 ..)
//   lies wholly above its rows, and its loop ends a tile early (a few
//   percent of the time). The bound is uniform over the warpgroup, so no
//   wgmma sits under a branch (C7520).
// - A slot is released only if it is filled again: the last tiles' slots,
//   and the tile the first consumer skips, take no arrival, so no barrier
//   is left in a phase that is never completed.
//
// Budget: 64 KiB (Q) + 5 x 32 KiB + 11 barriers + 1 KiB of alignment slack
// = 230,488 of 232,448 bytes.
struct WideFwdBf16 {
  static constexpr int D = 256;
  static constexpr int kRows = 128;  // query rows a block
  static constexpr int kN = 64;      // keys a tile
  static constexpr int kKSlots = 2;
  static constexpr int kVSlots = 3;
  static constexpr bool kSkipMasked = true;  // the first consumer's masked last tile (causal)
  static constexpr int kThreads = 384;       // the producer warpgroup and two consumers
  static constexpr int kConsumerWarps = 8;
  static constexpr size_t kTile = tile_bytes<D>(kN);
  static constexpr size_t kK = tile_bytes<D>(kRows);  // the K ring, after Q
  static constexpr size_t kV = kK + kKSlots * kTile;
  static constexpr size_t kBar = kV + kVSlots * kTile;
  static constexpr size_t kBytes =
      kBar + (1 + 2 * (kKSlots + kVSlots)) * sizeof(uint64_t) + 1024;
};

// The generic kernel's launch bounds name this when the D = 256 kernel
// below is declared.
template <>
struct Shape<256> {
  static constexpr int kThreads = WideFwdBf16::kThreads;
};

// The `clock:` comments name the phases of a tile that
// scripts/torch_fwd_clocks.py stamps with clock() in a copy of this file.
template <>
__global__ void __launch_bounds__(WideFwdBf16::kThreads, 1)
flash_fwd_bf16_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                           float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using W = WideFwdBf16;
  constexpr int D = W::D, N = W::kN, kKS = W::kKSlots, kVS = W::kVSlots;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + W::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + kKS;
  uint64_t* v_full = k_empty + kKS;
  uint64_t* v_empty = v_full + kVS;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * W::kRows;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + W::kRows) : seq;
  const int tiles = (kv_end + N - 1) / N;
  // The warpgroup, broadcast so that ptxas knows it is warp-uniform: a
  // loop bound it takes as divergent serializes every wgmma (C7520).
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const auto k_tile = [&](int j) { return smem + W::kK + (j % kKS) * W::kTile; };
  const auto v_tile = [&](int j) { return smem + W::kV + (j % kVS) * W::kTile; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], W::kConsumerWarps);
    }
    for (int s = 0; s < kVS; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], W::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();  // clock: start

  if (warpgroup == 0) {  // producer: Q and K_0, then K_{j+1} and V_j for each j
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // Fill n of a slot waits until fill n - 1 is released; fill 0 waits
      // on the phase before the barrier's first, which counts as complete.
      const auto load = [&](uint64_t* full, uint64_t* empty, uint8_t* tile, const CUtensorMap* map,
                            int j, int stages) {
        mbar_wait(&empty[j % stages], ((j / stages) & 1) ^ 1);  // clock: slot wait
        mbar_arrive_expect_tx(&full[j % stages], W::kTile);
        load_tile_tma<D>(tile, map, &full[j % stages], N, j * N, bh);  // clock: TMA issue
      };
      mbar_arrive_expect_tx(q_full, tile_bytes<D>(W::kRows));
      load_tile_tma<D>(smem, &q_map, q_full, W::kRows, q0, bh);
      load(k_full, k_empty, k_tile(0), &k_map, 0, kKS);
      for (int j = 0; j < tiles; ++j) {
        if (j + 1 < tiles) load(k_full, k_empty, k_tile(j + 1), &k_map, j + 1, kKS);
        load(v_full, v_empty, v_tile(j), &v_map, j, kVS);
      }
    }  // clock: store
    return;
  }

  // Consumers: this warpgroup's 64 rows start at r0. It computes `mine`
  // tiles: all of them, but for the first consumer's wholly masked last one.
  setmaxnreg_inc<240>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int q_row0 = (warpgroup - 1) * 64;  // within the Q tile
  const int r0 = q0 + q_row0;
  const int rows[2] = {r0 + warp * 16 + lane / 4, r0 + warp * 16 + lane / 4 + 8};
  const int mine = W::kSkipMasked && causal ? (min(seq, r0 + 64) + N - 1) / N : tiles;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[N / 2];
  uint32_t p[N / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  const auto needs_mask = [&](int j) {  // the causal diagonal or a ragged last tile
    return (causal && j * N + N - 1 > r0) || j * N + N > seq;
  };
  // Tile j's slot is done with (every warp arrives) if it is filled again.
  const auto release = [&](uint64_t* empty, int j, int stages) {
    if (lane == 0 && j + stages < tiles) mbar_arrive(&empty[j % stages]);
  };

  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);  // clock: K wait
  wgmma_fence();
  issue_qk<D, N, W::kRows>(s, smem, q_row0, k_tile(0));  // clock: S issue
  wgmma_wait<0>();
  fence_operand(s);  // clock: S wait
  release(k_empty, 0, kKS);
  softmax_tile<N>(s, m, l, corr, needs_mask(0), 0, rows, seq, causal, scale_log2);  // clock: softmax
  pack_p<N>(p, s);  // clock: rescale and pack

  for (int j = 1; j < mine; ++j) {
    // Tile j's S and tile j-1's P V in flight together; K_j is released as
    // soon as S is done, V_{j-1} once P V is.
    mbar_wait(&k_full[j % kKS], (j / kKS) & 1);  // clock: K wait
    fence_operand(acc);
    wgmma_fence();
    issue_qk<D, N, W::kRows>(s, smem, q_row0, k_tile(j));  // clock: S issue
    mbar_wait(&v_full[(j - 1) % kVS], ((j - 1) / kVS) & 1);  // clock: V wait
    wgmma_fence();
    issue_pv<D, N>(acc, p, v_tile(j - 1));  // clock: PV issue
    wgmma_wait<1>();
    fence_operand(s);  // clock: S wait
    release(k_empty, j, kKS);
    softmax_tile<N>(s, m, l, corr, needs_mask(j), j * N, rows, seq, causal, scale_log2);  // clock: softmax
    wgmma_wait<0>();
    fence_operand(acc);  // clock: PV wait
    release(v_empty, j - 1, kVS);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];
    pack_p<N>(p, s);  // clock: rescale and pack
  }
  mbar_wait(&v_full[(mine - 1) % kVS], ((mine - 1) / kVS) & 1);  // clock: V wait
  fence_operand(acc);
  wgmma_fence();
  issue_pv<D, N>(acc, p, v_tile(mine - 1));  // clock: PV issue
  wgmma_wait<0>();
  fence_operand(acc);  // clock: PV wait
  release(v_empty, mine - 1, kVS);  // clock: store
  store_rows<D>(o, lse, acc, m, l, rows, bh, seq);
}

template <>
cudaError_t launch<256>(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch_heads, int seq, int causal, float scale_log2,
                        cudaStream_t stream) {
  using W = WideFwdBf16;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<W::D>(&q_map, q, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&k_map, k, batch_heads, seq, W::kN)) != cudaSuccess ||
      (err = make_tile_map<W::D>(&v_map, v, batch_heads, seq, W::kN)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = W::kBytes;
  static_assert(smem <= 232448, "bf16 K1 needs more shared memory than a block has");
  if ((err = allow_smem(flash_fwd_bf16_kernel<256>, smem)) != cudaSuccess) return err;
  const dim3 grid(batch_heads, (seq + W::kRows - 1) / W::kRows);
  flash_fwd_bf16_kernel<256><<<grid, W::kThreads, smem, stream>>>(
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
__host__ __device__ constexpr int f32_consumers(int D) { return D == 32 ? 3 : (D == 64 ? 2 : 1); }

template <int D>
struct F32Shape {
  static constexpr int kConsumers = f32_consumers(D);
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

// Its launch bounds name no F32Shape: declaring the D = 256 kernel below,
// which has a shape of its own, would instantiate F32Shape<256>, whose
// unused members nvcc reports.
template <int D>
__global__ void __launch_bounds__(128 * (1 + f32_consumers(D)), 1)
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

// A 64-row float32 tile of head_dim 256 is 64 KiB, and 64 rows of O take
// 128 registers a thread. The block takes 32 query rows as a stacked
// operand (tf32.cuh: rows and their lo parts in one 64-row operand)
// against 16-key tiles, in two warpgroups and no producer warpgroup (256
// threads, up to 255 registers a thread: beside a producer warpgroup the
// others' 240 made ptxas serialize the products, C7512). The online
// softmax still steps 16 keys at a time, so the order of the sums is the
// (32, 16) tiling's.
//
// - Warpgroup 0 holds the stacked Q as the register A operand of S (128
//   registers, brought once by TMA into a staging area) and takes the
//   keys two tiles at a time: a stage of its K ring holds per column
//   block the 32 keys TMA brings, then their lo parts, which it writes.
//   One m64n64k8 product a k8 step gives Q_st K^T and Q_st K_lo^T of both
//   tiles, all four terms of the split (32 products for 32 keys; none
//   reads Q from shared memory, and m64n64 keeps the tensor cores at their
//   rate where a warpgroup's m64n16 and m64n32 products from registers
//   left them at half). It merges the terms, masks, runs the online
//   softmax of both tiles and writes each tile's P, hi and lo (query
//   rows, then their lo parts: the B operand of the output's products),
//   with each row's correction, into one of 4 exchange buffers.
// - Warpgroup 1 holds O transposed, O^T = V^T P^T, all 256 head_dim rows
//   as 4 slabs of 64 (128 registers), one tile at a time. Its A operand is
//   V^T in registers, hi and lo, loaded straight from the TMA tile: tf32
//   operands in shared memory are K-major only, so O = P V would need V^T
//   written into shared memory each tile. Its B operand is the
//   exchange's P pair: per slab and k8 step, V^T [P; P_lo]^T (m64n64)
//   and V^T_lo P^T (m64n32, into the P columns), the three terms of the
//   split (16 products a tile). Each thread's head_dim rows are chosen
//   (`wide_fwd_dim`) so that a warp's 8-byte loads of V meet no bank
//   twice. It rescales O by each row's correction before a tile's
//   products (a warp whose corrections are all 1 skips it), and at the
//   end adds each row's hi and lo columns.
// - Each warpgroup loads its own ring by TMA, every warp 2 of a stage's 8
//   boxes, after its side of the exchange (issuing a box takes a warp
//   tens of cycles, which the other warpgroup would otherwise wait for).
//   The warpgroups meet only at the exchange, so warpgroup 0's S and
//   softmax run ahead while warpgroup 1's products run.
//
// Budget: shared memory 2 x 64 KiB (K) + 3 x 16 KiB (V) + 32 KiB (Q
// staging, then the exchange) + barriers = 214,128 of 232,448 bytes. Per
// 16-key tile the tensor cores do 64 x 32 x 256 + 256 x 96 x 16
// multiply-adds (S; O), about 900 cycles at the tf32 rate; shared memory
// moves about 140 KiB (TMA, K_lo, V's fragments, the products' B
// operands, the exchange), about 1,100 cycles at 128 bytes a cycle.
// scripts/torch_fwd_clocks.py splits a tile's cycles by phase and
// warpgroup.
struct WideFwd {
  static constexpr int D = 256;
  static constexpr int kRows = 32;   // query rows a block
  static constexpr int kN = 16;      // keys a tile
  static constexpr int kKStages = 2;  // K ring, two tiles a stage
  static constexpr int kVStages = 3;  // V ring, a tile a stage
  static constexpr int kBufs = 4;     // exchange buffers, a tile each
  static constexpr int kThreads = 256;  // two warpgroups, no producer
  using L = TileLayout<D, float>;       // Q, K and V tiles: 8 column blocks of 128-byte rows
  using P = TileLayout<kN, float>;      // the P pair: 64 rows of 64 bytes
  static constexpr size_t kKStage = tile_bytes<D, float>(4 * kN);  // K of two tiles, then K_lo
  static constexpr size_t kVTile = tile_bytes<D, float>(kN);
  static constexpr size_t kV = kKStages * kKStage;
  static constexpr size_t kQ = kV + kVStages * kVTile;  // Q staging, then the exchange
  static constexpr size_t kXchg = kQ;
  static constexpr size_t kCorr = P::block_bytes(2 * kRows);  // within an exchange buffer
  static constexpr size_t kXchgBuf = align1k(kCorr + kRows * sizeof(float));
  static constexpr size_t kRowL = kXchg + kBufs * kXchgBuf;  // each row's sum, at the end
  static constexpr size_t kBar = kQ + tile_bytes<D, float>(kRows);
  static constexpr size_t kBytes =
      kBar + (1 + kKStages + kVStages + 2 * kBufs) * sizeof(uint64_t) + 1024;
  static_assert(kRowL + kRows * sizeof(float) <= kBar, "the exchange outgrows the Q staging area");
};

// Head_dim row of O^T (within a slab of 64) that warpgroup 1's thread
// (warp w, lane group gq = lane / 4) holds as fragment row 16w + gq; it
// holds the next, d + 1, as row 16w + gq + 8. With key t (lane % 4) the
// 8-byte loads of a warp cover each 128-byte row of a swizzled V tile
// once (chunk 4((gq >> 1) & 1) + w XOR the key's row), half a warp a
// column block.
__device__ __forceinline__ int wide_fwd_dim(int w, int gq) {
  return 32 * (gq >> 2) + 16 * ((gq >> 1) & 1) + 4 * w + 2 * (gq & 1);
}

// Softmax of two consecutive 16-key tiles of one row from key k0 (merged
// scores in place: sm[u] of tile u becomes p), as softmax_tile does for
// two rows and one tile; the same operations in the same order as the
// tiles in turn, their dependency chains interleaved. corr[u] rescales
// what came before tile u.
__device__ __forceinline__ void softmax_pair(float (&sm)[2][4], float& m, float& l,
                                             float (&corr)[2], bool mask, int k0, int row,
                                             int seq, int causal, float scale_log2) {
  constexpr int T = 2;
  const int t = threadIdx.x % 4;
  if (mask) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + 16 * u + (i / 2) * 8 + 2 * t + (i & 1);
        if (col >= seq || (causal && col > row)) sm[u][i] = -INFINITY;
      }
    }
  }
  float mx[T], shift[T];
#pragma unroll
  for (int u = 0; u < T; ++u) mx[u] = fmaxf(fmaxf(sm[u][0], sm[u][1]), fmaxf(sm[u][2], sm[u][3]));
#pragma unroll
  for (int u = 0; u < T; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
#pragma unroll
  for (int u = 0; u < T; ++u) mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const float m_new = fmaxf(m, mx[u] * scale_log2);
    shift[u] = isfinite(m_new) ? m_new : 0.f;
    corr[u] = isfinite(m) ? exp2_approx(m - shift[u]) : 0.f;
    m = m_new;
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sm[u][i] = exp2_approx(fmaf(sm[u][i], scale_log2, -shift[u]));
      sum += sm[u][i];
    }
    l = l * corr[u] + sum;
  }
}

// The `clock:` comments name the phases of a tile that
// scripts/torch_fwd_clocks.py stamps with clock() in a copy of this file.
template <>
__global__ void __launch_bounds__(WideFwd::kThreads, 1)
flash_fwd_f32_kernel<256>(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                          float* __restrict__ lse, int seq, int causal, float scale_log2) {
  using S = WideFwd;
  constexpr int D = S::D, N = S::kN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + S::kKStages;
  uint64_t* p_full = v_full + S::kVStages;  // per exchange buffer
  uint64_t* p_empty = p_full + S::kBufs;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::kRows;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + S::kRows) : seq;
  const int tiles = (kv_end + N - 1) / N;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t = lane % 4;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    // Every warp of the warpgroup that loads the ring, and of the one that
    // writes (p_full) or releases (p_empty) an exchange buffer.
    for (int s = 0; s < S::kKStages; ++s) mbar_init(&k_full[s], 4);
    for (int s = 0; s < S::kVStages; ++s) mbar_init(&v_full[s], 4);
    for (int b = 0; b < S::kBufs; ++b) {
      mbar_init(&p_full[b], 4);
      mbar_init(&p_empty[b], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup, broadcast so that ptxas knows it is warp-uniform: with
  // wgmma in both branches, a branch it takes as divergent serializes
  // every wgmma (C7520).
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), ctid = threadIdx.x % 128;
  // clock: start
  const CUtensorMap* const kmap = &k_map;
  const CUtensorMap* const vmap = &v_map;
  uint8_t* const xchg = smem + S::kXchg;
  float* const rowl = reinterpret_cast<float*>(smem + S::kRowL);

  if (g == 0) {
    // S, the softmax and P. Thread (warp w, lane l) owns query row
    // q0 + 8w + l/4, its keys 8jj + 2t + c of a tile (jj, c < 2). Stage i
    // of the K ring holds tiles 2i and 2i + 1: per column block their 32
    // keys (one TMA box), then the keys' lo parts.
    const int pairs = (tiles + 1) / 2;
    const auto k_stage = [&](int i) { return smem + (i % S::kKStages) * S::kKStage; };
    const auto load_k = [&](int i) {
      if (lane == 0 && i < pairs) {
        uint64_t* full = &k_full[i % S::kKStages];
        mbar_arrive_expect_tx(full, 4 * S::L::block_bytes(N));
#pragma unroll
        for (int c = 2 * warp; c < 2 * warp + 2; ++c) {
          tma_load_3d(k_stage(i) + c * S::L::block_bytes(4 * N), kmap, full, c * S::L::W, 2 * i * N, bh);
        }
      }
    };
    if (ctid == 0) {
      mbar_arrive_expect_tx(q_full, tile_bytes<D, float>(S::kRows));
      load_tile_tma<D, float>(smem + S::kQ, &q_map, q_full, S::kRows, q0, bh);
    }
    for (int i = 0; i < S::kKStages; ++i) load_k(i);
    const int r = 8 * warp + lane / 4, row = q0 + r;

    uint32_t a[D / 8][4];  // stacked Q
    mbar_wait(q_full, 0);
    tf32::load_stacked_a(a, smem + S::kQ, r, t);
    float x[2 * N];      // S of the stacked rows against the stage's 64 rows
    float sm[2][N / 4];  // merged, then p, of both tiles
    float m = -INFINITY, l = 0.f, corr[2];
    // Pair i's K_lo, visible to wgmma once a warpgroup barrier follows.
    const auto write_k_lo = [&](int i) {
      mbar_wait(&k_full[i % S::kKStages], (i / S::kKStages) & 1);
      tf32::write_pair_lo<4 * N>(k_stage(i), ctid);
      fence_proxy_async();
    };
    const auto issue_s = [&](int i) {
      const uint8_t* st = k_stage(i);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        wgmma_rs_tf32<4 * N>(x, a[kk], desc_k_major<D, float>(st, 4 * N, 0, kk), kk > 0);
      }
      wgmma_commit();
    };

    write_k_lo(0);  // Q staging is read: the exchange may take it after this barrier
    named_barrier_sync(1, 128);
    for (int i = 0; i < pairs; ++i) {
      issue_s(i);  // clock: S issue
      if (i + 1 < pairs) write_k_lo(i + 1);  // clock: K_lo copy and TMA wait (next pair)
      wgmma_wait<0>();  // clock: S products
      fence_operand(x);
      // Every warp's S of pair i is done (its stage may take pair i + 2)
      // and pair i + 1's lo parts are written.
      named_barrier_sync(1, 128);  // clock: warpgroup barrier
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // Key 8jj + 2t + c of tile 2i + h: column 16h + 8jj + 2t + c
            // against K, + 32 against K_lo; hi rows, then lo rows.
            const float* y = x + 8 * h + 4 * jj + c;
            sm[h][2 * jj + c] = (y[0] + y[2]) + (y[16] + y[18]);
          }
        }
      }
      // A tile past the last (tiles odd) is masked whole: its p are 0 and
      // its correction 1, and no P of it is written.
      const int k0 = 2 * i * N;
      const bool mask = (causal && k0 + 2 * N - 1 > q0) || k0 + 2 * N > seq;
      softmax_pair(sm, m, l, corr, mask, k0, row, seq, causal, scale_log2);
      // clock: merge and softmax
      // P and the corrections of tile j into buffer j % kBufs, once tile
      // j - kBufs's products have read it.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * i + h;
        if (j >= tiles) break;
        uint8_t* xb = xchg + (j % S::kBufs) * S::kXchgBuf;
        if (j >= S::kBufs) mbar_wait(&p_empty[j % S::kBufs], ((j / S::kBufs) - 1) & 1);
        // clock: wait for an exchange buffer
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = (8 * jj + 2 * t) * 4;
          const float2 p = make_float2(sm[h][2 * jj], sm[h][2 * jj + 1]);
          *reinterpret_cast<float2*>(xb + S::P::offset(r, col)) = p;
          *reinterpret_cast<float2*>(xb + S::P::offset(r + S::kRows, col)) =
              make_float2(tf32::lo(p.x), tf32::lo(p.y));
        }
        if (t == 0) reinterpret_cast<float*>(xb + S::kCorr)[r] = corr[h];
      }
      fence_proxy_async();
      __syncwarp();  // clock: P exchange write
      if (lane == 0) {
        mbar_arrive(&p_full[(2 * i) % S::kBufs]);
        if (2 * i + 1 < tiles) mbar_arrive(&p_full[(2 * i + 1) % S::kBufs]);
      }
      load_k(i + S::kKStages);  // into pair i's stage
    }

    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    if (t == 0) {
      rowl[r] = denom;
      if (row < seq) {
        lse[static_cast<int64_t>(bh) * seq + row] = ((isfinite(m) ? m : 0.f) + log2f(denom)) * kLn2;
      }
    }
    named_barrier_sync(3, 256);  // clock: store
    return;
  }

  // Warpgroup 1: O^T. Thread (warp w, lane l) holds, per slab s, head_dim
  // rows 64s + d0 and + 1 against query columns 8j + 2t + c (j < 4: P;
  // j >= 4: P_lo of the same rows).
  const auto v_tile = [&](int j) { return smem + S::kV + (j % S::kVStages) * S::kVTile; };
  const auto load_v = [&](int j) {
    if (lane == 0 && j < tiles) {  // column blocks 2 warp and 2 warp + 1
      uint64_t* full = &v_full[j % S::kVStages];
      mbar_arrive_expect_tx(full, 2 * S::L::block_bytes(N));
#pragma unroll
      for (int c = 2 * warp; c < 2 * warp + 2; ++c) {
        tma_load_3d(v_tile(j) + c * S::L::block_bytes(N), vmap, full, c * S::L::W, j * N, bh);
      }
    }
  };
  for (int j = 0; j < S::kVStages; ++j) load_v(j);
  const int d0 = wide_fwd_dim(warp, lane / 4);

  float acc[4][32];
  uint32_t v_hi[4][2][4], v_lo[4][2][4];  // per slab and k8 step
  // A fragments of tile j's V^T: rows d0, d0 + 1 of each slab (a[0..1]:
  // key 8kk + t; a[2..3]: key 8kk + t + 4), each one 8-byte load.
  const auto v_frags = [&](int j) {
    const uint8_t* vt = v_tile(j);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 64 * s + d0, key = 8 * kk + t + 4 * h;
          const float2 x = *reinterpret_cast<const float2*>(
              vt + (d / S::L::W) * S::L::block_bytes(N) + S::L::offset(key, (d % S::L::W) * 4));
          v_hi[s][kk][2 * h] = __float_as_uint(x.x) & 0xffffe000u;
          v_hi[s][kk][2 * h + 1] = __float_as_uint(x.y) & 0xffffe000u;
          v_lo[s][kk][2 * h] = __float_as_uint(x.x - __uint_as_float(v_hi[s][kk][2 * h]));
          v_lo[s][kk][2 * h + 1] = __float_as_uint(x.y - __uint_as_float(v_hi[s][kk][2 * h + 1]));
        }
        fence_operand(v_hi[s][kk]);
        fence_operand(v_lo[s][kk]);
      }
    }
  };
  // O *= each query row's correction for tile j, unless the warp's are all 1.
  const auto rescale = [&](int j) {
    const float* cr = reinterpret_cast<const float*>(xchg + (j % S::kBufs) * S::kXchgBuf + S::kCorr);
    float c8[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float2 c2 = *reinterpret_cast<const float2*>(cr + 8 * jj + 2 * t);
      c8[2 * jj] = c2.x, c8[2 * jj + 1] = c2.y;
    }
    bool ones = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) ones = ones && c8[i] == 1.f;
    if (__all_sync(0xffffffffu, ones)) return;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][i] *= c8[2 * ((i / 4) % 4) + (i & 1)];
    }
  };
  // O^T += V^T [P; P_lo]^T + V^T_lo P^T over tile j; tile 0's first
  // product of each slab overwrites it (zeros set by other instructions
  // could land inside an open wgmma stage, where ptxas serializes every
  // wgmma: C7515).
  const auto issue_pv = [&](int j) {
    const uint8_t* pb = xchg + (j % S::kBufs) * S::kXchgBuf;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t b = desc_k_major<N, float>(pb, 2 * S::kRows, 0, kk);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs_tf32<64>(acc[s], v_hi[s][kk], b, j > 0 || kk > 0);
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // V^T_lo against P alone: the columns of P, acc's first 16
        wgmma_rs_tf32<32>(*reinterpret_cast<float(*)[16]>(acc[s]), v_lo[s][kk], b, 1);
      }
    }
    wgmma_commit();
  };

  for (int j = 0; j < tiles; ++j) {
    // Tile j - 1's products are done (none are pending before tile 0),
    // so its exchange buffer is free. The wait is unconditional: on a path
    // ptxas sees without it, the writes below to V's and O's registers
    // would meet a product in flight, and it serializes every wgmma (C7520).
    wgmma_wait<0>();  // clock: PV products
#pragma unroll
    for (int s = 0; s < 4; ++s) fence_operand(acc[s]);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&p_empty[(j - 1) % S::kBufs]);  // clock: PV products
    }
    mbar_wait(&v_full[j % S::kVStages], (j / S::kVStages) & 1);  // clock: TMA wait V
    v_frags(j);  // clock: V fragments
    named_barrier_sync(2, 128);  // every warp has read tile j's V; clock: warpgroup barrier 1
    mbar_wait(&p_full[j % S::kBufs], (j / S::kBufs) & 1);  // clock: wait for P
    if (j > 0) rescale(j);  // clock: rescale
    issue_pv(j);  // clock: PV issue
    load_v(j + S::kVStages);  // into tile j's stage
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < 4; ++s) fence_operand(acc[s]);
  named_barrier_sync(3, 256);  // warpgroup 0 has written each row's sum; clock: store

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = 8 * jj + 2 * t + c;
      if (q0 + q >= seq) continue;
      const float denom = rowl[q];
      float* out = o + (static_cast<int64_t>(bh) * seq + q0 + q) * D + d0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* a = acc[s];
        *reinterpret_cast<float2*>(out + 64 * s) =
            make_float2((a[4 * jj + c] + a[4 * jj + 16 + c]) / denom,
                        (a[4 * jj + 2 + c] + a[4 * jj + 18 + c]) / denom);
      }
    }
  }
}

template <>
cudaError_t launch_f32<256>(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch_heads, int seq, int causal, float scale_log2,
                            cudaStream_t stream) {
  using S = WideFwd;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_tile_map<S::D, float>(&q_map, q, batch_heads, seq, S::kRows)) != cudaSuccess ||
      (err = make_tile_map<S::D, float>(&k_map, k, batch_heads, seq, 2 * S::kN)) != cudaSuccess ||
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

// ------------------------------------------------- above D = 256
//
// head_dim = 256 n, n >= 2 (sm90.cuh, "above D = 256"): a block takes
// the fixed query rows q0 .. of one head and owns chunk c = blockIdx.z of
// O, 256 columns, against K/V tiles up to the diagonal (causal) or the
// end. Per tile S = Q K^T streams over all n chunks of Q and K; the online
// softmax runs as at D <= 256, and O_c += P V_c reads the tile's chunk c
// of V from the out slot. Every block of a row tile computes S and the
// softmax in one order, so all agree; block 0 writes the lse. Recomputing
// S in each of the n blocks makes the work (n + 1) / 2 of K1's
// CostEstimate. Blocks are handed out longest first (causal).

// bfloat16: 64 query rows a block against 64-key tiles; the consumer
// warpgroup's registers hold O_c (128), S (32) and P (16).
__global__ void __launch_bounds__(WideChunkBf16::kThreads, 1)
flash_fwd_bf16_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                           float* __restrict__ lse, int seq, int head_dim, int causal,
                           float scale_log2) {
  using W = WideChunkBf16;
  constexpr int N = W::kRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  const WideBars<W> bars(smem);
  const int bh = blockIdx.x, c = blockIdx.z, n = head_dim / 256;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * N;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + N) : seq;
  const int tiles = (kv_end + N - 1) / N;
  // The warpgroup, broadcast so that ptxas knows it is warp-uniform.
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warpgroup == 0) {
    if (threadIdx.x < 32) {
      wide_produce<W>(smem, bars.full, bars.empty, bars.out_full, bars.out_empty, &q_map, &k_map,
                      &q_map, &k_map, 0, &v_map, nullptr, nullptr, n, c, q0, 0, tiles, bh, seq);
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int rows[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s[N / 2];
  uint32_t p[N / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    wide_reduce_bf16(s, smem, bars.full, bars.empty, it, n);
    const bool mask = (causal && j * N + N - 1 > q0) || j * N + N > seq;
    softmax_tile<N>(s, m, l, corr, mask, j * N, rows, seq, causal, scale_log2);
    fence_operand(acc);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] *= corr[(i / 2) & 1];
    pack_p<N>(p, s);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_operand(p[kk]);
    mbar_wait(bars.out_full, j & 1);
    fence_operand(acc);
    wgmma_fence();
    issue_pv<256, N>(acc, p, smem + W::kOut);
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(bars.out_empty);
  }

  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    if (rows[r] >= seq) continue;
    if (c == 0 && t == 0) {
      const float shift = isfinite(m[r]) ? m[r] : 0.f;
      lse[static_cast<int64_t>(bh) * seq + rows[r]] = (shift + log2f(denom)) * kLn2;
    }
    bf16* out = o + (static_cast<int64_t>(bh) * seq + rows[r]) * head_dim + 256 * c + 2 * t;
#pragma unroll
    for (int nn = 0; nn < 32; ++nn) {
      *reinterpret_cast<__nv_bfloat162*>(out + nn * 8) =
          __floats2bfloat162_rn(acc[4 * nn + 2 * r] / denom, acc[4 * nn + 2 * r + 1] / denom);
    }
  }
}

// float32 (split tf32): 32 query rows a block, stacked, against 32-key
// tiles. Thread (warp w, lane l) owns query row q0 + 8w + l/4 and keys
// 8j + 2t + c of a tile (t = l % 4): the online softmax over a row's 32
// keys reduces over its quad. O_c is a stacked m64n256 accumulator (128
// registers), each row's hi and lo parts added at the end.
__global__ void __launch_bounds__(WideChunkF32::kThreads, 1)
flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                          float* __restrict__ lse, int seq, int head_dim, int causal,
                          float scale_log2) {
  using W = WideChunkF32;
  constexpr int N = W::kRows;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (align1k(smem_addr(smem_raw)) - smem_addr(smem_raw));
  const WideBars<W> bars(smem);
  const int bh = blockIdx.x, c = blockIdx.z, n = head_dim / 256;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * N;  // longest q tiles first
  const int kv_end = causal ? min(seq, q0 + N) : seq;
  const int tiles = (kv_end + N - 1) / N;
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (warpgroup == 0) {
    if (threadIdx.x < 32) {
      wide_produce<W>(smem, bars.full, bars.empty, bars.out_full, bars.out_empty, &q_map, &k_map,
                      &q_map, &k_map, 0, &v_map, nullptr, nullptr, n, c, q0, 0, tiles, bh, seq);
    }
    return;
  }

  const int ctid = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4;
  const int r = 8 * (ctid / 32) + lane / 4, row = q0 + r;
  const int slices = n * (256 / W::kSlice);
  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  float x[N];      // the stacked S against the keys and their lo parts
  float sm[8];     // S, then P, of this row's 8 keys
  uint32_t fr[4][4];
  float m = -INFINITY, l = 0.f;
  int it = 0;
  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * N;
    tf32::wide_reduce_f32(x, smem, bars.full, bars.empty, it, slices, r, t, ctid);
    tf32::merge_stacked(sm, x);
    if ((causal && k0 + N - 1 > q0) || k0 + N > seq) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = k0 + (e / 2) * 8 + 2 * t + (e & 1);
        if (col >= seq || (causal && col > row)) sm[e] = -INFINITY;
      }
    }
    float mx = sm[0];
#pragma unroll
    for (int e = 1; e < 8; ++e) mx = fmaxf(mx, sm[e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx * scale_log2);
    const float shift = isfinite(m_new) ? m_new : 0.f;
    const float corr = isfinite(m) ? exp2_approx(m - shift) : 0.f;
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sm[e] = exp2_approx(fmaf(sm[e], scale_log2, -shift));
      sum += sm[e];
    }
    l = l * corr + sum;
    fence_operand(acc[0]);
    fence_operand(acc[1]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] *= corr, acc[1][i] *= corr;
    tf32::stacked_fragments<N>(fr, sm);

    // V's chunk c of the tile, transposed (C^T, C^T_lo) for O_c += P V_c.
    mbar_wait(bars.out_full, j & 1);
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

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float denom = fmaxf(l, 1e-30f);
  if (row >= seq) return;
  if (c == 0 && t == 0) {
    lse[static_cast<int64_t>(bh) * seq + row] = ((isfinite(m) ? m : 0.f) + log2f(denom)) * kLn2;
  }
  float* out = o + (static_cast<int64_t>(bh) * seq + row) * head_dim + 256 * c + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int nn = 0; nn < 16; ++nn) {
      const float* a = acc[half];
      *reinterpret_cast<float2*>(out + 128 * half + 8 * nn) =
          make_float2((a[4 * nn] + a[4 * nn + 2]) / denom, (a[4 * nn + 1] + a[4 * nn + 3]) / denom);
    }
  }
}

template <bool kBf16>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                        int batch_heads, int seq, int head_dim, int causal, float scale_log2,
                        cudaStream_t stream) {
  using W = std::conditional_t<kBf16, WideChunkBf16, WideChunkF32>;
  using T = typename W::T;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err;
  if ((err = make_wide_map<T>(&q_map, q, head_dim, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_wide_map<T>(&k_map, k, head_dim, batch_heads, seq, W::kRows)) != cudaSuccess ||
      (err = make_wide_map<T>(&v_map, v, head_dim, batch_heads, seq, W::kRows)) != cudaSuccess) {
    return err;
  }
  constexpr size_t smem = W::kBytes;
  static_assert(smem <= 232448, "K1 above head_dim 256 needs more shared memory than a block has");
  const dim3 grid(batch_heads, (seq + W::kRows - 1) / W::kRows, head_dim / 256);
  if constexpr (kBf16) {
    if ((err = allow_smem(flash_fwd_bf16_wide_kernel, smem)) != cudaSuccess) return err;
    flash_fwd_bf16_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, head_dim,
        causal, scale_log2);
  } else {
    if ((err = allow_smem(flash_fwd_f32_wide_kernel, smem)) != cudaSuccess) return err;
    flash_fwd_f32_wide_kernel<<<grid, W::kThreads, smem, stream>>>(
        q_map, k_map, v_map, static_cast<float*>(o), static_cast<float*>(lse), seq, head_dim,
        causal, scale_log2);
  }
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
    default:  // 256 n, n >= 2, in chunks of 256 (the grid's z dimension)
      if (head_dim <= 256 || head_dim % 256 != 0 || head_dim / 256 > 65535) {
        return cudaErrorInvalidValue;
      }
      return hopper::launch_wide<kBf16>(q, k, v, o, lse, batch_heads, seq, head_dim, causal,
                                        scale_log2, stream);
  }
}

}  // namespace

// q, k, v, o: (batch_heads, seq, head_dim) contiguous and 16-byte aligned,
// head_dim 32, 64, 128 or a multiple of 256, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); lse: (batch_heads, seq)
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
