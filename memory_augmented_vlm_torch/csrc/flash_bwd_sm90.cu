// Flash-attention backward for training on Hopper (sm_90a): dQ and dK/dV
// with TMA-fed wgmma, bound to Python with ctypes.
//
// Replaces the TPU kernels of memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:
//   flash_bwd_dq_sm90   <- _backward's dq pallas_call (_dq_kernel)
//   flash_bwd_dkv_sm90  <- _backward's dk/dv pallas_call (_dkv_kernel)
// for bf16 inputs (fp32 runs the 3xTF32 kernels of flash_train.cu), and
// computes their function:
//   - the caller passes qs = q * scale * log2(e) rounded to bf16 (one
//     elementwise op per backward); s = qs k^T in log2 units;
//   - p = exp2(s - lse), zero where masked (keys >= kv_valid_len[b], and
//     above the diagonal when causal); ds = p * (dp - delta) * scale with
//     dp = dO v^T and delta = rowsum(dO * O) from the caller;
//   - p is rounded to bf16 before dV += p^T dO, and ds before dQ += ds K and
//     dK += ds^T Q (Q unscaled);
//   - GQA: query head h reads K/V head h / kv_groups. dK and dV of a KV head
//     are the fp32 sum over its group, in head order, cast once.
// Layout is bshd for q/qs/k/v/dO/dQ/dK/dV (the head dim contiguous, rows on
// 16 bytes) and (B, H, Sq) fp32 for lse and delta.
//
// What bounds them on the H100: arithmetic. Per (query, key) pair and head
// dim the train step's three attention kernels do 18 flops, and 14 of them
// are here: dQ recomputes q k^T and does dO v^T and ds K (6), dK/dV
// recomputes q k^T and does dO v^T, p^T dO and ds^T Q (8). At the LM's train
// shape (S = 9557, D = 64, 14 query heads over 2 KV heads, causal) that is
// 0.25 and 0.33 ms at the bf16 peak, while their bytes take 0.02 ms; at
// Gemma-2B's (the same S, D = 256, 8 query heads over one KV head) 0.57
// and 0.76 ms.
//
// The design, per kernel:
//   - work split: a block takes one item of a work list that the wrapper
//     builds once per shape (ops/flash_bwd.py): (batch, query head, tile),
//     longest loop first, so the blocks that run longest start first and
//     the short ones fill the tail. dQ's tile is 64 query rows (128 at
//     D = 128 and 256) and its loop runs over 64-key tiles; dK/dV's tile is 128 keys
//     (64 at D = 128) and its loop runs over 64-query tiles. The group of
//     query heads is split across items, so no item loops more than 150
//     times at the train shape (the group-per-block split ran 1050): each
//     dK/dV item writes fp32 partials (B, H, Skv, D) to a scratch the
//     wrapper allocates, and a second kernel sums every group in fixed head
//     order and casts once. No atomics anywhere, so two runs give the same
//     bits. (A cluster reducing through distributed shared memory would save
//     the 2 x 34 MB round trip, 0.04 ms at the train shape, but would tie G
//     blocks of one key tile together and bring back the load imbalance the
//     split removes.) The kernel cuts each loop at the valid length and the
//     causal diagonal itself: the list depends on shapes only.
//   - pipeline: one producer warp issues TMA loads (cp.async.bulk.tensor,
//     128-byte swizzle, tensor maps encoded on the host and passed as
//     __grid_constant__ parameters) into a two-stage ring tracked by
//     mbarriers (full: bytes landed; empty: every consumer warp is done);
//     the item's fixed operands (dQ: qs and dO; dK/dV: K and V) arrive once.
//     TMA zero-fills rows past the end of a tensor, so ragged tiles need no
//     masking of the loads.
//   - products: every product is a wgmma m64n64k16, bf16 in, fp32
//     accumulate, by consumer warpgroups of 64 rows each. dQ: S = qs K^T
//     and dP = dO V^T from shared memory, dQ += dS K with dS from
//     registers; dK/dV: S^T = K qs^T, dP^T = V dO^T, dV += P^T dO and
//     dK += dS^T Q. P and dS are rounded to bf16 in the accumulator
//     registers and fed back as the register A operand (the accumulator's
//     layout is the A fragment's). An operand needed transposed (K for dQ;
//     dO and Q for dK/dV) is read as an MN-major B operand from the same
//     swizzled tile, so no transposed copy is staged.
//   - overlap of the softmax with the products: a warpgroup waits for its
//     products before its elementwise work, so the tensor cores need
//     another warpgroup's products meanwhile. dQ (one warpgroup, 128
//     registers) runs three blocks per SM; dK/dV (two warpgroups, 160
//     registers, one block per SM) makes its warpgroups take turns to issue
//     their score products (named barriers), so one's softmax runs under
//     the other's products. Tiles wholly inside the mask skip the mask
//     arithmetic, and exp2 runs on the special-function unit.
//
// Head dim 256 (Gemma's LM: 8 query heads over one KV head), where a 64 x
// 256 fp32 accumulator is 128 registers a thread. ptxas gives a thread at
// most 168 in a block of nine warps or more (three share a quarter of the
// register file) and 255 in one of eight or fewer:
//   - dQ (bwd_dq_d256_kernel): one block per 128-row item, two warpgroups
//     of 64 rows and no producer (256 threads, 231 registers, 0 spilled,
//     no C7508/C7512/C7515/C7520). Each holds its whole 64 x 256 dQ (128
//     registers) beside S and dP (32 each). qs and dO of the item take 128
//     KB; each 64-key K and V tile (32 KB) is staged once for both
//     warpgroups, K in a ring of two slots (read by S and again by dQ += dS
//     K), V in a ring of one (read by dP alone): 224 KB. The last warp out
//     of a slot refills it. A warpgroup issues S, waits for V, issues dP,
//     waits for both, forms dS and adds dQ += dS K; the other warpgroup's
//     products fill the tensor cores meanwhile. Past its own causal
//     diagonal a warpgroup only counts itself out of the slots; one whose
//     rows all lie past Sq computes nothing. Per element the same k-steps in
//     the same order as the 64-row kernel, so the same bits.
//   Measured and rejected (NVIDIA H100 80GB HBM3, 700.00 W,
//   microbench/flash_ab.py, ms of ten calls back to back at (1, 9557, 8,
//   256), causal, GQA 8, where this design ran 0.931-0.932 and the
//   one-warpgroup 64-row kernel before it 0.990-1.007): ping-pong turns
//   around the score products (named barriers) 0.931-0.957 over three
//   calls, no gain; tile j - 1's dQ
//   product issued in the same turn as tile j's S and dP (234 registers, no
//   warning from ptxas) 2.00, and without turns 1.28. With the K/V refills
//   left out (a timing probe, wrong values) it ran 0.78: the rest is shared
//   memory, whose S and dP products read both operands (128 bytes a clock at
//   the tensor cores' rate, all an SM gives) beside TMA's K/V writes.
//   - dK/dV (bwd_dkv_split_sm90_kernel): one block per 64-key item, two
//     warpgroups and no producer (256 threads, 206 registers, 0 spilled).
//     Warpgroup w owns columns [128 w, 128 w + 128) of dK and dV: 64 + 64
//     accumulators. The query loop steps 32-row tiles through three 48 KB
//     stages (qs, dO, q) beside the resident K and V (64 KB); the last warp
//     to finish with a stage refills it by TMA (a shared-memory counter).
//     The warpgroups take turns to score: warpgroup j % 2 computes tile j's
//     S^T = K qs^T and dP^T = V dO^T once (wgmma m64n32k16, both operands
//     from shared memory), forms P^T and dS^T (dS from the fp32 P, then
//     rounded) and hands their bf16 A fragments to the other through a
//     16 KB exchange ([4][128] uint4 a warpgroup, no bank conflicts;
//     mbarriers full and empty). Each warpgroup then adds its half of dV +=
//     P^T dO and dK += dS^T Q for every tile, in ascending order: the other's
//     tile j - 1 is issued right after its own tile j's scores, so it runs
//     under the softmax gradient. 4 units of 64 x 64 x 256 products per
//     64-query span instead of the column-half design's 6, and the partials
//     keep their bits (per element the same k-steps in the same order; the
//     n32 score products give the n64 ones' bits). lse and delta are read
//     from global memory into registers before each tile's scores. The
//     partials and the group sum are as above: at Gemma-2B's train shape
//     the partials are 2 x 8 heads x S x 256 fp32, 157 MB.
//   Measured and rejected (NVIDIA H100 80GB HBM3, 700.00 W,
//   microbench/flash_ab.py's timing; ms of ten calls back to back at (1,
//   9557, 8, 256), causal, GQA 8, where the column-half design ran 2.68): a
//   producer warpgroup handing registers over by setmaxnreg (384 threads):
//   ptxas kept 168 registers, spilled 432 bytes and serialised wgmma (C7515):
//   10.5; the stage's lse and delta written by the refilling warp, whose
//   global reads stall a computing warpgroup: 2.06 (1.75 from registers); a
//   role split, warpgroup 0 holding K and warpgroup 1 holding V as register A
//   fragments (scores read a third of the shared memory): 255 registers and
//   two exchanges a tile, 2.29 (2.9 with the next tile's scores issued early,
//   which ptxas serialised); the next own tile's scores issued before the
//   current update lands (a wgmma group in flight across the loop's back
//   edge): ptxas serialises, 2.96; ping-pong turns around the score products:
//   1.80, no gain; qs not loaded (a timing probe): 1.93 against 2.06. With
//   the stage refills left out (a timing probe) it runs 1.52: the rest is the
//   n32 score products, which read 3 KB of shared memory per 16 clocks of
//   tensor work, above the 128 bytes a clock an SM gives.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dkv_group_sum.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

using mavlm::pack_bf16x2;
using namespace mavlm::sm90;

constexpr int kWgRows = 64;     // rows of one warpgroup's tile (wgmma M)
constexpr int kStepRows = 64;   // rows of the looped tile (dQ's keys, dK/dV's queries)

struct BwdParams {
  const float* lse;      // (B, H, Sq)
  const float* delta;    // (B, H, Sq)
  const int* valid_len;  // (B,)
  const int* items;      // (n_items, 3): batch, query head, tile
  void* out;             // dQ (bshd bf16), or dK partials (B, H, Skv, D) fp32
  void* out2;            // dV partials
  int H, Sq, Skv, kv_groups, causal;
  long long o_sb, o_ss, o_sh;  // dQ strides (elements)
  float scale;
};

// Named barriers 1 and 2 order the two consumer warpgroups' score products
// (ping-pong): a warpgroup waits for its turn, issues, and hands the turn
// over, so one warpgroup's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// acc[64 x D] += A(64 x 64, registers) . B, where B is a [64][D] tile read
// MN-major (its rows are the reduction dim), one n64 product per 64-column
// block.
template <int D>
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[D / 64][32],
                                                 const uint32_t (&a)[4][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      wgmma_rs_n64<1>(acc[cb], a[kk], desc_mnmajor(tile + cb * kStepRows * kRowBytes,
                                                   kStepRows, kk), 1);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void fence_all(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) reg_fence(acc[cb]);
}

// ---------------------------------------------------------------- dQ

constexpr int STAGES = 2;  // ring depth of both kernels' looped tiles

template <int D, int NWG>
struct DqShape {
  static constexpr int BM = NWG * kWgRows;  // query rows per item
  static constexpr int BN = kStepRows;      // keys per stage
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t BARS = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr size_t SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// One item: 64 NWG query rows of one head (a warpgroup per 64), looping
// over 64-key tiles up to the valid length and the causal diagonal. MINB:
// blocks an SM holds (registers are capped to fit them).
template <int D, int NWG, int MINB>
__global__ void __launch_bounds__(NWG * 128 + 32, MINB)
    bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_qs,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const BwdParams p) {
  using S = DqShape<D, NWG>;
  constexpr int CB = D / kSwzCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_qs = base, s_do = base + S::Q_BYTES, s_kv = base + 2 * S::Q_BYTES;
  const uint32_t q_bar = base + S::BARS, full0 = q_bar + 8, empty0 = full0 + 8 * STAGES;

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], m0 = item[2] * S::BM;
  const int hk = h / p.kv_groups;
  int kv_end = min(p.valid_len[b], p.Skv);
  if (p.causal) kv_end = min(kv_end, m0 + S::BM);
  const int n_iters = kv_end > 0 ? (kv_end + S::BN - 1) / S::BN : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0 && n_iters > 0) {
      mbar_arrive_tx(q_bar, 2 * S::Q_BYTES);
      for (int c = 0; c < CB; ++c) {
        tma_load(s_qs + c * S::BM * kRowBytes, &tm_qs, q_bar, c * kSwzCols, m0, h, b);
        tma_load(s_do + c * S::BM * kRowBytes, &tm_do, q_bar, c * kSwzCols, m0, h, b);
      }
      for (int j = 0; j < n_iters; ++j) {
        const int s = j % STAGES;
        const uint32_t k_tile = s_kv + 2 * s * S::KV_BYTES, v_tile = k_tile + S::KV_BYTES;
        mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_arrive_tx(full0 + 8 * s, 2 * S::KV_BYTES);
        for (int c = 0; c < CB; ++c) {
          tma_load(k_tile + c * S::BN * kRowBytes, &tm_k, full0 + 8 * s, c * kSwzCols,
                   j * S::BN, hk, b);
          tma_load(v_tile + c * S::BN * kRowBytes, &tm_v, full0 + 8 * s, c * kSwzCols,
                   j * S::BN, hk, b);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = m0 + wg * kWgRows + wl * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[idx] : INFINITY;  // p = 0 on rows past Sq
    dlt[r] = row < p.Sq ? p.delta[idx] : 0.f;
  }
  float acc[CB][32], sc[32], dp[32];
  zero<D>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  if (n_iters > 0) mbar_wait(q_bar, 0);
  for (int j = 0; j < n_iters; ++j) {
    const int s = j % STAGES;
    const uint32_t k_tile = s_kv + 2 * s * S::KV_BYTES, v_tile = k_tile + S::KV_BYTES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S = qs K^T
      wgmma_ss_n64(sc, desc_kmajor(s_qs, S::BM, wg * kWgRows, kk),
                   desc_kmajor(k_tile, S::BN, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO V^T
      wgmma_ss_n64(dp, desc_kmajor(s_do, S::BM, wg * kWgRows, kk),
                   desc_kmajor(v_tile, S::BN, 0, kk), kk);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);
    const int n0 = j * S::BN;
    if (n0 + S::BN <= kv_end && (!p.causal || n0 + S::BN - 1 <= m0 + wg * kWgRows)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // no key of the tile is masked for these rows
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(sc[i] - lse[r]) * (dp[i] - dlt[r]) * p.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // element i: row row0 + 8 r, key col
        const int r = (i >> 1) & 1;
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = col < kv_end && (!p.causal || col <= row0 + 8 * r);
        const float pr = ok ? fast_exp2(sc[i] - lse[r]) : 0.f;
        sc[i] = pr * (dp[i] - dlt[r]) * p.scale;
      }
    }
    uint32_t a[4][4];
    acc_to_a(sc, a);  // dS rounded to bf16
    wg_fence();
    mma_rows_by_tile<D>(acc, a, k_tile);  // dQ += dS K
    wg_commit();
    wg_wait_all();
    fence_all<D>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out = dq + (long long)row * p.o_ss + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16x2(acc[c / 8][4 * (c % 8) + 2 * r], acc[c / 8][4 * (c % 8) + 2 * r + 1]);
    }
  }
}

// dQ at head dim 256: an item is 128 query rows, two warpgroups of 64 rows
// each holding their whole 64 x 256 fp32 dQ (128 registers a thread), 256
// threads and no producer. Each staged 64-key K and V tile serves both
// warpgroups. K tiles sit in a ring of two slots (a K tile is read by S =
// qs K^T and again by dQ += dS K), V tiles in a ring of one (read by dP =
// dO V^T alone; two slots of each would take 256 KB); the last warp out of
// a slot refills it.
struct DqD256Shape {
  static constexpr int D = 256;
  static constexpr int BM = 2 * kWgRows;  // query rows per item
  static constexpr int BN = kStepRows;    // keys per K or V tile
  static constexpr int CB = D / kSwzCols;
  static constexpr int WARPS = 8;  // two warpgroups
  using Ring = KvRings<2, 1, BN, CB>;
  static constexpr uint32_t Q_BYTES = BM * D * 2;  // the item's qs, or its dO
  static constexpr uint32_t SLOT0 = 2 * Q_BYTES;   // K slots, then V's
  // a full barrier per slot, the q barrier, then a counter per slot
  static constexpr uint32_t BARS = SLOT0 + Ring::BYTES;
  static constexpr uint32_t COUNTERS = BARS + 8 * (Ring::SLOTS + 1);
  static constexpr size_t SMEM = COUNTERS + 4 * Ring::SLOTS + 1024;
  static_assert(SMEM <= 227 * 1024, "qs, dO and the rings fit one block's shared memory");
};

// One item: 128 query rows of one head, warpgroup w owning rows [64 w, 64 w
// + 64), looping over 64-key tiles up to the valid length and its own
// causal diagonal. The warpgroups run unsynchronised but for the slots:
// one's softmax gradient runs under the other's products.
__global__ void __launch_bounds__(2 * 128, 1)
    bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tm_qs,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const BwdParams p) {
  using S = DqD256Shape;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // `base` as a generic pointer
  const uint32_t s_qs = base, s_do = base + S::Q_BYTES;
  const uint32_t q_bar = base + S::BARS + 8 * S::Ring::SLOTS;  // after the slots' barriers

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], m0 = item[2] * S::BM;
  const int hk = h / p.kv_groups;
  const int kv_valid = min(p.valid_len[b], p.Skv);
  const int kv_end = p.causal ? min(kv_valid, m0 + S::BM) : kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  const int n_tiles =
      __shfl_sync(0xffffffffu, kv_end > 0 ? (kv_end + S::BN - 1) / S::BN : 0, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;

  const S::Ring kv{base + S::SLOT0, base + S::BARS,
                   reinterpret_cast<unsigned int*>(gbase + S::COUNTERS), &tm_k, &tm_v, hk, b};
  auto wait_tile = [&](int v, int j) { kv.wait(v, j); };
  // this warp is done with tile j of K or V, which all eight warps read
  auto done_with = [&](int v, int j) { kv.done_with<S::WARPS>(v, j, n_tiles); };

  if (threadIdx.x == 0) {
    kv.init();
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {  // qs and dO, and the first tiles of the rings
    mbar_arrive_tx(q_bar, 2 * S::Q_BYTES);
    for (int c = 0; c < S::CB; ++c) {
      tma_load(s_qs + c * S::BM * kRowBytes, &tm_qs, q_bar, c * kSwzCols, m0, h, b);
      tma_load(s_do + c * S::BM * kRowBytes, &tm_do, q_bar, c * kSwzCols, m0, h, b);
    }
    kv.load_first(n_tiles);
  }

  const int q_first = m0 + wg * kWgRows;  // this warpgroup's first row
  const int row0 = q_first + wl * 16 + g;  // this thread's rows: row0, row0 + 8
  // this warpgroup's key tiles: the block's, cut at its own diagonal; none
  // when its rows all lie past Sq
  const int wg_end = p.causal ? min(kv_valid, q_first + kWgRows) : kv_valid;
  const int my_tiles = __shfl_sync(
      0xffffffffu,
      q_first < p.Sq && wg_end > 0 ? min(n_tiles, (wg_end + S::BN - 1) / S::BN) : 0, 0);
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[idx] : INFINITY;  // p = 0 on rows past Sq
    dlt[r] = row < p.Sq ? p.delta[idx] : 0.f;
  }
  float acc[S::CB][32], sc[32], dp[32];
  zero<S::D>(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t a[4][4];

  auto issue_s = [&](int j) {  // S = qs K^T
#pragma unroll
    for (int kk = 0; kk < S::D / 16; ++kk) {
      wgmma_ss_n64(sc, desc_kmajor(s_qs, S::BM, wg * kWgRows, kk),
                   desc_kmajor(kv.tile(0, j), S::BN, 0, kk), kk);
    }
  };
  auto issue_dp = [&](int j) {  // dP = dO V^T
#pragma unroll
    for (int kk = 0; kk < S::D / 16; ++kk) {
      wgmma_ss_n64(dp, desc_kmajor(s_do, S::BM, wg * kWgRows, kk),
                   desc_kmajor(kv.tile(1, j), S::BN, 0, kk), kk);
    }
  };

  if (my_tiles > 0) mbar_wait(q_bar, 0);
  for (int j = 0; j < my_tiles; ++j) {
    wait_tile(0, j);
    wg_fence();
    issue_s(j);
    wg_commit();
    wait_tile(1, j);  // V lands later than K: its single slot frees later
    wg_fence();
    issue_dp(j);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);
    done_with(1, j);
    const int n0 = j * S::BN;
    if (n0 + S::BN <= wg_end && (!p.causal || n0 + S::BN - 1 <= q_first)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // no key of the tile is masked for these rows
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(sc[i] - lse[r]) * (dp[i] - dlt[r]) * p.scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // element i: row row0 + 8 r, key col
        const int r = (i >> 1) & 1;
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = col < wg_end && (!p.causal || col <= row0 + 8 * r);
        const float pr = ok ? fast_exp2(sc[i] - lse[r]) : 0.f;
        sc[i] = pr * (dp[i] - dlt[r]) * p.scale;
      }
    }
    acc_to_a(sc, a);  // dS rounded to bf16
    wg_fence();
    mma_rows_by_tile<S::D>(acc, a, kv.tile(0, j));  // dQ += dS K
    wg_commit();
    wg_wait_all();
    fence_all<S::D>(acc);
    done_with(0, j);
  }
  for (int j = my_tiles; j < n_tiles; ++j) {  // past this warpgroup's diagonal: count only
    wait_tile(0, j);
    done_with(0, j);
    wait_tile(1, j);
    done_with(1, j);
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out = dq + (long long)row * p.o_ss + 2 * t;
#pragma unroll
    for (int c = 0; c < S::D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16x2(acc[c / 8][4 * (c % 8) + 2 * r], acc[c / 8][4 * (c % 8) + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- dK / dV

template <int D, int NWG>
struct DkvShape {
  static constexpr int BN = NWG * kWgRows;  // keys per item
  static constexpr int BM = kStepRows;      // query rows per stage
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  // a stage: qs, q, dO tiles, then lse and delta of its rows
  static constexpr uint32_t STAGE = (3 * Q_BYTES + 2 * BM * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t BARS = 2 * KV_BYTES + STAGES * STAGE;
  static constexpr size_t SMEM = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// One item: BN keys of one query head's KV head (a warpgroup per 64),
// looping over 64-row query tiles from the causal diagonal to Sq. Writes
// this head's fp32 dK and dV partials for its keys. Two warpgroups take
// turns to issue their score products (ping-pong).
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_qs,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const BwdParams p) {
  constexpr bool PING = NWG == 2;
  using S = DkvShape<D, NWG>;
  constexpr int CB = D / kSwzCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // `base` as a generic pointer
  const uint32_t s_k = base, s_v = base + S::KV_BYTES, s_st = base + 2 * S::KV_BYTES;
  const uint32_t kv_bar = base + S::BARS, full0 = kv_bar + 8, empty0 = full0 + 8 * STAGES;

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], k0 = item[2] * S::BN;
  const int hk = h / p.kv_groups;
  const int kv_end = min(p.valid_len[b], p.Skv);
  const int m_first = p.causal ? k0 / S::BM : 0;
  const int m_tiles = (p.Sq + S::BM - 1) / S::BM;
  const int n_iters = (k0 < kv_end && m_tiles > m_first) ? m_tiles - m_first : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer's lanes
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (n_iters > 0) {
      if (lane == 0) {
        mbar_arrive_tx(kv_bar, 2 * S::KV_BYTES);
        for (int c = 0; c < CB; ++c) {
          tma_load(s_k + c * S::BN * kRowBytes, &tm_k, kv_bar, c * kSwzCols, k0, hk, b);
          tma_load(s_v + c * S::BN * kRowBytes, &tm_v, kv_bar, c * kSwzCols, k0, hk, b);
        }
      }
      const long long rows = ((long long)b * p.H + h) * p.Sq;
      for (int j = 0; j < n_iters; ++j) {
        const int s = j % STAGES, m0 = (m_first + j) * S::BM;
        const uint32_t stage = s_st + s * S::STAGE, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        float* sl = reinterpret_cast<float*>(gbase + (stage - base) + 3 * S::Q_BYTES);
        for (int r = lane; r < S::BM; r += 32) {  // lse = inf on rows past Sq: p = 0
          const int row = m0 + r;
          sl[r] = row < p.Sq ? p.lse[rows + row] : INFINITY;
          sl[S::BM + r] = row < p.Sq ? p.delta[rows + row] : 0.f;
        }
        if (lane == 0) {  // every lane arrives after its own stores
          mbar_arrive_tx(full, 3 * S::Q_BYTES);
          for (int c = 0; c < CB; ++c) {
            const uint32_t off = c * S::BM * kRowBytes;
            tma_load(stage + off, &tm_qs, full, c * kSwzCols, m0, h, b);
            tma_load(stage + S::Q_BYTES + off, &tm_q, full, c * kSwzCols, m0, h, b);
            tma_load(stage + 2 * S::Q_BYTES + off, &tm_do, full, c * kSwzCols, m0, h, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + wg * kWgRows + wl * 16 + g;  // this thread's keys: key0, key0 + 8
  float dk[CB][32], dv[CB][32], st[32], dpt[32];
  zero<D>(dk);
  zero<D>(dv);
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  if (n_iters > 0) mbar_wait(kv_bar, 0);
  if (PING && wg == 1 && n_iters > 0) turn_pass(wg);  // warpgroup 0 goes first
  for (int j = 0; j < n_iters; ++j) {
    const int s = j % STAGES, m0 = (m_first + j) * S::BM;
    const uint32_t stage = s_st + s * S::STAGE;
    const uint32_t s_q = stage + S::Q_BYTES, s_do = stage + 2 * S::Q_BYTES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    if (PING) turn_wait(wg);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K qs^T
      wgmma_ss_n64(st, desc_kmajor(s_k, S::BN, wg * kWgRows, kk),
                   desc_kmajor(stage, S::BM, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V dO^T
      wgmma_ss_n64(dpt, desc_kmajor(s_v, S::BN, wg * kWgRows, kk),
                   desc_kmajor(s_do, S::BM, 0, kk), kk);
    }
    wg_commit();
    if (PING && (wg == 0 || j + 1 < n_iters)) turn_pass(wg);
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);
    const float* sl = reinterpret_cast<const float*>(gbase + (stage - base) + 3 * S::Q_BYTES);
    const int key_lo = k0 + wg * kWgRows;
    const bool inside = key_lo + kWgRows <= kv_end && (!p.causal || key_lo + kWgRows - 1 <= m0);
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // element 4c + e: key key0 + 8 (e >> 1), query column
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * c + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(sl + S::BM + 8 * c + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        const float lse = (e & 1) ? l2.y : l2.x, dlt = (e & 1) ? d2.y : d2.x;
        float pr;
        if (inside) {  // no pair of the tile is masked for these keys
          pr = fast_exp2(st[i] - lse);
        } else {
          const int key = key0 + 8 * (e >> 1), query = m0 + 8 * c + 2 * t + (e & 1);
          const bool ok = key < kv_end && (!p.causal || key <= query);
          pr = ok ? fast_exp2(st[i] - lse) : 0.f;
        }
        st[i] = pr;
        dpt[i] = pr * (dpt[i] - dlt) * p.scale;
      }
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(st, pa);   // P^T rounded to bf16
    acc_to_a(dpt, da);  // dS^T rounded to bf16
    wg_fence();
    mma_rows_by_tile<D>(dv, pa, s_do);  // dV += P^T dO
    mma_rows_by_tile<D>(dk, da, s_q);   // dK += dS^T Q
    wg_commit();
    wg_wait_all();
    fence_all<D>(dv);
    fence_all<D>(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  const long long head = ((long long)b * p.H + h) * p.Skv;
  float* dkp = static_cast<float*>(p.out) + head * D;
  float* dvp = static_cast<float*>(p.out2) + head * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const long long off = (long long)key * D + 8 * c + 2 * t;
      const int i = 4 * (c % 8) + 2 * r;
      *reinterpret_cast<float2*>(dkp + off) = make_float2(dk[c / 8][i], dk[c / 8][i + 1]);
      *reinterpret_cast<float2*>(dvp + off) = make_float2(dv[c / 8][i], dv[c / 8][i + 1]);
    }
  }
}

// dK/dV at head dim 256, where a warpgroup holds one column half of dK and
// dV (64 + 64 accumulator registers a thread): one block per 64-key item,
// two warpgroups (warpgroup w owns columns [128 w, 128 w + 128)) and no
// producer: the last warp to finish with a stage refills it. The query loop
// steps 32 rows a stage; the warpgroups take turns to score them:
// warpgroup j % 2 computes tile j's S^T and dP^T (m64n32) once, forms P^T
// and dS^T, and passes their bf16 A fragments to the other through shared
// memory; each then adds its half of dV += P^T dO and dK += dS^T Q.
template <int D>
struct DkvSplitShape {
  static constexpr int DH = D / 2;          // output columns of a warpgroup
  static constexpr int BN = kWgRows;        // keys per item
  static constexpr int BM = 32;             // query rows per stage
  static constexpr int STAGES = 3;
  static constexpr int WARPS = 8;           // two warpgroups
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2;  // a full-width tile of BM query rows
  static constexpr uint32_t STAGE = 3 * Q_BYTES;   // qs, dO, q
  // a scored tile's fragments: P^T's two k-steps, then dS^T's, one uint4
  // of each per thread of a warpgroup, laid out [4][128] (no bank conflicts)
  static constexpr uint32_t X_BYTES = 4 * 128 * 16;
  static constexpr uint32_t XBUF = 2 * KV_BYTES + STAGES * STAGE;  // one slot per warpgroup
  static constexpr uint32_t BARS = XBUF + 2 * X_BYTES;
  // kv, full[STAGES], xfull[2], xempty[2], then the stages' counters
  static constexpr uint32_t COUNTERS = BARS + 8 * (1 + STAGES + 4);
  static constexpr size_t SMEM = COUNTERS + 4 * STAGES + 1024;
  static_assert(DH % 64 == 0 && Q_BYTES % 1024 == 0, "1024-byte aligned swizzled blocks");
  static_assert(SMEM <= 227 * 1024, "one block's shared memory");
};

// One item: 64 keys of one query head's KV head, looping over 32-row query
// tiles from the causal diagonal to Sq; writes this head's fp32 dK and dV
// partials for its keys.
template <int D>
__global__ void __launch_bounds__(2 * 128, 1)
    bwd_dkv_split_sm90_kernel(const __grid_constant__ CUtensorMap tm_qs,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const BwdParams p) {
  using S = DkvSplitShape<D>;
  constexpr int CB = D / kSwzCols, CBH = S::DH / kSwzCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // `base` as a generic pointer
  const uint32_t s_k = base, s_v = base + S::KV_BYTES, s_st = base + 2 * S::KV_BYTES;
  const uint32_t kv_bar = base + S::BARS, full0 = kv_bar + 8, xfull0 = full0 + 8 * S::STAGES;
  const uint32_t xempty0 = xfull0 + 16;
  unsigned int* counters = reinterpret_cast<unsigned int*>(gbase + S::COUNTERS);

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], k0 = item[2] * S::BN;
  const int hk = h / p.kv_groups;
  const int kv_end = min(p.valid_len[b], p.Skv);
  const int m_first = p.causal ? k0 / S::BM : 0;
  const int m_tiles = (p.Sq + S::BM - 1) / S::BM;
  // the item's query tiles, seen as uniform (wgmma behind a branch on a
  // value ptxas cannot prove warp-uniform is serialised)
  const int n_iters = __shfl_sync(
      0xffffffffu, (k0 < kv_end && m_tiles > m_first) ? m_tiles - m_first : 0, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const long long rows = ((long long)b * p.H + h) * p.Sq;

  // tile j's qs, dO and q into its stage (one thread)
  auto load = [&](int j) {
    const int s = j % S::STAGES, m0 = (m_first + j) * S::BM;
    const uint32_t stage = s_st + s * S::STAGE, full = full0 + 8 * s;
    mbar_arrive_tx(full, S::STAGE);
    for (int c = 0; c < CB; ++c) {
      const uint32_t off = c * S::BM * kRowBytes;
      tma_load(stage + off, &tm_qs, full, c * kSwzCols, m0, h, b);
      tma_load(stage + S::Q_BYTES + off, &tm_do, full, c * kSwzCols, m0, h, b);
      tma_load(stage + 2 * S::Q_BYTES + off, &tm_q, full, c * kSwzCols, m0, h, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      counters[s] = 0;
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(xfull0 + 8 * w, 128);   // the scoring warpgroup's threads
      mbar_init(xempty0 + 8 * w, 128);  // the other's
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_iters > 0) {  // K and V, and the first stages
    mbar_arrive_tx(kv_bar, 2 * S::KV_BYTES);
    for (int c = 0; c < CB; ++c) {
      tma_load(s_k + c * S::BN * kRowBytes, &tm_k, kv_bar, c * kSwzCols, k0, hk, b);
      tma_load(s_v + c * S::BN * kRowBytes, &tm_v, kv_bar, c * kSwzCols, k0, hk, b);
    }
    for (int j = 0; j < min(n_iters, S::STAGES); ++j) load(j);
  }

  const int key0 = k0 + wl * 16 + g;  // this thread's keys: key0, key0 + 8
  float dk[CBH][32], dv[CBH][32], st[16], dpt[16];
  zero<S::DH>(dk);
  zero<S::DH>(dv);
  uint32_t pa[2][4], da[2][4];  // the fragments of a tile this warpgroup scored
  uint32_t xa[2][4], xd[2][4];  // the other's
  const bool diag_free = k0 + S::BN <= kv_end;  // no key of the item is past the valid length

  auto stage_of = [&](int j) { return s_st + (j % S::STAGES) * S::STAGE; };
  auto xslot = [&](int owner) {
    return reinterpret_cast<uint4*>(gbase + S::XBUF + owner * S::X_BYTES);
  };
  auto wait_tile = [&](int j) { mbar_wait(full0 + 8 * (j % S::STAGES), (j / S::STAGES) & 1); };
  // this warp is done with tile j's stage: the last of the eight refills it
  auto done_with = [&](int j) {
    if (last_out<S::WARPS>(counters + j % S::STAGES) && lane == 0 && j + S::STAGES < n_iters) {
      load(j + S::STAGES);
    }
  };
  // lse and delta of this thread's query columns of tile j (element 4c + e
  // takes row 2c + (e & 1)), read before its scores so that the loads land
  // under the products; lse = inf on rows past Sq: p = 0
  float lse_r[S::BM / 4], dlt_r[S::BM / 4];
  auto rows_of = [&](int j) {
    const int m0 = (m_first + j) * S::BM;
#pragma unroll
    for (int c = 0; c < S::BM / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * c + 2 * t + e;
        lse_r[2 * c + e] = row < p.Sq ? p.lse[rows + row] : INFINITY;
        dlt_r[2 * c + e] = row < p.Sq ? p.delta[rows + row] : 0.f;
      }
    }
  };
  // tile j's S^T = K qs^T and dP^T = V dO^T, one commit group
  auto scores = [&](int j) {
    const uint32_t stage = stage_of(j);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n32(st, desc_kmajor(s_k, S::BN, 0, kk), desc_kmajor(stage, S::BM, 0, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n32(dpt, desc_kmajor(s_v, S::BN, 0, kk),
                   desc_kmajor(stage + S::Q_BYTES, S::BM, 0, kk), kk);
    }
    wg_commit();
  };
  // P^T and dS^T of tile j from its scores, rounded to bf16 into pa and da
  auto probs = [&](int j) {
    const int m0 = (m_first + j) * S::BM;
    const bool inside = diag_free && (!p.causal || k0 + S::BN - 1 <= m0);
#pragma unroll
    for (int c = 0; c < S::BM / 8; ++c) {  // element 4c + e: key key0 + 8 (e >> 1), query column
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        const float lse = lse_r[2 * c + (e & 1)], dlt = dlt_r[2 * c + (e & 1)];
        float pr;
        if (inside) {  // no pair of the tile is masked for these keys
          pr = fast_exp2(st[i] - lse);
        } else {
          const int key = key0 + 8 * (e >> 1), query = m0 + 8 * c + 2 * t + (e & 1);
          const bool ok = key < kv_end && (!p.causal || key <= query);
          pr = ok ? fast_exp2(st[i] - lse) : 0.f;
        }
        st[i] = pr;
        dpt[i] = pr * (dpt[i] - dlt) * p.scale;
      }
    }
    acc_to_a(st, pa);   // P^T rounded to bf16
    acc_to_a(dpt, da);  // dS^T rounded to bf16
  };
  // this warpgroup's tile j's fragments to its slot, for the other
  auto publish = [&](int j) {
    mbar_wait(xempty0 + 8 * wg, ((j >> 1) & 1) ^ 1);
    uint4* x = xslot(wg);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      x[kk * 128 + tid] = make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
      x[(2 + kk) * 128 + tid] = make_uint4(da[kk][0], da[kk][1], da[kk][2], da[kk][3]);
    }
    mbar_arrive(xfull0 + 8 * wg);
  };
  // the other warpgroup's tile j's fragments from its slot
  auto fetch = [&](int j) {
    const int owner = j & 1;
    mbar_wait(xfull0 + 8 * owner, (j >> 1) & 1);
    const uint4* x = xslot(owner);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 fa = x[kk * 128 + tid], fd = x[(2 + kk) * 128 + tid];
      xa[kk][0] = fa.x; xa[kk][1] = fa.y; xa[kk][2] = fa.z; xa[kk][3] = fa.w;
      xd[kk][0] = fd.x; xd[kk][1] = fd.y; xd[kk][2] = fd.z; xd[kk][3] = fd.w;
    }
    mbar_arrive(xempty0 + 8 * owner);
  };
  // dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half] for
  // tile j, one commit group
  auto update = [&](const uint32_t (&fp)[2][4], const uint32_t (&fd)[2][4], int j) {
    const uint32_t stage = stage_of(j);
    const uint32_t s_do = stage + S::Q_BYTES + wg * CBH * S::BM * kRowBytes;
    const uint32_t s_q = stage + 2 * S::Q_BYTES + wg * CBH * S::BM * kRowBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int cb = 0; cb < CBH; ++cb) {
        wgmma_rs_n64<1>(dv[cb], fp[kk], desc_mnmajor(s_do + cb * S::BM * kRowBytes, S::BM, kk),
                        1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int cb = 0; cb < CBH; ++cb) {
        wgmma_rs_n64<1>(dk[cb], fd[kk], desc_mnmajor(s_q + cb * S::BM * kRowBytes, S::BM, kk),
                        1);
      }
    }
    wg_commit();
  };

  // Warpgroup 0 scores tile 0 alone; then at each step j a warpgroup scores
  // its tile j, adds the other's tile j - 1 while its softmax gradient runs
  // (the scores' wait leaves that update on the tensor cores), then adds
  // tile j; the other's last tile, if any, comes after the loop. The
  // updates keep ascending tile order, so each partial sums its query
  // tiles in the order of the single-warpgroup kernel.
  if (n_iters > 0) mbar_wait(kv_bar, 0);
  if (wg == 0 && n_iters > 0) {
    rows_of(0);
    wait_tile(0);
    scores(0);
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);
    probs(0);
    publish(0);
    update(pa, da, 0);
    wg_wait_all();
    fence_all<S::DH>(dv);
    fence_all<S::DH>(dk);
    done_with(0);
  }
  for (int j = 2 - wg; j < n_iters; j += 2) {
    rows_of(j);
    wait_tile(j);
    scores(j);
    fetch(j - 1);
    update(xa, xd, j - 1);
    wg_wait<1>();
    reg_fence(st);
    reg_fence(dpt);
    probs(j);
    publish(j);
    update(pa, da, j);
    wg_wait_all();
    fence_all<S::DH>(dv);
    fence_all<S::DH>(dk);
    done_with(j - 1);
    done_with(j);
  }
  if (n_iters > 0 && ((n_iters - 1) & 1) != wg) {  // the other's last tile
    fetch(n_iters - 1);
    update(xa, xd, n_iters - 1);
    wg_wait_all();
    fence_all<S::DH>(dv);
    fence_all<S::DH>(dk);
    done_with(n_iters - 1);
  }

  const long long head = ((long long)b * p.H + h) * p.Skv;
  const int col0 = wg * S::DH;
  float* dkp = static_cast<float*>(p.out) + head * D + col0;
  float* dvp = static_cast<float*>(p.out2) + head * D + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < S::DH / 8; ++c) {
      const long long off = (long long)key * D + 8 * c + 2 * t;
      const int i = 4 * (c % 8) + 2 * r;
      *reinterpret_cast<float2*>(dkp + off) = make_float2(dk[c / 8][i], dk[c / 8][i + 1]);
      *reinterpret_cast<float2*>(dvp + off) = make_float2(dv[c / 8][i], dv[c / 8][i + 1]);
    }
  }
}

// --------------------------------------------------------------- host

BwdParams make_params(const void* lse, const void* delta, const void* valid_len,
                      const void* items, int H, int Sq, int Skv, int kv_groups, int causal,
                      float scale) {
  BwdParams p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.valid_len = static_cast<const int*>(valid_len);
  p.items = static_cast<const int*>(items);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_groups = kv_groups;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// The configuration each head dim runs (the wrapper's work list uses the
// same tiles; flash_bwd_tiles reports them). dQ: consumer warpgroups (64
// query rows each) and blocks per SM; dK/dV: consumer warpgroups (64 keys
// each). At D = 64 dQ runs three one-warpgroup blocks per SM, so three
// independent items interleave their products and softmax; at D = 128 its
// accumulators need the registers of one two-warpgroup block; D = 256 has
// a kernel of its own (DqD256Shape: two warpgroups over 128-row items, no
// producer). dK/dV keeps one warpgroup at D = 128, for registers, and at
// 256 splits the columns between two warpgroups (DkvSplitShape).
template <int D>
struct DqConfig {
  static constexpr int NWG = D == 128 ? 2 : 1, MINB = D == 64 ? 3 : 1;
};
template <int D>
struct DkvConfig {
  static constexpr int NWG = D == 64 ? 2 : 1;
};

template <int D>
int run_dq(const void* qs, const void* k, const void* v, const void* dout, void* dq,
           const BwdParams& params, int n_items, int B, int Sq, int Skv, int H, int kv_groups,
           const long long* qs_strides, const long long* k_strides,
           const long long* v_strides, const long long* d_strides, cudaStream_t stream) {
  using C = DqConfig<D>;
  using S = DqShape<D, C::NWG>;
  const int Hkv = H / kv_groups;
  CUtensorMap m[4];
  if (!make_map(&m[0], qs, D, Sq, H, B, qs_strides, S::BM) ||
      !make_map(&m[1], dout, D, Sq, H, B, d_strides, S::BM) ||
      !make_map(&m[2], k, D, Skv, Hkv, B, k_strides, S::BN) ||
      !make_map(&m[3], v, D, Skv, Hkv, B, v_strides, S::BN)) {
    return kTmaRejected;
  }
  BwdParams p = params;
  p.out = dq;
  const auto kernel = bwd_dq_sm90_kernel<D, C::NWG, C::MINB>;
  const int rc = set_smem(kernel, S::SMEM);
  if (rc != 0) return rc;
  kernel<<<n_items, C::NWG * 128 + 32, S::SMEM, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// dQ at D = 256: one block per 128-row item (bwd_dq_d256_kernel).
int run_dq_d256(const void* qs, const void* k, const void* v, const void* dout, void* dq,
                const BwdParams& params, int n_items, int B, int Sq, int Skv, int H,
                int kv_groups, const long long* qs_strides, const long long* k_strides,
                const long long* v_strides, const long long* d_strides, cudaStream_t stream) {
  using S = DqD256Shape;
  const int Hkv = H / kv_groups;
  CUtensorMap m[4];
  if (!make_map(&m[0], qs, S::D, Sq, H, B, qs_strides, S::BM) ||
      !make_map(&m[1], dout, S::D, Sq, H, B, d_strides, S::BM) ||
      !make_map(&m[2], k, S::D, Skv, Hkv, B, k_strides, S::BN) ||
      !make_map(&m[3], v, S::D, Skv, Hkv, B, v_strides, S::BN)) {
    return kTmaRejected;
  }
  BwdParams p = params;
  p.out = dq;
  const int rc = set_smem(bwd_dq_d256_kernel, S::SMEM);
  if (rc != 0) return rc;
  bwd_dq_d256_kernel<<<n_items, 2 * 128, S::SMEM, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dkv(const void* qs, const void* q, const void* k, const void* v, const void* dout,
            void* dk_part, void* dv_part, void* dk, void* dv, const BwdParams& params,
            int n_items, int B, int Sq, int Skv, int H, int kv_groups,
            const long long* qs_strides, const long long* q_strides,
            const long long* k_strides, const long long* v_strides,
            const long long* d_strides, const long long* dkv_strides, cudaStream_t stream) {
  constexpr int NWG = DkvConfig<D>::NWG;
  using S = DkvShape<D, NWG>;
  const int Hkv = H / kv_groups;
  CUtensorMap m[5];
  if (!make_map(&m[0], qs, D, Sq, H, B, qs_strides, S::BM) ||
      !make_map(&m[1], q, D, Sq, H, B, q_strides, S::BM) ||
      !make_map(&m[2], dout, D, Sq, H, B, d_strides, S::BM) ||
      !make_map(&m[3], k, D, Skv, Hkv, B, k_strides, S::BN) ||
      !make_map(&m[4], v, D, Skv, Hkv, B, v_strides, S::BN)) {
    return kTmaRejected;
  }
  BwdParams p = params;
  p.out = dk_part;
  p.out2 = dv_part;
  const auto kernel = bwd_dkv_sm90_kernel<D, NWG>;
  const int rc = set_smem(kernel, S::SMEM);
  if (rc != 0) return rc;
  kernel<<<n_items, NWG * 128 + 32, S::SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], p);
  return mavlm::launch_group_sum<__nv_bfloat16>(dk_part, dv_part, dk, dv, B, Hkv, kv_groups,
                                                Skv, D, dkv_strides, stream);
}

// dK/dV at D = 256: one block per 64-key item (bwd_dkv_split_sm90_kernel),
// then the group sum.
template <int D>
int run_dkv_split(const void* qs, const void* q, const void* k, const void* v,
                  const void* dout, void* dk_part, void* dv_part, void* dk, void* dv,
                  const BwdParams& params, int n_items, int B, int Sq, int Skv, int H,
                  int kv_groups, const long long* qs_strides, const long long* q_strides,
                  const long long* k_strides, const long long* v_strides,
                  const long long* d_strides, const long long* dkv_strides,
                  cudaStream_t stream) {
  using S = DkvSplitShape<D>;
  const int Hkv = H / kv_groups;
  CUtensorMap m[5];
  if (!make_map(&m[0], qs, D, Sq, H, B, qs_strides, S::BM) ||
      !make_map(&m[1], q, D, Sq, H, B, q_strides, S::BM) ||
      !make_map(&m[2], dout, D, Sq, H, B, d_strides, S::BM) ||
      !make_map(&m[3], k, D, Skv, Hkv, B, k_strides, S::BN) ||
      !make_map(&m[4], v, D, Skv, Hkv, B, v_strides, S::BN)) {
    return kTmaRejected;
  }
  BwdParams p = params;
  p.out = dk_part;
  p.out2 = dv_part;
  const auto kernel = bwd_dkv_split_sm90_kernel<D>;
  const int rc = set_smem(kernel, S::SMEM);
  if (rc != 0) return rc;
  kernel<<<n_items, 2 * 128, S::SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], p);
  return mavlm::launch_group_sum<__nv_bfloat16>(dk_part, dv_part, dk, dv, B, Hkv, kv_groups,
                                                Skv, D, dkv_strides, stream);
}

}  // namespace

// bf16 only; strides are (batch, sequence, head) in elements, the head dim
// contiguous. `items` is the wrapper's work list, (n_items, 3) int32. Each
// function returns 0, a cudaError_t, -1 for a head dim it was not built
// for, or -4 when a tensor map is refused (kernel_error_string, in
// flash_fwd.cu, names the code).

// The tiles of the work items at a head dim: dQ items take dq_rows query
// rows and loop over dq_keys-key tiles; dK/dV items take dkv_keys keys and
// loop over dkv_rows-row query tiles.
extern "C" int flash_bwd_tiles(int head_dim, int* dq_rows, int* dq_keys, int* dkv_rows,
                               int* dkv_keys) {
  switch (head_dim) {
    case 64:
      *dq_rows = DqConfig<64>::NWG * kWgRows;
      *dkv_keys = DkvConfig<64>::NWG * kWgRows;
      break;
    case 128:
      *dq_rows = DqConfig<128>::NWG * kWgRows;
      *dkv_keys = DkvConfig<128>::NWG * kWgRows;
      break;
    case 256:
      *dq_rows = DqD256Shape::BM;
      *dkv_keys = DkvSplitShape<256>::BN;
      *dkv_rows = DkvSplitShape<256>::BM;
      *dq_keys = kStepRows;
      return 0;
    default:
      return -1;
  }
  *dq_keys = kStepRows;
  *dkv_rows = kStepRows;
  return 0;
}

// dq (B, Sq, H, D) is written.
extern "C" int flash_bwd_dq_sm90(int head_dim, const void* qs, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, const void* valid_len, const void* items,
                                 int n_items, int B, int Sq, int Skv, int H, int kv_groups,
                                 int causal, const long long* qs_strides,
                                 const long long* k_strides, const long long* v_strides,
                                 const long long* d_strides, const long long* dq_strides,
                                 float scale, void* stream) {
  BwdParams p = make_params(lse, delta, valid_len, items, H, Sq, Skv, kv_groups, causal, scale);
  p.o_sb = dq_strides[0];
  p.o_ss = dq_strides[1];
  p.o_sh = dq_strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return run_dq<64>(qs, k, v, dout, dq, p, n_items, B, Sq, Skv, H, kv_groups, qs_strides,
                      k_strides, v_strides, d_strides, s);
  }
  if (head_dim == 128) {
    return run_dq<128>(qs, k, v, dout, dq, p, n_items, B, Sq, Skv, H, kv_groups, qs_strides,
                       k_strides, v_strides, d_strides, s);
  }
  if (head_dim == 256) {
    return run_dq_d256(qs, k, v, dout, dq, p, n_items, B, Sq, Skv, H, kv_groups, qs_strides,
                       k_strides, v_strides, d_strides, s);
  }
  return -1;
}

// dk and dv (B, Skv, H / kv_groups, D), with the strides of dk, are written;
// dk_part and dv_part are fp32 scratch of (B, H, Skv, D), contiguous.
extern "C" int flash_bwd_dkv_sm90(int head_dim, const void* qs, const void* q, const void* k,
                                  const void* v, const void* dout, const void* lse,
                                  const void* delta, void* dk_part, void* dv_part, void* dk,
                                  void* dv, const void* valid_len, const void* items,
                                  int n_items, int B, int Sq, int Skv, int H, int kv_groups,
                                  int causal, const long long* qs_strides,
                                  const long long* q_strides, const long long* k_strides,
                                  const long long* v_strides, const long long* d_strides,
                                  const long long* dkv_strides, float scale, void* stream) {
  const BwdParams p =
      make_params(lse, delta, valid_len, items, H, Sq, Skv, kv_groups, causal, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return run_dkv<64>(
        qs, q, k, v, dout, dk_part, dv_part, dk, dv, p, n_items, B, Sq, Skv, H, kv_groups,
        qs_strides, q_strides, k_strides, v_strides, d_strides, dkv_strides, s);
  }
  if (head_dim == 128) {
    return run_dkv<128>(
        qs, q, k, v, dout, dk_part, dv_part, dk, dv, p, n_items, B, Sq, Skv, H, kv_groups,
        qs_strides, q_strides, k_strides, v_strides, d_strides, dkv_strides, s);
  }
  if (head_dim == 256) {
    return run_dkv_split<256>(
        qs, q, k, v, dout, dk_part, dv_part, dk, dv, p, n_items, B, Sq, Skv, H, kv_groups,
        qs_strides, q_strides, k_strides, v_strides, d_strides, dkv_strides, s);
  }
  return -1;
}
