// Flash-attention backward for training on Hopper (sm_90a): dQ and dK/dV
// with TMA-fed wgmma, bound to Python with ctypes.
//
// Replaces the TPU kernels of memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:
//   flash_bwd_dq_sm90   <- _backward's dq pallas_call (_dq_kernel)
//   flash_bwd_dkv_sm90  <- _backward's dk/dv pallas_call (_dkv_kernel)
// for bf16 inputs (fp32 parity runs keep the SIMT kernels of
// flash_train.cu), and computes their function:
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
// 0.25 and 0.33 ms at the bf16 peak, while their bytes take 0.02 ms.
//
// The design, per kernel:
//   - work split: a block takes one item of a work list that the wrapper
//     builds once per shape (ops/flash_bwd.py): (batch, query head, tile),
//     longest loop first, so the blocks that run longest start first and
//     the short ones fill the tail. dQ's tile is 64 query rows (128 at
//     D = 128) and its loop runs over 64-key tiles; dK/dV's tile is 128 keys
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// dK and dV (B, Skv, Hkv, D) from the partials (B, H, Skv, D): each group's
// G heads summed in head order in fp32, cast to bf16 once.
__global__ void dkv_group_sum_kernel(const float* dk_part, const float* dv_part,
                                     __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int Hkv,
                                     int G, int Skv, int D, long long o_sb, long long o_ss,
                                     long long o_sh) {
  const int d4s = D / 4;
  const long long n = (long long)B * Hkv * Skv * d4s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d4 = i % d4s;
    long long rest = i / d4s;
    const int key = rest % Skv;
    rest /= Skv;
    const int hk = rest % Hkv, b = rest / Hkv;
    const long long head = (long long)Skv * D;
    const long long src = (((long long)b * Hkv + hk) * G * Skv + key) * D + 4 * d4;
    float4 a = *reinterpret_cast<const float4*>(dk_part + src);
    float4 c = *reinterpret_cast<const float4*>(dv_part + src);
    for (int gi = 1; gi < G; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(dk_part + src + gi * head);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + src + gi * head);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    const long long dst = b * o_sb + key * o_ss + hk * o_sh + 4 * d4;
    uint2 pk = make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
    uint2 pv = make_uint2(pack_bf16x2(c.x, c.y), pack_bf16x2(c.z, c.w));
    *reinterpret_cast<uint2*>(dk + dst) = pk;
    *reinterpret_cast<uint2*>(dv + dst) = pv;
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
// accumulators need the registers of one two-warpgroup block. dK/dV keeps
// one warpgroup at D = 128, for registers.
template <int D>
struct DqConfig {
  static constexpr int NWG = D == 64 ? 1 : 2, MINB = D == 64 ? 3 : 1;
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
  int rc = set_smem(kernel, S::SMEM);
  if (rc != 0) return rc;
  kernel<<<n_items, NWG * 128 + 32, S::SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n = (long long)B * Hkv * Skv * (D / 4);
  const int threads = 256;
  const int blocks = static_cast<int>(n / threads + 1 < 132 * 16 ? n / threads + 1 : 132 * 16);
  dkv_group_sum_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, Hkv, kv_groups, Skv,
      D, dkv_strides[0], dkv_strides[1], dkv_strides[2]);
  return static_cast<int>(cudaGetLastError());
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
  if (head_dim != 64 && head_dim != 128) return -1;
  *dq_rows = (head_dim == 64 ? DqConfig<64>::NWG : DqConfig<128>::NWG) * kWgRows;
  *dq_keys = kStepRows;
  *dkv_rows = kStepRows;
  *dkv_keys = (head_dim == 64 ? DkvConfig<64>::NWG : DkvConfig<128>::NWG) * kWgRows;
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
  return -1;
}
