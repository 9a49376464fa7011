// Flash attention for training, bound to Python with ctypes: the C entry
// points of the forward that saves the log-sum-exp and of the fp32 backward,
// and the fp32 backward's kernels. The forward is #1's kernel with an lse
// epilogue (bf16: flash_fwd_sm90.cu's, flash_fwd_wide_sm90.cu's at 256;
// fp32: flash_fwd.cu's 3xTF32 kernel); the bf16 backward kernels are in
// flash_bwd_sm90.cu.
//
// Replaces the TPU kernels of memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:
//   flash_fwd_lse  <- _forward_with_lse (_fwd_lse_kernel)
//   flash_bwd_dq   <- _backward's dq pallas_call (_dq_kernel), fp32
//   flash_bwd_dkv  <- _backward's dk/dv pallas_call (_dkv_kernel), fp32
// and computes their function:
//   - q is scaled by scale*log2(e) and rounded to the input dtype before QK^T;
//     the softmax is base 2 and the saved lse is in log2 units,
//     lse = m + log2(max(l, 1e-30)) (-inf for a row that sees no key);
//   - masked positions are keys >= kv_valid_len[b], and above the diagonal
//     when causal: the TPU forward gives their scores the finite MASK_VALUE,
//     the kernels -inf (the same out and lse on every row that sees a key);
//     the backward zeroes p there;
//   - p = exp2(s - lse); ds = p * (dp - delta) * scale, in raw-score units,
//     with delta = rowsum(dO * O) computed by the caller;
//   - dQ = ds K, dV = p^T dO, dK = ds^T Q (Q unscaled);
//   - GQA is native: query head h reads K/V head h / kv_groups, and dK/dV
//     of a KV head sum over its whole group; the result is deterministic
//     (no atomics: two runs give the same bits).
// Layout is bshd for q/k/v/o/dO/dQ/dK/dV (read through strides, the head dim
// contiguous) and (B, H, Sq) fp32 for lse and delta.
//
// The fp32 forward is flash_fwd.cu's flash_fwd_3xtf32_kernel<D, true>
// (fwd_f32::run with an lse): both products in 3xTF32 on the tensor cores,
// and column warp 0 of each row group writes its rows' lse.
//
// The fp32 backward, bwd_dq_3xtf32_kernel and bwd_dkv_3xtf32_kernel at head
// dims 64, 128 and 256, runs every product on the tensor cores in 3xTF32,
// as flash_fwd.cu's forward does (tf32.cuh: each operand split by its bits
// into hi and lo, lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8; see that
// file's header for why mma.sync and not wgmma). They serve fp32 training:
// the parity cuts and the fp32 train CLI.
//   - The tensor core truncates each add into its accumulator, and dK/dV
//     sum thousands of query rows: every 8-column k-step of S and dP, every
//     32-key tile of dQ and every 32-row query tile of dK and dV goes into
//     a fresh fragment, added to the running sum in fp32.
//   - dQ: a block of 16-row warps (its query rows) loops over 32-key tiles
//     of K and V: S = qs K^T and dP = dO V^T read K and V as the forward's
//     QK^T reads K; dQ += dS K reads K as its PV reads V, with dS taken
//     from the score accumulator as the A fragment as it lies. q and dO
//     stay in registers, split anew at every tile.
//   - dK/dV: a block of 16-key warps loops over 32-row tiles of Q and dO
//     (from the diagonal's tile when causal): S^T = K qs^T and dP^T = V
//     dO^T, with the block's K (times scale*log2(e)) and V rows staged once
//     in shared memory as A operands; dV += P^T dO, then dK += dS^T Q. lse
//     and delta are per column here.
//   - A warp holds 64 of the head dim's columns (its accumulators: 32
//     registers each), and D / 64 column warps split a row group's columns,
//     so that no instance spills; their partial S and dP meet in shared
//     memory and each warp adds them in one order (sum_partials), so all
//     of them hold the same p and ds.
//   - Tiles come by TMA into rings refilled by the last warp out
//     (sm90::KvRings; dK/dV's rings hold Q and dO, from row row0), one box
//     of 64 + 4 columns a column warp, rows 68 floats apart: every fragment
//     load is free of bank conflicts.
//   - Work: one block per item of the wrapper's work list (flash_bwd.py's
//     work_list, longest loop first). A dK/dV item takes one query head, so
//     a KV head's keys spread over its group's heads (Gemma-2B has one KV
//     head: blocks of its 32 keys would not fill the card): each item
//     writes its head's fp32 dK and dV, and dkv_group_sum_kernel<float>
//     (dkv_group_sum.cuh, the bf16 path's too) sums each group in head order.
//   - Shared memory: dQ 35 / 101 / 169 KB at 64 / 128 / 256 (K and V rings
//     of 2); dK/dV 69 / 169 / 203 KB (at 256 a dO ring of 1).
// Bound: operations, 3 TF32 products per fp32 product at the TF32 peak (dQ
// 3 products per (query, key) pair, dK/dV 4).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dkv_group_sum.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using namespace mavlm::sm90;
using namespace mavlm::tf32;

struct TrainParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dO
  void* out;           // dq, or dk's partials
  void* out2;          // dv's partials
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  const int* valid_len;
  const int* items;    // backward: (n_items, 3) int32, batch, query head, tile
  int H, Sq, Skv, kv_groups, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;  // dO
  long long o_sb, o_ss, o_sh;  // the output tensor(s), bshd
  float scale;       // softmax scale (raw-score units)
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ int kv_limit(const TrainParams& p, int b) {
  return min(p.valid_len[b], p.Skv);
}

// ---------------------------------------------------------------------------
// fp32 backward: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

// The tiles of the fp32 backward at head dim D. A warp owns 16 rows (dQ:
// query rows; dK/dV: keys) and DW = 64 of the head dim's columns; WN = D /
// 64 warps split a row group's columns and RG row groups make a block of
// BM rows. Each loop step takes a tile of BN = 32 keys (dQ) or query rows
// (dK/dV), brought by TMA into two rings (dQ: K and V; dK/dV: Q and dO) of
// S0 and S1 slots, one box of DW + 4 columns a column warp (flash_fwd.cu's
// layout). dK/dV also stages its block's own K and V rows (OWN).
template <int D, bool DKV>
struct BwdF32Tile {
  static constexpr int DW = 64, WN = D / DW, RG = D == 256 ? 2 : 4;
  static constexpr int S0 = 2, S1 = DKV && D == 256 ? 1 : 2;
  static constexpr int BN = 32;              // keys (dQ) or query rows (dK/dV) a tile
  static constexpr int PITCH = DW + 4;       // floats from one staged row to the next
  static constexpr int BM = 16 * RG;         // query rows (dQ) or keys (dK/dV) of a block
  static constexpr int WARPS = WN * RG, THREADS = 32 * WARPS;
  static constexpr int NT = BN / 8;          // 8-column tiles of a score tile
  static constexpr int KD = DW / 8;          // k-steps of the score products
  static constexpr int XS_FLOATS = 2 * NT * 4 * 32;  // one warp's partial S and dP
  using Ring = KvRings<S0, S1, BN, WN, DW, 4 * PITCH>;
  static constexpr uint32_t OWN = Ring::BYTES;
  static constexpr uint32_t OWN_FLOATS = WARPS * 16 * PITCH;  // K's (or V's) rows
  static constexpr uint32_t BARS = OWN + (DKV ? 2 * OWN_FLOATS * 4 : 0);
  static constexpr uint32_t COUNTERS = BARS + 8 * Ring::SLOTS;
  static constexpr uint32_t XS = (COUNTERS + 4 * Ring::SLOTS + 15) / 16 * 16;
  static constexpr uint32_t XS_BYTES = WN > 1 ? WARPS * XS_FLOATS * 4 : 0;
  static constexpr size_t SMEM = 1024 + XS + XS_BYTES;  // 1024: the alignment of the base
  static_assert(D % DW == 0, "a warp's columns are 64 of the head dim");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The row group's partial S and dP (each warp's over its DW columns)
// summed in shared memory: each warp writes its own, then adds the WN
// partials of its row group in one order, so that every column warp holds
// the same sums; the second barrier keeps the next tile's writes behind
// every warp's reads.
template <int WN, int NT>
__device__ __forceinline__ void sum_partials(float* xs, int warp, int rg, int lane,
                                             float (&s)[NT][4], float (&dp)[NT][4]) {
  constexpr int F4 = 2 * NT * 32;  // a warp's float4s
  float4* mine = reinterpret_cast<float4*>(xs) + warp * F4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mine[nt * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    mine[(NT + nt) * 32 + lane] = make_float4(dp[nt][0], dp[nt][1], dp[nt][2], dp[nt][3]);
  }
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + rg), "n"(32 * WN) : "memory");
  const float4* group = reinterpret_cast<const float4*>(xs) + rg * WN * F4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float4 a = group[nt * 32 + lane], d = group[(NT + nt) * 32 + lane];
#pragma unroll
    for (int c = 1; c < WN; ++c) {
      const float4 x = group[c * F4 + nt * 32 + lane];
      const float4 y = group[c * F4 + (NT + nt) * 32 + lane];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      d.x += y.x; d.y += y.y; d.z += y.z; d.w += y.w;
    }
    s[nt][0] = a.x; s[nt][1] = a.y; s[nt][2] = a.z; s[nt][3] = a.w;
    dp[nt][0] = d.x; dp[nt][1] = d.y; dp[nt][2] = d.z; dp[nt][3] = d.w;
  }
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + rg), "n"(32 * WN) : "memory");
}

// A score accumulator as an A fragment, as it lies: the 8-column step kk's
// k index t holds column 2t and t + 4 holds column 2t + 1, split hi / lo
template <int NT>
__device__ __forceinline__ void split_scores(const float (&x)[NT][4], uint32_t (&hi)[NT][4],
                                             uint32_t (&lo)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    split_tf32(x[kk][0], hi[kk][0], lo[kk][0]);
    split_tf32(x[kk][2], hi[kk][1], lo[kk][1]);
    split_tf32(x[kk][1], hi[kk][2], lo[kk][2]);
    split_tf32(x[kk][3], hi[kk][3], lo[kk][3]);
  }
}

// acc (16 x DW) += a (16 x BN, split by split_scores) times the staged tile
// whose rows are its BN columns: one fresh fragment per 8 output columns
// over the whole tile, added in fp32. `f` is this thread's first element
// of the tile (row 2t, column g of this warp's box).
template <int NT, int KD, int P>
__device__ __forceinline__ void product_over_tile(float (&acc)[KD][4], const uint32_t (&hi)[NT][4],
                                                  const uint32_t (&lo)[NT][4], const float* f) {
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float* b = f + 8 * kk * P + 8 * n;
      mma_3xtf32(part, hi[kk], lo[kk], b[0], b[P]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[i];
  }
}

// s (16 x BN) += a (16 x DW, fragments a[ks]) times the staged tile's rows
// (BN rows, this warp's DW columns) transposed: one fresh fragment per
// k-step, added in fp32. `f` is this thread's first element of the tile
// (row g, column t of this warp's box).
template <int NT, int P>
__device__ __forceinline__ void scores_step(float (&s)[NT][4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], const float* f, int ks) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* b = f + 8 * nt * P + 8 * ks;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32(part, ah, al, b[0], b[4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] += part[i];
  }
}

template <int D>
__global__ void __launch_bounds__(BwdF32Tile<D, false>::THREADS, 1)
    bwd_dq_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const TrainParams p) {
  using T = BwdF32Tile<D, false>;
  constexpr int BN = T::BN, NT = T::NT, KD = T::KD, DW = T::DW, P = T::PITCH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::WN, cw = warp % T::WN;  // row group, column warp
  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], q0 = item[2] * T::BM;
  const int row0 = q0 + 16 * rg + g;  // this thread's rows: row0 and row0 + 8
  const int col0 = cw * DW;
  // this thread's first fragment element in a staged tile (this warp's
  // box): S's and dP's B, key g at column t; dQ's B, key 2t at column g
  const int qk_at = cw * BN * P + g * P + t, pv_at = cw * BN * P + 2 * t * P + g;

  const typename T::Ring ring = {base, base + T::BARS,
                                 reinterpret_cast<unsigned int*>(gbase + T::COUNTERS),
                                 &tm_k, &tm_v, h / p.kv_groups, b};
  const int kv_valid = max(kv_limit(p, b), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + T::BM) : kv_valid;
  const int n_tiles = (kv_end + BN - 1) / BN;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) ring.load_first(n_tiles);

  // q * scale*log2(e) and dO: this warp's 16 rows by DW columns as A
  // fragments (a0: row g, column t; a1: row g + 8; a2, a3: column t + 4)
  float qa[KD][4], da[KD][4];
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + col0 + t;
  const float* dout = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh + col0 + t;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1), col = 8 * ks + 4 * (i >> 1);
      const bool in = row < p.Sq;
      qa[ks][i] = in ? q[row * p.q_ss + col] * p.scale_log2 : 0.f;
      da[ks][i] = in ? dout[row * p.d_ss + col] : 0.f;
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[idx] : INFINITY;
    delta[r] = row < p.Sq ? p.delta[idx] : 0.f;
  }
  float dq[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  }
  float* xs = reinterpret_cast<float*>(gbase + T::XS);

  for (int j = 0; j < n_tiles; ++j) {
    // S = qs K^T and dP = dO V^T (16 x BN) over this warp's columns; c0,
    // c1: row g, keys 2t, 2t + 1 of the 8-key tile; c2, c3: row g + 8
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
    ring.wait(0, j);
    const float* sk = reinterpret_cast<const float*>(gbase + (ring.tile(0, j) - base));
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      // the splits are redone at every tile: hoisted out of the tile loop,
      // hi and lo of every fragment would take twice q's registers
      reg_fence(qa[ks]);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qa[ks][i], ah[i], al[i]);
      scores_step<NT, P>(s, ah, al, sk + qk_at, ks);
    }
    ring.wait(1, j);
    const float* sv = reinterpret_cast<const float*>(gbase + (ring.tile(1, j) - base));
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      reg_fence(da[ks]);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(da[ks][i], ah[i], al[i]);
      scores_step<NT, P>(dp, ah, al, sv + qk_at, ks);
    }
    ring.template done_with<T::WARPS>(1, j, n_tiles);
    if constexpr (T::WN > 1) sum_partials<T::WN, NT>(xs, warp, rg, lane, s, dp);

    // p = exp2(s - lse), zero where masked; ds = p (dp - delta) scale
    const int n0 = j * BN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * t + (i & 1);
        const int row = row0 + 8 * (i >> 1);
        const bool ok = key < kv_valid && (!p.causal || key <= row);
        const float pr = ok ? exp2f(s[nt][i] - lse[i >> 1]) : 0.f;
        s[nt][i] = pr * (dp[nt][i] - delta[i >> 1]) * p.scale;
      }
    }
    // dQ += dS K over this warp's columns
    uint32_t dh[NT][4], dl[NT][4];
    split_scores<NT>(s, dh, dl);
    product_over_tile<NT, KD, P>(dq, dh, dl, sk + pv_at);
    ring.template done_with<T::WARPS>(0, j, n_tiles);
  }

  float* out = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh + col0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    float* orow = out + row * p.o_ss;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BwdF32Tile<D, true>::THREADS, 1)
    bwd_dkv_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do, const TrainParams p) {
  using T = BwdF32Tile<D, true>;
  constexpr int BN = T::BN, NT = T::NT, KD = T::KD, DW = T::DW, P = T::PITCH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::WN, cw = warp % T::WN;  // key group, column warp
  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], k0 = item[2] * T::BM;
  const int hk = h / p.kv_groups;
  const int key0 = k0 + 16 * rg + g;  // this thread's keys: key0 and key0 + 8
  const int col0 = cw * DW;
  // in a staged Q or dO tile (this warp's box): S^T's and dP^T's B, query
  // g at column t; dV's and dK's B, query 2t at column g
  const int qk_at = cw * BN * P + g * P + t, pv_at = cw * BN * P + 2 * t * P + g;

  const int kv_valid = max(kv_limit(p, b), 0);
  // query tiles from the diagonal's when causal; none for keys past the valid length
  const int m_first = p.causal ? k0 / BN * BN : 0;
  const int n_tiles = k0 < kv_valid ? (max(p.Sq - m_first, 0) + BN - 1) / BN : 0;
  const typename T::Ring ring = {base, base + T::BARS,
                                 reinterpret_cast<unsigned int*>(gbase + T::COUNTERS),
                                 &tm_q, &tm_do, h, b, m_first};
  if (threadIdx.x == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) ring.load_first(n_tiles);

  // this warp's 16 keys of K * scale*log2(e) and of V, its DW columns, in
  // shared memory (rows P floats apart) as the A operands of S^T and dP^T
  float* own_k = reinterpret_cast<float*>(gbase + T::OWN) + warp * 16 * P;
  float* own_v = own_k + T::OWN_FLOATS;
  {
    const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + col0;
    const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + col0;
    for (int i = lane; i < 16 * DW / 4; i += 32) {
      const int r = i / (DW / 4), c = 4 * (i % (DW / 4));
      const int key = k0 + 16 * rg + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < p.Skv) {
        kx = *reinterpret_cast<const float4*>(kg + key * p.k_ss + c);
        vx = *reinterpret_cast<const float4*>(vg + key * p.v_ss + c);
      }
      kx.x *= p.scale_log2; kx.y *= p.scale_log2; kx.z *= p.scale_log2; kx.w *= p.scale_log2;
      *reinterpret_cast<float4*>(own_k + r * P + c) = kx;
      *reinterpret_cast<float4*>(own_v + r * P + c) = vx;
    }
    __syncwarp();
  }
  const float* ka = own_k + g * P + t;
  const float* va = own_v + g * P + t;

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }
  const long long row_base = ((long long)b * p.H + h) * p.Sq;
  float* xs = reinterpret_cast<float*>(gbase + T::XS);

  for (int j = 0; j < n_tiles; ++j) {
    const int m0 = m_first + j * BN;
    // lse and delta of this thread's query columns 8 nt + 2t + e
    float lse[NT][2], delta[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = m0 + 8 * nt + 2 * t + e;
        lse[nt][e] = qi < p.Sq ? p.lse[row_base + qi] : INFINITY;
        delta[nt][e] = qi < p.Sq ? p.delta[row_base + qi] : 0.f;
      }
    }
    // S^T = K qs^T and dP^T = V dO^T (16 keys x BN queries) over this
    // warp's columns; c0, c1: key g, queries 2t, 2t + 1 of the 8-query tile;
    // c2, c3: key g + 8
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
    ring.wait(0, j);
    const float* sq = reinterpret_cast<const float*>(gbase + (ring.tile(0, j) - base));
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t ah[4], al[4];
      const float a[4] = {ka[8 * ks], ka[8 * P + 8 * ks], ka[8 * ks + 4], ka[8 * P + 8 * ks + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
      scores_step<NT, P>(s, ah, al, sq + qk_at, ks);
    }
    ring.wait(1, j);
    const float* sd = reinterpret_cast<const float*>(gbase + (ring.tile(1, j) - base));
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      uint32_t ah[4], al[4];
      const float a[4] = {va[8 * ks], va[8 * P + 8 * ks], va[8 * ks + 4], va[8 * P + 8 * ks + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
      scores_step<NT, P>(dp, ah, al, sd + qk_at, ks);
    }
    if constexpr (T::WN > 1) sum_partials<T::WN, NT>(xs, warp, rg, lane, s, dp);

    // p^T = exp2(s^T - lse), zero where masked; ds^T = p^T (dp^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = m0 + 8 * nt + 2 * t + (i & 1);
        const int key = key0 + 8 * (i >> 1);
        const bool ok = key < kv_valid && (!p.causal || key <= qi);
        const float pr = ok ? exp2f(s[nt][i] - lse[nt][i & 1]) : 0.f;
        s[nt][i] = pr;
        dp[nt][i] = pr * (dp[nt][i] - delta[nt][i & 1]) * p.scale;
      }
    }
    // dV += P^T dO, then dK += dS^T Q, over this warp's columns
    {
      uint32_t hi[NT][4], lo[NT][4];
      split_scores<NT>(s, hi, lo);
      product_over_tile<NT, KD, P>(dv, hi, lo, sd + pv_at);
    }
    ring.template done_with<T::WARPS>(1, j, n_tiles);
    {
      uint32_t hi[NT][4], lo[NT][4];
      split_scores<NT>(dp, hi, lo);
      product_over_tile<NT, KD, P>(dk, hi, lo, sq + pv_at);
    }
    ring.template done_with<T::WARPS>(0, j, n_tiles);
  }

  // keys past the valid length (and whole blocks past it) write zeros
  float* dkp = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh + col0 + 2 * t;
  float* dvp = static_cast<float*>(p.out2) + b * p.o_sb + h * p.o_sh + col0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      const long long off = key * p.o_ss + 8 * n;
      *reinterpret_cast<float2*>(dkp + off) = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dvp + off) = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// one block per work item: dQ's query-row tiles over K/V maps, or dK/dV's
// key tiles over Q/dO maps
template <int D>
int launch_dq(const TrainParams& p, int n_items, int B, const long long* k_st,
              const long long* v_st, cudaStream_t stream) {
  using T = BwdF32Tile<D, false>;
  const int hkv = p.H / p.kv_groups;
  CUtensorMap mk, mv;
  if (!make_map_f32(&mk, p.k, D, p.Skv, hkv, B, k_st, T::BN, T::PITCH) ||
      !make_map_f32(&mv, p.v, D, p.Skv, hkv, B, v_st, T::BN, T::PITCH)) {
    return kTmaRejected;
  }
  const int rc = set_smem(bwd_dq_3xtf32_kernel<D>, T::SMEM);
  if (rc != 0) return rc;
  bwd_dq_3xtf32_kernel<D><<<n_items, T::THREADS, T::SMEM, stream>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const TrainParams& p, int n_items, int B, const long long* q_st,
               const long long* d_st, cudaStream_t stream) {
  using T = BwdF32Tile<D, true>;
  CUtensorMap mq, md;
  if (!make_map_f32(&mq, p.q, D, p.Sq, p.H, B, q_st, T::BN, T::PITCH) ||
      !make_map_f32(&md, p.dout, D, p.Sq, p.H, B, d_st, T::BN, T::PITCH)) {
    return kTmaRejected;
  }
  const int rc = set_smem(bwd_dkv_3xtf32_kernel<D>, T::SMEM);
  if (rc != 0) return rc;
  bwd_dkv_3xtf32_kernel<D><<<n_items, T::THREADS, T::SMEM, stream>>>(mq, md, p);
  return static_cast<int>(cudaGetLastError());
}

TrainParams make_params(const void* q, const void* k, const void* v, const void* valid_len,
                        int H, int Sq, int Skv, int kv_groups, int causal,
                        const long long* qs, const long long* ks, const long long* vs,
                        float scale, float scale_log2) {
  TrainParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid_len = static_cast<const int*>(valid_len);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_groups = kv_groups;
  p.causal = causal;
  p.q_sb = qs[0]; p.q_ss = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.scale = scale;
  p.scale_log2 = scale_log2;
  return p;
}

void backward_params(TrainParams& p, const void* dout, const void* lse, const void* delta,
                     const void* items, const long long* d_strides) {
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.items = static_cast<const int*>(items);
  p.d_sb = d_strides[0]; p.d_ss = d_strides[1]; p.d_sh = d_strides[2];
}

}  // namespace

// Strides are (batch, sequence, head) in elements; the head dim is
// contiguous, and q's, k's, v's and dO's also go into TMA tensor maps (a
// dim of size 1 needs a valid one). dtype: 0 = bf16, 1 = fp32. Each
// function returns 0, a cudaError_t, -1 / -2 for a head dim / dtype it was
// not built for, or -4 when a tensor map is refused (kernel_error_string,
// in flash_fwd.cu, names the code).

// out (B, Sq, H, D) and lse (B, H, Sq) fp32 are written. bf16 runs
// flash_fwd_sm90.cu's kernel, one block per item of `items` ((n_items, 3)
// int32: batch, query head, tile of block_rows query rows); fp32 runs
// flash_fwd.cu's 3xTF32 kernel with its lse epilogue (head dims 64, 128 and
// 256) and ignores the three.
extern "C" int flash_fwd_lse(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, void* out, void* lse, const void* valid_len,
                             int B, int Sq, int Skv, int H, int kv_groups, int causal,
                             const long long* q_strides, const long long* k_strides,
                             const long long* v_strides, const long long* o_strides,
                             float scale, float scale_log2, void* stream, const void* items,
                             int n_items, int block_rows) {
  mavlm::fwd_sm90::Args a = {q, k, v, out, lse, valid_len, items, n_items, block_rows, B, Sq,
                             Skv, H, kv_groups, causal};
  for (int i = 0; i < 3; ++i) {
    a.q_st[i] = q_strides[i];
    a.k_st[i] = k_strides[i];
    a.v_st[i] = v_strides[i];
    a.o_st[i] = o_strides[i];
  }
  a.scale_log2 = scale_log2;
  if (dtype == 0) return mavlm::fwd_sm90::run(a, head_dim, stream);  // 256: the wide kernel
  if (dtype == 1) return mavlm::fwd_f32::run(a, head_dim, stream);
  return -2;
}

// The tiles of the fp32 backward's work items at a head dim: dQ items take
// dq_rows query rows and loop over dq_keys-key tiles; dK/dV items take
// dkv_keys keys and loop over dkv_rows-row query tiles (the bf16 kernels'
// are flash_bwd_tiles, in flash_bwd_sm90.cu).
extern "C" int flash_bwd_f32_tiles(int head_dim, int* dq_rows, int* dq_keys, int* dkv_rows,
                                   int* dkv_keys) {
  switch (head_dim) {
    case 64:
      *dq_rows = BwdF32Tile<64, false>::BM;
      *dkv_keys = BwdF32Tile<64, true>::BM;
      break;
    case 128:
      *dq_rows = BwdF32Tile<128, false>::BM;
      *dkv_keys = BwdF32Tile<128, true>::BM;
      break;
    case 256:
      *dq_rows = BwdF32Tile<256, false>::BM;
      *dkv_keys = BwdF32Tile<256, true>::BM;
      break;
    default:
      return -1;
  }
  *dq_keys = *dkv_rows = BwdF32Tile<64, false>::BN;
  return 0;
}

// dq (B, Sq, H, D) is written, one block per item of `items` ((n_items, 3)
// int32: batch, query head, tile of dq_rows query rows); fp32 only (bf16:
// flash_bwd_dq_sm90).
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, const void* valid_len,
                            const void* items, int n_items, int B, int Sq, int Skv, int H,
                            int kv_groups, int causal, const long long* q_strides,
                            const long long* k_strides, const long long* v_strides,
                            const long long* d_strides, const long long* dq_strides,
                            float scale, float scale_log2, void* stream) {
  if (dtype != 1) return -2;
  TrainParams p = make_params(q, k, v, valid_len, H, Sq, Skv, kv_groups, causal, q_strides,
                              k_strides, v_strides, scale, scale_log2);
  backward_params(p, dout, lse, delta, items, d_strides);
  p.out = dq;
  p.o_sb = dq_strides[0]; p.o_ss = dq_strides[1]; p.o_sh = dq_strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_dq<64>(p, n_items, B, k_strides, v_strides, s);
    case 128: return launch_dq<128>(p, n_items, B, k_strides, v_strides, s);
    case 256: return launch_dq<256>(p, n_items, B, k_strides, v_strides, s);
    default: return -1;
  }
}

// dk and dv (B, Skv, H / kv_groups, D), with the strides of dk, are written,
// one block per item of `items` ((n_items, 3) int32: batch, query head, tile
// of dkv_keys keys); fp32 only (bf16: flash_bwd_dkv_sm90). The items write
// each query head's fp32 dK and dV into dk_part and dv_part ((B, H, Skv,
// D), contiguous), which dkv_group_sum_kernel<float> sums over each group in
// head order.
extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk_part, void* dv_part, void* dk,
                             void* dv, const void* valid_len, const void* items, int n_items,
                             int B, int Sq, int Skv, int H, int kv_groups, int causal,
                             const long long* q_strides, const long long* k_strides,
                             const long long* v_strides, const long long* d_strides,
                             const long long* dkv_strides, float scale, float scale_log2,
                             void* stream) {
  if (dtype != 1) return -2;
  TrainParams p = make_params(q, k, v, valid_len, H, Sq, Skv, kv_groups, causal, q_strides,
                              k_strides, v_strides, scale, scale_log2);
  backward_params(p, dout, lse, delta, items, d_strides);
  p.out = dk_part;  // (B, H, Skv, D)
  p.out2 = dv_part;
  p.o_sb = (long long)H * Skv * head_dim;
  p.o_ss = head_dim;
  p.o_sh = (long long)Skv * head_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (head_dim) {
    case 64: rc = launch_dkv<64>(p, n_items, B, q_strides, d_strides, s); break;
    case 128: rc = launch_dkv<128>(p, n_items, B, q_strides, d_strides, s); break;
    case 256: rc = launch_dkv<256>(p, n_items, B, q_strides, d_strides, s); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return mavlm::launch_group_sum<float>(dk_part, dv_part, dk, dv, B, H / kv_groups, kv_groups,
                                        Skv, head_dim, dkv_strides, s);
}
