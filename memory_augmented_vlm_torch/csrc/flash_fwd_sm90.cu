// Flash-attention forward for Hopper (sm_90a) in bf16: one online-softmax
// kernel fed by TMA and run on wgmma, behind both forward entry points
// (flash_fwd in flash_fwd.cu, flash_fwd_lse in flash_train.cu): a template
// with a flag for the lse epilogue, instantiated under one name per entry
// point (flash_fwd_kernel, flash_fwd_lse_kernel).
//
// Replaces the TPU kernels
//   _flash_fwd_kernel  behind memory_augmented_vlm_tpu/ops/pallas_flash.py::
//                      pallas_flash_attention (#1), and
//   _fwd_lse_kernel    behind memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py::
//                      _forward_with_lse (#9), which also writes the lse,
// and computes their function at a key tile of 64:
//   - q is scaled by scale*log2(e) and rounded to bf16 before QK^T;
//   - per tile of 64 keys, the running max m, alpha = exp2(m_prev - m_next),
//     p = exp2(s - m_next) rounded to bf16 for PV, and l and the fp32
//     accumulator rescaled by alpha: the TPU kernels' `_accumulate` at
//     block_k = 64, so P is rounded against the running max of its tile;
//   - keys at or past kv_valid_len[b], and above the diagonal when causal,
//     score MASK_VALUE; tiles wholly past the valid length or above the
//     diagonal of a warpgroup's 64 rows are skipped, as the TPU skips
//     them; a batch with valid length 0 gives zeros (and lse = -inf);
//   - out = acc / l in bf16; lse = m + log2(max(l, 1e-30)) in log2 units.
// Layout is bshd (read through strides, the head dim contiguous, rows on 16
// bytes); GQA reads K/V head h / kv_groups. lse is (B, H, Sq) fp32.
//
// What bounds it on the H100: arithmetic. At the path shapes (the tower,
// (64, 729, 16, 72); the LM prefill, 9472 causal tokens of 14 heads of 64
// over 2 KV heads; the memory's cross-attentions, 1568 queries of 8 heads
// of 112 over 3136 valid keys) the two products are 0.16 ms of bf16 work
// each for the tower and the LM, and its exp2 about as much on the
// special-function units; the bytes take a tenth of that.
//
// Design:
//   - a block is an item of a work list the wrapper builds once per shape
//     (ops/flash.py): (batch, query head, tile of BM rows), the longest loop
//     first when causal, with the tiles of one head side by side otherwise.
//     BM is 64 rows per consumer warpgroup: three warpgroups (192 rows; two,
//     128 rows, at D >= 112, whose accumulators need more registers) where
//     the grid still gives every SM two blocks, else one (64 rows, two
//     blocks per SM): the memory's 8 heads of 1568 rows make 72 blocks of
//     192 rows, too few for 132 SMs, and the key axis is not split, which
//     would move P's rounding points. The mma.sync kernels this replaces
//     read every K/V tile once per 64 rows;
//   - a producer warp issues TMA loads (tensor maps encoded on the host,
//     passed as __grid_constant__ parameters): the q tile once, then K and
//     V tiles of 64 keys into a ring of stages tracked by mbarriers (full:
//     the bytes landed; empty: every consumer warp is done). TMA zero-fills
//     rows past the end of a tensor and columns past D;
//   - the consumers apply scale*log2(e) and the rounding to the staged q
//     tile in place; QK^T is wgmma m64n64k16 with both operands K-major in
//     shared memory; the online softmax runs in the score accumulator's
//     registers; P, rounded to bf16, is repacked as the register A operand
//     of PV (acc_to_a), with V read MN-major: no transposed copy is staged;
//   - overlap: a warpgroup issues tile j's QK^T and tile j-1's PV together
//     and waits for both (one wait per tile), then runs tile j's softmax and
//     rescales the accumulator; the other warpgroups' products fill the
//     tensor cores meanwhile. Waiting for QK^T alone and running the softmax
//     under PV (wgmma.wait_group 1) measured no faster at two and three
//     warpgroups and 20% slower at the memory's one-warpgroup blocks
//     (PERF.md §6);
//   - head dims: a 64-column block is 128-byte swizzled (D = 64: one; D =
//     128: two). D = 72 adds a 16-column block with a 32-byte swizzle
//     (columns 64..79, TMA fills 72..79 with zeros), as two_sweep.cuh. D =
//     112 is staged as two 64-column boxes whose columns 112..127 TMA fills
//     with zeros: 14% more tensor work at shapes that are bound by the
//     length of their key loop, in exchange for D = 128's code path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace mavlm {
namespace fwd_sm90 {
namespace {

using namespace sm90;

constexpr int kWgRows = 64;  // query rows of a consumer warpgroup (wgmma M)
constexpr int kBN = 64;      // keys per K/V tile: QK^T's N
constexpr int kNC = 32;      // a thread's score accumulators
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // pallas_flash.MASK_VALUE

// consumer warpgroups of a block with the most rows at a head dim: three
// fit a thread's registers in 128 (the cap at 13 warps) at D <= 72
constexpr int max_wgs(int d) { return d <= 72 ? 3 : 2; }

// stages of the K/V ring: four, or as many as fit `blocks` blocks an SM
// beside their q tiles (and 2 KB each for barriers and alignment)
constexpr int ring_depth(uint32_t stage, uint32_t q_bytes, int blocks) {
  return blocks * (4 * stage + q_bytes + 2048) <= 227 * 1024   ? 4
         : blocks * (3 * stage + q_bytes + 2048) <= 227 * 1024 ? 3
                                                                : 2;
}

template <int D, int NWG>
struct Shape {
  static_assert(D == 64 || D == 72 || D == 112 || D == 128, "head dims 64, 72, 112, 128");
  static constexpr int CB = D == 72 ? 1 : (D + 63) / 64;  // 128-byte swizzled blocks
  static constexpr int W = D == 72 ? 16 : 0;               // columns of the narrow block
  static constexpr int NROW = 2 * W;                       // bytes of a narrow row
  static constexpr int KSTEPS = 4 * CB + W / 16;           // QK^T's 16-deep steps
  static constexpr int BM = NWG * kWgRows;                 // query rows per block
  static constexpr int THREADS = NWG * 128 + 32;           // and a producer warp
  // blocks an SM holds: two of one warpgroup, whose shared memory is sized
  // for two; at D >= 112 their accumulators need more than the 128
  // registers a thread of two such blocks is capped at, so ptxas is told one
  static constexpr int SMEM_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int MINB = NWG == 1 && D <= 72 ? 2 : 1;
  static constexpr uint32_t BLOCK = kBN * 128;             // a K or V tile's 64 columns
  static constexpr uint32_t BYTES = CB * BLOCK + kBN * NROW;  // a K or V tile
  static constexpr uint32_t STAGE = (2 * BYTES + 1023) / 1024 * 1024;  // K, then V
  static constexpr uint32_t Q_BLOCK = BM * 128;
  static constexpr uint32_t Q_LOAD = CB * Q_BLOCK + BM * NROW;
  static constexpr uint32_t Q_BYTES = (Q_LOAD + 1023) / 1024 * 1024;
  static constexpr int STAGES = ring_depth(STAGE, Q_BYTES, SMEM_BLOCKS);
  static constexpr size_t SMEM = STAGES * STAGE + Q_BYTES + 8 * (2 * STAGES + 1) + 1024;
};

struct Params {
  const int* valid_len;  // (B,)
  const int* items;      // (n_items, 3): batch, query head, tile of BM rows
  __nv_bfloat16* o;      // bshd
  float* lse;            // (B, H, Sq), or null for flash_fwd
  int Sq, Skv, H, kv_groups, causal;
  long long o_sb, o_ss, o_sh;
  float scale_log2;      // softmax scale * log2(e)
};

// a tile of `rows` rows at row0: its 64-column blocks (`block` bytes
// each) and its narrow block
template <int D, int NWG>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t block, const CUtensorMap* wide,
                                          const CUtensorMap* narrow, uint32_t bar, int row0,
                                          int h, int b) {
  using T = Shape<D, NWG>;
#pragma unroll
  for (int c = 0; c < T::CB; ++c) tma_load(dst + c * block, wide, bar, 64 * c, row0, h, b);
  if constexpr (T::W > 0) tma_load(dst + T::CB * block, narrow, bar, 64 * T::CB, row0, h, b);
}

// K-major descriptor of k-step kk of a tile of `rows` rows (CB blocks of
// `block` bytes, then the narrow block), rows from row0
template <int D, int NWG>
__device__ __forceinline__ uint64_t desc_tile(uint32_t tile, uint32_t block, int rows, int row0,
                                              int kk) {
  using T = Shape<D, NWG>;
  return kk < 4 * T::CB
      ? desc_kmajor(tile, rows, row0, kk)
      : desc_kmajor_narrow(tile + T::CB * block + row0 * T::NROW, T::NROW, kk - 4 * T::CB);
}

// issues sc = Q K^T of this warpgroup's rows (q_row0 of the q tile)
template <int D, int NWG>
__device__ __forceinline__ void qk_issue(float (&sc)[kNC], uint32_t q_tile, int q_row0,
                                         uint32_t k_tile) {
  using T = Shape<D, NWG>;
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    wgmma_ss_n64(sc, desc_tile<D, NWG>(q_tile, T::Q_BLOCK, T::BM, q_row0, kk),
                 desc_tile<D, NWG>(k_tile, T::BLOCK, kBN, 0, kk), kk);
  }
}

// issues o += P V: an n64 product per 64-column block of the V tile and an
// n16 one over its narrow block
template <int D, int NWG>
__device__ __forceinline__ void pv_issue(float (&o)[Shape<D, NWG>::CB][32], float (&on)[8],
                                         const uint32_t (&pa)[kBN / 16][4], uint32_t v_tile) {
  using T = Shape<D, NWG>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int cb = 0; cb < T::CB; ++cb) {
      wgmma_rs_n64<1>(o[cb], pa[kk], desc_mnmajor(v_tile + cb * T::BLOCK, kBN, kk), 1);
    }
    if constexpr (T::W == 16) {
      wgmma_rs_n16<1>(on, pa[kk],
                      desc_mnmajor_narrow(v_tile + T::CB * T::BLOCK, kBN, T::NROW, kk), 1);
    }
  }
}

// The kernel's body; LSE adds the lse epilogue (flash_fwd_lse).
template <int D, int NWG, bool LSE>
__device__ __forceinline__ void forward(const CUtensorMap& tm_q, const CUtensorMap& tm_qn,
                                        const CUtensorMap& tm_k, const CUtensorMap& tm_kn,
                                        const CUtensorMap& tm_v, const CUtensorMap& tm_vn,
                                        const Params& p) {
  using T = Shape<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base + T::STAGES * T::STAGE;
  const uint32_t full0 = q_tile + T::Q_BYTES, empty0 = full0 + 8 * T::STAGES;
  const uint32_t q_bar = empty0 + 8 * T::STAGES;

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], q0 = item[2] * T::BM;
  const int hk = h / p.kv_groups;
  const int kv_valid = max(min(p.valid_len[b], p.Skv), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + T::BM) : kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + kBN - 1) / kBN, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_tx(q_bar, T::Q_LOAD);
      load_tile<D, NWG>(q_tile, T::Q_BLOCK, &tm_q, &tm_qn, q_bar, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::STAGES;
        const uint32_t k_tile = base + s * T::STAGE, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((j / T::STAGES) & 1) ^ 1);
        mbar_arrive_tx(full, 2 * T::BYTES);
        load_tile<D, NWG>(k_tile, T::BLOCK, &tm_k, &tm_kn, full, j * kBN, hk, b);
        load_tile<D, NWG>(k_tile + T::BYTES, T::BLOCK, &tm_v, &tm_vn, full, j * kBN, hk, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int r_wg = q0 + wg * kWgRows;                // this warpgroup's first row
  const int row0 = r_wg + wl * 16 + g;               // this thread's rows: row0, row0 + 8
  // this warpgroup's key tiles: the block's, cut at its own diagonal; none
  // for rows wholly past Sq
  const int wg_end = p.causal ? min(kv_valid, r_wg + kWgRows) : kv_valid;
  const int my_tiles = __shfl_sync(
      0xffffffffu, r_wg < p.Sq ? min(n_tiles, (wg_end + kBN - 1) / kBN) : 0, 0);

  if (n_tiles > 0) {
    // scale*log2(e) and the bf16 rounding applied to the staged q tile in
    // place (the swizzle moves 16-byte chunks, so every element stays where
    // it is; TMA's zero fill maps to zero)
    mbar_wait(q_bar, 0);
    unsigned char* qs = smem_raw + (q_tile - raw);
    for (int i = threadIdx.x; i < static_cast<int>(T::Q_LOAD / 4); i += NWG * 128) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(qs) + i;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(__low2float(v) * p.scale_log2,
                                     __high2float(v) * p.scale_log2);
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;\n" :: "n"(NWG * 128) : "memory");  // the consumers
  }
  const int q_row0 = wg * kWgRows;  // this warpgroup's rows of the q tile

  float o[T::CB][32], on[8];
#pragma unroll
  for (int cb = 0; cb < T::CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) on[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sc[kNC];
  uint32_t pa[kBN / 16][4];

  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };
  // The online softmax of tile j's scores in place: element i of sc is row
  // row0 + 8 ((i >> 1) & 1), key n0 + 8 (i >> 2) + 2t + (i & 1). Masks only
  // where the valid length or the diagonal crosses the tile. Returns alpha
  // per row; sc becomes p.
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int n0 = j * kBN;
    if (!(n0 + kBN <= kv_valid && (!p.causal || n0 + kBN - 1 <= r_wg))) {
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (!(col < kv_valid && (!p.causal || col <= row))) sc[i] = kMaskValue;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kNC; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m_run[r] - mx[r]);  // 0 on the first tile (m_run = -inf)
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(sc[i] - mx[r]);
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
  };

  if (my_tiles > 0) {
    float alpha[2];
    mbar_wait(full0, 0);
    wg_fence();
    qk_issue<D, NWG>(sc, q_tile, q_row0, base);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    softmax(0, alpha);  // the accumulator is zero: nothing to rescale
    acc_to_a(sc, pa);   // P rounded to bf16
    for (int j = 1; j < my_tiles; ++j) {
      const int s = j % T::STAGES, sp = (j - 1) % T::STAGES;
      mbar_wait(full0 + 8 * s, (j / T::STAGES) & 1);
      wg_fence();
      qk_issue<D, NWG>(sc, q_tile, q_row0, base + s * T::STAGE);
      pv_issue<D, NWG>(o, on, pa, base + sp * T::STAGE + T::BYTES);  // tile j-1's PV
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
#pragma unroll
      for (int cb = 0; cb < T::CB; ++cb) reg_fence(o[cb]);
      reg_fence(on);
      release(sp);
      softmax(j, alpha);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int cb = 0; cb < T::CB; ++cb) o[cb][i] *= alpha[(i >> 1) & 1];
        if (i < 8) on[i] *= alpha[(i >> 1) & 1];
      }
      acc_to_a(sc, pa);
    }
    const int s = (my_tiles - 1) % T::STAGES;
    wg_fence();
    pv_issue<D, NWG>(o, on, pa, base + s * T::STAGE + T::BYTES);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < T::CB; ++cb) reg_fence(o[cb]);
    reg_fence(on);
    release(s);
  }
  for (int j = my_tiles; j < n_tiles; ++j) {  // tiles past this warpgroup's diagonal
    const int s = j % T::STAGES;
    mbar_wait(full0 + 8 * s, (j / T::STAGES) & 1);
    release(s);
  }

  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    if (LSE && t == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m_run[r] + log2f(fmaxf(l, 1e-30f));
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;  // a row that saw no key is zero
    __nv_bfloat16* orow = out + (long long)row * p.o_ss + 2 * t;
    constexpr int WIDE = D < 64 * T::CB ? D / 8 : 8 * T::CB;  // 8-column chunks of o
#pragma unroll
    for (int c = 0; c < WIDE; ++c) {  // columns 8c + 2t, +1
      const float* acc = &o[c / 8][4 * (c % 8) + 2 * r];
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16x2(acc[0] * inv, acc[1] * inv);
    }
#pragma unroll
    for (int c = 0; c < D / 8 - WIDE; ++c) {  // the narrow block's columns below D
      const float* acc = &on[4 * c + 2 * r];
      *reinterpret_cast<uint32_t*>(orow + 64 * T::CB + 8 * c) =
          pack_bf16x2(acc[0] * inv, acc[1] * inv);
    }
  }
}

// The kernels of the two entry points, one name each, so that a profile
// tells them apart.
template <int D, int NWG>
__global__ void __launch_bounds__(Shape<D, NWG>::THREADS, Shape<D, NWG>::MINB)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_qn,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_kn,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_vn, const Params p) {
  forward<D, NWG, false>(tm_q, tm_qn, tm_k, tm_kn, tm_v, tm_vn, p);
}

template <int D, int NWG>
__global__ void __launch_bounds__(Shape<D, NWG>::THREADS, Shape<D, NWG>::MINB)
    flash_fwd_lse_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_qn,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_kn,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_vn, const Params p) {
  forward<D, NWG, true>(tm_q, tm_qn, tm_k, tm_kn, tm_v, tm_vn, p);
}

template <int D, int NWG>
int launch(const Args& a, cudaStream_t stream) {
  using T = Shape<D, NWG>;
  const int hkv = a.H / a.kv_groups;
  CUtensorMap m[6];  // q, k, v: boxes of 64 columns, and of the narrow block
  const void* ptr[3] = {a.q, a.k, a.v};
  const long long* st[3] = {a.q_st, a.k_st, a.v_st};
  for (int i = 0; i < 3; ++i) {
    const int s = i == 0 ? a.Sq : a.Skv, heads = i == 0 ? a.H : hkv;
    const int rows = i == 0 ? T::BM : kBN;
    if (!make_map(&m[2 * i], ptr[i], D, s, heads, a.B, st[i], rows)) return kTmaRejected;
    if (T::W > 0 && !make_map(&m[2 * i + 1], ptr[i], D, s, heads, a.B, st[i], rows, T::W,
                              CU_TENSOR_MAP_SWIZZLE_32B)) {
      return kTmaRejected;
    }
    if (T::W == 0) m[2 * i + 1] = m[2 * i];
  }
  Params p;
  p.valid_len = static_cast<const int*>(a.valid_len);
  p.items = static_cast<const int*>(a.items);
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.lse = static_cast<float*>(a.lse);
  p.Sq = a.Sq;
  p.Skv = a.Skv;
  p.H = a.H;
  p.kv_groups = a.kv_groups;
  p.causal = a.causal;
  p.o_sb = a.o_st[0];
  p.o_ss = a.o_st[1];
  p.o_sh = a.o_st[2];
  p.scale_log2 = a.scale_log2;
  auto kernel = flash_fwd_kernel<D, NWG>;
  if (a.lse != nullptr) {
    if constexpr (D == 64 || D == 128) {  // flash_fwd_lse's head dims
      kernel = flash_fwd_lse_kernel<D, NWG>;
    } else {
      return -1;
    }
  }
  const int rc = set_smem(kernel, T::SMEM);
  if (rc != 0) return rc;
  kernel<<<a.n_items, T::THREADS, T::SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_rows(const Args& a, cudaStream_t stream) {
  if (a.block_rows == kWgRows) return launch<D, 1>(a, stream);
  if (a.block_rows == max_wgs(D) * kWgRows) return launch<D, max_wgs(D)>(a, stream);
  return -3;
}

}  // namespace

int run(const Args& a, int head_dim, void* stream) {
  if (a.n_items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch_rows<64>(a, s);
    case 72: return launch_rows<72>(a, s);
    case 112: return launch_rows<112>(a, s);
    case 128: return launch_rows<128>(a, s);
    case fwd_wide::kHeadDim: return fwd_wide::run(a, stream);
    default: return -1;
  }
}

}  // namespace fwd_sm90
}  // namespace mavlm

// The kernel's tiles at a head dim: its online softmax rounds P against the
// running max of each tile of key_tile keys; a block takes 64 query rows or
// max_block_rows.
extern "C" int flash_fwd_tiles(int head_dim, int* key_tile, int* max_block_rows) {
  if (head_dim == mavlm::fwd_wide::kHeadDim) {
    *key_tile = mavlm::fwd_wide::kKeyTile;
    *max_block_rows = mavlm::fwd_wide::kBlockRows;
    return 0;
  }
  if (head_dim != 64 && head_dim != 72 && head_dim != 112 && head_dim != 128) return -1;
  *key_tile = mavlm::fwd_sm90::kBN;
  *max_block_rows = mavlm::fwd_sm90::max_wgs(head_dim) * mavlm::fwd_sm90::kWgRows;
  return 0;
}
