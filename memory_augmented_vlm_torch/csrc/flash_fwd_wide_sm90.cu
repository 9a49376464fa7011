// Flash-attention forward for Hopper (sm_90a) in bf16 at the head dims
// whose fp32 output accumulator does not fit one warpgroup's registers
// beside its scores in the narrower kernel's block: 256 (Gemma's LM, and
// the memory at Gemma-2B's hidden size of 2048 over 8 heads) and 448 (the
// 7B model's memory, whose hidden size of 3584 is split over 8 heads). It
// is reached through flash_fwd (flash_fwd.cu) and, at 256, flash_fwd_lse
// (flash_train.cu) -> fwd_sm90::run, as the other head dims are. The two
// head dims have kernels of their own: flash_fwd_d256_kernel (and
// flash_fwd_lse_d256_kernel, the same with the lse epilogue) and
// flash_fwd_wide_kernel<448>.
//
// Replaces the TPU kernels
//   _flash_fwd_kernel  behind memory_augmented_vlm_tpu/ops/pallas_flash.py::
//                      pallas_flash_attention (#1) at those widths (the JAX
//                      model pads 448 to 512, a TPU lane alignment; here no
//                      pad), and
//   _fwd_lse_kernel    behind memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py::
//                      _forward_with_lse (#9) at 256 (Gemma training; no JAX
//                      path trains at 448, which refuses the lse),
// and computes their function at a key tile of BN = 64 keys (D = 256) or 32
// (D = 448):
//   - q is scaled by scale*log2(e) and rounded to bf16 before QK^T;
//   - per tile of BN keys, the running max m, alpha = exp2(m_prev - m_next),
//     p = exp2(s - m_next) rounded to bf16 for PV, l and the fp32
//     accumulator rescaled by alpha (the TPU kernel's `_accumulate` at
//     block_k = BN, so P is rounded against the running max of its tile);
//   - keys at or past kv_valid_len[b], and above the diagonal when causal,
//     score MASK_VALUE; tiles wholly past the valid length or above a
//     warpgroup's diagonal are skipped; a batch with valid length 0 gives
//     zeros;
//   - out = acc / l in bf16; with the lse epilogue also lse = m +
//     log2(max(l, 1e-30)) in log2 units, (B, H, Sq) fp32, -inf for a batch
//     with valid length 0, written by the warpgroup that owns the row.
//     Layout is bshd (strides, the head dim contiguous, rows on 16 bytes);
//     GQA reads K/V head h / kv_groups.
//
// What bounds it on the H100: arithmetic. The 7B memory's fuse (1568
// queries of 8 heads over 3136 valid keys) is 70 GFLOP of bf16 products,
// 0.07 ms at the dense peak; Gemma-2B's causal prefill of ~9.4k tokens (8
// heads of 256 over one KV head) is 362 GFLOP, 0.37 ms. Beside the
// products, shared memory: a QK^T whose operands both come from shared
// memory reads 128 bytes a clock at the tensor cores' full rate, all that
// shared memory gives an SM, and TMA writes every K/V tile there too (2.9
// GB of tiles at the prefill in 128-row blocks, 5.8 GB in 64-row ones).
//
// Head dim 256 (flash_fwd_d256_kernel). A warpgroup's 64 x 256 fp32
// accumulator is 128 registers a thread, beside 32 scores and 16 of P:
//   - a block is an item of the wrapper's work list (ops/flash.py):
//     (batch, query head, tile of 128 query rows), the longest loop first
//     when causal. Each of two warpgroups owns 64 of the rows at all 256
//     columns, so each score tile is computed once (the fuse's 8 x 1568
//     rows make 104 blocks, one wave on 132 SMs);
//   - no producer: 256 threads, so ptxas may give a thread 255 registers
//     (218 used for flash_fwd_d256_kernel, 220 with the lse epilogue, 0
//     spilled, no C7508, C7512 or C7520 warning). Thread 0 loads the
//     128-row q tile (64 KB, 64-column boxes, 128-byte swizzle) and the
//     first tiles of two rings, one of K tiles
//     and one of V tiles (2 slots of 32 KB each): a K slot frees as soon as
//     both warpgroups' QK^T has read it, a V slot after their PV. Every
//     warp counts itself out of a slot on a shared-memory counter, and the
//     last of the eight refills the slot by TMA with the ring's tile two
//     ahead; TMA zero-fills rows past the end of a tensor, so a ragged tail
//     (1568 = 12 x 128 + 32 rows) needs no mask;
//   - each warpgroup scales and rounds its 64 rows of the staged q in place;
//     QK^T is wgmma m64n64k16 with both operands K-major in shared memory
//     (16 k-steps), P is repacked from the score registers as the register
//     A operand of PV (acc_to_a), and PV is wgmma m64n64k16 per column
//     block, V read MN-major: per output element the wgmma sequence of the
//     64-row design before it, so the same bits;
//   - overlap inside a warpgroup: tile j's QK^T is issued, then tile j-1's
//     PV, and the warpgroup waits for QK^T alone (wgmma.wait_group 1), so
//     tile j's softmax runs while tile j-1's PV is on the tensor cores; the
//     accumulator is rescaled by tile j's alpha once that PV has landed,
//     and not at all where alpha is 1 on every row of the warp (exact);
//   - ping-pong between the warpgroups: they take turns to issue their
//     products (named barriers 3 and 4), so one's QK^T, whose operands both
//     come from shared memory, does not run beside the other's;
//   - a warpgroup stops at its own diagonal (causal) and, past it, only
//     counts itself out of the slots and takes its turns; a warpgroup whose
//     rows all lie past Sq computes nothing.
// Measured and rejected (NVIDIA H100 80GB HBM3, 700.00 W,
// microbench/flash_ab.py's timing; ms of ten calls back to back at Gemma-2B's
// prefill, 9472 rows of 8 heads over one KV head, causal): a producer
// warpgroup handing its registers to the consumers by setmaxnreg (24 / 240, a
// 384-thread block): ptxas budgets the 384-thread cap of 168 registers all
// the same (no C7508), spills 836 bytes and serialises every wgmma (C7512):
// 1.63 against the 64-row parent's 0.99 (the same code under a 256-thread
// bound fits in 206 registers, no spill, no serialisation); without the
// ping-pong 0.74-0.75; without the rescale skip 0.80; a K ring of three slots
// (224 KB) 0.75, no gain. The loads themselves cost ~0.17: with the K/V
// refills left out (wrong values, a timing probe) the kernel of that stage
// ran 0.63, not 0.80.
//
// Head dim 448 (flash_fwd_wide_kernel<448>): one 64-key K+V stage is 112 KB
// beside a 56 KB q tile, so two stages do not fit 227 KB; 32-key tiles. A
// block takes 64 rows; two consumer warpgroups own the same 64 rows and
// split the output's columns (blocks 0..3, 128 accumulator registers a
// thread, and 4..6); both compute the whole score tile S = Q K^T
// themselves (1.5x the minimal tensor work, and no exchange between them):
// the same wgmma sequence on the same shared operands gives both the same
// bits, hence the same softmax and the same P. A producer warp fills a
// ring of three 56 KB stages. The first warpgroup's accumulators alone are
// 128 of the 168 registers ptxas gives it, so it spills and serialises
// wgmma (C7512). Measured against that (PERF.md §6, the 448 row): a
// producer warpgroup handing registers to the consumers by setmaxnreg was
// 5-15% faster but still spilled (224 accumulators do not fit 240); three
// or four consumer warpgroups, with smaller shares of the columns each and
// S computed by each, 10-40% slower.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace mavlm {
namespace fwd_wide {
namespace {

using namespace sm90;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // pallas_flash.MASK_VALUE

struct Params {
  const int* valid_len;  // (B,)
  const int* items;      // (n_items, 3): batch, query head, tile of block rows
  __nv_bfloat16* o;      // bshd
  float* lse;            // (B, H, Sq), or null without the lse epilogue
  int Sq, Skv, H, kv_groups, causal;
  long long o_sb, o_ss, o_sh;
};

// The online softmax of one key tile's scores in place, for a thread of a
// warpgroup of 64 rows: element i of sc is row row0 + 8 ((i >> 1) & 1),
// key n0 + 8 (i >> 2) + 2t + (i & 1). Masks only where the valid length or
// the diagonal of the rows from q_first crosses the tile. Returns alpha per
// row in `alpha`; sc becomes p, m_run and l_run move on.
template <int BN, int NC>
__device__ __forceinline__ void online_softmax(float (&sc)[NC], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int n0,
                                               int kv_valid, int causal, int q_first, int row0,
                                               int t) {
  if (!(n0 + BN <= kv_valid && (!causal || n0 + BN - 1 <= q_first))) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (!(col < kv_valid && (!causal || col <= row))) sc[i] = kMaskValue;
    }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < NC; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(m_run[r] - mx[r]);  // 0 on the first tile (m_run = -inf)
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(sc[i] - mx[r]);
    sum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
}

// ------------------------------------------------------------ head dim 256

struct D256 {
  static constexpr int D = 256;
  static constexpr int WG_ROWS = 64;             // a consumer warpgroup's rows (wgmma M)
  static constexpr int BM = block_rows(D);       // query rows of a block: two warpgroups
  static constexpr int BN = key_tile(D);         // keys per K/V tile: QK^T's N
  static constexpr int CB = D / 64;              // 128-byte swizzled column blocks
  static constexpr int KSTEPS = D / 16;          // QK^T's 16-deep steps
  static constexpr int THREADS = 2 * 128;        // two consumer warpgroups, no producer
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NC = WG_ROWS * BN / 128;  // a thread's score accumulators
  // a ring of K tiles and one of V tiles; K's slot frees as soon as both
  // warpgroups' QK^T has read it, V's only after their PV
  static constexpr int K_SLOTS = 2, V_SLOTS = 2;
  static constexpr uint32_t Q_BLOCK = BM * kRowBytes;    // a 64-column block of the q tile
  static constexpr uint32_t Q_BYTES = CB * Q_BLOCK;
  static constexpr uint32_t KV_BLOCK = BN * kRowBytes;   // a 64-column block of a K or V tile
  static constexpr uint32_t TILE_BYTES = CB * KV_BLOCK;  // a K or V tile
  // K slots, V slots, the q tile, then a full barrier per slot (K's, then
  // V's), the q barrier and a counter per slot
  static constexpr int SLOTS = K_SLOTS + V_SLOTS;
  static constexpr uint32_t Q0 = SLOTS * TILE_BYTES;
  static constexpr uint32_t BARS = Q0 + Q_BYTES;
  static constexpr uint32_t COUNTERS = BARS + 8 * (SLOTS + 1);
  static constexpr size_t SMEM = COUNTERS + 4 * SLOTS + 1024;
  // ring v's (0: K, 1: V) slot of tile j, numbered over both rings, and the
  // parity of tile j's use of it
  static __device__ __forceinline__ int depth(int v) { return v ? V_SLOTS : K_SLOTS; }
  static __device__ __forceinline__ int slot(int v, int j) {
    return v ? K_SLOTS + j % V_SLOTS : j % K_SLOTS;
  }
  static __device__ __forceinline__ int parity(int v, int j) { return (j / depth(v)) & 1; }
  static_assert(BM == 2 * WG_ROWS && BN == 64, "two warpgroups of 64 rows, 64-key tiles");
  static_assert(TILE_BYTES % 1024 == 0, "1024-byte aligned swizzled blocks");
  static_assert(SMEM <= 227 * 1024, "the rings and the q tile fit one block's shared memory");
};

// The 256 kernel's body; LSE adds the lse epilogue (flash_fwd_lse). Both
// warpgroups compute; the last warp to finish with a K or V slot refills
// it with the tile two ahead.
template <bool LSE>
__device__ __forceinline__ void forward_d256(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                             const CUtensorMap& tm_v, const Params& p,
                                             const float scale_log2) {
  using T = D256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // `base` as a generic pointer
  const uint32_t q_tile = base + T::Q0;
  const uint32_t full0 = base + T::BARS;  // K slots', then V slots' full barriers
  const uint32_t q_bar = full0 + 8 * T::SLOTS;
  unsigned int* counters = reinterpret_cast<unsigned int*>(gbase + T::COUNTERS);

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], q0 = item[2] * T::BM;
  const int hk = h / p.kv_groups;
  const int kv_valid = max(min(p.valid_len[b], p.Skv), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + T::BM) : kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + T::BN - 1) / T::BN, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;

  // tile j of K (v = 0) or V (v = 1) into its slot
  auto load = [&](int v, int j) {
    const uint32_t slot = base + T::slot(v, j) * T::TILE_BYTES;
    const uint32_t full = full0 + 8 * T::slot(v, j);
    mbar_arrive_tx(full, T::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < T::CB; ++c) {
      tma_load(slot + c * T::KV_BLOCK, v ? &tm_v : &tm_k, full, 64 * c, j * T::BN, hk, b);
    }
  };
  auto wait_tile = [&](int v, int j) { mbar_wait(full0 + 8 * T::slot(v, j), T::parity(v, j)); };
  // this warp is done with tile j of K or V: the last of the eight refills
  // its slot with the ring's next tile for it
  auto done_with = [&](int v, int j) {
    const bool last = last_out<T::WARPS>(counters + T::slot(v, j));
    if (last && lane == 0 && j + T::depth(v) < n_tiles) {
      load(v, j + T::depth(v));
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::SLOTS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      counters[i] = 0;
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {  // the q tile and the first tiles of the rings
    mbar_arrive_tx(q_bar, T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < T::CB; ++c) {
      tma_load(q_tile + c * T::Q_BLOCK, &tm_q, q_bar, 64 * c, q0, h, b);
    }
    for (int j = 0; j < min(n_tiles, T::K_SLOTS); ++j) load(0, j);
    for (int j = 0; j < min(n_tiles, T::V_SLOTS); ++j) load(1, j);
  }

  const int q_first = q0 + wg * T::WG_ROWS;  // this warpgroup's first row
  const int row0 = q_first + wl * 16 + g;    // this thread's rows: row0, row0 + 8
  // this warpgroup's key tiles: the block's, cut at its own diagonal; none
  // when its rows all lie past Sq
  const int wg_end = p.causal ? min(kv_valid, q_first + T::WG_ROWS) : kv_valid;
  const int my_tiles = __shfl_sync(
      0xffffffffu, q_first < p.Sq ? min(n_tiles, (wg_end + T::BN - 1) / T::BN) : 0, 0);

  float o[T::CB][32];
#pragma unroll
  for (int cb = 0; cb < T::CB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sc[T::NC];
  uint32_t pa[T::BN / 16][4];

  auto qk_issue = [&](int j) {
    const uint32_t k_tile = base + T::slot(0, j) * T::TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      wgmma_ss_n64(sc, desc_kmajor(q_tile, T::BM, wg * T::WG_ROWS, kk),
                   desc_kmajor(k_tile, T::BN, 0, kk), kk);
    }
  };
  auto pv_issue = [&](int j) {
    const uint32_t v_tile = base + T::slot(1, j) * T::TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < T::CB; ++cb) {
        wgmma_rs_n64<1>(o[cb], pa[kk], desc_mnmajor(v_tile + cb * T::KV_BLOCK, T::BN, kk), 1);
      }
    }
  };

  // Ping-pong: the warpgroups take turns to issue their products (named
  // barriers 3 and 4), so that one's QK^T, which reads both operands from
  // shared memory, does not run beside the other's. Each takes n_tiles + 1
  // turns, issuing or not; warpgroup 0 goes first.
  int turn = 0;
  auto turn_wait = [&]() {
    if (wg == 0) {
      named_sync<3, 256>();
    } else {
      named_sync<4, 256>();
    }
  };
  auto turn_pass = [&]() {
    if (wg == 0) {
      named_arrive<4, 256>();
    } else if (turn < n_tiles) {  // warpgroup 1's last turn hands nothing on
      named_arrive<3, 256>();
    }
    ++turn;
  };
  if (wg == 1 && n_tiles > 0) named_arrive<3, 256>();

  if (my_tiles > 0) {
    // scale*log2(e) and the bf16 rounding applied to this warpgroup's rows
    // of the staged q tile in place (the swizzle moves 16-byte chunks within
    // a row, so every element stays in its row; TMA's zero fill maps to zero)
    mbar_wait(q_bar, 0);
    constexpr int kWords = T::WG_ROWS * kRowBytes / 4;  // bf16 pairs of a column block's rows
    for (int i = threadIdx.x & 127; i < T::CB * kWords; i += 128) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(
                              gbase + T::Q0 + (i / kWords) * T::Q_BLOCK +
                              wg * T::WG_ROWS * kRowBytes) + i % kWords;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(__low2float(v) * scale_log2, __high2float(v) * scale_log2);
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
    fence_async_smem();
    if (wg == 0) {
      named_sync<1, 128>();
    } else {
      named_sync<2, 128>();
    }

    float alpha[2];
    wait_tile(0, 0);
    turn_wait();
    wg_fence();
    qk_issue(0);
    wg_commit();
    turn_pass();
    wg_wait_all();
    reg_fence(sc);
    done_with(0, 0);
    online_softmax<T::BN>(sc, m_run, l_run, alpha, 0, kv_valid, p.causal, q_first, row0, t);
    acc_to_a(sc, pa);  // P rounded to bf16; the accumulator is zero: nothing to rescale
    for (int j = 1; j < my_tiles; ++j) {
      wait_tile(0, j);
      wait_tile(1, j - 1);
      turn_wait();
      wg_fence();
      qk_issue(j);
      wg_commit();
      pv_issue(j - 1);
      wg_commit();
      turn_pass();
      wg_wait<1>();  // tile j's QK^T; tile j-1's PV runs on under the softmax
      reg_fence(sc);
      done_with(0, j);
      online_softmax<T::BN>(sc, m_run, l_run, alpha, j * T::BN, kv_valid, p.causal, q_first,
                            row0, t);
      wg_wait_all();
#pragma unroll
      for (int cb = 0; cb < T::CB; ++cb) reg_fence(o[cb]);
      done_with(1, j - 1);
      // the rescale, skipped where it is exact already (alpha = 1 on every
      // row of the warp: the running max did not move)
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int cb = 0; cb < T::CB; ++cb) {
#pragma unroll
          for (int i = 0; i < 32; ++i) o[cb][i] *= alpha[(i >> 1) & 1];
        }
      }
      acc_to_a(sc, pa);
    }
    wait_tile(1, my_tiles - 1);
    turn_wait();
    wg_fence();
    pv_issue(my_tiles - 1);
    wg_commit();
    turn_pass();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < T::CB; ++cb) reg_fence(o[cb]);
    done_with(1, my_tiles - 1);
  }
  for (int j = my_tiles; j < n_tiles; ++j) {  // past this warpgroup's diagonal: count only
    turn_wait();  // a turn a tile, taken before waiting on it: the tile may wait on
    turn_pass();  // the other warpgroup's products, which wait on this turn
    wait_tile(0, j);
    done_with(0, j);
    wait_tile(1, j);
    done_with(1, j);
  }
  if (n_tiles > 0 && turn == n_tiles) {  // the last turn when no tile was issued
    turn_wait();
    turn_pass();
  }

  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh + 2 * t;
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
    __nv_bfloat16* orow = out + (long long)row * p.o_ss;
#pragma unroll
    for (int c = 0; c < 8 * T::CB; ++c) {  // columns 8c + 2t, +1
      const float* acc = &o[c / 8][4 * (c % 8) + 2 * r];
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16x2(acc[0] * inv, acc[1] * inv);
    }
  }
}

// The kernels of the two entry points, one name each, so that a profile
// tells them apart.
__global__ void __launch_bounds__(D256::THREADS, 1)
    flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p,
                          const float scale_log2) {
  forward_d256<false>(tm_q, tm_k, tm_v, p, scale_log2);
}

__global__ void __launch_bounds__(D256::THREADS, 1)
    flash_fwd_lse_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const Params p,
                              const float scale_log2) {
  forward_d256<true>(tm_q, tm_k, tm_v, p, scale_log2);
}

// ------------------------------------------------------------ head dim 448

// The kernel's geometry at head dim D.
template <int D>
struct Wide {
  static_assert(D == 448, "the column-split kernel serves head dim 448");
  static constexpr int BM = block_rows(D);  // query rows of a block (wgmma M)
  static constexpr int BN = key_tile(D);    // keys per K/V tile: QK^T's N
  static constexpr int CB = D / 64;         // 128-byte swizzled column blocks
  static constexpr int KSTEPS = D / 16;     // QK^T's 16-deep steps
  // Knob: the consumer warpgroups, which split the output's column blocks
  // (measured at 448: PERF.md §6).
  static constexpr int NWG = 2;
  static constexpr int THREADS = NWG * 128 + 32;  // and a producer warp
  static constexpr int NC = BM * BN / 128;        // a thread's score accumulators
  static constexpr int STAGES = 3;
  static constexpr uint32_t Q_BLOCK = BM * kRowBytes;    // a 64-column block of the q tile
  static constexpr uint32_t Q_BYTES = CB * Q_BLOCK;
  static constexpr uint32_t KV_BLOCK = BN * kRowBytes;   // a 64-column block of a K or V tile
  static constexpr uint32_t TILE_BYTES = CB * KV_BLOCK;  // a K or V tile
  static constexpr uint32_t STAGE = 2 * TILE_BYTES;      // K, then V
  static constexpr size_t SMEM = STAGES * STAGE + Q_BYTES + 8 * (2 * STAGES + 1) + 1024;
  static_assert(D % 64 == 0 && TILE_BYTES % 1024 == 0, "1024-byte aligned swizzled blocks");
  static_assert(SMEM <= 227 * 1024, "the ring and the q tile fit one block's shared memory");
};

// the output columns of consumer warpgroup WG: column blocks [first, first
// + count), the wider shares first (4 and 3 blocks of 64 at 448)
template <int D, int WG>
struct Cols {
  static constexpr int CB = Wide<D>::CB, NWG = Wide<D>::NWG;
  static constexpr int first = (WG * CB + NWG - 1) / NWG;
  static constexpr int count = ((WG + 1) * CB + NWG - 1) / NWG - first;
};

// The consumer side of a block, for warpgroup WG: its share of PV and of
// the output columns; both warpgroups run the same QK^T and softmax.
template <int D, int WG>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, uint32_t q_tile,
                                        uint32_t full0, uint32_t empty0, int n_tiles,
                                        int kv_valid, int q0, int b, int h) {
  using T = Wide<D>;
  constexpr int CB0 = Cols<D, WG>::first, NCB = Cols<D, WG>::count;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wl * 16 + g;  // this thread's rows: row0, row0 + 8

  float o[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sc[T::NC];
  uint32_t pa[T::BN / 16][4];

  auto qk_issue = [&](uint32_t k_tile) {
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      const uint64_t qd = desc_kmajor(q_tile, T::BM, 0, kk);
      const uint64_t kd = desc_kmajor(k_tile, T::BN, 0, kk);
      if constexpr (T::BN == 32) {
        wgmma_ss_n32(sc, qd, kd, kk);
      } else {
        wgmma_ss_n64(sc, qd, kd, kk);
      }
    }
  };
  auto pv_issue = [&](uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wgmma_rs_n64<1>(o[cb], pa[kk],
                        desc_mnmajor(v_tile + (CB0 + cb) * T::KV_BLOCK, T::BN, kk), 1);
      }
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };
  // The online softmax of tile j's scores in place: element i of sc is row
  // row0 + 8 ((i >> 1) & 1), key n0 + 8 (i >> 2) + 2t + (i & 1). Masks only
  // where the valid length or the diagonal crosses the tile. Returns alpha
  // per row; sc becomes p.
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int n0 = j * T::BN;
    if (!(n0 + T::BN <= kv_valid && (!p.causal || n0 + T::BN - 1 <= q0))) {
#pragma unroll
      for (int i = 0; i < T::NC; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (!(col < kv_valid && (!p.causal || col <= row))) sc[i] = kMaskValue;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < T::NC; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m_run[r] - mx[r]);  // 0 on the first tile (m_run = -inf)
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < T::NC; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(sc[i] - mx[r]);
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
  };

  if (n_tiles > 0) {
    float alpha[2];
    mbar_wait(full0, 0);
    wg_fence();
    qk_issue(base);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);
    softmax(0, alpha);  // the accumulator is zero: nothing to rescale
    acc_to_a(sc, pa);   // P rounded to bf16
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % T::STAGES, sp = (j - 1) % T::STAGES;
      mbar_wait(full0 + 8 * s, (j / T::STAGES) & 1);
      wg_fence();
      qk_issue(base + s * T::STAGE);
      pv_issue(base + sp * T::STAGE + T::TILE_BYTES);  // tile j-1's PV
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);
      release(sp);
      softmax(j, alpha);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cb][i] *= alpha[(i >> 1) & 1];
      }
      acc_to_a(sc, pa);
    }
    const int s = (n_tiles - 1) % T::STAGES;
    wg_fence();
    pv_issue(base + s * T::STAGE + T::TILE_BYTES);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);
    release(s);
  }

  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh + 64 * CB0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;  // a row that saw no key is zero
    __nv_bfloat16* orow = out + (long long)row * p.o_ss;
#pragma unroll
    for (int c = 0; c < 8 * NCB; ++c) {  // columns 8c + 2t, +1 of the owned blocks
      const float* acc = &o[c / 8][4 * (c % 8) + 2 * r];
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16x2(acc[0] * inv, acc[1] * inv);
    }
  }
}

// consume<D, wg>, the warpgroup index made a constant
template <int D, int WG>
__device__ __forceinline__ void consume_as(int wg, const Params& p, uint32_t base,
                                           uint32_t q_tile, uint32_t full0, uint32_t empty0,
                                           int n_tiles, int kv_valid, int q0, int b, int h) {
  if (wg == WG) {
    consume<D, WG>(p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
  } else if constexpr (WG + 1 < Wide<D>::NWG) {
    consume_as<D, WG + 1>(wg, p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
  }
}

// The kernel's body.
template <int D>
__device__ __forceinline__ void forward(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                        const CUtensorMap& tm_v, const Params& p,
                                        const float scale_log2) {
  using T = Wide<D>;
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
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + T::BN - 1) / T::BN, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * T::NWG);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * T::NWG) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c) {
        tma_load(q_tile + c * T::Q_BLOCK, &tm_q, q_bar, 64 * c, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % T::STAGES;
        const uint32_t k_tile = base + s * T::STAGE, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((j / T::STAGES) & 1) ^ 1);
        mbar_arrive_tx(full, T::STAGE);
#pragma unroll
        for (int c = 0; c < T::CB; ++c) {
          tma_load(k_tile + c * T::KV_BLOCK, &tm_k, full, 64 * c, j * T::BN, hk, b);
          tma_load(k_tile + T::TILE_BYTES + c * T::KV_BLOCK, &tm_v, full, 64 * c, j * T::BN,
                   hk, b);
        }
      }
    }
    return;
  }

  if (n_tiles > 0) {
    // scale*log2(e) and the bf16 rounding applied to the staged q tile in
    // place (the swizzle moves 16-byte chunks, so every element stays where
    // it is; TMA's zero fill maps to zero)
    mbar_wait(q_bar, 0);
    unsigned char* qs = smem_raw + (q_tile - raw);
    for (int i = threadIdx.x; i < static_cast<int>(T::Q_BYTES / 4); i += T::NWG * 128) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(qs) + i;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(__low2float(v) * scale_log2, __high2float(v) * scale_log2);
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;\n" :: "n"(T::NWG * 128) : "memory");  // the consumers
  }
  consume_as<D, 0>(warp >> 2, p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
}

template <int D>
__global__ void __launch_bounds__(Wide<D>::THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p,
                          const float scale_log2) {
  forward<D>(tm_q, tm_k, tm_v, p, scale_log2);
}

// ------------------------------------------------------------------ host

Params make_params(const fwd_sm90::Args& a) {
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
  return p;
}

// One launch of `kernel` (THREADS threads, SMEM bytes) over the items, q
// read in boxes of BM rows and K/V in boxes of BN.
template <int D, int BM, int BN, int THREADS, size_t SMEM, typename Kernel>
int launch(Kernel kernel, const fwd_sm90::Args& a, cudaStream_t stream) {
  const int hkv = a.H / a.kv_groups;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, D, a.Sq, a.H, a.B, a.q_st, BM) ||
      !make_map(&mk, a.k, D, a.Skv, hkv, a.B, a.k_st, BN) ||
      !make_map(&mv, a.v, D, a.Skv, hkv, a.B, a.v_st, BN)) {
    return kTmaRejected;
  }
  const int rc = set_smem(kernel, SMEM);
  if (rc != 0) return rc;
  kernel<<<a.n_items, THREADS, SMEM, stream>>>(mq, mk, mv, make_params(a), a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int run(const fwd_sm90::Args& a, int head_dim, void* stream) {
  if (a.lse != nullptr && head_dim != 256) return -1;  // no lse at 448
  if (!is_head_dim(head_dim)) return -1;
  if (a.block_rows != block_rows(head_dim)) return -3;
  if (a.n_items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 256) {
    using T = D256;
    return launch<256, T::BM, T::BN, T::THREADS, T::SMEM>(
        a.lse != nullptr ? flash_fwd_lse_d256_kernel : flash_fwd_d256_kernel, a, s);
  }
  using T = Wide<448>;
  return launch<448, T::BM, T::BN, T::THREADS, T::SMEM>(flash_fwd_wide_kernel<448>, a, s);
}

}  // namespace fwd_wide
}  // namespace mavlm
