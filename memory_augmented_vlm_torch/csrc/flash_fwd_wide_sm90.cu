// Flash-attention forward for Hopper (sm_90a) in bf16 at the head dims
// whose fp32 output accumulator does not fit one warpgroup's registers
// beside its scores in the narrower kernel's block: 256 (Gemma's LM, and
// the memory at Gemma-2B's hidden size of 2048 over 8 heads) and 448 (the
// 7B model's memory, whose hidden size of 3584 is split over 8 heads). It
// is reached through flash_fwd (flash_fwd.cu) and, at 256, flash_fwd_lse
// (flash_train.cu) -> fwd_sm90::run, as the other head dims are. The two
// head dims have kernels of their own: flash_fwd_d256_kernel (and
// flash_fwd_lse_d256_kernel, the same with the lse epilogue) and
// flash_fwd_d448_kernel. Both run two warpgroups and no producer (256
// threads, so ptxas may give a thread 255 registers), K and V rings
// refilled by the last warp out, and compute each score tile once.
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
// Head dim 448 (flash_fwd_d448_kernel). A 64 x 448 fp32 accumulator does
// not fit one warpgroup's registers, and one 64-key K+V stage is 112 KB
// beside a 56 KB q tile, so 32-key tiles and 64-row blocks:
//   - a block is an item of the wrapper's work list, 64 query rows of one
//     head; two warpgroups share the rows and split the output's columns
//     (blocks 0..3, 128 accumulator registers a thread, and 4..6);
//   - each score tile is computed once: warpgroup j % 2 computes tile j's
//     S = Q K^T (28 k-steps of m64n32k16, both operands in shared memory),
//     the online softmax and P, and hands P's bf16 A fragments with the
//     rows' running max and sum to the other through a shared-memory
//     exchange (a 6 KB slot per scoring warpgroup, [3][128] uint4, full and
//     empty mbarriers); alpha is recomputed from the two maxima, so both
//     warpgroups rescale by the same bits. Each warpgroup adds P V for its
//     columns, tiles in ascending order: per element the parent's wgmma
//     sequence, so the same bits;
//   - no producer: 256 threads, 186 registers, 0 spilled, no C7508 and no
//     warning that wgmma is serialised. Thread 0 loads q (56 KB) and the first tiles of a K
//     ring (three 28 KB slots, each read by the four warps that score its
//     tile) and a V ring (two slots, read by all eight); the last warp out
//     of a slot refills it: 208 KB with q and the exchange;
//   - overlap: a warpgroup issues its tile's scores and, while they run,
//     takes over the other's previous tile; once they have landed it runs
//     its softmax and hands P over, then rescales and adds the other tile's
//     PV, then its own. Its products run under the other warpgroup's
//     softmax, and its softmax under the other's products. No other
//     instruction touches an accumulator while a product is in flight:
//     every wait is unconditional, with both accumulators pinned below it.
//     Each way of breaking that made ptxas serialise wgmma: a wait behind
//     `if (own)` left it a path on which the softmax read scores in flight
//     (C7514), the softmax under the other tile's PV wrote scores inside
//     that PV's stage (C7515), the accumulator rescaled under the scores
//     likewise (C7515): 0.364-0.382, 0.363-0.376 and 0.368-0.381 ms back to
//     back at the fuse;
//   - the rescale is skipped where alpha is 1 on every row of the warp.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, microbench/flash_ab.py, ms of
// ten calls back to back at the 7B memory's fuse, 1568 rows of 8 heads over
// 6272 keys, 3136 valid, where the parent's column-split kernel with a
// producer warp, 168 registers, 300 bytes spilled and C7512 ran
// 0.554-0.570): 0.282-0.290; at the evolve (15680 keys, 1568 valid) 0.155
// against 0.295-0.305. Timing probes of the serialised (C7514) form, wrong
// values: with the K/V refills left out 0.306 against 0.366, half of S's
// k-steps 0.298, half of PV's 0.330, no softmax 0.332. Rejected: a K ring
// of two slots and a V ring of three, 0.368 (serialised form).

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
  // a ring of K tiles and one of V tiles, two slots each; K's slot frees as
  // soon as both warpgroups' QK^T has read it, V's only after their PV
  using Ring = KvRings<2, 2, BN, CB>;
  static constexpr uint32_t Q_BLOCK = BM * kRowBytes;  // a 64-column block of the q tile
  static constexpr uint32_t Q_BYTES = CB * Q_BLOCK;
  // K slots, V slots, the q tile, then a full barrier per slot (K's, then
  // V's), the q barrier and a counter per slot
  static constexpr uint32_t Q0 = Ring::BYTES;
  static constexpr uint32_t BARS = Q0 + Q_BYTES;
  static constexpr uint32_t COUNTERS = BARS + 8 * (Ring::SLOTS + 1);
  static constexpr size_t SMEM = COUNTERS + 4 * Ring::SLOTS + 1024;
  static_assert(BM == 2 * WG_ROWS && BN == 64, "two warpgroups of 64 rows, 64-key tiles");
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
  const uint32_t q_bar = base + T::BARS + 8 * T::Ring::SLOTS;  // after the slots' barriers

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], q0 = item[2] * T::BM;
  const int hk = h / p.kv_groups;
  const T::Ring kv{base, base + T::BARS,
                   reinterpret_cast<unsigned int*>(gbase + T::COUNTERS), &tm_k, &tm_v, hk, b};
  const int kv_valid = max(min(p.valid_len[b], p.Skv), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + T::BM) : kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + T::BN - 1) / T::BN, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;

  auto wait_tile = [&](int v, int j) { kv.wait(v, j); };
  // this warp is done with tile j of K or V, which all eight warps read
  auto done_with = [&](int v, int j) { kv.done_with<T::WARPS>(v, j, n_tiles); };

  if (threadIdx.x == 0) {
    kv.init();
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
    kv.load_first(n_tiles);
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
    const uint32_t k_tile = kv.tile(0, j);
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      wgmma_ss_n64(sc, desc_kmajor(q_tile, T::BM, wg * T::WG_ROWS, kk),
                   desc_kmajor(k_tile, T::BN, 0, kk), kk);
    }
  };
  auto pv_issue = [&](int j) {
    const uint32_t v_tile = kv.tile(1, j);
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < T::CB; ++cb) {
        wgmma_rs_n64<1>(o[cb], pa[kk], desc_mnmajor(v_tile + cb * T::Ring::BLOCK, T::BN, kk), 1);
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

struct D448 {
  static constexpr int D = 448;
  static constexpr int BM = block_rows(D);       // query rows of a block (wgmma M)
  static constexpr int BN = key_tile(D);         // keys per K/V tile: QK^T's N
  static constexpr int CB = D / 64;              // 128-byte swizzled column blocks
  static constexpr int KSTEPS = D / 16;          // QK^T's 16-deep steps
  static constexpr int THREADS = 2 * 128;        // two consumer warpgroups, no producer
  static constexpr int NC = BM * BN / 128;       // a thread's score accumulators
  // warpgroup 0 owns the output's column blocks [0, SPLIT), warpgroup 1
  // [SPLIT, CB): 4 and 3 of the 7
  static constexpr int SPLIT = 4;
  // a ring of K tiles (three slots), each read by the warpgroup that
  // scores it (four warps), and one of V tiles (two), read by both (eight)
  using Ring = KvRings<3, 2, BN, CB>;
  static constexpr uint32_t Q_BLOCK = BM * kRowBytes;  // a 64-column block of the q tile
  static constexpr uint32_t Q_BYTES = CB * Q_BLOCK;
  // a scored tile handed to the other warpgroup: P's two k-steps of A
  // fragments, then the rows' running max and sum, one uint4 of each per
  // thread, laid out [3][128] (no bank conflicts)
  static constexpr uint32_t X_BYTES = 3 * 128 * 16;
  // K slots, V slots, the q tile, an exchange slot per scoring warpgroup,
  // then a full barrier per ring slot (K's, then V's), the q barrier, the
  // exchange's full and empty barriers and a counter per ring slot
  static constexpr uint32_t Q0 = Ring::BYTES;
  static constexpr uint32_t XBUF = Q0 + Q_BYTES;
  static constexpr uint32_t BARS = XBUF + 2 * X_BYTES;
  static constexpr uint32_t COUNTERS = BARS + 8 * (Ring::SLOTS + 1 + 4);
  static constexpr size_t SMEM = COUNTERS + 4 * Ring::SLOTS + 1024;
  static_assert(BM == 64 && BN == 32, "64 rows a block, 32-key tiles");
  static_assert(SMEM <= 227 * 1024, "the rings, the q tile and the exchange fit one block");
};

// The shared-memory layout and the block's item, as both warpgroups see
// them.
struct Block448 {
  uint32_t base, q_tile, xfull0, xempty0;
  unsigned char* gbase;  // `base` as a generic pointer
  D448::Ring kv;
  int b, h, q0, kv_valid, n_tiles;
};

// Warpgroup WG's side of a block. Tile j is scored by warpgroup j % 2: S =
// Q K^T (28 k-steps of m64n32k16), the online softmax and P, whose bf16 A
// fragments go to the other warpgroup with the rows' running max and sum.
// Each warpgroup then adds P V for its own columns, tiles in ascending
// order, rescaling by alpha first (alpha from the handed-over max). At step
// j a warpgroup issues its scores of tile j and takes over tile j - 1 while
// they run; once they have landed it computes tile j's softmax and hands P
// over, then issues tile j - 1's PV and, once that has landed, its own tile
// j's PV; every group is waited for inside the step.
template <int WG>
__device__ __forceinline__ void consume448(const Params& p, const Block448& k) {
  using T = D448;
  constexpr int CB0 = WG == 0 ? 0 : T::SPLIT, NCB = WG == 0 ? T::SPLIT : T::CB - T::SPLIT;
  const int warp = warp_index(), lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = k.q0 + wl * 16 + g;  // this thread's rows: row0, row0 + 8

  auto wait_tile = [&](int v, int j) { k.kv.wait(v, j); };
  // this warp is done with tile j of K (read by its four scoring warps) or
  // V (read by all eight)
  auto done_with = [&](int v, int j) {
    if (v) {
      k.kv.done_with<8>(1, j, k.n_tiles);
    } else {
      k.kv.done_with<4>(0, j, k.n_tiles);
    }
  };

  float o[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float sc[T::NC];
  uint32_t pa[T::BN / 16][4], xa[T::BN / 16][4];  // P of this warpgroup's tile, of the other's

  auto qk_issue = [&](int j) {
    const uint32_t k_tile = k.kv.tile(0, j);
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
      wgmma_ss_n32(sc, desc_kmajor(k.q_tile, T::BM, 0, kk), desc_kmajor(k_tile, T::BN, 0, kk),
                   kk);
    }
  };
  auto pv_issue = [&](const uint32_t (&f)[T::BN / 16][4], int j) {
    const uint32_t v_tile = k.kv.tile(1, j);
#pragma unroll
    for (int kk = 0; kk < T::BN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wgmma_rs_n64<1>(o[cb], f[kk],
                        desc_mnmajor(v_tile + (CB0 + cb) * T::Ring::BLOCK, T::BN, kk), 1);
      }
    }
  };
  auto o_fence = [&]() {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) reg_fence(o[cb]);
  };
  // the rescale, skipped where it is exact already (alpha = 1 on every row
  // of the warp: the running max did not move)
  auto rescale = [&](const float (&alpha)[2]) {
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[cb][i] *= alpha[(i >> 1) & 1];
      }
    }
  };
  auto xslot = [&](int owner) {
    return reinterpret_cast<uint4*>(k.gbase + T::XBUF + owner * T::X_BYTES);
  };
  // this warpgroup's tile j (its (j >> 1)-th) to its exchange slot
  auto publish = [&](int j) {
    mbar_wait(k.xempty0 + 8 * WG, ((j >> 1) & 1) ^ 1);
    uint4* x = xslot(WG);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      x[kk * 128 + tid] = make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
    }
    x[2 * 128 + tid] = make_uint4(__float_as_uint(m_run[0]), __float_as_uint(m_run[1]),
                                  __float_as_uint(l_run[0]), __float_as_uint(l_run[1]));
    mbar_arrive(k.xfull0 + 8 * WG);
  };
  // the other warpgroup's tile j from its slot: P into xa, the running max
  // and sum taken over, alpha from this warpgroup's max before it
  auto fetch = [&](int j, float (&alpha)[2]) {
    constexpr int owner = 1 - WG;
    mbar_wait(k.xfull0 + 8 * owner, (j >> 1) & 1);
    const uint4* x = xslot(owner);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 f = x[kk * 128 + tid];
      xa[kk][0] = f.x; xa[kk][1] = f.y; xa[kk][2] = f.z; xa[kk][3] = f.w;
    }
    const uint4 s = x[2 * 128 + tid];
    mbar_arrive(k.xempty0 + 8 * owner);
    const float m_new[2] = {__uint_as_float(s.x), __uint_as_float(s.y)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = fast_exp2(m_run[r] - m_new[r]);  // as the scoring warpgroup computed it
      m_run[r] = m_new[r];
    }
    l_run[0] = __uint_as_float(s.z);
    l_run[1] = __uint_as_float(s.w);
  };

  // No instruction but a wgmma touches an accumulator while a product is in
  // flight (ptxas serialises wgmma otherwise: C7514 for a read, C7515 for a
  // write), so tile j's softmax runs before tile j - 1's PV is issued, and
  // the accumulator is rescaled only after every product has landed.
  for (int j = WG; j <= k.n_tiles; j += 2) {
    const bool own = j < k.n_tiles, other = j >= 1;  // tiles j (this one's) and j - 1
    if (own) {
      wait_tile(0, j);
      wg_fence();
      qk_issue(j);
      wg_commit();
    }
    float alpha[2], alpha_x[2];  // of tile j, of tile j - 1
    if (other) fetch(j - 1, alpha_x);
    // Tile j's scores. The wait is outside `if (own)`: ptxas does not see
    // that the two branches agree, and a wait behind one would leave it a
    // path on which the softmax reads the scores in flight (C7514). Both
    // accumulators are pinned below it, so that no rescale of o is
    // scheduled inside the scores' stage (C7515).
    wg_wait_all();
    reg_fence(sc);
    o_fence();
    if (own) {
      done_with(0, j);
      online_softmax<T::BN>(sc, m_run, l_run, alpha, j * T::BN, k.kv_valid, p.causal, k.q0,
                            row0, t);
      acc_to_a(sc, pa);  // P rounded to bf16
      publish(j);
    }
    if (other) {
      if (j - 1 > 0) rescale(alpha_x);  // on the first tile the accumulator is zero
      wait_tile(1, j - 1);
      wg_fence();
      pv_issue(xa, j - 1);
      wg_commit();
    }
    wg_wait_all();
    o_fence();
    if (other) done_with(1, j - 1);
    if (own) {
      if (j > 0) rescale(alpha);
      wait_tile(1, j);
      wg_fence();
      pv_issue(pa, j);
      wg_commit();
      wg_wait_all();
      o_fence();
      done_with(1, j);
    }
  }

  __nv_bfloat16* out = p.o + k.b * p.o_sb + k.h * p.o_sh + 64 * CB0 + 2 * t;
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

__global__ void __launch_bounds__(D448::THREADS, 1)
    flash_fwd_d448_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p,
                          const float scale_log2) {
  using T = D448;
  extern __shared__ unsigned char smem_raw[];
  Block448 k;
  const uint32_t raw = smem_u32(smem_raw);
  k.base = (raw + 1023u) & ~1023u;
  k.gbase = smem_raw + (k.base - raw);
  k.q_tile = k.base + T::Q0;
  const uint32_t q_bar = k.base + T::BARS + 8 * T::Ring::SLOTS;  // after the slots' barriers
  k.xfull0 = q_bar + 8;
  k.xempty0 = k.xfull0 + 16;

  const int* item = p.items + 3 * blockIdx.x;
  k.b = item[0];
  k.h = item[1];
  k.q0 = item[2] * T::BM;
  k.kv = {k.base, k.base + T::BARS, reinterpret_cast<unsigned int*>(k.gbase + T::COUNTERS),
          &tm_k, &tm_v, k.h / p.kv_groups, k.b};
  k.kv_valid = max(min(p.valid_len[k.b], p.Skv), 0);
  const int kv_end = p.causal ? min(k.kv_valid, k.q0 + T::BM) : k.kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  k.n_tiles = __shfl_sync(0xffffffffu, (kv_end + T::BN - 1) / T::BN, 0);

  if (threadIdx.x == 0) {
    k.kv.init();
    mbar_init(q_bar, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(k.xfull0 + 8 * w, 128);   // the scoring warpgroup's threads
      mbar_init(k.xempty0 + 8 * w, 128);  // the other's
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (k.n_tiles > 0) {
    if (threadIdx.x == 0) {  // the q tile and the first tiles of the rings
      mbar_arrive_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CB; ++c) {
        tma_load(k.q_tile + c * T::Q_BLOCK, &tm_q, q_bar, 64 * c, k.q0, k.h, k.b);
      }
      k.kv.load_first(k.n_tiles);
    }
    // scale*log2(e) and the bf16 rounding applied to the staged q tile in
    // place (the swizzle moves 16-byte chunks within a row, so every element
    // stays in its row; TMA's zero fill maps to zero)
    mbar_wait(q_bar, 0);
    for (int i = threadIdx.x; i < static_cast<int>(T::Q_BYTES / 4); i += T::THREADS) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(k.gbase + T::Q0) + i;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(__low2float(v) * scale_log2, __high2float(v) * scale_log2);
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
    fence_async_smem();
    __syncthreads();
  }
  if (warp_index() < 4) {
    consume448<0>(p, k);
  } else {
    consume448<1>(p, k);
  }
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
  using T = D448;
  return launch<448, T::BM, T::BN, T::THREADS, T::SMEM>(flash_fwd_d448_kernel, a, s);
}

}  // namespace fwd_wide
}  // namespace mavlm
