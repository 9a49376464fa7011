// Flash-attention forward for Hopper (sm_90a) in bf16 at head dim 448: the
// 7B model's memory, whose hidden size of 3584 is split over 8 heads. It is
// reached through flash_fwd (flash_fwd.cu) -> fwd_sm90::run, as the other
// head dims are.
//
// Replaces the TPU kernel _flash_fwd_kernel behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py::pallas_flash_attention (#1)
// at the width where the JAX model pads 448 to 512 (a TPU lane alignment;
// here no pad), and computes its function at a key tile of 32:
//   - q is scaled by scale*log2(e) and rounded to bf16 before QK^T;
//   - per tile of 32 keys, the running max m, alpha = exp2(m_prev - m_next),
//     p = exp2(s - m_next) rounded to bf16 for PV, l and the fp32
//     accumulator rescaled by alpha (the TPU kernel's `_accumulate` at
//     block_k = 32, so P is rounded against the running max of its tile);
//   - keys at or past kv_valid_len[b], and above the diagonal when causal,
//     score MASK_VALUE; tiles wholly past the valid length or above the
//     block's diagonal are skipped; a batch with valid length 0 gives zeros;
//   - out = acc / l in bf16. Layout is bshd (strides, the head dim
//     contiguous, rows on 16 bytes); GQA reads K/V head h / kv_groups.
//
// What bounds it on the H100: arithmetic. The memory's fuse (1568 queries
// of 8 heads over 3136 valid keys) is 70 GFLOP of bf16 products, 0.07 ms
// at the dense peak; its bytes take a third of that.
//
// Why not the narrower kernel at D = 448: its accumulator would be 224 fp32
// registers a thread, and one 64-key K+V stage is 112 KB beside a 56 KB q
// tile, so two stages do not fit 227 KB. Design:
//   - a block is an item of the wrapper's work list (ops/flash.py): (batch,
//     query head, tile of 64 query rows), the longest loop first when
//     causal;
//   - two consumer warpgroups own the same 64 rows and split the output's
//     columns: the first the 64-column blocks 0..3 (256 columns, 128
//     accumulator registers a thread), the second blocks 4..6 (192). Both
//     compute the whole score tile S = Q K^T themselves (1.5x the minimal
//     tensor work, and no exchange between them): the same wgmma sequence
//     on the same shared operands gives both the same bits, hence the same
//     softmax and the same P;
//   - a producer warp issues TMA loads: the q tile once (seven 64-column
//     boxes, 128-byte swizzle), then K and V tiles of 32 keys into a ring of
//     three 56 KB stages (full: the bytes landed; empty: all eight consumer
//     warps are done). TMA zero-fills rows past the end of a tensor;
//   - the consumers scale and round the staged q tile in place; QK^T is 28
//     wgmma m64n32k16 with both operands K-major in shared memory; P is
//     repacked from the score registers as the register A operand of PV
//     (acc_to_a), and PV is wgmma m64n64k16 per owned column block, V read
//     MN-major. A warpgroup issues tile j's QK^T with tile j-1's PV and
//     waits once per tile, as the narrower kernel does;
//   - registers: the first warpgroup's accumulators alone are 128 a
//     thread, and ptxas gives a thread of this block 168, so it spills and
//     serialises wgmma (C7512). Measured against that (PERF.md §6, PR 13):
//     a producer warpgroup handing registers to the consumers by setmaxnreg
//     was 5-15% faster but still spilled (ptxas allocates the consumers 168
//     all the same); three or four consumer warpgroups, with smaller
//     shares of the columns each and S computed by each, 10-40% slower.

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

constexpr int D = kHeadDim;
constexpr int kBM = kBlockRows;     // query rows of a block (wgmma M)
constexpr int kBN = kKeyTile;       // keys per K/V tile: QK^T's N
constexpr int kCB = D / 64;         // 128-byte swizzled column blocks
constexpr int kKSteps = D / 16;     // QK^T's 16-deep steps
// Knob: the consumer warpgroups, which split the output's column blocks
// (measured: PERF.md §6, PR 13).
constexpr int kNWG = 2;
constexpr int kThreads = kNWG * 128 + 32;  // and a producer warp
constexpr int kNC = kBM * kBN / 128;  // a thread's score accumulators
constexpr int kStages = 3;
constexpr uint32_t kQBlock = kBM * kRowBytes;    // a 64-column block of the q tile
constexpr uint32_t kQBytes = kCB * kQBlock;
constexpr uint32_t kKVBlock = kBN * kRowBytes;   // a 64-column block of a K or V tile
constexpr uint32_t kTileBytes = kCB * kKVBlock;  // a K or V tile
constexpr uint32_t kStage = 2 * kTileBytes;      // K, then V
constexpr size_t kSmem = kStages * kStage + kQBytes + 8 * (2 * kStages + 1) + 1024;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // pallas_flash.MASK_VALUE
static_assert(D % 64 == 0 && kTileBytes % 1024 == 0, "1024-byte aligned swizzled blocks");
static_assert(kSmem <= 227 * 1024, "the ring and the q tile fit one block's shared memory");

// the output columns of consumer warpgroup WG: column blocks [first, first
// + count), the wider shares first (4 and 3 blocks of 64 for two)
template <int WG>
struct Cols {
  static constexpr int first = (WG * kCB + kNWG - 1) / kNWG;
  static constexpr int count = ((WG + 1) * kCB + kNWG - 1) / kNWG - first;
};

struct Params {
  const int* valid_len;  // (B,)
  const int* items;      // (n_items, 3): batch, query head, tile of kBM rows
  __nv_bfloat16* o;      // bshd
  int Sq, Skv, kv_groups, causal;
  long long o_sb, o_ss, o_sh;
};

// The consumer side of a block, for warpgroup WG: its share of PV and of
// the output columns; both warpgroups run the same QK^T and softmax.
template <int WG>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, uint32_t q_tile,
                                        uint32_t full0, uint32_t empty0, int n_tiles,
                                        int kv_valid, int q0, int b, int h) {
  constexpr int CB0 = Cols<WG>::first, NCB = Cols<WG>::count;
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
  float sc[kNC];
  uint32_t pa[kBN / 16][4];

  auto qk_issue = [&](uint32_t k_tile) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      wgmma_ss_n32(sc, desc_kmajor(q_tile, kBM, 0, kk), desc_kmajor(k_tile, kBN, 0, kk), kk);
    }
  };
  auto pv_issue = [&](uint32_t v_tile) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        wgmma_rs_n64<1>(o[cb], pa[kk], desc_mnmajor(v_tile + (CB0 + cb) * kKVBlock, kBN, kk),
                        1);
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
    const int n0 = j * kBN;
    if (!(n0 + kBN <= kv_valid && (!p.causal || n0 + kBN - 1 <= q0))) {
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
      const int s = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(full0 + 8 * s, (j / kStages) & 1);
      wg_fence();
      qk_issue(base + s * kStage);
      pv_issue(base + sp * kStage + kTileBytes);  // tile j-1's PV
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
    const int s = (n_tiles - 1) % kStages;
    wg_fence();
    pv_issue(base + s * kStage + kTileBytes);
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

// consume<wg>, the warpgroup index made a constant
template <int WG>
__device__ __forceinline__ void consume_as(int wg, const Params& p, uint32_t base,
                                           uint32_t q_tile, uint32_t full0, uint32_t empty0,
                                           int n_tiles, int kv_valid, int q0, int b, int h) {
  if (wg == WG) {
    consume<WG>(p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
  } else if constexpr (WG + 1 < kNWG) {
    consume_as<WG + 1>(wg, p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p,
                          const float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base + kStages * kStage;
  const uint32_t full0 = q_tile + kQBytes, empty0 = full0 + 8 * kStages;
  const uint32_t q_bar = empty0 + 8 * kStages;

  const int* item = p.items + 3 * blockIdx.x;
  const int b = item[0], h = item[1], q0 = item[2] * kBM;
  const int hk = h / p.kv_groups;
  const int kv_valid = max(min(p.valid_len[b], p.Skv), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + kBM) : kv_valid;
  // the block's key tiles, seen as uniform (wgmma behind a branch on a value
  // ptxas cannot prove warp-uniform is serialised)
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + kBN - 1) / kBN, 0);
  const int warp = warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kNWG);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kNWG) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_tx(q_bar, kQBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c) tma_load(q_tile + c * kQBlock, &tm_q, q_bar, 64 * c, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t k_tile = base + s * kStage, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_arrive_tx(full, kStage);
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          tma_load(k_tile + c * kKVBlock, &tm_k, full, 64 * c, j * kBN, hk, b);
          tma_load(k_tile + kTileBytes + c * kKVBlock, &tm_v, full, 64 * c, j * kBN, hk, b);
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
    for (int i = threadIdx.x; i < static_cast<int>(kQBytes / 4); i += kNWG * 128) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(qs) + i;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(__low2float(v) * scale_log2, __high2float(v) * scale_log2);
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;\n" :: "n"(kNWG * 128) : "memory");  // the consumers
  }
  consume_as<0>(warp >> 2, p, base, q_tile, full0, empty0, n_tiles, kv_valid, q0, b, h);
}

}  // namespace

int run(const fwd_sm90::Args& a, void* stream) {
  if (a.lse != nullptr) return -1;  // the lse entry point takes head dims 64 and 128
  if (a.block_rows != kBM) return -3;
  if (a.n_items == 0) return 0;
  const int hkv = a.H / a.kv_groups;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, D, a.Sq, a.H, a.B, a.q_st, kBM) ||
      !make_map(&mk, a.k, D, a.Skv, hkv, a.B, a.k_st, kBN) ||
      !make_map(&mv, a.v, D, a.Skv, hkv, a.B, a.v_st, kBN)) {
    return kTmaRejected;
  }
  Params p;
  p.valid_len = static_cast<const int*>(a.valid_len);
  p.items = static_cast<const int*>(a.items);
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.Sq = a.Sq;
  p.Skv = a.Skv;
  p.kv_groups = a.kv_groups;
  p.causal = a.causal;
  p.o_sb = a.o_st[0];
  p.o_ss = a.o_st[1];
  p.o_sh = a.o_st[2];
  const int rc = set_smem(flash_fwd_wide_kernel, kSmem);
  if (rc != 0) return rc;
  flash_fwd_wide_kernel<<<a.n_items, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, p, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd_wide
}  // namespace mavlm
