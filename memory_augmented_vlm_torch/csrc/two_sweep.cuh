// The two-sweep bf16 attention shared by flash_merge.cu (the merge-heads
// attention, #2, and the attention stage of #5) and attn_block.cu (the
// attention stage of #12), for Hopper (sm_90a).
//
// Per (batch, head), the keys past kv_end = valid > 0 ? min(valid, S) : S
// are left out (they give p = 0); keys in [valid, S) take the policy's
// finite mask score, so a batch with valid length 0 weighs all S keys
// alike. Two sweeps over the keys instead of an online softmax: the first
// finds the row max, the second computes p against that final max, l and
// PV. The TPU kernels round P to bf16 against the final max; an online
// softmax would round it against running maxima and differ. The second
// QK^T costs a third more tensor-core work.
//
// What bounds it on the H100: at the tower's shape (B 64, 16 heads, S 729,
// D 72) the two products are 156.7 GFLOP of bf16 work, 0.158 ms at the
// tensor cores' peak; the kernel issues ~1.85x that (QK^T twice, its depth
// padded to 80, PV's width to 80, q rows padded to 768).
//
// Design:
//   - a block is 192 query rows of one head (128 at D = 128): consumer
//     warpgroups of 64 rows and a producer warp. Three warpgroups cap a
//     thread at 128 registers, which the q tile in shared memory leaves
//     room for at D <= 72; each waits on its own products, so the SM needs
//     as many as fit (a fourth spills). Per head K is read 8 times and V 4
//     times at S = 729; the mma.sync kernel it replaces read them 24 and
//     12 times, staged with plain loads between two barriers, and
//     transposed V by scalar stores;
//   - the producer warp issues TMA loads (tensor maps encoded on the host
//     and passed as __grid_constant__ parameters): the block's q tile once,
//     then into a ring of four stages (three at D = 128) tracked by
//     mbarriers (full: the bytes landed; empty: every consumer warp is
//     done) K tiles of 64 keys for sweep 1, then K and V tiles for sweep 2.
//     TMA zero-fills rows past S;
//   - products are wgmma: QK^T as m64n64k16 with A = the q tile (q_in
//     applied and rounded to bf16 in place once) and B = the K tile, both
//     K-major as they lie in memory; PV as m64n64k16 per 64-column block
//     (and a narrow product, below) with A = P, rounded to bf16 in the
//     score accumulator's registers (its layout is the A fragment's), and
//     B = the V tile read MN-major: no transposed copy is staged;
//   - head dim 72 (and 32): a 144-byte row does not fit TMA's 128-byte
//     swizzle, and QK^T's depth must be a multiple of 16. A tile is staged
//     as the 128-byte swizzled blocks of its first 64 columns (the layout
//     of flash_bwd_sm90.cu) plus one narrow block of what is left, 16 columns wide with a
//     32-byte swizzle (64..79; TMA fills 72..79 with zeros, so QK^T's fifth
//     k-step reads zeros there and PV's narrow n16 product writes columns
//     72..79 that are dropped), or 32 wide with a 64-byte swizzle at D = 32.
//     Both blocks keep the descriptor conventions of the 128-byte layout;
//     the alternative, an unswizzled 3-d map of 16-byte chunks, would cut
//     every TMA request to 16 bytes;
//   - overlap: each warpgroup waits for its own products before its
//     elementwise work; the other warpgroup's products run meanwhile. Sweep
//     1 issues two tiles' QK^T per wait, sweep 2 a tile's PV with the next
//     tile's QK^T. Branches that wgmma sits behind test values broadcast
//     from lane 0, which ptxas can see are warp-uniform (else it serialises
//     the products, C7520).
//
// What differs between the kernels that run it is a policy type P, passed
// by value as the kernel's parameter:
//   const __nv_bfloat16 *q, *k, *v;   // (B, NH, S, D), contiguous
//   int NH, S;
//   static constexpr float kMask;     // score of a key in [valid, S)
//   int valid(int b) const;           // batch b's valid key count
//   float q_in(float x) const;        // q's value, rounded to bf16 after
//   float logit(float qk) const;      // the score from the fp32 q.k
//   float prob(float s, float m) const;  // p of score s against row max m
//   template <int D> void store(int b, int h, int row, int t,
//                               const float (&acc)[D / 8][4], int r,
//                               float l) const;
// store is called for each of a thread's two rows (r = 0, 1: row g and
// g + 8 of its warp's 16) by every lane of the warp, rows past S included,
// with the un-normalised P.V in acc[.][2r], acc[.][2r + 1] (columns
// dt * 8 + 2t, +1) and the row's l; it may use warp shuffles. (A wgmma
// accumulator has, per warp, the layout of mma.sync's m16n8 C fragment.)

#pragma once

#include <cuda.h>
#include <math.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace mavlm {
namespace two_sweep {

constexpr int kWgRows = 64;  // query rows of a consumer warpgroup (wgmma M)
constexpr int kBN = 64;      // keys per K/V tile: QK^T's N
constexpr int kNC = kBN / 2;  // a thread's score accumulators
constexpr int kTPR = 2;      // sweep 1's tiles per wait

// A block's shape, and a K or V tile of kBN rows in shared memory: CB
// 128-byte swizzled blocks of 64 columns, then a narrow block of W columns
// (W = 0 when D is a multiple of 64).
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 72 || D == 128, "head dims 32, 64, 72, 128");
  // consumer warpgroups: three where a thread's registers fit in 128 (the
  // cap at 13 warps), two at D = 128
  static constexpr int NWG = D == 128 ? 2 : 3;
  static constexpr int BM = NWG * kWgRows;    // query rows per block
  static constexpr int THREADS = NWG * 128 + 32;  // and a producer warp
  static constexpr int CB = D / 64;
  static constexpr int W = (D % 64 + 15) / 16 * 16;  // 16 at D = 72, 32 at D = 32
  static constexpr int NROW = 2 * W;                 // bytes of a narrow row
  static constexpr uint32_t BLOCK = kBN * 128;
  static constexpr uint32_t BYTES = CB * BLOCK + kBN * NROW;
  static constexpr uint32_t STAGE = (2 * BYTES + 1023) / 1024 * 1024;  // K, then V
  static constexpr int KSTEPS = 4 * CB + W / 16;     // QK^T's 16-deep steps
  // the block's q tile, laid out as a K tile of BM rows
  static constexpr uint32_t Q_BLOCK = BM * 128;
  static constexpr uint32_t Q_BYTES = (CB * Q_BLOCK + BM * NROW + 1023) / 1024 * 1024;
  // ring depth: four stages where they fit in 227 KB beside the q tile
  static constexpr int STAGES = 4 * STAGE + Q_BYTES + 2048 <= 227 * 1024 ? 4 : 3;
  static constexpr size_t SMEM = STAGES * STAGE + Q_BYTES + 8 * (2 * STAGES + 1) + 1024;
};

// a tile of `rows` rows at row0: its 64-column blocks (`block` bytes each)
// and its narrow block
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t block, int rows,
                                          const CUtensorMap* wide, const CUtensorMap* narrow,
                                          uint32_t bar, int row0, int h, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::CB; ++c) sm90::tma_load(dst + c * block, wide, bar, 64 * c, row0, h, b);
  if constexpr (T::W > 0) sm90::tma_load(dst + T::CB * block, narrow, bar, 64 * T::CB, row0, h, b);
}

// K-major descriptor of k-step kk of a tile (CB blocks of `block` bytes,
// then the narrow block), rows from row0
template <int D>
__device__ __forceinline__ uint64_t desc_tile(uint32_t tile, uint32_t block, int rows, int row0,
                                              int kk) {
  using T = Tile<D>;
  return kk < 4 * T::CB
      ? sm90::desc_kmajor(tile, rows, row0, kk)
      : sm90::desc_kmajor_narrow(tile + T::CB * block + row0 * T::NROW, T::NROW, kk - 4 * T::CB);
}

// issues sc (64 x 64, fp32) = Q K^T of this warpgroup's rows (q_row0 of
// the q tile) against a K tile; the caller fences, commits and waits
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[kNC], uint32_t q_tile, int q_row0,
                                         uint32_t k_tile) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    const uint64_t da = desc_tile<D>(q_tile, T::Q_BLOCK, T::BM, q_row0, kk);
    const uint64_t db = desc_tile<D>(k_tile, T::BLOCK, kBN, 0, kk);
    sm90::wgmma_ss_n64(sc, da, db, kk);
  }
}

// sc = Q K^T, waited for
template <int D>
__device__ __forceinline__ void qk(float (&sc)[kNC], uint32_t q_tile, int q_row0, uint32_t k_tile) {
  sm90::wg_fence();
  qk_issue<D>(sc, q_tile, q_row0, k_tile);
  sm90::wg_commit();
  sm90::wg_wait_all();
  sm90::reg_fence(sc);
}

// issues o += P V: one n64 product per 64-column block of the V tile and
// one of width W over its narrow block; the caller fences, commits and
// waits
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[Tile<D>::CB > 0 ? Tile<D>::CB : 1][32],
                                         float (&on)[Tile<D>::W > 0 ? Tile<D>::W / 2 : 1],
                                         const uint32_t (&pa)[kBN / 16][4], uint32_t v_tile) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int cb = 0; cb < T::CB; ++cb) {
      sm90::wgmma_rs_n64<1>(o[cb], pa[kk], sm90::desc_mnmajor(v_tile + cb * T::BLOCK, kBN, kk), 1);
    }
    const uint64_t dn =
        sm90::desc_mnmajor_narrow(v_tile + T::CB * T::BLOCK, kBN, T::NROW, kk);
    if constexpr (T::W == 16) sm90::wgmma_rs_n16<1>(on, pa[kk], dn, 1);
    if constexpr (T::W == 32) sm90::wgmma_rs_n32<1>(on, pa[kk], dn, 1);
  }
}

template <int D, class P>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_qn,
           const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_kn,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_vn,
           const P p) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base + T::STAGES * T::STAGE;
  const uint32_t full0 = q_tile + T::Q_BYTES, empty0 = full0 + 8 * T::STAGES;
  const uint32_t q_bar = empty0 + 8 * T::STAGES;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T::BM;
  const int S = p.S;
  const int valid = p.valid(b);
  const int kv_end = valid > 0 ? min(valid, S) : S;
  // each sweep's tiles (the ring runs 2 n_tiles), seen as uniform
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + kBN - 1) / kBN, 0);
  const int warp = sm90::warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 4 * T::NWG);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * T::NWG) {  // the producer warp
    if (lane == 0) {
      sm90::mbar_arrive_tx(q_bar, T::CB * T::Q_BLOCK + T::BM * T::NROW);
      load_tile<D>(q_tile, T::Q_BLOCK, T::BM, &tm_q, &tm_qn, q_bar, q0, h, b);
      for (int j = 0; j < 2 * n_tiles; ++j) {
        const int s = j % T::STAGES, n0 = (j % n_tiles) * kBN;
        const bool with_v = j >= n_tiles;
        const uint32_t k_tile = base + s * T::STAGE, full = full0 + 8 * s;
        sm90::mbar_wait(empty0 + 8 * s, ((j / T::STAGES) & 1) ^ 1);
        sm90::mbar_arrive_tx(full, (with_v ? 2 : 1) * T::BYTES);
        load_tile<D>(k_tile, T::BLOCK, kBN, &tm_k, &tm_kn, full, n0, h, b);
        if (with_v) load_tile<D>(k_tile + T::BYTES, T::BLOCK, kBN, &tm_v, &tm_vn, full, n0, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * kWgRows + wl * 16 + g;  // this thread's rows: row0, row0 + 8
  // q_in(q), rounded to bf16, in place: an elementwise map of the staged q
  // tile (the swizzle moves 16-byte chunks, so every element stays where it
  // is; TMA's zero fill past S and D maps to zero)
  sm90::mbar_wait(q_bar, 0);
  {
    unsigned char* qs = smem_raw + (q_tile - raw);
    for (int i = threadIdx.x; i < (T::CB * T::Q_BLOCK + T::BM * T::NROW) / 4;
         i += T::NWG * 128) {
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(qs) + i;
      const __nv_bfloat162 v = *x;
      const uint32_t y = pack_bf16x2(p.q_in(__low2float(v)), p.q_in(__high2float(v)));
      *x = *reinterpret_cast<const __nv_bfloat162*>(&y);
    }
  }
  sm90::fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" :: "n"(T::NWG * 128) : "memory");  // the consumers
  const int q_row0 = wg * kWgRows;  // this warpgroup's rows of the q tile

  // Scores of the warpgroup's rows against keys [n0, n0 + kBN): element i
  // of sc is row row0 + 8 ((i >> 1) & 1), key n0 + 8 (i >> 2) + 2t + (i & 1).
  // Keys at or past S are not keys (-inf, p = 0); keys at or past valid get
  // P::kMask.
  auto scores = [&](float (&sc)[kNC], int n0) {
    const bool inside = n0 + kBN <= min(valid, S);
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      float x = p.logit(sc[i]);
      if (!inside) {
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (col >= S) {
          x = -INFINITY;
        } else if (col >= valid) {
          x = P::kMask;
        }
      }
      sc[i] = x;
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
  };

  // sweep 1: the row max over every key, kTPR tiles per round trip to the
  // tensor cores (a round past the last tile takes that tile again: no
  // wgmma sits behind a branch)
  float sc[kTPR][kNC];
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; j += kTPR) {
    int st[kTPR];
#pragma unroll
    for (int u = 0; u < kTPR; ++u) {
      st[u] = (j + u < n_tiles ? j + u : j) % T::STAGES;
      if (j + u < n_tiles) sm90::mbar_wait(full0 + 8 * st[u], ((j + u) / T::STAGES) & 1);
    }
    sm90::wg_fence();
#pragma unroll
    for (int u = 0; u < kTPR; ++u) qk_issue<D>(sc[u], q_tile, q_row0, base + st[u] * T::STAGE);
    sm90::wg_commit();
    sm90::wg_wait_all();
#pragma unroll
    for (int u = 0; u < kTPR; ++u) {
      sm90::reg_fence(sc[u]);
      if (j + u < n_tiles) release(st[u]);
    }
#pragma unroll
    for (int u = 0; u < kTPR; ++u) {
      if (j + u >= n_tiles) break;
      scores(sc[u], (j + u) * kBN);
#pragma unroll
      for (int i = 0; i < kNC; ++i) m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], sc[u][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's max over its quad's threads
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // sweep 2: p against the final max, l and PV
  float o[T::CB > 0 ? T::CB : 1][32], on[T::W > 0 ? T::W / 2 : 1];
#pragma unroll
  for (int cb = 0; cb < (T::CB > 0 ? T::CB : 1); ++cb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (T::W > 0 ? T::W / 2 : 1); ++i) on[i] = 0.f;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  {  // tile 0's scores; from then on a tile's PV and the next tile's QK^T
     // go to the tensor cores together (P has its own registers by then),
     // so each tile costs one wait
    const int s = n_tiles % T::STAGES;
    sm90::mbar_wait(full0 + 8 * s, (n_tiles / T::STAGES) & 1);
    qk<D>(sc[0], q_tile, q_row0, base + s * T::STAGE);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int jj = n_tiles + j, s = jj % T::STAGES;
    float (&s0)[kNC] = sc[0];
    scores(s0, j * kBN);
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      const int r = (i >> 1) & 1;
      s0[i] = p.prob(s0[i], m_row[r]);
      l_run[r] += s0[i];
    }
    uint32_t pa[kBN / 16][4];
    sm90::acc_to_a(s0, pa);  // P rounded to bf16
    sm90::wg_fence();
    pv_issue<D>(o, on, pa, base + s * T::STAGE + T::BYTES);
    if (j + 1 < n_tiles) {
      const int s2 = (jj + 1) % T::STAGES;
      sm90::mbar_wait(full0 + 8 * s2, ((jj + 1) / T::STAGES) & 1);
      qk_issue<D>(s0, q_tile, q_row0, base + s2 * T::STAGE);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < (T::CB > 0 ? T::CB : 1); ++cb) sm90::reg_fence(o[cb]);
    sm90::reg_fence(on);
    sm90::reg_fence(s0);
    release(s);
  }

  float acc[D / 8][4];  // columns 8 c .. 8 c + 7: a 64-column block's, or the narrow one's
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[c][e] = c < 8 * T::CB ? o[c / 8][4 * (c % 8) + e] : on[4 * (c - 8 * T::CB) + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    p.template store<D>(b, h, row0 + 8 * r, t, acc, r, l);
  }
}

// Encodes the tensor maps of q, k and v and launches; returns 0, -4 when a
// tensor map is refused, or a cudaError_t.
template <int D, class P>
int launch(const P& p, int B, cudaStream_t stream) {
  using T = Tile<D>;
  // (batch, sequence, head) strides of the (B, NH, S, D) tensors, in elements
  const long long st[3] = {static_cast<long long>(p.NH) * p.S * D, D,
                           static_cast<long long>(p.S) * D};
  CUtensorMap m[6];  // q, k, v: boxes of 64 columns and of the narrow block
  for (int i = 0; i < 3; ++i) {
    const void* x = i == 0 ? static_cast<const void*>(p.q)
                           : i == 1 ? static_cast<const void*>(p.k) : static_cast<const void*>(p.v);
    const int rows = i == 0 ? T::BM : kBN;
    if (T::CB > 0 && !sm90::make_map(&m[2 * i], x, D, p.S, p.NH, B, st, rows)) {
      return sm90::kTmaRejected;
    }
    if (T::W > 0 &&
        !sm90::make_map(&m[2 * i + 1], x, D, p.S, p.NH, B, st, rows, T::W,
                        T::W == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B)) {
      return sm90::kTmaRejected;
    }
    if (T::CB == 0) m[2 * i] = m[2 * i + 1];
    if (T::W == 0) m[2 * i + 1] = m[2 * i];
  }
  const auto kern = kernel<D, P>;
  const int rc = sm90::set_smem(kern, T::SMEM);
  if (rc != 0) return rc;
  kern<<<dim3((p.S + T::BM - 1) / T::BM, p.NH, B), T::THREADS, T::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace two_sweep
}  // namespace mavlm
