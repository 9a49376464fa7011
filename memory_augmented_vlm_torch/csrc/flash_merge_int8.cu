// The approximate int8_scores mode of the merge-heads attention for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the int8_scores branch (pallas_flash.py:279-313) of the TPU
// kernel `_flash_merge_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py:330
// flash_attention_merge_heads(int8_scores=True), and computes the same
// function, per (batch, head):
//   - qf = q * scale * log2(e) in fp32 (not rounded to bf16), one scale
//     sq = max(|qf|, 1e-12) / 127 per tile of `tile` query rows (the last
//     tile may be ragged);
//   - one scale sk and one sv over ALL S rows of k and v, masked keys
//     included;
//   - codes clip(rint(x * (1/s)), -127, 127), rint rounding half to even;
//   - s = raw * (sq * sk) with raw the int32 product of the codes, the
//     finite MASK_VALUE at or past kv_valid_len[b];
//   - m = the row max, p = exp2(s - m), l = sum(p) in fp32 over the
//     unrounded p, P = rint(p * 127) in int8;
//   - out = (P . vq)(int32) * ((sv / 127) / l), bf16, merged heads
//     (B, S, NH * D).
// A batch with valid length 0 gives every key p = 1: its rows are the mean
// of the dequantised V.
//
// What bounds it on the H100: at the tower's shape (B 64, 16 heads, S 729,
// D 72) the two products are 156.7 GOP of int8 work (0.079 ms at 1,979
// TOP/s), but q, k, v and out are 0.27 GB of bf16 (0.081 ms at 3.35 TB/s),
// and the codes add 0.13 GB written and read back: bytes bound it.
//
// Design: two launches on one stream.
//   1. merge_int8_prep: one block per (batch, head) and tensor (k or v)
//      reads the head once (729 x 72 bf16 = 105 KB, staged in shared
//      memory when it fits), takes the max, and writes the scale and the
//      codes: K codes K-major (B * NH, S, DK) with the depth zero-padded to
//      DK = 96; V codes transposed (B * NH, D, S16), S rounded up to 16,
//      because 8-bit wgmma takes only K-major operands and PV's reduction
//      dim is the keys. Each element is quantized once, where the mma.sync
//      kernel this replaces requantized K in both sweeps of every q block
//      (24 times per head) and V 12 times, after a separate scale pass.
//   2. merge_int8: a block is 128 query rows of one head, two consumer
//      warpgroups of 64 rows and a producer warp. The block takes
//      its q tiles' scales itself (merge_q_tile is 32 at S = 729, so the
//      block holds whole tiles; a tile that crosses the block is read whole
//      all the same) and keeps its q codes in registers as QK^T's A
//      fragments. The producer warp feeds a ring by TMA (rows past the
//      ends zero-filled): K code tiles of 64 keys (128-byte rows, 128-byte
//      swizzle) for sweep 1, K and V^T code tiles (64-byte rows of keys,
//      64-byte swizzle) for sweep 2. QK^T is a wgmma m64n64k32 .s8 with an
//      s32 accumulator, rescaled by sq * sk; PV is a wgmma m64n{DV}k32 .s8
//      (DV = D rounded up to 16: 80 at D = 72, the V^T rows 72..79 read as
//      zeros) with A = the P codes from registers. 64-key tiles keep the
//      products' registers within a thread's 168 (128-key tiles spilled).
//      Sweep 1 takes a tile's row max on the integer products and scales
//      it once; sweep 2 issues a tile's PV with the next tile's QK^T. A
//      thread's score accumulator holds keys {2t, 2t + 1} of each 8-key
//      chunk, but the 8-bit A fragment wants keys {4t .. 4t + 3} (and 16 +
//      those) of a 32-key step (the PTX ISA's register fragment of the k32
//      8-bit wgmma, CUTLASS's ALayout_64x32). A contraction's order is
//      free, so V^T's keys are stored in the order in which a thread's four
//      P codes are consecutive (pv_key). Nothing is quantized inside the
//      loops.

#include <math.h>

#include "int8_gemm.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

using int8k::kQuantFloor;
using int8k::quant_code;
using mavlm::pack_bf16x2;
namespace sm90 = mavlm::sm90;

constexpr int kPrepThreads = 512;
constexpr int kWgRows = 64;         // query rows of a consumer warpgroup
constexpr int kBN = 64;             // keys per tile: a 64-byte row of V^T codes
constexpr int kNC = kBN / 2;        // a thread's score accumulators
constexpr int kStages = 4;
constexpr int kMaxTiles = 2 * kWgRows + 1;  // q tiles a block can touch (tiles of one row)
constexpr float kMaskValue = -2.381976426469702e38f;  // -0.7 * FLT_MAX

// A block's shape (two consumer warpgroups: a third would cap a thread at
// 128 registers, and the score accumulator, PV's and the codes spill past
// that); the depth of the K codes (QK^T's, a multiple of 32) and the rows
// of V^T (PV's width, a multiple of 16).
template <int D>
struct Dims {
  static constexpr int NWG = 2;
  static constexpr int BM = NWG * kWgRows;
  static constexpr int THREADS = NWG * 128 + 32;  // and a producer warp
  static constexpr int DK = (D + 31) / 32 * 32;
  static constexpr int DV = (D + 15) / 16 * 16;
  static constexpr uint32_t K_BYTES = kBN * 128;  // a K tile: kBN keys x 128 bytes
  static constexpr uint32_t V_BYTES = DV * kBN;   // a V^T tile: DV rows x kBN keys
  static constexpr uint32_t STAGE = (K_BYTES + V_BYTES + 1023) / 1024 * 1024;
  static constexpr size_t SMEM = kStages * STAGE + 16 * kStages + 1024;
};

__host__ __device__ constexpr int s16(int s) { return (s + 15) / 16 * 16; }

// Place pl of the PV contraction -> its key. Thread t's A-fragment bytes
// 4t..4t+3 of a 32-key step are keys 2t, 2t+1, 8+2t, 9+2t (and 16+ those
// for bytes 16+4t..): place bits s3 s2 s1 s0 hold key bits s1 s3 s2 s0.
__device__ __forceinline__ int pv_key(int pl) {
  return (pl & ~15) | (((pl >> 1) & 1) << 3) | (((pl >> 3) & 1) << 2) | (((pl >> 2) & 1) << 1) |
         (pl & 1);
}

__device__ __forceinline__ uint32_t pack_codes(int c0, int c1, int c2, int c3) {
  return static_cast<uint32_t>(c0 & 0xff) | (static_cast<uint32_t>(c1 & 0xff) << 8) |
         (static_cast<uint32_t>(c2 & 0xff) << 16) | (static_cast<uint32_t>(c3 & 0xff) << 24);
}

// ---------------------------------------------------------------- prep

// blockIdx.x = batch * NH + head, blockIdx.y = 0 (k) or 1 (v). Writes
// scales[bh * 2 + y] and the codes: kq (B * NH, S, DK) or vt (B * NH, D, S16).
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                int8_t* __restrict__ kq, int8_t* __restrict__ vt, float* __restrict__ scales,
                int S, int stage) {
  constexpr int DK = Dims<D>::DK;
  extern __shared__ uint4 staged[];
  __shared__ float red[kPrepThreads / 32];
  const long long bh = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  const __nv_bfloat16* src = (is_v ? v : k) + bh * S * D;
  const int n8 = S * D / 8;  // 16-byte vectors of the head

  float amax = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n8; i += kPrepThreads) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    if (stage) staged[i] = raw;
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__bfloat162float(x[e])));
  }
  amax = mavlm::warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();  // also: the staged head is complete
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kPrepThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float scale = fmaxf(m, kQuantFloor) / 127.f;
  const float inv = 1.f / scale;
  if (threadIdx.x == 0) scales[bh * 2 + blockIdx.y] = scale;
  const __nv_bfloat16* x = stage ? reinterpret_cast<const __nv_bfloat16*>(staged) : src;

  if (!is_v) {  // 16 codes of one key row per thread-step, zero past D
    int8_t* dst = kq + bh * S * DK;
    for (int i = threadIdx.x; i < S * (DK / 16); i += kPrepThreads) {
      const int key = i / (DK / 16), d0 = (i % (DK / 16)) * 16;
      uint4 raw[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = d0 + 8 * hf;
        raw[hf] = d < D ? *reinterpret_cast<const uint4*>(x + key * D + d) : make_uint4(0, 0, 0, 0);
      }
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(raw);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = pack_codes(quant_code(__bfloat162float(xs[4 * j]), inv),
                          quant_code(__bfloat162float(xs[4 * j + 1]), inv),
                          quant_code(__bfloat162float(xs[4 * j + 2]), inv),
                          quant_code(__bfloat162float(xs[4 * j + 3]), inv));
      }
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(key) * DK + d0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {  // 16 places of one V^T row per thread-step, zero for keys past S;
            // neighbouring threads take neighbouring columns of the same keys
    const int sp = s16(S);
    int8_t* dst = vt + bh * D * sp;
    for (int i = threadIdx.x; i < D * (sp / 16); i += kPrepThreads) {
      const int d = i % D, p0 = (i / D) * 16;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = pv_key(p0 + 4 * j + e);
          c[e] = key < S ? quant_code(__bfloat162float(x[key * D + d]), inv) : 0;
        }
        w[j] = pack_codes(c[0], c[1], c[2], c[3]);
      }
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(d) * sp + p0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---------------------------------------------------------------- main

struct Int8MergeParams {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  __nv_bfloat16* o;        // (B, S, NH * D)
  const int* valid_len;    // (B,)
  const float* scales;     // (B * NH, 2): sk, sv from the prep kernel
  int NH, S, tile;
  float scale_log2;
};

// the consumer warpgroups' barrier (the producer warp has left)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// P codes (0..127) of four keys as one register of the A fragment
__device__ __forceinline__ uint32_t pack_p(int c0, int c1, int c2, int c3) {
  return static_cast<uint32_t>(c0) | (static_cast<uint32_t>(c1) << 8) |
         (static_cast<uint32_t>(c2) << 16) | (static_cast<uint32_t>(c3) << 24);
}

template <int D>
__global__ void __launch_bounds__(Dims<D>::THREADS, 1)
    merge_int8_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Int8MergeParams p) {
  using T = Dims<D>;
  constexpr int KSTEPS = T::DK / 32;
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned int tile_max[kMaxTiles];  // bits of the non-negative fp32 maxima
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kStages * T::STAGE, empty0 = full0 + 8 * kStages;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T::BM;
  const int S = p.S, bh = b * p.NH + h;
  const int valid = p.valid_len[b];
  const int kv_end = valid > 0 ? min(valid, S) : S;
  const int n_tiles = __shfl_sync(0xffffffffu, (kv_end + kBN - 1) / kBN, 0);  // uniform
  const int warp = sm90::warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 4 * T::NWG);
    }
    sm90::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < kMaxTiles; i += T::THREADS) tile_max[i] = 0u;
  __syncthreads();

  if (warp == 4 * T::NWG) {  // the producer warp
    if (lane == 0) {
      for (int j = 0; j < 2 * n_tiles; ++j) {
        const int s = j % kStages, n0 = (j % n_tiles) * kBN;
        const bool with_v = j >= n_tiles;
        const uint32_t k_tile = base + s * T::STAGE, full = full0 + 8 * s;
        sm90::mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        sm90::mbar_arrive_tx(full, T::K_BYTES + (with_v ? T::V_BYTES : 0));
        sm90::tma_load_3d(k_tile, &tm_k, full, 0, n0, bh);
        if (with_v) sm90::tma_load_3d(k_tile + T::K_BYTES, &tm_v, full, n0, 0, bh);
      }
    }
    return;
  }

  // The q scales of the tiles this block's rows fall in: the max of |q * c|
  // over each whole tile (a tile may reach past the block).
  const __nv_bfloat16* qh = p.q + static_cast<long long>(bh) * S * D;
  const int t_lo = q0 / p.tile;
  const int r_hi = min(S, ((min(q0 + T::BM, S) - 1) / p.tile + 1) * p.tile);
  // A half-warp's lanes take one 16-byte vector of a row each, reduced in
  // the half-warp before one atomic per row; a warp's eight row pairs of a
  // round are loaded before any is reduced.
  static_assert(D / 8 <= 16, "a row's vectors fit a half-warp");
  constexpr int kRound = 8 * 2 * 4 * T::NWG;  // rows per round
  for (int r_base = t_lo * p.tile; r_base < r_hi; r_base += kRound) {
    const int vec = lane & 15;
    uint4 raw[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int row = r_base + 2 * (4 * T::NWG * u + warp) + (lane >> 4);
      raw[u] = row < r_hi && vec < D / 8
          ? reinterpret_cast<const uint4*>(qh + static_cast<long long>(row) * D)[vec]
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int row = r_base + 2 * (4 * T::NWG * u + warp) + (lane >> 4);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw[u]);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        amax = fmaxf(amax, fabsf(__fmul_rn(__bfloat162float(x[e]), p.scale_log2)));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      if (vec == 0 && row < r_hi) atomicMax(&tile_max[row / p.tile - t_lo], __float_as_uint(amax));
    }
  }
  consumers_sync<T::NWG * 128>();

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * kWgRows + wl * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sk = p.scales[bh * 2], sv = p.scales[bh * 2 + 1];
  // q codes as QK^T's A fragments: register r of k-step kk holds row
  // row0 + 8 (r & 1), columns 32 kk + 16 (r >> 1) + 4t .. + 3; zero past S
  // and past D. sqk: sq * sk of the two rows (rows past S borrow the last's).
  uint32_t qa[KSTEPS][4];
  float sqk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row0 + 8 * r, S - 1);
    const float sq = fmaxf(__uint_as_float(tile_max[row / p.tile - t_lo]), kQuantFloor) / 127.f;
    sqk[r] = __fmul_rn(sq, sk);
    const float inv = 1.f / sq;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = 32 * kk + 16 * hf + 4 * t;
        uint32_t packed = 0;
        if (row0 + 8 * r < S && col < D) {
          const uint2 raw = *reinterpret_cast<const uint2*>(qh + static_cast<long long>(row) * D + col);
          const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
          packed = pack_codes(quant_code(__fmul_rn(__bfloat162float(x[0]), p.scale_log2), inv),
                              quant_code(__fmul_rn(__bfloat162float(x[1]), p.scale_log2), inv),
                              quant_code(__fmul_rn(__bfloat162float(x[2]), p.scale_log2), inv),
                              quant_code(__fmul_rn(__bfloat162float(x[3]), p.scale_log2), inv));
        }
        qa[kk][r + 2 * hf] = packed;
      }
    }
  }

  // raw = q codes . K codes of kBN keys: element i is row row0 + 8 ((i >> 1)
  // & 1), key n0 + 8 (i >> 2) + 2t + (i & 1)
  int raw[kNC];
  // The products accumulate onto zeroed registers: a first 8-bit product
  // that overwrites its accumulator (scale-d 0 by a register) makes ptxas
  // wait for every wgmma before the next (one WARPGROUP.DEPBAR per IGMMA in
  // the SASS, ~8% of the kernel's time).
  auto qk_issue = [&](uint32_t k_tile) {
#pragma unroll
    for (int i = 0; i < kNC; ++i) raw[i] = 0;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      sm90::wgmma_s8(raw, qa[kk], sm90::desc_kmajor(k_tile, kBN, 0, kk), 1);
    }
  };
  auto qk = [&](uint32_t k_tile) {
    sm90::wg_fence();
    qk_issue(k_tile);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::reg_fence(raw);
  };
  // the scores: keys at or past S are not keys (-inf, p = 0); keys at or
  // past valid get MASK_VALUE (`inside`: no key of the tile is either)
  auto score = [&](int i, int n0, bool inside) {
    float x = __fmul_rn(static_cast<float>(raw[i]), sqk[(i >> 1) & 1]);
    if (!inside) {
      const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col >= S) {
        x = -INFINITY;
      } else if (col >= valid) {
        x = kMaskValue;
      }
    }
    return x;
  };
  const int kv_in = min(valid, S);  // keys below this are neither masked nor past S
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
  };

  // sweep 1: the row max over every key
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    qk(base + s * T::STAGE);
    release(s);
    const int n0 = j * kBN;
    if (n0 + kBN <= kv_in) {
      // sq * sk > 0 and rounding is monotone, so the max score is the
      // scaled max of the integer products
      int mx[2] = {raw[0], raw[2]};
#pragma unroll
      for (int i = 0; i < kNC; ++i) mx[(i >> 1) & 1] = max(mx[(i >> 1) & 1], raw[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_row[r] = fmaxf(m_row[r], __fmul_rn(static_cast<float>(mx[r]), sqk[r]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], score(i, n0, false));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // sweep 2: p against the final max, l over the unrounded p, P codes and PV
  int o[T::DV / 2];
#pragma unroll
  for (int i = 0; i < T::DV / 2; ++i) o[i] = 0;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  {  // tile 0's products; from then on a tile's PV and the next tile's QK^T
     // go to the tensor cores together (the P codes have their own
     // registers by then), so each tile costs one wait
    const int s = n_tiles % kStages;
    sm90::mbar_wait(full0 + 8 * s, (n_tiles / kStages) & 1);
    qk(base + s * T::STAGE);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int jj = n_tiles + j, s = jj % kStages;
    const uint32_t k_tile = base + s * T::STAGE;
    const bool inside = j * kBN + kBN <= kv_in;
    // 32-key step c holds elements 16c .. 16c + 15 (chunks 4c .. 4c + 3)
    uint32_t pa[kBN / 32][4];
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) {
      int pc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = 16 * c + e;
        const float pe = exp2f(__fsub_rn(score(i, j * kBN, inside), m_row[(i >> 1) & 1]));
        l_run[(i >> 1) & 1] += pe;
        pc[e] = __float2int_rn(__fmul_rn(pe, 127.f));  // rint: half to even
      }
      pa[c][0] = pack_p(pc[0], pc[1], pc[4], pc[5]);
      pa[c][1] = pack_p(pc[2], pc[3], pc[6], pc[7]);
      pa[c][2] = pack_p(pc[8], pc[9], pc[12], pc[13]);
      pa[c][3] = pack_p(pc[10], pc[11], pc[14], pc[15]);
    }
    sm90::wg_fence();
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) {  // V^T rows of 64 bytes, 64-byte swizzle
      sm90::wgmma_s8(o, pa[c], sm90::desc_kmajor_narrow(k_tile + T::K_BYTES, kBN, c), 1);
    }
    if (j + 1 < n_tiles) {
      const int s2 = (jj + 1) % kStages;
      sm90::mbar_wait(full0 + 8 * s2, ((jj + 1) / kStages) & 1);
      qk_issue(base + s2 * T::STAGE);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::reg_fence(o);
    sm90::reg_fence(raw);
    release(s);
  }

  const int HD = p.NH * D;
  const float sv127 = sv / 127.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float f = __fdiv_rn(sv127, l);  // l >= 1: the max key contributes p = 1
    const int row = row0 + 8 * r;
    if (row < S) {
      __nv_bfloat16* orow = p.o + (static_cast<long long>(b) * S + row) * HD + h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16x2(__fmul_rn(static_cast<float>(o[4 * dt + 2 * r]), f),
                        __fmul_rn(static_cast<float>(o[4 * dt + 2 * r + 1]), f));
      }
    }
  }
}

template <int D>
int prep(const void* k, const void* v, void* kq, void* vt, void* scales, int BH, int S,
         cudaStream_t st) {
  // the head staged in shared memory when it fits beside the reduction
  const size_t bytes = static_cast<size_t>(S) * D * 2;
  const int stage = bytes <= 200 * 1024;
  const auto kern = prep_kernel<D>;
  const size_t smem = stage ? bytes : 0;
  int rc = sm90::set_smem(kern, smem);
  if (rc != 0) return rc;
  kern<<<dim3(BH, 2), kPrepThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<int8_t*>(kq), static_cast<int8_t*>(vt), static_cast<float*>(scales), S, stage);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int merge(const Int8MergeParams& p, const void* kq, const void* vt, int B, cudaStream_t st) {
  using T = Dims<D>;
  const int BH = B * p.NH, sp = s16(p.S);
  // K codes {DK, S, B * NH} in boxes of 128 (the depth past DK reads as
  // zeros) by kBN keys; V^T codes {S16, D, B * NH} in boxes of kBN keys by
  // DV rows (the rows past D read as zeros)
  const cuuint64_t kdims[3] = {(cuuint64_t)T::DK, (cuuint64_t)p.S, (cuuint64_t)BH};
  const cuuint64_t kstrides[2] = {(cuuint64_t)T::DK, (cuuint64_t)p.S * T::DK};
  const cuuint32_t kbox[3] = {128, kBN, 1};
  const cuuint64_t vdims[3] = {(cuuint64_t)sp, (cuuint64_t)D, (cuuint64_t)BH};
  const cuuint64_t vstrides[2] = {(cuuint64_t)sp, (cuuint64_t)sp * D};
  const cuuint32_t vbox[3] = {kBN, T::DV, 1};  // 64-byte rows
  CUtensorMap mk, mv;
  if (!sm90::encode_map(&mk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, kq, kdims, kstrides, kbox,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::encode_map(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, vt, vdims, vstrides, vbox,
                        CU_TENSOR_MAP_SWIZZLE_64B)) {
    return sm90::kTmaRejected;
  }
  const auto kern = merge_int8_kernel<D>;
  const int rc = sm90::set_smem(kern, T::SMEM);
  if (rc != 0) return rc;
  kern<<<dim3((p.S + T::BM - 1) / T::BM, p.NH, B), T::THREADS, T::SMEM, st>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

int run_prep(int head_dim, const void* k, const void* v, void* kq, void* vt, void* scales,
             int BH, int S, cudaStream_t st) {
  switch (head_dim) {
    case 64: return prep<64>(k, v, kq, vt, scales, BH, S, st);
    case 72: return prep<72>(k, v, kq, vt, scales, BH, S, st);
    case 128: return prep<128>(k, v, kq, vt, scales, BH, S, st);
    default: return -1;
  }
}

}  // namespace

// The codes and scales of k and v (B, NH, S, D) bf16 contiguous: kq (B, NH,
// S, DK) int8 with DK = D rounded up to 32, vt (B, NH, D, S16) int8 with
// S16 = S rounded up to 16, keys in PV order, and scales (B, NH, 2) fp32
// (sk, sv). Returns 0, a cudaError_t, -1 (head dim) or -3 (shape).
extern "C" int flash_merge_int8_prep(int head_dim, const void* k, const void* v, void* kq,
                                     void* vt, void* scales, int B, int NH, int S,
                                     void* stream) {
  if (S < 1 || B < 1 || NH < 1 || static_cast<long long>(B) * NH > 0x7fffffff) return -3;
  return run_prep(head_dim, k, v, kq, vt, scales, B * NH, S, static_cast<cudaStream_t>(stream));
}

// q, k, v (B, NH, S, D) bf16 contiguous -> o (B, S, NH*D) bf16; kq, vt and
// scales (as flash_merge_int8_prep writes them) are scratch. Returns 0, a
// cudaError_t, -1 for a head dim the library was not built for, -3 (shape)
// or -4 (a tensor map refused).
extern "C" int flash_merge_int8(int head_dim, const void* q, const void* k, const void* v,
                                void* o, const void* valid_len, void* kq, void* vt,
                                void* scales, int B, int NH, int S, int tile, float scale_log2,
                                void* stream) {
  if (tile < 1 || S < 1 || B < 1 || NH < 1 || B > 65535 || NH > 65535) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = run_prep(head_dim, k, v, kq, vt, scales, B * NH, S, st);
  if (rc != 0) return rc;
  Int8MergeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.valid_len = static_cast<const int*>(valid_len);
  p.scales = static_cast<const float*>(scales);
  p.NH = NH;
  p.S = S;
  p.tile = tile;
  p.scale_log2 = scale_log2;
  switch (head_dim) {
    case 64: return merge<64>(p, kq, vt, B, st);
    case 72: return merge<72>(p, kq, vt, B, st);
    default: return merge<128>(p, kq, vt, B, st);
  }
}
