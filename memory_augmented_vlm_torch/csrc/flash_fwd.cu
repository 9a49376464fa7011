// Flash-attention forward, bound to Python with ctypes: the C entry point
// flash_fwd, and the fp32 kernel of it and of flash_fwd_lse (flash_train.cu).
//
// Replaces the TPU kernel `_flash_fwd_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py::pallas_flash_attention and,
// in fp32 with its lse epilogue, `_fwd_lse_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py::_forward_with_lse, and
// computes the same function:
//   - q is scaled by scale*log2(e) and rounded to the input dtype before QK^T;
//   - scores, the running max m, the running sum l and the accumulator are
//     fp32, and the online softmax is base 2 (exp2);
//   - keys >= kv_valid_len[b] are masked, and with `causal` keys above the
//     diagonal too; a row that sees no valid key (valid length 0) is zero;
//   - P is rounded to the input dtype before PV, as the TPU kernel does;
//   - the output has the input dtype. Layout is bshd, read through strides.
//
// bf16 inputs, the main path, run the TMA-fed wgmma kernel of
// flash_fwd_sm90.cu. fp32 inputs (parity runs: the tower at head dim 72,
// the memory at 112, 256 and 448, the CLI's small checkpoints at 64) run
// flash_fwd_3xtf32_kernel here at head dims 64, 72, 112, 128, 256 and 448;
// in fp32, q and P are not rounded. flash_fwd_lse's fp32 branch (training at
// head dims 64, 128 and 256) runs the same kernel with LSE set: column warp 0
// of each row group also writes lse = m + log2(max(l, 1e-30)) in log2 units,
// -inf for a row that saw no key, (B, H, Sq) fp32. The TPU kernel gives a
// masked score the finite MASK_VALUE and this one -inf (skipping whole
// tiles): exp2 of either is 0 beside a finite max, so the two agree on every
// row that sees a key.
//
// The fp32 kernel. Both products run on the tensor cores in 3xTF32: each
// fp32 operand x splits into hi, x rounded to the nearest TF32 (ties away
// from zero, as cvt.rna.tf32.f32), and lo = x - hi, which the tensor core
// reads as TF32 (its 13 low bits dropped); a product accumulates
// lo*hi + hi*lo + hi*hi in fp32 (what is left, lo*lo and lo's dropped
// bits, is below 2^-20 of it). One TF32 product keeps ~11 bits and falls
// outside the fp32 rule the kernel is held to (1e-5); 3xTF32 keeps ~21.
// The work is 3 TF32 products per fp32 product: 165 TFLOP/s of fp32 work at
// the TF32 peak, against 67 outside the tensor cores.
//   - mma.sync.m16n8k8 tf32 (tf32.cuh, shared with flash_train.cu's fp32
//     backward), not wgmma: wgmma takes tf32 operands K-major only, so PV
//     would need V transposed in shared memory, and it reads shared-memory
//     operands as they are, so K and V would have to be staged twice, as
//     hi and lo. With mma.sync each warp loads its fragments from one
//     staged copy and splits them in registers.
//   - The split is three integer and float instructions (add half a TF32
//     step to the bits, clear the low 13, subtract); cvt.rna.tf32.f32 for
//     hi and again for lo cost several instructions each, and the splits
//     then took ~40% of the kernel's time.
//   - The tensor core adds a product into its accumulator with truncation,
//     an ulp of the accumulator each time: a score summed over the head
//     dim in one accumulator, or O over every key tile, drifted ~10x past
//     the fp32 plain version's rounding (5-10e-6 on outputs of ~1, enough
//     to move the 7B parity cut's nearly cancelling memory gradients). So
//     each 8-column step of QK^T, and each 32-key tile of PV, goes into a
//     fresh fragment, added to the running sum in fp32 (O = O alpha + PV
//     in one fused multiply-add): errors of 4-16e-7 at the path shapes.
//   - A warp owns 16 query rows and DW = D / WN of the head dim's columns,
//     both of QK^T's reduction and of the output; WN warps split a row
//     group's columns (WN = 4 at 448 and 256, 1 below), so that q's
//     fragments and the accumulator fit in registers (DW / 2 each a
//     thread: 56 at 448). Their partial scores meet in shared memory, and
//     each of them sums the WN partials in one order, so all of them hold
//     the same scores and the same softmax.
//   - PV takes P from the score accumulator as it lies: the A fragment's
//     k index t holds key 2t and t + 4 holds key 2t + 1, and the B fragment
//     reads V's rows in that order.
//   - K and V tiles of 32 keys come by TMA (sm90::KvRings, no producer
//     warp) as one box per column warp: its DW columns and the 4 past them
//     (from the next warp's columns, or zeros past D), rows DW + 4 floats
//     apart. That pitch makes every fragment load free of bank conflicts
//     (8 rows at 4 columns, or 4 row pairs at 8 columns, on 32 banks), and
//     each load's address is a register set once and an offset known at
//     compile time.
//   - Key tiles at or past kv_valid_len, and past the diagonal when causal,
//     are skipped, as on the TPU; a masked score is -inf.
//   - Shared memory at 448: K tiles of 32 x 4 x 116 fp32 (58 KB) in a ring
//     of 2, V in a ring of 1, and two 32 KB buffers of partial scores: 206
//     KB of the 227 KB a block may take; q stays in registers. One block of
//     8 warps (2 row groups x 4 column warps, 32 rows) an SM. At 256 the
//     same warps, rings of 2 + 2 tiles of 34 KB, 172 KB. Below: 4 warps of
//     16 rows at all the columns, rings of 9-17 KB tiles.
// Bound: operations, 3 TF32 products per fp32 product at the TF32 peak
// (the bytes take less at every path shape).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using namespace mavlm::sm90;
using namespace mavlm::tf32;

struct FlashParams {
  const float* q;
  float* o;
  const int* valid_len;  // (B,) int32, on the device
  int Sq, Skv, kv_groups, causal;
  long long q_sb, q_ss, q_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale * log2(e)
  float* lse;        // (B, H, Sq) fp32, written by the LSE instances
};

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

// WN warps split the head dim, RG row groups of 16 make a block; KS and VS
// are the K and V ring depths.
template <int D> struct F32Shape;
template <> struct F32Shape<64> { static constexpr int WN = 1, RG = 4, KS = 2, VS = 2; };
template <> struct F32Shape<72> { static constexpr int WN = 1, RG = 4, KS = 2, VS = 2; };
template <> struct F32Shape<112> { static constexpr int WN = 1, RG = 4, KS = 2, VS = 2; };
template <> struct F32Shape<128> { static constexpr int WN = 1, RG = 4, KS = 2, VS = 2; };
template <> struct F32Shape<256> { static constexpr int WN = 4, RG = 2, KS = 2, VS = 2; };
template <> struct F32Shape<448> { static constexpr int WN = 4, RG = 2, KS = 2, VS = 1; };

template <int D>
struct F32Tile {
  using S = F32Shape<D>;
  static constexpr int WN = S::WN, RG = S::RG;
  static constexpr int BN = 32;              // keys a tile
  static constexpr int DW = D / WN;          // head-dim columns of a warp
  static constexpr int PITCH = DW + 4;       // floats from one staged row to the next
  static constexpr int BM = 16 * RG;         // query rows of a block
  static constexpr int WARPS = WN * RG, THREADS = 32 * WARPS;
  static constexpr int NT = BN / 8;          // 8-key tiles of a score tile
  static constexpr int KD = DW / 8;          // QK^T's k-steps, PV's column tiles
  static constexpr int XS_FLOATS = NT * 4 * 32;  // one warp's partial scores
  using Ring = KvRings<S::KS, S::VS, BN, WN, DW, 4 * PITCH>;
  static constexpr uint32_t BARS = Ring::BYTES;
  static constexpr uint32_t COUNTERS = BARS + 8 * Ring::SLOTS;
  static constexpr uint32_t XS = (COUNTERS + 4 * Ring::SLOTS + 15) / 16 * 16;
  static constexpr uint32_t XS_BYTES = WN > 1 ? 2 * WARPS * XS_FLOATS * 4 : 0;
  static constexpr size_t SMEM = 1024 + XS + XS_BYTES;  // 1024: the alignment of the base
  static_assert(D % WN == 0 && DW % 8 == 0, "a warp's columns are whole 8-column tiles");
  static_assert(PITCH <= 256, "a TMA box is at most 256 columns");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int D, bool LSE>
__global__ void __launch_bounds__(F32Tile<D>::THREADS, 1)
    flash_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const FlashParams p) {
  using T = F32Tile<D>;
  constexpr int BN = T::BN, NT = T::NT, KD = T::KD, DW = T::DW, P = T::PITCH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / T::WN, cw = warp % T::WN;  // row group, column warp
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T::BM;
  const int row0 = q0 + 16 * rg + g;  // this thread's rows: row0 and row0 + 8
  const int col0 = cw * DW;           // this warp's first column
  // this thread's first fragment element in a staged tile (this warp's box):
  // QK^T's B, key g at column t; PV's B, key 2t at column g
  const int qk_at = cw * BN * P + g * P + t, pv_at = cw * BN * P + 2 * t * P + g;

  const typename T::Ring ring = {base, base + T::BARS,
                                 reinterpret_cast<unsigned int*>(gbase + T::COUNTERS),
                                 &tm_k, &tm_v, h / p.kv_groups, b};
  const int kv_valid = max(min(p.valid_len[b], p.Skv), 0);
  const int kv_end = p.causal ? min(kv_valid, q0 + T::BM) : kv_valid;
  const int n_tiles = (kv_end + BN - 1) / BN;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) ring.load_first(n_tiles);

  // q * scale*log2(e): this warp's 16 rows by DW columns as A fragments
  // (a0: row g, column t; a1: row g + 8; a2, a3: column t + 4)
  float qa[KD][4];
  const float* q = p.q + b * p.q_sb + h * p.q_sh + col0 + t;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1);
      qa[ks][i] = row < p.Sq ? q[row * p.q_ss + 8 * ks + 4 * (i >> 1)] * p.scale_log2 : 0.f;
    }
  }

  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float* xs = reinterpret_cast<float*>(gbase + T::XS);

  for (int j = 0; j < n_tiles; ++j) {
    // S (16 x BN) over this warp's columns; c0, c1: row g, keys 2t, 2t + 1
    // of the 8-key tile; c2, c3: row g + 8
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    }
    ring.wait(0, j);
    const float* sk = reinterpret_cast<const float*>(gbase + (ring.tile(0, j) - base)) + qk_at;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      // q's split is redone at every tile: hoisted out of the tile loop,
      // hi and lo of every fragment would take twice q's registers
      reg_fence(qa[ks]);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qa[ks][i], ah[i], al[i]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kf = sk + 8 * nt * P + 8 * ks;
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // a fresh fragment a step (header)
        mma_3xtf32(part, ah, al, kf[0], kf[4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] += part[i];
      }
    }
    ring.template done_with<T::WARPS>(0, j, n_tiles);
    if constexpr (T::WN > 1) {
      // the row group's partial scores, summed by each of its warps in the
      // same order; two buffers, so a warp writes tile j + 1's while the
      // others may still read tile j's
      float* buf = xs + (j & 1) * T::WARPS * T::XS_FLOATS;
      float* mine = buf + warp * T::XS_FLOATS;
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) mine[i * 32 + lane] = s[i / 4][i % 4];
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + rg), "n"(32 * T::WN) : "memory");
      const float* group = buf + rg * T::WN * T::XS_FLOATS;
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < T::WN; ++c) sum += group[c * T::XS_FLOATS + i * 32 + lane];
        s[i / 4][i % 4] = sum;
      }
    }

    // mask, then the online softmax of rows row0 (r = 0) and row0 + 8
    const int n0 = j * BN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 8 * nt + 2 * t + (i & 1);
        const int row = row0 + 8 * (i >> 1);
        if (key >= kv_valid || (p.causal && key > row)) s[nt][i] = -INFINITY;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float shift = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      alpha[r] = exp2f(m_run[r] - shift);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][2 * r + e] = exp2f(s[nt][2 * r + e] - shift);
          sum += s[nt][2 * r + e];
        }
      }
      l_run[r] = l_run[r] * alpha[r] + sum;  // this thread's share; summed at the end
    }

    // O = O alpha + P V over this warp's columns: the 8-key step kk's A
    // fragment holds key 2t at k index t and key 2t + 1 at t + 4
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
    ring.wait(1, j);
    const float* sv = reinterpret_cast<const float*>(gbase + (ring.tile(1, j) - base)) + pv_at;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float* vf = sv + 8 * kk * P + 8 * n;
        mma_3xtf32(part, ph[kk], pl[kk], vf[0], vf[P]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = fmaf(o[n][i], alpha[i >> 1], part[i]);
    }
    ring.template done_with<T::WARPS>(1, j, n_tiles);
  }

  float* out = p.o + b * p.o_sb + h * p.o_sh + col0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    if constexpr (LSE) {
      // every column warp holds the same m and l: one lane of column warp
      // 0's quad writes (-inf for a row that saw no key, whose m stays -inf)
      if (cw == 0 && t == 0) {
        p.lse[((long long)b * gridDim.y + h) * p.Sq + row] = m_run[r] + log2f(fmaxf(l, 1e-30f));
      }
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;  // a row that saw no key is zero
    float* orow = out + row * p.o_ss;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o[n][2 * r] * inv,
                                                             o[n][2 * r + 1] * inv);
    }
  }
}

template <int D, bool LSE = false>
int launch_f32(const mavlm::fwd_sm90::Args& a, cudaStream_t stream) {
  using T = F32Tile<D>;
  const int hkv = a.H / a.kv_groups;
  CUtensorMap mk, mv;
  if (!make_map_f32(&mk, a.k, D, a.Skv, hkv, a.B, a.k_st, T::BN, T::PITCH) ||
      !make_map_f32(&mv, a.v, D, a.Skv, hkv, a.B, a.v_st, T::BN, T::PITCH)) {
    return kTmaRejected;
  }
  const FlashParams p = {static_cast<const float*>(a.q), static_cast<float*>(a.o),
                         static_cast<const int*>(a.valid_len), a.Sq, a.Skv, a.kv_groups,
                         a.causal, a.q_st[0], a.q_st[1], a.q_st[2], a.o_st[0], a.o_st[1],
                         a.o_st[2], a.scale_log2, static_cast<float*>(a.lse)};
  const int rc = set_smem(flash_fwd_3xtf32_kernel<D, LSE>, T::SMEM);
  if (rc != 0) return rc;
  const dim3 grid((a.Sq + T::BM - 1) / T::BM, a.H, a.B);
  flash_fwd_3xtf32_kernel<D, LSE><<<grid, T::THREADS, T::SMEM, stream>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int mavlm::fwd_f32::run(const fwd_sm90::Args& a, int head_dim, void* cuda_stream) {
  const cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (a.lse != nullptr) {
    switch (head_dim) {
      case 64: return launch_f32<64, true>(a, stream);
      case 128: return launch_f32<128, true>(a, stream);
      case 256: return launch_f32<256, true>(a, stream);
      default: return -1;
    }
  }
  switch (head_dim) {
    case 64: return launch_f32<64>(a, stream);
    case 72: return launch_f32<72>(a, stream);
    case 112: return launch_f32<112>(a, stream);
    case 128: return launch_f32<128>(a, stream);
    case 256: return launch_f32<256>(a, stream);
    case 448: return launch_f32<448>(a, stream);
    default: return -1;
  }
}

// dtype: 0 = bf16, 1 = fp32. bf16 runs one block per item of `items`
// ((n_items, 3) int32: batch, query head, tile of block_rows query rows),
// which the wrapper builds per shape; fp32 ignores the three. k's and v's
// strides also go into TMA tensor maps (a dim of size 1 needs a valid
// one). Returns 0, a cudaError_t from the launch, or -1 for a head dim /
// -2 for a dtype / -3 for block rows the library was not built for, -4
// for a refused tensor map.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, void* o, const void* valid_len, int B,
                         int Sq, int Skv, int H, int kv_groups, int causal,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale_log2, void* stream, const void* items, int n_items,
                         int block_rows) {
  const mavlm::fwd_sm90::Args a = {
      q, k, v, o, nullptr, valid_len, items, n_items, block_rows, B, Sq, Skv, H,
      kv_groups, causal, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
      {o_sb, o_ss, o_sh}, scale_log2};
  if (dtype == 0) return mavlm::fwd_sm90::run(a, head_dim, stream);
  if (dtype == 1) return mavlm::fwd_f32::run(a, head_dim, stream);
  return -2;
}

// The message of a code returned by any launch function of the library.
extern "C" const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == -2) return "unsupported dtype";
  if (code == -3) return "unsupported shape";
  if (code == -4) return "TMA tensor map refused (alignment or strides)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
