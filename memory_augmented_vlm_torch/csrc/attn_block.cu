// The fused int8 attention half-block for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the TPU kernel `_attn_block_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_attn_block.py:143
// fused_attn_block_int8 and computes the same function:
//   hidden + out_proj(attn(LN1(hidden) @ {Wq, Wk, Wv}))
// with, per row: fp32 LayerNorm (eps, biased variance) and an int8 row
// quant; three int8 products acc * sx * s + b, each rounded to bf16 whatever
// hidden's dtype; per head: fp32 logits q.k times `scale` (on the logits,
// not folded into q), -1e30 for keys at or past `valid`, p = exp(l - max)
// (base e), l = sum(p) in fp32, P rounded to bf16 for PV, o = (P.v) / l in
// fp32; the out-projection quantizes o per (row, head) over its hd values
// and sums the heads in order, acc = acc + (oq_h . Wo[h]) * s_row_h, then
// acc * so + bo, plus the residual in fp32, cast once. Rows at or past
// `valid` are computed like the others.
//
// What bounds it on the H100: at the tower's shape (64 frames x 729 rows,
// 1152 wide, 16 heads of 72) the four projections are 4 x 123.8 GOP of int8
// work (0.250 ms at 1,979 TOP/s) and attention 156.7 GFLOP of bf16 work
// (0.158 ms at 989 TFLOP/s): the tensor cores bound it, 0.409 ms in all.
//
// Design: the TPU kernel parks K and V of every head of a frame in VMEM
// (2 x 729 x 1152 x 2 B = 3.4 MB), far past a Hopper block's 227 KB, and
// holds a (rows, 1152) fp32 accumulator for the out-projection. Here it is
// three stages on one stream:
//   1. LN + row quant + the q/k/v products into head-major bf16 scratch:
//      the C entry of qkv_int8.cu, whose function this stage is.
//   2. Per-head attention, one block per 128-row q slab, head and frame:
//      the two-sweep kernel of two_sweep.cuh that flash_merge.cu also
//      runs (the row max first, so P rounds against the final max; TMA and
//      wgmma), with
//      this kernel's softmax and an epilogue that quantizes each row's hd
//      outputs into int8 codes and a per-(row, head) scale (B*S, NH):
//      AttnPolicy. A head's hd codes (72) are not a multiple of the s8
//      wgmma depth of 32, so each head's codes are stored KP = hd rounded
//      up to 32 bytes wide (96), zeros past hd: (B*S, NH * KP). (Unpadded
//      codes, read 96 deep from h * 72, would start odd heads' TMA boxes
//      8 bytes off the 16 bytes TMA takes.)
//   3. The out-projection on the Hopper int8 core's tools: a producer warp
//      feeds one head per ring stage by TMA (the 128-row tile's codes of
//      the head and the same head's rows of Wo), and two consumer
//      warpgroups run its s8 wgmma products, 64 rows each, from shared
//      memory. Each head is read KP deep (96: a 64-byte and a 32-byte box,
//      each swizzled by its width) against a copy of Wo whose head rows are
//      zero-padded to KP in the same way (built by the wrapper,
//      ops/attn_block.py::pad_head_rows). After each head a warpgroup
//      waits for its products and adds them, times the row's scale, to its
//      fp32 accumulator: the TPU kernel's per-head sum, in its order. Then
//      the fp32 sums take so, bo and the residual in the GEMM core's
//      epilogue (int8_gemm_sm90.cuh, store_tile). The padding costs a third
//      more tensor-core work at hd 72. Tiles, codes layout and accumulator
//      sets: PERF.md §6.

#include <math.h>

#include "int8_gemm_sm90.cuh"
#include "two_sweep.cuh"

// qkv_int8.cu: LN + row quant + int8 q/k/v, head-major bf16
extern "C" int qkv_int8(int dtype, const void* hidden, const void* ln_w, const void* ln_b,
                        const void* wq, const void* sq, const void* bq,
                        const void* wk, const void* sk, const void* bk,
                        const void* wv, const void* sv, const void* bv,
                        void* q, void* k, void* v, void* xq, void* sx,
                        int B, int S, int H, int NH, float eps, void* stream);

namespace {

using int8k::kQuantFloor;
using int8k::quant_code;
namespace sm90 = mavlm::sm90;

constexpr float kNegInf = -1e30f;  // pallas_attn_block.NEG_INF

// A head as the out-projection reads it: KP bytes deep (hd rounded up to
// the 32-byte depth of an s8 wgmma), in a box of W0 bytes and, at KP 96,
// one of W1 = 32 past it, each swizzled by its width (a 64-byte and a
// 32-byte row: no byte is read that no product uses).
template <int HD>
struct HeadBoxes {
  static constexpr int KP = (HD + 31) / 32 * 32;
  static constexpr int W0 = KP >= 128 ? 128 : KP >= 64 ? 64 : 32;
  static constexpr int W1 = KP - W0;
  static_assert(KP <= 128 && (W1 == 0 || W1 == 32), "head dims up to 128");
};

// #12's softmax for two_sweep.cuh: q as it is, the scale on the fp32
// logits, base e, o = (P.v) / l, and an epilogue that quantizes each row's
// hd outputs into int8 codes and one scale per (row, head).
struct AttnPolicy {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int8_t* oq;              // (B * S, NH * KP) codes of o, head h at h * KP, zeros past D
  float* sa;               // (B * S, NH) their scales
  int NH, S, valid_keys;
  float scale;

  static constexpr float kMask = kNegInf;
  __device__ int valid(int) const { return valid_keys; }
  __device__ float q_in(float x) const { return x; }
  __device__ float logit(float qk) const { return __fmul_rn(qk, scale); }
  __device__ float prob(float s, float m) const { return expf(__fsub_rn(s, m)); }

  template <int D>
  __device__ void store(int b, int h, int row, int t, const float (&acc)[D / 8][4], int r,
                        float l) const {
    float o[D / 8][2];
    float amax = 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] = __fdiv_rn(acc[dt][2 * r], l);
      o[dt][1] = __fdiv_rn(acc[dt][2 * r + 1], l);
      amax = fmaxf(amax, fmaxf(fabsf(o[dt][0]), fabsf(o[dt][1])));
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float s = fmaxf(amax, kQuantFloor) / 127.f;
    const float inv = 1.f / s;
    if (row >= S) return;
    const long long m = static_cast<long long>(b) * S + row;
    constexpr int KP = HeadBoxes<D>::KP;
    int8_t* orow = oq + m * (NH * KP) + h * KP;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      char2 c2;
      c2.x = quant_code(o[dt][0], inv);
      c2.y = quant_code(o[dt][1], inv);
      *reinterpret_cast<char2*>(orow + dt * 8 + 2 * t) = c2;
    }
#pragma unroll
    for (int dt = D / 8; dt < KP / 8; ++dt) {  // the padding's zeros
      *reinterpret_cast<char2*>(orow + dt * 8 + 2 * t) = make_char2(0, 0);
    }
    if (t == 0) sa[m * NH + h] = s;
  }
};

// ---------------------------------------------------------------------------
// The out-projection with a per-(row, head) scale
// ---------------------------------------------------------------------------

constexpr CUtensorMapSwizzle swizzle_of(int width) {
  return width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// k-step kk (32 bytes) of a K-major block of `width`-byte swizzled rows,
// the 64 (A) or HN (B) rows from row0
__device__ __forceinline__ uint64_t desc_block(uint32_t block, int width, int row0, int kk) {
  return sm90::desc_make(block + row0 * width + kk * 32, 16, 8 * width,
                         width == 128 ? 1 : width == 64 ? 2 : 3);
}

template <int HD, int HN, int MINB>
struct HeadRing {
  using Hb = HeadBoxes<HD>;
  static constexpr uint32_t A_BYTES = int8h::kBM * Hb::KP;
  static constexpr uint32_t STAGE = (int8h::kBM + HN) * Hb::KP;  // a multiple of 1024
  static constexpr int SROW = HN + 8;  // staged fp32 row (the core's bank skew)
  static constexpr uint32_t STAGING = int8h::kConsumers * 4 * 16 * SROW * 4;
  static constexpr int STAGES = ((MINB == 2 ? 110 : 220) * 1024) / STAGE < 8
                                    ? ((MINB == 2 ? 110 : 220) * 1024) / STAGE : 8;
  static constexpr uint32_t RING = STAGES * STAGE > STAGING ? STAGES * STAGE : STAGING;
  static constexpr size_t SMEM = RING + 16 * STAGES + 1024;
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// out = hidden + (acc * so + bo) over the fp32 head sums acc
template <typename T>
struct HeadSumOut : int8h::RowScaleOut<T> {
  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
  __device__ __forceinline__ float value(float, int col, float acc) const {
    return __fadd_rn(__fmul_rn(acc, this->s[col]), this->bias[col]);
  }
};

// float(x) for |x| < 2^22, exactly: x added to the bits of 1.5 * 2^23 is
// that float plus x (its ulp is 1), and the subtraction is exact. An int32
// product of one head is at most 128 * 128 * 128 = 2^21 in magnitude. Two
// full-rate instructions in place of a conversion, of which an SM does a
// quarter as many a clock.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
}

// out[m, n] = hidden[m, n] + ((sum_h (oq_h . Wo[h])[m, n] * sa[m, h]) * so[n]
// + bo[n]); oq (M, NH * KP) and Wo (N, NH * KP) row-major, head h's KP
// bytes at h * KP, zero past HD in both. Tile: 128 rows by HN columns.
template <int HD, int HN, int MINB, typename T>
__global__ void __launch_bounds__(int8h::kThreads, MINB)
oproj_heads_sm90_kernel(const __grid_constant__ CUtensorMap tm_a0,
                        const __grid_constant__ CUtensorMap tm_a1,
                        const __grid_constant__ CUtensorMap tm_b0,
                        const __grid_constant__ CUtensorMap tm_b1,
                        const float* __restrict__ sa, int M, int N, int NH,
                        const HeadSumOut<T> epi) {
  using O = HeadRing<HD, HN, MINB>;
  using Hb = typename O::Hb;
  constexpr int KP = Hb::KP, W0 = Hb::W0, W1 = Hb::W1;
  constexpr int kBM = int8h::kBM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* staged = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full0 = base + O::RING, empty0 = full0 + 8 * O::STAGES;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * HN;
  const int warp = sm90::warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < O::STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 4 * int8h::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * int8h::kConsumers) {  // the producer warp: one head per stage
    if (lane == 0) {
      for (int h = 0; h < NH; ++h) {
        const int s = h % O::STAGES;
        const uint32_t tile = base + s * O::STAGE, full = full0 + 8 * s;
        sm90::mbar_wait(empty0 + 8 * s, ((h / O::STAGES) & 1) ^ 1);
        sm90::mbar_arrive_tx(full, O::STAGE);
        sm90::tma_load_2d(tile, &tm_a0, full, h * KP, m0);
        sm90::tma_load_2d(tile + O::A_BYTES, &tm_b0, full, h * KP, n0);
        if constexpr (W1 > 0) {
          sm90::tma_load_2d(tile + kBM * W0, &tm_a1, full, h * KP + W0, m0);
          sm90::tma_load_2d(tile + O::A_BYTES + HN * W0, &tm_b1, full, h * KP + W0, n0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2;
  const int row_lo = m0 + 64 * wg + 16 * (warp & 3) + g, row_hi = row_lo + 8;
  int acc[HN / 2];
  float facc[1][HN / 2];
#pragma unroll
  for (int i = 0; i < HN / 2; ++i) facc[0][i] = 0.f;

  for (int h = 0; h < NH; ++h) {
    const int s = h % O::STAGES;
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) acc[i] = 0;
    sm90::mbar_wait(full0 + 8 * s, (h / O::STAGES) & 1);
    const uint32_t tile = base + s * O::STAGE;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 32; ++kk) {
      const bool second = kk * 32 >= W0;
      const int kb = second ? kk - W0 / 32 : kk;
      const uint64_t da = second ? desc_block(tile + kBM * W0, W1, 64 * wg, kb)
                                 : desc_block(tile, W0, 64 * wg, kb);
      const uint64_t db = second ? desc_block(tile + O::A_BYTES + HN * W0, W1, 0, kb)
                                 : desc_block(tile + O::A_BYTES, W0, 0, kb);
      if constexpr (HN == 128) {
        sm90::wgmma_ss_s8_n128(acc, da, db);
      } else {
        sm90::wgmma_ss_s8_n64(acc, da, db);
      }
    }
    sm90::wg_commit();
    // the head's row scales, read while its products run
    const float s_lo = row_lo < M ? sa[static_cast<long long>(row_lo) * NH + h] : 0.f;
    const float s_hi = row_hi < M ? sa[static_cast<long long>(row_hi) * NH + h] : 0.f;
    sm90::wg_wait<0>();  // the head's products, complete before they are scaled
    sm90::reg_fence(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    // acc_f32 = acc_f32 + part * s_row_head, the TPU kernel's order
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) {
      facc[0][i] = __fadd_rn(facc[0][i],
                             __fmul_rn(small_int_to_float(acc[i]), (i >> 1) & 1 ? s_hi : s_lo));
    }
  }

  // every product of both warpgroups is done: the ring is free for staging
  int8h::consumers_sync();
  int8h::store_tile<1, HN, O::SROW>(facc, staged, epi, m0, n0, 0, M, N);
}

// Out-projection tiles: 128 rows by 64 columns, two blocks an SM (80
// registers a thread), so that one block's per-head waits and flushes and
// its epilogue run beside the other's products: on an H100 80GB HBM3 at
// 700 W, 0.41 ms at the tower's shape against 0.50 for 128 x 128 tiles at
// one block an SM (167 registers) and 0.59 for 128 x 64 at one; a second
// accumulator set, so that a head's products run during the previous
// head's flush, gained nothing at 128 x 64 (PERF.md §6).
constexpr int kOprojCols = 64, kOprojBlocksPerSM = 2;

template <int HD, typename T>
int oproj(const AttnPolicy& p, const int8_t* wo, const float* so, const float* bo,
          const void* hidden, void* out, int M, int N, cudaStream_t st) {
  constexpr int HN = kOprojCols, MINB = kOprojBlocksPerSM;
  using O = HeadRing<HD, HN, MINB>;
  using Hb = typename O::Hb;
  const int mt = (M + int8h::kBM - 1) / int8h::kBM;
  if (mt > 65535) return -3;
  const long long ld = static_cast<long long>(p.NH) * Hb::KP;  // oq's and Wo's rows
  const cuuint64_t adims[2] = {(cuuint64_t)ld, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)ld, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)ld};
  const int w1 = Hb::W1 > 0 ? Hb::W1 : Hb::W0;  // an unused second map repeats the first
  const cuuint32_t abox0[2] = {Hb::W0, int8h::kBM}, abox1[2] = {(cuuint32_t)w1, int8h::kBM};
  const cuuint32_t bbox0[2] = {Hb::W0, HN}, bbox1[2] = {(cuuint32_t)w1, HN};
  CUtensorMap ma0, ma1, mb0, mb1;
  constexpr auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!sm90::encode_map(&ma0, u8, 2, p.oq, adims, stride, abox0, swizzle_of(Hb::W0)) ||
      !sm90::encode_map(&ma1, u8, 2, p.oq, adims, stride, abox1, swizzle_of(w1)) ||
      !sm90::encode_map(&mb0, u8, 2, wo, bdims, stride, bbox0, swizzle_of(Hb::W0)) ||
      !sm90::encode_map(&mb1, u8, 2, wo, bdims, stride, bbox1, swizzle_of(w1))) {
    return sm90::kTmaRejected;
  }
  const auto kern = oproj_heads_sm90_kernel<HD, HN, MINB, T>;
  const int rc = sm90::set_smem(kern, O::SMEM);
  if (rc != 0) return rc;
  HeadSumOut<T> epi{{nullptr, so, bo, static_cast<const T*>(hidden), static_cast<T*>(out), N}};
  kern<<<dim3((N + HN - 1) / HN, mt), int8h::kThreads, O::SMEM, st>>>(
      ma0, ma1, mb0, mb1, p.sa, M, N, p.NH, epi);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int attention_and_oproj(int dtype, const AttnPolicy& p, int B, const int8_t* wo, const float* so,
                        const float* bo, const void* hidden, void* out, int M, int H,
                        cudaStream_t st) {
  const int rc = mavlm::two_sweep::launch<HD>(p, B, st);
  if (rc != 0) return rc;
  return dtype == 0 ? oproj<HD, __nv_bfloat16>(p, wo, so, bo, hidden, out, M, H, st)
                    : oproj<HD, float>(p, wo, so, bo, hidden, out, M, H, st);
}

}  // namespace

// dtype: 0 = bf16 hidden and out, 1 = fp32. wq, wk, wv (H, H) int8
// column-major, wo the same with each head's rows zero-padded to KP (hd
// rounded up to 32): (H, NH * KP) row-major; s*, b* (H,) fp32; ln_w, ln_b
// (H,) fp32. Scratch: xq (B*S, H) int8, sx (B*S,) fp32, q, k, v (B, NH, S,
// H/NH) bf16, oq (B*S, NH * KP) int8, sa (B*S, NH) fp32. Returns 0, a cudaError_t, -1 (head dim), -2 (dtype), -3
// (shape) or -4 (a tensor map refused).
extern "C" int attn_block_int8(int dtype, const void* hidden, const void* ln_w,
                               const void* ln_b, const void* wq, const void* sq,
                               const void* bq, const void* wk, const void* sk,
                               const void* bk, const void* wv, const void* sv,
                               const void* bv, const void* wo, const void* so,
                               const void* bo, void* out, void* xq, void* sx, void* q,
                               void* k, void* v, void* oq, void* sa, int B, int S, int H,
                               int NH, int valid, float eps, float scale, void* stream) {
  if (NH < 1 || H % NH || H % 16) return -3;
  if (dtype != 0 && dtype != 1) return -2;
  const long long m = static_cast<long long>(B) * S;
  if (m > 0x7fffffff) return -3;
  const int hd = H / NH;
  if (hd != 32 && hd != 64 && hd != 72 && hd != 128) return -1;
  int rc = qkv_int8(dtype, hidden, ln_w, ln_b, wq, sq, bq, wk, sk, bk, wv, sv, bv, q, k, v,
                    xq, sx, B, S, H, NH, eps, stream);
  if (rc != 0) return rc;
  AttnPolicy p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.oq = static_cast<int8_t*>(oq);
  p.sa = static_cast<float*>(sa);
  p.NH = NH;
  p.S = S;
  p.valid_keys = valid;
  p.scale = scale;
  const auto* w = static_cast<const int8_t*>(wo);
  const auto* s = static_cast<const float*>(so);
  const auto* bias = static_cast<const float*>(bo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = static_cast<int>(m);
  switch (hd) {
    case 32: rc = attention_and_oproj<32>(dtype, p, B, w, s, bias, hidden, out, M, H, st); break;
    case 64: rc = attention_and_oproj<64>(dtype, p, B, w, s, bias, hidden, out, M, H, st); break;
    case 72: rc = attention_and_oproj<72>(dtype, p, B, w, s, bias, hidden, out, M, H, st); break;
    default: rc = attention_and_oproj<128>(dtype, p, B, w, s, bias, hidden, out, M, H, st); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
