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
//   2. Per-head attention, one block per 64-row q slab, head and frame:
//      the two-sweep kernel of two_sweep.cuh that flash_merge.cu also
//      runs (the row max first, so P rounds against the final max), with
//      this kernel's softmax and an epilogue that quantizes each row's hd
//      outputs into int8 codes (B*S, H) and a per-(row, head) scale
//      (B*S, NH): AttnPolicy.
//   3. The out-projection: a 128 x 128 output tile of 8 warps (the shape of
//      int8_gemm.cuh's GEMM) loops over the heads outside the depth loop.
//      A head's hd codes (72) are not a multiple of int8 mma's depth of
//      32, so each head is staged with its depth zero-padded to 32 (96)
//      by 8-byte cp.async copies, its int32 products are summed by three
//      mma steps, and the fp32 accumulator takes them times the row's scale
//      before the next head: the TPU kernel's per-head sum, in its order,
//      in registers. The padding costs a third more tensor-core work at
//      hd 72. Two stages double-buffer the heads.

#include <math.h>

#include "int8_gemm.cuh"
#include "mma.cuh"
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
using int8k::store2;
using int8k::to_float;
using mavlm::lds32;

constexpr float kNegInf = -1e30f;  // pallas_attn_block.NEG_INF

// #12's softmax for two_sweep.cuh: q as it is, the scale on the fp32
// logits, base e, o = (P.v) / l, and an epilogue that quantizes each row's
// hd outputs into int8 codes and one scale per (row, head).
struct AttnPolicy {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int8_t* oq;              // (B * S, NH * D) codes of o
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
    int8_t* orow = oq + m * (NH * D) + h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      char2 c2;
      c2.x = quant_code(o[dt][0], inv);
      c2.y = quant_code(o[dt][1], inv);
      *reinterpret_cast<char2*>(orow + dt * 8 + 2 * t) = c2;
    }
    if (t == 0) sa[m * NH + h] = s;
  }
};

// ---------------------------------------------------------------------------
// The out-projection with a per-(row, head) scale
// ---------------------------------------------------------------------------

// 8-byte global -> shared copy; zero-fills when !pred.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

template <int HD>
struct OprojShape {
  static constexpr int KP = (HD + 31) / 32 * 32;  // a head's depth, zero-padded to 32
  static constexpr int SR = KP + 16;              // bytes per staged row (bank skew)
  static constexpr int STAGE = (int8k::BM + int8k::BN) * SR;
  static constexpr int SMEM = 2 * STAGE;
};

// out[m, n] = hidden[m, n] + ((sum_h (oq_h . Wo[h])[m, n] * sa[m, h]) * so[n]
// + bo[n]); oq (M, NH * HD) row-major, Wo (NH * HD, N) column-major.
template <int HD, typename T>
__global__ void __launch_bounds__(int8k::THREADS)
oproj_heads_kernel(const int8_t* __restrict__ oq, const float* __restrict__ sa,
                   const int8_t* __restrict__ wo, const float* __restrict__ so,
                   const float* __restrict__ bo, const T* __restrict__ hidden,
                   T* __restrict__ out, int M, int N, int NH) {
  using namespace int8k;
  using Shape = OprojShape<HD>;
  constexpr int KP = Shape::KP, SR = Shape::SR, STAGE = Shape::STAGE;
  constexpr int CH = HD / 8;  // 8-byte chunks of a head's row
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const long long K = static_cast<long long>(NH) * HD;

  // the depth padding [HD, KP) of every row stays zero: the copies below
  // write only [0, HD)
  for (int i = tid; i < Shape::SMEM / 16; i += THREADS) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  auto load_stage = [&](int stage, int head) {
    uint8_t* sA = smem + stage * STAGE;
    uint8_t* sB = sA + BM * SR;
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = m0 + r < M;
      cp_async8(sA + r * SR + c, ok ? oq + (m0 + r) * K + head * HD + c : oq, ok);
    }
    for (int i = tid; i < BN * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = n0 + r < N;
      cp_async8(sB + r * SR + c, ok ? wo + (n0 + r) * K + head * HD + c : wo, ok);
    }
  };

  float facc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) facc[mi][ni][0] = facc[mi][ni][1] = facc[mi][ni][2] = facc[mi][ni][3] = 0.f;

  load_stage(0, 0);
  mavlm::cp_async_commit();
  for (int head = 0; head < NH; ++head) {
    if (head + 1 < NH) load_stage((head + 1) & 1, head + 1);
    mavlm::cp_async_commit();
    mavlm::cp_async_wait<1>();  // this head's stage has landed
    __syncthreads();            // ... for every thread
    const uint8_t* sA = smem + (head & 1) * STAGE;
    const uint8_t* sB = sA + BM * SR;
    int acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KP; kk += 32) {
      uint32_t a[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint8_t* pa = sA + (wm0 + mi * 16 + g) * SR + kk + 4 * t;
        a[mi][0] = lds32(pa);
        a[mi][1] = lds32(pa + 8 * SR);
        a[mi][2] = lds32(pa + 16);
        a[mi][3] = lds32(pa + 8 * SR + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint8_t* pb = sB + (wn0 + ni * 8 + g) * SR + kk + 4 * t;
        bf[ni][0] = lds32(pb);
        bf[ni][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mavlm::mma_s8_16832(acc[mi][ni], a[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();  // the stage is consumed before the next load refills it
    // acc_f32 = acc_f32 + part * s_row_head, the TPU kernel's order
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm0 + mi * 16 + g + 8 * hf;
        const float s = row < M ? sa[static_cast<long long>(row) * NH + head] : 0.f;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            facc[mi][ni][2 * hf + e] = __fadd_rn(
                facc[mi][ni][2 * hf + e], __fmul_rn(static_cast<float>(acc[mi][ni][2 * hf + e]), s));
          }
        }
      }
    }
  }
  mavlm::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm0 + mi * 16 + g + 8 * hf;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn0 + ni * 8 + 2 * t;
        if (row < M && col < N) {
          const long long off = static_cast<long long>(row) * N + col;
          const float y0 = __fadd_rn(__fmul_rn(facc[mi][ni][2 * hf], so[col]), bo[col]);
          const float y1 = __fadd_rn(__fmul_rn(facc[mi][ni][2 * hf + 1], so[col + 1]), bo[col + 1]);
          store2(out + off, __fadd_rn(to_float(hidden[off]), y0),
                 __fadd_rn(to_float(hidden[off + 1]), y1));
        }
      }
    }
  }
}

template <int HD>
int attention_and_oproj(int dtype, const AttnPolicy& p, int B, const int8_t* wo, const float* so,
                        const float* bo, const void* hidden, void* out, int M, int H,
                        cudaStream_t st) {
  mavlm::two_sweep::launch<HD>(p, B, st);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int mt = (M + int8k::BM - 1) / int8k::BM;
  if (mt > 65535) return -3;
  const dim3 grid((H + int8k::BN - 1) / int8k::BN, mt);
  constexpr int smem = OprojShape<HD>::SMEM;
  if (dtype == 0) {
    auto* kern = oproj_heads_kernel<HD, __nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<grid, int8k::THREADS, smem, st>>>(p.oq, p.sa, wo, so, bo,
                                             static_cast<const __nv_bfloat16*>(hidden),
                                             static_cast<__nv_bfloat16*>(out), M, H, p.NH);
  } else {
    auto* kern = oproj_heads_kernel<HD, float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kern<<<grid, int8k::THREADS, smem, st>>>(p.oq, p.sa, wo, so, bo,
                                             static_cast<const float*>(hidden),
                                             static_cast<float*>(out), M, H, p.NH);
  }
  return 0;
}

}  // namespace

// dtype: 0 = bf16 hidden and out, 1 = fp32. w* (H, H) int8 column-major
// with s*, b* (H,) fp32; ln_w, ln_b (H,) fp32. Scratch: xq (B*S, H) int8,
// sx (B*S,) fp32, q, k, v (B, NH, S, H/NH) bf16, oq (B*S, H) int8, sa
// (B*S, NH) fp32. Returns 0, a cudaError_t, -1 (head dim), -2 (dtype) or
// -3 (shape).
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
