// The int8 transformer MLP for Hopper (sm_90a), bound to Python with
// ctypes: as a whole half-block (mlp_int8) and as the bare MLP
// (mlp_int8_core).
//
// mlp_int8 replaces the TPU kernel `_fused_block_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:127 fused_mlp_block_int8
// and computes the same function:
//   hidden + fc2(requant(gelu_tanh(fc1(quant(LayerNorm(hidden))))))
// with fc1 = acc * sx * s1 + b1 and fc2 = acc * sh * s2 + b2 in fp32, the
// requant scale sh taken over the whole I-wide fp32 GELU row, and the
// residual added in fp32 before the cast to hidden's dtype.
//
// mlp_int8_core replaces `_fused_mlp_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:51 fused_mlp_int8: the
// same without the LayerNorm and the residual,
//   fc2(requant(gelu_tanh(fc1(quant(x))))) cast to x's dtype,
// where the rows of x itself are quantized (a pass before the kernel on the
// TPU, stage 1 here).
//
// What bounds it on the H100: at the tower's shape (46656 rows, 1152 ->
// 4304 -> 1152) the two products are 925.3 GOP of int8 work against
// ~215 MB of bf16 hidden in and out, so the tensor cores bound it
// (0.468 ms at 1,979 TOP/s).
//
// Design: the TPU kernels keep W1, W2 (~10 MB) and the (BM, 4304)
// intermediate resident in VMEM; a Hopper block has 227 KB of shared
// memory, and a 64-row fp32 intermediate alone is 1.1 MB. So the block is
// split at the two points where a whole row must be known:
//   1. (LayerNorm +) row quant of the input -> int8 scratch (one warp per
//      row), which also zeroes h's row maxima;
//   2. fc1 on the Hopper GEMM core (int8_gemm_sm90.cuh: TMA ring, s8
//      wgmma from shared memory) in 128 x 128 tiles, two blocks an SM, so
//      that one block's epilogue (its tanh GELU costs about what the
//      1152-deep products do) runs beside the other's products. The
//      epilogue applies the scales, bias and tanh GELU, stores h in fp32
//      in row-contiguous vectors, and folds |h| into a per-row max, one
//      atomicMax on the float's bits per (row, tile) (non-negative floats
//      order as their int bits);
//   3. h -> int8 with its row's scale, one warp per row (requant_kernel);
//   4. fc2 on the same core over the I-deep codes (4304: TMA zero-fills
//      the last 128-byte step past it), in tiles of 128 x 256 (or 128 x
//      128 for a grid of under four waves), whose epilogue adds b2 (and
//      the residual).
// h stays fp32 until the requant: rounding it first (to bf16, say) would
// change the codes wherever a bf16 step crosses a code boundary, not only
// at ties. The cost is the fp32 intermediate's round trip (~0.8 GB written
// and read at 46656 x 4304), which the TPU design avoids; two ways around
// it measured slower on the H100 (PERF.md): recomputing fc1 (a pass for
// the row maxima, a second that writes codes), and requantizing each
// 128-row block in the fc1 block that finishes it last, from L2.

#include "int8_gemm_sm90.cuh"

namespace {

using namespace int8k;

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))
  const float c = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// fc1 + GELU: h in fp32 and its row max
struct Fc1Epi {
  static constexpr bool kRowMax = true;
  static constexpr bool kPaired = false;
  static constexpr bool kRagged = false;
  const float* sx;
  const float* s1;
  const float* b1;
  float* h;
  float* hmax;
  int I;

  __device__ __forceinline__ float row_scale(int row) const { return sx[row]; }
  __device__ __forceinline__ float value(float x, int col, int a) const {
    return gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a), x), s1[col]),
                               b1[col]));
  }
  __device__ __forceinline__ void row_max(int row, float m) const {
    atomicMax(reinterpret_cast<int*>(hmax) + row, __float_as_int(m));
  }
  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    *reinterpret_cast<float4*>(h + static_cast<long long>(row) * I + col) = v;
  }
};

// kBlock: the half-block (LayerNorm before, residual after); else the bare
// MLP of x's own rows.
template <typename T, bool kBlock>
int run(const void* x, const float* ln_w, const float* ln_b, const int8_t* w1,
        const float* s1, const float* b1, const int8_t* w2, const float* s2, const float* b2,
        void* out, int8_t* xq, float* h, int8_t* hq, float* sx, float* hmax, float* sh,
        int M, int K, int I, float eps, cudaStream_t st) {
  int rc = 0;
  if constexpr (kBlock) {
    rc = launch_ln_rowquant<T>(x, ln_w, ln_b, xq, sx, M, K, eps, st, hmax);
  } else {
    launch_rowquant<T, false>(x, nullptr, xq, sx, M, K, 0.f, st, hmax);
  }
  if (rc != 0) return rc;
  rc = int8h::launch_gemm_sm90<1, 2>(xq, K, w1, w1, K, I, M, I, K,
                                     Fc1Epi{sx, s1, b1, h, hmax, I}, st);
  if (rc != 0) return rc;
  launch_requant(h, hmax, hq, sh, M, I, st);
  int8h::RowScaleOut<T> fc2{sh, s2, b2, kBlock ? static_cast<const T*>(x) : nullptr,
                            static_cast<T*>(out), K};
  return int8h::launch_gemm_sm90_by_shape(hq, I, w2, I, K, M, K, I, fc2, st);
}

template <bool kBlock>
int dispatch(int dtype, const void* x, const void* ln_w, const void* ln_b, const void* w1,
             const void* s1, const void* b1, const void* w2, const void* s2, const void* b2,
             void* out, void* xq, void* h, void* hq, void* sx, void* hmax, void* sh, int M,
             int K, int I, float eps, void* stream) {
  if (K % 16 || I % 16) return -3;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  if (dtype != 0 && dtype != 1) return -2;
  auto* run_t = dtype == 0 ? &run<__nv_bfloat16, kBlock> : &run<float, kBlock>;
  const int rc = run_t(x, f(ln_w), f(ln_b), i8(w1), f(s1), f(b1), i8(w2), f(s2), f(b2), out,
                       static_cast<int8_t*>(xq), static_cast<float*>(h),
                       static_cast<int8_t*>(hq), static_cast<float*>(sx),
                       static_cast<float*>(hmax), static_cast<float*>(sh), M, K, I, eps,
                       static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16 hidden, 1 = fp32 hidden. w1 is (K, I) and w2 (I, K), both
// column-major. xq (M, K) int8, h (M, I) fp32, hq (M, I) int8 and sx, hmax,
// sh (M,) fp32 are scratch. Returns 0, a cudaError_t, -2 (dtype), -3
// (shape) or -4 (a tensor map refused).
extern "C" int mlp_int8(int dtype, const void* hidden, const void* ln_w, const void* ln_b,
                        const void* w1, const void* s1, const void* b1,
                        const void* w2, const void* s2, const void* b2, void* out,
                        void* xq, void* h, void* hq, void* sx, void* hmax, void* sh,
                        int M, int K, int I, float eps, void* stream) {
  return dispatch<true>(dtype, hidden, ln_w, ln_b, w1, s1, b1, w2, s2, b2, out, xq, h, hq, sx,
                        hmax, sh, M, K, I, eps, stream);
}

// The bare MLP of x (M, K): the arguments of mlp_int8 less the LayerNorm's.
extern "C" int mlp_int8_core(int dtype, const void* x, const void* w1, const void* s1,
                             const void* b1, const void* w2, const void* s2, const void* b2,
                             void* out, void* xq, void* h, void* hq, void* sx, void* hmax,
                             void* sh, int M, int K, int I, void* stream) {
  return dispatch<false>(dtype, x, nullptr, nullptr, w1, s1, b1, w2, s2, b2, out, xq, h, hq,
                         sx, hmax, sh, M, K, I, 0.f, stream);
}
