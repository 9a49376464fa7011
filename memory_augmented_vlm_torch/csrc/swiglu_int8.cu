// The int8 SwiGLU MLP half-block of the LM for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the TPU kernel `_fused_swiglu_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:214
// fused_swiglu_block_int8 and computes the same function:
//   hidden + down(requant(silu(gate(xq)) * up(xq))),  xq = quant(RMSNorm(hidden))
// with RMSNorm = hidden * rsqrt(mean(hidden^2) + eps) * w (no mean, no
// bias), gate = acc * sx * sg and up = acc * sx * su in fp32, silu(g) =
// g * 1 / (1 + exp(-g)), the requant scale taken over the whole I-wide fp32
// row, down = acc * sh * sd, and the residual added in fp32 before the cast
// to hidden's dtype. No projection has a bias. A row of zeros gives x = 0,
// the floor scale and h = 0, so it comes back as it went in.
//
// What bounds it on the H100: at the LM's prefill shape (9472 rows, 896 ->
// 2 x 4864 -> 896) the three products are 247.7 GOP of int8 work against
// ~47 MB of hidden in and out and of weights, so the tensor cores bound it
// (0.125 ms at 1,979 TOP/s).
//
// Design: the stage split of mlp_int8.cu (the TPU kernel keeps the three
// weight matrices and the (BM, 4864) intermediates in VMEM, which a Hopper
// block cannot):
//   1. RMSNorm + row quant of hidden -> int8 scratch (one warp per row),
//      which also zeroes h's row maxima;
//   2. ONE paired GEMM for gate and up on the Hopper core
//      (int8_gemm_sm90.cuh): silu(g) * u needs both accumulators of a (row,
//      channel) in one thread, so each block takes channels [n0, n0 + 64)
//      of the gate matrix and of the up matrix as its two B halves over the
//      same A tile (two TMA boxes, two m64n64k32 products per k-step into
//      two accumulator sets, two blocks an SM): equal registers hold
//      (gate_j, up_j), and the epilogue finds them side by side in its
//      staged row. No weight copy is made (0.27 ms at the prefill's shape
//      against 0.34 for one block an SM of 128-channel pairs). The
//      epilogue stores h in fp32 and folds |h| into the row max;
//   3. h -> int8 with its row's scale;
//   4. down GEMM whose epilogue adds the residual (128 x 128 tiles, two
//      blocks an SM, at the prefill's shape: 74 x 7 = 518 tiles, where
//      128 x 256 tiles would run 2.2 waves of 132 SMs).
// The fp32 h round trip (2 x 184 MB at 9472 x 4864) is what the TPU design
// avoids; see mlp_int8.cu.

#include "int8_gemm_sm90.cuh"

namespace {

using namespace int8k;

struct GateUpEpi {
  static constexpr bool kRowMax = true;
  static constexpr bool kPaired = true;
  static constexpr bool kRagged = false;
  const float* sx;
  const float* sg;
  const float* su;
  float* h;
  float* hmax;
  int I;

  __device__ __forceinline__ float row_scale(int row) const { return sx[row]; }
  // a: the gate's accumulator of channel j, b: the up's
  __device__ __forceinline__ float value(float x, int j, int a, int b) const {
    const float g = __fmul_rn(__fmul_rn(static_cast<float>(a), x), sg[j]);
    const float u = __fmul_rn(__fmul_rn(static_cast<float>(b), x), su[j]);
    const float silu = __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
    return __fmul_rn(silu, u);
  }
  __device__ __forceinline__ void row_max(int row, float m) const {
    atomicMax(reinterpret_cast<int*>(hmax) + row, __float_as_int(m));
  }
  __device__ __forceinline__ void store4(int row, int j, float4 v) const {
    *reinterpret_cast<float4*>(h + static_cast<long long>(row) * I + j) = v;
  }
};

template <typename T>
int run(const void* hidden, const float* rms_w, const int8_t* wg, const float* sg,
        const int8_t* wu, const float* su, const int8_t* wd, const float* sd, void* out,
        int8_t* xq, float* h, int8_t* hq, float* sx, float* hmax, float* sh, int M, int K,
        int I, float eps, cudaStream_t st) {
  launch_rowquant<T, true>(hidden, rms_w, xq, sx, M, K, eps, st, hmax);
  int rc = int8h::launch_gemm_sm90<2, 2, 64>(xq, K, wg, wu, K, I, M, I, K,
                                             GateUpEpi{sx, sg, su, h, hmax, I}, st);
  if (rc != 0) return rc;
  launch_requant(h, hmax, hq, sh, M, I, st);
  int8h::RowScaleOut<T> down{sh, sd, nullptr, static_cast<const T*>(hidden),
                             static_cast<T*>(out), K};
  return int8h::launch_gemm_sm90_by_shape(hq, I, wd, I, K, M, K, I, down, st);
}

}  // namespace

// dtype: 0 = bf16 hidden, 1 = fp32 hidden. wg and wu are (K, I), wd (I, K),
// all column-major. xq (M, K) int8, h (M, I) fp32, hq (M, I) int8 and sx,
// hmax, sh (M,) fp32 are scratch. Returns 0, a cudaError_t, -2 (dtype), -3
// (shape) or -4 (a tensor map refused).
extern "C" int swiglu_int8(int dtype, const void* hidden, const void* rms_w, const void* wg,
                           const void* sg, const void* wu, const void* su, const void* wd,
                           const void* sd, void* out, void* xq, void* h, void* hq, void* sx,
                           void* hmax, void* sh, int M, int K, int I, float eps,
                           void* stream) {
  if (K % 16 || I % 16) return -3;
  if (dtype != 0 && dtype != 1) return -2;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto* run_t = dtype == 0 ? &run<__nv_bfloat16> : &run<float>;
  const int rc = run_t(hidden, f(rms_w), i8(wg), f(sg), i8(wu), f(su), i8(wd), f(sd), out,
                       static_cast<int8_t*>(xq), static_cast<float*>(h),
                       static_cast<int8_t*>(hq), static_cast<float*>(sx),
                       static_cast<float*>(hmax), static_cast<float*>(sh), M, K, I, eps,
                       static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
