// The int8 transformer MLP half-block for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces the TPU kernel `_fused_block_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:127 fused_mlp_block_int8
// and computes the same function:
//   hidden + fc2(requant(gelu_tanh(fc1(quant(LayerNorm(hidden))))))
// with fc1 = acc * sx * s1 + b1 and fc2 = acc * sh * s2 + b2 in fp32, the
// requant scale sh taken over the whole I-wide fp32 GELU row, and the
// residual added in fp32 before the cast to hidden's dtype.
//
// What bounds it on the H100: at the tower's shape (46656 rows, 1152 ->
// 4304 -> 1152) the two products are 925.3 GOP of int8 work against
// ~215 MB of bf16 hidden in and out, so the tensor cores bound it
// (0.468 ms at 1,979 TOP/s).
//
// Design: the TPU kernel keeps W1, W2 (~10 MB) and the (BM, 4304)
// intermediate resident in VMEM; a Hopper block has 227 KB of shared
// memory, and a 64-row fp32 intermediate alone is 1.1 MB. So the block is
// split at the two points where a whole row must be known:
//   1. LayerNorm + row quant of hidden -> int8 scratch (one warp per row);
//   2. fc1 GEMM; the epilogue applies the scales, bias and tanh GELU,
//      stores h in fp32 and folds |h| into a per-row max with atomicMax on
//      the float's bits (non-negative floats order as their int bits);
//   3. h -> int8 with its row's scale, one warp per row;
//   4. fc2 GEMM over the I-deep codes (4304, zero-filled past it to the
//      64-byte step) whose epilogue adds b2 and the residual.
// h stays fp32 until the requant: rounding it first would change the
// codes. The cost is the fp32 intermediate's round trip (~0.8 GB written
// and read at 46656 x 4304), which the TPU design avoids and a later
// version can cut by recomputing fc1 instead.

#include "int8_gemm.cuh"

namespace {

using namespace int8k;

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))
  const float c = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

struct Fc1Epi {
  static constexpr bool kRowMax = true;
  const float* sx;
  const float* s1;
  const float* b1;
  float* h;
  int* hmax_bits;
  int I;

  __device__ __forceinline__ float operator()(int, int row, int col, int a0, int a1) const {
    const float x = sx[row];
    const float g0 = gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a0), x), s1[col]),
                                         b1[col]));
    const float g1 = gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a1), x),
                                                   s1[col + 1]), b1[col + 1]));
    *reinterpret_cast<float2*>(h + static_cast<long long>(row) * I + col) = make_float2(g0, g1);
    return fmaxf(fabsf(g0), fabsf(g1));
  }
  __device__ __forceinline__ void row_max(int row, float m) const {
    atomicMax(hmax_bits + row, __float_as_int(m));
  }
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

template <typename T>
struct Fc2Epi {
  static constexpr bool kRowMax = false;
  const float* sh;
  const float* s2;
  const float* b2;
  const T* hidden;
  T* out;
  int K;

  __device__ __forceinline__ float operator()(int, int row, int col, int a0, int a1) const {
    const float x = sh[row];
    const long long off = static_cast<long long>(row) * K + col;
    const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a0), x), s2[col]), b2[col]);
    const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a1), x), s2[col + 1]),
                               b2[col + 1]);
    store2(out + off, __fadd_rn(to_float(hidden[off]), y0),
           __fadd_rn(to_float(hidden[off + 1]), y1));
    return 0.f;
  }
  __device__ void row_max(int, float) const {}
};

// h (M, I) fp32 -> codes with s = max(row max, 1e-12) / 127; one warp per
// row, four values per lane step (I % 4 == 0).
__global__ void __launch_bounds__(256)
requant_kernel(const float* __restrict__ h, const float* __restrict__ hmax,
               int8_t* __restrict__ hq, float* __restrict__ sh, int M, int I) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const float s = fmaxf(hmax[row], kQuantFloor) / 127.f;
  const float inv = 1.f / s;
  const float* hr = h + static_cast<long long>(row) * I;
  int8_t* qr = hq + static_cast<long long>(row) * I;
  for (int i = lane * 4; i < I; i += 128) {
    const float4 v = *reinterpret_cast<const float4*>(hr + i);
    char4 q;
    q.x = quant_code(v.x, inv);
    q.y = quant_code(v.y, inv);
    q.z = quant_code(v.z, inv);
    q.w = quant_code(v.w, inv);
    *reinterpret_cast<char4*>(qr + i) = q;
  }
  if (lane == 0) sh[row] = s;
}

template <typename T>
int run(const void* hidden, const float* ln_w, const float* ln_b, const int8_t* w1,
        const float* s1, const float* b1, const int8_t* w2, const float* s2, const float* b2,
        void* out, int8_t* xq, float* h, int8_t* hq, float* sx, float* hmax, float* sh,
        int M, int K, int I, float eps, cudaStream_t st) {
  int rc = launch_ln_rowquant<T>(hidden, ln_w, ln_b, xq, sx, M, K, eps, st);
  if (rc != 0) return rc;
  cudaMemsetAsync(hmax, 0, sizeof(float) * M, st);
  Fc1Epi fc1{sx, s1, b1, h, reinterpret_cast<int*>(hmax), I};
  BOperands b1s{{w1, nullptr, nullptr}, K};
  rc = launch_gemm(xq, K, b1s, 1, M, I, K, fc1, st);
  if (rc != 0) return rc;
  requant_kernel<<<(M + 7) / 8, 256, 0, st>>>(h, hmax, hq, sh, M, I);
  Fc2Epi<T> fc2{sh, s2, b2, static_cast<const T*>(hidden), static_cast<T*>(out), K};
  BOperands b2s{{w2, nullptr, nullptr}, I};
  return launch_gemm(hq, I, b2s, 1, M, K, I, fc2, st);
}

}  // namespace

// dtype: 0 = bf16 hidden, 1 = fp32 hidden. w1 is (K, I) and w2 (I, K), both
// column-major. xq (M, K) int8, h (M, I) fp32, hq (M, I) int8 and sx, hmax,
// sh (M,) fp32 are scratch. Returns 0, a cudaError_t, -2 (dtype) or -3
// (shape).
extern "C" int mlp_int8(int dtype, const void* hidden, const void* ln_w, const void* ln_b,
                        const void* w1, const void* s1, const void* b1,
                        const void* w2, const void* s2, const void* b2, void* out,
                        void* xq, void* h, void* hq, void* sx, void* hmax, void* sh,
                        int M, int K, int I, float eps, void* stream) {
  if (K % 16 || I % 16) return -3;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = run<__nv_bfloat16>(hidden, f(ln_w), f(ln_b), i8(w1), f(s1), f(b1), i8(w2), f(s2),
                            f(b2), out, static_cast<int8_t*>(xq), static_cast<float*>(h),
                            static_cast<int8_t*>(hq), static_cast<float*>(sx),
                            static_cast<float*>(hmax), static_cast<float*>(sh), M, K, I, eps,
                            st);
  } else if (dtype == 1) {
    rc = run<float>(hidden, f(ln_w), f(ln_b), i8(w1), f(s1), f(b1), i8(w2), f(s2), f(b2), out,
                    static_cast<int8_t*>(xq), static_cast<float*>(h), static_cast<int8_t*>(hq),
                    static_cast<float*>(sx), static_cast<float*>(hmax), static_cast<float*>(sh),
                    M, K, I, eps, st);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
