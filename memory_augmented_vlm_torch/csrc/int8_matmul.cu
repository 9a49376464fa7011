// The w8a8 matrix product (int8_matmul) and the bare int8 GEMM of the int8
// ceiling micro-benchmark (int8_gemm_bf16) for Hopper (sm_90a), bound to
// Python with ctypes.
//
// int8_matmul replaces the TPU kernel `_ws_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_int8.py:63 int8_matmul and computes
// the same function: the rows of x quantized to int8 (x * (1/s), floor
// 1e-12; a pass before the kernel on the TPU, stage 1 here), an int8 x int8
// -> int32 product with the (K, N) int8 weights, and
//   acc * sx * sw [+ bias]
// in fp32, cast once to x's dtype. Any M >= 1: rows past M are zero-filled
// on load and masked in the epilogue, so one row needs no padding.
//
// What bounds it on the H100: at the tower MLP's shapes (46656 x 1152 x
// 4304 and 46656 x 4304 x 1152) each product is 462.7 GOP of int8 work
// against ~0.5 GB of activations, so the tensor cores bound it (0.234 ms at
// 1,979 TOP/s); at one row (896 -> 4864) the 4.4 MB of weights bound it
// (1.3 us at 3.35 TB/s).
//
// Design: the TPU kernel is weights-stationary (a (K, 512) weight tile
// stays in VMEM while the activation tiles stream past). Here the 128 x 128
// output tiles of int8_gemm.cuh run in parallel with blockIdx.x over N
// fastest, so the blocks in flight share a few activation row tiles and the
// whole weight matrix (at most 5 MB) lives in the 50 MB L2.
//
// int8_gemm_bf16 replaces the TPU kernel `_ws_kernel` behind
// tools_int8_ceiling.py:80 build_pallas, the int8 ceiling micro-benchmark:
// int8 x (M, K) . int8 w (K, N) -> int32 -> bf16, with no scale. The cast
// goes through fp32 (cvt.rn.f32.s32, then round to bf16), as XLA converts
// an int32 to bf16: sums past 2^24 can round twice. Bound at the tool's
// shape (46656 x 1152 x 4304): 462.7 GOP of int8 work, 0.234 ms at 1,979
// TOP/s. The same GEMM with a cast for its epilogue; N is not padded to
// the TPU's lane multiple (4352), the GEMM masks the ragged edge.

#include "int8_gemm.cuh"

namespace {

using namespace int8k;

template <typename T>
int run(const void* x, const int8_t* w, const float* sw, const float* bias, void* out,
        int8_t* xq, float* sx, int M, int N, int K, cudaStream_t st) {
  launch_rowquant<T, false>(x, nullptr, xq, sx, M, K, 0.f, st);
  RowScaleEpi<T> epi{sx, sw, bias, nullptr, static_cast<T*>(out), N};
  BOperands bs{{w, nullptr, nullptr}, K};
  return launch_gemm(xq, K, bs, 1, M, N, K, epi, st);
}

// acc -> fp32 -> bf16
struct Int32ToBf16Epi {
  static constexpr bool kRowMax = false;
  static constexpr bool kInterleaveB = false;
  __nv_bfloat16* out;
  int N;

  __device__ __forceinline__ float operator()(int, int row, int col, int a0, int a1) const {
    store2(out + static_cast<long long>(row) * N + col, __int2float_rn(a0), __int2float_rn(a1));
    return 0.f;
  }
  __device__ void row_max(int, float) const {}
};

}  // namespace

// dtype: 0 = bf16 x and out, 1 = fp32. w is (K, N) column-major; bias may
// be null. xq (M, K) int8 and sx (M,) fp32 are scratch. Returns 0, a
// cudaError_t, -2 (dtype) or -3 (shape: K % 16, N % 2).
extern "C" int int8_matmul(int dtype, const void* x, const void* w, const void* sw,
                           const void* bias, void* out, void* xq, void* sx, int M, int N,
                           int K, void* stream) {
  if (dtype != 0 && dtype != 1) return -2;
  auto* run_t = dtype == 0 ? &run<__nv_bfloat16> : &run<float>;
  const int rc = run_t(x, static_cast<const int8_t*>(w), static_cast<const float*>(sw),
                       static_cast<const float*>(bias), out, static_cast<int8_t*>(xq),
                       static_cast<float*>(sx), M, N, K, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) int8 row-major, w (K, N) int8 column-major -> out (M, N) bf16.
// Returns 0, a cudaError_t or -3 (shape: K % 16, N % 2).
extern "C" int int8_gemm_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                              void* stream) {
  const Int32ToBf16Epi epi{static_cast<__nv_bfloat16*>(out), N};
  const BOperands bs{{static_cast<const int8_t*>(w), nullptr, nullptr}, K};
  const int rc = launch_gemm(static_cast<const int8_t*>(x), K, bs, 1, M, N, K, epi,
                             static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
