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
// stays in VMEM while the activation tiles stream past). Here the product
// runs on the Hopper int8 GEMM core (int8_gemm_sm90.cuh: a producer warp
// feeds A and B tiles by TMA into an mbarrier ring, two consumer
// warpgroups issue s8 wgmma from shared memory), its blocks in flight
// sharing a few activation row tiles and the whole weight matrix (at most
// 5 MB) in the 50 MB L2, with the RowScaleOut epilogue (the plain
// version's fp32 operations in its order).
// Tiles by depth and grid size (launch_gemm_sm90_by_shape; PERF.md §6):
// the chain's fc1 (K 1152) and one decode row in 128 x 128 tiles at
// two blocks an SM, its fc2 (K 4304) in 128 x 256 tiles. One row's product
// takes ~5 us of device time in every tile tried (38 or 76 blocks), and
// the host's 0.03-0.08 ms to enqueue the call bounds it. Any N >= 1 (the
// TPU kernel pads N to its block): TMA zero-fills B's rows past N, and the
// epilogue masks its last columns and stores an element at a time where a
// row's base is not 4-aligned (N % 4 != 0).
//
// int8_gemm_bf16 replaces the TPU kernel `_ws_kernel` behind
// tools_int8_ceiling.py:80 build_pallas, the int8 ceiling micro-benchmark:
// int8 x (M, K) . int8 w (K, N) -> int32 -> bf16, with no scale. The cast
// goes through fp32 (cvt.rn.f32.s32, then round to bf16), as XLA converts
// an int32 to bf16: sums past 2^24 can round twice. Bound at the tool's
// shape (46656 x 1152 x 4304): 462.7 GOP of int8 work, 0.234 ms at 1,979
// TOP/s. It runs on the same core as int8_matmul's product, picked by the
// same rule (at K 1152: 128 x 128 tiles, two blocks an SM), with the
// Int32ToBf16Out epilogue; any N >= 1, the ragged edge masked as
// int8_matmul's (N is not padded to the TPU's lane multiple, 4352).

#include "int8_gemm_sm90.cuh"

namespace {

using namespace int8k;

template <typename T>
int run(const void* x, const int8_t* w, const float* sw, const float* bias, void* out,
        int8_t* xq, float* sx, int M, int N, int K, cudaStream_t st) {
  launch_rowquant<T, false>(x, nullptr, xq, sx, M, K, 0.f, st);
  const int8h::RowScaleOut<T, true> epi{sx, sw, bias, nullptr, static_cast<T*>(out), N};
  return int8h::launch_gemm_sm90_by_shape(xq, K, w, K, N, M, N, K, epi, st);
}

// The int8 ceiling's epilogue: the int32 sum cast to fp32 (cvt.rn.f32.s32)
// and rounded once more to bf16, no scale; any N (RowScaleOut<bf16, true>'s
// stores).
struct Int32ToBf16Out {
  static constexpr bool kRowMax = false;
  static constexpr bool kPaired = false;
  static constexpr bool kRagged = true;
  __nv_bfloat16* out;
  int N;

  __device__ __forceinline__ float row_scale(int) const { return 1.f; }
  __device__ __forceinline__ float value(float, int, int a) const {
    return static_cast<float>(a);
  }
  __device__ void row_max(int, float) const {}
  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * N + col) =
        make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  }
  __device__ __forceinline__ void store(int row, int col, float4 v, int nv) const {
    const long long off = static_cast<long long>(row) * N + col;
    if (nv == 4 && (off & 3) == 0) {
      store4(row, col, v);
      return;
    }
    const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // unrolled, so that y stays in registers
      if (j < nv) out[off + j] = __float2bfloat16_rn(y[j]);
    }
  }
};

}  // namespace

// dtype: 0 = bf16 x and out, 1 = fp32. w is (K, N) column-major; bias may
// be null. xq (M, K) int8 and sx (M,) fp32 are scratch; any M, N >= 1.
// Returns 0, a cudaError_t, -2 (dtype), -3 (shape: K % 16) or -4 (a tensor
// map refused).
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

// x (M, K) int8 row-major, w (K, N) int8 column-major -> out (M, N) bf16;
// any M, N >= 1. Returns 0, a cudaError_t, -3 (shape: K % 16) or -4 (a
// tensor map refused).
extern "C" int int8_gemm_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                              void* stream) {
  const Int32ToBf16Out epi{static_cast<__nv_bfloat16*>(out), N};
  return int8h::launch_gemm_sm90_by_shape(static_cast<const int8_t*>(x), K,
                                          static_cast<const int8_t*>(w), K, N, M, N, K, epi,
                                          static_cast<cudaStream_t>(stream));
}
