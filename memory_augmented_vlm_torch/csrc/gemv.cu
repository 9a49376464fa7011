// The decode GEMV for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_gemv_kernel` behind tools_gemv_bench.py:33
// pallas_gemv, the decode GEMV micro-benchmark, and computes the same
// function: y (1, N) = x (1, K) . W (K, N) with x and W read as fp32, fp32
// accumulation and y rounded to bf16. W is (K, N) row-major bf16. Any K and
// N: the TPU version asserts N % block_n == 0, which its own 896-wide
// down-projection breaks.
//
// What bounds it on the H100: bytes. At the tool's 0.5B MLP shapes (896 ->
// 4864 -> 896) W is 8.7 MB per product against 8.7 MFLOP, 0.5 flop per
// byte; 12 layers are 209.2 MB, 62.4 us at 3.35 TB/s, four times the 50 MB
// L2, so a chain of them streams W from device memory.
//
// Design: one product is too little work for a block per column strip
// (896 columns would be 4 blocks), so the grid splits K as well: a block
// takes a strip of 32 * VEC columns (VEC = 8 adjacent bf16 per thread, one
// 16-byte load per row, a warp reading 512 contiguous bytes) and a range of
// rows, its 8 warps taking every 8th row; the warps' sums meet in shared
// memory and the block writes fp32 partial sums (splits, N). A second
// launch adds each column's partials in split order and rounds to bf16:
// deterministic, no atomics. The caller sizes the split for about four
// blocks per SM. Widths that are not a multiple of 8 take VEC = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gemv_partial_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ part, int K, int N, int rows_per_split) {
  __shared__ float red[kWarps][VEC][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = blockIdx.x * 32 * VEC;
  const int col0 = strip + lane * VEC;
  const int k0 = blockIdx.y * rows_per_split;
  const int k1 = min(K, k0 + rows_per_split);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (col0 < N) {  // VEC = 8 only for N % 8 == 0: a vector is all in or all out
#pragma unroll 4
    for (int k = k0 + warp; k < k1; k += kWarps) {
      const float xv = __bfloat162float(x[k]);
      const __nv_bfloat16* row = w + static_cast<long long>(k) * N + col0;
      if constexpr (VEC == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row);
        const __nv_bfloat16* wv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += xv * __bfloat162float(wv[j]);
      } else {
        acc[0] += xv * __bfloat162float(row[0]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * VEC; i += kThreads) {
    const int j = i / 32, l = i % 32;
    const int col = strip + l * VEC + j;
    if (col < N) {
      float s = red[0][j][l];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) s += red[wp][j][l];
      part[static_cast<long long>(blockIdx.y) * N + col] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gemv_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ y, int N,
                   int splits) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= N) return;
  float s = part[col];
  for (int i = 1; i < splits; ++i) s += part[static_cast<long long>(i) * N + col];
  y[col] = __float2bfloat16_rn(s);
}

}  // namespace

// x (K,) bf16, w (K, N) bf16 row-major -> y (N,) bf16; part (splits, N)
// fp32 is scratch, each split covering rows_per_split rows of K. vec is 8
// (N % 8 == 0 and w 16-byte aligned) or 1. Returns 0, a cudaError_t or -3
// (shape).
extern "C" int gemv_bf16(const void* x, const void* w, void* y, void* part, int K, int N,
                         int splits, int rows_per_split, int vec, void* stream) {
  if (K < 1 || N < 1 || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < K || (vec != 8 && vec != 1) ||
      (vec == 8 && N % 8)) {
    return -3;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* pf = static_cast<float*>(part);
  const int cols = 32 * vec;
  const dim3 grid((N + cols - 1) / cols, splits);
  if (vec == 8) {
    gemv_partial_kernel<8><<<grid, kThreads, 0, st>>>(xb, wb, pf, K, N, rows_per_split);
  } else {
    gemv_partial_kernel<1><<<grid, kThreads, 0, st>>>(xb, wb, pf, K, N, rows_per_split);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gemv_reduce_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pf, static_cast<__nv_bfloat16*>(y), N, splits);
  return static_cast<int>(cudaGetLastError());
}
