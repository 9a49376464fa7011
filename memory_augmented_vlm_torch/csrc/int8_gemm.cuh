// The int8 building blocks of the fused int8 kernels: per-row quantization
// passes (plain, or after a LayerNorm or an RMSNorm) and the requantization
// of an fp32 intermediate. They and quant_code serve every int8 kernel of
// the port (qkv_int8.cu, mlp_int8.cu, swiglu_int8.cu, int8_matmul.cu,
// flash_merge.cu, flash_merge_int8.cu, attn_block.cu); every int8 product
// runs on the Hopper GEMM core of int8_gemm_sm90.cuh.
//
// Rounding follows the JAX kernels: LayerNorm in fp32 with a two-pass
// biased variance, s = max(|row|, 1e-12) / 127, q = clip(rint(x * (1/s)),
// -127, 127) (rint rounds half to even, as jnp.round does). Products that
// JAX evaluates left to right, such as acc * sx * s + b, are written with
// __fmul_rn / __fadd_rn so that nvcc does not contract them into an FMA
// and round them differently from the plain PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace int8k {

using namespace mavlm;

constexpr float kQuantFloor = 1e-12f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int8_t quant_code(float x, float inv_scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(x, inv_scale)), -127.f), 127.f));
}

// ---------------------------------------------------------------------------
// LayerNorm + per-row int8 quant: one warp per row, the row's fp32 LN
// output held in shared memory between its passes. zero_rows, when given,
// gets 0 at each row (the row max a later GEMM folds with atomicMax).
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
ln_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int M, int K, float eps,
                   float* __restrict__ zero_rows) {
  extern __shared__ float ybuf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  float* y = ybuf + warp * K;
  const T* xr = x + static_cast<long long>(row) * K;
  float sum = 0.f;
  for (int i = lane; i < K; i += 32) {
    const float v = to_float(xr[i]);
    y[i] = v;
    sum += v;
  }
  const float mu = warp_sum(sum) / K;
  float sq = 0.f;
  for (int i = lane; i < K; i += 32) {
    const float d = __fsub_rn(y[i], mu);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float r = rsqrtf(warp_sum(sq) / K + eps);
  float amax = 0.f;
  for (int i = lane; i < K; i += 32) {
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y[i], mu), r), w[i]), b[i]);
    y[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  const float s = fmaxf(warp_max(amax), kQuantFloor) / 127.f;
  const float inv = 1.f / s;
  int8_t* qr = xq + static_cast<long long>(row) * K;
  for (int i = lane; i < K; i += 32) qr[i] = quant_code(y[i], inv);
  if (lane == 0) {
    sx[row] = s;
    if (zero_rows != nullptr) zero_rows[row] = 0.f;
  }
}

template <typename T>
int launch_ln_rowquant(const void* x, const float* w, const float* b, int8_t* xq,
                       float* sx, int M, int K, float eps, cudaStream_t stream,
                       float* zero_rows = nullptr) {
  const size_t smem = sizeof(float) * kRowWarps * K;
  if (smem > 227 * 1024) return -3;
  auto* kern = ln_rowquant_kernel<T>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kern<<<(M + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, smem, stream>>>(
      static_cast<const T*>(x), w, b, xq, sx, M, K, eps, zero_rows);
  return 0;
}

// ---------------------------------------------------------------------------
// Per-row int8 quant of x itself, or (kRms) of its RMSNorm
// x * rsqrt(mean(x^2) + eps) * w: one warp per row. Nothing is staged: each
// pass re-reads the row (from L1/L2) and recomputes the value it quantizes.
// zero_rows: as ln_rowquant_kernel's.
// ---------------------------------------------------------------------------

template <typename T, bool kRms>
__global__ void __launch_bounds__(32 * kRowWarps)
rowquant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K, float eps,
                float* __restrict__ zero_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= M) return;
  const T* xr = x + static_cast<long long>(row) * K;
  float r = 1.f;
  if constexpr (kRms) {
    float sq = 0.f;
    for (int i = lane; i < K; i += 32) {
      const float v = to_float(xr[i]);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
    r = rsqrtf(warp_sum(sq) / K + eps);
  }
  auto value = [&](int i) {
    const float v = to_float(xr[i]);
    if constexpr (kRms) {
      return __fmul_rn(__fmul_rn(v, r), w[i]);
    } else {
      return v;
    }
  };
  float amax = 0.f;
  for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(value(i)));
  const float s = fmaxf(warp_max(amax), kQuantFloor) / 127.f;
  const float inv = 1.f / s;
  int8_t* qr = xq + static_cast<long long>(row) * K;
  for (int i = lane; i < K; i += 32) qr[i] = quant_code(value(i), inv);
  if (lane == 0) {
    sx[row] = s;
    if (zero_rows != nullptr) zero_rows[row] = 0.f;
  }
}

template <typename T, bool kRms>
void launch_rowquant(const void* x, const float* w, int8_t* xq, float* sx, int M, int K,
                     float eps, cudaStream_t stream, float* zero_rows = nullptr) {
  rowquant_kernel<T, kRms><<<(M + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, stream>>>(
      static_cast<const T*>(x), w, xq, sx, M, K, eps, zero_rows);
}

// h (M, I) fp32 -> codes with s = max(row max, 1e-12) / 127; one warp per
// row, four values per lane step (I % 4 == 0). A template so that every
// source that includes this header may hold it.
template <int kWarpsPerBlock>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
requant_kernel(const float* __restrict__ h, const float* __restrict__ hmax,
               int8_t* __restrict__ hq, float* __restrict__ sh, int M, int I) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
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

inline void launch_requant(const float* h, const float* hmax, int8_t* hq, float* sh, int M,
                           int I, cudaStream_t stream) {
  requant_kernel<kRowWarps><<<(M + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, stream>>>(
      h, hmax, hq, sh, M, I);
}

}  // namespace int8k
