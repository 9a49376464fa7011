// The int8 building blocks of the fused int8 kernels: per-row quantization
// passes (plain, or after a LayerNorm or an RMSNorm), the requantization of
// an fp32 intermediate, and an int8 x int8 -> int32 mma.sync GEMM whose
// epilogue is a functor. The quant passes and quant_code serve every int8
// kernel of the port (qkv_int8.cu, mlp_int8.cu, swiglu_int8.cu,
// int8_matmul.cu, flash_merge.cu, flash_merge_int8.cu, attn_block.cu); the
// mma.sync GEMM only int8_matmul.cu's int8_gemm_bf16 (the int8 ceiling
// micro-benchmark). Every other int8 product runs on the Hopper core of
// int8_gemm_sm90.cuh.
//
// Rounding follows the JAX kernels: LayerNorm in fp32 with a two-pass
// biased variance, s = max(|row|, 1e-12) / 127, q = clip(rint(x * (1/s)),
// -127, 127) (rint rounds half to even, as jnp.round does). Products that
// JAX evaluates left to right, such as acc * sx * s + b, are written with
// __fmul_rn / __fadd_rn so that nvcc does not contract them into an FMA
// and round them differently from the plain PyTorch versions.
//
// GEMM: C(M, N) = A(M, K) B(K, N), A row-major and B stored as N rows of K
// (the column-major (K, N) kernel layout of ops/quant.py), both K-contiguous
// so every mma fragment register is one 32-bit shared-memory load. Block
// tile 128 x 128, 8 warps of 64 x 32, K in 64-byte steps through a
// three-stage cp.async ring; ragged M, N and K edges are zero-filled on
// load (K a multiple of 16, so a 16-byte chunk is all in or all out) and
// masked in the epilogue.

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

// ---------------------------------------------------------------------------
// GEMM
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int WM = 64, WN = 32, STAGES = 3;
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = 32 * (BM / WM) * WARPS_N;  // 256
constexpr int MI = WM / 16, NI = WN / 8;            // m16 and n8 tiles per warp
constexpr int SROW = BK + 16;                       // bytes; the skew keeps fragment loads conflict-free
constexpr int STAGE_BYTES = (BM + BN) * SROW;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

// Epi: float operator()(int row, int col, int acc0, int acc1) const
// handles columns col and col + 1 of one row (col is even) and returns what
// the row-max reduction takes (when Epi::kRowMax, it then receives
// row_max(row, m)).
template <class Epi>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ A, long long lda, const int8_t* __restrict__ B,
            long long ldb, int M, int N, int K, const Epi epi) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int nk = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int kc) {
    uint8_t* sA = smem + stage * STAGE_BYTES;
    uint8_t* sB = sA + BM * SROW;
    const int k0 = kc * BK;
#pragma unroll
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sA + r * SROW + c, ok ? A + (m0 + r) * lda + k0 + c : A, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int n = n0 + r;
      const bool ok = n < N && k0 + c < K;
      const int8_t* src = B + n * ldb + k0 + c;
      cp_async16(sB + r * SROW + c, ok ? src : B, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();  // chunk kc has landed
    __syncthreads();              // ... for every thread, and chunk kc-1 is consumed
    const int next = kc + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();
    const uint8_t* sA = smem + (kc % STAGES) * STAGE_BYTES;
    const uint8_t* sB = sA + BM * SROW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint8_t* pa = sA + (wm0 + mi * 16 + g) * SROW + kk + 4 * t;
        a[mi][0] = lds32(pa);
        a[mi][1] = lds32(pa + 8 * SROW);
        a[mi][2] = lds32(pa + 16);
        a[mi][3] = lds32(pa + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint8_t* pb = sB + (wn0 + ni * 8 + g) * SROW + kk + 4 * t;
        b[ni][0] = lds32(pb);
        b[ni][1] = lds32(pb + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + wm0 + mi * 16 + g + 8 * hf;
      float rmax = 0.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn0 + ni * 8 + 2 * t;
        if (row < M && col < N) {
          rmax = fmaxf(rmax, epi(row, col, acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]));
        }
      }
      if constexpr (Epi::kRowMax) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (t == 0 && row < M) epi.row_max(row, rmax);
      }
    }
  }
}

// B is stored as N rows of K, ldb bytes apart. Requires K % 16 == 0 and N
// even (callers check); returns 0 or -3.
template <class Epi>
int launch_gemm(const int8_t* A, long long lda, const int8_t* B, long long ldb, int M, int N,
                int K, const Epi& epi, cudaStream_t stream) {
  if (K % 16 || N % 2 || lda % 16 || ldb % 16) return -3;
  const int mt = (M + BM - 1) / BM;
  if (mt > 65535) return -3;
  auto* kern = gemm_kernel<Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  dim3 grid((N + BN - 1) / BN, mt);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(A, lda, B, ldb, M, N, K, epi);
  return 0;
}

}  // namespace int8k
