// The second pass of the dK/dV backward, shared by bf16 (flash_bwd_sm90.cu)
// and fp32 (flash_train.cu): dK and dV (B, Skv, Hkv, D) from the dK/dV
// kernels' per-query-head fp32 partials (B, H, Skv, D), each group's G heads
// summed in head order in fp32 and stored once as Out (bf16 or fp32). No
// atomics: two runs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace mavlm {

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
}

template <typename Out>
__global__ void dkv_group_sum_kernel(const float* dk_part, const float* dv_part, Out* dk, Out* dv,
                                     int B, int Hkv, int G, int Skv, int D, long long o_sb,
                                     long long o_ss, long long o_sh) {
  const int d4s = D / 4;
  const long long n = (long long)B * Hkv * Skv * d4s;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d4 = i % d4s;
    long long rest = i / d4s;
    const int key = rest % Skv;
    rest /= Skv;
    const int hk = rest % Hkv, b = rest / Hkv;
    const long long head = (long long)Skv * D;
    const long long src = (((long long)b * Hkv + hk) * G * Skv + key) * D + 4 * d4;
    float4 a = *reinterpret_cast<const float4*>(dk_part + src);
    float4 c = *reinterpret_cast<const float4*>(dv_part + src);
    for (int gi = 1; gi < G; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(dk_part + src + gi * head);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + src + gi * head);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    const long long dst = b * o_sb + key * o_ss + hk * o_sh + 4 * d4;
    store4(dk + dst, a);
    store4(dv + dst, c);
  }
}

// The launch error of the kernel before it, else the group sum's launch
// (a grid-stride loop over float4s: at most 16 blocks of 256 threads for
// each of the card's 132 SMs); dkv_strides are dk's (batch, sequence, head).
template <typename Out>
inline int launch_group_sum(const void* dk_part, const void* dv_part, void* dk, void* dv, int B,
                            int Hkv, int G, int Skv, int D, const long long* dkv_strides,
                            cudaStream_t stream) {
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n = (long long)B * Hkv * Skv * (D / 4);
  const int threads = 256;
  const int blocks = static_cast<int>(n / threads + 1 < 132 * 16 ? n / threads + 1 : 132 * 16);
  dkv_group_sum_kernel<Out><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<Out*>(dk), static_cast<Out*>(dv), B, Hkv, G, Skv, D, dkv_strides[0],
      dkv_strides[1], dkv_strides[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mavlm
