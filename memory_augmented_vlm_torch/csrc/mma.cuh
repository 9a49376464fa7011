// Tensor-core and copy primitives shared by the port's kernels (sm_90a).
//
// Fragment layouts are those of the PTX ISA for mma.sync with
// groupID g = lane / 4 and thread-in-group t = lane % 4:
//   m16n8k16 bf16: A regs {row g, k 2t..}, {row g+8, k 2t..},
//                  {row g, k 8+2t..}, {row g+8, k 8+2t..};
//                  B regs {k 2t.., col g}, {k 8+2t.., col g};
//   m16n8k32 s8:   A regs {row g, k 4t..4t+3}, {row g+8, k 4t..},
//                  {row g, k 16+4t..}, {row g+8, k 16+4t..};
//                  B regs {k 4t..4t+3, col g}, {k 16+4t.., col g};
//   C/D (both):    {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
// So with both operands stored K-contiguous (A row-major, B as N rows of
// K), every fragment register is one aligned 32-bit shared-memory load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mavlm {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t lds32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col)
__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses L1; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace mavlm
