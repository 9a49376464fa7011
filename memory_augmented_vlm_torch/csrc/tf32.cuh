// 3xTF32 on mma.sync, shared by the fp32 flash kernels (flash_fwd.cu's
// forward, flash_train.cu's backward): the hi/lo split of an fp32 operand,
// the m16n8k8 TF32 product, the three products of one fp32 product, and the
// host-side TMA map of a bshd fp32 tensor read in padded boxes.
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8)
// a0 (row g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8,
// k t + 4); B (8 x 8) b0 (k t, column g), b1 (k t + 4, column g); C (16 x 8)
// c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8).
//
// The tensor core adds each product into its accumulator with truncation,
// an ulp of the accumulator each time, so the kernels start every product
// step in a fresh fragment and add it to their running sums in fp32.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace mavlm {
namespace tf32 {

// x = hi + lo: hi the TF32 nearest x (ties away from zero, as
// cvt.rna.tf32.f32: half a TF32 step added to the bits, the 13 low bits
// cleared), lo the rest, exact in fp32, which the tensor core reads as
// TF32 by dropping its 13 low bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8, fp32) += a (16 x 8) b (8 x 8), TF32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a split as (ah, al), b's fragment (b0, b1) split
// here: the two small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

// A 4-d map {D, S, H, B} of a bshd fp32 tensor (strides in elements:
// batch, sequence, head), read in boxes of `rows` rows by `cols` columns,
// unswizzled; columns past D read as zeros.
inline bool make_map_f32(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                         const long long* st, int rows, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 4, (cuuint64_t)st[2] * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace tf32
}  // namespace mavlm
