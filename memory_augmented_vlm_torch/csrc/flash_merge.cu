// One-shot attention with a merged-head store for Hopper (sm_90a), bound to
// Python with ctypes: alone (flash_merge) and with the int8 out-projection
// and the residual behind it (flash_merge_oproj).
//
// flash_merge replaces the TPU kernel `_flash_merge_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py:330
// flash_attention_merge_heads (its non-int8_scores mode) and computes the
// same function, per (batch, head):
//   - q * scale * log2(e) rounded to bf16 before QK^T;
//   - fp32 scores, keys at or past kv_valid_len[b] set to the finite
//     MASK_VALUE = -0.7 * FLT_MAX;
//   - m = the row max over ALL keys, p = exp2(s - m), l = sum(p) in fp32;
//   - P rounded to bf16 for PV, out = o * (1/l), bf16;
//   - stored merged, out[b, s, h*D + d], the layout the out-projection reads.
// A batch with valid length 0 masks every key with the same finite value,
// so each of its rows is the mean of V over all S keys, as on the TPU.
//
// flash_merge_oproj replaces `_flash_merge_oproj_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py:441
// flash_attention_out_proj_int8: the attention above into a bf16 merged row
// a, then
//   hidden + (acc(quant(a), Wo) * sx * so + bo)
// with the row scale sx over the whole NH*D-wide bf16 row (x * (1/s), floor
// 1e-12), the bias and the residual added in fp32, cast once to hidden's
// dtype.
//
// What bounds it on the H100: at the tower's shape (B 64, 16 heads, S 729,
// D 72) attention is 156.7 GFLOP of bf16 work against ~0.2 GB of q/k/v/out,
// so the tensor cores bound it (0.158 ms at 989 TFLOP/s); the out-projection
// adds 123.8 GOP of int8 work (0.063 ms at 1,979 TOP/s). As the port runs
// it (below), the out-projection's stages move ~0.54 GB (the bf16 scratch
// written and read, 2 x 107 MB; its codes, 2 x 54 MB; hidden read and out
// written, 2 x 107 MB), 0.16 ms at 3.35 TB/s: bytes, not operations, bound
// that part.
//
// Design: the two-sweep kernel of two_sweep.cuh (the row max first, so that
// P rounds against the final max as on the TPU; TMA into an mbarrier ring,
// wgmma for both products), with this function's policy, MergePolicy: q
// scaled and rounded to bf16, base 2, a multiply by 1/l and a merged bf16
// store.
//
// The out-projection cannot start before all 16 heads of a query row are
// done (its row scale is the max over the merged row), and the TPU kernel's
// block holds every head of its rows in VMEM. Here heads are spread over
// blocks, so flash_merge_oproj is three stages on one stream: the attention
// kernel above into a bf16 scratch (the TPU kernel's a_scr, 107 MB at 64
// frames, written and read once), the row quant of int8_gemm.cuh, and the
// int8 GEMM on the Hopper core of int8_gemm_sm90.cuh (TMA into an mbarrier
// ring, s8 wgmma from shared memory) with the rescale + bias + residual
// epilogue (int8h::RowScaleOut: the fp32 operations of the plain version in
// its order). Its tiles are 128 x 128, two blocks an SM
// (launch_gemm_sm90_by_shape's pick for a product 1152 deep: one block's
// epilogue beside the other's products; 1152 columns are also 4.5 tiles
// 256 wide; PERF.md §6).

#include <math.h>

#include "int8_gemm_sm90.cuh"
#include "mma.cuh"
#include "two_sweep.cuh"

namespace {

constexpr float kMaskValue = -2.381976426469702e38f;  // -0.7 * FLT_MAX

// The merge-heads softmax for two_sweep.cuh: q * scale * log2(e) rounded to
// bf16, base 2, out = o * (1/l) in bf16, merged heads.
struct MergePolicy {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // (B, S, NH * D)
  const int* valid_len;    // (B,)
  int NH, S;
  float scale_log2;

  static constexpr float kMask = kMaskValue;
  __device__ int valid(int b) const { return valid_len[b]; }
  __device__ float q_in(float x) const { return x * scale_log2; }
  __device__ float logit(float qk) const { return qk; }
  __device__ float prob(float s, float m) const { return exp2f(s - m); }

  template <int D>
  __device__ void store(int b, int h, int row, int t, const float (&acc)[D / 8][4], int r,
                        float l) const {
    const float inv = 1.f / l;  // l >= 1: the max key contributes p = 1
    if (row >= S) return;
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * S + row) * (NH * D) + h * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          mavlm::pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
};

// Returns 0, a cudaError_t, -4 (a tensor map refused) or -1 for a head dim
// the library was not built for.
int launch_merge(int head_dim, const void* q, const void* k, const void* v, void* o,
                 const void* valid_len, int B, int NH, int S, float scale_log2,
                 cudaStream_t st) {
  MergePolicy p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.valid_len = static_cast<const int*>(valid_len);
  p.NH = NH;
  p.S = S;
  p.scale_log2 = scale_log2;
  switch (head_dim) {
    case 64: return mavlm::two_sweep::launch<64>(p, B, st);
    case 72: return mavlm::two_sweep::launch<72>(p, B, st);
    case 128: return mavlm::two_sweep::launch<128>(p, B, st);
    default: return -1;
  }
}

template <typename T>
int out_proj(const void* attn, const void* hidden, const int8_t* wo, const float* so,
             const float* bo, void* out, int8_t* xq, float* sx, int M, int H,
             cudaStream_t st) {
  int8k::launch_rowquant<__nv_bfloat16, false>(attn, nullptr, xq, sx, M, H, 0.f, st);
  const int8h::RowScaleOut<T> epi{sx, so, bo, static_cast<const T*>(hidden),
                                  static_cast<T*>(out), H};
  return int8h::launch_gemm_sm90_by_shape(xq, H, wo, H, H, M, H, H, epi, st);
}

}  // namespace

// q, k, v (B, NH, S, D) bf16 contiguous -> o (B, S, NH*D) bf16. Returns 0,
// a cudaError_t or -1 for a head dim the library was not built for.
extern "C" int flash_merge(int head_dim, const void* q, const void* k, const void* v, void* o,
                           const void* valid_len, int B, int NH, int S, float scale_log2,
                           void* stream) {
  const int rc = launch_merge(head_dim, q, k, v, o, valid_len, B, NH, S, scale_log2,
                              static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// flash_merge, then hidden + out_proj(attn): q, k, v as above; hidden and
// out (B, S, NH*D) in `dtype` (0 = bf16, 1 = fp32); wo (NH*D, NH*D) int8
// column-major with so, bo (NH*D,) fp32. attn (B, S, NH*D) bf16, xq (B*S,
// NH*D) int8 and sx (B*S,) fp32 are scratch. Returns 0, a cudaError_t, -1
// (head dim), -2 (dtype), -3 (shape) or -4 (a tensor map refused).
extern "C" int flash_merge_oproj(int head_dim, const void* q, const void* k, const void* v,
                                 const void* valid_len, int dtype, const void* hidden,
                                 const void* wo, const void* so, const void* bo, void* out,
                                 void* attn, void* xq, void* sx, int B, int NH, int S,
                                 float scale_log2, void* stream) {
  const long long m = static_cast<long long>(B) * S;
  const int H = NH * head_dim;
  if (m > 0x7fffffff || H % 16) return -3;
  if (dtype != 0 && dtype != 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_merge(head_dim, q, k, v, attn, valid_len, B, NH, S, scale_log2, st);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  auto* proj = dtype == 0 ? &out_proj<__nv_bfloat16> : &out_proj<float>;
  rc = proj(attn, hidden, static_cast<const int8_t*>(wo), static_cast<const float*>(so),
            static_cast<const float*>(bo), out, static_cast<int8_t*>(xq),
            static_cast<float*>(sx), static_cast<int>(m), H, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
