// Fused LayerNorm + row quant + int8 q/k/v projections for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel `_qkv_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_qkv_int8.py:85 fused_qkv_int8 and
// computes the same function: per row, fp32 LayerNorm -> per-row int8 quant
// (x * (1/s), floor 1e-12) -> three int8 products with Wq, Wk, Wv ->
// acc * sx * s + b in fp32 -> bf16, stored head-major (B, NH, S, HD). S is
// not padded.
//
// What bounds it on the H100: at the tower's shape (46656 rows x 1152 ->
// 3 x 1152) the three products are 371.5 GOP of int8 work against ~110 MB
// of activations in and ~320 MB of bf16 out, so the tensor cores bound it
// (0.188 ms at 1,979 TOP/s), not memory.
//
// Design: two launches. (1) one warp per row computes the LayerNorm and the
// row's int8 codes and scale into a (M, H) int8 scratch (1 byte per element,
// read back by the GEMM from L2); (2) the int8 tensor-core GEMM of
// int8_gemm.cuh with blockIdx.z picking Wq, Wk or Wv, whose epilogue
// rescales, adds the bias, rounds to bf16 and scatters each column pair to
// (b, head, s, d). The TPU kernel keeps the LN output in VMEM instead; here
// the int8 round trip costs ~0.1 GB of traffic and keeps the GEMM a plain
// tiled product. The head split is index arithmetic in the epilogue, so
// head dims that are not tile multiples (72) need no padding.

#include "int8_gemm.cuh"

namespace {

using namespace int8k;

struct QkvEpi {
  static constexpr bool kRowMax = false;
  const float* sx;
  const float* scale[3];
  const float* bias[3];
  __nv_bfloat16* out[3];
  int S, NH, HD;

  __device__ __forceinline__ float operator()(int z, int row, int col, int a0, int a1) const {
    const float x = sx[row];
    const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a0), x), scale[z][col]),
                               bias[z][col]);
    const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a1), x), scale[z][col + 1]),
                               bias[z][col + 1]);
    const int b = row / S, s = row - b * S;
    const int head = col / HD, d = col - head * HD;  // HD is even: col, col+1 share a head
    const long long off = ((static_cast<long long>(b) * NH + head) * S + s) * HD + d;
    *reinterpret_cast<uint32_t*>(out[z] + off) = pack_bf16x2(y0, y1);
    return 0.f;
  }
  __device__ void row_max(int, float) const {}
};

}  // namespace

// dtype: 0 = bf16 hidden, 1 = fp32 hidden. xq (B*S, H) int8 and sx (B*S,)
// fp32 are scratch. Returns 0, a cudaError_t, -2 (dtype) or -3 (shape).
extern "C" int qkv_int8(int dtype, const void* hidden, const void* ln_w, const void* ln_b,
                        const void* wq, const void* sq, const void* bq,
                        const void* wk, const void* sk, const void* bk,
                        const void* wv, const void* sv, const void* bv,
                        void* q, void* k, void* v, void* xq, void* sx,
                        int B, int S, int H, int NH, float eps, void* stream) {
  if (NH < 1 || H % NH || (H / NH) % 2 || H % 16) return -3;
  const long long m = static_cast<long long>(B) * S;
  if (m > 0x7fffffff) return -3;
  const int M = static_cast<int>(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xq8 = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  const auto* lw = static_cast<const float*>(ln_w);
  const auto* lb = static_cast<const float*>(ln_b);
  int rc;
  if (dtype == 0) {
    rc = launch_ln_rowquant<__nv_bfloat16>(hidden, lw, lb, xq8, sxf, M, H, eps, st);
  } else if (dtype == 1) {
    rc = launch_ln_rowquant<float>(hidden, lw, lb, xq8, sxf, M, H, eps, st);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  QkvEpi epi;
  epi.sx = sxf;
  const void* scales[3] = {sq, sk, sv};
  const void* biases[3] = {bq, bk, bv};
  void* outs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    epi.scale[i] = static_cast<const float*>(scales[i]);
    epi.bias[i] = static_cast<const float*>(biases[i]);
    epi.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
  }
  epi.S = S;
  epi.NH = NH;
  epi.HD = H / NH;
  BOperands bs;
  bs.ptr[0] = static_cast<const int8_t*>(wq);
  bs.ptr[1] = static_cast<const int8_t*>(wk);
  bs.ptr[2] = static_cast<const int8_t*>(wv);
  bs.ld = H;
  rc = launch_gemm(xq8, H, bs, 3, M, H, H, epi, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
