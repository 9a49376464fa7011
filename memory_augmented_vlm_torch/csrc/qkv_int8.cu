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
// read back by the GEMM from L2); (2) the three products on the Hopper int8
// GEMM core of int8_gemm_sm90.cuh (TMA into an mbarrier ring, s8 wgmma from
// shared memory) as one stacked GEMM: blockIdx.x picks Wq, Wk or Wv, each
// read through its own tensor map (no (3H, H) copy), and the blocks of one
// 128-row tile run together, so the codes are read from device memory once.
// The epilogue rescales, adds the bias, rounds to bf16 and scatters four
// columns at a time to (b, head, s, d): one 8-byte store when the head dim
// is a multiple of 4 (the four columns then lie in one head), else two
// 4-byte pairs, the second possibly in the next head. The TPU kernel keeps
// the LN output in VMEM instead; here the int8 round trip costs ~0.1 GB of
// traffic and keeps the GEMM a plain tiled product. The head split is index
// arithmetic in the epilogue, so head dims that are not tile multiples (72)
// need no padding. Tiles and launches: PERF.md §6.

#include "int8_gemm_sm90.cuh"

namespace {

using namespace int8k;

// 128 x 128 tiles, two blocks an SM: on an H100 80GB HBM3 at 700 W the
// products take 0.59 ms at the tower's shape, against 0.61 as three
// launches, 0.76 at one block an SM and 0.82 in 128 x 256 tiles (1152
// columns are 4.5 of them) (PERF.md §6).
constexpr int kHalves = 1, kBlocksPerSM = 2;

template <class P>
__device__ __forceinline__ P pick(const P (&p)[3], int z) {
  return z == 0 ? p[0] : z == 1 ? p[1] : p[2];
}

// Column c of the stacked product is column c - z H of projection z.
struct QkvOut {
  static constexpr bool kRowMax = false;
  static constexpr bool kPaired = false;
  static constexpr bool kRagged = false;
  const float* sx;
  const float* scale[3];
  const float* bias[3];
  __nv_bfloat16* out[3];
  int H, S, NH, HD;

  __device__ __forceinline__ int which(int c) const { return c >= H ? (c >= 2 * H ? 2 : 1) : 0; }
  __device__ __forceinline__ float row_scale(int row) const { return sx[row]; }
  __device__ __forceinline__ float value(float x, int c, int a) const {
    const int z = which(c), col = c - z * H;
    return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(a), x), pick(scale, z)[col]),
                     pick(bias, z)[col]);
  }
  __device__ void row_max(int, float) const {}
  __device__ __forceinline__ void store4(int row, int c, float4 v) const {
    const int z = which(c), col = c - z * H;
    const int b = row / S, s = row - b * S;
    const int head = col / HD, d = col - head * HD;
    __nv_bfloat16* o = pick(out, z) + ((static_cast<long long>(b) * NH + head) * S + s) * HD + d;
    if (HD % 4 == 0) {  // d % 4 == 0: one aligned 8-byte store in one head
      *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
    } else {  // HD % 4 == 2: columns col + 2, + 3 may open the next head
      *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(v.x, v.y);
      __nv_bfloat16* o2 = d + 2 < HD ? o + 2 : o - d + static_cast<long long>(S) * HD;
      *reinterpret_cast<uint32_t*>(o2) = pack_bf16x2(v.z, v.w);
    }
  }
};

}  // namespace

// dtype: 0 = bf16 hidden, 1 = fp32 hidden. xq (B*S, H) int8 and sx (B*S,)
// fp32 are scratch. Returns 0, a cudaError_t, -2 (dtype), -3 (shape) or -4
// (a tensor map refused).
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
  const void* scales[3] = {sq, sk, sv};
  const void* biases[3] = {bq, bk, bv};
  void* outs[3] = {q, k, v};
  const int8_t* ws[3] = {static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                         static_cast<const int8_t*>(wv)};
  QkvOut epi;
  epi.sx = sxf;
  for (int i = 0; i < 3; ++i) {
    epi.scale[i] = static_cast<const float*>(scales[i]);
    epi.bias[i] = static_cast<const float*>(biases[i]);
    epi.out[i] = static_cast<__nv_bfloat16*>(outs[i]);
  }
  epi.H = H;
  epi.S = S;
  epi.NH = NH;
  epi.HD = H / NH;
  return int8h::launch_gemm_sm90_stacked<kHalves, kBlocksPerSM>(xq8, H, ws, 3, H, H, M, H, H,
                                                                epi, st);
}
