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
// adds 123.8 GOP of int8 work (0.063 ms at 1,979 TOP/s).
//
// Design: the structure of flash_fwd.cu (one block per 64-row q tile, head
// and batch; 4 warps of 16 rows; bf16 mma.sync with fp32 accumulation; the
// QK^T depth zero-padded from 72 to 80 in shared memory; V transposed into
// shared memory for the PV B operand), but two sweeps over the keys instead
// of an online softmax: the first finds the row max, the second computes p
// against that final max, l and PV. The TPU kernel rounds P to bf16 against
// the final max; an online softmax would round it against running maxima
// and differ. The second QK^T costs a third more tensor-core work. The key
// loop stops at the valid length (masked keys give p = 0) except when it is
// 0, where every one of the S keys takes part.
//
// The out-projection cannot start before all 16 heads of a query row are
// done (its row scale is the max over the merged row), and the TPU kernel's
// block holds every head of its rows in VMEM. Here heads are spread over
// blocks, so flash_merge_oproj is three stages on one stream: the attention
// kernel above into a bf16 scratch (the TPU kernel's a_scr, 107 MB at 64
// frames, written and read once), the row quant of int8_gemm.cuh, and its
// int8 GEMM with the rescale + bias + residual epilogue.

#include <math.h>

#include "int8_gemm.cuh"
#include "mma.cuh"

namespace {

using mavlm::lds32;
using mavlm::pack_bf16x2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per K/V tile
constexpr float kMaskValue = -2.381976426469702e38f;  // -0.7 * FLT_MAX

struct MergeParams {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // (B, S, NH * D)
  const int* valid_len;    // (B,)
  int NH, S;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_merge_kernel(const MergeParams p) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int DK = (D + 15) / 16 * 16;  // QK^T depth, zero-padded to 16
  constexpr int KSTR = DK + 8;            // Q/K tile row stride (bank skew)
  constexpr int VSTR = kBN + 8;           // transposed V tile row stride
  constexpr int NT = kBN / 8;             // 8-key score tiles per warp
  constexpr int DT = D / 8;               // 8-wide output tiles
  constexpr int KC = DK / 16;             // 16-deep steps of QK^T
  constexpr int CH = DK / 8;              // 16-byte chunks per Q/K tile row
  static_assert(kBM == kBN, "the Q tile is staged in the K buffer");

  __shared__ __align__(16) __nv_bfloat16 sK[kBN * KSTR];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * VSTR];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int S = p.S;
  const long long head = (static_cast<long long>(b) * p.NH + h) * S * D;
  const __nv_bfloat16* q = p.q + head;
  const __nv_bfloat16* k = p.k + head;
  const __nv_bfloat16* v = p.v + head;

  const int valid = p.valid_len[b];
  const int kv_end = valid > 0 ? min(valid, S) : S;

  // q * scale * log2(e), rounded to bf16; zero rows past S and depth past D
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (q0 + r < S && c < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + static_cast<long long>(q0 + r) * D + c);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint32_t* out = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[j] = pack_bf16x2(__bfloat162float(x[2 * j]) * p.scale_log2,
                             __bfloat162float(x[2 * j + 1]) * p.scale_log2);
      }
    }
    *reinterpret_cast<uint4*>(sK + r * KSTR + c) = packed;
  }
  __syncthreads();

  uint32_t qf[KC][4];
  {
    const __nv_bfloat16* qs = sK + warp * 16 * KSTR;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qf[kc][0] = lds32(qs + g * KSTR + kc * 16 + 2 * t);
      qf[kc][1] = lds32(qs + (g + 8) * KSTR + kc * 16 + 2 * t);
      qf[kc][2] = lds32(qs + g * KSTR + kc * 16 + 8 + 2 * t);
      qf[kc][3] = lds32(qs + (g + 8) * KSTR + kc * 16 + 8 + 2 * t);
    }
  }

  // Stage keys [n0, n0 + kBN) (and V, transposed, when with_v); rows past
  // kv_end are zero.
  auto load_tile = [&](int n0, bool with_v) {
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = n0 + r < kv_end && c < D;
      uint4 kraw = make_uint4(0, 0, 0, 0);
      if (in) kraw = *reinterpret_cast<const uint4*>(k + static_cast<long long>(n0 + r) * D + c);
      *reinterpret_cast<uint4*>(sK + r * KSTR + c) = kraw;
      if (with_v && c < D) {
        uint4 vraw = make_uint4(0, 0, 0, 0);
        if (in) vraw = *reinterpret_cast<const uint4*>(v + static_cast<long long>(n0 + r) * D + c);
        const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vraw);
#pragma unroll
        for (int j = 0; j < 8; ++j) sVt[(c + j) * VSTR + r] = vx[j];
      }
    }
  };

  // Masked scores of this warp's 16 rows against the staged keys: keys at
  // or past S are not keys (-inf, p = 0); keys at or past valid get the
  // finite MASK_VALUE.
  auto scores = [&](int n0, float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* ks = sK + (nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mavlm::mma_bf16_16816(s[nt], qf[kc], lds32(ks + kc * 16), lds32(ks + kc * 16 + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        if (col >= S) {
          s[nt][e] = -INFINITY;
        } else if (col >= valid) {
          s[nt][e] = kMaskValue;
        }
      }
    }
  };

  // sweep 1: the row max over every key
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // the previous tile (or the Q stage) is consumed
    load_tile(n0, false);
    __syncthreads();
    float s[NT][4];
    scores(n0, s);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      m_row[0] = fmaxf(m_row[0], fmaxf(s[nt][0], s[nt][1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(s[nt][2], s[nt][3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // sweep 2: p against the final max, l and PV
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();
    load_tile(n0, true);
    __syncthreads();
    float s[NT][4];
    scores(n0, s);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_row[e >> 1]);
        l_run[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vs = sVt + (dt * 8 + g) * VSTR + kc * 16 + 2 * t;
        mavlm::mma_bf16_16816(acc[dt], a, lds32(vs), lds32(vs + 8));
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
  const int HD = p.NH * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;  // l >= 1: the max key contributes p = 1
    const int row = row0 + 8 * r;
    if (row < S) {
      __nv_bfloat16* orow = p.o + (static_cast<long long>(b) * S + row) * HD + h * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
void launch(const MergeParams& p, int B, cudaStream_t stream) {
  dim3 grid((p.S + kBM - 1) / kBM, p.NH, B);
  flash_merge_kernel<D><<<grid, kThreads, 0, stream>>>(p);
}

// Returns 0, or -1 for a head dim the library was not built for.
int launch_merge(int head_dim, const void* q, const void* k, const void* v, void* o,
                 const void* valid_len, int B, int NH, int S, float scale_log2,
                 cudaStream_t st) {
  MergeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.valid_len = static_cast<const int*>(valid_len);
  p.NH = NH;
  p.S = S;
  p.scale_log2 = scale_log2;
  switch (head_dim) {
    case 64: launch<64>(p, B, st); break;
    case 72: launch<72>(p, B, st); break;
    case 128: launch<128>(p, B, st); break;
    default: return -1;
  }
  return 0;
}

template <typename T>
int out_proj(const void* attn, const void* hidden, const int8_t* wo, const float* so,
             const float* bo, void* out, int8_t* xq, float* sx, int M, int H,
             cudaStream_t st) {
  int8k::launch_rowquant<__nv_bfloat16, false>(attn, nullptr, xq, sx, M, H, 0.f, st);
  int8k::RowScaleEpi<T> epi{sx, so, bo, static_cast<const T*>(hidden), static_cast<T*>(out), H};
  int8k::BOperands bs{{wo, nullptr, nullptr}, H};
  return int8k::launch_gemm(xq, H, bs, 1, M, H, H, epi, st);
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
// (head dim), -2 (dtype) or -3 (shape).
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
