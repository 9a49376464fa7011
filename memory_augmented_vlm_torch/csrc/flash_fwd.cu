// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py::pallas_flash_attention and
// computes the same function:
//   - q is scaled by scale*log2(e) and rounded to the input dtype before QK^T;
//   - scores, the running max m, the running sum l and the accumulator are
//     fp32, and the online softmax is base 2 (exp2);
//   - keys >= kv_valid_len[b] are masked, and with `causal` keys above the
//     diagonal too; a row that sees no valid key (valid length 0) is zero;
//   - P is rounded to the input dtype before PV, as the TPU kernel does;
//   - the output has the input dtype. Layout is bshd, read through strides.
//
// What bounds it on the H100: at the three call sites of the bf16 video path
// (tower D=72 S=729, memory D=112 q=1568 kv<=15680, LM prefill D=64 S~9.5k
// causal) attention is compute-bound: every K/V tile is reused by a 64-row Q
// tile, so the score and PV products dominate and device memory does not.
// The design runs both products on the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate) with the scores kept in registers: the
// (Sq, Skv) score matrix never reaches device memory, which is what the
// plain version pays for. One block per (q tile, head, batch); a loop inside
// the block over K/V tiles takes the place of the TPU's sequential grid axis
// and ends at min(valid length, causal bound), so skipped tiles cost nothing.
// K/V tiles are staged through shared memory with no copy/compute overlap
// yet (cp.async/TMA pipelining and wgmma are later work).
//
// fp32 inputs take a second, SIMT kernel (one warp per query row, lanes over
// keys). It serves fp32 parity runs only; the bf16 path is the main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using mavlm::lds32;
using mavlm::pack_bf16x2;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* valid_len;  // (B,) int32, on the device
  int Sq, Skv, kv_groups, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // softmax scale * log2(e)
};

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const FlashParams p) {
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
  const int hk = h / p.kv_groups;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // keys this block needs: the valid prefix, cut at the causal bound
  int kv_end = min(p.valid_len[b], p.Skv);
  if (p.causal) kv_end = min(kv_end, q0 + kBM);

  // Stage q * scale * log2(e), rounded to bf16; zero rows past Sq and the
  // depth padding past D.
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Sq && c < D) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * p.q_ss + c);
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

  // A fragments of this warp's 16 query rows, held for the whole loop
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

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + g;  // the thread's rows: row0, row0 + 8

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // the previous tile (or the Q stage) is consumed
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kraw = make_uint4(0, 0, 0, 0);
      uint4 vraw = make_uint4(0, 0, 0, 0);
      const bool in = n0 + r < kv_end && c < D;
      if (in) {
        kraw = *reinterpret_cast<const uint4*>(k + (long long)(n0 + r) * p.k_ss + c);
        vraw = *reinterpret_cast<const uint4*>(v + (long long)(n0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * KSTR + c) = kraw;
      if (c < D) {
        const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vraw);
#pragma unroll
        for (int j = 0; j < 8; ++j) sVt[(c + j) * VSTR + r] = vx[j];
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, in the C fragment layout
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* ks = sK + (nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mavlm::mma_bf16_16816(s[nt], qf[kc], lds32(ks + kc * 16), lds32(ks + kc * 16 + 8));
      }
    }

    // mask: keys past the valid prefix, and above the diagonal when causal
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + ((e >> 1) << 3);
        const bool ok = col < kv_end && (!p.causal || col <= row);
        if (!ok) s[nt][e] = -INFINITY;
      }
    }

    // online base-2 softmax; the four threads of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[r] - base);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - base);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - base);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // acc += P V, with P (rounded to bf16) taken straight from the score
    // registers as the A operand
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

  // normalise and store; a row with l == 0 saw no valid key and stays zero
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 0.f : 1.f / l;
    const int row = row0 + 8 * r;
    if (row < p.Sq) {
      __nv_bfloat16* orow = o + (long long)row * p.o_ss;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernel (parity runs)
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = 8;   // warps per block, one query row each
constexpr int kBNF32 = 32;    // keys per tile, one per lane

template <int D>
__global__ void __launch_bounds__(32 * kRowsF32)
flash_fwd_f32_kernel(const FlashParams p) {
  constexpr int NI = (D + 31) / 32;  // output dims per lane
  __shared__ float sK[kBNF32][D + 1];
  __shared__ float sV[kBNF32][D];
  __shared__ float sQ[kRowsF32][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRowsF32;
  const int row = q0 + warp;
  const int hk = h / p.kv_groups;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  int kv_end = min(p.valid_len[b], p.Skv);
  if (p.causal) kv_end = min(kv_end, q0 + kRowsF32);

  for (int d = lane; d < D; d += 32) {
    sQ[warp][d] = row < p.Sq ? q[(long long)row * p.q_ss + d] * p.scale_log2 : 0.f;
  }

  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kBNF32) {
    __syncthreads();
    for (int i = tid; i < kBNF32 * D; i += 32 * kRowsF32) {
      const int r = i / D, d = i % D;
      const bool in = n0 + r < kv_end;
      sK[r][d] = in ? k[(long long)(n0 + r) * p.k_ss + d] : 0.f;
      sV[r][d] = in ? v[(long long)(n0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    const int col = n0 + lane;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(sQ[warp][d], sK[lane][d], s);
    const bool ok = col < kv_end && (!p.causal || col <= row);
    if (!ok) s = -INFINITY;

    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(m_run, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - base);
    const float pr = exp2f(s - base);
    float sum = pr;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBNF32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, sV[j][d], acc[i]);
      }
    }
  }

  if (row < p.Sq) {
    const float inv = l_run == 0.f ? 0.f : 1.f / l_run;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[(long long)row * p.o_ss + d] = acc[i] * inv;
    }
  }
}

template <template <int> class Launch>
int dispatch_head_dim(int head_dim, const FlashParams& p, dim3 grid,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 64: Launch<64>::run(p, grid, stream); break;
    case 72: Launch<72>::run(p, grid, stream); break;
    case 112: Launch<112>::run(p, grid, stream); break;
    case 128: Launch<128>::run(p, grid, stream); break;
    default: return -1;
  }
  return 0;
}

template <int D>
struct LaunchBf16 {
  static void run(const FlashParams& p, dim3 grid, cudaStream_t stream) {
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  }
};

template <int D>
struct LaunchF32 {
  static void run(const FlashParams& p, dim3 grid, cudaStream_t stream) {
    flash_fwd_f32_kernel<D><<<grid, 32 * kRowsF32, 0, stream>>>(p);
  }
};

}  // namespace

// dtype: 0 = bf16, 1 = fp32. Returns 0, a cudaError_t from the launch, or
// -1 for a head dim / -2 for a dtype the library was not built for.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, void* o, const void* valid_len, int B,
                         int Sq, int Skv, int H, int kv_groups, int causal,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale_log2, void* stream) {
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.valid_len = static_cast<const int*>(valid_len);
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_groups = kv_groups;
  p.causal = causal;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    dim3 grid((Sq + kBM - 1) / kBM, H, B);
    rc = dispatch_head_dim<LaunchBf16>(head_dim, p, grid, s);
  } else if (dtype == 1) {
    dim3 grid((Sq + kRowsF32 - 1) / kRowsF32, H, B);
    rc = dispatch_head_dim<LaunchF32>(head_dim, p, grid, s);
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The message of a code returned by any launch function of the library.
extern "C" const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported head dim";
  if (code == -2) return "unsupported dtype";
  if (code == -3) return "unsupported shape";
  if (code == -4) return "TMA tensor map refused (alignment or strides)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
