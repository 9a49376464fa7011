// Flash attention for training on Hopper (sm_90a), bound to Python with ctypes:
// the forward that saves the log-sum-exp (bf16 and fp32), and the fp32
// backward kernels. The bf16 backward kernels are in flash_bwd_sm90.cu.
//
// Replaces the TPU kernels of memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:
//   flash_fwd_lse  <- _forward_with_lse (_fwd_lse_kernel)
//   flash_bwd_dq   <- _backward's dq pallas_call (_dq_kernel), fp32
//   flash_bwd_dkv  <- _backward's dk/dv pallas_call (_dkv_kernel), fp32
// and computes their function:
//   - q is scaled by scale*log2(e) and rounded to the input dtype before QK^T;
//     the softmax is base 2 and the saved lse is in log2 units,
//     lse = m + log2(max(l, 1e-30)) (-inf for a row that sees no key);
//   - the forward gives masked scores the finite MASK_VALUE; the backward
//     zeroes p at masked positions (keys >= kv_valid_len[b], and above the
//     diagonal when causal);
//   - p = exp2(s - lse); ds = p * (dp - delta) * scale, in raw-score units,
//     with delta = rowsum(dO * O) computed by the caller;
//   - dQ = ds K, dV = p^T dO, dK = ds^T Q (Q unscaled);
//   - GQA is native: query head h reads K/V head h / kv_groups. dK/dV of a
//     KV head sum over its whole group inside one block, so the result is
//     deterministic (no atomics).
// Layout is bshd for q/k/v/o/dO/dQ/dK/dV (read through strides, the head dim
// contiguous) and (B, H, Sq) fp32 for lse and delta.
//
// What bounds the forward on the H100: at the LM's training shape (S = 9557,
// D = 64, 14 query heads over 2 KV heads, causal) it is compute-bound: every
// K/V tile staged in shared memory is reused by 64 rows, and the (Sq, Skv)
// score matrix never reaches device memory. The bf16 forward runs its
// products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), keeps scores and probabilities in registers, and turns each
// C fragment straight into the A fragment of the next product. One block per
// 64-row tile; a loop inside the block over the key tiles takes the place of
// the TPU's sequential grid axis and is cut at the valid length and the
// causal diagonal. V is staged transposed in shared memory; there is no
// copy/compute overlap yet.
//
// fp32 inputs take SIMT kernels (a warp per query or key row, lanes over
// the other axis). They serve fp32 parity runs only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using mavlm::lds32;
using mavlm::pack_bf16x2;

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // pallas_flash.MASK_VALUE

struct TrainParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dO
  void* out;           // forward: o; backward: dq (dq kernel) or dk (dkv kernel)
  void* out2;          // dkv kernel: dv
  float* lse;          // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  const int* valid_len;
  int H, Sq, Skv, kv_groups, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long d_sb, d_ss, d_sh;  // dO
  long long o_sb, o_ss, o_sh;  // the output tensor(s), bshd
  float scale;       // softmax scale (raw-score units)
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ int kv_limit(const TrainParams& p, int b) {
  return min(p.valid_len[b], p.Skv);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // rows per block (16 per warp) = columns per loop tile
constexpr int kTStr = kTile + 8;    // row stride of a transposed [D][kTile] tile

template <int D>
struct Tiles {
  static_assert(D % 16 == 0, "training kernels take head dims that are multiples of 16");
  static constexpr int STR = D + 8;   // row stride of a row-major [kTile][D] tile
  static constexpr int KC = D / 16;   // 16-deep steps over D
  static constexpr int DT = D / 8;    // 8-wide output tiles over D
  static constexpr int CH = D / 8;    // 16-byte chunks per row
  static constexpr int NT = kTile / 8;
};

// Copy a [kTile][D] tile (rows r0.., masked at r_end) into shared memory,
// row-major and/or transposed; optionally scaled by `mul` and rounded.
template <int D>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src, long long row_stride,
                                           int r0, int r_end, __nv_bfloat16* rowmajor,
                                           __nv_bfloat16* transposed, float mul) {
  using T = Tiles<D>;
  for (int i = threadIdx.x; i < kTile * T::CH; i += kThreads) {
    const int r = i / T::CH, c = (i % T::CH) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < r_end) {
      raw = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
    }
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
    if (rowmajor != nullptr) {
      uint4 packed = raw;
      if (mul != 1.f) {
        uint32_t* o = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = pack_bf16x2(__bfloat162float(x[2 * j]) * mul,
                             __bfloat162float(x[2 * j + 1]) * mul);
        }
      }
      *reinterpret_cast<uint4*>(rowmajor + r * T::STR + c) = packed;
    }
    if (transposed != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) transposed[(c + j) * kTStr + r] = x[j];
    }
  }
}

// A fragments of this warp's 16 rows of a row-major [kTile][D] smem tile.
template <int D>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile, int warp, int g, int t,
                                             uint32_t (*f)[4]) {
  using T = Tiles<D>;
  const __nv_bfloat16* base = tile + warp * 16 * T::STR;
#pragma unroll
  for (int kc = 0; kc < T::KC; ++kc) {
    f[kc][0] = lds32(base + g * T::STR + kc * 16 + 2 * t);
    f[kc][1] = lds32(base + (g + 8) * T::STR + kc * 16 + 2 * t);
    f[kc][2] = lds32(base + g * T::STR + kc * 16 + 8 + 2 * t);
    f[kc][3] = lds32(base + (g + 8) * T::STR + kc * 16 + 8 + 2 * t);
  }
}

// acc[16 x kTile] = A(16 x D, fragments) . B^T where B is a row-major
// [kTile][D] smem tile (B's rows are the output columns).
template <int D>
__device__ __forceinline__ void mma_rows(float (*acc)[4], uint32_t (*a)[4],
                                         const __nv_bfloat16* b, int g, int t) {
  using T = Tiles<D>;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* bs = b + (nt * 8 + g) * T::STR + 2 * t;
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc) {
      mavlm::mma_bf16_16816(acc[nt], a[kc], lds32(bs + kc * 16), lds32(bs + kc * 16 + 8));
    }
  }
}

// acc[16 x D] += X(16 x kTile, C fragments, rounded to bf16) . Y where Y is
// given transposed, a [D][kTile] smem tile.
template <int D>
__device__ __forceinline__ void mma_cols(float (*acc)[4], float (*x)[4],
                                         const __nv_bfloat16* yt, int g, int t) {
  using T = Tiles<D>;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kc][0], x[2 * kc][1]);
    a[1] = pack_bf16x2(x[2 * kc][2], x[2 * kc][3]);
    a[2] = pack_bf16x2(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[3] = pack_bf16x2(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < T::DT; ++dt) {
      const __nv_bfloat16* ys = yt + (dt * 8 + g) * kTStr + kc * 16 + 2 * t;
      mavlm::mma_bf16_16816(acc[dt], a, lds32(ys), lds32(ys + 8));
    }
  }
}

// Store this warp's 16 x D accumulator rows (row0, row0 + 8) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride, int row0,
                                           int rows, float (*acc)[4], float mul0,
                                           float mul1, int t) {
  using T = Tiles<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const float mul = r ? mul1 : mul0;
    __nv_bfloat16* out = dst + (long long)row * row_stride;
#pragma unroll
    for (int dt = 0; dt < T::DT; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_lse_bf16_kernel(const TrainParams p) {
  using T = Tiles<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][STR]
  __nv_bfloat16* sVt = sK + kTile * T::STR;                          // [D][kTStr]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int hk = h / p.kv_groups;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;

  int kv_end = kv_limit(p, b);
  if (p.causal) kv_end = min(kv_end, q0 + kTile);

  stage_tile<D>(q, p.q_ss, q0, p.Sq, sK, nullptr, p.scale_log2);
  __syncthreads();
  uint32_t qf[T::KC][4];
  load_a_frags<D>(sK, warp, g, t, qf);

  float acc[T::DT][4];
#pragma unroll
  for (int dt = 0; dt < T::DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;

  for (int n0 = 0; n0 < kv_end; n0 += kTile) {
    __syncthreads();  // the previous tile (or the Q stage) is consumed
    stage_tile<D>(k, p.k_ss, n0, kv_end, sK, nullptr, 1.f);
    stage_tile<D>(v, p.v_ss, n0, kv_end, nullptr, sVt, 1.f);
    __syncthreads();

    float s[T::NT][4];
    mma_rows<D>(s, qf, sK, g, t);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + ((e >> 1) << 3);
        if (!(col < kv_end && (!p.causal || col <= row))) s[nt][e] = kMaskValue;
      }
    }
    // online base-2 softmax; the four threads of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - m_new);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < T::DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }
    mma_cols<D>(acc, s, sVt, g, t);  // P rounded to bf16, times V
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 1.f : 1.f / l;
    const int row = row0 + 8 * r;
    if (t == 0 && row < p.Sq) {
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m_run[r] + log2f(fmaxf(l, 1e-30f));
    }
  }
  store_rows<D>(o, p.o_ss, row0, p.Sq, acc, inv[0], inv[1], t);
}

// ---------------------------------------------------------------------------
// fp32 SIMT kernels (parity runs)
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = 8;  // warps per block, one row each
constexpr int kColsF32 = 32;  // columns per loop tile, one per lane

template <int D>
__global__ void __launch_bounds__(32 * kRowsF32) fwd_lse_f32_kernel(const TrainParams p) {
  constexpr int NI = D / 32;
  __shared__ float sK[kColsF32][D + 1];
  __shared__ float sV[kColsF32][D];
  __shared__ float sQ[kRowsF32][D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowsF32;
  const int row = q0 + warp, hk = h / p.kv_groups;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
  int kv_end = kv_limit(p, b);
  if (p.causal) kv_end = min(kv_end, q0 + kRowsF32);

  for (int d = lane; d < D; d += 32) {
    sQ[warp][d] = row < p.Sq ? q[(long long)row * p.q_ss + d] * p.scale_log2 : 0.f;
  }
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  for (int n0 = 0; n0 < kv_end; n0 += kColsF32) {
    __syncthreads();
    for (int i = tid; i < kColsF32 * D; i += 32 * kRowsF32) {
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
    if (!(col < kv_end && (!p.causal || col <= row))) s = kMaskValue;
    const float m_new = fmaxf(m_run, mavlm::warp_max(s));
    const float alpha = exp2f(m_run - m_new);
    const float pr = exp2f(s - m_new);
    l_run = l_run * alpha + mavlm::warp_sum(pr);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[i] *= alpha;
    for (int j = 0; j < kColsF32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i] = fmaf(pj, sV[j][lane + 32 * i], acc[i]);
    }
  }
  if (row < p.Sq) {
    const float inv = l_run == 0.f ? 1.f : 1.f / l_run;
#pragma unroll
    for (int i = 0; i < NI; ++i) o[(long long)row * p.o_ss + lane + 32 * i] = acc[i] * inv;
    if (lane == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m_run + log2f(fmaxf(l_run, 1e-30f));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kRowsF32) bwd_dq_f32_kernel(const TrainParams p) {
  constexpr int NI = D / 32;
  __shared__ float sK[kColsF32][D + 1];
  __shared__ float sV[kColsF32][D + 1];
  __shared__ float sQ[kRowsF32][D];
  __shared__ float sDO[kRowsF32][D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowsF32;
  const int row = q0 + warp, hk = h / p.kv_groups;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
  float* dq = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
  int kv_end = kv_limit(p, b);
  if (p.causal) kv_end = min(kv_end, q0 + kRowsF32);

  const bool in_row = row < p.Sq;
  for (int d = lane; d < D; d += 32) {
    sQ[warp][d] = in_row ? q[(long long)row * p.q_ss + d] * p.scale_log2 : 0.f;
    sDO[warp][d] = in_row ? dout[(long long)row * p.d_ss + d] : 0.f;
  }
  const long long idx = ((long long)b * p.H + h) * p.Sq + row;
  const float lse = in_row ? p.lse[idx] : INFINITY;
  const float delta = in_row ? p.delta[idx] : 0.f;
  float acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i] = 0.f;
  for (int n0 = 0; n0 < kv_end; n0 += kColsF32) {
    __syncthreads();
    for (int i = tid; i < kColsF32 * D; i += 32 * kRowsF32) {
      const int r = i / D, d = i % D;
      const bool in = n0 + r < kv_end;
      sK[r][d] = in ? k[(long long)(n0 + r) * p.k_ss + d] : 0.f;
      sV[r][d] = in ? v[(long long)(n0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    const int col = n0 + lane;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(sQ[warp][d], sK[lane][d], s);
      dp = fmaf(sDO[warp][d], sV[lane][d], dp);
    }
    const bool ok = col < kv_end && (!p.causal || col <= row);
    const float pr = ok ? exp2f(s - lse) : 0.f;
    const float ds = pr * (dp - delta) * p.scale;
    for (int j = 0; j < kColsF32; ++j) {
      const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i] = fmaf(dj, sK[j][lane + 32 * i], acc[i]);
    }
  }
  if (in_row) {
#pragma unroll
    for (int i = 0; i < NI; ++i) dq[(long long)row * p.o_ss + lane + 32 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kRowsF32) bwd_dkv_f32_kernel(const TrainParams p) {
  constexpr int NI = D / 32;
  __shared__ float sQ[kColsF32][D + 1];  // raw q
  __shared__ float sDO[kColsF32][D + 1];
  __shared__ float sK[kRowsF32][D];
  __shared__ float sV[kRowsF32][D];
  __shared__ float sLse[kColsF32], sDelta[kColsF32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kRowsF32;
  const int key = k0 + warp;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* dk = static_cast<float*>(p.out) + b * p.o_sb + hk * p.o_sh;
  float* dv = static_cast<float*>(p.out2) + b * p.o_sb + hk * p.o_sh;
  const int kv_end = kv_limit(p, b);

  const bool in_key = key < kv_end;
  for (int d = lane; d < D; d += 32) {
    sK[warp][d] = in_key ? k[(long long)key * p.k_ss + d] : 0.f;
    sV[warp][d] = in_key ? v[(long long)key * p.v_ss + d] : 0.f;
  }
  float dk_acc[NI], dv_acc[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int m_first = p.causal ? (k0 / kColsF32) * kColsF32 : 0;
  if (k0 < kv_end) {
    for (int hq = hk * p.kv_groups; hq < (hk + 1) * p.kv_groups; ++hq) {
      const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hq * p.q_sh;
      const float* dout = static_cast<const float*>(p.dout) + b * p.d_sb + hq * p.d_sh;
      const long long row_base = ((long long)b * p.H + hq) * p.Sq;
      for (int m0 = m_first; m0 < p.Sq; m0 += kColsF32) {
        __syncthreads();
        for (int i = tid; i < kColsF32 * D; i += 32 * kRowsF32) {
          const int r = i / D, d = i % D;
          const bool in = m0 + r < p.Sq;
          sQ[r][d] = in ? q[(long long)(m0 + r) * p.q_ss + d] : 0.f;
          sDO[r][d] = in ? dout[(long long)(m0 + r) * p.d_ss + d] : 0.f;
        }
        if (tid < kColsF32) {
          const bool in = m0 + tid < p.Sq;
          sLse[tid] = in ? p.lse[row_base + m0 + tid] : INFINITY;
          sDelta[tid] = in ? p.delta[row_base + m0 + tid] : 0.f;
        }
        __syncthreads();
        const int qi = m0 + lane;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(sQ[lane][d] * p.scale_log2, sK[warp][d], s);
          dp = fmaf(sV[warp][d], sDO[lane][d], dp);
        }
        const bool ok = in_key && (!p.causal || key <= qi);
        const float pr = ok ? exp2f(s - sLse[lane]) : 0.f;
        const float ds = pr * (dp - sDelta[lane]) * p.scale;
        for (int j = 0; j < kColsF32; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pr, j);
          const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            dv_acc[i] = fmaf(pj, sDO[j][lane + 32 * i], dv_acc[i]);
            dk_acc[i] = fmaf(dj, sQ[j][lane + 32 * i], dk_acc[i]);
          }
        }
      }
    }
  }
  if (key < p.Skv) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      dk[(long long)key * p.o_ss + lane + 32 * i] = dk_acc[i];
      dv[(long long)key * p.o_ss + lane + 32 * i] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
int launch_bf16(const TrainParams& p, int B, cudaStream_t stream) {
  using T = Tiles<D>;
  const size_t smem = (size_t)kTile * T::STR * sizeof(__nv_bfloat16) +
                      (size_t)D * kTStr * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(fwd_lse_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, B);
  fwd_lse_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return 0;
}

template <int D>
int launch_f32(Which which, const TrainParams& p, int B, int Hkv, cudaStream_t stream) {
  const dim3 block(32 * kRowsF32);
  if (which == kFwd) {
    fwd_lse_f32_kernel<D><<<dim3((p.Sq + kRowsF32 - 1) / kRowsF32, p.H, B), block, 0, stream>>>(p);
  } else if (which == kDq) {
    bwd_dq_f32_kernel<D><<<dim3((p.Sq + kRowsF32 - 1) / kRowsF32, p.H, B), block, 0, stream>>>(p);
  } else {
    bwd_dkv_f32_kernel<D><<<dim3((p.Skv + kRowsF32 - 1) / kRowsF32, Hkv, B), block, 0, stream>>>(
        p);
  }
  return 0;
}

int launch(Which which, int dtype, int head_dim, const TrainParams& p, int B, int Hkv,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0 && which == kFwd) {  // bf16 dQ and dK/dV: flash_bwd_sm90.cu
    switch (head_dim) {
      case 64: rc = launch_bf16<64>(p, B, s); break;
      case 128: rc = launch_bf16<128>(p, B, s); break;
      default: return -1;
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 64: rc = launch_f32<64>(which, p, B, Hkv, s); break;
      case 128: rc = launch_f32<128>(which, p, B, Hkv, s); break;
      default: return -1;
    }
  } else {
    return -2;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

TrainParams make_params(const void* q, const void* k, const void* v, const void* valid_len,
                        int H, int Sq, int Skv, int kv_groups, int causal,
                        const long long* qs, const long long* ks, const long long* vs,
                        float scale, float scale_log2) {
  TrainParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid_len = static_cast<const int*>(valid_len);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.kv_groups = kv_groups;
  p.causal = causal;
  p.q_sb = qs[0]; p.q_ss = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.scale = scale;
  p.scale_log2 = scale_log2;
  return p;
}

}  // namespace

// Strides are (batch, sequence, head) in elements; the head dim is
// contiguous. dtype: 0 = bf16, 1 = fp32. Each function returns 0, a
// cudaError_t, or -1 / -2 for a head dim / dtype it was not built for
// (kernel_error_string, in flash_fwd.cu, names the code).

// out (B, Sq, H, D) and lse (B, H, Sq) fp32 are written.
extern "C" int flash_fwd_lse(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, void* out, void* lse, const void* valid_len,
                             int B, int Sq, int Skv, int H, int kv_groups, int causal,
                             const long long* q_strides, const long long* k_strides,
                             const long long* v_strides, const long long* o_strides,
                             float scale, float scale_log2, void* stream) {
  TrainParams p = make_params(q, k, v, valid_len, H, Sq, Skv, kv_groups, causal, q_strides,
                              k_strides, v_strides, scale, scale_log2);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_strides[0]; p.o_ss = o_strides[1]; p.o_sh = o_strides[2];
  return launch(kFwd, dtype, head_dim, p, B, H / kv_groups, stream);
}

// dq (B, Sq, H, D) is written; fp32 only (bf16: flash_bwd_dq_sm90).
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, const void* valid_len, int B, int Sq,
                            int Skv, int H, int kv_groups, int causal,
                            const long long* q_strides, const long long* k_strides,
                            const long long* v_strides, const long long* d_strides,
                            const long long* dq_strides, float scale, float scale_log2,
                            void* stream) {
  TrainParams p = make_params(q, k, v, valid_len, H, Sq, Skv, kv_groups, causal, q_strides,
                              k_strides, v_strides, scale, scale_log2);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.out = dq;
  p.d_sb = d_strides[0]; p.d_ss = d_strides[1]; p.d_sh = d_strides[2];
  p.o_sb = dq_strides[0]; p.o_ss = dq_strides[1]; p.o_sh = dq_strides[2];
  return launch(kDq, dtype, head_dim, p, B, H / kv_groups, stream);
}

// dk and dv (B, Skv, H / kv_groups, D), with the strides of dk, are written;
// fp32 only (bf16: flash_bwd_dkv_sm90).
extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, const void* valid_len,
                             int B, int Sq, int Skv, int H, int kv_groups, int causal,
                             const long long* q_strides, const long long* k_strides,
                             const long long* v_strides, const long long* d_strides,
                             const long long* dkv_strides, float scale, float scale_log2,
                             void* stream) {
  TrainParams p = make_params(q, k, v, valid_len, H, Sq, Skv, kv_groups, causal, q_strides,
                              k_strides, v_strides, scale, scale_log2);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.out = dk;
  p.out2 = dv;
  p.d_sb = d_strides[0]; p.d_ss = d_strides[1]; p.d_sh = d_strides[2];
  p.o_sb = dkv_strides[0]; p.o_ss = dkv_strides[1]; p.o_sh = dkv_strides[2];
  return launch(kDkv, dtype, head_dim, p, B, H / kv_groups, stream);
}
