// The approximate int8_scores mode of the merge-heads attention for Hopper
// (sm_90a), bound to Python with ctypes.
//
// Replaces the int8_scores branch (pallas_flash.py:279-313) of the TPU
// kernel `_flash_merge_kernel` behind
// memory_augmented_vlm_tpu/ops/pallas_flash.py:330
// flash_attention_merge_heads(int8_scores=True), and computes the same
// function, per (batch, head):
//   - qf = q * scale * log2(e) in fp32 (not rounded to bf16), one scale
//     sq = max(|qf|, 1e-12) / 127 per tile of `tile` query rows (the last
//     tile may be ragged);
//   - one scale sk and one sv over ALL S rows of k and v, masked keys
//     included;
//   - codes clip(rint(x * (1/s)), -127, 127), rint rounding half to even;
//   - s = raw * (sq * sk) with raw the int32 product of the codes, the
//     finite MASK_VALUE at or past kv_valid_len[b];
//   - m = the row max, p = exp2(s - m), l = sum(p) in fp32 over the
//     unrounded p, P = rint(p * 127) in int8;
//   - out = (P . vq)(int32) * ((sv / 127) / l), bf16, merged heads
//     (B, S, NH * D).
// A batch with valid length 0 gives every key p = 1: its rows are the mean
// of the dequantised V.
//
// What bounds it on the H100: at the tower's shape (B 64, 16 heads, S 729,
// D 72) the two products are 156.7 GOP of int8 work against ~0.2 GB of
// q/k/v/out, so the tensor cores bound it (0.079 ms at 1,979 TOP/s).
//
// Design: two launches on one stream.
//   1. A reduction writes the scalar scales, one block per q tile, k and v
//      of each (batch, head): the k/v scales span the whole key axis, which
//      no block of stage 2 sees, and a per-block max would be another
//      function.
//   2. The structure of two_sweep.cuh (one block per 64-row q slab, head
//      and batch; 4 warps of 16 rows; two sweeps over the keys, so that P
//      rounds against the final row max as on the TPU) with int8
//      mma.sync m16n8k32 for both products. It is not a policy of that
//      kernel: the operands it stages, their fragments and PV's key order
//      all differ, which leaves only the loop skeleton in common. A block
//      quantizes its q rows
//      (each with its own tile's scale) and each K/V tile as it stages it.
//      QK^T's depth is zero-padded to 32 (72 -> 96); PV's keys come 64 to a
//      tile. PV's A operand is P straight from the score registers: a
//      thread holds keys {2t, 2t+1} of each 8-key score tile, but the int8
//      A fragment wants keys {4t, ..., 4t+3} of a 32-key step. A
//      contraction's order is free, so both operands take the key order in
//      which a thread's four P codes are consecutive (pv_slot), and V^T is
//      staged in shared memory in that order.

#include <math.h>

#include "int8_gemm.cuh"
#include "mma.cuh"

namespace {

using int8k::kQuantFloor;
using int8k::quant_code;
using mavlm::lds32;
using mavlm::pack_bf16x2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per K/V tile
constexpr int kScaleThreads = 256;
constexpr float kMaskValue = -2.381976426469702e38f;  // -0.7 * FLT_MAX

struct Int8MergeParams {
  const __nv_bfloat16* q;  // (B, NH, S, D), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;        // (B, S, NH * D)
  const int* valid_len;    // (B,)
  const float* scales;     // (B * NH, ntiles + 2): q tiles, then sk, sv
  int NH, S, tile, ntiles;
  float scale_log2;
};

// scales[(b * NH + h) * (ntiles + 2) + j] = max(|x|, 1e-12) / 127 over q's
// tile j (x = q * c) for j < ntiles, over all of k for j = ntiles and of v
// for j = ntiles + 1. Rows are D % 8 == 0 bf16 values, so every range is
// whole 16-byte vectors.
__global__ void __launch_bounds__(kScaleThreads)
scales_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, float* __restrict__ scales, int NH, int S,
              int D, int tile, int ntiles, float c) {
  __shared__ float red[kScaleThreads / 32];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long head = (static_cast<long long>(b) * NH + h) * S * D;
  const bool is_q = j < ntiles;
  const __nv_bfloat16* src = (is_q ? q : (j == ntiles ? k : v)) + head;
  const long long lo = is_q ? static_cast<long long>(j) * tile * D : 0;
  const long long hi = static_cast<long long>(is_q ? min(S, (j + 1) * tile) : S) * D;
  float amax = 0.f;
  for (long long i = lo / 8 + threadIdx.x; i < hi / 8; i += kScaleThreads) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float val = __bfloat162float(x[e]);
      amax = fmaxf(amax, fabsf(is_q ? __fmul_rn(val, c) : val));
    }
  }
  amax = mavlm::warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kScaleThreads / 32; ++w) m = fmaxf(m, red[w]);
    scales[(static_cast<long long>(b) * NH + h) * (ntiles + 2) + j] = fmaxf(m, kQuantFloor) / 127.f;
  }
}

// Key r of a 64-key tile -> its place in the PV contraction. Within each
// 32-key step, thread t's A-fragment bytes 4t..4t+3 are keys 2t, 2t+1,
// 8+2t, 9+2t (and 16+ those for bytes 16+4t..): the inverse of that map.
__device__ __forceinline__ int pv_slot(int r) {
  const int rr = r & 31;
  return (r & 32) | (rr & 16) | (((rr >> 1) & 3) << 2) | (((rr >> 3) & 1) << 1) | (rr & 1);
}

__device__ __forceinline__ uint32_t pack_codes(int c0, int c1, int c2, int c3) {
  return static_cast<uint32_t>(c0 & 0xff) | (static_cast<uint32_t>(c1 & 0xff) << 8) |
         (static_cast<uint32_t>(c2 & 0xff) << 16) | (static_cast<uint32_t>(c3 & 0xff) << 24);
}

template <int D>
__global__ void __launch_bounds__(kThreads) merge_int8_kernel(const Int8MergeParams p) {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  constexpr int DK = (D + 31) / 32 * 32;  // QK^T depth, zero-padded to 32
  constexpr int KSTR = DK + 16;           // bytes per Q/K code row (bank skew)
  constexpr int VSTR = kBN + 16;          // bytes per V^T code row
  constexpr int NT = kBN / 8;             // 8-key score tiles per warp
  constexpr int DT = D / 8;               // 8-wide output tiles
  constexpr int KC = DK / 32;             // 32-deep steps of QK^T
  constexpr int CH = DK / 8;              // 8-code chunks per Q/K row

  __shared__ __align__(16) int8_t sQ[kBM * KSTR];
  __shared__ __align__(16) int8_t sK[kBN * KSTR];
  __shared__ __align__(16) int8_t sVt[D * VSTR];

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
  const float* sc = p.scales + (static_cast<long long>(b) * p.NH + h) * (p.ntiles + 2);
  const float sk = sc[p.ntiles], sv = sc[p.ntiles + 1];
  const float inv_k = 1.f / sk, inv_v = 1.f / sv;

  const int valid = p.valid_len[b];
  const int kv_end = valid > 0 ? min(valid, S) : S;

  // q codes, each row with its tile's scale; zero past S and past depth D
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint2 packed = make_uint2(0, 0);
    if (q0 + r < S && c < D) {
      const float inv = 1.f / sc[(q0 + r) / p.tile];
      const uint4 raw = *reinterpret_cast<const uint4*>(q + static_cast<long long>(q0 + r) * D + c);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      int8_t* out = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = quant_code(__fmul_rn(__bfloat162float(x[j]), p.scale_log2), inv);
    }
    *reinterpret_cast<uint2*>(sQ + r * KSTR + c) = packed;
  }
  // sq * sk of this thread's two rows (rows past S borrow the last one's)
  float sqk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + g + 8 * r, S - 1);
    sqk[r] = __fmul_rn(sc[row / p.tile], sk);
  }
  __syncthreads();

  uint32_t qa[KC][4];
  {
    const int8_t* qs = sQ + warp * 16 * KSTR;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      qa[kc][0] = lds32(qs + g * KSTR + kc * 32 + 4 * t);
      qa[kc][1] = lds32(qs + (g + 8) * KSTR + kc * 32 + 4 * t);
      qa[kc][2] = lds32(qs + g * KSTR + kc * 32 + 16 + 4 * t);
      qa[kc][3] = lds32(qs + (g + 8) * KSTR + kc * 32 + 16 + 4 * t);
    }
  }

  // Stage the codes of keys [n0, n0 + kBN) (and of V, transposed into PV
  // order, when with_v); rows past kv_end are zero.
  auto load_tile = [&](int n0, bool with_v) {
    for (int i = tid; i < kBN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = n0 + r < kv_end && c < D;
      uint2 packed = make_uint2(0, 0);
      if (in) {
        const uint4 raw = *reinterpret_cast<const uint4*>(k + static_cast<long long>(n0 + r) * D + c);
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
        int8_t* out = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) out[j] = quant_code(__bfloat162float(x[j]), inv_k);
      }
      *reinterpret_cast<uint2*>(sK + r * KSTR + c) = packed;
      if (with_v && c < D) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (in) raw = *reinterpret_cast<const uint4*>(v + static_cast<long long>(n0 + r) * D + c);
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const int slot = pv_slot(r);
#pragma unroll
        for (int j = 0; j < 8; ++j) sVt[(c + j) * VSTR + slot] = quant_code(__bfloat162float(x[j]), inv_v);
      }
    }
  };

  // Scores of this warp's 16 rows against the staged keys: keys at or past
  // S are not keys (-inf, p = 0); keys at or past valid get MASK_VALUE.
  auto scores = [&](int n0, float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* ks = sK + (nt * 8 + g) * KSTR + 4 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mavlm::mma_s8_16832(acc, qa[kc], lds32(ks + kc * 32), lds32(ks + kc * 32 + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        float x = __fmul_rn(static_cast<float>(acc[e]), sqk[e >> 1]);
        if (col >= S) {
          x = -INFINITY;
        } else if (col >= valid) {
          x = kMaskValue;
        }
        s[nt][e] = x;
      }
    }
  };

  // sweep 1: the row max over every key
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // the previous tile is consumed
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

  // sweep 2: p against the final max, l over the unrounded p, P codes and PV
  int acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0;
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();
    load_tile(n0, true);
    __syncthreads();
    float s[NT][4];
    scores(n0, s);
    int pc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(__fsub_rn(s[nt][e], m_row[e >> 1]));
        l_run[e >> 1] += pe;
        pc[nt][e] = static_cast<int>(rintf(__fmul_rn(pe, 127.f)));
      }
    }
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) {
      const int n = 4 * c;
      uint32_t a[4];
      a[0] = pack_codes(pc[n][0], pc[n][1], pc[n + 1][0], pc[n + 1][1]);
      a[1] = pack_codes(pc[n][2], pc[n][3], pc[n + 1][2], pc[n + 1][3]);
      a[2] = pack_codes(pc[n + 2][0], pc[n + 2][1], pc[n + 3][0], pc[n + 3][1]);
      a[3] = pack_codes(pc[n + 2][2], pc[n + 2][3], pc[n + 3][2], pc[n + 3][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int8_t* vs = sVt + (dt * 8 + g) * VSTR + c * 32 + 4 * t;
        mavlm::mma_s8_16832(acc[dt], a, lds32(vs), lds32(vs + 16));
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
  const int HD = p.NH * D;
  const float sv127 = sv / 127.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float f = __fdiv_rn(sv127, l);  // l >= 1: the max key contributes p = 1
    const int row = row0 + 8 * r;
    if (row < S) {
      __nv_bfloat16* orow = p.o + (static_cast<long long>(b) * S + row) * HD + h * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16x2(__fmul_rn(static_cast<float>(acc[dt][2 * r]), f),
                        __fmul_rn(static_cast<float>(acc[dt][2 * r + 1]), f));
      }
    }
  }
}

template <int D>
void launch(const Int8MergeParams& p, int B, cudaStream_t stream) {
  dim3 grid((p.S + kBM - 1) / kBM, p.NH, B);
  merge_int8_kernel<D><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// q, k, v (B, NH, S, D) bf16 contiguous -> o (B, S, NH*D) bf16; scales
// (B * NH, ceil(S / tile) + 2) fp32 is scratch. Returns 0, a cudaError_t,
// -1 for a head dim the library was not built for, or -3 (shape).
extern "C" int flash_merge_int8(int head_dim, const void* q, const void* k, const void* v,
                                void* o, const void* valid_len, void* scales, int B, int NH,
                                int S, int tile, float scale_log2, void* stream) {
  if (head_dim != 64 && head_dim != 72 && head_dim != 128) return -1;
  if (tile < 1 || S < 1 || B < 1 || NH < 1) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Int8MergeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.valid_len = static_cast<const int*>(valid_len);
  p.scales = static_cast<const float*>(scales);
  p.NH = NH;
  p.S = S;
  p.tile = tile;
  p.ntiles = (S + tile - 1) / tile;
  p.scale_log2 = scale_log2;
  scales_kernel<<<dim3(p.ntiles + 2, NH, B), kScaleThreads, 0, st>>>(
      p.q, p.k, p.v, static_cast<float*>(scales), NH, S, head_dim, tile, p.ntiles, scale_log2);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  switch (head_dim) {
    case 64: launch<64>(p, B, st); break;
    case 72: launch<72>(p, B, st); break;
    default: launch<128>(p, B, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
