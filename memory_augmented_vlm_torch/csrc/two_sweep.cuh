// The two-sweep bf16 attention shared by flash_merge.cu (the merge-heads
// attention, #2) and attn_block.cu (the attention stage of #12), for
// Hopper (sm_90a).
//
// Per (batch, head), the keys past kv_end = valid > 0 ? min(valid, S) : S
// are left out (they give p = 0); keys in [valid, S) take the policy's
// finite mask score, so a batch with valid length 0 weighs all S keys
// alike. One block per 64-row q tile, head and batch; 4 warps of 16 rows;
// bf16 mma.sync with fp32 accumulation; the QK^T depth zero-padded to 16
// in shared memory; V transposed into shared memory for the PV B operand.
// Two sweeps over the keys instead of an online softmax: the first finds
// the row max, the second computes p against that final max, l and PV.
// The TPU kernels round P to bf16 against the final max; an online
// softmax would round it against running maxima and differ. The second
// QK^T costs a third more tensor-core work.
//
// What differs between the two kernels is a policy type P, passed by value
// as the kernel's parameter:
//   const __nv_bfloat16 *q, *k, *v;   // (B, NH, S, D), contiguous
//   int NH, S;
//   static constexpr float kMask;     // score of a key in [valid, S)
//   int valid(int b) const;           // batch b's valid key count
//   float q_in(float x) const;        // q's value, rounded to bf16 after
//   float logit(float qk) const;      // the score from the fp32 q.k
//   float prob(float s, float m) const;  // p of score s against row max m
//   template <int D> void store(int b, int h, int row, int t,
//                               const float (&acc)[D / 8][4], int r,
//                               float l) const;
// store is called for each of a thread's two rows (r = 0, 1: row g and
// g + 8 of its warp's 16) by every lane of the warp, rows past S included,
// with the un-normalised P.V in acc[.][2r], acc[.][2r + 1] (columns
// dt * 8 + 2t, +1) and the row's l; it may use warp shuffles.

#pragma once

#include <math.h>

#include "mma.cuh"

namespace mavlm {
namespace two_sweep {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per K/V tile

template <int D, class P>
__global__ void __launch_bounds__(kThreads) kernel(const P p) {
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

  const int valid = p.valid(b);
  const int kv_end = valid > 0 ? min(valid, S) : S;

  // q_in(q) rounded to bf16; zero rows past S and depth past D
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (q0 + r < S && c < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + static_cast<long long>(q0 + r) * D + c);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint32_t* out = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[j] = pack_bf16x2(p.q_in(__bfloat162float(x[2 * j])),
                             p.q_in(__bfloat162float(x[2 * j + 1])));
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

  // Scores of this warp's 16 rows against the staged keys: keys at or past
  // S are not keys (-inf, p = 0); keys at or past valid get P::kMask.
  auto scores = [&](int n0, float (&s)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* ks = sK + (nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma_bf16_16816(s[nt], qf[kc], lds32(ks + kc * 16), lds32(ks + kc * 16 + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = p.logit(s[nt][e]);
        if (col >= S) {
          s[nt][e] = -INFINITY;
        } else if (col >= valid) {
          s[nt][e] = P::kMask;
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
        s[nt][e] = p.prob(s[nt][e], m_row[e >> 1]);
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
        mma_bf16_16816(acc[dt], a, lds32(vs), lds32(vs + 8));
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    p.template store<D>(b, h, row0 + 8 * r, t, acc, r, l);
  }
}

template <int D, class P>
void launch(const P& p, int B, cudaStream_t stream) {
  kernel<D, P><<<dim3((p.S + kBM - 1) / kBM, p.NH, B), kThreads, 0, stream>>>(p);
}

}  // namespace two_sweep
}  // namespace mavlm
