// Flash attention for training, bound to Python with ctypes: the C entry
// points of the forward that saves the log-sum-exp and of the fp32 backward,
// and their fp32 kernels. The bf16 forward is flash_fwd_sm90.cu's kernel,
// the bf16 backward kernels are in flash_bwd_sm90.cu.
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
// The fp32 kernels are SIMT (a warp per query or key row, lanes over the
// other axis), at head dims 64, 128 and 256. They serve fp32 parity runs
// only. Their tiles live in dynamic shared memory (F32Smem), since at 256
// they pass the 48 KB a block takes without the opt-in attribute: 72 KB
// for the forward, 82 KB for each backward kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "mma.cuh"

namespace {

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
// fp32 SIMT kernels (parity runs)
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = 8;  // warps per block, one row each
constexpr int kColsF32 = 32;  // columns per loop tile, one per lane

// The kernels' shared tiles, in dynamic shared memory: two [kColsF32][D + 1]
// tiles of the looped rows (padded against bank conflicts), two
// [kRowsF32][D] tiles of the block's own rows and two vectors of kColsF32
// (dK/dV's lse and delta); each kernel takes what it uses.
template <int D>
struct F32Smem {
  static constexpr int COLS = kColsF32 * (D + 1), ROWS = kRowsF32 * D;
  static constexpr size_t BYTES = (2 * COLS + 2 * ROWS + 2 * kColsF32) * sizeof(float);
  float* base;
  __device__ explicit F32Smem(float* p) : base(p) {}
  __device__ float (*cols(int i))[D + 1] {
    return reinterpret_cast<float (*)[D + 1]>(base + i * COLS);
  }
  __device__ float (*rows(int i))[D] {
    return reinterpret_cast<float (*)[D]>(base + 2 * COLS + i * ROWS);
  }
  __device__ float* vec(int i) { return base + 2 * COLS + 2 * ROWS + i * kColsF32; }
};

template <int D>
__global__ void __launch_bounds__(32 * kRowsF32) fwd_lse_f32_kernel(const TrainParams p) {
  constexpr int NI = D / 32;
  extern __shared__ float smem_f32[];
  F32Smem<D> sm(smem_f32);
  float(*sK)[D + 1] = sm.cols(0);
  float(*sV)[D + 1] = sm.cols(1);
  float(*sQ)[D] = sm.rows(0);
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
  extern __shared__ float smem_f32[];
  F32Smem<D> sm(smem_f32);
  float(*sK)[D + 1] = sm.cols(0);
  float(*sV)[D + 1] = sm.cols(1);
  float(*sQ)[D] = sm.rows(0);
  float(*sDO)[D] = sm.rows(1);
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
  extern __shared__ float smem_f32[];
  F32Smem<D> sm(smem_f32);
  float(*sQ)[D + 1] = sm.cols(0);  // raw q
  float(*sDO)[D + 1] = sm.cols(1);
  float(*sK)[D] = sm.rows(0);
  float(*sV)[D] = sm.rows(1);
  float* sLse = sm.vec(0);
  float* sDelta = sm.vec(1);
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
int launch_f32(Which which, const TrainParams& p, int B, int Hkv, cudaStream_t stream) {
  const dim3 block(32 * kRowsF32);
  const dim3 rows((p.Sq + kRowsF32 - 1) / kRowsF32, p.H, B);
  auto kernel = which == kFwd ? fwd_lse_f32_kernel<D>
                : which == kDq ? bwd_dq_f32_kernel<D> : bwd_dkv_f32_kernel<D>;
  const dim3 grid = which == kDkv ? dim3((p.Skv + kRowsF32 - 1) / kRowsF32, Hkv, B) : rows;
  constexpr size_t smem = F32Smem<D>::BYTES;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only: bf16 runs flash_fwd_sm90.cu / flash_fwd_wide_sm90.cu (forward)
// and flash_bwd_sm90.cu
int launch(Which which, int dtype, int head_dim, const TrainParams& p, int B, int Hkv,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return -2;
  switch (head_dim) {
    case 64: return launch_f32<64>(which, p, B, Hkv, s);
    case 128: return launch_f32<128>(which, p, B, Hkv, s);
    case 256: return launch_f32<256>(which, p, B, Hkv, s);
    default: return -1;
  }
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

// out (B, Sq, H, D) and lse (B, H, Sq) fp32 are written. bf16 runs
// flash_fwd_sm90.cu's kernel, one block per item of `items` ((n_items, 3)
// int32: batch, query head, tile of block_rows query rows); fp32 ignores the
// three.
extern "C" int flash_fwd_lse(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, void* out, void* lse, const void* valid_len,
                             int B, int Sq, int Skv, int H, int kv_groups, int causal,
                             const long long* q_strides, const long long* k_strides,
                             const long long* v_strides, const long long* o_strides,
                             float scale, float scale_log2, void* stream, const void* items,
                             int n_items, int block_rows) {
  if (dtype == 0) {  // head dims 64, 128 and 256 (flash_fwd_wide_sm90.cu)
    mavlm::fwd_sm90::Args a = {q, k, v, out, lse, valid_len, items, n_items, block_rows, B, Sq,
                               Skv, H, kv_groups, causal};
    for (int i = 0; i < 3; ++i) {
      a.q_st[i] = q_strides[i];
      a.k_st[i] = k_strides[i];
      a.v_st[i] = v_strides[i];
      a.o_st[i] = o_strides[i];
    }
    a.scale_log2 = scale_log2;
    return mavlm::fwd_sm90::run(a, head_dim, stream);
  }
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
