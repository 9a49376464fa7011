// Flash-attention forward, bound to Python with ctypes: the C entry point
// flash_fwd, and its fp32 kernel.
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
// bf16 inputs, the main path, run the TMA-fed wgmma kernel of
// flash_fwd_sm90.cu. fp32 inputs take the SIMT kernel here (one warp per
// query row, lanes over keys); it serves fp32 parity runs only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"

namespace {

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
struct LaunchF32 {
  static void run(const FlashParams& p, dim3 grid, cudaStream_t stream) {
    flash_fwd_f32_kernel<D><<<grid, 32 * kRowsF32, 0, stream>>>(p);
  }
};

}  // namespace

// dtype: 0 = bf16, 1 = fp32. bf16 runs one block per item of `items`
// ((n_items, 3) int32: batch, query head, tile of block_rows query rows),
// which the wrapper builds per shape; fp32 ignores the three. Returns 0, a
// cudaError_t from the launch, or -1 for a head dim / -2 for a dtype / -3
// for block rows the library was not built for, -4 for a refused tensor map.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                         const void* v, void* o, const void* valid_len, int B,
                         int Sq, int Skv, int H, int kv_groups, int causal,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale_log2, void* stream, const void* items, int n_items,
                         int block_rows) {
  if (dtype == 0) {
    const mavlm::fwd_sm90::Args a = {
        q, k, v, o, nullptr, valid_len, items, n_items, block_rows, B, Sq, Skv, H,
        kv_groups, causal, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
        {o_sb, o_ss, o_sh}, scale_log2};
    return mavlm::fwd_sm90::run(a, head_dim, stream);
  }
  if (dtype != 1) return -2;
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
  const dim3 grid((Sq + kRowsF32 - 1) / kRowsF32, H, B);
  const int rc =
      dispatch_head_dim<LaunchF32>(head_dim, p, grid, static_cast<cudaStream_t>(stream));
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
