// The decode GEMV for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_gemv_kernel` behind tools_gemv_bench.py:33
// pallas_gemv, the decode GEMV micro-benchmark, and computes the same
// function: y (1, N) = x (1, K) . W (K, N) with x and W read as fp32, fp32
// accumulation and y rounded to bf16. W is (K, N) row-major bf16. Any K and
// N: the TPU version asserts N % block_n == 0, which its own 896-wide
// down-projection breaks.
//
// What bounds it on the H100: bytes. At the tool's 0.5B MLP shapes (896 ->
// 4864 -> 896) W is 8.7 MB per product against 8.7 MFLOP, 0.5 flop per
// byte; 12 layers are 209.2 MB, 62.4 us at 3.35 TB/s, four times the 50 MB
// L2, so a chain of them streams W from device memory, and the gaps
// between its 24 dependent products cost as much as the bytes.
//
// Design (the partition is microbench/gemv.py's `plan`):
//   - A block takes a strip of COLS columns (128, 64 or 32: the widest
//     whose strips can fill the SMs, as a longer run of a W row reads
//     faster) and a slice of K; the blocks of one strip form a thread-block
//     cluster along K (up to 16 ranks, enough strips x ranks to fill the
//     SMs: 38 strips of 128 x 4 ranks up, 14 of 64 x 10 down). Each block
//     sums its slice in fp32 and stores its COLS sums into rank 0's shared memory
//     (distributed shared memory), then arrives on the cluster barrier;
//     rank 0 waits there, adds the ranks' sums in rank order and rounds
//     once to bf16, while the other ranks exit. One launch per product,
//     deterministic, no atomics and no global scratch.
//   - A block first loads its whole slice of W into shared memory (TMA
//     boxes of up to 256 rows on one mbarrier; plain 2-byte loads where W's
//     row stride or base is not 16-byte aligned, which TMA refuses), then
//     lets the next grid launch (griddepcontrol.launch_dependents), then
//     waits for the grid before it (griddepcontrol.wait), and only then
//     reads x and writes y. Launched with `pdl` (programmatic dependent
//     launch), the block starts while the grid before it still runs, so
//     this product's weights stream in while that one finishes; W must then
//     not be written by that grid (it is read before the wait), while x and
//     y may alias memory that grid used. Launched without, the block starts
//     after the grid before it has ended and the wait returns at once.
//   - A slice larger than a block's tile (96 KB) is read in passes; only
//     the first is loaded before the wait.
// Each thread sums 8 adjacent columns (one 16-byte shared load per row)
// over every RG-th row of the tile; the warp's row groups meet by shuffles,
// the warps' sums in shared memory, in a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
namespace sm90 = mavlm::sm90;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // adjacent columns a thread sums
constexpr int kMaxCluster = 16;  // ranks along K (a non-portable cluster)
constexpr int kMaxBoxRows = 256; // TMA's largest box side

// A product's partition: a cluster rank's `rows` of K, read in passes of
// `tile_rows` = boxes x `box_rows` rows (multiples of 8, so that every
// box lands 128-byte aligned).
struct Part {
  int K, N, rows, tile_rows, box_rows;
};

// The cluster barrier in its two halves. A first phase, arrived at on
// entry and waited for before the first store into another block's shared
// memory, makes sure every block of the cluster has started; the second
// orders the ranks' stores (release) before rank 0's reads (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A block's shared memory: the W tile [tile_rows][cols] bf16, x [tile_rows]
// fp32, the warps' sums [kWarps][cols], every rank's sums [kMaxCluster][cols]
// (read in rank 0), the mbarrier, and 128 bytes to align the tile.
inline size_t smem_bytes(int cols, int tile_rows) {
  return 128 + static_cast<size_t>(tile_rows) * cols * 2 + tile_rows * 4 + kWarps * cols * 4 +
         kMaxCluster * cols * 4 + 8;
}

template <int COLS, bool TMA>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, const Part p) {
  constexpr int TPR = COLS / kVec;    // threads per row
  constexpr int RG = kThreads / TPR;  // rows summed side by side
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tile = smem_raw + ((128u - (sm90::smem_u32(smem_raw) & 127u)) & 127u);
  float* xs = reinterpret_cast<float*>(tile + static_cast<size_t>(p.tile_rows) * COLS * 2);
  float* red = xs + p.tile_rows;
  float* ranks = red + kWarps * COLS;
  const uint32_t bar = sm90::smem_u32(ranks + kMaxCluster * COLS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, c0 = blockIdx.y * COLS;
  const int k_rank = rank * p.rows, passes = p.rows / p.tile_rows;
  const uint32_t tile_bytes = static_cast<uint32_t>(p.tile_rows) * COLS * 2;

  auto load_tile = [&](int k0) {  // rows k0 .. k0 + tile_rows of the strip
    if constexpr (TMA) {
      if (tid == 0) {
        sm90::mbar_arrive_tx(bar, tile_bytes);
        for (int r = 0; r < p.tile_rows; r += p.box_rows) {
          sm90::tma_load_2d(sm90::smem_u32(tile) + r * COLS * 2, &tm_w, bar, c0, k0 + r);
        }
      }
    } else {
      auto* t = reinterpret_cast<__nv_bfloat16*>(tile);
      for (int i = tid; i < p.tile_rows * COLS; i += kThreads) {
        const int k = k0 + i / COLS, n = c0 + i % COLS;
        t[i] = k < p.K && n < p.N ? w[static_cast<long long>(k) * p.N + n]
                                  : __float2bfloat16_rn(0.f);
      }
    }
  };
  auto load_x = [&](int k0) {
    for (int r = tid; r < p.tile_rows; r += kThreads) {
      xs[r] = k0 + r < p.K ? __bfloat162float(x[k0 + r]) : 0.f;
    }
  };

  cluster_arrive_relaxed();  // this block has started
  if constexpr (TMA) {
    if (tid == 0) {
      sm90::mbar_init(bar, 1);
      sm90::mbar_fence_init();
    }
    __syncthreads();
  }
  load_tile(k_rank);
  launch_dependents();  // the next product may start loading its weights
  wait_for_previous_grid();  // x is written, and y's memory free, from here on

  const int g = tid / TPR, j = tid % TPR;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int ps = 0; ps < passes; ++ps) {
    const int k0 = k_rank + ps * p.tile_rows;
    if (ps > 0) {
      __syncthreads();  // the last pass's tile and xs are read
      load_tile(k0);
    }
    load_x(k0);
    __syncthreads();
    if constexpr (TMA) sm90::mbar_wait(bar, ps & 1);
    for (int r = g; r < p.tile_rows; r += RG) {
      const float xv = xs[r];
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + (r * COLS + j * kVec) * 2);
      const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
        acc[2 * i] = fmaf(xv, __uint_as_float(u[i] << 16), acc[2 * i]);
        acc[2 * i + 1] = fmaf(xv, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
      }
    }
  }

  // the warp's row groups, then the warps in order
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < TPR) {
    float4* dst = reinterpret_cast<float4*>(red + warp * COLS + lane * kVec);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (tid < COLS) {
    float s = red[tid];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) s += red[wp * COLS + tid];
    *cluster.map_shared_rank(ranks + rank * COLS + tid, 0) = s;
  }
  cluster_arrive_release();
  if (rank != 0) return;  // no block reads this one's shared memory
  cluster_wait();  // every rank's sums are in this block's shared memory
  if (tid < COLS && c0 + tid < p.N) {
    const int n_ranks = static_cast<int>(cluster.num_blocks());
    float s = ranks[tid];
    for (int r = 1; r < n_ranks; ++r) s += ranks[r * COLS + tid];
    y[c0 + tid] = __float2bfloat16_rn(s);
  }
}

template <int COLS, bool TMA>
int launch(const CUtensorMap& map, const __nv_bfloat16* x, const __nv_bfloat16* w,
           __nv_bfloat16* y, const Part& p, int cluster, bool pdl, cudaStream_t st) {
  const auto kern = gemv_kernel<COLS, TMA>;
  const size_t smem = smem_bytes(COLS, p.tile_rows);
  int rc = sm90::set_smem(kern, smem);
  if (rc != 0) return rc;
  if (cluster > 8) {
    rc = static_cast<int>(
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (rc != 0) return rc;
  }
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.N + COLS - 1) / COLS, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = pdl ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, map, x, w, y, p));
}

}  // namespace

// x (K,) bf16, w (K, N) bf16 row-major -> y (N,) bf16, one launch.
// Partition (microbench/gemv.py's plan): strips of cols (128, 64 or 32)
// columns; cluster ranks along K, each over `rows` rows in passes of
// tile_rows = boxes x box_rows rows (cluster * rows >= K > (cluster - 1) *
// rows). tma: 1 reads W by TMA (N % 8 == 0 and w 16-byte aligned), 0 by
// plain loads. pdl: 1 launches it as a programmatic dependent of the grid
// before it on the stream, which must not have written w. Returns 0, a
// cudaError_t, -3 (shape or partition) or -4 (a tensor map refused).
extern "C" int gemv_bf16(const void* x, const void* w, void* y, int K, int N, int cols,
                         int cluster, int rows, int tile_rows, int box_rows, int tma,
                         int pdl, void* stream) {
  const Part p{K, N, rows, tile_rows, box_rows};
  if (K < 1 || N < 1 || (cols != 128 && cols != 64 && cols != 32) || cluster < 1 ||
      cluster > kMaxCluster || tile_rows < 8 || tile_rows % 8 || rows < tile_rows ||
      rows % tile_rows || box_rows < 8 || box_rows % 8 || box_rows > kMaxBoxRows ||
      tile_rows % box_rows ||
      static_cast<long long>(cluster) * rows < K ||
      static_cast<long long>(cluster - 1) * rows >= K || (N + cols - 1) / cols > 65535 ||
      smem_bytes(cols, tile_rows) > 227 * 1024 ||
      (tma && (N % 8 || reinterpret_cast<uintptr_t>(w) % 16))) {
    return -3;
  }
  CUtensorMap map = {};
  if (tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
    const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)box_rows};
    if (!sm90::encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return sm90::kTmaRejected;
    }
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 128) {
    return tma ? launch<128, true>(map, xb, wb, yb, p, cluster, pdl != 0, st)
               : launch<128, false>(map, xb, wb, yb, p, cluster, pdl != 0, st);
  }
  if (cols == 64) {
    return tma ? launch<64, true>(map, xb, wb, yb, p, cluster, pdl != 0, st)
               : launch<64, false>(map, xb, wb, yb, p, cluster, pdl != 0, st);
  }
  return tma ? launch<32, true>(map, xb, wb, yb, p, cluster, pdl != 0, st)
             : launch<32, false>(map, xb, wb, yb, p, cluster, pdl != 0, st);
}
