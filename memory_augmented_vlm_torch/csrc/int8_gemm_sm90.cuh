// The Hopper int8 GEMM core of the port's int8 kernels: the MLP half-blocks
// (mlp_int8.cu, swiglu_int8.cu), the q/k/v projections (qkv_int8.cu), the
// w8a8 layer and the int8 ceiling's bare GEMM (int8_matmul.cu's
// int8_matmul and int8_gemm_bf16) and the out-projection of the merge-heads
// attention (flash_merge.cu's flash_merge_oproj): C(M, N) = A(M, K) B(K, N)
// in int32, exact, handed to a functor epilogue, with an optional per-row
// max of |epilogue value|. Its epilogue (store_tile) also serves
// attn_block.cu's out-projection, whose accumulators are fp32.
//
// It runs on Hopper's own tools: a producer warp issues TMA loads of A and
// B tiles into an mbarrier ring, and two consumer warpgroups issue s8 wgmma
// with both operands read from shared memory (8-bit wgmma reads both K-major,
// which the port's layouts are: A is (M, K) row-major, B is stored as N
// rows of K, the column-major (K, N) kernel layout of ops/quant.py).
//
// Tiles: a block computes 128 rows (64 per consumer warpgroup) by one or
// two halves (NHALF) of HN = 128 or 64 B rows, K in steps of 128 bytes (one
// 128-byte swizzled row of a TMA box; ragged M, N and K edges read as
// zeros). Each half is one m64nHNk32 product per 32-byte k-step into its
// own HN / 2 accumulators. A plain GEMM takes its two halves as adjacent
// column blocks of one B; a paired GEMM (Epi::kPaired) takes the same
// column block [n0, n0 + HN) of two B matrices over the same A tile, so a
// thread holds both products of a (row, column) in equal registers (the
// gate and the up projection of a SwiGLU; no interleaved weight copy). A
// stacked GEMM runs up to three plain GEMMs over the same A in one grid
// (q, k and v from one set of LayerNorm codes): blockIdx.x picks the B
// matrix and the column tile, matrix-major, so the blocks of one row tile
// run together and read their A tile from L2 after the first.
// MINB = 2 runs two blocks an SM (at most 128 B rows, 64 accumulators a
// thread, so that ptxas keeps a thread within 112 registers), so one
// block's epilogue runs beside the other's products.
//
// The products accumulate onto zeroed registers with a constant scale-d
// (sm90::wgmma_ss_s8_n128 / _n64), and each k-tile waits only for the
// previous one's group (wgmma.wait_group 1) before it releases that stage:
// two waits in the source, and cuobjdump -sass shows two WARPGROUP.DEPBARs.
//
// Epilogue (store_tile): the accumulators go to shared memory as they lie
// (the ring, free by then), and a warp reads its 16 rows back row by row,
// four columns a lane, through the functor, leaving in row-contiguous
// stores, 512 bytes a warp (Epi::store4; Epi::store where N is ragged).
// Nothing of the epilogue holds
// the accumulators past their first store, which keeps the two-half
// kernels within ptxas's 168 registers (a block of 288 threads) without
// spills.
//
// Epi:
//   static constexpr bool kRowMax, kPaired, kRagged;
//   float row_scale(int row) const;                     // row < M
//   float value(float x, int col, int a) const;         // !kPaired
//   float value(float x, int col, int a, int b) const;  // kPaired: a of B0, b of B1
//   void row_max(int row, float m) const;               // when kRowMax
//   void store4(int row, int col, float4 v) const;      // columns col .. col + 3
//   void store(int row, int col, float4 v, int nv) const;  // kRagged: col .. col + nv - 1
// with col < n_out (the epilogue's columns: N, or B's rows when paired; z
// * n_out + c for matrix z of a stacked GEMM). n_out is a multiple of 16,
// so that four columns are all in or all out, unless kRagged: then n_out is
// any width of a plain GEMM, value sees only columns below it, and store
// takes the nv = min(4, n_out - col) columns of the step wherever the row's
// base leaves them (row * n_out + col need not be 4-aligned).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace int8h {

namespace sm90 = mavlm::sm90;
using mavlm::pack_bf16x2;

constexpr int kBM = 128;        // rows of a block: two consumer warpgroups of 64
constexpr int kBK = 128;        // bytes of K per stage: one 128-byte swizzled row
constexpr int kConsumers = 2;   // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // and a producer warp

template <int NHALF, int HN, int MINB>
struct GemmShape {
  static_assert(NHALF == 1 || NHALF == 2, "one or two halves");
  static_assert(HN == 64 || HN == 128, "halves of 64 or 128 B rows");
  static_assert(MINB == 1 || (MINB == 2 && NHALF * HN <= 128), "two blocks an SM: 128 rows");
  static constexpr int STAGES = MINB == 2 ? 3 : NHALF * HN == 256 ? 4 : 6;
  static constexpr uint32_t A_BYTES = kBM * kBK;
  static constexpr uint32_t HALF_BYTES = HN * kBK;
  static constexpr uint32_t STAGE = A_BYTES + NHALF * HALF_BYTES;
  static constexpr size_t SMEM = STAGES * STAGE + 16 * STAGES + 1024;
  // the staged accumulators: a row of both halves and 8 ints past it, so
  // that the int2 stores of a half-warp (rows g, columns 2 t) fall in
  // distinct banks
  static constexpr int SROW = NHALF * HN + 8;
  static_assert(kConsumers * 4 * 16 * SROW * 4 <= STAGES * STAGE, "staging fits the ring");
};

// the consumer warpgroups' barrier (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 128) : "memory");
}

template <typename Acc>
struct Acc4;
template <>
struct Acc4<int> {
  using type = int4;
};
template <>
struct Acc4<float> {
  using type = float4;
};
__device__ __forceinline__ int2 pair(int a, int b) { return make_int2(a, b); }
__device__ __forceinline__ float2 pair(float a, float b) { return make_float2(a, b); }

// The epilogue of a block's tile of 128 rows from m0 and OW columns from c0,
// its accumulators (int32 products, or fp32 sums) in the registers where
// wgmma left them. The caller has synchronised the consumers, so the ring
// is free: the accumulators go to it as they lie (a thread of warp w of its
// warpgroup holds rows 16 w + g and + 8, columns 8 j + 2 t and + 1, g =
// lane / 4, t = lane % 4), and a warp reads its 16 rows back row by row,
// four columns a lane (two rows at a time for a 64-column tile): the
// functor maps each value to an fp32 output (with the row's factor and the
// column's scales, read by neighbouring lanes from neighbouring addresses),
// |value| is folded over the row by the warp before one atomicMax per (row,
// tile), and the values leave in row-contiguous stores (Epi::store4). The
// functor sees column zc + c0 + c (zc: the offset of a stacked GEMM's
// matrix, 0 otherwise).
template <int NHALF, int HN, int SROW, class Epi, typename Acc>
__device__ __forceinline__ void store_tile(const Acc (&acc)[NHALF][HN / 2], Acc* staged,
                                           const Epi& epi, int m0, int c0, int zc, int M,
                                           int n_out) {
  constexpr int OW = Epi::kPaired ? HN : NHALF * HN;  // output columns of a tile
  using V2 = decltype(pair(Acc(), Acc()));
  using V4 = typename Acc4<Acc>::type;
  const int warp = sm90::warp_index(), lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  Acc* st = staged + warp * 16 * SROW;
#pragma unroll
  for (int h = 0; h < NHALF; ++h) {
#pragma unroll
    for (int i = 0; i < HN / 2; i += 2) {
      const int row = g + 8 * ((i >> 1) & 1), col = h * HN + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<V2*>(st + row * SROW + col) = pair(acc[h][i], acc[h][i + 1]);
    }
  }
  __syncwarp();
  // LPR lanes take a row, four columns each per step, RPP rows at a time;
  // the rows are unrolled so that one row's loads and maths overlap the
  // next one's
  constexpr int LPR = OW >= 128 ? 32 : OW / 4, RPP = 32 / LPR;
  const int sub = lane / LPR, ln = lane % LPR;
  const int row_base = m0 + 64 * wg + 16 * wl;
#pragma unroll
  for (int r = sub; r < 16; r += RPP) {
    const int row = row_base + r;
    float mx = 0.f;
    if (row < M) {
      const float x = epi.row_scale(row);
#pragma unroll
      for (int c = 4 * ln; c < OW; c += 4 * LPR) {
        if (c0 + c < n_out) {  // four columns, or the ragged edge's nv
          const int col = zc + c0 + c;
          const V4 a = *reinterpret_cast<const V4*>(st + r * SROW + c);
          float4 v;
          if constexpr (Epi::kRagged) {
            const int nv = min(4, n_out - c0 - c);
            v = make_float4(epi.value(x, col, a.x), nv > 1 ? epi.value(x, col + 1, a.y) : 0.f,
                            nv > 2 ? epi.value(x, col + 2, a.z) : 0.f,
                            nv > 3 ? epi.value(x, col + 3, a.w) : 0.f);
          } else if constexpr (Epi::kPaired) {
            const V4 b = *reinterpret_cast<const V4*>(st + r * SROW + HN + c);
            v = make_float4(epi.value(x, col, a.x, b.x), epi.value(x, col + 1, a.y, b.y),
                            epi.value(x, col + 2, a.z, b.z), epi.value(x, col + 3, a.w, b.w));
          } else {
            v = make_float4(epi.value(x, col, a.x), epi.value(x, col + 1, a.y),
                            epi.value(x, col + 2, a.z), epi.value(x, col + 3, a.w));
          }
          if constexpr (Epi::kRowMax) {
            mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
          }
          if constexpr (Epi::kRagged) {
            epi.store(row, col, v, min(4, n_out - c0 - c));
          } else {
            epi.store4(row, col, v);
          }
        }
      }
    }
    if constexpr (Epi::kRowMax) {  // over the row's LPR lanes
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (ln == 0 && row < M) epi.row_max(row, mx);
    }
  }
}

// blockIdx.x = z * tiles + column tile: a stacked GEMM (gridDim.x a multiple
// of the column tiles) takes B matrix z of tm_b0, tm_b1, tm_b2 for both
// halves; a paired one takes tm_b0 and tm_b1 as its halves.
template <int NHALF, int HN, int MINB, class Epi>
__global__ void __launch_bounds__(kThreads, MINB)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b0,
                 const __grid_constant__ CUtensorMap tm_b1,
                 const __grid_constant__ CUtensorMap tm_b2, int M, int n_out, int K,
                 const Epi epi) {
  using G = GemmShape<NHALF, HN, MINB>;
  static_assert(!Epi::kPaired || NHALF == 2, "a paired GEMM takes two B matrices");
  static_assert(!(Epi::kRagged && Epi::kPaired), "a ragged edge for plain GEMMs only");
  constexpr int OW = Epi::kPaired ? HN : NHALF * HN;  // output columns of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* staged = reinterpret_cast<int*>(smem_raw + (base - raw));
  const uint32_t full0 = base + G::STAGES * G::STAGE, empty0 = full0 + 8 * G::STAGES;
  const int tiles = (n_out + OW - 1) / OW;
  const int z = blockIdx.x / tiles;
  const int m0 = blockIdx.y * kBM, c0 = (blockIdx.x - z * tiles) * OW;
  const int nk = (K + kBK - 1) / kBK;
  const int warp = sm90::warp_index(), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 4 * kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp
    if (lane == 0) {
      const CUtensorMap* bz = z == 0 ? &tm_b0 : z == 1 ? &tm_b1 : &tm_b2;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G::STAGES;
        const uint32_t a_tile = base + s * G::STAGE, full = full0 + 8 * s;
        sm90::mbar_wait(empty0 + 8 * s, ((kt / G::STAGES) & 1) ^ 1);
        sm90::mbar_arrive_tx(full, G::STAGE);
        sm90::tma_load_2d(a_tile, &tm_a, full, kt * kBK, m0);
#pragma unroll
        for (int h = 0; h < NHALF; ++h) {
          sm90::tma_load_2d(a_tile + G::A_BYTES + h * G::HALF_BYTES,
                            Epi::kPaired ? (h == 0 ? &tm_b0 : &tm_b1) : bz, full, kt * kBK,
                            Epi::kPaired ? c0 : c0 + h * HN);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
  };
  int acc[NHALF][HN / 2];
#pragma unroll
  for (int h = 0; h < NHALF; ++h)
#pragma unroll
    for (int i = 0; i < HN / 2; ++i) acc[h][i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G::STAGES;
    sm90::mbar_wait(full0 + 8 * s, (kt / G::STAGES) & 1);
    const uint32_t a_tile = base + s * G::STAGE;
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const uint64_t da = sm90::desc_kmajor(a_tile, kBM, 64 * wg, kk);
#pragma unroll
      for (int h = 0; h < NHALF; ++h) {
        const uint64_t db =
            sm90::desc_kmajor(a_tile + G::A_BYTES + h * G::HALF_BYTES, HN, 0, kk);
        if constexpr (HN == 128) {
          sm90::wgmma_ss_s8_n128(acc[h], da, db);
        } else {
          sm90::wgmma_ss_s8_n64(acc[h], da, db);
        }
      }
    }
    sm90::wg_commit();
    sm90::wg_wait<1>();  // the previous k-tile's products are done with its stage
    if (kt > 0) release((kt - 1) % G::STAGES);
  }
  sm90::wg_wait<0>();
#pragma unroll
  for (int h = 0; h < NHALF; ++h) sm90::reg_fence(acc[h]);
  release((nk - 1) % G::STAGES);

  // every product of both warpgroups is done: the ring is free for staging
  consumers_sync();
  store_tile<NHALF, HN, G::SROW>(acc, staged, epi, m0, c0, z * n_out, M, n_out);
}

// A (M, K) int8 row-major with rows lda bytes apart; B[0..nz) (nb rows of
// K each, rows ldb bytes apart). nz = 1: one GEMM; a paired or two-half
// GEMM reads B[0] and B[1] (B[1] may equal B[0]). nz = 2 or 3: a stacked
// GEMM, nz plain GEMMs over the same A in one grid, matrix z's columns seen
// by the epilogue as z * n_out + c. n_out: the epilogue's columns of one
// matrix (N of a plain GEMM, nb of a paired one). Needs K, lda, ldb and
// n_out multiples of 16 and 16-byte aligned bases; returns 0, a
// cudaError_t, -3 (shape) or -4 (a tensor map refused). (n_out may be any
// width >= 1 for an Epi::kRagged epilogue.)
template <int NHALF, int MINB = 1, int HN = 128, class Epi>
int launch_gemm_sm90_stacked(const int8_t* A, long long lda, const int8_t* const* B, int nz,
                             long long ldb, int nb, int M, int n_out, int K, const Epi& epi,
                             cudaStream_t stream) {
  using G = GemmShape<NHALF, HN, MINB>;
  constexpr int OW = Epi::kPaired ? HN : NHALF * HN;
  if (M < 1 || K < 16 || K % 16 || lda % 16 || ldb % 16 || nb < 1 || n_out < 1) return -3;
  if (n_out % 16 && !Epi::kRagged) return -3;
  if (nz < 1 || nz > 3 || (nz > 1 && Epi::kPaired)) return -3;
  const int mt = (M + kBM - 1) / kBM;
  if (mt > 65535) return -3;
  // {K, rows} int8 maps read in boxes of 128 bytes by 128 (A) or HN (B)
  // rows, 128-byte swizzle
  const cuuint32_t abox[2] = {kBK, kBM};
  const cuuint32_t bbox[2] = {kBK, HN};
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t astride[1] = {(cuuint64_t)lda};
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)nb};
  const cuuint64_t bstride[1] = {(cuuint64_t)ldb};
  CUtensorMap ma, mb[3];
  if (!sm90::encode_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, A, adims, astride, abox,
                        CU_TENSOR_MAP_SWIZZLE_128B)) {
    return sm90::kTmaRejected;
  }
  const int nmaps = nz > 1 ? nz : 2;
  for (int i = 0; i < 3; ++i) {
    if (!sm90::encode_map(&mb[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, B[i < nmaps ? i : 0],
                          bdims, bstride, bbox, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return sm90::kTmaRejected;
    }
  }
  const auto kern = gemm_sm90_kernel<NHALF, HN, MINB, Epi>;
  const int rc = sm90::set_smem(kern, G::SMEM);
  if (rc != 0) return rc;
  const int tiles = (n_out + OW - 1) / OW;
  kern<<<dim3(nz * tiles, mt), kThreads, G::SMEM, stream>>>(ma, mb[0], mb[1], mb[2], M, n_out,
                                                            K, epi);
  return static_cast<int>(cudaGetLastError());
}

// One GEMM over B0 (and B1, which a paired or two-half GEMM reads and which
// may equal B0): launch_gemm_sm90_stacked with nz = 1.
template <int NHALF, int MINB = 1, int HN = 128, class Epi>
int launch_gemm_sm90(const int8_t* A, long long lda, const int8_t* B0, const int8_t* B1,
                     long long ldb, int nb, int M, int n_out, int K, const Epi& epi,
                     cudaStream_t stream) {
  const int8_t* const b[2] = {B0, B1};
  return launch_gemm_sm90_stacked<NHALF, MINB, HN>(A, lda, b, 1, ldb, nb, M, n_out, K, epi,
                                                   stream);
}

// A plain GEMM in 128 x 256 tiles where the product is deep (K >= 2048)
// and the grid holds at least four waves of the card's SMs, else in 128 x
// 128 tiles, two blocks an SM: the wider tile reads a third less from L2
// per product (the tower's fc2, K 4304: 0.61 against 0.77 ms in 128 x 128
// tiles, one block an SM; #8's, 0.55 against 0.63 at two blocks), the
// narrower one fills the last wave of a small grid (the LM's down
// projection, 74 x 4 wide tiles for 132 SMs: 0.081 against 0.107 ms wide)
// and runs one block's epilogue beside the other's products, which a
// shallow product needs (K 1152: #8's fc1 0.65 against 0.73 ms wide, #5's
// out-projection 0.23 against 0.32; PERF.md §6).
template <class Epi>
int launch_gemm_sm90_by_shape(const int8_t* A, long long lda, const int8_t* B, long long ldb,
                              int nb, int M, int n_out, int K, const Epi& epi,
                              cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long wide_tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((n_out + 255) / 256);
  if (K >= 2048 && wide_tiles >= 4LL * sms) {
    return launch_gemm_sm90<2, 1>(A, lda, B, B, ldb, nb, M, n_out, K, epi, stream);
  }
  return launch_gemm_sm90<1, 2>(A, lda, B, B, ldb, nb, M, n_out, K, epi, stream);
}

// The epilogue of a projection back to an activation:
//   out = [residual +] (acc * sx[row] * s[col] [+ bias[col]])
// left to right in fp32 (__fmul_rn / __fadd_rn, so that nvcc forms no FMA
// that the plain versions do not), cast once to T. bias and residual may
// be null; out and residual are (M, N) row-major. RAGGED takes any N (see
// Epi::kRagged): a step of four columns whose row base is 4-aligned
// leaves as one vector, any other (N % 4 != 0, or the last columns) an
// element at a time.
template <typename T, bool RAGGED = false>
struct RowScaleOut {
  static constexpr bool kRowMax = false;
  static constexpr bool kPaired = false;
  static constexpr bool kRagged = RAGGED;
  const float* sx;
  const float* s;
  const float* bias;
  const T* residual;
  T* out;
  int N;

  __device__ __forceinline__ float row_scale(int row) const { return sx[row]; }
  __device__ __forceinline__ float value(float x, int col, int a) const {
    const float y = __fmul_rn(__fmul_rn(static_cast<float>(a), x), s[col]);
    return bias != nullptr ? __fadd_rn(y, bias[col]) : y;
  }
  __device__ void row_max(int, float) const {}
  __device__ __forceinline__ void store4(int row, int col, float4 v) const {
    const long long off = static_cast<long long>(row) * N + col;
    if (residual != nullptr) {  // four elements in one 8- or 16-byte load
      float r[4];
      if constexpr (sizeof(T) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(residual + off);
        r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
      } else {  // a bf16 is the high half of its float
        const uint2 x = *reinterpret_cast<const uint2*>(residual + off);
        r[0] = __uint_as_float(x.x << 16), r[1] = __uint_as_float(x.x & 0xffff0000u);
        r[2] = __uint_as_float(x.y << 16), r[3] = __uint_as_float(x.y & 0xffff0000u);
      }
      v.x = __fadd_rn(r[0], v.x);
      v.y = __fadd_rn(r[1], v.y);
      v.z = __fadd_rn(r[2], v.z);
      v.w = __fadd_rn(r[3], v.w);
    }
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(out + off) = v;
    } else {
      *reinterpret_cast<uint2*>(out + off) = make_uint2(pack_bf16x2(v.x, v.y),
                                                        pack_bf16x2(v.z, v.w));
    }
  }
  __device__ __forceinline__ void store(int row, int col, float4 v, int nv) const {
    const long long off = static_cast<long long>(row) * N + col;
    if (nv == 4 && (off & 3) == 0) {
      store4(row, col, v);
      return;
    }
    const float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // unrolled, so that y stays in registers
      if (j < nv) {
        const float r = residual != nullptr
                            ? __fadd_rn(int8k::to_float(residual[off + j]), y[j]) : y[j];
        if constexpr (sizeof(T) == 4) {
          out[off + j] = r;
        } else {
          out[off + j] = __float2bfloat16_rn(r);
        }
      }
    }
  }
};

}  // namespace int8h
