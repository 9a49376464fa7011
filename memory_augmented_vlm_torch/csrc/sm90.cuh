// Hopper (sm_90a) building blocks shared by the port's TMA-fed wgmma kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, two_sweep.cuh, flash_merge_int8.cu,
// int8_gemm_sm90.cuh):
// shared-memory addresses, mbarriers, TMA loads, wgmma fences, the K/V rings
// of the kernels with no producer warp, shared-memory matrix descriptors,
// the wgmma shapes the kernels issue, the accumulator-to-operand repack, and
// the host-side tensor-map encoder.
//
// Layouts in shared memory are what TMA writes with a swizzle, and what the
// matching descriptor tells wgmma to read:
//   - 128-byte swizzle: rows of 128 bytes (64 bf16, or 128 int8), 8-row
//     groups 1024 bytes apart, every block of rows 1024-byte aligned. A tile
//     of R rows by D bf16 columns is D / 64 such blocks of [R][64];
//   - 32- and 64-byte swizzle: rows of 32 or 64 bytes (16 or 32 bf16),
//     8-row groups 256 or 512 bytes apart: what is left of a row past its
//     64-column blocks (columns 64..79 of a row 72 wide, the 8 past its end
//     filled with zeros by TMA; the whole row of a head dim of 32).
// A K-major operand has the reduction dim along its rows; an MN-major B
// operand has it across its rows (wgmma reads it transposed), so an
// operand needed both ways is staged once.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace mavlm {
namespace sm90 {

constexpr int kSwzCols = 64;    // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;  // bytes of one 128-byte swizzled row

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// one arrival that also raises the bytes the current phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a broken phase count) traps after ~2^26 polls, so it surfaces as a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;");
  }
}

// the barrier inits visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a box at (x, y, z, w) of a 4-d tensor map (x innermost) into shared
// memory at dst, completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y),
         "r"(z), "r"(w)
      : "memory");
}

// the same for a 3-d tensor map
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// the same for a 2-d tensor map
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// shared-memory stores by threads made visible to the async proxy (wgmma,
// TMA) before they read the same bytes
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// After wg_wait_all: the compiler sees wgmma's registers as written by the
// (synchronous-looking) asm that issued it, so reads must not move above
// the wait. Re-defining each register here pins them below it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Named barrier ID (1..15; 0 is __syncthreads) over THREADS threads.
template <int ID, int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(THREADS) : "memory");
}

// Arrive at named barrier ID without waiting (the other side bar.syncs).
template <int ID, int THREADS>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" :: "n"(ID), "n"(THREADS) : "memory");
}

// A warp is done with the tile in a ring slot that all WARPS warps of the
// block read: lane 0 counts it on the slot's counter in shared memory and
// returns true to the whole warp when it was the last of them (then this
// warp refills the slot). Each warp counts a slot's next tile only after it
// saw that tile land, so the counts of two tiles never mix.
template <int WARPS>
__device__ __forceinline__ bool last_out(unsigned int* counter) {
  __syncwarp();
  unsigned int last = 0;
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    last = atomicAdd(counter, 1u) % WARPS == WARPS - 1;
    __threadfence_block();
  }
  return __shfl_sync(0xffffffffu, last, 0) != 0;
}

// The index of this thread's warp, broadcast from lane 0 so that the
// compiler sees it as uniform across the warp: wgmma behind a branch on a
// value it cannot prove uniform is serialized (ptxas C7520).
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
}

// 2^x on the special-function unit (results below 2^-126 flush to 0: a p
// that small changes no sum).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ K/V rings

// A ring of K tiles and a ring of V tiles in shared memory, for a kernel
// with no producer warp (flash_fwd_wide_sm90.cu's head dims 256 and 448,
// flash_bwd_sm90.cu's dQ at 256, the fp32 kernels of flash_fwd.cu and
// flash_train.cu, whose dK/dV kernel rings Q and dO tiles instead). A tile
// is BN rows of a bshd tensor in CB blocks of COLS columns, loaded by TMA:
// 128-byte swizzled rows of 64 bf16 columns, or (fp32) unswizzled rows of
// ROW_BYTES, a little wider than COLS columns; tile j starts at row
// row0 + j * BN. Ring v is K (v = 0) or V (v = 1); the slots are numbered
// over both rings, K's first, and each has a full mbarrier (one arrival and
// the tile's bytes) and a counter of the warps done with its tile. One
// thread loads each ring's first tiles; after that the last warp out of a
// slot (last_out) refills it with its ring's tile `depth` ahead, so a ring
// needs no empty barrier.
template <int K_SLOTS_, int V_SLOTS_, int BN, int CB, int COLS = kSwzCols,
          int ROW_BYTES = kRowBytes>
struct KvRings {
  static constexpr int K_SLOTS = K_SLOTS_, V_SLOTS = V_SLOTS_, SLOTS = K_SLOTS + V_SLOTS;
  static constexpr uint32_t BLOCK = BN * ROW_BYTES;      // a block of COLS columns
  static constexpr uint32_t TILE_BYTES = CB * BLOCK;     // a K or V tile
  static constexpr uint32_t BYTES = SLOTS * TILE_BYTES;  // every slot's tile
  static_assert(TILE_BYTES % (ROW_BYTES == kRowBytes ? 1024 : 128) == 0,
                "1024-byte aligned swizzled blocks, 128-byte aligned plain ones");

  uint32_t tiles;           // slot 0's tile; the others follow, TILE_BYTES apart
  uint32_t full0;           // slot 0's full barrier; the others follow, 8 bytes apart
  unsigned int* counters;   // a counter per slot
  const CUtensorMap* tm_k;  // the tensor maps the tiles come from
  const CUtensorMap* tm_v;
  int head, batch;          // the KV head and batch element they read
  int row0 = 0;             // the row tile 0 starts at

  static __device__ __forceinline__ int depth(int v) { return v ? V_SLOTS : K_SLOTS; }
  static __device__ __forceinline__ int slot(int v, int j) {
    return v ? K_SLOTS + j % V_SLOTS : j % K_SLOTS;
  }
  // the parity of tile j's use of its slot
  static __device__ __forceinline__ int parity(int v, int j) { return (j / depth(v)) & 1; }
  __device__ __forceinline__ uint32_t tile(int v, int j) const {
    return tiles + slot(v, j) * TILE_BYTES;
  }
  __device__ __forceinline__ uint32_t full(int v, int j) const { return full0 + 8 * slot(v, j); }

  // the barriers and counters (one thread, before mbar_fence_init)
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      counters[i] = 0;
    }
  }
  // tile j of ring v into its slot (one thread)
  __device__ __forceinline__ void load(int v, int j) const {
    const uint32_t bar = full(v, j);
    mbar_arrive_tx(bar, TILE_BYTES);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      tma_load(tile(v, j) + c * BLOCK, v ? tm_v : tm_k, bar, COLS * c, row0 + j * BN, head,
               batch);
    }
  }
  // the first tiles of each ring, of the block's n_tiles (one thread)
  __device__ __forceinline__ void load_first(int n_tiles) const {
    for (int j = 0; j < min(n_tiles, K_SLOTS); ++j) load(0, j);
    for (int j = 0; j < min(n_tiles, V_SLOTS); ++j) load(1, j);
  }
  __device__ __forceinline__ void wait(int v, int j) const { mbar_wait(full(v, j), parity(v, j)); }
  // This warp is done with tile j of ring v, which READERS warps read: the
  // last of them refills the slot with the ring's next tile for it, when the
  // block's n_tiles hold one.
  template <int READERS>
  __device__ __forceinline__ void done_with(int v, int j, int n_tiles) const {
    const bool last = last_out<READERS>(counters + slot(v, j));
    if (last && (threadIdx.x & 31) == 0 && j + depth(v) < n_tiles) load(v, j + depth(v));
  }
};

// ------------------------------------------------------------ descriptors

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128-byte, 2: 64-byte, 3:
// 32-byte).
__device__ __forceinline__ uint64_t desc_make(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return desc_make(addr, lbo, sbo, 1);
}

// K-major operand in 128-byte swizzled blocks of `rows` rows (its rows are
// M or N, its columns the reduction dim): the 32 bytes of k-step kk (16
// bf16, or 32 int8), the 64 (A) or N (B) rows from row0. Within a swizzled
// row the k-step is a 32-byte offset of the start address; the hardware
// applies the swizzle to the address bits, as TMA did. The leading offset
// is unused; 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int row0, int kk) {
  return desc_sw128(tile + (kk >> 2) * rows * kRowBytes + row0 * kRowBytes + (kk & 3) * 32,
                    16, 1024);
}

// MN-major B operand (its rows are the reduction dim, its columns N): rows
// 16 * kk .. 16 * kk + 15 of one 64-column block of a [rows][D] tile. The
// leading offset steps to the next 64-column block (products here take N
// <= 64 from one block), the stride offset steps 8 rows.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

// The same two for a narrow block of 32- or 64-byte rows (16 or 32 bf16),
// swizzled by its row width: K-major, k-step kk of a row (32 bytes each);
// MN-major, the 16 rows of k-step kk.
__device__ __forceinline__ uint64_t desc_kmajor_narrow(uint32_t block, int row_bytes, int kk) {
  return desc_make(block + kk * 32, 16, 8 * row_bytes, row_bytes == 32 ? 3 : 2);
}
__device__ __forceinline__ uint64_t desc_mnmajor_narrow(uint32_t block, int rows, int row_bytes,
                                                        int kk) {
  return desc_make(block + kk * 16 * row_bytes, rows * row_bytes, 8 * row_bytes,
                   row_bytes == 32 ? 3 : 2);
}

// ------------------------------------------------------------ wgmma shapes

// D(64 x 64, fp32) = A(64 x 16) B(16 x 64) (+ D when `accumulate`); A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D(64 x 32, fp32) = A(64 x 16) B(16 x 32) (+ D when `accumulate`); A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D(64 x 64, fp32) (+)= A(64 x 16, bf16 in registers) B(16 x 64); B from shared
// memory, K-major (TB = 0) or MN-major (TB = 1); `accumulate` 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB)
      : "memory");
}

// D(64 x 16, fp32) (+)= A(64 x 16, bf16 in registers) B(16 x 16); B from shared
// memory, K-major (TB = 0) or MN-major (TB = 1); `accumulate` 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB)
      : "memory");
}

// D(64 x 32, fp32) (+)= A(64 x 16, bf16 in registers) B(16 x 32); B from shared
// memory, K-major (TB = 0) or MN-major (TB = 1); `accumulate` 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB)
      : "memory");
}

// D(64 x 64, s32) (+)= A(64 x 32, s8 in registers) B(32 x 64); B K-major in
// shared memory (the only layout of 8-bit wgmma); `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D(64 x 80, s32) (+)= A(64 x 32, s8 in registers) B(32 x 80); B K-major in
// shared memory (the only layout of 8-bit wgmma); `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_s8(int (&d)[40], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D(64 x 128, s32) (+)= A(64 x 32, s8 in registers) B(32 x 128); B K-major in
// shared memory (the only layout of 8-bit wgmma); `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// D(64 x 128, s32) += A(64 x 32, s8) B(32 x 128); A and B K-major in shared
// memory. It always accumulates: scale-d is the constant 1, which ptxas
// folds (an 8-bit product whose scale-d is a run-time register is
// serialised, one WARPGROUP.DEPBAR after each), so the caller zeroes D
// before the first product.
__device__ __forceinline__ void wgmma_ss_s8_n128(int (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// D(64 x 64, s32) += A(64 x 32, s8) B(32 x 64): wgmma_ss_s8_n128's narrow
// twin.
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// ------------------------------------------------ accumulator to operand

// The accumulator of a 64 x 64 product, rounded to bf16, as the register A
// operand of the next product (k-step kk takes columns 16 kk .. 16 kk + 15):
// a thread holds columns {2t, 2t + 1} of each 8-column chunk in rows g and
// g + 8, which is the A fragment's layout.
__device__ __forceinline__ void acc_to_a(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
  }
}

// The same for the accumulator of a 64 x 32 product: two k-steps.
__device__ __forceinline__ void acc_to_a(const float (&c)[16], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------ host

constexpr int kTmaRejected = -4;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query, so the library needs no link to libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// A tensor map of `rank` dims (dims[0] innermost, contiguous; strides in
// bytes for dims 1..rank-1), read in boxes of `box` elements, with a
// swizzle; elements past any dim's end read as zeros.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-d map {D, S, H, B} of a bshd bf16 tensor (strides in elements: batch,
// sequence, head), read in boxes of `rows` rows by `cols` columns (64 with
// the 128-byte swizzle, 16 with the 32-byte one).
inline bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
                     const long long* st, int rows, int cols = kSwzCols,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box, swizzle);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace sm90
}  // namespace mavlm
