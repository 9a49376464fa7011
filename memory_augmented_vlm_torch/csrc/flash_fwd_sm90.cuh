// The flash-attention forward kernels as the two entry points that take
// them call them, flash_fwd (flash_fwd.cu) with lse null and flash_fwd_lse
// (flash_train.cu): bf16 flash_fwd_sm90.cu's (flash_fwd_wide_sm90.cu's at
// head dims 256 and 448), fp32 flash_fwd.cu's 3xTF32 kernel.

#pragma once

namespace mavlm {
namespace fwd_sm90 {

struct Args {
  const void* q;          // (B, Sq, H, D) bf16 or fp32
  const void* k;          // (B, Skv, H / kv_groups, D)
  const void* v;
  void* o;                // (B, Sq, H, D)
  void* lse;              // (B, H, Sq) fp32, or null
  const void* valid_len;  // (B,) int32
  const void* items;      // (n_items, 3) int32: batch, query head, tile of block_rows rows
  int n_items, block_rows, B, Sq, Skv, H, kv_groups, causal;
  // (batch, sequence, head) strides in elements; q's, k's and v's also go
  // into TMA tensor maps, so a dim of size 1 must have a valid one (16 bytes)
  long long q_st[3], k_st[3], v_st[3], o_st[3];
  float scale_log2;
};

// Launches one block per item; returns 0, a cudaError_t, -1 for a head dim
// or -3 for block rows it was not built for, or -4 when a tensor map is
// refused. Head dims 256 and 448 run flash_fwd_wide_sm90.cu's kernel.
int run(const Args& a, int head_dim, void* stream);

}  // namespace fwd_sm90

// The wide-head kernel of flash_fwd_wide_sm90.cu: bf16, head dims 256 (the
// Gemma LM and the memory at its hidden size of 2048 over 8 heads; with
// the lse epilogue for training) and 448 (the 7B memory: hidden 3584 over
// 8 heads; no lse). Its online softmax takes key tiles of key_tile(D)
// keys; a block takes block_rows(D) query rows: 128 at 256 (two consumer
// warpgroups of 64 rows each), 64 at 448.
namespace fwd_wide {

constexpr bool is_head_dim(int d) { return d == 256 || d == 448; }
constexpr int key_tile(int d) { return d == 448 ? 32 : 64; }
constexpr int block_rows(int d) { return d == 256 ? 128 : 64; }

// As fwd_sm90::run at a head dim of is_head_dim: -1 when an lse is asked
// for at 448, -3 for block rows other than block_rows(head_dim).
int run(const fwd_sm90::Args& a, int head_dim, void* stream);

}  // namespace fwd_wide

// The fp32 kernel of flash_fwd.cu (3xTF32 on mma.sync), which reads no
// items: head dims 64, 72, 112, 128, 256 and 448, or with an lse 64, 128
// and 256; as fwd_sm90::run otherwise (-1 for another head dim).
namespace fwd_f32 {

int run(const fwd_sm90::Args& a, int head_dim, void* stream);

}  // namespace fwd_f32
}  // namespace mavlm
