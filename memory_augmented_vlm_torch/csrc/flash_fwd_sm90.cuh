// The bf16 flash-attention forward of flash_fwd_sm90.cu (and of
// flash_fwd_wide_sm90.cu at head dim 448), as the two entry points that take
// it call it: flash_fwd (flash_fwd.cu) with lse null, and flash_fwd_lse
// (flash_train.cu).

#pragma once

namespace mavlm {
namespace fwd_sm90 {

struct Args {
  const void* q;          // (B, Sq, H, D) bf16
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
// refused. Head dim 448 runs flash_fwd_wide_sm90.cu's kernel.
int run(const Args& a, int head_dim, void* stream);

}  // namespace fwd_sm90

// The wide-head kernel of flash_fwd_wide_sm90.cu: bf16, head dim 448 (the
// 7B memory: hidden 3584 over 8 heads), no lse. Its online softmax takes
// key tiles of kKeyTile keys; a block takes kBlockRows query rows.
namespace fwd_wide {

constexpr int kHeadDim = 448;
constexpr int kKeyTile = 32;
constexpr int kBlockRows = 64;

// As fwd_sm90::run at head dim 448: -1 when an lse is asked for, -3 for
// other block rows.
int run(const fwd_sm90::Args& a, void* stream);

}  // namespace fwd_wide
}  // namespace mavlm
