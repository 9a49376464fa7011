"""Attention ops (counterpart of `memory_augmented_vlm_tpu/ops/attention.py`).

  - `mha_attention`    : general batched attention with fp32 softmax, plain
                         torch (plain XLA in the JAX package).
  - `flash_attention`  : prefill/cross attention through `ops/flash.py` — the
                         CUDA kernel for CUDA tensors, its plain version for
                         CPU tensors. No size gate: every call site uses it.
                         With `differentiable=True` (training) it takes
                         `ops/flash_bwd.flash_attention_train` instead.
  - `decode_attention` : single-query attention against a padded KV cache,
                         GQA-native, plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from memory_augmented_vlm_torch.ops import flash, flash_bwd

NEG_INF = -1e30  # finite large-negative, as in the JAX package


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, causal: bool = False
                  ) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, H, D); mask broadcastable to
    (B, H, Sq, Sk), True = attend. Returns (B, Sq, H, D) in q.dtype.

    As in JAX, bf16 inputs form their logits in bf16 and fp32 inputs in fp32;
    the softmax is fp32 either way."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    if dtype == torch.bfloat16:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = (logits * scale).float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D), HF repeat_kv order."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: torch.Tensor, *, kv_groups: int = 1) -> torch.Tensor:
    """q (B, 1, H, D); k/v_cache (B, Smax, Hkv, D) of which the first
    `cache_len[b]` positions are valid. Query heads are grouped against
    their KV head, so the cache is never repeated. fp32 logits."""
    dtype = q.dtype
    b, sq, h, d = q.shape
    scale = d ** -0.5
    hkv = k_cache.shape[2]
    qg = q.reshape(b, sq, hkv, kv_groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    valid = torch.arange(k_cache.shape[1], device=q.device) < cache_len[:, None]
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(dtype), v_cache)
    return out.reshape(b, sq, h, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    kv_groups: int = 1,
                    differentiable: bool = False) -> torch.Tensor:
    """Flash attention for prefill and cross-attention: q (B, Sq, H, D),
    k/v (B, Skv, H // kv_groups, D), kv_valid_len (B,) int32.
    `differentiable=True` selects the training kernels (forward with lse,
    dQ and dK/dV kernels), as the JAX package does for its train step;
    otherwise the forward kernel, whose backward is a plain recompute."""
    fn = flash_bwd.flash_attention_train if differentiable else flash.flash_attention
    return fn(q, k, v, kv_valid_len, causal=causal, scale=scale, kv_groups=kv_groups)
