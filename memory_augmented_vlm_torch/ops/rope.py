"""Rotary position embeddings, HF Qwen2 `rotate_half` convention
(counterpart of `memory_augmented_vlm_tpu/ops/rope.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


def compute_rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """inv_freq[j] = theta^(-2j/d), shape (head_dim // 2,), fp32 (no RoPE
    scaling), made on `device`: the caller names it, there is no default."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos, sin (..., head_dim) fp32, laid out as
    [f0..f_{d/2-1}, f0..f_{d/2-1}] (concat, not interleave)."""
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim); cos/sin (..., seq, head_dim),
    broadcast over the heads axis."""
    cos = cos[..., :, None, :].to(x.dtype)
    sin = sin[..., :, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin
