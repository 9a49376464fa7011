"""Temporal positional encoding over frames (counterpart of
`memory_augmented_vlm_tpu/models/position_encoding.py`): the fixed
sinusoidal table, added per frame at the frame's original sampled index."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_table(max_frames: int, embed_dim: int) -> np.ndarray:
    """pe[p, 2i] = sin(p * exp(-2i ln(1e4)/d)), pe[p, 2i+1] = cos(...)."""
    pe = np.zeros((max_frames, embed_dim), dtype=np.float32)
    position = np.arange(max_frames, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, embed_dim, 2, dtype=np.float32) * -(np.log(10000.0) / embed_dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return pe


def init_params(max_frames: int, embed_dim: int, device, dtype=torch.float32):
    """The frozen table on `device`: the caller names it, there is no default."""
    table = torch.from_numpy(sinusoidal_table(max_frames, embed_dim))
    return {"frame_embed": table.to(device=device, dtype=dtype)}


def add_temporal_pe(params, features: torch.Tensor, frame_indices: torch.Tensor) -> torch.Tensor:
    """features (T, N, C); frame_indices (T,) int, clamped into the table."""
    if features.dim() != 3:
        raise ValueError(f"expected (T, N, C) features, got {tuple(features.shape)}")
    table = params["frame_embed"]
    idx = frame_indices.clamp(0, table.shape[0] - 1)
    return features + table[idx].to(features.dtype)[:, None, :]
