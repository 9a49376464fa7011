"""Spatial pooling (counterpart of `memory_augmented_vlm_tpu/ops/pooling.py`).

The flagship path pools 729 -> 196 tokens per frame with PyTorch's bilinear
`align_corners=False` resize to ceil(side / 2). As in the JAX package the
resize is written as two small matmuls against precomputed row-stochastic
weight matrices, so both packages do the same fp32 arithmetic.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix of bilinear `align_corners=False` source
    weights (half-pixel centers clamped at zero, edge-clamped neighbour)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        i0 = min(int(math.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        w[i, i0] += 1.0 - frac
        w[i, i1] += frac
    return w


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), fp32 math."""
    h, w = x.shape[-3], x.shape[-2]
    wh = torch.from_numpy(_bilinear_weight_matrix(h, out_h)).to(x.device)
    ww = torch.from_numpy(_bilinear_weight_matrix(w, out_w)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x.float())
    y = torch.einsum("pw,...owc->...opc", ww, y)
    return y.to(x.dtype)


def spatial_pool_2x2(features: torch.Tensor, patches_per_side: int,
                     stride: int = 2) -> torch.Tensor:
    """Bilinear (frames, side*side, dim) -> (frames, ceil(side/stride)**2, dim)."""
    f, p, d = features.shape
    side = patches_per_side
    if p != side * side:
        raise ValueError(f"expected {side * side} patches, got {p}")
    out = math.ceil(side / stride)
    img = bilinear_resize(features.reshape(f, side, side, d), out, out)
    return img.reshape(f, -1, d)
