"""Normalization ops (counterpart of `memory_augmented_vlm_tpu/ops/norms.py`).

  - `rms_norm`   : Qwen2RMSNorm — fp32 accumulation, weight applied after the
                   cast back to the input dtype.
  - `layer_norm` : torch.nn.LayerNorm — biased variance, fp32 math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    return weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)
