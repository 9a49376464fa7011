"""Multimodal projector (counterpart of
`memory_augmented_vlm_tpu/models/projector.py`), `mlp2x_gelu`: Linear,
exact GELU, Linear."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_params(in_dim: int, out_dim: int, gen: torch.Generator, device,
                dtype=torch.float32):
    def lin(d_in, d_out):
        w = torch.randn((d_in, d_out), generator=gen, device=device) * 0.02
        return {"kernel": w.to(dtype), "bias": torch.zeros(d_out, device=device, dtype=dtype)}

    return {"layers": [lin(in_dim, out_dim), lin(out_dim, out_dim)]}


def forward(params, x: torch.Tensor) -> torch.Tensor:
    first, second = params["layers"]
    x = F.gelu(x @ first["kernel"] + first["bias"])
    return x @ second["kernel"] + second["bias"]
