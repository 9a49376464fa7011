"""SigLIP-SO400M vision tower (counterpart of
`memory_augmented_vlm_tpu/models/siglip.py`, its non-fused bf16/fp32 path).

The tower drops its final encoder layer and skips the post-layernorm, so the
output equals `hidden_states[-2]`. Patch embedding is a 14x14 stride-14 conv
to 729 patches plus learned position embeddings; each layer is pre-LN
attention through the flash kernel (non-causal, every key valid) and a
tanh-GELU MLP. Pixels are NHWC, as in the JAX package.

Parameters: `patch_embedding.weight` is (out, in, kh, kw) for `F.conv2d`;
dense kernels are (in, out); `layers` is a list with one dict per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VisionConfig
from memory_augmented_vlm_torch.ops.attention import flash_attention
from memory_augmented_vlm_torch.ops.norms import layer_norm


def init_params(cfg: VisionConfig, gen: torch.Generator, device, dtype=torch.float32):
    """Random init with the JAX init's shapes and distributions."""
    h, i = cfg.hidden_size, cfg.intermediate_size

    def dense(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ln():
        return {"weight": torch.ones(h, device=device, dtype=dtype), "bias": zeros(h)}

    def lin(d_in, d_out):
        return {"kernel": dense(d_in, d_out), "bias": zeros(d_out)}

    return {
        "patch_embedding": {
            "weight": dense(h, cfg.num_channels, cfg.patch_size, cfg.patch_size),
            "bias": zeros(h),
        },
        "position_embedding": dense(cfg.num_patches, h),
        "layers": [
            {"layer_norm1": ln(), "layer_norm2": ln(),
             "q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
             "out_proj": lin(h, h), "fc1": lin(h, i), "fc2": lin(i, h)}
            for _ in range(cfg.num_used_layers)
        ],
        "post_layernorm": ln(),
    }


def _linear(p, x):
    return x @ p["kernel"] + p["bias"]


def embed_patches(params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, 729, hidden)."""
    pe = params["patch_embedding"]
    x = pixel_values.permute(0, 3, 1, 2)
    out = F.conv2d(x, pe["weight"].to(x.dtype), pe["bias"].to(x.dtype),
                   stride=cfg.patch_size)
    out = out.flatten(2).transpose(1, 2)  # (B, side*side, hidden), row-major
    return out + params["position_embedding"].to(out.dtype)


def forward(params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, 729, hidden) features."""
    hidden = embed_patches(params, cfg, pixel_values)
    b, s, h = hidden.shape
    nh = cfg.num_attention_heads
    for lp in params["layers"]:
        if "kernel" not in lp["q_proj"]:
            raise NotImplementedError("the int8 tower is not ported")
        x = layer_norm(hidden, lp["layer_norm1"]["weight"], lp["layer_norm1"]["bias"],
                       cfg.layer_norm_eps)
        q = _linear(lp["q_proj"], x).view(b, s, nh, h // nh)
        k = _linear(lp["k_proj"], x).view(b, s, nh, h // nh)
        v = _linear(lp["v_proj"], x).view(b, s, nh, h // nh)
        attn = flash_attention(q, k, v, causal=False).reshape(b, s, h)
        hidden = hidden + _linear(lp["out_proj"], attn)
        x = layer_norm(hidden, lp["layer_norm2"]["weight"], lp["layer_norm2"]["bias"],
                       cfg.layer_norm_eps)
        x = F.gelu(_linear(lp["fc1"], x), approximate="tanh")
        hidden = hidden + _linear(lp["fc2"], x)
    return hidden
