"""SigLIP-SO400M vision tower (counterpart of
`memory_augmented_vlm_tpu/models/siglip.py`: its bf16/fp32 path and its
fused int8 path).

The tower drops its final encoder layer and skips the post-layernorm, so the
output equals `hidden_states[-2]`. Patch embedding is a 14x14 stride-14 conv
to 729 patches plus learned position embeddings. Pixels are NHWC, as in the
JAX package.

A layer with float `kernel` entries is pre-LN attention through the flash
kernel (non-causal, every key valid) and a tanh-GELU MLP. A layer
prequantized by `prequantize_int8` (`kernel_int8` entries, the serving
configuration) runs the fused int8 path of the JAX tower:
`fused_qkv_int8` (LN1 + row quant + int8 q/k/v, head-major bf16) ->
`flash_attention_merge_heads` -> `int8_linear(out_proj)` + residual ->
`fused_mlp_block_int8` (LN2 + int8 MLP + residual). With
`forward(fused_oproj=True)` the two middle steps are one kernel,
`flash_attention_out_proj_int8` (attention + int8 out-projection +
residual), so every layer is three launches. Unlike JAX, which takes these
paths on a TPU above a size gate and pads the stream from 729 to 736 rows
(to 768 with `fused_oproj`, so that its blocks are lane-aligned), the port
takes them for every int8 layer and pads nothing: its kernels mask ragged
edges themselves. On the CPU each kernel wrapper runs its plain version.

Parameters: `patch_embedding.weight` is (out, in, kh, kw) for `F.conv2d`;
dense kernels are (in, out), int8 kernels (in, out) column-major
(`ops/quant.py`); `layers` is a list with one dict per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VisionConfig
from memory_augmented_vlm_torch.ops.attention import flash_attention
from memory_augmented_vlm_torch.ops.flash import (flash_attention_merge_heads,
                                                  flash_attention_out_proj_int8)
from memory_augmented_vlm_torch.ops.mlp_int8 import fused_mlp_block_int8
from memory_augmented_vlm_torch.ops.norms import layer_norm
from memory_augmented_vlm_torch.ops.qkv_int8 import fused_qkv_int8
from memory_augmented_vlm_torch.ops.quant import int8_linear, prequantize_kernel

_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


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


def prequantize_int8(params):
    """Static-scale int8 weights for the frozen tower (JAX
    `siglip.prequantize_int8`): each layer's six dense kernels become
    per-output-channel int8 (`kernel_int8`, column-major) with an fp32
    `scale`; biases, norms and the patch embedding stay as they are."""
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in _PROJECTIONS:
            wq, scale = prequantize_kernel(lp[name]["kernel"])
            lp[name] = {"kernel_int8": wq, "scale": scale, "bias": lp[name]["bias"]}
        layers.append(lp)
    return {**params, "layers": layers}


def _linear(p, x):
    return x @ p["kernel"] + p["bias"]


def _int8_layer(lp, cfg: VisionConfig, hidden: torch.Tensor,
                fused_oproj: bool) -> torch.Tensor:
    b, s, h = hidden.shape
    q, k, v = fused_qkv_int8(
        hidden, lp["layer_norm1"]["weight"], lp["layer_norm1"]["bias"],
        *(lp[name][key] for name in ("q_proj", "k_proj", "v_proj")
          for key in ("kernel_int8", "scale", "bias")),
        nh=cfg.num_attention_heads, eps=cfg.layer_norm_eps)
    valid = torch.full((b,), s, dtype=torch.int32, device=hidden.device)
    if fused_oproj:
        op = lp["out_proj"]
        hidden = flash_attention_out_proj_int8(q, k, v, valid, hidden, op["kernel_int8"],
                                               op["scale"], op["bias"])
    else:
        hidden = hidden + int8_linear(lp["out_proj"],
                                      flash_attention_merge_heads(q, k, v, valid))
    out = fused_mlp_block_int8(
        hidden.reshape(b * s, h), lp["layer_norm2"]["weight"], lp["layer_norm2"]["bias"],
        lp["fc1"]["kernel_int8"], lp["fc1"]["scale"], lp["fc1"]["bias"],
        lp["fc2"]["kernel_int8"], lp["fc2"]["scale"], lp["fc2"]["bias"],
        eps=cfg.layer_norm_eps)
    return out.reshape(b, s, h)


def embed_patches(params, cfg: VisionConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, 729, hidden), contiguous whatever the
    pixels' strides: the conv's output takes its input's memory layout, and
    the int8 layers' kernels take contiguous rows only."""
    pe = params["patch_embedding"]
    x = pixel_values.permute(0, 3, 1, 2)
    out = F.conv2d(x, pe["weight"].to(x.dtype), pe["bias"].to(x.dtype),
                   stride=cfg.patch_size)
    out = out.flatten(2).transpose(1, 2)  # (B, side*side, hidden), row-major
    return (out + params["position_embedding"].to(out.dtype)).contiguous()


def forward(params, cfg: VisionConfig, pixel_values: torch.Tensor, *,
            int8: bool = False, fused_oproj: bool = False) -> torch.Tensor:
    """(B, H, W, C) pixels -> (B, 729, hidden) features. Prequantized layers
    take the fused int8 path; `int8=True` with float kernels would be JAX's
    dynamic (AQT) int8 path, which is not ported.

    `fused_oproj` folds each prequantized layer's out-projection and
    residual into its attention kernel (JAX's opt-in of the same name). JAX
    pads the residual stream to 768 rows for this mode, a TPU lane
    workaround that is not ported: the stream stays at 729 rows. Float
    layers ignore the flag, as in JAX."""
    hidden = embed_patches(params, cfg, pixel_values)
    b, s, h = hidden.shape
    nh = cfg.num_attention_heads
    for lp in params["layers"]:
        if "kernel_int8" in lp["q_proj"]:
            hidden = _int8_layer(lp, cfg, hidden, fused_oproj)
            continue
        if int8:
            raise NotImplementedError("dynamic int8 (int8=True with float kernels) is not "
                                      "ported: prequantize the tower with prequantize_int8")
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
