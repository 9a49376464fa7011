"""Video assembly of the full model (counterpart of the video path of
`memory_augmented_vlm_tpu/models/vlm.py`).

SigLIP tower -> mlp2x_gelu projector -> 2x2 bilinear pool -> temporal PE ->
recurrent memory -> memory fuser -> token-type embeds -> `one_token` merge
with the image newline -> prompt splice. Token accounting matches the
reference: 10 memory-prompt + nseg*8*196 memory + 1 newline + 9 frame-prompt
+ nfine*196 fine + 1 newline visual tokens; without the memory
(`add_token_per_frame`), 197 per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import memory as memory_mod
from memory_augmented_vlm_torch.models import position_encoding
from memory_augmented_vlm_torch.models import projector as projector_mod
from memory_augmented_vlm_torch.models import qwen2, siglip
from memory_augmented_vlm_torch.ops.pooling import spatial_pool_2x2


def fine_frame_indices(num_frames: int, num_samples: int = 32) -> np.ndarray:
    """Rounding linspace over the sampled frames, clamped."""
    n = min(num_samples, num_frames)
    idx = np.round(np.linspace(0, num_frames - 1, n))
    return np.clip(idx, 0, num_frames - 1).astype(np.int64)


def pad_frames_to_segment_multiple(f: int, segment: int = 32) -> int:
    return ((f + segment - 1) // segment) * segment


def init_params(cfg: VLMConfig, seed: int, device, dtype=torch.float32):
    """Seeded random init of the whole model at the configured widths, with
    the JAX init's shapes and distributions. Draws happen on `device` with a
    `torch.Generator` seeded from `seed`, in fp32, then cast to `dtype`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h = cfg.lm.hidden_size

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def lin(d_in, d_out):
        return {"kernel": normal(d_in, d_out, scale=0.02),
                "bias": torch.zeros(d_out, device=device, dtype=dtype)}

    return {
        "vision_tower": siglip.init_params(cfg.vision, gen, device, dtype),
        "mm_projector": projector_mod.init_params(cfg.vision.hidden_size, h, gen, device,
                                                  dtype),
        "language_model": qwen2.init_params(cfg.lm, gen, device, dtype),
        "memory": {
            "recurrent_memory_transformer": memory_mod.init_params(
                cfg.memory, gen, device, dtype),
            "memory_fuser": {"fc1": lin(h, 4 * h), "fc2": lin(4 * h, h)},
            "token_type_embedding": normal(2, h, scale=0.02),
            "image_newline": normal(h, scale=1.0 / np.sqrt(h)),
        },
        "positional_encoding": position_encoding.init_params(
            cfg.memory.max_temporal_frames, h, device, dtype),
    }


def encode_frames(params, cfg: VLMConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(F, 384, 384, 3) NHWC pixels -> (F, 196, H) pooled projected features.

    The tower and projector run under `torch.no_grad()`, so the features
    come back detached: JAX's `stop_gradient` after the projector (the
    reference detaches vision features in training too), and the frozen
    tower keeps no activations for a backward."""
    with torch.no_grad():
        feats = siglip.forward(params["vision_tower"], cfg.vision, pixels,
                               int8=cfg.pipeline.tower_int8)
        feats = projector_mod.forward(params["mm_projector"], feats)
        return spatial_pool_2x2(feats, cfg.vision.num_patches_per_side,
                                stride=cfg.pipeline.mm_spatial_pool_stride)


def _merge_frames(feature: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """`one_token` merge of a `spatial_unpad` model: flatten the (N, P, H)
    stream and append one image-newline row."""
    h = feature.shape[-1]
    return torch.cat([feature.reshape(-1, h), newline.reshape(1, h)], dim=0)


def _embed_ids(lm_params, ids, device) -> torch.Tensor:
    return qwen2.embed_tokens(lm_params, torch.as_tensor(ids, dtype=torch.long, device=device))


def build_video_embeds(params, cfg: VLMConfig, feats: torch.Tensor,
                       frame_indices: torch.Tensor, frame_valid: torch.Tensor,
                       fine_idx: torch.Tensor, nseg: int, *,
                       drop_fine_frames: bool = False) -> torch.Tensor:
    """Memory + fine-frame visual stream with prompts, newlines and
    token-type embeds: (10 + nseg*8*196 + 1 [+ 9 + nfine*196 + 1 unless
    drop_fine_frames], H). The prompt ids, the newline and the token-type
    embeds stay in the autograd graph, as they do in JAX.

    feats (Fmax, 196, H) pooled and padded; frame_indices (Fmax,) original
    frame indices for the temporal PE; frame_valid (Fmax,) host bool;
    fine_idx (nfine,) indices into the Fmax axis; nseg <= cache cap."""
    mcfg = cfg.memory
    dev = feats.device
    feats = position_encoding.add_temporal_pe(params["positional_encoding"], feats,
                                              frame_indices)
    state = memory_mod.run_video(params["memory"]["recurrent_memory_transformer"], mcfg,
                                 feats, frame_valid)
    fused, _ = memory_mod.fuse_memory_bank(params["memory"]["memory_fuser"], state)
    mem_tokens = fused[: nseg * mcfg.num_memory_tokens]
    tte = params["memory"]["token_type_embedding"]
    mem_tokens = mem_tokens + tte[0]
    newline = params["memory"]["image_newline"].to(mem_tokens.dtype)
    lm = params["language_model"]
    mem_prompt = _embed_ids(lm, constants.MEMORY_PROMPT_IDS, dev).to(mem_tokens.dtype)
    mem_stream = [mem_prompt, _merge_frames(mem_tokens, newline)]
    if drop_fine_frames:
        return torch.cat(mem_stream, dim=0)
    fine = feats[fine_idx.to(dev)] + tte[1]
    frame_prompt = _embed_ids(lm, constants.FRAME_PROMPT_IDS, dev).to(mem_tokens.dtype)
    return torch.cat([*mem_stream, frame_prompt, _merge_frames(fine, newline)], dim=0)


def add_token_per_frame(feature: torch.Tensor, newline: torch.Tensor) -> torch.Tensor:
    """The plain video branch without the memory (`bench.py --no_memory`;
    `mm_newline_position="frame"`): the image newline after every frame's
    pooled tokens. (N, P, H) -> (N*(P+1), H)."""
    n, _, h = feature.shape
    nl = newline.reshape(1, 1, h).to(feature.dtype).expand(n, 1, h)
    return torch.cat([feature, nl], dim=1).reshape(-1, h)


def splice_image_embeds(params, text_ids_before: torch.Tensor, visual: torch.Tensor,
                        text_ids_after: torch.Tensor) -> torch.Tensor:
    """Replace the single <image> sentinel with the visual stream (batch 1)."""
    lm = params["language_model"]
    before = qwen2.embed_tokens(lm, text_ids_before.to(visual.device)).to(visual.dtype)
    after = qwen2.embed_tokens(lm, text_ids_after.to(visual.device)).to(visual.dtype)
    return torch.cat([before, visual, after], dim=0)
