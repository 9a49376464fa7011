"""Clip -> answer: the main path of the port (counterpart of
`bench.py::build_pipeline` without its no-memory and sampling modes).

SigLIP tower over the frames -> projector -> 2x2 pool -> temporal PE ->
recurrent memory over 32-frame segments -> fuser -> prompt splice -> Qwen2
prefill -> (with `kv_int8`, the cache quantized to int8) -> greedy decode
of `max_new_tokens` tokens. The int8 serving configuration is this path
with int8-prequantized weights (`int8_serving_params`), `tower_int8` set
and `kv_int8=True`, as `bench.py` runs by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, siglip, vlm

NUM_FRAMES = 64
MAX_NEW_TOKENS = 32


def int8_serving_params(params):
    """`bench.py`'s default 0.5B serving weights from float ones: the tower
    prequantized to int8, the LM to int8 with an int8 copy of the
    unembedding. Pair with `tower_int8=True` and `kv_int8=True`."""
    return {**params,
            "vision_tower": siglip.prequantize_int8(params["vision_tower"]),
            "language_model": qwen2.prequantize_int8(params["language_model"],
                                                     include_unembed=True)}


def build_pipeline(cfg: VLMConfig, num_frames: int = NUM_FRAMES, *,
                   kv_int8: bool = False, return_logits: bool = False,
                   max_new_tokens: int = MAX_NEW_TOKENS):
    """Returns (clip_to_answer, nseg).

    `clip_to_answer(params, pixels, text_before, text_after)` takes
    (num_frames, H, W, 3) NHWC pixels and the prompt's token ids around the
    video, and returns (tokens (max_new_tokens, 1) int32, spliced length s).
    With `return_logits` it also returns the fp32 logits each token was
    picked from, (max_new_tokens, 1, V): row 0 is the prefill logits.
    Frames pad to the 32-frame segment multiple with a validity mask, and
    the spliced memory length clamps at the ring cache's capacity."""
    mcfg = cfg.memory
    fmax = vlm.pad_frames_to_segment_multiple(num_frames, mcfg.segment_frames)
    nseg = min(fmax // mcfg.segment_frames, mcfg.cache_cap)
    fine_idx = torch.from_numpy(vlm.fine_frame_indices(num_frames, mcfg.num_fine_frames))
    frame_valid = torch.arange(fmax) < num_frames  # host side: steers the memory loop

    def clip_to_answer(params, pixels, text_before, text_after):
        dev = pixels.device
        lm = params["language_model"]
        feats = vlm.encode_frames(params, cfg, pixels)  # (num_frames, 196, H)
        if fmax != num_frames:  # the tower runs real frames; features pad
            feats = F.pad(feats, (0, 0, 0, 0, 0, fmax - num_frames))
        visual = vlm.build_video_embeds(params, cfg, feats, torch.arange(fmax, device=dev),
                                        frame_valid, fine_idx, nseg)
        embeds = vlm.splice_image_embeds(params, text_before, visual, text_after)
        s = embeds.shape[0]
        smax = ((s + 127) // 128) * 128
        padded = F.pad(embeds, (0, 0, 0, smax - s))[None]
        valid = torch.full((1,), s, dtype=torch.int32, device=dev)
        positions = torch.arange(smax, device=dev)[None]
        hidden, cache = qwen2.forward(lm, cfg.lm, padded, positions, valid_len=valid,
                                      cache_max_len=smax + max_new_tokens)
        logits = qwen2.unembed(lm, hidden[:, s - 1:s])[:, 0]
        if kv_int8:
            cache = qwen2.quantize_cache(cache)
        tokens, step_logits = [], []
        for step in range(max_new_tokens):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tokens.append(tok)
            step_logits.append(logits)
            if step + 1 == max_new_tokens:
                break  # the last token's logits are never read
            emb = qwen2.embed_tokens(lm, tok[:, None]).to(padded.dtype)
            hidden, cache = qwen2.decode_step(lm, cfg.lm, emb, cache)
            logits = qwen2.unembed(lm, hidden)[:, 0]
        tokens = torch.stack(tokens)
        if return_logits:
            return tokens, s, torch.stack(step_logits)
        return tokens, s

    return clip_to_answer, nseg
