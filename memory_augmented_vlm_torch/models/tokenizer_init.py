"""Vision-token tokenizer initialization over the port's LM tree
(counterpart of `memory_augmented_vlm_tpu/models/tokenizer_init.py`).

Capability parity with `initialize_vision_tokenizer` (llava_arch.py:924-965):
add <im_patch>/<im_start>/<im_end> special tokens and resize/initialize the
embedding table — new rows get the mean of existing embeddings (the
reference's input/output-embedding averaging).
"""

from __future__ import annotations

from typing import Tuple

import torch

from memory_augmented_vlm_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
)


def resize_token_embeddings(lm_params: dict, new_vocab: int,
                            tie_word_embeddings: bool) -> dict:
    """Grow (or shrink) the embedding table; new input rows take the mean of
    existing input embeddings, new output rows (the untied (H, V)
    `lm_head`'s columns) the mean of output embeddings (llava_arch.py:936-948).
    The means are summed in fp64 and cast to the table's dtype."""
    emb = lm_params["embed_tokens"]
    old_vocab = emb.shape[0]
    out = dict(lm_params)
    if new_vocab <= old_vocab:
        out["embed_tokens"] = emb[:new_vocab].clone()
        if "lm_head" in lm_params:
            out["lm_head"] = lm_params["lm_head"][:, :new_vocab].contiguous()
        return out
    extra = new_vocab - old_vocab
    mean_in = emb.double().mean(dim=0, keepdim=True).to(emb.dtype)
    out["embed_tokens"] = torch.cat([emb, mean_in.expand(extra, -1)])
    if "lm_head" in lm_params and not tie_word_embeddings:
        head = lm_params["lm_head"]  # (H, V)
        mean_out = head.double().mean(dim=1, keepdim=True).to(head.dtype)
        out["lm_head"] = torch.cat([head, mean_out.expand(-1, extra)], dim=1)
    return out


def initialize_vision_tokenizer(
    params: dict,
    tokenizer,
    *,
    tie_word_embeddings: bool,
    mm_use_im_patch_token: bool = False,
    mm_use_im_start_end: bool = False,
) -> Tuple[dict, object]:
    """Add vision special tokens and resize embeddings accordingly."""
    added = 0
    if mm_use_im_patch_token:
        added += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
    if mm_use_im_start_end:
        added += tokenizer.add_tokens(
            [DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN], special_tokens=True)
    if added:
        lm = resize_token_embeddings(params["language_model"], len(tokenizer),
                                     tie_word_embeddings)
        params = dict(params, language_model=lm)
    return params, tokenizer
