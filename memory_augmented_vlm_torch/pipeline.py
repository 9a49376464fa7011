"""Clip -> answer: the main path of the port (counterpart of
`bench.py::build_pipeline`).

SigLIP tower over the frames -> projector -> 2x2 pool -> temporal PE ->
recurrent memory over 32-frame segments -> fuser -> prompt splice (or,
with `no_memory`, the pooled frames with a newline after each) -> Qwen2
prefill -> (with `kv_int8`, the cache quantized to int8) -> decode of
`max_new_tokens` tokens, greedy or Gumbel-max sampled. The int8 serving
configuration is this path with int8-prequantized weights
(`int8_serving_params`), `tower_int8` set and `kv_int8=True`, as `bench.py`
runs by default.

The embedding chain is `vlm.clip_embeds` and decode is `vlm.generate` with
no eos and no stop sequence, so it does JAX's work: its `lax.scan` runs
`max_new_tokens` steps of pick -> embed -> `decode_step` -> unembed, so a
request makes `max_new_tokens` decode steps and `max_new_tokens + 1`
unembeds (the last step's logits are never read). On the card that decode
replays `vlm`'s captured chunks (see its "Generation" notes); on the CPU it
runs eagerly.
"""

from __future__ import annotations

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


def build_pipeline(cfg: VLMConfig, num_frames: int = NUM_FRAMES, *, no_memory: bool = False,
                   kv_int8: bool = False, return_logits: bool = False,
                   max_new_tokens: int = MAX_NEW_TOKENS, sample_temperature: float = 0.0):
    """Returns (clip_to_answer, nseg).

    `clip_to_answer(params, pixels, text_before, text_after, noise=None,
    cuda_graph=True)`
    takes (num_frames, H, W, 3) NHWC pixels and the prompt's token ids
    around the video, and returns (tokens (max_new_tokens, 1) int32,
    spliced length s). With `return_logits` it also returns the fp32 logits
    each token was picked from, (max_new_tokens, 1, V): row 0 is the
    prefill logits. Frames pad to the 32-frame segment multiple with a
    validity mask, and the spliced memory length clamps at the ring cache's
    capacity. With `no_memory` the visual stream is the pooled frames, each
    followed by the image newline (BASELINE.json config 2).

    `sample_temperature > 0` samples by Gumbel-max with per-step noise:
    `noise` (max_new_tokens, 1, V) fp32 if given (the tests pass JAX's
    draws), else draws from `vlm.generate`'s default seeded generator.
    `cuda_graph=False` runs the card's decode eagerly (what its captured
    chunks are held against)."""
    mcfg = cfg.memory
    fmax = vlm.pad_frames_to_segment_multiple(num_frames, mcfg.segment_frames)
    nseg = min(fmax // mcfg.segment_frames, mcfg.cache_cap)

    def clip_to_answer(params, pixels, text_before, text_after, noise=None, cuda_graph=True):
        embeds = vlm.clip_embeds(params, cfg, pixels, text_before, text_after,
                                 no_memory=no_memory)
        out = vlm.generate(params, cfg, embeds, max_new_tokens=max_new_tokens, eos_token_ids=(),
                           temperature=sample_temperature, noise=noise,
                           return_logits=return_logits, kv_int8=kv_int8,
                           cuda_graph=cuda_graph)
        result, rows = out if return_logits else (out, None)
        tokens, s = result.tokens[:, None], embeds.shape[0]
        return (tokens, s, rows[:, None]) if return_logits else (tokens, s)

    return clip_to_answer, nseg
