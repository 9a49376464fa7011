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

Decode does JAX's work: its `lax.scan` runs `max_new_tokens` steps of pick
-> embed -> `decode_step` -> unembed, so a request makes `max_new_tokens`
decode steps and `max_new_tokens + 1` unembeds (the last step's logits are
never read). The counterpart of that one jitted device program is one CUDA
graph (`DecodeGraph`): on the card the loop is captured once per pipeline,
weights, padded length and KV dtype, and replayed once per request, with
the prefill writing into the graph's persistent cache. On the CPU the same
loop (`decode`) runs eagerly.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, siglip, vlm

NUM_FRAMES = 64
MAX_NEW_TOKENS = 32
NOISE_SEED = 0  # the sampling noise's generator seed (JAX: jax.random.key(0))


def int8_serving_params(params):
    """`bench.py`'s default 0.5B serving weights from float ones: the tower
    prequantized to int8, the LM to int8 with an int8 copy of the
    unembedding. Pair with `tower_int8=True` and `kv_int8=True`."""
    return {**params,
            "vision_tower": siglip.prequantize_int8(params["vision_tower"]),
            "language_model": qwen2.prequantize_int8(params["language_model"],
                                                     include_unembed=True)}


def gumbel_noise(max_new_tokens: int, batch: int, vocab: int, device) -> torch.Tensor:
    """The sampling noise of a request: (max_new_tokens, batch, vocab) fp32
    standard Gumbel draws (-log of unit exponentials) from a generator
    seeded `NOISE_SEED`. Not JAX's bits: a test that holds the port to JAX
    passes JAX's draws in instead."""
    gen = torch.Generator(device=device)
    gen.manual_seed(NOISE_SEED)
    noise = torch.empty((max_new_tokens, batch, vocab), device=device)
    return noise.exponential_(generator=gen).log_().neg_()


def pick(logits: torch.Tensor, noise: Optional[torch.Tensor], temperature: float) -> torch.Tensor:
    """The next token of each row, int32: the argmax, or with `noise` the
    Gumbel-max draw argmax(logits / temperature + noise) in fp32 (bench.py's
    sampling; the division by a tensor, as JAX divides, not by a multiply)."""
    if noise is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return torch.argmax(logits.float() / t + noise, dim=-1).to(torch.int32)


def decode(lm, cfg: VLMConfig, logits: torch.Tensor, cache: qwen2.KVCache, act_dtype,
           max_new_tokens: int, noise: Optional[torch.Tensor] = None,
           temperature: float = 0.0, keep_logits: bool = False):
    """JAX's decode scan: `max_new_tokens` steps of pick -> embed ->
    `qwen2.decode_step` -> `qwen2.unembed`, from the prefill logits (B, V).
    Returns (tokens (T, B) int32, the logits each token was picked from
    (T, B, V) fp32, or None without `keep_logits`). Reads nothing back to
    the host, so a CUDA graph can capture it."""
    tokens, rows = [], []
    for step in range(max_new_tokens):
        tok = pick(logits, None if noise is None else noise[step], temperature)
        tokens.append(tok)
        if keep_logits:
            rows.append(logits)
        emb = qwen2.embed_tokens(lm, tok[:, None]).to(act_dtype)
        hidden, cache = qwen2.decode_step(lm, cfg.lm, emb, cache)
        logits = qwen2.unembed(lm, hidden)[:, 0]
    return torch.stack(tokens), torch.stack(rows) if keep_logits else None


class DecodeGraph:
    """`decode` captured in one CUDA graph for one model, padded length and
    KV dtype, with the persistent inputs a replay reads: the cache (`cache`,
    which the prefill fills), the prefill logits (`logits`) and the noise
    (`noise`). Captured at the first `replay`, after a one-step warm-up on
    a side stream (cuBLAS's workspaces), as PyTorch's graph docs ask; a
    capture that fails raises. Dropping the object frees its memory pool."""

    def __init__(self, lm, cfg: VLMConfig, batch: int, max_len: int, kv_dtype, act_dtype,
                 max_new_tokens: int, temperature: float, keep_logits: bool, device):
        self.lm = lm  # the weights the captured kernels read stay alive
        self.cache = qwen2.KVCache.zeros(cfg.lm, batch, max_len, device, kv_dtype)
        vocab = _vocab(lm)
        self.logits = torch.zeros((batch, vocab), dtype=torch.float32, device=device)
        self.noise = (torch.zeros((max_new_tokens, batch, vocab), device=device)
                      if temperature > 0 else None)
        self._run = functools.partial(decode, lm, cfg, self.logits, self.cache, act_dtype,
                                      noise=self.noise, temperature=temperature,
                                      keep_logits=keep_logits)
        self.max_new_tokens = max_new_tokens
        self.graph = None
        self.tokens = self.rows = None

    def _capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # writes the cache at its length, which step 0 of every replay rewrites
            self._run(1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.tokens, self.rows = self._run(self.max_new_tokens)
        self.graph = graph

    def replay(self):
        """(tokens (T, B), logits rows (T, B, V) or None), copied out of the
        graph's pool."""
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.tokens.clone(), None if self.rows is None else self.rows.clone()


def _vocab(lm) -> int:
    return (lm["unembed_scale"] if "unembed_scale" in lm else lm["embed_tokens"]).shape[0]


def build_pipeline(cfg: VLMConfig, num_frames: int = NUM_FRAMES, *, no_memory: bool = False,
                   kv_int8: bool = False, return_logits: bool = False,
                   max_new_tokens: int = MAX_NEW_TOKENS, sample_temperature: float = 0.0):
    """Returns (clip_to_answer, nseg).

    `clip_to_answer(params, pixels, text_before, text_after, noise=None)`
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
    draws), else `gumbel_noise`. On the card decode replays a `DecodeGraph`
    (one per weights and padded length, kept in `clip_to_answer.graphs`)."""
    mcfg = cfg.memory
    fmax = vlm.pad_frames_to_segment_multiple(num_frames, mcfg.segment_frames)
    nseg = min(fmax // mcfg.segment_frames, mcfg.cache_cap)
    fine_idx = torch.from_numpy(vlm.fine_frame_indices(num_frames, mcfg.num_fine_frames))
    frame_valid = torch.arange(fmax) < num_frames  # host side: steers the memory loop
    graphs = {}

    def clip_to_answer(params, pixels, text_before, text_after, noise=None):
        dev = pixels.device
        lm = params["language_model"]
        feats = vlm.encode_frames(params, cfg, pixels)  # (num_frames, 196, H)
        if no_memory:
            visual = vlm.add_token_per_frame(feats, params["memory"]["image_newline"])
        else:
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
        if sample_temperature > 0 and noise is None:
            noise = gumbel_noise(max_new_tokens, 1, _vocab(lm), dev)
        noise = None if sample_temperature <= 0 else noise.to(dev, torch.float32)
        kv_dtype = torch.int8 if kv_int8 else padded.dtype
        graph = None
        if dev.type == "cuda":
            key = (id(lm), smax, kv_dtype)
            if key not in graphs:
                graphs[key] = DecodeGraph(lm, cfg, 1, smax + max_new_tokens, kv_dtype,
                                          padded.dtype, max_new_tokens, sample_temperature,
                                          return_logits, dev)
            graph = graphs[key]
        prefill_cache = None if graph is None or kv_int8 else graph.cache
        hidden, cache = qwen2.forward(lm, cfg.lm, padded, positions, valid_len=valid,
                                      cache_max_len=smax + max_new_tokens, cache=prefill_cache)
        logits = qwen2.unembed(lm, hidden[:, s - 1:s])[:, 0]
        if kv_int8:
            cache = qwen2.quantize_cache(cache, out=None if graph is None else graph.cache)
        if graph is None:
            tokens, rows = decode(lm, cfg, logits, cache, padded.dtype, max_new_tokens, noise,
                                  sample_temperature, keep_logits=return_logits)
        else:
            graph.logits.copy_(logits)
            if noise is not None:
                graph.noise.copy_(noise)
            tokens, rows = graph.replay()
        if return_logits:
            return tokens, s, rows
        return tokens, s

    clip_to_answer.graphs = graphs  # for holding and timing a captured loop alone
    return clip_to_answer, nseg

