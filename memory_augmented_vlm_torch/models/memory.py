"""Recurrent memory transformer (counterpart of
`memory_augmented_vlm_tpu/models/memory.py`).

Per 32-frame segment: evolve the last cached memory by cross-attending it
over every cached memory (or start from the learned initial memory when the
cache is empty), fuse it with the segment's frame tokens through `depth`
post-LN cross-attention layers with a ReLU MLP, and append the result to a
ring cache of `cache_cap` entries that drops its oldest entry when full.

Where JAX scans and branches on traced values, the port loops in Python and
branches on host values: `cache_len` is a Python int and `frame_valid` a
host-side bool vector. Every cross-attention goes through the flash kernel
with a prefix valid length; the head dim (112 at full width) is not padded.

Gradients flow through the whole recurrence, the ring cache included: an
append writes into a clone of the cache (or into `torch.roll` of it when
full), so each segment's memory stays in the graph of the next segment's
evolve and of the fuser, as under JAX's `scan`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import MemoryConfig
from memory_augmented_vlm_torch.ops.attention import flash_attention
from memory_augmented_vlm_torch.ops.norms import layer_norm


class MemoryState(NamedTuple):
    cache: torch.Tensor  # (cap, num_mem, patch, D)
    cache_len: int       # number of valid entries (<= cap), a prefix

    @staticmethod
    def zeros(cfg: MemoryConfig, device, dtype=torch.float32) -> "MemoryState":
        shape = (cfg.cache_cap, cfg.num_memory_tokens, cfg.patch_size, cfg.hidden_size)
        return MemoryState(torch.zeros(shape, device=device, dtype=dtype), 0)


def init_params(cfg: MemoryConfig, gen: torch.Generator, device, dtype=torch.float32):
    """Random init with the JAX init's shapes and distributions: normal 0.02
    kernels, zero biases, unit norms, xavier-uniform initial memory (torch
    fan convention for a 3-D tensor) and a unit-normal memory PE."""
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def dense(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def lin(d_in, d_out):
        return {"kernel": dense(d_in, d_out),
                "bias": torch.zeros(d_out, device=device, dtype=dtype)}

    def ln():
        return {"weight": torch.ones(h, device=device, dtype=dtype),
                "bias": torch.zeros(h, device=device, dtype=dtype)}

    def attn():
        return {"q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
                "residual": {"dense": lin(h, h), "layernorm": ln()}}

    fan_in, fan_out = cfg.patch_size * h, cfg.num_memory_tokens * h
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    initial = torch.rand((cfg.num_memory_tokens, cfg.patch_size, h),
                         generator=gen, device=device) * (2 * bound) - bound
    return {
        "initial_memory": initial.to(dtype),
        "memory_pos_embed": dense(cfg.num_memory_tokens, 1, h, scale=1.0),
        "memory_update_attention": attn(),
        "layers": [
            {"attention": attn(), "mlp": lin(h, inter),
             "residual": {"dense": lin(inter, h), "layernorm": ln()}}
            for _ in range(cfg.depth)
        ],
    }


def _linear(p, x):
    return x @ p["kernel"] + p["bias"]


def _residual(p, hidden, input_tensor, eps):
    return layer_norm(_linear(p["dense"], hidden) + input_tensor,
                      p["layernorm"]["weight"], p["layernorm"]["bias"], eps)


def _valid_len(n: int, device) -> torch.Tensor:
    return torch.full((1,), n, dtype=torch.int32, device=device)


def attention(p, cfg: MemoryConfig, query: torch.Tensor, kv: torch.Tensor,
              kv_valid_len: torch.Tensor) -> torch.Tensor:
    """Post-LN cross attention: LayerNorm(Linear(softmax(QK^T/sqrt(dh)) V) +
    query). query (B, Lq, D); kv (B, Lk, D); the first kv_valid_len[b] keys
    are valid."""
    b, lq, d = query.shape
    lk = kv.shape[1]
    nh = cfg.num_attention_heads
    hd = d // nh
    q = _linear(p["q_proj"], query).view(b, lq, nh, hd)
    k = _linear(p["k_proj"], kv).view(b, lk, nh, hd)
    v = _linear(p["v_proj"], kv).view(b, lk, nh, hd)
    ctx = flash_attention(q, k, v, causal=False, kv_valid_len=kv_valid_len,
                          scale=hd ** -0.5).reshape(b, lq, d)
    return _residual(p["residual"], ctx, query, cfg.layer_norm_eps)


def evolve_with_cache(params, cfg: MemoryConfig, state: MemoryState) -> torch.Tensor:
    """The last cached memory, as 8*196 queries, cross-attends over the
    whole cache; the valid entries are a prefix. Needs cache_len > 0."""
    cap, nm, pp, d = state.cache.shape
    query = state.cache[state.cache_len - 1].reshape(1, nm * pp, d)
    keyval = state.cache.reshape(1, cap * nm * pp, d)
    kv_len = _valid_len(state.cache_len * nm * pp, state.cache.device)
    updated = attention(params["memory_update_attention"], cfg, query, keyval, kv_len)
    return updated.reshape(nm, pp, d)


def fuse_segment(params, cfg: MemoryConfig, memory_tokens: torch.Tensor,
                 segment: torch.Tensor, frame_valid: torch.Tensor) -> torch.Tensor:
    """Memory queries over the segment's frame tokens, padded frames masked.

    memory_tokens (8, 196, D); segment (Fseg, 196, D); frame_valid (Fseg,)
    host bool, valid frames a prefix."""
    nm, pp, d = memory_tokens.shape
    fseg = segment.shape[0]
    mem2d = memory_tokens.reshape(1, nm * pp, d)
    seg2d = segment.reshape(1, fseg * pp, d)
    kv_len = _valid_len(int(frame_valid.sum()) * pp, segment.device)
    for lp in params["layers"]:
        attn_out = attention(lp["attention"], cfg, mem2d, seg2d, kv_len)
        mlp_out = F.relu(_linear(lp["mlp"], attn_out))
        mem2d = _residual(lp["residual"], mlp_out, attn_out, cfg.layer_norm_eps)
    return mem2d.reshape(nm, pp, d)


def segment_step(params, cfg: MemoryConfig, state: MemoryState,
                 segment: torch.Tensor, frame_valid: torch.Tensor) -> MemoryState:
    """evolve -> fuse -> append to the ring cache. A segment with no valid
    frame leaves the state as it is."""
    if not bool(frame_valid.any()):
        return state
    if state.cache_len > 0:
        memory_tokens = evolve_with_cache(params, cfg, state)
    else:
        init = params["initial_memory"] + params["memory_pos_embed"]
        memory_tokens = init.to(state.cache.dtype)
    final = fuse_segment(params, cfg, memory_tokens, segment, frame_valid)
    cap = state.cache.shape[0]
    if state.cache_len >= cap:  # full: drop the oldest entry, write at the end
        cache = torch.roll(state.cache, -1, dims=0)
        write = cap - 1
    else:
        cache = state.cache.clone()
        write = state.cache_len
    cache[write] = final
    return MemoryState(cache, min(state.cache_len + 1, cap))


def run_video(params, cfg: MemoryConfig, frames: torch.Tensor,
              frame_valid: torch.Tensor) -> MemoryState:
    """frames (Fmax, 196, D), Fmax a multiple of segment_frames;
    frame_valid (Fmax,) host bool."""
    fmax, pp, d = frames.shape
    seg = cfg.segment_frames
    if fmax % seg:
        raise ValueError(f"pad frames to a multiple of {seg}, got {fmax}")
    state = MemoryState.zeros(cfg, frames.device, frames.dtype)
    for i in range(fmax // seg):
        state = segment_step(params, cfg, state, frames[i * seg:(i + 1) * seg],
                             frame_valid[i * seg:(i + 1) * seg])
    return state


def fuse_memory_bank(fuser_params, state: MemoryState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-fuser MLP (exact GELU) over the whole cache. Returns
    (fused (cap*8, 196, D), token_valid (cap*8,) bool)."""
    cap, nm, pp, d = state.cache.shape
    x = state.cache.reshape(cap * nm, pp, d)
    h = _linear(fuser_params["fc2"], F.gelu(_linear(fuser_params["fc1"], x)))
    valid = (torch.arange(cap, device=x.device) < state.cache_len).repeat_interleave(nm)
    return h, valid
