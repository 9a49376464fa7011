"""Qwen2 decoder LM (counterpart of `memory_augmented_vlm_tpu/models/qwen2.py`,
its dense RoPE path with a bf16/fp32 KV cache).

Prefill runs causal attention through the flash kernel with the 2 KV heads
passed as they are (`kv_groups`), which is the same math as JAX's
`repeat_kv`; decode uses the GQA-native plain `decode_attention`. The KV
cache is a preallocated (L, B, Smax, Hkv, Dh) pair that `decode_step`
updates in place, where JAX returns an updated copy: the cache is never
read again in its old state, and a copy would cost a cache write per token.

Parameters: dense kernels are (in, out), q/k/v carry biases, `layers` is
a list of per-layer dicts, and the unembedding is tied to `embed_tokens`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import LMConfig
from memory_augmented_vlm_torch.ops.attention import decode_attention, flash_attention
from memory_augmented_vlm_torch.ops.norms import rms_norm
from memory_augmented_vlm_torch.ops.rope import apply_rope, compute_rope_freqs, rope_cos_sin


class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, Smax, Hkv, Dh)
    v: torch.Tensor       # (L, B, Smax, Hkv, Dh)
    length: torch.Tensor  # (B,) int32 — valid positions per sequence

    @staticmethod
    def zeros(cfg: LMConfig, batch: int, max_len: int, device,
              dtype=torch.bfloat16) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
                 cfg.head_dim)
        return KVCache(torch.zeros(shape, device=device, dtype=dtype),
                       torch.zeros(shape, device=device, dtype=dtype),
                       torch.zeros((batch,), device=device, dtype=torch.int32))


def init_params(cfg: LMConfig, gen: torch.Generator, device, dtype=torch.float32):
    """Random init with the JAX init's shapes and distributions."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def proj(d_in, d_out, bias):
        p = {"kernel": dense(d_in, d_out)}
        if bias:
            p["bias"] = torch.zeros(d_out, device=device, dtype=dtype)
        return p

    ones = lambda: torch.ones(h, device=device, dtype=dtype)  # noqa: E731
    return {
        "embed_tokens": dense(cfg.vocab_size, h),
        "layers": [
            {"input_layernorm": ones(), "post_attention_layernorm": ones(),
             "q_proj": proj(h, nh * d, True),
             "k_proj": proj(h, nkv * d, True),
             "v_proj": proj(h, nkv * d, True),
             "o_proj": proj(nh * d, h, False),
             "gate_proj": proj(h, i, False), "up_proj": proj(h, i, False),
             "down_proj": proj(i, h, False)}
            for _ in range(cfg.num_hidden_layers)
        ],
        "norm": ones(),
    }


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def unembed(params, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm already applied; fp32 logits against the tied (V, H)
    embedding table."""
    return F.linear(hidden.float(), params["embed_tokens"].float())


def _proj(p, x):
    out = x @ p["kernel"]
    return out + p["bias"] if "bias" in p else out


def _qkv(lp, cfg: LMConfig, x):
    b, s, _ = x.shape
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return (_proj(lp["q_proj"], x).view(b, s, nh, d),
            _proj(lp["k_proj"], x).view(b, s, nkv, d),
            _proj(lp["v_proj"], x).view(b, s, nkv, d))


def _mlp(lp, x):
    return _proj(lp["down_proj"], F.silu(_proj(lp["gate_proj"], x)) * _proj(lp["up_proj"], x))


def _rope_tables(cfg: LMConfig, positions: torch.Tensor):
    inv_freq = compute_rope_freqs(cfg.head_dim, cfg.rope_theta, device=positions.device)
    return rope_cos_sin(positions, inv_freq)


def forward(params, cfg: LMConfig, inputs_embeds: torch.Tensor, positions: torch.Tensor,
            valid_len: Optional[torch.Tensor] = None, *,
            cache_max_len: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Prefill. inputs_embeds (B, S, H) right-padded; positions (B, S);
    valid_len (B,) int32 (None = all valid). The returned cache holds
    `cache_max_len` (default S) positions so decode continues in place.
    Returns (hidden after the final norm, cache)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    max_len = cache_max_len or s
    if max_len < s:
        raise ValueError(f"cache_max_len {max_len} < sequence length {s}")
    cache = KVCache.zeros(cfg, b, max_len, dev, inputs_embeds.dtype)
    cos, sin = _rope_tables(cfg, positions)
    hidden = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        cache.k[li, :, :s] = k
        cache.v[li, :, :s] = v
        attn = flash_attention(q, k, v, causal=True, kv_valid_len=valid_len,
                               kv_groups=cfg.kv_groups)
        hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, s, -1))
        x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        hidden = hidden + _mlp(lp, x)
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return hidden, cache._replace(length=valid_len.to(torch.int32))


def decode_step(params, cfg: LMConfig, token_embeds: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per row: token_embeds (B, 1, H). Writes the new K/V at
    `cache.length` (in place) and returns (hidden (B, 1, H), the cache with
    length + 1)."""
    b = token_embeds.shape[0]
    pos = cache.length.long()  # (B,) — position of the new token
    cos, sin = _rope_tables(cfg, pos[:, None])
    rows = torch.arange(b, device=token_embeds.device)
    hidden = token_embeds
    for li, lp in enumerate(params["layers"]):
        x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        cache.k[li, rows, pos] = k[:, 0]
        cache.v[li, rows, pos] = v[:, 0]
        attn = decode_attention(q, cache.k[li], cache.v[li], cache.length + 1,
                                kv_groups=cfg.kv_groups)
        hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, 1, -1))
        x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        hidden = hidden + _mlp(lp, x)
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return hidden, cache._replace(length=cache.length + 1)
