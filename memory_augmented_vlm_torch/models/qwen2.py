"""Qwen2 decoder LM (counterpart of `memory_augmented_vlm_tpu/models/qwen2.py`,
its dense RoPE path with a bf16/fp32 or int8 KV cache and float or
prequantized int8 weights).

Prefill runs causal attention through the flash kernel with the 2 KV heads
passed as they are (`kv_groups`), which is the same math as JAX's
`repeat_kv`; decode uses the GQA-native plain `decode_attention`. The KV
cache is a preallocated (L, B, Smax, Hkv, Dh) pair that `decode_step`
updates in place, where JAX returns an updated copy: the cache is never
read again in its old state, and a copy would cost a cache write per token.

The int8 serving configuration (`prequantize_int8(include_unembed=True)`
and `quantize_cache` after prefill) follows JAX's formulas: projections go
through `quant.int8_linear`, the unembedding through a per-vocab-row int8
copy of the table, and the cache holds per-(position, head) int8 rows with
fp32 scales (`x / s`, floor 1e-8), quantized on write and dequantized to
the activation dtype before `decode_attention`. With the module flag
`fused_swiglu_enabled` set, an int8 layer's MLP half runs as one kernel
(`swiglu_int8.fused_swiglu_block_int8`) at prefill sizes; see `_mlp_half`.

Parameters: dense kernels are (in, out), int8 kernels (in, out) column-major
(`ops/quant.py`), q/k/v carry biases, `layers` is a list of per-layer
dicts, and the unembedding is tied to `embed_tokens` or, for an untied LM
(`tie_word_embeddings=False`, Qwen2-7B), a dense (H, V) `lm_head`.

Decode is safe to capture in a CUDA graph: `decode_step` reads its position
from `cache.length` on the card, writes the cache in place and reads nothing
back to the host, and `forward(cache=...)` / `quantize_cache(out=...)` fill
a persistent cache whose addresses a captured decode loop keeps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from memory_augmented_vlm_torch.config import LMConfig
from memory_augmented_vlm_torch.ops.attention import decode_attention, flash_attention
from memory_augmented_vlm_torch.ops.norms import rms_norm
from memory_augmented_vlm_torch.ops.quant import (QUANT_FLOOR, int8_linear, int_mm,
                                                  prequantize_kernel, quantize_rows)
from memory_augmented_vlm_torch.ops.rope import apply_rope, compute_rope_freqs, rope_cos_sin
from memory_augmented_vlm_torch.ops.swiglu_int8 import fused_swiglu_block_int8

KV_QUANT_FLOOR = 1e-8
_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# Opt-in, as in JAX (`qwen2.fused_swiglu_enabled`): the int8 LM's MLP half as
# one fused kernel. Read by `_mlp_half` at call time; set it around a call and
# restore it.
fused_swiglu_enabled = False
FUSED_SWIGLU_MIN_ROWS = 1024


class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, Smax, Hkv, Dh)
    v: torch.Tensor       # (L, B, Smax, Hkv, Dh)
    length: torch.Tensor  # (B,) int32 — valid positions per sequence
    k_scale: Optional[torch.Tensor] = None  # (L, B, Smax, Hkv) fp32, int8 cache only
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: LMConfig, batch: int, max_len: int, device,
              dtype=torch.bfloat16) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
                 cfg.head_dim)
        # an int8 cache carries a zero fp32 scale per (layer, row, position,
        # head), one tensor each for K and V since decode_step writes in place
        scales = [torch.zeros(shape[:-1], device=device, dtype=torch.float32)
                  for _ in range(2)] if dtype == torch.int8 else [None, None]
        return KVCache(torch.zeros(shape, device=device, dtype=dtype),
                       torch.zeros(shape, device=device, dtype=dtype),
                       torch.zeros((batch,), device=device, dtype=torch.int32), *scales)


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last (head_dim) axis:
    (..., D) -> ((..., D) int8, (...) fp32 scale), `x / s` with a 1e-8 floor."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(KV_QUANT_FLOOR) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_cache(cache: KVCache, out: Optional[KVCache] = None) -> KVCache:
    """A prefill cache in the int8 form `decode_step` reads (serving
    `kv_int8`); an int8 cache is returned as it is. With `out`, an int8
    cache of the same shape, the codes, scales and lengths are written into
    its tensors in place and `out` is returned."""
    if cache.k.dtype == torch.int8:
        return cache
    kq, ks = quantize_kv_rows(cache.k)
    vq, vs = quantize_kv_rows(cache.v)
    if out is None:
        return KVCache(kq, vq, cache.length, ks, vs)
    for dst, src in zip(out, (kq, vq, cache.length, ks, vs)):
        dst.copy_(src)
    return out


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
        **({} if cfg.tie_word_embeddings else {"lm_head": dense(h, cfg.vocab_size)}),
    }


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][input_ids]


def unembed(params, hidden: torch.Tensor) -> torch.Tensor:
    """Final norm already applied; fp32 logits against the tied (V, H)
    embedding table or the untied (H, V) `lm_head`, or against the int8
    copy of either when `prequantize_int8` installed one: row-quantized
    activations times the int8 table, scaled by the row and vocab scales."""
    if "unembed_int8" in params:
        xq, sx = quantize_rows(hidden)
        acc = int_mm(xq.reshape(-1, xq.shape[-1]), params["unembed_int8"].t())
        acc = acc.reshape(*xq.shape[:-1], acc.shape[-1])
        return acc.float() * sx * params["unembed_scale"]
    weight = params["lm_head"] if "lm_head" in params else params["embed_tokens"].t()
    return _fp32_product(hidden, weight)


def _fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with fp32 products and an fp32 result from
    operands in their own dtype (JAX's `preferred_element_type=float32`).
    On the card a bf16 pair takes cuBLAS's bf16 product with an fp32
    output, so the (V, H) table is never cast: a cast would write and read
    an fp32 copy of it at every call (1.09 GB of bf16 at 7B)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cuda" and x2.dtype == w.dtype != torch.float32:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()  # no copy of an fp32 operand
    return out.reshape(*x.shape[:-1], w.shape[-1])


def prequantize_int8(params, *, include_unembed: bool = False):
    """Static-scale int8 LM weights (JAX `qwen2.prequantize_int8`, bits=8):
    the seven dense kernels of every layer become per-output-channel int8
    (`kernel_int8`, column-major) with an fp32 `scale`, biases kept. With
    `include_unembed`, also a per-vocab-row int8 copy of the unembedding
    (`unembed_int8` (V, H), `unembed_scale` (V,)) that `unembed` prefers:
    of the tied table, whose `embed_tokens` stays for token lookups, or of
    `lm_head.T`, whose dense `lm_head` is dropped."""
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in _PROJECTIONS:
            wq, scale = prequantize_kernel(lp[name]["kernel"])
            entry = {"kernel_int8": wq, "scale": scale}
            if "bias" in lp[name]:
                entry["bias"] = lp[name]["bias"]
            lp[name] = entry
        layers.append(lp)
    out = {**params, "layers": layers}
    if include_unembed:
        table = (params["lm_head"].t() if "lm_head" in params
                 else params["embed_tokens"]).float()
        scale = table.abs().amax(dim=1).clamp_min(QUANT_FLOOR) / 127.0
        out["unembed_int8"] = torch.round(table / scale[:, None]).clamp_(-127, 127).to(
            torch.int8).contiguous()  # (V, H) rows, whichever table it came from
        out["unembed_scale"] = scale
        out.pop("lm_head", None)
    return out


def _proj(p, x):
    if "kernel_int8" in p:
        return int8_linear(p, x)
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


def _mlp_half(lp, hidden, cfg: LMConfig):
    """Post-attention norm + MLP + residual of one layer.

    With `fused_swiglu_enabled`, a layer whose `gate_proj` is int8 and has
    no bias runs the whole half as one kernel when `b * s >= 1024` rows
    (prefill; one decode row keeps the composed path). JAX's gate also asks
    for a dense, gated, silu MLP behind an RMSNorm and a TPU backend: the
    port's LM has no other kind and no `1 + w` norm convention to fold into
    the weight, and the wrapper itself picks kernel or plain version by
    device."""
    b, s, h = hidden.shape
    gate = lp["gate_proj"]
    if (fused_swiglu_enabled and "kernel_int8" in gate and "bias" not in gate
            and b * s >= FUSED_SWIGLU_MIN_ROWS):
        return fused_swiglu_block_int8(
            hidden.reshape(b * s, h), lp["post_attention_layernorm"],
            gate["kernel_int8"], gate["scale"],
            lp["up_proj"]["kernel_int8"], lp["up_proj"]["scale"],
            lp["down_proj"]["kernel_int8"], lp["down_proj"]["scale"],
            eps=cfg.rms_norm_eps).reshape(b, s, h)
    x = rms_norm(hidden, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return hidden + _mlp(lp, x)


def _rope_tables(cfg: LMConfig, positions: torch.Tensor):
    inv_freq = compute_rope_freqs(cfg.head_dim, cfg.rope_theta, positions.device)
    return rope_cos_sin(positions, inv_freq)


def _layer(lp, cfg: LMConfig, hidden, cos, sin, valid_len, differentiable: bool):
    """One decoder layer over the whole sequence: (hidden, k, v)."""
    b, s, _ = hidden.shape
    x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
    q, k, v = _qkv(lp, cfg, x)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = flash_attention(q, k, v, causal=True, kv_valid_len=valid_len,
                           kv_groups=cfg.kv_groups, differentiable=differentiable)
    hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, s, -1))
    return _mlp_half(lp, hidden, cfg), k, v


def forward(params, cfg: LMConfig, inputs_embeds: torch.Tensor, positions: torch.Tensor,
            valid_len: Optional[torch.Tensor] = None, *,
            cache_max_len: Optional[int] = None, remat: bool = False,
            differentiable_attention: bool = False,
            need_cache: bool = True,
            cache: Optional[KVCache] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Prefill or training forward. inputs_embeds (B, S, H) right-padded;
    positions (B, S); valid_len (B,) int32 (None = all valid).

    With `need_cache` the returned cache holds `cache_max_len` (default S)
    positions so decode continues in place; without it no cache is made and
    the cache slot is None (the loss-only training path: writing K/V into a
    cache would tie it into the autograd graph). A `cache` passed in (of
    the activations' dtype and at least S positions) is filled in place,
    its lengths included, and returned: the persistent buffers of a
    captured decode loop. `remat` recomputes each
    layer in the backward (`torch.utils.checkpoint`, JAX's
    `jax.checkpoint`), so the forward keeps only the layers' inputs.
    `differentiable_attention` takes the training attention kernels.
    Returns (hidden after the final norm, cache or None)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if valid_len is None:
        valid_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    if cache is not None:
        if (cache.k.dtype != inputs_embeds.dtype or cache.k.shape[1] != b
                or cache.k.shape[2] < s):
            raise ValueError(f"cache {cache.k.dtype}{tuple(cache.k.shape)} cannot take "
                             f"{b} rows of {s} {inputs_embeds.dtype} positions")
    elif need_cache:
        max_len = cache_max_len or s
        if max_len < s:
            raise ValueError(f"cache_max_len {max_len} < sequence length {s}")
        cache = KVCache.zeros(cfg, b, max_len, dev, inputs_embeds.dtype)
    cos, sin = _rope_tables(cfg, positions)
    hidden = inputs_embeds
    for li, lp in enumerate(params["layers"]):
        args = (lp, cfg, hidden, cos, sin, valid_len, differentiable_attention)
        if remat:
            hidden, k, v = checkpoint(_layer, *args, use_reentrant=False)
        else:
            hidden, k, v = _layer(*args)
        if cache is not None:
            cache.k[li, :, :s] = k
            cache.v[li, :, :s] = v
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    if cache is None:
        return hidden, None
    cache.length.copy_(valid_len)
    return hidden, cache


def decode_step(params, cfg: LMConfig, token_embeds: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per row: token_embeds (B, 1, H). Writes the new K/V at
    `cache.length` (in place; an int8 cache quantizes them on the way in)
    and returns (hidden (B, 1, H), the cache with length + 1)."""
    b = token_embeds.shape[0]
    quant = cache.k.dtype == torch.int8
    act_dtype = token_embeds.dtype
    pos = cache.length.long()  # (B,) — position of the new token
    cos, sin = _rope_tables(cfg, pos[:, None])
    rows = torch.arange(b, device=token_embeds.device)
    hidden = token_embeds
    for li, lp in enumerate(params["layers"]):
        x = rms_norm(hidden, lp["input_layernorm"], cfg.rms_norm_eps)
        q, k, v = _qkv(lp, cfg, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if quant:
            k, k_s = quantize_kv_rows(k)  # (B, 1, Hkv, D), (B, 1, Hkv)
            v, v_s = quantize_kv_rows(v)
            cache.k_scale[li, rows, pos] = k_s[:, 0]
            cache.v_scale[li, rows, pos] = v_s[:, 0]
        cache.k[li, rows, pos] = k[:, 0]
        cache.v[li, rows, pos] = v[:, 0]
        layer_k, layer_v = cache.k[li], cache.v[li]
        if quant:
            layer_k = (layer_k.float() * cache.k_scale[li][..., None]).to(act_dtype)
            layer_v = (layer_v.float() * cache.v_scale[li][..., None]).to(act_dtype)
        attn = decode_attention(q, layer_k, layer_v, cache.length + 1,
                                kv_groups=cfg.kv_groups)
        hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, 1, -1))
        hidden = _mlp_half(lp, hidden, cfg)
    hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return hidden, cache._replace(length=cache.length + 1)
