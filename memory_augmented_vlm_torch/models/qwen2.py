"""Qwen2-family decoder LM (counterpart of
`memory_augmented_vlm_tpu/models/qwen2.py`, its dense gated RoPE path with
a bf16/fp32 or int8 KV cache and float or prequantized int8 weights), with
JAX's family flags: `attention_bias` (Qwen2; Llama, Mistral and Gemma have
no q/k/v bias), `mlp_act` (SiLU, or Gemma's exact or tanh GELU),
`norm_plus_one` (Gemma's `1 + w` RMSNorm, formed in the weight's dtype) and
`scale_embeddings` (Gemma's token embeddings times sqrt(hidden), the factor
rounded to the table's dtype first; only token ids are scaled, never the
spliced visual rows, as in JAX).

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
`fused_swiglu_enabled` set, an int8 SwiGLU layer's MLP half runs as one
kernel (`swiglu_int8.fused_swiglu_block_int8`) at prefill sizes; see
`_mlp_half`.

Parameters: dense kernels are (in, out), int8 kernels (in, out) column-major
(`ops/quant.py`), q/k/v carry biases where `attention_bias`, `layers` is a
list of per-layer dicts, and the unembedding is tied to `embed_tokens` or,
for an untied LM (`tie_word_embeddings=False`, Qwen2-7B), a dense (H, V)
`lm_head`.

Decode is safe to capture in a CUDA graph: `decode_step` reads its position
from `cache.length` on the card, writes the cache in place and reads nothing
back to the host, and `forward(cache=...)` / `quantize_cache(out=...)` fill
a persistent cache whose addresses a captured decode loop keeps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from memory_augmented_vlm_torch.config import LMConfig
from memory_augmented_vlm_torch.ops.attention import (decode_attention, flash_attention,
                                                      mha_attention, repeat_kv)
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
    """Random init with the JAX init's shapes and distributions: q/k/v
    biases only with `attention_bias` (JAX `_maybe_bias`)."""
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
             "q_proj": proj(h, nh * d, cfg.attention_bias),
             "k_proj": proj(h, nkv * d, cfg.attention_bias),
             "v_proj": proj(h, nkv * d, cfg.attention_bias),
             "o_proj": proj(nh * d, h, False),
             "gate_proj": proj(h, i, False), "up_proj": proj(h, i, False),
             "down_proj": proj(i, h, False)}
            for _ in range(cfg.num_hidden_layers)
        ],
        "norm": ones(),
        **({} if cfg.tie_word_embeddings else {"lm_head": dense(h, cfg.vocab_size)}),
    }


def embed_tokens(params, input_ids: torch.Tensor,
                 cfg: Optional[LMConfig] = None) -> torch.Tensor:
    """Token embeddings; with `cfg.scale_embeddings` (Gemma) times
    sqrt(hidden_size) rounded to the table's dtype first, as JAX's. The
    factor is a Python number, so a captured decode step holds it as a
    constant of the graph."""
    out = params["embed_tokens"][input_ids]
    if cfg is not None and cfg.scale_embeddings:
        out = out * _embed_scale(cfg.hidden_size, out.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _embed_scale(hidden: int, dtype: torch.dtype) -> float:
    return torch.tensor(hidden ** 0.5, dtype=dtype).item()


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


def _act(x, act: str):
    if act == "silu":
        return F.silu(x)
    if act in ("gelu", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh" if act == "gelu_pytorch_tanh" else "none")
    raise ValueError(f"unsupported mlp_act {act!r}")


def _norm_weight(w, cfg: LMConfig):
    """An RMSNorm's scale: Gemma's `1 + w`, formed in the weight's dtype
    (JAX's `_norm`; HF's GemmaRMSNorm forms it in fp32, ROADMAP §3)."""
    return (1 + w) if cfg.norm_plus_one else w


def _norm(x, w, cfg: LMConfig):
    return rms_norm(x, _norm_weight(w, cfg), cfg.rms_norm_eps)


def _mlp(lp, x, cfg: LMConfig):
    gate = _act(_proj(lp["gate_proj"], x), cfg.mlp_act)
    return _proj(lp["down_proj"], gate * _proj(lp["up_proj"], x))


def _mlp_half(lp, hidden, cfg: LMConfig):
    """Post-attention norm + MLP + residual of one layer.

    With `fused_swiglu_enabled`, a SiLU layer whose `gate_proj` is int8 and
    has no bias runs the whole half as one kernel when `b * s >= 1024` rows
    (prefill; one decode row keeps the composed path), its norm weight
    `1 + w` under `norm_plus_one`: JAX's gate less its TPU backend test (the
    wrapper itself picks kernel or plain version by device), and less its
    MoE, ungated and LayerNorm tests, modes the port's LM does not have
    (`convert.config_from_fields` refuses them). Gemma's GELU MLP keeps the
    composed path."""
    b, s, h = hidden.shape
    gate = lp["gate_proj"]
    w = lp["post_attention_layernorm"]
    if (fused_swiglu_enabled and cfg.mlp_act == "silu" and "kernel_int8" in gate
            and "bias" not in gate and b * s >= FUSED_SWIGLU_MIN_ROWS):
        return fused_swiglu_block_int8(
            hidden.reshape(b * s, h), _norm_weight(w, cfg),
            gate["kernel_int8"], gate["scale"],
            lp["up_proj"]["kernel_int8"], lp["up_proj"]["scale"],
            lp["down_proj"]["kernel_int8"], lp["down_proj"]["scale"],
            eps=cfg.rms_norm_eps).reshape(b, s, h)
    return hidden + _mlp(lp, _norm(hidden, w, cfg), cfg)


def _rope_tables(cfg: LMConfig, positions: torch.Tensor):
    inv_freq = compute_rope_freqs(cfg.head_dim, cfg.rope_theta, positions.device)
    return rope_cos_sin(positions, inv_freq)


def _layer(lp, cfg: LMConfig, hidden, cos, sin, valid_len, differentiable: bool):
    """One decoder layer over the whole sequence: (hidden, k, v)."""
    b, s, _ = hidden.shape
    x = _norm(hidden, lp["input_layernorm"], cfg)
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
    hidden = _norm(hidden, params["norm"], cfg)
    if cache is None:
        return hidden, None
    cache.length.copy_(valid_len)
    return hidden, cache


def _write_kv(cache: KVCache, li: int, rows, pos, k, v, act_dtype, drop=None):
    """Write a layer's new K/V (B', C, Hkv, D) at cache[li, rows (B',), pos
    (B', C)] in place (an int8
    cache quantizes them on the way in, a cache of another float dtype takes
    them rounded to it) and return that layer's whole K and V for `rows`,
    dequantized or cast to the activation dtype. `drop(new, layer)` maps
    each stored tensor's new values before the write (decode_chunk_batched's
    dropped positions)."""
    quant = cache.k.dtype == torch.int8
    if quant:
        (k, k_s), (v, v_s) = quantize_kv_rows(k), quantize_kv_rows(v)
        pairs = [(cache.k, k), (cache.v, v), (cache.k_scale, k_s), (cache.v_scale, v_s)]
    else:
        pairs = [(cache.k, k.to(cache.k.dtype)), (cache.v, v.to(cache.v.dtype))]
    for dst, new in pairs:
        dst[li, rows[:, None], pos] = new if drop is None else drop(new, dst[li])
    layer_k, layer_v = cache.k[li, rows], cache.v[li, rows]
    if quant:
        layer_k = (layer_k.float() * cache.k_scale[li, rows][..., None]).to(act_dtype)
        layer_v = (layer_v.float() * cache.v_scale[li, rows][..., None]).to(act_dtype)
    # a bf16 cache under fp32 activations: the exact widening that JAX's
    # einsum promotion makes
    return layer_k.to(act_dtype), layer_v.to(act_dtype)


def _chunk_layers(params, cfg: LMConfig, hidden, qpos, mask, write):
    """The decoder layers of a chunk step: RoPE at `qpos` (B', C), each
    layer's new K/V (B', C, Hkv, D) handed to `write(li, k, v)`, which
    stores them and returns that layer's K and V for the rows in the
    activations' dtype (`_write_kv` for a contiguous cache), plain attention
    under `mask`. Returns hidden after the final norm."""
    b, c, _ = hidden.shape
    cos, sin = _rope_tables(cfg, qpos)
    for li, lp in enumerate(params["layers"]):
        x = _norm(hidden, lp["input_layernorm"], cfg)
        q, k, v = _qkv(lp, cfg, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        layer_k, layer_v = write(li, k, v)
        attn = mha_attention(q, repeat_kv(layer_k, cfg.kv_groups),
                             repeat_kv(layer_v, cfg.kv_groups), mask=mask)
        hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, c, -1))
        hidden = _mlp_half(lp, hidden, cfg)
    return _norm(hidden, params["norm"], cfg)


def forward_chunk(params, cfg: LMConfig, token_embeds: torch.Tensor, cache: KVCache,
                  start, *, row: int = 0,
                  rope_seq_len: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """C-token step against a cache prefix (JAX `qwen2.forward_chunk`):
    positions [0, start) of cache row `row` are the valid context; the chunk
    token_embeds (1, C, H) attends to that prefix plus its own causal
    triangle, and its K/V are written at positions [start, start + C) of
    that row, in place (an int8 cache quantizes on write). `start` is an int
    or a 0-d integer tensor on the cache's device; nothing is read back to
    the host. As JAX's `dynamic_update_slice`, the write window is clamped
    into the cache while the positions and the mask are not.

    The verification step of speculative decoding. Returns (hidden (1, C, H)
    after the final norm, the cache with length[row] = start + C in a new
    length tensor): callers roll `length` back on partial acceptance;
    positions past the accepted point are garbage that the next write
    overwrites.

    `rope_seq_len` is accepted and has no effect: JAX pins its dynamic-NTK
    frequency basis with it, and the port's LMConfig has no RoPE scaling
    (`convert.config_from_fields` refuses configs that use it). Attention
    is the plain `mha_attention` with JAX's mask, as JAX uses XLA here."""
    del rope_seq_len
    b, c, _ = token_embeds.shape
    smax = cache.k.shape[2]
    dev = token_embeds.device
    start = torch.as_tensor(start, dtype=torch.long, device=dev)
    steps = torch.arange(c, device=dev)
    qpos = start + steps                                        # (C,)
    write_pos = start.clamp(0, smax - c) + steps
    mask = (torch.arange(smax, device=dev)[None, :] <= qpos[:, None])[None, None]
    rows = torch.full((b,), row, dtype=torch.long, device=dev)
    hidden = _chunk_layers(
        params, cfg, token_embeds, qpos[None, :].expand(b, c), mask,
        lambda li, k, v: _write_kv(cache, li, rows, write_pos[None, :], k, v, token_embeds.dtype))
    length = torch.where(torch.arange(cache.length.shape[0], device=dev) == row,
                         (start + c).to(torch.int32), cache.length)
    return hidden, cache._replace(length=length)


def decode_chunk_batched(params, cfg: LMConfig, token_embeds: torch.Tensor, cache: KVCache,
                         starts: torch.Tensor, *,
                         rope_seq_len: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Batched K-token step with per-row start offsets (JAX
    `qwen2.decode_chunk_batched`): token_embeds (B, K, H), starts (B,) int;
    row b's chunk occupies cache positions [starts[b], starts[b] + K) and
    attends to that row's prefix plus its own causal triangle.

    Positions outside [0, Smax) write nothing, as JAX's scatter with
    `mode="drop"` (a row parked at the cache bound writes nothing). The
    write goes through an index mask, never a scatter that wraps or a read
    back to the host: each dropped position is redirected to the row's
    nearest position in range and writes that position's own new value
    (in a row with no position in range, position 0's old value), so
    duplicate indices carry equal values. Returns (hidden (B, K, H) after
    the final norm, the cache); `length` is not updated: callers own
    per-row acceptance. `rope_seq_len` has no effect (see `forward_chunk`)."""
    del rope_seq_len
    b, kk, _ = token_embeds.shape
    smax = cache.k.shape[2]
    dev = token_embeds.device
    starts = starts.to(device=dev, dtype=torch.long)
    qpos = starts[:, None] + torch.arange(kk, device=dev)[None, :]      # (B, K)
    lo = starts.clamp_min(0)[:, None]
    hi = (starts + kk - 1).clamp_max(smax - 1)[:, None]
    any_in = lo <= hi                                                   # (B, 1)
    nearest = torch.minimum(torch.maximum(qpos, lo), hi)
    write_pos = torch.where(any_in, nearest, 0)
    src = torch.where(any_in, nearest - starts[:, None], 0)             # chunk index

    def drop(new, layer):
        tail = (1,) * (new.dim() - 2)
        moved = torch.gather(new, 1, src.reshape(src.shape + tail).expand_as(new))
        return torch.where(any_in.reshape(any_in.shape + tail), moved,
                           layer[:, :1].expand_as(new))

    mask = (torch.arange(smax, device=dev)[None, None, None, :]
            <= qpos[:, None, :, None])                                  # (B, 1, K, Smax)
    rows = torch.arange(b, device=dev)
    hidden = _chunk_layers(
        params, cfg, token_embeds, qpos, mask,
        lambda li, k, v: _write_kv(cache, li, rows, write_pos, k, v, token_embeds.dtype, drop))
    return hidden, cache


def _decode_layers(params, cfg: LMConfig, token_embeds: torch.Tensor, pos: torch.Tensor,
                   valid: torch.Tensor, write) -> torch.Tensor:
    """The decoder layers of a one-token step: token_embeds (B, 1, H), RoPE
    at `pos` (B,), each layer's new K/V (B, Hkv, D) handed to
    `write(li, k, v)`, which stores them and returns that layer's K and V
    (B, Smax, Hkv, D) in the activations' dtype, and decode attention over
    the first `valid` (B,) positions. Returns hidden after the final norm."""
    b = token_embeds.shape[0]
    cos, sin = _rope_tables(cfg, pos[:, None])
    hidden = token_embeds
    for li, lp in enumerate(params["layers"]):
        x = _norm(hidden, lp["input_layernorm"], cfg)
        q, k, v = _qkv(lp, cfg, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        layer_k, layer_v = write(li, k[:, 0], v[:, 0])
        attn = decode_attention(q, layer_k, layer_v, valid, kv_groups=cfg.kv_groups)
        hidden = hidden + _proj(lp["o_proj"], attn.reshape(b, 1, -1))
        hidden = _mlp_half(lp, hidden, cfg)
    return _norm(hidden, params["norm"], cfg)


def decode_step(params, cfg: LMConfig, token_embeds: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One token per row: token_embeds (B, 1, H). Writes the new K/V at
    `cache.length` (in place; an int8 cache quantizes them on the way in)
    and returns (hidden (B, 1, H), the cache with length + 1).

    A row whose length has reached the cache's Smax positions writes as
    JAX's `decode_step` does: nothing when B > 1 (its scatter drops the
    write), and at B = 1 onto position Smax - 1 (its `dynamic_update_slice`
    clamps); its length grows all the same and its attention reads all Smax
    positions. Nothing is read back to the host: a dropped row is redirected
    to position 0 and writes that position's own old value."""
    b = token_embeds.shape[0]
    smax = cache.k.shape[2]
    quant = cache.k.dtype == torch.int8
    act_dtype = token_embeds.dtype
    pos = cache.length.long()  # (B,) — position of the new token
    rows = torch.arange(b, device=token_embeds.device)
    if b == 1:
        keep, write_pos = None, pos.clamp_max(smax - 1)
    else:
        keep = pos < smax
        write_pos = torch.where(keep, pos, 0)

    def write(li, k, v):
        if quant:
            (k, k_s), (v, v_s) = quantize_kv_rows(k), quantize_kv_rows(v)
            pairs = [(cache.k, k), (cache.v, v), (cache.k_scale, k_s), (cache.v_scale, v_s)]
        else:
            pairs = [(cache.k, k), (cache.v, v)]
        for dst, new in pairs:
            if keep is not None:
                old = dst[li, rows, write_pos]
                new = torch.where(keep.view(-1, *(1,) * (new.dim() - 1)), new.to(dst.dtype), old)
            dst[li, rows, write_pos] = new
        layer_k, layer_v = cache.k[li], cache.v[li]
        if quant:
            layer_k = layer_k.float() * cache.k_scale[li][..., None]
            layer_v = layer_v.float() * cache.v_scale[li][..., None]
        # a no-op where the cache holds the activations' dtype
        return layer_k.to(act_dtype), layer_v.to(act_dtype)

    hidden = _decode_layers(params, cfg, token_embeds, pos, cache.length + 1, write)
    return hidden, cache._replace(length=cache.length + 1)
