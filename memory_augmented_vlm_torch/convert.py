"""Conversion from the JAX package's parameters and configs.

`from_jax_params` takes the pytree of `memory_augmented_vlm_tpu.models.vlm.
init_params` (or a checkpoint of it) with numpy leaves and returns the
port's parameters: the stacked (L, ...) layer arrays become lists of
per-layer dicts and the HWIO patch kernel becomes the (out, in, kh, kw)
conv weight. Dense kernels keep their (in, out) layout. Prequantized int8
entries (`kernel_int8`, `scale`, `bias`, and the LM's `unembed_int8`,
`unembed_scale`) come across as they are, each int8 kernel stored
column-major (`quant.column_major`), the layout the int8 kernels read; so
does the `w_int8` of a `pallas_int8.int8_linear` dict (`{w_int8, scale,
bias}`), through `int8_linear_params` or inside a tree, and the int8
matrices of the attention-block kernel's arguments (`attn_block_weights`).
`to_jax_layout` is the inverse layout change, for holding the port's
params, grads or per-leaf labels against JAX's leaf by leaf.
Nothing here imports JAX: the caller turns its arrays into numpy first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from memory_augmented_vlm_torch import config as port_config
from memory_augmented_vlm_torch.ops.quant import column_major


# the layer lists that the JAX package keeps stacked as (L, ...) arrays
STACKED_LAYERS = (("vision_tower", "layers"), ("language_model", "layers"),
                  ("memory", "recurrent_memory_transformer", "layers"))


# int8 (K, N) kernels, row-major in JAX, column-major in the port
INT8_KERNEL_KEYS = ("kernel_int8", "w_int8")


def under_stacked_layers(path) -> bool:
    """Whether a leaf path lies inside one of the `STACKED_LAYERS` lists."""
    return any(tuple(path[:len(p)]) == p and len(path) > len(p) for p in STACKED_LAYERS)


def _tensor(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "f" and arr.dtype not in (np.float16, np.float32, np.float64):
        arr = arr.astype(np.float32)  # ml_dtypes bfloat16 and friends
    t = torch.tensor(arr)  # a copy: the caller's arrays may be read-only
    return t.to(device=device, dtype=dtype if t.is_floating_point() and dtype else t.dtype)


def _tree(x, device, dtype):
    if isinstance(x, Mapping):
        out = {k: _tree(v, device, dtype) for k, v in x.items()}
        for key in INT8_KERNEL_KEYS:
            if key in out:
                out[key] = column_major(out[key])
        return out
    if isinstance(x, (list, tuple)):
        return [_tree(v, device, dtype) for v in x]
    return _tensor(x, device, dtype)


def int8_linear_params(qp: Mapping[str, Any], device="cuda"):
    """JAX's `pallas_int8.int8_linear` dict `{w_int8, scale, bias}` (numpy
    leaves, `w_int8` row-major) -> the port's, on `device`, with `w_int8`
    column-major."""
    return _tree(dict(qp), device, None)


def attn_block_weights(weights: Sequence[Any], device="cuda") -> List[torch.Tensor]:
    """The twelve weight arguments of JAX's `fused_attn_block_int8` (wq, sq,
    bq, wk, sk, bk, wv, sv, bv, wo, so, bo; numpy, each int8 (H, H) matrix
    row-major) -> the port's, on `device`, each int8 matrix column-major."""
    if len(weights) != 12:
        raise ValueError(f"expected 12 weight arrays, got {len(weights)}")
    out = [_tensor(x, device, None) for x in weights]
    return [column_major(x) if x.dtype == torch.int8 else x for x in out]


def _unstack(tree, n: int):
    """Stacked (L, ...) leaves -> a list of L per-layer trees."""
    def index(x, i):
        if isinstance(x, Mapping):
            return {k: index(v, i) for k, v in x.items()}
        if np.shape(x)[0] != n:
            raise ValueError(f"expected {n} stacked layers, got shape {np.shape(x)}")
        return np.asarray(x)[i]
    return [index(tree, i) for i in range(n)]


def from_jax_params(tree: Mapping[str, Any], cfg: port_config.VLMConfig,
                    device="cuda", dtype: Optional[torch.dtype] = None):
    """JAX `vlm.init_params` pytree (numpy leaves) -> the port's params on
    `device` (the card unless the caller asks for the CPU). `dtype` casts
    every floating leaf (None keeps each leaf's own)."""
    vt = tree["vision_tower"]
    vision = {
        "patch_embedding": {
            # HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw)
            "weight": np.transpose(np.asarray(vt["patch_embedding"]["kernel"]), (3, 2, 0, 1)),
            "bias": vt["patch_embedding"]["bias"],
        },
        "position_embedding": vt["position_embedding"],
        "layers": _unstack(vt["layers"], cfg.vision.num_used_layers),
        "post_layernorm": vt["post_layernorm"],
    }
    lm = dict(tree["language_model"])
    lm["layers"] = _unstack(lm["layers"], cfg.lm.num_hidden_layers)
    mem = dict(tree["memory"])
    rmt = dict(mem["recurrent_memory_transformer"])
    rmt["layers"] = _unstack(rmt["layers"], cfg.memory.depth)
    mem["recurrent_memory_transformer"] = rmt
    out = {
        "vision_tower": vision,
        "mm_projector": {"layers": list(tree["mm_projector"]["layers"])},
        "language_model": lm,
        "memory": mem,
        "positional_encoding": tree["positional_encoding"],
    }
    return _tree(out, device, dtype)


# the port takes its dtype from its parameters, not from the config
_IGNORED_FIELDS = {"dtype"}


def config_from_fields(cfg) -> port_config.VLMConfig:
    """The port `VLMConfig` of a JAX `VLMConfig` (or any object with the
    same dataclass sub-configs). A field the port does not have selects a
    mode it does not run: it must hold its default, or this raises
    `NotImplementedError`."""
    def sub(cls, obj):
        kept = {f.name for f in dataclasses.fields(cls)}
        for f in dataclasses.fields(type(obj)):
            if f.name in kept or f.name in _IGNORED_FIELDS:
                continue
            value = getattr(obj, f.name)
            if value != f.default:
                raise NotImplementedError(
                    f"{type(obj).__name__}.{f.name}={value!r} is not ported "
                    f"(the port runs {f.default!r})")
        return cls(**{name: getattr(obj, name) for name in kept})

    return port_config.VLMConfig(
        lm=sub(port_config.LMConfig, cfg.lm),
        vision=sub(port_config.VisionConfig, cfg.vision),
        memory=sub(port_config.MemoryConfig, cfg.memory),
        pipeline=sub(port_config.PipelineConfig, cfg.pipeline),
    )


def to_jax_layout(tree):
    """The port's parameter tree, or a tree of the same structure (grads,
    masks, labels), in the JAX package's layout with numpy leaves: the
    `STACKED_LAYERS` lists become stacked (L, ...) arrays and the OIHW
    patch `weight` the HWIO `kernel`. bf16 tensors come out as fp32."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    def walk(x, path):
        if isinstance(x, Mapping):
            return {k: walk(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            items = [walk(v, path + (i,)) for i, v in enumerate(x)]
            return stack(items) if path in STACKED_LAYERS else items
        return leaf(x)

    out = walk(tree, ())
    patch = out.get("vision_tower", {}).get("patch_embedding")
    if patch is not None and "weight" in patch:
        w = patch.pop("weight")
        patch["kernel"] = np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else w
    return out
