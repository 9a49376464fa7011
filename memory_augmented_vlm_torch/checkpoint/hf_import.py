"""HF checkpoint -> the port's parameter trees (counterpart of
`memory_augmented_vlm_tpu/checkpoint/hf_import.py`: `convert_qwen2`,
`convert_siglip`, `convert_projector`, `convert_memory_modules`).

The converters read a `Tensors`: HF-named tensors of a source with
`keys()` and `get(name)` (`safetensors_io.CheckpointReader`, or a
`state_dict()` mapping), under names that `strip` and `rename` derive
without reading anything. Each tensor is read when a converter asks for it,
moved to the target device, cast to the target dtype and laid out there,
one at a time, so the host holds one tensor at a time. The trees are the
port's (`convert.from_jax_params` gives the same from JAX's converters):
per-layer lists, dense kernels (in, out), the patch conv (out, in, kh, kw),
an untied `lm_head` (H, V), and q/k/v biases only where the checkpoint has
them. The Qwen2 LM and the `mlp2x_gelu` projector are the ones ported:
Mixtral, Qwen-MoE, MPT and the other projectors are ROADMAP §1 item 8.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import torch

from memory_augmented_vlm_torch.config import LMConfig, VisionConfig


class Tensors:
    """A source's tensors under derived names, each read on demand onto
    `device` in `dtype` (floating tensors only; None keeps the file's)."""

    def __init__(self, source, device="cuda", dtype: Optional[torch.dtype] = None,
                 names: Optional[Dict[str, str]] = None):
        if isinstance(source, Mapping):
            source = _MappingSource(source)
        self.source, self.device, self.dtype = source, device, dtype
        self.names = {k: k for k in source.keys()} if names is None else names

    def keys(self) -> List[str]:
        return list(self.names)

    def __contains__(self, name) -> bool:
        return name in self.names

    def shape(self, name):
        return tuple(self.source.shape(self.names[name]))

    def __getitem__(self, name) -> torch.Tensor:
        t = self.source.get(self.names[name])
        dtype = self.dtype if t.is_floating_point() and self.dtype is not None else t.dtype
        # a copy even where nothing changes: the result must not hold the file
        return t.to(device=self.device, dtype=dtype, copy=True)

    def dense(self, name) -> torch.Tensor:
        """A torch (out, in) Linear weight as the port's (in, out) kernel."""
        return self[name].t().contiguous()

    def rename(self, fn: Callable[[str], Optional[str]]) -> "Tensors":
        """The tensors under `fn(name)`; a name it maps to None is dropped."""
        names = {}
        for k, orig in self.names.items():
            new = fn(k)
            if new is not None:
                names[new] = orig
        return Tensors(self.source, self.device, self.dtype, names)

    def strip(self, prefixes: Sequence[str]) -> "Tensors":
        """The tensors whose name starts with one of `prefixes`, under the
        name less the first that matches; all of them as they are when none
        matches (JAX's `_strip_prefix`)."""
        def fn(k):
            return next((k[len(p):] for p in prefixes if k.startswith(p)), None)
        out = self.rename(fn)
        return out if out.names else self


class _MappingSource:
    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        self._tensors = tensors

    def keys(self) -> Iterable[str]:
        return self._tensors.keys()

    def shape(self, name):
        return tuple(self._tensors[name].shape)

    def get(self, name) -> torch.Tensor:
        return self._tensors[name].detach()


def _strip_model(sd: Tensors) -> Tensors:
    return sd.rename(lambda k: re.sub(r"^model\.", "", k))


def _proj(sd: Tensors, prefix: str) -> dict:
    """A Linear as {kernel, bias}; the bias only where the checkpoint has it."""
    out = {"kernel": sd.dense(prefix + ".weight")}
    if prefix + ".bias" in sd:
        out["bias"] = sd[prefix + ".bias"]
    return out


def _linear(sd: Tensors, prefix: str) -> dict:
    return {"kernel": sd.dense(prefix + ".weight"), "bias": sd[prefix + ".bias"]}


def _layernorm(sd: Tensors, prefix: str) -> dict:
    return {"weight": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def convert_qwen2(sd: Tensors, cfg: LMConfig) -> dict:
    """HF Qwen2 weights (with or without the `model.` prefix) -> the port's
    LM tree (JAX `convert_qwen2`)."""
    if "model.embed_tokens.weight" in sd:
        sd = _strip_model(sd)
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        layers.append({
            "input_layernorm": sd[p + "input_layernorm.weight"],
            "post_attention_layernorm": sd[p + "post_attention_layernorm.weight"],
            "q_proj": _proj(sd, p + "self_attn.q_proj"),
            "k_proj": _proj(sd, p + "self_attn.k_proj"),
            "v_proj": _proj(sd, p + "self_attn.v_proj"),
            "o_proj": {"kernel": sd.dense(p + "self_attn.o_proj.weight")},
            "gate_proj": {"kernel": sd.dense(p + "mlp.gate_proj.weight")},
            "up_proj": {"kernel": sd.dense(p + "mlp.up_proj.weight")},
            "down_proj": {"kernel": sd.dense(p + "mlp.down_proj.weight")},
        })
    params = {"embed_tokens": sd["embed_tokens.weight"], "layers": layers,
              "norm": sd["norm.weight"]}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = sd.dense("lm_head.weight")
    return params


SIGLIP_PREFIXES = ("model.vision_tower.vision_tower.vision_model.",
                   "vision_tower.vision_tower.vision_model.",
                   "vision_tower.vision_model.", "vision_model.")


def convert_siglip(sd: Tensors, cfg: VisionConfig) -> dict:
    """HF SigLIP vision weights -> the port's tower tree (JAX
    `convert_siglip`): the first `cfg.num_used_layers` encoder layers (the
    reference drops the last layer and the pooling head), the patch conv as
    it is (OIHW)."""
    sd = sd.strip(SIGLIP_PREFIXES)
    layers = []
    for i in range(cfg.num_used_layers):
        p = f"encoder.layers.{i}."
        layers.append({
            "layer_norm1": _layernorm(sd, p + "layer_norm1"),
            "layer_norm2": _layernorm(sd, p + "layer_norm2"),
            **{name: _linear(sd, p + "self_attn." + name)
               for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "fc1": _linear(sd, p + "mlp.fc1"), "fc2": _linear(sd, p + "mlp.fc2"),
        })
    return {
        "patch_embedding": {"weight": sd["embeddings.patch_embedding.weight"],
                            "bias": sd["embeddings.patch_embedding.bias"]},
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "layers": layers,
        "post_layernorm": _layernorm(sd, "post_layernorm"),
    }


def convert_projector(sd: Tensors, projector_type: str = "mlp2x_gelu") -> dict:
    """`mm_projector.{0,2}.*` -> the port's projector tree (JAX
    `convert_projector` for `mlp2x_gelu`, the one projector the port runs)."""
    if projector_type != "mlp2x_gelu":
        raise NotImplementedError(f"mm_projector_type {projector_type!r} is not ported "
                                  "(ROADMAP §1 item 8); the port runs 'mlp2x_gelu'")
    sd = sd.strip(("model.mm_projector.", "mm_projector."))
    # nn.Sequential indices 0 and 2, the GELU between them
    return {"layers": [_linear(sd, "0"), _linear(sd, "2")]}


def _memory_attention(sd: Tensors, prefix: str) -> dict:
    return {
        "q_proj": _linear(sd, prefix + "q_proj"),
        "k_proj": _linear(sd, prefix + "k_proj"),
        "v_proj": _linear(sd, prefix + "v_proj"),
        "residual": {"dense": _linear(sd, prefix + "residual.dense"),
                     "layernorm": _layernorm(sd, prefix + "residual.layernorm")},
    }


def convert_memory_modules(sd: Tensors, depth: int = 2) -> dict:
    """The reference's memory-module weights -> the port's memory tree (JAX
    `convert_memory_modules`; key names of llava_arch.py:131-150 and
    MemoryController.py:74-87):
      recurrent_memory_transformer.{initial_memory, memory_pos_embed,
        memory_update_attention.*, layers.N.*}
      memory_fuser.{0,2}.{weight,bias}
      token_type_embedding.weight
      image_newline (optional)"""
    sd = _strip_model(sd)
    rmt = "recurrent_memory_transformer."
    layers = []
    for i in range(depth):
        lp = f"{rmt}layers.{i}."
        layers.append({
            "attention": _memory_attention(sd, lp + "memory_segment_fusion_attention."),
            "mlp": _linear(sd, lp + "mlp.0"),
            "residual": {"dense": _linear(sd, lp + "residual.dense"),
                         "layernorm": _layernorm(sd, lp + "residual.layernorm")},
        })
    params = {
        "recurrent_memory_transformer": {
            "initial_memory": sd[rmt + "initial_memory"],
            "memory_pos_embed": sd[rmt + "memory_pos_embed"],
            "memory_update_attention": _memory_attention(sd, rmt + "memory_update_attention."),
            "layers": layers,
        },
        "memory_fuser": {"fc1": _linear(sd, "memory_fuser.0"),
                         "fc2": _linear(sd, "memory_fuser.2")},
        "token_type_embedding": sd["token_type_embedding.weight"],
    }
    if "image_newline" in sd:
        params["image_newline"] = sd["image_newline"]
    return params
