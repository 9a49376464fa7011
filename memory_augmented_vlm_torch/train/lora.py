"""LoRA — low-rank adaptation of the LM (counterpart of
`memory_augmented_vlm_tpu/train/lora.py`; the reference's peft
integration, train.py:267-280 `find_all_linear_names`, :1507-1543):

  - `init_lora` makes (A, B) factors for every projection kernel of the
    language model whose path matches the target list (default: all linear
    projections), A ~ N(0, 1/r) from an explicit `torch.Generator`, B = 0;
  - `apply_lora` returns merged params `W + scale * A @ B` (scale = alpha /
    r, peft's) — per step in training, the base detached, and once at
    export (`merge_and_unload`);
  - QLoRA: factors ride over int8 bases (`kernel_int8` of
    `qwen2.prequantize_int8`), dequantized to bf16 for the merge. The int4
    base (JAX's `prequantize_int8(bits=4)`) is not ported (ROADMAP §1
    item 8) and raises.

The factor tree holds only the targets, per layer as the port keeps its
layers: `{"language_model": {"layers": [{"q_proj": {"kernel": {"a": (in,
r), "b": (r, out)}}, ...}, ...]}}` (JAX's stacks each factor over the
layers and keeps None elsewhere; `convert.lora_from_jax` carries JAX's
across). `make_lora_train_step` trains the factors alone over a fixed base.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.convert import under_stacked_layers
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig
from memory_augmented_vlm_torch.utils.tree import path_str, tree_map


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: int = 16
    dropout: float = 0.0
    target_modules: Sequence[str] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.r


_KERNEL_KEYS = ("kernel", "kernel_int8")


def _no_int4(p: dict) -> None:
    if "kernel_int4" in p:
        raise NotImplementedError("LoRA over an int4 base is not ported: the port has no "
                                  "prequantize_int8(bits=4) (ROADMAP §1 item 8)")


def _is_target(path, leaf, cfg: LoraConfig) -> bool:
    s = path_str(path)
    return (s.startswith("language_model") and s.endswith(_KERNEL_KEYS)
            and any(t in s for t in cfg.target_modules)
            and leaf.dim() + under_stacked_layers(path) >= 2)


def init_lora(params: Any, cfg: LoraConfig, generator: torch.Generator) -> Any:
    """(A, B) factors for each targeted kernel, drawn in leaf order on the
    generator's device: A ~ N(0, 1) / r, B = 0 (adapters start as the
    identity). bf16 over int8 bases (QLoRA), the kernel's dtype otherwise."""
    def make(tree, path):
        if isinstance(tree, dict):
            _no_int4(tree)
            out = {k: make(v, path + (k,)) for k, v in tree.items()}
            out = {k: v for k, v in out.items() if v is not None}
            return out or None
        if isinstance(tree, (list, tuple)):
            out = [make(v, path + (i,)) for i, v in enumerate(tree)]
            return out if any(v is not None for v in out) else None
        if not isinstance(tree, torch.Tensor) or not _is_target(path, tree, cfg):
            return None
        d_in, d_out = tree.shape[-2:]
        dtype = tree.dtype if path[-1] == "kernel" else torch.bfloat16
        a = torch.randn((d_in, cfg.r), generator=generator, device=generator.device) / cfg.r
        return {"a": a.to(tree.device, dtype),
                "b": torch.zeros((cfg.r, d_out), dtype=dtype, device=tree.device)}

    return make(params, ()) or {}


def _dequant_kernel(p: dict) -> torch.Tensor:
    """Full-precision view of a (possibly int8) projection kernel."""
    if "kernel" in p:
        return p["kernel"]
    return (p["kernel_int8"].float() * p["scale"].unsqueeze(-2)).to(torch.bfloat16)


def apply_lora(params: Any, lora: Any, cfg: LoraConfig, *, freeze_base: bool = False) -> Any:
    """Merged params `W + scale * A @ B` where `lora` has factors;
    `freeze_base` detaches W (training: only the factors learn). An int8
    base is dequantized into a plain `kernel` entry; the stored base stays
    int8."""
    def merge(p, f):
        if isinstance(p, dict):
            _no_int4(p)
            key = next((k for k in _KERNEL_KEYS if k in p), None)
            fac = f.get(key) if key is not None and isinstance(f, dict) else None
            if fac is not None:
                base = _dequant_kernel(p)
                if freeze_base:
                    base = base.detach()
                delta = (fac["a"] @ fac["b"]) * cfg.scale
                merged = base + delta.to(base.dtype)
                # the kernel where it stood, the bias kept, an int8 scale dropped
                return {("kernel" if k == key else k): (merged if k == key else v)
                        for k, v in p.items() if k in (key, "bias")}
            f = f if isinstance(f, dict) else {}
            return {k: merge(v, f.get(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            f = f if isinstance(f, (list, tuple)) else [None] * len(p)
            return [merge(v, fv) for v, fv in zip(p, f)]
        return p

    return merge(params, lora)


def merge_and_unload(params: Any, lora: Any, cfg: LoraConfig) -> Any:
    """The peft merge_and_unload equivalent (builder.py LoRA-merge load path)."""
    return apply_lora(params, lora, cfg, freeze_base=False)


def lora_trainable_mask(params: Any, lora: Any):
    """(params all False, factors all True): the masks of a (params, lora)
    pair, as JAX's."""
    return tree_map(lambda _: False, params), tree_map(lambda _: True, lora)


def make_lora_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig, lora_cfg: LoraConfig, *,
                         nseg: Optional[int] = None, drop_frames: bool = False):
    """`step(state, base_params, batch) -> (state, metrics)` where
    `state.params` is the factor tree (`trainer.init_train_state(lora,
    opt_cfg)`; `opt_cfg.mm_tunable_parts` must name `mm_language_model`):
    the loss of the merged params, the base detached, so only the factors
    take gradients and updates. A `TextBatch` without `nseg`, a
    `TrainBatch` with it."""
    def step(state: trainer_mod.TrainState, base_params, batch):
        def loss_fn(factors):
            merged = apply_lora(base_params, factors, lora_cfg, freeze_base=True)
            if nseg is None:
                return trainer_mod.text_loss(merged, cfg, batch)
            return trainer_mod.multimodal_loss(merged, cfg, batch, nseg=nseg,
                                               drop_frames=drop_frames)

        return trainer_mod._step(loss_fn, state, opt_cfg)

    return step
