"""AdamW with per-module learning-rate groups and selective trainability
(counterpart of `memory_augmented_vlm_tpu/train/optimizer.py`, in optax's
semantics).

Leaves are labelled from their dotted paths (`utils/tree.path_str`), so the
rules read as they do in JAX: the port's paths carry list indices where
JAX's stacked layer arrays carry none, which no prefix or substring rule
sees, and `decay_mask` counts a stacked layer's leading axis as JAX does.

`build_optimizer(params, cfg)` returns an `Optimizer` with optax's
`init(params)` and `update(grads, state, params) -> (updates, state)`; the
caller adds `updates` to the params. The update follows optax's chain:

  1. frozen leaves' grads are zeroed (before the clip, so frozen modules do
     not inflate the norm);
  2. `clip_by_global_norm`: g if norm < max_norm, else g / norm * max_norm
     (optax's formula, not torch's max / (norm + 1e-6));
  3. AdamW per LR group: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
     in the param dtype, u = mu_hat / (sqrt(nu_hat) + eps) + wd * p where
     `decay_mask`, times -lr(count) read before the count is incremented;
     each group keeps its own count, as each optax.adamw of a
     `multi_transform` does. Every constant is rounded to the param dtype
     first, as JAX rounds a Python scalar to its array's dtype, and the
     bias corrections are computed in fp32, as optax computes them;
  4. frozen leaves' updates are zero, so they stay bit-identical.

Frozen leaves hold no moments here (optax keeps zeros for them, which
never change). Global norms add the leaves' sums as optax does, in JAX's
leaf order and in the tree's dtype (`global_norm`), so a bf16 clip is
optax's to the bit.

With `grad_accum_steps` k > 1 the chain is wrapped as JAX wraps it in
`optax.MultiSteps(tx, every_k_schedule=k)` (`MultiStepsState`): each
micro-step folds its grads into a Welford mean `acc + (g - acc) / (n + 1)`
kept in the param dtype; the k-th runs the chain above on that mean,
returns its updates, keeps its state (so the LR schedule counts
accumulated steps) and resets the mean to 0. The other k - 1 return None
for the updates: optax runs the chain there too and keeps nothing of it
(its state stays, its updates are multiplied by 0), so the port skips it.
Frozen leaves hold no mean (the chain zeroes their grads first).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from memory_augmented_vlm_torch.convert import STACKED_LAYERS, under_stacked_layers
from memory_augmented_vlm_torch.utils.tree import (leaves_with_path, map_with_path, path_str,
                                                   tree_map)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-6          # LM lr (finetune_short.sh)
    mm_projector_lr: Optional[float] = None
    mm_vision_tower_lr: Optional[float] = 2e-6
    memory_transformer_lr: Optional[float] = 1e-5
    memory_key_value_lr: Optional[float] = 1e-5
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    schedule: str = "cosine"             # cosine | constant (HF lr_scheduler_type)
    mm_tunable_parts: str = "larimar_model,recurrent_model,mm_language_model"
    grad_accum_steps: int = 1            # gradient_accumulation_steps


TUNABLE_PART_PREFIXES = {
    "mm_language_model": ("language_model",),
    "larimar_model": ("memory.token_type_embedding", "memory.memory_fuser",
                      "memory.image_newline"),
    "recurrent_model": ("memory.recurrent_memory_transformer",),
    "mm_mlp_adapter": ("mm_projector",),
    "mm_vision_tower": ("vision_tower",),
    "mm_resampler": ("vision_resampler",),
    "value_head": ("value_head",),
}


def trainable_mask(params: Any, mm_tunable_parts: str) -> Any:
    """Bool tree: True = trainable, per mm_tunable_parts."""
    parts = [p.strip() for p in mm_tunable_parts.split(",") if p.strip()]
    prefixes: list = []
    for part in parts:
        if part not in TUNABLE_PART_PREFIXES:
            raise ValueError(f"unknown mm_tunable_part: {part}")
        prefixes.extend(TUNABLE_PART_PREFIXES[part])
    return map_with_path(lambda path, _: path_str(path).startswith(tuple(prefixes)), params)


def lr_group_labels(params: Any, cfg: OptimizerConfig) -> Any:
    """String-label tree mirroring the reference's substring lr_mapper."""
    mapper = []
    if cfg.mm_projector_lr is not None:
        mapper.append(("mm_projector", "projector"))
    if cfg.mm_vision_tower_lr is not None:
        mapper.append(("vision_tower", "tower"))
    if cfg.memory_transformer_lr is not None:
        mapper.append(("recurrent_memory_transformer", "memory_transformer"))
    if cfg.memory_key_value_lr is not None:
        mapper.append(("token_type_embedding", "memory_kv"))
        mapper.append(("memory_fuser", "memory_kv"))

    def label(path, _):
        s = path_str(path)
        return next((name for keyword, name in mapper if keyword in s), "default")

    return map_with_path(label, params)


def decay_mask(params: Any) -> Any:
    """Weight-decay mask: no biases, norms or leaves of fewer than 2 dims, a
    leaf inside a stacked layer list counting the layer axis JAX has."""
    def is_decay(path, leaf):
        s = path_str(path)
        if s.endswith("bias"):
            return False
        if "layernorm" in s.lower() or "norm" in s.split(".")[-1].lower():
            return False
        return leaf.dim() + under_stacked_layers(path) >= 2

    return map_with_path(is_decay, params)


def make_schedule(cfg: OptimizerConfig, base_lr: float) -> Callable[[int], float]:
    """lr(count) as optax's `warmup_cosine_decay_schedule(0, base_lr, warmup,
    max(total_steps, warmup + 1))` (warmup counted inside the decay steps),
    or a linear warmup into a constant."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 0)
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        if cfg.schedule == "constant":
            return base_lr
        t = min(count - warmup, decay_steps)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    return schedule


class OptState(NamedTuple):
    count: Dict[str, int]  # per LR group: updates taken
    mu: Any                # tree; None on frozen leaves
    nu: Any


class MultiStepsState(NamedTuple):
    """optax's `MultiStepsState` less its (empty) skip state."""
    mini_step: int        # micro-steps folded into acc_grads, 0..k-1
    gradient_step: int    # accumulated updates applied
    inner_opt_state: OptState
    acc_grads: Any        # tree: the mean so far, param dtype; None on frozen leaves


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], Any]


def _jax_leaf_groups(tree, path=()):
    """The port's leaves grouped as the JAX layout's leaves, in JAX's
    flatten order (dict keys sorted; a `STACKED_LAYERS` list is one leaf
    per key, stacked over the layers)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_leaf_groups(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and path in STACKED_LAYERS:
        yield from _stacked_groups(tree)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_leaf_groups(v, path + (i,))
    else:
        yield [tree]


def _stacked_groups(layers):
    if isinstance(layers[0], dict):
        for k in sorted(layers[0]):
            yield from _stacked_groups([layer[k] for layer in layers])
    else:
        yield list(layers)


def global_norm(tree) -> torch.Tensor:
    """`optax.global_norm`: per JAX leaf, the fp32 sum of its squares (each
    square in the leaf's dtype) rounded to that dtype; those sums added one
    by one in JAX's leaf order, in the promoted dtype (bf16 for a bf16
    tree), and the square root of the total."""
    total = None
    for group in _jax_leaf_groups(tree):
        s = None
        for x in group:
            sq = torch.sum(x * x, dtype=torch.float32)
            s = sq if s is None else s + sq
        s = s.to(group[0].dtype)
        total = s if total is None else total + s
    return total.sqrt()


def build_optimizer(params: Any, cfg: OptimizerConfig) -> Optimizer:
    """AdamW with LR groups, trainability masking and global-norm clipping,
    accumulated over `cfg.grad_accum_steps` micro-steps when above 1."""
    group_lrs = {
        "default": cfg.learning_rate,
        "projector": cfg.mm_projector_lr or cfg.learning_rate,
        "tower": cfg.mm_vision_tower_lr or cfg.learning_rate,
        "memory_transformer": cfg.memory_transformer_lr or cfg.learning_rate,
        "memory_kv": cfg.memory_key_value_lr or cfg.learning_rate,
    }
    labels = lr_group_labels(params, cfg)
    schedules = {name: make_schedule(cfg, group_lrs[name])
                 for name in {label for _, label in leaves_with_path(labels)}}
    trainable = trainable_mask(params, cfg.mm_tunable_parts)
    decay = decay_mask(params)
    b1, b2 = cfg.betas

    def init(params) -> OptState:
        def zeros(_, p, train):
            return torch.zeros_like(p) if train else None

        return OptState({name: 0 for name in schedules},
                        map_with_path(zeros, params, trainable),
                        map_with_path(zeros, params, trainable))

    def update(grads, state: OptState, params):
        grads = tree_map(lambda g, train: g if train else torch.zeros_like(g),
                         grads, trainable)
        if cfg.max_grad_norm:
            norm = global_norm(grads)
            grads = tree_map(lambda g: torch.where(
                norm < cfg.max_grad_norm, g, g / norm.to(g.dtype) * cfg.max_grad_norm), grads)

        def adamw(_, g, p, mu, nu, label, train, wd):
            if not train:
                return torch.zeros_like(p), None, None
            return adamw_leaf(g, p, mu, nu, state.count[label] + 1, b1, b2, cfg.eps,
                              cfg.weight_decay if wd else 0.0,
                              schedules[label](state.count[label]))

        out = map_with_path(adamw, grads, params, state.mu, state.nu, labels, trainable, decay)
        updates, mu, nu = (_pick(out, i) for i in range(3))
        return updates, OptState({name: c + 1 for name, c in state.count.items()}, mu, nu)

    if cfg.grad_accum_steps > 1:
        return _multi_steps(Optimizer(init, update), trainable, cfg.grad_accum_steps)
    return Optimizer(init, update)


def adamw_leaf(g, p, mu, nu, count: int, b1: float, b2: float, eps: float,
               weight_decay: float, lr: float):
    """One leaf's AdamW step in optax's semantics, its `count`-th update:
    (update, mu, nu), the update -lr * (mu_hat / (sqrt(nu_hat) + eps) +
    weight_decay * p). Each constant is rounded to the leaf's dtype first
    and the bias corrections are formed in fp32, as optax forms them."""
    r = functools.partial(_rounded, dtype=p.dtype)
    n = np.float32(count)
    mu = r(1 - b1) * g + r(b1) * mu
    nu = r(1 - b2) * (g * g) + r(b2) * nu
    bc1 = r(np.float32(1) - np.float32(b1) ** n)
    bc2 = r(np.float32(1) - np.float32(b2) ** n)
    u = (mu / bc1) / ((nu / bc2).sqrt() + r(eps))
    if weight_decay:
        u = u + r(weight_decay) * p
    return r(-lr) * u, mu, nu


def _multi_steps(inner: Optimizer, trainable, k: int) -> Optimizer:
    """`optax.MultiSteps(inner, every_k_schedule=k)` with the grad mean;
    `update` returns None for the updates on the micro-steps that apply
    nothing."""
    def init(params) -> MultiStepsState:
        acc = tree_map(lambda p, train: torch.zeros_like(p) if train else None,
                       params, trainable)
        return MultiStepsState(0, 0, inner.init(params), acc)

    def update(grads, state: MultiStepsState, params):
        n = state.mini_step

        def fold(g, acc):
            if acc is None:  # frozen: the chain zeroes it
                return None
            # divided by a tensor: CUDA turns a division by a Python scalar
            # into a product with its reciprocal, which optax's is not
            return acc + (g - acc) / torch.full((), n + 1, dtype=acc.dtype, device=acc.device)

        acc = tree_map(fold, grads, state.acc_grads)
        if n < k - 1:
            return None, MultiStepsState(n + 1, state.gradient_step, state.inner_opt_state, acc)
        mean = tree_map(lambda g, a: g if a is None else a, grads, acc)
        updates, inner_state = inner.update(mean, state.inner_opt_state, params)
        # optax's reset, (1 - emit) * acc: a NaN in the mean stays
        return updates, MultiStepsState(0, state.gradient_step + 1, inner_state,
                                        tree_map(lambda a: None if a is None else a * 0, acc))

    return Optimizer(init, update)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`, as JAX rounds a Python scalar to the dtype of
    the array it meets (bf16: 0.999 becomes 1.0, 0.9 becomes 0.8984375)."""
    return torch.tensor(float(x), dtype=dtype).item()


def _pick(tree, i):
    """The i-th entry of every (update, mu, nu) tuple leaf of `tree`."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
