"""Weight delta / consolidation utilities over the port's parameter trees
(counterpart of `memory_augmented_vlm_tpu/checkpoint/delta.py`).

Capability parity with llava/model/{apply_delta,make_delta,consolidate}.py:
publishable deltas vs a base LM and their re-application (works on any
checkpoint the importers read).
"""

from __future__ import annotations

from typing import Any

import torch

from memory_augmented_vlm_torch.utils.tree import map_with_path, tree_map


def _overlap(b: torch.Tensor, t: torch.Tensor):
    return tuple(slice(0, min(bs, ts)) for bs, ts in zip(b.shape, t.shape))


def make_delta(base_params: Any, target_params: Any) -> Any:
    """target - base for shared leaves; leaves absent from base (multimodal
    modules) are stored whole (make_delta.py semantics: embeddings handled
    by shape, extra keys pass through)."""

    def sub(path, t):
        b = _lookup(base_params, path)
        if b is None:
            return t.clone()
        if b.shape != t.shape:  # e.g. resized embeddings: delta on the overlap
            out = t.clone()
            sl = _overlap(b, t)
            out[sl] = t[sl] - b[sl]
            return out
        return t - b

    return map_with_path(sub, target_params)


def apply_delta(base_params: Any, delta_params: Any) -> Any:
    """Inverse of make_delta (apply_delta.py semantics)."""

    def add(path, d):
        b = _lookup(base_params, path)
        if b is None:
            return d.clone()
        if b.shape != d.shape:
            out = d.clone()
            sl = _overlap(b, d)
            out[sl] = d[sl] + b[sl]
            return out
        return b + d

    return map_with_path(add, delta_params)


def _lookup(tree: Any, path) -> Any:
    node = tree
    for key in path:
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            return None
    return node


def consolidate(params: Any, dtype: torch.dtype = torch.float16) -> Any:
    """Cast a tree to a storage dtype (consolidate.py: save the fp16 full
    model)."""
    return tree_map(lambda x: x.to(dtype), params)
