"""Train-state checkpoints and the HF safetensors export (counterpart of
`memory_augmented_vlm_tpu/checkpoint/orbax_io.py`; the port has no orbax).

A train state (the port's `TrainState`, or any tree of dicts, lists,
tuples, named tuples, tensors, None and Python scalars) is saved under
`ckpt_dir/checkpoint-<step>/` as `train_state.safetensors` (every tensor,
keyed by its path, in its own dtype) and `train_state.json` (the tree's
structure with its scalars inline). `restore_checkpoint` reads it back into
the structure, dtypes, layouts and devices of a target tree. JAX's naming,
`keep` rule and `latest_checkpoint` are kept. A checkpoint is written into
`checkpoint-<step>.tmp` and renamed when whole, so `latest_checkpoint`
never sees a partial one.

`export_hf_safetensors` writes a model's parameters under the reference's
key names (the ones `hf_import` reads), fp32, with the `config.json` that
JAX's exporter writes, so that either package loads the other's export.
Prequantized int8 kernels are written dequantized, as JAX's are.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from memory_augmented_vlm_torch.checkpoint import safetensors_io
from memory_augmented_vlm_torch.config import VLMConfig

STATE_TENSORS = "train_state.safetensors"
STATE_TREE = "train_state.json"
_CHECKPOINT_DIR = re.compile(r"^checkpoint-(\d+)$")


# ---------------------------------------------------------------------------
# Train-state checkpoints
# ---------------------------------------------------------------------------

def _flatten(tree, tensors: Dict[str, torch.Tensor], path: Tuple = ()):
    """The JSON structure of `tree`; its tensors go into `tensors` by path."""
    if isinstance(tree, torch.Tensor):
        key = ".".join(str(p) for p in path) or "."
        if key in tensors:
            raise ValueError(f"two tensors of the tree have the path {key!r}")
        tensors[key] = tree
        return {"tensor": key}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"dict keys at {path} must be str")
        return {"dict": {k: _flatten(v, tensors, path + (k,)) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, tensors, path + (i,)) for i, v in enumerate(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {path}")


def _write(path: str, tensors: Dict[str, torch.Tensor], structure, step: int,
           ckpt_dir: str, keep: int):
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    safetensors_io.save_file(tensors, os.path.join(tmp, STATE_TENSORS))
    with open(os.path.join(tmp, STATE_TREE), "w") as f:
        json.dump({"step": step, "tree": structure}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    # gc only removes OLDER checkpoint dirs, once the new one is whole
    _gc_checkpoints(ckpt_dir, keep)


class _Writer:
    """The one background save in flight, and its error."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def run(self, *args):
        try:
            _write(*args)
        except Exception as e:  # noqa: BLE001 — kept for wait(), which raises it
            self.error = e

    def wait(self):
        with self.lock:
            thread, self.thread = self.thread, None
        if thread is not None:
            thread.join()
        err, self.error = self.error, None
        if err is not None:
            raise err


_WRITER = _Writer()


def save_checkpoint(ckpt_dir: str, state: Any, step: int, keep: int = 2,
                    block: bool = True) -> str:
    """Save a train state (or any tree) under ckpt_dir/checkpoint-<step>,
    then remove all but the newest `keep` checkpoint dirs (none with keep <=
    0).

    block=False returns once every tensor is copied to the host, and writes
    from a thread (training goes on, and may update the state in place:
    the copy is what is written); `wait_for_checkpoints()` joins it and
    raises its error. A new save waits for the one before it first."""
    wait_for_checkpoints()
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    tensors: Dict[str, torch.Tensor] = {}
    structure = _flatten(state, tensors)
    if block:
        _write(path, tensors, structure, step, ckpt_dir, keep)
        return path
    snapshot = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
    thread = threading.Thread(target=_WRITER.run, name=f"save checkpoint-{step}",
                              args=(path, snapshot, structure, step, ckpt_dir, keep))
    with _WRITER.lock:
        _WRITER.thread = thread
    thread.start()
    return path


def wait_for_checkpoints() -> None:
    """Block until any in-flight background save has landed on disk; raise
    its error if it failed."""
    _WRITER.wait()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint-<step> dir (auto-resume, train.py:1816)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = _CHECKPOINT_DIR.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best


def _unflatten(structure, target, f: safetensors_io.SafetensorsFile, path: Tuple = ()):
    where = ".".join(str(p) for p in path) or "the root"
    if isinstance(target, torch.Tensor):
        if "tensor" not in structure:
            raise ValueError(f"checkpoint has no tensor at {where}")
        saved = f.get(structure["tensor"])
        if tuple(saved.shape) != tuple(target.shape):
            raise ValueError(f"{where}: checkpoint shape {tuple(saved.shape)}, target "
                             f"{tuple(target.shape)}")
        out = torch.empty_strided(target.shape, target.stride(), dtype=target.dtype,
                                  device=target.device)
        return out.copy_(saved)
    if isinstance(target, dict):
        items = structure.get("dict")
        if items is None or set(items) != set(target):
            raise ValueError(f"{where}: checkpoint keys {sorted(items or ())}, target "
                             f"{sorted(target)}")
        return {k: _unflatten(items[k], v, f, path + (k,)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        items = structure.get("list", structure.get("tuple"))
        if items is None or len(items) != len(target):
            raise ValueError(f"{where}: checkpoint holds {structure}, target "
                             f"{len(target)} items")
        out = [_unflatten(s, v, f, path + (i,)) for i, (s, v) in enumerate(zip(items, target))]
        if isinstance(target, list):
            return out
        return type(target)(*out) if hasattr(target, "_fields") else tuple(out)
    if "value" not in structure:
        raise ValueError(f"{where}: checkpoint holds {structure}, target a scalar")
    return structure["value"]


def restore_checkpoint(path: str, target: Any) -> Any:
    """The checkpoint at `path` in the structure of `target`: each tensor in
    the target leaf's dtype, layout (strides) and device, each scalar as
    saved."""
    with open(os.path.join(path, STATE_TREE)) as fh:
        structure = json.load(fh)["tree"]
    with safetensors_io.SafetensorsFile(os.path.join(path, STATE_TENSORS)) as f:
        return _unflatten(structure, target, f)


def _gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    """save_total_limit equivalent (finetune_short.sh)."""
    entries = []
    for name in os.listdir(ckpt_dir):
        m = _CHECKPOINT_DIR.match(name)
        if m:
            entries.append((int(m.group(1)), name))
    for _, name in sorted(entries)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


# ---------------------------------------------------------------------------
# HF-format export (reference key naming, so either package can load it)
# ---------------------------------------------------------------------------

def _kernel(entry) -> torch.Tensor:
    """Full-precision (in, out) view of a (possibly prequantized) kernel."""
    if "kernel" in entry:
        return entry["kernel"]
    return entry["kernel_int8"].float() * entry["scale"].float().unsqueeze(-2)


def _lm_tensors(lm, cfg: VLMConfig, flat: Dict[str, torch.Tensor]):
    flat["model.embed_tokens.weight"] = lm["embed_tokens"]
    flat["model.norm.weight"] = lm["norm"]
    if "lm_head" in lm:
        flat["lm_head.weight"] = lm["lm_head"].t()
    elif not cfg.lm.tie_word_embeddings:  # the untied head lives as its int8 copy
        flat["lm_head.weight"] = lm["unembed_int8"].float() * lm["unembed_scale"][:, None]
    for i, lyr in enumerate(lm["layers"]):
        p = f"model.layers.{i}."
        flat[p + "input_layernorm.weight"] = lyr["input_layernorm"]
        flat[p + "post_attention_layernorm.weight"] = lyr["post_attention_layernorm"]
        for name in ("q_proj", "k_proj", "v_proj"):
            flat[p + f"self_attn.{name}.weight"] = _kernel(lyr[name]).t()
            if "bias" in lyr[name]:
                flat[p + f"self_attn.{name}.bias"] = lyr[name]["bias"]
        flat[p + "self_attn.o_proj.weight"] = _kernel(lyr["o_proj"]).t()
        for name in ("gate_proj", "up_proj", "down_proj"):
            flat[p + f"mlp.{name}.weight"] = _kernel(lyr[name]).t()


def _tower_tensors(vt, flat: Dict[str, torch.Tensor]):
    vp = "model.vision_tower.vision_tower.vision_model."
    flat[vp + "embeddings.patch_embedding.weight"] = vt["patch_embedding"]["weight"]
    flat[vp + "embeddings.patch_embedding.bias"] = vt["patch_embedding"]["bias"]
    flat[vp + "embeddings.position_embedding.weight"] = vt["position_embedding"]
    flat[vp + "post_layernorm.weight"] = vt["post_layernorm"]["weight"]
    flat[vp + "post_layernorm.bias"] = vt["post_layernorm"]["bias"]
    for i, lyr in enumerate(vt["layers"]):
        p = vp + f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            flat[p + f"{ln}.weight"] = lyr[ln]["weight"]
            flat[p + f"{ln}.bias"] = lyr[ln]["bias"]
        for name, tgt in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                          ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
                          ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            flat[p + f"{tgt}.weight"] = _kernel(lyr[name]).t()
            flat[p + f"{tgt}.bias"] = lyr[name]["bias"]


def _linear_tensors(prefix: str, p, flat: Dict[str, torch.Tensor]):
    flat[prefix + ".weight"] = p["kernel"].t()
    flat[prefix + ".bias"] = p["bias"]


def _attention_tensors(prefix: str, a, flat: Dict[str, torch.Tensor]):
    for name in ("q_proj", "k_proj", "v_proj"):
        _linear_tensors(prefix + name, a[name], flat)
    _linear_tensors(prefix + "residual.dense", a["residual"]["dense"], flat)
    flat[prefix + "residual.layernorm.weight"] = a["residual"]["layernorm"]["weight"]
    flat[prefix + "residual.layernorm.bias"] = a["residual"]["layernorm"]["bias"]


def _memory_tensors(mem, flat: Dict[str, torch.Tensor]):
    rmt = mem["recurrent_memory_transformer"]
    mp = "model.recurrent_memory_transformer."
    flat[mp + "initial_memory"] = rmt["initial_memory"]
    flat[mp + "memory_pos_embed"] = rmt["memory_pos_embed"]
    _attention_tensors(mp + "memory_update_attention.", rmt["memory_update_attention"], flat)
    for i, layer in enumerate(rmt["layers"]):
        lp = f"{mp}layers.{i}."
        _attention_tensors(lp + "memory_segment_fusion_attention.", layer["attention"], flat)
        _linear_tensors(lp + "mlp.0", layer["mlp"], flat)
        _linear_tensors(lp + "residual.dense", layer["residual"]["dense"], flat)
        flat[lp + "residual.layernorm.weight"] = layer["residual"]["layernorm"]["weight"]
        flat[lp + "residual.layernorm.bias"] = layer["residual"]["layernorm"]["bias"]
    _linear_tensors("model.memory_fuser.0", mem["memory_fuser"]["fc1"], flat)
    _linear_tensors("model.memory_fuser.2", mem["memory_fuser"]["fc2"], flat)
    flat["model.token_type_embedding.weight"] = mem["token_type_embedding"]
    if "image_newline" in mem:
        flat["model.image_newline"] = mem["image_newline"]


def hf_config(cfg: VLMConfig) -> dict:
    """The `config.json` JAX's exporter writes for `cfg` (orbax_io.py:196-221);
    the projector, merge and pool fields are the only values the port runs."""
    pinpoints = cfg.pipeline.image_grid_pinpoints
    return {
        "model_type": "llava_qwen",
        "vocab_size": cfg.lm.vocab_size,
        "hidden_size": cfg.lm.hidden_size,
        "intermediate_size": cfg.lm.intermediate_size,
        "num_hidden_layers": cfg.lm.num_hidden_layers,
        "num_attention_heads": cfg.lm.num_attention_heads,
        "num_key_value_heads": cfg.lm.num_key_value_heads,
        "max_position_embeddings": cfg.lm.max_position_embeddings,
        "rope_theta": cfg.lm.rope_theta,
        "tie_word_embeddings": cfg.lm.tie_word_embeddings,
        "mm_projector_type": "mlp2x_gelu",
        "mm_patch_merge_type": cfg.pipeline.mm_patch_merge_type,
        "mm_newline_position": "one_token",
        "mm_spatial_pool_mode": "bilinear",
        "image_aspect_ratio": cfg.pipeline.image_aspect_ratio,
        "image_grid_pinpoints": ([list(p) for p in pinpoints]
                                 if isinstance(pinpoints, tuple) else pinpoints),
        "tokenizer_model_max_length": cfg.pipeline.tokenizer_model_max_length,
    }


def export_hf_safetensors(params: Any, cfg: VLMConfig, out_dir: str) -> str:
    """Write `params` to `out_dir/model.safetensors` (fp32, reference key
    names) and `out_dir/config.json`. Each tensor is cast to fp32 on its
    device and copied to the host as it is written."""
    os.makedirs(out_dir, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    _lm_tensors(params["language_model"], cfg, flat)
    _tower_tensors(params["vision_tower"], flat)
    for i, lp in enumerate(params["mm_projector"]["layers"]):
        _linear_tensors(f"model.mm_projector.{i * 2}", lp, flat)
    _memory_tensors(params["memory"], flat)
    out_path = os.path.join(out_dir, "model.safetensors")
    safetensors_io.save_file(flat, out_path, dtype=torch.float32)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    return out_path
