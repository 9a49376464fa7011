"""The multimodal train step (counterpart of
`memory_augmented_vlm_tpu/train/trainer.py`, its single-device path).

loss -> grads of every parameter -> AdamW in optax's semantics
(`train/optimizer.py`) -> new params. Where JAX differentiates a pure
function of the whole param tree, the port hands `torch.autograd.grad` a
fresh leaf per parameter (`value_and_grad_params`), so the step is a
function of its `TrainState` as in JAX: a leaf that takes no part in the
loss (the tower and projector behind `encode_frames`' detach) gets a zero
gradient, as under `stop_gradient`, and the frozen temporal PE table gets
its real one. `grad_norm` is the global norm of all of them, before any
masking, as JAX reports it.

What differs from JAX, and why:
  - the per-sample memory stream is a loop over the batch where JAX vmaps
    it, because the port's memory loop branches on host values
    (`frame_valid` comes to the host);
  - `cross_entropy` runs the chunked loss on the card and the dense one on
    the CPU, as JAX dispatches on its backend; each 512-row chunk of the
    chunked loss runs under `torch.utils.checkpoint`, so the (S, vocab)
    fp32 logits and their gradient are never whole;
  - position skipping and synced frame dropout draw from `jax.random` and
    are not ported; gradient accumulation neither (`build_optimizer`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.constants import IGNORE_INDEX
from memory_augmented_vlm_torch.models import qwen2, vlm
from memory_augmented_vlm_torch.train.optimizer import (OptimizerConfig, OptState,
                                                        build_optimizer, global_norm)
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, tree_map


class TrainBatch(NamedTuple):
    """One bucketed multimodal batch (all samples share Fmax/nfine/St)."""

    pixels: torch.Tensor         # (B, Fmax, img, img, 3)
    frame_indices: torch.Tensor  # (B, Fmax) int — original indices for PE
    frame_valid: torch.Tensor    # (B, Fmax) bool
    fine_idx: torch.Tensor       # (B, nfine) int
    input_ids: torch.Tensor      # (B, St) int, <image> sentinel removed
    labels: torch.Tensor         # (B, St) int, IGNORE_INDEX on non-targets
    image_pos: torch.Tensor      # (B,) int — insertion offset in input_ids
    text_len: torch.Tensor       # (B,) int — valid text length


class TextBatch(NamedTuple):
    input_ids: torch.Tensor  # (B, St)
    labels: torch.Tensor     # (B, St)
    text_len: torch.Tensor   # (B,)


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def _splice_batched(text_embeds, visual, image_pos, labels, ignore):
    """Insert (B, Lvis, H) visual streams at per-sample positions:
    (B, St, H) text embeds -> (B, St+Lvis, H) embeds and (B, St+Lvis)
    labels with `ignore` over the visual positions."""
    b, st, h = text_embeds.shape
    lvis = visual.shape[1]
    j = torch.arange(st + lvis, device=text_embeds.device)[None, :]
    pos = image_pos.to(text_embeds.device).long()[:, None]
    in_visual = (j >= pos) & (j < pos + lvis)
    text_idx = torch.where(j < pos, j, j - lvis).clamp(0, st - 1)
    vis_idx = (j - pos).clamp(0, lvis - 1)
    gathered_text = torch.gather(text_embeds, 1, text_idx[..., None].expand(-1, -1, h))
    gathered_vis = torch.gather(visual, 1, vis_idx[..., None].expand(-1, -1, h))
    embeds = torch.where(in_visual[..., None], gathered_vis, gathered_text)
    lab = torch.gather(labels.to(text_embeds.device), 1, text_idx)
    return embeds, torch.where(in_visual, torch.full_like(lab, ignore), lab)


def _targets(labels, valid_len):
    """Next-token targets (labels[:, 1:] then IGNORE_INDEX) and their mask:
    not ignored, and before valid_len - 1."""
    b, s = labels.shape
    targets = torch.cat([labels[:, 1:], labels.new_full((b, 1), IGNORE_INDEX)], dim=1)
    pos_ok = torch.arange(s, device=labels.device)[None, :] < (valid_len[:, None] - 1)
    return targets, (targets != IGNORE_INDEX) & pos_ok


def _nll_sum(hidden, table, targets, mask):
    """Summed masked NLL of fp32 logits against the tied (V, H) table in
    fp32 (`qwen2.unembed`'s float path)."""
    logits = F.linear(hidden.float(), table)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    return ((logz - tgt) * mask).sum()


def dense_cross_entropy(params, cfg: VLMConfig, hidden, labels, valid_len):
    """Next-token CE over the whole (B, S, vocab) fp32 logits. Returns
    (mean loss, token count)."""
    targets, mask = _targets(labels, valid_len)
    total = _nll_sum(hidden, params["language_model"]["embed_tokens"].float(), targets, mask)
    cnt = mask.sum()
    return total / cnt.clamp_min(1), cnt


def chunked_cross_entropy(params, cfg: VLMConfig, hidden, labels, valid_len,
                          chunk: int = 512):
    """The same loss in `chunk`-row pieces along the sequence, each under
    checkpoint: only one piece's logits exist at a time, in the forward and
    again in the backward. The table is cast to fp32 once for all pieces."""
    targets, mask = _targets(labels, valid_len)
    table = params["language_model"]["embed_tokens"].float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, hidden.shape[1], chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_nll_sum, hidden[:, sl], table, targets[:, sl],
                                   mask[:, sl], use_reentrant=False)
    cnt = mask.sum()
    return total / cnt.clamp_min(1), cnt


def cross_entropy(params, cfg: VLMConfig, hidden, labels, valid_len, chunk: int = 512):
    """Chunked on the card, dense on the CPU."""
    if hidden.device.type == "cuda":
        return chunked_cross_entropy(params, cfg, hidden, labels, valid_len, chunk)
    return dense_cross_entropy(params, cfg, hidden, labels, valid_len)


def _lm_loss(params, cfg: VLMConfig, embeds, labels, valid_len):
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    hidden, _ = qwen2.forward(params["language_model"], cfg.lm, embeds, positions,
                              valid_len=valid_len, remat=True,
                              differentiable_attention=True, need_cache=False)
    loss, count = cross_entropy(params, cfg, hidden, labels, valid_len)
    return loss, {"loss": loss, "target_tokens": count}


def multimodal_loss(params, cfg: VLMConfig, batch: TrainBatch, *, nseg: int,
                    drop_frames: bool = False, pos_skip_key=None):
    """Fusion + LM loss for one bucketed batch: (loss, metrics)."""
    if pos_skip_key is not None:
        raise NotImplementedError("position skipping draws from jax.random and is not ported")
    b, fmax = batch.pixels.shape[:2]
    feats = vlm.encode_frames(params, cfg, batch.pixels.reshape(
        (b * fmax,) + tuple(batch.pixels.shape[2:])))
    feats = feats.reshape(b, fmax, feats.shape[-2], feats.shape[-1])
    frame_valid = batch.frame_valid.cpu()  # steers the memory loop on the host
    visual = torch.stack([
        vlm.build_video_embeds(params, cfg, feats[i], batch.frame_indices[i], frame_valid[i],
                               batch.fine_idx[i], nseg, drop_fine_frames=drop_frames)
        for i in range(b)])
    lm = params["language_model"]
    text_embeds = qwen2.embed_tokens(lm, batch.input_ids.clamp_min(0)).to(visual.dtype)
    embeds, labels = _splice_batched(text_embeds, visual, batch.image_pos, batch.labels,
                                     IGNORE_INDEX)
    valid_len = (batch.text_len.to(embeds.device) + visual.shape[1]).to(torch.int32)
    return _lm_loss(params, cfg, embeds, labels, valid_len)


def text_loss(params, cfg: VLMConfig, batch: TextBatch):
    """LM loss of a text-only batch (embeds in the param dtype)."""
    embeds = qwen2.embed_tokens(params["language_model"], batch.input_ids.clamp_min(0))
    return _lm_loss(params, cfg, embeds, batch.labels, batch.text_len.to(torch.int32))


def value_and_grad_params(loss_fn, params):
    """((loss, metrics), grads) of `loss_fn(params)` with respect to every
    floating leaf, as `jax.value_and_grad` over the whole tree: a leaf the
    loss does not reach gets zeros, and an integer leaf (a prequantized
    frozen module) fp32 zeros, as JAX's float0 tangents become."""
    inputs = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    loss, metrics = loss_fn(inputs)
    leaves = [x for _, x in leaves_with_path(inputs) if x.requires_grad]
    found = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad(p):
        if not p.requires_grad:
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        g = next(found)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad, inputs)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def _step(loss_fn, state: TrainState, opt_cfg: OptimizerConfig):
    (_, metrics), grads = value_and_grad_params(loss_fn, state.params)
    optimizer = build_optimizer(state.params, opt_cfg)
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = tree_map(lambda p, u: p + u.to(p.dtype), state.params, updates)
    metrics = dict(metrics, grad_norm=global_norm(grads))
    return TrainState(params, opt_state, state.step + 1), metrics


def make_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig, *, nseg: int,
                    drop_frames: bool = False):
    """`train_step(state, batch) -> (state, metrics)`: grads -> clipped,
    grouped AdamW. metrics: loss, target_tokens, grad_norm (tensors)."""
    def train_step(state: TrainState, batch: TrainBatch):
        return _step(lambda p: multimodal_loss(p, cfg, batch, nseg=nseg,
                                               drop_frames=drop_frames), state, opt_cfg)

    return train_step


def make_text_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig):
    def train_step(state: TrainState, batch: TextBatch):
        return _step(lambda p: text_loss(p, cfg, batch), state, opt_cfg)

    return train_step


def init_train_state(params, opt_cfg: OptimizerConfig) -> TrainState:
    return TrainState(params, build_optimizer(params, opt_cfg).init(params), 0)
