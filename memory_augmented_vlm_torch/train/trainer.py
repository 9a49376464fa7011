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
  - JAX draws position skipping's offsets inside the loss from a key; the
    port's `multimodal_loss` takes the three draws (`pos_skip_draws`,
    from `draw_pos_skipping` and a `torch.Generator`), so a test can hand
    it JAX's. `synced_frame_dropout` is JAX's draw to the bit, computed in
    numpy: a hash of (seed, step), the same on every rank.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.constants import IGNORE_INDEX
from memory_augmented_vlm_torch.models import qwen2, vlm
from memory_augmented_vlm_torch.train.optimizer import (OptimizerConfig, build_optimizer,
                                                        global_norm)
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
    opt_state: Any  # OptState, or MultiStepsState when accumulating
    step: int       # micro-steps taken


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, counter):
    """Threefry-2x32 (20 rounds) of one block, as `jax.random` computes it."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = np.uint32(counter[0]) + ks[0], np.uint32(counter[1]) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def step_uniform(step: int, seed: int = 17) -> np.float32:
    """JAX's `uniform(fold_in(key(seed), step))`, bit for bit: a pure
    function of (seed, step)."""
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps by design
        folded = _threefry2x32((0, seed), (0, step))  # fold_in
        b0, b1 = _threefry2x32(folded, (0, 0))        # random_bits of shape ()
    bits = np.array([(b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)], np.uint32)
    return bits.view(np.float32)[0] - np.float32(1)


def synced_frame_dropout(step: int, prob: float = 0.5, seed: int = 17) -> bool:
    """JAX's shared dropout decision: every rank draws the same
    `step_uniform(step, seed)`, so no collective is needed (the reference
    broadcasts rank 0's draw)."""
    return bool(step_uniform(step, seed) < prob)


def draw_pos_skipping(seq_len: int, skip_range: int,
                      generator: torch.Generator) -> Tuple[int, int, int]:
    """(split, left, right) in JAX's ranges: split in [0, seq_len], left in
    [0, skip_range], right = left + an offset in [0, max(skip_range + 1 -
    left, 1)). The draws are torch's, not JAX's."""
    def randint(high):
        return int(torch.randint(high, (), generator=generator))

    split = randint(seq_len + 1)
    left = randint(skip_range + 1)
    return split, left, left + randint(max(skip_range + 1 - left, 1))


def pos_skipping_positions(seq_len: int, batch: int, split: int, left: int, right: int,
                           device=None) -> torch.Tensor:
    """Length-generalisation position skipping (llava_arch.py:869-875): the
    positions before `split` shift by `left`, the rest by `right`. (batch,
    seq_len) int64."""
    pos = torch.arange(seq_len, device=device)
    pos = pos + torch.where(pos < split, left, right)
    return pos[None].expand(batch, seq_len)


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
    """Summed masked NLL of fp32 logits against a (V, H) table in fp32
    (`qwen2.unembed`'s float path)."""
    logits = F.linear(hidden.float(), table)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    return ((logz - tgt) * mask).sum()


def unembed_table(params) -> torch.Tensor:
    """The loss's (V, H) fp32 table, as `qwen2.unembed` takes its weight:
    the untied (H, V) `lm_head` (a transposed view of its fp32 copy) where
    the LM has one, else the tied `embed_tokens`. Cast once per loss."""
    lm = params["language_model"]
    return lm["lm_head"].float().t() if "lm_head" in lm else lm["embed_tokens"].float()


def dense_cross_entropy(params, cfg: VLMConfig, hidden, labels, valid_len):
    """Next-token CE over the whole (B, S, vocab) fp32 logits. Returns
    (mean loss, token count)."""
    targets, mask = _targets(labels, valid_len)
    total = _nll_sum(hidden, unembed_table(params), targets, mask)
    cnt = mask.sum()
    return total / cnt.clamp_min(1), cnt


def chunked_cross_entropy(params, cfg: VLMConfig, hidden, labels, valid_len,
                          chunk: int = 512):
    """The same loss in `chunk`-row pieces along the sequence, each under
    checkpoint: only one piece's logits exist at a time, in the forward and
    again in the backward. The table is cast to fp32 once for all pieces."""
    targets, mask = _targets(labels, valid_len)
    table = unembed_table(params)
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


def _lm_loss(params, cfg: VLMConfig, embeds, labels, valid_len, positions=None):
    b, s, _ = embeds.shape
    if positions is None:
        positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    hidden, _ = qwen2.forward(params["language_model"], cfg.lm, embeds, positions,
                              valid_len=valid_len, remat=True,
                              differentiable_attention=True, need_cache=False)
    loss, count = cross_entropy(params, cfg, hidden, labels, valid_len)
    return loss, {"loss": loss, "target_tokens": count}


def multimodal_loss(params, cfg: VLMConfig, batch: TrainBatch, *, nseg: int,
                    drop_frames: bool = False,
                    pos_skip_draws: Optional[Tuple[int, int, int]] = None):
    """Fusion + LM loss for one bucketed batch: (loss, metrics). Under
    `cfg.pipeline.use_pos_skipping`, `pos_skip_draws` (split, left, right)
    shifts the LM's positions (`pos_skipping_positions`)."""
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
    text_embeds = qwen2.embed_tokens(lm, batch.input_ids.clamp_min(0), cfg.lm).to(visual.dtype)
    embeds, labels = _splice_batched(text_embeds, visual, batch.image_pos, batch.labels,
                                     IGNORE_INDEX)
    valid_len = (batch.text_len.to(embeds.device) + visual.shape[1]).to(torch.int32)
    positions = None
    if cfg.pipeline.use_pos_skipping and pos_skip_draws is not None:
        positions = pos_skipping_positions(embeds.shape[1], b, *pos_skip_draws,
                                           device=embeds.device)
    return _lm_loss(params, cfg, embeds, labels, valid_len, positions)


def text_loss(params, cfg: VLMConfig, batch: TextBatch):
    """LM loss of a text-only batch (embeds in the param dtype)."""
    embeds = qwen2.embed_tokens(params["language_model"], batch.input_ids.clamp_min(0), cfg.lm)
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
    params = (state.params if updates is None  # an accumulating micro-step
              else tree_map(lambda p, u: p + u.to(p.dtype), state.params, updates))
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
