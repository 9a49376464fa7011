"""DPO training — the reference's `train_dpo.py` + vendored TRL
`DPOTrainer` (counterpart of `memory_augmented_vlm_tpu/train/dpo.py`).

Loss replicates trl/trainer/dpo_trainer.py:730-793,945-957:
  logits   = (pol_chosen_lp - pol_rejected_lp) - (ref_chosen_lp - ref_rejected_lp)
  dpo      = -logsigmoid(beta * logits) * (1 - ls) - logsigmoid(-beta * logits) * ls
  total    = dpo_alpha * dpo + gamma * sft(chosen)
with rewards beta * (policy - reference) for logging.

The reference policy is a frozen copy of the initial params. Both policies
read the policy's visual stream (the tower and projector run detached, as
in `trainer.multimodal_loss`; the memory stream is built per sample, as
there); the reference's forwards run under `torch.no_grad()`, JAX's
`stop_gradient`. The log-probs take fp32 logits against the fp32 table, as
the trainer's loss does; on the card in 512-row pieces under
`torch.utils.checkpoint`, so the (S, vocab) logits are never whole (JAX
materialises them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, vlm
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    dpo_alpha: float = 1.0
    gamma: float = 1.0          # SFT-loss weight on the chosen response
    label_smoothing: float = 0.0


class DPOBatch(NamedTuple):
    """Paired preference batch; chosen/rejected share the visual context."""

    pixels: torch.Tensor
    frame_indices: torch.Tensor
    frame_valid: torch.Tensor
    fine_idx: torch.Tensor
    chosen_ids: torch.Tensor       # (B, St)
    chosen_labels: torch.Tensor
    rejected_ids: torch.Tensor
    rejected_labels: torch.Tensor
    image_pos: torch.Tensor
    chosen_len: torch.Tensor
    rejected_len: torch.Tensor


def _target_logprob(table, hidden, targets):
    """(B, S) log-prob of each target under fp32 logits against the (V, H)
    fp32 table (the trainer's loss product: `qwen2.unembed`'s card product
    has no derivative)."""
    logits = F.linear(hidden.float(), table)
    logz = torch.logsumexp(logits, dim=-1)
    return logits.gather(-1, targets.clamp_min(0)[..., None])[..., 0] - logz


def sequence_logprob(params, cfg: VLMConfig, hidden, labels, valid_len, chunk: int = 512):
    """Sum of target-token logprobs over supervised positions, per sample:
    ((B,) sums, (B,) counts)."""
    targets, mask = trainer_mod._targets(labels, valid_len)
    lm = params["language_model"]
    table = (lm["lm_head"].t() if "lm_head" in lm else lm["embed_tokens"]).float()
    if hidden.device.type == "cuda":
        lp = torch.cat([checkpoint(_target_logprob, table, hidden[:, i:i + chunk],
                                   targets[:, i:i + chunk], use_reentrant=False)
                        for i in range(0, hidden.shape[1], chunk)], dim=1)
    else:
        lp = _target_logprob(table, hidden, targets)
    return (lp * mask).sum(dim=-1), mask.sum(dim=-1)


def dpo_loss(policy_chosen_lp, policy_rejected_lp, ref_chosen_lp, ref_rejected_lp,
             cfg: DPOConfig):
    """Sigmoid DPO with label smoothing (dpo_trainer.py:730-793)."""
    logits = (policy_chosen_lp - policy_rejected_lp) - (ref_chosen_lp - ref_rejected_lp)
    ls = cfg.label_smoothing
    losses = (-F.logsigmoid(cfg.beta * logits) * (1 - ls)
              - F.logsigmoid(-cfg.beta * logits) * ls)
    chosen_rewards = cfg.beta * (policy_chosen_lp - ref_chosen_lp).detach()
    rejected_rewards = cfg.beta * (policy_rejected_lp - ref_rejected_lp).detach()
    return losses, chosen_rewards, rejected_rewards


def _forward_response(params, cfg: VLMConfig, visual, ids, labels, image_pos, text_len):
    text_embeds = qwen2.embed_tokens(params["language_model"], ids.clamp_min(0),
                                     cfg.lm).to(visual.dtype)
    embeds, lab = trainer_mod._splice_batched(text_embeds, visual, image_pos, labels,
                                              constants.IGNORE_INDEX)
    valid_len = (text_len.to(embeds.device) + visual.shape[1]).to(torch.int32)
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    hidden, _ = qwen2.forward(params["language_model"], cfg.lm, embeds, positions,
                              valid_len=valid_len, remat=True, differentiable_attention=True,
                              need_cache=False)
    return hidden, lab, valid_len


def dpo_forward(params, ref_params, cfg: VLMConfig, dpo_cfg: DPOConfig, batch: DPOBatch, *,
                nseg: int):
    """Full DPO objective for one batch: (loss, metrics)."""
    b, fmax = batch.pixels.shape[:2]
    feats = vlm.encode_frames(params, cfg, batch.pixels.reshape(
        (b * fmax,) + tuple(batch.pixels.shape[2:])))
    feats = feats.reshape(b, fmax, feats.shape[-2], feats.shape[-1])
    frame_valid = batch.frame_valid.cpu()  # steers the memory loop on the host
    visual = torch.stack([
        vlm.build_video_embeds(params, cfg, feats[i], batch.frame_indices[i], frame_valid[i],
                               batch.fine_idx[i], nseg)
        for i in range(b)])

    sides = (("chosen", batch.chosen_ids, batch.chosen_labels, batch.chosen_len),
             ("rejected", batch.rejected_ids, batch.rejected_labels, batch.rejected_len))
    lps = {}
    for side, ids, labels, tl in sides:
        hidden, lab, vl = _forward_response(params, cfg, visual, ids, labels, batch.image_pos,
                                            tl)
        lps[("policy", side)], _ = sequence_logprob(params, cfg, hidden, lab, vl)
        if side == "chosen":
            sft_hidden, sft_lab, sft_vl = hidden, lab, vl
    with torch.no_grad():
        for side, ids, labels, tl in sides:
            hidden, lab, vl = _forward_response(ref_params, cfg, visual.detach(), ids, labels,
                                                batch.image_pos, tl)
            lps[("ref", side)], _ = sequence_logprob(ref_params, cfg, hidden, lab, vl)

    losses, cr, rr = dpo_loss(lps[("policy", "chosen")], lps[("policy", "rejected")],
                              lps[("ref", "chosen")], lps[("ref", "rejected")], dpo_cfg)
    sft_loss, _ = trainer_mod.cross_entropy(params, cfg, sft_hidden, sft_lab, sft_vl)
    total = dpo_cfg.dpo_alpha * losses.mean() + dpo_cfg.gamma * sft_loss
    metrics = {
        "loss": total,
        "dpo_loss": losses.mean(),
        "sft_loss": sft_loss,
        "rewards_chosen": cr.mean(),
        "rewards_rejected": rr.mean(),
        "reward_margin": (cr - rr).mean(),
        "reward_accuracy": (cr > rr).float().mean(),
    }
    return total, metrics


def make_dpo_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig, dpo_cfg: DPOConfig, *,
                        nseg: int):
    """`step(state, ref_params, batch) -> (state, metrics)`."""
    def step(state: trainer_mod.TrainState, ref_params, batch: DPOBatch):
        return trainer_mod._step(
            lambda p: dpo_forward(p, ref_params, cfg, dpo_cfg, batch, nseg=nseg), state, opt_cfg)

    return step
