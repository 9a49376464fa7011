"""Reward-model training (counterpart of
`memory_augmented_vlm_tpu/train/reward.py`, the capability of TRL's
`RewardTrainer`, trl/trainer/reward_trainer.py:60-257).

The loss replicates reward_trainer.py:196-225:
  loss = -logsigmoid(r_chosen - r_rejected [- margin]).mean()
with the reward read from a scalar head over the last valid token's hidden
state (the sequence-classification pooling rule).

The embeddings take the table's dtype, as `trainer.text_loss` takes them;
JAX casts them to bf16 only on a TPU with a bf16 LM config, which is the
same whenever the table's dtype is the config's. The head meets the hidden
states in their promoted dtype (`ppo.value_head`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig
from memory_augmented_vlm_torch.train.ppo import init_value_head, value_head


class RewardBatch(NamedTuple):
    """Paired preference batch of plain token sequences (right-padded)."""

    chosen_ids: torch.Tensor      # (B, S) int
    chosen_len: torch.Tensor      # (B,) int32
    rejected_ids: torch.Tensor    # (B, S)
    rejected_len: torch.Tensor    # (B,)
    margin: Optional[torch.Tensor] = None   # (B,) optional score margin


def sequence_reward(params, cfg: VLMConfig, input_ids, valid_len):
    """Scalar reward per sequence: decoder forward (layers recomputed in the
    backward, the training attention kernels) -> value head at the last
    valid position."""
    embeds = qwen2.embed_tokens(params["language_model"], input_ids, cfg.lm)
    b, s = embeds.shape[:2]
    positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
    hidden, _ = qwen2.forward(params["language_model"], cfg.lm, embeds, positions,
                              valid_len=valid_len, remat=True, differentiable_attention=True,
                              need_cache=False)
    scores = value_head(params["value_head"], hidden)         # (B, S)
    last = (valid_len.to(scores.device).long() - 1).clamp(0, s - 1)
    return torch.gather(scores, 1, last[:, None])[:, 0]


def reward_loss(rewards_chosen, rewards_rejected, margin=None):
    """reward_trainer.py:214-218."""
    delta = rewards_chosen - rewards_rejected
    if margin is not None:
        delta = delta - margin
    return -torch.mean(F.logsigmoid(delta))


def init_reward_params(cfg: VLMConfig, lm_params, gen: torch.Generator, device="cuda",
                       dtype=torch.float32):
    """Attach a fresh scalar head (drawn from `gen`, on `device`) to existing
    LM params."""
    return {"language_model": lm_params,
            "value_head": init_value_head(cfg.lm.hidden_size, gen, device, dtype)}


def make_reward_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig):
    """`step(state, batch) -> (state, metrics)`."""
    def step(state: trainer_mod.TrainState, batch: RewardBatch):
        def loss_fn(params):
            rc = sequence_reward(params, cfg, batch.chosen_ids, batch.chosen_len)
            rr = sequence_reward(params, cfg, batch.rejected_ids, batch.rejected_len)
            loss = reward_loss(rc, rr, batch.margin)
            acc = torch.mean((rc > rr).float())
            return loss, {"loss": loss, "rewards/chosen": rc.mean(),
                          "rewards/rejected": rr.mean(), "rewards/accuracies": acc,
                          "rewards/margins": (rc - rr).mean()}

        return trainer_mod._step(loss_fn, state, opt_cfg)

    return step
