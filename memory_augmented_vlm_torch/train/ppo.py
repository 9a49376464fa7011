"""PPO training with a value head (counterpart of
`memory_augmented_vlm_tpu/train/ppo.py`, the capability of TRL's
`PPOTrainer`, trl/trainer/ppo_trainer.py).

The trainer's math as plain tensor functions:
  - per-token rewards = -kl_coef * KL(policy || ref) with the reward-model
    score added at the last response token (ppo_trainer.py:1031-1067); KL
    penalty kinds kl/abs/mse/full (ppo_trainer.py:1069-1083);
  - GAE advantages with masked whitening (ppo_trainer.py:1085-1111), a loop
    over the response positions from the last (JAX's reversed `lax.scan`),
    with `gamma * lam` formed as one Python float first, as JAX forms it,
    and each step's multiply-add rounded once, as XLA fuses it;
  - the clipped-surrogate policy loss, the clipped value loss and the
    ratio-threshold batch skip, a product by 0 or 1 and no branch, so a NaN
    loss stays NaN (ppo_trainer.py:1113-1198);
  - the adaptive and fixed KL controllers, host-side Python state updated
    between steps (trl/trainer/utils.py:35-60);
  - a scalar value head over the decoder's hidden states
    (trl/models/modeling_value_head.py).

What differs from JAX, and why:
  - `init_value_head` draws from an explicit `torch.Generator` on a device
    (the card by default), not from a JAX key: tests carry JAX's head across
    (`convert.from_jax_params`) instead of matching random streams;
  - `torch.matmul` refuses mixed dtypes where `jnp.einsum` promotes, so
    `value_head` takes both operands to their promoted dtype (bf16 hidden
    states and the fp32 head meet in fp32, as in JAX);
  - the policy's logits are fp32 products against the fp32 unembedding
    table (`trainer.unembed_table`, as the trainer's loss takes them): on
    the card `qwen2.unembed`'s bf16 product with an fp32 output has no
    derivative;
  - `kl_coef` is a float or a 0-d tensor; the step is a plain function, so
    nothing is rebuilt when the controller moves it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Knobs mirroring trl PPOConfig defaults (trl/trainer/ppo_config.py)."""

    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 0.1
    kl_penalty: str = "kl"        # kl | abs | mse | full ("full" uses the
                                  # exact per-token KL computed at rollout
                                  # time: PPOBatch.full_kls)
    init_kl_coef: float = 0.2
    adap_kl_ctrl: bool = True
    target: float = 6.0
    horizon: float = 10000.0
    whiten_rewards: bool = False
    ratio_threshold: float = 10.0


# ---------------------------------------------------------------------------
# Masked statistics (trl/core.py:147-193)
# ---------------------------------------------------------------------------

def masked_mean(values, mask, axis=None):
    if axis is None:
        return (values * mask).sum() / mask.sum()
    return (values * mask).sum(dim=axis) / mask.sum(dim=axis)


def masked_var(values, mask, unbiased: bool = True):
    mean = masked_mean(values, mask)
    variance = masked_mean((values - mean) ** 2, mask)
    if unbiased:
        n = mask.sum()
        variance = variance * (n / (n - 1))
    return variance


def masked_whiten(values, mask, shift_mean: bool = True):
    mean, var = masked_mean(values, mask), masked_var(values, mask)
    whitened = (values - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        whitened = whitened + mean
    return whitened


def entropy_from_logits(logits):
    pd = torch.softmax(logits, dim=-1)
    return torch.logsumexp(logits, dim=-1) - torch.sum(pd * logits, dim=-1)


# ---------------------------------------------------------------------------
# KL controllers (host-side; trl/trainer/utils.py:35-60)
# ---------------------------------------------------------------------------

class AdaptiveKLController:
    def __init__(self, init_kl_coef: float, target: float, horizon: float):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int) -> None:
        proportional_error = float(np.clip(current / self.target - 1, -0.2, 0.2))
        self.value *= 1 + proportional_error * n_steps / self.horizon


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int) -> None:
        pass


def make_kl_controller(cfg: PPOConfig):
    if cfg.adap_kl_ctrl:
        return AdaptiveKLController(cfg.init_kl_coef, cfg.target, cfg.horizon)
    return FixedKLController(cfg.init_kl_coef)


# ---------------------------------------------------------------------------
# Value head (trl/models/modeling_value_head.py)
# ---------------------------------------------------------------------------

def init_value_head(hidden_size: int, gen: torch.Generator, device="cuda",
                    dtype=torch.float32):
    """A fresh head, N(0, 1) / sqrt(hidden + 1) and a zero bias, drawn from
    `gen` (a generator on `device`)."""
    kernel = torch.randn((hidden_size, 1), generator=gen, device=device) / (hidden_size + 1) ** 0.5
    return {"summary": {"kernel": kernel.to(dtype),
                        "bias": torch.zeros((1,), dtype=dtype, device=device)}}


def value_head(vh_params, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, H) hidden states -> (B, S) scalar values, in the promoted
    dtype of the hidden states and the head."""
    kernel, bias = vh_params["summary"]["kernel"], vh_params["summary"]["bias"]
    dtype = torch.promote_types(hidden.dtype, kernel.dtype)
    out = hidden.to(dtype) @ kernel.to(dtype)
    return (out + bias.to(dtype))[..., 0]


def _policy_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of final-normed hidden states against the fp32 table,
    differentiable on every device."""
    return F.linear(hidden.float(), trainer_mod.unembed_table(params))


def forward_with_value(params, cfg: VLMConfig, embeds, positions, valid_len):
    """Policy forward returning (logits, values): the
    AutoModelForCausalLMWithValueHead contract on the shared decoder."""
    hidden, _ = qwen2.forward(params["language_model"], cfg.lm, embeds, positions,
                              valid_len=valid_len, differentiable_attention=True,
                              need_cache=False)
    values = value_head(params["value_head"], hidden.float())
    return _policy_logits(params, hidden), values


# ---------------------------------------------------------------------------
# Rewards / advantages / loss (ppo_trainer.py:1031-1198)
# ---------------------------------------------------------------------------

def kl_penalty(logprob, ref_logprob, kind: str = "kl"):
    """ppo_trainer.py:1069-1083. kl/abs/mse take realized-token logprobs
    (B, T); `full` takes full log-distributions (B, T, V) and returns the
    exact per-token KL(policy || ref)."""
    if kind == "kl":
        return logprob - ref_logprob
    if kind == "abs":
        return torch.abs(logprob - ref_logprob)
    if kind == "mse":
        return 0.5 * torch.square(logprob - ref_logprob)
    if kind == "full":
        p = torch.exp(logprob)
        return torch.sum(p * (logprob - ref_logprob), dim=-1)
    raise NotImplementedError(kind)


def compute_rewards(scores, logprobs, ref_logprobs, masks, kl_coef, kind: str = "kl",
                    full_kls=None):
    """scores (B,), logprobs/ref/masks (B, T) -> (rewards, non_score, kls).

    kind="full" takes `full_kls` (B, T) from `response_full_kl` at rollout
    time, or (B, T, V) log-distributions as logprobs/ref_logprobs. The
    score lands on each row's last mask index, `t - 1` for an all-zero
    row (the first maximum of the flipped mask, as JAX's argmax)."""
    if kind == "full":
        if full_kls is not None:
            kls = full_kls
        elif logprobs.dim() == 3:
            kls = kl_penalty(logprobs, ref_logprobs, "full")
        else:
            raise ValueError(
                "kl_penalty='full' needs PPOBatch.full_kls (see "
                "response_full_kl) or (B, T, V) log-distributions")
    else:
        kls = kl_penalty(logprobs, ref_logprobs, kind)
    non_score = -kl_coef * kls
    t = masks.shape[1]
    last = (t - 1) - torch.argmax(torch.flip(masks, dims=(1,)), dim=1)
    bonus = F.one_hot(last, t).to(scores.dtype) * scores[:, None]
    return non_score + bonus, non_score, kls


def compute_advantages(values, rewards, mask, cfg: PPOConfig):
    """Masked GAE (ppo_trainer.py:1085-1111); returns (values, advantages,
    returns) with the advantages whitened and detached."""
    values = values * mask
    rewards = rewards * mask
    if cfg.whiten_rewards:
        rewards = masked_whiten(rewards, mask, shift_mean=False)

    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    deltas = rewards + cfg.gamma * next_values - values  # (B, T)
    decay = cfg.gamma * cfg.lam
    lastgaelam = torch.zeros_like(deltas[:, 0])
    reversed_adv = []
    for t in range(deltas.shape[1] - 1, -1, -1):
        # delta + decay * last in one rounding: XLA contracts JAX's step into
        # a fused multiply-add, as `add` with an alpha computes it
        lastgaelam = torch.add(deltas[:, t], lastgaelam, alpha=decay)
        reversed_adv.append(lastgaelam)
    advantages = torch.stack(reversed_adv[::-1], dim=1)
    returns = advantages + values
    advantages = masked_whiten(advantages, mask).detach()
    return values, advantages, returns


def ppo_loss(old_logprobs, values, logits, vpreds, logprobs, mask, advantages, returns,
             cfg: PPOConfig):
    """Clipped PPO objective (ppo_trainer.py:1113-1198).

    Returns (pg_loss, vf_coef * vf_loss, stats)."""
    vpredclipped = torch.clamp(vpreds, values - cfg.cliprange_value,
                               values + cfg.cliprange_value)
    vf_losses1 = torch.square(vpreds - returns)
    vf_losses2 = torch.square(vpredclipped - returns)
    vf_loss = 0.5 * masked_mean(torch.maximum(vf_losses1, vf_losses2), mask)
    vf_clipfrac = masked_mean((vf_losses2 > vf_losses1).float(), mask)

    ratio = torch.exp(logprobs - old_logprobs)
    pg_losses = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1.0 - cfg.cliprange, 1.0 + cfg.cliprange)
    pg_loss = masked_mean(torch.maximum(pg_losses, pg_losses2), mask)
    pg_clipfrac = masked_mean((pg_losses2 > pg_losses).float(), mask)

    # batch skip on runaway ratios (ppo_trainer.py:1164-1168), branch-free
    avg_ratio = masked_mean(ratio, mask)
    keep = (avg_ratio <= cfg.ratio_threshold).to(pg_loss.dtype)
    pg_loss = pg_loss * keep
    vf_loss = vf_loss * keep

    stats = {
        "loss/policy": pg_loss,
        "loss/value": cfg.vf_coef * vf_loss,
        "loss/total": pg_loss + cfg.vf_coef * vf_loss,
        "policy/entropy": masked_mean(entropy_from_logits(logits), mask),
        "policy/approxkl": 0.5 * masked_mean(torch.square(logprobs - old_logprobs), mask),
        "policy/policykl": masked_mean(old_logprobs - logprobs, mask),
        "policy/clipfrac": pg_clipfrac,
        "policy/advantages_mean": masked_mean(advantages, mask),
        "returns/mean": masked_mean(returns, mask),
        "val/vpred": masked_mean(vpreds, mask),
        "val/error": masked_mean(torch.square(vpreds - returns), mask),
        "val/clipfrac": vf_clipfrac,
    }
    return pg_loss, cfg.vf_coef * vf_loss, stats


# ---------------------------------------------------------------------------
# Train step over the shared decoder (value-head policy)
# ---------------------------------------------------------------------------

class PPOBatch(NamedTuple):
    """One rollout minibatch: full sequences (query + response,
    right-padded) plus frozen rollout-time statistics, on the params'
    device."""

    input_ids: torch.Tensor       # (B, S) int
    response_mask: torch.Tensor   # (B, T) 1 on response tokens
    query_len: torch.Tensor       # (B,) response starts here
    seq_len: torch.Tensor         # (B,) int32, query + response length
    old_logprobs: torch.Tensor    # (B, T) rollout-time policy logprobs
    old_values: torch.Tensor      # (B, T) rollout-time value predictions
    scores: torch.Tensor          # (B,) reward-model scalars
    ref_logprobs: torch.Tensor    # (B, T) frozen reference logprobs
    # (B, T) exact per-token KL(policy || ref) from response_full_kl; only
    # read when kl_penalty == "full"
    full_kls: Optional[torch.Tensor] = None


def _response_rows(query_len, t_max: int, s: int):
    """(positions (B, T) of the response tokens, the rows (B, T) that
    predict them, both clipped into [0, s - 1])."""
    pos = query_len.long()[:, None] + torch.arange(t_max, device=query_len.device)[None, :]
    return pos, (pos - 1).clamp(0, s - 1)


def _gather_rows(x, rows):
    """x (B, S, V) at rows (B, T) -> (B, T, V)."""
    return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))


def _response_logprobs(logits, input_ids, query_len, t_max: int):
    """Per-token logprobs of the realized response tokens.

    Response token j lives at sequence index query_len + j; its predictive
    logits are one position earlier. Returns (lp (B, T), pred_rows (B, T,
    V), pos (B, T))."""
    s = logits.shape[1]
    pos, rows = _response_rows(query_len, t_max, s)
    pred_rows = _gather_rows(F.log_softmax(logits, dim=-1), rows)
    tok = torch.gather(input_ids.long(), 1, pos.clamp(0, s - 1))
    lp = torch.gather(pred_rows, -1, tok[..., None])[..., 0]
    return lp, pred_rows, pos


def response_full_kl(policy_logits, ref_logits, query_len, t_max: int):
    """Exact per-token KL(policy || ref) over the response positions, (B, T),
    from the two models' rollout-time (B, S, V) logits: carried in
    PPOBatch.full_kls, it gives TRL's kl_penalty="full" without (B, T, V)
    rollout tensors."""
    _, rows = _response_rows(query_len, t_max, policy_logits.shape[1])
    lp = _gather_rows(F.log_softmax(policy_logits, dim=-1), rows)
    ref_lp = _gather_rows(F.log_softmax(ref_logits, dim=-1), rows)
    return kl_penalty(lp, ref_lp, "full")


def make_ppo_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig, ppo_cfg: PPOConfig):
    """`step(state, batch, kl_coef) -> (state, stats)`: one PPO optimization
    step over a rollout minibatch, through the trainer's grads and AdamW.
    `kl_coef` (a float or a 0-d tensor) is an argument, so the host-side KL
    controller moves it between steps."""

    def step(state: trainer_mod.TrainState, batch: PPOBatch, kl_coef):
        t_max = batch.response_mask.shape[1]
        rewards, _, kls = compute_rewards(
            batch.scores, batch.old_logprobs, batch.ref_logprobs, batch.response_mask,
            kl_coef, ppo_cfg.kl_penalty, full_kls=batch.full_kls)
        values, advantages, returns = compute_advantages(
            batch.old_values, rewards, batch.response_mask, ppo_cfg)

        def loss_fn(params):
            embeds = qwen2.embed_tokens(params["language_model"], batch.input_ids, cfg.lm)
            b, s = embeds.shape[:2]
            positions = torch.arange(s, device=embeds.device)[None, :].expand(b, s)
            logits, vpreds_all = forward_with_value(params, cfg, embeds, positions,
                                                    batch.seq_len)
            lp, pred_rows, pos = _response_logprobs(logits, batch.input_ids, batch.query_len,
                                                    t_max)
            vpreds = torch.gather(vpreds_all, 1, (pos - 1).clamp(0, s - 1))
            pg, vf, stats = ppo_loss(batch.old_logprobs, values, pred_rows, vpreds, lp,
                                     batch.response_mask, advantages, returns, ppo_cfg)
            return pg + vf, stats

        state, stats = trainer_mod._step(loss_fn, state, opt_cfg)
        stats["objective_kl"] = masked_mean(kls, batch.response_mask)
        return state, stats

    return step
