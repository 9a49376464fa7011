"""DDPO, Denoising Diffusion Policy Optimization (counterpart of
`memory_augmented_vlm_tpu/train/ddpo.py`: TRL's ddpo_trainer.py:55-604 and
`PerPromptStatTracker`, trl/trainer/utils.py:560-598).

Semantics mirrored:
  - sample rollouts: each denoising step t is one "action" with a stored
    log-prob; trajectories carry (latents[t], timesteps[t], next_latents[t],
    log_probs[t]) (ddpo_trainer.py:429-489);
  - per-prompt advantage normalization via a bounded reward buffer with a
    global fallback below `min_count` (utils.py:576-595), else global
    whitening (ddpo_trainer.py:276-279);
  - PPO-style clipped importance-weighted loss over re-evaluated step
    log-probs, with advantage clamping, approx-KL = 0.5*mean((dlp)^2) and
    clipfrac diagnostics (ddpo_trainer.py:325-403);
  - inner epochs re-shuffle the sample batch and independently permute each
    sample's timestep axis before rebatching to `train_batch_size`
    (ddpo_trainer.py:289-316), with JAX's numpy generator, so both packages
    draw the same orders from one seed.

The trainer is generic over a user-supplied sampler/log-prob pair, as in
JAX (diffusion is outside the framework's model zoo):

  sample_fn(params, generator, prompt_embeds, num_steps)
      -> dict(latents (B, T+1, ...), timesteps (B, T), log_probs (B, T)),
         plus anything the reward needs under "images"; `generator` is a
         `torch.Generator` on the params' device, seeded from `seed` and
         advanced by every call, where JAX hands a fresh split key
  logprob_fn(params, latents, timesteps, next_latents, prompt_embeds)
      -> (B,) log prob of next_latents given latents at timesteps,
         differentiable with respect to params

DDPO runs none of the port's kernels: its policy is the user's. The update
is `optax.adamw` as optax computes it (`adamw` below: Adam's moments, bias
corrections in fp32, weight decay on every leaf, -lr), on every floating
leaf of the user's params; rollout bookkeeping (stat tracker, shuffles,
rebatching) stays on the host, like the reference's accelerator loop.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import Optimizer, _pick, adamw_leaf
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, tree_map


class PerPromptStatTracker:
    """trl/trainer/utils.py:560-598, verbatim semantics."""

    def __init__(self, buffer_size: int, min_count: int):
        self.buffer_size = buffer_size
        self.min_count = min_count
        self.stats: Dict[str, deque] = {}

    def update(self, prompts: Sequence[str], rewards) -> np.ndarray:
        prompts = np.array(prompts)
        rewards = np.array(rewards, np.float64)
        advantages = np.empty_like(rewards)
        for prompt in np.unique(prompts):
            prompt_rewards = rewards[prompts == prompt]
            buf = self.stats.setdefault(str(prompt),
                                        deque(maxlen=self.buffer_size))
            buf.extend(prompt_rewards)
            if len(buf) < self.min_count:
                mean, std = np.mean(rewards), np.std(rewards) + 1e-6
            else:
                mean, std = np.mean(buf), np.std(buf) + 1e-6
            advantages[prompts == prompt] = (prompt_rewards - mean) / std
        return advantages

    def get_stats(self):
        return {k: {"mean": np.mean(v), "std": np.std(v), "count": len(v)}
                for k, v in self.stats.items()}


def ddpo_loss(advantages: torch.Tensor, clip_range: float,
              ratio: torch.Tensor) -> torch.Tensor:
    """ddpo_trainer.py:391-403: max of unclipped/clipped -A*ratio."""
    unclipped = -advantages * ratio
    clipped = -advantages * torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range)
    return torch.mean(torch.maximum(unclipped, clipped))


def calculate_loss(log_prob: torch.Tensor, old_log_prob: torch.Tensor,
                   advantages: torch.Tensor, *, clip_range: float,
                   adv_clip_max: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ddpo_trainer.py:325-389 tail: advantage clamp -> ratio -> clipped
    loss, approx_kl, clipfrac."""
    advantages = torch.clamp(advantages, -adv_clip_max, adv_clip_max)
    ratio = torch.exp(log_prob - old_log_prob)
    loss = ddpo_loss(advantages, clip_range, ratio)
    approx_kl = 0.5 * torch.mean((log_prob - old_log_prob) ** 2)
    clipfrac = torch.mean((torch.abs(ratio - 1.0) > clip_range).float())
    return loss, approx_kl, clipfrac


class AdamState(NamedTuple):
    count: int  # updates taken
    mu: Any
    nu: Any


def adamw(learning_rate: float, b1: float, b2: float, eps: float,
          weight_decay: float) -> Optimizer:
    """`optax.adamw` with a constant rate and weight decay on every leaf
    (`optimizer.adamw_leaf` on each)."""
    def init(params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params):
        def leaf(g, p, mu, nu):
            return adamw_leaf(g, p, mu, nu, state.count + 1, b1, b2, eps, weight_decay,
                              learning_rate)

        out = tree_map(leaf, grads, params, state.mu, state.nu)
        return _pick(out, 0), AdamState(state.count + 1, _pick(out, 1), _pick(out, 2))

    return Optimizer(init, update)


@dataclasses.dataclass
class DDPOConfig:
    """The reference DDPOConfig knobs that survive the framework swap."""
    sample_num_steps: int = 10
    sample_batch_size: int = 4
    sample_num_batches_per_epoch: int = 2
    train_batch_size: int = 4
    train_num_inner_epochs: int = 1
    train_learning_rate: float = 3e-4
    train_adam_beta1: float = 0.9
    train_adam_beta2: float = 0.999
    train_adam_weight_decay: float = 1e-4
    train_adam_epsilon: float = 1e-8
    train_clip_range: float = 1e-4
    train_adv_clip_max: float = 5.0
    per_prompt_stat_tracking: bool = False
    per_prompt_stat_tracking_buffer_size: int = 16
    per_prompt_stat_tracking_min_count: int = 16
    seed: int = 0


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DDPOTrainer:
    def __init__(
        self,
        config: DDPOConfig,
        params: Any,
        *,
        sample_fn: Callable[..., Dict[str, Any]],
        logprob_fn: Callable[..., torch.Tensor],
        prompt_fn: Callable[[], Tuple[str, Any]],
        reward_fn: Callable[[Any, Sequence[str], Sequence[Any]],
                            Tuple[np.ndarray, Any]],
        embed_fn: Callable[[Sequence[str]], torch.Tensor],
    ) -> None:
        self.config = config
        self.params = params
        self.sample_fn = sample_fn
        self.logprob_fn = logprob_fn
        self.prompt_fn = prompt_fn
        self.reward_fn = reward_fn
        self.embed_fn = embed_fn
        self.stat_tracker = (
            PerPromptStatTracker(config.per_prompt_stat_tracking_buffer_size,
                                 config.per_prompt_stat_tracking_min_count)
            if config.per_prompt_stat_tracking else None)
        self._device = next(leaves_with_path(params))[1].device
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(config.seed)
        self._np_rng = np.random.default_rng(config.seed)
        self.optimizer = adamw(
            config.train_learning_rate, config.train_adam_beta1, config.train_adam_beta2,
            config.train_adam_epsilon, config.train_adam_weight_decay)
        self.opt_state = self.optimizer.init(params)

    # -- inner update ---------------------------------------------------------
    def _train_step(self, batch):
        def loss_fn(p):
            log_prob = self.logprob_fn(
                p, batch["latents"], batch["timesteps"],
                batch["next_latents"], batch["prompt_embeds"])
            loss, kl, clipfrac = calculate_loss(
                log_prob, batch["log_probs"], batch["advantages"],
                clip_range=self.config.train_clip_range,
                adv_clip_max=self.config.train_adv_clip_max)
            return loss, {"loss": loss, "approx_kl": kl, "clipfrac": clipfrac}

        (_, metrics), grads = trainer_mod.value_and_grad_params(loss_fn, self.params)
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        self.params = tree_map(lambda p, u: p + u.to(p.dtype), self.params, updates)
        return metrics

    # -- rollout ------------------------------------------------------------
    def _generate_samples(self, iterations: int, batch_size: int):
        """ddpo_trainer.py:429-489: per iteration draw prompts, embed, run
        the sampler, slice latents into (before, after) step pairs."""
        samples: List[Dict[str, Any]] = []
        prompt_image_data: List[List[Any]] = []
        for _ in range(iterations):
            prompts, metadata = zip(*[self.prompt_fn()
                                      for _ in range(batch_size)])
            embeds = self.embed_fn(prompts)
            out = self.sample_fn(self.params, self._gen, embeds,
                                 self.config.sample_num_steps)
            latents = _numpy(out["latents"])       # (B, T+1, ...)
            samples.append({
                "prompts": np.array(prompts),
                "prompt_embeds": _numpy(embeds),
                "timesteps": _numpy(out["timesteps"]),
                "latents": latents[:, :-1],
                "next_latents": latents[:, 1:],
                "log_probs": _numpy(out["log_probs"]),
            })
            prompt_image_data.append([out.get("images"), prompts, metadata])
        return samples, prompt_image_data

    def compute_rewards(self, prompt_image_pairs):
        rewards, metas = [], []
        for images, prompts, metadata in prompt_image_pairs:
            reward, meta = self.reward_fn(images, prompts, metadata)
            rewards.append(np.asarray(_numpy(reward), np.float64))
            metas.append(meta)
        return rewards, metas

    # -- one epoch-level step (reference `step`) ----------------------------
    def step(self, epoch: int, global_step: int) -> Tuple[int, Dict]:
        cfg = self.config
        samples, prompt_image_data = self._generate_samples(
            cfg.sample_num_batches_per_epoch, cfg.sample_batch_size)
        flat = {k: np.concatenate([s[k] for s in samples])
                for k in samples[0]}
        rewards_list, _ = self.compute_rewards(prompt_image_data)
        rewards = np.concatenate(rewards_list)

        if self.stat_tracker is not None:
            advantages = self.stat_tracker.update(
                [str(p) for p in flat["prompts"]], rewards)
        else:
            advantages = (rewards - rewards.mean()) / (rewards.std() + 1e-8)
        flat["advantages"] = advantages.astype(np.float32)
        flat.pop("prompts")

        total, num_t = flat["timesteps"].shape
        metrics: Dict[str, float] = {"reward_mean": float(rewards.mean()),
                                     "reward_std": float(rewards.std())}

        def put(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=self._device)

        for _ in range(cfg.train_num_inner_epochs):
            perm = self._np_rng.permutation(total)
            flat = {k: v[perm] for k, v in flat.items()}
            # independent per-sample timestep permutation
            # (ddpo_trainer.py:296-305)
            perms = np.stack([self._np_rng.permutation(num_t)
                              for _ in range(total)])
            rows = np.arange(total)[:, None]
            for key in ("timesteps", "latents", "next_latents", "log_probs"):
                flat[key] = flat[key][rows, perms]

            # rebatch to train_batch_size; every timestep is its own
            # training example (the reference loops j over the time axis
            # inside _train_batched_samples)
            n_batches = total // cfg.train_batch_size
            for i in range(n_batches):
                sl = slice(i * cfg.train_batch_size, (i + 1) * cfg.train_batch_size)
                for t in range(num_t):
                    batch = {
                        "latents": put(flat["latents"][sl, t]),
                        "next_latents": put(flat["next_latents"][sl, t]),
                        "timesteps": put(flat["timesteps"][sl, t]),
                        "log_probs": put(flat["log_probs"][sl, t], torch.float32),
                        "advantages": put(flat["advantages"][sl]),
                        "prompt_embeds": put(flat["prompt_embeds"][sl]),
                    }
                    m = self._train_step(batch)
                    global_step += 1
            metrics.update({k: float(v) for k, v in m.items()})
        return global_step, metrics

    def train(self, epochs: int):
        global_step = 0
        history = []
        for epoch in range(epochs):
            global_step, metrics = self.step(epoch, global_step)
            history.append(metrics)
        return history

