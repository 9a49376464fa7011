"""Iterative SFT (counterpart of
`memory_augmented_vlm_tpu/train/iterative_sft.py`, the capability of TRL's
`IterativeSFTTrainer`, trl/trainer/iterative_sft_trainer.py:52-334): an
online trainer whose `step()` is called with freshly generated batches
(lists of token lists) between rollouts instead of iterating a dataset.

Semantics mirrored:
  - labels default to input_ids (iterative_sft_trainer.py:255-257);
  - attention_mask defaults to all-ones (prepare_model_inputs:131-132);
  - `max_length` truncation with `truncation_mode` keep_start / keep_end
    (prepare_model_inputs:144-151);
  - per-call shuffled minibatching over the provided samples (step:262-297),
    the order from `np.random.default_rng(seed).permutation` as in JAX, so
    both packages see the same minibatches;
  - standard causal-LM CE with IGNORE on pad/masked positions.

`prepare_model_inputs` is numpy, copied from JAX; the step is the port's
text train step (`trainer.make_text_train_step`) on the params' device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig


def prepare_model_inputs(
    input_ids: Sequence[Sequence[int]],
    attention_mask: Optional[Sequence[Sequence[int]]] = None,
    labels: Optional[Sequence[Sequence[int]]] = None,
    *,
    max_length: Optional[int] = None,
    truncation_mode: str = "keep_end",
    pad_to_multiple: int = 8,
):
    """Pad a list of variable-length samples into right-padded arrays.

    Returns (ids (B, S) int32, labels (B, S) int32 with IGNORE_INDEX on
    pad/masked positions, lengths (B,) int32).
    """
    if labels is None:
        labels = [list(ids) for ids in input_ids]
    if attention_mask is None:
        attention_mask = [[1] * len(ids) for ids in input_ids]
    rows, labs, lens = [], [], []
    for ids, att, lab in zip(input_ids, attention_mask, labels):
        ids, att, lab = list(ids), list(att), list(lab)
        if max_length is not None and len(ids) > max_length:
            if truncation_mode == "keep_start":
                ids, att, lab = (x[:max_length] for x in (ids, att, lab))
            elif truncation_mode == "keep_end":
                ids, att, lab = (x[-max_length:] for x in (ids, att, lab))
            else:
                raise ValueError(f"Unknown truncation mode: {truncation_mode}")
        rows.append(ids)
        labs.append([l if a else constants.IGNORE_INDEX
                     for l, a in zip(lab, att)])
        lens.append(len(ids))
    smax = max(lens)
    smax = ((smax + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    ids_arr = np.zeros((len(rows), smax), np.int32)
    lab_arr = np.full((len(rows), smax), constants.IGNORE_INDEX, np.int32)
    for i, (ids, lab) in enumerate(zip(rows, labs)):
        ids_arr[i, : len(ids)] = ids
        lab_arr[i, : len(lab)] = lab
    return ids_arr, lab_arr, np.asarray(lens, np.int32)


class IterativeSFT:
    """Online trainer: call `step(input_ids=..., labels=...)` between
    rollouts; each call runs one shuffled pass over the provided samples."""

    def __init__(self, cfg: VLMConfig, opt_cfg: OptimizerConfig, params,
                 *, batch_size: int = 8, max_length: Optional[int] = None,
                 truncation_mode: str = "keep_end", seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_length = max_length
        self.truncation_mode = truncation_mode
        self._rng = np.random.default_rng(seed)
        self._step_fn = trainer_mod.make_text_train_step(cfg, opt_cfg)
        self.state = trainer_mod.init_train_state(params, opt_cfg)
        self._device = params["language_model"]["embed_tokens"].device

    def step(self, input_ids: Sequence[Sequence[int]],
             attention_mask: Optional[Sequence[Sequence[int]]] = None,
             labels: Optional[Sequence[Sequence[int]]] = None) -> dict:
        if input_ids is None:
            raise ValueError("step requires input_ids")
        ids, labs, lens = prepare_model_inputs(
            input_ids, attention_mask, labels,
            max_length=self.max_length, truncation_mode=self.truncation_mode)
        order = self._rng.permutation(len(ids))
        losses: List[float] = []
        for start in range(0, len(order), self.batch_size):
            sel = order[start: start + self.batch_size]
            batch = trainer_mod.TextBatch(*(torch.from_numpy(x[sel]).to(self._device)
                                            for x in (ids, labs, lens)))
            self.state, metrics = self._step_fn(self.state, batch)
            losses.append(float(metrics["loss"]))
        return {"loss": float(np.mean(losses)), "num_minibatches": len(losses),
                "step": int(self.state.step)}
