"""SFT trainer capability — the reference's vendored TRL `SFTTrainer`
(counterpart of `memory_augmented_vlm_tpu/train/sft.py`).

The SFTTrainer's value-add over plain CE training is data preparation:
  - constant-length packing (trl/trainer/utils.py:341-457
    `ConstantLengthDataset`): concatenate eos-joined tokenized samples and
    emit fixed `seq_length` chunks, dropping the ragged tail;
  - completion-only label masking (trl/trainer/utils.py:119-192
    `DataCollatorForCompletionOnlyLM`): supervise only tokens after the
    response template, including the multi-turn instruction/response variant.

Both are numpy, copied from JAX; `make_sft_train_step` is the text-only
train step (`train/trainer.py`'s LM loss, grads and AdamW) over a packed
(input_ids, labels, valid_len) batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    seq_length: int = 1024
    packing: bool = True
    append_concat_token: bool = True
    ignore_index: int = constants.IGNORE_INDEX


def pack_constant_length(
    tokenized: Iterable[Sequence[int]],
    seq_length: int,
    concat_token_id: int,
    *,
    append_concat_token: bool = True,
    shuffle: bool = False,
    seed: int = 0,
) -> List[np.ndarray]:
    """ConstantLengthDataset packing over pre-tokenized samples: join with
    the eos/concat token, slice fixed-length chunks, drop the ragged tail
    (trl/trainer/utils.py:421-457). labels == input_ids for packed chunks."""
    all_ids: List[int] = []
    for ids in tokenized:
        ids = list(ids)
        if append_concat_token:
            ids = ids + [concat_token_id]
        all_ids.extend(ids)
    examples = [
        np.asarray(all_ids[i:i + seq_length], np.int64)
        for i in range(0, len(all_ids) - seq_length + 1, seq_length)
    ]
    if shuffle:
        rng = np.random.default_rng(seed)
        rng.shuffle(examples)
    return examples


def completion_only_labels(
    input_ids: np.ndarray,
    response_template_ids: Sequence[int],
    instruction_template_ids: Optional[Sequence[int]] = None,
    ignore_index: int = constants.IGNORE_INDEX,
) -> np.ndarray:
    """DataCollatorForCompletionOnlyLM label masking for one sequence
    (trl/trainer/utils.py:119-192): supervise only response spans.

    Single-template mode masks everything through the END of the (last)
    response template; instruction mode masks every [instruction, response)
    span across multi-turn sequences, plus any trailing instruction."""
    ids = np.asarray(input_ids)
    labels = ids.copy()
    resp = list(response_template_ids)

    def _matches(template: List[int]) -> List[int]:
        starts = []
        for idx in np.where(labels == template[0])[0]:
            if ids[idx:idx + len(template)].tolist() == template:
                starts.append(int(idx))
        return starts

    if instruction_template_ids is None:
        start = None
        for idx in _matches(resp):
            start = idx
        if start is None:
            labels[:] = ignore_index
        else:
            labels[: start + len(resp)] = ignore_index
        return labels

    instr = list(instruction_template_ids)
    response_idxs = [s + len(resp) for s in _matches(resp)]
    human_idxs = _matches(instr)
    if not response_idxs or not human_idxs:
        labels[:] = ignore_index
        return labels
    if human_idxs[0] > response_idxs[0]:
        human_idxs = [0] + human_idxs
    for i, (start, end) in enumerate(zip(human_idxs, response_idxs)):
        labels[(start if i != 0 else 0):end] = ignore_index
    if len(response_idxs) < len(human_idxs):
        labels[human_idxs[-1]:] = ignore_index
    return labels


def sft_loss(params, cfg: VLMConfig, input_ids: torch.Tensor, labels: torch.Tensor,
             valid_len: torch.Tensor):
    """Next-token CE over supervised positions (the HF Trainer objective the
    reference SFTTrainer delegates to): (mean loss, supervised tokens)."""
    embeds = qwen2.embed_tokens(params["language_model"], input_ids, cfg.lm)
    loss, metrics = trainer_mod._lm_loss(params, cfg, embeds, labels,
                                         valid_len.to(torch.int32))
    return loss, metrics["target_tokens"]


def make_sft_train_step(cfg: VLMConfig, opt_cfg: OptimizerConfig):
    """`step(state, input_ids, labels, valid_len) -> (state, metrics)`:
    loss, supervised_tokens, grad_norm."""
    def step(state: trainer_mod.TrainState, input_ids, labels, valid_len):
        def loss_fn(p):
            loss, n = sft_loss(p, cfg, input_ids, labels, valid_len)
            return loss, {"loss": loss, "supervised_tokens": n}

        return trainer_mod._step(loss_fn, state, opt_cfg)

    return step
