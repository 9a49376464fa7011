"""DPO preference dataset — the `DPODataset` of train_dpo.py (a copy of
`memory_augmented_vlm_tpu/data/dpo_dataset.py` on the port's
`LazySupervisedDataset`).

Items carry a shared prompt (+ optional video/image) and a chosen/rejected
response pair:
  {"id", "video"?, "image"?, "prompt": str,
   "chosen": str, "rejected": str}
or conversation-style {"chosen": [...], "rejected": [...]} where each is a
full conversations list (the reference's format); only the final assistant
turn differs.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.dataset import LazySupervisedDataset


class DPODataset(LazySupervisedDataset):
    """Preference pairs over the supervised dataset machinery."""

    def _conversations_for(self, item: Dict[str, Any], side: str):
        if isinstance(item.get(side), list):
            return copy.deepcopy(item[side])
        prompt = item.get("prompt", "")
        if ("image" in item or "video" in item) and \
                constants.DEFAULT_IMAGE_TOKEN not in prompt:
            prompt = constants.DEFAULT_IMAGE_TOKEN + "\n" + prompt
        return [
            {"from": "human", "value": prompt},
            {"from": "gpt", "value": item[side]},
        ]

    def _get_item(self, i: int) -> Dict[str, Any]:
        item = self.items[i]
        base = dict(item)
        base["conversations"] = self._conversations_for(item, "chosen")
        orig_first = (base["conversations"][0].get("value", "")
                      if base["conversations"] else "")
        self.items[i] = base
        out = super()._get_item(i)
        self.items[i] = item  # restore

        rej_convs = self._conversations_for(item, "rejected")
        # _get_item may rewrite the chosen prompt in place (the video
        # add_time_instruction); the rejected side must see the SAME prompt
        # or the DPO logratio compares responses to different contexts
        new_first = (base["conversations"][0].get("value", "")
                     if base["conversations"] else "")
        if (new_first != orig_first and rej_convs
                and rej_convs[0].get("value", "") == orig_first):
            rej_convs[0]["value"] = new_first
        rejected = self.preprocess_fn(rej_convs, self.tokenizer)
        out["chosen_input_ids"] = out.pop("input_ids")
        out["chosen_labels"] = out.pop("labels")
        out["rejected_input_ids"] = rejected["input_ids"]
        out["rejected_labels"] = rejected["labels"]
        return out
