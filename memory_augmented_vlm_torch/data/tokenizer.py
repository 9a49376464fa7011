"""Tokenizer glue (a copy of `memory_augmented_vlm_tpu/data/tokenizer.py`;
`transformers` is imported by `load_qwen_tokenizer` only).

Reimplements llava/mm_utils.py:314-372: `tokenizer_image_token` (split the
prompt on "<image>", tokenize chunks, join with IMAGE_TOKEN_INDEX sentinels)
and keyword-based stopping for host-side decode loops.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from memory_augmented_vlm_torch.constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> np.ndarray:
    """Tokenize a prompt containing "<image>" sentinels.

    Matches the reference's interleave logic (mm_utils.py:314-338): each text
    chunk is tokenized separately; a chunk after the first drops its leading
    BOS if the tokenizer inserts one; sentinels become `image_token_index`.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    def insert_separator(xs, sep):
        out = []
        for i, x in enumerate(xs):
            out.append(x)
            if i < len(xs) - 1:
                out.append(sep)
        return out

    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if len(chunks) > 0 and len(chunks[0]) > 0 and bos is not None and chunks[0][0] == bos:
        offset = 1
        input_ids.append(chunks[0][0])
    for chunk in insert_separator(chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(chunk[offset:])
    return np.asarray(input_ids, dtype=np.int64)


class KeywordsStoppingCriteria:
    """Host-side keyword stopping (mm_utils.py:341-372 semantics): stop when
    any keyword string appears in the newly decoded text."""

    def __init__(self, keywords: Sequence[str], tokenizer, input_len: int = 0):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.input_len = input_len
        self.keyword_ids = []
        for kw in self.keywords:
            ids = tokenizer(kw).input_ids
            bos = getattr(tokenizer, "bos_token_id", None)
            if len(ids) > 1 and bos is not None and ids[0] == bos:
                ids = ids[1:]
            self.keyword_ids.append(np.asarray(ids, np.int64))
        self.max_keyword_len = max((len(i) for i in self.keyword_ids), default=0)

    def should_stop(self, output_ids: np.ndarray) -> bool:
        """output_ids: (S,) generated ids (without the prompt)."""
        tail = output_ids[-self.max_keyword_len:] if self.max_keyword_len else output_ids
        for kw_ids in self.keyword_ids:
            if len(tail) >= len(kw_ids) and np.array_equal(tail[-len(kw_ids):], kw_ids):
                return True
        # text backstop over a bounded tail only (the reference decodes the
        # full sequence every step — O(n^2) over a generation); a window of
        # 3x the longest keyword id-length covers mid-stream retokenization
        window = max(self.max_keyword_len * 3, 16)
        text = self.tokenizer.decode(output_ids[-window:],
                                     skip_special_tokens=False)
        return any(kw in text for kw in self.keywords)


def load_qwen_tokenizer(path_or_name: str = "Qwen/Qwen2-0.5B-Instruct"):
    """Load the HF tokenizer used by the flagship model (local path or hub)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path_or_name)
