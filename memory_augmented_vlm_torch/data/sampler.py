"""Length/modality-grouped batch sampling (a copy of
`memory_augmented_vlm_tpu/data/sampler.py`, numpy only).

Capability parity with llava/train/llava_trainer.py:51-237
(`LengthGroupedSampler`, `get_length_grouped_indices`,
`get_modality_length_grouped_indices`): shuffle into length-sorted
mega-batches so batches have similar lengths (less padding waste), with the
multimodal variant first separating media samples (positive lengths) from
text-only samples (negative lengths) so a batch never mixes modalities.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy length-balanced split of one megabatch across ranks
    (llava_trainer.py:51-69 semantics)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0] * num_chunks
    for idx in indices:
        shortest = int(np.argmin(chunk_lengths))
        chunks[shortest].append(idx)
        chunk_lengths[shortest] += lengths[idx]
        if len(chunks[shortest]) == num_per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               generator: Optional[np.random.Generator] = None
                               ) -> List[int]:
    """Random megabatches sorted by length inside (llava_trainer.py:72-82)."""
    g = generator or np.random.default_rng(0)
    indices = g.permutation(len(lengths))
    mega = batch_size * world_size
    megabatches = [indices[i : i + mega].tolist() for i in range(0, len(lengths), mega)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches]
    out: List[int] = []
    for m in megabatches:
        for chunk in split_to_even_chunks(m, lengths, world_size):
            out.extend(chunk)
    return out


def get_modality_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                                        world_size: int,
                                        generator: Optional[np.random.Generator] = None
                                        ) -> List[int]:
    """Multimodal variant (llava_trainer.py:85-126): positive lengths are
    media samples, negative are text-only; group each separately, then shuffle
    whole megabatches together (last, shortest megabatch goes last)."""
    g = generator or np.random.default_rng(0)
    lengths = list(lengths)
    if any(l == 0 for l in lengths):
        # the reference asserts this (llava_trainer.py:87); a zero length
        # would otherwise silently vanish from the epoch below
        raise ValueError("modality grouping needs non-zero length hints "
                         "(positive = media, negative = text)")
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices([abs(l) for l in lengths], batch_size,
                                          world_size, g)
    mm_indices = [i for i, l in enumerate(lengths) if l > 0]
    lang_indices = [i for i, l in enumerate(lengths) if l < 0]
    mm_lengths = [lengths[i] for i in mm_indices]
    lang_lengths = [-lengths[i] for i in lang_indices]

    mm_shuffle = [mm_indices[i] for i in get_length_grouped_indices(
        mm_lengths, batch_size, world_size, g)]
    lang_shuffle = [lang_indices[i] for i in get_length_grouped_indices(
        lang_lengths, batch_size, world_size, g)]
    mega = batch_size * world_size
    mm_mega = [mm_shuffle[i : i + mega] for i in range(0, len(mm_shuffle), mega)]
    lang_mega = [lang_shuffle[i : i + mega] for i in range(0, len(lang_shuffle), mega)]
    last_mm = mm_mega[-1] if mm_mega and len(mm_mega[-1]) < mega else None
    last_lang = lang_mega[-1] if lang_mega and len(lang_mega[-1]) < mega else None
    full = [m for m in mm_mega if len(m) == mega] + [m for m in lang_mega if len(m) == mega]
    order = g.permutation(len(full))
    out: List[int] = []
    for i in order:
        out.extend(full[i])
    leftover = (last_mm or []) + (last_lang or [])
    out.extend(leftover)
    return out


class LengthGroupedSampler:
    """Iterable index sampler mirroring the reference class
    (llava_trainer.py:129-166)."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int], *, group_by_modality: bool = False,
                 seed: int = 0):
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.group_by_modality = group_by_modality
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        g = np.random.default_rng(self.seed + self._epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, g)
        else:
            idx = get_length_grouped_indices(
                [abs(l) for l in self.lengths], self.batch_size, self.world_size, g)
        return iter(idx)
