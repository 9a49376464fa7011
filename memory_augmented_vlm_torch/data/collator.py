"""Batch collation: dataset samples -> static-shape `TrainBatch`es (the
counterpart of `memory_augmented_vlm_tpu/data/collator.py`; numpy out, as
there: the CLI moves a batch to the device).

Replaces the reference's `DataCollatorForSupervisedDataset`
(train.py:1282-1326) with bucket-aware padding: every sample in a batch is
padded to shared (Fmax, nfine, St), so the CLI keeps one step function per
bucket. Host-side frame re-sampling reproduces the fusion-time arithmetic
(models/vlm.py `sample_video_frames`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import MemoryConfig
from memory_augmented_vlm_torch.models.vlm import (
    fine_frame_indices,
    pad_frames_to_segment_multiple,
    sample_video_frames,
)


def _text_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate_video_batch(
    samples: List[Dict[str, Any]],
    memory_cfg: MemoryConfig,
    text_buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
    pad_token_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Collate video samples into TrainBatch arrays (as a dict of numpy).

    Each sample: {"pixels": (F0, H, W, C), "input_ids", "labels"} with one
    IMAGE_TOKEN_INDEX in input_ids. Produces per-batch-constant Fmax/nfine/St.
    """
    seg = memory_cfg.segment_frames
    nfine_target = memory_cfg.num_fine_frames

    per = []
    fmax_all, st_all = 0, 0
    for s in samples:
        pixels = s["pixels"]
        idx = sample_video_frames(pixels.shape[0])
        f1 = len(idx)
        fmax = pad_frames_to_segment_multiple(f1, seg)
        fine = fine_frame_indices(f1, nfine_target)
        ids = s["input_ids"]
        img_pos = int(np.where(ids == constants.IMAGE_TOKEN_INDEX)[0][0])
        ids_noim = np.delete(ids, img_pos)
        labels_noim = np.delete(s["labels"], img_pos)
        per.append(dict(pixels=pixels[idx], f1=f1, fmax=fmax, sample_idx=idx,
                        fine=fine, ids=ids_noim, labels=labels_noim,
                        img_pos=img_pos))
        fmax_all = max(fmax_all, fmax)
        st_all = max(st_all, len(ids_noim))

    st_all = _text_bucket(st_all, text_buckets)
    nfine = max(len(p["fine"]) for p in per)
    b = len(per)
    img = per[0]["pixels"].shape[1]
    c = per[0]["pixels"].shape[-1]

    batch = dict(
        pixels=np.zeros((b, fmax_all, img, img, c), np.float32),
        frame_indices=np.zeros((b, fmax_all), np.int32),
        frame_valid=np.zeros((b, fmax_all), bool),
        fine_idx=np.zeros((b, nfine), np.int32),
        input_ids=np.full((b, st_all), pad_token_id, np.int32),
        labels=np.full((b, st_all), constants.IGNORE_INDEX, np.int32),
        image_pos=np.zeros((b,), np.int32),
        text_len=np.zeros((b,), np.int32),
    )
    for i, p in enumerate(per):
        f1 = p["f1"]
        batch["pixels"][i, :f1] = p["pixels"]
        batch["frame_indices"][i, :f1] = p["sample_idx"]
        batch["frame_valid"][i, :f1] = True
        nf = len(p["fine"])
        batch["fine_idx"][i, :nf] = p["fine"]
        if nf < nfine:  # repeat last index; masked positions add no new info
            batch["fine_idx"][i, nf:] = p["fine"][-1] if nf else 0
        st = min(len(p["ids"]), st_all)
        batch["input_ids"][i, :st] = p["ids"][:st]
        batch["labels"][i, :st] = p["labels"][:st]
        batch["image_pos"][i] = min(p["img_pos"], st)
        batch["text_len"][i] = st
    return batch


def collate_text_batch(
    samples: List[Dict[str, Any]],
    text_buckets: Sequence[int] = (128, 256, 512, 1024, 2048),
    pad_token_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Collate text-only samples (no media) into TextBatch arrays."""
    st_all = _text_bucket(max(len(s["input_ids"]) for s in samples), text_buckets)
    b = len(samples)
    batch = dict(
        input_ids=np.full((b, st_all), pad_token_id, np.int32),
        labels=np.full((b, st_all), constants.IGNORE_INDEX, np.int32),
        text_len=np.zeros((b,), np.int32),
    )
    for i, s in enumerate(samples):
        st = min(len(s["input_ids"]), st_all)
        batch["input_ids"][i, :st] = s["input_ids"][:st]
        batch["labels"][i, :st] = s["labels"][:st]
        batch["text_len"][i] = st
    return batch


def bucket_key(sample: Dict[str, Any], memory_cfg: MemoryConfig,
               text_buckets: Sequence[int] = (128, 256, 512, 1024, 2048)) -> Tuple:
    """Group samples so each batch shares one compiled train step."""
    pixels = sample.get("pixels")
    if pixels is None:
        return ("text", _text_bucket(len(sample["input_ids"]), text_buckets))
    f1 = len(sample_video_frames(pixels.shape[0]))
    fmax = pad_frames_to_segment_multiple(f1, memory_cfg.segment_frames)
    return (
        "video",
        fmax,
        min(memory_cfg.num_fine_frames, f1),
        _text_bucket(len(sample["input_ids"]), text_buckets),
    )
