"""Supervised multimodal dataset — the `LazySupervisedDataset` equivalent
(reference: llava/train/train.py:981-1279; a copy of
`memory_augmented_vlm_tpu/data/dataset.py` over the port's image processor
and video loaders; PyYAML and Pillow are imported where they are used).

Capabilities replicated:
  - data_path may be JSON, JSONL, or a **YAML of datasets** with per-dataset
    `sampling_strategy` (`first:N`, `end:N`, `random:N`, percentages)
    (train.py:1001-1049);
  - per-sample retry ladder: same index x3, next index x3, then raise
    (train.py:1127-1158);
  - modality tags ("image" / "video" / "text") + length hints for the
    grouped samplers;
  - video branch supports folder-of-frames / pre-extracted tensors / codec
    files (data/video.py), with optional `add_time_instruction`
    (train.py:1238-1240);
  - ChatML (qwen) conversation tokenization with user-turn label masking
    (train.py preprocess_qwen semantics).
"""

from __future__ import annotations

import copy
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import PipelineConfig
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.data.video import load_video, load_video_dynamic


def load_data_manifest(data_path: str) -> List[Dict[str, Any]]:
    """Load JSON / JSONL / YAML-of-datasets with sampling strategies."""
    if data_path.endswith(".yaml") or data_path.endswith(".yml"):
        import yaml

        with open(data_path) as f:
            spec = yaml.safe_load(f)
        items: List[Dict[str, Any]] = []
        for ds in spec["datasets"]:
            sub = _load_single(ds["json_path"])
            sub = _apply_sampling_strategy(sub, ds.get("sampling_strategy", "all"))
            items.extend(sub)
        return items
    return _load_single(data_path)


def _load_single(path: str) -> List[Dict[str, Any]]:
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    with open(path) as f:
        return json.load(f)


def _apply_sampling_strategy(items: List, strategy: str) -> List:
    """`first:N`, `end:N`, `random:N`; N may be a count or `P%`
    (train.py:1015-1043 semantics)."""
    if not strategy or strategy == "all":
        return items
    kind, _, amount = strategy.partition(":")
    if not amount:
        return items
    if amount.endswith("%"):
        n = int(len(items) * float(amount[:-1]) / 100.0)
    else:
        n = int(amount)
    n = min(n, len(items))
    if kind == "first":
        return items[:n]
    if kind == "end":
        return items[-n:]
    if kind == "random":
        out = list(items)
        random.shuffle(out)
        return out[:n]
    raise ValueError(f"Unknown sampling strategy: {strategy}")


def preprocess_qwen(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    system_message: str = "You are a helpful assistant.",
) -> Dict[str, np.ndarray]:
    """ChatML tokenization with user/system label masking.

    Matches the reference's apply_chat_template flow (train.py:615-655):
    system + per-turn ChatML blocks; assistant turns supervised; the
    <|im_start|>/<|im_end|> structure tokens unmasked; "<image>" becomes
    IMAGE_TOKEN_INDEX.
    """
    roles = {"human": "user", "gpt": "assistant"}
    im_start = tokenizer.convert_tokens_to_ids("<|im_start|>")
    im_end = tokenizer.convert_tokens_to_ids("<|im_end|>")
    unmask = {im_start, im_end}
    nl = tokenizer("\n", add_special_tokens=False).input_ids

    def encode_block(role: str, content: str) -> List[int]:
        ids = [im_start]
        ids += tokenizer(role, add_special_tokens=False).input_ids
        ids += nl
        ids += tokenizer(content, add_special_tokens=False).input_ids
        ids += [im_end]
        ids += nl
        return ids

    input_id: List[int] = []
    target: List[int] = []
    sys_ids = encode_block("system", system_message)
    input_id += sys_ids
    target += [constants.IGNORE_INDEX] * len(sys_ids)

    convs = list(conversations)
    if convs and roles.get(convs[0].get("from", convs[0].get("role")), "") != "user":
        convs = convs[1:]
    for conv in convs:
        role = roles.get(conv.get("from", conv.get("role")), conv.get("role", "user"))
        content = conv.get("value", conv.get("content", ""))
        # tokenize around the <image> sentinel
        ids: List[int] = []
        pieces = content.split(constants.DEFAULT_IMAGE_TOKEN)
        block_ids: List[int] = [im_start]
        block_ids += tokenizer(role, add_special_tokens=False).input_ids + nl
        for i, piece in enumerate(pieces):
            block_ids += tokenizer(piece, add_special_tokens=False).input_ids
            if i < len(pieces) - 1:
                block_ids.append(constants.IMAGE_TOKEN_INDEX)
        block_ids += [im_end] + nl
        input_id += block_ids
        if role in ("user", "system"):
            target += [constants.IGNORE_INDEX] * len(block_ids)
        else:
            target += block_ids
    # unmask ChatML structure tokens (reference train.py:644-647)
    target = [
        tid if tid in unmask else t
        for tid, t in zip(input_id, target)
    ]
    return {
        "input_ids": np.asarray(input_id, np.int64),
        "labels": np.asarray(target, np.int64),
    }


class LazySupervisedDataset:
    """Lazy multimodal dataset with the reference's retry/skip behavior."""

    def __init__(
        self,
        data_path: str,
        tokenizer,
        image_folder: Optional[str] = None,
        video_folder: Optional[str] = None,
        image_processor: Optional[SigLipImageProcessor] = None,
        pipeline: Optional[PipelineConfig] = None,
        conv_version: str = "qwen_1_5",
    ):
        self.items = load_data_manifest(data_path)
        self.tokenizer = tokenizer
        self.image_folder = image_folder
        self.video_folder = video_folder
        self.image_processor = image_processor or SigLipImageProcessor()
        self.pipeline = pipeline or PipelineConfig()
        if conv_version not in PREPROCESS_FUNCS:
            raise ValueError(
                f"Unknown conversation version {conv_version!r}; "
                f"available: {sorted(PREPROCESS_FUNCS)}")
        self.preprocess_fn = PREPROCESS_FUNCS[conv_version]

    def __len__(self) -> int:
        return len(self.items)

    @property
    def modality_lengths(self) -> List[int]:
        """Signed length hints for the modality-grouped sampler: positive for
        samples with media, negative for text-only (llava_trainer.py:129-160
        convention)."""
        out = []
        for item in self.items:
            conv_len = sum(
                len(c.get("value", c.get("content", "")).split())
                for c in item.get("conversations", [])
            )
            has_media = "image" in item or "video" in item
            out.append(conv_len if has_media else -conv_len)
        return out

    def _get_item(self, i: int) -> Dict[str, Any]:
        item = self.items[i]
        convs = copy.deepcopy(item.get("conversations", []))
        out: Dict[str, Any] = {"id": item.get("id", i)}

        if "video" in item:
            path = item["video"]
            if self.video_folder and not os.path.isabs(path):
                path = os.path.join(self.video_folder, path)
            loader = (load_video_dynamic
                      if getattr(self.pipeline, "dynamic_video_sampling",
                                 False) else load_video)
            frames, video_time, frame_times, num = loader(
                path,
                video_fps=self.pipeline.video_fps,
                frames_upbound=self.pipeline.frames_upbound,
                force_sample=self.pipeline.force_sample,
            )
            pixels = self.image_processor.preprocess(frames)
            if convs and constants.DEFAULT_IMAGE_TOKEN not in convs[0].get(
                    "value", ""):
                # a media sample without the sentinel would crash the video
                # collator (np.where(...)[0][0]); prepend like the serving
                # and adapter paths do for raw questions
                convs[0]["value"] = (constants.DEFAULT_IMAGE_TOKEN + "\n"
                                     + convs[0].get("value", ""))
            if self.pipeline.add_time_instruction and convs:
                instr = (
                    f"The video lasts for {video_time:.2f} seconds, and "
                    f"{num} frames are uniformly sampled from it. These "
                    f"frames are located at {frame_times}."
                )
                convs[0]["value"] = convs[0].get("value", "").replace(
                    constants.DEFAULT_IMAGE_TOKEN,
                    f"{constants.DEFAULT_IMAGE_TOKEN}\n{instr}",
                )
            out["pixels"] = pixels
            out["modality"] = "video"
        elif "image" in item:
            from PIL import Image

            path = item["image"]
            if self.image_folder and not os.path.isabs(path):
                path = os.path.join(self.image_folder, path)
            img = Image.open(path).convert("RGB")
            out["pixels"] = self.image_processor.preprocess(img)
            out["image_size"] = img.size
            out["modality"] = "image"
            if convs and constants.DEFAULT_IMAGE_TOKEN not in convs[0].get(
                    "value", ""):
                convs[0]["value"] = (constants.DEFAULT_IMAGE_TOKEN + "\n"
                                     + convs[0].get("value", ""))
        else:
            out["modality"] = "text"

        enc = self.preprocess_fn(convs, self.tokenizer)
        out.update(enc)
        return out

    def __getitem__(self, i: int) -> Dict[str, Any]:
        """Retry ladder: same index x3, following indices x3, then raise
        (train.py:1127-1158)."""
        last_err: Optional[Exception] = None
        for _ in range(3):
            try:
                return self._get_item(i)
            except Exception as e:  # noqa: BLE001 — media IO is flaky by design
                last_err = e
        for step in range(1, 4):
            j = (i + step) % len(self)
            try:
                return self._get_item(j)
            except Exception as e:  # noqa: BLE001
                last_err = e
        raise RuntimeError(f"failed to load sample {i} and 3 successors") from last_err


def preprocess_plain(conversations, tokenizer) -> Dict[str, np.ndarray]:
    """Pretraining-style plain captioning (train.py preprocess_plain): input
    is `<image>\\n` + caption; only the caption is supervised."""
    assert len(conversations) == 2
    caption = conversations[1].get("value", conversations[1].get("content", ""))
    ids: List[int] = [constants.IMAGE_TOKEN_INDEX]
    nl = tokenizer("\n", add_special_tokens=False).input_ids
    cap_ids = tokenizer(caption, add_special_tokens=False).input_ids
    input_id = ids + nl + cap_ids
    target = [constants.IGNORE_INDEX] * (1 + len(nl)) + list(cap_ids)
    return {"input_ids": np.asarray(input_id, np.int64),
            "labels": np.asarray(target, np.int64)}


def preprocess_llama3(
    conversations, tokenizer,
    system_message: str = "You are a helpful language and vision assistant.",
) -> Dict[str, np.ndarray]:
    """Llama-3 header-block format (train.py preprocess_llama3 semantics):
    <|start_header_id|>role<|end_header_id|>\\n\\n content <|eot_id|>, user and
    system turns masked, structure tokens unmasked."""
    roles = {"human": "user", "gpt": "assistant"}
    sh = tokenizer.convert_tokens_to_ids("<|start_header_id|>")
    eh = tokenizer.convert_tokens_to_ids("<|end_header_id|>")
    eot = tokenizer.convert_tokens_to_ids("<|eot_id|>")
    bos = tokenizer.convert_tokens_to_ids("<|begin_of_text|>")
    unmask = {sh, eh, eot, bos}
    nl2 = tokenizer("\n\n", add_special_tokens=False).input_ids

    def block(role: str, content: str, mask: bool):
        ids = [sh] + tokenizer(role, add_special_tokens=False).input_ids + [eh] + nl2
        body: List[int] = []
        pieces = content.split(constants.DEFAULT_IMAGE_TOKEN)
        for i, piece in enumerate(pieces):
            body += tokenizer(piece, add_special_tokens=False).input_ids
            if i < len(pieces) - 1:
                body.append(constants.IMAGE_TOKEN_INDEX)
        ids += body + [eot]
        tgt = ([constants.IGNORE_INDEX] * len(ids)) if mask else list(ids)
        return ids, tgt

    input_id: List[int] = [bos]
    target: List[int] = [constants.IGNORE_INDEX]
    ids, tgt = block("system", system_message, mask=True)
    input_id += ids
    target += tgt
    for conv in conversations:
        role = roles.get(conv.get("from", conv.get("role")), "user")
        content = conv.get("value", conv.get("content", ""))
        ids, tgt = block(role, content, mask=role != "assistant")
        input_id += ids
        target += tgt
    target = [tid if tid in unmask else t for tid, t in zip(input_id, target)]
    return {"input_ids": np.asarray(input_id, np.int64),
            "labels": np.asarray(target, np.int64)}


def preprocess_v1(
    conversations, tokenizer,
    system_message: str = (
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
) -> Dict[str, np.ndarray]:
    """Vicuna v1 (TWO separator style, train.py preprocess_v1 semantics):
    `system USER: x ASSISTANT: y</s>`; everything except assistant replies
    masked."""
    roles = {"human": "USER", "gpt": "ASSISTANT"}
    eos = getattr(tokenizer, "eos_token_id", None)
    input_id: List[int] = list(
        tokenizer(system_message + " ", add_special_tokens=False).input_ids)
    target: List[int] = [constants.IGNORE_INDEX] * len(input_id)
    for conv in conversations:
        role = roles.get(conv.get("from", conv.get("role")), "USER")
        content = conv.get("value", conv.get("content", ""))
        if role == "USER":
            ids: List[int] = []
            pieces = content.split(constants.DEFAULT_IMAGE_TOKEN)
            for i, piece in enumerate(pieces):
                ids += tokenizer(f"USER: {piece} " if i == 0 else piece,
                                 add_special_tokens=False).input_ids
                if i < len(pieces) - 1:
                    ids.append(constants.IMAGE_TOKEN_INDEX)
            input_id += ids
            target += [constants.IGNORE_INDEX] * len(ids)
        else:
            prefix = tokenizer("ASSISTANT: ", add_special_tokens=False).input_ids
            body = tokenizer(content, add_special_tokens=False).input_ids
            input_id += prefix + body
            target += [constants.IGNORE_INDEX] * len(prefix) + list(body)
            if eos is not None:
                input_id.append(eos)
                target.append(eos)
    return {"input_ids": np.asarray(input_id, np.int64),
            "labels": np.asarray(target, np.int64)}


def preprocess_gemma(conversations, tokenizer) -> Dict[str, np.ndarray]:
    """Gemma turn format (train.py preprocess_gemma semantics):
    <start_of_turn>role\n content <end_of_turn>\n per turn, model turns
    supervised (including the closing <end_of_turn>)."""
    roles = {"human": "user", "gpt": "model"}
    sot = tokenizer.convert_tokens_to_ids("<start_of_turn>")
    eot = tokenizer.convert_tokens_to_ids("<end_of_turn>")
    bos = getattr(tokenizer, "bos_token_id", None)
    nl = tokenizer("\n", add_special_tokens=False).input_ids

    input_id: List[int] = [] if bos is None else [bos]
    target: List[int] = [constants.IGNORE_INDEX] * len(input_id)
    for conv in conversations:
        role = roles.get(conv.get("from", conv.get("role")), "user")
        content = conv.get("value", conv.get("content", ""))
        head = [sot] + tokenizer(role, add_special_tokens=False).input_ids + nl
        body: List[int] = []
        pieces = content.split(constants.DEFAULT_IMAGE_TOKEN)
        for i, piece in enumerate(pieces):
            body += tokenizer(piece, add_special_tokens=False).input_ids
            if i < len(pieces) - 1:
                body.append(constants.IMAGE_TOKEN_INDEX)
        tail = [eot] + nl
        input_id += head + body + tail
        if role == "model":
            target += [constants.IGNORE_INDEX] * len(head) + body + tail
        else:
            target += [constants.IGNORE_INDEX] * (len(head) + len(body) + len(tail))
    return {"input_ids": np.asarray(input_id, np.int64),
            "labels": np.asarray(target, np.int64)}


def preprocess_llama_2(
    conversations, tokenizer,
    system_message: str = (
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist "
        "the user with a variety of tasks using natural language."
    ),
) -> Dict[str, np.ndarray]:
    """Llama-2 [INST] format (train.py preprocess_llama_2 semantics):
    `[INST] <<SYS>>\n{sys}\n<</SYS>>\n\n{user} [/INST] {answer}</s>` per
    round (system only on the first); answers + eos supervised."""
    bos = getattr(tokenizer, "bos_token_id", None)
    eos = getattr(tokenizer, "eos_token_id", None)

    def tok_with_image(text: str) -> List[int]:
        ids: List[int] = []
        pieces = text.split(constants.DEFAULT_IMAGE_TOKEN)
        for i, piece in enumerate(pieces):
            ids += tokenizer(piece, add_special_tokens=False).input_ids
            if i < len(pieces) - 1:
                ids.append(constants.IMAGE_TOKEN_INDEX)
        return ids

    users = [c for c in conversations
             if c.get("from", c.get("role")) in ("human", "user")]
    answers = [c for c in conversations
               if c.get("from", c.get("role")) in ("gpt", "assistant")]
    input_id: List[int] = []
    target: List[int] = []
    for rnd, (u, a) in enumerate(zip(users, answers)):
        utext = u.get("value", u.get("content", ""))
        atext = a.get("value", a.get("content", ""))
        if rnd == 0:
            utext = f"<<SYS>>\n{system_message}\n<</SYS>>\n\n{utext}"
        prefix = ([] if bos is None else [bos]) + tok_with_image(
            f"[INST] {utext} [/INST]")
        body = tokenizer(atext, add_special_tokens=False).input_ids
        input_id += prefix + body
        target += [constants.IGNORE_INDEX] * len(prefix) + list(body)
        if eos is not None:
            input_id.append(eos)
            target.append(eos)
    return {"input_ids": np.asarray(input_id, np.int64),
            "labels": np.asarray(target, np.int64)}


PREPROCESS_FUNCS = {
    "qwen_1_5": preprocess_qwen,
    "qwen_2": preprocess_qwen,
    "plain": preprocess_plain,
    "llava_plain": preprocess_plain,
    "llava_llama_3": preprocess_llama3,
    "llama3": preprocess_llama3,
    "v1": preprocess_v1,
    "vicuna_v1": preprocess_v1,
    "gemma": preprocess_gemma,
    "llama_2": preprocess_llama_2,
    "llava_llama_2": preprocess_llama_2,
    # MPT uses the same ChatML structure/masking as qwen (train.py:827-905)
    "mpt": preprocess_qwen,
}
