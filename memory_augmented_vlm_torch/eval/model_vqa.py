"""Batch VQA answer generation (counterpart of
`memory_augmented_vlm_tpu/eval/model_vqa.py`; reference
`llava/eval/model_vqa.py:86-240`): reads a questions JSON or JSONL file,
answers each question with the model and writes an answers JSONL; chunk
sharding (`--num-chunks`/`--chunk-idx`) splits a question file across
processes or hosts.

    python -m memory_augmented_vlm_torch.eval.model_vqa --model-path DIR \\
        --question-file q.jsonl [--video-folder V] [--image-folder I] \\
        [--answers-file answers.jsonl] [--device_preprocess] [--load-8bit]

Runs on the card; `--device-map cpu` loads onto the CPU instead. A
question's media is decoded and preprocessed on a prefetch thread while the
card answers the one before it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
from queue import Queue
from typing import List

import numpy as np

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.conversation import conv_templates
from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model


def get_chunk(lst: List, n: int, k: int) -> List:
    size = math.ceil(len(lst) / n)
    return lst[k * size:(k + 1) * size]


def load_questions(path: str) -> List[dict]:
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-folder", default="")
    p.add_argument("--video-folder", default="")
    p.add_argument("--extra-prompt", default="")
    p.add_argument("--answers-file", default="answers.jsonl")
    p.add_argument("--conv-mode", default="qwen_1_5")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--test_size", type=int, default=10000000)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--max_frames_num", type=int, default=64)
    p.add_argument("--device_preprocess", action="store_true",
                   help="send raw uint8 video frames to the card, where they are resized "
                        "and normalized (ops/preprocess.py), instead of the host processor")
    p.add_argument("--load-8bit", action="store_true",
                   help="serve the checkpoint with the tower and the LM prequantized to int8 "
                        "(the reference's bitsandbytes load_8bit, builder.py:30-34)")
    p.add_argument("--device-map", default="auto",
                   help="where the weights go: 'auto' (the card), 'cuda[:n]' or 'cpu'")
    args = p.parse_args(argv)

    tokenizer, model, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, "llava_qwen", load_8bit=args.load_8bit,
        device_map=args.device_map, device_preprocess=args.device_preprocess)
    questions = get_chunk(load_questions(args.question_file)[:args.test_size],
                          args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)

    def preprocess_question(q):
        """Decode and preprocess a question's media on the host."""
        text = q.get("text", q.get("question", q.get("Q1", "")))
        pixels, modality = None, "text"
        if q.get("video"):
            from memory_augmented_vlm_torch.data.video import load_video

            frames, *_ = load_video(os.path.join(args.video_folder, q["video"]))
            if frames.shape[0] > args.max_frames_num:
                idx = np.linspace(0, frames.shape[0] - 1, args.max_frames_num).astype(int)
                frames = frames[idx]
            if args.device_preprocess and frames.dtype == np.uint8:
                pixels = frames  # raw bytes; resized and normalized on the card
            else:
                pixels = image_processor.preprocess(frames)
            modality = "video"
        elif q.get("image"):
            from PIL import Image

            pixels = image_processor.preprocess(
                Image.open(os.path.join(args.image_folder, q["image"])))
            modality = "image"
        if pixels is not None and constants.DEFAULT_IMAGE_TOKEN not in text:
            text = constants.DEFAULT_IMAGE_TOKEN + "\n" + text
        if args.extra_prompt:
            text = text + args.extra_prompt
        return q, text, pixels, modality

    # double-buffered prefetch: question i+1 is decoded and preprocessed on
    # a thread while the card answers question i
    queue: Queue = Queue(maxsize=2)

    def producer():
        for q in questions:
            try:
                queue.put(preprocess_question(q))
            except Exception as e:  # noqa: BLE001 — a bad sample becomes an error row
                queue.put((q, f"__error__: {e}", None, "text"))
        queue.put(None)

    threading.Thread(target=producer, daemon=True).start()

    with open(args.answers_file, "w") as ans_file:
        while True:
            item = queue.get()
            if item is None:
                break
            q, text, pixels, modality = item
            if text.startswith("__error__"):
                ans_file.write(json.dumps({"question_id": q.get("question_id", q.get("id")),
                                           "text": "", "error": text}) + "\n")
                continue

            def answer_one(prompt_text):
                conv = conv_templates[args.conv_mode].copy()
                conv.append_message(conv.roles[0], prompt_text)
                conv.append_message(conv.roles[1], None)
                ids = tokenizer_image_token(conv.get_prompt(), tokenizer)
                out = model.generate(
                    ids[None], images=[pixels] if pixels is not None else None,
                    modalities=[modality], do_sample=args.temperature > 0,
                    temperature=args.temperature, top_p=args.top_p, num_beams=args.num_beams,
                    max_new_tokens=args.max_new_tokens,
                    eos_token_id=tokenizer.convert_tokens_to_ids("<|im_end|>"))
                return (tokenizer.decode(out[0], skip_special_tokens=True).strip(),
                        [int(t) for t in np.asarray(out[0]).tolist()])

            ans_text, ans_ids = answer_one(text)
            row = {
                "question_id": q.get("question_id", q.get("id")),
                "prompt": text,
                "text": ans_text,
                # the raw generated ids: a tiny test tokenizer may decode
                # unknown ids to the empty string, so A/Bs compare these
                "output_ids": ans_ids,
                "model_id": os.path.basename(args.model_path.rstrip("/")),
            }
            if q.get("answer") or q.get("A"):
                # the ground truth carried through for the judges (gpt_eval.py)
                row["answer"] = q.get("answer", q.get("A"))
            if q.get("Q2"):
                # a consistency pair (video_chatgpt_benchmark_eval_shard.sh's
                # consistency role): the second phrasing against the same media
                q2 = q["Q2"]
                if pixels is not None and constants.DEFAULT_IMAGE_TOKEN not in q2:
                    q2 = constants.DEFAULT_IMAGE_TOKEN + "\n" + q2
                row["pred2"] = answer_one(q2 + args.extra_prompt)[0]
            ans_file.write(json.dumps(row) + "\n")
            ans_file.flush()


if __name__ == "__main__":
    main()
