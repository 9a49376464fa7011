"""Trainer -> eval bridge (counterpart of
`memory_augmented_vlm_tpu/eval/eval_bridge.py`).

Capability parity with `LLaVAEvalTrainer.evaluate`
(llava/train/llava_trainer_eval.py:1-60): benchmark evaluation of a training
checkpoint. Where lmms-eval is installed it runs it with the port's
`mavlm_torch` adapter (`eval/lmms_adapter.py`); otherwise it falls back to
the port's `model_vqa` CLI over a local question file.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
from typing import Optional, Sequence


def evaluate_checkpoint(
    checkpoint_dir: str,
    tasks: Sequence[str] = ("videomme",),
    *,
    question_file: Optional[str] = None,
    video_folder: str = "",
    output_dir: str = "eval_out",
    max_frames_num: int = 64,
) -> str:
    """Evaluate an HF-format checkpoint directory; returns the results path."""
    os.makedirs(output_dir, exist_ok=True)
    # the vendored API subset (third_party/lmms_eval) has no CLI __main__:
    # only a real installation can run `python -m lmms_eval`
    if shutil.which("lmms-eval") or _module_exists("lmms_eval.__main__"):
        cmd = [
            "python", "-m", "lmms_eval",
            "--model", "mavlm_torch",
            "--model_args", f"pretrained={checkpoint_dir},max_frames_num={max_frames_num}",
            "--tasks", ",".join(tasks),
            "--batch_size", "1",
            "--log_samples",
            "--output_path", output_dir,
        ]
        subprocess.run(cmd, check=True)
        return output_dir
    if question_file is None:
        raise RuntimeError("lmms-eval is not installed; pass question_file= for the "
                           "in-repo model_vqa fallback")
    from memory_augmented_vlm_torch.eval import model_vqa

    answers = os.path.join(output_dir, "answers.jsonl")
    model_vqa.main([
        "--model-path", checkpoint_dir,
        "--question-file", question_file,
        "--video-folder", video_folder,
        "--answers-file", answers,
        "--max_frames_num", str(max_frames_num),
    ])
    return answers


def _module_exists(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        # find_spec("pkg.__main__") raises when the parent package is absent
        return False
