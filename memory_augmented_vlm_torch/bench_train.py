"""Training-step benchmark of the port: the flagship 0.5B multimodal train
step on one CUDA card, the counterpart of the root `bench_train.py` (its
geometry, batches, optimizer, metric name and JSON keys).

    python -m memory_augmented_vlm_torch.bench_train [--iters 3] [--frames 64]

Times `train/trainer.make_train_step` at B = 1, 64 frames (2 segments), 32
fine frames and 128 text tokens (9,557 spliced tokens) with seeded random
bf16 weights at full width and depth. `--frames 300` is
finetune_short.sh's long-video shape: 300 frames pad to 10 segments of 32
(the ring cache's cap) and about 22k spliced tokens.

Timing: the first step, its batch made inside the clock as bench_train.py
does, is the warm-up (`compile_s`); then `--iters` steps on distinct
batches, all staged on the card before the clock starts (bench_train.py's
`--staged` protocol; the port has no relay to work around, so no flag),
each synchronised before and after; the headline is the fastest.
`vs_baseline` compares against the same modeled A100 step
(`baseline_train_step_s`). Leaves out bench_train.py's `impl` (the port
has one kernel set), `staged`, `backend` and `vs_baseline_iso_peak` (a
v5e/A100 peak ratio), and adds the peak device memory and the card.
Prints ONE JSON line. Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.timing import require_card
from memory_augmented_vlm_torch.models import vlm
from memory_augmented_vlm_torch.train import trainer
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig

NUM_FRAMES = 64
NUM_FINE = 32
ST = 128


def baseline_train_step_s(num_frames: int = NUM_FRAMES) -> float:
    """Analytic A100 train-step time for the same geometry (see module
    docstring; constants match bench.py's inference baseline model)."""
    nseg = min(-(-num_frames // 32), 10)  # ring cache caps at 10
    s_tokens = 1568 * nseg + 196 * min(32, num_frames) + 36
    tower_tf = 0.81 * num_frames                   # frozen: forward only
    lm_matmul_tf = 3 * 2 * 0.5e9 * s_tokens / 1e12  # fwd + bwd (2x fwd)
    # causal attention fwd+bwd: 2 matmuls * S^2 * D * NH / 2, x3.5 for bwd
    attn_tf = 3.5 * 2 * (s_tokens ** 2) * 64 * 14 * 0.5 * 24 / 1e12
    return (tower_tf + lm_matmul_tf + attn_tf) / (312.0 * 0.35)


def metric_name(num_frames: int) -> str:
    return f"train_step_s_0.5b_{num_frames}frame"


def optimizer_config() -> OptimizerConfig:
    """bench_train.py's optimizer (at warmup 0.03 of 100 steps, step 0 runs
    at lr 0)."""
    return OptimizerConfig(learning_rate=1e-5, memory_transformer_lr=5e-5,
                           memory_key_value_lr=5e-5, mm_vision_tower_lr=None, total_steps=100,
                           warmup_ratio=0.03)


def make_batch(rng: np.random.Generator, cfg: VLMConfig, num_frames: int,
               device) -> trainer.TrainBatch:
    """bench_train.make_batch's batch on `device`, from the same numpy draws:
    (1, num_frames) frames of standard normal pixels (bf16), padded with
    zero frames to whole segments and a validity mask; 128 text ids in
    [5, 1000) with the first 8 labels ignored; the image at text position
    3; the fine frames over the real ones. Frames at cfg's image size (384
    at the configurations bench_train runs)."""
    fmax = vlm.pad_frames_to_segment_multiple(num_frames, cfg.memory.segment_frames)
    side = cfg.vision.image_size
    pixels = rng.standard_normal((1, num_frames, side, side, 3)).astype(np.float32)
    if fmax != num_frames:  # pad to whole segments with a validity mask
        pixels = np.concatenate(
            [pixels, np.zeros((1, fmax - num_frames, side, side, 3), pixels.dtype)], axis=1)
    ids = rng.integers(5, 1000, size=(1, ST))
    labels = ids.copy()
    labels[:, :8] = constants.IGNORE_INDEX

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x)).to(device, dtype)

    return trainer.TrainBatch(
        pixels=torch.from_numpy(pixels).to(device, torch.bfloat16),
        frame_indices=t(np.arange(fmax)[None]),
        frame_valid=t((np.arange(fmax) < num_frames)[None], torch.bool),
        fine_idx=t(vlm.fine_frame_indices(num_frames, NUM_FINE)[None]),
        input_ids=t(ids), labels=t(labels), image_pos=t([3]), text_len=t([ST]))


def result(num_frames: int, nseg: int, times: List[float], compile_s: float, loss_first: float,
           loss_last: float, peak_memory_gb: float, card: str) -> dict:
    """bench_train.py's JSON line less `impl`, `staged`, `backend` and
    `vs_baseline_iso_peak`, with the peak memory and the card."""
    step_s = min(times)
    baseline_s = baseline_train_step_s(num_frames)
    return {
        "metric": metric_name(num_frames),
        "value": round(step_s, 3),
        "unit": "s/step",
        # throughput ratio (baseline time / ours): > 1 = faster than the modeled A100
        "vs_baseline": round(baseline_s / step_s, 3),
        "detail": {
            "frames": num_frames,
            "segments": nseg,
            "all_times": times,
            "compile_s": round(compile_s, 1),
            "loss_first": round(loss_first, 3),
            "loss_last": round(loss_last, 3),
            "baseline_modeled_s": round(baseline_s, 3),
            "peak_memory_gb": peak_memory_gb,  # torch.cuda.max_memory_allocated, 2^30 bytes
            "card": card,  # name and power limit, as nvidia-smi gives them
        },
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--frames", type=int, default=NUM_FRAMES)
    args = ap.parse_args(argv)
    card = require_card()  # raises without a CUDA card: this never runs on the CPU
    dev = "cuda"
    cfg = VLMConfig.onevision_0_5b()
    params = vlm.init_params(cfg, 0, dev, dtype=torch.bfloat16)
    opt_cfg = optimizer_config()
    state = trainer.init_train_state(params, opt_cfg)
    del params
    fmax = vlm.pad_frames_to_segment_multiple(args.frames, cfg.memory.segment_frames)
    nseg = min(fmax // cfg.memory.segment_frames, cfg.memory.cache_cap)
    step_fn = trainer.make_train_step(cfg, opt_cfg, nseg=nseg)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, make_batch(rng, cfg, args.frames, dev))
    loss_first = float(metrics["loss"])  # the value fetch waits for the step
    compile_s = time.perf_counter() - t0

    batches = [make_batch(rng, cfg, args.frames, dev) for _ in range(args.iters)]
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    out = result(args.frames, nseg, times, compile_s, loss_first, loss,
                 torch.cuda.max_memory_allocated() / 2**30, card)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
