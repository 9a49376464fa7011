"""Training entry point (counterpart of `memory_augmented_vlm_tpu/train/cli.py`,
the reference's `train_mem.py`):

    python -m memory_augmented_vlm_torch.train.cli --data_path ... --output_dir ...
        [--model_name_or_path DIR] [--gradient_accumulation_steps 4]
        [--dropout_frames] [--tower_int8] ...

JAX's flags, names and defaults, with its checks and messages. The loop is
JAX's: dataset -> bucket queues -> collate (`data/collator.py`) -> one train
step per micro-step (`train/trainer.py`, one step function per (bucket,
segments, dropout)) -> checkpoints every `save_steps` through
`checkpoint/checkpoint_io.py`, auto-resume from the newest one -> an HF
safetensors export in `output_dir/hf_export`. `state.step` counts
micro-steps; the loop runs to `max_steps * gradient_accumulation_steps`,
and the optimizer applies an update every k-th (`build_optimizer`'s
accumulation). The data order is numpy's `default_rng(seed).permutation`
with `random.seed(seed)`, as in JAX, so both CLIs visit the same samples.

The model lives where `build_model` puts it: `--model_name_or_path` loads
through `eval/builder.load_pretrained_model` (on the card), otherwise the
0.5B configuration is initialised on the card in bf16 from `--seed`. There
is no CPU fallback: without a card both raise (tests hand in CPU weights by
replacing `build_model`). Batches go to the weights' device, pixels in the
weights' float dtype (the port's tower runs in its input's dtype; JAX
promotes the bf16 tower to its fp32 pixels').

One device only: `--mesh_*` and `--distributed` are accepted, and a layout
that needs more than one device raises (ROADMAP §1 item 9);
`--pp_microbatches` only matters under pipeline stages, so it is read and
not used. The loop's `data`, `step` and `checkpoint` sections are
`torch.profiler` spans (`utils/logging.StepTimer`). A metrics record holds
the step's metrics, each section's EMA (`time_<section>_s`) and last raw
time (`last_<section>_s`), and, for a video batch, whether that
micro-step dropped its fine frames (`dropped_frames`, decided at the step
count before it). JAX writes
the EMAs under the sections' own names, so its `step` key ends up holding
the step section's time, not the step count; here `step` is the count.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from memory_augmented_vlm_torch.checkpoint import checkpoint_io
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.data import collator as collator_mod
from memory_augmented_vlm_torch.data.dataset import PREPROCESS_FUNCS, LazySupervisedDataset
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.train import trainer as trainer_mod
from memory_augmented_vlm_torch.train.optimizer import OptimizerConfig
from memory_augmented_vlm_torch.utils.logging import (MetricsLogger, StepTimer, build_logger,
                                                      rank0_print)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("mavlm_torch trainer")
    # model
    p.add_argument("--model_name_or_path", type=str, default=None,
                   help="HF-format checkpoint dir (load_pretrained_model)")
    p.add_argument("--version", type=str, default="qwen_1_5")
    p.add_argument("--mm_tunable_parts", type=str,
                   default="larimar_model,recurrent_model,mm_language_model")
    p.add_argument("--mm_projector_type", type=str, default="mlp2x_gelu")
    p.add_argument("--mm_spatial_pool_mode", type=str, default="bilinear")
    p.add_argument("--dropout_frames", action="store_true")
    p.add_argument("--tower_int8", action="store_true",
                   help="run the frozen tower with prequantized int8 weights "
                        "(the fused int8 tower kernels; it takes no gradient either way)")
    # data
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--image_folder", type=str, default=None)
    p.add_argument("--video_folder", type=str, default=None)
    p.add_argument("--add_time_instruction", action="store_true")
    p.add_argument("--frames_upbound", type=int, default=300)
    # optimization (finetune_short.sh defaults)
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--mm_vision_tower_lr", type=float, default=2e-6)
    p.add_argument("--memory_transformer_lr", type=float, default=1e-5)
    p.add_argument("--memory_key_value_lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine")
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--per_device_train_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--model_max_length", type=int, default=32768)
    # infra
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--save_steps", type=int, default=100)
    p.add_argument("--save_total_limit", type=int, default=2)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--report_to", type=str, default="none")
    p.add_argument("--run_name", type=str, default="mavlm")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=0,
                   help="0 = all remaining devices (one here)")
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--mesh_sp", type=int, default=1)
    p.add_argument("--mesh_pp", type=int, default=1)
    p.add_argument("--mesh_ep", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipeline step (read only under --mesh_pp > 1)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported: ROADMAP §1 item 9)")
    return p.parse_args(argv)


def build_model(args) -> tuple:
    """Load or init (tokenizer, params, cfg), on the card."""
    if args.model_name_or_path:
        from memory_augmented_vlm_torch.eval.builder import load_pretrained_model

        tokenizer, model, _, _ = load_pretrained_model(
            args.model_name_or_path, None, "llava_qwen")
        return tokenizer, model.params, model.cfg
    if not torch.cuda.is_available():
        raise RuntimeError("the train CLI initialises its weights on a CUDA card; none is "
                           "available")
    from memory_augmented_vlm_torch.data.tokenizer import load_qwen_tokenizer
    from memory_augmented_vlm_torch.models import vlm as vlm_mod

    cfg = VLMConfig.onevision_0_5b()
    params = vlm_mod.init_params(cfg, args.seed, "cuda", dtype=torch.bfloat16)
    return load_qwen_tokenizer(), params, cfg


def _check_layout(args) -> None:
    """One device: any mesh axis above 1, or several processes, raises."""
    axes = {name: getattr(args, f"mesh_{name}") for name in ("data", "tp", "sp", "pp", "ep")}
    axes["fsdp"] = args.mesh_fsdp or 1
    wide = {k: v for k, v in axes.items() if v > 1}
    if wide or args.distributed:
        what = (f"mesh {wide}" if wide else "--distributed")
        raise NotImplementedError(
            f"{what} needs more than one device; the port trains on one card (parallelism "
            "is ROADMAP §1 item 9)")


def _to_batch(np_batch: Dict[str, np.ndarray], cls, device, dtype):
    def tensor(name, v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(device, dtype) if name == "pixels" else t.to(device)

    return cls(**{k: tensor(k, v) for k, v in np_batch.items()})


def train(args) -> Dict[str, float]:
    _check_layout(args)
    build_logger("train", os.path.join(args.output_dir, "train.log"))
    tokenizer, params, cfg = build_model(args)
    if args.version not in PREPROCESS_FUNCS:
        raise ValueError(
            f"--version {args.version}: available conversation templates: "
            f"{sorted(PREPROCESS_FUNCS)}")
    # the port's models have one projector and one pooling (config_from_json
    # refuses others when loading): other values cannot be trained
    if args.mm_projector_type != "mlp2x_gelu":
        raise NotImplementedError(
            f"--mm_projector_type {args.mm_projector_type} is not ported (ROADMAP §1 item 8); "
            "the port runs mlp2x_gelu")
    if args.mm_spatial_pool_mode != "bilinear":
        raise NotImplementedError(
            f"--mm_spatial_pool_mode {args.mm_spatial_pool_mode} is not ported (ROADMAP §1 "
            "item 8); the port runs bilinear")
    pipeline = dataclasses.replace(
        cfg.pipeline,
        dropout_frames=args.dropout_frames or cfg.pipeline.dropout_frames,
        add_time_instruction=args.add_time_instruction,
        frames_upbound=args.frames_upbound,
        tokenizer_model_max_length=args.model_max_length,
        tower_int8=args.tower_int8 or cfg.pipeline.tower_int8,
    )
    cfg = dataclasses.replace(cfg, pipeline=pipeline)
    if cfg.pipeline.tower_int8:
        # the FINAL flag value (CLI or checkpoint config.json) decides; a
        # quantized tower cannot also be trained. The port's towers are all
        # SigLIP (the loader refuses others).
        if "mm_vision_tower" in args.mm_tunable_parts:
            raise ValueError(
                "tower_int8 (from --tower_int8 or the checkpoint config) "
                "conflicts with training the tower (mm_tunable_parts "
                "contains mm_vision_tower)")
        if "kernel_int8" not in params["vision_tower"]["layers"][0]["q_proj"]:
            from memory_augmented_vlm_torch.models import siglip

            params["vision_tower"] = siglip.prequantize_int8(params["vision_tower"])
            rank0_print("tower: prequantized int8 (frozen, int8 kernels)")
    embed = params["language_model"]["embed_tokens"]
    device, dtype = embed.device, embed.dtype
    rank0_print(f"device: {device} ({dtype}); one device, no mesh")

    dataset = LazySupervisedDataset(
        args.data_path, tokenizer,
        image_folder=args.image_folder, video_folder=args.video_folder,
        image_processor=SigLipImageProcessor(
            size=(cfg.vision.image_size, cfg.vision.image_size)),
        pipeline=cfg.pipeline,
        conv_version=args.version,
    )
    steps_per_epoch = max(1, len(dataset) // max(
        1, args.per_device_train_batch_size * args.gradient_accumulation_steps))
    total_steps = (args.max_steps if args.max_steps > 0
                   else int(steps_per_epoch * args.num_train_epochs))
    # the loop counts micro-steps; the optimizer applies every k-th
    total_micro_steps = total_steps * args.gradient_accumulation_steps
    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate,
        grad_accum_steps=args.gradient_accumulation_steps,
        mm_vision_tower_lr=args.mm_vision_tower_lr,
        memory_transformer_lr=args.memory_transformer_lr,
        memory_key_value_lr=args.memory_key_value_lr,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        schedule=args.lr_scheduler_type,
        total_steps=total_steps,
        mm_tunable_parts=args.mm_tunable_parts,
    )
    state = trainer_mod.init_train_state(params, opt_cfg)
    del params

    resume = checkpoint_io.latest_checkpoint(args.output_dir)
    if resume:
        rank0_print(f"auto-resuming from {resume}")
        state = checkpoint_io.restore_checkpoint(resume, state)

    step_fns: Dict = {}
    metrics_log = MetricsLogger(args.output_dir, use_wandb=args.report_to == "wandb",
                                run_name=args.run_name)
    timer = StepTimer()
    rng = np.random.default_rng(args.seed)
    # dataset sampling strategies ('random:N') use the stdlib shuffle; seed
    # it too or auto-resumed runs rebuild a DIFFERENT data subset (the
    # reference gets this via HF set_seed)
    random.seed(args.seed)

    # bucketed batching: greedy queueing by bucket key
    queues: Dict[tuple, List] = defaultdict(list)
    order = rng.permutation(len(dataset))
    bsz = args.per_device_train_batch_size
    step = int(state.step)
    last: Dict[str, float] = {}
    i = 0
    # with --max_steps the data cycles until the step budget is spent;
    # otherwise one pass bounded by num_train_epochs
    data_budget = (np.inf if args.max_steps > 0
                   else len(order) * int(np.ceil(args.num_train_epochs)))
    while step < total_micro_steps and i < data_budget:
        with timer.section("data"):
            sample = dataset[int(order[i % len(order)])]
            i += 1
            key = collator_mod.bucket_key(sample, cfg.memory)
            queues[key].append(sample)
            if len(queues[key]) < bsz:
                continue
            samples = queues.pop(key)
            if key[0] == "text":
                batch = _to_batch(collator_mod.collate_text_batch(samples),
                                  trainer_mod.TextBatch, device, dtype)
                nseg, drop = 0, False
            else:
                np_batch = collator_mod.collate_video_batch(samples, cfg.memory)
                batch = _to_batch(np_batch, trainer_mod.TrainBatch, device, dtype)
                nseg = min(np_batch["pixels"].shape[1] // cfg.memory.segment_frames,
                           cfg.memory.cache_cap)
                drop = (cfg.pipeline.dropout_frames
                        and trainer_mod.synced_frame_dropout(step))
        fn_key = (key, nseg, drop)
        if fn_key not in step_fns:
            if key[0] == "text":
                step_fns[fn_key] = trainer_mod.make_text_train_step(cfg, opt_cfg)
            else:
                step_fns[fn_key] = trainer_mod.make_train_step(cfg, opt_cfg, nseg=nseg,
                                                               drop_frames=drop)
        with timer.section("step"):
            state, metrics = step_fns[fn_key](state, batch)
            last = {k: float(v) for k, v in metrics.items()}  # waits for the step
        step = int(state.step)
        if step % args.logging_steps == 0:
            times = {f"time_{k}_s": v for k, v in timer.summary().items()}
            times.update({f"last_{k}_s": v for k, v in timer.last.items()})
            if key[0] == "video":
                times["dropped_frames"] = drop
            metrics_log.log(step, dict(last, **times))
            rank0_print(f"step {step}/{total_micro_steps} loss={last.get('loss', 0):.4f} "
                        f"gnorm={last.get('grad_norm', 0):.3f} {timer.summary()}")
        if args.save_steps and step % args.save_steps == 0:
            with timer.section("checkpoint"):
                # a background write: the disk overlaps the next steps
                checkpoint_io.save_checkpoint(args.output_dir, state, step,
                                              keep=args.save_total_limit, block=False)

    if step == 0 and any(queues.values()):
        rank0_print(
            f"WARNING: dataset too small to fill a batch of {bsz}; "
            f"{sum(len(q) for q in queues.values())} samples queued but never "
            "trained — reduce batch size or add data")
    checkpoint_io.wait_for_checkpoints()
    final_path = os.path.join(args.output_dir, f"checkpoint-{step}")
    if step > 0 and not os.path.exists(final_path):
        checkpoint_io.save_checkpoint(args.output_dir, state, step,
                                      keep=args.save_total_limit)
    checkpoint_io.export_hf_safetensors(state.params, cfg,
                                        os.path.join(args.output_dir, "hf_export"))
    rank0_print(f"done at step {step}: {last}")
    return last


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return train(args)


if __name__ == "__main__":
    main()
