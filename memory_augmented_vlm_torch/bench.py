"""Headline benchmark of the port: end-to-end clip -> answer on one CUDA
card, the counterpart of the root `bench.py` (its flags, metric names and
JSON keys).

    python -m memory_augmented_vlm_torch.bench [--model 0.5b|7b] [--bf16_lm]
                                               [--frames N] [--no_memory]

Runs `pipeline.build_pipeline` with seeded random weights at full width and
depth: by default the 0.5B full-int8 serving configuration (int8 tower, LM,
unembedding and KV cache); `--bf16_lm` keeps the 0.5B LM in bf16;
`--model 7b` serves an int8 tower and the 7B LM with random int8 layer
kernels (`init_lm_7b_int8`), a bf16 untied `lm_head` and a bf16 KV cache;
`--no_memory` splices the pooled frames without the memory (BASELINE.json
config 2). Decode replays one CUDA graph per request.

Timing: CUDA events around the whole request (pixels on the card -> 32
tokens), after one warm-up request (which captures the decode graph);
three repetitions, all listed; the headline takes the fastest, as
`bench.py` does. `vs_baseline` compares against the same modeled A100
estimate (`baseline_visual_tokens_per_s`). The relay fields of `bench.py`
(`dispatch_floor_ms`, `projected_*`) have no counterpart. Prints ONE JSON
line. Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.timing import require_card
from memory_augmented_vlm_torch.models import qwen2, siglip, vlm
from memory_augmented_vlm_torch import pipeline

A100_BASELINE_VISUAL_TOKENS_PER_S = 16500.0
# 7B analytic baseline (same modeling): tower ~52 TF + 7B prefill over ~9.4k
# tokens (2 * 7.6e9 * 9.4e3 ~ 143 TF) at 35% MFU on 312 TF/s bf16 ~ 1.79 s,
# + 32 decode steps at ~12 ms/token (HBM-bound, 15.2 GB weights / 2 TB/s
# with flash-attn-2 overheads) ~ 0.38 s => ~2.17 s => ~4.3k visual tokens/s
A100_BASELINE_7B_VISUAL_TOKENS_PER_S = 4300.0

NUM_FRAMES = pipeline.NUM_FRAMES
MAX_NEW_TOKENS = pipeline.MAX_NEW_TOKENS
TEXT_BEFORE = [151644, 872, 198]
TEXT_AFTER = [3838, 374, 12482, 304, 419, 2766, 30, 151645, 198, 151644, 77091, 198]
REPS = 3


def baseline_visual_tokens_per_s(num_frames: int, model: str = "0.5b",
                                 no_memory: bool = False) -> float:
    """The modeled A100 baseline at other frame counts (BASELINE.json
    configs 2-5 span 16-128 frames).

    Same model as the 64-frame headline constants: SigLIP-SO400M ~0.81
    TF/frame + LM prefill (2 * n_params * S FLOPs, S = 1568*ceil(F/32)
    memory tokens + 6272 fine + text) at 35% MFU on 312 TF/s bf16, plus 32
    HBM-bound decode steps (~10 ms at 0.5B, ~380 ms at 7B: 15.2 GB weights
    / 2 TB/s + flash-attn-2 overheads). Returns exactly the pinned headline
    constants at 64 frames.
    """
    if num_frames == NUM_FRAMES and not no_memory:
        return (A100_BASELINE_7B_VISUAL_TOKENS_PER_S if model == "7b"
                else A100_BASELINE_VISUAL_TOKENS_PER_S)
    if no_memory:
        # plain pooled video branch: 196 + newline per frame + text
        s_tokens = 197 * num_frames + 15
    else:
        nseg = min((num_frames + 31) // 32, 10)  # ring cache caps at 10
        # 8*196 memory tokens/segment + 196/fine frame + vis prompts + text
        s_tokens = 1568 * nseg + 196 * min(32, num_frames) + 36
    n_params = 7.6e9 if model == "7b" else 0.5e9
    tf = 0.81 * num_frames + 2 * n_params * s_tokens / 1e12
    decode_s = 0.38 if model == "7b" else 0.010
    time_s = tf / (312.0 * 0.35) + decode_s
    return (s_tokens - 15) / time_s


def metric_name(num_frames: int, model: str = "0.5b", bf16_lm: bool = False,
                no_memory: bool = False) -> str:
    """`bench.py`'s metric name for a configuration (`--bf16_lm` applies to
    the 0.5B model only)."""
    if model == "7b":
        name = f"visual_tokens_per_s_{num_frames}frame_clip_to_answer_7b_int8"
    else:
        name = f"visual_tokens_per_s_{num_frames}frame_clip_to_answer_0.5b"
        if not bf16_lm:
            name += "_lm_int8"
    return name + ("_no_memory" if no_memory else "")


def init_lm_7b_int8(cfg_lm, gen: torch.Generator, device):
    """A random LM in serving int8 form (`bench._init_lm_7b_int8`): every
    layer's dense kernels random int8 in [-127, 127], column-major, with a
    constant per-output-channel scale of 0.02/127 (dequantized weights in
    the 0.02-std class of the float init); zero bf16 q/k/v biases; bf16
    embeddings and untied `lm_head` (normal * 0.02); bf16 unit norms. The
    7B model is made this way because its float weights need not exist."""
    h, inter = cfg_lm.hidden_size, cfg_lm.intermediate_size
    nh, nkv, d = cfg_lm.num_attention_heads, cfg_lm.num_key_value_heads, cfg_lm.head_dim

    def proj(d_in, d_out, bias=False):
        codes = torch.randint(-127, 128, (d_out, d_in), generator=gen, device=device,
                              dtype=torch.int8)
        entry = {"kernel_int8": codes.t(),  # (in, out), each column's K values contiguous
                 "scale": torch.full((d_out,), 0.02 / 127, dtype=torch.float32, device=device)}
        if bias:
            entry["bias"] = torch.zeros(d_out, dtype=torch.bfloat16, device=device)
        return entry

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)

    def ones():
        return torch.ones(h, dtype=torch.bfloat16, device=device)

    return {
        "embed_tokens": dense(cfg_lm.vocab_size, h),
        "layers": [
            {"input_layernorm": ones(), "post_attention_layernorm": ones(),
             "q_proj": proj(h, nh * d, True), "k_proj": proj(h, nkv * d, True),
             "v_proj": proj(h, nkv * d, True), "o_proj": proj(nh * d, h),
             "gate_proj": proj(h, inter), "up_proj": proj(h, inter),
             "down_proj": proj(inter, h)}
            for _ in range(cfg_lm.num_hidden_layers)
        ],
        "norm": ones(),
        "lm_head": dense(h, cfg_lm.vocab_size),
    }


def serving_config(model: str = "0.5b") -> VLMConfig:
    """The model's config with the int8 tower, as `bench.py` serves both."""
    cfg = VLMConfig.onevision_7b() if model == "7b" else VLMConfig.onevision_0_5b()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                 tower_int8=True))


def init_serving_params(cfg: VLMConfig, model: str, bf16_lm: bool, device, seed: int = 0):
    """`bench.py`'s serving weights for `cfg`, seeded: at 7B everything at a
    one-layer LM depth, then the LM from `init_lm_7b_int8` (seed + 1) swapped
    in; at 0.5B the float model, its LM prequantized with an int8 unembedding
    unless `bf16_lm`. The tower is prequantized to int8 in both."""
    if model == "7b":
        shallow = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_hidden_layers=1))
        params = vlm.init_params(shallow, seed, device, dtype=torch.bfloat16)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        params["language_model"] = init_lm_7b_int8(cfg.lm, gen, device)
    else:
        params = vlm.init_params(cfg, seed, device, dtype=torch.bfloat16)
        if not bf16_lm:
            params["language_model"] = qwen2.prequantize_int8(params["language_model"],
                                                              include_unembed=True)
    params["vision_tower"] = siglip.prequantize_int8(params["vision_tower"])
    return params


def kv_int8(model: str, bf16_lm: bool) -> bool:
    """The int8 KV cache belongs to the 0.5B full-int8 configuration only."""
    return model != "7b" and not bf16_lm


def request_inputs(cfg: VLMConfig, num_frames: int, device, seed: int = 0):
    """(pixels (F, H, W, 3) bf16 drawn on `device` from a seeded generator,
    text_before, text_after): `bench.py`'s prompt ids around the video."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    side = cfg.vision.image_size
    pixels = torch.randn((num_frames, side, side, 3), generator=gen, device=device)
    return (pixels.to(torch.bfloat16), torch.tensor(TEXT_BEFORE, device=device),
            torch.tensor(TEXT_AFTER, device=device))


def time_requests(fn, params, inputs, reps: int = REPS) -> List[float]:
    """Seconds of each of `reps` requests (the caller warms up first): CUDA
    events around the whole request, the card idle at its start."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(params, *inputs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times


def result(metric: str, times: List[float], n_visual: int, num_frames: int, nseg: int,
           baseline: float, card: str) -> dict:
    """`bench.py`'s JSON line less its relay fields, with every repetition
    and the card beside the headline."""
    latency = min(times)
    value = n_visual / latency
    return {
        "metric": metric,
        "value": round(value, 1),
        "unit": "visual tokens/s",
        "vs_baseline": round(value / baseline, 3),
        "detail": {
            "latency_s": round(latency, 4),
            "latency_s_reps": times,
            "visual_tokens": n_visual,
            "frames": num_frames,
            "segments": nseg,
            "decode_tokens": MAX_NEW_TOKENS,
            "backend": "cuda",
            "card": card,  # name and power limit, as nvidia-smi gives them
        },
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="0.5b", choices=["0.5b", "7b"])
    ap.add_argument("--bf16_lm", action="store_true",
                    help="0.5b only: serve the LM in bf16 instead of the default "
                    "full-int8 serving configuration")
    ap.add_argument("--frames", type=int, default=NUM_FRAMES,
                    help="clip length; non-multiples of the 32-frame segment pad "
                    "with a validity mask")
    ap.add_argument("--no_memory", action="store_true",
                    help="BASELINE.json config 2: pooled frames + image_newline, "
                    "no memory module")
    args, _ = ap.parse_known_args(argv)
    card = require_card()  # raises without a CUDA card: this never runs on the CPU
    bf16_lm = args.bf16_lm and args.model != "7b"
    cfg = serving_config(args.model)
    params = init_serving_params(cfg, args.model, bf16_lm, "cuda")
    fn, nseg = pipeline.build_pipeline(cfg, args.frames, no_memory=args.no_memory,
                                       kv_int8=kv_int8(args.model, bf16_lm))
    inputs = request_inputs(cfg, args.frames, "cuda")
    _, s = fn(params, *inputs)  # the warm-up: builds the kernels, captures the decode graph
    n_visual = s - len(TEXT_BEFORE) - len(TEXT_AFTER)
    times = time_requests(fn, params, inputs)
    out = result(metric_name(args.frames, args.model, bf16_lm, args.no_memory), times,
                 n_visual, args.frames, nseg,
                 baseline_visual_tokens_per_s(args.frames, args.model, args.no_memory), card)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
