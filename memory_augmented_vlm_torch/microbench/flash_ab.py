"""A/B timing of the flash forward kernels (#1 `flash_attention`, #9
`forward_with_lse`), the 64-frame bf16 tower and the bf16 LM prefill, on the
card:

    python -m memory_augmented_vlm_torch.microbench.flash_ab [CHECKOUT ...]

With no argument it times this checkout: `flash.flash_attention` at its four
path shapes (the tower, 64 frames x 729 x 16 heads of 72; the memory's fuse
and evolve attentions, 1568 queries of 8 heads of 112 over 6272 and 15680
keys, 3136 valid; the 9,472-token causal LM prefill, 14 heads of 64 over 2
KV heads, 9444 valid), and where the tree has the wide kernel, the 7B
memory's (8 heads of 448 over 6272 keys, 3136 valid, and over 15680, 1568
valid) with its output's share of elements bit-equal to the plain version
at the kernel's key tile; `flash_bwd.forward_with_lse` at the train shape
(9557 causal tokens), each as the median of 5 single calls and as ten calls
back to back (CUDA events); the 64-frame bf16 tower through `siglip.forward`
and the 9,472-token bf16 prefill through `qwen2.forward` (median of 5), on
seeded random weights; and the registers, spills and shared memory that
ptxas reported for the forward kernels. It prints one JSON line. Given
checkouts (directories of other trees of this repository), it runs this
file against each tree's package, in a process of its own and in the order
given (e.g. parent, change, change, parent, to compare in turns on one
card), and prints each run's line. Only entry points that every tree of the
port has are called.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys

import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.timing import require_card, time_ms
from memory_augmented_vlm_torch.models import qwen2, siglip
from memory_augmented_vlm_torch.ops import cuda_lib, flash, flash_bwd

KERNELS = re.compile(r"fwd_sm90|fwd_kernel|flash_fwd_bf16|fwd_lse_bf16|fwd_wide")
PREFILL_TOKENS, PREFILL_VALID = 9472, 9444  # the 64-frame request's padded and spliced lengths
TRAIN_TOKENS = 9557


def ptxas_report(log: str) -> dict:
    """{entry: 'Used N registers, ...' and its spill line} for the bf16
    flash forward kernels, from nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m or not KERNELS.search(m.group(1)):
            continue
        found = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                 if "Used" in x or "spill" in x]
        out[m.group(1)] = "; ".join(found)
    return out


def _timed(fn) -> dict:
    return {"ms": time_ms(fn), "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10}


def measure() -> dict:
    card = require_card()
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def lens(*v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    shapes = {
        "tower": ((64, 729, 16, 72), (64, 729, 16, 72), lens(*[729] * 64), False),
        "memory_fuse": ((1, 1568, 8, 112), (1, 6272, 8, 112), lens(3136), False),
        "memory_evolve": ((1, 1568, 8, 112), (1, 15680, 8, 112), lens(3136), False),
        "lm_prefill": ((1, PREFILL_TOKENS, 14, 64), (1, PREFILL_TOKENS, 2, 64),
                       lens(PREFILL_VALID), True),
    }
    kernels = {}
    for name, (qs, kvs, valid, causal) in shapes.items():
        q, k, v = randn(*qs), randn(*kvs), randn(*kvs)
        groups = qs[2] // kvs[2]
        kernels[f"flash_fwd {name}"] = _timed(lambda: flash.flash_attention(
            q, k, v, valid, causal=causal, kv_groups=groups))
    if hasattr(flash, "WIDE_HEAD_DIM"):  # the 7B memory, trees from PR 13 on
        d = flash.WIDE_HEAD_DIM
        for name, skv, valid in (("memory_fuse_7b", 6272, 3136), ("memory_evolve_7b", 15680, 1568)):
            q, k, v = randn(1, 1568, 8, d), randn(1, skv, 8, d), randn(1, skv, 8, d)
            fn = functools.partial(flash.flash_attention, q, k, v, lens(valid))
            ref = flash.flash_attention_reference(q, k, v, lens(valid),
                                                  block_k=flash.forward_tiles(d)[0])
            kernels[f"flash_fwd {name}"] = {**_timed(fn),
                                            "bit_equal_share": float((fn() == ref).float().mean())}
        del q, k, v, ref
    q, k, v = (randn(1, TRAIN_TOKENS, h, 64) for h in (14, 2, 2))
    kernels["flash_fwd_lse lm_train"] = _timed(lambda: flash_bwd.forward_with_lse(
        q, k, v, lens(TRAIN_TOKENS), causal=True, scale=64 ** -0.5, kv_groups=7))
    del q, k, v

    cfg = VLMConfig.onevision_0_5b()
    tower = siglip.init_params(cfg.vision, gen, "cuda", torch.bfloat16)
    pixels = randn(64, 384, 384, 3)
    lm = qwen2.init_params(cfg.lm, gen, "cuda", torch.bfloat16)
    embeds = randn(1, PREFILL_TOKENS, cfg.lm.hidden_size)
    positions = torch.arange(PREFILL_TOKENS, device="cuda")[None]

    def tower_fn():
        with torch.no_grad():
            return siglip.forward(tower, cfg.vision, pixels)

    def prefill_fn():
        with torch.no_grad():
            return qwen2.forward(lm, cfg.lm, embeds, positions, valid_len=lens(PREFILL_VALID),
                                 cache_max_len=PREFILL_TOKENS + 32)

    return {"checkout": os.getcwd(), "card": card, "kernels": kernels,
            "bf16_tower_64_frames_ms": time_ms(tower_fn),
            "bf16_lm_prefill_ms": time_ms(prefill_fn),
            "ptxas": ptxas_report(cuda_lib.BUILD_LOG["ptxas"])}


def main(argv) -> None:
    if not argv:
        print(json.dumps(measure()), flush=True)
        return
    for tree in argv:  # this file, run against the other tree's package
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=tree, env=env, check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
