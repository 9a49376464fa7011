"""A/B timing of the merge-heads attention kernels and the 64-frame int8
towers, on the card:

    python -m memory_augmented_vlm_torch.microbench.merge_ab [CHECKOUT ...]

With no argument it times this checkout: the merge (#2), its `int8_scores`
mode (#2s), the fused out-projection (#5) and the attention half-block
(#12) at the tower's shape (64 frames x 16 heads x 729 x 72), each as the
median of 5 single calls and as ten calls back to back (CUDA events), and
the 64-frame int8 tower through `siglip.forward` with the merge, with
`fused_oproj=True` and with the merge swapped for its `int8_scores` mode
(median of 5), on seeded random weights; and it prints the registers,
spills and shared memory that ptxas reported for those kernels. It prints
one JSON line. Given checkouts (directories of other trees of this
repository), it runs this file against each tree's package, in a process
of its own and in the order given (e.g. parent, change, change, parent, to
compare in turns on one card), and prints each run's line. Only entry
points that every tree of the port has are called.
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
from memory_augmented_vlm_torch.models import siglip
from memory_augmented_vlm_torch.ops import attn_block, cuda_lib, flash, quant

B, NH, S, D = 64, 16, 729, 72
KERNELS = re.compile(r"two_sweep|merge_int8|prep_kernel|oproj_heads")


def ptxas_report(log: str) -> dict:
    """{entry: 'Used N registers, ...' and its spill line} for the kernels
    of the merge-heads attention, from nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m or not KERNELS.search(m.group(1)):
            continue
        found = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                 if "Used" in x or "spill" in x]
        out[m.group(1)] = "; ".join(found)
    return out


def _int8_weight(gen, k, n):
    w, s = quant.prequantize_kernel(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    return w, s, torch.randn((n,), generator=gen, device="cuda") * 0.02


def measure() -> dict:
    card = require_card()
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    h = NH * D
    q, k, v = (torch.randn((B, NH, S, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    valid = torch.full((B,), S, dtype=torch.int32, device="cuda")
    hidden = torch.randn((B, S, h), generator=gen, device="cuda").to(torch.bfloat16)
    oproj = (q, k, v, valid, hidden, *_int8_weight(gen, h, h))
    block = [(hidden.float() * 0.3).to(torch.bfloat16),
             1.0 + 0.1 * torch.randn((h,), generator=gen, device="cuda"),
             0.1 * torch.randn((h,), generator=gen, device="cuda")]
    for _ in range(4):
        block += [quant.column_major(torch.randint(-127, 128, (h, h), generator=gen,
                                                   device="cuda", dtype=torch.int8)),
                  torch.randn((h,), generator=gen, device="cuda").abs() * 0.02 / 127,
                  torch.randn((h,), generator=gen, device="cuda") * 0.01]
    calls = {
        "flash_attention_merge_heads": lambda: flash.flash_attention_merge_heads(q, k, v, valid),
        "flash_attention_merge_heads_int8_scores":
            lambda: flash.flash_attention_merge_heads_int8_scores(q, k, v, valid),
        "flash_attention_out_proj_int8": lambda: flash.flash_attention_out_proj_int8(*oproj),
        "fused_attn_block_int8": lambda: attn_block.fused_attn_block_int8(*block, nh=NH,
                                                                         valid=S)}
    kernels = {name: {"ms": time_ms(fn),
                      "ms_back_to_back": time_ms(lambda fn=fn: [fn() for _ in range(10)]) / 10}
               for name, fn in calls.items()}
    del q, k, v, oproj, block, calls
    cfg = VLMConfig.onevision_0_5b().vision
    params = siglip.prequantize_int8(siglip.init_params(cfg, gen, "cuda", torch.bfloat16))
    pixels = torch.randn((64, 384, 384, 3), generator=gen, device="cuda").to(torch.bfloat16)

    def tower(fused=False):
        with torch.no_grad():
            return siglip.forward(params, cfg, pixels, int8=True, fused_oproj=fused)

    def int8_scores_tower():
        saved = siglip.flash_attention_merge_heads
        siglip.flash_attention_merge_heads = functools.partial(
            flash.flash_attention_merge_heads, int8_scores=True)
        try:
            return tower()
        finally:
            siglip.flash_attention_merge_heads = saved

    towers = {"int8": tower, "int8, fused_oproj": functools.partial(tower, True),
              "int8, int8_scores merge": int8_scores_tower}
    return {"checkout": os.getcwd(), "card": card, "kernels_tower_shape": kernels,
            "tower_64_frames_ms": {name: time_ms(fn) for name, fn in towers.items()},
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
