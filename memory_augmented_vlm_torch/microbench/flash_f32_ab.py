"""A/B timing of #1 in fp32 (`flash.flash_attention` on fp32 tensors, the
kernel of csrc/flash_fwd.cu) on the card:

    python -m memory_augmented_vlm_torch.microbench.flash_f32_ab [CHECKOUT ...]

With no argument it times this checkout, TF32 off, at the fp32 path shapes
(`SHAPES`): the tower (64 frames x 729 x 16 heads of 72), the 0.5B memory's
fuse and evolve (1568 queries of 8 heads of 112 over 6272 keys, 3136 valid,
and over 15680, 1568 valid), Gemma-2B's (8 heads of 256 over 6272 keys,
all valid, and over 15680, 1568 valid), the 0.5B and 7B LMs' causal
9,472-token prefill in fp32 (14 heads of 64 over 2 KV heads, 28 of 128 over
4; 9444 valid) and, where the tree takes fp32 at head dim 448, the 7B
memory's (8 heads of 448 over 6272 keys, 3136 valid, and over 15680, 1568
valid). Each shape gives the median of 5 single calls and of ten calls back
to back (CUDA events), the largest difference from the plain version (the
online softmax over 1024-key tiles: the fp32 function of one tile), and
SDPA's fp32 time on the same inputs; then the registers and spills ptxas
reported for the fp32 kernels. It prints one JSON line. Given checkouts
(directories of other trees of this repository), it runs this file against
each tree's package, in a process of its own and in the order given (e.g.
parent, change, change, parent, to compare in turns on one card), and
prints each run's line. Only entry points that every tree of the port has
are called.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.microbench.timing import require_card, time_ms
from memory_augmented_vlm_torch.ops import cuda_lib, flash

# (name, q shape, k/v shape, valid length, causal)
SHAPES = [
    ("tower", (64, 729, 16, 72), (64, 729, 16, 72), 729, False),
    ("memory_fuse", (1, 1568, 8, 112), (1, 6272, 8, 112), 3136, False),
    ("memory_evolve", (1, 1568, 8, 112), (1, 15680, 8, 112), 1568, False),
    ("memory_fuse_gemma", (1, 1568, 8, 256), (1, 6272, 8, 256), 6272, False),
    ("memory_evolve_gemma", (1, 1568, 8, 256), (1, 15680, 8, 256), 1568, False),
    ("lm_prefill", (1, 9472, 14, 64), (1, 9472, 2, 64), 9444, True),
    ("lm_prefill_7b", (1, 9472, 28, 128), (1, 9472, 4, 128), 9444, True),
    ("memory_fuse_7b", (1, 1568, 8, 448), (1, 6272, 8, 448), 3136, False),
    ("memory_evolve_7b", (1, 1568, 8, 448), (1, 15680, 8, 448), 1568, False),
]
PLAIN_BLOCK_K = 1024
F32_KERNELS = re.compile(r"flash_fwd_(f32|3xtf32)_kernel")


def ptxas_report(log: str) -> dict:
    """{entry: its 'Used N registers' and spill lines} for the fp32 forward
    kernels, from nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and F32_KERNELS.search(m.group(1)):
            out[m.group(1)] = "; ".join(x.split("info    :")[-1].strip()
                                        for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x)
    return out


def _sdpa(q, k, v, valid, causal):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if causal:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=gqa)
    keep = torch.arange(k.shape[1], device=q.device)[None, :] < valid[:, None]
    mask = None if bool(keep.all()) else keep[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def measure() -> dict:
    card = require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    takes_448 = hasattr(flash, "flash_forward_d448_f32")
    shapes = {}
    for name, qs, kvs, n, causal in SHAPES:
        if qs[-1] == 448 and not takes_448:  # fp32 at 448 raised before its kernel came
            continue
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, kvs, kvs))
        valid = torch.full((qs[0],), n, dtype=torch.int32, device="cuda")
        groups = qs[2] // kvs[2]

        def fn():
            return flash.flash_attention(q, k, v, valid, causal=causal, kv_groups=groups)

        ref = flash.flash_attention_reference(q, k, v, valid, causal=causal, kv_groups=groups,
                                              block_k=PLAIN_BLOCK_K)
        err = float((fn() - ref).abs().max())
        del ref
        shapes[name] = {"ms": time_ms(fn),
                        "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10,
                        "max_abs_err": err, "sdpa_ms": time_ms(_sdpa(q, k, v, valid, causal))}
        del q, k, v
        torch.cuda.empty_cache()
    return {"checkout": os.getcwd(), "card": card, "fp32": shapes,
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
