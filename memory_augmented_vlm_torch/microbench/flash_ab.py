"""A/B timing of the flash kernels (#1 `flash_attention`, #9
`forward_with_lse`; #1, #9, #10 and #11 at head dim 256), the 64-frame bf16
tower and the bf16 LM prefill, on the card:

    python -m memory_augmented_vlm_torch.microbench.flash_ab [CHECKOUT ...]

With no argument it times this checkout: `flash.flash_attention` at its four
path shapes (the tower, 64 frames x 729 x 16 heads of 72; the memory's fuse
and evolve attentions, 1568 queries of 8 heads of 112 over 6272 and 15680
keys, 3136 valid; the 9,472-token causal LM prefill, 14 heads of 64 over 2
KV heads, 9444 valid), and where the tree has the wide kernel, the 7B
memory's (8 heads of 448 over 6272 keys, 3136 valid, and over 15680, 1568
valid) with its output's share of elements bit-equal to the plain version
at the kernel's key tile; where the tree has the head dim 256 entries,
Gemma-2B's three path shapes of #1 (8 heads of 256: the memory's fuse over
6272 keys, all valid, and evolve over 15680, 1568 valid; the causal
9,472-token prefill over one KV head, 9444 valid) and #9, #10 and #11 at its
train shape (1, 9557, 8, 256), causal, GQA 8; `flash_bwd.forward_with_lse`
at the 0.5B train shape (9557 causal tokens), each as the median of 5
single calls and as ten calls back to back (CUDA events), and the wide
kernels' outputs as SHA-256 digests (`sha256`), so that two trees' bits
compare; the 64-frame bf16 tower through `siglip.forward` and the 9,472-token
bf16 prefill through `qwen2.forward` (median of 5), on seeded random
weights; and the registers, spills and shared memory that ptxas reported
for the flash kernels, with its C7508 (setmaxnreg ignored) warnings and
those that wgmma is serialised (C7512, C7514, C7515, C7520, ...). It prints one JSON line. Given
checkouts (directories of other trees of this repository), it runs this
file against each tree's package, in a process of its own and in the order
given (e.g. parent, change, change, parent, to compare in turns on one
card), and prints each run's line. Only entry points that every tree of the
port has are called.
"""

from __future__ import annotations

import functools
import hashlib
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

KERNELS = re.compile(r"fwd_sm90|fwd_kernel|flash_fwd_bf16|fwd_lse_bf16|fwd_wide|d256|d448|bwd_dq"
                     r"|bwd_dkv")
# setmaxnreg ignored; wgmma serialised, whatever the code (C7512, C7514, C7515, C7520, ...)
WARNINGS = re.compile(r"C7508|wgmma\.mma_async instructions are serialized")
PREFILL_TOKENS, PREFILL_VALID = 9472, 9444  # the 64-frame request's padded and spliced lengths
TRAIN_TOKENS = 9557


def ptxas_report(log: str) -> dict:
    """{entry: 'Used N registers, ...' and its spill line} for the flash
    kernels, from nvcc's -Xptxas -v output, and under "warnings" every
    C7508 or serialised-wgmma line ptxas printed."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m or not KERNELS.search(m.group(1)):
            continue
        found = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                 if "Used" in x or "spill" in x]
        out[m.group(1)] = "; ".join(found)
    out["warnings"] = [line.strip() for line in lines if WARNINGS.search(line)]
    return out


def sha256(*tensors) -> str:
    """The SHA-256 of the tensors' bytes, in order (first 16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _d256_kernels(lens) -> dict:
    """#1 at Gemma-2B's three path shapes and #9-#11 at its train shape,
    timed, with each output's digest; inputs from one seeded generator per
    shape, so that every tree draws the same."""
    def randn(seed, *shapes):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]

    d, out = flash.D256, {}
    for seed, (name, sq, skv, hkv, valid, causal) in enumerate((
            ("memory_fuse_gemma", 1568, 6272, 8, 6272, False),
            ("memory_evolve_gemma", 1568, 15680, 8, 1568, False),
            ("lm_prefill_gemma", PREFILL_TOKENS, PREFILL_TOKENS, 1, PREFILL_VALID, True))):
        q, k, v = randn(10 + seed, (1, sq, 8, d), (1, skv, hkv, d), (1, skv, hkv, d))
        fn = functools.partial(flash.flash_attention, q, k, v, lens(valid), causal=causal,
                               kv_groups=8 // hkv)
        out[f"flash_fwd_d256 {name}"] = {**_timed(fn), "sha256": sha256(fn())}
    s = TRAIN_TOKENS
    q, k, v, g = randn(20, (1, s, 8, d), (1, s, 1, d), (1, s, 1, d), (1, s, 8, d))
    kw = dict(causal=True, scale=d ** -0.5, kv_groups=8)
    vl = lens(s)
    fwd = functools.partial(flash_bwd.forward_with_lse_d256, q, k, v, vl, **kw)
    o, lse = fwd()
    delta = flash_bwd.attention_delta(o, g)
    qs = flash_bwd.scaled_q(q, kw["scale"])
    dq_fn = functools.partial(flash_bwd.backward_dq_d256, q, k, v, g, lse, delta, vl, qs=qs, **kw)
    dkv_fn = functools.partial(flash_bwd.backward_dkv_d256, q, k, v, g, lse, delta, vl, qs=qs,
                               **kw)
    out["flash_fwd_lse_d256 gemma_train"] = {**_timed(fwd), "sha256": sha256(*fwd())}
    out["flash_bwd_dq_d256 gemma_train"] = {**_timed(dq_fn), "sha256": sha256(dq_fn())}
    out["flash_bwd_dkv_d256 gemma_train"] = {**_timed(dkv_fn), "sha256": sha256(*dkv_fn())}
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
            got = fn()
            kernels[f"flash_fwd {name}"] = {**_timed(fn), "sha256": sha256(got),
                                            "bit_equal_share": float((got == ref).float().mean())}
        del q, k, v, ref, got
    if hasattr(flash_bwd, "backward_dkv_d256"):  # trees with the Gemma training entries
        kernels.update(_d256_kernels(lens))
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
