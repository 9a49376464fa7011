"""A/B timing of the int8 q/k/v kernel, the int8 attention half-block and
the 64-frame int8 towers, on the card:

    python -m memory_augmented_vlm_torch.microbench.qkv_ab [--kernels] [CHECKOUT ...]

With no checkout it times this one: `fused_qkv_int8` (#3) at the tower's
shape (46656 rows x 1152 -> 3 x 1152, 16 heads) and
`fused_attn_block_int8` (#12) at (64, 729, 1152), 16 heads, valid 729, each
as the median of 5 single calls and as ten calls back to back (CUDA
events), with the SHA-256 of its outputs' bytes at a fixed seed (equal
digests: the two trees' kernels agree bit for bit) and, from
`torch.profiler` over one call, the device time of each kernel the call
launches (the per-stage split: LayerNorm + quant, the q/k/v products,
attention, the out-projection); the 64-frame int8 tower through
`siglip.forward`, unfused and with `fused_oproj=True` (median of 5, and
its output's digest), on seeded random weights; and the registers, spills
and SASS GMMA / WARPGROUP.ARRIVE / WARPGROUP.DEPBAR counts of the int8
GEMM kernels and #12's out-projection (`mlp_ab.ptxas_report`,
`mlp_ab.sass_report`). `--kernels` leaves out the towers. It prints one
JSON line. Given checkouts (directories of other trees of this
repository), it runs this file against each tree's package, in a process
of its own and in the order given (e.g. parent, change, change, parent,
to compare in turns on one card), and prints each run's line. Only entry
points that every tree of the port has are called.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.mlp_ab import (digest, kernel_split, ptxas_report,
                                                          sass_report)
from memory_augmented_vlm_torch.microbench.timing import require_card, time_ms
from memory_augmented_vlm_torch.models import siglip
from memory_augmented_vlm_torch.ops import attn_block, cuda_lib, qkv_int8, quant

FRAMES, S, H, NH = 64, 729, 1152, 16


def _timed(fn) -> dict:
    out = fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    return {"ms": time_ms(fn), "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10,
            "sha256": [digest(o) for o in outs], "kernels_ms": kernel_split(fn)}


def measure(towers: bool = True) -> dict:
    card = require_card()
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # #3: chip_smoke's inputs (weights through quant.prequantize_kernel)
    hidden = randn(FRAMES, S, H).to(torch.bfloat16)
    ln_w, ln_b = 1.0 + 0.1 * randn(H), 0.1 * randn(H)
    qkv = []
    for _ in range(3):
        w, s = quant.prequantize_kernel(randn(H, H) * 0.02)
        qkv += [w, s, randn(H) * 0.02]
    # #12: tools_attnblock_bench.py's inputs, the weights column-major
    block_hidden = (randn(FRAMES, S, H) * 0.3).to(torch.bfloat16)
    block = []
    for _ in range(4):
        block += [quant.column_major(torch.randint(-127, 128, (H, H), generator=gen,
                                                   device="cuda", dtype=torch.int8)),
                  randn(H).abs() * 0.02 / 127, randn(H) * 0.01]
    calls = {
        "fused_qkv_int8": lambda: qkv_int8.fused_qkv_int8(hidden, ln_w, ln_b, *qkv, nh=NH),
        "fused_attn_block_int8": lambda: attn_block.fused_attn_block_int8(
            block_hidden, ln_w, ln_b, *block, nh=NH, valid=S)}
    out = {"checkout": os.getcwd(), "card": card,
           "kernels": {name: _timed(fn) for name, fn in calls.items()}}
    del hidden, qkv, block_hidden, block, calls
    torch.cuda.empty_cache()

    if towers:
        cfg = VLMConfig.onevision_0_5b()
        tower = siglip.prequantize_int8(siglip.init_params(cfg.vision, gen, "cuda",
                                                           torch.bfloat16))
        pixels = randn(FRAMES, 384, 384, 3).to(torch.bfloat16)
        for key, fused in (("int8_tower_64_frames", False),
                           ("int8_fused_oproj_tower_64_frames", True)):
            def tower_fn(fused=fused):
                with torch.no_grad():
                    return siglip.forward(tower, cfg.vision, pixels, int8=True,
                                          fused_oproj=fused)
            out[key] = {"ms": time_ms(tower_fn), "sha256": digest(tower_fn())}
    out["ptxas"] = ptxas_report(cuda_lib.BUILD_LOG["ptxas"])
    out["sass"] = sass_report(cuda_lib.BUILD_LOG["path"])
    return out


def main(argv) -> None:
    flags = [a for a in argv if a == "--kernels"]
    trees = [a for a in argv if a != "--kernels"]
    if not trees:
        print(json.dumps(measure(towers=not flags)), flush=True)
        return
    for tree in trees:  # this file, run against the other tree's package
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        subprocess.run([sys.executable, os.path.abspath(__file__), *flags], cwd=tree, env=env,
                       check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
