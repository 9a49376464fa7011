"""A/B timing of the w8a8 layer and of the merge-heads attention with its
int8 out-projection, on the card:

    python -m memory_augmented_vlm_torch.microbench.gemm_ab [--kernels] [CHECKOUT ...]

With no checkout it times this one: `int8_matmul` (#8) at the chain's two
products (46656 x 1152 -> 4304 and 46656 x 4304 -> 1152, bf16) and at one
decode row (1 x 896 -> 4864), the chain f2(gelu(f1(x))) through it, and
`flash_attention_out_proj_int8` (#5) at the tower's shape (64, 16, 729,
72; hidden bf16 (64, 729, 1152), Wo 1152 x 1152 int8), each as the median
of 5 single calls and as ten calls back to back (CUDA events), with the
host's time per call (the enqueue of 100 calls on the host's clock, no
synchronisation between them: where it exceeds the device's time, the
host bounds the call), the SHA-256 of its output's bytes at a fixed seed
(equal digests: the two trees' kernels agree bit for bit) and, from
`torch.profiler` over one call, the device time of each kernel the call
launches (the per-stage split: #5's attention, row quant and GEMM); the
64-frame int8 tower through `siglip.forward` with `fused_oproj=True`
(median of 5, and its output's digest), on seeded random weights; and the
registers, spills and SASS GMMA / WARPGROUP.ARRIVE / WARPGROUP.DEPBAR
counts of the int8 GEMM kernels (`mlp_ab.ptxas_report`,
`mlp_ab.sass_report`). `--kernels` leaves out the tower. It prints one
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
import time

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.mlp_ab import (digest, kernel_split, ptxas_report,
                                                          sass_report)
from memory_augmented_vlm_torch.microbench.timing import require_card, time_ms
from memory_augmented_vlm_torch.models import siglip
from memory_augmented_vlm_torch.ops import cuda_lib, flash, pallas_int8, quant

FRAMES, S, H, NH, D, I = 64, 729, 1152, 16, 72, 4304
LM_H, LM_I = 896, 4864
HOST_CALLS = 100


def host_ms(fn) -> float:
    """ms per call of the host's enqueue of HOST_CALLS calls (no
    synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / HOST_CALLS


def _timed(fn) -> dict:
    out = fn()
    torch.cuda.synchronize()
    return {"ms": time_ms(fn), "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10,
            "host_ms": host_ms(fn), "sha256": digest(out), "kernels_ms": kernel_split(fn)}


def measure(tower: bool = True) -> dict:
    card = require_card()
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def weight(k, n):
        w, s = quant.prequantize_kernel(randn(k, n) * 0.02)
        return w, s, randn(n) * 0.02

    m = FRAMES * S
    x1, x2 = randn(m, H).to(torch.bfloat16), randn(m, I).to(torch.bfloat16)
    fc1, fc2 = weight(H, I), weight(I, H)
    row, up = randn(1, LM_H).to(torch.bfloat16), weight(LM_H, LM_I)
    q, k, v = (randn(FRAMES, NH, S, D).to(torch.bfloat16) for _ in range(3))
    hidden = randn(FRAMES, S, H).to(torch.bfloat16)
    valid = torch.full((FRAMES,), S, dtype=torch.int32, device="cuda")
    wo = weight(H, H)
    mm = pallas_int8.int8_matmul
    calls = {
        "int8_matmul_fc1": lambda: mm(x1, *fc1),
        "int8_matmul_fc2": lambda: mm(x2, *fc2),
        "int8_matmul_one_row": lambda: mm(row, *up),
        "chain": lambda: mm(F.gelu(mm(x1, *fc1), approximate="tanh"), *fc2),
        "flash_attention_out_proj_int8": lambda: flash.flash_attention_out_proj_int8(
            q, k, v, valid, hidden, *wo)}
    out = {"checkout": os.getcwd(), "card": card,
           "kernels": {name: _timed(fn) for name, fn in calls.items()}}
    del x1, x2, fc1, fc2, row, up, q, k, v, hidden, wo, calls
    torch.cuda.empty_cache()

    if tower:
        cfg = VLMConfig.onevision_0_5b()
        params = siglip.prequantize_int8(siglip.init_params(cfg.vision, gen, "cuda",
                                                            torch.bfloat16))
        pixels = randn(FRAMES, 384, 384, 3).to(torch.bfloat16)

        def tower_fn():
            with torch.no_grad():
                return siglip.forward(params, cfg.vision, pixels, int8=True, fused_oproj=True)

        out["int8_fused_oproj_tower_64_frames"] = {"ms": time_ms(tower_fn),
                                                   "sha256": digest(tower_fn())}
    out["ptxas"] = ptxas_report(cuda_lib.BUILD_LOG["ptxas"])
    out["sass"] = sass_report(cuda_lib.BUILD_LOG["path"])
    return out


def main(argv) -> None:
    flags = [a for a in argv if a == "--kernels"]
    trees = [a for a in argv if a != "--kernels"]
    if not trees:
        print(json.dumps(measure(tower=not flags)), flush=True)
        return
    for tree in trees:  # this file, run against the other tree's package
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        subprocess.run([sys.executable, os.path.abspath(__file__), *flags], cwd=tree, env=env,
                       check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
