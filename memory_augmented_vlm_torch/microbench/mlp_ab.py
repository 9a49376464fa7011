"""A/B timing of the int8 MLP half-block kernels, the 64-frame int8 towers
and the fused-SwiGLU LM prefill, on the card:

    python -m memory_augmented_vlm_torch.microbench.mlp_ab [CHECKOUT ...]

With no argument it times this checkout: `fused_mlp_block_int8` (#4) at
the tower's shape (46656 rows x 1152 -> 4304 -> 1152), `fused_mlp_int8`
(#6) at the chain's (the same rows and widths) and
`fused_swiglu_block_int8` (#7) at the LM prefill's (9472 rows x 896 -> 2 x
4864 -> 896), each as the median of 5 single calls and as ten calls back
to back (CUDA events), with the SHA-256 of its output's bytes at a fixed
seed (equal digests: the two trees' kernels agree bit for bit) and, from
`torch.profiler` over one call, the device time of each kernel the call
launches (the per-stage split); the 64-frame int8 tower through
`siglip.forward` (unfused and `fused_oproj=True`) and the 9,472-token int8
prefill through `qwen2.forward` with `qwen2.fused_swiglu_enabled` (median
of 5), on seeded random weights; and the registers, spills and shared
memory that ptxas reported for the int8 GEMM and quant kernels, and the
count of GMMA, WARPGROUP.ARRIVE and WARPGROUP.DEPBAR instructions in each
GEMM kernel's SASS (`cuobjdump -sass` of the built library: a DEPBAR per
wait in the source, and no more, means ptxas serialised no product). It
prints one JSON line. Given checkouts (directories of other trees of this
repository), it runs this file against each tree's package, in a process
of its own and in the order given (e.g. parent, change, change, parent,
to compare in turns on one card), and prints each run's line. Only entry
points that every tree of the port has are called.
"""

from __future__ import annotations

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
from memory_augmented_vlm_torch.ops import cuda_lib, mlp_int8, quant, swiglu_int8

TOWER_ROWS, TOWER_H, TOWER_I = 64 * 729, 1152, 4304
LM_ROWS, LM_H, LM_I = 9472, 896, 4864
PREFILL_VALID = 9444  # the 64-frame request's spliced length
KERNELS = re.compile(r"gemm|rowquant|requant|oproj_heads")


def ptxas_report(log: str, kernels: re.Pattern = KERNELS) -> dict:
    """{entry: 'Used N registers, ...' and its spill line} for each entry
    whose name `kernels` matches (by default the int8 GEMM and quant
    kernels and #12's out-projection), from nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if not m or not kernels.search(m.group(1)):
            continue
        found = [x.split("info    :")[-1].strip() for x in lines[i + 1:i + 4]
                 if "Used" in x or "spill" in x]
        out[m.group(1)] = "; ".join(found)
    return out


def sass_report(lib: str) -> dict:
    """{GEMM kernel (and #12's out-projection): counts of its GMMA,
    WARPGROUP.ARRIVE and WARPGROUP.DEPBAR instructions} in the library's
    SASS. A kernel that two sources instantiate appears once per object;
    its first copy is counted and `copies` says how many there are."""
    cuobjdump = os.path.join(os.path.dirname(cuda_lib.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counted, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counted = None
            if "gemm" in fn or "oproj_heads" in fn:
                if fn in counts:
                    counts[fn]["copies"] += 1
                else:
                    counted = counts[fn] = {"GMMA": 0, "WARPGROUP.ARRIVE": 0,
                                            "WARPGROUP.DEPBAR": 0, "copies": 1}
            continue
        if counted is not None:
            for key in ("GMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR"):
                if key in line:
                    counted[key] += 1
    return counts


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (bf16 read as int16)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def kernel_split(fn) -> dict:
    """{kernel name: device ms} of one call of `fn`, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.key not in out:
            out[evt.key] = us / 1e3
    return out


def _int8_weight(gen, k, n):
    w, s = quant.prequantize_kernel(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    return w, s, torch.randn((n,), generator=gen, device="cuda") * 0.02


def _timed(fn) -> dict:
    out = fn()
    torch.cuda.synchronize()
    return {"ms": time_ms(fn), "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10,
            "sha256": digest(out), "kernels_ms": kernel_split(fn)}


def measure() -> dict:
    card = require_card()
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    hidden = randn(TOWER_ROWS, TOWER_H).to(torch.bfloat16)
    ln_w, ln_b = 1.0 + 0.1 * randn(TOWER_H), 0.1 * randn(TOWER_H)
    fc = (*_int8_weight(gen, TOWER_H, TOWER_I), *_int8_weight(gen, TOWER_I, TOWER_H))
    lm_hidden = randn(LM_ROWS, LM_H).to(torch.bfloat16)
    rms_w = 1.0 + 0.1 * randn(LM_H)
    (wg, sg, _), (wu, su, _), (wd, sd, _) = (_int8_weight(gen, LM_H, LM_I),
                                             _int8_weight(gen, LM_H, LM_I),
                                             _int8_weight(gen, LM_I, LM_H))
    calls = {
        "fused_mlp_block_int8": lambda: mlp_int8.fused_mlp_block_int8(hidden, ln_w, ln_b, *fc),
        "fused_mlp_int8": lambda: mlp_int8.fused_mlp_int8(hidden, *fc),
        "fused_swiglu_block_int8": lambda: swiglu_int8.fused_swiglu_block_int8(
            lm_hidden, rms_w, wg, sg, wu, su, wd, sd)}
    kernels = {name: _timed(fn) for name, fn in calls.items()}
    del hidden, fc, lm_hidden, wg, wu, wd, calls
    torch.cuda.empty_cache()

    cfg = VLMConfig.onevision_0_5b()
    tower = siglip.prequantize_int8(siglip.init_params(cfg.vision, gen, "cuda", torch.bfloat16))
    pixels = randn(64, 384, 384, 3).to(torch.bfloat16)
    lm = qwen2.prequantize_int8(qwen2.init_params(cfg.lm, gen, "cuda", torch.bfloat16))
    embeds = randn(1, LM_ROWS, cfg.lm.hidden_size).to(torch.bfloat16)
    positions = torch.arange(LM_ROWS, device="cuda")[None]
    valid = torch.tensor([PREFILL_VALID], dtype=torch.int32, device="cuda")

    def tower_fn(fused):
        with torch.no_grad():
            return siglip.forward(tower, cfg.vision, pixels, int8=True, fused_oproj=fused)

    def prefill_fn():
        saved = qwen2.fused_swiglu_enabled
        qwen2.fused_swiglu_enabled = True
        try:
            with torch.no_grad():
                return qwen2.forward(lm, cfg.lm, embeds, positions, valid_len=valid,
                                     cache_max_len=LM_ROWS + 32)
        finally:
            qwen2.fused_swiglu_enabled = saved

    return {"checkout": os.getcwd(), "card": card, "kernels": kernels,
            "int8_tower_64_frames_ms": time_ms(lambda: tower_fn(False)),
            "int8_fused_oproj_tower_64_frames_ms": time_ms(lambda: tower_fn(True)),
            "int8_fused_swiglu_lm_prefill_ms": time_ms(prefill_fn),
            "ptxas": ptxas_report(cuda_lib.BUILD_LOG["ptxas"]),
            "sass": sass_report(cuda_lib.BUILD_LOG["path"])}


def main(argv) -> None:
    if not argv:
        print(json.dumps(measure()), flush=True)
        return
    for tree in argv:  # this file, run against the other tree's package
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=tree, env=env, check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
