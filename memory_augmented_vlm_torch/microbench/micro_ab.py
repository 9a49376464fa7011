"""A/B timing of the two micro-benchmark kernels, on the card:

    python -m memory_augmented_vlm_torch.microbench.micro_ab [CHECKOUT ...]

With no checkout it measures this one: `int8_gemm_bf16` (#13) at the int8
ceiling tool's shape (46656 x 1152 -> 4304), as the median of 5 single
calls and of ten calls back to back (CUDA events), with the SHA-256 of its
output at a fixed seed (equal digests: the trees agree bit for bit) and
each kernel's device time from `torch.profiler`; and `gemv` (#14): the
tool's 12-layer chain (896 -> 4864 -> 896) replayed from a CUDA graph and
run eagerly (median of 5), the host's enqueue time of one product, the
share of each output bit-equal to its plain version (the up and down
products; the chain against the plain chain), and, from `torch.profiler`
over one graph replay of the chain, the device kernels it ran, how many
consecutive pairs overlap and the gaps between them (`replay_trace`); then
the registers and spills ptxas reported for both kernels and the SASS
GMMA / WARPGROUP.DEPBAR counts of #13's GEMM kernel. It prints one JSON
line. Given checkouts (directories of other trees of this repository), it
runs this file against each tree's package, in a process of its own and in
the order given (e.g. parent, change, change, parent, to compare in turns
on one card), and prints each run's line. Of the kernels' modules only
entry points that every tree has had since #13 and #14 were ported are
called (`int8_ceiling.int8_gemm_bf16`, `gemv.gemv`, `gemv.chain`, their
operands and plain versions). The measuring tools come from the tree
measured: a tree older than `timing.replay_trace` and
`mlp_ab.ptxas_report`'s pattern argument takes this tree's
`microbench/timing.py` and `microbench/mlp_ab.py` copied over its own
(tools only: no kernel, and nothing that `gemv` or `int8_gemm_bf16`
calls).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

from memory_augmented_vlm_torch.microbench import gemv, int8_ceiling
from memory_augmented_vlm_torch.microbench.gemm_ab import host_ms
from memory_augmented_vlm_torch.microbench.mlp_ab import (digest, kernel_split, ptxas_report,
                                                          sass_report)
from memory_augmented_vlm_torch.microbench.timing import (graph_ms, replay_trace, require_card,
                                                          time_ms)
from memory_augmented_vlm_torch.ops import cuda_lib

KERNELS = re.compile(r"gemv|Int32ToBf16")


def _bit_equal(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out == ref).float().mean())


def measure() -> dict:
    card = require_card()
    cuda_lib.load()
    xq, wq, _, _ = int8_ceiling.operands(seed=0)

    def ceiling():
        return int8_ceiling.int8_gemm_bf16(xq, wq)

    out = ceiling()
    torch.cuda.synchronize()
    int8_gemm = {"shape": [*xq.shape, wq.shape[1]], "ms": time_ms(ceiling),
                 "ms_back_to_back": time_ms(lambda: [ceiling() for _ in range(10)]) / 10,
                 "sha256": digest(out), "kernels_ms": kernel_split(ceiling)}
    del xq, wq, out
    torch.cuda.empty_cache()

    x, w1, w2 = gemv.operands(seed=0)

    def chain():
        return gemv.chain(gemv.gemv, x, w1, w2)

    h = gemv.gemv(x, w1[0])
    y = chain()
    torch.cuda.synchronize()
    ref_h = gemv.gemv_reference(x, w1[0])
    gemv_row = {
        "chain_graph_ms": graph_ms(chain), "chain_eager_ms": time_ms(chain),
        "host_ms_per_product": host_ms(lambda: gemv.gemv(x, w1[0])),
        "bit_equal": {"up": _bit_equal(h, ref_h),
                      "down": _bit_equal(gemv.gemv(ref_h, w2[0]),
                                         gemv.gemv_reference(ref_h, w2[0])),
                      "chain": _bit_equal(y, gemv.chain(gemv.gemv_reference, x, w1, w2))},
        "graph_replay": replay_trace(chain, "gemv")}
    return {"checkout": os.getcwd(), "card": card, "int8_gemm_bf16": int8_gemm,
            "gemv": gemv_row, "ptxas": ptxas_report(cuda_lib.BUILD_LOG["ptxas"], KERNELS),
            "sass": {k: v for k, v in sass_report(cuda_lib.BUILD_LOG["path"]).items()
                     if "Int32ToBf16" in k}}


def main(argv) -> None:
    if not argv:
        print(json.dumps(measure()), flush=True)
        return
    for tree in argv:  # this file, run against the other tree's package
        env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
        subprocess.run([sys.executable, os.path.abspath(__file__)], cwd=tree, env=env,
                       check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
