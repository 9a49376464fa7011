"""A/B timing of #9, #10 and #11 in fp32 (`flash_bwd.forward_with_lse`,
`backward_dq` and `backward_dkv` on fp32 tensors: the 3xTF32 kernels of
csrc/flash_fwd.cu and csrc/flash_train.cu) on the card:

    python -m memory_augmented_vlm_torch.microbench.flash_bwd_f32_ab [CHECKOUT ...]

With no argument it times this checkout, TF32 off, at the fp32 parity cuts'
LM shapes (`SHAPES`, causal, every key valid): the 0.5B's 4,853 tokens of
14 heads of 64 over 2 KV heads, Gemma-2B's 3,677 of 8 heads of 256 over
one, and the 7B's 3,677 of 28 heads of 128 over 4. For each shape, the
forward with lse gives the median of 5 single calls and of ten calls back
to back (CUDA events), the largest difference of its out and of its lse
from the plain version's, whether its out has the bits of
`flash.flash_attention`'s (#1 in fp32), and SDPA's fp32 forward on the
same inputs. dQ
and dK/dV, from the plain forward's out and lse (so that every tree's
backward reads the same bits), give the same times, the largest difference
from their plain versions, whether a second call gives the same bits, and
the SHA-256 of their outputs; beside them, SDPA's fp32 backward (its
forward and backward less its forward: dQ, dK and dV together). Then the
digest of bf16 dK and dV at the same shape (from the bf16 forward's lse),
and the registers and spills that ptxas reported for the fp32 forward and
backward kernels. It prints one JSON line. Given checkouts (directories of
other trees of this repository), it runs this file against each tree's
package, in a process of its own and in the order given (e.g. parent,
change, change, parent, to compare in turns on one card), and prints each
run's line. Only entry points that every tree of the port has are called.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch.microbench.flash_ab import sha256
from memory_augmented_vlm_torch.microbench.timing import require_card, time_ms
from memory_augmented_vlm_torch.ops import cuda_lib, flash, flash_bwd

# (name, tokens, query heads, KV heads, head dim): the LMs of the fp32
# parity cuts, at the tokens their batches splice
SHAPES = [
    ("lm_0.5b", 4853, 14, 2, 64),
    ("lm_gemma_2b", 3677, 8, 1, 256),
    ("lm_7b", 3677, 28, 4, 128),
]
F32_KERNELS = re.compile(r"bwd_(dq|dkv)_(f32|3xtf32)_kernel|fwd_lse_f32_kernel"
                         r"|flash_fwd_3xtf32_kernelILi(64|128|256)E")


def ptxas_report(log: str) -> dict:
    """{entry: its 'Used N registers' and spill lines} for the fp32 forward
    (at the training head dims) and backward kernels, from nvcc's -Xptxas -v
    output."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and F32_KERNELS.search(m.group(1)):
            out[m.group(1)] = "; ".join(x.split("info    :")[-1].strip()
                                        for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x)
    return out


def _sdpa_ms(q, k, v, g, kv_groups):
    """SDPA's fp32 forward, and its forward and backward less its forward,
    causal, on the same inputs: a yardstick the port never calls."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    gt = g.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=kv_groups > 1)

    t_fwd = time_ms(fwd)
    return t_fwd, time_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), gt)) - t_fwd


def _timed(fn) -> dict:
    return {"ms": time_ms(fn), "ms_back_to_back": time_ms(lambda: [fn() for _ in range(10)]) / 10}


def measure() -> dict:
    card = require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = {}
    for name, s, h, hkv, d in SHAPES:
        q, g = (torch.randn((1, s, h, d), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((1, s, hkv, d), generator=gen, device="cuda") for _ in range(2))
        vl = torch.full((1,), s, dtype=torch.int32, device="cuda")
        kw = dict(causal=True, scale=d ** -0.5, kv_groups=h // hkv)
        fwd = lambda: flash_bwd.forward_with_lse(q, k, v, vl, **kw)  # noqa: E731
        out, lse = flash_bwd.forward_with_lse_reference(q, k, v, vl, **kw)
        got_out, got_lse = fwd()
        same = torch.equal(got_out, flash.flash_attention(q, k, v, vl, causal=True,
                                                          kv_groups=h // hkv))
        row = {"fwd_lse": {**_timed(fwd), "max_abs_err_out": float((got_out - out).abs().max()),
                           "max_abs_err_lse": float((got_lse - lse).abs().max()),
                           "out_bit_equal_to_flash_attention": same}}
        del got_out, got_lse
        delta = flash_bwd.attention_delta(out, g)
        args = (q, k, v, g, lse, delta, vl)
        for kernel, fn, plain in (
                ("dq", lambda: flash_bwd.backward_dq(*args, **kw),
                 lambda: (flash_bwd.backward_dq_reference(*args, **kw),)),
                ("dkv", lambda: flash_bwd.backward_dkv(*args, **kw),
                 lambda: flash_bwd.backward_dkv_reference(*args, **kw))):
            got, again = fn(), fn()
            got, again = (x if isinstance(x, tuple) else (x,) for x in (got, again))
            err = max(float((a - b).abs().max()) for a, b in zip(got, plain()))
            torch.cuda.empty_cache()
            row[kernel] = {**_timed(fn), "max_abs_err": err, "sha256": sha256(*got),
                           "second_call_bit_equal": all(torch.equal(a, b)
                                                        for a, b in zip(got, again))}
        row["sdpa_forward_ms"], row["sdpa_backward_ms"] = _sdpa_ms(q, k, v, g, h // hkv)
        del out, lse, delta, args
        qb, kb, vb, gb = (x.bfloat16() for x in (q, k, v, g))
        ob, lb = flash_bwd.forward_with_lse(qb, kb, vb, vl, **kw)
        row["bf16_dkv_sha256"] = sha256(*flash_bwd.backward_dkv(
            qb, kb, vb, gb, lb, flash_bwd.attention_delta(ob, gb), vl, **kw))
        shapes[name] = row
        del q, k, v, g, qb, kb, vb, gb, ob, lb
        torch.cuda.empty_cache()
    return {"checkout": os.getcwd(), "card": card, "fp32_forward_and_backward": shapes,
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
