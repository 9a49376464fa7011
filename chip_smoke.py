#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`memory_augmented_vlm_torch`).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and the CUDA toolkit (`nvcc`); it
builds the kernels from `memory_augmented_vlm_torch/csrc` first. Phases,
each of which raises on failure:

  1. card     — name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
  2. build    — compile the kernels (one nvcc per source, in parallel), print
                the build time and ptxas report;
  3. kernels  — every kernel against its plain PyTorch version on the card,
                at the shapes of the main paths and at edge cases, with the
                kernel's, the plain version's and a library call's times
                (CUDA events, median of 5) and the card's bound: the three
                training kernels at the LM's train shape (S = 9557, causal,
                GQA 14/2) and at edge cases in bf16 and fp32, the backward
                of flash_fwd at the memory's fuse shape, flash_fwd, the
                three int8 kernels of the default tower, the four of the
                fused configuration and the w8a8 layer (int8_matmul,
                fused_mlp_int8, fused_swiglu_block_int8,
                flash_attention_out_proj_int8), and the four of the
                approximate attention and the micro-benchmarks (the
                int8_scores merge and fused_attn_block_int8, each held
                to its plain version bit-close, EXACT_MIN_SHARE, with
                neighbouring functions as controls that must fail, the
                merge also to JAX's bound against the exact merge;
                int8_gemm_bf16, bit for bit; gemv, its 12-layer chain
                timed from a CUDA graph);
  4. chain    — the dependent int8 MLP chain f2(f1(x)) at the tower's shape
                (46656 x 1152 x 4304): two int8_matmul calls with a tanh GELU
                between against one fused_mlp_int8 call, held against each
                other and against their plain versions, and timed; then the
                fused attention half-block at the tower's shape and at the
                tool's 768-row stream, beside the two composed halves it
                would replace (drift held, timed in turns); then both
                micro-benchmarks (int8 GEMM TOP/s, GEMV chain GB/s);
  5. requests — the full-width 0.5B int8 serving model (random weights from
                a seed, prequantized on the card) answers 64-, 16- and
                128-frame clips with 32 greedy tokens; the bf16 model answers
                a 64-frame clip. Each checks the token accounting and that
                every kernel's launch count rose by what the config implies;
                then one 64-frame request of each model with its stages
                synchronised and timed. The fused configuration runs beside
                it on the same weights: the 64-frame tower with
                fused_oproj=True (launches 26/26/26 and no merge launch)
                against the unfused tower, and the 64-frame request with
                qwen2.fused_swiglu_enabled (24 fused launches, all in
                prefill) against the unfused request, each held to the int8
                model's noise floor measured in the same run, and timed;
                and the 64-frame tower through vlm.encode_frames with the
                merge swapped for its int8_scores mode (26 int8_scores
                launches, no exact merge), its drift from the exact tower
                printed beside the same run's tie-flip floor, and timed;
  6. train    — four full-width bf16 train steps of bench_train.py's
                configuration (64 frames, 9557 tokens, AdamW with its LR
                groups) on distinct seeded batches: finite losses, 120
                target tokens, exact per-step launch counts, frozen tower,
                projector and PE bit-identical, nothing moved at lr 0 and
                every trainable group moved by the last step; then one more
                step with its stages synchronised, one under torch.profiler
                (kernel time by kind, device idle share), and the peak
                memory;
  7. parity   — full widths cut to 2 tower and 2 LM layers, fp32: the card
                (through the kernels) against the CPU (plain versions) on the
                same weights, for the bf16-path model (8 frames), the int8
                model with an int8 KV cache, the same with both fusions on,
                and one train step (40 frames,
                2 segments), whose loss, grad_norm and every gradient leaf
                are compared.

The line before the last is a JSON object describing each of the 15
kernels, with its launches on each path; the last
line is {"ok": true, "device": {...}}. Nothing is printed as a result when
there is no card: the run raises first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch import constants, pipeline
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import qwen2, siglip, vlm
from memory_augmented_vlm_torch.microbench import gemv, int8_ceiling
from memory_augmented_vlm_torch.microbench.timing import graph_ms, require_card
from memory_augmented_vlm_torch.microbench.timing import time_ms as _time_ms
from memory_augmented_vlm_torch.ops import (attn_block, cuda_lib, flash, flash_bwd, mlp_int8,
                                            pallas_int8, qkv_int8, quant, swiglu_int8)
from memory_augmented_vlm_torch.train import optimizer, trainer
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str

# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12

# bf16 flash kernel vs plain version: both round q and P to bf16 but at
# different points of the softmax (running vs final max), and the output is
# bf16 (2^-8 relative steps), so they agree to the bf16 class, not bit for bit.
BF16_ATOL = BF16_RTOL = 1e-2
# fp32 flash kernel vs plain version: the same math in another summation order.
F32_ATOL = F32_RTOL = 1e-5
# int8 kernels vs plain versions. The int8 products are exact and the
# epilogues repeat the plain arithmetic operation by operation, but the
# LayerNorm's sums run in another order, so a value at a rounding tie can
# take the neighbouring int8 code, and a bf16 output can land one step
# (2^-8 relative) away. Such elements stay inside atol + rtol*|ref| unless
# |ref| is large, so the check allows 0.1% of elements outside it and caps
# every difference at 0.25 (one bf16 step below |x| = 64).
INT8_ATOL = INT8_RTOL = 1e-2
INT8_MAX_OUTSIDE = 1e-3
INT8_MAX_ABS = 0.25
# end-to-end fp32 logits, card vs CPU, bf16-path model: summation order
# differs in every matmul, norm and softmax of ~10 layers; TF32 is off.
PARITY_ATOL = 1e-3
# the same for the int8 model. Here the bound is the int8 network's own
# noise floor, not summation order: a LayerNorm or softmax summed in another
# order moves the odd value across an int8 rounding tie, and each flipped
# code perturbs the next quantization far more than the first difference
# did, so the flips cascade until the logits carry a re-drawn copy of the
# quantization noise. On the CPU alone, scaling the pixels by (1 + 1e-7)
# moves this cut's prefill logits (std 0.60, max 2.8) by up to 0.084, with
# an RMS of 0.030 std (the parity phase measures and prints this floor
# each run). The card is held to about three times that floor; a wrong
# kernel lands near 1 std.
INT8_PARITY_ATOL = 0.25
INT8_PARITY_RMS = 0.1
# a fused kernel against the composition it replaces (the chain path: two
# int8_matmul calls and a GELU against fused_mlp_int8). The composition
# rounds the intermediate to bf16 before it is requantized and the fused
# kernel keeps it in fp32, so codes differ wherever a bf16 step crosses a
# code boundary, not only at ties: the outputs agree to the int8
# quantization noise itself. Held as the JAX package's tests hold a fused
# kernel to its composition: the RMS difference within 2e-2 of the output's
# spread, and no element further than INT8_MAX_ABS.
FUSED_VS_COMPOSED_RMS = 2e-2
# the full-width fused tower and fused request against the unfused ones, in
# bf16. The fusions change roundings (bias and residual in fp32; the MLP's
# intermediates in fp32), and the int8 model amplifies any such change into
# a re-drawn copy of its quantization noise (see INT8_PARITY_ATOL). The
# yardstick is that noise, measured in the same run: the unfused path against
# itself with the bf16 pixels scaled by 1 + 2^-8 (each moves by at most one
# bf16 step). The fused path may differ from the unfused one by three times
# that floor, in RMS over the output's spread and in the largest element.
FUSED_FLOOR_FACTOR = 3.0
# The 64-frame int8 tower with the int8_scores merge against the exact one,
# by tools_attn_int8_ab.py's measure (std of |difference| over std), is held
# to FUSED_FLOOR_FACTOR times the tie-flip floor of the same run: the first
# card run read 0.0160 against a floor of 0.0166, and a broken kernel lands
# near 1. Any change of the approximation (another q tile, other K/V
# scales) re-draws the chaotic tower's quantization noise and reads near the
# floor too, so the tower cannot tell those apart: the kernel check below
# does (EXACT_MIN_SHARE).
#
# The int8_scores merge and fused_attn_block_int8 against their plain
# versions. Each repeats its plain version's integer products exactly, and
# only fp32 rounding order differs (a row sum; exp2f or expf against
# torch's), which moves an output by one bf16 step or flips one P code. So
# almost every element is bit-equal, while a neighbouring function (the
# exact merge, another q tile, K/V scales per key block, the composed
# halves with their per-row quant of the attention output) re-draws the
# quantization noise of nearly every element. The int8 rule above cannot
# tell those apart: the merge's output spread is 0.06 at the tower's shape,
# and #12's attention term is 0.02 on a residual of 0.3. These two kernels
# are held instead to the share of bit-equal elements and to the RMS
# difference over the spread of what the kernel computes (the output; for
# #12 the attention term, out - hidden), and each check runs controls,
# neighbouring functions that must fail it. The bounds sit between the
# readings of the first card run that took them: the kernels at the path
# shapes and edge cases 0.9735-1.0 bit-equal and 0-0.0045 RMS; the
# controls 0.069-0.794 bit-equal and 0.0156-0.0288 RMS. #12 with fp32
# hidden is held to F32_ATOL instead (its largest difference read 1.2e-7).
EXACT_MIN_SHARE = 0.9
EXACT_MAX_RMS = 0.008
# bench_train.py's batch: 64 frames (2 segments, 32 fine frames) spliced into
# 128 text tokens -> 128 + 9429 = 9557 tokens, all valid; 8 labels ignored
TRAIN_FRAMES, TRAIN_TEXT, TRAIN_IGNORED = 64, 128, 8
TRAIN_TOKENS = TRAIN_TEXT + 9429
# train parity, card (kernels) vs CPU (plain versions), fp32: gradients agree
# to summation order through ~10 layers, the chunked vs the dense loss and
# the base-2 kernels vs their plain versions. Each leaf is held to 1e-3 of
# its own largest magnitude plus 1e-6 of the largest gradient element of
# the whole model: fp32 summation noise scales with the terms summed, and a
# leaf whose gradient nearly cancels (the memory's initial tokens, behind
# post-LN LayerNorms, ~1e-5 of the model's largest) carries the noise of
# its terms, 1% of its own size in the first card run. The loss and
# grad_norm are held to 1e-4 relative.
TRAIN_PARITY_RTOL = 1e-3
TRAIN_PARITY_MODEL_RTOL = 1e-6
TRAIN_PARITY_LOSS_RTOL = 1e-4
TEXT_BEFORE = [151644, 872, 198]
TEXT_AFTER = [3838, 374, 12482, 304, 419, 2766, 30, 151645, 198, 151644, 77091, 198]
CSRC = "memory_augmented_vlm_torch/csrc/"


def log(*args):
    print(*args, flush=True)


def phase_card() -> str:
    card = require_card()
    log(card)
    nvcc = cuda_lib.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc_version}; "
        f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {cuda_lib.BUILD_LOG['path']}")
    for line in cuda_lib.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())


def _bound(ops: float, peak: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the type's peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------ flash_fwd


def _check_case(name, q, k, v, valid, *, causal=False, kv_groups=1, dtype=torch.bfloat16,
                timed=False):
    atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = flash.flash_attention(q, k, v, valid, causal=causal, kv_groups=kv_groups)
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, valid, causal=causal, kv_groups=kv_groups)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    bad = int((diff > atol + rtol * ref.float().abs()).sum())
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    zero_rows = (valid == 0).nonzero().flatten().tolist()
    for b in zero_rows:
        if out[b].abs().max() != 0:
            raise RuntimeError(f"{name}: batch {b} has valid length 0 but nonzero output")
    row = {"case": name, "q": list(q.shape), "kv": list(k.shape),
           "valid": valid.tolist(), "causal": causal, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "tol": f"atol {atol} + rtol {rtol}"}
    if timed:
        row["ms"] = _time_ms(lambda: flash.flash_attention(q, k, v, valid, causal=causal,
                                                           kv_groups=kv_groups))
        row["plain_ms"] = _time_ms(lambda: flash.flash_attention_reference(
            q, k, v, valid, causal=causal, kv_groups=kv_groups))
        row["library_ms"] = _time_ms(_sdpa_call(q, k, v, valid, causal, kv_groups))
        row["bound_ms"], row["bound_by"] = _flash_bound(q, k, v, valid, causal, kv_groups)
    log(json.dumps(row))
    if bad:
        raise RuntimeError(f"{name}: {bad} elements outside tolerance (max err {err})")
    return row


def _sdpa_call(q, k, v, valid, causal, kv_groups):
    """scaled_dot_product_attention on the same inputs: a yardstick the port
    never calls. bhsd views; a boolean key mask where keys are invalid; the
    LM's causal case uses is_causal (the 28 padded keys past the valid
    length reach only the padded query rows, which the path discards)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=kv_groups > 1)
    keep = (torch.arange(k.shape[1], device=q.device)[None, :] < valid[:, None])
    mask = None if bool(keep.all()) else keep[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=kv_groups > 1)


def _flash_bound(q, k, v, valid, causal, kv_groups):
    """Attention work of these inputs: 4 * (query, valid key) pairs * D per
    head, reading only the valid keys."""
    b, sq, h, d = q.shape
    flops = 4.0 * _attn_pairs(sq, k.shape[1], valid, causal, h) * d
    kv_read = sum(min(n, k.shape[1]) for n in valid.tolist()) * k.shape[2] * d * 2 * 2
    return _bound(flops, PEAK_BF16, 2 * _nbytes(q) + kv_read)


def _attn_pairs(sq, skv, valid, causal, h) -> int:
    """(query, valid key) pairs of the inputs, over all heads: row r of a
    causal batch sees min(r + 1, n) keys."""
    pairs = 0
    for n in valid.tolist():
        n = min(n, skv)
        if causal:
            m = min(sq, n)
            pairs += m * (m + 1) // 2 + (sq - m) * n
        else:
            pairs += sq * n
    return pairs * h


def phase_flash_kernel():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def lens(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    path_rows = [
        _check_case("tower", randn(64, 729, 16, 72), randn(64, 729, 16, 72),
                    randn(64, 729, 16, 72), lens(*[729] * 64), timed=True),
        _check_case("memory_fuse", randn(1, 1568, 8, 112), randn(1, 6272, 8, 112),
                    randn(1, 6272, 8, 112), lens(3136), timed=True),
        _check_case("memory_evolve", randn(1, 1568, 8, 112), randn(1, 15680, 8, 112),
                    randn(1, 15680, 8, 112), lens(3136), timed=True),
        # the 64-frame request's spliced length: 9429 visual + 15 text tokens
        _check_case("lm_prefill", randn(1, 9472, 14, 64), randn(1, 9472, 2, 64),
                    randn(1, 9472, 2, 64), lens(9444), causal=True, kv_groups=7,
                    timed=True),
    ]
    errs = [r["max_abs_err"] for r in path_rows]
    for d in flash.KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                # Sq not a tile multiple, B=2 with valid lengths 0 and ragged
                errs.append(_check_case(f"edge_d{d}", randn(2, 150, 4, d), randn(2, 150, 2, d),
                                        randn(2, 150, 2, d), lens(0, 77), causal=causal,
                                        kv_groups=2, dtype=dtype)["max_abs_err"])
        errs.append(_check_case(f"cross_d{d}", randn(2, 100, 2, d), randn(2, 333, 2, d),
                                randn(2, 333, 2, d), lens(333, 65))["max_abs_err"])
    return {
        "name": "flash_fwd", "route": "cuda", "source": CSRC + "flash_fwd.cu",
        "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:567",
        "max_abs_err": max(errs),
        **{key: sum(r[key] for r in path_rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in path_rows)
        else "bytes",
        "per_shape": [{key: r[key] for key in ("case", "max_abs_err", "ms", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")}
                      for r in path_rows],
    }


# ------------------------------------------------------- int8 kernels


def _compare(name, out, ref, **info):
    """Hold a kernel's output against its plain version (the int8 rule)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: {out.dtype}{tuple(out.shape)} vs plain "
                           f"{ref.dtype}{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    outside = float((diff > INT8_ATOL + INT8_RTOL * ref.float().abs()).float().mean()) \
        if diff.numel() else 0.0
    row = {"case": name, **info, "max_abs_err": err, "share_outside": outside,
           "exact_share": float((diff == 0).float().mean()) if diff.numel() else 1.0,
           "tol": f"share outside atol {INT8_ATOL} + rtol {INT8_RTOL} <= {INT8_MAX_OUTSIDE}, "
                  f"max abs <= {INT8_MAX_ABS}"}
    log(json.dumps(row))
    if outside > INT8_MAX_OUTSIDE or err > INT8_MAX_ABS:
        raise RuntimeError(f"{name}: kernel and plain version disagree ({row})")
    return row


def _int8_weight(gen, k, n, dev):
    w, s = quant.prequantize_kernel(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    return w, s, torch.randn((n,), generator=gen, device=dev) * 0.02


def _qkv_args(gen, b, s, h, dtype, dev):
    hidden = torch.randn((b, s, h), generator=gen, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn((h,), generator=gen, device=dev)
    ln_b = 0.1 * torch.randn((h,), generator=gen, device=dev)
    mats = [t for _ in range(3) for t in _int8_weight(gen, h, h, dev)]
    return (hidden, ln_w, ln_b, *mats)


def _mlp_args(gen, m, k, i, dtype, dev):
    hidden = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn((k,), generator=gen, device=dev)
    ln_b = 0.1 * torch.randn((k,), generator=gen, device=dev)
    return (hidden, ln_w, ln_b, *_int8_weight(gen, k, i, dev), *_int8_weight(gen, i, k, dev))


def phase_int8_kernels():
    """fused_qkv_int8, flash_attention_merge_heads and fused_mlp_block_int8
    at the 64-frame tower's shapes, and at edge cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    dev = "cuda"
    b, s, h, nh, inter = 64, 729, 1152, 16, 4304
    rows = {}

    # --- fused_qkv_int8
    args = _qkv_args(gen, b, s, h, torch.bfloat16, dev)
    out = qkv_int8.fused_qkv_int8(*args, nh=nh)
    torch.cuda.synchronize()
    ref = qkv_int8.fused_qkv_int8_reference(*args, nh=nh)
    errs = [_compare(f"qkv_{n}", o, r, hidden=list(args[0].shape))["max_abs_err"]
            for n, o, r in zip("qkv", out, ref)]
    xq, _ = quant.quantize_rows(args[0].reshape(-1, h))
    w_qkv = quant.column_major(torch.cat([args[3], args[6], args[9]], dim=1))
    ops = 2.0 * b * s * h * 3 * h
    bound, by = _bound(ops, PEAK_INT8, _nbytes(args[0], *out, args[3], args[6], args[9]))
    rows["qkv"] = {
        "ms": _time_ms(lambda: qkv_int8.fused_qkv_int8(*args, nh=nh)),
        "plain_ms": _time_ms(lambda: qkv_int8.fused_qkv_int8_reference(*args, nh=nh)),
        "library_ms": _time_ms(lambda: torch._int_mm(xq, w_qkv)),
        "library_call": "torch._int_mm (46656x1152 @ 1152x3456): the matmul share only",
        "bound_ms": bound, "bound_by": by}
    del args, out, ref, xq, w_qkv
    for bb, ss, dtype in ((2, 150, torch.bfloat16), (2, 150, torch.float32), (1, 5, torch.float32)):
        args = _qkv_args(gen, bb, ss, h, dtype, dev)
        out = qkv_int8.fused_qkv_int8(*args, nh=nh)
        torch.cuda.synchronize()
        ref = qkv_int8.fused_qkv_int8_reference(*args, nh=nh)
        errs += [_compare(f"qkv_edge_{n}", o, r, hidden=list(args[0].shape),
                          dtype=str(dtype))["max_abs_err"] for n, o, r in zip("qkv", out, ref)]
    rows["qkv"]["max_abs_err"] = max(errs)

    # --- flash_attention_merge_heads
    q, k, v = (torch.randn((b, nh, s, 72), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = flash.flash_attention_merge_heads(q, k, v, valid)
    torch.cuda.synchronize()
    errs = [_compare("merge", out, flash.flash_attention_merge_heads_reference(q, k, v, valid),
                     q=list(q.shape))["max_abs_err"]]
    bound, by = _bound(4.0 * b * nh * s * s * 72, PEAK_BF16, _nbytes(q, k, v, out))
    rows["merge"] = {
        "ms": _time_ms(lambda: flash.flash_attention_merge_heads(q, k, v, valid)),
        "plain_ms": _time_ms(lambda: flash.flash_attention_merge_heads_reference(q, k, v, valid)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        "library_call": "scaled_dot_product_attention (64, 16, 729, 72) bf16",
        "bound_ms": bound, "bound_by": by}
    del q, k, v, out
    for lens in ((77, 150), (0, 150)):  # ragged, and a batch with no valid key
        q, k, v = (torch.randn((2, nh, 150, 72), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        valid = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = flash.flash_attention_merge_heads(q, k, v, valid)
        torch.cuda.synchronize()
        ref = flash.flash_attention_merge_heads_reference(q, k, v, valid)
        errs.append(_compare(f"merge_edge_{lens}", out, ref, q=list(q.shape))["max_abs_err"])
        if lens[0] == 0:  # the TPU kernel's semantics: the mean of V over all S keys
            mean_v = v[0].float().mean(dim=1).reshape(1, -1)
            if float((out[0].float() - mean_v).abs().max()) > 2e-2:
                raise RuntimeError("merge: a batch with valid length 0 is not the mean of V")
    rows["merge"]["max_abs_err"] = max(errs)

    # --- fused_mlp_block_int8
    m = b * s
    args = _mlp_args(gen, m, h, inter, torch.bfloat16, dev)
    out = mlp_int8.fused_mlp_block_int8(*args)
    torch.cuda.synchronize()
    errs = [_compare("mlp", out, mlp_int8.fused_mlp_block_int8_reference(*args),
                     hidden=list(args[0].shape))["max_abs_err"]]
    xq, _ = quant.quantize_rows(args[0])
    hq = torch.randint(-127, 128, (m, inter), generator=gen, device=dev, dtype=torch.int8)
    bound, by = _bound(2.0 * m * h * inter * 2, PEAK_INT8,
                       2 * _nbytes(args[0]) + _nbytes(args[3], args[6]))
    rows["mlp"] = {
        "ms": _time_ms(lambda: mlp_int8.fused_mlp_block_int8(*args)),
        "plain_ms": _time_ms(lambda: mlp_int8.fused_mlp_block_int8_reference(*args)),
        "library_ms": _time_ms(lambda: (torch._int_mm(xq, args[3]), torch._int_mm(hq, args[6]))),
        "library_call": "torch._int_mm x2 (46656x1152 @ 1152x4304, 46656x4304 @ 4304x1152): "
                        "the matmul share only",
        "bound_ms": bound, "bound_by": by}
    del args, out, xq, hq
    for mm, dtype in ((300, torch.bfloat16), (300, torch.float32), (5, torch.bfloat16)):
        args = _mlp_args(gen, mm, h, inter, dtype, dev)
        out = mlp_int8.fused_mlp_block_int8(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"mlp_edge_{mm}", out, mlp_int8.fused_mlp_block_int8_reference(*args),
                             hidden=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
    rows["mlp"]["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    return [
        {"name": "fused_qkv_int8", "route": "cuda", "source": CSRC + "qkv_int8.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_qkv_int8.py:85", **rows["qkv"]},
        {"name": "flash_attention_merge_heads", "route": "cuda",
         "source": CSRC + "flash_merge.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:330", **rows["merge"]},
        {"name": "fused_mlp_block_int8", "route": "cuda", "source": CSRC + "mlp_int8.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:127", **rows["mlp"]},
    ]


# ------------------------------- fused configuration and w8a8 kernels


def _rms(out, ref) -> float:
    """RMS difference over the spread of `ref`."""
    return float((out.float() - ref.float()).pow(2).mean().sqrt() / ref.float().std())


def _swiglu_args(gen, m, k, i, dtype, dev):
    hidden = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    hidden[m // 2] = 0  # the prompt's padding rows are zeros
    rms_w = 1.0 + 0.1 * torch.randn((k,), generator=gen, device=dev)
    (wg, sg, _), (wu, su, _), (wd, sd, _) = (_int8_weight(gen, k, i, dev),
                                             _int8_weight(gen, k, i, dev),
                                             _int8_weight(gen, i, k, dev))
    return (hidden, rms_w, wg, sg, wu, su, wd, sd)


def _oproj_args(gen, b, s, nh, d, valid, dtype, dev):
    q, k, v = (torch.randn((b, nh, s, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    hidden = torch.randn((b, s, nh * d), generator=gen, device=dev).to(dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    return (q, k, v, vl, hidden, *_int8_weight(gen, nh * d, nh * d, dev))


def phase_fused_kernels():
    """int8_matmul, fused_mlp_int8, fused_swiglu_block_int8 and
    flash_attention_out_proj_int8 at the shapes of the chain path, the LM
    prefill and the 64-frame tower, and at edge cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    dev = "cuda"
    b, s, h, nh, inter = 64, 729, 1152, 16, 4304
    m = b * s
    lm_rows, lm_h, lm_i = 9472, 896, 4864
    rows = {}

    # --- int8_matmul: both products of the chain, and one decode row
    errs, shapes = [], []
    for name, mm, k, n in (("chain_fc1", m, h, inter), ("chain_fc2", m, inter, h),
                           ("lm_row", 1, lm_h, lm_i)):
        x = torch.randn((mm, k), generator=gen, device=dev).to(torch.bfloat16)
        w, sw, bias = _int8_weight(gen, k, n, dev)
        out = pallas_int8.int8_matmul(x, w, sw, bias)
        torch.cuda.synchronize()
        err = _compare(f"matmul_{name}", out, pallas_int8.int8_matmul_reference(x, w, sw, bias),
                       x=list(x.shape), n=n)["max_abs_err"]
        errs.append(err)
        xq, _ = quant.quantize_rows(x)
        xq32 = F.pad(xq, (0, 0, 0, 32 - mm)) if mm < 32 else xq  # _int_mm takes > 16 rows
        bound, by = _bound(2.0 * mm * k * n, PEAK_INT8,
                           _nbytes(x, out, w) + 4 * (n + n))
        shapes.append({
            "case": name, "max_abs_err": err,
            "ms": _time_ms(lambda: pallas_int8.int8_matmul(x, w, sw, bias)),
            "plain_ms": _time_ms(lambda: pallas_int8.int8_matmul_reference(x, w, sw, bias)),
            "library_ms": _time_ms(lambda: torch._int_mm(xq32, w)),
            "bound_ms": bound, "bound_by": by})
        del x, w, out, xq, xq32
    chain = shapes[:2]  # the kernel's main path is the chain
    rows["matmul"] = {
        **{key: sum(r[key] for r in chain) for key in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in chain)
        else "bytes",
        "library_call": "torch._int_mm (46656x1152 @ 1152x4304, 46656x4304 @ 4304x1152): "
                        "the matmul share only",
        "per_shape": shapes}
    for mm, k, n, dtype, with_bias in ((300, h, inter, torch.float32, True),
                                       (300, h, inter, torch.bfloat16, False),
                                       (5, lm_h, lm_i, torch.float32, False)):
        x = torch.randn((mm, k), generator=gen, device=dev).to(dtype)
        x[mm // 2] = 0  # a zero row takes the floor scale
        w, sw, bias = _int8_weight(gen, k, n, dev)
        bias = bias if with_bias else None
        out = pallas_int8.int8_matmul(x, w, sw, bias)
        torch.cuda.synchronize()
        errs.append(_compare(f"matmul_edge_{mm}", out,
                             pallas_int8.int8_matmul_reference(x, w, sw, bias),
                             x=list(x.shape), dtype=str(dtype),
                             bias=with_bias)["max_abs_err"])
        if float(out[mm // 2].float().abs().max()) > (float(bias.abs().max()) if with_bias
                                                      else 0.0):
            raise RuntimeError("int8_matmul: a zero row gave more than its bias")
    rows["matmul"]["max_abs_err"] = max(errs)

    # --- fused_mlp_int8
    args = _mlp_args(gen, m, h, inter, torch.bfloat16, dev)
    args = (args[0], *args[3:])  # no LayerNorm
    out = mlp_int8.fused_mlp_int8(*args)
    torch.cuda.synchronize()
    errs = [_compare("mlp_core", out, mlp_int8.fused_mlp_int8_reference(*args),
                     x=list(args[0].shape))["max_abs_err"]]
    xq, _ = quant.quantize_rows(args[0])
    hq = torch.randint(-127, 128, (m, inter), generator=gen, device=dev, dtype=torch.int8)
    bound, by = _bound(2.0 * m * h * inter * 2, PEAK_INT8,
                       2 * _nbytes(args[0]) + _nbytes(args[1], args[4]))
    rows["mlp_core"] = {
        "ms": _time_ms(lambda: mlp_int8.fused_mlp_int8(*args)),
        "plain_ms": _time_ms(lambda: mlp_int8.fused_mlp_int8_reference(*args)),
        "library_ms": _time_ms(lambda: (torch._int_mm(xq, args[1]), torch._int_mm(hq, args[4]))),
        "library_call": "torch._int_mm x2 (46656x1152 @ 1152x4304, 46656x4304 @ 4304x1152): "
                        "the matmul share only",
        "bound_ms": bound, "bound_by": by}
    del args, out, xq, hq
    for mm, dtype in ((300, torch.bfloat16), (300, torch.float32), (1, torch.bfloat16)):
        args = _mlp_args(gen, mm, h, inter, dtype, dev)
        args = (args[0], *args[3:])
        out = mlp_int8.fused_mlp_int8(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"mlp_core_edge_{mm}", out, mlp_int8.fused_mlp_int8_reference(*args),
                             x=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
    rows["mlp_core"]["max_abs_err"] = max(errs)

    # --- fused_swiglu_block_int8
    args = _swiglu_args(gen, lm_rows, lm_h, lm_i, torch.bfloat16, dev)
    out = swiglu_int8.fused_swiglu_block_int8(*args)
    torch.cuda.synchronize()
    errs = [_compare("swiglu", out, swiglu_int8.fused_swiglu_block_int8_reference(*args),
                     hidden=list(args[0].shape))["max_abs_err"]]
    xq, _ = quant.quantize_rows(args[0])
    hq = torch.randint(-127, 128, (lm_rows, lm_i), generator=gen, device=dev, dtype=torch.int8)
    bound, by = _bound(2.0 * lm_rows * lm_h * lm_i * 3, PEAK_INT8,
                       2 * _nbytes(args[0]) + _nbytes(args[2], args[4], args[6]))
    rows["swiglu"] = {
        "ms": _time_ms(lambda: swiglu_int8.fused_swiglu_block_int8(*args)),
        "plain_ms": _time_ms(lambda: swiglu_int8.fused_swiglu_block_int8_reference(*args)),
        "library_ms": _time_ms(lambda: (torch._int_mm(xq, args[2]), torch._int_mm(xq, args[4]),
                                        torch._int_mm(hq, args[6]))),
        "library_call": "torch._int_mm x3 (9472x896 @ 896x4864 twice, 9472x4864 @ 4864x896): "
                        "the matmul share only",
        "bound_ms": bound, "bound_by": by}
    del args, out, xq, hq
    for mm, dtype in ((300, torch.bfloat16), (300, torch.float32), (1, torch.bfloat16)):
        args = _swiglu_args(gen, mm, lm_h, lm_i, dtype, dev)
        out = swiglu_int8.fused_swiglu_block_int8(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"swiglu_edge_{mm}", out,
                             swiglu_int8.fused_swiglu_block_int8_reference(*args),
                             hidden=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
        if not torch.equal(out[mm // 2], args[0][mm // 2]):
            raise RuntimeError("swiglu: a zero row did not come back as it went in")
    rows["swiglu"]["max_abs_err"] = max(errs)

    # --- flash_attention_out_proj_int8
    args = _oproj_args(gen, b, s, nh, 72, [s] * b, torch.bfloat16, dev)
    out = flash.flash_attention_out_proj_int8(*args)
    torch.cuda.synchronize()
    errs = [_compare("oproj", out, flash.flash_attention_out_proj_int8_reference(*args),
                     q=list(args[0].shape))["max_abs_err"]]
    xq = torch.randint(-127, 128, (m, h), generator=gen, device=dev, dtype=torch.int8)
    q, k, v = args[:3]
    t_ops = 4.0 * b * nh * s * s * 72 / PEAK_BF16 + 2.0 * m * h * h / PEAK_INT8
    t_bytes = (_nbytes(q, k, v, args[5]) + 2 * _nbytes(args[4])) / PEAK_BYTES
    rows["oproj"] = {
        "ms": _time_ms(lambda: flash.flash_attention_out_proj_int8(*args)),
        "plain_ms": _time_ms(lambda: flash.flash_attention_out_proj_int8_reference(*args)),
        "library_ms": _time_ms(lambda: (F.scaled_dot_product_attention(q, k, v),
                                        torch._int_mm(xq, args[5]))),
        "library_call": "scaled_dot_product_attention (64, 16, 729, 72) bf16 + torch._int_mm "
                        "(46656x1152 @ 1152x1152): the attention and matmul shares only",
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    del args, out, xq, q, k, v
    for valid, dtype in (((77, 150), torch.bfloat16), ((0, 150), torch.bfloat16),
                         ((0, 77), torch.float32)):
        args = _oproj_args(gen, 2, 150, nh, 72, valid, dtype, dev)
        out = flash.flash_attention_out_proj_int8(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"oproj_edge_{valid}", out,
                             flash.flash_attention_out_proj_int8_reference(*args),
                             q=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
    rows["oproj"]["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    return [
        {"name": "flash_attention_out_proj_int8", "route": "cuda",
         "source": CSRC + "flash_merge.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:441", **rows["oproj"]},
        {"name": "fused_mlp_int8", "route": "cuda", "source": CSRC + "mlp_int8.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:51", **rows["mlp_core"]},
        {"name": "fused_swiglu_block_int8", "route": "cuda", "source": CSRC + "swiglu_int8.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_mlp_int8.py:214", **rows["swiglu"]},
        {"name": "int8_matmul", "route": "cuda", "source": CSRC + "int8_matmul.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_int8.py:63", **rows["matmul"]},
    ]


def phase_chain():
    """The dependent int8 MLP chain f2(f1(x)) at the tower's shape, as the
    JAX package's chain and fused-MLP tools run it: through two int8_matmul
    calls with a tanh GELU between, and through one fused_mlp_int8 call.
    Returns the launch counts of the path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    dev = "cuda"
    m, k, i = 46656, 1152, 4304
    x = (torch.randn((m, k), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    w1, s1, b1 = _int8_weight(gen, k, i, dev)
    w2, s2, b2 = _int8_weight(gen, i, k, dev)

    def chain(mm):
        return mm(F.gelu(mm(x, w1, s1, b1), approximate="tanh"), w2, s2, b2)

    def fused():
        return mlp_int8.fused_mlp_int8(x, w1, s1, b1, w2, s2, b2)

    _reset_launches()
    y_chain = chain(pallas_int8.int8_matmul)
    y_fused = fused()
    torch.cuda.synchronize()
    launches = _launches()
    want = {**dict.fromkeys(WRAPPERS, 0), "int8_matmul": 2, "fused_mlp_int8": 1}
    if launches != want:
        raise RuntimeError(f"chain: launches {launches}, want {want}")
    _compare("chain_vs_plain_chain", y_chain, chain(pallas_int8.int8_matmul_reference))
    _compare("fused_vs_plain_fused", y_fused,
             mlp_int8.fused_mlp_int8_reference(x, w1, s1, b1, w2, s2, b2))
    rms = _rms(y_chain, y_fused)
    err = float((y_chain.float() - y_fused.float()).abs().max())
    row = {"chain": "f2(gelu(f1(x))), 46656 x 1152 x 4304, bf16",
           "chain_vs_fused_rms_over_std": rms, "chain_vs_fused_max_abs": err,
           "tol": f"rms <= {FUSED_VS_COMPOSED_RMS}, max abs <= {INT8_MAX_ABS}",
           "chain_ms": _time_ms(lambda: chain(pallas_int8.int8_matmul)),
           "fused_ms": _time_ms(fused),
           "chain_ms_again": _time_ms(lambda: chain(pallas_int8.int8_matmul)),
           "launches": launches}
    log(json.dumps(row))
    if not (torch.isfinite(y_chain).all() and torch.isfinite(y_fused).all()):
        raise RuntimeError("chain: non-finite output")
    if not (rms <= FUSED_VS_COMPOSED_RMS and err <= INT8_MAX_ABS):
        raise RuntimeError(f"chain: the two int8_matmul calls and fused_mlp_int8 disagree ({row})")
    del x, y_chain, y_fused
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- approximate attention and microbench


def _tool_drift(got, ref) -> float:
    """The measure of tools_attn_int8_ab.py and of JAX's int8_scores test:
    std of |difference| over std."""
    return float((got.float() - ref.float()).abs().std() / ref.float().std())


def _jax_class(got, exact) -> dict:
    """JAX's bound of the int8_scores mode against the exact one
    (tests/test_pallas_flash.py:178) reads the drift and the correlation."""
    a, b = got.float().flatten(), exact.float().flatten()
    return {"abs_diff_std_over_std": _tool_drift(a, b),
            "corr": float(torch.corrcoef(torch.stack([a, b]))[0, 1])}


def _block_args(gen, b, s, h, dtype, dev):
    """tools_attnblock_bench.py's inputs: hidden ~ N(0, 0.3^2), LN weights
    near 1, int8 codes uniform in [-127, 127] with scales |N(0, 1)| * 0.02 /
    127 and biases N(0, 0.01^2), the weights column-major."""
    hidden = (torch.randn((b, s, h), generator=gen, device=dev) * 0.3).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn((h,), generator=gen, device=dev)
    ln_b = 0.1 * torch.randn((h,), generator=gen, device=dev)
    mats = []
    for _ in range(4):
        mats += [quant.column_major(torch.randint(-127, 128, (h, h), generator=gen, device=dev,
                                                  dtype=torch.int8)),
                 torch.randn((h,), generator=gen, device=dev).abs() * 0.02 / 127,
                 torch.randn((h,), generator=gen, device=dev) * 0.01]
    return (hidden, ln_w, ln_b, *mats)


def _bit_close(name, out, ref, base=None, **info) -> dict:
    """The share of bit-equal elements and the RMS difference over the
    spread of `ref` (of ref - base where `base` is given), each against its
    bound (EXACT_MIN_SHARE, EXACT_MAX_RMS)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: {out.dtype}{tuple(out.shape)} vs plain "
                           f"{ref.dtype}{tuple(ref.shape)}")
    diff = out.float() - ref.float()
    spread = (ref.float() - (0.0 if base is None else base.float())).std()
    row = {"case": name, **info, "exact_share": float((diff == 0).float().mean()),
           "rms_over_spread": float(diff.pow(2).mean().sqrt() / spread),
           "max_abs_err": float(diff.abs().max()),
           "spread_of": "output" if base is None else "output - hidden",
           "tol": f"exact_share >= {EXACT_MIN_SHARE}, rms_over_spread <= {EXACT_MAX_RMS}"}
    row["held"] = row["exact_share"] >= EXACT_MIN_SHARE and row["rms_over_spread"] <= EXACT_MAX_RMS
    return row


def _hold_bitwise(name, out, ref, base=None, **info) -> dict:
    """A kernel against its plain version, held to _bit_close's bounds."""
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    row = _bit_close(name, out, ref, base, **info)
    log(json.dumps(row))
    if not row["held"]:
        raise RuntimeError(f"{name}: kernel and plain version disagree ({row})")
    return row


def _must_fail(name, out, ref, base=None, **info):
    """A neighbouring function through the kernel's check: it must fail,
    or the check could not tell the kernel from it. `out` is cast to the
    kernel's dtype (the composed halves add an fp32 bias)."""
    row = _bit_close(name, out.to(ref.dtype), ref, base, **info)
    log(json.dumps({"control": "must fail", **row}))
    if row["held"]:
        raise RuntimeError(f"{name}: a neighbouring function passes the kernel check ({row})")


def _hold_f32(name, out, ref, **info) -> dict:
    """An fp32 output against its plain version at F32_ATOL + F32_RTOL."""
    diff = (out - ref).abs()
    row = {"case": name, **info, "max_abs_err": float(diff.max()),
           "outside": int((diff > F32_ATOL + F32_RTOL * ref.abs()).sum()),
           "tol": f"every element within atol {F32_ATOL} + rtol {F32_RTOL}"}
    log(json.dumps(row))
    if out.dtype != torch.float32 or row["outside"] or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: kernel and plain version disagree ({row})")
    return row


def _hold_equal(name, out, ref, **info) -> dict:
    """An output that must equal its plain version bit for bit: the int8
    GEMM's int32 sums are exact and both cast them through fp32 to bf16."""
    row = _compare(name, out, ref, **info)
    if not torch.equal(out, ref):
        raise RuntimeError(f"{name}: kernel and plain version differ ({row})")
    return row


def _int8_scores_kv_per_block(q, k, v, valid, block=64):
    """The int8_scores function with K and V scaled per `block` keys instead
    of over the whole key axis: a control for the kernel check. Codes times
    their scales in float64, which equals the integer products rescaled."""
    b, nh, s, d = q.shape
    tile = flash.merge_q_tile(s)

    def dequant(x, rows):
        x = F.pad(x.double(), (0, 0, 0, -s % rows)).view(b, nh, -1, rows, d)
        sc = flash._scalar_scale(x)
        return (flash._codes(x, sc) * sc).view(b, nh, -1, d)[:, :, :s]

    qd = dequant(q.float() * (d ** -0.5 * flash.LOG2E), tile)
    sc = torch.matmul(qd, dequant(k, block).transpose(-1, -2))
    sc = torch.where(torch.arange(s, device=q.device) < valid[:, None, None, None],
                     sc, flash.MASK_VALUE).float()
    p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
    out = torch.matmul(torch.round(p * 127.0).double(), dequant(v, block)) / 127.0
    out = (out / p.sum(dim=-1, keepdim=True).double()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, s, nh * d)


def phase_int8_attn_kernels():
    """The int8_scores merge, the fused attention half-block, the int8
    ceiling GEMM and the decode GEMV against their plain versions at their
    path shapes (timed) and at edge cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    dev = "cuda"
    b, s, h, nh, d = 64, 729, 1152, 16, 72
    rows = {}

    # --- flash_attention_merge_heads(int8_scores=True) at the tower's shape
    q, k, v = (torch.randn((b, nh, s, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = flash.flash_attention_merge_heads_int8_scores(q, k, v, valid)
    torch.cuda.synchronize()
    ref = flash.flash_attention_merge_heads_int8_scores_reference(q, k, v, valid)
    errs = [_hold_bitwise("int8_scores", out, ref, q=list(q.shape),
                          q_tile=flash.merge_q_tile(s))["max_abs_err"]]
    exact = flash.flash_attention_merge_heads(q, k, v, valid)
    for control, got in (
            ("the exact merge kernel", exact),
            ("q tiles of 16 rows", flash.flash_attention_merge_heads_int8_scores_reference(
                q, k, v, valid, block_q=16)),
            ("K/V scales per 64-key block", _int8_scores_kv_per_block(q, k, v, valid))):
        _must_fail(f"int8_scores control: {control}", got, ref)
    jax_class = _jax_class(out, exact)
    log(json.dumps({"int8_scores_vs_exact_kernel": "tower shape", **jax_class,
                    "tol": "abs_diff_std_over_std < 0.03, corr > 0.999 (JAX's bound)"}))
    if not (jax_class["abs_diff_std_over_std"] < 0.03 and jax_class["corr"] > 0.999):
        raise RuntimeError(f"int8_scores left JAX's class of the exact kernel: {jax_class}")
    bound, by = _bound(4.0 * b * nh * s * s * d, PEAK_INT8, _nbytes(q, k, v, out))
    rows["int8_scores"] = {
        "ms": _time_ms(lambda: flash.flash_attention_merge_heads_int8_scores(q, k, v, valid)),
        "plain_ms": _time_ms(lambda: flash.flash_attention_merge_heads_int8_scores_reference(
            q, k, v, valid)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        "library_call": "scaled_dot_product_attention (64, 16, 729, 72) bf16, the function "
                        "the mode approximates",
        "bound_ms": bound, "bound_by": by, "vs_exact_kernel": jax_class}
    del q, k, v, out, ref, exact
    # ragged valid lengths, a batch with no valid key, ragged last q tiles
    # (S 150 takes 8-row tiles, the last of 6 rows), D 64 and 128, a block_q
    for lens, dd, ss, block_q in (((77, 150), 72, 150, 128), ((0, 150), 72, 150, 128),
                                  ((150, 33), 64, 150, 128), ((0, 200), 128, 200, 64),
                                  ((97, 100), 72, 100, 16)):
        q, k, v = (torch.randn((2, 4, ss, dd), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = flash.flash_attention_merge_heads_int8_scores(q, k, v, vl, block_q=block_q)
        torch.cuda.synchronize()
        ref = flash.flash_attention_merge_heads_int8_scores_reference(q, k, v, vl, block_q=block_q)
        errs.append(_hold_bitwise(f"int8_scores_edge_{lens}_d{dd}", out, ref, q=list(q.shape),
                                  q_tile=flash.merge_q_tile(ss, block_q))["max_abs_err"])
    rows["int8_scores"]["max_abs_err"] = max(errs)

    # --- fused_attn_block_int8 at the tower's shape
    args = _block_args(gen, b, s, h, torch.bfloat16, dev)
    out = attn_block.fused_attn_block_int8(*args, nh=nh, valid=s)
    torch.cuda.synchronize()
    ref = attn_block.fused_attn_block_int8_reference(*args, nh=nh, valid=s)
    errs = [_hold_bitwise("attn_block", out, ref, args[0], hidden=list(args[0].shape),
                          nh=nh)["max_abs_err"]]
    for control, fn in zip(("qkv -> merge -> int8_linear", "qkv -> out_proj_int8"),
                           _composed_halves(args, nh, s)):
        _must_fail(f"attn_block control: {control}", fn(), ref, args[0])
    del ref
    m = b * s
    xq = torch.randint(-127, 128, (m, h), generator=gen, device=dev, dtype=torch.int8)
    qb, kb, vb = (torch.randn((b, nh, s, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    t_ops = 4 * 2.0 * m * h * h / PEAK_INT8 + 4.0 * b * nh * s * s * d / PEAK_BF16
    t_bytes = (2 * _nbytes(args[0]) + _nbytes(args[3], args[6], args[9], args[12])) / PEAK_BYTES
    rows["attn_block"] = {
        "ms": _time_ms(lambda: attn_block.fused_attn_block_int8(*args, nh=nh, valid=s)),
        "plain_ms": _time_ms(lambda: attn_block.fused_attn_block_int8_reference(
            *args, nh=nh, valid=s), reps=3),
        "library_ms": _time_ms(lambda: (F.scaled_dot_product_attention(qb, kb, vb),
                                        *(torch._int_mm(xq, args[i]) for i in (3, 6, 9, 12)))),
        "library_call": "scaled_dot_product_attention (64, 16, 729, 72) bf16 + torch._int_mm "
                        "x4 (46656x1152 @ 1152x1152): the attention and matmul shares only",
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    del args, out, xq, qb, kb, vb
    torch.cuda.empty_cache()
    # valid < S, nh 2 / 8 / 16 (head dims 128, 32, 72), fp32 hidden, valid 0
    for bb, ss, hh, nhh, vv, dtype in ((2, 150, 1152, 16, 77, torch.bfloat16),
                                       (2, 150, 256, 2, 100, torch.bfloat16),
                                       (2, 150, 256, 8, 150, torch.float32),
                                       (1, 97, 1152, 16, 0, torch.float32)):
        args = _block_args(gen, bb, ss, hh, dtype, dev)
        out = attn_block.fused_attn_block_int8(*args, nh=nhh, valid=vv)
        torch.cuda.synchronize()
        ref = attn_block.fused_attn_block_int8_reference(*args, nh=nhh, valid=vv)
        name, info = f"attn_block_edge_nh{nhh}_valid{vv}", {"hidden": list(args[0].shape)}
        row = (_hold_f32(name, out, ref, **info) if dtype == torch.float32
               else _hold_bitwise(name, out, ref, args[0], **info))
        errs.append(row["max_abs_err"])
    rows["attn_block"]["max_abs_err"] = max(errs)

    # --- int8_gemm_bf16 at the ceiling tool's shape
    xq, wq, xb, wb = int8_ceiling.operands(seed=11)
    out = int8_ceiling.int8_gemm_bf16(xq, wq)
    torch.cuda.synchronize()
    errs = [_hold_equal("int8_gemm_bf16", out, int8_ceiling.int8_gemm_bf16_reference(xq, wq),
                        x=list(xq.shape), n=int8_ceiling.N)["max_abs_err"]]
    mm, kk = xq.shape
    bound, by = _bound(2.0 * mm * kk * int8_ceiling.N, PEAK_INT8, _nbytes(xq, wq, out))
    rows["int8_gemm"] = {
        "ms": _time_ms(lambda: int8_ceiling.int8_gemm_bf16(xq, wq)),
        "plain_ms": _time_ms(lambda: int8_ceiling.int8_gemm_bf16_reference(xq, wq)),
        "library_ms": _time_ms(lambda: torch._int_mm(xq, wq)),
        "library_call": "torch._int_mm (46656x1152 @ 1152x4304), int32 out",
        "bound_ms": bound, "bound_by": by}
    del xq, wq, xb, wb, out
    for mm, kk, nn in ((1000, 1152, 1000), (1, 896, 130), (300, 4304, 1152)):  # ragged M, N
        x = torch.randint(-127, 128, (mm, kk), generator=gen, device=dev, dtype=torch.int8)
        w = quant.column_major(torch.randint(-127, 128, (kk, nn), generator=gen, device=dev,
                                             dtype=torch.int8))
        out = int8_ceiling.int8_gemm_bf16(x, w)
        torch.cuda.synchronize()
        errs.append(_hold_equal(f"int8_gemm_bf16_edge_{mm}x{kk}x{nn}", out,
                                int8_ceiling.int8_gemm_bf16_reference(x, w))["max_abs_err"])
    rows["int8_gemm"]["max_abs_err"] = max(errs)

    # --- gemv: the tool's 12-layer chain, timed as one CUDA-graph replay
    x, w1, w2 = gemv.operands(seed=12)
    errs = []
    for name, xx, w in (("up", x, w1[0]), ("down", gemv.gemv_reference(x, w1[0]), w2[0])):
        out = gemv.gemv(xx, w)
        torch.cuda.synchronize()
        errs.append(_compare(f"gemv_{name}", out, gemv.gemv_reference(xx, w),
                             w=list(w.shape))["max_abs_err"])
    y = gemv.chain(gemv.gemv, x, w1, w2)
    torch.cuda.synchronize()
    errs.append(_compare("gemv_chain", y, gemv.chain(gemv.gemv_reference, x, w1, w2),
                         layers=gemv.L)["max_abs_err"])
    bound, by = _bound(4.0 * gemv.L * gemv.H * gemv.I, PEAK_F32, gemv.chain_bytes(x, w1, w2))
    rows["gemv"] = {
        "ms": graph_ms(lambda: gemv.chain(gemv.gemv, x, w1, w2)),
        "plain_ms": graph_ms(lambda: gemv.chain(gemv.gemv_reference, x, w1, w2)),
        "library_ms": graph_ms(lambda: gemv.chain(torch.matmul, x, w1, w2)),
        "library_call": "torch.matmul chained the same way (bf16)",
        "timing": "one 12-layer chain (24 products, 209 MB of weights) replayed from a "
                  "CUDA graph",
        "bound_ms": bound, "bound_by": by}
    del x, w1, w2, y
    for kk, nn in ((1000, 777), (5, 3), (4864, 900), (33, 4104)):  # K, N off the block
        x = torch.randn((1, kk), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((kk, nn), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        out = gemv.gemv(x, w)
        torch.cuda.synchronize()
        errs.append(_compare(f"gemv_edge_{kk}x{nn}", out, gemv.gemv_reference(x, w))["max_abs_err"])
    rows["gemv"]["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    return [
        {"name": "flash_attention_merge_heads_int8_scores", "route": "cuda",
         "source": CSRC + "flash_merge_int8.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:279", **rows["int8_scores"]},
        {"name": "fused_attn_block_int8", "route": "cuda", "source": CSRC + "attn_block.cu",
         "replaces": "memory_augmented_vlm_tpu/ops/pallas_attn_block.py:143",
         **rows["attn_block"]},
        {"name": "int8_gemm_bf16", "route": "cuda", "source": CSRC + "int8_matmul.cu",
         "replaces": "tools_int8_ceiling.py:80", **rows["int8_gemm"]},
        {"name": "gemv", "route": "cuda", "source": CSRC + "gemv.cu",
         "replaces": "tools_gemv_bench.py:33", **rows["gemv"]},
    ]


def _composed_halves(args, nh, valid):
    """The two composed attention halves #12 would replace, on its weights:
    fused_qkv_int8 -> the merge kernel -> the int8 out-projection + residual
    (the tower's unfused layer), and fused_qkv_int8 ->
    flash_attention_out_proj_int8 (its fused_oproj layer)."""
    hidden, ln_w, ln_b = args[:3]
    wo, so, bo = args[12:]
    b, s, h = hidden.shape
    vl = torch.full((b,), valid, dtype=torch.int32, device=hidden.device)
    qkv_proj = args[3:12]

    def merge_path():
        q, k, v = qkv_int8.fused_qkv_int8(hidden, ln_w, ln_b, *qkv_proj, nh=nh)
        attn = flash.flash_attention_merge_heads(q, k, v, vl)
        return hidden + quant.int8_linear({"kernel_int8": wo, "scale": so, "bias": bo}, attn)

    def oproj_path():
        q, k, v = qkv_int8.fused_qkv_int8(hidden, ln_w, ln_b, *qkv_proj, nh=nh)
        return flash.flash_attention_out_proj_int8(q, k, v, vl, hidden, wo, so, bo)

    return merge_path, oproj_path


def phase_attn_block():
    """#12 at the tower's shape (64 x 729 x 1152, 16 heads, valid 729) and at
    the tool's padded stream (64 x 768, valid 729), on seeded int8 weights,
    beside the two composed halves it would replace: timed in turns, and
    its drift from them held to the fused-vs-composed bound. That bound
    holds #12 to the class of the composition, which is another function;
    that #12 computes its own is held in phase_int8_attn_kernels, where
    both compositions are controls that must fail. Returns the launch
    counts of #12's two calls."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    nh, valid = 16, 729
    weights = _block_args(gen, 1, 1, 1152, torch.bfloat16, "cuda")[1:]
    inputs = {s: (torch.randn((64, s, 1152), generator=gen, device="cuda") * 0.3)
              .to(torch.bfloat16) for s in (729, 768)}
    _reset_launches()
    outs = {s: attn_block.fused_attn_block_int8(x, *weights, nh=nh, valid=valid)
            for s, x in inputs.items()}
    torch.cuda.synchronize()
    launches = _launches()
    want = {**dict.fromkeys(WRAPPERS, 0), "fused_attn_block_int8": 2}
    if launches != want:
        raise RuntimeError(f"attention block: launches {launches}, want {want}")
    for s, x in inputs.items():
        args = (x, *weights)
        merge_path, oproj_path = _composed_halves(args, nh, valid)
        block = outs[s]
        rows = valid  # padded rows are computed, compared only on the valid ones
        drift = {}
        for name, fn in (("merge + int8_linear", merge_path), ("out_proj_int8", oproj_path)):
            ref = fn()
            rms = _rms(block[:, :rows], ref[:, :rows])
            err = float((block[:, :rows].float() - ref[:, :rows].float()).abs().max())
            term = (ref[:, :rows].float() - x[:, :rows].float()).std()
            drift[name] = {"rms_over_std": rms, "max_abs": err,
                           "rms_over_attention_term_std": float(
                               (block[:, :rows].float() - ref[:, :rows].float()).pow(2).mean()
                               .sqrt() / term)}
            if not (rms <= FUSED_VS_COMPOSED_RMS and err <= INT8_MAX_ABS):
                raise RuntimeError(f"attention block at S={s} drifts from {name}: {drift}")
        if not bool(torch.isfinite(block).all()):
            raise RuntimeError(f"attention block at S={s}: non-finite output")
        # composed, fused, fused, composed: two readings of each in turns
        fns = {"fused_attn_block_int8": lambda: attn_block.fused_attn_block_int8(
            x, *weights, nh=nh, valid=valid), "qkv -> merge -> int8_linear": merge_path,
            "qkv -> out_proj_int8": oproj_path}
        order = ["qkv -> merge -> int8_linear", "qkv -> out_proj_int8", "fused_attn_block_int8",
                 "fused_attn_block_int8", "qkv -> out_proj_int8", "qkv -> merge -> int8_linear"]
        times = {}
        for name in order:
            times.setdefault(name, []).append(_time_ms(fns[name]))
        log(json.dumps({"attn_block": f"64 x {s} x 1152, 16 heads, valid {valid}",
                        "ms_median_of_5_two_readings": times, "drift_from_composed": drift,
                        "tol": f"rms <= {FUSED_VS_COMPOSED_RMS}, max abs <= {INT8_MAX_ABS}"}))
    del outs, inputs
    torch.cuda.empty_cache()
    return launches


def phase_microbench():
    """Both micro-benchmarks as their modules run them: one counted pass of
    each path (the ceiling GEMM once, the GEMV chain once), then the
    tools' measurements. Returns each path's launch counts."""
    paths = {}
    xq, wq, xb, wb = int8_ceiling.operands()
    _reset_launches()
    int8_ceiling.int8_gemm_bf16(xq, wq)
    torch.cuda.synchronize()
    paths["int8_ceiling_microbench"] = _launches()
    log(json.dumps({"int8_ceiling": int8_ceiling.measure(xq, wq, xb, wb)}))
    del xq, wq, xb, wb
    x, w1, w2 = gemv.operands()
    _reset_launches()
    gemv.chain(gemv.gemv, x, w1, w2)
    torch.cuda.synchronize()
    paths["gemv_microbench"] = _launches()
    log(json.dumps({"gemv": gemv.measure(x, w1, w2)}))
    want = {"int8_ceiling_microbench": {"int8_gemm_bf16": 1},
            "gemv_microbench": {"gemv": 2 * w1.shape[0]}}
    for path, counts in want.items():
        if paths[path] != {**dict.fromkeys(WRAPPERS, 0), **counts}:
            raise RuntimeError(f"{path}: launches {paths[path]}, want {counts}")
    torch.cuda.empty_cache()
    return paths


# ----------------------------------------------------- training kernels

TRAIN_REPLACES = {
    "flash_fwd_lse": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:332",
    "flash_bwd_dq": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:148",
    "flash_bwd_dkv": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:232",
}
# flops per (query, valid key) pair and head dim: QK^T and PV in the forward;
# the dQ kernel recomputes QK^T and does dO V^T and dS K; the dK/dV kernel
# recomputes QK^T and does dO V^T, P^T dO and dS^T Q
TRAIN_FLOPS_PER_PAIR = {"flash_fwd_lse": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def _train_bounds(q, k, valid, causal):
    """{kernel: (bound ms, bound_by)}: each kernel's operations at the bf16
    peak against its bytes (inputs read once, outputs written once, only
    the valid keys of K/V)."""
    b, sq, h, d = q.shape
    pairs = _attn_pairs(sq, k.shape[1], valid, causal, h)
    kv = sum(min(n, k.shape[1]) for n in valid.tolist()) * k.shape[2] * d * q.element_size()
    rows = b * h * sq * 4  # one fp32 lse or delta per query row
    io = {"flash_fwd_lse": 2 * _nbytes(q) + 2 * kv + rows,
          "flash_bwd_dq": 3 * _nbytes(q) + 2 * kv + 2 * rows,
          "flash_bwd_dkv": 2 * _nbytes(q) + 4 * kv + 2 * rows}
    return {name: _bound(f * pairs * d, PEAK_BF16, io[name])
            for name, f in TRAIN_FLOPS_PER_PAIR.items()}


def _train_kernels_case(name, gen, b, sq, skv, h, hkv, d, causal, valid, dtype=torch.bfloat16,
                        timed=False):
    """Run the three training kernels on one input and hold each output
    against its plain version (lse on its finite entries, and -inf where
    the plain version has -inf). Returns {kernel: row}."""
    atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL)
    dev = "cuda"
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    g = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    kw = dict(causal=causal, scale=d ** -0.5, kv_groups=h // hkv)
    fwd = lambda: flash_bwd.forward_with_lse(q, k, v, vl, **kw)  # noqa: E731
    out, lse = fwd()
    delta = flash_bwd.attention_delta(out, g)
    dq_fn = lambda: flash_bwd.backward_dq(q, k, v, g, lse, delta, vl, **kw)  # noqa: E731
    dkv_fn = lambda: flash_bwd.backward_dkv(q, k, v, g, lse, delta, vl, **kw)  # noqa: E731
    dq = dq_fn()
    dk, dv = dkv_fn()
    torch.cuda.synchronize()
    info = {"q": list(q.shape), "kv": list(k.shape), "valid": list(valid), "causal": causal,
            "dtype": str(dtype).split(".")[-1], "tol": f"atol {atol} + rtol {rtol}"}

    def held(label, got, ref):
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: non-finite kernel output")
        diff = (got.float() - ref.float()).abs()
        bad = int((diff > atol + rtol * ref.float().abs()).sum())
        if bad:
            raise RuntimeError(f"{name} {label}: {bad} elements outside tolerance "
                               f"(max err {float(diff.max())})")
        return float(diff.max()) if diff.numel() else 0.0

    rout, rlse = flash_bwd.forward_with_lse_reference(q, k, v, vl, **kw)
    fin = torch.isfinite(rlse)
    if not torch.equal(torch.isfinite(lse), fin):
        raise RuntimeError(f"{name}: lse is -inf on other rows than the plain version's")
    errs = {"flash_fwd_lse": max(held("out", out, rout), held("lse", lse[fin], rlse[fin]))}
    del rout, rlse
    errs["flash_bwd_dq"] = held("dq", dq, flash_bwd.backward_dq_reference(
        q, k, v, g, lse, delta, vl, **kw))
    rdk, rdv = flash_bwd.backward_dkv_reference(q, k, v, g, lse, delta, vl, **kw)
    errs["flash_bwd_dkv"] = max(held("dk", dk, rdk), held("dv", dv, rdv))
    del rdk, rdv
    empty = (vl == 0).nonzero().flatten().tolist()
    for i in empty:  # no valid key: zero output and grads, lse -inf
        if any(float(x[i].abs().max()) for x in (out, dq, dk, dv)) or bool(
                torch.isfinite(lse[i]).any()):
            raise RuntimeError(f"{name}: batch {i} has valid length 0 but a nonzero result")
    rows = {kname: {"case": name, "kernel": kname, **info, "max_abs_err": err}
            for kname, err in errs.items()}
    if timed:
        plain = {
            "flash_fwd_lse": lambda: flash_bwd.forward_with_lse_reference(q, k, v, vl, **kw),
            "flash_bwd_dq": lambda: flash_bwd.backward_dq_reference(
                q, k, v, g, lse, delta, vl, **kw),
            "flash_bwd_dkv": lambda: flash_bwd.backward_dkv_reference(
                q, k, v, g, lse, delta, vl, **kw)}
        for kname, fn in (("flash_fwd_lse", fwd), ("flash_bwd_dq", dq_fn),
                          ("flash_bwd_dkv", dkv_fn)):
            rows[kname]["ms"] = _time_ms(fn)
            rows[kname]["plain_ms"] = _time_ms(plain[kname], reps=3)
            torch.cuda.empty_cache()
        lib_fwd, lib_bwd = _sdpa_train_ms(q, k, v, g, causal, h // hkv)
        rows["flash_fwd_lse"]["library_ms"] = lib_fwd
        rows["flash_fwd_lse"]["library_call"] = "scaled_dot_product_attention forward"
        for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
            rows[kname]["library_ms"] = lib_bwd
            rows[kname]["library_call"] = ("scaled_dot_product_attention backward (forward + "
                                           "backward minus forward): dQ, dK and dV together")
        for kname, (bound, by) in _train_bounds(q, k, vl, causal).items():
            rows[kname]["bound_ms"], rows[kname]["bound_by"] = bound, by
    for row in rows.values():
        log(json.dumps(row))
    torch.cuda.empty_cache()
    return rows


def _sdpa_train_ms(q, k, v, g, causal, kv_groups):
    """scaled_dot_product_attention's forward, and its backward as
    forward + backward minus forward, on the same inputs: a yardstick the
    port never calls."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    gt = g.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=kv_groups > 1)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    t_fwd = _time_ms(fwd)
    return t_fwd, _time_ms(fwd_bwd) - t_fwd


def _flash_backward_check(gen):
    """#1's backward (the plain recompute, on the card) at the memory's fuse
    shape, bf16, against the same recompute in fp32: the largest difference
    within 1e-2 of each gradient's largest magnitude (about 2.5 bf16 steps)."""
    dev = "cuda"
    q = torch.randn((1, 1568, 8, 112), generator=gen, device=dev).bfloat16().requires_grad_()
    k, v = (torch.randn((1, 6272, 8, 112), generator=gen, device=dev).bfloat16()
            .requires_grad_() for _ in range(2))
    g = torch.randn((1, 1568, 8, 112), generator=gen, device=dev).bfloat16()
    vl = torch.tensor([3136], dtype=torch.int32, device=dev)
    grads = torch.autograd.grad(flash.flash_attention(q, k, v, vl), (q, k, v), g)
    xs = [x.detach().float().requires_grad_() for x in (q, k, v)]
    refs = torch.autograd.grad(flash.xla_attention_reference(
        *xs, vl, causal=False, scale=112 ** -0.5), xs, g.float())
    errs = []
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        err = float((got.float() - ref).abs().max())
        if not (torch.isfinite(got).all() and err <= 1e-2 * float(ref.abs().max())):
            raise RuntimeError(f"flash_fwd backward {name}: max err {err} against "
                               f"max |ref| {float(ref.abs().max())}")
        errs.append(err)
    t_fwd = _time_ms(lambda: flash.flash_attention(q, k, v, vl))
    t_all = _time_ms(lambda: torch.autograd.grad(flash.flash_attention(q, k, v, vl),
                                                 (q, k, v), g))
    row = {"case": "flash_fwd backward, memory fuse shape", "q": [1, 1568, 8, 112],
           "kv": [1, 6272, 8, 112], "valid": [3136], "max_abs_err": max(errs),
           "backward_ms": t_all - t_fwd, "tol": "1e-2 of max |grad|"}
    log(json.dumps(row))
    return row


def phase_train_kernels():
    """forward_with_lse, backward_dq and backward_dkv at the LM's training
    shape (timed) and at edge cases, in bf16 and fp32; then #1's backward."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    s = TRAIN_TOKENS
    main_rows = _train_kernels_case("lm_train", gen, 1, s, s, 14, 2, 64, True, (s,),
                                    timed=True)
    errs = {name: [row["max_abs_err"]] for name, row in main_rows.items()}
    cases = [
        # B=2, one batch shorter; 4 query heads keep the plain version's
        # (B, H, S, S) fp32 intermediates near 3 GB each
        ("b2_ragged", 2, s, s, 4, 2, 64, True, (9000, s), (torch.bfloat16,)),
        ("cross_d128", 2, 1000, 3000, 4, 2, 128, False, (3000, 1234),
         (torch.bfloat16, torch.float32)),
        ("valid0_causal", 2, 150, 150, 4, 2, 64, True, (0, 77), (torch.bfloat16, torch.float32)),
        ("valid0_cross", 2, 150, 333, 4, 4, 128, False, (0, 300),
         (torch.bfloat16, torch.float32)),
        ("lm_cut_f32", 1, 700, 700, 14, 2, 64, True, (700,), (torch.float32,)),
    ]
    for name, b, sq, skv, h, hkv, d, causal, valid, dtypes in cases:
        for dtype in dtypes:
            rows = _train_kernels_case(f"{name}_{str(dtype).split('.')[-1]}", gen, b, sq, skv,
                                       h, hkv, d, causal, valid, dtype)
            for kname, row in rows.items():
                errs[kname].append(row["max_abs_err"])
    backward = _flash_backward_check(gen)
    kernels = []
    for kname, row in main_rows.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + "flash_train.cu",
            "replaces": TRAIN_REPLACES[kname], "max_abs_err": max(errs[kname]),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_call")}})
    return kernels, backward


# ------------------------------------------------------------ requests

WRAPPERS = {
    "flash_fwd": flash.flash_attention,
    "fused_qkv_int8": qkv_int8.fused_qkv_int8,
    "flash_attention_merge_heads": flash.flash_attention_merge_heads,
    "fused_mlp_block_int8": mlp_int8.fused_mlp_block_int8,
    "flash_fwd_lse": flash_bwd.forward_with_lse,
    "flash_bwd_dq": flash_bwd.backward_dq,
    "flash_bwd_dkv": flash_bwd.backward_dkv,
    "flash_attention_out_proj_int8": flash.flash_attention_out_proj_int8,
    "fused_mlp_int8": mlp_int8.fused_mlp_int8,
    "fused_swiglu_block_int8": swiglu_int8.fused_swiglu_block_int8,
    "int8_matmul": pallas_int8.int8_matmul,
    "flash_attention_merge_heads_int8_scores": flash.flash_attention_merge_heads_int8_scores,
    "fused_attn_block_int8": attn_block.fused_attn_block_int8,
    "int8_gemm_bf16": int8_ceiling.int8_gemm_bf16,
    "gemv": gemv.gemv,
}


def _reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _memory_calls(cfg: VLMConfig, num_frames: int) -> int:
    """Memory cross-attentions of one request: the first segment fuses
    (depth calls), each later one evolves once and fuses."""
    segments = vlm.pad_frames_to_segment_multiple(num_frames, cfg.memory.segment_frames) \
        // cfg.memory.segment_frames
    return cfg.memory.depth + (segments - 1) * (1 + cfg.memory.depth)


def _expected_tower_launches(cfg: VLMConfig, fused_oproj: bool) -> dict:
    """The int8 tower alone: three kernels a layer, the attention one being
    the merge kernel or, with `fused_oproj`, the fused out-projection."""
    tower = cfg.vision.num_used_layers
    attn = "flash_attention_out_proj_int8" if fused_oproj else "flash_attention_merge_heads"
    return {**dict.fromkeys(WRAPPERS, 0), "fused_qkv_int8": tower, attn: tower,
            "fused_mlp_block_int8": tower}


def _expected_launches(cfg: VLMConfig, num_frames: int, fused_oproj: bool = False,
                       fused_swiglu: bool = False) -> dict:
    """One request. `fused_swiglu` adds one launch per LM layer, in prefill
    only: a decode step's single row stays below the kernel's gate."""
    lm = cfg.lm.num_hidden_layers
    if cfg.pipeline.tower_int8:
        want = _expected_tower_launches(cfg, fused_oproj)
        want["flash_fwd"] = _memory_calls(cfg, num_frames) + lm
        want["fused_swiglu_block_int8"] = lm if fused_swiglu else 0
        return want
    return {**dict.fromkeys(WRAPPERS, 0),
            "flash_fwd": cfg.vision.num_used_layers + _memory_calls(cfg, num_frames) + lm}


def _expected_train_launches(cfg: VLMConfig, num_frames: int) -> dict:
    """One train step: the frozen tower and the memory through flash_fwd
    (the memory's backward is a plain recompute), each LM layer through the
    training kernels, its forward twice under remat."""
    lm = cfg.lm.num_hidden_layers
    return {**dict.fromkeys(WRAPPERS, 0),
            "flash_fwd": cfg.vision.num_used_layers + _memory_calls(cfg, num_frames),
            "flash_fwd_lse": 2 * lm, "flash_bwd_dq": lm, "flash_bwd_dkv": lm}


def _visual_tokens(cfg: VLMConfig, num_frames: int, nseg: int) -> int:
    m = cfg.memory
    return (10 + nseg * m.num_memory_tokens * m.patch_size + 1 + 9
            + min(m.num_fine_frames, num_frames) * m.patch_size + 1)


def _serve(label, cfg, params, frame_counts, gen, kv_int8):
    dev = "cuda"
    tb = torch.tensor(TEXT_BEFORE, device=dev)
    ta = torch.tensor(TEXT_AFTER, device=dev)
    launches_64 = None
    for num_frames in frame_counts:
        fn, nseg = pipeline.build_pipeline(cfg, num_frames, return_logits=True, kv_int8=kv_int8)
        pixels = torch.randn((num_frames, 384, 384, 3), generator=gen,
                             device=dev).to(torch.bfloat16)
        latencies = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, s, logits = fn(params, pixels, tb, ta)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            launches = _launches()
        want = _expected_launches(cfg, num_frames)
        if launches != want:
            raise RuntimeError(f"{label} {num_frames} frames: launches {launches}, want {want}")
        visual = s - len(TEXT_BEFORE) - len(TEXT_AFTER)
        if visual != _visual_tokens(cfg, num_frames, nseg):
            raise RuntimeError(f"{label} {num_frames} frames: {visual} visual tokens")
        if num_frames == 64 and visual != 9429:
            raise RuntimeError(f"{label} 64 frames: {visual} visual tokens, want 9429")
        if tokens.shape != (32, 1) or not bool(((tokens >= 0)
                                                 & (tokens < cfg.lm.vocab_size)).all()):
            raise RuntimeError(f"{label} {num_frames} frames: bad tokens "
                               f"{tokens.flatten().tolist()}")
        if logits.shape != (32, 1, cfg.lm.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{label} {num_frames} frames: non-finite or misshapen logits")
        if num_frames == 64:
            launches_64 = launches
        log(json.dumps({"request": label, "frames": num_frames, "segments": nseg,
                        "visual_tokens": visual, "spliced": s, "launches": launches,
                        "latency_s_first": latencies[0], "latency_s_second": latencies[1],
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                        "tokens": tokens.flatten().tolist()[:8]}))
    return launches_64


REQUEST_STAGES = [
    (siglip, "forward", "tower"), (vlm, "encode_frames", "tower+projector+pool"),
    (vlm, "build_video_embeds", "memory+assembly"), (qwen2, "forward", "lm_prefill"),
    (qwen2, "unembed", "unembed"), (qwen2, "quantize_cache", "quantize_cache"),
    (qwen2, "decode_step", "decode_steps")]
TRAIN_STAGES = [
    (vlm, "encode_frames", "tower"), (vlm, "build_video_embeds", "memory"),
    (qwen2, "forward", "lm_forward"), (trainer, "cross_entropy", "loss"),
    (trainer, "value_and_grad_params", "forward+backward")]


@contextlib.contextmanager
def _stage_clock(totals: dict, stages=REQUEST_STAGES):
    """Times the stages by wrapping the module functions they call
    (synchronising around each), summing seconds per stage into `totals`."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]

    def timed(fn, stage):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[stage] = totals.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for mod, name, stage in stages:
        setattr(mod, name, timed(getattr(mod, name), stage))
    try:
        yield totals
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _stage_times(label, cfg, params, num_frames, gen, kv_int8):
    """One more request with each stage synchronised and timed (three
    repetitions); the tower's time is inside tower+projector+pool."""
    dev = "cuda"
    fn, _ = pipeline.build_pipeline(cfg, num_frames, kv_int8=kv_int8)
    pixels = torch.randn((num_frames, 384, 384, 3), generator=gen, device=dev).to(torch.bfloat16)
    tb, ta = torch.tensor(TEXT_BEFORE, device=dev), torch.tensor(TEXT_AFTER, device=dev)
    reps = []
    for _ in range(3):
        totals = {}
        with _stage_clock(totals):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, pixels, tb, ta)
            torch.cuda.synchronize()
            totals["total"] = time.perf_counter() - t0
        reps.append(totals)
    log(json.dumps({"stage_seconds": label, "frames": num_frames,
                    **{k: [r.get(k, 0.0) for r in reps] for k in reps[0]}}))


@contextlib.contextmanager
def _fused_flags(oproj: bool = False, swiglu: bool = False):
    """The opt-in fusions, switched on as a user switches them on and
    restored after: `qwen2.fused_swiglu_enabled` is a module flag;
    `fused_oproj` is an argument of `siglip.forward` that the pipeline does
    not pass (the JAX pipeline has no such knob either), so for a whole
    request the tower's entry point is wrapped."""
    saved = (siglip.forward, qwen2.fused_swiglu_enabled)
    if oproj:
        siglip.forward = functools.partial(siglip.forward, fused_oproj=True)
    qwen2.fused_swiglu_enabled = swiglu
    try:
        yield
    finally:
        siglip.forward, qwen2.fused_swiglu_enabled = saved


def _one_step_of_pixels(pixels: torch.Tensor) -> torch.Tensor:
    """The bf16 pixels scaled by 1 + 2^-8: each moves by at most one bf16
    step. The unfused path on these against itself on the pixels is the
    int8 model's noise floor."""
    return (pixels.float() * (1.0 + 2.0 ** -8)).to(pixels.dtype)


def _held_to_floor(label, fused, unfused, perturbed, **info):
    """Fused against unfused output, held to FUSED_FLOOR_FACTOR times the
    floor (unfused on the one-step pixels against unfused), in RMS over the
    spread and in the largest element."""
    rms, floor_rms = _rms(fused, unfused), _rms(perturbed, unfused)
    err = float((fused.float() - unfused.float()).abs().max())
    floor_err = float((perturbed.float() - unfused.float()).abs().max())
    row = {"fused_vs_unfused": label, **info, "rms_over_std": rms, "max_abs": err,
           "floor_rms_over_std": floor_rms, "floor_max_abs": floor_err,
           "std": float(unfused.float().std()),
           "tol": f"{FUSED_FLOOR_FACTOR} x the floor of this run, both"}
    log(json.dumps(row))
    if not bool(torch.isfinite(fused).all()):
        raise RuntimeError(f"{label}: non-finite output")
    if not (rms <= FUSED_FLOOR_FACTOR * floor_rms and err <= FUSED_FLOOR_FACTOR * floor_err):
        raise RuntimeError(f"{label}: fused and unfused differ beyond the noise floor ({row})")
    return row


def _fused_tower(cfg, params, gen):
    """The 64-frame int8 tower through `siglip.forward(fused_oproj=True)`
    (every layer fused_qkv_int8 -> flash_attention_out_proj_int8 ->
    fused_mlp_block_int8) beside the unfused tower on the same pixels.
    Returns the fused run's launch counts."""
    vt, vcfg = params["vision_tower"], cfg.vision
    pixels = torch.randn((64, 384, 384, 3), generator=gen, device="cuda").to(torch.bfloat16)

    def tower(pix, fused):
        with torch.no_grad():
            return siglip.forward(vt, vcfg, pix, int8=True, fused_oproj=fused)

    _reset_launches()
    unfused = tower(pixels, False)
    torch.cuda.synchronize()
    if _launches() != _expected_tower_launches(cfg, False):
        raise RuntimeError(f"unfused tower: launches {_launches()}")
    perturbed = tower(_one_step_of_pixels(pixels), False)
    _reset_launches()
    fused = tower(pixels, True)
    torch.cuda.synchronize()
    launches = _launches()
    if launches != _expected_tower_launches(cfg, True):
        raise RuntimeError(f"fused tower: launches {launches}, want "
                           f"{_expected_tower_launches(cfg, True)}")
    if fused.shape != (64, vcfg.num_patches, vcfg.hidden_size) or fused.dtype != torch.bfloat16:
        raise RuntimeError(f"fused tower: output {fused.dtype}{tuple(fused.shape)}")
    _held_to_floor("int8 tower, 64 frames, fused_oproj", fused, unfused, perturbed,
                   launches=launches)
    del unfused, perturbed, fused
    # unfused, fused, fused, unfused: two readings of each within one run
    times = [_time_ms(lambda f=f: tower(pixels, f)) for f in (False, True, True, False)]
    log(json.dumps({"tower_ms": "int8 tower, 64 frames, 26 layers, median of 5",
                    "unfused": [times[0], times[3]], "fused_oproj": [times[1], times[2]]}))
    return launches


@contextlib.contextmanager
def _int8_scores_merge():
    """The tower's merge entry swapped for its int8_scores mode, as
    tools_attn_int8_ab.py swaps it, and restored after: `siglip` imports the
    name, so the name in `siglip` is the one swapped."""
    saved = siglip.flash_attention_merge_heads
    siglip.flash_attention_merge_heads = functools.partial(flash.flash_attention_merge_heads,
                                                           int8_scores=True)
    try:
        yield
    finally:
        siglip.flash_attention_merge_heads = saved


def _int8_scores_tower(cfg, params, gen):
    """The 64-frame int8 tower through `vlm.encode_frames` with the merge
    swapped for its int8_scores mode, beside the exact tower on the same
    pixels: launches, drift beside the tie-flip floor, and tower ms.
    Returns the int8_scores run's launch counts."""
    pixels = torch.randn((64, 384, 384, 3), generator=gen, device="cuda").to(torch.bfloat16)

    def encode(pix):
        return vlm.encode_frames(params, cfg, pix)

    exact = encode(pixels)
    perturbed = encode(_one_step_of_pixels(pixels))
    _reset_launches()
    with _int8_scores_merge():
        approx = encode(pixels)
    torch.cuda.synchronize()
    launches = _launches()
    layers = cfg.vision.num_used_layers
    want = {**_expected_tower_launches(cfg, False), "flash_attention_merge_heads": 0,
            "flash_attention_merge_heads_int8_scores": layers}
    if launches != want:
        raise RuntimeError(f"int8_scores tower: launches {launches}, want {want}")
    if approx.shape != exact.shape or not bool(torch.isfinite(approx).all()):
        raise RuntimeError(f"int8_scores tower: output {tuple(approx.shape)} or non-finite")
    drift, floor = _tool_drift(approx, exact), _tool_drift(perturbed, exact)
    times = {}
    for mode in ("exact", "int8_scores", "int8_scores", "exact"):
        ctx = _int8_scores_merge() if mode == "int8_scores" else contextlib.nullcontext()
        with ctx:
            times.setdefault(mode, []).append(_time_ms(lambda: encode(pixels)))
    row = {"int8_scores_tower": "vlm.encode_frames, 64 frames, 26 int8 layers",
           "launches": launches, "drift_abs_diff_std_over_std": drift,
           "tie_flip_floor_abs_diff_std_over_std": floor,
           "rms_over_std": _rms(approx, exact), "floor_rms_over_std": _rms(perturbed, exact),
           "encode_frames_ms_median_of_5_two_readings": times,
           "tol": f"drift <= {FUSED_FLOOR_FACTOR} x the tie-flip floor of this run"}
    log(json.dumps(row))
    if not drift <= FUSED_FLOOR_FACTOR * floor:
        raise RuntimeError(f"int8_scores tower drifts from the exact tower: {row}")
    return launches


def _fused_request(cfg, params, gen):
    """The 64-frame int8 request with `qwen2.fused_swiglu_enabled` beside the
    unfused request on the same pixels: 24 fused launches, all in prefill.
    Returns the fused run's launch counts."""
    dev = "cuda"
    tb, ta = torch.tensor(TEXT_BEFORE, device=dev), torch.tensor(TEXT_AFTER, device=dev)
    fn, nseg = pipeline.build_pipeline(cfg, 64, return_logits=True, kv_int8=True)
    pixels = torch.randn((64, 384, 384, 3), generator=gen, device=dev).to(torch.bfloat16)
    _, s_u, logits_u = fn(params, pixels, tb, ta)
    _, _, logits_p = fn(params, _one_step_of_pixels(pixels), tb, ta)
    latencies = []
    with _fused_flags(swiglu=True):
        for _ in range(2):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, s, logits = fn(params, pixels, tb, ta)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            launches = _launches()
    want = _expected_launches(cfg, 64, fused_swiglu=True)
    if launches != want or launches["fused_swiglu_block_int8"] != 24:
        raise RuntimeError(f"fused request: launches {launches}, want {want}")
    visual = s - len(TEXT_BEFORE) - len(TEXT_AFTER)
    if s != s_u or visual != 9429 or visual != _visual_tokens(cfg, 64, nseg):
        raise RuntimeError(f"fused request: {visual} visual tokens, spliced {s} vs {s_u}")
    if tokens.shape != (32, 1) or not bool(((tokens >= 0) & (tokens < cfg.lm.vocab_size)).all()):
        raise RuntimeError(f"fused request: bad tokens {tokens.flatten().tolist()}")
    if logits.shape != (32, 1, cfg.lm.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError("fused request: non-finite or misshapen logits")
    _held_to_floor("int8 request, 64 frames, fused_swiglu: prefill logits", logits[0],
                   logits_u[0], logits_p[0], visual_tokens=visual, launches=launches,
                   latency_s_first=latencies[0], latency_s_second=latencies[1],
                   tokens=tokens.flatten().tolist()[:8])
    return launches


def phase_requests():
    """The int8 serving model at 64, 16 and 128 frames, then its fused
    configuration (the fused tower and the fused request, each beside the
    unfused one), then the bf16 model at 64 frames only (the bf16 path's 16-
    and 128-frame requests are left out to keep the run short). Returns each
    path's 64-frame launch counts, keyed by kernel."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    full = VLMConfig.onevision_0_5b()
    t0 = time.perf_counter()
    params = vlm.init_params(full, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"init 0.5B bf16 params: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    int8_params = pipeline.int8_serving_params(params)
    torch.cuda.synchronize()
    log(f"prequantize to int8 on the card: {time.perf_counter() - t0:.2f} s")
    int8_cfg = dataclasses.replace(
        full, pipeline=dataclasses.replace(full.pipeline, tower_int8=True))
    int8_launches = _serve("int8", int8_cfg, int8_params, (64, 16, 128), gen, kv_int8=True)
    _stage_times("int8", int8_cfg, int8_params, 64, gen, kv_int8=True)
    fused_tower_launches = _fused_tower(int8_cfg, int8_params, gen)
    int8_scores_launches = _int8_scores_tower(int8_cfg, int8_params, gen)
    fused_request_launches = _fused_request(int8_cfg, int8_params, gen)
    with _fused_flags(swiglu=True):
        _stage_times("int8, fused_swiglu", int8_cfg, int8_params, 64, gen, kv_int8=True)
    with _fused_flags(oproj=True, swiglu=True):
        _stage_times("int8, fused_oproj and fused_swiglu", int8_cfg, int8_params, 64, gen,
                     kv_int8=True)
    del int8_params
    torch.cuda.empty_cache()
    bf16_launches = _serve("bf16", full, params, (64,), gen, kv_int8=False)
    _stage_times("bf16", full, params, 64, gen, kv_int8=False)
    del params
    torch.cuda.empty_cache()
    return {"int8_serving_64_frames": int8_launches, "bf16_64_frames": bf16_launches,
            "int8_fused_oproj_tower_64_frames": fused_tower_launches,
            "int8_fused_swiglu_64_frames": fused_request_launches,
            "int8_scores_tower_64_frames": int8_scores_launches}


# -------------------------------------------------------------- parity


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.to("cuda")


def _parity(label, cfg, params_cpu, atol, kv_int8, rms_bound=None, noise_floor=False,
            fused=False):
    """`fused`: both opt-in fusions on, on the card and on the CPU alike."""
    with _fused_flags(oproj=fused, swiglu=fused):
        _parity_run(label, cfg, params_cpu, atol, kv_int8, rms_bound, noise_floor, fused)


def _parity_run(label, cfg, params_cpu, atol, kv_int8, rms_bound, noise_floor, fused):
    params_gpu = _to_cuda(params_cpu)
    gen = torch.Generator()
    gen.manual_seed(3)
    pixels = torch.randn((8, 384, 384, 3), generator=gen)
    tb, ta = torch.tensor(TEXT_BEFORE), torch.tensor(TEXT_AFTER)
    fn, _ = pipeline.build_pipeline(cfg, 8, return_logits=True, max_new_tokens=8,
                                    kv_int8=kv_int8)
    _reset_launches()
    tok_g, s_g, lg_g = fn(params_gpu, pixels.cuda(), tb.cuda(), ta.cuda())
    torch.cuda.synchronize()
    if _launches() != _expected_launches(cfg, 8, fused_oproj=fused, fused_swiglu=fused):
        raise RuntimeError(f"{label} parity run did not go through the kernels: {_launches()}")
    t0 = time.perf_counter()
    tok_c, s_c, lg_c = fn(params_cpu, pixels, tb, ta)
    cpu_s = time.perf_counter() - t0
    if s_g != s_c:
        raise RuntimeError(f"{label}: spliced length {s_g} on the card, {s_c} on the CPU")

    def max_and_rms(other):
        diff = other - lg_c[0]
        return float(diff.abs().max()), float(diff.pow(2).mean().sqrt() / lg_c[0].std())

    err, rms = max_and_rms(lg_g[0].cpu())
    floor = None
    if noise_floor:  # the CPU against itself with the pixels scaled by 1 + 1e-7
        floor = max_and_rms(fn(params_cpu, pixels * (1 + 1e-7), tb, ta)[2][0])
    if not err <= atol:
        raise RuntimeError(f"{label}: prefill logits differ by {err} > {atol}")
    if rms_bound is not None and not rms <= rms_bound:
        raise RuntimeError(f"{label}: prefill logits differ by {rms} std (RMS) > {rms_bound}")
    # greedy tokens agree while the CPU's top-2 margin exceeds the tolerance;
    # at a near-tie either side may pick either token, and the runs diverge
    compared = 0
    for step in range(tok_c.shape[0]):
        top2 = torch.topk(lg_c[step, 0], 2).values
        if float(top2[0] - top2[1]) <= atol:
            break
        if int(tok_g[step, 0]) != int(tok_c[step, 0]):
            raise RuntimeError(f"{label}: greedy token {step} differs: {tok_g[:, 0].tolist()} "
                               f"vs {tok_c[:, 0].tolist()}")
        compared += 1
    log(json.dumps({"parity": label, "spliced": s_c, "prefill_logits_max_abs_err": err,
                    "prefill_logits_rms_err_over_std": rms, "tol": atol,
                    "rms_tol": rms_bound, "cpu_vs_cpu_scaled_pixels_max_and_rms": floor,
                    "tokens_compared": compared,
                    "tokens_card": tok_g[:, 0].tolist(), "tokens_cpu": tok_c[:, 0].tolist(),
                    "cpu_run_s": cpu_s}))


def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = VLMConfig.onevision_0_5b()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, num_hidden_layers=3),  # 2 used
        lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = vlm.init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    _parity("fp32 bf16-path model, card vs cpu", cfg, params, PARITY_ATOL, kv_int8=False)
    int8_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     tower_int8=True))
    int8_params = pipeline.int8_serving_params(params)
    _parity("fp32 activations, int8 weights and KV cache, card vs cpu", int8_cfg,
            int8_params, INT8_PARITY_ATOL, kv_int8=True, rms_bound=INT8_PARITY_RMS,
            noise_floor=True)
    # the same cut and bounds with fused_oproj and fused_swiglu on (the
    # 3172-token prompt pads to 3200 rows, above the fused SwiGLU's gate)
    _parity("the same with fused_oproj and fused_swiglu, card vs cpu", int8_cfg,
            int8_params, INT8_PARITY_ATOL, kv_int8=True, rms_bound=INT8_PARITY_RMS, fused=True)


# ---------------------------------------------------------------- train

def _bench_opt() -> optimizer.OptimizerConfig:
    """bench_train.py's optimizer: at warmup_ratio 0.03 of 100 steps, step
    0 runs at lr 0 and the trainable leaves first move at step 1."""
    return optimizer.OptimizerConfig(
        learning_rate=1e-5, memory_transformer_lr=5e-5, memory_key_value_lr=5e-5,
        mm_vision_tower_lr=None, total_steps=100, warmup_ratio=0.03)


def _train_batch(rng, cfg: VLMConfig, num_frames, num_fine, dev, dtype):
    """bench_train.make_batch's batch (B=1, image at text position 3), with
    `num_fine` fine frames; numpy draws from `rng`."""
    fmax = vlm.pad_frames_to_segment_multiple(num_frames, cfg.memory.segment_frames)
    pixels = np.zeros((1, fmax, 384, 384, 3), np.float32)
    pixels[:, :num_frames] = rng.standard_normal((1, num_frames, 384, 384, 3), np.float32)
    ids = rng.integers(5, 1000, size=(1, TRAIN_TEXT))
    labels = ids.copy()
    labels[:, :TRAIN_IGNORED] = constants.IGNORE_INDEX
    fine = vlm.fine_frame_indices(num_frames, num_fine)

    def t(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    return trainer.TrainBatch(
        pixels=torch.from_numpy(pixels).to(dev, dtype), frame_indices=t(np.arange(fmax)[None]),
        frame_valid=t((np.arange(fmax) < num_frames)[None], torch.bool),
        fine_idx=t(fine[None]), input_ids=t(ids), labels=t(labels), image_pos=t([3]),
        text_len=t([TRAIN_TEXT]))


def _leaves(tree):
    return [(path_str(p), x) for p, x in leaves_with_path(tree)]


def _kernel_category(name: str) -> str:
    n = name.lower()
    for key, label in (("bwd_dkv", "flash_bwd_dkv"), ("bwd_dq", "flash_bwd_dq"),
                       ("fwd_lse", "flash_fwd_lse"), ("flash_fwd", "flash_fwd")):
        if key in n:
            return label
    if "f32f32" in n or "sgemm" in n:
        return "fp32 GEMM"
    if any(key in n for key in ("gemm", "nvjet", "xmma", "cutlass")):
        return "bf16 GEMM"
    if any(key in n for key in ("reduce", "softmax", "norm")):
        return "reductions and norms"
    return "elementwise, copies and indexing"


def _profiled_step(step, state, batch):
    """One train step under torch.profiler: the device's busy time (union of
    kernel intervals) over the step's wall time, and kernel time by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no kernel on the card")
    by_kind, busy, end = {}, 0.0, float("-inf")
    for t0, t1, name in spans:
        kind = _kernel_category(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (t1 - t0) / 1e3
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return state, {"wall_s": wall, "kernels": len(spans), "device_busy_s": busy / 1e6,
                   "device_idle_share": 1.0 - busy / 1e6 / wall,
                   "kernel_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))}


def phase_train():
    """Four full-width bf16 train steps of bench_train.py's configuration on
    distinct seeded batches, then one more with its stages synchronised and
    one under the profiler. Returns the per-step launch counts."""
    dev = "cuda"
    cfg = VLMConfig.onevision_0_5b()
    opt = _bench_opt()
    t0 = time.perf_counter()
    params = vlm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    state = trainer.init_train_state(params, opt)
    torch.cuda.synchronize()
    log(f"init 0.5B bf16 params and AdamW state: {time.perf_counter() - t0:.2f} s")
    nseg = vlm.pad_frames_to_segment_multiple(TRAIN_FRAMES, cfg.memory.segment_frames) \
        // cfg.memory.segment_frames
    step = trainer.make_train_step(cfg, opt, nseg=nseg)
    rng = np.random.default_rng(0)
    want = _expected_train_launches(cfg, TRAIN_FRAMES)
    initial = _leaves(params)
    trainable = dict(_leaves(optimizer.trainable_mask(params, opt.mm_tunable_parts)))
    groups = dict(_leaves(optimizer.lr_group_labels(params, opt)))
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(4):
        batch = _train_batch(rng, cfg, TRAIN_FRAMES, cfg.memory.num_fine_frames, dev,
                             torch.bfloat16)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches = _launches()
        loss, tokens = float(metrics["loss"]), int(metrics["target_tokens"])
        losses.append(loss)
        if launches != want:
            raise RuntimeError(f"train step {i}: launches {launches}, want {want}")
        if not math.isfinite(loss) or tokens != TRAIN_TEXT - TRAIN_IGNORED:
            raise RuntimeError(f"train step {i}: loss {loss}, target_tokens {tokens}")
        moved = {name: 0 for name in set(groups.values())}
        for (name, p0), (_, p1) in zip(initial, _leaves(state.params)):
            if not torch.equal(p0, p1):
                if not trainable[name]:
                    raise RuntimeError(f"train step {i}: frozen {name} changed")
                moved[groups[name]] += 1
        if i == 0 and any(moved.values()):  # lr(0) = 0
            raise RuntimeError(f"train step 0 moved params at lr 0: {moved}")
        log(json.dumps({"train_step": i, "loss": loss, "target_tokens": tokens,
                        "grad_norm": float(metrics["grad_norm"]), "seconds": times[-1],
                        "launches": launches, "leaves_moved_by_group": moved}))
    if not all(moved[g] for g in set(groups[n] for n, t in trainable.items() if t)):
        raise RuntimeError(f"a trainable group never moved: {moved}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    totals = {}
    batch = _train_batch(rng, cfg, TRAIN_FRAMES, cfg.memory.num_fine_frames, dev, torch.bfloat16)
    with _stage_clock(totals, TRAIN_STAGES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        totals["total"] = time.perf_counter() - t0
    forward = sum(totals[k] for k in ("tower", "memory", "lm_forward", "loss"))
    totals["backward+assembly"] = totals["forward+backward"] - forward
    totals["optimizer"] = totals["total"] - totals["forward+backward"]
    batch = _train_batch(rng, cfg, TRAIN_FRAMES, cfg.memory.num_fine_frames, dev, torch.bfloat16)
    state, profiled = _profiled_step(step, state, batch)
    log(json.dumps({"train": "0.5B bf16, bench_train batch", "spliced": TRAIN_TOKENS,
                    "step_seconds": times, "losses": losses, "peak_mem_gb": peak,
                    "stage_seconds_synchronised": totals, "profiled_step": profiled}))
    del state, params, initial
    torch.cuda.empty_cache()
    return want


def phase_train_parity():
    """One fp32 train step, full widths cut to 2 tower and 2 LM layers, 64
    padded frames of which 40 are real (2 segments, so evolve is
    differentiated) and 8 fine frames: card (kernels) against CPU (plain
    versions), the same weights and batch. Loss, grad_norm and every
    gradient leaf are compared."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = VLMConfig.onevision_0_5b()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, num_hidden_layers=3),  # 2 used
        lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    params = vlm.init_params(cfg, seed=6, device="cpu", dtype=torch.float32)
    opt = _bench_opt()
    step = trainer.make_train_step(cfg, opt, nseg=2)
    captured = []
    inner = trainer.value_and_grad_params

    def capture(*args, **kwargs):  # keep the step's own gradients
        out = inner(*args, **kwargs)
        captured.append(out[1])
        return out

    results = {}
    trainer.value_and_grad_params = capture
    try:
        for dev in ("cuda", "cpu"):
            batch = _train_batch(np.random.default_rng(7), cfg, 40, 8, dev, torch.float32)
            state = trainer.init_train_state(_to_cuda(params) if dev == "cuda" else params, opt)
            _reset_launches()
            t0 = time.perf_counter()
            _, metrics = step(state, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
                if _launches() != _expected_train_launches(cfg, 40):
                    raise RuntimeError(f"train parity: launches {_launches()}")
            results[dev] = (metrics, _leaves(captured[-1]), time.perf_counter() - t0)
    finally:
        trainer.value_and_grad_params = inner
    (mg, gg, tg), (mc, gc, tc) = results["cuda"], results["cpu"]
    model_max = max(float(b.abs().max()) for _, b in gc)
    worst = []
    for (name, a), (_, b) in zip(gg, gc):
        err = float((a.cpu() - b).abs().max())
        scale = float(b.abs().max())
        tol = TRAIN_PARITY_RTOL * scale + TRAIN_PARITY_MODEL_RTOL * model_max
        if not err <= tol:
            raise RuntimeError(f"train parity: grad {name} differs by {err} (max |grad| "
                               f"{scale}, tolerance {tol})")
        worst.append((err / tol if tol else 0.0, name, err, scale))
    worst = sorted(worst, reverse=True)[:5]
    for key in ("loss", "grad_norm"):
        a, b = float(mg[key]), float(mc[key])
        if not abs(a - b) <= TRAIN_PARITY_LOSS_RTOL * abs(b):
            raise RuntimeError(f"train parity: {key} {a} on the card, {b} on the CPU")
    if int(mg["target_tokens"]) != int(mc["target_tokens"]):
        raise RuntimeError("train parity: target token counts differ")
    log(json.dumps({"train_parity": "fp32, 2 tower + 2 LM layers, 40 frames, card vs cpu",
                    "loss_card": float(mg["loss"]), "loss_cpu": float(mc["loss"]),
                    "grad_norm_card": float(mg["grad_norm"]),
                    "grad_norm_cpu": float(mc["grad_norm"]), "grad_leaves": len(gg),
                    "model_max_grad": model_max,
                    "worst_leaves_err_over_tol_err_max": worst,
                    "tol": f"{TRAIN_PARITY_RTOL} of each leaf's max |grad| + "
                           f"{TRAIN_PARITY_MODEL_RTOL} of the model's",
                    "card_step_s": tg, "cpu_step_s": tc}))


def main():
    phase_card()
    phase_build()
    train_kernels, flash_backward = phase_train_kernels()
    kernels = [phase_flash_kernel(), *phase_int8_kernels(), *phase_fused_kernels(),
               *train_kernels, *phase_int8_attn_kernels()]
    kernels[0]["backward"] = flash_backward
    chain_launches = phase_chain()
    attn_block_launches = phase_attn_block()
    microbench_launches = phase_microbench()
    launches = phase_requests()
    launches["int8_mlp_chain"] = chain_launches
    launches["attn_block"] = attn_block_launches
    launches.update(microbench_launches)
    launches["train_step"] = phase_train()
    phase_parity()
    phase_train_parity()
    for row in kernels:
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise RuntimeError(f"{row['name']} was never launched on the main paths")
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            if not math.isfinite(row[key]):
                raise RuntimeError(f"{row['name']}: {key} is {row[key]}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
