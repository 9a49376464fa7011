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
                (CUDA events, median of 5) and the card's bound: flash_fwd
                at the tower's, the memory's and both LMs' prefill shapes
                (the 7B's 28 heads of 128 over 4 KV heads among them), and
                flash_fwd_d448 (the wide kernel, head dim 448) at the 7B
                memory's fuse and evolve shapes, SDPA's kernels named, and
                at edge cases (valid length 0 and 1, 65 rows, two batches of
                unequal valid length, causal GQA), and at generate_batched's
                prefill (three rows of 15744, valid 5524, 9444 and 15716,
                causal GQA 14/2); the three
                training kernels at the LM's train shape (S = 9557, causal,
                GQA 14/2; dQ and dK/dV also run twice for the same bits and
                beside three neighbouring functions that must fail their
                check) and at edge cases in bf16 and fp32, the backward
                of flash_fwd at the memory's fuse shape, flash_fwd, the
                three int8 kernels of the default tower, the four of the
                fused configuration and the w8a8 layer (int8_matmul,
                fused_mlp_int8, fused_swiglu_block_int8,
                flash_attention_out_proj_int8), and the four of the
                approximate attention and the micro-benchmarks (the
                int8_scores merge, whose prep pass's codes and scales must
                equal their plain version bit for bit, and
                fused_attn_block_int8; int8_gemm_bf16, bit for bit, at odd
                N too; gemv, bit for bit to its own summation order and run
                twice for the same bits, its 12-layer chain timed from a
                CUDA graph, held to the int8 rule and bit for bit to its
                own order). Every int8 kernel, the decode GEMV's single
                products, the exact merge and the bf16 flash forward
                (flash_fwd, and flash_fwd_lse's out, against the online
                softmax over the kernel's 64-key tiles; its lse to the fp32
                rule) are held to their plain versions bit-close
                (EXACT_MIN_SHARE), each with neighbouring functions as
                controls that must fail; the int8_scores merge also to
                JAX's bound against the exact merge. The three int8 MLP
                half-blocks (fused_mlp_block_int8, fused_mlp_int8,
                fused_swiglu_block_int8) also run at rows around their GEMM
                core's 64- and 128-row edges (1, 47, 63, 65, 129) and at a
                K and an I that are multiples of 16 but not of 128 (144,
                272), and their controls include the plain version with h
                rounded to bf16 before the requant. int8_matmul also runs
                at N off the GEMM core's 16-column rule (200, 72, 34, 33),
                and flash_attention_out_proj_int8 with fp32 hidden at the
                tower's shape and at 65 rows;
  4. chain    — the dependent int8 MLP chain f2(f1(x)) at the tower's shape
                (46656 x 1152 x 4304): two int8_matmul calls with a tanh GELU
                between against one fused_mlp_int8 call, held against each
                other and against their plain versions, and timed; then the
                fused attention half-block at the tower's shape and at the
                tool's 768-row stream, beside the two composed halves it
                would replace (drift held, timed in turns); then both
                micro-benchmarks (int8 GEMM TOP/s, GEMV chain GB/s, and the
                device kernels of one graph replay of the GEMV chain: one
                per product, and how many consecutive products overlap);
  5. requests — the full-width 0.5B int8 serving model (random weights from
                a seed, prequantized on the card) answers 64-, 16- and
                128-frame clips with 32 greedy tokens, and a 64-frame clip
                without the memory (--no_memory); the bf16 model answers
                a 64-frame clip. Each checks the token accounting and that
                every kernel's launch count rose by what the config implies;
                then one 64-frame request of each model with its stages
                synchronised and timed, and its decode replayed from its
                CUDA graph against the eager loop: tokens and logits equal
                bit for bit (int8 greedy and sampled with seeded noise,
                bf16), decode ms/token of each. The fused configuration runs beside
                it on the same weights: the 64-frame tower with
                fused_oproj=True (launches 26/26/26 and no merge launch)
                against the unfused tower, and the 64-frame request with
                qwen2.fused_swiglu_enabled (24 fused launches, all in
                prefill) against the unfused request, each held to the int8
                model's noise floor measured in the same run, and timed;
                and the 64-frame tower through vlm.encode_frames with the
                merge swapped for its int8_scores mode (26 int8_scores
                launches, no exact merge), its drift from the exact tower
                printed beside the same run's tie-flip floor, and timed.
                Then the generation surface on the same int8 weights with
                every LM matrix times 5, so that greedy tokens vary (a
                bf16 cache, as JAX's generate): vlm.video_qa_embeds of a
                20-, a 64- and a 200-frame clip; generate greedy and
                sampled, its captured decode chunk against the eager loop
                (tokens and every step's logits bit-equal), sampled with an
                eos and a stop sequence from its own tokens firing at the
                known step; generate_batched over the three clips (B = 3),
                each row held to its own generate wherever the top-2
                margin exceeds the logit difference seen, and that
                difference to a bound; generate_stream
                (its chunks are generate's tokens); generate_speculative
                (greedy's tokens, or a departure at a margin inside the
                measured forward_chunk-vs-decode_step difference; then
                with its own tokens as drafts: the same tokens in fewer
                iterations);
                score_continuation of the greedy continuation (greedy, and
                its total against the log-softmax of the graph's logits);
                beam_search K = 1 (greedy) and K = 4; each call's launches
                held (flash_fwd 24 per prefill and the memory's per clip,
                the tower's 26 each per clip, none from forward_chunk), each
                entry's ms/token beside the pipeline's decode; then a bf16
                greedy generate, graph against eager.
                Then, the 0.5B weights freed, the 7B int8 serving model
                (bench.py --model 7b, built by the port's bench functions)
                answers a 64-frame clip: launches (5 of flash_fwd_d448, 28
                of flash_fwd, 26 of each int8 tower kernel), stages, graph
                decode against the eager loop. Then loading (`phase_load`):
                the 0.5B model's seeded bf16 weights (LM matrices times 5)
                exported with `export_hf_safetensors` under build/ and
                loaded back by `load_pretrained_model`, in bf16 and with
                load_8bit: every leaf bit-equal to the source (or to its
                prequantization), and `model.generate` of a 64-frame
                480x640 uint8 clip read back from a y4m file through
                `load_video` giving the in-memory request's 32 tokens
                (flash_fwd 55; the tower's int8 kernels 26 each and
                flash_fwd 29), with export and load times, GB/s, the peak
                host RSS and each generate's ms. And `python -m
                memory_augmented_vlm_torch.bench` runs as a subprocess with
                no flags and with --model 7b, its JSON line held to
                bench.py's keys and metric names;
  6. train    — four full-width bf16 train steps of bench_train.py's
                configuration (64 frames, 9557 tokens, AdamW with its LR
                groups) on distinct seeded batches: finite losses, 120
                target tokens, exact per-step launch counts, frozen tower,
                projector and PE bit-identical, nothing moved at lr 0 and
                every trainable group moved by the last step; two more
                from one state and batch, which must give the same loss
                and gradient leaves bit for bit; then one more step with
                its stages synchronised, one under torch.profiler (kernel
                time by kind, device idle share), and the peak memory;
                then `python -m memory_augmented_vlm_torch.bench_train` as
                a subprocess, --iters 2 and --frames 300 --iters 1 (10
                segments, the ring cache's cap, ~22k tokens), each JSON line
                held to bench_train.py's keys (less impl, staged, backend,
                vs_baseline_iso_peak; with peak_memory_gb and card) and to
                finite losses;
  7. parity   — full widths cut to 2 tower and 2 LM layers, fp32: the card
                (through the kernels) against the CPU (plain versions) on the
                same weights, for the bf16-path model (8 frames), the int8
                model with an int8 KV cache, the same with both fusions on,
                and one train step (40 frames,
                2 segments), whose loss, grad_norm and every gradient leaf
                are compared.

The line before the last is a JSON object describing each of the 16
kernels (#1's head dim 448 as its own row), with its launches on each
path; the last
line is {"ok": true, "device": {...}}. Nothing is printed as a result when
there is no card: the run raises first.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch import bench as port_bench
from memory_augmented_vlm_torch import bench_train as port_bench_train
from memory_augmented_vlm_torch import constants, pipeline
from memory_augmented_vlm_torch.checkpoint.checkpoint_io import export_hf_safetensors
from memory_augmented_vlm_torch.data import native_loader
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.data.video import load_video, write_y4m
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model
from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.models import beam_search, qwen2, siglip, vlm
from memory_augmented_vlm_torch.microbench import gemv, int8_ceiling
from memory_augmented_vlm_torch.microbench.timing import graph_ms, replay_trace, require_card
from memory_augmented_vlm_torch.microbench.timing import time_ms as _time_ms
from memory_augmented_vlm_torch.ops import (attn_block, cuda_lib, flash, flash_bwd, mlp_int8,
                                            norms, pallas_int8, qkv_int8, quant,
                                            swiglu_int8)
from memory_augmented_vlm_torch.train import optimizer, trainer
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str

# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12

# The bf16 backward kernels (dQ, dK/dV) vs their plain versions: both round
# P and dS to bf16, from fp32 sums taken in another order, and the outputs
# are bf16 (2^-8 relative steps), so they agree to the bf16 class. The bf16
# forward kernels are held bit-close instead (EXACT_MIN_SHARE, below).
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
# The same rule holds fused_mlp_block_int8, fused_mlp_int8 and int8_matmul
# (first card run: kernels 0.98-1.0 bit-equal and <= 0.0011 RMS; controls
# 0.44-0.75 and >= 0.0029), and the exact merge, fused_qkv_int8 and
# fused_swiglu_block_int8 (the merge 0.9976-0.9997 bit-equal and <= 0.00014
# RMS, mma.sync and wgmma kernels alike; its controls 0.458-0.659 and
# 0.0022-0.0035; qkv and SwiGLU 0.9995-1.0 and <= 0.00032, their controls
# 0.036-0.250 and >= 0.0069). flash_attention_out_proj_int8 is held tighter:
# its attention term (out - hidden) is small against the bf16 residual, so
# the composed merge -> quant.int8_linear + residual, which differs from it
# only by rounding the projection to bf16 before the bias, read 0.9625
# bit-equal and 0.0101 RMS, close to the general bounds, while the kernel
# read 0.9961-0.9991 and 0.0008-0.0031 at its path shape and edge cases.
# The bf16 flash forward (flash_fwd; flash_fwd_lse's out) is held to the
# shared bounds against the online softmax over the kernel's key tile
# (flash.online_softmax): the mma.sync kernels, in the first card run that
# took the rule, read 0.9920-0.9999 bit-equal and <= 0.00024 RMS at the path
# shapes and edge cases, and their controls (SDPA, the one-tile plain
# version, q unrounded, P in fp32, the diagonal moved by one key or the
# valid length one less) 0.17-0.66 and 0.0016-0.31. The decode GEMV's
# single products and edge cases (gemv) are held to the shared bounds too:
# its fp32 sums run in another order and round to bf16 once, while its
# controls (the last cluster rank's slice of K dropped, the ranks' sums
# rounded to bf16, a bf16 accumulator) read 0.0027, 0.58 and 0.051
# bit-equal at the up product's shape on the CPU's plain versions; and to
# its own summation order (gemv.gemv_in_kernel_order) bit for bit.
OPROJ_BOUNDS = {"min_share": 0.99, "max_rms": 0.006}
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
                timed=False, controls=False, name_library=False, control_rows=None):
    """flash_fwd on one input against its plain version: bf16 held bit-close
    (`_hold_bitwise`) to the online softmax over the kernel's key tile
    (`flash.forward_tiles`), fp32 to every element within F32_ATOL +
    F32_RTOL of the one-tile plain version. `controls` runs `_flash_controls`
    through the same check, each of which must fail it, over every query
    row or, causal with `control_rows`, over the first that many queries
    and keys of each batch (where the one-tile control's whole score matrix
    would not fit the card);
    `name_library` records the device kernels of the timed library call
    (its backend)."""
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = flash.flash_attention(q, k, v, valid, causal=causal, kv_groups=kv_groups)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    zero_rows = (valid == 0).nonzero().flatten().tolist()
    for b in zero_rows:
        if out[b].abs().max() != 0:
            raise RuntimeError(f"{name}: batch {b} has valid length 0 but nonzero output")
    info = {"q": list(q.shape), "kv": list(k.shape), "valid": valid.tolist(), "causal": causal,
            "dtype": str(dtype).split(".")[-1]}
    block_k = flash.forward_tiles(q.shape[-1])[0] if dtype == torch.bfloat16 else None
    plain = functools.partial(flash.flash_attention_reference, q, k, v, valid, causal=causal,
                              kv_groups=kv_groups, block_k=block_k)
    ref = plain()
    if dtype == torch.bfloat16:
        row = _hold_bitwise(name, out, ref, block_k=block_k, **info)
    else:
        row = _hold_f32(name, out, ref, **info)
    if controls:
        cq, ck, cv, cref = q, k, v, ref
        if control_rows is not None:  # causal: the first rows see only the first keys
            if not causal:
                raise ValueError("control_rows cuts a causal case only")
            cq, ck, cv, cref = (x[:, :control_rows] for x in (q, k, v, ref))
        for label, fn in _flash_controls(cq, ck, cv, valid.clamp_max(cq.shape[1]), causal,
                                         kv_groups, block_k):
            _must_fail(f"{name} control: {label}", fn()[0], cref)
    del ref
    if timed:
        row["ms"] = _time_ms(lambda: flash.flash_attention(q, k, v, valid, causal=causal,
                                                           kv_groups=kv_groups))
        row["plain_ms"] = _time_ms(plain)
        sdpa = _sdpa_call(q, k, v, valid, causal, kv_groups)
        row["library_ms"] = _time_ms(sdpa)
        if name_library:
            row["library_kernels"] = _device_kernels(sdpa)
        row["bound_ms"], row["bound_by"] = _flash_bound(q, k, v, valid, causal, kv_groups)
        log(json.dumps(row))
    return row


def _online_variant(q, k, v, valid, *, causal, kv_groups, block_k, round_q=True,
                    round_p=True, diagonal=0):
    """The kernels' online softmax (`flash.online_softmax`) with one knob
    turned: q left unrounded, P left in fp32, the causal diagonal moved.
    Returns (out in q's dtype, lse in log2 units)."""
    qs = q.float() * (q.shape[-1] ** -0.5 * flash.LOG2E)
    qs = qs.to(q.dtype).float() if round_q else qs
    k, v = (x.repeat_interleave(kv_groups, dim=2) for x in (k, v))
    out, m, l = flash.online_softmax(qs, k, v, valid, causal, block_k, round_p=round_p,
                                     diagonal=diagonal)
    return out.to(q.dtype), m + torch.log2(l.clamp_min(1e-30))


def _flash_controls(q, k, v, valid, causal, kv_groups, block_k):
    """Neighbouring functions of flash_fwd and flash_fwd_lse on their inputs,
    in plain torch, which their bf16 check must tell apart: SDPA, the
    one-tile plain version (P rounded against the final max), q unrounded,
    P in fp32; with `causal` the diagonal moved by one key, else the valid
    length one less. Yields (label, fn giving (out, lse or None))."""
    kw = dict(causal=causal, kv_groups=kv_groups, block_k=block_k)
    sdpa = _sdpa_call(q, k, v, valid, causal, kv_groups)
    yield "scaled_dot_product_attention", lambda: (sdpa().transpose(1, 2), None)
    yield "one tile over the whole key axis", lambda: flash_bwd.forward_with_lse_reference(
        q, k, v, valid, causal=causal, scale=q.shape[-1] ** -0.5, kv_groups=kv_groups)
    yield "q not rounded to bf16", lambda: _online_variant(q, k, v, valid, round_q=False, **kw)
    yield "P left in fp32 for PV", lambda: _online_variant(q, k, v, valid, round_p=False, **kw)
    if causal:
        yield "the causal diagonal moved by one key", lambda: _online_variant(
            q, k, v, valid, diagonal=1, **kw)
    else:
        yield "the valid length one less", lambda: _online_variant(
            q, k, v, (valid - 1).clamp_min(0), **kw)


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

    b3_lens = [_spliced_len(VLMConfig.onevision_0_5b(), f) for f in GENERATE_CLIPS]
    b3_rows = -(-max(b3_lens) // 128) * 128
    path_rows = [
        _check_case("tower", randn(64, 729, 16, 72), randn(64, 729, 16, 72),
                    randn(64, 729, 16, 72), lens(*[729] * 64), timed=True, controls=True),
        _check_case("memory_fuse", randn(1, 1568, 8, 112), randn(1, 6272, 8, 112),
                    randn(1, 6272, 8, 112), lens(3136), timed=True, controls=True),
        _check_case("memory_evolve", randn(1, 1568, 8, 112), randn(1, 15680, 8, 112),
                    randn(1, 15680, 8, 112), lens(3136), timed=True, controls=True),
        # the 64-frame request's spliced length: 9429 visual + 15 text tokens
        _check_case("lm_prefill", randn(1, 9472, 14, 64), randn(1, 9472, 2, 64),
                    randn(1, 9472, 2, 64), lens(9444), causal=True, kv_groups=7,
                    timed=True, controls=True),
        # the 7B LM's prefill: 28 heads of 128 over 4 KV heads
        _check_case("lm_prefill_7b", randn(1, 9472, 28, 128), randn(1, 9472, 4, 128),
                    randn(1, 9472, 4, 128), lens(9444), causal=True, kv_groups=7,
                    timed=True, controls=True),
        # generate_batched's prefill: the generation phase's three clips as
        # B = 3 right-padded rows of unequal valid length
        _check_case("lm_prefill_b3", randn(3, b3_rows, 14, 64), randn(3, b3_rows, 2, 64),
                    randn(3, b3_rows, 2, 64), lens(*b3_lens), causal=True, kv_groups=7,
                    timed=True, controls=True, control_rows=B3_CONTROL_ROWS),
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
    return [_flash_row("flash_fwd", "flash_fwd_sm90.cu", path_rows, errs),
            _flash_row("flash_fwd_d448", "flash_fwd_wide_sm90.cu", *_wide_cases(randn, lens))]


def _wide_cases(randn, lens):
    """#1 at head dim 448 (csrc/flash_fwd_wide_sm90.cu, the 7B memory): the
    fuse and evolve shapes of a 64-frame 7B request, timed, with the
    library call's backend named; edge cases of valid length 0 (zeros) and
    1, 65 query rows, B = 2 with unequal valid lengths, causal GQA. Each
    held bit-close to the online softmax at the kernel's 32-key tile;
    controls where the case can tell them apart (not where most rows see
    a single tile). Returns (path rows, errors)."""
    d = flash.WIDE_HEAD_DIM
    path_rows = [
        _check_case("memory_fuse_7b", randn(1, 1568, 8, d), randn(1, 6272, 8, d),
                    randn(1, 6272, 8, d), lens(3136), timed=True, controls=True,
                    name_library=True),
        _check_case("memory_evolve_7b", randn(1, 1568, 8, d), randn(1, 15680, 8, d),
                    randn(1, 15680, 8, d), lens(1568), timed=True, controls=True,
                    name_library=True),
    ]
    errs = [r["max_abs_err"] for r in path_rows]
    for name, sq, skv, h, hkv, valid, causal, controls in [
            ("valid_0_and_77_causal_gqa", 150, 150, 4, 2, (0, 77), True, False),
            ("valid_0_and_77", 150, 150, 4, 2, (0, 77), False, False),
            ("valid_1", 65, 100, 2, 2, (1,), False, False),
            ("sq_65", 65, 333, 8, 8, (333,), False, True),
            ("b2_unequal", 100, 333, 2, 2, (333, 65), False, True)]:
        b = len(valid)
        errs.append(_check_case(f"d448_{name}", randn(b, sq, h, d), randn(b, skv, hkv, d),
                                randn(b, skv, hkv, d), lens(*valid), causal=causal,
                                kv_groups=h // hkv, controls=controls)["max_abs_err"])
    return path_rows, errs


def _device_kernels(fn) -> list:
    """The device kernels of one call of `fn` (for a library call: which
    backend ran), by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:80] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _flash_row(name, source, path_rows, errs):
    return {
        "name": name, "route": "cuda", "source": CSRC + source,
        "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:567",
        "max_abs_err": max(errs),
        **{key: sum(r[key] for r in path_rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in path_rows)
        else "bytes",
        "per_shape": [{key: r[key] for key in ("case", "max_abs_err", "ms", "plain_ms",
                                                "library_ms", "library_kernels", "bound_ms",
                                                "bound_by") if key in r}
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


def _qkv_controls(args, nh):
    """Neighbouring functions of fused_qkv_int8 (#3) on its arguments, each
    of which its check must tell apart: the tower's unfused projections
    (the LayerNorm cast to hidden's dtype, then quant.int8_linear, which
    adds its bias after the bf16 cast) and an RMS normalisation (no mean
    subtracted, the same weight and bias) in place of the LayerNorm."""
    hidden, ln_w, ln_b = args[:3]
    projections = [args[3 + 3 * i:6 + 3 * i] for i in range(3)]
    b, s, h = hidden.shape

    def heads(y):
        return y.to(torch.bfloat16).view(b, s, nh, h // nh).transpose(1, 2).contiguous()

    def int8_linear():
        x = norms.layer_norm(hidden, ln_w, ln_b, 1e-6)
        return tuple(heads(quant.int8_linear({"kernel_int8": w, "scale": sc, "bias": bias}, x))
                     for w, sc, bias in projections)

    def rms_norm():
        hf = hidden.float()
        x = hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True) + 1e-6) * ln_w + ln_b
        xq, sx = quant.quantize_rows(x.reshape(b * s, h))
        return tuple(heads((quant.int_mm(xq, w).float() * sx * sc + bias).view(b, s, h))
                     for w, sc, bias in projections)

    return [("LayerNorm -> quant.int8_linear (bias after the bf16 cast)", int8_linear),
            ("RMS normalisation in place of the LayerNorm", rms_norm)]


def _merge_variant(q, k, v, valid, *, round_q=True, round_p=True):
    """The merge's plain version with q left unrounded or P left in fp32
    for PV: neighbouring functions of #2."""
    b, nh, s, d = q.shape
    qs = q.float() * (d ** -0.5 * flash.LOG2E)
    qs = qs.to(q.dtype).float() if round_q else qs
    sc = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    keep = torch.arange(s, device=q.device)[None, :] < valid[:, None]
    sc = torch.where(keep[:, None, None, :], sc, flash.MASK_VALUE)
    p = torch.exp2(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if round_p else p
    o = torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) * (1.0 / l)
    return o.to(q.dtype).transpose(1, 2).reshape(b, s, nh * d)


def _online_merge(q, k, v, valid, block=64):
    """#1's online softmax (`flash.online_softmax`, P rounded to bf16
    against the running max of each block of 64 keys) in the merged
    layout."""
    b, nh, s, d = q.shape
    qs = (q.float() * (d ** -0.5 * flash.LOG2E)).to(q.dtype).float()
    out = flash.online_softmax(qs.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), valid,
                               False, block)[0]
    return out.to(q.dtype).reshape(b, s, nh * d)


def _merge_controls(q, k, v, valid):
    """Neighbouring functions of flash_attention_merge_heads (#2) on its
    inputs, in plain torch, each of which its check must tell apart."""
    b, nh, s, d = q.shape

    def sdpa():
        keep = torch.arange(s, device=q.device)[None, :] < valid[:, None]
        mask = None if bool(keep.all()) else keep[:, None, None, :]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return o.transpose(1, 2).reshape(b, s, nh * d)

    return [("scaled_dot_product_attention", sdpa),
            ("P left in fp32 for PV", lambda: _merge_variant(q, k, v, valid, round_p=False)),
            ("q not rounded to bf16", lambda: _merge_variant(q, k, v, valid, round_q=False)),
            ("#1's online softmax", lambda: _online_merge(q, k, v, valid))]


def _mlp_edges(k, i, small):
    """(rows, K, I, dtype) edge cases of the int8 MLP half-blocks: 300 rows
    in bf16 and fp32, `small` rows, rows at and around the GEMM core's
    64-row warpgroup and 128-row block edges (1, 47, 63, 65, 129), and a K
    and an I that are multiples of 16 but not of its 128-byte k-step (144,
    272) in bf16 and fp32 hidden."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [(300, k, i, bf16), (300, k, i, f32), (small, k, i, bf16),
            *((mm, k, i, bf16) for mm in (1, 47, 63, 65, 129) if mm != small),
            (129, 144, 272, bf16), (129, 144, 272, f32)]


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
    errs = [_hold_bitwise(f"qkv_{n}", o, r, hidden=list(args[0].shape))["max_abs_err"]
            for n, o, r in zip("qkv", out, ref)]
    for control, fn in _qkv_controls(args, nh):
        for n, o, r in zip("qkv", fn(), ref):
            _must_fail(f"qkv_{n} control: {control}", o, r)
    del ref
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
    del args, out, xq, w_qkv
    # ragged rows against the 128-row tiles; H 144 (K and N ragged against
    # the 128-byte step and the tiles) with head dim 72, and with head dim 18
    # (four columns of a store may open the next head)
    edges = [(2, 150, h, nh, torch.bfloat16), (2, 150, h, nh, torch.float32),
             (1, 5, h, nh, torch.float32)]
    edges += [(1, rr, h, nh, dtype) for rr in (1, 47, 63, 65, 129)
              for dtype in (torch.bfloat16, torch.float32)]
    edges += [(1, 129, 144, nhh, dtype) for nhh in (2, 8)
              for dtype in (torch.bfloat16, torch.float32)]
    for bb, ss, hh, nhh, dtype in edges:
        args = _qkv_args(gen, bb, ss, hh, dtype, dev)
        out = qkv_int8.fused_qkv_int8(*args, nh=nhh)
        torch.cuda.synchronize()
        ref = qkv_int8.fused_qkv_int8_reference(*args, nh=nhh)
        errs += [_hold_bitwise(f"qkv_edge_{n}", o, r, hidden=list(args[0].shape), nh=nhh,
                               dtype=str(dtype))["max_abs_err"] for n, o, r in zip("qkv", out, ref)]
    rows["qkv"]["max_abs_err"] = max(errs)

    # --- flash_attention_merge_heads
    q, k, v = (torch.randn((b, nh, s, 72), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = flash.flash_attention_merge_heads(q, k, v, valid)
    torch.cuda.synchronize()
    ref = flash.flash_attention_merge_heads_reference(q, k, v, valid)
    errs = [_hold_bitwise("merge", out, ref, q=list(q.shape))["max_abs_err"]]
    for control, fn in _merge_controls(q, k, v, valid):
        _must_fail(f"merge control: {control}", fn(), ref)
    del ref
    bound, by = _bound(4.0 * b * nh * s * s * 72, PEAK_BF16, _nbytes(q, k, v, out))
    rows["merge"] = {
        "ms": _time_ms(lambda: flash.flash_attention_merge_heads(q, k, v, valid)),
        "plain_ms": _time_ms(lambda: flash.flash_attention_merge_heads_reference(q, k, v, valid)),
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        "library_call": "scaled_dot_product_attention (64, 16, 729, 72) bf16",
        "bound_ms": bound, "bound_by": by}
    del q, k, v, out
    # ragged valid lengths, a batch with no valid key, head dims 64 and 128,
    # S off the tiles
    for lens, dd, ss in (((77, 150), 72, 150), ((0, 150), 72, 150), ((150, 33), 64, 150),
                         ((0, 200), 128, 200), ((97, 100), 128, 100)):
        q, k, v = (torch.randn((2, nh, ss, dd), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        valid = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = flash.flash_attention_merge_heads(q, k, v, valid)
        torch.cuda.synchronize()
        ref = flash.flash_attention_merge_heads_reference(q, k, v, valid)
        errs.append(_hold_bitwise(f"merge_edge_{lens}_d{dd}", out, ref,
                                  q=list(q.shape))["max_abs_err"])
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
    ref = mlp_int8.fused_mlp_block_int8_reference(*args)
    errs = [_hold_bitwise("mlp", out, ref, args[0], hidden=list(args[0].shape))["max_abs_err"]]
    with _erf_gelu():
        _must_fail("mlp control: erf GELU", mlp_int8.fused_mlp_block_int8_reference(*args), ref,
                   args[0])
    with _h_in_bf16():
        _must_fail("mlp control: h rounded to bf16 before the requant",
                   mlp_int8.fused_mlp_block_int8_reference(*args), ref, args[0])
    del ref
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
    for mm, k, i, dtype in _mlp_edges(h, inter, 5):
        args = _mlp_args(gen, mm, k, i, dtype, dev)
        out = mlp_int8.fused_mlp_block_int8(*args)
        torch.cuda.synchronize()
        errs.append(_hold_bitwise(f"mlp_edge_{mm}x{k}x{i}", out,
                                  mlp_int8.fused_mlp_block_int8_reference(*args), args[0],
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


def _swiglu_controls(args):
    """Neighbouring functions of fused_swiglu_block_int8 (#7) on its
    arguments: the LM's unfused `_mlp_half` (the bf16 RMSNorm, three
    quant.int8_linear calls, the residual added in bf16), the plain
    version with GELU in place of SiLU, and the plain version with h
    rounded to bf16 before the requant."""
    hidden, rms_w, wg, sg, wu, su, wd, sd = args
    layer = {"post_attention_layernorm": rms_w.to(hidden.dtype),
             "gate_proj": {"kernel_int8": wg, "scale": sg},
             "up_proj": {"kernel_int8": wu, "scale": su},
             "down_proj": {"kernel_int8": wd, "scale": sd}}

    def unfused():
        with _fused_flags(swiglu=False):
            return qwen2._mlp_half(layer, hidden[None],
                                   types.SimpleNamespace(rms_norm_eps=1e-6))[0]

    def gelu():
        silu = swiglu_int8.silu_f32
        swiglu_int8.silu_f32 = F.gelu
        try:
            return swiglu_int8.fused_swiglu_block_int8_reference(*args)
        finally:
            swiglu_int8.silu_f32 = silu

    return [("the unfused _mlp_half", unfused), ("GELU in place of SiLU", gelu),
            ("h rounded to bf16 before the requant", lambda: _swiglu_bf16_h(args))]


def _oproj_args(gen, b, s, nh, d, valid, dtype, dev):
    q, k, v = (torch.randn((b, nh, s, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    hidden = torch.randn((b, s, nh * d), generator=gen, device=dev).to(dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    return (q, k, v, vl, hidden, *_int8_weight(gen, nh * d, nh * d, dev))


@contextlib.contextmanager
def _h_in_bf16():
    """The int8 MLP's plain versions with h (the GELU output) rounded to
    bf16 before the requant: the shortcut that halves h's round trip, and
    a neighbouring function (its codes move wherever a bf16 step crosses a
    code boundary)."""
    gelu = mlp_int8.gelu_tanh
    mlp_int8.gelu_tanh = lambda x: gelu(x).to(torch.bfloat16).float()
    try:
        yield
    finally:
        mlp_int8.gelu_tanh = gelu


def _swiglu_bf16_h(args):
    """fused_swiglu_block_int8's plain version with h = silu(g) * u rounded
    to bf16 before the requant (see _h_in_bf16)."""
    hidden, rms_w, wg, sg, wu, su, wd, sd = args
    hf = hidden.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    xq, sx = quant.quantize_rows(hf * torch.rsqrt(var + 1e-6) * rms_w.float())
    g = quant.int_mm(xq, wg).float() * sx * sg.float()
    u = quant.int_mm(xq, wu).float() * sx * su.float()
    hq, sh = quant.quantize_rows((swiglu_int8.silu_f32(g) * u).to(torch.bfloat16).float())
    return (hf + quant.int_mm(hq, wd).float() * sh * sd.float()).to(hidden.dtype)


@contextlib.contextmanager
def _erf_gelu():
    """The int8 MLP's plain versions with exact (erf) GELU in place of tanh
    GELU: a neighbouring function (the projector's and fuser's GELU)."""
    tanh = mlp_int8.gelu_tanh
    mlp_int8.gelu_tanh = F.gelu
    try:
        yield
    finally:
        mlp_int8.gelu_tanh = tanh


def _oproj_out(attn, hidden, wo, so, bo):
    """hidden + the row-quantized int8 out-projection of `attn` (B, S, H), in
    fp32 and cast once: the epilogue of #5's plain version."""
    b, s, h = hidden.shape
    xq, sx = quant.quantize_rows(attn.to(torch.bfloat16).reshape(b * s, h))
    y = quant.int_mm(xq, wo).float() * sx * so.float() + bo.float()
    return (hidden.float() + y.reshape(b, s, h)).to(hidden.dtype)


def _oproj_controls(args):
    """Neighbouring functions of flash_attention_out_proj_int8 (#5) on its
    arguments (q, k, v, valid, hidden, wo, so, bo), each of which its check
    must tell apart: the composed merge -> quant.int8_linear + residual (the
    tower's unfused layer); the attention quantized per (row, head) with the
    heads' products summed in head order (#12's out-projection); and an fp32
    base-e softmax without the bf16 rounding of q and P."""
    q, k, v, vl, hidden, wo, so, bo = args
    b, nh, s, d = q.shape

    def composed():
        attn = flash.flash_attention_merge_heads(q, k, v, vl)
        return hidden + quant.int8_linear({"kernel_int8": wo, "scale": so, "bias": bo}, attn)

    def per_head_quant():
        attn = flash.flash_attention_merge_heads_reference(q, k, v, vl).to(torch.bfloat16)
        oq, s_row = quant.quantize_rows(attn.reshape(b * s, nh, d))
        wo3 = wo.double().reshape(nh, d, nh * d)
        acc = torch.zeros((b * s, nh * d), dtype=torch.float32, device=q.device)
        for i in range(nh):
            acc = acc + torch.matmul(oq[:, i].double(), wo3[i]).float() * s_row[:, i]
        y = acc * so.float() + bo.float()
        return (hidden.float() + y.reshape(b, s, nh * d)).to(hidden.dtype)

    def f32_softmax():
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
        keep = torch.arange(s, device=q.device)[None, :] < vl[:, None]
        p = torch.softmax(torch.where(keep[:, None, None, :], sc, flash.MASK_VALUE), dim=-1)
        attn = torch.einsum("bhqk,bhkd->bqhd", p, v.float()).reshape(b, s, nh * d)
        return _oproj_out(attn, hidden, wo, so, bo)

    return [("merge -> quant.int8_linear + residual", composed),
            ("attention quantized per (row, head)", per_head_quant),
            ("fp32 base-e softmax, q and P not rounded", f32_softmax)]


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
        ref = pallas_int8.int8_matmul_reference(x, w, sw, bias)
        err = _hold_bitwise(f"matmul_{name}", out, ref, x=list(x.shape), n=n)["max_abs_err"]
        errs.append(err)
        _must_fail(f"matmul_{name} control: quant.int8_linear (bias after the cast)",
                   quant.int8_linear({"kernel_int8": w, "scale": sw, "bias": bias}, x), ref)
        del ref
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
    # rows past one 128-row tile and within it; N off the 16-column rule of
    # the GEMM core (even, N % 4 != 0 and odd: rows whose base is not
    # 4-aligned), K off its 128-byte step
    edges = [(300, h, inter, torch.float32, True), (300, h, inter, torch.bfloat16, False),
             (5, lm_h, lm_i, torch.float32, False)]
    for n in (200, 72, 34, 33):
        edges += [(300, h if n > 34 else 144, n, torch.bfloat16, False),
                  (37, h if n > 34 else 144, n, torch.float32, True)]
    for mm, k, n, dtype, with_bias in edges:
        x = torch.randn((mm, k), generator=gen, device=dev).to(dtype)
        x[mm // 2] = 0  # a zero row takes the floor scale
        w, sw, bias = _int8_weight(gen, k, n, dev)
        bias = bias if with_bias else None
        out = pallas_int8.int8_matmul(x, w, sw, bias)
        torch.cuda.synchronize()
        errs.append(_hold_bitwise(f"matmul_edge_{mm}x{k}x{n}", out,
                                  pallas_int8.int8_matmul_reference(x, w, sw, bias),
                                  x=list(x.shape), n=n, dtype=str(dtype),
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
    ref = mlp_int8.fused_mlp_int8_reference(*args)
    errs = [_hold_bitwise("mlp_core", out, ref, x=list(args[0].shape))["max_abs_err"]]
    with _erf_gelu():
        _must_fail("mlp_core control: erf GELU", mlp_int8.fused_mlp_int8_reference(*args), ref)
    with _h_in_bf16():
        _must_fail("mlp_core control: h rounded to bf16 before the requant",
                   mlp_int8.fused_mlp_int8_reference(*args), ref)
    del ref
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
    for mm, k, i, dtype in _mlp_edges(h, inter, 1):
        args = _mlp_args(gen, mm, k, i, dtype, dev)
        args = (args[0], *args[3:])
        out = mlp_int8.fused_mlp_int8(*args)
        torch.cuda.synchronize()
        errs.append(_hold_bitwise(f"mlp_core_edge_{mm}x{k}x{i}", out,
                                  mlp_int8.fused_mlp_int8_reference(*args),
                                  x=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
    rows["mlp_core"]["max_abs_err"] = max(errs)

    # --- fused_swiglu_block_int8
    args = _swiglu_args(gen, lm_rows, lm_h, lm_i, torch.bfloat16, dev)
    out = swiglu_int8.fused_swiglu_block_int8(*args)
    torch.cuda.synchronize()
    ref = swiglu_int8.fused_swiglu_block_int8_reference(*args)
    errs = [_hold_bitwise("swiglu", out, ref, args[0], hidden=list(args[0].shape))["max_abs_err"]]
    for control, fn in _swiglu_controls(args):
        _must_fail(f"swiglu control: {control}", fn(), ref, args[0])
    del ref
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
    for mm, k, i, dtype in _mlp_edges(lm_h, lm_i, 1):
        args = _swiglu_args(gen, mm, k, i, dtype, dev)
        out = swiglu_int8.fused_swiglu_block_int8(*args)
        torch.cuda.synchronize()
        errs.append(_hold_bitwise(f"swiglu_edge_{mm}x{k}x{i}", out,
                                  swiglu_int8.fused_swiglu_block_int8_reference(*args), args[0],
                                  hidden=list(args[0].shape), dtype=str(dtype))["max_abs_err"])
        if not torch.equal(out[mm // 2], args[0][mm // 2]):
            raise RuntimeError("swiglu: a zero row did not come back as it went in")
    rows["swiglu"]["max_abs_err"] = max(errs)

    # --- flash_attention_out_proj_int8
    args = _oproj_args(gen, b, s, nh, 72, [s] * b, torch.bfloat16, dev)
    out = flash.flash_attention_out_proj_int8(*args)
    torch.cuda.synchronize()
    ref = flash.flash_attention_out_proj_int8_reference(*args)
    errs = [_hold_bitwise("oproj", out, ref, args[4], **OPROJ_BOUNDS,
                          q=list(args[0].shape))["max_abs_err"]]
    for control, fn in _oproj_controls(args):
        _must_fail(f"oproj control: {control}", fn(), ref, args[4], **OPROJ_BOUNDS)
    del ref
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
    # valid lengths ragged and 0; fp32 hidden, at the tower's shape too;
    # rows ragged against the GEMM's 128-row tiles (300, 65)
    for name, bb, ss, valid, dtype in (("77_150", 2, 150, (77, 150), torch.bfloat16),
                                       ("0_150", 2, 150, (0, 150), torch.bfloat16),
                                       ("0_77_f32", 2, 150, (0, 77), torch.float32),
                                       ("tower_f32", b, s, [s] * b, torch.float32),
                                       ("1x65", 1, 65, (65,), torch.bfloat16)):
        args = _oproj_args(gen, bb, ss, nh, 72, valid, dtype, dev)
        out = flash.flash_attention_out_proj_int8(*args)
        torch.cuda.synchronize()
        errs.append(_hold_bitwise(f"oproj_edge_{name}", out,
                                  flash.flash_attention_out_proj_int8_reference(*args), args[4],
                                  **OPROJ_BOUNDS, q=list(args[0].shape),
                                  dtype=str(dtype))["max_abs_err"])
        del args, out
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


def _bit_close(name, out, ref, base=None, min_share=EXACT_MIN_SHARE,
               max_rms=EXACT_MAX_RMS, **info) -> dict:
    """The share of bit-equal elements and the RMS difference over the
    spread of `ref` (of ref - base where `base` is given), each against its
    bound (EXACT_MIN_SHARE, EXACT_MAX_RMS). fp32 outputs are compared
    rounded to bf16: a LayerNorm summed in another order flips an int8 code
    at a rounding tie, which moves every fp32 output of its row by far less
    than a bf16 step (the first card run read 0.871 of fp32 elements
    bit-equal and an RMS of 7e-5 of the spread for #4)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise RuntimeError(f"{name}: {out.dtype}{tuple(out.shape)} vs plain "
                           f"{ref.dtype}{tuple(ref.shape)}")
    if ref.dtype == torch.float32:
        out, ref = out.to(torch.bfloat16), ref.to(torch.bfloat16)
        base = None if base is None else base.to(torch.bfloat16)
        info["compared_in"] = "bfloat16"
    diff = out.float() - ref.float()
    spread = (ref.float() - (0.0 if base is None else base.float())).std()
    rms = diff.pow(2).mean().sqrt()
    # an output that is its residual alone (a row of zeros in, the same row
    # out) has no spread: bit-equal reads 0, anything else infinity
    rms = rms / spread if spread > 0 else (0.0 if rms == 0 else math.inf)
    row = {"case": name, **info, "exact_share": float((diff == 0).float().mean()),
           "rms_over_spread": float(rms),
           "max_abs_err": float(diff.abs().max()),
           "spread_of": "output" if base is None else "output - hidden",
           "tol": f"exact_share >= {min_share}, rms_over_spread <= {max_rms}"}
    row["held"] = row["exact_share"] >= min_share and row["rms_over_spread"] <= max_rms
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


def _f32_close(name, out, ref, **info) -> dict:
    """Elements of an fp32 output outside F32_ATOL + F32_RTOL of `ref`."""
    diff = (out - ref).abs()
    return {"case": name, **info, "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "outside": int((diff > F32_ATOL + F32_RTOL * ref.abs()).sum()),
            "tol": f"every element within atol {F32_ATOL} + rtol {F32_RTOL}"}


def _hold_f32(name, out, ref, **info) -> dict:
    """An fp32 output against its plain version at F32_ATOL + F32_RTOL."""
    row = _f32_close(name, out, ref, **info)
    log(json.dumps(row))
    if out.dtype != torch.float32 or row["outside"] or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: kernel and plain version disagree ({row})")
    return row


def _must_fail_f32(name, out, ref):
    """A neighbouring function through `_hold_f32`'s rule: it must fail."""
    row = _f32_close(name, out, ref)
    log(json.dumps({"control": "must fail", **row}))
    if not row["outside"]:
        raise RuntimeError(f"{name}: a neighbouring function passes the kernel check ({row})")


def _hold_equal(name, out, ref, **info) -> dict:
    """An output that must equal its plain version bit for bit: the int8
    GEMM's int32 sums are exact and both cast them through fp32 to bf16;
    the GEMV's fp32 sums, taken in the kernel's own order, round alike."""
    row = _compare(name, out, ref, **info)
    if not torch.equal(out, ref):
        raise RuntimeError(f"{name}: kernel and plain version differ ({row})")
    return row


def _hold_prep(name, k, v):
    """The int8_scores kernel's prep pass (K codes, V^T codes in PV's key
    order, the two scales) against its plain version, bit for bit."""
    got = flash.merge_int8_prep(k, v)
    torch.cuda.synchronize()
    want = flash.merge_int8_prep_reference(k, v)
    equal = {part: torch.equal(a, b)
             for part, a, b in zip(("k_codes", "vt_codes", "scales"), got, want)}
    log(json.dumps({"case": name, "kv": list(k.shape), "bit_equal": equal,
                    "tol": "every code and scale equal"}))
    if not all(equal.values()):
        raise RuntimeError(f"{name}: the prep pass differs from its plain version: {equal}")


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


def _gemv_controls(x, w, sms):
    """Neighbouring functions of the decode GEMV (#14) on x (1, K) and w
    (K, N), each of which its check must tell apart: the kernel's partition
    (`gemv.plan` for `sms` SMs) with the last cluster rank's slice of K
    dropped; each rank's fp32 sum rounded to bf16 before the ranks' sums
    are added; and the product summed in a bf16 accumulator, row by row."""
    k, n = w.shape
    slices = gemv.plan(k, n, sms).slices(k)
    xf, wf = x.float(), w.float()

    def last_split_dropped():
        end = slices[-1][0]
        return gemv.gemv_reference(x[:, :end], w[:end])

    def partials_in_bf16():
        acc = torch.zeros((1, n), dtype=torch.float32, device=x.device)
        for a, b in slices:
            acc = acc + (xf[:, a:b] @ wf[a:b]).to(torch.bfloat16).float()
        return acc.to(x.dtype)

    def summed_in_bf16():
        acc = torch.zeros((1, n), dtype=torch.bfloat16, device=x.device)
        for kk in range(k):
            acc = (acc.float() + xf[:, kk:kk + 1] * wf[kk]).to(torch.bfloat16)
        return acc.to(x.dtype)

    return [("the last K split dropped", last_split_dropped),
            ("fp32 partial sums rounded to bf16 before the sum", partials_in_bf16),
            ("the product summed in bf16", summed_in_bf16)]


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
    _hold_prep("int8_scores_prep", k, v)
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
        _hold_prep(f"int8_scores_prep_edge_d{dd}_s{ss}", k, v)
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
    # valid < S, nh 2 / 4 / 8 / 16 (head dims 128, 64, 32, 72), fp32 hidden,
    # valid 0, rows ragged against the 128-row tiles
    for bb, ss, hh, nhh, vv, dtype in ((2, 150, 1152, 16, 77, torch.bfloat16),
                                       (2, 150, 256, 2, 100, torch.bfloat16),
                                       (2, 150, 256, 4, 120, torch.bfloat16),
                                       (2, 150, 256, 8, 150, torch.float32),
                                       (1, 97, 1152, 16, 0, torch.float32),
                                       (1, 1, 1152, 16, 1, torch.bfloat16),
                                       (1, 65, 1152, 16, 65, torch.bfloat16),
                                       (1, 129, 1152, 16, 129, torch.bfloat16)):
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
    # ragged M and N; odd N, which the mma.sync GEMM before the s8 wgmma
    # core refused
    for mm, kk, nn in ((1000, 1152, 1000), (1, 896, 130), (300, 4304, 1152), (1, 896, 33),
                       (300, 1152, 1)):
        x = torch.randint(-127, 128, (mm, kk), generator=gen, device=dev, dtype=torch.int8)
        w = quant.column_major(torch.randint(-127, 128, (kk, nn), generator=gen, device=dev,
                                             dtype=torch.int8))
        out = int8_ceiling.int8_gemm_bf16(x, w)
        torch.cuda.synchronize()
        errs.append(_hold_equal(f"int8_gemm_bf16_edge_{mm}x{kk}x{nn}", out,
                                int8_ceiling.int8_gemm_bf16_reference(x, w))["max_abs_err"])
    rows["int8_gemm"]["max_abs_err"] = max(errs)

    # --- gemv: the tool's 12-layer chain, timed as one CUDA-graph replay.
    # A single product repeats its plain version's fp32 sums in another
    # order and rounds once to bf16, so it is held bit-close, with controls.
    x, w1, w2 = gemv.operands(seed=12)
    errs = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, xx, w in (("up", x, w1[0]), ("down", gemv.gemv_reference(x, w1[0]), w2[0])):
        out = gemv.gemv(xx, w)
        again = gemv.gemv(xx, w)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise RuntimeError(f"gemv_{name}: two calls on the same operands differ")
        ref = gemv.gemv_reference(xx, w)
        pl = gemv.plan(*w.shape, sms)
        errs.append(_hold_bitwise(f"gemv_{name}", out, ref, w=list(w.shape),
                                  plan=pl._asdict())["max_abs_err"])
        _hold_equal(f"gemv_{name}_in_kernel_order", out, gemv.gemv_in_kernel_order(xx, w, pl))
        if name == "up":
            for control, fn in _gemv_controls(xx, w, sms):
                _must_fail(f"gemv control: {control}", fn(), ref)
    # the chain keeps the path rule: one bf16 step flipped in the first of
    # its 24 products spreads through every later one, so most of its
    # outputs differ in the last bits
    y = gemv.chain(gemv.gemv, x, w1, w2)
    torch.cuda.synchronize()
    errs.append(_compare("gemv_chain", y, gemv.chain(gemv.gemv_reference, x, w1, w2),
                         layers=gemv.L)["max_abs_err"])
    # ... and equals its own order product by product: each product read the
    # output of the one before it only after that one had finished

    def in_kernel_order(xx, w):
        return gemv.gemv_in_kernel_order(xx, w, gemv.plan(*w.shape, sms))

    _hold_equal("gemv_chain_in_kernel_order", y, gemv.chain(in_kernel_order, x, w1, w2))
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
    # K and N off the block; N = 777, 3, 900 and 4100 give row strides that
    # TMA refuses, so those load W with plain loads; the strips are 64, 32,
    # 64, 128, 32 and 128 columns wide. Each W is written by the grid
    # launched just before the call, which gemv (no programmatic edge) must
    # wait for before it reads W; in the last case that grid is a gemv,
    # which lets its dependents launch before it writes its output
    for kk, nn in ((1000, 777), (5, 3), (4864, 900), (33, 4104), (896, 200), (896, 4100),
                   (38, 128)):
        x = torch.randn((1, kk), generator=gen, device=dev).to(torch.bfloat16)
        if (kk, nn) == (38, 128):  # W is the up product's output, 38 x 128
            x0 = torch.randn((1, gemv.H), generator=gen, device=dev).to(torch.bfloat16)
            w0 = (torch.randn((gemv.H, gemv.I), generator=gen, device=dev) * 0.05).to(
                torch.bfloat16)
            w = gemv.gemv(x0, w0).view(kk, nn)
        else:
            w = (torch.randn((kk, nn), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        out = gemv.gemv(x, w)
        torch.cuda.synchronize()
        pl = gemv.plan(kk, nn, sms)
        errs.append(_hold_bitwise(f"gemv_edge_{kk}x{nn}", out, gemv.gemv_reference(x, w),
                                  loads="tma" if gemv.loads_by_tma(w) else "plain",
                                  plan=pl._asdict())["max_abs_err"])
        _hold_equal(f"gemv_edge_{kk}x{nn}_in_kernel_order", out,
                    gemv.gemv_in_kernel_order(x, w, pl))
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
    # one device kernel per product in a graph replay of the chain, and
    # whether consecutive products overlap (the programmatic edge kept)
    trace = replay_trace(lambda: gemv.chain(gemv.gemv, x, w1, w2), "gemv")
    log(json.dumps({"gemv_chain_graph_replay": trace}))
    if trace["device_kernels"] != 2 * w1.shape[0]:
        raise RuntimeError(f"gemv chain replay: {trace['device_kernels']} device kernels, "
                           f"want {2 * w1.shape[0]}")
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
TRAIN_SOURCES = {"flash_fwd_lse": "flash_fwd_sm90.cu", "flash_bwd_dq": "flash_bwd_sm90.cu",
                 "flash_bwd_dkv": "flash_bwd_sm90.cu"}
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


def _train_outside(got, ref) -> int:
    """Elements of a training kernel's output outside the rule it is held
    to against its plain version: atol + rtol * |ref|, bf16 or fp32 class."""
    atol, rtol = (BF16_ATOL, BF16_RTOL) if ref.dtype == torch.bfloat16 else (F32_ATOL, F32_RTOL)
    return int(((got.float() - ref.float()).abs() > atol + rtol * ref.float().abs()).sum())


def _backward_without(q, k, v, g, lse, delta, vl, drop, *, causal, scale, kv_groups):
    """The plain dQ, dK and dV with the (query, key) pairs where `drop`
    (Sq, Skv) is true left out: a neighbouring function for the controls."""
    p, ds = flash_bwd._dscores(q, k, v, g, lse, delta, vl, causal, scale, kv_groups)
    p, ds = p.masked_fill(drop, 0.0), ds.masked_fill(drop, 0.0)
    rk, rv = (flash_bwd._repeat(x, kv_groups).float() for x in (k, v))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), rk).to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bhkd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bqhd->bhkd", ds.to(q.dtype).float(), q.float())
    return (dq, *(flash_bwd.group_sum(x, kv_groups).to(k.dtype) for x in (dk, dv)))


def _train_controls(q, k, v, g, lse, delta, vl, refs, **kw):
    """Neighbouring functions of flash_bwd_dq and flash_bwd_dkv that their
    check (`_train_outside` == 0) must tell apart, each against the plain
    output it would replace: dK/dV with the first query head of each group
    left out; dK/dV with the first query tile each dK/dV item visits (the
    diagonal's, when causal) skipped; dQ with the last key tile each dQ item
    visits left out. Yields (label, output, plain output)."""
    rq, rk, rv = refs
    b, sq, h, d = q.shape
    kv_groups = kw["kv_groups"]
    pk, pv = flash_bwd.backward_dkv_partials_reference(q, k, v, g, lse, delta, vl, **kw)
    keep = (torch.arange(h, device=q.device) % kv_groups != 0)[None, :, None, None]
    for name, part, ref in (("dk", pk, rk), ("dv", pv, rv)):
        yield (f"{name}, one query head of each group left out",
               flash_bwd.group_sum(part * keep, kv_groups).to(ref.dtype), ref)
    del pk, pv
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(k.shape[1], device=q.device)[None, :]
    block_k = flash_bwd.dkv_block_k(d)
    first = (cols // block_k * block_k // flash_bwd.DKV_BLOCK_Q if kw["causal"]
             else torch.zeros_like(cols))
    _, dk, dv = _backward_without(q, k, v, g, lse, delta, vl,
                                  rows // flash_bwd.DKV_BLOCK_Q == first, **kw)
    yield "dk, each key tile's first query tile skipped", dk, rk
    yield "dv, each key tile's first query tile skipped", dv, rv
    del dk, dv
    blk = flash_bwd.dq_block_q(d)
    end = torch.minimum((rows // blk + 1) * blk, vl.min().clamp_min(1)) if kw["causal"] \
        else vl.min().clamp_min(1).expand_as(rows)
    last = (end - 1) // flash_bwd.DQ_BLOCK_K
    dq, _, _ = _backward_without(q, k, v, g, lse, delta, vl,
                                 cols // flash_bwd.DQ_BLOCK_K == last, **kw)
    yield "dq, the last key tile of each query tile left out", dq, rq


def _train_kernels_case(name, gen, b, sq, skv, h, hkv, d, causal, valid, dtype=torch.bfloat16,
                        timed=False):
    """Run the three training kernels on one input and hold each output
    against its plain version (lse on its finite entries, and -inf where
    the plain version has -inf). The timed case (the train shape) also runs
    dQ and dK/dV a second time and requires the same bits, and runs the
    controls of `_train_controls`, each of which must fail the check.
    Returns {kernel: row}."""
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
        bad = _train_outside(got, ref)
        if bad:
            raise RuntimeError(f"{name} {label}: {bad} elements outside tolerance "
                               f"(max err {float(diff.max())})")
        return float(diff.max()) if diff.numel() else 0.0

    # bf16: out held bit-close to the online softmax over the kernel's key
    # tile, lse to the fp32 rule on its finite rows; fp32: the one-tile plain
    # version at the fp32 class
    block_k = flash.forward_tiles(d)[0] if dtype == torch.bfloat16 else None
    rout, rlse = flash_bwd.forward_with_lse_reference(q, k, v, vl, block_k=block_k, **kw)
    fin = torch.isfinite(rlse)
    if not torch.equal(torch.isfinite(lse), fin):
        raise RuntimeError(f"{name}: lse is -inf on other rows than the plain version's")
    if dtype == torch.bfloat16:
        fwd_err = _hold_bitwise(f"{name} out", out, rout, block_k=block_k, **info)["max_abs_err"]
    else:
        fwd_err = held("out", out, rout)
    errs = {"flash_fwd_lse": max(fwd_err, _hold_f32(f"{name} lse", lse[fin], rlse[fin],
                                                    **info)["max_abs_err"])}
    if timed:
        for label, fn in _flash_controls(q, k, v, vl, causal, h // hkv, block_k):
            c_out, c_lse = fn()
            _must_fail(f"{name} out control: {label}", c_out, rout)
            if label == "the causal diagonal moved by one key":
                _must_fail_f32(f"{name} lse control: {label}", c_lse[fin], rlse[fin])
        _must_fail_f32(f"{name} lse control: natural-log units", rlse[fin] * math.log(2.0),
                       rlse[fin])
    del rout, rlse
    rdq = flash_bwd.backward_dq_reference(q, k, v, g, lse, delta, vl, **kw)
    errs["flash_bwd_dq"] = held("dq", dq, rdq)
    rdk, rdv = flash_bwd.backward_dkv_reference(q, k, v, g, lse, delta, vl, **kw)
    errs["flash_bwd_dkv"] = max(held("dk", dk, rdk), held("dv", dv, rdv))
    if timed:
        repeat = (dq_fn(), *dkv_fn())
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip((dq, dk, dv), repeat)]
        log(json.dumps({"case": name, "second_run_bit_equal": dict(zip(("dq", "dk", "dv"), same))}))
        if not all(same):
            raise RuntimeError(f"{name}: a second run of the backward kernels differs: {same}")
        del repeat
        for label, got, ref in _train_controls(q, k, v, g, lse, delta, vl, (rdq, rdk, rdv), **kw):
            outside = _train_outside(got, ref)
            log(json.dumps({"control": "must fail", "case": name, "neighbour": label,
                            "elements_outside": outside, "of": ref.numel(), "tol": info["tol"]}))
            if not outside:
                raise RuntimeError(f"{name}: a neighbouring function passes the kernel check "
                                   f"({label})")
            del got
    del rdq, rdk, rdv
    empty = (vl == 0).nonzero().flatten().tolist()
    for i in empty:  # no valid key: zero output and grads, lse -inf
        if any(float(x[i].abs().max()) for x in (out, dq, dk, dv)) or bool(
                torch.isfinite(lse[i]).any()):
            raise RuntimeError(f"{name}: batch {i} has valid length 0 but a nonzero result")
    rows = {kname: {"case": name, "kernel": kname, **info, "max_abs_err": err}
            for kname, err in errs.items()}
    if timed:
        plain = {
            "flash_fwd_lse": lambda: flash_bwd.forward_with_lse_reference(
                q, k, v, vl, block_k=block_k, **kw),
            "flash_bwd_dq": lambda: flash_bwd.backward_dq_reference(
                q, k, v, g, lse, delta, vl, **kw),
            "flash_bwd_dkv": lambda: flash_bwd.backward_dkv_reference(
                q, k, v, g, lse, delta, vl, **kw)}
        for kname, fn in (("flash_fwd_lse", fwd), ("flash_bwd_dq", dq_fn),
                          ("flash_bwd_dkv", dkv_fn)):
            rows[kname]["ms"] = _time_ms(fn)
            # ten calls in a row: the card's time without the host's gap
            # before each single call
            rows[kname]["ms_back_to_back"] = _time_ms(lambda: [fn() for _ in range(10)]) / 10
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
            "name": kname, "route": "cuda", "source": CSRC + TRAIN_SOURCES[kname],
            "replaces": TRAIN_REPLACES[kname], "max_abs_err": max(errs[kname]),
            **{key: row[key] for key in ("ms", "ms_back_to_back", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "library_call")}})
    return kernels, backward


# ------------------------------------------------------------ requests

WRAPPERS = {
    "flash_fwd": flash.flash_attention,
    "flash_fwd_d448": flash.flash_forward_wide,
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
                       fused_swiglu: bool = False, no_memory: bool = False) -> dict:
    """One request. `fused_swiglu` adds one launch per LM layer, in prefill
    only: a decode step's single row stays below the kernel's gate. The
    memory's cross-attentions take the wide kernel at head dim 448 (7B);
    `no_memory` runs none."""
    lm = cfg.lm.num_hidden_layers
    if cfg.pipeline.tower_int8:
        want = _expected_tower_launches(cfg, fused_oproj)
        want["fused_swiglu_block_int8"] = lm if fused_swiglu else 0
    else:
        want = {**dict.fromkeys(WRAPPERS, 0), "flash_fwd": cfg.vision.num_used_layers}
    memory = 0 if no_memory else _memory_calls(cfg, num_frames)
    wide = cfg.memory.hidden_size // cfg.memory.num_attention_heads == flash.WIDE_HEAD_DIM
    want["flash_fwd_d448" if wide else "flash_fwd"] += memory
    want["flash_fwd"] += lm
    return want


def _expected_train_launches(cfg: VLMConfig, num_frames: int) -> dict:
    """One train step: the frozen tower and the memory through flash_fwd
    (the memory's backward is a plain recompute), each LM layer through the
    training kernels, its forward twice under remat."""
    lm = cfg.lm.num_hidden_layers
    return {**dict.fromkeys(WRAPPERS, 0),
            "flash_fwd": cfg.vision.num_used_layers + _memory_calls(cfg, num_frames),
            "flash_fwd_lse": 2 * lm, "flash_bwd_dq": lm, "flash_bwd_dkv": lm}


def _visual_tokens(cfg: VLMConfig, num_frames: int, nseg: int, no_memory: bool = False) -> int:
    m = cfg.memory
    if no_memory:  # each frame's pooled tokens and a newline
        return num_frames * (m.patch_size + 1)
    return (10 + nseg * m.num_memory_tokens * m.patch_size + 1 + 9
            + min(m.num_fine_frames, num_frames) * m.patch_size + 1)


def _serve(label, cfg, params, frame_counts, gen, kv_int8, no_memory=False):
    dev = "cuda"
    tb = torch.tensor(TEXT_BEFORE, device=dev)
    ta = torch.tensor(TEXT_AFTER, device=dev)
    launches_64 = None
    for num_frames in frame_counts:
        fn, nseg = pipeline.build_pipeline(cfg, num_frames, return_logits=True, kv_int8=kv_int8,
                                           no_memory=no_memory)
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
        want = _expected_launches(cfg, num_frames, no_memory=no_memory)
        if launches != want:
            raise RuntimeError(f"{label} {num_frames} frames: launches {launches}, want {want}")
        visual = s - len(TEXT_BEFORE) - len(TEXT_AFTER)
        if visual != _visual_tokens(cfg, num_frames, nseg, no_memory):
            raise RuntimeError(f"{label} {num_frames} frames: {visual} visual tokens")
        if num_frames == 64 and visual != (12608 if no_memory else 9429):
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


# with decode replayed from its captured chunks, `unembed` is the prefill's
# one call and `decode` the replays (32 steps and 32 unembeds)
REQUEST_STAGES = [
    (siglip, "forward", "tower"), (vlm, "encode_frames", "tower+projector+pool"),
    (vlm, "build_video_embeds", "memory+assembly"), (qwen2, "forward", "lm_prefill"),
    (qwen2, "unembed", "unembed"), (qwen2, "quantize_cache", "quantize_cache"),
    (vlm._Decoder, "run_chunk", "decode")]
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
    repetitions, after a warm-up that captures the decode graph outside the
    clock); the tower's time is inside tower+projector+pool."""
    dev = "cuda"
    fn, _ = pipeline.build_pipeline(cfg, num_frames, kv_int8=kv_int8)
    pixels = torch.randn((num_frames, 384, 384, 3), generator=gen, device=dev).to(torch.bfloat16)
    tb, ta = torch.tensor(TEXT_BEFORE, device=dev), torch.tensor(TEXT_AFTER, device=dev)
    fn(params, pixels, tb, ta)
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


@contextlib.contextmanager
def _decoders_started():
    """Records each decoder a call starts, with the prefill's logits, the
    cache lengths and the settings, so that its decode alone can run again
    (`_decode_again`)."""
    seen, real = [], vlm._Decoder.reset

    def spy(dec, logits, st):
        seen.append((dec, logits.clone(), dec.cache.length.clone(), st))
        return real(dec, logits, st)

    vlm._Decoder.reset = spy
    try:
        yield seen
    finally:
        vlm._Decoder.reset = real


def _decode_again(dec, logits, length, st):
    """A started decoder's decode once more from its prefill: the cache
    lengths and the state reset, then every chunk of the budget (each
    rewrites the cache positions the last run wrote before reading them;
    sampled, the noise buffer as the last chunk left it)."""
    dec.cache.length.copy_(length)
    dec.reset(logits, st)
    for _ in range(-(-st.max_new_tokens // dec.chunk)):
        dec.run_chunk(dec.noise)


def _graph_vs_eager(label, cfg, params, gen, kv_int8, temperature=0.0):
    """A 64-frame request (sampled with the default seeded noise) decoded
    twice by replaying its captured chunks, against the same request decoded
    eagerly on the card (`cuda_graph=False`: the same transitions op by op):
    tokens and logits equal bit for bit, after the capture and after a
    replay. Then decode ms/token of each, the decoder alone
    (`_decode_again`), CUDA events, median."""
    dev = "cuda"
    tb, ta = torch.tensor(TEXT_BEFORE, device=dev), torch.tensor(TEXT_AFTER, device=dev)
    pixels = torch.randn((64, 384, 384, 3), generator=gen, device=dev).to(torch.bfloat16)
    fn, _ = pipeline.build_pipeline(cfg, 64, kv_int8=kv_int8, return_logits=True,
                                    sample_temperature=temperature)
    with _decoders_started() as started:
        runs = [fn(params, pixels, tb, ta, cuda_graph=g) for g in (True, True, False)]
    want_tokens, _, want_logits = runs[2]
    equal = [bool(torch.equal(tokens, want_tokens) and torch.equal(logits, want_logits))
             for tokens, _, logits in runs[:2]]
    graph_ms = _time_ms(lambda: _decode_again(*started[1]))
    eager_ms = _time_ms(lambda: _decode_again(*started[2]), reps=3)
    n = pipeline.MAX_NEW_TOKENS
    row = {"decode_graph_vs_eager": label, "temperature": temperature,
           "tokens_and_logits_bit_equal": equal, "tokens": want_tokens.flatten().tolist()[:8],
           "decode_ms_per_token_graph": graph_ms / n, "decode_ms_per_token_eager": eager_ms / n,
           "decode_steps": n, "unembeds_in_decode": n}
    log(json.dumps(row))
    if not all(equal):
        raise RuntimeError(f"{label}: graph decode differs from the eager loop ({row})")
    return row


def phase_requests():
    """The int8 serving model at 64, 16 and 128 frames and without the
    memory, then its fused configuration (the fused tower and the fused
    request, each beside the unfused one), then the bf16 model at 64 frames
    only (the bf16 path's 16- and 128-frame requests are left out to keep
    the run short); graph decode against the eager loop for the int8
    (greedy and sampled) and bf16 models. Returns each path's 64-frame
    launch counts, keyed by kernel."""
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
    int8_cfg = port_bench.serving_config("0.5b")
    int8_launches = _serve("int8", int8_cfg, int8_params, (64, 16, 128), gen, kv_int8=True)
    no_memory_launches = _serve("int8, no_memory", int8_cfg, int8_params, (64,), gen,
                                kv_int8=True, no_memory=True)
    _stage_times("int8", int8_cfg, int8_params, 64, gen, kv_int8=True)
    decode_rows = [_graph_vs_eager("int8", int8_cfg, int8_params, gen, kv_int8=True),
                   _graph_vs_eager("int8, sampled", int8_cfg, int8_params, gen, kv_int8=True,
                                   temperature=1.0)]
    fused_tower_launches = _fused_tower(int8_cfg, int8_params, gen)
    int8_scores_launches = _int8_scores_tower(int8_cfg, int8_params, gen)
    fused_request_launches = _fused_request(int8_cfg, int8_params, gen)
    with _fused_flags(swiglu=True):
        _stage_times("int8, fused_swiglu", int8_cfg, int8_params, 64, gen, kv_int8=True)
    with _fused_flags(oproj=True, swiglu=True):
        _stage_times("int8, fused_oproj and fused_swiglu", int8_cfg, int8_params, 64, gen,
                     kv_int8=True)
    bf16_launches = _serve("bf16", full, params, (64,), gen, kv_int8=False)
    _stage_times("bf16", full, params, 64, gen, kv_int8=False)
    decode_rows.append(_graph_vs_eager("bf16", full, params, gen, kv_int8=False))
    vlm.clear_decoders()
    del int8_params
    lively = _lively(params)
    del params
    generate_launches = phase_generate(int8_cfg, pipeline.int8_serving_params(lively), full,
                                       lively, gen, decode_rows)
    del lively
    torch.cuda.empty_cache()
    return {"int8_serving_64_frames": int8_launches, "bf16_64_frames": bf16_launches,
            "generate": generate_launches,
            "int8_serving_64_frames_no_memory": no_memory_launches,
            "int8_fused_oproj_tower_64_frames": fused_tower_launches,
            "int8_fused_swiglu_64_frames": fused_request_launches,
            "int8_scores_tower_64_frames": int8_scores_launches}


def phase_requests_7b():
    """`bench.py --model 7b` built by the port's bench functions (the int8
    tower, the 7B LM in int8 from `init_lm_7b_int8`, a bf16 untied lm_head
    and KV cache; the memory at head dim 448): a 64-frame request with its
    token accounting and launch counts (5 of flash_fwd_d448, 28 of
    flash_fwd, 26 of each int8 tower kernel), its stages timed, and graph
    decode against the eager loop. The 0.5B weights are freed before it
    loads. Returns the request's launch counts."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cfg = port_bench.serving_config("7b")
    t0 = time.perf_counter()
    params = port_bench.init_serving_params(cfg, "7b", False, "cuda")
    torch.cuda.synchronize()
    log(f"init 7B int8 serving params: {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GB")
    kv_int8 = port_bench.kv_int8("7b", False)
    launches = _serve("7b int8", cfg, params, (64,), gen, kv_int8=kv_int8)
    want = {"flash_fwd_d448": 5, "flash_fwd": 28, "fused_qkv_int8": 26,
            "flash_attention_merge_heads": 26, "fused_mlp_block_int8": 26}
    if any(launches[k] != n for k, n in want.items()):
        raise RuntimeError(f"7b request: launches {launches}, want {want}")
    _stage_times("7b int8", cfg, params, 64, gen, kv_int8=kv_int8)
    _graph_vs_eager("7b int8", cfg, params, gen, kv_int8=kv_int8)
    vlm.clear_decoders()
    del params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ generation

# the generation phase's clips: unequal spliced lengths (5524, 9444 and
# 15716 tokens: one, two and six segments)
GENERATE_CLIPS = (20, 64, 200)
# flash_fwd's B = 3 case runs its controls over the first this many queries
# and keys of each row (the one-tile control's score matrix at full length
# would take 41 GB; here 6.3 GB): row 0's valid length, 5524, falls inside
# it, so the controls meet a ragged batch and its padded rows
B3_CONTROL_ROWS = 6144
# every LM matrix of the generation phase's weights is scaled by this, as
# the CPU tests' "lively" LM: at init scale greedy repeats one token
LIVELY_SCALE = 5.0
# fewer distinct greedy tokens in 32 than this, and the checks that compare
# two runs' tokens would compare a near-constant sequence: the phase fails
MIN_DISTINCT_TOKENS = 8
GENERATE_NEW = 32
# below this top-2 margin a log-softmax's rounding can turn an argmax
GREEDY_TIE = 1e-4
# the most a row's logits may differ between generate_batched (B = 3, padded
# to the longest clip) and that row's own generate while their tokens agree.
# On the card (NVIDIA H100 80GB HBM3, 700 W) the lively weights' logits have
# a std of 3.0; most steps differ by exactly 0, a few by 0.1-2.27, and rows
# whose tokens have parted differ by 18-22, as mixed-up rows would
BATCHED_LOGIT_TOL = 6.0


def _spliced_len(cfg: VLMConfig, num_frames: int) -> int:
    """The spliced length `video_qa_embeds` gives a clip of num_frames."""
    f1 = len(vlm.sample_video_frames(num_frames))
    fmax = vlm.pad_frames_to_segment_multiple(f1, cfg.memory.segment_frames)
    nseg = min(fmax // cfg.memory.segment_frames, cfg.memory.cache_cap)
    return len(TEXT_BEFORE) + len(TEXT_AFTER) + _visual_tokens(cfg, f1, nseg)


def _qa_ids() -> np.ndarray:
    return np.array(TEXT_BEFORE + [constants.IMAGE_TOKEN_INDEX] + TEXT_AFTER, np.int64)


def _first_new(seq, start: int, width: int = 1) -> int:
    """The first step >= start whose last `width` tokens occur nowhere
    before it (a stop there fires at that step and no earlier), else the
    first such step from the start."""
    grams = [tuple(seq[i - width + 1:i + 1]) for i in range(len(seq))]
    for lo in (start, width - 1):
        for i in range(max(lo, width - 1), len(seq)):
            if grams[i] not in grams[width - 1:i]:
                return i
    raise RuntimeError(f"no step to stop at in {seq}")


def _margin(row: torch.Tensor) -> float:
    top2 = torch.topk(row.float(), 2).values
    return float(top2[0] - top2[1])


class _Counted:
    """Runs a path's calls with the launch counts reset around each, holds
    each call's counts to what it must launch, and sums them."""

    def __init__(self, label):
        self.label, self.total = label, dict.fromkeys(WRAPPERS, 0)

    def __call__(self, what, fn, want):
        _reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = _launches()
        want = {**dict.fromkeys(WRAPPERS, 0), **want}
        if got != want:
            raise RuntimeError(f"{self.label}, {what}: launches {got}, want {want}")
        for name, n in got.items():
            self.total[name] += n
        return out


def _qa_launches(cfg: VLMConfig, num_frames: int) -> dict:
    """video_qa_embeds of one clip: the tower's and the memory's launches of
    a request, without the LM prefill."""
    want = _expected_launches(cfg, len(vlm.sample_video_frames(num_frames)))
    want["flash_fwd"] -= cfg.lm.num_hidden_layers
    return want


def _clip_embeds(counted, cfg, params, gen, frame_counts):
    out = []
    for f0 in frame_counts:
        pixels = torch.randn((f0, 384, 384, 3), generator=gen, device="cuda").to(torch.bfloat16)
        emb = counted(f"video_qa_embeds, {f0} frames",
                      lambda: vlm.video_qa_embeds(params, cfg, pixels, _qa_ids()),
                      _qa_launches(cfg, f0))
        if emb.shape != (_spliced_len(cfg, f0), cfg.lm.hidden_size) or \
                not bool(torch.isfinite(emb).all()):
            raise RuntimeError(f"video_qa_embeds, {f0} frames: {tuple(emb.shape)} or non-finite")
        out.append(emb)
    return out


def _entry_ms(fn, prefill_ms: float, tokens: int, reps: int = 3) -> dict:
    """A whole call (CUDA events, median) and its decode ms/token, the
    prefill's time taken off."""
    ms = _time_ms(fn, reps=reps)
    return {"call_ms": ms, "decode_ms_per_token": (ms - prefill_ms) / tokens}


def _graph_and_eager(label, run) -> tuple:
    """`run(cuda_graph)` -> (GenerateResult, logits rows) twice through the
    captured chunk (the capture, then a replay of it) and once eagerly on
    the card: tokens, counts and the logits of every step bit-equal."""
    (a, rows_a), (b, rows_b), (c, rows_c) = run(True), run(True), run(False)
    equal = [bool(torch.equal(x.tokens, c.tokens) and torch.equal(x.num_tokens, c.num_tokens)
                  and torch.equal(r, rows_c)) for x, r in ((a, rows_a), (b, rows_b))]
    if not all(equal):
        raise RuntimeError(f"{label}: graph decode differs from the eager loop {equal}")
    return a, rows_a


def _greedy_agreement(label, tokens_a, rows_a, tokens_b, rows_b, bound: float) -> dict:
    """Two greedy runs of one prompt whose logits differ by rounding: their
    logits must differ by at most `bound` at every step while their tokens
    agree, and their tokens must agree at every step whose top-2 margin
    (run a's) exceeds the largest logit difference seen so far; from the
    first near-tie on either may take either token and the runs part.
    Returns the share of steps held."""
    diff, held = 0.0, 0
    n = len(tokens_a)
    for t in range(n):
        diff = max(diff, float((rows_a[t] - rows_b[t]).abs().max()))
        if not diff <= bound:
            raise RuntimeError(f"{label}: logits differ by {diff} > {bound} at step {t}")
        if _margin(rows_a[t]) <= diff:
            break
        if int(tokens_a[t]) != int(tokens_b[t]):
            raise RuntimeError(f"{label}: token {t} differs ({tokens_a.tolist()} vs "
                               f"{tokens_b.tolist()}) at margin {_margin(rows_a[t])} > {diff}")
        held += 1
    return {"steps_held": held, "share_held": held / n, "max_logit_diff": diff, "bound": bound}


def _lively(params):
    """`params` with every LM matrix (ndim >= 2) times LIVELY_SCALE."""
    def scale(x):
        if isinstance(x, dict):
            return {k: scale(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(scale(v) for v in x)
        return x * LIVELY_SCALE if x.ndim >= 2 else x
    return dict(params, language_model=scale(params["language_model"]))


def phase_generate(cfg, params, bf16_cfg, bf16_params, gen, decode_rows):
    """The generation surface at full width: `video_qa_embeds` of a 20-, a
    64- and a 200-frame clip on the 0.5B int8 serving weights (int8 tower
    and LM, bf16 cache, as JAX's generate), then `generate` (greedy and
    sampled, graph against eager bit for bit; sampled with an eos and a
    stop sequence taken from its own tokens, which vary where greedy ones
    may repeat), `generate_batched` over the three clips,
    `generate_stream`, `generate_speculative`, `score_continuation` and
    `beam_search` (K = 1 against greedy, K = 4), each call's launches held
    (#1 24 per prefill, the tower's three int8 kernels 26 each and the
    memory's #1 per clip, none from forward_chunk); then a bf16 greedy run.
    Times each entry beside the pipeline's decode ms/token (`decode_rows`,
    the same decoder with an int8 cache). The weights' LM matrices are
    `_lively`. Returns the path's launch counts."""
    counted = _Counted("generate")
    n = GENERATE_NEW
    lm = params["language_model"]
    prefill = {"flash_fwd": cfg.lm.num_hidden_layers}
    clips = _clip_embeds(counted, cfg, params, gen, GENERATE_CLIPS)
    emb = clips[1]

    def greedy(embeds, cuda_graph=True, **kw):
        return vlm.generate(params, cfg, embeds, max_new_tokens=n, eos_token_ids=(),
                            return_logits=True, cuda_graph=cuda_graph, **kw)

    free, free_rows = _graph_and_eager("generate, greedy", lambda g: counted(
        "generate", lambda: greedy(emb, g), prefill))
    toks = free.tokens.tolist()
    if len(set(toks)) < MIN_DISTINCT_TOKENS:
        raise RuntimeError(f"generate, greedy: {len(set(toks))} distinct tokens {toks}")
    # sampled (the default seeded generator, so every call draws the same
    # noise), and with an eos and a stop sequence taken from those tokens,
    # which vary where random weights' greedy tokens may repeat one
    sampling = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.1)
    sampled, _ = _graph_and_eager("generate, sampled", lambda g: counted(
        "generate, sampled", lambda: greedy(emb, g, **sampling), prefill))
    drawn = sampled.tokens.tolist()
    i_eos, j_stop = _first_new(drawn, 12), _first_new(drawn, 6, width=2)
    stops = dict(sampling, eos_token_ids=(drawn[i_eos],),
                 stop_sequences=((drawn[j_stop - 1], drawn[j_stop]),
                                 (cfg.lm.vocab_size, cfg.lm.vocab_size + 1)))
    stopped = counted("generate, sampled, eos and stop", lambda: vlm.generate(
        params, cfg, emb, max_new_tokens=n, **stops), prefill)
    num = min(i_eos, j_stop) + 1
    if int(stopped.num_tokens) != num or stopped.tokens.tolist() != drawn[:num] + [0] * (n - num):
        raise RuntimeError(f"generate with eos at {i_eos} and a stop at {j_stop}: "
                           f"{stopped.tokens.tolist()}, num {int(stopped.num_tokens)}")

    # the prefill alone, to take off each entry's time
    padded = F.pad(emb, (0, 0, 0, -(-emb.shape[0] // 128) * 128 - emb.shape[0]))[None]
    valid = torch.tensor([emb.shape[0]], dtype=torch.int32, device="cuda")
    prefill_ms = _time_ms(lambda: vlm._prefill(lm, cfg, padded, valid,
                                               cache_max_len=padded.shape[1] + n), reps=3)
    def plain(embeds, model=params, model_cfg=cfg, cuda_graph=True):
        return vlm.generate(model, model_cfg, embeds, max_new_tokens=n, eos_token_ids=(),
                            cuda_graph=cuda_graph)

    times = {"prefill_ms": prefill_ms,
             "pipeline_decode_ms_per_token": {
                 r["decode_graph_vs_eager"]: r["decode_ms_per_token_graph"] for r in decode_rows},
             "generate_graph": _entry_ms(lambda: plain(emb), prefill_ms, n),
             "generate_eager": _entry_ms(lambda: plain(emb, cuda_graph=False), prefill_ms, n,
                                         reps=2)}

    # generate_batched: the three clips right-padded to one length, B = 3
    smax = -(-max(e.shape[0] for e in clips) // 128) * 128
    batch = torch.stack([F.pad(e, (0, 0, 0, smax - e.shape[0])) for e in clips])
    lens = torch.tensor([e.shape[0] for e in clips], dtype=torch.int32, device="cuda")

    def batched():
        return vlm.generate_batched(params, cfg, batch, lens, max_new_tokens=n,
                                    eos_token_ids=(), return_logits=True)

    out_b, rows_b = counted("generate_batched", batched, prefill)
    agreement = {}
    for r, e in enumerate(clips):
        single, rows_s = (free, free_rows) if r == 1 else counted(
            f"generate, clip {r}", lambda e=e: greedy(e), prefill)
        agreement[GENERATE_CLIPS[r]] = _greedy_agreement(
            f"generate_batched row {r}", single.tokens, rows_s, out_b.tokens[r], rows_b[:, r],
            BATCHED_LOGIT_TOL)
    times["generate_batched_b3_ms"] = _time_ms(batched, reps=3)

    # generate_stream: the chunks put together are generate's tokens
    chunks = counted("generate_stream", lambda: list(vlm.generate_stream(
        params, cfg, emb, max_new_tokens=n, **stops)), prefill)
    if np.concatenate(chunks).tolist() != drawn[:num]:
        raise RuntimeError(f"generate_stream: {[c.tolist() for c in chunks]} vs {drawn[:num]}")

    # speculative: greedy's tokens, or a departure at a margin inside the
    # measured forward_chunk-vs-decode_step difference (the corpus, the
    # prompt's text ids, proposes no accepted draft). Then again with its
    # own tokens added to the corpus: their drafts are accepted, in fewer
    # iterations, and accepting them changes no token (a verified row sees
    # the same prefix in the same arithmetic)
    def speculative(corpus=()):
        return vlm.generate_speculative(params, cfg, emb,
                                        draft_ids=TEXT_BEFORE + TEXT_AFTER + list(corpus),
                                        max_new_tokens=n, eos_token_ids=(), spec_k=4)

    spec, info = counted("generate_speculative", speculative, prefill)
    _, cache = counted("prefill for forward_chunk", lambda: vlm._prefill(
        lm, cfg, padded, valid, cache_max_len=padded.shape[1] + n), prefill)
    chunk_emb = qwen2.embed_tokens(lm, free.tokens[None].long()).to(emb.dtype)
    hidden, _ = counted("forward_chunk", lambda: qwen2.forward_chunk(
        lm, cfg.lm, chunk_emb, cache, emb.shape[0]), {})
    chunk_diff = float((qwen2.unembed(lm, hidden)[0, :-1] - free_rows[1:]).abs().max())
    spec_toks = spec.tokens.tolist()
    first_diff = next((t for t in range(n) if spec_toks[t] != toks[t]), None)
    again, info_again = counted("generate_speculative, its own tokens in the corpus",
                                lambda: speculative(spec_toks), prefill)
    row = {"speculative": "spec_k 4, corpus the prompt's text ids", "tokens_equal_greedy":
           first_diff is None, "iterations": info["iterations"],
           "mean_accepted": int(spec.num_tokens) / info["iterations"],
           "forward_chunk_vs_decode_step_max_logit_diff": chunk_diff,
           "own_tokens_in_corpus": {
               "tokens_equal": again.tokens.tolist() == spec_toks,
               "iterations": info_again["iterations"],
               "mean_accepted": int(again.num_tokens) / info_again["iterations"]}}
    if first_diff is not None:
        row.update(first_differing_step=first_diff, margin=_margin(free_rows[first_diff]))
        if not row["margin"] <= chunk_diff:
            log(json.dumps(row))
            raise RuntimeError(f"generate_speculative departs from greedy off a near-tie: {row}")
    log(json.dumps(row))
    if again.tokens.tolist() != spec_toks or not info_again["iterations"] < info["iterations"]:
        raise RuntimeError(f"generate_speculative with its own tokens as drafts: {row}")
    times["speculative"] = _entry_ms(speculative, prefill_ms, n, reps=2)
    times["speculative_own_tokens_in_corpus"] = _entry_ms(lambda: speculative(spec_toks),
                                                          prefill_ms, n, reps=2)

    # score_continuation of the greedy continuation
    full = torch.cat([emb, qwen2.embed_tokens(lm, free.tokens.long()).to(emb.dtype)])
    total, is_greedy = counted("score_continuation", lambda: vlm.score_continuation(
        params, cfg, full, free.tokens.cpu().numpy()), prefill)
    fpad = F.pad(full, (0, 0, 0, -(-full.shape[0] // 128) * 128 - full.shape[0]))[None]
    hidden, _ = counted("prefill of the continuation", lambda: qwen2.forward(
        lm, cfg.lm, fpad, torch.arange(fpad.shape[1], device="cuda")[None],
        valid_len=torch.tensor([full.shape[0]], dtype=torch.int32, device="cuda"),
        need_cache=False), prefill)
    logits_p = qwen2.unembed(lm, hidden[0, emb.shape[0] - 1:full.shape[0] - 1])
    idx = free.tokens.long()[:, None]
    total_p = float(torch.log_softmax(logits_p, -1).gather(1, idx).sum())
    total_g = float(torch.log_softmax(free_rows, -1).gather(1, idx).sum())
    score_diff = float((logits_p - free_rows).abs().max())
    flips = [t for t in range(n) if int(logits_p[t].argmax()) != toks[t]]
    row = {"score_continuation": total, "greedy": is_greedy, "from_its_prefill": total_p,
           "from_the_graphs_logits": total_g, "prefill_vs_decode_max_logit_diff": score_diff,
           "steps_whose_prefill_argmax_differs": flips}
    log(json.dumps(row))
    if not abs(total - total_p) <= 1e-5 * abs(total_p):
        raise RuntimeError(f"score_continuation is not its prefill's log-softmax: {row}")
    if not abs(total - total_g) <= 2 * n * score_diff:
        raise RuntimeError(f"score_continuation and the graph's logits disagree: {row}")
    if is_greedy != (not flips) or any(_margin(free_rows[t]) > score_diff for t in flips):
        raise RuntimeError(f"score_continuation's greedy flag is off a near-tie: {row}")

    # beam search: one beam is greedy, four run
    beam1 = counted("beam_search K=1", lambda: beam_search.beam_search(
        params, cfg, emb, num_beams=1, max_new_tokens=n, eos_token_ids=()), prefill)
    ties = [t for t in range(n) if _margin(free_rows[t]) <= GREEDY_TIE]
    held = ties[0] if ties else n
    if beam1.tolist()[:held] != toks[:held]:
        raise RuntimeError(f"beam_search K=1 {beam1.tolist()} is not greedy {toks}")

    def beam4():
        return beam_search.beam_search(params, cfg, emb, num_beams=4, max_new_tokens=n,
                                       eos_token_ids=())

    beam = counted("beam_search K=4", beam4, prefill)
    if len(beam) != n or not ((beam >= 0) & (beam < cfg.lm.vocab_size)).all():
        raise RuntimeError(f"beam_search K=4: {beam.tolist()}")
    times["beam_k1"] = _entry_ms(lambda: beam_search.beam_search(
        params, cfg, emb, num_beams=1, max_new_tokens=n, eos_token_ids=()), prefill_ms, n, 2)
    times["beam_k4"] = _entry_ms(beam4, prefill_ms, n, reps=2)

    # the bf16 model, greedy: graph against eager
    (emb16,) = _clip_embeds(counted, bf16_cfg, bf16_params, gen, (64,))

    def greedy16(cuda_graph=True):
        return vlm.generate(bf16_params, bf16_cfg, emb16, max_new_tokens=n, eos_token_ids=(),
                            return_logits=True, cuda_graph=cuda_graph)

    free16, _ = _graph_and_eager("generate, bf16", lambda g: counted(
        "generate, bf16", lambda: greedy16(g), prefill))
    pad16 = F.pad(emb16, (0, 0, 0, -(-emb16.shape[0] // 128) * 128 - emb16.shape[0]))[None]
    valid16 = torch.tensor([emb16.shape[0]], dtype=torch.int32, device="cuda")
    prefill16 = _time_ms(lambda: vlm._prefill(bf16_params["language_model"], bf16_cfg, pad16,
                                              valid16, cache_max_len=pad16.shape[1] + n), reps=3)
    times["generate_bf16_graph"] = _entry_ms(
        lambda: plain(emb16, bf16_params, bf16_cfg), prefill16, n)
    times["generate_bf16_eager"] = _entry_ms(
        lambda: plain(emb16, bf16_params, bf16_cfg, cuda_graph=False), prefill16, n, reps=2)
    log(json.dumps({"generate": "0.5B int8 weights, bf16 cache; 64-frame clip unless named",
                    "spliced": [e.shape[0] for e in clips], "tokens": toks[:12],
                    "sampled_tokens": drawn[:12], "eos_step": i_eos, "stop_step": j_stop,
                    "num_with_stops": num,
                    "stream_chunks": [len(c) for c in chunks],
                    "batched_agreement_by_clip_frames": agreement,
                    "beam_k4_tokens": beam.tolist()[:12],
                    "bf16_tokens": free16.tokens.tolist()[:12],
                    "times": times, "launches": counted.total}))
    vlm.clear_decoders()
    return counted.total


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"latency_s", "visual_tokens", "frames", "segments", "decode_tokens",
                     "backend"}


def phase_entry_point():
    """`python -m memory_augmented_vlm_torch.bench` in a subprocess, with no
    flags and with `--model 7b`: its last line parses as bench.py's JSON
    (less the relay fields), with bench.py's metric name, three listed
    repetitions, backend cuda and the card."""
    for args, model in (([], "0.5b"), (["--model", "7b"], "7b")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "memory_augmented_vlm_torch.bench", *args],
                              capture_output=True, text=True, timeout=600,
                              cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            raise RuntimeError(f"bench {args} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        out = json.loads(line)
        detail = out.get("detail", {})
        if (set(out) != BENCH_KEYS or not BENCH_DETAIL_KEYS <= set(detail)
                or out["metric"] != port_bench.metric_name(64, model)
                or detail["backend"] != "cuda" or len(detail["latency_s_reps"]) != 3
                or not (math.isfinite(out["value"]) and out["value"] > 0)):
            raise RuntimeError(f"bench {args}: unexpected line {line}")
        log(f"bench {' '.join(args) or '(default)'} ({time.perf_counter() - t0:.1f} s): {line}")


BENCH_TRAIN_DETAIL_KEYS = {"frames", "segments", "all_times", "compile_s", "loss_first",
                           "loss_last", "baseline_modeled_s", "peak_memory_gb", "card"}


def phase_bench_train():
    """`python -m memory_augmented_vlm_torch.bench_train` in a subprocess, as
    `--iters 2` (64 frames) and `--frames 300 --iters 1` (10 segments, the
    ring cache's cap): its last line parses as bench_train.py's JSON less
    `impl`, `staged`, `backend` and `vs_baseline_iso_peak`, with its metric
    name, one time per iteration and finite losses."""
    for args, frames, iters in ((["--iters", "2"], 64, 2),
                                (["--frames", "300", "--iters", "1"], 300, 1)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "memory_augmented_vlm_torch.bench_train",
                               *args], capture_output=True, text=True, timeout=600,
                              cwd=Path(__file__).resolve().parent)
        if proc.returncode != 0:
            raise RuntimeError(f"bench_train {args} exited {proc.returncode}:\n"
                               f"{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        out = json.loads(line)
        detail = out.get("detail", {})
        if (set(out) != BENCH_KEYS or set(detail) != BENCH_TRAIN_DETAIL_KEYS
                or out["metric"] != port_bench_train.metric_name(frames)
                or detail["frames"] != frames or len(detail["all_times"]) != iters
                or not all(math.isfinite(detail[k]) for k in ("loss_first", "loss_last"))
                or not (math.isfinite(out["value"]) and out["value"] > 0)):
            raise RuntimeError(f"bench_train {args}: unexpected line {line}")
        log(f"bench_train {' '.join(args)} ({time.perf_counter() - t0:.1f} s): step "
            f"{detail['all_times']} s, peak {detail['peak_memory_gb']:.3f} GB: {line}")


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
    vlm.clear_decoders()


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


def _step_grads(step, state, batch):
    """One train step from `state`, keeping the gradients it computes:
    (metrics, [(path, gradient)])."""
    captured = []
    inner = trainer.value_and_grad_params

    def capture(*args, **kwargs):
        out = inner(*args, **kwargs)
        captured.append(out[1])
        return out

    trainer.value_and_grad_params = capture
    try:
        _, metrics = step(state, batch)
    finally:
        trainer.value_and_grad_params = inner
    return metrics, _leaves(captured[-1])


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A checksum of a tensor's raw bits (int64, on its device)."""
    x = x.detach()
    if x.is_floating_point():
        x = x.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
    return x.to(torch.int64).sum() if x.numel() else torch.zeros((), dtype=torch.int64,
                                                                   device=x.device)


def _op_trace(fn):
    """Run `fn` and record every aten op it dispatches with checksums of its
    tensor inputs and outputs: [(op, [input sums], [output sums])]. Ops that
    only allocate are skipped (their memory is uninitialised)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    trace = []

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if "empty" not in name:
                trace.append((name, [_bits(x) for x in tree_leaves((args, kwargs))
                                     if isinstance(x, torch.Tensor)],
                              [_bits(x) for x in tree_leaves(out) if isinstance(x, torch.Tensor)]))
            return out

    with Trace():
        fn()
    return [(name, [int(x) for x in ins], [int(x) for x in outs]) for name, ins, outs in trace]


def _first_divergent_op(fn) -> dict:
    """Run `fn` twice and name the first op whose outputs differ. If its
    inputs differ too, they came from outside the dispatcher: one of the
    port's ctypes kernels, launched just before it."""
    first, second = _op_trace(fn), _op_trace(fn)
    for i, ((name, ins_a, outs_a), (name_b, ins_b, outs_b)) in enumerate(zip(first, second)):
        if name != name_b:
            return {"op_index": i, "op": name, "other_run": name_b, "finding": "op order differs"}
        if outs_a != outs_b:
            return {"op_index": i, "ops": len(first), "op": name, "inputs_equal": ins_a == ins_b,
                    "finding": "this op is not deterministic" if ins_a == ins_b else
                    "its inputs differ: they come from a kernel outside the dispatcher"}
    return {"ops": len(first), "finding": "every op's output repeated"}


def _check_step_determinism(step, state, batch) -> list:
    """Two train steps from the same state and batch must give equal losses
    and gradient leaves, bit for bit; then two more under
    torch.use_deterministic_algorithms(True) (warn_only: cuBLAS is not
    configured for it, and the check is of the port's own ops). If a pair
    differs, name the first op whose output differs
    (`_first_divergent_op`) and raise."""
    rows = []
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            (m0, g0), (m1, g1) = [_step_grads(step, state, batch) for _ in range(2)]
            differ = [name for (name, a), (_, b) in zip(g0, g1) if not torch.equal(a, b)]
            row = {"train_determinism": "two steps from one state and batch",
                   "use_deterministic_algorithms": deterministic,
                   "loss": [float(m0["loss"]), float(m1["loss"])], "grad_leaves": len(g0),
                   "leaves_differing": len(differ), "first_leaves_differing": differ[:5]}
            if differ or not torch.equal(m0["loss"], m1["loss"]):
                row["first_divergent_op"] = _first_divergent_op(lambda: step(state, batch))
                log(json.dumps(row))
                raise RuntimeError(f"the train step is not bit-reproducible: {row}")
        finally:
            torch.use_deterministic_algorithms(False)
        log(json.dumps(row))
        rows.append(row)
    return rows


def _kernel_category(name: str) -> str:
    n = name.lower()
    for key, label in (("bwd_dkv", "flash_bwd_dkv"), ("dkv_group_sum", "flash_bwd_dkv"),
                       ("bwd_dq", "flash_bwd_dq"),
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
    attn_bwd = by_kind.get("flash_bwd_dq", 0.0) + by_kind.get("flash_bwd_dkv", 0.0)
    return state, {"wall_s": wall, "kernels": len(spans), "device_busy_s": busy / 1e6,
                   "device_idle_share": 1.0 - busy / 1e6 / wall,
                   "attention_backward_share_of_busy": attn_bwd / (busy / 1e3),
                   "kernel_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))}


def phase_train():
    """Four full-width bf16 train steps of bench_train.py's configuration on
    distinct seeded batches, then one more with its stages synchronised and
    one under the profiler. Returns the per-step launch counts."""
    dev = "cuda"
    cfg = VLMConfig.onevision_0_5b()
    opt = port_bench_train.optimizer_config()  # step 0 runs at lr 0
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
    batch = _train_batch(rng, cfg, TRAIN_FRAMES, cfg.memory.num_fine_frames, dev, torch.bfloat16)
    _check_step_determinism(step, state, batch)
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
    opt = port_bench_train.optimizer_config()  # step 0 runs at lr 0
    step = trainer.make_train_step(cfg, opt, nseg=2)
    results = {}
    for dev in ("cuda", "cpu"):
        batch = _train_batch(np.random.default_rng(7), cfg, 40, 8, dev, torch.float32)
        state = trainer.init_train_state(_to_cuda(params) if dev == "cuda" else params, opt)
        _reset_launches()
        t0 = time.perf_counter()
        metrics, grads = _step_grads(step, state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            if _launches() != _expected_train_launches(cfg, 40):
                raise RuntimeError(f"train parity: launches {_launches()}")
        results[dev] = (metrics, grads, time.perf_counter() - t0)
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


# ---------------------------------------------------------------- loading

LOAD_FRAMES = 64
LOAD_FRAME_HW = (480, 640)  # a camera frame, resized by the host processor
LOAD_SEED = 3


class _PeakRss:
    """The process's peak resident set while the block runs, sampled every
    5 ms, in GB: VmRSS (/proc/self/status), and resident less shared pages
    (/proc/self/statm), which leaves out the pages of a mapped file where
    the kernel counts them as shared."""

    def __enter__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self._read()
        self.peak = dict(self.before)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> dict:
        with open("/proc/self/statm") as f:
            _, resident, shared = (int(v) for v in f.read().split()[:3])
        with open("/proc/self/status") as f:
            vmrss = next(int(line.split()[1]) * 1024 for line in f
                         if line.startswith("VmRSS:"))
        return {"rss": vmrss, "unshared": (resident - shared) * self.page}

    def _run(self):
        while not self._stop.wait(0.005):
            now = self._read()
            for k in self.peak:
                self.peak[k] = max(self.peak[k], now[k])

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def report(self) -> dict:
        return {"peak_rss_gb": self.peak["rss"] / 1e9, "rss_gb_before": self.before["rss"] / 1e9,
                "peak_unshared_gb": self.peak["unshared"] / 1e9,
                "unshared_gb_before": self.before["unshared"] / 1e9}


def _loaded_leaves_equal(label, got, want):
    """Every leaf of the loaded params bit-equal to the source's, same paths
    and dtypes."""
    a, b = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    if a.keys() != b.keys():
        raise RuntimeError(f"{label}: leaves differ: {sorted(map(path_str, set(a) ^ set(b)))}")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            raise RuntimeError(f"{label}: {path_str(k)} differs from the source "
                               f"({a[k].dtype} vs {b[k].dtype})")
    return len(a)


def _load_case(label, ckpt, nbytes, cfg, source, ids, frames, processor, load_8bit, want):
    """`load_pretrained_model(ckpt)` (bf16, or `load_8bit`): its leaves held
    to `source` bit for bit, its `generate` on the clip's uint8 frames to
    the same request from `source` (the host processor, `video_qa_embeds`,
    `vlm.generate`) token for token, its launches counted; both timed."""
    counted = _Counted(label)
    torch.cuda.synchronize()
    with _PeakRss() as rss:
        t0 = time.perf_counter()
        tokenizer, model, image_processor, context_len = load_pretrained_model(
            ckpt, load_8bit=load_8bit)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    side = cfg.vision.image_size
    if tokenizer is not None or image_processor.size != (side, side) or \
            context_len != cfg.lm.max_position_embeddings or model.cfg != cfg:
        raise RuntimeError(f"{label}: tokenizer {tokenizer}, processor {image_processor.size}, "
                           f"context {context_len}, config {model.cfg}")
    leaves = _loaded_leaves_equal(label, model.params, source)

    def loaded():
        return model.generate(ids, images=[frames], modalities=["video"],
                              max_new_tokens=GENERATE_NEW)

    def in_memory():
        pixels = processor.preprocess(frames)
        emb = vlm.video_qa_embeds(source, cfg, pixels, ids[0])
        out = vlm.generate(source, cfg, emb, max_new_tokens=GENERATE_NEW)
        return out.tokens[:int(out.num_tokens)].cpu().numpy()

    got = counted("generate", loaded, want)[0]
    ref = in_memory()
    if got.tolist() != ref.tolist():
        raise RuntimeError(f"{label}: loaded tokens {got.tolist()} != in-memory {ref.tolist()}")
    if len(set(got.tolist())) < MIN_DISTINCT_TOKENS:
        raise RuntimeError(f"{label}: {len(set(got.tolist()))} distinct tokens in {got.tolist()}")
    t0 = time.perf_counter()
    processor.preprocess(frames)
    processor_ms = 1e3 * (time.perf_counter() - t0)
    row = {"load": label, "load_s": load_s, "gb_read_per_s": nbytes / 1e9 / load_s,
           **rss.report(), "leaves_bit_equal": leaves, "launches": counted.total,
           "tokens": got.tolist(), "generate_ms": _time_ms(loaded, reps=3),
           "in_memory_ms": _time_ms(in_memory, reps=3), "host_processor_ms": processor_ms}
    log(json.dumps(row))
    del model
    vlm.clear_decoders()
    return counted.total


def phase_load():
    """Loading at full width: the 0.5B model's seeded bf16 params (LM
    matrices times 5, `_lively`) exported with the port's
    `export_hf_safetensors` under build/ (fp32, ~3.6 GB), then
    `load_pretrained_model` of it in bf16 and with `load_8bit`. The loaded
    leaves equal the source's bit for bit (bf16 -> fp32 -> bf16 is exact;
    with `load_8bit`, `siglip.prequantize_int8` and `qwen2.prequantize_int8`
    of the source on the card); `model.generate` of a 64-frame 480x640
    uint8 clip, written as y4m and read back through `data/video.load_video`
    (the native frame loader, built first, decodes it), gives the same 32
    tokens as the in-memory request, with flash_fwd 55 launches in bf16 and
    fused_qkv_int8 / flash_attention_merge_heads / fused_mlp_block_int8 26
    each and flash_fwd 29 with load_8bit. Prints the export and load times,
    GB read per s, the peak host RSS during each load and each generate's ms
    beside the in-memory request's. Deletes the checkpoint. Returns each
    load's launch counts."""
    log(f"load phase on {require_card()}")
    t0 = time.perf_counter()
    lib = native_loader.build()
    log(f"native frame loader: {lib.name}, {time.perf_counter() - t0:.2f} s")
    cfg = VLMConfig.onevision_0_5b()
    source = _lively(vlm.init_params(cfg, seed=LOAD_SEED, device="cuda", dtype=torch.bfloat16))
    ckpt = Path(__file__).resolve().parent / "build" / f"load_phase_{LOAD_SEED}"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = export_hf_safetensors(source, cfg, str(ckpt))
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    rng = np.random.default_rng(LOAD_SEED)
    clip = rng.integers(0, 256, (LOAD_FRAMES, *LOAD_FRAME_HW, 3), dtype=np.uint8)
    write_y4m(str(ckpt / "clip.y4m"), clip, fps=30)
    frames, _, _, num = load_video(str(ckpt / "clip.y4m"), frames_upbound=LOAD_FRAMES,
                                   force_sample=True)
    if frames.shape != (LOAD_FRAMES, *LOAD_FRAME_HW, 3) or num != LOAD_FRAMES:
        raise RuntimeError(f"load_video: {frames.shape}, {num} frames")
    log(json.dumps({"export_s": export_s, "checkpoint_gb": nbytes / 1e9,
                    "export_gb_per_s": nbytes / 1e9 / export_s,
                    "parameters": sum(x.numel() for _, x in leaves_with_path(source))}))
    ids = _qa_ids()[None]
    processor = SigLipImageProcessor(size=(cfg.vision.image_size, cfg.vision.image_size))
    tower, lm = cfg.vision.num_used_layers, cfg.lm.num_hidden_layers
    memory = _memory_calls(cfg, LOAD_FRAMES)
    launches = {"load_bf16": _load_case(
        "bf16", str(ckpt), nbytes, cfg, source, ids, frames, processor, False,
        {"flash_fwd": tower + memory + lm})}
    int8_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     tower_int8=True))
    int8_source = {**source, "vision_tower": siglip.prequantize_int8(source["vision_tower"]),
                   "language_model": qwen2.prequantize_int8(source["language_model"])}
    launches["load_int8"] = _load_case(
        "int8", str(ckpt), nbytes, int8_cfg, int8_source, ids, frames, processor, True,
        {"fused_qkv_int8": tower, "flash_attention_merge_heads": tower,
         "fused_mlp_block_int8": tower, "flash_fwd": memory + lm})
    shutil.rmtree(ckpt)
    del source, int8_source
    torch.cuda.empty_cache()
    return launches


def main():
    phase_card()
    phase_build()
    train_kernels, flash_backward = phase_train_kernels()
    kernels = [*phase_flash_kernel(), *phase_int8_kernels(), *phase_fused_kernels(),
               *train_kernels, *phase_int8_attn_kernels()]
    kernels[0]["backward"] = flash_backward
    chain_launches = phase_chain()
    attn_block_launches = phase_attn_block()
    microbench_launches = phase_microbench()
    launches = phase_requests()
    launches["7b_int8_64_frames"] = phase_requests_7b()
    launches.update(phase_load())
    phase_entry_point()
    launches["int8_mlp_chain"] = chain_launches
    launches["attn_block"] = attn_block_launches
    launches.update(microbench_launches)
    launches["train_step"] = phase_train()
    phase_bench_train()
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
