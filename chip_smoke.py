#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`memory_augmented_vlm_torch`).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and the CUDA toolkit (`nvcc`); it
builds the kernels from `memory_augmented_vlm_torch/csrc` first. Phases,
each of which raises on failure:

  1. card     — name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
  2. build    — compile the kernels (one nvcc per source, in parallel), print
                the build time and ptxas report (kept beside a cached
                library), and fail if ptxas spills, ignores setmaxnreg
                (C7508) or serialises wgmma (C7512, C7514, C7515, C7520, ...)
                in the Hopper flash kernels at head dims 256 and 448, or
                spills in any head dim's instance of the fp32 3xTF32 kernel
                (`PTXAS_CLEAN`);
  3. kernels  — every kernel against its plain PyTorch version on the card,
                at the shapes of the main paths and at edge cases, with the
                kernel's, the plain version's and a library call's times
                (CUDA events, median of 5) and the card's bound: flash_fwd
                at the tower's, the memory's and both LMs' prefill shapes
                (the 7B's 28 heads of 128 over 4 KV heads among them), and
                flash_fwd_d448 (the wide kernel, head dim 448) at the 7B
                memory's fuse and evolve shapes, SDPA's kernels named, and
                at edge cases (valid length 0 and 1, 65 rows, two batches of
                unequal valid length, causal GQA, an even number of key
                tiles so that both warpgroups score), flash_fwd_d256 (the same
                kernel at head dim 256: Gemma-2B's memory and LM prefill,
                held in the Gemma phase below at the shapes its requests
                gave it, and at edge cases of GQA 8 and 1, valid lengths off
                the tile, 40 query rows, B = 2), and at generate_batched's
                prefill (three rows of 15744, valid 5524, 9444 and 15716,
                causal GQA 14/2), and at the anyres image path's tower
                (16 tiles of 729) and prefill (7296 rows, valid 7284), and at
                the serving engine's prefill (1536 rows, valid 1500); the three
                training kernels at the LM's train shape (S = 9557, causal,
                GQA 14/2; dQ and dK/dV also run twice for the same bits and
                beside three neighbouring functions that must fail their
                check) and at Gemma-2B's (S = 9557, 8 heads of 256 over one
                KV head; their own wrappers flash_fwd_lse_d256,
                flash_bwd_dq_d256 and flash_bwd_dkv_d256, the same checks
                and controls, and dK/dV with the column halves of Q and dO
                swapped), each timed beside SDPA, and at edge cases in bf16
                and fp32 (B = 2 with a valid length of 0, cross attention,
                fp32 cuts at 64 and 256, 540 rows at 256, whose last dQ item
                leaves its upper warpgroup idle), and #9-#11 in fp32 timed at
                the LM shapes of the three fp32 parity cuts (0.5B: 14 heads of
                64 over 2; Gemma-2B: 8 of 256 over 1; 7B: 28 of 128 over 4)
                beside SDPA in fp32; #1's fp32 kernel (csrc/flash_fwd.cu,
                3xTF32 on the tensor cores) at every head dim, timed beside
                its plain version and SDPA in fp32 with TF32 off, with
                bounds at the 3xTF32 rate and at the fp32 peak: the tower
                (72), the 0.5B memory's fuse and evolve (112), an fp32 LM
                prefill at 64 and 128, and as flash_fwd_d256_f32 and
                flash_fwd_d448_f32 the memory's fuse and evolve of Gemma-2B
                (256) and the 7B (448); at each head dim causal GQA with a
                ragged batch, a cross case with a batch of valid length 0 and
                65 query rows; each case held to the plain version at
                F32_ATOL + F32_RTOL, and the same check failing a
                single-TF32 form of the kernel's products (a control); the
                backward
                of flash_fwd at the memory's fuse shape, flash_fwd, the
                three int8 kernels of the default tower, the four of the
                fused configuration and the w8a8 layer (int8_matmul,
                fused_mlp_int8, fused_swiglu_block_int8,
                flash_attention_out_proj_int8; the default tower's three
                also at the image path's 16 and 5 tiles, 11664 and 3645
                rows, the 16 timed with their controls), and the four of the
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
                micro-benchmarks (int8 GEMM TOP/s, GEMV chain GB/s; the GEMV
                chain's CUDA graph holds one gemv kernel node per product,
                counted from the captured graph itself, and its replay's
                output equals the eager chain's bit for bit; the profiler's
                record of one replay, how many consecutive products overlap,
                is logged);
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
                decode against the eager loop. Then Gemma-2B
                (`phase_requests_gemma`): the repo's VLM with google/gemma-2b's
                published LM widths (18 layers, 8 heads of 256 over one KV
                head, vocabulary 256000, GELU, `1 + w` norms, scaled
                embeddings; built by `eval.builder.config_from_json` from a
                llava_gemma config, random weights, LM matrices times 5)
                answers a 64-frame clip through `vlm.clip_embeds` and
                `vlm.generate` in bf16 and in the load_8bit form (int8
                tower, int8 LM and unembedding, int8 KV cache): 23 launches
                of flash_fwd_d256 a request (5 in the memory, 18 in the
                prefill), graph decode against the eager loop bit for bit,
                stages timed; #1 at head dim 256 against its plain version
                at the shapes recorded from those requests; the config cut
                to 2 + 2 layers, bf16 on the card against fp32 on the CPU,
                held to 3 times the CPU's own bf16 floor; small llava_llama,
                llava_mistral and llava_gemma checkpoints written with HF key
                names, loaded by `load_pretrained_model` (leaves bit-equal)
                and answering a uint8 clip and a text prompt through
                `MavlmForCausalLM.generate`. Then serving
                (`phase_serving`): the continuous-batching engine at
                bench_serving.py's configuration (the 0.5B LM in bf16,
                matrices times 5; 4 slots of 2048 positions; six
                1500-token prompts sharing a 512-token prefix; 64 new
                tokens), one engine a run: plain, kv_int8,
                chunk_prefill=512, speculative=4 (accepted drafts),
                decode_ticks=4, the prefix through set_prefix (contiguous
                and paged), the paged pool full and oversubscribed
                (preemptions), the int8 LM with kv_int8, and idle slots
                whose lengths pass max_len; every request's tokens held to
                vlm.generate by the margin rule, no engine record at ERROR,
                flash_fwd 24 a one-shot prefill and none from chunks,
                decode or verification; each run's decode tokens/s, first
                tokens, ms a tick, stats and peak memory. Then loading (`phase_load`):
                the 0.5B model's seeded bf16 weights (LM matrices times 5)
                exported with `export_hf_safetensors` under build/ and
                loaded back by `load_pretrained_model`, in bf16 and with
                load_8bit: every leaf bit-equal to the source (or to its
                prequantization), and `model.generate` of a 64-frame
                480x640 uint8 clip read back from a y4m file through
                `load_video` giving the in-memory request's 32 tokens
                (flash_fwd 55; the tower's int8 kernels 26 each and
                flash_fwd 29), with export and load times, GB/s, the peak
                host RSS and each generate's ms. Then evaluation and the
                image path (`phase_eval`) on that checkpoint: the device
                preprocess (ops/preprocess.py) on the card against the same
                function on the CPU (fp32, PREPROCESS_TOL; its
                antialias=False control must fail) and within the host
                processor's quantization envelope, for the 64-frame clip, 8
                frames of 1080x1920, one of 2160x3840 and the anyres tiles
                of a 1920x1080 image, each timed beside the host processor;
                the clip through load_pretrained_model(device_preprocess=
                True) in bf16 and with load_8bit (the tokens of the same
                call fed the card-preprocessed frames, phase_load's
                launches); the image with modalities=["image"] through the
                host anyres processor and through the device preprocess in
                both (7269 visual tokens, launches, 32 tokens, finite
                logits, the two paths' embeds within EMBED_FLOOR_FACTOR of
                the uint8 requantization floor); model_vqa over a clip, a
                PNG and a text question with and without
                --device_preprocess, the lmms-eval adapter's generate_until
                and loglikelihood through the vendored harness, and
                Predictor on the clip, each with its launches and ms. Then
                the serving HTTP stack (`phase_serve_stack`) on that
                checkpoint, in this process over 127.0.0.1: a controller, a
                ModelWorker(device_preprocess=True), an SGLangWorker (4
                slots of 10240 positions) and the web UI; the 64-frame clip
                as base64 PNG frames through the client to the model worker
                (raw uint8 to the card), the same with one frame of another
                size (the host processor), the clip and two text prompts at
                once to the engine worker, a text turn through /chat and
                serve.cli on the clip; every chunk at error_code 0, the
                workers' ids equal to the in-process model.generate (the
                engine's held to vlm.generate by the margin rule),
                flash_fwd 55 a clip and 24 a text prefill, each request's
                HTTP and in-process ms. Then
                the training entry (`phase_train_cli`) on that checkpoint:
                `train.cli.main` at full width over four 65-frame videos
                and two text samples, k = 2, --dropout_frames (a leaf
                moves on every 2nd micro-step only, the dropout decisions
                synced_frame_dropout's, exact launches, the export loaded
                back equal to the final state), stopped after micro-step 5
                and resumed from that mid-accumulation checkpoint to 6,
                --tower_int8 under torch.profiler (the int8 tower
                bit-identical, its three kernels 26 each, the data, step
                and checkpoint spans in the trace); the optimizer update
                alone; one SFT, LoRA and DPO step with their launches. Then
                the train CLI on small llava_gemma (`--version gemma`, bf16,
                the LM's training kernels at 256) and untied llava_llama
                (`--version llava_llama_3`, fp32, its first loss held to the
                CPU's and its lm_head moved) checkpoints, two micro-steps
                each, and one SFT and one LoRA step on each. Then the
                TRL extras at Qwen2-0.5B's full width (`phase_trl_extras`,
                bf16 weights from a seed): a PPO round (4 queries of 64
                tokens, 32 sampled tokens each through generate_batched,
                the old log-probs and values, the frozen reference's
                log-probs, the full KL and the reward model's scores, two
                PPO steps with the KL controller moved between them), a
                reward step on 4 pairs of 96 tokens, an iterative-SFT step
                of two minibatches, best-of-N (4 samples, the winner
                re-scored as the top), the tool-use text environment over
                4 tasks and DDPO's toy policy, each with exact launches of
                #1 and #9-#11; then its fp32 cut (2 LM layers): a PPO step
                for kl_penalty "kl" and "full" and a reward step on the
                card against the CPU, every statistic, grad_norm and
                gradient leaf, with a cliprange control that must fail. And `python -m
                memory_augmented_vlm_torch.bench` runs as a subprocess with
                no flags and with --model 7b, its JSON line held to
                bench.py's keys and metric names, then `... .bench_serving`
                (defaults) and `... .bench_throughput --synthetic-producer`,
                their lines held to the root scripts' keys (less the relay
                fields) and a finite positive value;
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
                finite losses; then Gemma-2B's train step at full width
                (`phase_train_gemma`: three steps of bench_train's batch,
                launches 26 + 5 of #1, 36 / 18 / 18 of the training kernels
                at 256, watched leaves, step seconds, peak memory);
  7. parity   — full widths cut to 2 tower and 2 LM layers, fp32: the card
                (through the kernels) against the CPU (plain versions) on the
                same weights, for the bf16-path model (8 frames), the int8
                model with an int8 KV cache, the same with both fusions on,
                and one train step (40 frames,
                2 segments), whose loss, grad_norm and every gradient leaf
                are compared, then one update accumulated over two
                micro-steps (k = 2), whose parameters are compared; then the
                same train step of Gemma-2B's config cut to 2 + 2 layers
                (40 frames, fp32: #9-#11 and #1 at 256 through their fp32
                kernels), loss, grad_norm and every gradient leaf; then the
                7B config (Qwen2-7B's LM, the memory at 3584 over 8 heads of
                448) cut the same way, fp32, over 33 frames (2 segments:
                the memory's fuse and evolve at 448 through
                flash_fwd_d448_f32, the LM's #9-#11 at 128), the same
                comparison.

The line before the last is a JSON object describing each of the 22
kernels (#1's head dims 448 and 256 and its fp32 kernel at 256 and 448,
and the training kernels at 256, as rows of their own), with its launches
on each path; the last
line is {"ok": true, "device": {...}}. Nothing is printed as a result when
there is no card: the run raises first.
"""

from __future__ import annotations

import base64
import builtins
import contextlib
import dataclasses
import functools
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from memory_augmented_vlm_torch import bench as port_bench
from memory_augmented_vlm_torch import bench_serving as port_bench_serving
from memory_augmented_vlm_torch import bench_train as port_bench_train
from memory_augmented_vlm_torch import constants, pipeline
from memory_augmented_vlm_torch import predict as port_predict
from memory_augmented_vlm_torch.checkpoint.checkpoint_io import export_hf_safetensors
from memory_augmented_vlm_torch.data import native_loader
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor, \
    process_anyres_image
from memory_augmented_vlm_torch.data.tokenizer import load_qwen_tokenizer, tokenizer_image_token
from memory_augmented_vlm_torch.data.video import load_video, write_y4m
from memory_augmented_vlm_torch.eval import lmms_adapter, model_vqa
from memory_augmented_vlm_torch.eval import model as eval_model
from memory_augmented_vlm_torch.eval.builder import config_from_json, load_pretrained_model
from memory_augmented_vlm_torch.config import LMConfig, VisionConfig, VLMConfig
from memory_augmented_vlm_torch.models import beam_search, image_path, qwen2, siglip, vlm
from memory_augmented_vlm_torch.models import paged as paged_kv
from memory_augmented_vlm_torch.microbench import gemv, int8_ceiling
from memory_augmented_vlm_torch.microbench.timing import (capture, graph_kernels, graph_ms,
                                                         replay_trace, require_card)
from memory_augmented_vlm_torch.microbench.timing import time_ms as _time_ms
from memory_augmented_vlm_torch.ops import (attn_block, cuda_lib, flash, flash_bwd, mlp_int8,
                                            norms, pallas_int8, qkv_int8, quant,
                                            swiglu_int8)
from memory_augmented_vlm_torch.ops.preprocess import preprocess_anyres_image, \
    preprocess_frames
from memory_augmented_vlm_torch.serve import batch_engine, model_worker, sglang_worker, \
    web_server
from memory_augmented_vlm_torch.serve import cli as serve_cli
from memory_augmented_vlm_torch.serve import client as serve_client
from memory_augmented_vlm_torch.serve import controller as serve_controller
from memory_augmented_vlm_torch.train import cli as train_cli
from memory_augmented_vlm_torch.train import (best_of_n, ddpo, dpo, iterative_sft, lora,
                                             optimizer, ppo, reward, sft,
                                             text_environment, trainer)
from memory_augmented_vlm_torch.utils.logging import start_profiler, stop_profiler
from memory_augmented_vlm_torch.utils.tree import leaves_with_path, path_str, tree_map

# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12  # fp32 outside the tensor cores
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3  # fp32 work as 3xTF32: three TF32 products a product
PEAK_BYTES = 3.35e12

# The bf16 backward kernels (dQ, dK/dV) vs their plain versions: both round
# P and dS to bf16, from fp32 sums taken in another order, and the outputs
# are bf16 (2^-8 relative steps), so they agree to the bf16 class. The bf16
# forward kernels are held bit-close instead (EXACT_MIN_SHARE, below).
BF16_ATOL = BF16_RTOL = 1e-2
# fp32 flash kernel vs plain version: the same math in another summation
# order, the fp32 forward's products in 3xTF32 (~2^-21 of each product). A
# single TF32 product (~2^-11) lands outside: the fp32 checks run it as a
# control (`_tf32_attention`).
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


# kernels whose ptxas report must show no spill, no C7508 (setmaxnreg
# ignored) and no warning that wgmma is serialised, whatever its code
# (C7512, C7514, C7515, C7520, ...); C7519, injected arrives, is no fault.
# The fp32 forward's instances (mma.sync, no wgmma), #1f's at every fp32
# head dim and #9f's (LSE) at the training ones, and the fp32 backward's
# are held to no spill.
F32_HEAD_DIMS = (64, 72, 112, 128, 256, 448)
PTXAS_CLEAN = ("bwd_dq_d256_kernel", "flash_fwd_d448_kernel", "flash_fwd_d256_kernel",
               "flash_fwd_lse_d256_kernel", "bwd_dkv_split_sm90_kernelILi256E",
               *(f"flash_fwd_3xtf32_kernelILi{d}ELb0E" for d in F32_HEAD_DIMS),
               *(f"flash_fwd_3xtf32_kernelILi{d}ELb1E" for d in flash_bwd.TRAIN_HEAD_DIMS),
               *(f"bwd_{k}_3xtf32_kernelILi{d}E" for k in ("dq", "dkv")
                 for d in flash_bwd.TRAIN_HEAD_DIMS))
PTXAS_FAULTS = re.compile(r"C7508|wgmma\.mma_async instructions are serialized")


def ptxas_faults(log_text: str) -> dict:
    """{kernel of PTXAS_CLEAN: its faults} from nvcc's -Xptxas -v output:
    spill stores or loads in its function properties, a C7508 or
    serialised-wgmma warning that names it (or, naming no function, follows
    its "Compiling entry function" line), or no entry of that name at all."""
    faults = {name: [] for name in PTXAS_CLEAN}
    seen, entry, props = set(), None, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        named = re.findall(r"'(_Z[^']*)'", line)
        for name in PTXAS_CLEAN:
            if entry and name in entry:
                seen.add(name)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and props and name in props and (int(spill[1]) or int(spill[2])):
                faults[name].append(line.strip())
            if PTXAS_FAULTS.search(line) and any(
                    name in f for f in (named or [entry or ""])):
                faults[name].append(line.strip())
    for name in PTXAS_CLEAN:
        if name not in seen:
            faults[name].append("no entry function of this name in the ptxas report")
    return {name: f for name, f in faults.items() if f}


def phase_build():
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {cuda_lib.BUILD_LOG['path']}")
    for line in cuda_lib.BUILD_LOG["ptxas"].splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "C75" in line):  # the C75xx lines: wgmma serialised, setmaxnreg ignored
            log("  " + line.strip())
    faults = ptxas_faults(cuda_lib.BUILD_LOG["ptxas"])
    if faults:
        raise RuntimeError(f"ptxas spilled or serialised the Hopper flash kernels: {faults}")


def _bound(ops: float, peak: float, nbytes: float):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the type's peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------ flash_fwd


def _check_case(name, q, k, v, valid, *, causal=False, kv_groups=1, dtype=torch.bfloat16,
                timed=False, controls=False, name_library=False, control_rows=None,
                plain_block_k=None):
    """flash_fwd on one input against its plain version: bf16 held bit-close
    (`_hold_bitwise`) to the online softmax over the kernel's key tile
    (`flash.forward_tiles`), fp32 to every element within F32_ATOL +
    F32_RTOL of the plain version (one tile over the keys, or the online
    softmax over `plain_block_k` keys, the same function in fp32, where one
    tile's scores would not fit the card). `controls` runs the neighbouring
    functions through the same check, each of which must fail it
    (`_flash_controls` in bf16, the single-TF32 form `_tf32_attention` in
    fp32), over every query row or, causal with `control_rows`, over the
    first that many queries and keys of each batch (where the one-tile
    control's whole score matrix would not fit the card);
    `name_library` records the device kernels of the timed library call
    (its backend). The bound is at the bf16 peak, or in fp32 at the 3xTF32
    rate the kernel computes at (`bound_f32_peak_ms`: at the fp32 peak
    outside the tensor cores)."""
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
    block_k = flash.forward_tiles(q.shape[-1])[0] if dtype == torch.bfloat16 else plain_block_k
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
        cvalid = valid.clamp_max(cq.shape[1])
        if dtype == torch.bfloat16:
            for label, fn in _flash_controls(cq, ck, cv, cvalid, causal, kv_groups, block_k):
                _must_fail(f"{name} control: {label}", fn()[0], cref)
        else:
            _must_fail_f32(f"{name} control: single TF32 products",
                           _tf32_attention(cq, ck, cv, cvalid, causal, kv_groups, terms=1)[0],
                           cref)
    del ref
    if timed:
        row["ms"] = _time_ms(lambda: flash.flash_attention(q, k, v, valid, causal=causal,
                                                           kv_groups=kv_groups))
        row["plain_ms"] = _time_ms(plain)
        sdpa = _sdpa_call(q, k, v, valid, causal, kv_groups)
        row["library_ms"] = _time_ms(sdpa)
        if name_library:
            row["library_kernels"] = _device_kernels(sdpa)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_3XTF32
        row["bound_ms"], row["bound_by"] = _flash_bound(q, k, v, valid, causal, kv_groups, peak)
        if dtype == torch.float32:
            row["bound_f32_peak_ms"] = _flash_bound(q, k, v, valid, causal, kv_groups,
                                                    PEAK_F32)[0]
        log(json.dumps(row))
    return row


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """x as TF32 (10 mantissa bits), by masking its fp32 bits: to nearest,
    ties away from zero (cvt.rna.tf32.f32), or with `nearest=False` by
    dropping the 13 low bits, as the tensor core reads an fp32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 4096 if nearest else bits) & -8192).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """einsum(eq, a, b) as the fp32 forward computes it on the tensor cores:
    each operand split into hi (to nearest TF32) and lo = x - hi (read as
    TF32 by dropping its low bits), lo*hi + hi*lo + hi*hi summed in fp32
    (`terms` 3); `terms` 1 keeps hi*hi, a single TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        al, bl = _tf32(a - ah, nearest=False), _tf32(b - bh, nearest=False)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


def _tf32_attention(q, k, v, valid, causal, kv_groups, terms=3):
    """The fp32 flash forward's function with both products in TF32
    (`_tf32_product`): 3xTF32, the kernel's own arithmetic, or a single
    TF32 product (`terms=1`), the control its checks must fail. One tile
    over the keys. Returns (out, lse (B, H, Sq) in log2 units, m +
    log2(max(l, 1e-30))): a row with no valid key has out 0 and lse -inf."""
    b, sq, h, d = q.shape
    k, v = (x.repeat_interleave(kv_groups, dim=2).float() for x in (k, v))
    qs = q.float() * (d ** -0.5 * flash.LOG2E)
    s = _tf32_product("bqhd,bkhd->bhqk", qs, k, terms)
    s = s.masked_fill(~flash.attention_mask(b, sq, k.shape[1], valid, causal, q.device),
                      -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(dim=-1)
    o = _tf32_product("bhqk,bkhd->bqhd", p, v, terms)
    lt = l.transpose(1, 2)[..., None]
    lse = torch.where(l == 0, -math.inf, m[..., 0] + torch.log2(l.clamp_min(1e-30)))
    return torch.where(lt == 0, 0.0, o / lt), lse


def _tf32_backward(q, k, v, g, lse, delta, valid, causal, kv_groups, terms=3):
    """The fp32 backward's function (`flash_bwd.backward_dq_reference`,
    `backward_dkv_reference`) with each of its five products in TF32
    (`_tf32_product`): 3xTF32, the kernels' own arithmetic, or a single
    TF32 product (`terms=1`), the control their checks must fail. Returns
    (dQ, dK, dV), dK and dV summed over each group."""
    b, sq, h, d = q.shape
    scale = d ** -0.5
    kr, vr = (x.repeat_interleave(kv_groups, dim=2).float() for x in (k, v))
    s = _tf32_product("bqhd,bkhd->bhqk", q.float() * (scale * flash.LOG2E), kr, terms)
    mask = flash.attention_mask(b, sq, k.shape[1], valid, causal, q.device)
    p = torch.where(mask, torch.exp2(s - lse[..., None]), 0.0)
    ds = p * (_tf32_product("bqhd,bkhd->bhqk", g.float(), vr, terms) - delta[..., None]) * scale
    dq = _tf32_product("bhqk,bkhd->bqhd", ds, kr, terms)
    dk, dv = (_tf32_product("bhqk,bqhd->bkhd", x, y.float(), terms)
              .reshape(b, k.shape[1], h // kv_groups, kv_groups, d).sum(dim=3)
              for x, y in ((ds, q), (p, g)))
    return dq, dk, dv


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


def _flash_bound(q, k, v, valid, causal, kv_groups, peak=PEAK_BF16):
    """Attention work of these inputs: 4 * (query, valid key) pairs * D per
    head at `peak`, reading only the valid keys."""
    b, sq, h, d = q.shape
    flops = 4.0 * _attn_pairs(sq, k.shape[1], valid, causal, h) * d
    kv_read = sum(min(n, k.shape[1]) for n in valid.tolist()) * k.shape[2] * d * 2 * \
        q.element_size()
    return _bound(flops, peak, 2 * _nbytes(q) + kv_read)


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
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 plain versions and SDPA
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def lens(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    cfg = VLMConfig.onevision_0_5b()
    b3_lens = [_spliced_len(cfg, f) for f in GENERATE_CLIPS]
    b3_rows = -(-max(b3_lens) // 128) * 128
    image_len = _image_spliced_len(cfg, EVAL_IMAGE_HW[::-1])
    image_rows = -(-image_len // 128) * 128
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
        # the anyres image path: the tower over the 1920x1080 image's 16
        # tiles, and the LM prefill of its spliced sequence
        _check_case("image_tower", randn(IMAGE_TILES[0], 729, 16, 72),
                    randn(IMAGE_TILES[0], 729, 16, 72), randn(IMAGE_TILES[0], 729, 16, 72),
                    lens(*[729] * IMAGE_TILES[0]), timed=True, controls=True),
        _check_case("image_prefill", randn(1, image_rows, 14, 64), randn(1, image_rows, 2, 64),
                    randn(1, image_rows, 2, 64), lens(image_len), causal=True, kv_groups=7,
                    timed=True, controls=True),
        # the serving engine's one-shot prefill: a 1500-token prompt padded
        # to the 128-row bucket
        _check_case("serve_prefill", randn(1, 1536, 14, 64), randn(1, 1536, 2, 64),
                    randn(1, 1536, 2, 64), lens(SERVE_PROMPT), causal=True, kv_groups=7,
                    timed=True, controls=True),
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
    row = _flash_row("flash_fwd", "flash_fwd_sm90.cu", path_rows, errs)
    # fp32 at the head dims that flash_fwd counts: csrc/flash_fwd.cu's
    # kernel, its rows apart from the bf16 ones that make the row's times
    f32 = [_f32_cases(d, seed=13 + d) for d in flash.KERNEL_HEAD_DIMS]
    row["f32_source"] = CSRC + "flash_fwd.cu"
    row["f32_per_shape"] = _per_shape([r for rows, _ in f32 for r in rows])
    row["max_abs_err"] = max([row["max_abs_err"]] + [e for _, errs in f32 for e in errs])
    return [row, _flash_row("flash_fwd_d448", "flash_fwd_wide_sm90.cu", *_wide_cases(randn, lens)),
            _f32_row("flash_fwd_d256_f32", flash.D256, seed=13),
            _f32_row("flash_fwd_d448_f32", flash.WIDE_HEAD_DIM, seed=14)]


# edge cases of the wide kernel: (name, Sq, Skv, H, H_kv, valid lengths,
# causal, controls). Controls run where the case can tell them apart (not
# where most rows see a single key tile).
WIDE_EDGES = {
    flash.WIDE_HEAD_DIM: [
        ("valid_0_and_77_causal_gqa", 150, 150, 4, 2, (0, 77), True, False),
        ("valid_0_and_77", 150, 150, 4, 2, (0, 77), False, False),
        ("valid_1", 65, 100, 2, 2, (1,), False, False),
        ("sq_65", 65, 333, 8, 8, (333,), False, True),
        ("b2_unequal", 100, 333, 2, 2, (333, 65), False, True),
        # an even number of 32-key tiles: both warpgroups score
        ("valid_64_even", 65, 100, 2, 2, (64,), False, True)],
    # Gemma: GQA 8 (one KV head) and 1, valid lengths off the 64-key tile,
    # fewer queries than one 128-row block (its second warpgroup idle), B = 2
    flash.D256: [
        ("valid_0_and_77_causal_gqa8", 150, 150, 8, 1, (0, 77), True, False),
        ("causal_gqa8_ragged", 200, 200, 8, 1, (200, 131), True, True),
        ("causal_gqa1_ragged", 300, 300, 2, 2, (211, 300), True, True),
        ("valid_1", 65, 100, 2, 2, (1,), False, False),
        ("sq_40", 40, 333, 8, 8, (333,), False, True),
        ("b2_unequal_gqa8", 100, 333, 8, 1, (333, 65), False, True)],
}


def _wide_edges(randn, lens, d) -> list:
    """The wide kernel at head dim `d` on `WIDE_EDGES[d]`, each held
    bit-close to the online softmax at the kernel's key tile. Returns the
    errors."""
    errs = []
    for name, sq, skv, h, hkv, valid, causal, controls in WIDE_EDGES[d]:
        b = len(valid)
        errs.append(_check_case(f"d{d}_{name}", randn(b, sq, h, d), randn(b, skv, hkv, d),
                                randn(b, skv, hkv, d), lens(*valid), causal=causal,
                                kv_groups=h // hkv, controls=controls)["max_abs_err"])
    return errs


def _wide_cases(randn, lens):
    """#1 at head dim 448 (csrc/flash_fwd_wide_sm90.cu, the 7B memory): the
    fuse and evolve shapes of a 64-frame 7B request, timed, with the
    library call's backend named; edge cases of valid length 0 (zeros) and
    1, 65 query rows, B = 2 with unequal valid lengths, causal GQA, an even
    number of key tiles (`WIDE_EDGES`). Each held bit-close to the online softmax at the
    kernel's 32-key tile. Returns (path rows, errors)."""
    d = flash.WIDE_HEAD_DIM
    path_rows = [
        _check_case("memory_fuse_7b", randn(1, 1568, 8, d), randn(1, 6272, 8, d),
                    randn(1, 6272, 8, d), lens(3136), timed=True, controls=True,
                    name_library=True),
        _check_case("memory_evolve_7b", randn(1, 1568, 8, d), randn(1, 15680, 8, d),
                    randn(1, 15680, 8, d), lens(1568), timed=True, controls=True,
                    name_library=True),
    ]
    return path_rows, [r["max_abs_err"] for r in path_rows] + _wide_edges(randn, lens, d)


def _d256_cases(shapes) -> dict:
    """#1 at head dim 256 (csrc/flash_fwd_wide_sm90.cu at 256: the Gemma-2B
    path) at the shapes its request gave it (`shapes`: one (case, q shape,
    kv shape, valid lengths, causal) per distinct call), each timed with its
    controls and the library call's backend named, then `WIDE_EDGES[256]`;
    every case held bit-close to the online softmax at the kernel's 64-key
    tile. Returns the kernels line's row."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def lens(*v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    path_rows = [
        _check_case(case, randn(*q), randn(*kv), randn(*kv), lens(*valid), causal=causal,
                    kv_groups=q[2] // kv[2], timed=True, controls=True, name_library=True)
        for case, q, kv, valid, causal in shapes]
    errs = [r["max_abs_err"] for r in path_rows] + _wide_edges(randn, lens, flash.D256)
    return _flash_row("flash_fwd_d256", "flash_fwd_wide_sm90.cu", path_rows, errs)


# #1's fp32 kernel at each head dim: the fp32 path shapes, each timed with
# its control, as (case, q shape, k/v shape, valid lengths, causal). The
# parity cuts run the tower at 72 and the memory at 112 (0.5B), 256
# (Gemma-2B) and 448 (7B); no fp32 path runs 64 or 128 at full width (the
# CLI's small checkpoints run 64), which are timed at the 0.5B and 7B LMs'
# prefill shapes, as an fp32 generate would give them.
F32_PATHS = {
    64: [("lm_prefill_f32", (1, 9472, 14, 64), (1, 9472, 2, 64), (9444,), True)],
    72: [("tower_f32", (64, 729, 16, 72), (64, 729, 16, 72), (729,) * 64, False)],
    112: [("memory_fuse_f32", (1, 1568, 8, 112), (1, 6272, 8, 112), (3136,), False),
          ("memory_evolve_f32", (1, 1568, 8, 112), (1, 15680, 8, 112), (1568,), False)],
    128: [("lm_prefill_7b_f32", (1, 9472, 28, 128), (1, 9472, 4, 128), (9444,), True)],
    256: [("memory_fuse_gemma_f32", (1, 1568, 8, 256), (1, 6272, 8, 256), (6272,), False),
          ("memory_evolve_gemma_f32", (1, 1568, 8, 256), (1, 15680, 8, 256), (1568,), False)],
    448: [("memory_fuse_7b_f32", (1, 1568, 8, 448), (1, 6272, 8, 448), (3136,), False),
          ("memory_evolve_7b_f32", (1, 1568, 8, 448), (1, 15680, 8, 448), (1568,), False)],
}
# ... and edge cases at every head dim: (name, B, Sq, Skv, H, H_kv, valid
# lengths, causal): causal GQA with a ragged batch, a cross case with a
# batch of valid length 0, 65 query rows (not a multiple of a block's 64 or
# 32)
F32_EDGES = [("causal_gqa_ragged", 2, 300, 300, 8, 1, (300, 211), True),
             ("cross_valid0", 2, 150, 333, 4, 2, (0, 300), False),
             ("sq_65", 1, 65, 200, 2, 2, (200,), False)]
# the causal prefill shapes: the plain version's online softmax over tiles
# of this many keys, and the controls over the first this many rows
F32_PLAIN_BLOCK_K = 1024
F32_CONTROL_ROWS = 2048


def _f32_cases(d: int, seed: int):
    """#1's fp32 kernel (csrc/flash_fwd.cu, 3xTF32) at head dim `d`: the
    cases of F32_PATHS[d] timed beside the plain version and SDPA in fp32
    (TF32 off), the library's backend named, the bound at the 3xTF32 rate
    and at the fp32 peak; then F32_EDGES. Every case held to the plain
    version at F32_ATOL + F32_RTOL, with the single-TF32 control failing the
    same check. Returns (path rows, errors)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def lens(*v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    path_rows = []
    for case, qs, kvs, valid, causal in F32_PATHS[d]:
        big = dict(plain_block_k=F32_PLAIN_BLOCK_K, control_rows=F32_CONTROL_ROWS) \
            if causal else {}
        path_rows.append(_check_case(
            case, randn(*qs), randn(*kvs), randn(*kvs), lens(*valid), causal=causal,
            kv_groups=qs[2] // kvs[2], dtype=torch.float32, timed=True, controls=True,
            name_library=True, **big))
        torch.cuda.empty_cache()
    errs = [r["max_abs_err"] for r in path_rows]
    for name, b, sq, skv, h, hkv, valid, causal in F32_EDGES:
        errs.append(_check_case(f"f32_d{d}_{name}", randn(b, sq, h, d), randn(b, skv, hkv, d),
                                randn(b, skv, hkv, d), lens(*valid), causal=causal,
                                kv_groups=h // hkv, dtype=torch.float32,
                                controls=True)["max_abs_err"])
    return path_rows, errs


def _f32_row(name: str, d: int, seed: int) -> dict:
    """The kernels line's row of #1's fp32 kernel at head dim 256 or 448,
    which count their own launches (`_f32_cases`)."""
    row = _flash_row(name, "flash_fwd.cu", *_f32_cases(d, seed))
    row["bound_f32_peak_ms"] = sum(r["bound_f32_peak_ms"] for r in row["per_shape"])
    return row


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


def _per_shape(path_rows) -> list:
    return [{key: r[key] for key in ("case", "max_abs_err", "ms", "plain_ms", "library_ms",
                                     "library_kernels", "bound_ms", "bound_by",
                                     "bound_f32_peak_ms") if key in r}
            for r in path_rows]


def _flash_row(name, source, path_rows, errs):
    return {
        "name": name, "route": "cuda", "source": CSRC + source,
        "replaces": "memory_augmented_vlm_tpu/ops/pallas_flash.py:565",
        "max_abs_err": max(errs),
        **{key: sum(r[key] for r in path_rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in path_rows)
        else "bytes",
        "per_shape": _per_shape(path_rows),
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


# the anyres image path's tower batches: the card phase's 1920x1080 image
# (a 5 x 3 grid and the base view, 11664 rows = 91 * 128 + 16) and a 2 x 2
# grid and the base (3645 rows, 28 * 128 + 61)
IMAGE_TILES = (16, 5)


def _qkv_case(gen, b, s, h, nh, label, timed):
    """fused_qkv_int8 at (b, s, h) bf16 held bit-close to its plain version;
    `timed` also runs the controls, which must fail, and returns the
    kernel's, the plain version's and `_int_mm`'s ms beside the bound."""
    args = _qkv_args(gen, b, s, h, torch.bfloat16, "cuda")
    out = qkv_int8.fused_qkv_int8(*args, nh=nh)
    torch.cuda.synchronize()
    ref = qkv_int8.fused_qkv_int8_reference(*args, nh=nh)
    row = {"max_abs_err": max(_hold_bitwise(f"qkv{label}_{n}", o, r,
                                            hidden=list(args[0].shape))["max_abs_err"]
                              for n, o, r in zip("qkv", out, ref))}
    if not timed:
        return row
    for control, fn in _qkv_controls(args, nh):
        for n, o, r in zip("qkv", fn(), ref):
            _must_fail(f"qkv{label}_{n} control: {control}", o, r)
    del ref
    xq, _ = quant.quantize_rows(args[0].reshape(-1, h))
    w_qkv = quant.column_major(torch.cat([args[3], args[6], args[9]], dim=1))
    bound, by = _bound(2.0 * b * s * h * 3 * h, PEAK_INT8,
                       _nbytes(args[0], *out, args[3], args[6], args[9]))
    return {**row,
            "ms": _time_ms(lambda: qkv_int8.fused_qkv_int8(*args, nh=nh)),
            "plain_ms": _time_ms(lambda: qkv_int8.fused_qkv_int8_reference(*args, nh=nh)),
            "library_ms": _time_ms(lambda: torch._int_mm(xq, w_qkv)),
            "library_call": f"torch._int_mm ({b * s}x{h} @ {h}x{3 * h}): the matmul share only",
            "bound_ms": bound, "bound_by": by}


def _merge_case(gen, b, s, nh, label, timed):
    """flash_attention_merge_heads at (b, nh, s, 72) bf16, all keys valid,
    as `_qkv_case`; its controls and SDPA as the library call."""
    q, k, v = (torch.randn((b, nh, s, 72), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    valid = torch.full((b,), s, dtype=torch.int32, device="cuda")
    out = flash.flash_attention_merge_heads(q, k, v, valid)
    torch.cuda.synchronize()
    ref = flash.flash_attention_merge_heads_reference(q, k, v, valid)
    row = {"max_abs_err": _hold_bitwise(f"merge{label}", out, ref, q=list(q.shape))["max_abs_err"]}
    if not timed:
        return row
    for control, fn in _merge_controls(q, k, v, valid):
        _must_fail(f"merge{label} control: {control}", fn(), ref)
    del ref
    bound, by = _bound(4.0 * b * nh * s * s * 72, PEAK_BF16, _nbytes(q, k, v, out))
    return {**row,
            "ms": _time_ms(lambda: flash.flash_attention_merge_heads(q, k, v, valid)),
            "plain_ms": _time_ms(lambda: flash.flash_attention_merge_heads_reference(
                q, k, v, valid)),
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "library_call": f"scaled_dot_product_attention ({b}, {nh}, {s}, 72) bf16",
            "bound_ms": bound, "bound_by": by}


def _mlp_case(gen, m, h, inter, label, timed):
    """fused_mlp_block_int8 at (m, h) x (h, inter) bf16, as `_qkv_case`;
    its controls are the erf GELU and h rounded to bf16 before the
    requant."""
    args = _mlp_args(gen, m, h, inter, torch.bfloat16, "cuda")
    out = mlp_int8.fused_mlp_block_int8(*args)
    torch.cuda.synchronize()
    ref = mlp_int8.fused_mlp_block_int8_reference(*args)
    row = {"max_abs_err": _hold_bitwise(f"mlp{label}", out, ref, args[0],
                                        hidden=list(args[0].shape))["max_abs_err"]}
    if not timed:
        return row
    with _erf_gelu():
        _must_fail(f"mlp{label} control: erf GELU",
                   mlp_int8.fused_mlp_block_int8_reference(*args), ref, args[0])
    with _h_in_bf16():
        _must_fail(f"mlp{label} control: h rounded to bf16 before the requant",
                   mlp_int8.fused_mlp_block_int8_reference(*args), ref, args[0])
    del ref
    xq, _ = quant.quantize_rows(args[0])
    hq = torch.randint(-127, 128, (m, inter), generator=gen, device="cuda", dtype=torch.int8)
    bound, by = _bound(2.0 * m * h * inter * 2, PEAK_INT8,
                       2 * _nbytes(args[0]) + _nbytes(args[3], args[6]))
    return {**row,
            "ms": _time_ms(lambda: mlp_int8.fused_mlp_block_int8(*args)),
            "plain_ms": _time_ms(lambda: mlp_int8.fused_mlp_block_int8_reference(*args)),
            "library_ms": _time_ms(lambda: (torch._int_mm(xq, args[3]),
                                            torch._int_mm(hq, args[6]))),
            "library_call": f"torch._int_mm x2 ({m}x{h} @ {h}x{inter}, {m}x{inter} @ "
                            f"{inter}x{h}): the matmul share only",
            "bound_ms": bound, "bound_by": by}


def _image_cases(case, shape) -> tuple:
    """`case` at the image path's two tower batches (IMAGE_TILES), the
    first timed with its controls: (per-shape rows by tile count, errs)."""
    rows = {f"{t}_tiles": case(*shape(t), f"_image_{t}", t == IMAGE_TILES[0])
            for t in IMAGE_TILES}
    return rows, [r["max_abs_err"] for r in rows.values()]


def phase_int8_kernels():
    """fused_qkv_int8, flash_attention_merge_heads and fused_mlp_block_int8
    at the 64-frame tower's shapes, at the anyres image's tower batches
    (IMAGE_TILES, the larger timed) and at edge cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    dev = "cuda"
    b, s, h, nh, inter = 64, 729, 1152, 16, 4304
    rows = {}

    # --- fused_qkv_int8
    rows["qkv"] = _qkv_case(gen, b, s, h, nh, "", True)
    errs = [rows["qkv"]["max_abs_err"]]
    rows["qkv"]["image_shapes"], more = _image_cases(
        lambda bb, ss, label, timed: _qkv_case(gen, bb, ss, h, nh, label, timed),
        lambda t: (t, s))
    errs += more
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
    rows["merge"] = _merge_case(gen, b, s, nh, "", True)
    errs = [rows["merge"]["max_abs_err"]]
    rows["merge"]["image_shapes"], more = _image_cases(
        lambda bb, ss, label, timed: _merge_case(gen, bb, ss, nh, label, timed),
        lambda t: (t, s))
    errs += more
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
    rows["mlp"] = _mlp_case(gen, b * s, h, inter, "", True)
    errs = [rows["mlp"]["max_abs_err"]]
    rows["mlp"]["image_shapes"], more = _image_cases(
        lambda m, label, timed: _mlp_case(gen, m, h, inter, label, timed), lambda t: (t * s,))
    errs += more
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
            return qwen2._mlp_half(layer, hidden[None], LMConfig(rms_norm_eps=1e-6))[0]

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
    _hold_gemv_graph(x, w1, w2)
    want = {"int8_ceiling_microbench": {"int8_gemm_bf16": 1},
            "gemv_microbench": {"gemv": 2 * w1.shape[0]}}
    for path, counts in want.items():
        if paths[path] != {**dict.fromkeys(WRAPPERS, 0), **counts}:
            raise RuntimeError(f"{path}: launches {paths[path]}, want {counts}")
    torch.cuda.empty_cache()
    return paths


def _hold_gemv_graph(x, w1, w2):
    """The GEMV chain captured in a CUDA graph: one kernel node per product,
    every node a gemv kernel, counted from the captured graph itself
    (`timing.graph_kernels`, which cannot drop a node as the profiler can
    drop a record), and one replay's output bit-equal to the eager chain's.
    The profiler's record of a replay (how many consecutive products
    overlap, the programmatic edge kept; the gaps) is logged beside it and
    decides nothing."""
    held = {}

    def run():
        held["out"] = gemv.chain(gemv.gemv, x, w1, w2)

    graph = capture(run, keep_graph=True)
    nodes = graph_kernels(graph)
    want = 2 * w1.shape[0]
    graph.replay()
    eager = gemv.chain(gemv.gemv, x, w1, w2)
    torch.cuda.synchronize()
    row = {"gemv_chain_graph": {
        "kernel_nodes": len(nodes), "gemv_kernel_nodes": sum("gemv" in n for n in nodes),
        "want": want, "node_names": sorted(set(nodes)),
        "replay_bit_equal_to_eager": torch.equal(held["out"], eager)},
        "gemv_chain_graph_replay_profile": replay_trace(lambda: gemv.chain(gemv.gemv, x, w1, w2),
                                                        "gemv")}
    log(json.dumps(row))
    graph_row = row["gemv_chain_graph"]
    if graph_row["kernel_nodes"] != want or graph_row["gemv_kernel_nodes"] != want:
        raise RuntimeError(f"gemv chain graph: {graph_row['gemv_kernel_nodes']} gemv kernel "
                           f"nodes of {graph_row['kernel_nodes']}, want {want} of {want}")
    if not graph_row["replay_bit_equal_to_eager"]:
        raise RuntimeError("gemv chain graph: the replay's output differs from the eager chain's")


# ----------------------------------------------------- training kernels

TRAIN_REPLACES = {
    "flash_fwd_lse": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:332",
    "flash_bwd_dq": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:148",
    "flash_bwd_dkv": "memory_augmented_vlm_tpu/ops/pallas_flash_bwd.py:232",
}
TRAIN_SOURCES = {"flash_fwd_lse": "flash_fwd_sm90.cu", "flash_bwd_dq": "flash_bwd_sm90.cu",
                 "flash_bwd_dkv": "flash_bwd_sm90.cu",
                 "flash_fwd_lse_d256": "flash_fwd_wide_sm90.cu",
                 "flash_bwd_dq_d256": "flash_bwd_sm90.cu",
                 "flash_bwd_dkv_d256": "flash_bwd_sm90.cu"}
TRAIN_F32_SOURCES = {"flash_fwd_lse": "flash_fwd.cu", "flash_bwd_dq": "flash_train.cu",
                     "flash_bwd_dkv": "flash_train.cu"}
# flops per (query, valid key) pair and head dim: QK^T and PV in the forward;
# the dQ kernel recomputes QK^T and does dO V^T and dS K; the dK/dV kernel
# recomputes QK^T and does dO V^T, P^T dO and dS^T Q
TRAIN_FLOPS_PER_PAIR = {"flash_fwd_lse": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def _train_bounds(q, k, valid, causal, peak=PEAK_BF16):
    """{kernel: (bound ms, bound_by)}: each kernel's operations at `peak`
    against its bytes (inputs read once, outputs written once, only the
    valid keys of K/V)."""
    b, sq, h, d = q.shape
    pairs = _attn_pairs(sq, k.shape[1], valid, causal, h)
    kv = sum(min(n, k.shape[1]) for n in valid.tolist()) * k.shape[2] * d * q.element_size()
    rows = b * h * sq * 4  # one fp32 lse or delta per query row
    io = {"flash_fwd_lse": 2 * _nbytes(q) + 2 * kv + rows,
          "flash_bwd_dq": 3 * _nbytes(q) + 2 * kv + 2 * rows,
          "flash_bwd_dkv": 2 * _nbytes(q) + 4 * kv + 2 * rows}
    return {name: _bound(f * pairs * d, peak, io[name])
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
    visits left out; at head dim 256, dK and dV with the column halves of Q
    and dO swapped (`_dkv_halves_swapped`). Yields (label, output, plain
    output)."""
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
    block_k, block_q = flash_bwd.dkv_block_k(d), flash_bwd.dkv_block_q(d)
    first = (cols // block_k * block_k // block_q if kw["causal"]
             else torch.zeros_like(cols))
    _, dk, dv = _backward_without(q, k, v, g, lse, delta, vl, rows // block_q == first, **kw)
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
    del dq
    if d == flash.D256:  # the dK/dV kernel's warpgroups each take one half of the columns
        dk, dv = _dkv_halves_swapped(q, k, v, g, lse, delta, vl, **kw)
        yield "dk, q's column halves swapped in dS^T Q", dk, rk
        yield "dv, dO's column halves swapped in P^T dO", dv, rv


def _dkv_halves_swapped(q, k, v, g, lse, delta, vl, *, causal, scale, kv_groups):
    """The plain dK and dV with the scores from q and dO as they are, but
    the products dS^T Q and P^T dO taken over Q and dO with their two column
    halves swapped: the function of a column-split dK/dV kernel that staged
    the wrong half."""
    p, ds = flash_bwd._dscores(q, k, v, g, lse, delta, vl, causal, scale, kv_groups)
    qs, gs = (torch.cat(x.chunk(2, dim=-1)[::-1], dim=-1) for x in (q, g))
    dv = torch.einsum("bhqk,bqhd->bhkd", p.to(g.dtype).float(), gs.float())
    dk = torch.einsum("bhqk,bqhd->bhkd", ds.to(q.dtype).float(), qs.float())
    return tuple(flash_bwd.group_sum(x, kv_groups).to(k.dtype) for x in (dk, dv))


def _train_kernels_case(name, gen, b, sq, skv, h, hkv, d, causal, valid, dtype=torch.bfloat16,
                        timed=False, parity_shape=False):
    """Run the three training kernels on one input and hold each output
    against its plain version (lse on its finite entries, and -inf exactly
    where the plain version has -inf). The timed case (the train shape) also
    runs dQ and dK/dV a second time and requires the same bits, and runs the
    controls of `_flash_controls` and `_train_controls`, each of which must
    fail the check. fp32 bounds are at the 3xTF32 rate (`bound_f32_peak_ms`:
    at the fp32 peak). An fp32 edge case also runs the forward and the
    backward with single TF32 products (`_tf32_attention(terms=1)`,
    `_tf32_backward(terms=1)`), whose out, lse, dQ, dK and dV must each fail
    the elementwise fp32 rule that the 3xTF32 kernels pass, and lse in
    natural-log units, which must fail it too. A `parity_shape`
    case (fp32 at a parity cut's LM shape) is timed for its row without
    controls, and its out, dQ, dK and dV are held to TRAIN_PARITY_RTOL of
    each one's largest magnitude, the rule the cut's step holds their
    gradients to, with a bit-equal second run; each row records how many
    elements the elementwise fp32 rule would put outside (the SIMT backward
    that the 3xTF32 kernels replaced left 13 to 23 elements of dK and dV
    outside at these lengths: sums of thousands of terms in sequence).
    Returns {kernel: row}."""
    timed = timed or parity_shape
    controls = timed and not parity_shape
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
            "dtype": str(dtype).split(".")[-1],
            "tol": (f"{TRAIN_PARITY_RTOL} of the largest |ref|" if parity_shape
                    else f"atol {atol} + rtol {rtol}")}
    outside_elementwise = {}

    def held(label, got, ref):
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: non-finite kernel output")
        diff = (got.float() - ref.float()).abs()
        bad = _train_outside(got, ref)
        if parity_shape:
            outside_elementwise[label] = bad
            bad = int((diff > TRAIN_PARITY_RTOL * ref.float().abs().max()).sum())
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
    if not (torch.equal(torch.isfinite(lse), fin) and torch.equal(lse[~fin], rlse[~fin])):
        raise RuntimeError(f"{name}: lse is -inf on other rows than the plain version's")
    if dtype == torch.bfloat16:
        fwd_err = _hold_bitwise(f"{name} out", out, rout, block_k=block_k, **info)["max_abs_err"]
    else:
        fwd_err = held("out", out, rout)
    errs = {"flash_fwd_lse": max(fwd_err, _hold_f32(f"{name} lse", lse[fin], rlse[fin],
                                                    **info)["max_abs_err"])}
    if controls:
        for label, fn in _flash_controls(q, k, v, vl, causal, h // hkv, block_k):
            c_out, c_lse = fn()
            _must_fail(f"{name} out control: {label}", c_out, rout)
            if label == "the causal diagonal moved by one key":
                _must_fail_f32(f"{name} lse control: {label}", c_lse[fin], rlse[fin])
    f32_edge = dtype == torch.float32 and not parity_shape
    if f32_edge:
        c_out, c_lse = _tf32_attention(q, k, v, vl, causal, h // hkv, terms=1)
        _must_fail_f32(f"{name} out control: single TF32 products", c_out, rout)
        _must_fail_f32(f"{name} lse control: single TF32 products", c_lse[fin], rlse[fin])
        del c_out, c_lse
    if controls or f32_edge:
        _must_fail_f32(f"{name} lse control: natural-log units", rlse[fin] * math.log(2.0),
                       rlse[fin])
    del rout, rlse
    rdq = flash_bwd.backward_dq_reference(q, k, v, g, lse, delta, vl, **kw)
    errs["flash_bwd_dq"] = held("dq", dq, rdq)
    rdk, rdv = flash_bwd.backward_dkv_reference(q, k, v, g, lse, delta, vl, **kw)
    errs["flash_bwd_dkv"] = max(held("dk", dk, rdk), held("dv", dv, rdv))
    if f32_edge:
        single = _tf32_backward(q, k, v, g, lse, delta, vl, causal, h // hkv, terms=1)
        for label, got, ref in zip(("dq", "dk", "dv"), single, (rdq, rdk, rdv)):
            _must_fail_f32(f"{name} {label} control: single TF32 products", got, ref)
        del single
    if timed:
        repeat = (dq_fn(), *dkv_fn())
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip((dq, dk, dv), repeat)]
        log(json.dumps({"case": name, "second_run_bit_equal": dict(zip(("dq", "dk", "dv"), same))}))
        if not all(same):
            raise RuntimeError(f"{name}: a second run of the backward kernels differs: {same}")
        del repeat
    if controls:
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
    if parity_shape:  # what the elementwise fp32 rule would say, for the record
        for kname, labels in (("flash_fwd_lse", ("out",)), ("flash_bwd_dq", ("dq",)),
                              ("flash_bwd_dkv", ("dk", "dv"))):
            rows[kname]["outside_elementwise_f32_rule"] = sum(
                outside_elementwise[x] for x in labels)
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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_3XTF32
        for kname, (bound, by) in _train_bounds(q, k, vl, causal, peak).items():
            rows[kname]["bound_ms"], rows[kname]["bound_by"] = bound, by
        if dtype == torch.float32:
            for kname, (bound, _) in _train_bounds(q, k, vl, causal, PEAK_F32).items():
                rows[kname]["bound_f32_peak_ms"] = bound
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


# the training kernels' edge cases: (name, B, Sq, Skv, H, H_kv, D, causal,
# valid lengths, dtypes)
TRAIN_EDGES = [
    # B=2, one batch shorter; 4 query heads keep the plain version's
    # (B, H, S, S) fp32 intermediates near 3 GB each
    ("b2_ragged", 2, TRAIN_TOKENS, TRAIN_TOKENS, 4, 2, 64, True, (9000, TRAIN_TOKENS),
     (torch.bfloat16,)),
    ("cross_d128", 2, 1000, 3000, 4, 2, 128, False, (3000, 1234),
     (torch.bfloat16, torch.float32)),
    ("valid0_causal", 2, 150, 150, 4, 2, 64, True, (0, 77), (torch.bfloat16, torch.float32)),
    ("valid0_cross", 2, 150, 333, 4, 4, 128, False, (0, 300),
     (torch.bfloat16, torch.float32)),
    ("lm_cut_f32", 1, 700, 700, 14, 2, 64, True, (700,), (torch.float32,)),
    # Gemma (head dim 256, GQA 8 over one KV head): B = 2 ragged with a
    # batch of valid length 0, cross attention with Skv != Sq, an fp32 cut
    ("d256_b2_valid0", 2, 600, 600, 8, 1, 256, True, (0, 531),
     (torch.bfloat16, torch.float32)),
    ("d256_cross", 2, 1000, 3000, 8, 1, 256, False, (3000, 1234),
     (torch.bfloat16, torch.float32)),
    # (at S = 700 one dV element of 1.4M, a sum of 8 x 700 products taken in
    # sequence by the SIMT kernel that came before the 3xTF32 one, fell
    # 2.4e-5 from the plain version's blocked sum: outside the 1e-5 rule)
    ("d256_cut_f32", 1, 300, 300, 8, 1, 256, True, (300,), (torch.float32,)),
    # the 7B LM's head dim in fp32, causal GQA 7: lengths that are no
    # multiple of any tile, and B = 2 with a batch of valid length 0
    ("d128_causal_gqa7", 1, 333, 333, 28, 4, 128, True, (333,), (torch.float32,)),
    ("d128_causal_gqa7_b2", 2, 333, 333, 28, 4, 128, True, (333, 0), (torch.float32,)),
    # dQ's last 128-row item holds 28 rows: its upper warpgroup is idle
    ("d256_sq_540", 1, 540, 540, 8, 1, 256, True, (540,), (torch.bfloat16,)),
]


TRAIN_TIMED_KEYS = ("ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_call")


def _train_kernel_rows(main_rows, errs, f32_rows, suffix=""):
    """The kernels line's rows of the three training kernels, from the timed
    case's rows, the timed fp32 cases' rows (`f32_per_shape`: the fp32
    kernels of csrc/flash_train.cu) and every case's errors; `suffix` names
    the head dim 256 wrappers."""
    rows = []
    for kname, row in main_rows.items():
        name = kname + suffix
        rows.append({
            "name": name, "route": "cuda", "source": CSRC + TRAIN_SOURCES[name],
            "replaces": TRAIN_REPLACES[kname], "max_abs_err": max(errs[kname]),
            **{key: row[key] for key in TRAIN_TIMED_KEYS},
            "f32_source": CSRC + TRAIN_F32_SOURCES[kname],
            "f32_per_shape": [{key: r[key] for key in ("case", "q", "kv", "max_abs_err", "tol",
                                                       "outside_elementwise_f32_rule",
                                                       *TRAIN_TIMED_KEYS, "bound_f32_peak_ms")}
                              for r in f32_rows[kname]]})
    return rows


def _parity_tokens(cfg: VLMConfig, num_frames: int, num_fine: int) -> int:
    """The LM's tokens in a parity cut's train step (`_train_batch`): the
    text and the spliced visual tokens of `num_frames` frames, `num_fine`
    of them fine."""
    nseg = vlm.pad_frames_to_segment_multiple(num_frames, cfg.memory.segment_frames) \
        // cfg.memory.segment_frames
    memory = dataclasses.replace(cfg.memory, num_fine_frames=num_fine)
    return TRAIN_TEXT + _visual_tokens(dataclasses.replace(cfg, memory=memory), num_frames, nseg)


def _f32_train_shapes() -> list:
    """(case, config, tokens) of the fp32 parity cuts' LMs, whose training
    kernels run fp32 (csrc/flash_train.cu): the 0.5B (14 heads of 64 over
    2), Gemma-2B (8 of 256 over 1) and the 7B (28 of 128 over 4)."""
    return [("lm_train_f32", VLMConfig.onevision_0_5b(),
             _parity_tokens(VLMConfig.onevision_0_5b(), PARITY_FRAMES, 8)),
            ("gemma_train_f32", _gemma_config(), _parity_tokens(_gemma_config(), PARITY_FRAMES, 2)),
            ("lm_train_7b_f32", VLMConfig.onevision_7b(),
             _parity_tokens(VLMConfig.onevision_7b(), PARITY_7B_FRAMES, 2))]


def phase_train_kernels():
    """forward_with_lse, backward_dq and backward_dkv at the 0.5B LM's
    training shape (S = 9557, 14 heads of 64 over 2 KV heads) and at
    Gemma-2B's (8 heads of 256 over one KV head), each timed with its
    controls, in fp32 timed at the fp32 parity cuts' LM shapes
    (`_f32_train_shapes`), and at edge cases (`TRAIN_EDGES`), in bf16 and
    fp32; then #1's backward. Returns (the kernels line's rows, #1's
    backward row)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    s = TRAIN_TOKENS
    main = {64: _train_kernels_case("lm_train", gen, 1, s, s, 14, 2, 64, True, (s,),
                                    timed=True),
            flash.D256: _train_kernels_case("gemma_train", gen, 1, s, s, 8, 1, flash.D256,
                                            True, (s,), timed=True)}
    # head dims 64 and 128 share the wrappers of the first rows, 256 has its own
    errs = {d: {name: [row["max_abs_err"]] for name, row in rows.items()}
            for d, rows in main.items()}
    for name, b, sq, skv, h, hkv, d, causal, valid, dtypes in TRAIN_EDGES:
        for dtype in dtypes:
            rows = _train_kernels_case(f"{name}_{str(dtype).split('.')[-1]}", gen, b, sq, skv,
                                       h, hkv, d, causal, valid, dtype)
            for kname, row in rows.items():
                errs[flash.D256 if d == flash.D256 else 64][kname].append(row["max_abs_err"])
    f32 = {d: {name: [] for name in TRAIN_REPLACES} for d in (64, flash.D256)}
    for case, cfg, s in _f32_train_shapes():
        lm = cfg.lm
        rows = _train_kernels_case(case, gen, 1, s, s, lm.num_attention_heads,
                                   lm.num_key_value_heads, lm.head_dim, True, (s,),
                                   torch.float32, parity_shape=True)
        d = flash.D256 if lm.head_dim == flash.D256 else 64
        for kname, row in rows.items():
            errs[d][kname].append(row["max_abs_err"])
            f32[d][kname].append(row)
    backward = _flash_backward_check(gen)
    kernels = (_train_kernel_rows(main[64], errs[64], f32[64])
               + _train_kernel_rows(main[flash.D256], errs[flash.D256], f32[flash.D256], "_d256"))
    return kernels, backward


# ------------------------------------------------------------ requests

WRAPPERS = {
    "flash_fwd": flash.flash_attention,
    "flash_fwd_d448": flash.flash_forward_wide,
    "flash_fwd_d256": flash.flash_forward_d256,
    "fused_qkv_int8": qkv_int8.fused_qkv_int8,
    "flash_attention_merge_heads": flash.flash_attention_merge_heads,
    "fused_mlp_block_int8": mlp_int8.fused_mlp_block_int8,
    "flash_fwd_lse": flash_bwd.forward_with_lse,
    "flash_bwd_dq": flash_bwd.backward_dq,
    "flash_bwd_dkv": flash_bwd.backward_dkv,
    "flash_fwd_lse_d256": flash_bwd.forward_with_lse_d256,
    "flash_bwd_dq_d256": flash_bwd.backward_dq_d256,
    "flash_bwd_dkv_d256": flash_bwd.backward_dkv_d256,
    "flash_fwd_d256_f32": flash.flash_forward_d256_f32,
    "flash_fwd_d448_f32": flash.flash_forward_d448_f32,
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


def _attn_kernel(head_dim: int, dtype=torch.bfloat16) -> str:
    """The wrapper (WRAPPERS' name) that counts #1 at a head dim and dtype."""
    if head_dim == flash.WIDE_HEAD_DIM:
        return "flash_fwd_d448_f32" if dtype == torch.float32 else "flash_fwd_d448"
    if head_dim == flash.D256:
        return "flash_fwd_d256_f32" if dtype == torch.float32 else "flash_fwd_d256"
    return "flash_fwd"


def _train_kernel_names(head_dim: int) -> tuple:
    """The wrappers that count the training kernels (#9, #10, #11) at a head
    dim: head dim 256 has its own."""
    suffix = "_d256" if head_dim == flash.D256 else ""
    return tuple(n + suffix for n in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"))


def _lm_train_launches(cfg: VLMConfig, steps: int = 1, passes: int = 1) -> dict:
    """The LM's training kernels over `steps` steps of `passes` LM passes
    with a backward each: its forward twice a layer under remat."""
    lm = cfg.lm.num_hidden_layers * steps * passes
    fwd, dq, dkv = _train_kernel_names(cfg.lm.head_dim)
    return {**dict.fromkeys(WRAPPERS, 0), fwd: 2 * lm, dq: lm, dkv: lm}


def _expected_train_launches(cfg: VLMConfig, num_frames: int,
                             dtype=torch.bfloat16) -> dict:
    """One train step: the frozen tower and the memory through #1 (the
    memory's backward is a plain recompute), each LM layer through the
    training kernels, its forward twice under remat. Each at its head dim's
    wrapper (Gemma-2B's memory and LM at 256); `dtype` is the activations'."""
    want = _lm_train_launches(cfg)
    want[_attn_kernel(cfg.vision.hidden_size // cfg.vision.num_attention_heads, dtype)] += \
        cfg.vision.num_used_layers
    want[_attn_kernel(cfg.memory.hidden_size // cfg.memory.num_attention_heads, dtype)] += \
        _memory_calls(cfg, num_frames)
    return want


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
    (`_decode_again`), CUDA events after a warm-up: the graph's the median
    of 5, the eager loop's one run (~5 s of host-bound work a run at
    int8)."""
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
    eager_ms = _time_ms(lambda: _decode_again(*started[2]), reps=1)
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


# ------------------------------------------------------------ Gemma-2B

# google/gemma-2b's published config.json (its LM widths; tied embeddings,
# which GemmaConfig defaults to and JAX's registry does not), as a
# llava_gemma checkpoint carries it, with the SigLIP-SO400M tower. Its
# memory runs at the LM's width: 2048 over 8 heads, #1 at head dim 256.
GEMMA_2B = {
    "model_type": "llava_gemma", "vocab_size": 256000, "hidden_size": 2048,
    "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8,
    "num_key_value_heads": 1, "head_dim": 256, "hidden_act": "gelu", "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "tie_word_embeddings": True,
    "mm_vision_tower": "google/siglip-so400m-patch14-384"}
GEMMA_FRAMES = 64  # two segments: the memory's fuse and evolve both run at D = 256
GEMMA_NEW = 32
# The 2-layer cut, bf16 on the card (the requests' path) against fp32 on
# the CPU (fp32 at head dim 256 on the card is held by `_f32_cases` and
# `phase_train_parity_gemma`): prefill logits held to
# FUSED_FLOOR_FACTOR times the bf16 floor of the same run, the CPU in bf16
# against the CPU in fp32, in RMS over the logits' spread and in the
# largest element; a wrong kernel lands near 1 std.
GEMMA_PARITY_FRAMES = 8


def _gemma_config(**extra) -> VLMConfig:
    """`config_from_json` of the Gemma-2B llava_gemma config (plus `extra`
    fields), as `load_pretrained_model` builds it."""
    return config_from_json({**GEMMA_2B, **extra})


def _d256_calls(calls: list):
    """Records the (q, kv, valid, causal) of every #1 call at head dim 256
    into `calls`, around `flash._flash_forward` (the counts stay the
    wrappers' own)."""
    real = flash._flash_forward

    def spy(q, k, v, kv_valid_len, causal, scale, kv_groups):
        if q.shape[-1] == flash.D256:
            calls.append((tuple(q.shape), tuple(k.shape), tuple(kv_valid_len.tolist()),
                          bool(causal)))
        return real(q, k, v, kv_valid_len, causal, scale, kv_groups)

    return _patched(flash, "_flash_forward", spy)


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _gemma_launches(cfg: VLMConfig, num_frames: int) -> dict:
    """One Gemma request: the tower's kernels (bf16: #1 at its head dim 72;
    int8: its three int8 kernels), #1 at head dim 256 once per memory
    cross-attention and once per LM layer in the prefill."""
    want = (_expected_tower_launches(cfg, False) if cfg.pipeline.tower_int8
            else {**dict.fromkeys(WRAPPERS, 0), "flash_fwd": cfg.vision.num_used_layers})
    want["flash_fwd_d256"] = _memory_calls(cfg, num_frames) + cfg.lm.num_hidden_layers
    return want


def _gemma_request(label, cfg, params, gen, kv_int8, calls: list) -> dict:
    """A GEMMA_FRAMES-frame request through the entry points a user calls,
    `vlm.clip_embeds` then `vlm.generate` (greedy, GEMMA_NEW tokens, its
    captured decoder; `kv_int8` quantizes the prefill's cache): launches
    held, the decode's graph against the eager loop (tokens and every
    step's logits bit-equal), tokens in the vocabulary, finite logits; then
    three repetitions with the stages synchronised and timed. Returns the
    request's launches."""
    dev = "cuda"
    frames = torch.randn((GEMMA_FRAMES, 384, 384, 3), generator=gen,
                         device=dev).to(torch.bfloat16)
    tb, ta = torch.tensor(TEXT_BEFORE, device=dev), torch.tensor(TEXT_AFTER, device=dev)

    def request(cuda_graph=True):
        emb = vlm.clip_embeds(params, cfg, frames, tb, ta)
        return vlm.generate(params, cfg, emb, max_new_tokens=GEMMA_NEW, eos_token_ids=(),
                            return_logits=True, kv_int8=kv_int8, cuda_graph=cuda_graph)

    counted = _Counted(label)
    want = _gemma_launches(cfg, GEMMA_FRAMES)
    with _d256_calls(calls):
        result, rows = _graph_and_eager(label, lambda g: counted("request",
                                                                 lambda: request(g), want))
    tokens = result.tokens
    if tokens.shape != (GEMMA_NEW,) or not bool(((tokens >= 0)
                                                 & (tokens < cfg.lm.vocab_size)).all()):
        raise RuntimeError(f"{label}: bad tokens {tokens.tolist()}")
    if rows.shape != (GEMMA_NEW, cfg.lm.vocab_size) or not bool(torch.isfinite(rows).all()):
        raise RuntimeError(f"{label}: non-finite or misshapen logits")
    reps = []
    for _ in range(3):
        totals = {}
        with _stage_clock(totals):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            totals["total"] = time.perf_counter() - t0
        reps.append(totals)
    log(json.dumps({"request": label, "frames": GEMMA_FRAMES,
                    "spliced": _spliced_len(cfg, GEMMA_FRAMES), "launches": counted.total,
                    "tokens": tokens.tolist(), "distinct_tokens": len(set(tokens.tolist())),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                    "stage_seconds": {k: [r.get(k, 0.0) for r in reps] for k in reps[0]}}))
    vlm.clear_decoders()
    return counted.total


def _gemma_parity_setup():
    """(the 2 + 2-layer cut of Gemma-2B's config, its seeded bf16 params on
    the CPU, the seeded pixels, the pipeline)."""
    full = _gemma_config()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, num_hidden_layers=3),  # 2 used
        lm=dataclasses.replace(full.lm, num_hidden_layers=2))
    bf16 = vlm.init_params(cfg, seed=7, device="cpu", dtype=torch.bfloat16)
    gen = torch.Generator()
    gen.manual_seed(8)
    pixels = torch.randn((GEMMA_PARITY_FRAMES, 384, 384, 3), generator=gen)
    fn, _ = pipeline.build_pipeline(cfg, GEMMA_PARITY_FRAMES, return_logits=True,
                                    max_new_tokens=8)
    return cfg, bf16, pixels, fn


def _gemma_parity_cpu():
    """`_gemma_parity`'s CPU half: the cut's request in fp32 (tokens, spliced
    length, logits) and in bf16 (logits), and its seconds."""
    _, bf16, pixels, fn = _gemma_parity_setup()
    f32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, bf16)
    tb, ta = torch.tensor(TEXT_BEFORE), torch.tensor(TEXT_AFTER)
    t0 = time.perf_counter()
    tok_c, s_c, lg_c = fn(f32, pixels, tb, ta)
    _, _, lg_b = fn(bf16, pixels.to(torch.bfloat16), tb, ta)
    return tok_c, s_c, lg_c, lg_b, time.perf_counter() - t0


def _gemma_parity():
    """The Gemma-2B config cut to 2 tower and 2 LM layers: a GEMMA_PARITY_FRAMES
    clip through `pipeline.build_pipeline` (8 greedy tokens), bf16 weights on
    the card against the same weights in fp32 on the CPU, held to
    FUSED_FLOOR_FACTOR times the CPU's own bf16 floor (the CPU in bf16 against
    the CPU in fp32); greedy tokens agree while the CPU's top-2 margin
    exceeds the difference."""
    cfg, bf16, pixels, fn = _gemma_parity_setup()
    tb, ta = torch.tensor(TEXT_BEFORE), torch.tensor(TEXT_AFTER)
    _reset_launches()
    tok_g, s_g, lg_g = fn(_to_cuda(bf16), pixels.cuda().to(torch.bfloat16), tb.cuda(),
                          ta.cuda())
    torch.cuda.synchronize()
    want = _gemma_launches(cfg, GEMMA_PARITY_FRAMES)
    if _launches() != want:
        raise RuntimeError(f"gemma parity: launches {_launches()}, want {want}")
    tok_c, s_c, lg_c, lg_b, cpu_s = _cpu_reference("gemma_parity", _gemma_parity_cpu)
    ref = lg_c[0]
    err, floor_err = [float((x[0].float().cpu() - ref).abs().max()) for x in (lg_g, lg_b)]
    rms, floor_rms = [float((x[0].float().cpu() - ref).pow(2).mean().sqrt() / ref.std())
                      for x in (lg_g, lg_b)]
    compared = 0
    for step in range(tok_c.shape[0]):
        if _margin(lg_c[step, 0]) <= err:
            break
        if int(tok_g[step, 0]) != int(tok_c[step, 0]):
            raise RuntimeError(f"gemma parity: greedy token {step} differs: "
                               f"{tok_g[:, 0].tolist()} vs {tok_c[:, 0].tolist()}")
        compared += 1
    row = {"parity": "gemma-2b cut to 2 + 2 layers, bf16 card vs fp32 cpu", "spliced": s_c,
           "prefill_logits_max_abs_err": err, "prefill_logits_rms_err_over_std": rms,
           "cpu_bf16_floor_max_abs": floor_err, "cpu_bf16_floor_rms_over_std": floor_rms,
           "tol": f"{FUSED_FLOOR_FACTOR} x the floor, both", "tokens_compared": compared,
           "tokens_card": tok_g[:, 0].tolist(), "tokens_cpu": tok_c[:, 0].tolist(),
           "cpu_runs_s": cpu_s}
    log(json.dumps(row))
    if s_g != s_c or not (rms <= FUSED_FLOOR_FACTOR * floor_rms
                          and err <= FUSED_FLOOR_FACTOR * floor_err):
        raise RuntimeError(f"gemma parity: card and cpu disagree ({row})")
    vlm.clear_decoders()


# small checkpoints of the ported families, as `load_pretrained_model` reads
# them: an LM of 2 layers whose head dims the card's #1 takes (64, and
# Gemma's 256), the memory at 512 / 8 = 64, a SigLIP tower of 2 heads of 64
# at 56 px (the loader infers hidden // 64 heads); the vocabulary holds the
# memory's prompt ids (up to 48876)
FAMILY_BASE = {"vocab_size": 50000, "num_hidden_layers": 2, "hidden_size": 512,
               "intermediate_size": 1024, "max_position_embeddings": 8192,
               "mm_vision_tower": "google/siglip-so400m-patch14-384"}
FAMILY_LMS = {
    "llava_llama": {"num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 64,
                    "rope_theta": 500000.0, "rms_norm_eps": 1e-5},
    "llava_mistral": {"num_attention_heads": 8, "num_key_value_heads": 2, "head_dim": 64,
                      "rope_theta": 1000000.0, "rms_norm_eps": 1e-5, "sliding_window": 4096},
    "llava_gemma": {"num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 256,
                    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                    # one activation under both names: JAX's registry reads
                    # hidden_activation first, HF's GemmaMLP (4.57) hidden_act
                    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
                    "tie_word_embeddings": True},
}
FAMILY_TOWER = VisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=3,
                            num_attention_heads=2, image_size=56, patch_size=14)


def family_checkpoint(directory, family: str, *, device="cpu", seed=11, **lm_fields):
    """Writes a small `family` checkpoint (FAMILY_LMS, FAMILY_BASE, with
    `lm_fields` over them) into `directory`: seeded fp32 params, every LM
    norm weight 1 + 0.1 N(0, 1), written by `export_hf_safetensors` (HF key
    names; no q/k/v biases outside Qwen2) and a config.json with the family's
    HF fields. Returns (raw config, cfg, params)."""
    raw = {**FAMILY_BASE, **FAMILY_LMS[family], **lm_fields, "model_type": family}
    cfg = dataclasses.replace(config_from_json(raw), vision=FAMILY_TOWER)
    params = vlm.init_params(cfg, seed=seed, device=device, dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    lm = params["language_model"]

    def noisy(w):
        return 1 + 0.1 * torch.randn(w.shape, generator=gen, device=device)

    lm["norm"] = noisy(lm["norm"])
    for layer in lm["layers"]:
        for name in ("input_layernorm", "post_attention_layernorm"):
            layer[name] = noisy(layer[name])
    export_hf_safetensors(params, cfg, str(directory))
    with open(Path(directory) / "config.json") as f:
        written = json.load(f)
    with open(Path(directory) / "config.json", "w") as f:
        json.dump({**written, **raw}, f, indent=2)
    return raw, cfg, params


FAMILY_FRAMES = 8


def _family_loads() -> dict:
    """Each FAMILY_LMS checkpoint written under build/, loaded on the card by
    `load_pretrained_model` in bf16 (every leaf bit-equal to the source's
    rounded to bf16), then `MavlmForCausalLM.generate` of an 8-frame uint8
    clip and of a text prompt, 8 greedy tokens each: launches held (#1 at
    the tower's and the memory's head dim 64, and the LM's prefill at its
    own: 64, or 256 for Gemma), tokens in the vocabulary. Returns each
    load's launches."""
    launches = {}
    clip = np.random.default_rng(12).integers(0, 256, (FAMILY_FRAMES, 480, 640, 3),
                                              dtype=np.uint8)
    video_ids = np.array([[3, 14, 15, constants.IMAGE_TOKEN_INDEX, 92, 65, 35, 89]])
    text_ids = np.array([[5, 17, 301, 42]])
    for family in FAMILY_LMS:
        directory = Path(__file__).resolve().parent / "build" / f"family_{family}"
        shutil.rmtree(directory, ignore_errors=True)
        _, cfg, source = family_checkpoint(directory, family, device="cuda")
        t0 = time.perf_counter()
        _, model, _, _ = load_pretrained_model(str(directory))
        load_s = time.perf_counter() - t0
        _loaded_leaves_equal(f"{family} load", model.params,
                             tree_map(lambda x: x.to(torch.bfloat16), source))
        if model.cfg.lm != cfg.lm:
            raise RuntimeError(f"{family}: loaded {model.cfg.lm}, want {cfg.lm}")
        lm_kernel = "flash_fwd_d256" if cfg.lm.head_dim == flash.D256 else "flash_fwd"
        text = {lm_kernel: cfg.lm.num_hidden_layers}
        video = {"flash_fwd": cfg.vision.num_used_layers + _memory_calls(cfg, FAMILY_FRAMES)}
        video[lm_kernel] = video.get(lm_kernel, 0) + cfg.lm.num_hidden_layers
        counted = _Counted(f"{family} load")
        out = counted("generate, video", lambda: model.generate(
            video_ids, images=[clip], modalities=["video"], max_new_tokens=8), video)
        said = counted("generate, text", lambda: model.generate(text_ids, max_new_tokens=8),
                       text)
        for what, toks in (("video", out), ("text", said)):
            if toks.shape[0] != 1 or not ((toks >= 0) & (toks < cfg.lm.vocab_size)).all():
                raise RuntimeError(f"{family} {what}: bad tokens {toks.tolist()}")
        log(json.dumps({"family_load": family, "lm": dataclasses.asdict(cfg.lm),
                        "load_s": load_s, "tokens_video": out[0].tolist(),
                        "tokens_text": said[0].tolist(), "launches": counted.total}))
        launches[f"{family}_load"] = counted.total
        vlm.clear_decoders()
        del model, source
        shutil.rmtree(directory, ignore_errors=True)
    return launches


def phase_requests_gemma():
    """The repo's VLM with Gemma-2B's LM (GEMMA_2B through
    `eval.builder.config_from_json`, random weights from a seed, every LM
    matrix times 5 (`_lively`) so that greedy tokens vary): a
    64-frame request in bf16, then in the `load_8bit` form (the tower
    prequantized, the LM with its int8 unembedding table of 256000 x 2048,
    an int8 KV cache), each with its launches, graph decode against the
    eager loop and stage times; then #1 at head dim 256 held to its plain
    version at the shapes those requests gave it (`_d256_cases`); then the
    2-layer cut, card against CPU (`_gemma_parity`); then the small
    llava_llama, llava_mistral and llava_gemma checkpoints
    (`_family_loads`). Returns (#1 at D = 256's kernels row, launches by
    path)."""
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cfg = _gemma_config()
    t0 = time.perf_counter()
    params = _lively(vlm.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    log(f"init Gemma-2B VLM bf16 params: {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GB; lm {dataclasses.asdict(cfg.lm)}")
    calls = []
    launches = {"gemma_bf16_64_frames": _gemma_request("gemma-2b bf16", cfg, params, gen,
                                                       False, calls)}
    params = pipeline.int8_serving_params(params)
    launches["gemma_int8_64_frames"] = _gemma_request(
        "gemma-2b int8", _gemma_config(tower_int8=True), params, gen, True, calls)
    del params
    torch.cuda.empty_cache()
    names = {(False, 15680): "memory_evolve_gemma", (False, 6272): "memory_fuse_gemma",
             (True, None): "lm_prefill_gemma"}
    shapes = {}
    for q, kv, valid, causal in calls:
        name = names[(True, None)] if causal else names.get((False, kv[1]), f"cross_{kv[1]}")
        shapes.setdefault((q, kv, valid, causal), name)
    log(json.dumps({"d256_shapes": [[n, *key] for key, n in shapes.items()]}))
    row = _d256_cases([(n, q, kv, valid, causal) for (q, kv, valid, causal), n in shapes.items()])
    _gemma_parity()
    launches.update(_family_loads())
    return row, launches


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


def _image_visual_tokens(cfg: VLMConfig, size) -> int:
    """The visual tokens `image_path.build_image_embeds` gives an anyres
    image of `size` (W, H) under `cfg` (spatial_unpad, anyres_max_N): the
    base view's patches, then the unpadded grid, downscaled to the patch
    budget where it exceeds it by more than 1.1, with a newline column."""
    side = cfg.vision.num_patches_per_side
    pipe = cfg.pipeline
    npw, nph = image_path.get_anyres_image_grid_shape(size, pipe.image_grid_pinpoints,
                                                      cfg.vision.image_size)
    _, gh, gw = image_path.unpad_image_map(torch.empty(0, nph * side, npw * side), size).shape
    budget = int(re.match(r"anyres_max_(\d+)", pipe.image_aspect_ratio).group(1)) * side ** 2
    times = math.sqrt(gh * gw / budget)
    if times > 1.1:
        gh, gw = int(gh // times), int(gw // times)
    return side * side + gh * (gw + 1)


def _image_spliced_len(cfg: VLMConfig, size) -> int:
    return len(TEXT_BEFORE) + len(TEXT_AFTER) + _image_visual_tokens(cfg, size)


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
    """A whole call (CUDA events, the median of `reps` after a warm-up; the
    eager, host-bound entries take one) and its decode ms/token, the
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
                                         reps=1)}

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
    chunk_emb = qwen2.embed_tokens(lm, free.tokens[None].long(), cfg.lm).to(emb.dtype)
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
    times["speculative"] = _entry_ms(speculative, prefill_ms, n, reps=1)
    times["speculative_own_tokens_in_corpus"] = _entry_ms(lambda: speculative(spec_toks),
                                                          prefill_ms, n, reps=1)

    # score_continuation of the greedy continuation
    full = torch.cat([emb, qwen2.embed_tokens(lm, free.tokens.long(), cfg.lm).to(emb.dtype)])
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
        params, cfg, emb, num_beams=1, max_new_tokens=n, eos_token_ids=()), prefill_ms, n, 1)
    times["beam_k4"] = _entry_ms(beam4, prefill_ms, n, reps=1)

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
        lambda: plain(emb16, bf16_params, bf16_cfg, cuda_graph=False), prefill16, n, reps=1)
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


# ---------------------------------------------------------------- serving

# bench_serving.py's configuration: the 0.5B LM, 4 slots of 2048 positions,
# prompts of 1500 tokens, 64 new tokens; 6 requests, so that slots recycle
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_NEW, SERVE_REQUESTS = 4, 2048, 1500, 64, 6
# every prompt opens with this shared prefix (the prefix-caching runs'),
# and its rest is a text of SERVE_PROMPT - SERVE_PREFIX tokens made of one
# repeated piece (prompt lookups hit in the speculative run)
SERVE_PREFIX, SERVE_PIECE = 512, 247
SERVE_PAGE, SERVE_CHUNK = 128, 512
# the oversubscribed pool: 48 pages of 128 hold the four 12-page prompts
# and no decode page, below the 4 x 16 of a full pool, so decode preempts
SERVE_OVERSUBSCRIBED_PAGES = 48
# the idle-slot run: requests one at a time through 4 slots of 256
# positions, 5 x 64 ticks, so an idle slot's length passes 256
IDLE_MAX_LEN, IDLE_PROMPT, IDLE_REQUESTS = 256, 64, 5


class _EngineLogits:
    """The logits each request's tokens were picked from, recorded by
    wrapping the engine's device functions (module globals it looks up at
    call time): at each one-token step (`_decode_step`, which
    `_decode_multi_step` calls, and `paged.decode_step_paged`) every active
    slot's row; at each verification (`_spec_verify_step`) the row its
    chunk's first token came from and the verified rows of its accepted
    drafts (the step's `qwen2.unembed` output, its accepted count read
    after the run). Kept under each request's output queue, the object
    itself (an id could be reused once a queue is freed); the copies stay
    on the card, with no read back during the run."""

    def __init__(self):
        self.engine, self.rows = None, {}

    def _active(self):
        eng = self.engine
        pending = eng._pending[0] if eng._pending else None
        return [(s, req) for s, req in enumerate(eng._slots)
                if req is not None and req is not pending]

    def _step(self, fn):
        def recorded(params, cfg, logits, *args, **kw):
            for s, req in self._active():
                self.rows.setdefault(req.out, []).append(logits[s].clone())
            return fn(params, cfg, logits, *args, **kw)
        return recorded

    def _verify(self, fn):
        def recorded(params, cfg, logits, *args, **kw):
            slots, unembeds, unembed = self._active(), [], qwen2.unembed

            def kept(lm, hidden):
                unembeds.append(unembed(lm, hidden))
                return unembeds[-1]

            qwen2.unembed = kept
            try:
                out = fn(params, cfg, logits, *args, **kw)
            finally:
                qwen2.unembed = unembed
            for s, req in slots:
                self.rows.setdefault(req.out, []).extend(
                    [logits[s].clone(), (unembeds[-1], out[0], s)])
            return out
        return recorded

    def of(self, out, n: int) -> torch.Tensor:
        """The first n rows of the request whose output queue is `out`."""
        rows = []
        for item in self.rows[out]:
            if isinstance(item, tuple):
                verified, packed, s = item
                rows.extend(verified[s, :int(packed[s, 0])])
            else:
                rows.append(item)
        return torch.stack(rows[:n])

    def accepted(self) -> int:
        """The drafts accepted over the run's verifications."""
        return sum(int(item[1][item[2], 0]) for items in self.rows.values()
                   for item in items if isinstance(item, tuple))

    @contextlib.contextmanager
    def installed(self):
        names = ((batch_engine, "_decode_step", self._step),
                 (paged_kv, "decode_step_paged", self._step),
                 (batch_engine, "_spec_verify_step", self._verify))
        saved = [getattr(mod, name) for mod, name, _ in names]
        for (mod, name, wrap), fn in zip(names, saved):
            setattr(mod, name, wrap(fn))
        try:
            yield self
        finally:
            for (mod, name, _), fn in zip(names, saved):
                setattr(mod, name, fn)


@contextlib.contextmanager
def _no_engine_errors(label):
    """Raises after the block if the engine logged at ERROR or above (it
    drops a failed request and serves on, which on the card would look like
    a short answer)."""
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = records.append
    engine_log = logging.getLogger("batch_engine")
    engine_log.addHandler(handler)
    try:
        yield
    finally:
        engine_log.removeHandler(handler)
    if records:
        raise RuntimeError(f"{label}: the engine logged {[r.getMessage() for r in records]}")


def _serve_prompts(rng, vocab) -> list:
    prefix = rng.integers(0, vocab, SERVE_PREFIX)
    rest = SERVE_PROMPT - SERVE_PREFIX
    return [np.concatenate([prefix, np.resize(rng.integers(0, vocab, SERVE_PIECE), rest)])
            for _ in range(SERVE_REQUESTS)]


def _serve_references(lm_params, cfg, embeds, kv_int8=False) -> list:
    """`vlm.generate(..., return_logits=True)` of each prompt on the card,
    with the engine's cache (`kv_int8`: the prefill's quantized, as the
    engine's): (tokens, logits rows)."""
    out = []
    for emb in embeds:
        res, rows = vlm.generate(lm_params, cfg, emb, max_new_tokens=SERVE_NEW, eos_token_ids=(),
                                 return_logits=True, kv_int8=kv_int8)
        out.append((res.tokens.cpu(), rows))
    return out


def _serving_run(label, lm_params, cfg, embeds, refs, engine_kw, *, prefix=None,
                 draft_ids=None, want_flash=None):
    """One engine over `embeds` (the suffixes after `prefix` when it is
    given): every request submitted at once, bench_serving's figures
    (decode tokens/s over the steady phase after each slot's first token,
    time to those first tokens, ms per tick), its stats and peak memory,
    flash_fwd's launches against `want_flash`, and each request's 64 tokens
    held to its reference by the margin rule (`_greedy_agreement` on the
    logits `_EngineLogits` recorded)."""
    rec = _EngineLogits()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = batch_engine.BatchEngine(lm_params, cfg, num_slots=SERVE_SLOTS,
                                      max_len=SERVE_MAX_LEN, **engine_kw)
    rec.engine = engine
    _reset_launches()
    with _no_engine_errors(label), rec.installed():
        engine.start()
        try:
            if prefix is not None:
                engine.set_prefix(prefix)
            t0 = time.perf_counter()
            outs = [engine.submit(e, max_new_tokens=SERVE_NEW, eos_token_ids=(),
                                  use_prefix=prefix is not None,
                                  draft_ids=() if draft_ids is None else draft_ids[i])
                    for i, e in enumerate(embeds)]
            got = [[] for _ in outs]
            for i, o in enumerate(outs[:engine.num_slots]):
                first = o.get(timeout=600)
                if first is None:
                    raise RuntimeError(f"{label}: request {i} returned no token")
                got[i].append(first)
            t_first = time.perf_counter() - t0
            rounds0 = engine.stats["decode_rounds"]
            t1 = time.perf_counter()
            for i, o in enumerate(outs):
                while (item := o.get(timeout=600)) is not None:
                    got[i].append(item)
            steady = time.perf_counter() - t1
        finally:
            engine.shutdown()
    torch.cuda.synchronize()
    launches = _launches()
    if engine._thread.is_alive():
        raise RuntimeError(f"{label}: the engine thread did not stop")
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_fwd": want_flash(engine)}
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")
    tokens = [np.concatenate(g) for g in got]
    held, diff = [], 0.0
    for i, (toks, (ref_tokens, ref_rows)) in enumerate(zip(tokens, refs)):
        if toks.shape != (SERVE_NEW,):
            raise RuntimeError(f"{label}: request {i} returned {toks.shape[0]} tokens")
        agree = _greedy_agreement(f"{label} request {i}", ref_tokens, ref_rows,
                                  torch.from_numpy(toks), rec.of(outs[i], SERVE_NEW),
                                  BATCHED_LOGIT_TOL)
        diff = max(diff, agree["max_logit_diff"])
        held.append(agree["share_held"])
    steady_tokens = sum(len(t) for t in tokens) - engine.num_slots
    rounds = engine.stats["decode_rounds"] - rounds0
    row = {"serving": label, "decode_tokens_per_s": steady_tokens / steady,
           "time_to_first_tokens_s": t_first, "steady_s": steady, "decode_rounds": rounds,
           "ms_per_tick": 1e3 * steady / max(rounds, 1), "stats": dict(engine.stats),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "share_held": held, "max_logit_diff": diff, "accepted_drafts": rec.accepted(),
           "tokens": tokens[0][:8].tolist()}
    log(json.dumps(row))
    return row, engine


def _idle_slot_run(cfg, lm_params):
    """Step 0's case at full width: a 4-slot engine of 256 positions serves
    five 64-token requests one at a time (more than 256 ticks); slot 0
    takes every request, slots 1-3 stay idle while their lengths pass 256
    (their writes drop), and every request keeps its reference's tokens."""
    rng = np.random.default_rng(6)
    lm = lm_params["language_model"]
    ids = [rng.integers(0, cfg.lm.vocab_size, IDLE_PROMPT) for _ in range(IDLE_REQUESTS)]
    embeds = [lm["embed_tokens"][torch.as_tensor(i, device="cuda")] for i in ids]
    refs = _serve_references(lm_params, cfg, embeds)
    rec = _EngineLogits()
    engine = batch_engine.BatchEngine(lm_params, cfg, num_slots=SERVE_SLOTS,
                                      max_len=IDLE_MAX_LEN)
    rec.engine = engine
    shares = []
    _reset_launches()
    with _no_engine_errors("serving, idle slots"), rec.installed():
        engine.start()
        try:
            for i, emb in enumerate(embeds):
                out = engine.submit(emb.float().cpu().numpy(), max_new_tokens=SERVE_NEW,
                                    eos_token_ids=())
                toks = []
                while (item := out.get(timeout=600)) is not None:
                    toks.append(item)
                    if any(r is not None for r in engine._slots[1:]):
                        raise RuntimeError("serving, idle slots: a request left slot 0")
                toks = np.concatenate(toks)
                if toks.shape != (SERVE_NEW,):
                    raise RuntimeError(f"serving, idle slots: request {i} returned "
                                       f"{toks.shape[0]} tokens")
                rows = rec.of(out, SERVE_NEW)
                shares.append(_greedy_agreement(
                    f"serving, idle slots, request {i}", refs[i][0], refs[i][1],
                    torch.from_numpy(toks), rows, BATCHED_LOGIT_TOL)["share_held"])
        finally:
            engine.shutdown()
    torch.cuda.synchronize()
    lengths = engine._cache.length.tolist()
    if engine._len[1:] != [0] * (SERVE_SLOTS - 1) or min(lengths[1:]) <= IDLE_MAX_LEN:
        raise RuntimeError(f"serving, idle slots: host lengths {engine._len}, device {lengths}")
    launches = _launches()
    if launches["flash_fwd"] != cfg.lm.num_hidden_layers * IDLE_REQUESTS:
        raise RuntimeError(f"serving, idle slots: launches {launches}")
    log(json.dumps({"serving": "idle slots", "device_lengths": lengths,
                    "decode_rounds": engine.stats["decode_rounds"], "share_held": shares}))
    return launches


def phase_serving():
    """The continuous-batching engine (`serve/batch_engine.py`, the paged
    cache of `models/paged.py`) at bench_serving.py's configuration: the
    0.5B LM in bf16 with every matrix times 5 (`_lively`), 4 slots of 2048
    positions, six 1500-token prompts sharing a 512-token prefix, 64 new
    tokens each, greedy, one engine per run: plain; kv_int8;
    chunk_prefill=512 (every prompt in 3 chunks); speculative=4 (the draft corpus is each prompt's ids
    and its reference's tokens, as when an answer quotes its context:
    verify forwards and accepted drafts); decode_ticks=4; the prefix
    through set_prefix, contiguous and paged; paged_page_size=128 with a
    full pool, and oversubscribed (48 pages: preemptions); the int8 LM
    (prequantize_int8 with the unembedding) with kv_int8; then the idle-slot
    run (`_idle_slot_run`). Each request's tokens are held to
    `vlm.generate` of the same prompt on the card (with the run's cache:
    the prefill's quantized for kv_int8) by the margin rule; no
    engine record at ERROR; flash_fwd 24 per one-shot prefill and per
    set_prefix, 0 from chunks, decode and verify. Returns the phase's
    launches."""
    t_phase = time.perf_counter()
    cfg = VLMConfig.onevision_0_5b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    lm_params = _lively({"language_model": qwen2.init_params(cfg.lm, gen, "cuda",
                                                             dtype=torch.bfloat16)})
    lm = lm_params["language_model"]
    ids = _serve_prompts(np.random.default_rng(5), cfg.lm.vocab_size)
    embeds = [lm["embed_tokens"][torch.as_tensor(i, device="cuda")] for i in ids]
    host = [e.float().cpu().numpy() for e in embeds]
    suffixes = [h[SERVE_PREFIX:] for h in host]
    prefix = host[0][:SERVE_PREFIX]
    refs = _serve_references(lm_params, cfg, embeds)
    distinct = len(set(refs[0][0].tolist()))
    if distinct < MIN_DISTINCT_TOKENS:
        raise RuntimeError(f"serving: the reference's 64 tokens hold {distinct} distinct ones")
    total = dict.fromkeys(WRAPPERS, 0)
    layers = cfg.lm.num_hidden_layers  # flash_fwd's launches a prefill
    prefills = lambda eng: layers * (SERVE_REQUESTS + eng.stats["preemptions"])  # noqa: E731
    rows = {}

    def run(label, kw, inputs=host, refs=refs, **extra):
        row, engine = _serving_run(f"serving, {label}", lm_params, cfg, inputs, refs, kw,
                                   want_flash=extra.pop("want_flash", prefills), **extra)
        for name, n in row["launches"].items():
            total[name] += n
        rows[label] = row
        return row, engine

    run("plain", {})
    int8_kv_refs = _serve_references(lm_params, cfg, embeds, kv_int8=True)
    run("kv_int8", {"kv_int8": True}, refs=int8_kv_refs)
    del int8_kv_refs
    run(f"chunk_prefill={SERVE_CHUNK}", {"chunk_prefill": SERVE_CHUNK},
        want_flash=lambda eng: 0)
    drafts = [tuple(int(t) for t in np.concatenate([i, r[0].numpy()])) for i, r in zip(ids, refs)]
    spec, _ = run("speculative=4", {"speculative": 4}, draft_ids=drafts)
    if not (spec["stats"]["spec_forwards"] > 0 and spec["accepted_drafts"] > 0):
        raise RuntimeError(f"serving, speculative: no accepted draft {spec}")
    run("decode_ticks=4", {"decode_ticks": 4})
    one_prefix = lambda eng: layers  # noqa: E731 (set_prefix; suffixes prefill in chunks)
    run("prefix", {}, suffixes, prefix=prefix, want_flash=one_prefix)
    run("prefix, paged", {"paged_page_size": SERVE_PAGE}, suffixes, prefix=prefix,
        want_flash=one_prefix)
    _, paged = run("paged", {"paged_page_size": SERVE_PAGE})
    if len(paged._free) != paged.num_pages:
        raise RuntimeError(f"serving, paged: {len(paged._free)} of {paged.num_pages} pages free")
    over, _ = run("paged, oversubscribed", {"paged_page_size": SERVE_PAGE,
                                            "paged_pages": SERVE_OVERSUBSCRIBED_PAGES})
    if not over["stats"]["preemptions"] > 0:
        raise RuntimeError(f"serving, oversubscribed: no preemption {over['stats']}")
    int8_params = {"language_model": qwen2.prequantize_int8(lm, include_unembed=True)}
    int8_refs = _serve_references(int8_params, cfg, embeds, kv_int8=True)
    row, _ = _serving_run("serving, int8 LM, kv_int8", int8_params, cfg, host, int8_refs,
                          {"kv_int8": True}, want_flash=prefills)
    rows["int8 LM, kv_int8"] = row
    for name, n in row["launches"].items():
        total[name] += n
    del int8_params, int8_refs
    for name, n in _idle_slot_run(cfg, lm_params).items():
        total[name] += n
    vlm.clear_decoders()
    del lm_params, refs
    torch.cuda.empty_cache()
    log(json.dumps({"serving_summary": {k: {m: r[m] for m in (
        "decode_tokens_per_s", "time_to_first_tokens_s", "ms_per_tick", "peak_mem_gb")}
        for k, r in rows.items()}, "phase_s": time.perf_counter() - t_phase}))
    return total


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"latency_s", "visual_tokens", "frames", "segments", "decode_tokens",
                     "backend"}


def _entry_line(module: str, args) -> dict:
    """`python -m memory_augmented_vlm_torch.<module> args` in a subprocess:
    its last line, parsed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"memory_augmented_vlm_torch.{module}", *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {args} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"{module} {' '.join(args) or '(default)'} ({time.perf_counter() - t0:.1f} s): {line}")
    return json.loads(line)


# bench_throughput.py's --synthetic-producer line
THROUGHPUT_DETAIL_KEYS = {"device_bound_s_per_clip", "device_preprocess_clips_per_s",
                          "device_preprocess_s_per_clip", "clips"}


def phase_entry_point():
    """`python -m memory_augmented_vlm_torch.bench` in a subprocess, with no
    flags and with `--model 7b`: its last line parses as bench.py's JSON
    (less the relay fields), with bench.py's metric name, three listed
    repetitions, backend cuda and the card. Then `... .bench_serving` with
    its defaults and `... .bench_throughput --synthetic-producer`: their
    lines in the root scripts' keys (less the relay fields), a finite
    positive value, bench_serving's backend the card and every slot's first
    token."""
    for args, model in (([], "0.5b"), (["--model", "7b"], "7b")):
        out = _entry_line("bench", args)
        detail = out.get("detail", {})
        if (set(out) != BENCH_KEYS or not BENCH_DETAIL_KEYS <= set(detail)
                or out["metric"] != port_bench.metric_name(64, model)
                or detail["backend"] != "cuda" or len(detail["latency_s_reps"]) != 3
                or not (math.isfinite(out["value"]) and out["value"] > 0)):
            raise RuntimeError(f"bench {args}: unexpected line {out}")
    serving_args = port_bench_serving.parse_args([])
    want = port_bench_serving.result(serving_args, dict.fromkeys(
        ("tokens", "rounds", "steady_s", "time_to_first_tokens_s", "first_tokens",
         "engine_stats"), 1), "card")
    out = _entry_line("bench_serving", [])
    if (set(out) != set(want) or set(out["detail"]) != set(want["detail"])
            or out["metric"] != want["metric"]
            or torch.cuda.get_device_name(0) not in out["detail"]["backend"]
            or out["detail"]["first_tokens"] != serving_args.num_slots
            or not (math.isfinite(out["value"]) and out["value"] > 0)):
        raise RuntimeError(f"bench_serving: unexpected line {out}")
    out = _entry_line("bench_throughput", ["--synthetic-producer"])
    if (set(out) != BENCH_KEYS or set(out["detail"]) != THROUGHPUT_DETAIL_KEYS
            or out["metric"] != "sustained_clips_per_s_64frame_0.5b_synthetic_producer"
            or not (math.isfinite(out["value"]) and out["value"] > 0)):
        raise RuntimeError(f"bench_throughput: unexpected line {out}")


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


def _step_state_grads(step, state, batch):
    """One train step from `state`, keeping the gradients it computes:
    (new state, metrics, [(path, gradient)])."""
    captured = []
    inner = trainer.value_and_grad_params

    def capture(*args, **kwargs):
        out = inner(*args, **kwargs)
        captured.append(out[1])
        return out

    trainer.value_and_grad_params = capture
    try:
        state, metrics = step(state, batch)
    finally:
        trainer.value_and_grad_params = inner
    return state, metrics, _leaves(captured[-1])


def _step_grads(step, state, batch):
    """(metrics, [(path, gradient)]) of one train step from `state`."""
    return _step_state_grads(step, state, batch)[1:]


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


# the parity cuts' train step: 40 real frames of 64 padded, 2 segments, so
# that the memory's evolve is differentiated; the 7B cut takes the fewest
# frames of 2 segments (the fuse and the evolve at head dim 448 both run),
# which keeps its CPU half short
PARITY_FRAMES = 40
PARITY_7B_FRAMES = 33


def _parity_cut(full: VLMConfig) -> VLMConfig:
    """`full` cut to 2 tower and 2 LM layers, its widths kept."""
    return dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, num_hidden_layers=3),  # 2 used
        lm=dataclasses.replace(full.lm, num_hidden_layers=2))


def _train_parity_setup():
    """(the 0.5B cut, its seeded fp32 params on the CPU)."""
    cfg = _parity_cut(VLMConfig.onevision_0_5b())
    return cfg, vlm.init_params(cfg, seed=6, device="cpu", dtype=torch.float32)


def _gemma_train_parity_setup():
    """(Gemma-2B's cut, its seeded fp32 params on the CPU)."""
    cfg = _parity_cut(_gemma_config())
    return cfg, vlm.init_params(cfg, seed=12, device="cpu", dtype=torch.float32)


def _7b_train_parity_setup():
    """(the 7B config's cut: Qwen2-7B's LM widths, 3584 over 28 heads of
    128 and 4 KV heads, 18944, an untied head over 152064; the memory at
    3584 over 8 heads of 448; its seeded fp32 params on the CPU)."""
    cfg = _parity_cut(VLMConfig.onevision_7b())
    return cfg, vlm.init_params(cfg, seed=14, device="cpu", dtype=torch.float32)


def phase_train_parity():
    """One fp32 train step, full widths cut to 2 tower and 2 LM layers, 64
    padded frames of which 40 are real (2 segments, so evolve is
    differentiated) and 8 fine frames: card (kernels) against CPU (plain
    versions), the same weights and batch (`_card_vs_cpu_step`); then an
    accumulated update (`_accumulated_update_parity`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _train_parity_setup()
    _card_vs_cpu_step(f"fp32, 2 tower + 2 LM layers, {PARITY_FRAMES} frames, card vs cpu",
                      cfg, params, 8,
                      _cpu_reference("train_parity", lambda: _parity_step(
                          *_train_parity_setup(), 8, "cpu")))
    _accumulated_update_parity(cfg, params)


def _parity_step(cfg: VLMConfig, params, num_fine: int, dev: str, frames: int = PARITY_FRAMES):
    """One fp32 train step (`make_train_step`, 2 segments: `frames` of 64
    padded frames, `num_fine` fine frames, the batch from seed 7) from
    `params` on `dev`, whose gradients it keeps: (metrics as floats, [(path,
    gradient on the CPU)], seconds, launches)."""
    opt = port_bench_train.optimizer_config()  # step 0 runs at lr 0
    step = trainer.make_train_step(cfg, opt, nseg=2)
    batch = _train_batch(np.random.default_rng(7), cfg, frames, num_fine, dev, torch.float32)
    state = trainer.init_train_state(_to_cuda(params) if dev == "cuda" else params, opt)
    _reset_launches()
    t0 = time.perf_counter()
    metrics, grads = _step_grads(step, state, batch)
    if dev == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    grads = [(name, g.cpu()) for name, g in grads]
    return metrics, grads, seconds, _launches()


@contextlib.contextmanager
def _plain_on_card():
    """#1 and the training kernels' wrappers replaced by their plain
    versions, which then run on CUDA tensors too: the card computes the
    same step as the CPU without the port's kernels, for a noise floor."""
    def forward(q, k, v, kv_valid_len, causal, scale, kv_groups):
        return flash.flash_attention_reference(q, k, v, kv_valid_len, causal=causal,
                                               scale=scale, kv_groups=kv_groups)

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(flash, "_flash_forward", forward))
        for name in ("forward_with_lse", "backward_dq", "backward_dkv"):
            stack.enter_context(_patched(flash_bwd, name,
                                         getattr(flash_bwd, f"{name}_reference")))
        yield


def _held_grads(label, gg, gc, floor_err=None):
    """Every gradient leaf of a card step (gg, [(path, gradient)]) against the
    CPU's (gc): TRAIN_PARITY_RTOL of the leaf's largest magnitude plus
    TRAIN_PARITY_MODEL_RTOL of the model's, or FUSED_FLOOR_FACTOR times the
    leaf's `floor_err` where given. Returns (the model's largest |grad|,
    the five leaves nearest their tolerance)."""
    floor_err = floor_err or {}
    model_max = max(float(b.abs().max()) for _, b in gc)
    worst, outside = [], []
    for (name, a), (_, b) in zip(gg, gc):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = max(TRAIN_PARITY_RTOL * scale + TRAIN_PARITY_MODEL_RTOL * model_max,
                  FUSED_FLOOR_FACTOR * floor_err.get(name, 0.0))
        if not err <= tol:
            outside.append((name, err, scale, tol))
        worst.append((err / tol if tol else 0.0, name, err, scale, floor_err.get(name)))
    if outside:
        raise RuntimeError(f"{label}: gradient leaves outside their tolerance "
                           f"(name, err, max |grad|, tolerance): {outside}")
    return model_max, sorted(worst, reverse=True)[:5]


def _card_vs_cpu_step(label, cfg: VLMConfig, params, num_fine: int, cpu,
                      floor: bool = False, frames: int = PARITY_FRAMES) -> dict:
    """One fp32 train step (`_parity_step`) from `params` on the card, held
    against `cpu`, the same step on the CPU: the card's launches
    (`_expected_train_launches` in fp32), the loss and grad_norm to
    TRAIN_PARITY_LOSS_RTOL, every gradient leaf to TRAIN_PARITY_RTOL of its
    own largest magnitude plus TRAIN_PARITY_MODEL_RTOL of the model's (every
    leaf outside named). With `floor`, the step runs once more on the card
    through the plain versions (`_plain_on_card`), and each leaf may also
    differ by FUSED_FLOOR_FACTOR times that run's difference from the CPU:
    the noise of fp32 sums taken in another order on the card. Returns the
    logged row."""
    mg, gg, tg, launches = _parity_step(cfg, params, num_fine, "cuda", frames)
    want = _expected_train_launches(cfg, frames, torch.float32)
    if launches != want:
        raise RuntimeError(f"train parity ({label}): launches {launches}, want {want}")
    torch.cuda.empty_cache()
    mc, gc, tc, _ = cpu
    floor_err = {}
    if floor:
        with _plain_on_card():
            mf, gf, _, plain_launches = _parity_step(cfg, params, num_fine, "cuda", frames)
        if any(plain_launches.values()):
            raise RuntimeError(f"train parity ({label}): the plain run launched "
                               f"{plain_launches}")
        floor_err = {name: float((a - b).abs().max()) for (name, a), (_, b) in zip(gf, gc)}
        torch.cuda.empty_cache()
    model_max, worst = _held_grads(f"train parity ({label})", gg, gc, floor_err)
    for key in ("loss", "grad_norm"):
        a, b = mg[key], mc[key]
        if not abs(a - b) <= TRAIN_PARITY_LOSS_RTOL * abs(b):
            raise RuntimeError(f"train parity ({label}): {key} {a} on the card, {b} on the CPU")
    if int(mg["target_tokens"]) != int(mc["target_tokens"]):
        raise RuntimeError(f"train parity ({label}): target token counts differ")
    row = {"train_parity": label, "loss_card": mg["loss"], "loss_cpu": mc["loss"],
           "grad_norm_card": mg["grad_norm"], "grad_norm_cpu": mc["grad_norm"],
           "grad_leaves": len(gg), "model_max_grad": model_max,
           "launches": {k: v for k, v in launches.items() if v},
           "worst_leaves_err_over_tol_err_max_floor": worst,
           "tol": f"{TRAIN_PARITY_RTOL} of each leaf's max |grad| + "
                  f"{TRAIN_PARITY_MODEL_RTOL} of the model's"
                  + (f", or {FUSED_FLOOR_FACTOR} x the plain card run's difference"
                     if floor else ""),
           "card_step_s": tg, "cpu_step_s": tc}
    if floor:
        row["plain_card_loss"] = mf["loss"]
    log(json.dumps(row))
    return row


GEMMA_TRAIN_STEPS = 3
# the LM, memory and projector leaves a Gemma-2B step must move, and a
# frozen tower leaf it must not (paths of `_leaves`)
GEMMA_WATCHED = {
    "language_model.layers.0.q_proj.kernel": True,
    "language_model.layers.17.down_proj.kernel": True,
    "memory.recurrent_memory_transformer.memory_update_attention.q_proj.kernel": True,
    "vision_tower.layers.0.q_proj.kernel": False}


def phase_train_gemma():
    """Gemma-2B training at full width through `trainer.make_train_step`,
    as `phase_train` drives the 0.5B step: GEMMA_2B through
    `config_from_json` (18 LM layers of 8 heads of 256 over one KV head,
    vocabulary 256000; the memory at 2048 over 8 heads), seeded bf16
    weights, the SigLIP-SO400M tower frozen, bench_train's batch (64 frames,
    9557 spliced tokens, past Gemma's 8192 positions, which neither package
    bounds) and AdamW as bench_train configures it (step 0 at lr 0).
    GEMMA_TRAIN_STEPS steps on distinct batches, each timed: finite losses,
    120 target tokens, exact launches (#1 26 in the tower at head dim 72
    and 5 in the memory at 256; #9 36, #10 18, #11 18 at 256), the watched
    leaves moved or held (GEMMA_WATCHED), and the peak memory. Returns a
    step's launches."""
    dev = "cuda"
    cfg = _gemma_config()
    opt = port_bench_train.optimizer_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = vlm.init_params(cfg, seed=1, device=dev, dtype=torch.bfloat16)
    state = trainer.init_train_state(params, opt)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for _, x in _leaves(params))
    log(f"init Gemma-2B VLM bf16 params ({n_params / 1e9:.3f} B) and AdamW state: "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GB")
    watched = {name: x.clone() for name, x in _leaves(params) if name in GEMMA_WATCHED}
    if set(watched) != set(GEMMA_WATCHED):
        raise RuntimeError(f"gemma train: watched leaves {sorted(watched)}")
    del params
    nseg = vlm.pad_frames_to_segment_multiple(TRAIN_FRAMES, cfg.memory.segment_frames) \
        // cfg.memory.segment_frames
    step = trainer.make_train_step(cfg, opt, nseg=nseg)
    want = _expected_train_launches(cfg, TRAIN_FRAMES)
    rng = np.random.default_rng(11)
    times, losses, norms = [], [], []
    for i in range(GEMMA_TRAIN_STEPS):
        batch = _train_batch(rng, cfg, TRAIN_FRAMES, cfg.memory.num_fine_frames, dev,
                             torch.bfloat16)
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        loss, tokens = float(metrics["loss"]), int(metrics["target_tokens"])
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        if _launches() != want:
            raise RuntimeError(f"gemma train step {i}: launches {_launches()}, want {want}")
        if not (math.isfinite(loss) and math.isfinite(norms[-1])) \
                or tokens != TRAIN_TEXT - TRAIN_IGNORED:
            raise RuntimeError(f"gemma train step {i}: loss {loss}, grad_norm {norms[-1]}, "
                               f"target_tokens {tokens}")
        log(json.dumps({"gemma_train_step": i, "loss": loss, "grad_norm": norms[-1],
                        "seconds": times[-1]}))
    now = dict(_leaves(state.params))
    moved = {name: not torch.equal(x, now[name]) for name, x in watched.items()}
    if moved != GEMMA_WATCHED:
        raise RuntimeError(f"gemma train: leaves moved {moved}, want {GEMMA_WATCHED}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({"train": "Gemma-2B bf16, bench_train batch", "spliced": TRAIN_TOKENS,
                    "params_b": n_params / 1e9, "step_seconds": times, "losses": losses,
                    "grad_norms": norms, "peak_mem_gb": peak,
                    "launches": {k: v for k, v in want.items() if v}}))
    del state, watched, now
    torch.cuda.empty_cache()
    return want


def phase_train_parity_gemma():
    """Gemma-2B's config cut to 2 tower and 2 LM layers at full widths
    (vocabulary 256000), fp32: one train step on the card (#9-#11 at head
    dim 256 in fp32 in the LM, #1 in fp32 at 256 in the memory) against the
    CPU (plain versions) on one batch of 40 frames (2 segments, 2 fine
    frames), loss, grad_norm and every gradient leaf (`_card_vs_cpu_step`
    with its noise floor: the memory's gradients at 2048 wide nearly cancel,
    and read 2e-3 of their largest from the CPU's in the first card run).
    Returns the card step's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _gemma_train_parity_setup()
    cpu = _cpu_reference("train_parity_gemma", lambda: _parity_step(
        *_gemma_train_parity_setup(), 2, "cpu"))
    row = _card_vs_cpu_step(f"Gemma-2B fp32, 2 tower + 2 LM layers, {PARITY_FRAMES} frames, "
                            "card vs cpu",
                            cfg, params, 2, cpu, floor=True)
    return {**dict.fromkeys(WRAPPERS, 0), **row["launches"]}


def phase_train_parity_7b():
    """The 7B config cut to 2 tower and 2 LM layers at full widths
    (`_7b_train_parity_setup`), fp32: one train step on the card (#1 in fp32
    at 448 in the memory, its fuse and evolve: flash_fwd_d448_f32; #9-#11
    in fp32 at 128 in the LM; #1 at 72 in the tower) against the CPU (plain
    versions) on one batch of PARITY_7B_FRAMES frames (2 segments, 2 fine
    frames), launches held to the config's, loss, grad_norm and every
    gradient leaf (`_card_vs_cpu_step` with its noise floor). Returns the
    card step's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = _7b_train_parity_setup()
    cpu = _cpu_reference("train_parity_7b", lambda: _parity_step(
        *_7b_train_parity_setup(), 2, "cpu", PARITY_7B_FRAMES))
    row = _card_vs_cpu_step(f"7B fp32, 2 tower + 2 LM layers, {PARITY_7B_FRAMES} frames, "
                            "card vs cpu", cfg, params, 2, cpu, floor=True,
                            frames=PARITY_7B_FRAMES)
    del params, cpu
    torch.cuda.empty_cache()
    return {**dict.fromkeys(WRAPPERS, 0), **row["launches"]}


ACCUM_PARITY_FRAMES = 16  # one segment of 32 padded frames, 2 fine: the CPU half stays short


def _adam_step_bound(g, tol_g, lr, clip, eps):
    """Elementwise bound on how far Adam's first step, u = -lr * h / (|h| +
    eps) with h = clip * g (the bias corrections cancel), moves when g moves
    by up to tol_g: lr * clip * tol_g * eps / (clip * (|g| - tol_g) + eps)^2
    (the slope's largest value over the interval), at most 2 lr (a sign
    flip)."""
    low = (g.abs() - tol_g).clamp_min(0) * clip
    return torch.clamp(lr * clip * tol_g * eps / (low + eps) ** 2, max=2 * lr)


def _accumulation_config():
    return dataclasses.replace(port_bench_train.optimizer_config(), warmup_ratio=0.0,
                               grad_accum_steps=2)


def _accumulated_run(cfg: VLMConfig, params, dev: str):
    """`_accumulated_update_parity`'s run on `dev`: two micro-steps (k = 2)
    of ACCUM_PARITY_FRAMES-frame batches from seed 8, the first moving no
    parameter. Returns (each micro-step's metrics as floats, the
    accumulated mean gradient and each leaf's move, on the CPU, seconds)."""
    opt = _accumulation_config()
    rng = np.random.default_rng(8)
    state = trainer.init_train_state(_to_cuda(params) if dev == "cuda" else params, opt)
    step = trainer.make_train_step(cfg, opt, nseg=1)
    first = _leaves(state.params)
    metrics, grads, t0 = [], [], time.perf_counter()
    for i in range(2):
        batch = _train_batch(rng, cfg, ACCUM_PARITY_FRAMES, 2, dev, torch.float32)
        state, m, g = _step_state_grads(step, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(g)
        if i == 0 and any(not torch.equal(a, b) for (_, a), (_, b) in
                          zip(first, _leaves(state.params))):
            raise RuntimeError(f"accumulated update on {dev}: the first micro-step moved "
                               "parameters")
    mean = [(n, (a + (b - a) / 2).cpu()) for (n, a), (_, b) in zip(*grads)]
    moves = [(n, (b - a).cpu()) for (n, a), (_, b) in zip(first, _leaves(state.params))]
    return metrics, mean, moves, time.perf_counter() - t0


def _accumulated_update_parity(cfg: VLMConfig, params):
    """One accumulated update (grad_accum_steps 2, two batches, no warmup),
    card against CPU: the losses and grad norms of both micro-steps to
    TRAIN_PARITY_LOSS_RTOL, no parameter moved by the first micro-step, the
    frozen leaves unmoved, and each trainable element's move by the second
    held to the gradient rule carried through Adam's first step: the
    accumulated gradient within TRAIN_PARITY_RTOL of its leaf's largest +
    TRAIN_PARITY_MODEL_RTOL of the model's, `_adam_step_bound` of that
    (where the gradient is far from 0 the step is lr * sign(g) and barely
    moves; near Adam's eps it follows g), + TRAIN_PARITY_MODEL_RTOL of the
    largest move for the update's own rounding, + the rounding of p + u
    on each side (a move is read as p1 - p0: an fp32 ulp of p each)."""
    opt = _accumulation_config()
    mg, gg, dg, tg = _accumulated_run(cfg, params, "cuda")
    mc, gc, dc, tc = _cpu_reference("accumulated_update", lambda: _accumulated_run(
        *_train_parity_setup(), "cpu"))
    for i in range(2):
        for key in ("loss", "grad_norm"):
            a, b = mg[i][key], mc[i][key]
            if not abs(a - b) <= TRAIN_PARITY_LOSS_RTOL * abs(b):
                raise RuntimeError(f"accumulated update, micro-step {i + 1}: {key} {a} on the "
                                   f"card, {b} on the CPU")
    trainable = dict(_leaves(optimizer.trainable_mask(params, opt.mm_tunable_parts)))
    start = dict(_leaves(params))
    labels = dict(_leaves(optimizer.lr_group_labels(params, opt)))
    lrs = {"default": opt.learning_rate, "memory_transformer": opt.memory_transformer_lr,
           "memory_kv": opt.memory_key_value_lr}
    norm = math.sqrt(sum(float(g.double().pow(2).sum()) for n, g in gc if trainable[n]))
    clip = min(1.0, opt.max_grad_norm / norm)
    grad_max = max(float(g.abs().max()) for _, g in gc)
    move_max = max(float(d.abs().max()) for _, d in dc)
    worst, moved = [], 0
    for (name, a), (_, b), (_, g), (_, g_card) in zip(dg, dc, gc, gg):
        if not trainable[name]:
            if a.any() or b.any():
                raise RuntimeError(f"accumulated update: frozen {name} moved")
            continue
        tol_g = TRAIN_PARITY_RTOL * float(g.abs().max()) + TRAIN_PARITY_MODEL_RTOL * grad_max
        bound = (_adam_step_bound(g, tol_g, lrs[labels[name]], clip, opt.eps)
                 + TRAIN_PARITY_MODEL_RTOL * move_max
                 + 2 * torch.finfo(torch.float32).eps * start[name].abs())
        ratios = (a - b).abs() / bound
        ratio = float(ratios.max())
        if not ratio <= 1.0:
            i = int(ratios.argmax())
            at = {k: float(x.reshape(-1)[i]) for k, x in (
                ("grad_cpu", g), ("grad_card", g_card), ("move_cpu", b), ("move_card", a),
                ("bound", bound))}
            raise RuntimeError(f"accumulated update: {name} moved {float((a - b).abs().max())} "
                               f"apart, {ratio} of its bound; worst element {at}, gradient "
                               f"tolerance {tol_g}, clip {clip}")
        moved += int((b != 0).sum())
        worst.append((ratio, name))
    if not moved:
        raise RuntimeError("accumulated update: no parameter moved")
    log(json.dumps({"train_parity_accumulated": "fp32, k = 2, two batches of "
                    f"{ACCUM_PARITY_FRAMES} frames, card vs cpu",
                    "loss_card": [m["loss"] for m in mg],
                    "loss_cpu": [m["loss"] for m in mc],
                    "elements_moved_cpu": moved, "clip": clip, "largest_move": move_max,
                    "worst_leaves_err_over_bound": sorted(worst)[-3:],
                    "card_s": tg, "cpu_s": tc}))


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


LOAD_DIR = Path(__file__).resolve().parent / "build" / f"load_phase_{LOAD_SEED}"


def _export_checkpoint(cfg: VLMConfig):
    """The 0.5B model's seeded bf16 params (LM matrices times 5, `_lively`)
    exported with the port's `export_hf_safetensors` into LOAD_DIR (fp32,
    ~3.7 GB), and the LOAD_FRAMES-frame 480x640 uint8 clip written beside
    it as clip.y4m. Returns (params, bytes written, export s)."""
    source = _lively(vlm.init_params(cfg, seed=LOAD_SEED, device="cuda", dtype=torch.bfloat16))
    shutil.rmtree(LOAD_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = export_hf_safetensors(source, cfg, str(LOAD_DIR))
    export_s = time.perf_counter() - t0
    clip = np.random.default_rng(LOAD_SEED).integers(0, 256, (LOAD_FRAMES, *LOAD_FRAME_HW, 3),
                                                     dtype=np.uint8)
    write_y4m(str(LOAD_DIR / "clip.y4m"), clip, fps=30)
    return source, os.path.getsize(path), export_s


def _load_clip() -> np.ndarray:
    """The exported clip read back through `load_video` (the native frame
    loader decodes the y4m): LOAD_FRAMES uint8 frames of LOAD_FRAME_HW."""
    frames, _, _, num = load_video(str(LOAD_DIR / "clip.y4m"), frames_upbound=LOAD_FRAMES,
                                   force_sample=True)
    if frames.shape != (LOAD_FRAMES, *LOAD_FRAME_HW, 3) or num != LOAD_FRAMES:
        raise RuntimeError(f"load_video: {frames.shape}, {num} frames")
    return frames


def phase_load(keep: bool = False):
    """Loading at full width: the checkpoint of `_export_checkpoint`, then
    `load_pretrained_model` of it in bf16 and with `load_8bit`. The loaded
    leaves equal the source's bit for bit (bf16 -> fp32 -> bf16 is exact;
    with `load_8bit`, `siglip.prequantize_int8` and `qwen2.prequantize_int8`
    of the source on the card); `model.generate` of the 64-frame 480x640
    uint8 clip, read back through `data/video.load_video` (the native frame
    loader, built first, decodes it), gives the same 32 tokens as the
    in-memory request, with flash_fwd 55 launches in bf16 and
    fused_qkv_int8 / flash_attention_merge_heads / fused_mlp_block_int8 26
    each and flash_fwd 29 with load_8bit. Prints the export and load times,
    GB read per s, the peak host RSS during each load and each generate's ms
    beside the in-memory request's. Deletes the checkpoint unless `keep`
    (for `phase_eval`). Returns each load's launch counts."""
    log(f"load phase on {require_card()}")
    t0 = time.perf_counter()
    lib = native_loader.build()
    log(f"native frame loader: {lib.name}, {time.perf_counter() - t0:.2f} s")
    cfg = VLMConfig.onevision_0_5b()
    source, nbytes, export_s = _export_checkpoint(cfg)
    frames = _load_clip()
    log(json.dumps({"export_s": export_s, "checkpoint_gb": nbytes / 1e9,
                    "export_gb_per_s": nbytes / 1e9 / export_s,
                    "parameters": sum(x.numel() for _, x in leaves_with_path(source))}))
    ids = _qa_ids()[None]
    processor = SigLipImageProcessor(size=(cfg.vision.image_size, cfg.vision.image_size))
    tower, lm = cfg.vision.num_used_layers, cfg.lm.num_hidden_layers
    memory = _memory_calls(cfg, LOAD_FRAMES)
    launches = {"load_bf16": _load_case(
        "bf16", str(LOAD_DIR), nbytes, cfg, source, ids, frames, processor, False,
        {"flash_fwd": tower + memory + lm})}
    int8_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     tower_int8=True))
    int8_source = {**source, "vision_tower": siglip.prequantize_int8(source["vision_tower"]),
                   "language_model": qwen2.prequantize_int8(source["language_model"])}
    launches["load_int8"] = _load_case(
        "int8", str(LOAD_DIR), nbytes, int8_cfg, int8_source, ids, frames, processor, True,
        {"fused_qkv_int8": tower, "flash_attention_merge_heads": tower,
         "fused_mlp_block_int8": tower, "flash_fwd": memory + lm})
    if not keep:
        shutil.rmtree(LOAD_DIR)
    del source, int8_source
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- evaluation

EVAL_IMAGE_HW = (1080, 1920)   # a 1920x1080 image: the anyres 5 x 3 grid and the base view
EVAL_BIG_FRAMES = 8            # 1080x1920 frames through the device preprocess
EVAL_LARGEST_HW = (2160, 3840)  # the largest downscale a path takes here: 10x to 384
EVAL_SEED = 5
# card against CPU, fp32, normalized units: the same float32 weights, the
# products summed in another order (each output sums a few dozen nonzero
# terms); the control (antialias=False, JAX's unwidened support) moves a
# downscale by ~1
PREPROCESS_TOL = 1e-5
# tests/test_device_preprocess.py's envelope against the host processor
# (PIL requantizes to uint8 after its resize): (mean, 99th percentile)
FRAMES_ENVELOPE = (0.01, 0.05)
ANYRES_ENVELOPE = (0.015, 0.08)
# host- and device-processed image embeds: their RMS difference within this
# many times the floor that PIL's uint8 requantization alone causes
EMBED_FLOOR_FACTOR = 3.0
ADAPTER_FRAMES = 16


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt())


def _envelope(label, got: torch.Tensor, host: np.ndarray, envelope) -> dict:
    diff = np.abs(got.float().cpu().numpy() - host)
    mean, q99 = float(diff.mean()), float(np.quantile(diff, 0.99))
    if not (mean < envelope[0] and q99 < envelope[1]):
        raise RuntimeError(f"{label}: against the host processor mean {mean}, q99 {q99}, "
                           f"want < {envelope}")
    return {"mean": mean, "q99": q99}


def _host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _preprocess_case(label, frames: np.ndarray, size, processor, control: bool):
    """preprocess_frames of uint8 `frames` on the card against the same
    function on the CPU (fp32, within PREPROCESS_TOL), both within the host
    processor's quantization envelope; `control` also runs antialias=False
    on the card, which must exceed the tolerance. ms: on the card from
    uint8 already there (bf16 out, as the paths take it), from host uint8
    (the copy to the card included), the CPU run, the host processor."""
    u8 = torch.from_numpy(frames).cuda()
    card = preprocess_frames(u8, size=size, dtype=torch.float32)
    cpu, cpu_ms = _host_ms(lambda: preprocess_frames(frames, size=size, dtype=torch.float32))
    err = float((card.cpu() - cpu).abs().max())
    row = {"case": label, "frames": list(frames.shape), "out": list(card.shape),
           "max_abs_err": err, "tol": PREPROCESS_TOL,
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    if not err <= PREPROCESS_TOL:
        raise RuntimeError(f"{label}: card and CPU differ by {err} > {PREPROCESS_TOL}")
    if control:
        wrong = preprocess_frames(u8, size=size, dtype=torch.float32, antialias=False)
        row["control_antialias_false_err"] = float((wrong.cpu() - cpu).abs().max())
        if not row["control_antialias_false_err"] > PREPROCESS_TOL:
            raise RuntimeError(f"{label}: the antialias=False control passed ({row})")
    if processor is not None:
        host, row["host_processor_ms"] = _host_ms(lambda: processor.preprocess(frames))
        row["card_vs_host"] = _envelope(label, card, host, FRAMES_ENVELOPE)
        row["cpu_vs_host"] = _envelope(label, cpu, host, FRAMES_ENVELOPE)
    del card, cpu
    row["card_ms"] = _time_ms(lambda: preprocess_frames(u8, size=size))
    row["card_ms_from_host_uint8"] = _time_ms(
        lambda: preprocess_frames(torch.from_numpy(frames).cuda(), size=size))
    row["cpu_ms"] = cpu_ms
    log(json.dumps(row))
    return row


def _anyres_case(cfg, image: np.ndarray):
    """The anyres tiles of `image` on the card against the CPU and the host
    processor (`process_anyres_image`), as `_preprocess_case`."""
    s, pinpoints = cfg.vision.image_size, cfg.pipeline.image_grid_pinpoints
    u8 = torch.from_numpy(image).cuda()
    card, size = preprocess_anyres_image(u8, pinpoints, size=(s, s), dtype=torch.float32)
    (cpu, cpu_size), cpu_ms = _host_ms(lambda: preprocess_anyres_image(
        image, pinpoints, size=(s, s), dtype=torch.float32))
    from PIL import Image

    processor = SigLipImageProcessor(size=(s, s))
    (host, host_size), host_ms = _host_ms(lambda: process_anyres_image(
        Image.fromarray(image), processor, pinpoints))
    err = float((card.cpu() - cpu).abs().max())
    if size != cpu_size or size != tuple(host_size) or card.shape != host.shape or \
            not err <= PREPROCESS_TOL:
        raise RuntimeError(f"anyres tiles: {tuple(card.shape)} {size}, CPU {cpu_size}, host "
                           f"{host.shape} {host_size}, card vs CPU {err}")
    row = {"case": "anyres_tiles", "image": list(image.shape), "tiles": list(card.shape),
           "max_abs_err": err, "tol": PREPROCESS_TOL,
           "card_vs_host": _envelope("anyres card", card, host, ANYRES_ENVELOPE),
           "cpu_vs_host": _envelope("anyres cpu", cpu, host, ANYRES_ENVELOPE),
           "card_ms": _time_ms(lambda: preprocess_anyres_image(u8, pinpoints, size=(s, s))),
           "card_ms_from_host_uint8": _time_ms(lambda: preprocess_anyres_image(
               torch.from_numpy(image).cuda(), pinpoints, size=(s, s))),
           "cpu_ms": cpu_ms, "host_processor_ms": host_ms}
    log(json.dumps(row))
    return row


def _eval_video(cfg, label, load_8bit, frames, ids, want):
    """`load_pretrained_model(device_preprocess=True)` and `model.generate`
    of the uint8 clip: its launches, 32 tokens (>= 8 distinct) equal to the
    same call fed the card-preprocessed frames as float, and its ms
    (median of 3 after a warm-up). Returns (model, launches, row)."""
    _, model, _, _ = load_pretrained_model(str(LOAD_DIR), load_8bit=load_8bit,
                                           device_preprocess=True)
    counted = _Counted(f"eval video {label}")

    def call():
        return model.generate(ids, images=[frames], modalities=["video"],
                              max_new_tokens=GENERATE_NEW)

    got = counted("generate, uint8 frames on the card", call, want)[0]
    s = cfg.vision.image_size
    pixels = preprocess_frames(torch.from_numpy(frames).cuda(), size=(s, s), dtype=model.dtype)
    ref = model.generate(ids, images=[pixels], modalities=["video"],
                         max_new_tokens=GENERATE_NEW)[0]
    if got.tolist() != ref.tolist() or len(got) != GENERATE_NEW or \
            len(set(got.tolist())) < MIN_DISTINCT_TOKENS:
        raise RuntimeError(f"eval video {label}: tokens {got.tolist()}, from float frames "
                           f"{ref.tolist()}")
    row = {"eval": f"video_{label}_device_preprocess", "frames": list(frames.shape),
           "tokens": got.tolist(), "launches": counted.total,
           "generate_ms": _time_ms(call, reps=3)}
    log(json.dumps(row))
    return model, counted.total, row


def _eval_image(model, cfg, label, image, ids, want):
    """`model.generate` of the uint8 image with modalities=["image"], through
    the host anyres processor and through the device preprocess: each with
    its launches, the visual tokens `_image_visual_tokens` gives, 32 tokens
    (>= 8 distinct) equal to `vlm.generate` of its spliced sequence, whose
    logits are finite, and its ms. The two paths' sequences differ by
    PIL's uint8 requantization: their RMS difference is held within
    EMBED_FLOOR_FACTOR times that of the device tiles against the same
    tiles requantized to uint8 codes. Returns each path's launches."""
    size = image.shape[1::-1]
    launches, embeds, rows = {}, {}, []
    for path, on_card in (("host", False), ("device", True)):
        model.device_preprocess = on_card
        counted = _Counted(f"eval image {label} {path}")

        def call():
            return model.generate(ids, images=[image[None]], modalities=["image"],
                                  max_new_tokens=GENERATE_NEW)

        got = counted("generate", call, want)[0]
        emb = model._row_embeds(ids[0], [image[None]], "image")
        if emb.shape[0] != _image_spliced_len(cfg, size):
            raise RuntimeError(f"eval image {label} {path}: {emb.shape[0]} spliced tokens, want "
                               f"{_image_spliced_len(cfg, size)}")
        out, logits = vlm.generate(model.params, model.cfg, emb, max_new_tokens=GENERATE_NEW,
                                   return_logits=True)
        tokens = out.tokens[:int(out.num_tokens)].tolist()
        if tokens != got.tolist() or len(tokens) != GENERATE_NEW or \
                len(set(tokens)) < MIN_DISTINCT_TOKENS or not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"eval image {label} {path}: tokens {got.tolist()}, vlm.generate "
                               f"{tokens}, finite logits {bool(torch.isfinite(logits).all())}")
        embeds[path] = emb
        launches[f"eval_image_{label}_{path}"] = counted.total
        rows.append({"path": path, "tokens": tokens, "launches": counted.total,
                     "generate_ms": _time_ms(call, reps=3)})
    s = cfg.vision.image_size
    tiles, size = preprocess_anyres_image(torch.from_numpy(image).cuda(),
                                          cfg.pipeline.image_grid_pinpoints, size=(s, s),
                                          dtype=torch.float32)
    requantized = (torch.round((tiles * 0.5 + 0.5) * 255.0) / 255.0 - 0.5) / 0.5
    floor_emb = image_path.splice(model.params, ids[0], image_path.build_image_embeds(
        model.params, model.cfg, requantized, size), model.cfg.lm)
    floor, diff = _rel_rms(floor_emb, embeds["device"]), _rel_rms(embeds["host"], embeds["device"])
    row = {"eval": f"image_{label}", "image": list(image.shape),
           "visual_tokens": _image_visual_tokens(cfg, size), "paths": rows,
           "embeds_rel_rms_host_vs_device": diff, "requantization_floor": floor,
           "bound": f"{EMBED_FLOOR_FACTOR} x floor"}
    log(json.dumps(row))
    if not diff <= EMBED_FLOOR_FACTOR * floor:
        raise RuntimeError(f"eval image {label}: host and device embeds differ by {diff}, "
                           f"above {EMBED_FLOOR_FACTOR} x the requantization floor {floor}")
    model.device_preprocess = True
    return launches


QWEN_SPECIALS = {"specials": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                 "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}


def _write_tokenizer(directory: Path, chat: dict = QWEN_SPECIALS):
    """A small byte-level BPE tokenizer with a chat template's specials
    (`chat`: Qwen2's by default), trained here (no published tokenizer can
    be fetched), saved beside the exported weights so that the entries,
    which tokenize a prompt, load it. Its 2000 ids lie inside the model's
    vocabulary; decoding the model's other ids gives "", so the checks read
    `output_ids`."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers, trainers

    tok = Tokenizer(tok_models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    # every byte in the alphabet: a character the corpus lacks still encodes
    trainer = trainers.BpeTrainer(vocab_size=2000, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  special_tokens=chat["specials"])
    tok.train_from_iterator(["What happens in the video?", "Describe the image.",
                             "What does a memory token hold?", "a cat sits on a mat"] * 50,
                            trainer)
    tok.save(str(directory / "tokenizer.json"))
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast",
         **{k: v for k, v in chat.items() if k != "specials"}}))


def _eval_entries(cfg, frames, image):
    """The entries over the exported checkpoint, bf16 on the card:
    `model_vqa.main` over three questions (the y4m clip, a PNG image, text
    only), without and with --device_preprocess; the lmms-eval adapter's
    `generate_until` and `loglikelihood` through the vendored harness on a
    video doc and an image doc; `Predictor.setup` and `.predict` on the
    clip, the checkpoint given a tokenizer first (`_write_tokenizer`). Each
    holds its launches; returns them by path."""
    tower, lm = cfg.vision.num_used_layers, cfg.lm.num_hidden_layers
    clip = str(LOAD_DIR / "clip.y4m")
    n_video = len(load_video(clip)[0])  # what model_vqa and Predictor sample (1 fps)

    def video(f):
        return {k: v + (lm if k == "flash_fwd" else 0) for k, v in _qa_launches(cfg, f).items()}

    def total(*wants):
        out = dict.fromkeys(WRAPPERS, 0)
        for w in wants:
            for k, v in w.items():
                out[k] += v
        return out

    view, text = {"flash_fwd": tower + lm}, {"flash_fwd": lm}
    _write_tokenizer(LOAD_DIR)
    load_qwen_tokenizer(str(LOAD_DIR))  # imports transformers before the timed entries
    from PIL import Image

    Image.fromarray(image).save(LOAD_DIR / "image.png")
    questions = [{"question_id": 1, "video": "clip.y4m", "text": "What happens in the video?"},
                 {"question_id": 2, "image": "image.png", "text": "Describe the image."},
                 {"question_id": 3, "text": "What does a memory token hold?"}]
    (LOAD_DIR / "questions.jsonl").write_text("\n".join(json.dumps(q) for q in questions))
    launches, rows = {}, {}
    for extra in ([], ["--device_preprocess"]):
        name = "eval_model_vqa" + ("_device_preprocess" if extra else "")
        answers = LOAD_DIR / f"{name}.jsonl"
        counted = _Counted(name)
        _, wall_ms = _host_ms(lambda: counted("main", lambda: model_vqa.main([
            "--model-path", str(LOAD_DIR), "--question-file", str(LOAD_DIR / "questions.jsonl"),
            "--video-folder", str(LOAD_DIR), "--image-folder", str(LOAD_DIR),
            "--answers-file", str(answers), "--max_new_tokens", str(GENERATE_NEW), *extra]),
            total(video(n_video), view, text)))
        got = [json.loads(line) for line in answers.read_text().splitlines()]
        if [r["question_id"] for r in got] != [1, 2, 3] or any("error" in r for r in got) or \
                not all(0 < len(r["output_ids"]) <= GENERATE_NEW and all(
                    0 <= t < cfg.lm.vocab_size for t in r["output_ids"]) for r in got):
            raise RuntimeError(f"{name}: answers {got}")
        launches[name] = counted.total
        rows[name] = {"wall_ms_with_load": wall_ms, "ms_per_question_with_load": wall_ms / 3,
                      "output_ids": [r["output_ids"][:8] for r in got]}
        vlm.clear_decoders()

    from lmms_eval import evaluate_task

    adapter = lmms_adapter.MavlmTorch(pretrained=str(LOAD_DIR), max_frames_num=ADAPTER_FRAMES)
    docs = [{"doc_id": 0, "question": "What happens?", "answer": "A", "visual": [frames]},
            {"doc_id": 1, "question": "What is shown?", "answer": "B",
             "visual": [Image.fromarray(image)]}]
    task = dict(doc_to_text=lambda d: d["question"], doc_to_visual=lambda d: d["visual"],
                doc_to_target=lambda d: d["answer"])
    counted = _Counted("eval_lmms_adapter")
    gen_out, gen_ms = _host_ms(lambda: counted(
        "generate_until", lambda: evaluate_task(
            adapter, "eval_phase", docs, request_type="generate_until",
            gen_kwargs={"max_new_tokens": GENERATE_NEW, "temperature": 0, "until": ["\n\n"]},
            **task),
        total(video(ADAPTER_FRAMES), view)))
    ll_out, ll_ms = _host_ms(lambda: counted(
        "loglikelihood", lambda: evaluate_task(adapter, "eval_phase", docs,
                                               request_type="loglikelihood",
                                               choices=lambda d: ["A", "B"], **task),
        total(video(ADAPTER_FRAMES), video(ADAPTER_FRAMES), view, view)))
    scores = [adapter.score("What happens?", " A", visuals=frames, modality="video")]
    if len(gen_out["responses"]) != 2 or not all(isinstance(r, str) for r in
                                                  gen_out["responses"]) or \
            not all(r in ("A", "B") for r in ll_out["responses"]) or \
            not all(math.isfinite(sc[0]) for sc in scores):
        raise RuntimeError(f"eval lmms adapter: {gen_out}, {ll_out}, {scores}")
    launches["eval_lmms_adapter"] = counted.total
    rows["lmms_adapter"] = {"generate_until_ms_per_request": gen_ms / 2,
                            "loglikelihood_ms_per_request": ll_ms / 4,
                            "responses": gen_out["responses"], "picks": ll_out["responses"]}
    del adapter
    vlm.clear_decoders()

    predictor = port_predict.Predictor()
    predictor.setup(str(LOAD_DIR))
    counted = _Counted("eval_predictor")
    answer, ms = _host_ms(lambda: counted(
        "predict", lambda: predictor.predict("What happens in the video?", video=clip,
                                             max_new_tokens=GENERATE_NEW), video(n_video)))
    if not isinstance(answer, str):
        raise RuntimeError(f"Predictor.predict: {answer!r}")
    launches["eval_predictor"] = counted.total
    rows["predictor"] = {"predict_ms": ms, "video_frames": n_video}
    del predictor
    vlm.clear_decoders()
    log(json.dumps({"eval_entries": rows}))
    return launches


def phase_eval(keep: bool = False):
    """Evaluation and the image path at full width, over `phase_load`'s
    checkpoint (exported here when it is not there), which it deletes
    unless `keep` (for `phase_train_cli`):
    the device preprocess against its plain version (the same function on
    the CPU) and the host processor: the 64-frame 480x640 clip, 8 frames of
    1080x1920, one frame of 2160x3840 (10x down) and the anyres tiles of a
    1920x1080 image; the clip through `device_preprocess` in bf16 and with
    load_8bit (launches as `phase_load`'s: flash_fwd 55; 26 / 26 / 26 and
    flash_fwd 29); the image through the host anyres processor and through
    the device preprocess in both (flash_fwd 50: tower 26 + prefill 24;
    26 / 26 / 26 and flash_fwd 24); then the entries (`_eval_entries`).
    Returns each path's launch counts."""
    log(f"eval phase on {require_card()}")
    t_phase = time.perf_counter()
    cfg = VLMConfig.onevision_0_5b()
    if not (LOAD_DIR / "config.json").exists():
        _export_checkpoint(cfg)
    frames = _load_clip()
    rng = np.random.default_rng(EVAL_SEED)
    big = rng.integers(0, 256, (EVAL_BIG_FRAMES, *EVAL_IMAGE_HW, 3), dtype=np.uint8)
    largest = rng.integers(0, 256, (1, *EVAL_LARGEST_HW, 3), dtype=np.uint8)
    image = rng.integers(0, 256, (*EVAL_IMAGE_HW, 3), dtype=np.uint8)
    s = cfg.vision.image_size
    processor = SigLipImageProcessor(size=(s, s))
    _preprocess_case("frames_64x480x640", frames, (s, s), processor, control=True)
    _preprocess_case("frames_8x1080x1920", big, (s, s), processor, control=True)
    _preprocess_case("frame_2160x3840", largest, (s, s), None, control=False)
    _anyres_case(cfg, image)
    del big, largest

    ids = _qa_ids()[None]
    tower, lm = cfg.vision.num_used_layers, cfg.lm.num_hidden_layers
    memory = _memory_calls(cfg, LOAD_FRAMES)
    int8_tower = {"fused_qkv_int8": tower, "flash_attention_merge_heads": tower,
                  "fused_mlp_block_int8": tower}
    launches = {}
    int8_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     tower_int8=True))
    for label, load_8bit, run_cfg, video_want, image_want in (
            ("bf16", False, cfg, {"flash_fwd": tower + memory + lm}, {"flash_fwd": tower + lm}),
            ("int8", True, int8_cfg, {**int8_tower, "flash_fwd": memory + lm},
             {**int8_tower, "flash_fwd": lm})):
        model, launches[f"eval_video_{label}"], _ = _eval_video(
            run_cfg, label, load_8bit, frames, ids, video_want)
        launches.update(_eval_image(model, run_cfg, label, image, ids, image_want))
        del model
        vlm.clear_decoders()
        torch.cuda.empty_cache()
    launches.update(_eval_entries(cfg, frames, image))
    if not keep:
        shutil.rmtree(LOAD_DIR)
    torch.cuda.empty_cache()
    log(json.dumps({"eval_phase_s": time.perf_counter() - t_phase}))
    return launches


# ---------------------------------------------------------- the HTTP stack

STACK_NEW = 32
# the engine worker's positions: a 64-frame clip splices ~9.4k tokens and
# the engine refuses a prompt of max_len or more (a multiple of its 128)
STACK_MAX_LEN = 10240
STACK_ODD_HW = (360, 480)  # request b's last frame: another size than the clip's
STACK_QUESTION = "What happens in the video?"


def _b64_png(frame: np.ndarray) -> str:
    """A uint8 frame as base64 PNG (lossless: the worker decodes the same
    bytes), stored without compression: noise does not compress, and
    deflate would take most of the host's encode and decode time."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG", compress_level=0)
    return base64.b64encode(buf.getvalue()).decode()


class _StackRecord:
    """Each request's token ids and the inputs they came from, recorded by
    wrapping a model worker's `model.generate_stream` (input ids, images,
    ids) or an engine worker's `engine.submit` (the float32 sequence, the
    engine's output queue, ids); `take()` hands the records over and
    clears them."""

    def __init__(self):
        self.calls, self.lock = [], threading.Lock()

    def stream(self, fn):
        def recorded(input_ids, images=None, **kw):
            call = {"input_ids": np.asarray(input_ids), "images": images, "ids": []}
            with self.lock:
                self.calls.append(call)
            for ids in fn(input_ids, images=images, **kw):
                call["ids"].extend(int(t) for t in ids)
                yield ids
        return recorded

    def submit(self, fn):
        def recorded(embeds, **kw):
            out = fn(embeds, **kw)
            call = {"embeds": embeds, "out": out, "ids": [], "kw": kw}
            with self.lock:
                self.calls.append(call)

            def get():
                item = out.get(timeout=600)
                if item is not None:
                    call["ids"].extend(int(t) for t in item)
                return item
            return types.SimpleNamespace(get=get)
        return recorded

    def take(self) -> list:
        with self.lock:
            calls, self.calls = self.calls, []
        return calls


def _start_server(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@contextlib.contextmanager
def _heartbeats(workers, every: float = 5.0):
    """Each worker's heartbeat to its controller every `every` s while the
    block runs (a worker built with register=False sends none, and the
    controller drops it CONTROLLER_HEART_BEAT_EXPIRATION s after its last)."""
    stop = threading.Event()

    def beat():
        while not stop.wait(every):
            for w in workers:
                w._post("/receive_heart_beat", {"worker_name": w.worker_addr,
                                                "queue_length": w.queue_length})
    thread = threading.Thread(target=beat, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=30)


def _streamed(label, chunks, t0) -> dict:
    """A request's chunks (every one at error_code 0) and its times: to the
    first chunk and to the last (HTTP end to end), ms."""
    first, out = None, []
    for c in chunks:
        first = first if first is not None else time.perf_counter()
        out.append(c)
    end = time.perf_counter()
    codes = [c.get("error_code") for c in out]
    if not out or set(codes) != {0}:
        raise RuntimeError(f"serve stack, {label}: error codes {codes}: "
                           f"{[c.get('text', '')[:200] for c in out if c.get('error_code')]}")
    return {"chunks": len(out), "first_chunk_ms": 1e3 * (first - t0),
            "e2e_ms": 1e3 * (end - t0), "last": out[-1]}


def _request_launches(cfg: VLMConfig, num_frames: int) -> dict:
    """A video request of a loaded model: `video_qa_embeds`' launches and
    the LM prefill's."""
    want = _qa_launches(cfg, num_frames)
    want["flash_fwd"] += cfg.lm.num_hidden_layers
    return want


def _stack_launches(label, want: dict) -> dict:
    torch.cuda.synchronize()
    got, want = _launches(), {**dict.fromkeys(WRAPPERS, 0), **want}
    if got != want:
        raise RuntimeError(f"serve stack, {label}: launches {got}, want {want}")
    return got


def _equal_ids(label, got: list, want) -> list:
    want = [int(t) for t in want]
    if got != want or not 0 < len(got) <= STACK_NEW:
        raise RuntimeError(f"serve stack, {label}: streamed ids {got}, in-process {want}")
    return got


def _held_to_generate(label, call, ref_tokens, ref_rows, got_rows) -> dict:
    """The engine's tokens against `vlm.generate`'s by the margin rule
    (`_greedy_agreement`); both stop at the same eos, so where every step
    held their lengths agree too."""
    got = torch.tensor(call["ids"])
    n = min(len(got), len(ref_tokens))
    agree = _greedy_agreement(label, ref_tokens[:n], ref_rows[:n], got[:n], got_rows[:n],
                              BATCHED_LOGIT_TOL)
    if agree["steps_held"] == n and len(got) != len(ref_tokens):
        raise RuntimeError(f"serve stack, {label}: {len(got)} tokens, vlm.generate "
                           f"{len(ref_tokens)}")
    return agree


def phase_serve_stack():
    """The serving HTTP stack (`serve/controller.py`, `model_worker.py`,
    `sglang_worker.py`, `web_server.py`, `client.py`, `cli.py`) over
    `phase_load`'s checkpoint and tokenizer (left by `phase_eval`), all in
    this process on 127.0.0.1: one controller, a
    `ModelWorker(device_preprocess=True)` and an `SGLangWorker` (4 slots of
    STACK_MAX_LEN positions), each loading the bf16 model, and the web UI.
    Requests, greedy, 32 new tokens: (a) the 64-frame 480x640 clip as 64
    base64 PNG frames through `client.stream_generate` to the model worker
    (raw uint8 to the card); (b) the same with its last frame of another
    size (the host processor); (c) the clip and two text prompts at once,
    from three threads, to the engine worker; (d) a text turn through the
    web UI's `/chat`; (e) `cli.main` on clip.y4m (JAX's 1 fps sampling)
    with one line of input. Every chunk at error_code 0; a and b's ids
    equal the same model's in-process `model.generate` of the frames the
    worker received, d's and e's too; c's held to `vlm.generate` of the
    sequences the engine received by the margin rule; flash_fwd 55 a
    64-frame request (tower 26, memory 5, prefill 24), 24 a text prefill;
    no engine record at ERROR. Logs each request's HTTP end-to-end ms, its
    first chunk and the in-process call's ms, and the host's PNG encode,
    base64 and PNG decode ms. Returns each request's launches."""
    from PIL import Image

    log(f"serve stack phase on {require_card()}")
    t_phase = time.perf_counter()
    cfg = VLMConfig.onevision_0_5b()
    lm = cfg.lm.num_hidden_layers
    video, text = _request_launches(cfg, LOAD_FRAMES), {"flash_fwd": lm}
    frames = _load_clip()
    t0 = time.perf_counter()
    payload = [_b64_png(f) for f in frames]
    odd = np.ascontiguousarray(frames[-1][:STACK_ODD_HW[0], :STACK_ODD_HW[1]])
    payload_b = payload[:-1] + [_b64_png(odd)]
    encode_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    raw = [base64.b64decode(b) for b in payload]
    b64_ms = 1e3 * (time.perf_counter() - t0)
    decoded = np.stack([np.asarray(Image.open(io.BytesIO(r)).convert("RGB")) for r in raw])
    png_ms = 1e3 * (time.perf_counter() - t0) - b64_ms
    if not np.array_equal(decoded, frames):
        raise RuntimeError("serve stack: the PNG payload does not decode to the clip")
    del raw, decoded
    host = {"png_encode_ms": encode_ms, "base64_decode_ms": b64_ms, "png_decode_ms": png_ms,
            "payload_mb": sum(map(len, payload)) / 1e6}

    rec, servers = _StackRecord(), []
    servers.append(serve_controller.serve("127.0.0.1", 0))
    ctrl = _start_server(servers[-1])
    t0 = time.perf_counter()
    worker = model_worker.ModelWorker(ctrl, "", str(LOAD_DIR), "mavlm-0.5b", register=False,
                                      device_preprocess=True)
    engine_worker = sglang_worker.SGLangWorker(ctrl, "", str(LOAD_DIR), "mavlm-0.5b-engine",
                                               register=False, num_slots=4,
                                               max_len=STACK_MAX_LEN)
    torch.cuda.synchronize()
    host["two_worker_loads_s"] = time.perf_counter() - t0
    engine = engine_worker.engine
    worker.model.generate_stream = rec.stream(worker.model.generate_stream)
    engine.submit = rec.submit(engine.submit)
    for w in (worker, engine_worker):
        servers.append(ThreadingHTTPServer(("127.0.0.1", 0), model_worker.make_handler(w)))
        w.worker_addr = _start_server(servers[-1])
        w.register_to_controller()
    servers.append(ThreadingHTTPServer(("127.0.0.1", 0), web_server.make_handler(ctrl)))
    web = _start_server(servers[-1])
    model, launches, rows = worker.model, {}, {}
    try:
        with _heartbeats((worker, engine_worker)):
            models = serve_client.post_json(ctrl + "/list_models", {})["models"]
            if models != ["mavlm-0.5b", "mavlm-0.5b-engine"]:
                raise RuntimeError(f"serve stack: the controller lists {models}")
            prompt = web_server._render_prompt("qwen_1_5", [[0, STACK_QUESTION]], 1)

            def request(label, model_name, images, want, reference):
                _reset_launches()
                t0 = time.perf_counter()
                row = _streamed(label, serve_client.stream_generate(
                    ctrl, model_name, prompt, images=images, max_new_tokens=STACK_NEW), t0)
                launches[f"serve_stack_{label}"] = _stack_launches(label, want)
                (call,) = rec.take()
                ref, row["in_process_ms"] = _host_ms(lambda: reference(call))
                row["tokens"] = _equal_ids(label, call["ids"], ref[0])
                rows[label] = {k: v for k, v in row.items() if k != "last"}
                return call

            # a: raw uint8 frames to the card (device_preprocess)
            call = request("a_video_device_preprocess", "mavlm-0.5b", payload, video,
                           lambda c: model.generate(c["input_ids"], images=[frames],
                                                    modalities=["video"],
                                                    max_new_tokens=STACK_NEW))
            pixels = call["images"][0]
            if not (pixels.dtype == np.uint8 and np.array_equal(pixels, frames)):
                raise RuntimeError("serve stack, a: the worker did not hand the model the clip's "
                                   "uint8 frames")
            # b: one frame of another size: the host processor resizes each frame
            frames_b = [Image.fromarray(f) for f in frames[:-1]] + [Image.fromarray(odd)]
            pixels_b = worker.image_processor.preprocess(frames_b)
            call = request("b_video_host_processor", "mavlm-0.5b", payload_b, video,
                           lambda c: model.generate(c["input_ids"], images=[pixels_b],
                                                    modalities=["video"],
                                                    max_new_tokens=STACK_NEW))
            if not np.array_equal(call["images"][0], pixels_b):
                raise RuntimeError("serve stack, b: the worker's host-processed frames differ")
            del pixels_b, frames_b

            # c: the clip and two text prompts at once to the engine worker
            texts = [web_server._render_prompt("qwen_1_5", [[0, q]], 0)
                     for q in ("What does a memory token hold?", "Describe the image.")]
            jobs = [(prompt, payload), (texts[0], []), (texts[1], [])]
            results, errors = [None] * 3, []
            logits = _EngineLogits()
            logits.engine = engine
            _reset_launches()
            with _no_engine_errors("serve stack, c"), logits.installed():
                def one(i):
                    try:
                        t0 = time.perf_counter()
                        results[i] = _streamed(f"c{i}", serve_client.stream_generate(
                            ctrl, "mavlm-0.5b-engine", jobs[i][0], images=jobs[i][1],
                            max_new_tokens=STACK_NEW), t0)
                    except Exception as e:  # noqa: BLE001 — raised below, on this thread
                        errors.append(e)
                threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall_ms = 1e3 * (time.perf_counter() - t0)
            if errors or any(t.is_alive() for t in threads):
                raise RuntimeError(f"serve stack, c: {errors or 'a request hung'}")
            launches["serve_stack_c_engine"] = _stack_launches(
                "c_engine", {"flash_fwd": video["flash_fwd"] + 2 * lm})
            calls = rec.take()
            eos = engine_worker.tokenizer.convert_tokens_to_ids("<|im_end|>")
            lens = sorted(c["embeds"].shape[0] for c in calls)
            video_len = (_spliced_len(cfg, LOAD_FRAMES) - len(TEXT_BEFORE) - len(TEXT_AFTER)
                         + len(tokenizer_image_token(prompt, worker.tokenizer)) - 1)
            if len(calls) != 3 or lens[-1] != video_len:
                raise RuntimeError(f"serve stack, c: the engine received {lens}, want "
                                   f"{video_len} for the clip")
            held = []
            for i, c in enumerate(calls):
                emb = torch.from_numpy(c["embeds"]).to(engine.device, engine_worker.model.dtype)
                (res, ref_rows), ms = _host_ms(lambda: vlm.generate(
                    engine_worker.model.params, cfg, emb, max_new_tokens=STACK_NEW,
                    eos_token_ids=(eos,), return_logits=True))
                ref = res.tokens[:int(res.num_tokens)].cpu()
                agree = _held_to_generate(f"c{i}", c, ref, ref_rows,
                                          logits.of(c["out"], len(c["ids"])))
                held.append({"spliced": int(c["embeds"].shape[0]), "tokens": c["ids"],
                             "vlm_generate_ms": ms, **agree})
            rows["c_engine"] = {"wall_ms": wall_ms, "requests": [
                {k: v for k, v in r.items() if k != "last"} for r in results], "held": held}
            del logits, calls

            # d: a text turn through the web UI
            _reset_launches()
            body = {"model": "mavlm-0.5b", "template": "qwen_1_5",
                    "history": [[0, "What does a memory token hold?"]], "images": [],
                    "temperature": 0.0, "max_new_tokens": STACK_NEW}
            t0 = time.perf_counter()
            req = urllib.request.Request(web + "/chat", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                row = _streamed("d_web_chat", (json.loads(line) for line in resp if line.strip()),
                                t0)
            if row["last"]["text"].startswith("<|im_start|>"):
                raise RuntimeError(f"serve stack, d: the prompt echo stayed: {row['last']}")
            launches["serve_stack_d_web_chat"] = _stack_launches("d_web_chat", text)
            (call,) = rec.take()
            ref, row["in_process_ms"] = _host_ms(lambda: model.generate(
                call["input_ids"], max_new_tokens=STACK_NEW))
            row["tokens"] = _equal_ids("d_web_chat", call["ids"], ref[0])
            rows["d_web_chat"] = {k: v for k, v in row.items() if k != "last"}

            # e: the terminal chat on the y4m clip, one line of input
            clip = str(LOAD_DIR / "clip.y4m")
            n_video = len(load_video(clip)[0])
            cli_calls = _StackRecord()
            stream = eval_model.MavlmForCausalLM.generate_stream
            lines = iter([STACK_QUESTION])

            def fake_input(message=""):
                line = next(lines, None)
                if line is None:
                    raise EOFError
                return line
            _reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with _patched(eval_model.MavlmForCausalLM, "generate_stream",
                          lambda self, *a, **kw: cli_calls.stream(
                              functools.partial(stream, self))(*a, **kw)), \
                    _patched(builtins, "input", fake_input), contextlib.redirect_stdout(out):
                serve_cli.main(["--model-path", str(LOAD_DIR), "--video-file", clip,
                                "--max-new-tokens", str(STACK_NEW)])
            cli_ms = 1e3 * (time.perf_counter() - t0)
            launches["serve_stack_e_cli"] = _stack_launches("e_cli",
                                                            _request_launches(cfg, n_video))
            (call,) = cli_calls.take()
            if not out.getvalue().startswith("assistant: "):
                raise RuntimeError(f"serve stack, e: the CLI printed {out.getvalue()!r}")
            ref, ms = _host_ms(lambda: model.generate(
                call["input_ids"], images=call["images"], modalities=["video"],
                max_new_tokens=STACK_NEW,
                eos_token_id=worker.tokenizer.convert_tokens_to_ids("<|im_end|>")))
            rows["e_cli"] = {"frames": n_video, "wall_ms_with_load": cli_ms, "in_process_ms": ms,
                             "tokens": _equal_ids("e_cli", call["ids"], ref[0])}
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        engine.shutdown()
    if engine._thread.is_alive():
        raise RuntimeError("serve stack: the engine thread did not stop")
    del worker.model.generate_stream, worker, engine_worker, engine, model
    gc.collect()
    vlm.clear_decoders()
    torch.cuda.empty_cache()
    log(json.dumps({"serve_stack": rows, "host": host,
                    "phase_s": time.perf_counter() - t_phase}))
    return launches


# ------------------------------------------------------- training entry

TRAIN_CLI_DIR = Path(__file__).resolve().parent / "build" / "train_cli_phase"
# stored at 1 fps (.npy): the reference's sampling rule takes 64 of 65 s
# (two segments of 32); a 64-frame file would give one segment
TRAIN_CLI_FRAMES = 65
TRAIN_CLI_SEED = 9
TRAIN_CLI_LR = 1e-4  # large enough that a bf16 LM leaf moves on each update
DPO_TEXT = 64


class _Stop(Exception):
    """Raised by a save hook to stop a CLI run after a given checkpoint."""


def _train_cli_data():
    """Four 65-frame 384x384 uint8 videos (.npy, 1 fps) and two text-only
    samples under TRAIN_CLI_DIR: the mixed manifest, and one of the videos
    alone. Returns (mixed manifest, videos manifest, video folder)."""
    rng = np.random.default_rng(TRAIN_CLI_SEED)
    vids = TRAIN_CLI_DIR / "videos"
    vids.mkdir(parents=True, exist_ok=True)
    items = []
    for i in range(4):
        np.save(vids / f"v{i}.npy", rng.integers(0, 256, (TRAIN_CLI_FRAMES, 384, 384, 3),
                                                 dtype=np.uint8))
        items.append({"id": i, "video": f"v{i}.npy", "conversations": [
            {"from": "human", "value": "<image>\nWhat happens in the video?"},
            {"from": "gpt", "value": "a cat sits on a mat " * (i + 1)}]})
    texts = [{"id": 10 + i, "conversations": [
        {"from": "human", "value": "What does a memory token hold?"},
        {"from": "gpt", "value": "Describe the image. " * (3 + i)}]} for i in range(2)]
    mixed, videos = TRAIN_CLI_DIR / "mixed.json", TRAIN_CLI_DIR / "videos.json"
    mixed.write_text(json.dumps(items + texts))
    videos.write_text(json.dumps(items))
    return str(mixed), str(videos), str(vids)


def _cli_argv(data, vids, out, *extra):
    return ["--model_name_or_path", str(LOAD_DIR), "--data_path", data, "--video_folder", vids,
            "--output_dir", out, "--per_device_train_batch_size", "1",
            "--learning_rate", str(TRAIN_CLI_LR), "--warmup_ratio", "0", "--seed", "3", *extra]


@contextlib.contextmanager
def _watched_cli(record: dict):
    """The CLI's step functions, wrapped: after each micro-step, whether the
    watched trainable leaf (the first LM layer's q_proj) moved; the state
    before the first micro-step and after the last. Its exports, timed."""
    makers = {name: getattr(trainer, name) for name in ("make_train_step",
                                                        "make_text_train_step")}
    export = train_cli.checkpoint_io.export_hf_safetensors

    def leaf(state):
        return state.params["language_model"]["layers"][0]["q_proj"]["kernel"]

    def wrap(make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def watched(state, batch):
                record.setdefault("first", state)
                before = leaf(state)
                state, metrics = step(state, batch)
                record["moved"].append(not torch.equal(before, leaf(state)))
                record["state"] = state
                return state, metrics
            return watched
        return made

    def timed_export(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = export(*args, **kwargs)
        record["export_s"].append(time.perf_counter() - t0)
        return out

    record.update(moved=[], export_s=[])
    for name, make in makers.items():
        setattr(trainer, name, wrap(make))
    train_cli.checkpoint_io.export_hf_safetensors = timed_export
    try:
        yield record
    finally:
        for name, make in makers.items():
            setattr(trainer, name, make)
        train_cli.checkpoint_io.export_hf_safetensors = export


def _cli_records(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli_launches(cfg: VLMConfig, records: list, int8_tower: bool = False) -> dict:
    """Launches of the CLI's micro-steps: a video step is one bench_train
    step (64 frames), a text step the LM's training kernels alone."""
    video = sum("dropped_frames" in r for r in records)
    want = _lm_train_launches(cfg, len(records))
    want[_attn_kernel(cfg.memory.hidden_size // cfg.memory.num_attention_heads)] += \
        video * _memory_calls(cfg, 64)
    tower = {k: v * video for k, v in _expected_tower_launches(cfg, False).items() if v}
    if int8_tower:
        want.update(tower)
    else:
        want[_attn_kernel(cfg.vision.hidden_size // cfg.vision.num_attention_heads)] += \
            video * cfg.vision.num_used_layers
    return want


def _check_cli_run(label, records, record, moved_on, cfg, launches, int8_tower=False):
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: losses {losses}")
    steps = [r["step"] for r in records]
    if record["moved"] != [s in moved_on for s in steps]:
        raise RuntimeError(f"{label}: the watched leaf moved at {record['moved']} over micro-"
                           f"steps {steps}, want only at {moved_on}")
    for r in records:
        if "dropped_frames" in r and r["dropped_frames"] != trainer.synced_frame_dropout(
                r["step"] - 1):
            raise RuntimeError(f"{label}: micro-step {r['step']} dropped_frames "
                               f"{r['dropped_frames']}, synced_frame_dropout disagrees")
    want = _cli_launches(cfg, records, int8_tower)
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, want {want}")


def _held_equal_leaves(label, got, want):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"{label}: {name} differs")


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    float(out[1]["loss"])  # waits for the step
    return out, time.perf_counter() - t0


def _optimizer_update_s(params, opt) -> dict:
    """Seconds of one optimizer update alone at full width (zero gradients),
    host clock synchronised, the best of three after a warm-up: plain AdamW
    (`k1`), and with grad_accum_steps 2 the micro-step that only folds the
    mean (`k2_fold`) and the one that runs the chain on it (`k2_apply`)."""
    grads = tree_map(lambda x: torch.zeros(
        x.shape, dtype=x.dtype if x.is_floating_point() else torch.float32, device=x.device),
        params)

    def best(tx, state):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tx.update(grads, state, params)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times[1:])

    tx = optimizer.build_optimizer(params, dataclasses.replace(opt, grad_accum_steps=1))
    out = {"k1": best(tx, tx.init(params))}
    tx = optimizer.build_optimizer(params, dataclasses.replace(opt, grad_accum_steps=2))
    state = tx.init(params)
    out["k2_fold"] = best(tx, state)
    out["k2_apply"] = best(tx, tx.update(grads, state, params)[1])
    return out


def _sft_lora_dpo(cfg: VLMConfig, params, opt) -> dict:
    """One SFT step on two packed 2048-token rows, one LoRA step (r 8 over
    every LM projection of the bf16 base: the base bit-identical, every B
    factor moved) and one DPO step on a 64-frame pair, at full width on the
    card, each with its launches and seconds."""
    rng = np.random.default_rng(TRAIN_CLI_SEED)
    text = _lm_train_launches(cfg)
    launches, seconds = {}, {}
    packed = sft.pack_constant_length(
        [rng.integers(5, 2000, int(n)).tolist() for n in rng.integers(100, 900, 12)], 2048, 2)
    ids = torch.from_numpy(np.stack(packed[:2])).to("cuda")
    valid = torch.tensor([2048, 2048], device="cuda")

    _reset_launches()
    (state, m), seconds["sft"] = _timed(sft.make_sft_train_step(cfg, opt),
                                        trainer.init_train_state(params, opt), ids, ids, valid)
    launches["sft"] = _launches()
    if launches["sft"] != text or not math.isfinite(float(m["loss"])):
        raise RuntimeError(f"sft: launches {launches['sft']}, loss {float(m['loss'])}")
    del state

    lora_cfg = lora.LoraConfig(r=8, alpha=16)
    factors = lora.init_lora(params, lora_cfg, torch.Generator("cuda").manual_seed(0))
    base = [x.clone() for _, x in _leaves(params)]
    _reset_launches()
    (state, m), seconds["lora"] = _timed(
        lora.make_lora_train_step(cfg, opt, lora_cfg), trainer.init_train_state(factors, opt),
        params, trainer.TextBatch(ids, ids, valid))
    launches["lora"] = _launches()
    if launches["lora"] != text or not math.isfinite(float(m["loss"])):
        raise RuntimeError(f"lora: launches {launches['lora']}, loss {float(m['loss'])}")
    if any(not torch.equal(a, b) for a, (_, b) in zip(base, _leaves(params))):
        raise RuntimeError("lora: the base moved")
    frozen_b = [n for n, x in _leaves(state.params) if n.endswith(".b") and not x.any()]
    if frozen_b:
        raise RuntimeError(f"lora: B factors that did not move: {frozen_b[:4]}")
    n_factors = len(_leaves(factors))
    del state, factors, base

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    chosen, rejected = (rng.integers(5, 2000, (1, DPO_TEXT)) for _ in range(2))
    batch = dpo.DPOBatch(
        pixels=torch.from_numpy(rng.standard_normal(
            (1, 64, cfg.vision.image_size, cfg.vision.image_size, 3), np.float32)).to(
            "cuda", torch.bfloat16),
        frame_indices=t(np.arange(64)[None]), frame_valid=t(np.ones((1, 64)), torch.bool),
        fine_idx=t(vlm.fine_frame_indices(64, cfg.memory.num_fine_frames)[None]),
        chosen_ids=t(chosen), chosen_labels=t(chosen), rejected_ids=t(rejected),
        rejected_labels=t(rejected), image_pos=t([3]), chosen_len=t([DPO_TEXT]),
        rejected_len=t([DPO_TEXT]))
    _reset_launches()
    (state, m), seconds["dpo"] = _timed(
        dpo.make_dpo_train_step(cfg, opt, dpo.DPOConfig(), nseg=2),
        trainer.init_train_state(params, opt), params, batch)
    launches["dpo"] = _launches()
    # two policy passes with a backward, two reference passes without
    want = _lm_train_launches(cfg, passes=2)
    want["flash_fwd_lse"] += 2 * cfg.lm.num_hidden_layers
    want["flash_fwd"] = cfg.vision.num_used_layers + _memory_calls(cfg, 64)
    metrics = {k: float(v) for k, v in m.items()}
    if launches["dpo"] != want or not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"dpo: launches {launches['dpo']} (want {want}), metrics {metrics}")
    # the policy starts as the reference: the DPO term is log 2
    if not abs(metrics["dpo_loss"] - math.log(2.0)) <= 1e-2:
        raise RuntimeError(f"dpo: dpo_loss {metrics['dpo_loss']} at the reference, not log 2")
    del state
    log(json.dumps({"sft_lora_dpo_seconds": seconds, "sft_tokens": 2 * 2048,
                    "lora_factors": n_factors, "dpo_metrics": metrics}))
    return launches, seconds


def phase_train_cli():
    """`python -m memory_augmented_vlm_torch.train.cli`'s `main` at full width
    over `phase_load`'s checkpoint and `_write_tokenizer`'s tokenizer (made
    here when absent), then SFT, LoRA and DPO steps; deletes LOAD_DIR and
    TRAIN_CLI_DIR at the end. Runs: (A) the mixed manifest, k = 2, B = 1,
    --max_steps 2 --save_steps 2 --dropout_frames: 4 micro-steps whose
    watched leaf moves on 2 and 4 only, finite losses, dropout decisions
    equal to synced_frame_dropout, exact launches, checkpoint-2 and -4 and
    an export that loads back through load_pretrained_model equal to the
    final state; (B) the same directory with --max_steps 3 --save_steps 1,
    stopped after checkpoint-5 (the middle of an accumulation); (C) the
    same again, which resumes from checkpoint-5 and ends at micro-step 6,
    the update applied there; (D) --tower_int8 on the videos alone, one
    micro-step under torch.profiler: the tower's int8 leaves and scales
    bit-identical, fused_qkv_int8 / merge / fused_mlp_block_int8 26 each,
    and the trace holds the data, step and checkpoint spans. Returns the
    launches by path and the timings."""
    log(f"train CLI phase on {require_card()}")
    t_phase = time.perf_counter()
    cfg = VLMConfig.onevision_0_5b()
    if not (LOAD_DIR / "config.json").exists():
        _export_checkpoint(cfg)
    if not (LOAD_DIR / "tokenizer.json").exists():
        _write_tokenizer(LOAD_DIR)
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    mixed, videos, vids = _train_cli_data()
    out = str(TRAIN_CLI_DIR / "run")
    accumulate = ("--gradient_accumulation_steps", "2", "--dropout_frames")
    launches, timings = {}, {}

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _watched_cli({}) as rec:
        train_cli.main(_cli_argv(mixed, vids, out, *accumulate, "--max_steps", "2",
                                 "--save_steps", "2"))
    launches["train_cli"] = _launches()
    records = _cli_records(out)
    if [r["step"] for r in records] != [1, 2, 3, 4]:
        raise RuntimeError(f"train CLI: micro-steps {[r['step'] for r in records]}")
    _check_cli_run("train CLI", records, rec, {2, 4}, cfg, launches["train_cli"])
    for name in ("checkpoint-2", "checkpoint-4", "hf_export/model.safetensors"):
        if not os.path.exists(os.path.join(out, name)):
            raise RuntimeError(f"train CLI: no {name}")
    timings.update(micro_step_s=[r["last_step_s"] for r in records],
                   accumulated_step_s=records[2]["last_step_s"] + records[3]["last_step_s"],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
                   export_s=rec["export_s"][0],
                   checkpoint_snapshot_s=records[2]["last_checkpoint_s"])  # the save at 2
    _, model, _, _ = load_pretrained_model(os.path.join(out, "hf_export"))
    _held_equal_leaves("train CLI export, loaded back", model.params, rec["state"].params)
    rec_a = rec["moved"]
    del model, rec
    torch.cuda.empty_cache()

    resume = ("--max_steps", "3", "--save_steps", "1")
    save = train_cli.checkpoint_io.save_checkpoint

    def save_then_stop(ckpt_dir, state, step, **kw):
        path = save(ckpt_dir, state, step, **kw)
        if step == 5:
            train_cli.checkpoint_io.wait_for_checkpoints()
            raise _Stop
        return path

    train_cli.checkpoint_io.save_checkpoint = save_then_stop
    try:
        with _watched_cli({}) as rec_b:
            train_cli.main(_cli_argv(mixed, vids, out, *accumulate, *resume))
        raise RuntimeError("train CLI: the run meant to stop at micro-step 5 did not")
    except _Stop:
        pass
    finally:
        train_cli.checkpoint_io.save_checkpoint = save
    with _watched_cli({}) as rec_c:
        train_cli.main(_cli_argv(mixed, vids, out, *accumulate, *resume))
    launches["train_cli"] = _launches()
    records = _cli_records(out)
    if [r["step"] for r in records] != [1, 2, 3, 4, 5, 6]:
        raise RuntimeError(f"train CLI resumed: micro-steps {[r['step'] for r in records]}")
    moves = {"moved": rec_a + rec_b["moved"] + rec_c["moved"]}
    _check_cli_run("train CLI resumed", records, moves, {2, 4, 6}, cfg, launches["train_cli"])
    del rec_b, rec_c
    torch.cuda.empty_cache()

    out_d = str(TRAIN_CLI_DIR / "run_int8")
    _reset_launches()
    start_profiler(str(TRAIN_CLI_DIR / "trace"))
    try:
        with _watched_cli({}) as rec:
            train_cli.main(_cli_argv(videos, vids, out_d, "--tower_int8", "--max_steps", "1",
                                     "--gradient_accumulation_steps", "1", "--save_steps", "1"))
    finally:
        trace = stop_profiler()
    launches["train_cli_tower_int8"] = _launches()
    records = _cli_records(out_d)
    int8_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                     tower_int8=True))
    _check_cli_run("train CLI --tower_int8", records, rec, {1}, int8_cfg,
                   launches["train_cli_tower_int8"], int8_tower=True)
    tower0, tower1 = rec["first"].params["vision_tower"], rec["state"].params["vision_tower"]
    if not any(x.dtype == torch.int8 for _, x in _leaves(tower0)):
        raise RuntimeError("train CLI --tower_int8: the tower holds no int8 leaf")
    _held_equal_leaves("train CLI --tower_int8 tower", tower1, tower0)
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if not {"data", "step", "checkpoint"} <= names:
        raise RuntimeError("train CLI profile: the trace lacks a data, step or checkpoint "
                           "span")
    timings["int8_tower_micro_step_s"] = records[0]["last_step_s"]
    del rec, tower0, tower1
    torch.cuda.empty_cache()

    _, model, _, _ = load_pretrained_model(str(LOAD_DIR))
    opt = optimizer.OptimizerConfig(learning_rate=TRAIN_CLI_LR, warmup_ratio=0.0, total_steps=10)
    timings["optimizer_update_s"] = _optimizer_update_s(model.params, opt)
    more, seconds = _sft_lora_dpo(model.cfg, model.params, opt)
    launches.update(more)
    timings.update({f"{k}_step_s": v for k, v in seconds.items()})
    del model
    shutil.rmtree(LOAD_DIR)
    shutil.rmtree(TRAIN_CLI_DIR)
    torch.cuda.empty_cache()
    log(json.dumps({"train_cli": timings, "launches": launches,
                    "train_cli_phase_s": time.perf_counter() - t_phase}))
    return launches


# the train CLI on small family checkpoints: each family's --version and
# the chat specials its preprocess reads
FAMILY_CLI = {
    "llava_gemma": ("gemma", {"specials": ["<pad>", "<eos>", "<bos>", "<start_of_turn>",
                                           "<end_of_turn>"],
                              "eos_token": "<eos>", "pad_token": "<pad>", "bos_token": "<bos>"}),
    "llava_llama": ("llava_llama_3", {"specials": ["<|begin_of_text|>", "<|end_of_text|>",
                                                   "<|start_header_id|>", "<|end_header_id|>",
                                                   "<|eot_id|>"],
                                      "eos_token": "<|eot_id|>",
                                      "pad_token": "<|end_of_text|>"}),
}
FAMILY_CLI_DIR = Path(__file__).resolve().parent / "build" / "train_cli_families"


def _family_cli_data(root: Path):
    """One 65-frame 64x64 uint8 video (.npy, 1 fps: 64 sampled, two
    segments) and one text sample under `root`: (manifest, video folder)."""
    rng = np.random.default_rng(TRAIN_CLI_SEED + 1)
    vids = root / "videos"
    vids.mkdir(parents=True, exist_ok=True)
    np.save(vids / "v0.npy", rng.integers(0, 256, (TRAIN_CLI_FRAMES, 64, 64, 3), dtype=np.uint8))
    items = [{"id": 0, "video": "v0.npy", "conversations": [
                 {"from": "human", "value": "<image>\nWhat happens in the video?"},
                 {"from": "gpt", "value": "a cat sits on a mat " * 3}]},
             {"id": 1, "conversations": [
                 {"from": "human", "value": "What does a memory token hold?"},
                 {"from": "gpt", "value": "Describe the image. " * 4}]}]
    (root / "data.json").write_text(json.dumps(items))
    return str(root / "data.json"), str(vids)


def _family_cli_run(label, directory, version, data, vids, out, device, dtype):
    """`train_cli.main` over the checkpoint at `directory`, loaded on
    `device` in `dtype` (`build_model` replaced, as the CPU tests replace
    it), two micro-steps of one sample, k = 1, --dropout_frames: (records,
    the watched record, launches)."""
    def build(args):
        tokenizer, model, _, _ = load_pretrained_model(
            args.model_name_or_path, None, "llava_qwen", torch_dtype=dtype, device_map=device)
        return tokenizer, model.params, model.cfg

    shutil.rmtree(out, ignore_errors=True)
    _reset_launches()
    with _patched(train_cli, "build_model", build), _watched_cli({}) as rec:
        train_cli.main(["--model_name_or_path", str(directory), "--data_path", data,
                        "--video_folder", vids, "--output_dir", out, "--version", version,
                        "--per_device_train_batch_size", "1", "--gradient_accumulation_steps",
                        "1", "--max_steps", "2", "--save_steps", "100", "--dropout_frames",
                        "--learning_rate", str(TRAIN_CLI_LR), "--warmup_ratio", "0",
                        "--seed", "3"])
    records = _cli_records(out)
    if [r["step"] for r in records] != [1, 2]:
        raise RuntimeError(f"{label}: micro-steps {[r['step'] for r in records]}")
    return records, rec, _launches()


def _family_sft_lora(family, cfg, params) -> dict:
    """One SFT step (two packed 512-token rows) and one LoRA step (r 8) on a
    family checkpoint's bf16 params on the card: finite losses, the LM's
    training kernels at its head dim (`_lm_train_launches`)."""
    rng = np.random.default_rng(TRAIN_CLI_SEED)
    opt = optimizer.OptimizerConfig(learning_rate=TRAIN_CLI_LR, warmup_ratio=0.0, total_steps=10)
    ids = torch.from_numpy(rng.integers(5, 2000, (2, 512))).to("cuda")
    valid = torch.tensor([512, 300], device="cuda")
    want, launches = _lm_train_launches(cfg), {}
    _reset_launches()
    _, m = sft.make_sft_train_step(cfg, opt)(trainer.init_train_state(params, opt), ids, ids,
                                             valid)
    launches[f"{family}_sft"] = _launches()
    lora_cfg = lora.LoraConfig(r=8, alpha=16)
    factors = lora.init_lora(params, lora_cfg, torch.Generator("cuda").manual_seed(0))
    _reset_launches()
    _, m2 = lora.make_lora_train_step(cfg, opt, lora_cfg)(
        trainer.init_train_state(factors, opt), params, trainer.TextBatch(ids, ids, valid))
    launches[f"{family}_lora"] = _launches()
    losses = [float(m["loss"]), float(m2["loss"])]
    for path, got in launches.items():
        if got != want:
            raise RuntimeError(f"{path}: launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{family} SFT / LoRA losses {losses}")
    log(json.dumps({"family_sft_lora": family, "losses": losses}))
    return launches


def phase_train_cli_families():
    """The train CLI (`train.cli.main`) on the small family checkpoints of
    `family_checkpoint` (written under build/ with a tokenizer holding the
    family's chat specials, FAMILY_CLI), over a 65-frame video and a text
    sample, two micro-steps, k = 1: llava_gemma (`--version gemma`; tied,
    2 heads of 256 over one KV head) in bf16 on the card, its launches held
    (the LM's training kernels at 256) and the watched leaf moved at each
    update; the untied llava_llama (`--version llava_llama_3`) in fp32 on
    the card and again on the CPU, the first micro-step's loss held to
    TRAIN_PARITY_LOSS_RTOL, its launches held and its `lm_head` moved. Then
    one SFT and one LoRA step on each checkpoint's bf16 params. Returns the
    launches by path."""
    t_phase = time.perf_counter()
    shutil.rmtree(FAMILY_CLI_DIR, ignore_errors=True)
    data, vids = _family_cli_data(FAMILY_CLI_DIR)
    launches, losses = {}, {}
    for family, (version, chat) in FAMILY_CLI.items():
        directory = FAMILY_CLI_DIR / family
        _, cfg, _ = family_checkpoint(directory, family)
        _write_tokenizer(directory, chat)
        out = str(FAMILY_CLI_DIR / f"run_{family}")
        dtype = "bfloat16" if family == "llava_gemma" else "float32"
        records, rec, got = _family_cli_run(f"train CLI {family}", directory, version, data,
                                            vids, out, "cuda", dtype)
        _check_cli_run(f"train CLI {family}", records, rec, {1, 2}, cfg, got)
        launches[f"train_cli_{family}"] = got
        losses[family] = [r["loss"] for r in records]
        if family == "llava_llama":
            first = rec["first"].params["language_model"]
            if "lm_head" not in first or torch.equal(
                    first["lm_head"], rec["state"].params["language_model"]["lm_head"]):
                raise RuntimeError("train CLI llava_llama: lm_head is missing or did not move")
            cpu_records, _, _ = _family_cli_run("train CLI llava_llama on the CPU", directory,
                                                version, data, vids, out + "_cpu", "cpu",
                                                dtype)
            a, b = records[0]["loss"], cpu_records[0]["loss"]
            losses["llava_llama_cpu"] = [r["loss"] for r in cpu_records]
            if not abs(a - b) <= TRAIN_PARITY_LOSS_RTOL * abs(b):
                raise RuntimeError(f"train CLI llava_llama: first loss {a} on the card, {b} on "
                                   "the CPU")
        del rec
        _, model, _, _ = load_pretrained_model(str(directory))
        launches.update(_family_sft_lora(family, model.cfg, model.params))
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(FAMILY_CLI_DIR)
    log(json.dumps({"train_cli_families": losses, "launches": {
        path: {k: v for k, v in counts.items() if v} for path, counts in launches.items()},
        "phase_s": time.perf_counter() - t_phase}))
    return launches


# The TRL extras (PPO with a value head, the reward model, iterative SFT,
# best-of-N, the tool-use text environment, DDPO) on Qwen2-0.5B at full
# width: bf16 weights from a seed, token ids from a seed, a toy byte-level
# tokenizer where text is needed.
TRL_SEED = 28
TRL_LR = TRAIN_CLI_LR  # a bf16 LM leaf moves on each update
TRL_QUERIES, TRL_QUERY_LEN, TRL_NEW = 4, 64, 32
TRL_REWARD_PAIRS, TRL_REWARD_LEN = 4, 96
TRL_SFT_SAMPLES, TRL_SFT_BATCH = 8, 4
TRL_BON_SIZE, TRL_BON_LENGTHS = 4, (16, 48)
TRL_ENV_TASKS, TRL_ENV_TURNS, TRL_ENV_NEW = 4, 2, 16
DDPO_SIGMA = 0.3


def _trl_opt(parts: str = "mm_language_model,value_head") -> optimizer.OptimizerConfig:
    return optimizer.OptimizerConfig(learning_rate=TRL_LR, warmup_ratio=0.0, total_steps=10,
                                     mm_tunable_parts=parts)


def _byte_text(ids) -> str:
    """The toy tokenizer's decode: each id to a printable character."""
    return "".join(chr(32 + int(t) % 95) for t in ids)


def _byte_ids(text: str) -> list:
    return [ord(c) for c in text]


def _finite(label, metrics: dict) -> dict:
    out = {k: float(v) for k, v in metrics.items()}
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"{label}: not finite: {bad}")
    return out


def _leaf(tree, name: str) -> torch.Tensor:
    return dict(_leaves(tree))[name]


def _watched(cfg: VLMConfig) -> str:
    """An LM leaf that an update must move: the last layer's down_proj."""
    return f"language_model.layers.{cfg.lm.num_hidden_layers - 1}.down_proj.kernel"


def _moved(label, before, after, names):
    still = [n for n in names if torch.equal(_leaf(before, n), _leaf(after, n))]
    if still:
        raise RuntimeError(f"{label}: did not move: {still}")


def _ppo_round(cfg, policy, ref, rm, rng) -> dict:
    """4 queries of 64 tokens, 32 sampled tokens each (`generate_batched`);
    the rollout's statistics (`forward_with_value` for the old log-probs and
    values, the frozen reference's log-probs, `response_full_kl`,
    `sequence_reward`'s scores); then two `make_ppo_train_step` steps
    (kl_penalty "full"), the KL controller updated between them."""
    lm_layers = cfg.lm.num_hidden_layers
    counted = _Counted("trl ppo round")
    t_round = time.perf_counter()
    q = torch.from_numpy(rng.integers(5, 2000, (TRL_QUERIES, TRL_QUERY_LEN))).to("cuda")
    embeds = qwen2.embed_tokens(policy["language_model"], q, cfg.lm)
    gen = torch.Generator("cuda").manual_seed(TRL_SEED)
    out = counted("rollout", lambda: vlm.generate_batched(
        policy, cfg, embeds, torch.full((TRL_QUERIES,), TRL_QUERY_LEN, dtype=torch.int32),
        max_new_tokens=TRL_NEW, do_sample=True, temperature=1.0, rng=gen),
        {"flash_fwd": lm_layers})
    num = out.num_tokens.long()
    ids = torch.cat([q, out.tokens.long()], dim=1)
    mask = (torch.arange(TRL_NEW, device="cuda")[None] < num[:, None]).float()
    qlen = torch.full((TRL_QUERIES,), TRL_QUERY_LEN, dtype=torch.int32, device="cuda")
    seq_len = (qlen + num).to(torch.int32)
    b, s = ids.shape
    positions = torch.arange(s, device="cuda")[None].expand(b, s)
    lse = {"flash_fwd_lse": lm_layers}
    with torch.no_grad():
        full = qwen2.embed_tokens(policy["language_model"], ids, cfg.lm)
        logits, values = counted("old log-probs and values", lambda: ppo.forward_with_value(
            policy, cfg, full, positions, seq_len), lse)
        old_lp, _, pos = ppo._response_logprobs(logits, ids, qlen, TRL_NEW)
        old_values = torch.gather(values, 1, (pos - 1).clamp(0, s - 1))
        ref_logits, _ = counted("reference log-probs", lambda: ppo.forward_with_value(
            ref, cfg, qwen2.embed_tokens(ref["language_model"], ids, cfg.lm), positions,
            seq_len), lse)
        ref_lp = ppo._response_logprobs(ref_logits, ids, qlen, TRL_NEW)[0]
        full_kls = ppo.response_full_kl(logits, ref_logits, qlen, TRL_NEW)
        scores = counted("scores", lambda: reward.sequence_reward(rm, cfg, ids, seq_len), lse)
        del logits, ref_logits
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t_round
    stats = _finite("ppo rollout", {"old_lp_mean": ppo.masked_mean(old_lp, mask),
                                    "ref_lp_mean": ppo.masked_mean(ref_lp, mask),
                                    "old_value_mean": ppo.masked_mean(old_values, mask),
                                    "full_kl_mean": ppo.masked_mean(full_kls, mask),
                                    "score_mean": scores.mean()})
    batch = ppo.PPOBatch(ids, mask, qlen, seq_len, old_lp, old_values, scores, ref_lp,
                         full_kls)
    ppo_cfg = ppo.PPOConfig(kl_penalty="full")
    step = ppo.make_ppo_train_step(cfg, _trl_opt(), ppo_cfg)
    ctl = ppo.make_kl_controller(ppo_cfg)
    state = trainer.init_train_state(policy, _trl_opt())
    steps, coefs, step_s = [], [], []
    for i in range(2):
        coefs.append(ctl.value)
        t0 = time.perf_counter()
        state, m = counted(f"ppo step {i}", lambda: step(state, batch, ctl.value),
                           {"flash_fwd_lse": lm_layers, "flash_bwd_dq": lm_layers,
                            "flash_bwd_dkv": lm_layers})
        step_s.append(time.perf_counter() - t0)
        steps.append(_finite(f"ppo step {i}", m))
        ctl.update(steps[-1]["objective_kl"], n_steps=TRL_QUERIES)
    if ctl.value == coefs[0]:
        raise RuntimeError("ppo: the KL controller did not move")
    _moved("ppo", policy, state.params, ["value_head.summary.kernel", _watched(cfg)])
    round_s = time.perf_counter() - t_round
    return {"launches": counted.total, "rollout": stats, "steps": steps, "kl_coefs": coefs,
            "response_tokens": int(num.sum()), "rollout_s": rollout_s, "step_s": step_s,
            "round_s": round_s, "rollout_share": rollout_s / round_s}


def _reward_step(cfg, rm, rng) -> dict:
    """One `make_reward_train_step` step on 4 chosen/rejected pairs of 96
    tokens (two `sequence_reward` passes under remat: each layer's forward
    twice)."""
    lm_layers = cfg.lm.num_hidden_layers
    counted = _Counted("trl reward step")

    def ids():
        return torch.from_numpy(rng.integers(5, 2000, (TRL_REWARD_PAIRS, TRL_REWARD_LEN))).to(
            "cuda")

    lens = torch.from_numpy(rng.integers(TRL_REWARD_LEN // 2, TRL_REWARD_LEN + 1,
                                         (2, TRL_REWARD_PAIRS)).astype(np.int32)).to("cuda")
    batch = reward.RewardBatch(ids(), lens[0], ids(), lens[1])
    t0 = time.perf_counter()
    state, m = counted("step", lambda: reward.make_reward_train_step(cfg, _trl_opt())(
        trainer.init_train_state(rm, _trl_opt()), batch),
        {"flash_fwd_lse": 4 * lm_layers, "flash_bwd_dq": 2 * lm_layers,
         "flash_bwd_dkv": 2 * lm_layers})
    seconds = time.perf_counter() - t0
    _moved("reward", rm, state.params, ["value_head.summary.kernel", _watched(cfg)])
    return {"launches": counted.total, "metrics": _finite("reward step", m), "step_s": seconds}


def _iterative_sft(cfg, lm_params, rng) -> dict:
    """One `IterativeSFT.step` over 8 samples of 40 to 95 tokens, batch 4:
    two minibatches of the text train step (remat: each layer's forward
    twice)."""
    lm_layers = cfg.lm.num_hidden_layers
    counted = _Counted("trl iterative sft")
    samples = [rng.integers(5, 2000, int(n)).tolist()
               for n in rng.integers(40, 96, TRL_SFT_SAMPLES)]
    tr = iterative_sft.IterativeSFT(cfg, _trl_opt("mm_language_model"),
                                    {"language_model": lm_params}, batch_size=TRL_SFT_BATCH,
                                    seed=TRL_SEED)
    t0 = time.perf_counter()
    out = counted("step", lambda: tr.step(input_ids=samples),
                  {"flash_fwd_lse": 4 * lm_layers, "flash_bwd_dq": 2 * lm_layers,
                   "flash_bwd_dkv": 2 * lm_layers})
    seconds = time.perf_counter() - t0
    if out["num_minibatches"] != 2 or out["step"] != 2 or not math.isfinite(out["loss"]):
        raise RuntimeError(f"iterative sft: {out}")
    _moved("iterative sft", {"language_model": lm_params}, tr.state.params, [_watched(cfg)])
    return {"launches": counted.total, "result": out, "step_s": seconds}


def _best_of_n(cfg, policy, rng) -> dict:
    """`BestOfNSampler` with 4 samples of one 64-token query, lengths from
    `LengthSampler(16, 48)` (a 64-token decode bucket): the texts it scored,
    and the returned text re-scored as the top of the four."""
    counted = _Counted("trl best-of-n")
    seen = {}

    def score(texts):  # distinct characters
        seen["texts"], seen["scores"] = list(texts), [float(len(set(t))) for t in texts]
        return seen["scores"]

    sampler = best_of_n.BestOfNSampler(
        policy, cfg, score, best_of_n.LengthSampler(*TRL_BON_LENGTHS, seed=TRL_SEED),
        decode=_byte_text, sample_size=TRL_BON_SIZE, seed=TRL_SEED)
    query = rng.integers(5, 2000, TRL_QUERY_LEN)
    t0 = time.perf_counter()
    out = counted("generate", lambda: sampler.generate(query),
                  {"flash_fwd": cfg.lm.num_hidden_layers})
    seconds = time.perf_counter() - t0
    texts, scores = seen["texts"], seen["scores"]
    best = texts[int(np.argsort(-np.asarray(scores), kind="stable")[0])]
    lengths = [len(t) - TRL_QUERY_LEN for t in texts]
    if (out != [[best]] or score(out[0])[0] != max(scores)
            or not all(TRL_BON_LENGTHS[0] <= n < TRL_BON_LENGTHS[1] for n in lengths)):
        raise RuntimeError(f"best-of-n: returned {out}, scores {scores}, lengths {lengths}")
    return {"launches": counted.total, "scores": scores, "completion_lengths": lengths,
            "generate_s": seconds}


def _text_environment(cfg, policy) -> dict:
    """`TextEnvironment.run` over 4 tasks with the real LM's turns
    (`generate_batched` with the `<call>`/`<submit>` stop sequences, 16 new
    tokens, greedy), at most 2 turns, one tool: #1 once a layer for each
    model turn; the query/response/mask split against the histories'
    spans."""
    counted = _Counted("trl text environment")
    turns = []
    inner = vlm.generate_batched

    def turn(*args, **kw):
        turns.append(args[2].shape[0])
        return inner(*args, **kw)

    env = text_environment.TextEnvironment(
        policy, cfg, encode=_byte_ids, decode=_byte_text, tools={"Calc": lambda q: str(len(q))},
        reward_fn=lambda texts: [float(len(t)) for t in texts], eos_text="\x7f",
        max_turns=TRL_ENV_TURNS, max_new_tokens=TRL_ENV_NEW, prompt="Task: ")
    tasks = [f"add {i} and {i + 1} with <request><Calc>...<call>" for i in range(TRL_ENV_TASKS)]
    t0 = time.perf_counter()
    with _patched(vlm, "generate_batched", turn):
        _reset_launches()
        queries, responses, masks, rewards, histories = env.run(tasks)
        torch.cuda.synchronize()
        got = _launches()
    seconds = time.perf_counter() - t0
    want = {**dict.fromkeys(WRAPPERS, 0), "flash_fwd": cfg.lm.num_hidden_layers * len(turns)}
    if got != want or not turns:
        raise RuntimeError(f"text environment: launches {got}, want {want} ({turns} turns)")
    for i, h in enumerate(histories):
        q, r, m = h.split_query_response_tokens()
        model = sum(b - a for (a, b), system in zip(h.token_spans, h.system_spans) if not system)
        if (q.tolist() != h.tokens[:h.token_spans[0][1]] or q.tolist() + r.tolist() != h.tokens
                or len(m) != len(r) or int(m.sum()) != model or not h.completed
                or not np.array_equal(queries[i], q) or not np.array_equal(responses[i], r)
                or not np.array_equal(masks[i], m) or rewards[i] != h.reward):
            raise RuntimeError(f"text environment: history {i} does not split by its spans")
    for name, n in got.items():
        counted.total[name] += n
    return {"launches": counted.total, "turn_rows": turns, "rewards": rewards,
            "response_tokens": [len(r) for r in responses], "run_s": seconds}


def _ddpo_toy(params, gen, prompt_embeds, num_steps):
    """JAX's toy Gaussian denoising policy (tests/test_ddpo.py), on the card:
    each step moves the latent halfway to mu = embeds @ params["mu"]."""
    b = prompt_embeds.shape[0]
    mu = prompt_embeds @ params["mu"]
    lat = [torch.zeros(b, device=mu.device)]
    lps = []
    for _ in range(num_steps):
        mean = lat[-1] + 0.5 * (mu - lat[-1])
        nxt = mean + DDPO_SIGMA * torch.randn(b, generator=gen, device=mu.device)
        lps.append(_ddpo_logprob(nxt, mean))
        lat.append(nxt)
    return {"latents": torch.stack(lat, 1), "log_probs": torch.stack(lps, 1),
            "timesteps": torch.arange(num_steps, device=mu.device)[None].expand(b, num_steps),
            "images": lat[-1]}


def _ddpo_logprob(x, mean):
    return (-0.5 * ((x - mean) / DDPO_SIGMA) ** 2 - math.log(DDPO_SIGMA)
            - 0.5 * math.log(2 * math.pi))


def _ddpo() -> dict:
    """One `DDPOTrainer.step` of the toy policy on the card: 2 batches of 8
    rollouts of 4 steps, 8 updates; no kernel of the port."""
    counted = _Counted("trl ddpo")
    trainer_ = ddpo.DDPOTrainer(
        ddpo.DDPOConfig(sample_num_steps=4, sample_batch_size=8, sample_num_batches_per_epoch=2,
                        train_batch_size=8, train_learning_rate=0.05, train_clip_range=0.2,
                        seed=TRL_SEED),
        {"mu": torch.zeros(2, device="cuda")}, sample_fn=_ddpo_toy,
        logprob_fn=lambda p, lat, t, nxt, emb: _ddpo_logprob(
            nxt, lat + 0.5 * (emb @ p["mu"] - lat)),
        prompt_fn=lambda: ("go", None),
        reward_fn=lambda images, prompts, meta: (-(images - 2.0).abs(), None),
        embed_fn=lambda prompts: torch.full((len(prompts), 2), 0.5, device="cuda"))
    t0 = time.perf_counter()
    step, metrics = counted("step", lambda: trainer_.step(0, 0), {})
    seconds = time.perf_counter() - t0
    metrics = _finite("ddpo", metrics)
    if step != 8 or not trainer_.params["mu"].abs().max() > 0:
        raise RuntimeError(f"ddpo: {step} updates, mu {trainer_.params['mu'].tolist()}")
    return {"launches": counted.total, "metrics": metrics, "mu": trainer_.params["mu"].tolist(),
            "step_s": seconds}


TRL_PARITY_SEED = 29
TRL_PARITY_B, TRL_PARITY_S, TRL_PARITY_T = 2, 48, 16


def _trl_parity_setup():
    """(the 0.5B config cut to 2 LM layers at full widths, a seeded fp32
    (LM, value head) tree on the CPU)."""
    cfg = _parity_cut(VLMConfig.onevision_0_5b())
    gen = torch.Generator().manual_seed(TRL_PARITY_SEED)
    return cfg, {"language_model": qwen2.init_params(cfg.lm, gen, "cpu", torch.float32),
                 "value_head": ppo.init_value_head(cfg.lm.hidden_size, gen, "cpu")}


def _trl_parity_batches(cfg, dev: str):
    """A PPOBatch (B 2, S 48, T 16; rollout log-probs near the model's, so
    the ratio is near 1 and the clip partly active) and a RewardBatch
    (B 2, S 48), from numpy."""
    rng = np.random.default_rng(TRL_PARITY_SEED)
    b, s, t = TRL_PARITY_B, TRL_PARITY_S, TRL_PARITY_T
    qlen, seq = np.array([32, 30], np.int32), np.array([48, 44], np.int32)
    near = -math.log(cfg.lm.vocab_size)

    def f32(x):
        return np.asarray(x, np.float32)

    arrays = dict(
        input_ids=rng.integers(5, 2000, (b, s)), query_len=qlen, seq_len=seq,
        response_mask=f32(np.arange(t)[None] < (seq - qlen)[:, None]),
        old_logprobs=f32(near + 0.2 * rng.standard_normal((b, t))),
        old_values=f32(0.1 * rng.standard_normal((b, t))), scores=f32([1.0, -0.5]),
        ref_logprobs=f32(near + 0.2 * rng.standard_normal((b, t))),
        full_kls=f32(np.abs(0.1 * rng.standard_normal((b, t)))))
    rew = dict(chosen_ids=rng.integers(5, 2000, (b, s)), chosen_len=np.array([48, 40], np.int32),
               rejected_ids=rng.integers(5, 2000, (b, s)),
               rejected_len=np.array([44, 48], np.int32))

    def put(d):
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in d.items()}

    return ppo.PPOBatch(**put(arrays)), reward.RewardBatch(**put(rew))


def _trl_parity_steps(dev: str, cliprange: float = 0.2, kinds=("kl", "full"),
                      with_reward: bool = True) -> dict:
    """One fp32 PPO step for each kl_penalty of `kinds` (kl_coef 0.2) and
    one reward step, each from `_trl_parity_setup`'s params on `dev`,
    keeping their gradients: {name: (metrics as floats, [(path, gradient on
    the CPU)], seconds, launches)}."""
    cfg, params = _trl_parity_setup()
    if dev == "cuda":
        params = _to_cuda(params)
    ppo_batch, reward_batch = _trl_parity_batches(cfg, dev)
    steps = {f"ppo_{kind}": (functools.partial(ppo.make_ppo_train_step(
        cfg, _trl_opt(), ppo.PPOConfig(kl_penalty=kind, cliprange=cliprange)), kl_coef=0.2),
        ppo_batch) for kind in kinds}
    if with_reward:
        steps["reward"] = (reward.make_reward_train_step(cfg, _trl_opt()), reward_batch)
    out = {}
    for name, (step, batch) in steps.items():
        _reset_launches()
        t0 = time.perf_counter()
        _, metrics, grads = _step_state_grads(step, trainer.init_train_state(params, _trl_opt()),
                                              batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     [(n, g.cpu()) for n, g in grads], time.perf_counter() - t0, _launches())
    return out


def _held_stats(label, got: dict, want: dict):
    """Every statistic of a card step against the CPU's: TRAIN_PARITY_LOSS_RTOL
    of its own magnitude plus TRAIN_PARITY_MODEL_RTOL of the largest
    statistic's (advantages_mean is a mean of whitened values, ~1e-8)."""
    scale = max(abs(v) for v in want.values())
    outside = [(k, got[k], v) for k, v in want.items()
               if not abs(got[k] - v) <= TRAIN_PARITY_LOSS_RTOL * abs(v)
               + TRAIN_PARITY_MODEL_RTOL * scale]
    if set(got) != set(want) or outside:
        raise RuntimeError(f"{label}: statistics outside their tolerance (name, card, cpu): "
                           f"{outside}")


def _trl_parity(cfg) -> dict:
    """The fp32 cut of the PPO and reward steps (`_trl_parity_steps`): the card
    (#9-#11 through their fp32 kernels) against the CPU (plain versions),
    every statistic (`_held_stats`), grad_norm and every gradient leaf
    (`_held_grads`); the card's launches exact (2 LM layers: a PPO step's
    forward once a layer, the reward step's two passes twice under remat).
    A control, the kl step on the card with cliprange 0.3, must fail."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _cpu_reference("trl_parity", lambda: _trl_parity_steps("cpu"))
    card = _trl_parity_steps("cuda")
    lm_layers = _parity_cut(VLMConfig.onevision_0_5b()).lm.num_hidden_layers
    fwd, dq, dkv = _train_kernel_names(cfg.lm.head_dim)
    total = dict.fromkeys(WRAPPERS, 0)
    rows = {}
    for name, (mg, gg, tg, launches) in card.items():
        k = 2 if name == "reward" else 1  # passes; the reward's under remat
        want = {**dict.fromkeys(WRAPPERS, 0), fwd: k * k * lm_layers, dq: k * lm_layers,
                dkv: k * lm_layers}
        if launches != want:
            raise RuntimeError(f"trl parity {name}: launches {launches}, want {want}")
        mc, gc, tc, _ = cpu[name]
        _held_stats(f"trl parity {name}", mg, mc)
        model_max, worst = _held_grads(f"trl parity {name}", gg, gc)
        rows[name] = {"loss_card": mg.get("loss/total", mg.get("loss")),
                      "loss_cpu": mc.get("loss/total", mc.get("loss")),
                      "grad_norm_card": mg["grad_norm"], "grad_norm_cpu": mc["grad_norm"],
                      "grad_leaves": len(gg), "model_max_grad": model_max,
                      "worst_leaves_err_over_tol_err_max_floor": worst,
                      "card_step_s": tg, "cpu_step_s": tc}
        for n, c in launches.items():
            total[n] += c
    control = _trl_parity_steps("cuda", cliprange=0.3, kinds=("kl",), with_reward=False)
    mg, gg, _, _ = control["ppo_kl"]
    try:
        _held_stats("control", mg, cpu["ppo_kl"][0])
        _held_grads("control", gg, cpu["ppo_kl"][1])
    except RuntimeError as err:
        rows["control_fails"] = str(err)[:200]
    else:
        raise RuntimeError("trl parity: the cliprange 0.3 control passed the check")
    del card, cpu, control
    torch.cuda.empty_cache()
    log(json.dumps({"trl_parity": rows}))
    return total


def phase_trl_extras():
    """The TRL extras at Qwen2-0.5B's full width (24 layers, 896 over 14 heads
    and 2 KV heads of 64, vocabulary 151936), bf16 weights from a seed: a
    PPO round (a policy with a value head, a frozen reference copy, a reward
    model from `init_reward_params`; `_ppo_round`), a reward step, an
    iterative-SFT step, best-of-N, the text environment and DDPO's toy
    policy, each path's launches of #1 and #9-#11 exact; then the fp32
    2-layer cut of the PPO and reward steps against the CPU with its
    control (`_trl_parity`). Logs the round's seconds, the rollout's share
    and the peak memory; returns the launches by path."""
    t_phase = time.perf_counter()
    cfg = VLMConfig.onevision_0_5b()
    rng = np.random.default_rng(TRL_SEED)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda").manual_seed(TRL_SEED)
    lm = qwen2.init_params(cfg.lm, gen, "cuda", torch.bfloat16)
    policy = {"language_model": lm,
              "value_head": ppo.init_value_head(cfg.lm.hidden_size, gen, "cuda")}
    ref = tree_map(torch.clone, policy)
    rm = reward.init_reward_params(cfg, qwen2.init_params(cfg.lm, gen, "cuda", torch.bfloat16),
                                   gen, "cuda")
    results = {"ppo_round": _ppo_round(cfg, policy, ref, rm, rng)}
    results["peak_memory_gb_ppo_round"] = torch.cuda.max_memory_allocated() / 2**30
    results["reward_step"] = _reward_step(cfg, rm, rng)
    del rm
    results["iterative_sft"] = _iterative_sft(cfg, ref["language_model"], rng)
    del ref
    results["best_of_n"] = _best_of_n(cfg, policy, rng)
    results["text_environment"] = _text_environment(cfg, policy)
    results["ddpo"] = _ddpo()
    results["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    vlm.clear_decoders()
    del policy, lm
    gc.collect()
    torch.cuda.empty_cache()
    launches = {f"trl_{name}": results[name].pop("launches")
                for name in ("ppo_round", "reward_step", "iterative_sft", "best_of_n",
                             "text_environment", "ddpo")}
    log(json.dumps({"trl_extras": results}))
    launches["trl_parity_fp32"] = _trl_parity(cfg)
    log(json.dumps({"trl_extras_launches": {
        path: {k: v for k, v in counts.items() if v} for path, counts in launches.items()},
        "phase_s": time.perf_counter() - t_phase}))
    return launches


# The CPU halves of the parity checks (plain versions over full widths, a
# few minutes of the card machine's CPU in all), computed by a child
# process while the card runs the kernel phases, so that they take no time
# of their own; a phase that needs one waits for the child. Without a
# child (a phase called alone) each is computed in the calling process.
CPU_REFERENCE_DIR = Path(__file__).resolve().parent / "build" / "cpu_references"
CPU_REFERENCE_JOBS = {
    "gemma_parity": _gemma_parity_cpu,
    "trl_parity": lambda: _trl_parity_steps("cpu"),
    "train_parity": lambda: _parity_step(*_train_parity_setup(), 8, "cpu"),
    "accumulated_update": lambda: _accumulated_run(*_train_parity_setup(), "cpu"),
    "train_parity_gemma": lambda: _parity_step(*_gemma_train_parity_setup(), 2, "cpu"),
    "train_parity_7b": lambda: _parity_step(*_7b_train_parity_setup(), 2, "cpu",
                                            PARITY_7B_FRAMES),
}
_CPU_CHILD = {}


def _cpu_references():
    """The child: every CPU_REFERENCE_JOBS entry in order, each saved under
    CPU_REFERENCE_DIR as it is done, on all cores but two (the parent's
    host work keeps them)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 4) - 2))
    torch.backends.cudnn.allow_tf32 = False
    for name, job in CPU_REFERENCE_JOBS.items():
        t0 = time.perf_counter()
        result = job()
        torch.save(result, CPU_REFERENCE_DIR / f"{name}.tmp")
        os.replace(CPU_REFERENCE_DIR / f"{name}.tmp", CPU_REFERENCE_DIR / f"{name}.pt")
        log(f"cpu reference {name}: {time.perf_counter() - t0:.1f} s")


def _start_cpu_references():
    """Start the child (no card visible to it), its output in a log."""
    shutil.rmtree(CPU_REFERENCE_DIR, ignore_errors=True)
    CPU_REFERENCE_DIR.mkdir(parents=True)
    out = open(CPU_REFERENCE_DIR / "child.log", "w")
    _CPU_CHILD["proc"] = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke._cpu_references()"],
        cwd=str(Path(__file__).resolve().parent), stdout=out, stderr=subprocess.STDOUT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    _CPU_CHILD["log"] = out


def _stop_cpu_references():
    proc = _CPU_CHILD.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "log" in _CPU_CHILD:
        _CPU_CHILD.pop("log").close()


def _cpu_reference(name: str, compute):
    """The CPU half `name`: the child's, once it is saved (waiting for it),
    else `compute()` here. A child that ended without it raises with its
    log."""
    proc = _CPU_CHILD.get("proc")
    if proc is None:
        return compute()
    path = CPU_REFERENCE_DIR / f"{name}.pt"
    t0 = time.perf_counter()
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            tail = (CPU_REFERENCE_DIR / "child.log").read_text()[-3000:]
            raise RuntimeError(f"the CPU reference process ended (rc {proc.returncode}) "
                               f"without {name}:\n{tail}")
        time.sleep(0.5)
    log(json.dumps({"cpu_reference": name, "waited_s": time.perf_counter() - t0}))
    return torch.load(path, weights_only=False)


def _phase(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, its seconds logged as one line."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(json.dumps({"phase": fn.__name__, "seconds": time.perf_counter() - t0}))
    return out


def main():
    phase_card()
    _phase(phase_build)
    _start_cpu_references()
    try:
        _main()
    finally:
        _stop_cpu_references()
    shutil.rmtree(CPU_REFERENCE_DIR, ignore_errors=True)


def _main():
    train_kernels, flash_backward = _phase(phase_train_kernels)
    kernels = [*_phase(phase_flash_kernel), *_phase(phase_int8_kernels),
               *_phase(phase_fused_kernels), *train_kernels, *_phase(phase_int8_attn_kernels)]
    kernels[0]["backward"] = flash_backward
    chain_launches = _phase(phase_chain)
    attn_block_launches = _phase(phase_attn_block)
    microbench_launches = _phase(phase_microbench)
    launches = _phase(phase_requests)
    launches["7b_int8_64_frames"] = _phase(phase_requests_7b)
    d256_row, gemma_launches = _phase(phase_requests_gemma)
    kernels.insert(2, d256_row)
    launches.update(gemma_launches)
    launches["serving"] = _phase(phase_serving)
    launches.update(_phase(phase_load, keep=True))
    launches.update(_phase(phase_eval, keep=True))
    launches.update(_phase(phase_serve_stack))
    launches.update(_phase(phase_train_cli))
    launches.update(_phase(phase_train_cli_families))
    launches.update(_phase(phase_trl_extras))
    _phase(phase_entry_point)
    launches["int8_mlp_chain"] = chain_launches
    launches["attn_block"] = attn_block_launches
    launches.update(microbench_launches)
    launches["train_step"] = _phase(phase_train)
    launches["train_step_gemma"] = _phase(phase_train_gemma)
    _phase(phase_bench_train)
    _phase(phase_parity)
    _phase(phase_train_parity)
    launches["train_parity_gemma"] = _phase(phase_train_parity_gemma)
    launches["train_parity_7b"] = _phase(phase_train_parity_7b)
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
