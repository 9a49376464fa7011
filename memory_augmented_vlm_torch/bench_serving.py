"""Serving benchmark of the port: continuous-batching decode throughput on
the 0.5B LM (the sglang-class worker's steady state), the counterpart of
the root `bench_serving.py` (its flags, metric and JSON keys).

    python -m memory_augmented_vlm_torch.bench_serving [--num_slots 4] [--max_len 2048]
        [--prompt_len 1500] [--decode_tokens 64] [--kv_int8] [--chunk_prefill 512]
        [--speculative K] [--decode_ticks K] [--paged_page_size PS] [--paged_pages N]

Fills every engine slot with a prompt of seeded random ids on seeded random
bf16 weights, then measures the sustained decode tokens/s across the pool:
the time to every slot's first token, then the rest of the tokens over
host clock time (the engine reads each tick's tokens back, so the clock
ends after the card's work). The relay fields of the root script
(`dispatch_floor_ms`, `device_ms_per_round`,
`projected_tokens_per_s_1ms_dispatch`) have no counterpart; `backend`
names the card (name and power limit, as nvidia-smi gives them). Prints ONE
JSON line. Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from memory_augmented_vlm_torch.config import VLMConfig
from memory_augmented_vlm_torch.microbench.timing import require_card
from memory_augmented_vlm_torch.models import qwen2
from memory_augmented_vlm_torch.serve.batch_engine import BatchEngine

METRIC = "serving_decode_tokens_per_s_0.5b"
EOS = (151645,)
WAIT_S = 600  # the longest wait for one engine output


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_slots", type=int, default=4)
    ap.add_argument("--max_len", type=int, default=2048)
    ap.add_argument("--prompt_len", type=int, default=1500)
    ap.add_argument("--decode_tokens", type=int, default=64,
                    help="tokens per request in the timed phase")
    ap.add_argument("--kv_int8", action="store_true")
    ap.add_argument("--chunk_prefill", type=int, default=0)
    ap.add_argument("--speculative", type=int, default=0)
    ap.add_argument("--decode_ticks", type=int, default=1)
    ap.add_argument("--paged_page_size", type=int, default=0)
    ap.add_argument("--paged_pages", type=int, default=None)
    return ap.parse_args(argv)


def make_engine(params, cfg: VLMConfig, args: argparse.Namespace) -> BatchEngine:
    return BatchEngine(params, cfg, num_slots=args.num_slots, max_len=args.max_len,
                       kv_int8=args.kv_int8, chunk_prefill=args.chunk_prefill,
                       speculative=args.speculative, decode_ticks=args.decode_ticks,
                       paged_page_size=args.paged_page_size, paged_pages=args.paged_pages)


def measure(engine: BatchEngine, lm, args: argparse.Namespace,
            rng: np.random.Generator) -> dict:
    """Fill every slot (the first requests also build the kernels), take
    each slot's first token, then drain the rest: the root script's
    measurement. The engine must be started."""
    def submit():
        ids = rng.integers(0, 1000, size=(args.prompt_len,))
        emb = lm["embed_tokens"][torch.as_tensor(ids)].float().cpu().numpy()
        return engine.submit(emb, max_new_tokens=args.decode_tokens, eos_token_ids=EOS,
                             draft_ids=tuple(int(t) for t in ids))

    outs = [submit() for _ in range(args.num_slots)]
    t0 = time.perf_counter()
    first = [o.get(timeout=WAIT_S) for o in outs]  # the first token of each slot
    t_first = time.perf_counter() - t0
    rounds0 = engine.stats["decode_rounds"]
    t0 = time.perf_counter()
    total = 0
    for o in outs:
        while True:
            item = o.get(timeout=WAIT_S)
            if item is None:
                break
            total += len(item)
    dt = time.perf_counter() - t0
    return {"tokens": total, "rounds": engine.stats["decode_rounds"] - rounds0,
            "steady_s": dt, "time_to_first_tokens_s": t_first,
            "first_tokens": sum(1 for f in first if f is not None),
            "engine_stats": dict(engine.stats)}


def result(args: argparse.Namespace, measured: dict, backend: str) -> dict:
    """The root script's JSON line, less its relay fields."""
    return {
        "metric": METRIC,
        "value": round(measured["tokens"] / measured["steady_s"], 1),
        "unit": "tokens/s",
        "detail": {
            "num_slots": args.num_slots,
            "prompt_len": args.prompt_len,
            "max_len": args.max_len,
            "kv_int8": args.kv_int8,
            "chunk_prefill": args.chunk_prefill,
            "speculative": args.speculative,
            "decode_ticks": args.decode_ticks,
            "paged_page_size": args.paged_page_size,
            "paged_pages": args.paged_pages,
            "engine_stats": measured["engine_stats"],
            "decode_tokens_timed": measured["tokens"],
            "decode_rounds_timed": measured["rounds"],
            "steady_s": round(measured["steady_s"], 3),
            "time_to_first_tokens_s": round(measured["time_to_first_tokens_s"], 3),
            "first_tokens": measured["first_tokens"],
            "backend": backend,
        },
    }


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    card = require_card()  # raises without a CUDA card: this never runs on the CPU
    cfg = VLMConfig.onevision_0_5b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = {"language_model": qwen2.init_params(cfg.lm, gen, "cuda", dtype=torch.bfloat16)}
    engine = make_engine(params, cfg, args).start()
    try:
        out = result(args, measure(engine, params["language_model"], args,
                                   np.random.default_rng(0)), card)
    finally:
        engine.shutdown()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
