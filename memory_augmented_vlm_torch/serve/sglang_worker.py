"""SGLang-class worker (counterpart of `memory_augmented_vlm_tpu/serve/sglang_worker.py`;
reference llava/serve/sglang_worker.py): the model worker's HTTP protocol
over the continuous-batching engine, `serve/batch_engine.BatchEngine`
(slot-pool KV cache, admission by prefill into a slot, one batched decode
step a tick), so that concurrent requests share the decode.

    python -m memory_augmented_vlm_torch.serve.sglang_worker --model-path DIR \\
        [--port 40001] [--num-slots 4] [--max-len 4096] [--device-map cpu]

A request's spliced sequence is built on the weights' device
(`MavlmForCausalLM._row_embeds`; video frames always through the host
processor) and handed to the engine as a float32 host array, which holds a
bf16 sequence exactly. Greedy outputs are the single-request path's tokens
to within the rounding of the engine's eager decode.
"""

from __future__ import annotations

import argparse
from http.server import ThreadingHTTPServer

import numpy as np

from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.model import DEFAULT_EOS
from memory_augmented_vlm_torch.serve.batch_engine import BatchEngine
from memory_augmented_vlm_torch.serve.model_worker import (ModelWorker, chunk, decode_images,
                                                           make_handler, worker_args)
from memory_augmented_vlm_torch.utils.logging import build_logger

logger = build_logger("sglang_worker")


class SGLangWorker(ModelWorker):
    """ModelWorker with the generate path swapped for the batch engine."""

    def __init__(self, *args, num_slots: int = 4, max_len: int = 4096,
                 kv_int8: bool = False, chunk_prefill: int = 0,
                 speculative: int = 0, decode_ticks: int = 1,
                 paged_page_size: int = 0, paged_pages: int = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        # the engine's options, as its docstrings give them: kv_int8 halves
        # the cache, chunk_prefill admits long prompts a chunk a tick,
        # decode_ticks runs K steps a dispatch, paged_* back the cache with
        # a paged pool
        self.engine = BatchEngine(self.model.params, self.model.cfg,
                                  num_slots=num_slots, max_len=max_len,
                                  kv_int8=kv_int8,
                                  chunk_prefill=chunk_prefill,
                                  speculative=speculative,
                                  decode_ticks=decode_ticks,
                                  paged_page_size=paged_page_size,
                                  paged_pages=paged_pages).start()

    def generate_stream(self, params: dict):
        self.queue_length += 1
        try:
            prompt = params["prompt"]
            ids = tokenizer_image_token(prompt, self.tokenizer)
            pixels = None
            modality = "text"
            images_b64 = params.get("images") or []
            if images_b64:
                imgs = decode_images(images_b64)
                pixels = self.image_processor.preprocess(
                    imgs[0] if len(imgs) == 1 else np.stack(
                        [np.asarray(i.convert("RGB")) for i in imgs]))
                modality = "video" if len(imgs) > 1 else "image"
            embeds = self.model._row_embeds(np.asarray(ids, np.int64), pixels, modality, None)
            eos = self.tokenizer.convert_tokens_to_ids("<|im_end|>") \
                if self.tokenizer else DEFAULT_EOS
            stop = params.get("stop")
            stops = ([stop] if isinstance(stop, str) else list(stop or []))
            stop_seqs = []
            if self.tokenizer:
                for s in stops:
                    tok = self.tokenizer.encode(s, add_special_tokens=False)
                    if tok:
                        stop_seqs.append(tuple(tok))
            top_p = params.get("top_p")
            out_q = self.engine.submit(
                embeds.float().cpu().numpy(),
                max_new_tokens=int(params.get("max_new_tokens", 256)),
                eos_token_ids=(eos,),
                temperature=float(params.get("temperature", 0.0)),
                top_p=float(top_p) if top_p is not None else 1.0,
                stop_sequences=tuple(stop_seqs),
                # the prompt's text ids seed speculation's lookup corpus
                draft_ids=tuple(int(t) for t in ids if t >= 0))
            all_tokens: list = []
            while True:
                ids_chunk = out_q.get()
                if ids_chunk is None:
                    break
                # cumulative decode: multi-byte characters split across chunks
                all_tokens.extend(int(t) for t in ids_chunk)
                text = (self.tokenizer.decode(all_tokens, skip_special_tokens=True)
                        if self.tokenizer else str(all_tokens))
                hit = next((s for s in stops if s and s in text), None)
                if hit is not None:
                    yield chunk(prompt + text.split(hit)[0])
                    break
                yield chunk(prompt + text)
        except Exception as e:  # noqa: BLE001
            yield chunk(f"server error: {e}", 1)
        finally:
            self.queue_length -= 1


def main(argv=None):
    p = worker_args(argparse.ArgumentParser(), 40001)
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=4096)
    args = p.parse_args(argv)
    worker_addr = args.worker_address or f"http://localhost:{args.port}"
    worker = SGLangWorker(args.controller_address, worker_addr,
                          args.model_path, args.model_name,
                          num_slots=args.num_slots, max_len=args.max_len,
                          device_map=args.device_map)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    logger.info(f"sglang-class worker on {args.host}:{args.port} "
                f"({args.num_slots} slots)")
    server.serve_forever()


if __name__ == "__main__":
    main()
