"""Model worker (counterpart of `memory_augmented_vlm_tpu/serve/model_worker.py`;
reference llava/serve/model_worker.py:44-271) on the standard library's
http.server: loads the model with `load_pretrained_model`, registers with
the controller, heartbeats every WORKER_HEART_BEAT_INTERVAL seconds, and
serves `/worker_generate_stream` with a concurrency semaphore and
`\\0`-delimited JSON chunks (the reference's wire format).

    python -m memory_augmented_vlm_torch.serve.model_worker --model-path DIR \\
        [--port 40000] [--controller-address http://localhost:10000]
        [--device-map cpu]

The weights load on the card; `--device-map cpu` loads them onto the CPU.
With `ModelWorker(device_preprocess=True)` a video whose frames all have
one size crosses to the card as raw uint8 and is resized and normalized
there (`ops/preprocess.py`); mixed frame sizes, single images and every
payload without it go through the host processor, which resizes each frame
before stacking.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from memory_augmented_vlm_torch.constants import WORKER_HEART_BEAT_INTERVAL
from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model
from memory_augmented_vlm_torch.utils.logging import build_logger

logger = build_logger("model_worker")


def decode_images(images_b64: list) -> list:
    """The payload's base64 images as PIL images (decoded lazily by PIL)."""
    from PIL import Image

    return [Image.open(io.BytesIO(base64.b64decode(b))) for b in images_b64]


def chunk(text: str, error_code: int = 0) -> bytes:
    """One `\\0`-terminated JSON chunk of the stream."""
    return json.dumps({"text": text, "error_code": error_code}).encode() + b"\0"


class ModelWorker:
    """Serves one model. `register=False` leaves the controller alone: the
    heartbeat thread holds the worker, and with it the weights, for the
    life of the process."""

    def __init__(self, controller_addr: Optional[str], worker_addr: str,
                 model_path: str, model_name: Optional[str] = None,
                 limit_model_concurrency: int = 5, register: bool = True,
                 device_preprocess: bool = False, device_map="auto"):
        self.worker_id = str(uuid.uuid4())[:6]
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name or model_path.rstrip("/").split("/")[-1]
        self.device_preprocess = device_preprocess
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(
             model_path, None, self.model_name, device_map=device_map,
             device_preprocess=device_preprocess)
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.queue_length = 0
        if register and controller_addr:
            self.register_to_controller()
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()

    # -- controller protocol ------------------------------------------------
    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.controller_addr + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read())

    def status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1.0,
                "queue_length": self.queue_length}

    def register_to_controller(self):
        self._post("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })
        logger.info(f"registered {self.worker_addr} as {self.model_name}")

    def _heartbeat_loop(self):
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                ok = self._post("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length,
                })
                if not ok.get("exist"):
                    self.register_to_controller()
            except Exception as e:  # noqa: BLE001 — retry forever like the reference
                logger.info(f"heartbeat error: {e}")

    # -- generation ---------------------------------------------------------
    def _pixels(self, images_b64: list):
        """(pixels, modality) of the payload's images: raw uint8 frames for
        a same-size video under `device_preprocess`, else the host
        processor's float frames; (None, "text") without images."""
        if not images_b64:
            return None, "text"
        imgs = decode_images(images_b64)
        modality = "video" if len(imgs) > 1 else "image"
        if (modality == "video" and self.device_preprocess
                and len({i.size for i in imgs}) == 1):
            # raw uint8 to the card, resized and normalized there (a raw
            # stack needs one shape)
            return np.stack([np.asarray(i.convert("RGB")) for i in imgs]), modality
        # a list: the processor resizes each frame to the tower's size
        # before stacking (mixed-size payloads)
        return self.image_processor.preprocess(imgs[0] if len(imgs) == 1 else imgs), modality

    def generate_stream(self, params: dict):
        """Yield `\\0`-delimited JSON chunks {text, error_code}: the prompt
        echoed with the answer so far, decoded cumulatively and cut at the
        `stop` string; any error as {"server error: ...", 1}."""
        self.queue_length += 1
        try:
            with self.semaphore:
                prompt = params["prompt"]
                ids = tokenizer_image_token(prompt, self.tokenizer)
                pixels, modality = self._pixels(params.get("images") or [])
                temperature = float(params.get("temperature", 0.0))
                top_p = params.get("top_p")
                # the stop string's ids stop the decode; text-level
                # truncation below is the backstop
                stop = params.get("stop")
                stop_seqs = []
                if stop and self.tokenizer:
                    tok = self.tokenizer.encode(stop, add_special_tokens=False)
                    if tok:
                        stop_seqs.append(tuple(tok))
                all_tokens: list = []
                for ids_chunk in self.model.generate_stream(
                    ids[None],
                    images=[pixels] if pixels is not None else None,
                    modalities=[modality],
                    do_sample=temperature > 0,
                    temperature=temperature,
                    top_p=float(top_p) if top_p is not None else None,
                    max_new_tokens=int(params.get("max_new_tokens", 256)),
                    stop_sequences=tuple(stop_seqs),
                ):
                    # decode cumulatively: a multi-byte character split
                    # across chunks would otherwise become U+FFFD
                    all_tokens.extend(int(t) for t in ids_chunk)
                    text = (self.tokenizer.decode(all_tokens, skip_special_tokens=True)
                            if self.tokenizer else str(all_tokens))
                    if stop and stop in text:
                        yield chunk(prompt + text.split(stop)[0])
                        break
                    yield chunk(prompt + text)
        except Exception as e:  # noqa: BLE001
            yield chunk(f"server error: {e}", 1)
        finally:
            self.queue_length -= 1


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for piece in worker.generate_stream(data):
                    self.wfile.write(piece)
                    self.wfile.flush()
            elif self.path == "/worker_get_status":
                body = json.dumps(worker.status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def worker_args(p: argparse.ArgumentParser, port: int) -> argparse.ArgumentParser:
    """The flags both workers take."""
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=port)
    p.add_argument("--controller-address", default="http://localhost:10000")
    p.add_argument("--worker-address", default=None)
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-name", default=None)
    p.add_argument("--device-map", default="auto",
                   help="where the weights go: 'auto' (the card), 'cuda[:n]' or 'cpu'")
    return p


def main(argv=None):
    p = worker_args(argparse.ArgumentParser(), 40000)
    p.add_argument("--limit-model-concurrency", type=int, default=5)
    args = p.parse_args(argv)
    worker_addr = args.worker_address or f"http://localhost:{args.port}"
    worker = ModelWorker(args.controller_address, worker_addr, args.model_path,
                         args.model_name, args.limit_model_concurrency,
                         device_map=args.device_map)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    logger.info(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
