"""Smoke-test client (counterpart of `memory_augmented_vlm_tpu/serve/client.py`;
the reference's `llava/serve/test_message.py`): pushes one message through
controller -> worker and prints the streamed reply.

    python -m memory_augmented_vlm_torch.serve.client --model-name NAME \\
        [--controller-address http://localhost:10000] [--message TEXT]
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from typing import Iterator, Optional


def post_json(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def stream_generate(controller_addr: str, model: str, prompt: str,
                    images: Optional[list] = None, max_new_tokens: int = 64,
                    temperature: float = 0.0) -> Iterator[dict]:
    """POST a generation request to the controller's proxy and yield the
    worker's `\\0`-delimited JSON chunks ({text, error_code}) as they come."""
    payload = {"model": model, "prompt": prompt, "images": images or [],
               "max_new_tokens": max_new_tokens, "temperature": temperature}
    req = urllib.request.Request(
        controller_addr + "/worker_generate_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        buf = b""
        while True:
            chunk = resp.read(4096)
            if not chunk:
                break
            buf += chunk
            while b"\0" in buf:
                piece, buf = buf.split(b"\0", 1)
                if piece:
                    yield json.loads(piece)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--controller-address", default="http://localhost:10000")
    p.add_argument("--model-name", required=True)
    p.add_argument("--message", default="Tell me a story with more than 1000 words.")
    args = p.parse_args(argv)
    models = post_json(args.controller_address + "/list_models", {})["models"]
    print("models:", models)
    for out in stream_generate(args.controller_address, args.model_name, args.message):
        print(out["text"])


if __name__ == "__main__":
    main()
