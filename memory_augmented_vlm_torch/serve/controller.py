"""Serving controller (counterpart of `memory_augmented_vlm_tpu/serve/controller.py`;
reference llava/serve/controller.py:29-287): the worker registry and
dispatch, on the standard library's http.server.

    python -m memory_augmented_vlm_torch.serve.controller [--host 0.0.0.0]
        [--port 10000] [--dispatch-method shortest_queue|lottery]

Endpoints (JSON over POST):
  /register_worker        {worker_name, check_heart_beat, worker_status}
  /receive_heart_beat     {worker_name, queue_length}
  /list_models            {} -> {models: [...]}
  /get_worker_address     {model} -> {address}
  /worker_generate_stream proxied to the chosen worker, in 4096-byte reads

A worker that checks its heartbeat and sends none for
CONTROLLER_HEART_BEAT_EXPIRATION seconds is dropped. Lottery dispatch draws
from the controller's own numpy RandomState (JAX's draws from numpy's
global generator; a RandomState seeded s draws what the global does after
`np.random.seed(s)`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from memory_augmented_vlm_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from memory_augmented_vlm_torch.utils.logging import build_logger

logger = build_logger("controller")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue",
                 rng: Optional[np.random.RandomState] = None):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = dispatch_method
        self.rng = rng if rng is not None else np.random.RandomState()
        self.lock = threading.Lock()
        t = threading.Thread(target=self._expire_loop, daemon=True)
        t.start()

    def register_worker(self, name: str, check_heart_beat: bool, status: dict) -> bool:
        with self.lock:
            self.workers[name] = WorkerInfo(
                model_names=status.get("model_names", []),
                speed=status.get("speed", 1.0),
                queue_length=status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time(),
            )
        logger.info(f"Register worker: {name}")
        return True

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            if name not in self.workers:
                return False
            self.workers[name].queue_length = queue_length
            self.workers[name].last_heart_beat = time.time()
            return True

    def _expire_loop(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_stale_workers(time.time() - CONTROLLER_HEART_BEAT_EXPIRATION)

    def remove_stale_workers(self, expire: float):
        """Drop every worker that checks its heartbeat and sent none since
        `expire` (a `time.time()`)."""
        with self.lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat and w.last_heart_beat < expire]
            for n in dead:
                logger.info(f"Remove stale worker: {n}")
                del self.workers[n]

    def list_models(self) -> List[str]:
        with self.lock:
            names: List[str] = []
            for w in self.workers.values():
                names.extend(w.model_names)
            return sorted(set(names))

    def get_worker_address(self, model_name: str) -> str:
        """Lottery (speed-weighted) or shortest-queue dispatch
        (controller.py:117-150 semantics); "" when no worker serves the
        model."""
        with self.lock:
            cands = [(n, w) for n, w in self.workers.items()
                     if model_name in w.model_names]
            if not cands:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([w.speed for _, w in cands], np.float64)
                if speeds.sum() <= 0:
                    return ""
                pt = self.rng.uniform(0, speeds.sum())
                return cands[int(np.searchsorted(np.cumsum(speeds), pt))][0]
            # shortest_queue, speed-normalized
            qlens = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            idx = int(np.argmin(qlens))
            name, w = cands[idx]
            w.queue_length += 1
            return name


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            data = self._read()
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data.get("check_heart_beat", True),
                    data.get("worker_status", {}))
                self._json({"exist": ok})
            elif self.path == "/receive_heart_beat":
                ok = controller.receive_heart_beat(
                    data["worker_name"], data.get("queue_length", 0))
                self._json({"exist": ok})
            elif self.path == "/list_models":
                self._json({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._json({"address": controller.get_worker_address(data["model"])})
            elif self.path == "/worker_generate_stream":
                addr = controller.get_worker_address(data.get("model", ""))
                if not addr:
                    self._json({"text": "", "error_code": 2}, 200)
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate_stream",
                    data=json.dumps(data).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req) as resp:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.end_headers()
                    while True:
                        chunk = resp.read(4096)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve(host: str = "0.0.0.0", port: int = 10000,
          dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    """A controller's server, bound and not yet serving (`serve_forever`)."""
    controller = Controller(dispatch_method)
    return ThreadingHTTPServer((host, port), make_handler(controller))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    args = p.parse_args(argv)
    server = serve(args.host, args.port, args.dispatch_method)
    logger.info(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
