"""Throughput benchmark of the port: sustained clip -> answer clips/s over a
stream of clips, the counterpart of the root `bench_throughput.py` (its
flag, modes, metric names and JSON keys).

    python -m memory_augmented_vlm_torch.bench_throughput [--synthetic-producer]

The 0.5B int8 serving configuration (`pipeline.int8_serving_params`, the
int8 tower, `build_pipeline(kv_int8=True)`) on seeded random weights over
8 clips of 64 seeded random uint8 frames, in four modes:

  - serial: each clip through the host `SigLipImageProcessor`, then the
    request, one after another;
  - pipelined: a producer thread preprocesses on the host into a queue of
    2 while the main thread runs the requests;
  - device-bound: pre-staged preprocessed tensors on the card, at most 2
    requests in flight before a result is read back;
  - device preprocess: raw uint8 frames to the card, resized and
    normalised there (`ops/preprocess.preprocess_frames`) before the
    request, at most 2 in flight.

`--synthetic-producer` runs the two device modes only (the host processor
stays out of the figure) and prints the device-bound clips/s; without it
all four run and the pipelined figure is the headline. `vs_baseline`
compares against the modeled A100 single-clip pipeline run back to back
(`bench.baseline_visual_tokens_per_s` at 64 frames over 9429 visual tokens
a clip). Host clock around each mode, which ends on a read of the last
tokens. Prints ONE JSON line. Needs a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from queue import Queue
from typing import List, Optional, Sequence

import numpy as np
import torch

from memory_augmented_vlm_torch import bench, pipeline
from memory_augmented_vlm_torch.data.preprocessing import SigLipImageProcessor
from memory_augmented_vlm_torch.microbench.timing import require_card
from memory_augmented_vlm_torch.models import vlm
from memory_augmented_vlm_torch.ops.preprocess import preprocess_frames

NUM_CLIPS = 8
VISUAL_TOKENS_PER_CLIP = 9429
# the root script's prompt ids around the video
TEXT_BEFORE = [151644, 872, 198]
TEXT_AFTER = [3838, 374, 12482, 304, 419, 2766, 30]
IN_FLIGHT = 2


def baseline_clips_per_s() -> float:
    return (bench.baseline_visual_tokens_per_s(pipeline.NUM_FRAMES)
            / VISUAL_TOKENS_PER_CLIP)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stream:
    """One benchmark's request function, weights, clips and prompt on one
    device: `fn(params, pixels, text_before, text_after)` returns (tokens,
    spliced length), as `pipeline.build_pipeline`'s does."""

    def __init__(self, fn, params, raw_clips: Sequence[np.ndarray],
                 processor: SigLipImageProcessor, device, text_before=TEXT_BEFORE,
                 text_after=TEXT_AFTER, dtype=torch.bfloat16):
        self.fn, self.params, self.raw_clips, self.processor = fn, params, raw_clips, processor
        self.device, self.dtype = torch.device(device), dtype
        self.tb = torch.tensor(text_before, device=self.device)
        self.ta = torch.tensor(text_after, device=self.device)

    def host_pixels(self, clip: np.ndarray) -> torch.Tensor:
        """A clip through the host processor, on the device."""
        return torch.from_numpy(self.processor.preprocess(clip)).to(self.device, self.dtype)

    def device_pixels(self, clip: np.ndarray) -> torch.Tensor:
        """A clip's raw frames to the device, preprocessed there."""
        raw = torch.from_numpy(clip).to(self.device)
        return preprocess_frames(raw, size=self.processor.size, dtype=self.dtype)

    def request(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.fn(self.params, pixels, self.tb, self.ta)[0]

    def warm_up(self):
        """One request per path (builds the kernels, captures the decode)."""
        clip = self.raw_clips[0]
        for pixels in (self.host_pixels(clip), self.device_pixels(clip)):
            self.request(pixels)
        _sync(self.device)

    def run(self, pipelined: bool) -> float:
        """Seconds for every clip through the host processor: serially, or
        with one producer thread feeding a queue of 2."""
        t0 = time.perf_counter()
        if pipelined:
            q: Queue = Queue(maxsize=IN_FLIGHT)

            def producer():
                for clip in self.raw_clips:
                    q.put(self.host_pixels(clip))
                q.put(None)

            thread = threading.Thread(target=producer, daemon=True)
            thread.start()
            results = []
            while True:
                pixels = q.get(timeout=600)
                if pixels is None:
                    break
                results.append(self.request(pixels))
            thread.join(timeout=600)
            _sync(self.device)
        else:
            for clip in self.raw_clips:
                self.request(self.host_pixels(clip))
                _sync(self.device)
        return time.perf_counter() - t0

    def _in_flight(self, pixels_of) -> float:
        """Seconds for every clip with at most IN_FLIGHT results unread."""
        t0 = time.perf_counter()
        inflight, results = [], []
        for clip in self.raw_clips:
            inflight.append(self.request(pixels_of(clip)))
            if len(inflight) > IN_FLIGHT:
                results.append(inflight.pop(0).cpu())  # a forced read
        results.extend(r.cpu() for r in inflight)
        return time.perf_counter() - t0

    def run_device_bound(self) -> float:
        """Pre-staged preprocessed tensors on the device (the native-loader
        serving path): the device-bound stream."""
        staged = [self.host_pixels(c) for c in self.raw_clips]
        _sync(self.device)
        return self._in_flight(lambda clip: staged.pop(0))

    def run_device_preprocess(self) -> float:
        """Raw uint8 frames to the device, preprocessed there."""
        return self._in_flight(self.device_pixels)


def result(clips: int, t_dev: float, t_devprep: float, t_serial: Optional[float] = None,
           t_piped: Optional[float] = None) -> dict:
    """The root script's JSON line: the device-bound headline with
    `--synthetic-producer` (no host times), else the pipelined one."""
    base = baseline_clips_per_s()
    devprep = {"device_preprocess_clips_per_s": round(clips / t_devprep, 3),
               "device_preprocess_s_per_clip": round(t_devprep / clips, 3), "clips": clips}
    if t_piped is None:
        value = clips / t_dev
        return {"metric": "sustained_clips_per_s_64frame_0.5b_synthetic_producer",
                "value": round(value, 3), "unit": "clips/s",
                "vs_baseline": round(value / base, 3),
                "detail": {"device_bound_s_per_clip": round(t_dev / clips, 3), **devprep}}
    value = clips / t_piped
    return {"metric": "pipelined_clip_throughput_64frame_0.5b",
            "value": round(value, 3), "unit": "clips/s",
            "vs_baseline": round(value / base, 3),
            "detail": {"serial_s_per_clip": round(t_serial / clips, 3),
                       "pipelined_speedup_vs_serial": round(t_serial / t_piped, 3),
                       "pipelined_s_per_clip": round(t_piped / clips, 3),
                       "device_bound_clips_per_s": round(clips / t_dev, 3),
                       "device_bound_s_per_clip": round(t_dev / clips, 3), **devprep}}


def measure(stream: Stream, synthetic_producer: bool) -> dict:
    """Warm up, run the modes in the root script's order, build its line."""
    stream.warm_up()
    clips = len(stream.raw_clips)
    if synthetic_producer:
        return result(clips, stream.run_device_bound(), stream.run_device_preprocess())
    t_serial, t_piped = stream.run(pipelined=False), stream.run(pipelined=True)
    return result(clips, stream.run_device_bound(), stream.run_device_preprocess(),
                  t_serial, t_piped)


def raw_clips(num_clips: int, frames: int, side: int, seed: int = 0) -> List[np.ndarray]:
    """Seeded random decoded frames, uint8 (frames, side, side, 3) a clip."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (frames, side, side, 3), dtype=np.uint8)
            for _ in range(num_clips)]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic-producer", action="store_true",
                    help="pre-staged device tensors, no host preprocessing in the figure: "
                    "the device-bound sustained number")
    args = ap.parse_args(argv)
    require_card()  # raises without a CUDA card: this never runs on the CPU
    cfg = bench.serving_config("0.5b")
    params = pipeline.int8_serving_params(
        vlm.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16))
    fn, _ = pipeline.build_pipeline(cfg, pipeline.NUM_FRAMES, kv_int8=True)
    processor = SigLipImageProcessor(size=(cfg.vision.image_size,) * 2)
    stream = Stream(fn, params, raw_clips(NUM_CLIPS, pipeline.NUM_FRAMES, 384), processor,
                    "cuda")
    out = measure(stream, args.synthetic_producer)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
