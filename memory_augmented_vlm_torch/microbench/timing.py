"""Timing on the card for the micro-benchmarks: CUDA events around a call,
or around the replay of a CUDA graph that captured it, median of `reps`
after a warm-up. A measurement needs a card and raises without one."""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch


def require_card() -> str:
    """The card's name and power limit, as nvidia-smi gives them; raises
    when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the micro-benchmarks run on a GPU only")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Median ms of `fn` on the current stream (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], reps: int = 5) -> float:
    """Median ms of one replay of a CUDA graph that captured `fn`: the
    device's time for a chain of small launches, without the host's time to
    enqueue them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)
