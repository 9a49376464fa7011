"""Timing on the card for the micro-benchmarks: CUDA events around a call,
or around the replay of a CUDA graph that captured it, median of `reps`
after a warm-up; and the device kernels of one such replay, by
torch.profiler. A measurement needs a card and raises without one."""

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
    return time_ms(_capture(fn).replay, reps)


def _capture(fn: Callable[[], object]) -> torch.cuda.CUDAGraph:
    """A CUDA graph that captured `fn`, after a warm-up call off the capture
    (as torch.cuda.graph asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_trace(fn, name: str) -> dict:
    """The device kernels whose name holds `name` in one replay of a CUDA
    graph that captured `fn`, by torch.profiler: how many ran, how many
    consecutive pairs overlap (the next one started before this one ended,
    as a programmatic dependent launch lets it), the gaps between
    consecutive kernels and the replay's span, in us."""
    graph = _capture(fn)
    graph.replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graph.replay()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)
    gaps = sorted(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    return {"device_kernels": len(spans), "overlapping_pairs": sum(g < 0 for g in gaps),
            "gap_us": {"min": gaps[0], "median": gaps[len(gaps) // 2], "max": gaps[-1]}
            if gaps else None,
            "span_us": spans[-1][1] - spans[0][0] if spans else None}
