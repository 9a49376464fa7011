"""Timing on the card for the micro-benchmarks: CUDA events around a call,
or around the replay of a CUDA graph that captured it, median of `reps`
after a warm-up; the kernel nodes of such a graph, read from the graph
itself; and the device kernels of one replay, by torch.profiler. A
measurement needs a card and raises without one."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
from typing import Callable, List

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
    return time_ms(capture(fn).replay, reps)


def capture(fn: Callable[[], object], keep_graph: bool = False) -> torch.cuda.CUDAGraph:
    """A CUDA graph that captured `fn`, after a warm-up call off the capture
    (as torch.cuda.graph asks). `keep_graph` keeps the captured graph
    beside its instantiation, for `graph_kernels`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True) if keep_graph else torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
        "grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "shared_mem")),
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL = 0


def graph_kernels(graph: torch.cuda.CUDAGraph) -> List[str]:
    """The names of the kernel nodes of `graph` (made by `capture` with
    `keep_graph=True`), read from the captured graph itself through the CUDA
    driver (cuGraphGetNodes, cuGraphNodeGetType, cuGraphKernelNodeGetParams,
    cuFuncGetName or cuKernelGetName). Unlike a profiler's records, none
    can go missing. A node of another type raises."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    count = ctypes.c_size_t()
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            raise RuntimeError(f"graph node of type {kind.value}, not a kernel")
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return names


def replay_trace(fn, name: str) -> dict:
    """The device kernels whose name holds `name` in one replay of a CUDA
    graph that captured `fn`, by torch.profiler: how many it recorded, how
    many consecutive pairs overlap (the next one started before this one
    ended, as a programmatic dependent launch lets it), the gaps between
    consecutive kernels and the replay's span, in us. A reading only: the
    profiler can drop a record (`graph_kernels` counts a graph's kernels)."""
    graph = capture(fn)
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
