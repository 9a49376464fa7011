"""Logging and step tracing (counterpart of
`memory_augmented_vlm_tpu/utils/logging.py`).

`rank0_print`, `build_logger`, `StepTimer` and `MetricsLogger`
(`metrics.jsonl`, wandb only when asked for) as in JAX. `trace_step` is a
`torch.profiler.record_function` span, so a profiled run shows the named
sections of the train loop; `start_profiler` / `stop_profiler` drive one
`torch.profiler` session and write its Chrome trace. `is_main_process` is
rank 0 of an initialised `torch.distributed` group, else true.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import torch

_handler_installed = False


def is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def rank0_print(*args, **kwargs) -> None:
    if is_main_process():
        print(*args, **kwargs)


def build_logger(name: str, filename: Optional[str] = None) -> logging.Logger:
    global _handler_installed
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not _handler_installed:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(name)s | %(message)s"))
        logger.addHandler(h)
        if filename:
            os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
            fh = logging.FileHandler(filename)
            fh.setFormatter(h.formatter)
            logger.addHandler(fh)
        _handler_installed = True
    return logger


@contextlib.contextmanager
def trace_step(name: str):
    """Named profiler span (a `record_function` range in a torch.profiler
    trace; free when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Wall-time breakdown per step (data / step / checkpoint) with an EMA,
    and each section's last raw time; each section is also a `trace_step`
    span."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.times: Dict[str, float] = {}
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with trace_step(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.last[name] = dt
            prev = self.times.get(name)
            self.times[name] = dt if prev is None else self.ema * prev + (1 - self.ema) * dt

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.times.items()}


_profiler: Optional[torch.profiler.profile] = None
_profiler_dir: Optional[str] = None


def start_profiler(logdir: str) -> None:
    """Start one torch.profiler session (CPU, and CUDA where there is a card)."""
    global _profiler, _profiler_dir
    if _profiler is not None:
        raise RuntimeError("a profiler session is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=activities)
    _profiler.__enter__()
    _profiler_dir = logdir


def stop_profiler() -> str:
    """End the session; write its Chrome trace as `logdir/trace.json` and
    return that path."""
    global _profiler, _profiler_dir
    if _profiler is None:
        raise RuntimeError("no profiler session is running")
    prof, logdir = _profiler, _profiler_dir
    _profiler = _profiler_dir = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


class MetricsLogger:
    """JSONL metrics stream + optional wandb (reference: --report_to wandb)."""

    def __init__(self, out_dir: str, use_wandb: bool = False, run_name: str = ""):
        self.path = os.path.join(out_dir, "metrics.jsonl")
        os.makedirs(out_dir, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="mavlm_torch", name=run_name or None)
            except Exception:  # noqa: BLE001 — as JAX: no wandb, no stream
                self._wandb = None

    def log(self, step: int, metrics: Dict) -> None:
        if not is_main_process():
            return
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)
