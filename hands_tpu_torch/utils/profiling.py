"""Profiling and tracing hooks (port of ``hands_tpu/utils/profiling.py``) on
``torch.profiler``: a trace context, named regions, a tracer of a window of
training steps that writes a Chrome trace, and a wall-clock step timer that
synchronises the card."""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch


def _profiler():
    # host activity always, the card's where this build of PyTorch has it
    return torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing, Perfetto).
    Yields the profiler (``key_averages()`` after the block)."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _profiler()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


class StepTrace:
    """Trace a window of training steps into ``log_dir/trace.json``: steps
    [skip, skip + steps) of the run (the first ``skip`` steps are warm-up and
    would drown the timeline). ``update(step)`` is called once per step;
    no-op when ``steps == 0``."""

    def __init__(self, log_dir: str, steps: int, skip: int = 2):
        self.log_dir = log_dir
        self.steps = steps
        self.skip = skip
        self._prof = None
        self._done = steps == 0

    def _stop(self):
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.log_dir, "trace.json"))
        self._prof = None
        self._done = True

    def update(self, step: int):
        if self._done:
            return
        if self._prof is None and step >= self.skip:
            self._prof = _profiler()
            self._prof.start()
        elif self._prof is not None and step >= self.skip + self.steps:
            self._stop()

    def close(self):
        if self._prof is not None:
            self._stop()


class StepTimer:
    """Wall-clock step timing with a device synchronise and a percentile
    summary."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """``result``: a tensor of the step; if it lies on a card, the card
        is synchronised before the clock is read."""
        if torch.is_tensor(result) and result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }


def device_busy_ms(fn, names=(), warmup: bool = True):
    """(ms, {name: ms}): the card's time in the kernels that one call of
    ``fn`` launches (``torch.profiler`` over CUPTI, after a warm-up call
    unless ``warmup`` is false), and the part of it in kernels whose name
    holds each of ``names``; (None, {}) where the profiler saw no device
    time (on the CPU, where ``fn`` is not called)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None, {}
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total / 1e3)
             for e in prof.key_averages()]
    total = sum(t for _, t in times)
    if total <= 0.0:
        return None, {}
    return total, {n: sum(t for k, t in times if n in k) for n in names}
