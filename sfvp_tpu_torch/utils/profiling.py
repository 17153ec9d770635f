"""Tracing and profiling hooks, counterpart of sfvp_tpu/utils/profiling.py
(SURVEY.md §5).

``named_scope(name)`` labels a phase in a torch.profiler trace
(``torch.profiler.record_function``); ``profile_trace(log_dir)`` captures
the enclosed block with torch.profiler, the host's ops and, with a CUDA
device, the card's kernels, and writes a Chrome trace into ``log_dir``;
``StepTimer`` smooths phase times on the host clock, as sfvp_tpu's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write ``log_dir/trace.json`` (Chrome
    trace format)::

        with profile_trace("/tmp/sfvp_trace") as prof:
            renderer.step()
        prof.key_averages()

    The card's activity is recorded when a CUDA device is present."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock phase timer with EMA smoothing for the render loop's logs."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ema = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else (
                self.alpha * dt + (1 - self.alpha) * prev)

    def summary(self) -> dict:
        return {k: round(v, 5) for k, v in self.ema.items()}
