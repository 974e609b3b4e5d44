"""Profiling helpers: device traces and a wall-clock meter.

Port of ``tq_tpu.utils.trace``.  The JAX package wraps ``jax.profiler``;
here :func:`device_trace` wraps ``torch.profiler`` with the same directory
convention, so speed claims ship with their traces.  The trace is a
Chrome trace (``chrome://tracing`` or Perfetto): on the card its kernel
events (category ``kernel``) carry each launch's device time.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["device_trace", "Timer", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(out_dir: str = "traces", label: str = "run"):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a CUDA device) and write the Chrome trace to
    ``out_dir/label/trace.json`` when it ends, also by an exception;
    yields that directory."""
    path = Path(out_dir) / label
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path / TRACE_FILE))


class Timer:
    """Minimal wall-clock meter (device time belongs to the profiler, not
    the wall clock: synchronize inside ``measure`` to time card work)."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def total(self):
        return sum(self.times)
