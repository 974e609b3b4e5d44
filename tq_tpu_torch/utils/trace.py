"""Profiling helpers: device traces and the program's spans.

Port of ``tq_tpu.utils.trace``.  The JAX package wraps ``jax.profiler``;
here :func:`device_trace` wraps ``torch.profiler`` with the same directory
convention, so speed claims ship with their traces.  The trace is a
Chrome trace (``chrome://tracing`` or Perfetto): on the card its kernel
events (category ``kernel``) carry each launch's device time.

:func:`span` marks a layer boundary of the program.  The profiler is its
switch: with none recording, a span is one shared no-op (one check, no
clock read, no allocation); while one records, a span enters
``torch.profiler.record_function`` (so it lies in the Chrome trace on the
kernels' clock) and appends a :class:`SpanRecord` to a bounded list that
:func:`records` returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["device_trace", "span", "records", "dropped", "clear",
           "SpanRecord", "MAX_RECORDS", "TRACE_FILE"]

TRACE_FILE = "trace.json"
# Spans kept at most; those past it are counted by dropped().
MAX_RECORDS = 1 << 16


@contextlib.contextmanager
def device_trace(out_dir: str = "traces", label: str = "run"):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a CUDA device) and write the Chrome trace to
    ``out_dir/label/trace.json`` when it ends, also by an exception;
    yields that directory.

    The trace holds the program's spans (category ``user_annotation``):
    ``tq.sampler.request`` (a sampled request, its seed as ``rid``) and
    ``tq.sampler.draw`` (a token's draw) in ``evals/generate.py``;
    ``tq.lstm.step`` (a recurrent LM step); ``tq.runner.launch`` and
    ``tq.runner.harvest`` (``BatchRunner``'s batches); ``tq.cnn.forward``
    (a CNN batch) and ``tq.convert.cnn`` (a CNN's conversion);
    ``tq.calib.histogram`` (a layer's histogram update) and
    ``tq.calib.search`` (a layer's scale search); ``tq.dsv3.prefill`` and
    ``tq.dsv3.step`` (a DeepSeek-V3 prefill and decode step),
    ``tq.mla.attend`` (a layer's latent attention), ``tq.moe.route`` (an
    expert layer's router, sort and counts' copy to the host) and
    ``tq.moe.experts`` (its experts' products)."""
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


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span: ``parent`` is the index in :func:`records` of the span
    that enclosed it (None at the top); times are ``perf_counter_ns``;
    ``device_ms`` is the stream time between the span's CUDA events
    (``events``, resolved by :func:`records`), None for a span that
    recorded none."""

    name: str
    rid: object
    parent: int | None
    start_ns: int
    end_ns: int | None = None
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


class _Off:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_records: list[SpanRecord] = []
_dropped = 0
_open: list["_Span"] = []  # the spans entered and not yet left


class _Span:
    __slots__ = ("name", "rid", "device", "index", "_rf", "_record")

    def __init__(self, name: str, rid, device: bool):
        self.name, self.rid, self.device = name, rid, device

    def __enter__(self):
        global _dropped
        parent = _open[-1] if _open else None
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        self._rf = record_function(
            self.name, None if self.rid is None else str(self.rid))
        self._rf.__enter__()
        self.index = self._record = None
        if len(_records) < MAX_RECORDS:
            self.index = len(_records)
            self._record = SpanRecord(
                self.name, self.rid,
                None if parent is None else parent.index,
                time.perf_counter_ns())
            _records.append(self._record)
            if self.device:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self._record.events = (start, None)
        else:
            _dropped += 1
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.pop()
        rec = self._record
        if rec is not None:
            if rec.events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec.events = (rec.events[0], end)
            rec.end_ns = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        return False


def span(name: str, rid=None, device: bool = False):
    """A context manager that marks ``name`` while a profiler records, and
    the shared no-op otherwise.  ``rid``: the request's identifier, taken
    from the enclosing span when not given.  ``device``: also time the
    span's work on the current CUDA stream (pass it only for work on a
    CUDA device); the events are read by :func:`records`, never here."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, rid, device)


def records() -> list[SpanRecord]:
    """The spans recorded since :func:`clear`, in the order they began,
    with each device span's ``device_ms`` resolved (one synchronize, where
    any is left to resolve)."""
    todo = [r for r in _records
            if r.events is not None and r.events[1] is not None]
    if todo:
        torch.cuda.synchronize()
        for r in todo:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return _records


def dropped() -> int:
    """Spans not recorded since :func:`clear`: the list was full."""
    return _dropped


def clear() -> None:
    """Empty the record and the count of dropped spans."""
    global _dropped
    _records.clear()
    _dropped = 0
