"""The program's own spans in a traced run, for the per-layer metrics that
read them.

The port marks its layers with ``tq.*`` spans (``tq_tpu_torch/utils/
trace.py::span``), on only while a profiler records: in the traced part
of a ``--trace 1`` run they reach the trace as ``user_annotation`` host
operations, on the kernels' clock, and the port's ``records()`` holds
them with their device times.  A program without those spans (an older
commit) gives None here, never 0.
"""

from __future__ import annotations

from benchmark.harness import _union

PREFIX = "tq."


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The traced window less the union of its kernels."""
    out, t = [], trace.start
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def span_intervals(trace, name: str | None = None):
    """The union of the spans called ``name`` (every ``tq.*`` span where
    None), cut to the window."""
    return _union((max(ts, trace.start), min(ts + d, trace.end))
                  for n, ts, d in trace.host_ops
                  if (n == name if name else n.startswith(PREFIX)))


def idle_in(trace, name: str) -> float | None:
    """% of the window idle under a span called ``name``; None without
    kernels or without such a span."""
    spans = span_intervals(trace, name)
    if trace.idle_share() is None or not spans:
        return None
    return 100.0 * _overlap(idle_intervals(trace), spans) / (
        trace.end - trace.start)


def idle_outside(trace) -> float | None:
    """% of the window idle under no ``tq.*`` span; None without kernels
    or without such spans."""
    spans = span_intervals(trace)
    if trace.idle_share() is None or not spans:
        return None
    idle = idle_intervals(trace)
    return 100.0 * (_length(idle) - _overlap(idle, spans)) / (
        trace.end - trace.start)


def device_ms_per_step(run, name: str) -> float | None:
    """The summed ``device_ms`` of the port's records called ``name``
    over the traced part's steps; None where the port keeps no records,
    dropped some, has none of ``name`` or one without a device time."""
    from tq_tpu_torch.utils import trace as port

    records = getattr(port, "records", None)
    if records is None or port.dropped() or not run.trace_steps:
        return None
    times = [r.device_ms for r in records() if r.name == name]
    if not times or None in times:
        return None
    return sum(times) / run.trace_steps
