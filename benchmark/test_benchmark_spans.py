"""CPU tests of the readers of the port's spans and counter: the idle time
under ``tq.*`` spans on a synthetic trace, the device times of the span
records over the traced settings, and ``BatchRunner``'s queue wait.

    python -m pytest benchmark/test_benchmark_spans.py -q
"""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import pytest

from benchmark import spans
from benchmark.harness import Trace
from tq_tpu_torch.utils import trace as port

BENCH = Path(__file__).resolve().parent


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _trace(host_ops):
    """A window of 100 us whose kernels run over [10, 20), [30, 40) and
    [70, 80): idle [0, 10), [20, 30), [40, 70), [80, 100), 70%."""
    kernels = [("k", 10.0, 10.0), ("k", 30.0, 10.0), ("k", 70.0, 10.0)]
    return Trace(0.0, 100.0, kernels, host_ops)


# A request over [5, 95) holding two steps, a draw and an operator; a
# harvest that began before the window ends at 3.
SPANS = [("tq.sampler.request", 5.0, 90.0), ("tq.lstm.step", 8.0, 27.0),
         ("aten::mm", 41.0, 4.0), ("tq.sampler.draw", 50.0, 10.0),
         ("tq.lstm.step", 62.0, 13.0), ("tq.runner.harvest", -10.0, 13.0)]


def _run(host_ops=SPANS, **kw):
    return types.SimpleNamespace(trace=_trace(host_ops), **kw)


@pytest.mark.parametrize("cell", ["requests", "tokens"])
def test_idle_in_step_and_outside(cell):
    run = _run()
    # Steps: [8, 10) and [20, 30) idle in the first, [62, 70) in the
    # second.  Outside every span: [3, 5) and [95, 100).
    assert _reader(f"idle_in_step.{cell}")(run) == pytest.approx(20.0)
    assert _reader(f"idle_outside.{cell}")(run) == pytest.approx(7.0)


def test_idle_in_draw_and_the_parts_add_up():
    run = _run()
    step = _reader("idle_in_step.requests")(run)
    draw = _reader("idle_in_draw.requests")(run)
    outside = _reader("idle_outside.requests")(run)
    assert draw == pytest.approx(10.0)
    # The rest of the request: [5, 8), [40, 50), [60, 62), [80, 95) and
    # the harvest's [0, 3).
    other = spans.idle_in(run.trace, "tq.sampler.request") - step - draw
    assert other == pytest.approx(30.0)
    assert step + draw + other + 3.0 + outside == pytest.approx(
        run.trace.idle_share())
    assert step + draw + outside <= run.trace.idle_share()


@pytest.mark.parametrize("name", ["idle_in_step.requests",
                                  "idle_in_draw.requests",
                                  "idle_outside.requests",
                                  "idle_in_step.tokens",
                                  "idle_outside.tokens"])
def test_idle_readers_give_none_without_spans_or_kernels(name):
    assert _reader(name)(_run([("aten::mm", 41.0, 4.0)])) is None
    bare = _run()
    bare.trace.kernels = []
    assert _reader(name)(bare) is None


def _record(name, ms):
    return port.SpanRecord(name, None, None, 0, 1, ms)


RECORDS = [_record("tq.calib.histogram", 1.5), _record("tq.calib.search", 0.25),
           _record("tq.calib.histogram", 2.5), _record("tq.cnn.forward", 9.0),
           _record("tq.calib.histogram", 3.0), _record("tq.calib.search", 0.75)]


@pytest.mark.parametrize("name,want", [("histogram_ms.calib", 3.5),
                                       ("scale_search_ms.calib", 0.5)])
def test_device_ms_over_the_traced_settings(monkeypatch, name, want):
    monkeypatch.setattr(port, "records", lambda: RECORDS)
    read = _reader(name)
    assert read(_run(trace_steps=2)) == pytest.approx(want)
    assert read(_run(trace_steps=0)) is None
    monkeypatch.setattr(port, "records",
                        lambda: RECORDS + [_record("tq.calib.histogram", None),
                                           _record("tq.calib.search", None)])
    assert read(_run(trace_steps=2)) is None
    monkeypatch.setattr(port, "records", lambda: RECORDS[3:4])
    assert read(_run(trace_steps=2)) is None
    monkeypatch.setattr(port, "records", lambda: RECORDS)
    monkeypatch.setattr(port, "dropped", lambda: 1)
    assert read(_run(trace_steps=2)) is None
    monkeypatch.delattr(port, "records")
    assert read(_run(trace_steps=2)) is None


def test_queue_wait_ms():
    read = _reader("queue_wait_ms.tokens")
    runner = types.SimpleNamespace(counts={"requests": 128,
                                           "queue_wait_ns": 64_000_000})
    assert read(_run(loop=types.SimpleNamespace(runner=runner))) == \
        pytest.approx(0.5)
    runner.counts = {"requests": 0, "queue_wait_ns": 0}
    assert read(_run(loop=types.SimpleNamespace(runner=runner))) is None
    assert read(_run(loop=types.SimpleNamespace(
        runner=types.SimpleNamespace()))) is None
    assert read(_run(loop=types.SimpleNamespace())) is None
