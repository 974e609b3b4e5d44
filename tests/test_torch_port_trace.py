"""The port's spans (``utils/trace.span``) and ``BatchRunner``'s queue
counter, on the CPU.

A span is the shared no-op while no profiler records, and a record and a
``record_function`` while one does; the sampler, the LSTM step, the
runner and the calibration mark their work with spans.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from tq_tpu_torch.convert import finalize_cnn
from tq_tpu_torch.evals import generate as tgen
from tq_tpu_torch.layers.common import TRParams
from tq_tpu_torch.layers.linear import init_quant_state
from tq_tpu_torch.layers.quantize import histogram_update
from tq_tpu_torch.models import lstm_lm
from tq_tpu_torch.parallel.mesh import local_mesh
from tq_tpu_torch.parallel.serving import BatchRunner
from tq_tpu_torch.utils import trace as ttrace

VOCAB, H = 40, 16


@pytest.fixture(autouse=True)
def _empty_record():
    ttrace.clear()
    yield
    ttrace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _names(recs):
    return [r.name for r in recs]


@pytest.mark.parametrize("kw", [{}, {"rid": 5}, {"device": True}],
                         ids=["plain", "rid", "device"])
def test_span_without_a_profiler_is_the_shared_noop(monkeypatch, kw):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(ttrace, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    s = ttrace.span("tq.probe", **kw)
    assert s is ttrace.span("tq.other")
    with s as entered:
        with ttrace.span("tq.inner"):
            pass
    assert entered is s
    assert ttrace.records() == [] and ttrace.dropped() == 0


def test_nested_spans_record_parent_rid_and_times(tmp_path):
    with ttrace.device_trace(tmp_path, "spans") as path:
        with ttrace.span("tq.a", rid=7):
            with ttrace.span("tq.b"):
                with ttrace.span("tq.c", rid=9):
                    torch.ones(4).sum()
            with ttrace.span("tq.d"):
                pass
    a, b, c, d = recs = ttrace.records()
    assert _names(recs) == ["tq.a", "tq.b", "tq.c", "tq.d"]
    assert [r.parent for r in recs] == [None, 0, 1, 0]
    assert [r.rid for r in recs] == [7, 7, 9, 7]
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
            <= d.start_ns <= d.end_ns <= a.end_ns)
    assert all(r.device_ms is None for r in recs)
    events = json.loads((path / ttrace.TRACE_FILE).read_text())["traceEvents"]
    marked = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"tq.a", "tq.b", "tq.c", "tq.d"} <= marked
    assert ttrace.span("tq.after") is ttrace.span("tq.other")


@pytest.fixture(scope="module")
def served():
    g = torch.Generator().manual_seed(0)
    params = lstm_lm.init(g, vocab=VOCAB, emsize=H, nhid=H, nlayers=2)
    stream = np.random.default_rng(1).integers(0, VOCAB, (40, 2))
    return tgen.serving_model(params, (8, 8, 24, 8, 8), "u8s", stream,
                              calib_chunks=1)


@pytest.mark.parametrize("words,seed", [(1, 3), (6, 2**31 + 11)])
def test_sampler_spans_and_tokens(served, words, seed):
    plain = tgen.sample_quantized(*served, VOCAB, words=words, seed=seed)
    assert ttrace.records() == []
    with _profiled():
        traced = tgen.sample_quantized(*served, VOCAB, words=words, seed=seed)
    assert traced == plain
    recs = ttrace.records()
    names = _names(recs)
    assert names[0] == "tq.sampler.request" and recs[0].rid == seed
    assert names.count("tq.sampler.request") == 1
    assert names.count("tq.lstm.step") == words
    assert names.count("tq.sampler.draw") == words
    assert all(r.parent == 0 and r.rid == seed for r in recs[1:])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        yield local_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [16, 21], ids=["whole", "tail"])
def test_batch_runner_counts_queue_wait(one_rank, n):
    runner = BatchRunner(lambda x: x * 2, one_rank, batch_size=8)
    assert runner.counts == {"requests": 0, "queue_wait_ns": 0}
    with _profiled():
        got = runner.run_all([np.float32(i) for i in range(n)])
    assert [float(y) for y in got] == [2.0 * i for i in range(n)]
    assert runner.counts["requests"] == n
    assert runner.counts["queue_wait_ns"] >= 0
    names = _names(ttrace.records())
    assert names.count("tq.runner.launch") == -(-n // 8)
    assert names.count("tq.runner.harvest") == 1


def test_finalize_cnn_records_one_search_a_layer():
    qcfg = {f"conv{i}": TRParams(weight_bits=8, group_size=1, weight_terms=8,
                                 data_bits=9, data_terms=3,
                                 quantize_input=True) for i in range(3)}
    qstate = {}
    with _profiled():
        for i, name in enumerate(qcfg):
            qs = init_quant_state()
            x = torch.randn(256, generator=torch.Generator().manual_seed(i))
            qstate[name] = {**qs, "hist": histogram_update(qs["hist"], x)}
        finalize_cnn(qstate, qcfg)
    recs = ttrace.records()
    assert _names(recs) == ["tq.calib.histogram"] * 3 + ["tq.calib.search"] * 3
    assert all(r.device_ms is None for r in recs)


@pytest.mark.parametrize("cap", [0, 3])
def test_clear_and_the_cap(monkeypatch, cap):
    monkeypatch.setattr(ttrace, "MAX_RECORDS", cap)
    with _profiled():
        with ttrace.span("tq.outer", rid=1):
            for _ in range(4):
                with ttrace.span("tq.inner"):
                    pass
    assert len(ttrace.records()) == cap
    assert ttrace.dropped() == 5 - cap
    ttrace.clear()
    assert ttrace.records() == [] and ttrace.dropped() == 0
