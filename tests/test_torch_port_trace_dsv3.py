"""The DeepSeek-V3 model's spans and the expert layer's counter on the
CPU: a tiny prefill and one decode step under a profiler record
``tq.dsv3.prefill``, ``tq.dsv3.step``, ``tq.mla.attend``,
``tq.moe.route`` and ``tq.moe.experts``, nested as the model runs them,
and ``moe_apply.counts`` counts what each expert layer routed."""

from torch.profiler import ProfilerActivity, profile

from test_torch_port_deepseek_v3 import TINY, _model, _tokens
from tq_tpu_torch.layers import moe
from tq_tpu_torch.models import deepseek_v3 as dsv3
from tq_tpu_torch.utils import trace as ttrace


def test_prefill_and_a_step_record_the_spans_and_the_counts():
    params = _model()
    qp, qcfg, qstate = dsv3.convert(params, TINY, (8, 8, 24, 8, 8),
                                    pack_fmt="u8s")
    B, T = 3, 5
    cache = dsv3.init_cache(TINY, B, 8)
    ttrace.clear()
    moe.moe_apply.counts.clear()
    tokens = _tokens(B, T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dsv3.prefill(qp, TINY, tokens, cache, qcfg, qstate, chunk_rows=2 * T)
        dsv3.decode_step(qp, TINY, tokens[:, 0], T, cache, qcfg, qstate)
    recs = list(ttrace.records())
    names = [r.name for r in recs]
    ttrace.clear()
    # Two prefill chunks (2 and 1 sequences) and one step: 3 layers'
    # attention each, 2 expert layers' route and experts each.
    assert names.count("tq.dsv3.prefill") == 1
    assert names.count("tq.dsv3.step") == 1
    assert names.count("tq.mla.attend") == 3 * 3
    assert names.count("tq.moe.route") == names.count("tq.moe.experts") == 6
    step = names.index("tq.dsv3.step")
    assert all(recs[i].parent == step for i, n in enumerate(names)
               if i > step and n != "tq.dsv3.step")
    assert all(r.device_ms is None for r in recs)  # no CUDA work here
    events = {e.name for e in prof.events()}
    assert {"tq.dsv3.prefill", "tq.dsv3.step", "tq.mla.attend",
            "tq.moe.route", "tq.moe.experts"} <= events
    k = TINY["num_experts_per_tok"]
    for layer in ("layers.1.mlp", "layers.2.mlp"):
        c = moe.moe_apply.counts[layer]
        # 2 prefill chunks and 1 step; every (row, slot) pair routed.
        assert c["calls"] == 3
        assert c["tokens"] == (B * T + B) * k
        assert 1 <= c["max_load"] <= 2 * T
        assert c["stream"] + c["mma"] <= 3 * TINY["n_routed_experts"]
        assert c["stream"] >= 1


def test_without_a_profiler_the_model_records_nothing():
    params = _model()
    cache = dsv3.init_cache(TINY, 2, 4)
    ttrace.clear()
    dsv3.prefill(params, TINY, _tokens(2, 3), cache)
    dsv3.decode_step(params, TINY, _tokens(2, 1)[:, 0], 3, cache)
    assert ttrace.records() == [] and ttrace.dropped() == 0
