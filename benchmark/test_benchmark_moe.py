"""The DeepSeek-V3 cell on the CPU at the tiny size of ``conftest.py``:
its check is correct for a sound run and not for the control or a fault
planted in the timed path; its work counts at the published shapes.

    python -m pytest benchmark/test_benchmark_moe.py -q
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark import roofline
from benchmark import run as bench
from benchmark.work import deepseek_v3 as work

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "moonlight16b-tr-decode-b64"
SEED = 2**31 + 2207


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def drive(control: bool = False, seed: int = SEED):
    _, cfg, traffic, e2e, _ = bench.cell_spec(MANIFEST, CELL)
    limits = json.loads((ROOT / "benchmark" / "limits" /
                         f"{CELL}.json").read_text())
    result, _, run = bench.run_cell(CELL, cfg, traffic, e2e, [], limits,
                                    seed, 0.3, False, torch.device("cpu"),
                                    control=control)
    return result, run


def test_sound_run_is_correct_and_reads_every_check():
    result, run = drive()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"weight_mismatch", "route_mismatch",
                                     "layer_gap", "cache_gap", "logit_gap"}
    assert result["checks"]["weight_mismatch"]["value"] == 0
    assert run.loop.steps >= 3 and result["attempted"] == 4 * run.loop.steps
    assert 0 < result["metrics"]["tokens_per_s"]["value"]
    # The sample: the dense layer and two expert layers, two of four rows.
    assert run.loop.layers == [0, 1, 2] and len(run.loop.check) == 2


def test_control_is_not_correct():
    result, _ = drive(control=True)
    assert not result["correct"], result["checks"]
    # TF32 moves the numbers themselves, not the weights.
    assert result["checks"]["weight_mismatch"]["value"] == 0


def _plant(monkeypatch, fault: str):
    from tq_tpu_torch.layers import moe
    from tq_tpu_torch.models import deepseek_v3 as dsv3

    real_apply, real_route = dsv3.moe_apply, moe.route
    if fault == "expert_dropped":
        def apply(x, router, expert, *a, **kw):
            def dropping(e, rows):
                out = expert(e, rows)
                return torch.zeros_like(out) if e == 0 else out
            return real_apply(x, router, dropping, *a, **kw)
        monkeypatch.setattr(dsv3, "moe_apply", apply)
    elif fault == "scale_left_out":
        def apply(x, router, expert, top_k, scale, **kw):
            return real_apply(x, router, expert, top_k, 1.0, **kw)
        monkeypatch.setattr(dsv3, "moe_apply", apply)
    elif fault == "bias_in_weights":
        def route(x, router, top_k, scale):
            idx, w = real_route(x, router, top_k, scale)
            b = router["bias"][idx]
            s = w / scale
            return idx, (s + b) / (s + b).sum(-1, keepdim=True) * scale
        monkeypatch.setattr(moe, "route", route)
    elif fault == "kv_norm_skipped":
        real = dsv3._projections

        def projections(params, cfg, pre, a, ctx):
            q_nope, q_pe, _, k_pe = real(params, cfg, pre, a, ctx)
            r = cfg["kv_lora_rank"]
            c = ctx.dense(f"{pre}.kv_a_proj_with_mqa",
                          params[f"{pre}.kv_a_proj_with_mqa"], a)[:, :r]
            return q_nope, q_pe, c, k_pe
        monkeypatch.setattr(dsv3, "_projections", projections)
    elif fault == "cache_entry_altered":
        real = dsv3.prefill

        def prefill(params, cfg, tokens, cache, *a, **kw):
            out = real(params, cfg, tokens, cache, *a, **kw)
            cache[:, :, 3, 5] += 0.5
            return out
        monkeypatch.setattr(dsv3, "prefill", prefill)


@pytest.mark.parametrize("fault", ["expert_dropped", "scale_left_out",
                                   "bias_in_weights", "kv_norm_skipped",
                                   "cache_entry_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    result, _ = drive()
    assert not result["correct"], result["checks"]


def _published():
    entry = {c["name"]: c for c in MANIFEST["configs"]}["moonlight16b-tr"]
    return json.loads((ROOT / entry["file"]).read_text())


def test_work_at_64_rows_equals_the_hand_count():
    cfg = _published()
    d, V, rows, P = 2048, 163840, 64, 1024 + 33 / 2
    attn = 2048 * (16 * 192) + 2048 * 576 + 16 * 128 * 2048
    dense = 3 * 2048 * 11264
    experts = 3 * 2048 * 1408  # one expert
    shared = 3 * 2048 * 2816
    ops = (2 * rows * (27 * attn + dense + 26 * shared + d * V)
           + 2 * 6 * rows * 26 * experts
           + 27 * 2 * rows * 16 * (128 * 512 + 512 * 128)
           + 27 * 2 * rows * 16 * P * (576 + 512)
           + 26 * 2 * rows * d * 64)
    weights = ((27 * attn + dense + 26 * shared + 26 * 64 * experts
                + d * V) * 9 / 8
               + 27 * 16 * (128 * 512 + 512 * 128) * 4
               + 26 * (64 * d + 64) * 4 + (27 * (2 * d + 512) + d) * 4)
    cache = 27 * rows * (P + 1) * 576 * 4
    io = rows * (d + V) * 4
    got = work.step(cfg, rows, work.mean_positions(
        {"context": 1024, "steps": 32}))
    assert got[0] == pytest.approx(ops, rel=1e-12)
    assert got[1] == pytest.approx(weights + cache + io, rel=1e-12)
    # 17.5 GB of packed weights, 4.1 GB of cache: ~6.5 ms at 3.35 TB/s.
    assert 6.4e-3 < roofline.least_seconds(*got, "tf32") < 6.7e-3
    kops, kbytes = work.kernel(cfg, "term_matmul", rows)
    # The TR products alone, each reading its input and writing its
    # output: the experts' (row, slot) pairs, 6 a row.
    act = (27 * ((d + 16 * 192) + (d + 576) + (2048 + d))
           + 2 * (d + 11264) + (11264 + d)
           + 26 * (2 * (d + 2816) + (2816 + d))
           + d + V) * rows * 4 + 26 * 6 * rows * (2 * (d + 1408)
                                                  + (1408 + d)) * 4
    assert kops == pytest.approx(
        2 * rows * (27 * attn + dense + 26 * shared + d * V)
        + 2 * 6 * rows * 26 * experts, rel=1e-12)
    assert kbytes == pytest.approx(
        (27 * attn + dense + 26 * shared + 26 * 64 * experts + d * V) * 9 / 8
        + act, rel=1e-12)
    # At one row, 6 experts' weights a layer.
    one = work.kernel(cfg, "term_matmul", 1)[1]
    assert one < kbytes / 5


def test_readers_on_a_synthetic_run():
    from benchmark.harness import Trace

    cfg = _published()
    _, _, traffic, _, _ = bench.cell_spec(MANIFEST, CELL)
    traffic = {**traffic, "context": 1024, "steps": 32}
    trace = Trace(0.0, 100.0, [("term_matmul_mma_kernel", 10.0, 40.0)],
                  [("tq.moe.route", 40.0, 30.0)])
    run = types.SimpleNamespace(cfg=cfg, traffic=traffic, trace=trace,
                                lead_steps=4, lead_seconds=0.8,
                                trace_steps=2,
                                loop=types.SimpleNamespace(rows=64))
    from benchmark.run import read_metric

    least = roofline.least_seconds(*work.step(cfg, 64, 1040.5), "tf32")
    assert read_metric("step_mfu.moe", run) == pytest.approx(
        100 * least / 0.2)
    assert read_metric("idle_share.moe", run) == pytest.approx(60.0)
    assert read_metric("idle_in_route.moe", run) == pytest.approx(20.0)
    k = roofline.least_seconds(
        *[2 * v for v in work.kernel(cfg, "term_matmul", 64)], "tf32")
    assert read_metric("term_matmul_roofline.moe", run) == pytest.approx(
        100 * k / 40e-6)
